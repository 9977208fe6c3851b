"""Serving entry points of the port (ports of ``repro/launch/*``)."""
