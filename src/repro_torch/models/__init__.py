"""Dense decoder-only LM of the port (ports of ``repro/models/*``)."""
