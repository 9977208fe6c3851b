"""Core of the port: packing, quantization, rotations, the KV caches and
their policies (ports of ``repro/core/*``)."""
