"""The plain reference the benchmark holds the port to: plain PyTorch in
float32, independent of ``repro_torch``."""
