"""The benchmark of the PyTorch/CUDA port (``repro_torch``): one command
runs one cell of ``BENCHMARK.json``; see ``run.py``."""
