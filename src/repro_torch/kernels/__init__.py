"""Hand-written Hopper kernels (``csrc/*.cu``) with their plain PyTorch
versions: B3 ``srft_quant`` (the fused cache write) and B1
``quant_attention`` (the int4 flash-decode read)."""
