"""Hand-written Hopper kernels (``csrc/*.cu``) with their plain PyTorch
versions: B3 ``srft_quant`` (the fused cache write) and B4
``srft_dequant`` (its inverse), B1 and B2 ``quant_attention`` (the int4
flash-decode read, dense and paged)."""
