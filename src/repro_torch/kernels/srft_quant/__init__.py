from repro_torch.kernels.srft_quant.ops import (
    quantize_rotated,
    rotate_quantize,
    srft_quant,
)

__all__ = ["srft_quant", "rotate_quantize", "quantize_rotated"]
