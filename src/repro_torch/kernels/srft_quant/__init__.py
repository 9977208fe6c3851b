from repro_torch.kernels.srft_quant.ops import (
    dequantize_rotate,
    quantize_rotated,
    rotate_quantize,
    srft_dequant,
    srft_quant,
)

__all__ = ["srft_quant", "srft_dequant", "rotate_quantize",
           "dequantize_rotate", "quantize_rotated"]
