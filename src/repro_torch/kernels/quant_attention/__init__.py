from repro_torch.kernels.quant_attention.ops import (
    decode_attention_kernel,
    quant_decode_attention,
)

__all__ = ["decode_attention_kernel", "quant_decode_attention"]
