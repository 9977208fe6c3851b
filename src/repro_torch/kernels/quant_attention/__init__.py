from repro_torch.kernels.quant_attention.ops import (
    decode_attention_kernel,
    decode_attention_kernel_paged,
    quant_decode_attention,
    quant_decode_attention_paged,
)

__all__ = ["decode_attention_kernel", "decode_attention_kernel_paged",
           "quant_decode_attention", "quant_decode_attention_paged"]
