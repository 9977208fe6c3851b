"""The port's models (ports of ``repro/models/*``): ``LM`` for the dense,
moe, vlm, hybrid and ssm families, ``EncDec`` for audio."""
from repro_torch.models.encdec import EncDec, EncDecRotations
from repro_torch.models.lm import LM


def build_model(cfg, *, device=None):
    """Config -> model with init / loss / prefill / decode_step (ref
    ``repro/models/__init__.py:6-10``): ``EncDec`` for audio, ``LM``
    otherwise."""
    if cfg.family == "audio":
        return EncDec(cfg, device=device)
    return LM(cfg, device=device)


__all__ = ["LM", "EncDec", "EncDecRotations", "build_model"]
