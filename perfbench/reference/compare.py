"""The comparison that decides ``correct`` for a served model: how far
below the reference's best logit each served token's logit lies."""
from __future__ import annotations

import torch

__all__ = ["gaps", "control_gaps"]


def gaps(ref_logits: torch.Tensor, served: torch.Tensor) -> torch.Tensor:
    """(n,) reference best logit less the reference logit of each served
    token (0 where the served token is the reference's choice)."""
    best = ref_logits.max(-1).values
    return best - ref_logits.gather(-1, served[:, None].long())[:, 0]


def control_gaps(ref_logits: torch.Tensor, ctl_logits: torch.Tensor
                 ) -> torch.Tensor:
    """(n,) the same gap for the token the control puts first."""
    return gaps(ref_logits, ctl_logits.argmax(-1))
