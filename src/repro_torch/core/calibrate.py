"""Post-training rotation calibration (port of ``repro/core/calibrate.py``;
paper §5).

Learnable components layered on the fixed SRFT base:
  * per-coordinate scale lambda (d params/channel)         -- §5.1 (1)
  * Cayley orthogonal R = (I - A/2)^-1 (I + A/2), A = U - U^T -- §5.1 (2)
  * Householder product of k reflectors (k=d/2 default)    -- Table 3/4
  * "no-SRFT" ablation: learn R + lambda from identity base -- §5.3

Training: Adam steps minimizing the reconstruction MSE
|| inverse(quantize(forward(x))) - x ||^2 over batches of collected K/V
activations, with a straight-through estimator through the rounding, per
layer and per side (K and V fit separately).  Autograd runs through plain
functions; the batches are drawn from the caller's ``torch.Generator``.

Also the deployment-path *static* lambda (one forward pass:
lambda_d = 1 / per_channel_max(SRFT-output)_d, §7.1) with the paper's
window-uniform strategy (§7.3 "calibration alternatives").
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core import quant
from repro_torch.core.transforms import Rotation
from repro_torch.optim.adam import adam_init, adam_update

__all__ = [
    "static_lambda",
    "apply_static_lambda",
    "CalibParams",
    "init_calib_params",
    "compose_rotation",
    "calibrate",
    "reconstruction_mse",
]


# ---------------------------------------------------------------------------
# Static (train-free) per-channel lambda -- the deployment default (§7.1)
# ---------------------------------------------------------------------------

def static_lambda(rot: Rotation, x: torch.Tensor, eps: float = 1e-6
                  ) -> torch.Tensor:
    """lambda (d,) = 1 / per-channel max |base(x)| over every vector of x.

    Window-uniform: the max runs over the whole calibration window (§7.3:
    a wider window sees larger outliers, so a smaller lambda)."""
    base = Rotation(rot.matrix, torch.ones_like(rot.lam), rot.signs, rot.kind)
    y = base.forward(x.reshape(-1, x.shape[-1]))
    return 1.0 / y.abs().amax(dim=0).clamp_min(eps)


def apply_static_lambda(rot: Rotation, lam: torch.Tensor) -> Rotation:
    return Rotation(rot.matrix, lam.float(), rot.signs, rot.kind)


# ---------------------------------------------------------------------------
# Learned variants
# ---------------------------------------------------------------------------

class CalibParams(NamedTuple):
    """Trainable calibration parameters (subset active per variant)."""

    log_lam: Optional[torch.Tensor]  # (d,) lambda = exp(log_lam) > 0
    cayley_u: Optional[torch.Tensor]  # (d, d) R = cayley(U - U^T)
    householder_v: Optional[torch.Tensor]  # (k, d) reflectors


def init_calib_params(d: int, *, learn_lambda: bool = True,
                      learn_cayley: bool = False,
                      learn_householder: int = 0,  # k reflectors; 0 = off
                      generator: Optional[torch.Generator] = None,
                      device=None) -> CalibParams:
    """Near-identity init (paper: 'near-identity initialization'); U, then
    V, are drawn from ``generator`` (seed 0 on ``device`` if None)."""
    device = torch.device("cpu" if device is None else device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)

    def normal(shape):
        return torch.randn(shape, generator=generator,
                           device=generator.device).to(device)

    log_lam = (torch.zeros(d, dtype=torch.float32, device=device)
               if learn_lambda else None)
    cayley_u = 1e-3 * normal((d, d)) if learn_cayley else None
    householder_v = None
    if learn_householder:
        # v ~ e_i + small noise => reflector ~ near a coordinate flip;
        # product of near-axis-aligned reflectors is near +/- identity and
        # orthogonal throughout training by construction.
        base = torch.eye(d, dtype=torch.float32, device=device)
        householder_v = (base[:learn_householder]
                         + 1e-3 * normal((learn_householder, d)))
    return CalibParams(log_lam, cayley_u, householder_v)


def _cayley_matrix(u: torch.Tensor) -> torch.Tensor:
    """R = (I - A/2)^{-1} (I + A/2), A = U - U^T.  Exactly orthogonal,
    differentiable via solve (numerically tamer than expm under autodiff)."""
    a = u - u.T
    eye = torch.eye(u.shape[0], dtype=u.dtype, device=u.device)
    return torch.linalg.solve(eye - 0.5 * a, eye + 0.5 * a)


def _householder_matrix(v: torch.Tensor) -> torch.Tensor:
    """R = H_k ... H_2 H_1, H_i = I - 2 v_i v_i^T / ||v_i||^2, v (k, d): the
    reference's order (its scan applies H_1 to I first).

    The product is taken as a tree of batched matmuls, log2(k) launches
    deep instead of k: the same product, summed in another association
    (the reference's sequential scan costs a launch chain per reflector,
    forward and backward, at every Adam step)."""
    d = v.shape[-1]
    w = v / v.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    eye = torch.eye(d, dtype=v.dtype, device=v.device)
    mats = eye - 2.0 * w[:, :, None] * w[:, None, :]  # (k, d, d): H_1..H_k
    while mats.shape[0] > 1:
        odd = mats[-1:] if mats.shape[0] % 2 else None
        pairs = mats[: mats.shape[0] // 2 * 2]
        mats = pairs[1::2] @ pairs[0::2]  # H_{2j+2} @ H_{2j+1}
        if odd is not None:
            mats = torch.cat([mats, odd])
    return mats[0]


def compose_rotation(base: Rotation, p: CalibParams) -> Rotation:
    """Fold learned R and lambda into the base: matrix = R @ B,
    lam = exp(log_lam)."""
    mat = base.matrix
    if p.cayley_u is not None:
        mat = _cayley_matrix(p.cayley_u) @ mat
    if p.householder_v is not None:
        mat = _householder_matrix(p.householder_v) @ mat
    lam = base.lam
    if p.log_lam is not None:
        lam = torch.exp(p.log_lam)
    return Rotation(mat, lam, base.signs, base.kind)


# ---------------------------------------------------------------------------
# Reconstruction objective with straight-through rounding
# ---------------------------------------------------------------------------

def _ste_roundtrip(y: torch.Tensor, bits: int, group: int) -> torch.Tensor:
    """Differentiable quantization round-trip, STE on round() ONLY.

    The naive ``y + stop_grad(deq - y)`` form kills the learning signal:
    with an orthonormal R the reconstruction error norm ||c/lam|| is then
    *independent* of R under autodiff (c fully stop-gradiented) and the
    lambda gradient degenerates to "grow every lambda".  Keeping the
    abs-max scale differentiable (LSQ/SpinQuant-style) lets gradients see
    how the rotation re-shapes the per-group dynamic range.
    """
    d = y.shape[-1]
    yg = y.reshape(*y.shape[:-1], d // group, group)
    m = float(quant.qmax(bits))
    absmax = yg.abs().amax(dim=-1, keepdim=True)
    scale = absmax.clamp_min(1e-12) / m
    u = yg / scale
    u_q = torch.clamp(torch.round(u), -m, m)  # round half to even, as rint
    u_ste = u + (u_q - u).detach()  # STE through rint+clip only
    return (u_ste * scale).reshape(y.shape)


def reconstruction_mse(rot: Rotation, x: torch.Tensor, *, bits: int = 4,
                       group: Optional[int] = None) -> torch.Tensor:
    """|| inverse(Q(forward(x))) - x ||^2 averaged over vectors;
    ``group`` None is one group spanning d (per token)."""
    g = group or x.shape[-1]
    y = rot.forward(x)
    x_hat = rot.inverse(_ste_roundtrip(y, bits, g))
    return (x_hat - x.float()).square().mean()


def calibrate(base: Rotation, activations: torch.Tensor, *, bits: int = 4,
              group: Optional[int] = None, steps: int = 300,
              lr: float = 3e-3, batch: int = 1024, learn_lambda: bool = True,
              learn_cayley: bool = False, learn_householder: int = 0,
              generator: Optional[torch.Generator] = None):
    """Adam on reconstruction MSE (paper: 200-300 steps, 1-5 min/model).

    ``activations`` (N, d) are collected K or V vectors; each step draws
    ``min(batch, N)`` rows with replacement from ``generator`` (seed 0 on
    the activations' device if None), which also draws the init.  Returns
    (rotation, diagnostics), the diagnostics carrying the initial/final
    MSE on the first ``min(4096, N)`` rows for Table-3-style 'MSE
    reduction' reporting.
    """
    dev = activations.device
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    params = init_calib_params(base.d, learn_lambda=learn_lambda,
                               learn_cayley=learn_cayley,
                               learn_householder=learn_householder,
                               generator=generator, device=dev)
    # Adam runs over the active leaves only
    active = {name: getattr(params, name) for name in params._fields
              if getattr(params, name) is not None}

    def to_params(act: dict) -> CalibParams:
        return CalibParams(act.get("log_lam"), act.get("cayley_u"),
                           act.get("householder_v"))

    def mse(act, xb):
        return reconstruction_mse(compose_rotation(base, to_params(act)), xb,
                                  bits=bits, group=group)

    n = activations.shape[0]
    head = activations[: min(4096, n)]
    with torch.no_grad():
        mse0 = float(mse(active, head))
    opt = adam_init(active)
    for _ in range(steps):
        idx = torch.randint(0, n, (min(batch, n),), generator=generator,
                            device=generator.device).to(dev)
        act = {k: v.detach().requires_grad_(True) for k, v in active.items()}
        loss = mse(act, activations[idx])
        grads = dict(zip(act, torch.autograd.grad(loss, list(act.values()))))
        active, opt = adam_update(grads, opt, active, lr=lr)
    with torch.no_grad():
        rot = compose_rotation(base, to_params(active))
        mse1 = float(reconstruction_mse(rot, head, bits=bits, group=group))
    diag = {
        "mse_initial": mse0,
        "mse_final": mse1,
        "mse_reduction": 0.0 if mse0 == 0 else 1.0 - mse1 / mse0,
    }
    return rot, diag
