"""Orthonormal rotations for KV-cache quantization (port of
``repro/core/transforms.py``).

SRFT(x) = pack(F · diag(s) · x)   -- sign-randomized real FFT
SRHT(x) = (1/sqrt(d)) H · diag(s) · x

``transform_matrix`` materializes the d×d matrix B with
``forward(x) == x @ B.T``; the cache applies that matrix (one matmul, or
the fused B3 kernel), and the FFT form is the oracle it is checked
against.  ``make_rotation`` draws its signs from an explicit
``torch.Generator``; it cannot replay the reference's JAX PRNG, so parity
tests carry the reference's rotations across (``repro_torch.bridge``).
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = [
    "hermitian_pack",
    "hermitian_unpack",
    "srft_forward",
    "srft_inverse",
    "srht_forward",
    "srht_inverse",
    "fwht",
    "random_signs",
    "transform_matrix",
    "Rotation",
    "make_rotation",
]


def _sqrt2(like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(2.0, dtype=torch.float32, device=like.device).sqrt()


def random_signs(generator: torch.Generator, d: int,
                 device: "torch.device | str" = "cpu") -> torch.Tensor:
    """Fixed random sign vector s in {-1,+1}^d (drawn once at init)."""
    u = torch.rand(d, generator=generator, device=generator.device)
    return torch.where(u < 0.5, 1.0, -1.0).to(torch.float32).to(device)


def hermitian_pack(y: torch.Tensor, d: int) -> torch.Tensor:
    """Pack rfft output (..., d/2+1) complex into (..., d) real."""
    re, im = y.real, y.imag
    s2 = _sqrt2(re)
    return torch.cat([re[..., :1], s2 * re[..., 1:d // 2],
                      re[..., d // 2:d // 2 + 1], s2 * im[..., 1:d // 2]],
                     dim=-1)


def hermitian_unpack(p: torch.Tensor, d: int) -> torch.Tensor:
    """Inverse of :func:`hermitian_pack`: (..., d) real -> (..., d/2+1)
    complex."""
    s2 = _sqrt2(p)
    head, nyq = p[..., :1], p[..., d // 2:d // 2 + 1]
    re = torch.cat([head, p[..., 1:d // 2] / s2, nyq], dim=-1)
    im = torch.cat([torch.zeros_like(head), p[..., d // 2 + 1:] / s2,
                    torch.zeros_like(nyq)], dim=-1)
    return torch.complex(re, im)


def srft_forward(x: torch.Tensor, signs: torch.Tensor) -> torch.Tensor:
    """SRFT(x) = pack(rfft_ortho(s * x)).  Exact orthonormal map on R^d."""
    d = x.shape[-1]
    y = torch.fft.rfft(x.float() * signs, dim=-1, norm="ortho")
    return hermitian_pack(y, d)


def srft_inverse(p: torch.Tensor, signs: torch.Tensor) -> torch.Tensor:
    """Inverse SRFT: unpack, irfft, undo the signs."""
    d = p.shape[-1]
    y = hermitian_unpack(p.float(), d)
    return torch.fft.irfft(y, n=d, dim=-1, norm="ortho") * signs


def fwht(x: torch.Tensor) -> torch.Tensor:
    """Unnormalized fast Walsh-Hadamard transform along the last axis."""
    d = x.shape[-1]
    if d & (d - 1):
        raise ValueError(f"FWHT requires power-of-two d, got {d}")
    shape = x.shape
    h = 1
    y = x
    while h < d:
        y = y.reshape(*shape[:-1], d // (2 * h), 2, h)
        a, b = y[..., 0, :], y[..., 1, :]
        y = torch.cat([a + b, a - b], dim=-1).reshape(shape)
        h *= 2
    return y


def srht_forward(x: torch.Tensor, signs: torch.Tensor) -> torch.Tensor:
    d = x.shape[-1]
    return fwht(x.float() * signs) / torch.tensor(
        float(d), dtype=torch.float32).sqrt()


def srht_inverse(p: torch.Tensor, signs: torch.Tensor) -> torch.Tensor:
    """Inverse SRHT: H is symmetric and H @ H = d I, so H / sqrt(d), then
    the signs."""
    d = p.shape[-1]
    return (fwht(p.float()) / torch.tensor(float(d), dtype=torch.float32)
            .sqrt()) * signs


def transform_matrix(kind: str, signs: torch.Tensor) -> torch.Tensor:
    """The d×d orthonormal matrix B of a transform: x @ B.T == forward(x)."""
    d = signs.shape[0]
    eye = torch.eye(d, dtype=torch.float32, device=signs.device)
    if kind == "srft":
        cols = srft_forward(eye, signs)  # rows are forward(e_i)
    elif kind == "srht":
        cols = srht_forward(eye, signs)
    elif kind == "identity":
        cols = eye
    else:
        raise ValueError(f"unknown transform kind: {kind}")
    return cols.T.contiguous()


@dataclasses.dataclass
class Rotation:
    """Composite rotation y = lam * (B @ x) (reference ``Rotation``).

    ``matrix`` is the folded (R @ Base) orthonormal matrix, ``lam`` the
    per-coordinate scale (ones if unlearned), ``signs``/``kind`` the base
    transform it was built from.
    """

    matrix: torch.Tensor  # (d, d) orthonormal
    lam: torch.Tensor  # (d,) > 0
    signs: torch.Tensor  # (d,)
    kind: str = "srft"

    @property
    def d(self) -> int:
        return self.matrix.shape[-1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (..., d) -> rotated-and-rescaled (..., d), fp32."""
        return (x.float() @ self.matrix.T) * self.lam

    def forward_at(self, x: torch.Tensor, index) -> torch.Tensor:
        """``forward(x[index])``: a cache write names the rows it rotates
        by an index into its input, so that a cache split by KV head can
        rotate them once at full width, as the unsplit write does
        (``launch/sharded_cache.py``)."""
        return self.forward(x[index])

    def inverse(self, y: torch.Tensor) -> torch.Tensor:
        lam = self.lam.clamp_min(1e-6)  # paper: clamp at 1e-6
        return (y.float() / lam) @ self.matrix

    def folded_query_matrix(self) -> torch.Tensor:
        """M = diag(1/lam) @ B, so q_eff = M q scores the stored lam*B*k."""
        return self.matrix / self.lam.clamp_min(1e-6)[:, None]


def make_rotation(kind: str, generator: torch.Generator, d: int,
                  device: "torch.device | str" = "cpu") -> Rotation:
    """Fresh unlearned rotation of the given kind (lam = 1)."""
    signs = random_signs(generator, d, device)
    if kind == "identity":
        signs = torch.ones(d, dtype=torch.float32, device=device)
    return Rotation(matrix=transform_matrix(kind, signs),
                    lam=torch.ones(d, dtype=torch.float32, device=device),
                    signs=signs, kind=kind)
