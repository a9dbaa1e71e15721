"""The reference's precision and its few linear-algebra helpers, in plain
torch.

A ``Precision`` is the dtype the reference computes in and a rounding applied
to every tensor it makes. The reference itself runs in complex128 with no
rounding. The control is the reference in the precision below the
configuration's: complex64 for a complex128 configuration; for a complex64
one, complex64 with every tensor rounded to bfloat16 (real and imaginary
parts apart), as a bfloat16 path that accumulates in float32 would hold it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


def to_bf16_grid(x: torch.Tensor) -> torch.Tensor:
    """x with its real and imaginary parts rounded to bfloat16."""
    if x.is_complex():
        return torch.complex(x.real.to(torch.bfloat16).to(x.real.dtype),
                             x.imag.to(torch.bfloat16).to(x.imag.dtype))
    return x.to(torch.bfloat16).to(x.dtype)


@dataclass(frozen=True)
class Precision:
    name: str
    dtype: torch.dtype
    rnd: Callable[[torch.Tensor], torch.Tensor]

    def take(self, x: torch.Tensor) -> torch.Tensor:
        """An input in this precision."""
        return self.rnd(x.to(self.dtype))


REFERENCE = Precision("complex128", torch.complex128, _identity)
CONTROLS = {"complex64": Precision("bfloat16", torch.complex64, to_bf16_grid),
            "complex128": Precision("complex64", torch.complex64, _identity)}


def precision(subject: str, config: dict) -> Precision:
    """The reference's precision ("reference") or the control's for the
    configuration's dtype ("control")."""
    return REFERENCE if subject == "reference" else CONTROLS[config["dtype"]]


def real_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.empty((), dtype=dtype).real.dtype


def qr_pos(a: torch.Tensor):
    """Thin QR with R's diagonal real and non-negative (the unique gauge).
    A complex64 matrix is factored in complex128: torch's complex64 QR on
    the CPU returns non-finite factors for some rank-deficient inputs (the
    zero-padded bonds of a message)."""
    q, r = torch.linalg.qr(a.to(torch.complex128) if a.dtype == torch.complex64 else a,
                           mode="reduced")
    q, r = q.to(a.dtype), r.to(a.dtype)
    d = torch.diagonal(r)
    ad = d.abs()
    live = ad >= torch.finfo(ad.dtype).tiny  # a subnormal counts as zero
    phase = torch.where(live, d / torch.where(live, ad, torch.ones_like(ad)), torch.ones_like(d))
    return q * phase[None, :], r * phase.conj()[:, None]


def eigh_psd_sqrt(n_mat: torch.Tensor, rtol: float):
    """(X, w): N ≈ X·X† with the eigenvalues at or below rtol·w_max zeroed."""
    n_mat = 0.5 * (n_mat + n_mat.mH)
    w, u = torch.linalg.eigh(n_mat)
    wmax = torch.clamp(w[-1], min=0.0)
    wpos = torch.where(w > rtol * wmax, w, torch.zeros_like(w))
    return u * torch.sqrt(wpos).to(u.dtype)[None, :], w


def psd_solve(n_mat: torch.Tensor, b: torch.Tensor, rtol: float) -> torch.Tensor:
    """Least-squares solve of the Hermitian PSD system N x = b, dropping the
    eigendirections below rtol·w_max."""
    n_mat = 0.5 * (n_mat + n_mat.mH)
    w, u = torch.linalg.eigh(n_mat)
    wmax = torch.clamp(w[-1], min=1e-300)
    one = torch.ones_like(w)
    winv = torch.where(w > rtol * wmax, 1.0 / torch.where(w > 0, w, one), torch.zeros_like(w))
    return u @ (winv.to(b.dtype) * (u.mH @ b))


def phase_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """‖a/‖a‖ − e^{iφ}·b/‖b‖‖ at the best phase φ: the distance of two
    tensors that the scale and the phase of either leave unchanged."""
    a = a.reshape(-1).to(torch.complex128)
    b = b.reshape(-1).to(torch.complex128)
    na, nb = torch.linalg.vector_norm(a), torch.linalg.vector_norm(b)
    if not (float(na) > 0 and float(nb) > 0):
        return float("inf")
    ov = torch.vdot(b, a)
    phase = ov / ov.abs() if float(ov.abs()) > 0 else torch.ones_like(ov)
    return float(torch.linalg.vector_norm(a / na - phase * b / nb))
