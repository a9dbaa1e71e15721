"""Small linear-algebra helpers shared by the MPS code (torch counterpart of
kagomeperiodicbp_tpu/ops/linalg.py).

``KPBP_LINALG=gram`` keeps its meaning from the JAX package: tall QRs go
through CholeskyQR2, whose Cholesky factor and inverse come from kernel K2
(``ops/kernels.chol_inv``), and exact truncated SVDs through eigh of the
gram matrix. It is read at every call.
"""
from __future__ import annotations

import os
from typing import Optional

import torch

from .kernels import chol_inv

PINV_RTOL = 1e-10


def _real_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.empty((), dtype=dtype).real.dtype


def rtol_for(dtype) -> float:
    """Regularisation threshold scaled to the working precision."""
    if torch.finfo(_real_dtype(dtype)).bits <= 32:
        return 1e-6
    return PINV_RTOL


def _gram_mode() -> bool:
    return os.environ.get("KPBP_LINALG") == "gram"


def _phase_fix(q: torch.Tensor, r: torch.Tensor):
    """Make R's diagonal real-nonnegative (unique gauge).

    A subnormal |R_jj| counts as zero, as it does under XLA, which flushes
    subnormals: dividing by one overflows (complex64 reaches 1e-42 on
    rank-deficient bonds of the pin's BP) and turns the column into NaN."""
    d = torch.diagonal(r, dim1=-2, dim2=-1)
    ad = d.abs()
    live = ad >= torch.finfo(ad.dtype).tiny
    phase = torch.where(live, d / torch.where(live, ad, torch.ones_like(ad)), torch.ones_like(d))
    q = q * phase[..., None, :]
    r = r * phase.conj()[..., :, None]
    return q, r


def _cholqr_once(a: torch.Tensor):
    """One shifted CholeskyQR pass for a tall [m, k] matrix (m ≥ k):
    G = A†A + u·tr(G)·I, (L, W = L⁻¹) from kernel K2, Q = A·W†, R = L†.
    The shift keeps the Cholesky alive for rank-deficient A (zero-padded
    bonds); null directions come back with ~zero-norm Q columns."""
    k = a.shape[-1]
    g = a.mH @ a
    u = torch.finfo(_real_dtype(a.dtype)).eps
    shift = u * torch.clamp(torch.diagonal(g).real.sum(), min=1e-300)
    g = g + shift * torch.eye(k, dtype=g.dtype, device=g.device)
    l, w = chol_inv(g)
    return a @ w.mH, l.mH


def cholqr2(a: torch.Tensor):
    """CholeskyQR2: two passes restore orthonormality to ~machine eps for
    cond(A) ≲ u^(-1/2). Requires m ≥ k."""
    q1, r1 = _cholqr_once(a)
    q, r2 = _cholqr_once(q1)
    return _phase_fix(q, r2 @ r1)


def _batched(a: torch.Tensor) -> bool:
    """Whether `a` is a batch of matrices: leading batch axes, or a tensor
    that ``torch.func.vmap`` maps (the batched sweep's)."""
    return a.ndim > 2 or torch._C._functorch.is_batchedtensor(a)


def _qr(a: torch.Tensor):
    """Thin ``torch.linalg.qr``. A complex64 matrix on the CPU, or a batch of
    complex64 matrices on any device, is factored in complex128 and the
    factors cast back: torch's CPU complex64 QR and the card's batched one
    return non-finite Q and R for some finite rank-deficient inputs (16×12
    blobs of rank 4 in a BP sweep at N=2, D=2, χ_msg=8, χ=12, batched or
    not on the CPU, batched on an H100), where numpy's complex64 QR, the
    card's unbatched one and complex128 do not. The card's unbatched
    complex64 QRs stay as they are (tools/qr_widen_check.py measures what
    widening costs)."""
    if a.dtype == torch.complex64 and (a.device.type == "cpu" or _batched(a)):
        q, r = torch.linalg.qr(a.to(torch.complex128), mode="reduced")
        return q.to(a.dtype), r.to(a.dtype)
    return torch.linalg.qr(a, mode="reduced")


def qr_stable(a: torch.Tensor):
    """Thin QR with R's diagonal made real-nonnegative (unique gauge);
    tall matrices go through CholeskyQR2 under KPBP_LINALG=gram."""
    if _gram_mode() and a.ndim == 2 and a.shape[0] >= a.shape[1]:
        return cholqr2(a)
    return _phase_fix(*_qr(a))


def svd_trunc(a: torch.Tensor, k: int):
    """SVD keeping the k largest singular values: (u [m,k], s [k], vh [k,n])."""
    u, s, vh = torch.linalg.svd(a, full_matrices=False)
    return u[..., :, :k], s[..., :k], vh[..., :k, :]


# Exact SVD up to this size; above it the randomized projection.
RSVD_MIN_DIM = 256

RSVD_OVERSAMPLE = 10
RSVD_POWER_ITERS = 2


def rsvd_trunc(a: torch.Tensor, k: int, oversample: int = RSVD_OVERSAMPLE,
               power_iters: int = RSVD_POWER_ITERS, omega: Optional[torch.Tensor] = None):
    """Randomized truncated SVD (Halko-Martinsson-Tropp): Gaussian sketch +
    power iterations, then an exact SVD of the small projected matrix.

    `omega` [n, ell] is the sketch. By default it is drawn from a generator
    on a's device seeded with the JAX package's fold value
    (m·1000003 + n) mod (2³¹−1), so results repeat run to run; the numbers
    are torch's, not jax.random's."""
    m, n = a.shape
    ell = min(k + oversample, m, n)
    if omega is None:
        gen = torch.Generator(device=a.device)
        gen.manual_seed((m * 1000003 + n) % (2**31 - 1))
        omega = torch.randn((n, ell), generator=gen, dtype=_real_dtype(a.dtype), device=a.device)
    omega = omega.to(a.dtype)
    y = a @ omega
    q, _ = _qr(y)
    for _ in range(power_iters):
        z, _ = _qr(a.mH @ q)
        q, _ = _qr(a @ z)
    b = q.mH @ a
    ub, s, vh = torch.linalg.svd(b, full_matrices=False)
    u = q @ ub
    return u[:, :k], s[:k], vh[:k, :]


# eigh calls that failed and were retried shifted, by call site and matrix
# size; eigh_retries() reads them and reset_eigh_retries() zeroes them, as
# ops/kernels counts its launches.
_EIGH_RETRIES: dict = {}


def reset_eigh_retries() -> None:
    _EIGH_RETRIES.clear()


def eigh_retries() -> dict:
    """{call site: {matrix size: retries}}."""
    return {site: dict(by_n) for site, by_n in _EIGH_RETRIES.items()}


def _eigh_shifted(g: torch.Tensor, site: str):
    """eigh of a Hermitian PSD matrix. Where it fails to converge, eigh of
    G + σI with σ = u·tr(G) (the shift of ``_cholqr_once``), then w − σ: the
    same eigenvectors. cuSOLVER's complex64 eigh fails on a gram whose zero
    eigenvalue is many-fold (the D=3 ITE environment's first truncation
    under gram) and converges on the shifted one. Only the failing case is
    shifted, and counted under `site` in ``eigh_retries``: shifting every call
    moves the complex128 gram pin's energies by ~2e-9 (chip_smoke.py on an
    H100)."""
    try:
        return torch.linalg.eigh(g)
    except torch.linalg.LinAlgError:
        n = g.shape[-1]
        by_n = _EIGH_RETRIES.setdefault(site, {})
        by_n[n] = by_n.get(n, 0) + 1
        u = torch.finfo(_real_dtype(g.dtype)).eps
        sigma = u * torch.clamp(torch.diagonal(g).real.sum(), min=1e-300)
        w, v = torch.linalg.eigh(g + sigma * torch.eye(n, dtype=g.dtype, device=g.device))
        return w - sigma, v


def svd_trunc_gram(a: torch.Tensor, k: int):
    """Truncated SVD via eigh of the gram matrix on the short side."""
    m, n = a.shape

    def inv_of(s):
        live = s >= torch.finfo(s.dtype).tiny  # subnormals count as zero, as in _phase_fix
        return torch.where(live, 1.0 / torch.where(live, s, torch.ones_like(s)),
                           torch.zeros_like(s))

    if m <= n:
        w, u = _eigh_shifted(a @ a.mH, "svd_trunc_gram")               # ascending
        w = w.flip(0)[:k]
        u_k = u.flip(1)[:, :k]
        s = torch.sqrt(torch.clamp(w, min=0.0))
        vh = inv_of(s).to(a.dtype)[:, None] * (u_k.mH @ a)
        return u_k, s, vh
    w, v = _eigh_shifted(a.mH @ a, "svd_trunc_gram")
    w = w.flip(0)[:k]
    v_k = v.flip(1)[:, :k]
    s = torch.sqrt(torch.clamp(w, min=0.0))
    u_k = (a @ v_k) * inv_of(s).to(a.dtype)[None, :]
    return u_k, s, v_k.mH


def svd_trunc_auto(a: torch.Tensor, k: int):
    """svd_trunc (or its gram variant under KPBP_LINALG=gram) up to
    RSVD_MIN_DIM, rsvd_trunc above."""
    m, n = a.shape
    if min(m, n) > max(RSVD_MIN_DIM, 4 * k):
        return rsvd_trunc(a, k)
    if _gram_mode():
        return svd_trunc_gram(a, k)
    return svd_trunc(a, k)


# ------------------------------ ITE solves --------------------------------


def robust_solve(n_mat: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Minimal-norm least-squares solve of the Hermitian-PSD system N x = b
    by spectral projection: the components of b along eigendirections below
    rtol·w_max are dropped, not amplified, so a rank-deficient ALS system
    (a zero-padded bond) keeps the update inside the supported subspace.
    A failing eigh is retried shifted (``_eigh_shifted``)."""
    n_mat = 0.5 * (n_mat + n_mat.mH)
    w, u = _eigh_shifted(n_mat, "robust_solve")
    wmax = torch.clamp(w[-1], min=1e-300)
    rtol = max(rtol_for(n_mat.dtype), 1e-14)
    one = torch.ones_like(w)
    winv = torch.where(w > rtol * wmax, 1.0 / torch.where(w > 0, w, one), torch.zeros_like(w))
    winv = winv.to(b.dtype)
    ub = u.mH @ b
    return u @ (winv[:, None] * ub if b.ndim > 1 else winv * ub)


def eigh_psd_sqrt(n_mat: torch.Tensor, rtol: Optional[float] = None):
    """Hermitise, clip the eigenvalues at or below rtol·w_max to zero and
    return (X, w) with N ≈ X·X†; X keeps the full width (clipped columns are
    zero), w are the raw eigenvalues, ascending. A failing eigh is retried
    shifted (``_eigh_shifted``)."""
    if rtol is None:
        rtol = min(rtol_for(n_mat.dtype), 1e-12) if rtol_for(n_mat.dtype) < 1e-7 else 1e-6
    n_mat = 0.5 * (n_mat + n_mat.mH)
    w, u = _eigh_shifted(n_mat, "eigh_psd_sqrt")
    wmax = torch.clamp(w[-1], min=0.0)
    wpos = torch.where(w > rtol * wmax, w, torch.zeros_like(w))
    return u * torch.sqrt(wpos).to(u.dtype)[None, :], w


def pinv_reg(a: torch.Tensor) -> torch.Tensor:
    """Pseudo-inverse with singular values at or below rtol·s_max dropped."""
    return torch.linalg.pinv(a, rtol=rtol_for(a.dtype))
