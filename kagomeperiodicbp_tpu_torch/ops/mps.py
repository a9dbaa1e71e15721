"""Open-boundary MPS with an explicit log-scale (torch counterpart of
kagomeperiodicbp_tpu/ops/mps.py).

Sites are a tuple of ``[Dl, p, Dr]`` tensors; ``logscale`` is a 0-dim real
tensor holding the natural log of the overall scalar factor, so giant
contractions stay inside float range. Every function returns new tensors.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch

from .linalg import _real_dtype, qr_stable, svd_trunc_auto


def lmul(mat: torch.Tensor, site: torch.Tensor) -> torch.Tensor:
    """mat[a,b] · site[b,p,c] → [a,p,c]."""
    b, p, c = site.shape
    return (mat @ site.reshape(b, p * c)).reshape(mat.shape[0], p, c)


def rmul(site: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
    """site[a,p,b] · mat[b,c] → [a,p,c]."""
    a, p, b = site.shape
    return (site.reshape(a * p, b) @ mat).reshape(a, p, mat.shape[1])


def _clamped_norm(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.linalg.vector_norm(x), min=1e-300)


@dataclass
class MPS:
    sites: Tuple[torch.Tensor, ...]  # each [Dl, p, Dr]; ends have Dl=1 / Dr=1
    logscale: torch.Tensor           # 0-dim real tensor

    @property
    def n(self) -> int:
        return len(self.sites)

    def reverse(self) -> "MPS":
        """Reverse site order (bond legs swap): the message wrap flip."""
        return MPS(tuple(s.permute(2, 1, 0) for s in reversed(self.sites)), self.logscale)

    def scale_to(self, logscale: torch.Tensor) -> "MPS":
        """The same state with logscale set to `logscale` (first site rescaled)."""
        first = self.sites[0] * torch.exp(self.logscale - logscale)
        return MPS((first,) + tuple(self.sites[1:]), logscale)


def from_sites(sites: Sequence[torch.Tensor]) -> MPS:
    s0 = sites[0]
    return MPS(tuple(sites), torch.zeros((), dtype=_real_dtype(s0.dtype), device=s0.device))


def canonicalize_left(mps: MPS) -> MPS:
    """Left-canonical gauge via a QR sweep; the trailing 1×1 R factor's
    magnitude goes into logscale, its phase into the last site."""
    sites = list(mps.sites)
    carry = None
    for i in range(len(sites)):
        s = sites[i]
        if carry is not None:
            s = lmul(carry, s)
        dl, p, dr = s.shape
        q, r = qr_stable(s.reshape(dl * p, dr))
        sites[i] = q.reshape(dl, p, q.shape[1])
        carry = r
    scalar = carry[0, 0]
    nrm = torch.clamp(scalar.abs(), min=1e-300)
    sites[-1] = sites[-1] * (scalar / nrm)
    return MPS(tuple(sites), mps.logscale + torch.log(nrm))


def compress(mps: MPS, chi: int) -> MPS:
    """Truncate every bond to ≤ chi: left QR sweep, then right→left SVD
    sweep. Output is right-canonical with unit norm."""
    m = canonicalize_left(mps)
    sites = list(m.sites)
    carry = None
    for i in range(len(sites) - 1, 0, -1):
        s = sites[i]
        if carry is not None:
            s = rmul(s, carry)
        dl, p, dr = s.shape
        k = min(chi, dl, p * dr)
        u, sv, vh = svd_trunc_auto(s.reshape(dl, p * dr), k)
        sites[i] = vh.reshape(k, p, dr)
        carry = u * sv.to(u.dtype)[None, :]
    s0 = sites[0]
    if carry is not None:
        s0 = rmul(s0, carry)
    nrm = _clamped_norm(s0)
    sites[0] = s0 / nrm
    return MPS(tuple(sites), m.logscale + torch.log(nrm))


def upd_left(cl: torch.Tensor, b: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """CL'[a2, g2] = Σ CL[a,g] B[a,p,a2] conj(Q[g,p,g2])."""
    x = torch.tensordot(cl, b, dims=([0], [0]))                      # [g, p, a2]
    return torch.tensordot(x, q.conj(), dims=([0, 1], [0, 1]))       # [a2, g2]


def upd_right(cr: torch.Tensor, b: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """CR'[a, g] = Σ B[a,p,a2] CR[a2,g2] conj(Q[g,p,g2])."""
    x = torch.tensordot(b, cr, dims=([2], [0]))                      # [a, p, g2]
    return torch.tensordot(x, q.conj(), dims=([1, 2], [1, 2]))       # [a, g]


def right_canon(site: torch.Tensor):
    """(Q, Rᵀ) with site = Rᵀ·Q and Q right-orthonormal [k, p, dr]; the
    transposes are plain, as in the JAX package."""
    dl, p, dr = site.shape
    q, r = qr_stable(site.reshape(dl, p * dr).transpose(-2, -1))     # site = rᵀ·qᵀ
    return q.transpose(-2, -1).reshape(q.shape[1], p, dr), r.transpose(-2, -1)


def compress_iter(mps: MPS, chi: int, sweeps: int = 2) -> MPS:
    """SVD-free iterative compression (the reference's ``reduceDiter``):
    alternating sweeps that project each site of a guess MPS (bonds clipped
    to ≤ chi) onto the current left/right isometry bases of the original —
    matmul ladders and thin QRs, no SVD. Output is right-canonical with unit
    norm, as from ``compress``."""
    n = mps.n
    B = list(mps.sites)
    if n == 1 or max(s.shape[2] for s in B[:-1]) <= chi:
        return compress(mps, chi)  # nothing to truncate: the exact path

    tb = [min(B[i].shape[2], chi) for i in range(n - 1)]
    # initial guess: the leading indices of every bond
    A = [s[: (1 if i == 0 else tb[i - 1]), :, : (1 if i == n - 1 else tb[i])]
         for i, s in enumerate(B)]

    def eye(k):
        return torch.eye(k, dtype=B[0].dtype, device=B[0].device)

    # right-canonicalise the guess, building the right environments
    R_env = [None] * (n + 1)
    R_env[n] = eye(B[-1].shape[2])
    for i in range(n - 1, 0, -1):
        A[i], r = right_canon(A[i])
        A[i - 1] = torch.tensordot(A[i - 1], r, dims=([2], [0]))
        R_env[i] = upd_right(R_env[i + 1], B[i], A[i])

    for _ in range(sweeps):
        cl = eye(B[0].shape[0])
        L_env = [None] * n
        for i in range(n - 1):                                       # L → R
            x = torch.tensordot(B[i], R_env[i + 1], dims=([2], [0]))   # [a, p, g2]
            x = torch.tensordot(cl, x, dims=([0], [0]))                # [g, p, g2]
            dl, p, dr = x.shape
            q, r = qr_stable(x.reshape(dl * p, dr))
            A[i] = q.reshape(dl, p, q.shape[1])
            A[i + 1] = torch.tensordot(r, A[i + 1], dims=([1], [0]))
            cl = upd_left(cl, B[i], A[i])
            L_env[i] = cl
        cr = eye(B[-1].shape[2])
        for i in range(n - 1, 0, -1):                                # R → L
            x = torch.tensordot(B[i], cr, dims=([2], [0]))
            x = torch.tensordot(L_env[i - 1], x, dims=([0], [0]))
            A[i], r = right_canon(x)
            A[i - 1] = torch.tensordot(A[i - 1], r, dims=([2], [0]))
            cr = upd_right(cr, B[i], A[i])
            R_env[i] = cr

    nrm = _clamped_norm(A[0])
    A[0] = A[0] / nrm
    return MPS(tuple(A), mps.logscale + torch.log(nrm))


def inner(a: MPS, b: MPS) -> Tuple[torch.Tensor, torch.Tensor]:
    """⟨a|b*⟩ → (mantissa, log): value = mantissa·exp(log), both logscales
    included; the transfer ladder is rescaled at every step."""
    if a.n != b.n:
        raise ValueError(f"inner: {a.n} vs {b.n} sites")
    s0 = a.sites[0]
    c = torch.ones((1, 1), dtype=s0.dtype, device=s0.device)
    log = a.logscale + b.logscale
    for sa, sb in zip(a.sites, b.sites):
        sb = sb.conj()
        x, p, adim = sa.shape
        y, _, bdim = sb.shape
        t = (c.T @ sa.reshape(x, p * adim)).reshape(y * p, adim)
        c = t.T @ sb.reshape(y * p, bdim)
        nrm = _clamped_norm(c)
        c = c / nrm
        log = log + torch.log(nrm)
    return c[0, 0], log


def distance(a: MPS, b: MPS) -> torch.Tensor:
    """1 − |⟨a|b⟩| / (‖a‖‖b‖): scale-invariant message distance."""
    ab, log_ab = inner(a, b)
    aa, log_aa = inner(a, a)
    bb, log_bb = inner(b, b)
    log_ratio = log_ab - 0.5 * (log_aa + log_bb)
    return 1.0 - ab.abs() / torch.sqrt(aa.abs() * bb.abs()) * torch.exp(log_ratio)


def add(a: MPS, b: MPS, wa=1.0, wb=1.0) -> MPS:
    """Direct sum wa·|a⟩ + wb·|b⟩ (BP damping, hermitization); both MPSs are
    first brought to a common logscale unless they share one object."""
    if a.n != b.n:
        raise ValueError(f"add: {a.n} vs {b.n} sites")
    common = a.logscale
    if a.logscale is not b.logscale:
        common = torch.maximum(a.logscale, b.logscale)
        a = a.scale_to(common)
        b = b.scale_to(common)
    sites = []
    n = a.n
    for i, (sa, sb) in enumerate(zip(a.sites, b.sites)):
        (la, p, ra), (lb, _, rb) = sa.shape, sb.shape
        if i == 0:
            s = torch.cat([sa * wa, sb * wb], dim=2)
        elif i == n - 1:
            s = torch.cat([sa, sb], dim=0)
        else:
            top = torch.cat([sa, sa.new_zeros((la, p, rb))], dim=2)
            bot = torch.cat([sb.new_zeros((lb, p, ra)), sb], dim=2)
            s = torch.cat([top, bot], dim=0)
        sites.append(s)
    return MPS(tuple(sites), common)


def dense(mps: MPS) -> torch.Tensor:
    """Full tensor over the physical legs (small sizes only); end bonds must
    be trivial."""
    t = mps.sites[0]
    for s in mps.sites[1:]:
        t = torch.tensordot(t, s, dims=([t.ndim - 1], [0]))
    if t.shape[0] != 1 or t.shape[-1] != 1:
        raise ValueError("dense: end bonds must have dimension 1")
    t = t.reshape(t.shape[1:-1])
    return t * torch.exp(mps.logscale)


def _pad_dim(x: torch.Tensor, dim: int, pad: int) -> torch.Tensor:
    shape = list(x.shape)
    shape[dim] = pad
    return torch.cat([x, x.new_zeros(shape)], dim=dim)


def pad_bonds(mps: MPS, profile: Sequence[int]) -> MPS:
    """Zero-pad internal bonds up to `profile` (canonical static shapes)."""
    if len(profile) != mps.n - 1:
        raise ValueError(f"pad_bonds: profile of {len(profile)} bonds for {mps.n} sites")
    sites = list(mps.sites)
    for k, target in enumerate(profile):
        cur = sites[k].shape[2]
        if cur > target:
            raise ValueError(f"bond {k}: {cur} > profile {target}")
        if cur < target:
            sites[k] = _pad_dim(sites[k], 2, target - cur)
            sites[k + 1] = _pad_dim(sites[k + 1], 0, target - cur)
    return MPS(tuple(sites), mps.logscale)


# ------------------------- message initialisation -------------------------


def uniform_message(D: int, n_sites: int, dtype=torch.complex128, device=None) -> MPS:
    """Product of normalised vectorised identities vec(I_D)/√D with trivial
    bonds: the "uniform quantum" initial message."""
    v = (torch.eye(D, dtype=dtype, device=device) / D ** 0.5).reshape(1, D * D, 1)
    return from_sites([v] * n_sites)


def random_message(D: int, n_sites: int, generator: torch.Generator,
                   dtype=torch.complex128, device=None) -> MPS:
    """Random product of |v⟩⟨v| ket-bra vectorisations, one v per site,
    drawn from `generator` (on the generator's device, then moved)."""
    rd = _real_dtype(dtype)
    gdev = generator.device
    sites = []
    for _ in range(n_sites):
        v = torch.randn(D, generator=generator, dtype=rd, device=gdev)
        if dtype.is_complex:
            v = v + 1j * torch.randn(D, generator=generator, dtype=rd, device=gdev)
        v = v.to(device=device, dtype=dtype)
        v = v / torch.linalg.vector_norm(v)
        sites.append(torch.outer(v, v.conj()).reshape(1, D * D, 1))
    return from_sites(sites)



def classical_message(D: int, n_sites: int, generator: Optional[torch.Generator] = None,
                      dtype=torch.complex128, device=None) -> MPS:
    """Classical (diagonal) initial messages: a probability distribution on
    the diagonal of each fused D² leg. ``generator=None`` gives the uniform
    distribution ("uniform-classic"); otherwise each site's weights are
    drawn from `generator` in [0.1, 1) and normalised ("random-classic";
    torch's numbers, not jax.random's)."""
    if generator is None:
        site = torch.diag(torch.full((D,), 1.0 / D, dtype=dtype, device=device)).reshape(1, D * D, 1)
        return from_sites([site] * n_sites)
    rd = _real_dtype(dtype)
    sites = []
    for _ in range(n_sites):
        w = 0.1 + 0.9 * torch.rand(D, generator=generator, dtype=rd, device=generator.device)
        w = (w / w.sum()).to(device=device, dtype=dtype)
        sites.append(torch.diag(w).reshape(1, D * D, 1))
    return from_sites(sites)
