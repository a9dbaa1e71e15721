"""Purification-MPS (PMPS) boundary: single-layer ket-TN contraction
(counterpart of kagomeperiodicbp_tpu/ops/pmps.py).

(reference: src/libs/bubblecon.py:1255 `swallow_bubbleket_T` and the
`bubbleket=True` mode, bubblecon.py:2586 — contract a KET tensor network
directly, representing the boundary as a purification MPS whose per-site
purifying legs absorb the physical legs of swallowed tensors. ⟨PMPS|PMPS⟩
with purifiers traced then equals the double-layer contraction, at
single-layer cost per swallow.)

Representation: each site is a 3-leg tensor [Dl, d_out·P, Dr] — the ket out
leg fused with that site's purifying dimension P (recorded separately) —
so every 3-leg MPS sweep (canonicalisation, bond truncation) works
unchanged. The mega-purifier produced by a swallow lands on the FIRST
output site; `ptrim` compresses purifying dimensions (only the purifier's
gram matters, reference `Ptrim`). The QRs go through ``qr_stable``, so under
``KPBP_LINALG=gram`` their tall ones reach kernel K2.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import torch

from .contract import Frontier, _split_blob
from .linalg import svd_trunc


@dataclass
class PMPS:
    sites: Tuple[torch.Tensor, ...]       # [Dl, d_out*P, Dr] each
    purifiers: Tuple[int, ...]            # P per site (static)
    logscale: torch.Tensor                # overall log-magnitude, 0-dim real

    @property
    def n(self) -> int:
        return len(self.sites)

    def out_dim(self, i: int) -> int:
        return self.sites[i].shape[1] // self.purifiers[i]


def pmps_root(ket_t: torch.Tensor, out_legs: Sequence[int]) -> PMPS:
    """Bootstrap: the first swallowed ket tensor (reference: 'swallowing the
    root tensor as ket', bubblecon.py:2734). ket_t's first leg is physical;
    it becomes the purifier of the first output site."""
    d = ket_t.shape[0]
    t = ket_t.permute([v + 1 for v in out_legs] + [0])  # [out1..outk, d]
    # purifier d fuses into the first out leg (out1-major, d-minor — the
    # same fusion convention the swallow uses): blob [1, out1·d, out2.., 1]
    t = t.movedim(-1, 1)                                # [out1, d, out2..outk]
    sh = t.shape
    blob = t.reshape((1, sh[0] * sh[1]) + tuple(sh[2:]) + (1,))
    fr = Frontier(chi=10**9)
    fr._init_scale(blob)
    blob = fr._absorb_norm(blob)
    sites = _split_blob(blob, fr)
    purifiers = [d] + [1] * (len(sites) - 1)
    return PMPS(tuple(sites), tuple(purifiers), fr.logscale)


def swallow_bubbleket(pmps: PMPS, ket_t: torch.Tensor, i0: int,
                      in_legs: Sequence[int], out_legs: Sequence[int],
                      chi: int | None = None) -> PMPS:
    """Swallow ket_t (first leg physical) into sites [i0, i0+len(in_legs)):
    contract in_legs against those sites' ket legs; the sites' purifiers and
    ket_t's physical leg fuse into a mega-purifier on the first output site
    (reference: swallow_bubbleket_T, bubblecon.py:1255)."""
    n_in, n_out = len(in_legs), len(out_legs)
    if n_in < 1:
        raise ValueError("swallow_bubbleket: needs at least one in-leg")
    d = ket_t.shape[0]
    # T0: [d, in..., F] with F = fused out legs (dim 1 when no out legs)
    t0 = ket_t.permute([0] + [v + 1 for v in in_legs] + [v + 1 for v in out_legs])
    out_dims = tuple(t0.shape[1 + n_in:])
    f = 1
    for od in out_dims:
        f *= od
    t0 = t0.reshape(tuple(t0.shape[: 1 + n_in]) + (f,))

    # first consumed site: unfuse ket/purifier, contract ket leg 0
    p0 = pmps.purifiers[i0]
    s0 = pmps.sites[i0]
    dl, mid, dr = s0.shape
    m0 = s0.reshape(dl, mid // p0, p0, dr)
    a = torch.tensordot(m0, t0, dims=([1], [1]))
    # a: [Dl, P0, Dr, d, in2.., F] → [F, Dl, P0·d, Dr, in2..]
    k = a.ndim
    a = a.permute([k - 1, 0, 1, 3, 2] + list(range(4, k - 1)))
    sh = a.shape
    a = a.reshape((sh[0], sh[1], sh[2] * sh[3], sh[4]) + tuple(sh[5:]))

    big_p = p0 * d
    for j in range(1, n_in):
        pj = pmps.purifiers[i0 + j]
        sj = pmps.sites[i0 + j]
        dlj, midj, drj = sj.shape
        mj = sj.reshape(dlj, midj // pj, pj, drj)
        # a: [F, Dl, P, Dr_j, in_j, in_rest...]; contract (Dr_j, in_j)
        a = torch.tensordot(a, mj, dims=([3, 4], [0, 1]))
        k = a.ndim
        # → [F, Dl, P, P_j, Dr, in_rest...]
        a = a.permute([0, 1, 2, k - 2, k - 1] + list(range(3, k - 2)))
        sh = a.shape
        a = a.reshape((sh[0], sh[1], sh[2] * sh[3]) + tuple(sh[4:]))
        big_p *= pj

    # a: [F, Dl, P, Dr] — fold the fused out legs with the mega-purifier on
    # the first output site: blob [Dl, F1·P, F2.., Dr]
    if a.ndim != 4:
        raise AssertionError("swallow_bubbleket: in-legs left uncontracted")
    a = a.permute(1, 0, 2, 3)                       # [Dl, F, P, Dr]
    first_out = out_dims[0] if n_out else 1
    a = a.reshape((a.shape[0], first_out) + out_dims[1:] + (big_p, a.shape[3]))
    a = a.movedim(-2, 2)                            # [Dl, f1, P, rest.., Dr]
    sh = a.shape
    blob = a.reshape((sh[0], sh[1] * sh[2]) + tuple(sh[3:]))

    fr = Frontier(chi=chi or 10**9)
    fr.sites = list(pmps.sites)
    fr.lc, fr.rc = 0, len(fr.sites)
    fr._init_scale(blob)
    fr.logscale = fr.logscale + pmps.logscale
    blob = fr._absorb_norm(blob)
    new_sites = _split_blob(blob, fr)
    fr.replace(i0, n_in, new_sites)
    if chi is not None and fr.max_bond_in(i0, i0 + len(new_sites)) > chi:
        fr.truncate_window(i0, i0 + len(new_sites))

    purifiers = list(pmps.purifiers)
    purifiers[i0 : i0 + n_in] = [big_p] + [1] * (len(new_sites) - 1)
    return PMPS(tuple(fr.sites), tuple(purifiers), fr.logscale)


def ptrim(pmps: PMPS, i: int, max_p: int) -> PMPS:
    """Compress the purifying dimension at site i to ≤ max_p. Only the
    purifier's gram matrix is observable (purifiers are always traced), so
    an SVD over the purifying leg keeping the max_p dominant directions is
    exact whenever rank ≤ max_p and optimal otherwise (reference `Ptrim`)."""
    p = pmps.purifiers[i]
    if p <= max_p:
        return pmps
    s = pmps.sites[i]
    dl, mid, dr = s.shape
    dout = mid // p
    m = s.reshape(dl * dout, p, dr).permute(1, 0, 2).reshape(p, dl * dout * dr)
    _, sv, vh = svd_trunc(m, max_p)
    new = (sv.to(vh.dtype)[:, None] * vh).reshape(max_p, dl, dout, dr)
    new = new.permute(1, 2, 0, 3).reshape(dl, dout * max_p, dr)
    purifiers = list(pmps.purifiers)
    purifiers[i] = max_p
    return PMPS(pmps.sites[:i] + (new,) + pmps.sites[i + 1:], tuple(purifiers), pmps.logscale)


def pmps_inner(a: PMPS) -> Tuple[torch.Tensor, torch.Tensor]:
    """⟨a|a⟩ with every purifier traced: (mantissa, log) with value
    mantissa·exp(log) — equals the DOUBLE-layer contraction of the ket TN
    the PMPS represents."""
    s0 = a.sites[0]
    if s0.shape[0] != 1:
        raise ValueError("pmps_inner: the PMPS must start with a trivial left bond")
    m0 = s0.reshape(s0.shape[1], s0.shape[2])
    env = m0.transpose(0, 1) @ m0.conj()                    # [b, B]
    for s in a.sites[1:]:
        x = torch.tensordot(env, s, dims=([0], [0]))         # [A, p, b]
        env = torch.tensordot(x, s.conj(), dims=([0, 1], [0, 1]))
    return env.reshape(()), 2.0 * a.logscale
