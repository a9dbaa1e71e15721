"""Plan executor: runs a compiled contraction Plan on torch tensors (the
counterpart of kagomeperiodicbp_tpu/ops/contract.py).

A plan runs double-layer (each lattice step swallows a fused D⁴-leg tensor)
or, with ``Plan.single_layer``, single-layer: each lattice step swallows the
raw ket against the ket halves of the frontier's fused D² legs and then the
bra, so the D⁸ fused tensor never exists. A single-layer swallow whose blob
would exceed ``KPBP_BLOB_LIMIT`` elements takes a sketched range finder
instead (``_swallow_ket_gram_split``; ``KPBP_SKETCH_RANK``,
``KPBP_SKETCH_POWER``), the three switches the JAX package reads, under the
same names and defaults.

The frontier MPS carries canonical gauge markers so each swallow's bond
truncation only canonicalises the sites it needs: a windowed,
mixed-canonical truncation with amortised O(row) sweeps. All marker logic is
host-side Python on ints; only tensor ops reach the device, and nothing in
here reads a value back to the host.

``row_partition`` is the χ-sharding hook of ``parallel/chi_shard`` (the
counterpart of the JAX package's ``site_constraint``): while it is set, the
ranks of a group split the rows of each large swallow blob between them.
"""
from __future__ import annotations

import contextlib
import os
from typing import Callable, List, Optional, Sequence

import torch

from ..networks.graph import Source
from ..planner.compiler import Plan, Step
from .linalg import _real_dtype, qr_stable, svd_trunc_auto
from .mps import MPS, lmul, rmul


class Frontier:
    """Boundary MPS under construction, with canonical gauge markers.

    Invariants (conservative — may understate what is canonical):
    * sites[i] for i < lc are left-canonical;
    * sites[i] for i >= rc are right-canonical;
    * every bond not freshly created by the current step is ≤ chi.
    """

    def __init__(self, chi: int):
        self.sites: List[torch.Tensor] = []
        self.lc = 0
        self.rc = 0
        self.chi = chi
        self.logscale = None
        self.mantissa = None

    # ------------- marker helpers -------------

    def _invalidate(self, i: int):
        """Site i was modified."""
        self.lc = min(self.lc, i)
        self.rc = max(self.rc, i + 1)
        self.rc = min(self.rc, len(self.sites))

    def _certify_left(self, i: int):
        if self.lc == i:
            self.lc = i + 1

    def _certify_right(self, i: int):
        if self.rc == i + 1:
            self.rc = i

    # ------------- scale bookkeeping -------------

    def _init_scale(self, t: torch.Tensor):
        if self.logscale is None:
            self.logscale = torch.zeros((), dtype=_real_dtype(t.dtype), device=t.device)
            self.mantissa = torch.ones((), dtype=t.dtype, device=t.device)

    def _absorb_norm(self, x: torch.Tensor) -> torch.Tensor:
        n = torch.clamp(torch.linalg.vector_norm(x), min=1e-300)
        self.logscale = self.logscale + torch.log(n)
        return x / n

    def _absorb_scalar(self, scalar: torch.Tensor):
        n = torch.clamp(scalar.abs(), min=1e-300)
        self.logscale = self.logscale + torch.log(n)
        self.mantissa = self.mantissa * (scalar / n)

    # ------------- gauge sweeps -------------

    def _left_qr_at(self, i: int):
        """Left-canonicalise site i, absorbing R into site i+1 (or scale)."""
        s = self.sites[i]
        dl, p, dr = s.shape
        q, r = qr_stable(s.reshape(dl * p, dr))
        self.sites[i] = q.reshape(dl, p, q.shape[1])
        self._certify_left(i)
        if i + 1 < len(self.sites):
            self.sites[i + 1] = self._absorb_norm(lmul(r, self.sites[i + 1]))
            self._invalidate(i + 1)
        else:
            self._absorb_scalar(r[0, 0])

    def _right_qr_at(self, i: int):
        """Right-canonicalise site i, absorbing L into site i−1 (or scale).
        The transposes are plain (not conjugating), as in the JAX package."""
        s = self.sites[i]
        dl, p, dr = s.shape
        q, r = qr_stable(s.reshape(dl, p * dr).transpose(-2, -1))  # sᵀ = q·r ⇒ s = rᵀ·qᵀ
        k = q.shape[1]
        self.sites[i] = q.transpose(-2, -1).reshape(k, p, dr)
        self._certify_right(i)
        rt = r.transpose(-2, -1)
        if i > 0:
            self.sites[i - 1] = self._absorb_norm(rmul(self.sites[i - 1], rt))
            self._invalidate(i - 1)
        else:
            self._absorb_scalar(rt[0, 0])

    def ensure_left_to(self, p: int):
        """Make sites [0, p) left-canonical."""
        for i in range(self.lc, min(p, len(self.sites))):
            self._left_qr_at(i)

    def ensure_right_from(self, p: int):
        """Make sites [p, n) right-canonical."""
        for i in range(self.rc - 1, p - 1, -1):
            self._right_qr_at(i)

    # ------------- windowed truncation -------------

    def truncate_window(self, s: int, e: int):
        """Optimally truncate all bonds inside (s-1, e) created by a swallow
        to ≤ chi: mixed-canonical at every truncated bond."""
        n = len(self.sites)
        s, e = max(s, 0), min(e, n)
        if e - s < 1:
            return
        self.ensure_left_to(s)
        self.ensure_right_from(e)
        for i in range(s, e - 1):
            self._left_qr_at(i)
        for i in range(e - 1, s, -1):
            st = self.sites[i]
            dl, p, dr = st.shape
            k = min(self.chi, dl, p * dr)
            u, sv, vh = svd_trunc_auto(st.reshape(dl, p * dr), k)
            self.sites[i] = vh.reshape(k, p, dr)
            self._certify_right(i)
            carry = u * sv.to(u.dtype)[None, :]
            self.sites[i - 1] = self._absorb_norm(rmul(self.sites[i - 1], carry))
            self._invalidate(i - 1)

    def max_bond_in(self, s: int, e: int) -> int:
        mx = 1
        for i in range(max(s, 0), min(e, len(self.sites))):
            mx = max(mx, self.sites[i].shape[0], self.sites[i].shape[2])
        return mx

    # ------------- structural edits -------------

    def replace(self, s: int, n_in: int, new_sites: List[torch.Tensor]):
        shift = len(new_sites) - n_in
        self.sites[s : s + n_in] = new_sites
        self.lc = min(self.lc, s)
        if self.rc >= s + n_in:
            self.rc += shift
        self.rc = max(self.rc, s + len(new_sites))
        self.rc = min(self.rc, len(self.sites))


def _split_blob(blob: torch.Tensor, frontier: Frontier) -> List[torch.Tensor]:
    """Split blob [Dl, o1..ok, Dr] into k MPS sites via a QR chain."""
    out_dims = blob.shape[1:-1]
    dl, dr = blob.shape[0], blob.shape[-1]
    if len(out_dims) == 1:
        return [blob]
    sites = []
    left = dl
    rest = 1
    for od in out_dims:
        rest *= od
    carry = blob.reshape(left, rest * dr)
    for od in out_dims[:-1]:
        rest //= od
        q, r = qr_stable(carry.reshape(left * od, rest * dr))
        sites.append(q.reshape(left, od, q.shape[1]))
        carry = frontier._absorb_norm(r)
        left = q.shape[1]
    sites.append(carry.reshape(left, out_dims[-1], dr))
    return sites


def _fuse_ket(tk: torch.Tensor, n_out: int) -> torch.Tensor:
    """ket [out.., d] ⊗ conj → fused [D²-out..] (the zero-in-leg step)."""
    tt = torch.tensordot(tk, tk.conj(), dims=([tk.ndim - 1], [tk.ndim - 1]))
    perm = []
    for i in range(n_out):
        perm += [i, n_out + i]
    tt = tt.permute(perm)
    return tt.reshape(tuple(tt.shape[2 * i] * tt.shape[2 * i + 1] for i in range(n_out)))


def _swallow_ket_blob(tk: torch.Tensor, consumed: Sequence[torch.Tensor], n_in: int, n_out: int,
                      D: int) -> torch.Tensor:
    """Single-layer swallow: the ket tensor against the ket halves of the
    consumed fused-leg frontier sites, then the bra copy against their bra
    halves, with the physical pair traced in the same contraction.

    tk: ket permuted to [in1..in_nin, out1..out_nout, d], D-dim legs;
    consumed: frontier sites [a, D², b]. Returns the blob [Dl, D²-out..., Dr]
    the double-layer path makes, a·b·D^(2·n_out) elements, and holds nothing
    larger: tracing the pair after the bra contraction, as the JAX package
    does, would hold d² times that."""
    d = tk.shape[-1]
    out_dims = tuple(tk.shape[n_in:-1])
    tk_f = tk.reshape(tuple(tk.shape[:n_in]) + (-1,))  # [in..., F], F = Πout·d

    s0 = consumed[0]
    a0, _, b0 = s0.shape
    acc = torch.tensordot(s0.reshape(a0, D, D, b0), tk_f, dims=([1], [0]))  # [a, bra1, b, in2.., F]
    acc = torch.movedim(acc, 1, -1)                                          # [a, b, in2.., F, bra1]
    for j in range(1, n_in):
        sj = consumed[j]
        aj, _, bj = sj.shape
        # left bond ↔ the current right bond, ket leg ↔ in_j
        acc = torch.tensordot(sj.reshape(aj, D, D, bj), acc, dims=([0, 1], [1, 2]))
        # [bra_j, bj, a, in.., F, bras..] → [a, bj, in.., F, bras.., bra_j]
        acc = torch.movedim(torch.movedim(acc, 0, -1), 0, 1)
    # acc: [a, b, F, bra1..bra_nin] → [a, b, out.., d, bras..]; the bra takes
    # the bra legs and the physical leg at once, which traces the pair
    acc = acc.reshape(tuple(acc.shape[:2]) + out_dims + (d,) + tuple(acc.shape[3:]))
    acc = torch.tensordot(acc, tk.conj(), dims=(list(range(2 + n_out, 3 + n_out + n_in)),
                                                [n_in + n_out] + list(range(n_in))))
    # [a, b, ket_out.., bra_out..] → interleave the pairs, fuse to D² legs
    perm = [0]
    for i in range(n_out):
        perm += [2 + i, 2 + n_out + i]
    perm.append(1)
    acc = acc.permute(perm)
    return acc.reshape((acc.shape[0],) + tuple(o * o for o in out_dims) + (acc.shape[-1],))


def _blob_elem_limit() -> int:
    """Element count above which a single-layer swallow takes the sketched
    path (KPBP_BLOB_LIMIT, elements, default 3e8)."""
    return int(float(os.environ.get("KPBP_BLOB_LIMIT", 3e8)))


def _tail_letters(n_out: int):
    """einsum letters of the ket (m, n, o, ...) and bra (p, q, r, ...) tail legs."""
    return ("".join(chr(ord("m") + j) for j in range(n_out - 1)),
            "".join(chr(ord("p") + j) for j in range(n_out - 1)))


def _project_rows(U: torch.Tensor, S: torch.Tensor, tkn: torch.Tensor,
                  n_out: int, a: int, D: int, b: int) -> torch.Tensor:
    """U†·B without forming B[a, o1², tail², b] = S·tk·tk*. U: [a·D², k] row
    basis. Returns [k, o2², .., b]."""
    k = U.shape[1]
    m_ket, m_bra = _tail_letters(n_out)
    Uc = U.conj().reshape(a, D, D, k)                                  # [a, x, z, K]
    P1 = torch.einsum("axzK,aijb->xzKijb", Uc, S)
    P2 = torch.einsum(f"xzKijb,ix{m_ket}d->zKjb{m_ket}d", P1, tkn)
    pairs = "".join(x + y for x, y in zip(m_ket, m_bra))
    B2 = torch.einsum(f"zKjb{m_ket}d,jz{m_bra}d->K{pairs}b", P2, tkn.conj())
    return B2.reshape((k,) + tuple(o * o for o in tkn.shape[2:-1]) + (b,))


def _gauss(generator: torch.Generator, dim: int, s_dim: int, dtype: torch.dtype) -> torch.Tensor:
    """[dim, s_dim] standard normal sketch factor on the CPU; complex types
    take independent real and imaginary parts, as the JAX package does."""
    rdt = _real_dtype(dtype)
    if dtype.is_complex:
        g = torch.randn((dim, s_dim, 2), generator=generator, dtype=rdt)
        return torch.complex(g[..., 0], g[..., 1])
    return torch.randn((dim, s_dim), generator=generator, dtype=rdt).to(dtype)


def sketch_factors(n_out: int, D: int, b: int, s_dim: int, dtype: torch.dtype, device=None):
    """The Khatri-Rao sketch factors of ``_swallow_ket_gram_split``:
    (ket factors [D, s] × (n_out−1), bra factors [D, s] × (n_out−1), bond
    factor [b, s]). Drawn from a CPU generator seeded 0 and then moved, so the
    sketch is the same in every sweep and on every device; the numbers are
    torch's, not jax.random's."""
    gen = torch.Generator().manual_seed(0)
    om_ket = [_gauss(gen, D, s_dim, dtype) for _ in range(n_out - 1)]
    om_bra = [_gauss(gen, D, s_dim, dtype) for _ in range(n_out - 1)]
    om_b = _gauss(gen, b, s_dim, dtype)
    return ([x.to(device) for x in om_ket], [x.to(device) for x in om_bra], om_b.to(device))


def _sketch_rank(rows: int, chi: int) -> int:
    """Retained sketch rank: KPBP_SKETCH_RANK, or 2χ+32 when it is 0/unset,
    at most the rows."""
    return int(min(rows, int(os.environ.get("KPBP_SKETCH_RANK", 0)) or (2 * chi + 32)))


def _khatri_rao(t: torch.Tensor, oms: Sequence[torch.Tensor]) -> torch.Tensor:
    """t [i, x, m1..mk, d] with each tail leg m_j contracted against oms[j]
    [m_j, s], all sharing s: [i, x, d, s]. One pair at a time, so no
    intermediate grows past t·s."""
    x = torch.tensordot(t, oms[0], dims=([2], [0]))      # [i, x, m2.., d, s]
    for om in oms[1:]:
        x = torch.einsum("ixm...s,ms->ix...s", x, om)
    return x


def _swallow_ket_gram_split(tk: torch.Tensor, consumed: Sequence[torch.Tensor], n_out: int,
                            D: int, chi: int, fr: Frontier) -> List[torch.Tensor]:
    """Memory-lean single-layer swallow for a one-in-leg node whose blob
    would be huge (n_out=3 at D=6, χ=82: a·b·d²·D⁶ ≈ 1.3·10⁹ elements). The
    blob B[a, o1², o2².., b] is never formed; a randomized range finder over
    its first cut (rows a, o1_ket, o1_bra) is built from small contractions
    of the factors (frontier site S, ket, bra):

      1. Y = B·Ω with a Khatri-Rao Ω (one Gaussian factor per remaining leg,
         s = min(rows, 2χ+32) columns);
      2. KPBP_SKETCH_POWER (default 1) power iterations Y ← B·(B†·Q);
      3. Q = QR(Y), a left-orthonormal row basis of ~2χ columns, so the
         windowed truncation afterwards still picks the best χ within it;
      4. B2 = Q†·B, [s, o2².., b]: the first site is Q as [a, o1², s], the
         rest the exact QR chain on B2.

    At s = rows the sketch spans the row space and the result is exact.
    The factors come from ``sketch_factors``, which a parity test replaces
    with the JAX package's draw. Only n_in=1 (Kagome nodes have 4 legs, so
    n_out ≥ 2 means one in-leg)."""
    out_d = tuple(tk.shape[1:-1])
    if len(out_d) != n_out:
        raise ValueError(f"ket has {len(out_d)} out legs, the step {n_out}")
    # the einsum letters m.. (ket) and p.. (bra) collide from n_out = 5;
    # Kagome and square single-layer swallows have n_out ≤ 3
    if n_out > 4:
        raise ValueError(f"the sketched swallow supports n_out <= 4, got {n_out}")
    s0 = consumed[0]
    a, _, b = s0.shape
    S = fr._absorb_norm(s0.reshape(a, D, D, b))          # [a, ik, ib, b]
    ntk = torch.clamp(torch.linalg.vector_norm(tk), min=1e-300)
    tkn = tk / ntk
    fr.logscale = fr.logscale + 2 * torch.log(ntk)       # tk enters twice (ket and bra)

    rows = a * D * D
    s_dim = _sketch_rank(rows, chi)
    n_power = int(os.environ.get("KPBP_SKETCH_POWER", 1))
    om_ket, om_bra, om_b = sketch_factors(n_out, D, b, s_dim, tk.dtype, tk.device)
    m_ket, m_bra = _tail_letters(n_out)

    # Y = B·Ω, pairwise contractions in a fixed order
    T1 = _khatri_rao(tkn, om_ket)                        # [i, x, d, s]
    T2 = _khatri_rao(tkn.conj(), om_bra)                 # [j, z, d, s]
    S1 = torch.tensordot(S, om_b, dims=([3], [0]))       # [a, i, j, s]
    W = torch.einsum("aijs,ixds->ajxds", S1, T1)
    Y = torch.einsum("ajxds,jzds->axzs", W, T2).reshape(rows, s_dim)
    del T1, T2, S1, W

    Q = qr_stable(Y)[0]
    pairs = "".join(x + y for x, y in zip(m_ket, m_bra))
    for _ in range(n_power):
        # B·(B†·Q): Z = Q†·B [s, o2².., b], its tail legs unfused into (ket, bra)
        Z = _project_rows(Q, S, tkn, n_out, a, D, b)
        Zt = Z.conj().reshape((Q.shape[1],) + (D,) * (2 * (n_out - 1)) + (b,))
        Z2 = torch.einsum(f"jz{m_bra}d,S{pairs}b->jzd{m_ket}bS", tkn.conj(), Zt)
        Z3 = torch.einsum(f"ix{m_ket}d,jzd{m_ket}bS->jzdixbS", tkn, Z2)
        BZ = torch.einsum("aijb,jzdixbS->axzS", S, Z3)
        del Z, Zt, Z2, Z3
        Q = qr_stable(BZ.reshape(rows, -1))[0]

    B2 = fr._absorb_norm(_project_rows(Q, S, tkn, n_out, a, D, b))
    return [Q.reshape(a, D * D, Q.shape[1])] + _split_blob(B2, fr)


# swallows since the last ``reset_swallow_counts``, by kind: a message site,
# a fused (double-layer) node, a single-layer node through the blob
# ("direct") or the sketch ("sketched"); host-side ints, no device read
_SWALLOWS = {"message": 0, "fused": 0, "direct": 0, "sketched": 0}


def reset_swallow_counts() -> None:
    """Zero the swallow counts and the partitioned-swallow counts."""
    for k in _SWALLOWS:
        _SWALLOWS[k] = 0
    for k in _PARTITIONED:
        _PARTITIONED[k] = 0


def swallow_counts() -> dict:
    return dict(_SWALLOWS)


# The row-partition hook: (gather, rank, size, min_size) or None. While it is
# set, a double-layer swallow, or a direct single-layer one, whose first
# consumed site's left bond Dl is at least min_size builds only this rank's
# chunk of the blob's Dl rows: that bond is a free index of the tensordot
# chain (the blob's leading axis; in ``_swallow_ket_blob`` as well, where
# every step keeps it first). The chunks, padded to equal size, are gathered
# before the norm is absorbed; the split, the truncations and the norms stay
# replicated, as in the JAX package, where the windowed truncations are
# gathered. The sketched swallow and message swallows stay replicated too.
# Rows built by different ranks fit together because every rank holds the
# same frontier, gauge included: the replicated steps run the same
# arithmetic on the same inputs, which the card repeats exactly across
# processes (at D=6 rank 0's own unsharded call equals another process's,
# tools/chi_shard_check.py).
_ROW_PARTITION: Optional[tuple] = None
# partitioned swallows on this rank since ``reset_swallow_counts``, the rows
# it built and the rows of those blobs
_PARTITIONED = {"swallows": 0, "rows": 0, "of_rows": 0}


@contextlib.contextmanager
def row_partition(gather: Callable[[torch.Tensor], List[torch.Tensor]], rank: int, size: int):
    """Split large swallow blobs' rows over `size` ranks for the duration,
    this one being `rank`: those whose bond has at least twice as many rows
    as there are ranks (a smaller bond is not worth the gather, as the JAX
    package's ``site_sharder`` replicates it). ``gather(t)`` returns every
    rank's `t` (equal shapes) in rank order; ``parallel/chi_shard`` passes
    a collective over its group."""
    global _ROW_PARTITION
    prev = _ROW_PARTITION
    _ROW_PARTITION = (gather, rank, size, 2 * size)
    try:
        yield
    finally:
        _ROW_PARTITION = prev


def partition_counts() -> dict:
    return dict(_PARTITIONED)


def _partitioned(build: Callable[[torch.Tensor], torch.Tensor], s0: torch.Tensor) -> torch.Tensor:
    """build(s0) — the blob whose leading axis is s0's left bond — with its
    rows split over the row-partition ranks when the hook is set and the
    bond is large enough."""
    if _ROW_PARTITION is None or s0.shape[0] < _ROW_PARTITION[3]:
        return build(s0)
    gather, r, n, _ = _ROW_PARTITION
    rows = s0.shape[0]
    chunk = -(-rows // n)
    lo, hi = min(r * chunk, rows), min((r + 1) * chunk, rows)
    part = build(s0[lo:hi])
    if hi - lo < chunk:
        pad = part.new_zeros((chunk - (hi - lo),) + tuple(part.shape[1:]))
        part = torch.cat([part, pad])
    _PARTITIONED["swallows"] += 1
    _PARTITIONED["rows"] += hi - lo
    _PARTITIONED["of_rows"] += rows
    return torch.cat(gather(part))[:rows]


def _truncate_after(fr: Frontier, plan: Plan, s: int, n_out: int) -> None:
    """The plan's truncation policy after a swallow wrote sites [s, s+n_out):
    the window it touched to χ, or, in two-tier lazy mode (Plan.chi_lazy),
    the whole frontier once any bond exceeds chi_lazy."""
    if plan.chi_lazy is not None:
        if fr.max_bond_in(0, len(fr.sites)) > plan.chi_lazy:
            fr.truncate_window(0, len(fr.sites))
    elif fr.max_bond_in(s, s + n_out) > plan.chi:
        fr.truncate_window(s, s + n_out)


def apply_step(fr: Frontier, plan: Plan, step: Step, raw: torch.Tensor, dtype=None) -> None:
    """One plan step applied to the frontier, in place: permute the fetched
    tensor, swallow it (double- or single-layer), split the blob back into
    MPS sites and truncate as the plan says."""
    single = plan.single_layer and step.source[0] == "lat"
    t = raw if dtype is None else raw.to(dtype)
    fr._init_scale(t)
    if single:
        # the ket [d, v0..v3]: its virtual legs permuted as the plan says, d last
        t = t.permute(tuple(p + 1 for p in step.perm) + (0,))
    else:
        t = t.permute(step.perm)

    s, n_in, n_out = step.start, step.n_in, step.n_out
    if n_in == 0:
        if fr.sites:
            raise RuntimeError("zero-in-leg step on a non-empty frontier")
        if single:  # no frontier contact: the fused node tensor is the blob
            t = _fuse_ket(t, n_out)
        blob = t.reshape((1,) + tuple(t.shape) + (1,))
    elif single:
        D = t.shape[0]
        consumed = fr.sites[s : s + n_in]
        if n_in == 1 and n_out >= 2:
            a, b, d = consumed[0].shape[0], consumed[-1].shape[2], t.shape[-1]
            if a * b * d * d * D ** (2 * n_out) > _blob_elem_limit():
                # in lazy mode bonds grow to chi_lazy before the windowed SVD:
                # the sketch is sized for that
                new_sites = _swallow_ket_gram_split(t, consumed, n_out, D,
                                                    plan.chi_lazy or plan.chi, fr)
                _SWALLOWS["sketched"] += 1
                fr.replace(s, n_in, new_sites)
                _truncate_after(fr, plan, s, n_out)
                return
        blob = _partitioned(lambda s0: _swallow_ket_blob(t, [s0] + consumed[1:], n_in, n_out, D),
                            consumed[0])
        _SWALLOWS["direct"] += 1
    else:
        consumed = fr.sites[s : s + n_in]

        def chain(s0):
            run = torch.tensordot(t, s0, dims=([0], [1]))
            run = torch.movedim(run, run.ndim - 2, 0)  # [Dl, in2.., out.., b]
            for j in range(1, n_in):
                run = torch.tensordot(run, consumed[j], dims=([1, run.ndim - 1], [1, 0]))
            return run  # [Dl, out..., Dr]

        lattice = step.source[0] == "lat"
        blob = _partitioned(chain, consumed[0]) if lattice else chain(consumed[0])
        _SWALLOWS["fused" if lattice else "message"] += 1

    blob = fr._absorb_norm(blob)

    if n_out == 0:
        mat = blob.reshape(blob.shape[0], blob.shape[-1])
        del fr.sites[s : s + n_in]
        if fr.rc >= s + n_in:
            fr.rc -= n_in
        else:
            fr.rc = max(fr.rc, s)
        fr.rc = min(fr.rc, len(fr.sites))
        fr.lc = min(fr.lc, max(s - 1, 0))
        if s > 0:
            fr.sites[s - 1] = rmul(fr.sites[s - 1], mat)
            fr._invalidate(s - 1)
        elif fr.sites:
            fr.sites[0] = lmul(mat, fr.sites[0])
            fr._invalidate(0)
        else:
            fr.mantissa = fr.mantissa * mat[0, 0]
    else:
        fr.replace(s, n_in, _split_blob(blob, fr))
        _truncate_after(fr, plan, s, n_out)


def _fetch_raw(plan: Plan, step: Step, fetch: Callable[[Source], torch.Tensor]):
    """The tensor a step consumes, before permutation: the ket ("ket", v)
    where a single-layer plan swallows a lattice node."""
    if plan.single_layer and step.source[0] == "lat":
        return fetch(("ket", step.source[1]))
    return fetch(step.source)


def execute_plan(plan: Plan, fetch: Callable[[Source], torch.Tensor], dtype=None):
    """Run the plan. Returns an ``MPS`` over the final frontier — or, for a
    full contraction (empty frontier), a tuple (mantissa, log) with
    value = mantissa·exp(log)."""
    fr = Frontier(plan.chi)
    for step in plan.steps:
        apply_step(fr, plan, step, _fetch_raw(plan, step, fetch), dtype)
    if not fr.sites:
        return fr.mantissa, fr.logscale
    first = fr.sites[0] * fr.mantissa
    return MPS((first,) + tuple(fr.sites[1:]), fr.logscale)
