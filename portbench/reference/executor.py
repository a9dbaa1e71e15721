"""The reference's boundary-MPS executor, in plain torch.

Translated from the JAX package, the repo's reference implementation, and
not from the port: ``kagomeperiodicbp_tpu/ops/contract.py`` (the frontier
with its canonical markers, the QR chain that splits a swallowed blob, the
windowed truncation, the double- and single-layer swallows, the sketched
single-layer swallow) and ``kagomeperiodicbp_tpu/ops/linalg.py`` (the QR
gauge, the exact or randomized truncated SVD). The plans come from the JAX
package's planner (``geometry/``).

At the published sizes the truncations are not exact: a wide window takes
the randomized SVD, and a one-in, three-out single-layer swallow the
sketched range finder, each from a Gaussian draw. Two good truncations of
one D=6 boundary state differ by some 3%, as much as a bfloat16 computation
moves it, so the reference has to take the same draws as the program to
tell the two apart. That rule of the draws is all it shares with the
program (``Draws``): seeds, order and real dtype, as torch's generators
make them (``jax.random``'s numbers cannot be made without JAX). Everything
else is computed here at the reference's precision. The JAX package's scale
bookkeeping (log-scale and mantissa) is left out: every output is compared
at unit norm, so intermediate tensors are only normalised.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Sequence

import torch

from .numerics import Precision, qr_pos, real_dtype

# kagomeperiodicbp_tpu/ops/linalg.py: RSVD_OVERSAMPLE, RSVD_POWER_ITERS;
# ops/contract.py: KPBP_SKETCH_POWER's default
RSVD_OVERSAMPLE = 10
RSVD_POWER_ITERS = 2
SKETCH_POWER_ITERS = 1


@dataclass(frozen=True)
class Recipe:
    """The sizes that pick a truncation (JAX package: ``RSVD_MIN_DIM`` in
    ops/linalg, ``KPBP_BLOB_LIMIT`` in ops/contract): exact SVD up to
    ``rsvd_min_dim`` (or 4k), randomized above; a single-layer swallow
    whose blob would pass ``blob_limit`` elements is sketched. The draws
    are made in ``draw_dtype``. The CPU tests lower the two sizes to reach
    both randomized paths at a small D."""
    draw_dtype: torch.dtype = torch.float32
    rsvd_min_dim: int = 256
    blob_limit: float = 3e8


def recipe_for(config: dict) -> Recipe:
    """The recipe of a configuration: its draws in its own real dtype."""
    return Recipe(draw_dtype=real_dtype(getattr(torch, config["dtype"])))


class Draws:
    """The rule of the Gaussian draws, shared with the program as data.

    * randomized SVD of an m×n matrix: an [n, k+10] real normal matrix from
      a generator on the matrix's device seeded (m·1000003 + n) mod (2³¹−1),
      the JAX package's fold value;
    * sketched swallow: from a CPU generator seeded 0, the n_out−1 ket
      factors [D, s], the n_out−1 bra factors [D, s], then the bond factor
      [b, s], each complex with independent normal parts drawn as [·, s, 2].
    """

    def __init__(self, dtype: torch.dtype):
        self.dtype = dtype

    def rsvd(self, m: int, n: int, ell: int, device) -> torch.Tensor:
        gen = torch.Generator(device=device)
        gen.manual_seed((m * 1000003 + n) % (2 ** 31 - 1))
        return torch.randn((n, ell), generator=gen, dtype=self.dtype, device=device)

    def sketch(self, n_out: int, D: int, b: int, s_dim: int, like: torch.Tensor):
        """(ket factors, bra factors, bond factor), moved to `like`'s device
        and dtype."""
        gen = torch.Generator().manual_seed(0)

        def gauss(dim):
            g = torch.randn((dim, s_dim, 2), generator=gen, dtype=self.dtype)
            return torch.complex(g[..., 0], g[..., 1]).to(device=like.device, dtype=like.dtype)

        ket = [gauss(D) for _ in range(n_out - 1)]
        bra = [gauss(D) for _ in range(n_out - 1)]
        return ket, bra, gauss(b)


class Ctx:
    """What a step needs besides its tensors: the precision, the recipe and
    the draws (ops/linalg.qr_stable and svd_trunc_auto)."""

    def __init__(self, prec: Precision, recipe: Recipe):
        self.prec = prec
        self.recipe = recipe
        self.draws = Draws(recipe.draw_dtype)

    def qr(self, a):
        q, r = qr_pos(a)
        return self.prec.rnd(q), self.prec.rnd(r)

    def unit(self, x):
        """x at unit norm (where the JAX package moves the norm into its
        log-scale)."""
        return self.prec.rnd(x / torch.clamp(torch.linalg.vector_norm(x), min=1e-300))

    def _rsvd(self, a, k):
        """Halko–Martinsson–Tropp: range of a·Ω, power iterations, then the
        exact SVD of the projection (ops/linalg.rsvd_trunc)."""
        m, n = a.shape
        ell = min(k + RSVD_OVERSAMPLE, m, n)
        omega = self.draws.rsvd(m, n, ell, a.device).to(a.dtype)
        q = torch.linalg.qr(a @ omega)[0]
        for _ in range(RSVD_POWER_ITERS):
            z = torch.linalg.qr(a.mH @ q)[0]
            q = torch.linalg.qr(a @ z)[0]
        ub, s, vh = torch.linalg.svd(q.mH @ a, full_matrices=False)
        return (q @ ub)[:, :k], s[:k], vh[:k, :]

    def svd(self, a, k):
        m, n = a.shape
        if min(m, n) > max(self.recipe.rsvd_min_dim, 4 * k):
            u, s, vh = self._rsvd(a, k)
        else:
            u, s, vh = torch.linalg.svd(a, full_matrices=False)
            u, s, vh = u[:, :k], s[:k], vh[:k, :]
        return self.prec.rnd(u), s, self.prec.rnd(vh)


class Frontier:
    """The boundary MPS under construction (ops/contract.Frontier). Sites
    [l, p, r]; sites[:lc] are left-canonical and sites[rc:] right-canonical
    (the markers may understate it); every bond a step did not just make is
    at most χ."""

    def __init__(self, chi: int, ctx: Ctx):
        self.ctx = ctx
        self.chi = chi
        self.sites: List[torch.Tensor] = []
        self.lc = 0
        self.rc = 0

    def _touched(self, i: int):
        self.lc = min(self.lc, i)
        self.rc = min(max(self.rc, i + 1), len(self.sites))

    def _left_qr_at(self, i: int):
        """Site i left-canonical, its R into site i+1."""
        dl, p, dr = self.sites[i].shape
        q, r = self.ctx.qr(self.sites[i].reshape(dl * p, dr))
        self.sites[i] = q.reshape(dl, p, q.shape[1])
        if self.lc == i:
            self.lc = i + 1
        if i + 1 < len(self.sites):
            self.sites[i + 1] = self.ctx.unit(torch.einsum("ab,bpc->apc", r, self.sites[i + 1]))
            self._touched(i + 1)

    def _right_qr_at(self, i: int):
        """Site i right-canonical from the QR of its plain transpose, sᵀ = q·r,
        so s = rᵀ·qᵀ, and rᵀ into site i−1."""
        dl, p, dr = self.sites[i].shape
        q, r = self.ctx.qr(self.sites[i].reshape(dl, p * dr).T)
        self.sites[i] = q.T.reshape(q.shape[1], p, dr)
        if self.rc == i + 1:
            self.rc = i
        if i > 0:
            self.sites[i - 1] = self.ctx.unit(torch.einsum("apb,bc->apc", self.sites[i - 1], r.T))
            self._touched(i - 1)

    def truncate_window(self, s: int, e: int):
        """Every bond inside the window [s, e) cut to χ at its best, each
        in mixed-canonical form: the outside canonical, a QR sweep forward
        through the window, then a truncating SVD sweep back."""
        n = len(self.sites)
        s, e = max(s, 0), min(e, n)
        if e - s < 1:
            return
        for i in range(self.lc, min(s, n)):
            self._left_qr_at(i)
        for i in range(self.rc - 1, e - 1, -1):
            self._right_qr_at(i)
        for i in range(s, e - 1):
            self._left_qr_at(i)
        for i in range(e - 1, s, -1):
            dl, p, dr = self.sites[i].shape
            k = min(self.chi, dl, p * dr)
            u, sv, vh = self.ctx.svd(self.sites[i].reshape(dl, p * dr), k)
            self.sites[i] = vh.reshape(k, p, dr)
            if self.rc == i + 1:
                self.rc = i
            carry = u * sv.to(u.dtype)[None, :]
            self.sites[i - 1] = self.ctx.unit(torch.einsum("apb,bc->apc", self.sites[i - 1], carry))
            self._touched(i - 1)

    def truncate_after(self, s: int, n_out: int):
        """The window of a step's new sites, if a bond in it passes χ."""
        bonds = [d for x in self.sites[max(s, 0):s + n_out] for d in (x.shape[0], x.shape[2])]
        if max(bonds, default=1) > self.chi:
            self.truncate_window(s, s + n_out)

    def replace(self, s: int, n_in: int, new_sites: List[torch.Tensor]):
        self.sites[s:s + n_in] = new_sites
        self.lc = min(self.lc, s)
        if self.rc >= s + n_in:
            self.rc += len(new_sites) - n_in
        self.rc = min(max(self.rc, s + len(new_sites)), len(self.sites))


def split_blob(blob: torch.Tensor, ctx: Ctx) -> List[torch.Tensor]:
    """blob [l, o1..ok, r] as k sites by a QR chain from the left."""
    outs = tuple(blob.shape[1:-1])
    left, right = blob.shape[0], blob.shape[-1]
    sites = []
    carry = blob
    for od in outs[:-1]:
        q, r = ctx.qr(carry.reshape(left * od, -1))
        sites.append(q.reshape(left, od, q.shape[1]))
        left = q.shape[1]
        carry = ctx.unit(r)
    sites.append(carry.reshape(left, outs[-1], right))
    return sites


def fused_pairs(x: torch.Tensor, n_out: int, first: int = 0) -> torch.Tensor:
    """x [.., k1..k_n, b1..b_n, ..] with ket legs from `first` and the bra
    legs after them → the pairs (k_j, b_j) fused to D² legs, ket major."""
    perm = list(range(first))
    for j in range(n_out):
        perm += [first + j, first + n_out + j]
    perm += list(range(first + 2 * n_out, x.ndim))
    x = x.permute(perm)
    sh = x.shape
    return x.reshape(tuple(sh[:first]) + tuple(sh[first + 2 * j] * sh[first + 2 * j + 1]
                                               for j in range(n_out)) + tuple(sh[first + 2 * n_out:]))


def _letters(k: int, start: str) -> str:
    return "".join(chr(ord(start) + j) for j in range(k))


def single_layer_blob(tk: torch.Tensor, consumed: Sequence[torch.Tensor], n_in: int, n_out: int,
                      D: int) -> torch.Tensor:
    """The blob [l, D²-out.., r] of a single-layer swallow, by its
    definition: the consumed frontier sites [a, D², b], their fused legs
    unfused to (ket, bra), against the ket tk [in.., out.., d] and its
    conjugate, the physical leg traced (ops/contract._swallow_ket_blob)."""
    ins_k, ins_b = _letters(n_in, "a"), _letters(n_in, "h")
    outs_k, outs_b = _letters(n_out, "o"), _letters(n_out, "t")
    bonds = _letters(n_in + 1, "A")
    ops, subs = [], []
    for j, site in enumerate(consumed):
        ops.append(site.reshape(site.shape[0], D, D, site.shape[2]))
        subs.append(bonds[j] + ins_k[j] + ins_b[j] + bonds[j + 1])
    ops += [tk, tk.conj()]
    subs += [ins_k + outs_k + "z", ins_b + outs_b + "z"]
    x = torch.einsum(",".join(subs) + "->" + bonds[0] + outs_k + outs_b + bonds[-1], *ops)
    return fused_pairs(x, n_out, first=1)


def sketched_swallow(tk: torch.Tensor, site: torch.Tensor, n_out: int, D: int, chi: int,
                     ctx: Ctx) -> List[torch.Tensor]:
    """A one-in single-layer swallow whose blob B[a, o1², o2².., b] would be
    too large, by a randomized range finder over its first cut (rows a, o1)
    built from contractions of the factors, never B itself
    (ops/contract._swallow_ket_gram_split): Y = B·Ω with a Khatri–Rao Ω of
    s = min(rows, 2χ+32) columns, one power iteration Y ← B·(B†·Q), Q =
    QR(Y); the first site is Q and the rest the QR chain of Q†·B."""
    if n_out > 4:
        raise ValueError(f"the sketched swallow supports n_out <= 4, got {n_out}")
    a, _, b = site.shape
    S = ctx.unit(site.reshape(a, D, D, b))                        # [a, ik, ib, b]
    tkn = tk / torch.clamp(torch.linalg.vector_norm(tk), min=1e-300)
    rows = a * D * D
    s_dim = int(min(rows, 2 * chi + 32))
    om_ket, om_bra, om_b = ctx.draws.sketch(n_out, D, b, s_dim, tk)
    mk, mb = _letters(n_out - 1, "m"), _letters(n_out - 1, "p")
    pairs = "".join(x + y for x, y in zip(mk, mb))

    def project(U):
        """U†·B as [k, o2².., b] for a row basis U [rows, k], one factor at
        a time."""
        Uc = U.conj().reshape(a, D, D, U.shape[1])
        x = torch.einsum("axzK,aijb->xzKijb", Uc, S)
        x = torch.einsum(f"xzKijb,ix{mk}d->zKjb{mk}d", x, tkn)
        x = torch.einsum(f"zKjb{mk}d,jz{mb}d->K{pairs}b", x, tkn.conj())
        return x.reshape((U.shape[1],) + tuple(o * o for o in tkn.shape[2:-1]) + (b,))

    T1 = torch.einsum(f"ix{mk}d," + ",".join(f"{c}s" for c in mk) + "->ixds", tkn, *om_ket)
    T2 = torch.einsum(f"jz{mb}d," + ",".join(f"{c}s" for c in mb) + "->jzds", tkn.conj(), *om_bra)
    Y = torch.einsum("aijs,ixds->ajxds", torch.einsum("aijb,bs->aijs", S, om_b), T1)
    Q = ctx.qr(torch.einsum("ajxds,jzds->axzs", Y, T2).reshape(rows, s_dim))[0]
    for _ in range(SKETCH_POWER_ITERS):
        # B·(B†·Q), B† applied as the conjugate of Q†·B with its tail legs unfused
        Zt = project(Q).conj().reshape((Q.shape[1],) + (D,) * (2 * (n_out - 1)) + (b,))
        x = torch.einsum(f"jz{mb}d,S{pairs}b->jzd{mk}bS", tkn.conj(), Zt)
        x = torch.einsum(f"ix{mk}d,jzd{mk}bS->jzdixbS", tkn, x)
        BZ = torch.einsum("aijb,jzdixbS->axzS", S, x)
        Q = ctx.qr(BZ.reshape(rows, -1))[0]
    B2 = ctx.unit(project(Q))
    return [Q.reshape(a, D * D, Q.shape[1])] + split_blob(B2, ctx)


def apply_step(fr: Frontier, plan, step, t: torch.Tensor) -> None:
    """One plan step on the frontier (ops/contract.apply_step): the fetched
    tensor permuted as the step says, swallowed, the blob split back into
    sites, and the new window truncated where a bond passes χ."""
    ctx = fr.ctx
    single = plan.single_layer and step.source[0] == "lat"
    # a ket [d, v0..v3] takes its virtual legs in the step's order, d last
    t = t.permute(tuple(p + 1 for p in step.perm) + (0,)) if single else t.permute(step.perm)
    s, n_in, n_out = step.start, step.n_in, step.n_out
    consumed = fr.sites[s:s + n_in]
    if n_in == 0:
        if fr.sites:
            raise RuntimeError("zero-in-leg step on a non-empty frontier")
        if single:
            t = fused_pairs(torch.tensordot(t, t.conj(), dims=([n_out], [n_out])), n_out)
        blob = t.reshape((1,) + tuple(t.shape) + (1,))
    elif single:
        D = t.shape[0]
        a, b, d = consumed[0].shape[0], consumed[-1].shape[2], t.shape[-1]
        if n_in == 1 and n_out >= 2 and a * b * d * d * D ** (2 * n_out) > ctx.recipe.blob_limit:
            fr.replace(s, n_in, sketched_swallow(t, consumed[0], n_out, D, plan.chi, ctx))
            fr.truncate_after(s, n_out)
            return
        blob = single_layer_blob(t, consumed, n_in, n_out, D)
    else:
        # the double-layer node [in.., out..] against the consumed sites
        run = torch.movedim(torch.tensordot(t, consumed[0], dims=([0], [1])), t.ndim - 1, 0)
        for j in range(1, n_in):
            run = torch.tensordot(run, consumed[j], dims=([1, run.ndim - 1], [1, 0]))
        blob = run                                             # [l, out.., r]
    blob = ctx.unit(blob)
    if n_out == 0:
        if len(fr.sites) == n_in:
            raise RuntimeError("the plan closes the whole network: no boundary left")
        mat = blob.reshape(blob.shape[0], blob.shape[-1])
        del fr.sites[s:s + n_in]
        fr.rc = fr.rc - n_in if fr.rc >= s + n_in else max(fr.rc, s)
        fr.rc = min(fr.rc, len(fr.sites))
        fr.lc = min(fr.lc, max(s - 1, 0))
        if s > 0:
            fr.sites[s - 1] = torch.einsum("apb,bc->apc", fr.sites[s - 1], mat)
            fr._touched(s - 1)
        else:
            fr.sites[0] = torch.einsum("ab,bpc->apc", mat, fr.sites[0])
            fr._touched(0)
        return
    fr.replace(s, n_in, [blob] if n_out == 1 else split_blob(blob, ctx))
    fr.truncate_after(s, n_out)


def run_plan(plan, fetch: Callable, prec: Precision, recipe: Recipe) -> List[torch.Tensor]:
    """The final frontier of `plan` as sites [l, p, r], up to scale and
    phase (ops/contract.execute_plan). `fetch(source)` gives ("lat", v)
    double-layer tensors, ("ket", v) kets (for the lattice steps of a
    single-layer plan) and message sites, in the reference's precision."""
    if plan.chi_lazy is not None:
        raise ValueError("lazy truncation is not part of the recipe")
    fr = Frontier(plan.chi, Ctx(prec, recipe))
    for step in plan.steps:
        src = step.source
        if plan.single_layer and src[0] == "lat":
            src = ("ket", src[1])
        apply_step(fr, plan, step, fetch(src))
    return list(fr.sites)
