"""Plan executor: runs a compiled contraction Plan on torch tensors (the
counterpart of kagomeperiodicbp_tpu/ops/contract.py, double-layer branch).

The frontier MPS carries canonical gauge markers so each swallow's bond
truncation only canonicalises the sites it needs: a windowed,
mixed-canonical truncation with amortised O(row) sweeps. All marker logic is
host-side Python on ints; only tensor ops reach the device, and nothing in
here reads a value back to the host.
"""
from __future__ import annotations

from typing import Callable, List

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


def apply_step(fr: Frontier, plan: Plan, step: Step, raw: torch.Tensor, dtype=None) -> None:
    """One plan step applied to the frontier, in place: permute the fetched
    double-layer tensor, swallow it, split the blob back into MPS sites and
    truncate the window it touched."""
    if plan.single_layer:
        raise NotImplementedError("single-layer swallowing is not ported yet")
    if plan.chi_lazy is not None:
        raise NotImplementedError("two-tier lazy truncation (Plan.chi_lazy) is not ported yet")
    t = raw if dtype is None else raw.to(dtype)
    fr._init_scale(t)
    t = t.permute(step.perm)

    s, n_in, n_out = step.start, step.n_in, step.n_out
    if n_in == 0:
        if fr.sites:
            raise RuntimeError("zero-in-leg step on a non-empty frontier")
        blob = t.reshape((1,) + tuple(t.shape) + (1,))
    else:
        consumed = fr.sites[s : s + n_in]
        run = torch.tensordot(t, consumed[0], dims=([0], [1]))
        run = torch.movedim(run, run.ndim - 2, 0)  # [Dl, in2.., out.., b]
        for j in range(1, n_in):
            run = torch.tensordot(run, consumed[j], dims=([1, run.ndim - 1], [1, 0]))
        blob = run  # [Dl, out..., Dr]

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
        if fr.max_bond_in(s, s + n_out) > plan.chi:
            fr.truncate_window(s, s + n_out)


def _fetch_raw(plan: Plan, step: Step, fetch: Callable[[Source], torch.Tensor]):
    """The tensor a step consumes, before permutation."""
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
