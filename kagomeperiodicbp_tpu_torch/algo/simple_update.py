"""Simple-update (SU) imaginary-time evolution on the Kagome unit cell
(counterpart of kagomeperiodicbp_tpu/algo/simple_update.py): the mean-field
warm start of ``run_ite --cell su``, in place of the reference's vendored
``tnsu`` package. Environments are approximated by diagonal λ weights on
each of the 6 edge classes of the 3-site cell.

Each site has 4 virtual legs and each leg belongs to exactly one edge class,
so the infinite Kagome lattice's SU closes on (A, B, C) + 6 λ vectors:

  class (f1, f2) joins leg_of(f1, dir) with leg_of(f2, dir.opposite()).

A sweep is a plain function of tensors (the JAX package jits it); each
sweep reads one number back to the host, the change of the λ spectra that
ends a block of equal time steps.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..enums import UpdateEdge
from ..lattices.kagome import NODE_KIND_DIRS
from ..networks.unit_cell import UnitCell
from ..ops.ite_kernels import gate_from_hamiltonian
from ..ops.linalg import _real_dtype

EdgeKey = Tuple[int, int]  # (flavor1, flavor2) ints


def _leg_of(flavor: int, d) -> int:
    return NODE_KIND_DIRS[flavor].index(d)


def edge_classes() -> List[Tuple[UpdateEdge, int, int]]:
    """[(edge, leg1, leg2)] for the 6 classes; leg indices are virtual-leg
    positions (0..3) on the first/second tensor."""
    res = []
    for e in UpdateEdge.all_options():
        d = e.direction()
        res.append((e, _leg_of(int(e.first), d), _leg_of(int(e.second), d.opposite())))
    return res


def _move_leg_front(t: torch.Tensor, leg: int) -> Tuple[torch.Tensor, Tuple[int, ...]]:
    """[d, v0..v3] → [d, v_leg, rest...]; returns the inverse permutation."""
    order = (0, leg + 1) + tuple(i + 1 for i in range(4) if i != leg)
    inv = np.argsort(order)
    return t.permute(order), tuple(int(i) for i in inv)


def _absorb_lambdas(t: torch.Tensor, flavor: int, lambdas, skip_leg: int, classes) -> torch.Tensor:
    """Multiply each virtual leg of tensor `t` (flavor) by its edge-class λ,
    except `skip_leg`."""
    for e, l1, l2 in classes:
        key = (int(e.first), int(e.second))
        for f, leg in ((int(e.first), l1), (int(e.second), l2)):
            if f == flavor and leg != skip_leg:
                shape = [1] * 5
                shape[leg + 1] = -1
                t = t * lambdas[key].reshape(shape)
    return t


def default_time_steps() -> List[float]:
    """The SU ladder of the JAX package: 200 sweeps at dt=0.1, 200 at 0.01,
    200 at 1e-3 and 100 at 1e-4, each block left once the spectra settle."""
    return [0.1] * 200 + [0.01] * 200 + [1e-3] * 200 + [1e-4] * 100


def _sweep(tns: Dict[int, torch.Tensor], lms: Dict[EdgeKey, torch.Tensor], g: torch.Tensor,
           classes, D: int) -> None:
    """One SU sweep over the 6 edge classes, updating `tns` and `lms` in
    place: per edge, θ = t1·λ·t2 with every other leg's λ absorbed, the
    gate, an SVD truncated to D, and the other λs divided back out."""
    for e, l1, l2 in classes:
        f1, f2 = int(e.first), int(e.second)
        t1 = _absorb_lambdas(tns[f1], f1, lms, l1, classes)
        t2 = _absorb_lambdas(tns[f2], f2, lms, l2, classes)
        t1m, inv1 = _move_leg_front(t1, l1)
        t2m, inv2 = _move_leg_front(t2, l2)
        d = t1m.shape[0]
        lam = lms[(f1, f2)].to(t1m.dtype)
        # θ[i, rest1, j, rest2] with λ on the shared bond
        theta = torch.tensordot(t1m * lam[None, :, None, None, None], t2m, dims=([1], [1]))
        # the gate: θ'[i r1 j r2] = Σ g[i,I,j,J] θ[I r1 J r2]
        th = torch.tensordot(g, theta, dims=([1, 3], [0, 4]))  # [i, j, r1.., r2..]
        th = th.permute(0, 2, 3, 4, 1, 5, 6, 7)
        sh1, sh2 = tuple(t1m.shape[2:]), tuple(t2m.shape[2:])
        m = th.reshape(d * int(np.prod(sh1)), d * int(np.prod(sh2)))
        u, s, vh = torch.linalg.svd(m, full_matrices=False)
        k = min(D, s.shape[0])
        u, s, vh = u[:, :k], s[:k], vh[:k, :]
        s = s / torch.linalg.vector_norm(s)
        t1n = u.reshape((d,) + sh1 + (k,)).movedim(-1, 1)   # [d, k, rest1]
        t2n = vh.reshape((k, d) + sh2).movedim(0, 1)        # [d, k, rest2]
        # restore the leg order, then divide the other legs' λ back out
        inv_l = {k2: 1.0 / v for k2, v in lms.items()}
        t1n = _absorb_lambdas(t1n.permute(inv1), f1, inv_l, l1, classes)
        t2n = _absorb_lambdas(t2n.permute(inv2), f2, inv_l, l2, classes)
        tns[f1] = t1n / torch.linalg.vector_norm(t1n)
        tns[f2] = t2n / torch.linalg.vector_norm(t2n)
        lms[(f1, f2)] = torch.clamp(s, min=1e-15)


def simple_update(
    h: np.ndarray,
    D: int,
    d: int = 2,
    time_steps: Optional[List[float]] = None,
    cell: Optional[UnitCell] = None,
    dtype: torch.dtype = torch.complex128,
    generator: Optional[torch.Generator] = None,
    tol: float = 1e-10,
    device=None,
) -> Tuple[UnitCell, Dict[EdgeKey, torch.Tensor]]:
    """Run SU until the λ spectra stop moving (per dt), and return the cell
    with the λs absorbed symmetrically (√λ on each side, the standard
    SU → PEPS form) and the λs by edge class.

    With `cell=None` the start is ``UnitCell.random`` drawn from `generator`
    (a generator seeded 0 on `device` if None); otherwise the SU runs on
    `cell`'s device. The sweeps run in `dtype`, and `tol` is clamped to its
    precision as BP clamps its thresholds (a complex64 spectrum does not
    settle below ~1e-7)."""
    if time_steps is None:
        time_steps = default_time_steps()
    if cell is None:
        if generator is None:
            generator = torch.Generator(device=device or "cpu").manual_seed(0)
        cell = UnitCell.random(d, D, generator, dtype, device)
    device = cell.A.device
    classes = edge_classes()
    lam_keys = sorted((int(e.first), int(e.second)) for e, _, _ in classes)
    lms = {k: torch.ones(D, dtype=_real_dtype(dtype), device=device) for k in lam_keys}
    tns = {f: cell[name].to(dtype) for f, name in enumerate("ABC")}
    h_t = torch.as_tensor(np.asarray(h), dtype=dtype, device=device)
    tol = max(tol, 30 * torch.finfo(_real_dtype(dtype)).eps)

    # group the ladder into (dt, count) blocks; a settled block ends early
    blocks: List[Tuple[float, int]] = []
    for dt in time_steps:
        if blocks and blocks[-1][0] == dt:
            blocks[-1] = (dt, blocks[-1][1] + 1)
        else:
            blocks.append((dt, 1))

    for dt, count in blocks:
        g = gate_from_hamiltonian(h_t, dt)
        prev = None
        for _ in range(count):
            _sweep(tns, lms, g, classes, D)
            spectra = torch.cat([lms[k] for k in lam_keys])
            # the sweep's one host read: has the block settled?
            if prev is not None and float(torch.linalg.vector_norm(spectra - prev)) < tol:
                break
            prev = spectra

    # absorb √λ symmetrically into the tensors
    sqrt_lam = {k: torch.sqrt(v) for k, v in lms.items()}
    out = []
    for f in range(3):
        t = _absorb_lambdas(tns[f], f, sqrt_lam, -1, classes)
        out.append(t / torch.linalg.vector_norm(t))
    return UnitCell(*out), dict(lms)
