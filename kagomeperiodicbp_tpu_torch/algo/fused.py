"""Algorithmic units of BP, measurement and the ITE edge update as plain
functions on tensors (counterpart of kagomeperiodicbp_tpu/algo/fused.py,
where each unit is one jitted program; here they run eagerly).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..enums import UpdateEdge
from ..lattices import BlockSide
from ..networks.graph import message_bond_profile
from ..ops import ite_kernels as K
from ..ops import mps as mpslib
from ..ops.contract import execute_plan
from ..ops.mps import MPS
from ..physics import pauli
from . import contraction as C
from . import edge_env as E
from .contraction import MsgSites


# ------------------------------ helpers -----------------------------------


def _msgs_to_sites(messages) -> MsgSites:
    return {int(s): tuple(m.sites) for s, m in messages.items()}


def _sites_to_msgs(sites: MsgSites) -> Dict[BlockSide, MPS]:
    return {BlockSide(s): mpslib.from_sites(ss) for s, ss in sites.items()}


def _one_outgoing(tensors, msg_sites: MsgSites, N, D, chi, chi_msg, toward: int,
                  single: bool = False) -> MPS:
    """Outgoing message toward `toward`, canonical profile, unit scale.
    `tensors` are the fused tensors, or with `single` the raw kets, which the
    plan then swallows single-layer."""
    plan = C.to_message_plan(N, D, chi, chi_msg, toward)
    if single:
        plan = C.single_layer_plan(plan)
        fetch = C._make_fetch(None, msg_sites, kets=tuple(tensors))
    else:
        fetch = C._make_fetch(tensors, msg_sites)
    raw = execute_plan(plan, fetch)
    return C.message_postprocess(raw, plan, N, D, chi_msg)


# ------------------------------ BP sweep ----------------------------------


def _one_side_update(tensors, msg_sites: MsgSites, N: int, D: int, chi: int, chi_msg: int,
                     toward: int, damping: Optional[float] = None, single: bool = False):
    """(new wrapped message sites, distance to the old one) for one side;
    with `damping`, the new message keeps that fraction of the old one."""
    wrapped = _one_outgoing(tensors, msg_sites, N, D, chi, chi_msg, toward, single).reverse()
    tgt = int(BlockSide(toward).opposite())
    old = MPS(tuple(msg_sites[tgt]), torch.zeros_like(wrapped.logscale))
    dist = mpslib.distance(old, wrapped)
    if damping:
        mixed = mpslib.add(wrapped, old, 1.0 - damping, damping)
        mixed = mpslib.compress(mixed, chi_msg)
        mixed = mpslib.pad_bonds(mixed, message_bond_profile(N, D, chi_msg))
        wrapped = MPS(mixed.sites, torch.zeros_like(mixed.logscale))
    return tuple(wrapped.sites), dist


def bp_iteration(N: int, D: int, chi: int, chi_msg: int, damping: Optional[float],
                 single: bool = False):
    """(tensors, msg_sites) → (new_msg_sites, mean distance): one synchronous
    BP sweep over the six sides. `tensors` are the fused tensors, or with
    `single` the raw kets (single-layer swallowing). The mean distance stays
    a 0-dim device tensor; the caller decides when to read it."""

    def run(tensors, msg_sites: MsgSites):
        new: MsgSites = {}
        dists = []
        for side in BlockSide:
            wrapped, dist = _one_side_update(tensors, msg_sites, N, D, chi, chi_msg,
                                             int(side), damping, single)
            new[int(side.opposite())] = wrapped
            dists.append(dist)
        return new, torch.stack(dists).mean()

    return run


def hermitize_all(N: int, D: int, chi_msg: int):
    """msg_sites → hermitized msg_sites."""
    from .bp import hermitize_message

    def run(msg_sites: MsgSites) -> MsgSites:
        return {s: tuple(hermitize_message(mpslib.from_sites(ss), D, chi_msg).sites)
                for s, ss in msg_sites.items()}

    return run


# ---------------------------- measurement ---------------------------------


def _rho_health(rho: torch.Tensor):
    """(hermiticity defect, eigenvalue sum, negativity) of a 2-site RDM."""
    d1, d2 = rho.shape[0], rho.shape[2]
    m = rho.permute(0, 2, 1, 3).reshape(d1 * d2, d1 * d2)
    herm = torch.linalg.matrix_norm(m - m.mH) / torch.clamp(torch.linalg.matrix_norm(m), min=1e-300)
    w = torch.linalg.eigvalsh(0.5 * (m + m.mH))
    pt = rho.permute(0, 3, 2, 1).reshape(d1 * d2, d1 * d2)
    wpt = torch.linalg.eigvalsh(0.5 * (pt + pt.mH))
    neg = torch.where(wpt < 0, -wpt, torch.zeros_like(wpt)).sum()
    return herm, w.sum(), neg


def _edge_env(cells, msg_sites: MsgSites, N: int, chi: int, chi_msg: int, edge: UpdateEdge):
    """(t1, t2, env) — the sandwich environment of one edge (the JAX
    package's ``_edge_env_jit``)."""
    t1, t2, env, _ = E.edge_environment_sites(cells, msg_sites, N, chi, chi_msg, edge)
    return t1, t2, env


def _measure_from_env(t1, t2, env, h):
    """(energy, negativity, ⟨x/y/z⟩ per site) from one edge environment
    (the JAX package's ``_measure_from_env_jit``)."""
    rho = K.rho_ij(t1, t2, env)
    energy = K.expectation(rho, h)
    _, _, neg = _rho_health(rho)
    rho_i = torch.einsum("iIjj->iI", rho)
    rho_j = torch.einsum("iijJ->jJ", rho)
    exps = {}
    for name in ("x", "y", "z"):
        op = torch.as_tensor(pauli.ALL[name], dtype=rho.dtype, device=rho.device)
        exps[name] = (torch.einsum("iI,Ii->", rho_i, op), torch.einsum("jJ,Jj->", rho_j, op))
    return energy, neg, exps


def edge_measure(N: int, D: int, chi: int, chi_msg: int, edge: UpdateEdge):
    """(cells, msg_sites, h) → (energy, negativity, ⟨xyz⟩ per site) of one
    edge class."""

    def run(cells, msg_sites: MsgSites, h):
        t1, t2, env = _edge_env(cells, msg_sites, N, chi, chi_msg, edge)
        return _measure_from_env(t1, t2, env, h)

    return run


# ----------------------------- ITE update ---------------------------------


def _unpermute(t: torch.Tensor, perm) -> torch.Tensor:
    """Undo a virtual-leg permutation of a [d, D,D,D,D] ket."""
    inv = [0] * 4
    for i, p in enumerate(perm):
        inv[p] = i
    return t.permute((0,) + tuple(i + 1 for i in inv))


def _gate_als(t1, t2, env, h, dt, D: int, als_iters: int, normalize: bool):
    """(t1', t2', energy, hermiticity defect, eigenvalue sum, negativity):
    gate, ALS truncation to D, and the pair's new RDM in the old env (the
    JAX package's ``_gate_als_jit``)."""
    g = K.gate_from_hamiltonian(h, dt)
    t1n, t2n, _ = K.apply_gate(g, D, t1, t2, env, als_iters=als_iters)
    rho = K.rho_ij(t1n, t2n, env)
    energy = K.expectation(rho, h).real
    herm, sum_eig, neg = _rho_health(rho)
    if normalize:
        t1n = t1n / torch.linalg.vector_norm(t1n)
        t2n = t2n / torch.linalg.vector_norm(t2n)
    return t1n, t2n, energy, herm, sum_eig, neg


def edge_update(N: int, D: int, chi: int, chi_msg: int, edge: UpdateEdge,
                als_iters: int, normalize: bool):
    """(cells, msg_sites, h, dt) → (new_cells, energy, herm, sum_eig, neg):
    one ITE edge update — the edge environment (one K1 launch), gate and
    ALS, and the write-back of the pair into the cell's leg order. The
    scalars stay 0-dim device tensors."""

    def run(cells, msg_sites: MsgSites, h, dt):
        t1, t2, env, (p1, p2) = E.edge_environment_sites(cells, msg_sites, N, chi, chi_msg, edge)
        t1n, t2n, energy, herm, sum_eig, neg = _gate_als(t1, t2, env, h, dt, D, als_iters,
                                                         normalize)
        new_cells = list(cells)
        new_cells[int(edge.first)] = _unpermute(t1n, p1)
        new_cells[int(edge.second)] = _unpermute(t2n, p2)
        return tuple(new_cells), energy, herm, sum_eig, neg

    return run
