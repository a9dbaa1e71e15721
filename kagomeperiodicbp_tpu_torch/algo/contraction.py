"""Contraction facade: binds unit-cell tensors and messages to compiled plans
and runs them (counterpart of kagomeperiodicbp_tpu/algo/contraction.py).
Plans are host-side ``lru_cache``s; execution is eager.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Sequence, Tuple

import torch

from ..lattices import BlockSide
from ..lattices.kagome import num_message_sites
from ..networks.graph import TNGraph, full_graph, message_bond_profile
from ..networks.unit_cell import FLAVORS, UnitCell
from ..ops import mps as mpslib
from ..ops.contract import execute_plan
from ..ops.kernels import fused_tensors
from ..ops.mps import MPS
from ..planner.compiler import Plan, compile_plan

MessageDict = Dict[BlockSide, MPS]
MsgSites = Dict[int, Tuple[torch.Tensor, ...]]  # side int → site tensors


# --------------------------- plan caching ---------------------------------


@functools.lru_cache(maxsize=None)
def _graph_for(N: int, D: int, chi_msg: int, sides: Tuple[int, ...]) -> TNGraph:
    return full_graph(N, D, chi_msg, tuple(BlockSide(s) for s in sides))


@functools.lru_cache(maxsize=None)
def to_message_plan(N: int, D: int, chi: int, chi_msg: int, toward: int) -> Plan:
    """Plan for the outgoing message toward side `toward`: contract the block
    and the other 5 incoming messages."""
    sides = tuple(int(s) for s in BlockSide if int(s) != toward)
    return compile_plan(_graph_for(N, D, chi_msg, sides), BlockSide(toward), chi)


@functools.lru_cache(maxsize=None)
def full_scalar_plan(N: int, D: int, chi: int, chi_msg: int, toward: int = int(BlockSide.U)) -> Plan:
    graph = _graph_for(N, D, chi_msg, tuple(int(s) for s in BlockSide))
    return compile_plan(graph, BlockSide(toward), chi)


# --------------------------- tensor binding -------------------------------


def site_kets(cell) -> Tuple[torch.Tensor, ...]:
    """A unit cell's three kets (A, B, C), or a per-site view's one ket per
    block site (anything exposing ``_tensors``, as in the JAX package)."""
    if hasattr(cell, "_tensors"):
        return tuple(cell._tensors)
    return tuple(cell[f] for f in FLAVORS)


def fused_sites(kets: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """The fused double-layer tensor of each ket: one launch of kernel K1
    per three kets on the card."""
    return tuple(f for i in range(0, len(kets), 3) for f in fused_tensors(kets[i:i + 3]))


def fused_cells(cell) -> Tuple[torch.Tensor, ...]:
    """The fused double-layer tensors: 3 for a unit cell (one K1 launch),
    one per site for a per-site view (one launch per three sites)."""
    return fused_sites(site_kets(cell))


def _make_fetch(fused: Optional[Sequence[torch.Tensor]], msgs: MsgSites,
                kets: Optional[Sequence[torch.Tensor]] = None):
    """source → tensor: a fused tensor for ("lat", v), the raw ket for
    ("ket", v) (single-layer plans), a message site for ("msg", side, k)."""
    def fetch(source):
        if source[0] == "lat":
            return fused[source[1] % len(fused)]
        if source[0] == "ket":
            return kets[source[1] % len(kets)]
        _, side, k = source
        return msgs[side][k]

    return fetch


def run_plan(plan: Plan, cell_or_fused, messages: Optional[MessageDict]):
    """Execute `plan` with the given unit cell (or fused tensors) and
    messages. Returns an MPS with the messages' logscales folded in, or
    (mantissa, log) for a scalar plan."""
    fused = fused_cells(cell_or_fused) if isinstance(cell_or_fused, UnitCell) else tuple(cell_or_fused)
    used_sides = {st.source[1] for st in plan.steps if st.source[0] == "msg"}
    msg_sites: MsgSites = {}
    extra_log = 0.0
    for side, m in (messages or {}).items():
        if int(side) in used_sides:
            msg_sites[int(side)] = tuple(m.sites)
            extra_log = extra_log + m.logscale
    missing = used_sides - set(msg_sites)
    if missing:
        raise ValueError(f"plan needs messages for sides {missing}")
    out = execute_plan(plan, _make_fetch(fused, msg_sites))
    if isinstance(out, MPS):
        return MPS(out.sites, out.logscale + extra_log)
    mantissa, log = out
    return mantissa, log + extra_log


# --------------------------- message helpers ------------------------------


def initial_messages(N: int, D: int, chi: int, model: str = "uniform",
                     generator: Optional[torch.Generator] = None,
                     dtype=torch.complex128, device=None) -> MessageDict:
    """Fresh incoming messages for all 6 sides, in canonical padded profile.
    The models are ``uniform``, ``random``, ``uniform-classic`` and
    ``random-classic``; the random ones draw from `generator` (a CPU
    generator seeded 0 if None), torch's numbers, not jax.random's."""
    n = num_message_sites(N)
    profile = message_bond_profile(N, D, chi)
    if model.startswith("random") and generator is None:
        generator = torch.Generator().manual_seed(0)
    msgs: MessageDict = {}
    for side in BlockSide:
        if model == "uniform":
            m = mpslib.uniform_message(D, n, dtype, device)
        elif model == "random":
            m = mpslib.random_message(D, n, generator, dtype, device)
        elif model == "uniform-classic":
            m = mpslib.classical_message(D, n, None, dtype, device)
        elif model == "random-classic":
            m = mpslib.classical_message(D, n, generator, dtype, device)
        else:
            raise ValueError(f"unknown message model {model!r}")
        msgs[side] = mpslib.pad_bonds(m, profile)
    return msgs


def pad_messages(messages: MessageDict, N: int, D: int, chi_msg: int) -> MessageDict:
    """Messages of a cell padded to bond dimension D (``UnitCell.pad_to``
    with no noise): each fused leg's ket and bra halves zero-padded to D,
    the bonds to the canonical profile at D. The padded network holds the
    same state, so these are its messages."""
    out = {}
    for side, m in messages.items():
        sites = []
        for s in m.sites:
            l, p, r = s.shape
            d0 = int(round(p ** 0.5))
            t = s.new_zeros((l, D, D, r))
            t[:, :d0, :d0, :] = s.reshape(l, d0, d0, r)
            sites.append(t.reshape(l, D * D, r))
        out[side] = mpslib.pad_bonds(MPS(tuple(sites), m.logscale),
                                     message_bond_profile(N, D, chi_msg))
    return out


def finalize_outgoing(raw: MPS, plan: Plan, graph_boundary_count: int) -> MPS:
    """Fold the dim-1 corner end sites of a raw ToMessage frontier into
    their neighbours."""
    sites = list(raw.sites)
    while len(sites) > graph_boundary_count:
        if sites[0].shape[1] == 1:
            m = sites[0].reshape(sites[0].shape[0], sites[0].shape[2])
            sites[1] = mpslib.lmul(m, sites[1])
            sites = sites[1:]
        elif sites[-1].shape[1] == 1:
            m = sites[-1].reshape(sites[-1].shape[0], sites[-1].shape[2])
            sites[-2] = mpslib.rmul(sites[-2], m)
            sites = sites[:-1]
        else:
            raise AssertionError("unexpected extra non-trivial site in message")
    if sites[0].shape[0] != 1 or sites[-1].shape[2] != 1:
        raise AssertionError("message end bonds must be trivial")
    return MPS(tuple(sites), raw.logscale)


def message_postprocess(raw: MPS, plan: Plan, N: int, D: int, chi_msg: int) -> MPS:
    """Raw ToMessage frontier → canonical BP message: fold corner ends,
    compress to χ, pad to the canonical profile, drop the scale."""
    out = finalize_outgoing(raw, plan, num_message_sites(N))
    out = mpslib.compress(out, chi_msg)
    out = mpslib.pad_bonds(out, message_bond_profile(N, D, chi_msg))
    return MPS(out.sites, torch.zeros_like(out.logscale))


def outgoing_message(cell_or_fused, messages: MessageDict, N: int, D: int, chi: int,
                     chi_msg: int, toward: BlockSide) -> MPS:
    """The outgoing message through side `toward`, in canonical padded
    profile with unit norm."""
    plan = to_message_plan(N, D, chi, chi_msg, int(toward))
    raw = run_plan(plan, cell_or_fused, messages)
    return message_postprocess(raw, plan, N, D, chi_msg)


# ------------------------- single-layer mode -------------------------------
# The same compiled plan run with Plan.single_layer=True: lattice steps fetch
# ("ket", v) and swallow the ket and the bra layer one after the other
# (ops/contract._swallow_ket_blob), so no fused D⁸ tensor is made.


def single_layer_plan(plan: Plan) -> Plan:
    """The same compiled plan, executed in single-layer mode."""
    return dataclasses.replace(plan, single_layer=True)


def outgoing_message_single(cell: UnitCell, messages: MessageDict, N: int, D: int, chi: int,
                            chi_msg: int, toward: BlockSide) -> MPS:
    """Single-layer ``outgoing_message``: the same message (same steps and
    truncations, each swallow reordered), with no fused tensor."""
    plan = single_layer_plan(to_message_plan(N, D, chi, chi_msg, int(toward)))
    msg_sites = {int(s): tuple(m.sites) for s, m in messages.items() if int(s) != int(toward)}
    raw = execute_plan(plan, _make_fetch(None, msg_sites, kets=(cell.A, cell.B, cell.C)))
    return message_postprocess(raw, plan, N, D, chi_msg)
