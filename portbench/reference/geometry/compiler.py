# Copied from the JAX package, the repo's reference implementation: kagomeperiodicbp_tpu/planner/compiler.py
# (the block's lattice geometry and its plans); the reference imports neither package.
"""The plan compiler: turns a planar TN graph + sweep direction into a static
list of "swallow" steps executable as one jit-compiled JAX program.

This replaces the reference's runtime contraction engine *logic*
(bubblecon's per-vertex leg angle sorting, src/libs/
bubblecon.py:2844-3062, and the snake contraction-order planner,
src/algo/contraction_order.py) with a host-side compiler: all index
bookkeeping happens once per (graph, direction, χ); execution touches only
static-shaped tensors.

Frontier convention
-------------------
Contracting toward block side ``M`` sweeps nodes by ascending projection on
``M``; the frontier MPS is ordered by ascending projection on
``u = M.orthogonal_ccw()`` (so a finished boundary message has site k at
boundary rank k of side M).

For a node being swallowed, let φ(leg) = signed_angle(u, leg direction):

* in-legs (into the swallowed region) have φ ∈ [0, π] and are consumed in
  frontier order = φ **descending**;
* out-legs have φ ∈ [−π, 0] and are inserted in frontier order = φ
  **ascending**.

Leg directions are computed from actual node positions when the neighbour
exists (robust at message corners), falling back to the recorded leg angle.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .directions import BlockSide, signed_angle
from .graph import GraphNode, Source, TNGraph

_TOL = 1e-6


@dataclass(frozen=True)
class Step:
    source: Source                 # which tensor to fetch
    perm: Tuple[int, ...]          # tensor legs → [in legs (frontier order)] + [out legs (frontier order)]
    start: int                     # frontier index of first consumed site
    n_in: int
    n_out: int
    out_dims: Tuple[int, ...]
    compress_after: bool


@dataclass
class Plan:
    steps: List[Step]
    chi: int
    # open-edge descriptor (nid, leg) of every final frontier site:
    final_sites: List[Tuple[int, int]]
    # physical dimension of each final frontier site (bond dims are runtime
    # values set by χ; only p is static):
    final_dims: List[int]
    # (target_nid, target_leg) each final site connects to, or None if the
    # underlying graph leg is open:
    final_targets: List[Optional[Tuple[int, int]]] = None  # type: ignore[assignment]
    # two-tier lazy truncation (reference D_trunc/D_trunc2,
    # bubblecon.py:2995-3011): when set, per-swallow truncation is skipped
    # until some frontier bond exceeds chi_lazy, then the whole frontier is
    # truncated to chi. None = truncate after every swallow (default).
    chi_lazy: Optional[int] = None
    # single-layer swallowing (reference bubblecon.py:1855 swallow_ket_T):
    # lattice steps fetch the raw ket tensor ("ket", v) and contract the ket
    # and bra layers separately — same plan, lower peak memory at large D.
    single_layer: bool = False

    @property
    def n_final(self) -> int:
        return len(self.final_sites)


def sweep_order(graph: TNGraph, major: BlockSide, include: Optional[set] = None) -> List[int]:
    """Node sweep order: ascending projection on `major`, then on
    `u = major.orthogonal_ccw()` (row-by-row, row-internal along frontier)."""
    m = np.array(major.unit)
    u = np.array(major.orthogonal_ccw().unit)
    nids = [n.nid for n in graph.nodes if include is None or n.nid in include]
    pos = np.array([graph.nodes[i].pos for i in nids])
    pm = np.round(pos @ m, 6)
    pu = pos @ u
    order = sorted(range(len(nids)), key=lambda k: (pm[k], pu[k]))
    return [nids[k] for k in order]


def _leg_vec(graph: TNGraph, nid: int, leg: int) -> Tuple[float, float]:
    node = graph.nodes[nid]
    nb = node.neighbors[leg]
    if nb is not None:
        other = graph.nodes[nb[0]]
        dx, dy = other.pos[0] - node.pos[0], other.pos[1] - node.pos[1]
        n = math.hypot(dx, dy)
        if n > 1e-9:
            return (dx / n, dy / n)
    a = node.angles[leg]
    return (math.cos(a), math.sin(a))


def compile_plan(
    graph: TNGraph,
    major: BlockSide,
    chi: int,
    swallow: Optional[set] = None,
) -> Plan:
    """Compile the contraction of `swallow` (default: all nodes) toward
    `major` into a static step list.

    The final frontier covers every edge from swallowed → unswallowed nodes
    plus every open leg of swallowed nodes, ordered along u.
    """
    if swallow is None:
        swallow = {n.nid for n in graph.nodes}
    order = sweep_order(graph, major, include=swallow)
    u = major.orthogonal_ccw().unit

    # frontier: list of dicts describing open MPS sites
    frontier: List[dict] = []  # {"edge": (nid, leg) of the *emitting* side, "dim": int,
    #                             "to": (nid, leg) target or None}
    steps: List[Step] = []
    swallowed: set = set()
    # map from (target_nid, target_leg) -> frontier position, rebuilt lazily
    for v in order:
        node = graph.nodes[v]
        n_legs = len(node.angles)

        # classify legs
        in_pos: List[Tuple[int, int]] = []  # (frontier_pos, leg)
        out_legs: List[int] = []
        for leg in range(n_legs):
            hit = None
            for pos_idx, site in enumerate(frontier):
                if site["to"] == (v, leg):
                    hit = pos_idx
                    break
            if hit is not None:
                in_pos.append((hit, leg))
            else:
                nb = node.neighbors[leg]
                assert nb is None or nb[0] not in swallowed, (
                    f"leg {v}:{leg} points to swallowed node but is not in frontier"
                )
                out_legs.append(leg)

        if frontier and not in_pos:
            raise AssertionError(
                f"node {v} ({node.source}) has no frontier contact — disconnected sweep"
            )

        # order checks / sorting
        in_pos.sort()
        positions = [pq for pq, _ in in_pos]
        if positions:
            start = positions[0]
            assert positions == list(range(start, start + len(positions))), (
                f"non-contiguous in-legs for node {v} ({node.source}): {positions}"
            )
        else:
            start = 0

        # φ-sanity for in-legs: frontier order must equal φ-descending
        def phi(leg: int) -> float:
            return signed_angle(u, _leg_vec(graph, v, leg))

        in_phis = [phi(leg) for _, leg in in_pos]
        in_phis_n = [ph if ph > -_TOL else ph + 2 * math.pi for ph in in_phis]
        assert all(
            in_phis_n[i] >= in_phis_n[i + 1] - _TOL for i in range(len(in_phis_n) - 1)
        ), f"in-leg φ order violated at node {v}: {in_phis_n}"

        # out-legs sorted φ-ascending with left-pointing mapped to −π
        def phi_out(leg: int) -> float:
            ph = phi(leg)
            return ph if ph <= _TOL else ph - 2 * math.pi

        out_legs.sort(key=phi_out)
        for leg in out_legs:
            ph = phi_out(leg)
            assert -math.pi - _TOL <= ph <= _TOL, (
                f"out-leg {v}:{leg} points backward (φ={ph}) — ordering bug"
            )

        perm = tuple(leg for _, leg in in_pos) + tuple(out_legs)
        out_dims = tuple(node.dims[leg] for leg in out_legs)
        n_in, n_out = len(in_pos), len(out_legs)

        # replace frontier span (index bookkeeping only — all shape logic
        # happens at trace time in the executor)
        new_sites = [
            {"edge": (v, leg), "dim": node.dims[leg], "to": node.neighbors[leg]}
            for leg in out_legs
        ]
        frontier[start : start + n_in] = new_sites

        steps.append(
            Step(
                source=node.source,
                perm=perm,
                start=start,
                n_in=n_in,
                n_out=n_out,
                out_dims=out_dims,
                compress_after=False,
            )
        )
        swallowed.add(v)

    final_sites = [s["edge"] for s in frontier]
    final_targets = [s["to"] for s in frontier]
    return Plan(
        steps=steps, chi=chi, final_sites=final_sites,
        final_dims=[s["dim"] for s in frontier], final_targets=final_targets,
    )
