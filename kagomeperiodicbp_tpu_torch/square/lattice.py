"""Square-lattice periodic blocks: geometry + contraction graph (the
port's copy of kagomeperiodicbp_tpu/square/lattice.py, numpy only).

Re-design of the reference's legacy square-lattice engine
(src/libs/squareITE.py:559 `create_periodic_random_2D_PEPS`,
:105 `_contraction_order_per_direction`, :298 `all_boundary_tensors`): the
same planner/executor that serves the Kagome block compiles square-block
plans — only the graph differs.

A block is n×n sites, each with legs [U, L, D, R] (angles 90°/180°/270°/0°)
plus the physical leg folded into the double layer. Boundary-MPS messages
run along the 4 sides with the same canonical padded bond profile as the
Kagome messages.
"""
from __future__ import annotations

import math
from enum import IntEnum
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..networks.graph import GraphNode, TNGraph

# site legs (named to avoid clashing with bond-dimension parameters)
LEG_U, LEG_L, LEG_D, LEG_R = 0, 1, 2, 3
_LEG_ANGLE = {LEG_U: math.pi / 2, LEG_L: math.pi, LEG_D: 3 * math.pi / 2, LEG_R: 0.0}
_OPP_LEG = {LEG_U: LEG_D, LEG_D: LEG_U, LEG_L: LEG_R, LEG_R: LEG_L}


class SquareSide(IntEnum):
    """Duck-types BlockSide for the plan compiler (unit / orthogonal_ccw /
    opposite are all `sweep_order`/BP need)."""

    UP = 0
    LEFT = 1
    DOWN = 2
    RIGHT = 3

    @property
    def angle(self) -> float:
        return {0: math.pi / 2, 1: math.pi, 2: 3 * math.pi / 2, 3: 0.0}[int(self)]

    @property
    def unit(self) -> Tuple[float, float]:
        a = self.angle
        return (math.cos(a), math.sin(a))

    def opposite(self) -> "SquareSide":
        return SquareSide((int(self) + 2) % 4)

    def orthogonal_ccw(self) -> "SquareSide":
        return SquareSide((int(self) + 1) % 4)  # +90°: ccw of UP is LEFT

    def orthogonal_cw(self) -> "SquareSide":
        return SquareSide((int(self) + 3) % 4)

    def rotate_ccw(self) -> "SquareSide":
        return SquareSide((int(self) + 1) % 4)


def site_index(i: int, j: int, n: int) -> int:
    """Row-major node id for site (row i from bottom, column j)."""
    return i * n + j


def build_square_graph(n: int, D: int) -> TNGraph:
    """Lattice part of the n×n block (fused double layer, every leg D²).
    Open boundary legs point outward; messages attach to them."""
    p = D * D
    nodes: List[GraphNode] = []
    for i in range(n):
        for j in range(n):
            v = site_index(i, j, n)
            nbs: List[Optional[Tuple[int, int]]] = [None] * 4
            if i < n - 1:
                nbs[LEG_U] = (site_index(i + 1, j, n), LEG_D)
            if j > 0:
                nbs[LEG_L] = (site_index(i, j - 1, n), LEG_R)
            if i > 0:
                nbs[LEG_D] = (site_index(i - 1, j, n), LEG_U)
            if j < n - 1:
                nbs[LEG_R] = (site_index(i, j + 1, n), LEG_L)
            nodes.append(
                GraphNode(
                    nid=v,
                    pos=(float(j), float(i)),
                    angles=[_LEG_ANGLE[leg] for leg in (LEG_U, LEG_L, LEG_D, LEG_R)],
                    dims=[p] * 4,
                    neighbors=nbs,
                    source=("lat", v),
                )
            )
    return TNGraph(nodes)


def boundary_legs(n: int, side: SquareSide) -> List[Tuple[int, int]]:
    """(site, leg) pairs along `side`, ordered ccw as seen from outside the
    block walking the boundary counterclockwise (matches the Kagome message
    convention: site k of side S ↔ boundary rank k)."""
    if side == SquareSide.UP:        # ccw along top: right→left
        return [(site_index(n - 1, j, n), LEG_U) for j in range(n - 1, -1, -1)]
    if side == SquareSide.LEFT:      # left column: top→bottom
        return [(site_index(i, 0, n), LEG_L) for i in range(n - 1, -1, -1)]
    if side == SquareSide.DOWN:      # bottom row: left→right
        return [(site_index(0, j, n), LEG_D) for j in range(n)]
    # RIGHT: bottom→top
    return [(site_index(i, n - 1, n), LEG_R) for i in range(n)]


def square_message_profile(n: int, D: int, chi: int) -> List[int]:
    p = D * D
    return [min(chi, p ** (k + 1), p ** (n - 1 - k)) for k in range(n - 1)]


def attach_square_messages(
    graph: TNGraph,
    n: int,
    D: int,
    chi: int,
    sides: Sequence[SquareSide] = tuple(SquareSide),
) -> TNGraph:
    """Boundary-MPS message nodes along each side + dim-1 corner joins (the
    square analog of networks.graph.attach_messages)."""
    nodes = [
        GraphNode(m.nid, m.pos, list(m.angles), list(m.dims), list(m.neighbors), m.source)
        for m in graph.nodes
    ]
    profile = square_message_profile(n, D, chi)
    side_first: Dict[int, int] = {}
    side_last: Dict[int, int] = {}
    all_pos = np.array([m.pos for m in graph.nodes])

    for side in sides:
        legs = boundary_legs(n, side)
        nhat = np.array(side.unit)
        that = np.array(side.orthogonal_ccw().unit)
        c_line = float((all_pos @ nhat).max()) + 1.2
        prev_nid: Optional[int] = None
        for k, (v, vleg) in enumerate(legs):
            nid = len(nodes)
            t_coord = float(np.array(graph.nodes[v].pos) @ that)
            mpos_vec = t_coord * that + c_line * nhat
            mpos = (float(mpos_vec[0]), float(mpos_vec[1]))
            phys_angle = (_LEG_ANGLE[vleg] + math.pi) % (2 * math.pi)
            dim_prev = 1 if k == 0 else profile[k - 1]
            dim_next = 1 if k == n - 1 else profile[k]
            node = GraphNode(
                nid=nid,
                pos=mpos,
                angles=[side.orthogonal_cw().angle, phys_angle,
                        side.orthogonal_ccw().angle],
                dims=[dim_prev, D * D, dim_next],
                neighbors=[None, (v, vleg), None],
                source=("msg", int(side), k),
            )
            assert nodes[v].neighbors[vleg] is None
            nodes[v].neighbors[vleg] = (nid, 1)
            if prev_nid is not None:
                node.neighbors[0] = (prev_nid, 2)
                nodes[prev_nid].neighbors[2] = (nid, 0)
            else:
                side_first[int(side)] = nid
            nodes.append(node)
            prev_nid = nid
        side_last[int(side)] = prev_nid  # type: ignore[assignment]

    for s in sides:
        s_next = s.rotate_ccw()
        if int(s) in side_last and int(s_next) in side_first:
            a, b = side_last[int(s)], side_first[int(s_next)]
            nodes[a].neighbors[2] = (b, 0)
            nodes[b].neighbors[0] = (a, 2)

    g = TNGraph(nodes)
    g.validate()
    return g


def full_square_graph(n: int, D: int, chi: int,
                      sides: Sequence[SquareSide] = tuple(SquareSide)) -> TNGraph:
    return attach_square_messages(build_square_graph(n, D), n, D, chi, sides)
