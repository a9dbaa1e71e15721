# Copied from the JAX package, the repo's reference implementation: kagomeperiodicbp_tpu/lattices/kagome.py
# (the block's lattice geometry and its plans); the reference imports neither package.
"""The Kagome block: 3 nodes (up/left/right of an "upper triangle") per
triangular-lattice vertex, hexagon-shaped, with named edges and per-leg
directions.

Equivalent structure to the reference's ``KagomeLattice``
(src/lattices/kagome.py:352) but built as flat numpy-backed
tables (positions, leg→neighbor maps) rather than object graphs, so the plan
compiler can consume it directly.

Node index convention: node ``3t + k`` belongs to triangle ``t`` with
``k ∈ {0: up, 1: left, 2: right}``.

Leg/direction convention per node kind (fixed by the lattice geometry;
same as reference kagome.py:121-126):

* up:    [UL, DL, DR, UR]
* left:  [L,  DL, R,  UR]
* right: [UL, L,  DR, R ]

Unit-cell tensors (d, leg0..leg3) use the same leg order.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import triangle
from .directions import BlockSide, LatticeDir

# node-kind → the 4 leg directions, in tensor-leg order
NODE_KIND_DIRS: Tuple[Tuple[LatticeDir, ...], ...] = (
    (LatticeDir.UL, LatticeDir.DL, LatticeDir.DR, LatticeDir.UR),  # up
    (LatticeDir.L, LatticeDir.DL, LatticeDir.R, LatticeDir.UR),    # left
    (LatticeDir.UL, LatticeDir.L, LatticeDir.DR, LatticeDir.R),    # right
)
UP, LEFT, RIGHT = 0, 1, 2

# offset of each node from its triangle's centre (true geometry; any radius
# 0 < c < 1 keeps planarity — see planner docs)
_C = 0.7
NODE_OFFSETS = (
    (0.0, _C),                                        # up
    (_C * math.cos(7 * math.pi / 6), _C * math.sin(7 * math.pi / 6)),  # left
    (_C * math.cos(-math.pi / 6), _C * math.sin(-math.pi / 6)),        # right
)

# which node of a triangle touches a given boundary side
# (reference: kagome.py:129-137)
_BOUNDARY_NODE_KINDS: Dict[BlockSide, Tuple[int, ...]] = {
    BlockSide.U: (UP,),
    BlockSide.DL: (LEFT,),
    BlockSide.DR: (RIGHT,),
    BlockSide.D: (LEFT, RIGHT),
    BlockSide.UR: (UP, RIGHT),
    BlockSide.UL: (UP, LEFT),
}

# inter-triangle wiring: moving from triangle t in lattice direction d,
# which node of t connects to which node of the neighbour triangle
# (reference: kagome.py:240-273). Each entry: d → (kind_here, kind_there);
# the connecting leg of `kind_here` points in direction d.
_INTER_TRIANGLE: Dict[LatticeDir, Tuple[int, int]] = {
    LatticeDir.L: (LEFT, RIGHT),
    LatticeDir.DL: (LEFT, UP),
    LatticeDir.DR: (RIGHT, UP),
    LatticeDir.R: (RIGHT, LEFT),
    LatticeDir.UR: (UP, LEFT),
    LatticeDir.UL: (UP, RIGHT),
}

# intra-triangle wiring: (kind1, dir1→2, kind2); the reverse leg is opposite
_INTRA_TRIANGLE = (
    (UP, LatticeDir.DL, LEFT),
    (UP, LatticeDir.DR, RIGHT),
    (LEFT, LatticeDir.R, RIGHT),
)


def num_message_sites(N: int) -> int:
    """Number of boundary legs per hexagon side = message-MPS length."""
    return 2 * N - 1


@dataclass(frozen=True)
class KagomeBlock:
    """Static geometry of a size-N Kagome block. All arrays are host-side."""

    N: int
    n_nodes: int
    positions: np.ndarray          # [n_nodes, 2]
    kinds: np.ndarray              # [n_nodes] ∈ {0,1,2}
    triangles: np.ndarray          # [n_nodes] triangle index
    # neighbor[v, leg] = neighboring node index, or -1 if boundary leg
    neighbors: np.ndarray          # [n_nodes, 4]
    # neighbor_leg[v, leg] = leg index on the neighbor that connects back
    neighbor_legs: np.ndarray      # [n_nodes, 4]
    # boundary_side[v, leg] = BlockSide int of the outer face, or -1
    boundary_sides: np.ndarray     # [n_nodes, 4]
    # boundary_rank[v, leg] = position of this outer leg in the ccw-sorted
    # boundary-edge list of its side, or -1
    boundary_ranks: np.ndarray     # [n_nodes, 4]

    # ---------------- constructors ----------------

    @staticmethod
    @functools.cache
    def build(N: int) -> "KagomeBlock":
        assert N >= 2, "block size must be at least 2"
        nt = triangle.total_vertices(N)
        n_nodes = 3 * nt
        tri_pos = triangle.all_positions(N)

        positions = np.zeros((n_nodes, 2))
        kinds = np.zeros(n_nodes, dtype=np.int64)
        tri_of = np.zeros(n_nodes, dtype=np.int64)
        neighbors = np.full((n_nodes, 4), -1, dtype=np.int64)
        neighbor_legs = np.full((n_nodes, 4), -1, dtype=np.int64)
        boundary_sides = np.full((n_nodes, 4), -1, dtype=np.int64)
        boundary_ranks = np.full((n_nodes, 4), -1, dtype=np.int64)

        for t in range(nt):
            for k in range(3):
                v = 3 * t + k
                kinds[v] = k
                tri_of[v] = t
                positions[v] = tri_pos[t] + np.array(NODE_OFFSETS[k])

        def leg_of(kind: int, d: LatticeDir) -> int:
            return NODE_KIND_DIRS[kind].index(d)

        # intra-triangle edges
        for t in range(nt):
            for k1, d, k2 in _INTRA_TRIANGLE:
                v1, v2 = 3 * t + k1, 3 * t + k2
                l1, l2 = leg_of(k1, d), leg_of(k2, d.opposite())
                neighbors[v1, l1], neighbors[v2, l2] = v2, v1
                neighbor_legs[v1, l1], neighbor_legs[v2, l2] = l2, l1

        # inter-triangle edges
        for t in range(nt):
            for d in LatticeDir.all_ccw():
                t2 = triangle.neighbor_index(t, d, N)
                if t2 is None:
                    continue
                k1, k2 = _INTER_TRIANGLE[d]
                v1, v2 = 3 * t + k1, 3 * t2 + k2
                l1, l2 = leg_of(k1, d), leg_of(k2, d.opposite())
                neighbors[v1, l1], neighbors[v2, l2] = v2, v1
                neighbor_legs[v1, l1], neighbor_legs[v2, l2] = l2, l1

        block = KagomeBlock(
            N=N,
            n_nodes=n_nodes,
            positions=positions,
            kinds=kinds,
            triangles=tri_of,
            neighbors=neighbors,
            neighbor_legs=neighbor_legs,
            boundary_sides=boundary_sides,
            boundary_ranks=boundary_ranks,
        )

        # tag boundary (open) legs with side + ccw rank
        for side in BlockSide:
            for rank, (v, leg) in enumerate(block._derive_boundary_legs(side)):
                assert neighbors[v, leg] == -1, "boundary leg must be open"
                boundary_sides[v, leg] = int(side)
                boundary_ranks[v, leg] = rank

        # sanity: every leg is either connected or tagged
        open_legs = (neighbors == -1)
        assert (boundary_sides[open_legs] >= 0).all(), "untagged open leg"
        return block

    # ---------------- boundary derivation ----------------

    def boundary_nodes(self, side: BlockSide) -> List[int]:
        """Nodes on a face, sorted ccw (by projection on side.orthogonal_ccw()).
        (reference: _common.py:92, kagome.py:466)"""
        kinds_on_side = _BOUNDARY_NODE_KINDS[side]
        members = []
        for t in range(triangle.total_vertices(self.N)):
            if side in triangle.boundaries_of_vertex(t, self.N):
                for k in kinds_on_side:
                    members.append(3 * t + k)
        u = np.array(side.orthogonal_ccw().unit)
        members.sort(key=lambda v: float(self.positions[v] @ u))
        return members

    def _derive_boundary_legs(self, side: BlockSide) -> List[Tuple[int, int]]:
        """The 2N−1 outer legs of a face, ccw-sorted: (node, leg) pairs.

        Logic (reference kagome.py:470-498): walk the ccw-sorted boundary
        nodes; each contributes its legs pointing in the side's two matching
        lattice directions (in ccw order); drop the trailing leg/node so each
        corner leg belongs to exactly one side.
        """
        nodes = self.boundary_nodes(side)
        n_msg = num_message_sites(self.N)
        d_lo, d_hi = side.matching_lattice_dirs()  # ccw order: angle−30°, +30°
        res: List[Tuple[int, int]] = []
        for v in nodes:
            dirs = NODE_KIND_DIRS[self.kinds[v]]
            for d in (d_lo, d_hi):
                if d in dirs:
                    res.append((v, dirs.index(d)))
            if len(res) >= n_msg + 1:
                break
        # Single-node-per-triangle faces (N nodes, 2 legs each = 2N legs):
        # drop the last leg. Two-node faces (2N nodes, 1 leg each): drop the
        # last node's leg. Both cases: keep the first 2N−1.
        assert len(res) >= n_msg
        return res[:n_msg]

    def boundary_legs(self, side: BlockSide) -> List[Tuple[int, int]]:
        res = []
        for v in range(self.n_nodes):
            for leg in range(4):
                if self.boundary_sides[v, leg] == int(side):
                    res.append((self.boundary_ranks[v, leg], v, leg))
        res.sort()
        return [(v, leg) for _, v, leg in res]

    # ---------------- rows / core ----------------

    def nodes_rows_in_direction(self, major: BlockSide) -> List[List[int]]:
        """Kagome-node rows swept toward `major` (generic positional version
        of reference kagome.py:410)."""
        maj = np.array(major.unit)
        mino = np.array(major.orthogonal_ccw().unit)
        p_major = self.positions @ maj
        p_minor = self.positions @ mino
        keys = np.round(p_major, 6)
        rows = []
        for k in np.unique(keys):
            members = np.where(keys == k)[0]
            members = members[np.argsort(p_minor[members])]
            rows.append([int(v) for v in members])
        return rows

    @property
    def center_triangle(self) -> int:
        return triangle.center_vertex_index(self.N)

    def center_nodes(self) -> List[int]:
        t = self.center_triangle
        return [3 * t + k for k in range(3)]

    def core_nodes(self) -> List[int]:
        """The 9 core nodes, ascending index: the centre triangle's 3 nodes
        ("center core") plus their 6 nearest neighbours ("around core").
        (reference tagging: tensor_network.py:936-947)
        """
        center = set(self.center_nodes())
        around = set()
        for v in center:
            for leg in range(4):
                n = int(self.neighbors[v, leg])
                if n >= 0 and n not in center:
                    around.add(n)
        assert len(around) == 6
        return sorted(center | around)

    def around_core_nodes(self) -> List[int]:
        center = set(self.center_nodes())
        return [v for v in self.core_nodes() if v not in center]

    def node_dirs(self, v: int) -> Tuple[LatticeDir, ...]:
        return NODE_KIND_DIRS[self.kinds[v]]
