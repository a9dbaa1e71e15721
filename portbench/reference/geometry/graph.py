# Copied from the JAX package, the repo's reference implementation: kagomeperiodicbp_tpu/networks/graph.py
# (the block's lattice geometry and its plans); the reference imports neither package.
"""Contraction-graph representation of the Kagome block tensor network.

A ``TNGraph`` is the *static* planar structure consumed by the plan compiler
(planner/compiler.py) and the exact oracle (ops/exact.py): node positions,
per-leg angles/dims, adjacency, and a ``source`` descriptor saying how to
fetch each node's tensor at execution time.  No tensor data lives here.

Node sources:
* ``("lat", v)``      — fused (ket⊗bra) unit-cell tensor of lattice node v;
                         flavor = v % 3 (A=up, B=left, C=right), legs D².
* ``("msg", side, k)``— site k of the incoming boundary-MPS message of
                         ``side``; legs [bond_prev, phys=D², bond_next].

Messages are stored in the *canonical padded bond profile* so all shapes are
static per (N, D, χ):  bond k = min(χ, (D²)^(k+1), (D²)^(n−1−k)).

Replaces the reference's TensorNode/KagomeTensorNetwork object graph
(src/tensor_networks/tensor_network.py:63-335) with flat
tables + static plans.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .directions import BlockSide, LatticeDir
from .kagome import KagomeBlock
from .kagome import num_message_sites

Source = Tuple  # ("lat", v) | ("msg", side_int, k)


@dataclass
class GraphNode:
    nid: int
    pos: Tuple[float, float]
    angles: List[float]                      # one per leg
    dims: List[int]                          # one per leg
    # (other_nid, other_leg) per leg; None = open leg
    neighbors: List[Optional[Tuple[int, int]]]
    source: Source


@dataclass
class TNGraph:
    nodes: List[GraphNode]

    def node(self, nid: int) -> GraphNode:
        return self.nodes[nid]

    @property
    def n_nodes(self) -> int:
        return len(self.nodes)

    def open_legs(self) -> List[Tuple[int, int]]:
        res = []
        for node in self.nodes:
            for leg, nb in enumerate(node.neighbors):
                if nb is None:
                    res.append((node.nid, leg))
        return res

    def subgraph_without(self, drop: set) -> "TNGraph":
        """New graph with `drop` node ids removed; edges into dropped nodes
        become open legs. Node ids are re-indexed; `source` keeps identity."""
        keep = [n.nid for n in self.nodes if n.nid not in drop]
        remap = {old: new for new, old in enumerate(keep)}
        new_nodes = []
        for old in keep:
            n = self.nodes[old]
            nbs: List[Optional[Tuple[int, int]]] = []
            for nb in n.neighbors:
                if nb is None or nb[0] in drop:
                    nbs.append(None)
                else:
                    nbs.append((remap[nb[0]], nb[1]))
            new_nodes.append(
                GraphNode(
                    nid=remap[old],
                    pos=n.pos,
                    angles=list(n.angles),
                    dims=list(n.dims),
                    neighbors=nbs,
                    source=n.source,
                )
            )
        return TNGraph(new_nodes)

    def validate(self) -> None:
        """Structural invariants (the reference's DEBUG_MODE `_validate_tn`,
        tensor_network.py:1072)."""
        for n in self.nodes:
            assert len(n.angles) == len(n.dims) == len(n.neighbors)
            for leg, nb in enumerate(n.neighbors):
                if nb is None:
                    continue
                other, oleg = nb
                back = self.nodes[other].neighbors[oleg]
                assert back == (n.nid, leg), f"non-reciprocal edge {n.nid}:{leg}"
                assert self.nodes[other].dims[oleg] == n.dims[leg], "dim mismatch"


def message_bond_profile(N: int, D: int, chi: int) -> List[int]:
    """Canonical padded bond dims of a message MPS: n−1 internal bonds."""
    n = num_message_sites(N)
    p = D * D
    return [min(chi, p ** (k + 1), p ** (n - 1 - k)) for k in range(n - 1)]


def build_block_graph(block: KagomeBlock, D: int) -> TNGraph:
    """Lattice part only (fused double layer, every leg D²)."""
    p = D * D
    nodes = []
    for v in range(block.n_nodes):
        dirs = block.node_dirs(v)
        nbs: List[Optional[Tuple[int, int]]] = []
        for leg in range(4):
            nb = int(block.neighbors[v, leg])
            nbs.append(None if nb < 0 else (nb, int(block.neighbor_legs[v, leg])))
        nodes.append(
            GraphNode(
                nid=v,
                pos=(float(block.positions[v, 0]), float(block.positions[v, 1])),
                angles=[d.angle for d in dirs],
                dims=[p] * 4,
                neighbors=nbs,
                source=("lat", v),
            )
        )
    return TNGraph(nodes)


def attach_messages(
    graph: TNGraph,
    block: KagomeBlock,
    D: int,
    chi: int,
    sides: Sequence[BlockSide] = tuple(BlockSide),
) -> TNGraph:
    """Append message-MPS nodes for each side (ccw site order matching
    boundary ranks) and join adjacent messages at corners with dim-1 bonds
    (the reference's `connect_corner_messages` fake legs,
    contract_tensor_network.py:99)."""
    nodes = [
        GraphNode(n.nid, n.pos, list(n.angles), list(n.dims), list(n.neighbors), n.source)
        for n in graph.nodes
    ]
    N = block.N
    n_msg = num_message_sites(N)
    profile = message_bond_profile(N, D, chi)
    side_first: Dict[int, int] = {}  # side -> nid of its first message node
    side_last: Dict[int, int] = {}

    # normal coordinate of each side's message line: just outside the block
    all_pos = np.array([n.pos for n in graph.nodes])

    for side in sides:
        legs = block.boundary_legs(side)
        assert len(legs) == n_msg
        nhat = np.array(side.unit)
        that = np.array(side.orthogonal_ccw().unit)
        c_line = float((all_pos @ nhat).max()) + 1.4
        prev_nid: Optional[int] = None
        for k, (v, vleg) in enumerate(legs):
            nid = len(nodes)
            d_out = block.node_dirs(v)[vleg]
            # collinear placement on the side's outer line (keeps every
            # message chain monotone under any sweep direction — the planner
            # relies on this):
            mid = np.array(graph.nodes[v].pos) + 0.7 * np.array(d_out.unit)
            t_coord = float(mid @ that)
            mpos_vec = t_coord * that + c_line * nhat
            mpos = (float(mpos_vec[0]), float(mpos_vec[1]))
            # legs: [bond_prev, phys, bond_next]
            phys_angle = (d_out.angle + math.pi) % (2 * math.pi)
            dim_prev = 1 if k == 0 else profile[k - 1]
            dim_next = 1 if k == n_msg - 1 else profile[k]
            # bond angles point along the boundary traversal (ccw): next bond
            # toward the next message node; prev toward the previous.
            next_angle = side.orthogonal_ccw().angle
            prev_angle = side.orthogonal_cw().angle
            node = GraphNode(
                nid=nid,
                pos=mpos,
                angles=[prev_angle, phys_angle, next_angle],
                dims=[dim_prev, D * D, dim_next],
                neighbors=[None, (v, vleg), None],
                source=("msg", int(side), k),
            )
            assert nodes[v].neighbors[vleg] is None, "boundary leg already used"
            nodes[v].neighbors[vleg] = (nid, 1)
            if prev_nid is not None:
                node.neighbors[0] = (prev_nid, 2)
                nodes[prev_nid].neighbors[2] = (nid, 0)
            else:
                side_first[int(side)] = nid
            nodes.append(node)
            prev_nid = nid
        side_last[int(side)] = prev_nid  # type: ignore[assignment]

    # corner joins (dim-1): last node of side s ↔ first node of the
    # geometrically-adjacent ccw-next side, when both are present.
    for s in sides:
        s_next = s.rotate_ccw()
        if int(s) in side_last and int(s_next) in side_first:
            a, b = side_last[int(s)], side_first[int(s_next)]
            nodes[a].neighbors[2] = (b, 0)
            nodes[b].neighbors[0] = (a, 2)

    g = TNGraph(nodes)
    g.validate()
    return g


def full_graph(N: int, D: int, chi: int, sides: Sequence[BlockSide] = tuple(BlockSide)) -> TNGraph:
    block = KagomeBlock.build(N)
    return attach_messages(build_block_graph(block, D), block, D, chi, sides)
