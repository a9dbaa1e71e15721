# The cut-axis geometry of an edge environment, copied from the JAX package,
# the repo's reference implementation: kagomeperiodicbp_tpu/algo/edge_env.py
# (edge_pair, edge_geometry, chain_geometry) and kagomeperiodicbp_tpu/enums.py
# (the edge directions): which two nodes an edge class updates, the row of
# nodes through them, and the two halves of the network on either side of it.
# Only the geometry is copied; the reference computes every tensor itself.
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from .compiler import Plan, compile_plan
from .directions import BlockSide, LatticeDir
from .graph import TNGraph, full_graph
from .kagome import KagomeBlock

# first→second lattice direction per ordered flavor pair (A=0, B=1, C=2)
EDGE_DIRECTION = {
    (0, 1): LatticeDir.DL, (0, 2): LatticeDir.UL, (1, 0): LatticeDir.DL,
    (1, 2): LatticeDir.R, (2, 0): LatticeDir.UL, (2, 1): LatticeDir.R,
}


def edge_pair(block: KagomeBlock, first: int, second: int) -> Tuple[int, int]:
    """n1 = the centre triangle's node of flavor `first`, n2 = its neighbour
    in the edge's direction (of flavor `second`)."""
    c = block.center_triangle
    n1 = 3 * c + first
    d = EDGE_DIRECTION[(first, second)]
    leg = block.node_dirs(n1).index(d)
    n2 = int(block.neighbors[n1, leg])
    assert n2 >= 0 and n2 % 3 == second
    return n1, n2


@dataclass
class CutGeometry:
    graph: TNGraph
    chain: List[int]           # cut-row node ids in axis order
    top_leg: Dict[int, int]
    bot_leg: Dict[int, int]
    fwd: Dict[int, Optional[int]]
    bwd: Dict[int, Optional[int]]
    top_plan: Plan
    bot_plan: Plan
    top_site_of: Dict[int, int]
    bot_site_of: Dict[int, int]


def cut_geometry(N: int, D: int, chi: int, chi_msg: int, axis: LatticeDir) -> CutGeometry:
    block = KagomeBlock.build(N)
    graph = full_graph(N, D, chi_msg)
    major_top = BlockSide(round(((axis.angle + math.pi / 2) % (2 * math.pi) - math.pi / 6)
                                / (math.pi / 3)) % 6)
    major_bot = major_top.opposite()
    c = block.center_triangle
    starts = {LatticeDir.R: 3 * c + 1, LatticeDir.DL: 3 * c + 0, LatticeDir.UL: 3 * c + 2}
    n_start = starts[axis]

    def walk(v: int, d: LatticeDir) -> List[int]:
        out = []
        while True:
            leg = block.node_dirs(v).index(d)
            v = graph.nodes[v].neighbors[leg][0]
            out.append(v)
            if graph.nodes[v].source[0] == "msg":
                return out

    chain = list(reversed(walk(n_start, axis.opposite()))) + [n_start] + walk(n_start, axis)
    chain_set = set(chain)

    # the two components of the graph without the chain
    comp: Dict[int, int] = {}
    for s in range(graph.n_nodes):
        if s in chain_set or s in comp:
            continue
        stack = [s]
        comp[s] = s
        while stack:
            v = stack.pop()
            for nb in graph.nodes[v].neighbors:
                if nb is not None and nb[0] not in chain_set and nb[0] not in comp:
                    comp[nb[0]] = s
                    stack.append(nb[0])
    seeds = sorted(set(comp.values()))
    assert len(seeds) == 2
    set_a = {v for v, s in comp.items() if s == seeds[0]}
    set_b = {v for v, s in comp.items() if s == seeds[1]}
    pos = np.array([n.pos for n in graph.nodes])
    nvec = np.array(major_top.unit)
    if np.mean(pos[list(set_a)] @ nvec) > np.mean(pos[list(set_b)] @ nvec):
        top_set, bot_set = set_a, set_b
    else:
        top_set, bot_set = set_b, set_a

    top_leg, bot_leg, fwd, bwd = {}, {}, {}, {}
    for i, v in enumerate(chain):
        fwd[v] = bwd[v] = None
        for leg, nb in enumerate(graph.nodes[v].neighbors):
            if nb[0] in top_set:
                top_leg[v] = leg
            elif nb[0] in bot_set:
                bot_leg[v] = leg
            elif i + 1 < len(chain) and nb[0] == chain[i + 1]:
                fwd[v] = leg
            elif i > 0 and nb[0] == chain[i - 1]:
                bwd[v] = leg
            else:
                raise AssertionError("non-adjacent in-row edge")

    top_plan = compile_plan(graph, major_bot, chi, swallow=top_set)
    bot_plan = compile_plan(graph, major_top, chi, swallow=bot_set)

    def site_map(plan: Plan, legmap: Dict[int, int]) -> Dict[int, int]:
        res = {}
        for idx, tgt in enumerate(plan.final_targets):
            if tgt is not None and tgt[0] in legmap and legmap[tgt[0]] == tgt[1]:
                res[tgt[0]] = idx
        assert len(res) == len(legmap)
        return res

    return CutGeometry(graph, chain, top_leg, bot_leg, fwd, bwd, top_plan, bot_plan,
                       site_map(top_plan, top_leg), site_map(bot_plan, bot_leg))
