"""Edge environments via cut-axis "sandwich" contractions.

Torch counterpart of kagomeperiodicbp_tpu/algo/edge_env.py, which replaces
the reference's staged Full→Core→Mode→Edge reduction chain
(src/algo/tn_reduction/): for every one of the 6 edge classes, the 6-tensor
periodic environment of the pair comes from

1. two directional contractions of the full TN (block + 6 messages) toward
   the two block sides orthogonal to the edge's lattice axis, stopping at the
   cut row through the center (compiled plans, cached per axis);
2. two transfer-matrix "zip" ladders walking the cut row inward from both
   ends (the `updateCLeft/Right` ladder of kagome_to_core.py:192, with the
   cut-row tensors sandwiched);
3. assembly of the 6 env tensors in the counterclockwise order expected by
   `rho_ij` (libs/ITE.py:555): [top(n1), back(n1), bottom(n1), bottom(n2),
   forward(n2), top(n2)].

All three cut axes pass through the center triangle, and each serves two of
the six `UpdateEdge` classes, so 6 directional contractions cover a full
measurement pass.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..enums import UpdateEdge
from ..lattices import BlockSide, KagomeBlock, LatticeDir
from ..networks.graph import TNGraph
from ..networks.unit_cell import UnitCell
from ..ops.contract import _blob_elem_limit, execute_plan
from ..ops.mps import MPS
from ..planner.compiler import Plan, compile_plan
from . import contraction as C


# ------------------------- static edge geometry ---------------------------


def edge_pair(block: KagomeBlock, edge: UpdateEdge) -> Tuple[int, int]:
    """The representative node pair of this edge class: n1 = center-triangle
    node of flavor `first`, n2 = its neighbour in the edge direction."""
    c = block.center_triangle
    n1 = 3 * c + int(edge.first)
    d = edge.direction()
    leg = block.node_dirs(n1).index(d)
    n2 = int(block.neighbors[n1, leg])
    assert n2 >= 0 and n2 % 3 == int(edge.second)
    return n1, n2


@dataclass
class EdgeGeometry:
    """Static data for one cut axis (shared by the 2 edges on it)."""

    axis: LatticeDir
    major_top: BlockSide       # side at axis.angle + 90°
    major_bot: BlockSide
    chain: List[int]           # cut-row node ids in axis order
    top_leg: Dict[int, int]    # chain node -> leg index into the top half
    bot_leg: Dict[int, int]
    chain_leg_fwd: Dict[int, Optional[int]]  # leg toward next chain node
    chain_leg_bwd: Dict[int, Optional[int]]
    top_plan: Plan
    bot_plan: Plan
    top_site_of: Dict[int, int]  # chain node -> site index in top MPS
    bot_site_of: Dict[int, int]


@functools.lru_cache(maxsize=None)
def edge_geometry(N: int, D: int, chi: int, chi_msg: int, axis: LatticeDir) -> EdgeGeometry:
    block = KagomeBlock.build(N)
    graph = C._graph_for(N, D, chi_msg, tuple(int(s) for s in BlockSide))
    major_top = BlockSide(round(((axis.angle + math.pi / 2) % (2 * math.pi) - math.pi / 6) / (math.pi / 3)) % 6)
    assert abs(((major_top.angle - axis.angle - math.pi / 2 + math.pi) % (2 * math.pi)) - math.pi) < 1e-9
    major_bot = major_top.opposite()

    # --- the cut chain: walk lattice nodes along `axis` through the centre
    # triangle's pair, then extend with the message node at each end ---
    c = block.center_triangle
    starts = {
        LatticeDir.R: 3 * c + 1,   # left node (B), edge B→C along R
        LatticeDir.DL: 3 * c + 0,  # up (A), edge A→B along DL
        LatticeDir.UL: 3 * c + 2,  # right (C), edge C→A along UL
    }
    n_start = starts[axis]

    def walk(v: int, d: LatticeDir) -> List[int]:
        out = []
        while True:
            node = graph.nodes[v]
            dirs = block.node_dirs(v)
            leg = dirs.index(d)
            nb = node.neighbors[leg]
            assert nb is not None, "chain hit an open leg (missing messages?)"
            v = nb[0]
            out.append(v)
            if graph.nodes[v].source[0] == "msg":
                return out  # message node terminates the chain

    fwd_nodes = walk(n_start, axis)
    bwd_nodes = walk(n_start, axis.opposite())
    chain = list(reversed(bwd_nodes)) + [n_start] + fwd_nodes
    return chain_geometry(graph, chain, major_top, major_bot, chi, axis=axis)


def chain_geometry(graph: TNGraph, chain: List[int], major_top, major_bot,
                   chi: int, axis=None) -> "EdgeGeometry":
    """Graph-generic half of the cut-axis construction: given the cut chain
    (lattice pair row extended to its terminating message nodes), split the
    rest of the graph into the two connected components, identify each chain
    node's top/bottom/fwd/bwd legs, and compile the two directional boundary
    plans.  Shared by the Kagome edge environment (above) and the square
    lattice full update (square/fullupdate.py)."""
    chain_set = set(chain)

    # --- top/bottom = the two connected components of the rest ---
    comp = {}
    for seed in range(graph.n_nodes):
        if seed in chain_set or seed in comp:
            continue
        stack, members = [seed], []
        comp[seed] = seed
        while stack:
            v = stack.pop()
            members.append(v)
            for nb in graph.nodes[v].neighbors:
                if nb is not None and nb[0] not in chain_set and nb[0] not in comp:
                    comp[nb[0]] = seed
                    stack.append(nb[0])
        for m in members:
            comp[m] = seed
    seeds = set(comp.values())
    assert len(seeds) == 2, f"cut must split the graph in 2, got {len(seeds)}"
    comp_a, comp_b = sorted(seeds)
    set_a = {v for v, s in comp.items() if s == comp_a}
    set_b = {v for v, s in comp.items() if s == comp_b}
    # which is on the major_top side? compare mean projection
    pos = np.array([n.pos for n in graph.nodes])
    nvec = np.array(major_top.unit)
    if np.mean(pos[list(set_a)] @ nvec) > np.mean(pos[list(set_b)] @ nvec):
        top_set, bot_set = set_a, set_b
    else:
        top_set, bot_set = set_b, set_a

    # chain adjacency + top/bottom legs (exactly one each per chain node)
    top_leg, bot_leg, fwd, bwd = {}, {}, {}, {}
    for i, v in enumerate(chain):
        node = graph.nodes[v]
        fwd[v] = bwd[v] = None
        for leg, nb in enumerate(node.neighbors):
            assert nb is not None, f"cut-row node {v} has open leg {leg}"
            if nb[0] in top_set:
                assert v not in top_leg, f"node {v} has two top legs"
                top_leg[v] = leg
            elif nb[0] in bot_set:
                assert v not in bot_leg, f"node {v} has two bottom legs"
                bot_leg[v] = leg
            else:
                assert nb[0] in chain_set, "cut-row leg goes nowhere"
                if i + 1 < len(chain) and nb[0] == chain[i + 1]:
                    fwd[v] = leg
                elif i > 0 and nb[0] == chain[i - 1]:
                    bwd[v] = leg
                else:
                    raise AssertionError("non-adjacent in-row edge")
        assert v in top_leg and v in bot_leg, f"chain node {v} missing top/bot leg"

    top_plan = compile_plan(graph, major_bot, chi, swallow=top_set)
    bot_plan = compile_plan(graph, major_top, chi, swallow=bot_set)

    def site_map(plan: Plan, legmap: Dict[int, int]) -> Dict[int, int]:
        res = {}
        for idx, tgt in enumerate(plan.final_targets):
            if tgt is not None and tgt[0] in legmap and legmap[tgt[0]] == tgt[1]:
                res[tgt[0]] = idx
        assert len(res) == len(legmap), "missing sites for some chain nodes"
        return res

    top_site_of = site_map(top_plan, top_leg)
    bot_site_of = site_map(bot_plan, bot_leg)

    # sanity: top MPS site order ascends with chain order; bottom descends
    ts = [top_site_of[v] for v in chain]
    bs = [bot_site_of[v] for v in chain]
    assert ts == sorted(ts), f"top sites not chain-ordered: {ts}"
    assert bs == sorted(bs, reverse=True), f"bottom sites not reverse-ordered: {bs}"
    # and they are consecutive (each chain node has exactly 1 top leg)
    assert ts == list(range(ts[0], ts[0] + len(ts)))
    assert bs == list(range(bs[0], bs[0] - len(bs), -1))

    return EdgeGeometry(
        axis=axis, major_top=major_top, major_bot=major_bot, chain=chain,
        top_leg=top_leg, bot_leg=bot_leg, chain_leg_fwd=fwd, chain_leg_bwd=bwd,
        top_plan=top_plan, bot_plan=bot_plan,
        top_site_of=top_site_of, bot_site_of=bot_site_of,
    )


# --------------------------- runtime assembly -----------------------------


def _ladder_step(T, top_site, bot_site, tensor, perm):
    """T [t, c, b] → T' [t', c', b'] absorbing one chain node.

    `tensor` permuted by `perm` has legs [top, chain_in, bottom, chain_out]
    (chain_in of dim 1 is prepended for end nodes without one).
    """
    t = tensor.permute(perm)
    if t.ndim == 3:  # end node: [top, bottom, chain_out] → add chain_in
        t = t[:, None, :, :]
    # T[t,c,b] × top[t,pt,t2] → [c,b,pt,t2]
    x = torch.tensordot(T, top_site, dims=([0], [0]))
    # × tensor[pt,c,pb,c2] over (pt, c) → [b,t2,pb,c2]
    x = torch.tensordot(x, t, dims=([2, 0], [0, 1]))
    # × bot[b2,pb,b] over (pb, b) → [t2,c2,b2]
    return torch.tensordot(x, bot_site, dims=([2, 0], [1, 2]))


def _norm_rescale(x, logs):
    n = torch.clamp(torch.linalg.vector_norm(x), min=1e-300)
    return x / n, logs + torch.log(n)


def env_single_layer(D: int, chi: int, chi_msg: int) -> bool:
    """Whether the edge environment's boundary plans run single-layer: where
    the double-layer plan's largest blob would exceed the executor's blob
    limit (``ops/contract._blob_elem_limit``: ``KPBP_BLOB_LIMIT``, 3e8
    elements by default). That blob is the first product of a two-in-leg
    swallow, a fused node [D², D², D², D²] against the frontier site before
    it, [D², D², D², a, b], with its bonds a ≈ χ_msg and b ≈ χ: a·b·D⁶
    elements,

    ====  ==========  =======  =======  =============
    D     χ_msg / χ   a·b·D⁶   c64      contracts
    ====  ==========  =======  =======  =============
    6     72 / 82     2.75e8   2.2 GB   double-layer
    6     144 / 164   1.1e9    8.8 GB   single-layer
    7     98 / 108    1.25e9   10 GB    single-layer
    8     128 / 138   4.6e9    37 GB    single-layer
    ====  ==========  =======  =======  =============

    so the ITE update at D=6 (χ = 2D²+10) and every test size stay
    double-layer, while a D=6 measurement at the production χ×2, and every
    environment from D=7, swallows single-layer. Every lattice step of these
    plans takes two or three in-legs, so none is eligible for the sketched
    swallow, which takes one: single-layer, each goes through its blob."""
    return chi_msg * chi * D ** 6 > _blob_elem_limit()


def edge_environment_sites(cells, msg_sites, N: int, chi: int, chi_msg: int,
                           edge: UpdateEdge, single_layer: Optional[bool] = None):
    """The edge environment of one edge class.

    * cells — (A, B, C) ket tensors, or one per block site;
    * msg_sites — dict side-int → tuple of message site tensors;
    * single_layer — run the top and bottom boundary plans single-layer
      (large-D memory); the chain ladder still takes the three fused
      tensors. None: by the blob rule of ``env_single_layer``.

    Returns (t1, t2, env, (perm1, perm2)) — see `edge_environment`. The
    fused tensors come from one launch of kernel K1 per three kets on the
    card.
    """
    D = cells[0].shape[1]
    if single_layer is None:
        single_layer = env_single_layer(D, chi, chi_msg)
    block = KagomeBlock.build(N)
    geo = edge_geometry(N, D, chi, chi_msg, edge.direction())
    n1, n2 = edge_pair(block, edge)
    i1 = geo.chain.index(n1)
    if geo.chain[i1 + 1] != n2:
        raise AssertionError("pair must be chain-adjacent")

    fused = C.fused_sites(cells)
    fetch_plan = C._make_fetch(fused, msg_sites, kets=tuple(cells))
    top_plan, bot_plan = geo.top_plan, geo.bot_plan
    if single_layer:
        top_plan, bot_plan = C.single_layer_plan(top_plan), C.single_layer_plan(bot_plan)
    top = execute_plan(top_plan, fetch_plan)
    bot = execute_plan(bot_plan, fetch_plan)

    graph = C._graph_for(N, D, chi_msg, tuple(int(s) for s in BlockSide))

    def fetch(v):
        return fetch_plan(graph.nodes[v].source)

    def node_perm(v, incoming_leg: Optional[int], outgoing_leg: Optional[int]):
        """Permutation to [top, chain_in, bottom, chain_out] (3-leg nodes:
        [top, bottom, chain_out] or [top, chain_in, bottom])."""
        order = [geo.top_leg[v]]
        if incoming_leg is not None:
            order.append(incoming_leg)
        order.append(geo.bot_leg[v])
        if outgoing_leg is not None:
            order.append(outgoing_leg)
        return tuple(order)

    s0 = top.sites[0]
    logs = top.logscale + bot.logscale

    # --- left ladder: chain[0 .. i1-1] ---
    L = torch.ones((1, 1, 1), dtype=s0.dtype, device=s0.device)
    for i in range(i1):
        v = geo.chain[i]
        perm = node_perm(v, geo.chain_leg_bwd[v], geo.chain_leg_fwd[v])
        L = _ladder_step(L, top.sites[geo.top_site_of[v]], bot.sites[geo.bot_site_of[v]],
                         fetch(v), perm)
        L, logs = _norm_rescale(L, logs)

    # --- right ladder: chain[-1 .. i1+2] ---
    R = torch.ones((1, 1, 1), dtype=s0.dtype, device=s0.device)
    for i in range(len(geo.chain) - 1, i1 + 1, -1):
        v = geo.chain[i]
        # walking backward: incoming = fwd leg, outgoing = bwd leg; the MPS
        # sites are flipped so the ladder consumes their inward-facing bonds
        perm = node_perm(v, geo.chain_leg_fwd[v], geo.chain_leg_bwd[v])
        R = _ladder_step(R, _flip(top.sites[geo.top_site_of[v]]),
                         _flip(bot.sites[geo.bot_site_of[v]]), fetch(v), perm)
        R, logs = _norm_rescale(R, logs)

    # --- assemble env (ccw cycle [top1, back, bot1, bot2, fwd, top2]) ---
    def split(t):  # [a, D², b] → [a, D, D, b]
        a, _, b = t.shape
        return t.reshape(a, D, D, b)

    env = [
        split(_flip(top.sites[geo.top_site_of[n1]])),  # top(n1)
        split(L),                                       # back: [t, c, b]
        split(_flip(bot.sites[geo.bot_site_of[n1]])),  # bottom(n1)
        split(_flip(bot.sites[geo.bot_site_of[n2]])),  # bottom(n2)
        split(_flip(R)),                                # forward: [t,c,b] → [b,c,t]
        split(_flip(top.sites[geo.top_site_of[n2]])),  # top(n2)
    ]

    tensor_of = lambda v: cells[v % len(cells)]
    t1, perm1 = _canonical_ket(tensor_of, block, n1, edge.direction())
    t2, perm2 = _canonical_ket(tensor_of, block, n2, edge.direction().opposite())
    return t1, t2, env, (perm1, perm2)


def edge_environment(cell: UnitCell, messages: Dict[BlockSide, MPS], N: int, chi: int,
                     chi_msg: int, edge: UpdateEdge):
    """Returns (t1, t2, env, perms):

    * t1, t2 — ket tensors of the pair with legs [d, edge, ccw…];
    * env    — list of 6 tensors [prev, D, D, next] in ccw order;
    * perms  — (perm1, perm2) applied to the cell tensors' virtual legs.

    Message logscales are irrelevant: every consumer normalises.
    """
    msg_sites = {int(s): tuple(m.sites) for s, m in messages.items()}
    return edge_environment_sites((cell.A, cell.B, cell.C), msg_sites, N, chi, chi_msg, edge)


def _flip(site):
    return site.permute(2, 1, 0)


def _canonical_ket(tensor_of, block: KagomeBlock, v: int, edge_dir: LatticeDir):
    """Ket tensor of node v permuted to [d, edge, ccw-from-edge…].
    Returns (tensor, virtual-leg permutation)."""
    dirs = block.node_dirs(v)
    e = dirs.index(edge_dir)
    rest = sorted(
        (i for i in range(4) if i != e),
        key=lambda i: (dirs[i].angle - edge_dir.angle) % (2 * math.pi),
    )
    perm = (e,) + tuple(rest)
    return tensor_of(v).permute((0,) + tuple(p + 1 for p in perm)), perm
