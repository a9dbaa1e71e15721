"""Exact NumPy contraction oracles (tests only — no truncation, no MPS).

Independent of the planner's frontier/QR/SVD machinery: a single dense
environment tensor is grown by tensordot, tracking open legs by (nid, leg).
Feasible only for tiny (N, D, χ) — which is exactly what the 1e-10
validation tests use (mirrors the role of `scripts/tests/bp.py`'s χ=40
"exact" runs in the reference).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..networks.graph import Source, TNGraph


def contract_dense(
    graph: TNGraph,
    fetch: Callable[[Source], np.ndarray],
    order: Sequence[int],
) -> Tuple[np.ndarray, List[Tuple[int, int]]]:
    """Contract nodes in `order` into one dense tensor.

    Returns (tensor, open_legs) where open_legs[i] = (nid, leg) — the leg of
    the *swallowed* node that remained open (either a boundary leg or an edge
    into an unswallowed node).
    """
    env = np.ones((), dtype=np.complex128)
    axes_of: Dict[Tuple[int, int], int] = {}  # (nid, leg) -> axis in env
    in_set = set(order)
    done: set = set()

    for v in order:
        node = graph.nodes[v]
        t = np.asarray(fetch(node.source))
        # which of t's legs contract with env?
        t_axes, e_axes = [], []
        for leg, nb in enumerate(node.neighbors):
            if nb is not None and nb[0] in done:
                key = (nb[0], nb[1])
                t_axes.append(leg)
                e_axes.append(axes_of.pop(key))
        env = np.tensordot(env, t, axes=(e_axes, t_axes))
        # remaining env axes shifted: rebuild axes_of
        old_axes = sorted(axes_of.items(), key=lambda kv: kv[1])
        removed = sorted(e_axes)
        new_map = {}
        for key, ax in old_axes:
            shift = sum(1 for r in removed if r < ax)
            new_map[key] = ax - shift
        base = env.ndim - (t.ndim - len(t_axes))
        # new axes from t (its uncontracted legs, in leg order)
        t_open = [leg for leg in range(t.ndim) if leg not in t_axes]
        for i, leg in enumerate(t_open):
            new_map[(v, leg)] = base + i
        axes_of = new_map
        done.add(v)

    open_legs = sorted(axes_of.items(), key=lambda kv: kv[1])
    return env, [key for key, _ in open_legs]


def greedy_order(graph: TNGraph, include: Optional[set] = None) -> List[int]:
    """A cheap contraction order: repeatedly absorb the neighbour that
    minimises the dense-environment size (good enough for tiny graphs)."""
    nids = [n.nid for n in graph.nodes if include is None or n.nid in include]
    if not nids:
        return []
    remaining = set(nids)
    order = [min(nids)]
    remaining.discard(order[0])
    # trivial: BFS by connectivity, smallest-degree first
    while remaining:
        frontier_neighbors = set()
        for v in list(order):
            for nb in graph.nodes[v].neighbors:
                if nb is not None and nb[0] in remaining:
                    frontier_neighbors.add(nb[0])
        if not frontier_neighbors:
            nxt = min(remaining)
        else:
            nxt = min(frontier_neighbors)
        order.append(nxt)
        remaining.discard(nxt)
    return order


def contract_scalar(graph: TNGraph, fetch: Callable[[Source], np.ndarray]) -> complex:
    """Fully contract a closed graph to a scalar."""
    order = [n.nid for n in graph.nodes]
    env, open_legs = contract_dense(graph, fetch, order)
    assert not open_legs or all(
        graph.nodes[nid].neighbors[leg] is None for nid, leg in open_legs
    )
    # any remaining open (boundary) legs must be dim-1 — squeeze
    return complex(env.reshape(-1)[0]) if env.size == 1 else env
