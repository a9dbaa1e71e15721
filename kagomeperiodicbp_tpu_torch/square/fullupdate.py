"""Square-lattice FULL update: gate application against BP bond environments
with ALS truncation (counterpart of kagomeperiodicbp_tpu/square/fullupdate.py).

The reference's legacy square engine updates blocks with environments taken
from BP messages (src/libs/squareITE.py:2091 `update_blocks`, environments
via `BP_RDMs` :2558); its environment-free mode is `algo.simple_update`.
This module is the environment mode, built on the cut-axis chain machinery
of the Kagome edge environment (algo/edge_env.chain_geometry and the ladder
assembly) and the same ALS kernels (ops/ite_kernels.apply_gate): the square
bond environment is geometrically isomorphic to the Kagome one, a straight
chain of 4-leg nodes between two boundary-MPS halves.

Conventions (identical to the Kagome edge layout, ops/ite_kernels):
* pair kets [d, edge, 3 ccw env legs];
* env: 6 tensors [prev, ket, bra, next] ccw from t1's first env leg.
"""
from __future__ import annotations

import functools
import logging
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..algo.edge_env import EdgeGeometry, _flip, _ladder_step, _norm_rescale, chain_geometry
from ..ops.contract import execute_plan
from ..ops.ite_kernels import apply_gate, gate_from_hamiltonian, rho_ij
from .algo import _fused_cell, _graph_for, _tile_fetch, belief_propagation, measure_energy
from .lattice import _LEG_ANGLE, LEG_D, LEG_L, LEG_R, LEG_U, SquareSide, site_index

# walk/edge leg + boundary halves per bond orientation.  major_top is the
# side at (axis angle + 90°), matching the Kagome cut-axis convention
# (algo/edge_env.edge_geometry) so the ccw env assembly below is identical.
_ORIENT = {
    "h": dict(fwd=LEG_R, bwd=LEG_L, top=SquareSide.UP, bot=SquareSide.DOWN),
    "v": dict(fwd=LEG_U, bwd=LEG_D, top=SquareSide.LEFT, bot=SquareSide.RIGHT),
}


def bond_pair(n: int, orient: str, i: int, j: int) -> Tuple[int, int]:
    v1 = site_index(i, j, n)
    v2 = site_index(i, j + 1, n) if orient == "h" else site_index(i + 1, j, n)
    return v1, v2


@functools.lru_cache(maxsize=None)
def bond_geometry(n: int, D: int, chi: int, chi_msg: int,
                  orient: str, i: int, j: int) -> EdgeGeometry:
    """Cut-chain geometry for the bond (i,j)→(i,j+1) ["h"] or (i,j)→(i+1,j)
    ["v"]: the full row/column extended to its terminating message nodes."""
    graph = _graph_for(n, D, chi_msg, tuple(int(s) for s in SquareSide))
    o = _ORIENT[orient]
    v1, _ = bond_pair(n, orient, i, j)

    def walk(v: int, leg: int) -> List[int]:
        out = []
        while True:
            nb = graph.nodes[v].neighbors[leg]
            if nb is None:
                raise ValueError("the bond's chain hit an open leg (missing messages?)")
            v = nb[0]
            out.append(v)
            if graph.nodes[v].source[0] == "msg":
                return out

    fwd_nodes = walk(v1, o["fwd"])
    bwd_nodes = walk(v1, o["bwd"])
    chain = list(reversed(bwd_nodes)) + [v1] + fwd_nodes
    return chain_geometry(graph, chain, o["top"], o["bot"], chi)


def _canonical_ket(t: torch.Tensor, edge_leg: int) -> Tuple[torch.Tensor, Tuple[int, ...]]:
    """Ket [d, U, L, D, R] → [d, edge, ccw-from-edge…] (the edge layout;
    the same angular sort as algo/edge_env._canonical_ket)."""
    a0 = _LEG_ANGLE[edge_leg]
    rest = sorted((l for l in range(4) if l != edge_leg),
                  key=lambda l: (_LEG_ANGLE[l] - a0) % (2 * math.pi))
    perm = (edge_leg,) + tuple(rest)
    return t.permute((0,) + tuple(p + 1 for p in perm)), perm


def _uncanonical(t: torch.Tensor, perm: Tuple[int, ...]) -> torch.Tensor:
    """Invert _canonical_ket's virtual-leg permutation."""
    inv = tuple(perm.index(k) for k in range(4))
    return t.permute((0,) + tuple(p + 1 for p in inv))


def bond_environment(cell, n: int, D: int, msg_sites, chi: int, chi_msg: int,
                     orient: str, i: int, j: int):
    """(t1, t2, env, (perm1, perm2)) for the bond — the square analog of
    algo/edge_env.edge_environment_sites, one boundary MPS per half plus the
    left/right chain ladders."""
    m = len(cell)
    geo = bond_geometry(n, D, chi, chi_msg, orient, i, j)
    v1, v2 = bond_pair(n, orient, i, j)
    i1 = geo.chain.index(v1)
    if geo.chain[i1 + 1] != v2:
        raise ValueError("the bond's sites must be adjacent on its chain")

    fetch = _tile_fetch(_fused_cell(cell), n, msg_sites)
    top = execute_plan(geo.top_plan, fetch)
    bot = execute_plan(geo.bot_plan, fetch)

    graph = _graph_for(n, D, chi_msg, tuple(int(s) for s in SquareSide))

    def node_perm(v: int, incoming: Optional[int], outgoing: Optional[int]):
        order = [geo.top_leg[v]]
        if incoming is not None:
            order.append(incoming)
        order.append(geo.bot_leg[v])
        if outgoing is not None:
            order.append(outgoing)
        return tuple(order)

    dtype, device = top.sites[0].dtype, top.sites[0].device
    logs = top.logscale + bot.logscale

    L = torch.ones((1, 1, 1), dtype=dtype, device=device)
    for k in range(i1):
        v = geo.chain[k]
        perm = node_perm(v, geo.chain_leg_bwd[v], geo.chain_leg_fwd[v])
        L = _ladder_step(L, top.sites[geo.top_site_of[v]],
                         bot.sites[geo.bot_site_of[v]],
                         fetch(graph.nodes[v].source), perm)
        L, logs = _norm_rescale(L, logs)

    R = torch.ones((1, 1, 1), dtype=dtype, device=device)
    for k in range(len(geo.chain) - 1, i1 + 1, -1):
        v = geo.chain[k]
        perm = node_perm(v, geo.chain_leg_fwd[v], geo.chain_leg_bwd[v])
        R = _ladder_step(R, _flip(top.sites[geo.top_site_of[v]]),
                         _flip(bot.sites[geo.bot_site_of[v]]),
                         fetch(graph.nodes[v].source), perm)
        R, logs = _norm_rescale(R, logs)

    def split(t):  # [a, D², b] → [a, D, D, b] (fused = ket,bra pairs)
        a, _, b = t.shape
        return t.reshape(a, D, D, b)

    ts1 = top.sites[geo.top_site_of[v1]]
    ts2 = top.sites[geo.top_site_of[v2]]
    bs1 = bot.sites[geo.bot_site_of[v1]]
    bs2 = bot.sites[geo.bot_site_of[v2]]
    env = [
        split(ts1.permute(2, 1, 0)),
        split(L),
        split(bs1.permute(2, 1, 0)),
        split(bs2.permute(2, 1, 0)),
        split(R.permute(2, 1, 0)),
        split(ts2.permute(2, 1, 0)),
    ]

    o = _ORIENT[orient]
    i1r, j1c = divmod(v1, n)
    i2r, j2c = divmod(v2, n)
    t1, perm1 = _canonical_ket(cell[i1r % m][j1c % m], o["fwd"])
    t2, perm2 = _canonical_ket(cell[i2r % m][j2c % m], o["bwd"])
    return t1, t2, env, (perm1, perm2)


def bond_expectation(cell, n: int, D: int, messages, chi: int, chi_msg: int,
                     h: np.ndarray, orient: str, i: int, j: int) -> complex:
    """⟨h⟩ on the bond via the 2-site RDM from the bond environment — a
    cross-check against algo.pair_expectation's RDM-free sandwich path."""
    msg_sites = {int(s): tuple(mm.sites) for s, mm in messages.items()}
    t1, t2, env, _ = bond_environment(cell, n, D, msg_sites, chi, chi_msg,
                                      orient, i, j)
    rho = rho_ij(t1, t2, env)
    return complex(torch.einsum("iIjJ,iIjJ->", rho,
                                torch.as_tensor(h, dtype=rho.dtype, device=rho.device)).item())


def full_update(
    cell,
    h: np.ndarray,
    n: int = 4,
    dts: Sequence[float] = (0.05, 0.02, 0.01, 0.005, 0.002, 0.001),
    sweeps_per_dt: int = 10,
    chi: Optional[int] = None,
    chi_msg: Optional[int] = None,
    als_iters: int = 10,
    bp_iters: int = 40,
    bp_tol: float = 1e-7,
    logger: Optional[logging.Logger] = None,
    measure_each_stage: bool = True,
):
    """BP-environment full update on the m×m periodic cell over an n×n block
    (reference squareITE.py:2091 update_blocks, environment mode).

    Per sweep: converge BP (warm-started), then for every bond class apply
    exp(−dt·h) against its bond environment and ALS-truncate back to D.
    Returns (cell, best_energy, history); the caller's cell is left as it
    was."""
    log = logger or logging.getLogger("square_fu")
    cell = [list(row) for row in cell]
    m = len(cell)
    D = int(cell[0][0].shape[1])
    chi_msg = chi_msg or 2 * D * D
    chi = chi or chi_msg + 10
    dtype, device = cell[0][0].dtype, cell[0][0].device
    c = max((n - m - 1) // 2, 0)
    if not c + m < n:
        raise ValueError(f"block n={n} too small for an m={m} cell's bonds")

    msgs = None
    history: List[Tuple[float, float]] = []
    best_e, best_cell = float("inf"), None
    h_t = torch.as_tensor(h, dtype=dtype, device=device)
    for dt in dts:
        g = gate_from_hamiltonian(h_t, dt)
        for _ in range(sweeps_per_dt):
            msgs, err = belief_propagation(
                cell, n, D, chi_msg, chi=chi, messages=msgs,
                max_iterations=bp_iters, tol=bp_tol, dtype=dtype)
            msg_sites = {int(s): tuple(mm.sites) for s, mm in msgs.items()}
            for di in range(m):
                for dj in range(m):
                    for orient in ("h", "v"):
                        i, j = c + di, c + dj
                        t1, t2, env, (p1, p2) = bond_environment(
                            cell, n, D, msg_sites, chi, chi_msg, orient, i, j)
                        t1n, t2n, _ = apply_gate(g, D, t1, t2, env,
                                                 als_iters=als_iters)
                        v1, v2 = bond_pair(n, orient, i, j)
                        i1r, j1c = divmod(v1, n)
                        i2r, j2c = divmod(v2, n)
                        cell[i1r % m][j1c % m] = _uncanonical(t1n, p1)
                        cell[i2r % m][j2c % m] = _uncanonical(t2n, p2)
        if measure_each_stage:
            msgs, err = belief_propagation(
                cell, n, D, chi_msg, chi=chi, messages=msgs,
                max_iterations=bp_iters, tol=bp_tol, dtype=dtype)
            e = measure_energy(cell, n, D, msgs, chi, chi_msg, h)
            history.append((dt, float(e)))
            log.info("full update dt=%.4g: energy/site = %.8f (bp err %.1e)",
                     dt, e, err)
            if e < best_e:
                best_e = float(e)
                best_cell = [[t for t in row] for row in cell]
    if best_cell is not None:
        cell = best_cell
    return cell, best_e, history
