"""Square-lattice BlockBP + imaginary-time evolution (counterpart of
kagomeperiodicbp_tpu/square/algo.py).

Re-design of the reference's legacy square engine (src/libs/squareITE.py):
BP message passing (:2558 `BP_RDMs`), energy measurement (:3085
`PEPS_energy`), and ground-state search via gate-based simple update (:2091
`update_blocks` in its environment-free mode, :1662/:1715
`get_horiz_gates`/`get_vertical_gates`), all on the plan compiler and
executor that serve the Kagome block.

Unit cell: an m×m list of ket tensors with legs [d, U, L, D, R], tiled
periodically over an n×n block (site (i,j) → cell[i%m][j%m]). Kernel K1
builds the cell's fused tensors, one launch per three sites on the card,
once per BP run or energy measurement, and its operator form the
sandwiches of ``pair_expectation``.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..algo.contraction import finalize_outgoing, fused_sites
from ..ops import mps as mpslib
from ..ops.contract import execute_plan
from ..ops.kernels import fused_tensors_with_operator
from ..ops.linalg import _real_dtype
from ..ops.mps import MPS
from ..planner.compiler import Plan, compile_plan
from .lattice import SquareSide, full_square_graph, site_index, square_message_profile

MessageDict = Dict[SquareSide, MPS]


# ------------------------------- plans -------------------------------------


@functools.lru_cache(maxsize=None)
def _graph_for(n: int, D: int, chi_msg: int, sides: Tuple[int, ...]):
    return full_square_graph(n, D, chi_msg, tuple(SquareSide(s) for s in sides))


@functools.lru_cache(maxsize=None)
def message_plan(n: int, D: int, chi: int, chi_msg: int, toward: int) -> Plan:
    sides = tuple(int(s) for s in SquareSide if int(s) != toward)
    graph = _graph_for(n, D, chi_msg, sides)
    return compile_plan(graph, SquareSide(toward), chi)


@functools.lru_cache(maxsize=None)
def scalar_plan(n: int, D: int, chi: int, chi_msg: int,
                toward: int = int(SquareSide.UP)) -> Plan:
    graph = _graph_for(n, D, chi_msg, tuple(int(s) for s in SquareSide))
    return compile_plan(graph, SquareSide(toward), chi)


# --------------------------- messages + BP ---------------------------------


def initial_messages(n: int, D: int, chi: int, model: str = "uniform",
                     generator: Optional[torch.Generator] = None,
                     dtype=torch.complex128, device=None) -> MessageDict:
    """Fresh messages on the 4 sides in the canonical padded profile; the
    "random" model draws from `generator` (a CPU generator seeded 0 if
    None), torch's numbers, not jax.random's."""
    if model == "random" and generator is None:
        generator = torch.Generator().manual_seed(0)
    profile = square_message_profile(n, D, chi)
    msgs: MessageDict = {}
    for side in SquareSide:
        if model == "uniform":
            m = mpslib.uniform_message(D, n, dtype, device)
        elif model == "random":
            m = mpslib.random_message(D, n, generator, dtype, device)
        else:
            raise ValueError(model)
        msgs[side] = mpslib.pad_bonds(m, profile)
    return msgs


def _fused_cell(cell: Sequence[Sequence[torch.Tensor]]) -> List[List[torch.Tensor]]:
    """The cell's m² fused tensors, m×m, K1 launched once per three sites.
    Built once per BP run, energy measurement or bond environment and
    shared by every contraction in it."""
    m = len(cell)
    flat = fused_sites([t for row in cell for t in row])
    return [flat[i * m:(i + 1) * m] for i in range(m)]


def _tile_fetch(fused: Sequence[Sequence[torch.Tensor]], n: int,
                msgs: Dict[int, Tuple[torch.Tensor, ...]],
                replace: Optional[Dict[int, torch.Tensor]] = None):
    """Fetch for square plans over the cell's fused tensors (``_fused_cell``).
    Cell tensors have legs [d, U, L, D, R]; the graph's lattice legs are
    ordered [U, L, D, R], so the fused tensor's leg order matches directly."""
    m = len(fused)

    def fetch(source):
        if source[0] == "lat":
            v = source[1]
            if replace and v in replace:
                return replace[v]
            i, j = divmod(v, n)
            return fused[i % m][j % m]
        _, side, k = source
        return msgs[side][k]

    return fetch


def _outgoing(fused, n: int, D: int, messages: MessageDict, chi: int,
              chi_msg: int, toward: SquareSide) -> MPS:
    plan = message_plan(n, D, chi, chi_msg, int(toward))
    msg_sites = {int(s): tuple(m.sites) for s, m in messages.items()
                 if int(s) != int(toward)}
    raw = execute_plan(plan, _tile_fetch(fused, n, msg_sites))
    out = finalize_outgoing(raw, plan, n)  # folds dim-1 corner ends
    out = mpslib.compress(out, chi_msg)
    out = mpslib.pad_bonds(out, square_message_profile(n, D, chi_msg))
    return MPS(out.sites, torch.zeros_like(out.logscale))


def outgoing_message(cell, n: int, D: int, messages: MessageDict, chi: int,
                     chi_msg: int, toward: SquareSide) -> MPS:
    return _outgoing(_fused_cell(cell), n, D, messages, chi, chi_msg, toward)


def _bp_step(fused, n: int, D: int, messages: MessageDict, chi: int,
             chi_msg: int) -> MessageDict:
    new: MessageDict = {}
    for side in SquareSide:
        out = _outgoing(fused, n, D, messages, chi, chi_msg, side)
        new[side.opposite()] = out.reverse()
    return new


def bp_step(cell, n: int, D: int, messages: MessageDict, chi: int,
            chi_msg: int) -> MessageDict:
    """One synchronous sweep; wrap = reversed outgoing into the opposite
    side (periodic identification, same as the Kagome wiring)."""
    return _bp_step(_fused_cell(cell), n, D, messages, chi, chi_msg)


def belief_propagation(cell, n: int, D: int, chi_msg: int,
                       max_iterations: int = 40, tol: float = 1e-10,
                       chi: Optional[int] = None, messages=None,
                       dtype=torch.complex128) -> Tuple[MessageDict, float]:
    """BP to a mean message distance below `tol` (clamped to 30 ulp of the
    working precision); one host read per sweep, the cell fused once."""
    chi = chi or chi_msg
    msgs = messages or initial_messages(n, D, chi_msg, dtype=dtype, device=cell[0][0].device)
    tol = max(tol, 30 * torch.finfo(_real_dtype(dtype)).eps)
    fused = _fused_cell(cell)
    err = float("inf")
    for _ in range(max_iterations):
        new = _bp_step(fused, n, D, msgs, chi, chi_msg)
        err = float(torch.stack([mpslib.distance(msgs[s], new[s]) for s in SquareSide]).mean())
        msgs = new
        if err < tol:
            break
    return msgs, err


# ---------------------------- measurement ----------------------------------


def _kron_terms(h: np.ndarray) -> List[Tuple[np.ndarray, np.ndarray]]:
    """h[iK,iB,jK,jB] = Σ_k A_k ⊗ B_k (operator-Schmidt decomposition)."""
    d = h.shape[0]
    M = h.reshape(d * d, d * d)
    u, s, vh = np.linalg.svd(M)
    terms = []
    for k in range(len(s)):
        if s[k] < 1e-14:
            break
        terms.append(((u[:, k] * s[k]).reshape(d, d), vh[k, :].reshape(d, d)))
    return terms


def _complex(x: torch.Tensor) -> complex:
    return complex(x.item())


def _scalar(fused, n, D, msgs_sites, chi, chi_msg, replace=None) -> Tuple[complex, float]:
    plan = scalar_plan(n, D, chi, chi_msg)
    mant, log = execute_plan(plan, _tile_fetch(fused, n, msgs_sites, replace))
    return _complex(mant), float(log)


def _pair(cell, fused, n, D, msg_sites, chi, chi_msg, h, v1, v2, den) -> complex:
    """``pair_expectation`` on the fused cell, with the denominator
    (mantissa, log) of the unsandwiched network given."""
    m = len(cell)
    den_m, den_l = den
    i1, j1 = divmod(v1, n)
    i2, j2 = divmod(v2, n)
    t1 = cell[i1 % m][j1 % m]
    t2 = cell[i2 % m][j2 % m]
    terms = _kron_terms(h)
    sandwiches = []
    for t, ops in ((t1, [a for a, _ in terms]), (t2, [b for _, b in terms])):
        sandwiches.append([s for k in range(0, len(ops), 3)
                           for s in fused_tensors_with_operator(t, ops[k:k + 3])])
    total = 0.0 + 0.0j
    for a_sw, b_sw in zip(*sandwiches):
        num_m, num_l = _scalar(fused, n, D, msg_sites, chi, chi_msg, {v1: a_sw, v2: b_sw})
        total += (num_m / den_m) * np.exp(num_l - den_l)
    return total


def pair_expectation(cell, n: int, D: int, messages: MessageDict, chi: int,
                     chi_msg: int, h: np.ndarray, v1: int, v2: int) -> complex:
    """⟨h⟩ on the site pair (v1, v2) by operator-Schmidt-decomposing h into
    ≤d² single-site Kronecker terms, each a full sandwich contraction
    (reference: PEPS_energy via RDMs, squareITE.py:3085 — here RDM-free).
    K1's operator form makes each site's sandwiches, three per launch."""
    fused = _fused_cell(cell)
    msg_sites = {int(s): tuple(mm.sites) for s, mm in messages.items()}
    den = _scalar(fused, n, D, msg_sites, chi, chi_msg)
    return _pair(cell, fused, n, D, msg_sites, chi, chi_msg, h, v1, v2, den)


def measure_energy(cell, n: int, D: int, messages: MessageDict, chi: int,
                   chi_msg: int, h: np.ndarray) -> float:
    """Mean energy per site: one horizontal + one vertical bond per cell
    class, averaged over the cell and measured at central block sites
    (2 bonds/site on the square lattice). The cell is fused, and the
    unsandwiched network contracted, once for all bonds."""
    m = len(cell)
    c = max((n - m - 1) // 2, 0)
    if not c + m < n:
        raise ValueError(f"block n={n} too small to center an m={m} cell's bonds")
    fused = _fused_cell(cell)
    msg_sites = {int(s): tuple(mm.sites) for s, mm in messages.items()}
    den = _scalar(fused, n, D, msg_sites, chi, chi_msg)
    e_sum = 0.0
    n_pairs = 0
    for di in range(m):
        for dj in range(m):
            i, j = c + di, c + dj
            for v2 in (site_index(i, j + 1, n), site_index(i + 1, j, n)):
                e_sum += _pair(cell, fused, n, D, msg_sites, chi, chi_msg, h,
                               site_index(i, j, n), v2, den).real
                n_pairs += 1
    # 2 bonds per site on the square lattice
    return 2.0 * e_sum / max(n_pairs, 1)


# --------------------------- simple-update ITE -----------------------------


def _gate(h: np.ndarray, dt: float, dtype, device=None) -> torch.Tensor:
    """exp(−dt·h) in [iK, iB, jK, jB] layout: matricise as [(iK,jK),(iB,jB)]
    before exponentiating (same as ops/ite_kernels.gate_from_hamiltonian)."""
    d = h.shape[0]
    M = np.transpose(h, (0, 2, 1, 3)).reshape(d * d, d * d)
    w, v = np.linalg.eigh((M + M.conj().T) / 2)
    g = (v * np.exp(-dt * w)) @ v.conj().T
    return torch.as_tensor(np.transpose(g.reshape(d, d, d, d), (0, 2, 1, 3)),
                           dtype=dtype, device=device)


def _initial_cell(m: int, D: int, d: int, generator: torch.Generator, dtype,
                  device=None) -> List[List[torch.Tensor]]:
    """The simple update's start: m×m real Gaussian kets [d, D,D,D,D] from
    `generator`, each of unit norm, cast to `dtype` (torch's numbers, not
    jax.random's; the parity tests substitute the JAX package's draw)."""
    cell = [[torch.randn((d, D, D, D, D), generator=generator, dtype=torch.float64)
             .to(dtype=dtype, device=device) for _ in range(m)] for _ in range(m)]
    return [[t / torch.linalg.vector_norm(t) for t in row] for row in cell]


def simple_update(
    h: np.ndarray,
    D: int,
    m: int = 2,
    d: int = 2,
    dts: Sequence[float] = (0.1, 0.05, 0.01, 0.005, 0.001),
    sweeps_per_dt: int = 60,
    generator: Optional[torch.Generator] = None,
    dtype=torch.complex128,
    staggered_field: float = 0.4,
    device=None,
):
    """Gate-based simple update on the m×m periodic square cell with per-bond
    λ weights (squareITE.py:2091 `update_blocks` environment-free mode).

    `staggered_field`: initial strength of a decaying staggered −B·(−1)^(i+j)Sz
    field (halved at each dt stage, off at the last). Without it the
    bipartite AFM collapses into the Z₂ Néel *cat* state — the bond
    dimension is spent on the classical superposition (every bond lands at
    ⟨S·S⟩ = −¼ exactly) instead of quantum fluctuations. The same basin
    trick as the reference's AFM-T protocol.

    The start cell is drawn from `generator` (a CPU generator seeded 0 if
    None) by ``_initial_cell``. Returns (cell, lambdas): cell[i][j] legs
    [d, U, L, D, R]."""
    generator = generator if generator is not None else torch.Generator().manual_seed(0)
    cell = _initial_cell(m, D, d, generator, dtype, device)
    device = cell[0][0].device
    rdt = _real_dtype(dtype)
    # bond classes: ("h", i, j) joins (i,j).R ↔ (i,(j+1)%m).L;
    #               ("v", i, j) joins (i,j).U ↔ ((i+1)%m,j).D
    lambdas: Dict[Tuple[str, int, int], torch.Tensor] = {}
    for i in range(m):
        for j in range(m):
            for orient in ("h", "v"):
                lambdas[(orient, i, j)] = torch.ones((D,), dtype=rdt, device=device) / np.sqrt(D)

    # leg of each tensor touched by a bond class, per orientation
    def bonds_of(i, j):
        # (class, leg) pairs for tensor (i, j); legs in [d, U, L, D, R] order
        return [
            (("h", i, j), 4),                 # its RIGHT leg
            (("h", i, (j - 1) % m), 2),       # its LEFT leg
            (("v", i, j), 1),                 # its UP leg
            (("v", (i - 1) % m, j), 3),       # its DOWN leg
        ]

    def absorb(t, i, j, lam_map, skip, inverse=False):
        for cls, leg in bonds_of(i, j):
            if leg == skip:
                continue
            lam = lam_map[cls]
            lam = 1.0 / lam if inverse else lam
            shape = [1] * 5
            shape[leg] = lam.shape[0]
            t = t * lam.reshape(shape).to(t.dtype)
        return t

    if not (m % 2 == 0 or staggered_field == 0):
        raise ValueError("staggered field needs an even cell (consistent sublattice parity)")
    sz = np.diag([0.5, -0.5]).astype(complex)
    id_d = np.eye(d, dtype=complex)

    for stage, dt in enumerate(dts):
        b = 0.0 if stage == len(dts) - 1 else staggered_field * (0.5 ** stage)
        gates = {}
        for s1 in (+1, -1):
            # per-bond share: each site sits in 4 bonds → field weight B/4
            hb = h - (b / 4.0) * s1 * (
                np.tensordot(sz, id_d, 0) - np.tensordot(id_d, sz, 0)
            )
            gates[s1] = _gate(hb, dt, dtype, device)
        for _ in range(sweeps_per_dt):
            for i in range(m):
                for j in range(m):
                    for orient in ("h", "v"):
                        if orient == "h":
                            i2, j2 = i, (j + 1) % m
                            l1, l2 = 4, 2          # R of t1, L of t2
                        else:
                            i2, j2 = (i + 1) % m, j
                            l1, l2 = 1, 3          # U of t1, D of t2
                        cls = (orient, i, j)
                        g = gates[+1 if (i + j) % 2 == 0 else -1]
                        t1 = absorb(cell[i][j], i, j, lambdas, skip=l1)
                        t2 = absorb(cell[i2][j2], i2, j2, lambdas, skip=l2)
                        lam = lambdas[cls]
                        # move bond legs to front (after phys)
                        t1m = torch.movedim(t1, l1, 1)   # [d, b, rest(3)]
                        t2m = torch.movedim(t2, l2, 1)
                        theta = torch.einsum("ibxyz,b,jbuvw->ixyzjuvw", t1m,
                                             lam.to(dtype), t2m)
                        th = torch.einsum("iIjJ,IxyzJuvw->ixyzjuvw", g, theta)
                        mmat = th.reshape(d * D**3, d * D**3)
                        u, s, vh = torch.linalg.svd(mmat, full_matrices=False)
                        k = min(D, s.shape[0])
                        u, s, vh = u[:, :k], s[:k], vh[:k, :]
                        s = s / torch.linalg.vector_norm(s)
                        new_lam = torch.clamp(s, min=1e-15)
                        t1n = torch.movedim(u.reshape((d, D, D, D, k)), -1, 1)  # [d, b, rest]
                        t2n = torch.movedim(vh.reshape((k, d, D, D, D)), 0, 1)
                        t1n = torch.movedim(t1n, 1, l1)
                        t2n = torch.movedim(t2n, 1, l2)
                        t1n = absorb(t1n, i, j, lambdas, skip=l1, inverse=True)
                        t2n = absorb(t2n, i2, j2, lambdas, skip=l2, inverse=True)
                        cell[i][j] = t1n / torch.linalg.vector_norm(t1n)
                        cell[i2][j2] = t2n / torch.linalg.vector_norm(t2n)
                        lambdas[cls] = new_lam

    # absorb √λ symmetrically
    sqrt_lam = {k2: torch.sqrt(v) for k2, v in lambdas.items()}
    out = []
    for i in range(m):
        row = []
        for j in range(m):
            t = absorb(cell[i][j], i, j, sqrt_lam, skip=-1)
            row.append(t / torch.linalg.vector_norm(t))
        out.append(row)
    return out, lambdas
