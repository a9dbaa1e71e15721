"""Energy and observable measurements on a unit cell via per-edge RDMs, and
single-site expectations by the full operator sandwich (counterpart of
kagomeperiodicbp_tpu/algo/measurements.py).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict

import numpy as np
import torch

from ..enums import UpdateEdge
from ..lattices import BlockSide
from ..networks.unit_cell import FLAVORS, UnitCell, fused_tensor_with_operator
from ..ops.contract import execute_plan
from ..ops.kernels import fused_tensors_with_operator
from ..physics import pauli
from . import contraction as C
from . import fused as F
from .contraction import MessageDict


@dataclass
class MeasurementsOnUnitCell:
    energies: Dict[str, float] = field(default_factory=dict)
    expectations: Dict[str, Dict[str, float]] = field(default_factory=dict)
    entanglement: Dict[str, float] = field(default_factory=dict)

    @property
    def mean_energy(self) -> float:
        """Energy per site: Σ over the 6 edge classes / 3 sites."""
        return float(sum(self.energies.values()) / 3.0)


def expectation_values_with_rdm(rho: np.ndarray) -> Dict[str, tuple]:
    """Per-site ⟨x/y/z⟩ from the 2-site RDM's partial traces."""
    res = {}
    rho_i = np.einsum("iIjj->iI", rho)
    rho_j = np.einsum("iijJ->jJ", rho)
    for name, op in pauli.ALL.items():
        vi = complex(np.einsum("iI,Ii->", rho_i, op))
        vj = complex(np.einsum("jJ,Jj->", rho_j, op))
        res[name] = (vi, vj)
    return res


def sandwich_expectation(
    cell: UnitCell,
    messages: MessageDict,
    N: int,
    chi: int,
    chi_msg: int,
    operator: np.ndarray,
    flavor: int = 0,
    force_real: bool = False,
    _shared=None,
):
    """⟨op⟩ at a central site of `flavor` by fully contracting the operator
    sandwich: numerator = the network with that site's double-layer tensor
    replaced by the ket–op–bra sandwich (K1's operator form), denominator =
    the plain network norm, each as (mantissa, log) so that the ratio never
    under- or overflows; the message log-scales cancel in it. Independent of
    the RDM path, which it cross-checks.

    `_shared`: the plan, fused tensors and denominator from
    `_sandwich_shared`, computed once for a batch of calls."""
    sh = _shared or _sandwich_shared(cell, messages, N, chi, chi_msg)
    f_op = fused_tensor_with_operator(cell[FLAVORS[flavor % 3]], operator)
    return _sandwich_ratio(sh, flavor, f_op, force_real)


def _central_site(graph, flavor: int) -> int:
    """The lattice node of `flavor` nearest the block's centre."""
    lat_nodes = [n for n in graph.nodes if n.source[0] == "lat"]
    mine = [n for n in lat_nodes if n.source[1] % 3 == flavor % 3]
    cx = np.mean([n.pos for n in lat_nodes], axis=0)
    node = min(mine, key=lambda n: (n.pos[0] - cx[0]) ** 2 + (n.pos[1] - cx[1]) ** 2)
    return node.source[1]


def _sandwich_ratio(sh, flavor: int, f_op: torch.Tensor, force_real: bool):
    """The numerator with `f_op` at the central site of `flavor`, over the
    shared denominator."""
    target = _central_site(sh["graph"], flavor)
    fused, msg_sites = sh["fused"], sh["msg_sites"]

    def fetch(source):
        if source[0] == "lat":
            return f_op if source[1] == target else fused[source[1] % 3]
        _, side, k = source
        return msg_sites[side][k]

    num_m, num_l = execute_plan(sh["plan"], fetch)
    den_m, den_l = sh["den"]
    ratio = complex(num_m.item()) / complex(den_m.item())
    val = ratio * math.exp(float(num_l - den_l))
    return float(val.real) if force_real else val


def _sandwich_shared(cell: UnitCell, messages: MessageDict, N: int, chi: int, chi_msg: int):
    """Plan, graph, fused tensors (one K1 launch) and the operator-free
    denominator, computed once per (cell, messages) for a batch of
    sandwich calls."""
    plan = C.full_scalar_plan(N, cell.D, chi, chi_msg)
    graph = C._graph_for(N, cell.D, chi_msg, tuple(int(s) for s in BlockSide))
    fused = C.fused_cells(cell)
    msg_sites = {int(s): tuple(m.sites) for s, m in messages.items()}
    den = execute_plan(plan, C._make_fetch(fused, msg_sites))
    return {"plan": plan, "graph": graph, "fused": fused, "msg_sites": msg_sites, "den": den}


def measure_xyz_sandwich(cell: UnitCell, messages: MessageDict, N: int, chi: int,
                         chi_msg: int) -> Dict[str, Dict[str, complex]]:
    """Per-flavour ⟨x/y/z⟩ by the full sandwich: one denominator serves all
    9 numerators, and each flavour's three sandwiches come from one launch
    of K1's operator form (1 + 3 K1 launches in all on the card)."""
    shared = _sandwich_shared(cell, messages, N, chi, chi_msg)
    out: Dict[str, Dict[str, complex]] = {}
    for f, name in enumerate(FLAVORS):
        f_ops = fused_tensors_with_operator(cell[name], [pauli.ALL[k] for k in "xyz"])
        out[name] = {k: _sandwich_ratio(shared, f, f_op, False) for k, f_op in zip("xyz", f_ops)}
    return out


def measure_energies_and_observables(
    cell: UnitCell,
    messages: MessageDict,
    N: int,
    chi: int,
    chi_msg: int,
    h: np.ndarray,
    force_real: bool = True,
) -> MeasurementsOnUnitCell:
    """Energy, negativity and ⟨x/y/z⟩ of all 6 edge classes. The six edges
    are computed on the device first; their scalars come back in one batch."""
    dtype = cell.A.dtype
    h_t = torch.as_tensor(h if dtype.is_complex else np.real(h), dtype=dtype, device=cell.A.device)
    cells = C.site_kets(cell)
    msg_sites = F._msgs_to_sites(messages)

    results = {}
    for edge in UpdateEdge.all_options():
        results[edge] = F.edge_measure(N, cell.D, chi, chi_msg, edge)(cells, msg_sites, h_t)

    def host(x) -> complex:
        return complex(x.item())

    out = MeasurementsOnUnitCell()
    acc = {f: {k: [] for k in "xyz"} for f in "ABC"}
    for edge, (energy, neg, exps) in results.items():
        e = host(energy)
        key = str(edge)
        out.energies[key] = float(e.real) if force_real else e
        out.entanglement[key] = float(neg)
        f1, f2 = edge.first.name, edge.second.name
        for k, (vi, vj) in exps.items():
            vi, vj = host(vi), host(vj)
            acc[f1][k].append(vi.real if force_real else vi)
            acc[f2][k].append(vj.real if force_real else vj)

    out.expectations = {
        f: {k: float(np.mean(v)) for k, v in kv.items()} for f, kv in acc.items()
    }
    return out
