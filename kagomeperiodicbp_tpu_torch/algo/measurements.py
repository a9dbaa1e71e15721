"""Energy and observable measurements on a unit cell via per-edge RDMs
(counterpart of kagomeperiodicbp_tpu/algo/measurements.py; the full-sandwich
``sandwich_expectation`` is not ported yet).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

import numpy as np
import torch

from ..enums import UpdateEdge
from ..networks.unit_cell import UnitCell
from ..physics import pauli
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
    cells = (cell.A, cell.B, cell.C)
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
