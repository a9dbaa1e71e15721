"""Arbitrary (non-repeated) Kagome blocks: per-site tensors, BP, and
lattice-shift-averaged measurements (counterpart of
kagomeperiodicbp_tpu/algo/arbitrary.py).

(reference: `KagomeTNArbitrary`, tensor_network.py:400/489 and
`calc_measurement_non_unit_cell_kagome_tn`, measurements.py:245 — used for
cross-implementation validation of externally produced tensor sets)

The same compiled plans serve arbitrary blocks: the tensor fetchers index
``fused[v % len(fused)]``, so passing 3 tensors tiles a unit cell and
passing ``3·n_triangles`` tensors binds every site individually. Their
fused tensors take one launch of kernel K1 per three sites on the card
(``contraction.fused_cells``).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..lattices import KagomeBlock, LatticeDir, triangle
from ..networks.unit_cell import FLAVORS, UnitCell
from .bp import BPConfig, robust_belief_propagation
from .measurements import MeasurementsOnUnitCell, measure_energies_and_observables


def kagome_shift_permutation(N: int, d: LatticeDir) -> List[int]:
    """Kagome-node permutation for a one-step periodic shift of the block:
    node 3t+k → 3·σ(t)+k with σ the triangle-lattice shift
    (reference: triangle.py:1020, tensor_network.py:489)."""
    tri_perm = triangle.periodic_shift_permutation(N, d)
    return [3 * tri_perm[t] + k for t in range(triangle.total_vertices(N)) for k in range(3)]


def all_shift_permutations(N: int) -> List[List[int]]:
    """All |triangles| distinct periodic shifts (identity included) — every
    way of centring the block (reference: triangle.py:1138)."""
    nt = triangle.total_vertices(N)
    base_r = kagome_shift_permutation(N, LatticeDir.R)
    base_dr = kagome_shift_permutation(N, LatticeDir.DR)

    def compose(p, q):  # apply q after p
        return [q[x] for x in p]

    perms, seen = [], set()
    # the translation group, generated by composing R and DR shifts
    frontier = [list(range(3 * nt))]
    while frontier:
        p = frontier.pop()
        key = tuple(p)
        if key in seen:
            continue
        seen.add(key)
        perms.append(p)
        frontier.append(compose(p, base_r))
        frontier.append(compose(p, base_dr))
    if len(perms) != nt:
        raise AssertionError(f"expected {nt} shifts, got {len(perms)}")
    return perms


class ArbitraryKagomeTN:
    """A size-N block with an individual ket tensor per site."""

    def __init__(self, tensors: Sequence[torch.Tensor], N: int):
        block = KagomeBlock.build(N)
        if len(tensors) != block.n_nodes:
            raise ValueError(f"need {block.n_nodes} tensors for N={N}, got {len(tensors)}")
        self.N = N
        self.block = block
        self.tensors = list(tensors)

    @staticmethod
    def from_unit_cell(cell: UnitCell, N: int) -> "ArbitraryKagomeTN":
        block = KagomeBlock.build(N)
        return ArbitraryKagomeTN([cell[FLAVORS[v % 3]] for v in range(block.n_nodes)], N)

    def shifted(self, perm: List[int]) -> "ArbitraryKagomeTN":
        """Tensors moved by a periodic-shift permutation (node v's tensor
        moves to perm[v])."""
        new: List[Optional[torch.Tensor]] = [None] * len(self.tensors)
        for v, t in enumerate(self.tensors):
            new[perm[v]] = t
        return ArbitraryKagomeTN(new, self.N)

    def as_cell_view(self) -> "_PerSiteCellView":
        """A pseudo unit cell whose tensors are the full per-site list: it
        stands in for a UnitCell in BP and the measurements, whose fetchers
        index ``fused[v % len(fused)]``."""
        return _PerSiteCellView(self.tensors)

    def measure(self, h: np.ndarray, bp_config: Optional[BPConfig] = None,
                chi: Optional[int] = None, average_shifts: bool = False) -> MeasurementsOnUnitCell:
        """BP + per-edge measurements; optionally averaged over every
        periodic shift of the block (reference measurements.py:245-321)."""
        D = int(self.tensors[0].shape[1])
        bp_config = bp_config or BPConfig(trunc_dim=2 * D * D, dtype=self.tensors[0].dtype)
        chi = chi or 2 * D * D + 10

        tns = [self]
        if average_shifts:
            tns = [self.shifted(p) for p in all_shift_permutations(self.N)]

        results = []
        for tn in tns:
            holder = tn.as_cell_view()
            msgs, _ = robust_belief_propagation(holder, None, bp_config, self.N)
            results.append(measure_energies_and_observables(holder, msgs, self.N, chi,
                                                            bp_config.trunc_dim, h))
        if len(results) == 1:
            return results[0]
        out = MeasurementsOnUnitCell()
        for key in results[0].energies:
            out.energies[key] = float(np.mean([r.energies[key] for r in results]))
            out.entanglement[key] = float(np.mean([r.entanglement[key] for r in results]))
        out.expectations = {f: {k: float(np.mean([r.expectations[f][k] for r in results]))
                                for k in "xyz"}
                            for f in FLAVORS}
        return out


class _PerSiteCellView:
    """Stands in for a UnitCell in BP and the measurements, carrying one
    tensor per site (``contraction.site_kets`` reads ``_tensors``)."""

    def __init__(self, tensors: Sequence[torch.Tensor]):
        self._tensors = list(tensors)
        self.rotated = 0

    @property
    def A(self) -> torch.Tensor:
        return self._tensors[0]

    @property
    def B(self) -> torch.Tensor:
        return self._tensors[1]

    @property
    def C(self) -> torch.Tensor:
        return self._tensors[2]

    @property
    def D(self) -> int:
        return int(self._tensors[0].shape[1])

    def __getitem__(self, key: str) -> torch.Tensor:
        return self._tensors[FLAVORS.index(key)]

    def items(self):
        yield from zip(FLAVORS, self._tensors[:3])
