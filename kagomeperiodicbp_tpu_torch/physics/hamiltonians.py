"""2-local Hamiltonian terms in [i_ket, i_bra, j_ket, j_bra] layout.

(reference: src/physics/hamiltonians.py:30-85)
"""
from __future__ import annotations

import numpy as np

from . import pauli


def zero() -> np.ndarray:
    return np.zeros((2, 2, 2, 2), dtype=np.complex128)


def heisenberg_afm() -> np.ndarray:
    """AFM Heisenberg: h = S·S = ¼ Σ σᵢ⊗σᵢ (reference: hamiltonians.py:53)."""
    h = sum(pauli.two_site(pauli.SPIN[k], pauli.SPIN[k]) for k in "xyz")
    return np.asarray(h)


heisenberg_afm.reference = -0.40454  # published VU D=2 energy/site (hamiltonians.py:61)


def heisenberg_fm() -> np.ndarray:
    return -heisenberg_afm()


def heisenberg_afm_with_field(b: float = 0.0, direction: str = "z") -> np.ndarray:
    """AFM + uniform field −B·Σ Sᶻ distributed over edges: each site appears
    in 4 edges of the Kagome lattice, so the per-edge field weight is B/4
    (reference: hamiltonians.py:37-50)."""
    h = heisenberg_afm()
    s = pauli.SPIN[direction]
    h = h - (b / 4.0) * (pauli.two_site(s, pauli.id2) + pauli.two_site(pauli.id2, s))
    return h


heisenberg_afm_with_field.reference = heisenberg_afm.reference  # field→0 limit


def ising_with_transverse_field(b: float = 0.0) -> np.ndarray:
    """H = −ΣZZ − B·ΣX (per-edge X weight 1/4; reference: hamiltonians.py:71)."""
    h = -pauli.two_site(pauli.z, pauli.z)
    h = h - (b / 4.0) * (pauli.two_site(pauli.x, pauli.id2) + pauli.two_site(pauli.id2, pauli.x))
    return h


class DecreasingGlobalField:
    """The reference's AFM-T annealing protocol
    (scripts/run_ite.py:29-41 `decreasing_global_field_func`):
    a uniform field that decays ×0.93 per ITE segment (×0.90 once
    δt < 1e-5), starting at 1e-2 and clamped to 0 below 1e-16. The field
    breaks the degeneracy between competing basins early on and vanishes by
    the time energies are measured at small δt — this is how the reference
    reaches its best-store basins from random starts.

    Stateful by design: each call advances the decay, mirroring the
    reference's module-global `crnt_force_value`.
    """

    def __init__(self, start: float = 1e-2):
        self.value = start

    def __call__(self, delta_t: float | None) -> float:
        if delta_t is None:
            return 0.0
        self.value *= 0.93 if delta_t > 1e-5 else 0.90
        if self.value < 1e-16:
            self.value = 0.0
        return self.value


def constant_global_field(b: float):
    return lambda delta_t: b


BY_NAME = {
    "AFM": heisenberg_afm,
    "FM": heisenberg_fm,
    "AFM-T": heisenberg_afm_with_field,
    "Ising-AFM": ising_with_transverse_field,
}
