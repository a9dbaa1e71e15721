"""Quantum-information metrics on 2-site RDMs.

(reference: src/physics/metrics/ — negativity, fidelity,
entanglement entropy, hermicity; and src/algo/density_matrices.py)
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

import numpy as np


def rho_tensor_to_matrix(rho: np.ndarray) -> np.ndarray:
    """ρ[i_ket,i_bra,j_ket,j_bra] → matrix [(i j)_ket, (i j)_bra]
    (reference: density_matrices.py:11 rho_ij_to_rho + TenQI.op_to_mat)."""
    rho = np.asarray(rho)
    d1, d2 = rho.shape[0], rho.shape[2]
    return np.transpose(rho, (0, 2, 1, 3)).reshape(d1 * d2, d1 * d2)


def hermicity(m: np.ndarray) -> float:
    n = np.linalg.norm(m)
    if n == 0:
        return 0.0
    return float(np.linalg.norm(m - m.conj().T) / n)


def negativity(rho: np.ndarray, d1: int = 2, d2: int = 2) -> float:
    """Σ|λ₋| of the partial transpose (reference: metrics/_negativity.py:55)."""
    m = rho if rho.ndim == 2 else rho_tensor_to_matrix(rho)
    t = m.reshape(d1, d2, d1, d2)
    pt = np.transpose(t, (0, 3, 2, 1)).reshape(d1 * d2, d1 * d2)
    w = np.linalg.eigvals(pt)
    return float(np.abs(w.real[w.real < 0]).sum())


def fidelity(rho1: np.ndarray, rho2: np.ndarray) -> float:
    """(Tr√(√ρ₁ ρ₂ √ρ₁))² (reference: metrics/_fidelity.py:4)."""
    m1 = rho1 if rho1.ndim == 2 else rho_tensor_to_matrix(rho1)
    m2 = rho2 if rho2.ndim == 2 else rho_tensor_to_matrix(rho2)

    def psd_sqrt(m):
        m = 0.5 * (m + m.conj().T)
        w, u = np.linalg.eigh(m)
        w = np.clip(w, 0, None)
        return (u * np.sqrt(w)) @ u.conj().T

    s1 = psd_sqrt(m1)
    inner = psd_sqrt(s1 @ m2 @ s1)
    return float(np.real(np.trace(inner)) ** 2)


def entanglement_entropy(rho: np.ndarray, d1: int = 2, d2: int = 2) -> float:
    """Von Neumann entropy of the reduced single-site state."""
    m = rho if rho.ndim == 2 else rho_tensor_to_matrix(rho)
    t = m.reshape(d1, d2, d1, d2)
    r1 = np.trace(t, axis1=1, axis2=3)
    w = np.linalg.eigvalsh(0.5 * (r1 + r1.conj().T))
    w = w[w > 1e-15]
    return float(-(w * np.log2(w)).sum())


@dataclass
class MatrixMetrics:
    """(reference: containers/density_matrices.py MatrixMetrics)"""

    eigenvalues: np.ndarray
    negativity: float
    hermicity: float
    norm: float
    trace: complex
    sum_eigenvalues: complex
    other: Dict[str, float] = field(default_factory=dict)


def calc_metrics(rho: np.ndarray) -> MatrixMetrics:
    m = rho if rho.ndim == 2 else rho_tensor_to_matrix(rho)
    w = np.linalg.eigvals(m)
    return MatrixMetrics(
        eigenvalues=w,
        negativity=negativity(m),
        hermicity=hermicity(m),
        norm=float(np.linalg.norm(m)),
        trace=complex(np.trace(m)),
        sum_eigenvalues=complex(w.sum()),
    )
