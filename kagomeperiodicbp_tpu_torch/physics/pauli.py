"""Pauli and spin-½ operators (reference: src/physics/pauli.py,
spin_operators.py). Plain numpy — these are tiny host-side constants."""
import numpy as np

x = np.array([[0.0, 1.0], [1.0, 0.0]], dtype=np.complex128)
y = np.array([[0.0, -1.0j], [1.0j, 0.0]], dtype=np.complex128)
z = np.array([[1.0, 0.0], [0.0, -1.0]], dtype=np.complex128)
id2 = np.eye(2, dtype=np.complex128)

# spin-1/2
sx, sy, sz = x / 2, y / 2, z / 2

ALL = {"x": x, "y": y, "z": z}
SPIN = {"x": sx, "y": sy, "z": sz}


def two_site(op1: np.ndarray, op2: np.ndarray) -> np.ndarray:
    """op1 ⊗ op2 in [i_ket, i_bra, j_ket, j_bra] tensor layout."""
    return np.tensordot(op1, op2, 0)
