"""Multi-qubit operator helpers (reference: src/libs/TenQI.py).

Operators in tensor form carry interleaved ket/bra legs
[k1, b1, k2, b2, …]; matrix form groups kets then bras.
"""
from __future__ import annotations

import numpy as np


def op_to_mat(op: np.ndarray) -> np.ndarray:
    """[k1,b1,…,kn,bn] → matrix [(k1…kn), (b1…bn)] (TenQI.py:55)."""
    op = np.asarray(op)
    n = op.ndim // 2
    kets = list(range(0, 2 * n, 2))
    bras = list(range(1, 2 * n, 2))
    d = int(np.prod([op.shape[i] for i in kets]))
    return np.transpose(op, kets + bras).reshape(d, d)


def mat_to_op(mat: np.ndarray, dims: tuple) -> np.ndarray:
    """Inverse of op_to_mat for site dimensions `dims` (TenQI.py:99)."""
    n = len(dims)
    t = np.asarray(mat).reshape(tuple(dims) + tuple(dims))
    perm = []
    for i in range(n):
        perm += [i, i + n]
    return np.transpose(t, perm)


def op_dagger(op: np.ndarray) -> np.ndarray:
    """Hermitian conjugate in tensor form (TenQI.py:148)."""
    op = np.asarray(op)
    n = op.ndim // 2
    perm = []
    for i in range(n):
        perm += [2 * i + 1, 2 * i]
    return np.conj(np.transpose(op, perm))


def op_norm(op: np.ndarray, ord=2) -> float:
    """Operator norm of the matrix form (TenQI.py:181)."""
    return float(np.linalg.norm(op_to_mat(op), ord=ord))


def op_trace(op: np.ndarray) -> complex:
    """Trace of the matrix form (TenQI.py:231)."""
    return complex(np.trace(op_to_mat(op)))
