"""The 3-site unit cell (A=up, B=left, C=right of the upper triangle).

Tensor leg conventions (the same as kagomeperiodicbp_tpu's UnitCell, forced
by the node leg-direction tables in lattices/kagome.py):

* A: [d, UL, DL, DR, UR]
* B: [d, L,  DL, R,  UR]
* C: [d, UL, L,  DR, R ]

``UnitCell`` is a small ``nn.Module`` with A, B and C as buffers; ``load``
reads the pickles that the JAX package's ``UnitCell.save`` writes.
"""
from __future__ import annotations

import pickle

import numpy as np
import torch
from torch import nn

from ..ops.kernels import fused_tensor

FLAVORS = ("A", "B", "C")

# 120°-ccw rotation: the node arriving at each position and the permutation
# of its virtual legs into the canonical leg order of the new position.
_ROT_SRC = {"A": "C", "B": "A", "C": "B"}
_ROT_PERM = {"A": (3, 0, 1, 2), "B": (3, 0, 1, 2), "C": (2, 3, 0, 1)}


class UnitCell(nn.Module):
    def __init__(self, A: torch.Tensor, B: torch.Tensor, C: torch.Tensor, rotated: int = 0):
        super().__init__()
        self.register_buffer("A", A)
        self.register_buffer("B", B)
        self.register_buffer("C", C)
        self.rotated = rotated  # how many 120° rotations away from canonical

    # -- access --
    def __getitem__(self, key: str) -> torch.Tensor:
        return getattr(self, key)

    def items(self):
        for f in FLAVORS:
            yield f, getattr(self, f)

    @property
    def d(self) -> int:
        return self.A.shape[0]

    @property
    def D(self) -> int:
        return self.A.shape[1]

    def _map(self, fn, rotated=None) -> "UnitCell":
        return UnitCell(*(fn(t) for _, t in self.items()),
                        rotated=self.rotated if rotated is None else rotated)

    # -- transforms --
    def rotate_ccw(self) -> "UnitCell":
        """Rotate the state by 120° counterclockwise (lattice symmetry)."""
        new = {}
        for f in FLAVORS:
            src = getattr(self, _ROT_SRC[f])
            new[f] = src.permute((0,) + tuple(p + 1 for p in _ROT_PERM[f]))
        return UnitCell(new["A"], new["B"], new["C"], rotated=(self.rotated + 1) % 3)

    def force_zero_rotation(self) -> "UnitCell":
        uc = self
        while uc.rotated % 3 != 0:
            uc = uc.rotate_ccw()
        return uc._map(lambda t: t, rotated=0)

    def normalize(self) -> "UnitCell":
        return self._map(lambda t: t / torch.linalg.vector_norm(t))

    def astype(self, dtype: torch.dtype) -> "UnitCell":
        return self._map(lambda t: t.to(dtype))

    # -- persistence (the JAX package's pickle of numpy arrays) --
    @staticmethod
    def load(path: str, device=None, dtype=None) -> "UnitCell":
        with open(path, "rb") as fh:
            data = pickle.load(fh)

        def one(a):
            t = torch.from_numpy(np.ascontiguousarray(a))
            return t.to(device=device, dtype=dtype or t.dtype)

        return UnitCell(one(data["A"]), one(data["B"]), one(data["C"]),
                        rotated=data.get("rotated", 0))


__all__ = ["FLAVORS", "UnitCell", "fused_tensor"]
