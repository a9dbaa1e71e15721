"""The 3-site unit cell (A=up, B=left, C=right of the upper triangle).

Tensor leg conventions (the same as kagomeperiodicbp_tpu's UnitCell, forced
by the node leg-direction tables in lattices/kagome.py):

* A: [d, UL, DL, DR, UR]
* B: [d, L,  DL, R,  UR]
* C: [d, UL, L,  DR, R ]

``UnitCell`` is a small ``nn.Module`` with A, B and C as buffers. ``save``
writes, and ``load`` reads, the JAX package's pickle of numpy arrays
({"A", "B", "C", "rotated"}), so either package reads the other's cells.
Random draws take an explicit ``torch.Generator`` on the cell's device
(``jax.random``'s streams cannot be repeated in torch).
"""
from __future__ import annotations

import os
import pickle
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..ops.kernels import fused_tensor, fused_tensors_with_operator

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

    def replace(self, **kw) -> "UnitCell":
        fields = {f: getattr(self, f) for f in FLAVORS}
        fields["rotated"] = self.rotated
        fields.update(kw)
        return UnitCell(**fields)

    def to_device(self, device) -> "UnitCell":
        """A copy of the cell on `device` (``nn.Module.to`` would move this
        one in place)."""
        return self._map(lambda t: t.to(device))

    # -- constructors --
    @staticmethod
    def random(d: int, D: int, generator: Optional[torch.Generator] = None,
               dtype: torch.dtype = torch.complex128, device=None) -> "UnitCell":
        """iid Gaussian tensors of unit norm (real and imaginary parts drawn
        apart, as the JAX package does), from `generator` on `device`."""
        shape = (d, D, D, D, D)
        device = generator.device if generator is not None and device is None else device
        real = torch.empty((), dtype=dtype).real.dtype

        def one():
            t = torch.randn(shape, generator=generator, dtype=real, device=device)
            if dtype.is_complex:
                t = torch.complex(t, torch.randn(shape, generator=generator, dtype=real,
                                                 device=device))
            t = t.to(dtype)
            return t / torch.linalg.vector_norm(t)

        return UnitCell(one(), one(), one())

    @staticmethod
    def random_product_state(d: int, D: int, generator: Optional[torch.Generator] = None,
                             dtype: torch.dtype = torch.complex128, device=None) -> "UnitCell":
        uc = UnitCell.random(d, D, generator, dtype, device)
        return UnitCell(uc.A, uc.A, uc.A)

    @staticmethod
    def product_state_120(d: int, D: int, chirality: int = +1,
                          dtype: torch.dtype = torch.complex128, device=None) -> "UnitCell":
        """q=0 120° Néel order: spin-coherent product state with the three
        sublattice spins coplanar (xz-plane) at mutual 120° angles;
        chirality=±1 picks the A→B→C winding."""
        if d != 2:
            raise ValueError("spin coherent states are defined for d=2")
        ts = []
        for k in range(3):
            alpha = chirality * 2.0 * np.pi / 3.0 * k
            t = np.zeros((d, D, D, D, D))
            t[0, 0, 0, 0, 0] = np.cos(alpha / 2.0)
            t[1, 0, 0, 0, 0] = np.sin(alpha / 2.0)
            ts.append(torch.as_tensor(t, dtype=dtype, device=device))
        return UnitCell(*ts)

    @staticmethod
    def zero_product_state(d: int, D: int, dtype: torch.dtype = torch.complex128,
                           device=None) -> "UnitCell":
        """|0…0⟩: nonzero only at physical index 0, virtual (0,0,0,0)."""
        t = torch.zeros((d, D, D, D, D), dtype=dtype, device=device)
        t[0, 0, 0, 0, 0] = 1.0
        return UnitCell(t, t, t)

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

    def pad_to(self, D: int, noise_fraction: float = 0.03,
               generator: Optional[torch.Generator] = None) -> "UnitCell":
        """Embed into a larger bond dimension: zero-pad every virtual leg to
        `D` and add noise so the new bond directions are live (a converged D
        state seeds the D+1 optimisation). With near-zero weight in the
        padded directions the ALS metric is near-singular; 0.03–0.1 is the
        stable range the JAX package measured."""
        if D < self.D:
            raise ValueError(f"pad_to({D}) below current D={self.D}")
        if D == self.D:
            return self

        def pad(t):
            out = torch.zeros((t.shape[0],) + (D,) * 4, dtype=t.dtype, device=t.device)
            out[:, :t.shape[1], :t.shape[2], :t.shape[3], :t.shape[4]] = t
            return out

        cell = self._map(pad)
        return cell.add_noise(noise_fraction, generator) if noise_fraction else cell

    def add_noise(self, fraction: float, generator: Optional[torch.Generator] = None) -> "UnitCell":
        """Gaussian noise scaled to `fraction`·‖T‖ per tensor, from
        `generator` (on the cell's device)."""

        def noisy(t):
            real = t.real.dtype
            noise = torch.randn(t.shape, generator=generator, dtype=real, device=t.device)
            if t.dtype.is_complex:
                im = torch.randn(t.shape, generator=generator, dtype=real, device=t.device)
                noise = torch.complex(noise, im)
            noise = noise.to(t.dtype)
            return t + noise * (fraction * torch.linalg.vector_norm(t)
                                / torch.linalg.vector_norm(noise))

        return self._map(noisy)

    def normalize(self) -> "UnitCell":
        return self._map(lambda t: t / torch.linalg.vector_norm(t))

    def astype(self, dtype: torch.dtype) -> "UnitCell":
        return self._map(lambda t: t.to(dtype))

    # -- persistence (the JAX package's pickle of numpy arrays) --
    def save(self, path: str) -> str:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        data = {f: t.detach().cpu().resolve_conj().numpy() for f, t in self.items()}
        data["rotated"] = self.rotated
        with open(path, "wb") as fh:
            pickle.dump(data, fh)
        return path

    @staticmethod
    def load(path: str, device=None, dtype=None) -> "UnitCell":
        """Read a cell that either package saved; the pickle may hold numpy
        arrays and plain values only (``NumpyUnpickler``)."""
        with open(path, "rb") as fh:
            data = NumpyUnpickler(fh).load()

        def one(a):
            t = torch.from_numpy(np.ascontiguousarray(a))
            return t.to(device=device, dtype=dtype or t.dtype)

        return UnitCell(one(data["A"]), one(data["B"]), one(data["C"]),
                        rotated=data.get("rotated", 0))


class NumpyUnpickler(pickle.Unpickler):
    """An unpickler that builds numpy arrays and plain Python values, and
    refuses every other global: reading a cell or checkpoint runs no code
    and imports no package beyond numpy. ``extra`` maps further
    (module, name) pairs to the objects that stand for them."""

    _NUMPY = {(m, n) for m in ("numpy.core.multiarray", "numpy._core.multiarray")
              for n in ("_reconstruct", "scalar")} | {("numpy", "ndarray"), ("numpy", "dtype")}

    def __init__(self, file, extra: Optional[dict] = None):
        super().__init__(file)
        self.extra = extra or {}

    def find_class(self, module, name):
        if (module, name) in self.extra:
            return self.extra[(module, name)]
        if (module, name) in self._NUMPY:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(f"refusing to unpickle {module}.{name}")


def fused_tensor_with_operator(t: torch.Tensor, op) -> torch.Tensor:
    """ket–op–bra sandwich with fused ket-bra pairs: the double-layer tensor
    of ⟨ψ| op |ψ⟩ at one site, [d, D,D,D,D] + op [d, d] → [D²,D²,D²,D²]
    (K1's operator form: one launch on the card)."""
    return fused_tensors_with_operator(t, (op,))[0]


__all__ = ["FLAVORS", "NumpyUnpickler", "UnitCell", "fused_tensor", "fused_tensor_with_operator"]
