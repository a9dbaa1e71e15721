"""Foreign-state bridges: load tnsu-format Kagome tensor sets as UnitCells
(counterpart of kagomeperiodicbp_tpu/utils/foreign.py).

The reference warm-starts its ITE from published tnsu simple-update states
(reference: scripts/run_ite.py:78-107 via src/unit_cell/get_from/
_simple_update.py:272-291, the tnsu → unit-cell bridge). The tnsu networks
are saved after ``absorb_all_weights()`` (_simple_update.py:379), so the
√λ gauge is already folded in and the single-periodic-cell sets map
straight onto (A, B, C) with no leg permutation.

The pickles reference the foreign package's classes; a stub unpickler
captures their attribute dicts. Unlike the JAX package's, it imports no
module at all: numpy's array globals are the only ones it resolves, and
every other class the pickle names becomes a stub.
"""
from __future__ import annotations

import glob
import os
import pickle
import re

import numpy as np
import torch

from ..networks.unit_cell import NumpyUnpickler, UnitCell

# the reference repository's folder of published sets (data/ of a checkout
# of it), relative to the working directory; a missing set raises
# FileNotFoundError, and `path` names a set anywhere
DEFAULT_TNSU_FOLDER = os.path.join("data", "simple_update_results")


class _Stub:
    """Placeholder for any class the pickle references; keeps the state."""

    def __init__(self, *a, **k):
        pass

    def __setstate__(self, state):
        self.__dict__.update(state if isinstance(state, dict) else {"_state": state})


class _StubUnpickler(pickle.Unpickler):
    """numpy's arrays and scalars as themselves, old-protocol object
    reconstruction on stubs, and a stub class for every other global."""

    _ALLOWED = NumpyUnpickler._NUMPY | {("copyreg", "_reconstructor"), ("builtins", "object")}

    def find_class(self, module, name):
        if (module, name) in self._ALLOWED:
            return super().find_class(module, name)
        return type(name, (_Stub,), {"__module__": module})


def load_tnsu(path: str) -> dict:
    """→ dict with `tensors` (list of ndarrays, leg order [d, 1..4]),
    `D` (from the tensors: the stored `virtual_dim` attribute is stale on
    some sets), `final_energy` (the foreign implementation's own number)."""
    with open(path, "rb") as fh:
        obj = _StubUnpickler(fh).load()
    d = obj.__dict__ if hasattr(obj, "__dict__") else dict(obj)
    return {
        "tensors": d["tensors"],
        "D": int(d["tensors"][0].shape[1]),
        "final_energy": (float(d["final_energy"])
                         if d.get("final_energy") is not None else None),
    }


def write_tnsu(path, tensors, final_energy=None, **attrs) -> str:
    """Write a tnsu-format set: the foreign package's TensorNetwork object
    with `tensors` (leg order [d, 1..4]), unit weights and `final_energy`
    (and any other attributes in `attrs`), pickled under the foreign
    module's name, which need not be importable. Returns the path."""
    import sys
    import types

    mod = types.ModuleType("tnsu.tensor_network")
    cls = type("TensorNetwork", (), {"__module__": mod.__name__})
    mod.TensorNetwork = cls
    obj = cls()
    obj.tensors = list(tensors)
    obj.weights = [np.ones(t.shape[1]) for t in obj.tensors]
    obj.final_energy = None if final_energy is None else np.float64(final_energy)
    obj.__dict__.update(attrs)
    saved = {name: sys.modules.get(name) for name in ("tnsu", mod.__name__)}
    sys.modules.update({"tnsu": types.ModuleType("tnsu"), mod.__name__: mod})
    try:
        with open(path, "wb") as fh:
            pickle.dump(obj, fh)
    finally:
        for name, was in saved.items():
            if was is None:
                sys.modules.pop(name, None)
            else:
                sys.modules[name] = was
    return str(path)


def tnsu_unit_cell(D: int, dtype: torch.dtype = torch.complex128,
                   folder: str = DEFAULT_TNSU_FOLDER, path: str | None = None, device=None):
    """The published size=1 PBC tnsu SU state at bond dimension D (or the
    set at `path`), as a UnitCell on `device`, with the foreign energy: the
    same warm start the reference's run_ite uses."""
    if path is None:
        path = os.path.join(folder, f"tnsu_AFH_D={D}_size=1_PBC.dat")
        if not os.path.exists(path):
            avail = sorted(
                int(re.search(r"D=(\d+)", p).group(1))
                for p in glob.glob(os.path.join(folder, "*size=1_PBC.dat")))
            raise FileNotFoundError(
                f"{path} not found (size=1 PBC sets available for D={avail})")
    data = load_tnsu(path)
    if len(data["tensors"]) != 3:
        raise ValueError(
            f"{path}: {len(data['tensors'])} tensors — only "
            "single-periodic-cell (3-tensor) sets map directly onto (A,B,C)")
    if data["D"] != D:
        raise ValueError(f"{path}: tensors have D={data['D']}, requested D={D}")
    ts = [torch.tensor(np.asarray(t)).to(device=device, dtype=dtype) for t in data["tensors"]]
    return UnitCell(*ts), data["final_energy"]
