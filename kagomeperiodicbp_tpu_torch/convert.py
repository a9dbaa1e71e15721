"""Carrying state between numpy, the JAX package and this port.

The dict of ``unit_cell_from_numpy`` is the one the JAX package's
``UnitCell.save`` pickles ({"A", "B", "C", "rotated"}), and a message set is
{side_int: [site arrays]}, so a test can hand the same numpy cell and
messages to both packages.
"""
from __future__ import annotations

from typing import Dict, Mapping, Sequence

import numpy as np
import torch

from .lattices import BlockSide
from .networks.unit_cell import FLAVORS, UnitCell
from .ops.mps import MPS, from_sites


def _tensor(a, device, dtype) -> torch.Tensor:
    t = torch.tensor(np.asarray(a))  # a copy: arrays from JAX are read-only
    return t.to(device=device, dtype=dtype or t.dtype)


def unit_cell_from_numpy(data: Mapping, device=None, dtype=None) -> UnitCell:
    return UnitCell(*(_tensor(data[f], device, dtype) for f in FLAVORS),
                    rotated=int(data.get("rotated", 0)))


def messages_from_numpy(sites: Mapping[int, Sequence[np.ndarray]], device=None,
                        dtype=None) -> Dict[BlockSide, MPS]:
    """Messages with zero logscale from {side_int: [site arrays]}."""
    return {BlockSide(int(s)): from_sites([_tensor(a, device, dtype) for a in ss])
            for s, ss in sites.items()}


def to_numpy(x):
    """Tensor → ndarray; UnitCell → the save dict; MPS → list of site
    arrays; a message dict → {side_int: [site arrays]}."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, UnitCell):
        return {**{f: to_numpy(t) for f, t in x.items()}, "rotated": x.rotated}
    if isinstance(x, MPS):
        return [to_numpy(s) for s in x.sites]
    if isinstance(x, Mapping):
        return {int(k): to_numpy(v) for k, v in x.items()}
    raise TypeError(f"to_numpy: unsupported {type(x)}")
