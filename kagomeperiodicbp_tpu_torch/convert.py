"""Carrying state between numpy, the JAX package and this port.

The dict of ``unit_cell_from_numpy`` is the one the JAX package's
``UnitCell.save`` pickles ({"A", "B", "C", "rotated"}), and a message set is
{side_int: [site arrays]}, so a test can hand the same numpy cell and
messages to both packages; so are a simple update's λs ({(f1, f2): array}),
an arbitrary block's per-site tensors and a square-lattice cell (an m×m
list of [d, D,D,D,D] arrays, legs [d, U, L, D, R]) with its messages; chains
of cells and their messages stack into the [n_chains, …] batches of
``parallel/multichip``. A saved cell or best-store file of either package
reads with ``UnitCell.load``; a JAX ``ITETracker`` checkpoint with
``tracker_from_jax_checkpoint``. Neither imports JAX or its package.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch

from .algo.arbitrary import ArbitraryKagomeTN
from .algo.bp import BPConfig, BPStats
from .enums import UpdateMode
from .lattices import BlockSide
from .lattices.kagome import num_message_sites
from .networks.graph import message_bond_profile
from .networks.unit_cell import FLAVORS, NumpyUnpickler, UnitCell
from .ops.mps import MPS, from_sites
from .square.lattice import SquareSide

_JAX_PACKAGE = "kagomeperiodicbp_tpu"


def tracker_from_jax_checkpoint(path: str, device=None):
    """An ``ITETracker`` from a checkpoint the JAX package's
    ``ITETracker.save`` wrote, its best cell on `device`; it does not write
    back to that file. The pickle is read with a restricted unpickler: the
    JAX package and JAX are not imported, and a global outside its table of
    classes and dtypes is refused."""
    from .algo.ite import _DTYPE_NAMES, ITESegmentStats, ITETracker  # algo.ite imports this module

    # the JAX package's classes (module paths relative to its package), each
    # read as this port's class of the same fields; jnp dtypes as torch's
    classes = {
        **{(f"{_JAX_PACKAGE}.{module}", cls.__name__): cls
           for module, cls in (("algo.ite", ITESegmentStats), ("algo.bp", BPStats),
                               ("algo.bp", BPConfig), ("enums", UpdateMode))},
        **{("jax.numpy", n): getattr(torch, n) for n in _DTYPE_NAMES},
    }
    with open(path, "rb") as fh:
        data = NumpyUnpickler(fh, extra=classes).load()
    for seg in data.get("stats", []):
        for st in seg.bp_stats:
            cfg = st.final_config
            if cfg is not None and cfg.dtype is not None and not isinstance(cfg.dtype, torch.dtype):
                cfg.dtype = getattr(torch, np.dtype(cfg.dtype).name)
    return ITETracker.from_checkpoint(data, None, device)


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


def numpy_random_cell(D: int, seed: int, d: int = 2) -> dict:
    """The save dict of a random cell drawn with numpy from `seed`: iid
    Gaussian real and imaginary parts, each tensor of unit norm (the
    distribution of ``UnitCell.random``), the same numbers on every device
    and in either package."""
    rng = np.random.default_rng(seed)

    def one():
        t = rng.standard_normal((d,) + (D,) * 4) + 1j * rng.standard_normal((d,) + (D,) * 4)
        return t / np.linalg.norm(t)

    return {"A": one(), "B": one(), "C": one(), "rotated": 0}


def numpy_product_messages(N: int, D: int, chi: int, seed: int) -> Dict[int, List[np.ndarray]]:
    """{side_int: [site arrays]}: the "random" message model (a product of
    vectorised |v⟩⟨v|, one random unit v per site, as
    ``ops/mps.random_message``) drawn with numpy from `seed`, its bonds
    zero-padded to the canonical profile."""
    rng = np.random.default_rng(seed)
    n = num_message_sites(N)
    bonds = [1] + message_bond_profile(N, D, chi) + [1]
    out = {}
    for side in BlockSide:
        sites = []
        for k in range(n):
            v = rng.standard_normal(D) + 1j * rng.standard_normal(D)
            v /= np.linalg.norm(v)
            site = np.zeros((bonds[k], D * D, bonds[k + 1]), complex)
            site[0, :, 0] = np.outer(v, v.conj()).reshape(-1)
            sites.append(site)
        out[int(side)] = sites
    return out


def chain_cells_from_numpy(cells: Sequence[Mapping], device=None,
                           dtype=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The (A, B, C) batch of ``parallel/multichip``: one [n_chains, d, D,
    D, D, D] tensor per flavour from one save dict per chain."""
    return tuple(torch.stack([_tensor(c[f], device, dtype) for c in cells]) for f in FLAVORS)


def message_batch_from_numpy(messages: Sequence[Mapping[int, Sequence[np.ndarray]]], device=None,
                             dtype=None) -> Dict[int, Tuple[torch.Tensor, ...]]:
    """{side_int: tuple of [n_chains, …] sites} from one {side_int: [site
    arrays]} per chain (equal shapes: the canonical padded profile)."""
    return {int(s): tuple(torch.stack([_tensor(m[s][k], device, dtype) for m in messages])
                          for k in range(len(messages[0][s])))
            for s in messages[0]}


def lambdas_from_numpy(lams: Mapping[Tuple[int, int], np.ndarray], device=None,
                       dtype=None) -> Dict[Tuple[int, int], torch.Tensor]:
    """A simple update's λ vectors by edge class (f1, f2)."""
    return {(int(k[0]), int(k[1])): _tensor(v, device, dtype) for k, v in lams.items()}


def arbitrary_tn_from_numpy(tensors: Sequence[np.ndarray], N: int, device=None,
                            dtype=None) -> ArbitraryKagomeTN:
    """An arbitrary block from its per-site ket arrays (the JAX package's
    ``ArbitraryKagomeTN.tensors``)."""
    return ArbitraryKagomeTN([_tensor(t, device, dtype) for t in tensors], N)


def square_cell_from_numpy(cell: Sequence[Sequence[np.ndarray]], device=None,
                           dtype=None) -> List[List[torch.Tensor]]:
    """A square-lattice cell: m×m kets [d, U, L, D, R]."""
    return [[_tensor(t, device, dtype) for t in row] for row in cell]


def square_messages_from_numpy(sites: Mapping[int, Sequence[np.ndarray]], device=None,
                               dtype=None) -> Dict[SquareSide, MPS]:
    """Square-lattice messages with zero logscale from {side_int: [site arrays]}."""
    return {SquareSide(int(s)): from_sites([_tensor(a, device, dtype) for a in ss])
            for s, ss in sites.items()}


def to_numpy(x):
    """Tensor → ndarray; UnitCell → the save dict; MPS → list of site
    arrays; a message dict → {side_int: [site arrays]}; λs → {(f1, f2):
    array}; an arbitrary block → its list of per-site arrays; a square cell
    (a list of rows) → a list of rows of arrays."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().resolve_conj().numpy()
    if isinstance(x, UnitCell):
        return {**{f: to_numpy(t) for f, t in x.items()}, "rotated": x.rotated}
    if isinstance(x, MPS):
        return [to_numpy(s) for s in x.sites]
    if isinstance(x, ArbitraryKagomeTN):
        return [to_numpy(t) for t in x.tensors]
    if isinstance(x, (list, tuple)):
        return [to_numpy(v) for v in x]
    if isinstance(x, Mapping):
        return {(tuple(int(i) for i in k) if isinstance(k, tuple) else int(k)): to_numpy(v)
                for k, v in x.items()}
    raise TypeError(f"to_numpy: unsupported {type(x)}")
