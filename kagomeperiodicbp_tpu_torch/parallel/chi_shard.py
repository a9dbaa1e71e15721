"""χ-sharded boundary-MPS contraction: ONE contraction spread over the ranks
of a group (counterpart of kagomeperiodicbp_tpu/parallel/chi_shard.py).

The reference's dead MPI block-BP (src/libs/_blockbp/
functions.py:609-747) documents the intent of spreading a single BlockBP
environment computation over workers. The JAX package lays the frontier's
bond χ over a mesh axis and lets GSPMD partition the swallows. Here the
executor's row-partition hook (``ops/contract.row_partition``) does it by
hand: each rank builds only its chunk of a large swallow blob's rows (the
χ²·D⁴-scale tensordots that dominate flops and memory at large D and χ),
and the chunks are gathered. The windowed QR/SVD truncations, the χ³ tail,
stay replicated, as the JAX package gathers them.

Same plan and same maths as the unsharded executor: results agree to
round-off (``tests/test_torch_parallel.py``, ``multichip.dryrun_multichip``).
``ops/contract.partition_counts`` counts, per rank, the swallows it
partitioned and the rows it built.
"""
from __future__ import annotations

import functools
import time
from typing import Optional, Tuple

from ..algo import contraction as C
from ..lattices import BlockSide
from ..ops import contract as X
from ..ops import mps as mpslib
from ..ops.mps import MPS
from . import launch

DIMS = ("chi",)


def chi_mesh(n_devices: Optional[int] = None):
    """A 1-D mesh ("chi",) over the group's ranks (`n_devices` must be the
    group's size); the plain shape (1,) outside a group."""
    import torch.distributed as dist

    n = n_devices or (dist.get_world_size() if dist.is_initialized() else 1)
    return launch.mesh((n,), DIMS)


def outgoing_message_sharded(cell_or_fused, messages: C.MessageDict, N: int, D: int, chi: int,
                             chi_msg: int, toward: BlockSide, mesh, single: bool = False) -> MPS:
    """``algo/contraction.outgoing_message`` with its swallow blobs' rows
    split over `mesh`'s chi axis. `cell_or_fused` is a unit cell or its
    fused tensors; with `single` a unit cell whose plan runs single-layer
    (``outgoing_message_single``)."""
    plan = C.to_message_plan(N, D, chi, chi_msg, int(toward))
    msg_sites = {int(s): tuple(m.sites) for s, m in messages.items() if int(s) != int(toward)}
    if single:
        plan = C.single_layer_plan(plan)
        cell = cell_or_fused
        fetch = C._make_fetch(None, msg_sites, kets=(cell.A, cell.B, cell.C))
    else:
        fused = cell_or_fused if isinstance(cell_or_fused, tuple) else C.fused_cells(cell_or_fused)
        fetch = C._make_fetch(fused, msg_sites)
    group, size, rank = launch.axis(mesh, "chi", DIMS)
    if size > 1:
        with X.row_partition(functools.partial(launch.all_gather, group=group), rank, size):
            raw = X.execute_plan(plan, fetch)
    else:
        raw = X.execute_plan(plan, fetch)
    extra = sum(m.logscale for s, m in messages.items() if int(s) != int(toward))
    return C.message_postprocess(MPS(raw.sites, raw.logscale + extra), plan, N, D, chi_msg)


def bp_sweep_sharded(cell_or_fused, messages: C.MessageDict, N: int, D: int, chi: int,
                     chi_msg: int, mesh) -> Tuple[C.MessageDict, float]:
    """One synchronous BP sweep with every outgoing-message contraction
    χ-sharded over the mesh: (new messages, mean message distance).
    (reference: belief_propagation.py:164 ``_belief_propagation_step``)"""
    new: C.MessageDict = {}
    for toward in BlockSide:
        out = outgoing_message_sharded(cell_or_fused, messages, N, D, chi, chi_msg, toward, mesh)
        # the periodic wrap: as the opposite side's incoming message the
        # outgoing MPS is traversed the other way
        new[toward.opposite()] = out.reverse()
    err = sum(float(mpslib.distance(new[s], messages[s])) for s in BlockSide) / len(BlockSide)
    return new, err


# ---------------- rank functions (run under launch.run_group) ---------------


def outgoing_message_task(cell, messages: C.MessageDict, N: int, D: int, chi: int, chi_msg: int,
                          toward: int, single: bool = False, reps: int = 1) -> dict:
    """One χ-sharded outgoing message over all the group's ranks, `reps`
    times: {"out": the message, "seconds": per call, "ranks":
    ``multichip.rank_report``} (each rank's partitioned swallows and rows)."""
    from .multichip import _reset_counts, _timed, rank_report

    cell, messages = launch.moved((cell, messages), launch.device())
    mesh = chi_mesh()
    _reset_counts()
    out, times = _timed(lambda: outgoing_message_sharded(
        cell, messages, N, D, chi, chi_msg, BlockSide(toward), mesh, single=single), reps)
    return {"out": out, "seconds": times, "ranks": rank_report()}


def bp_sweep_task(cell, messages: C.MessageDict, N: int, D: int, chi: int, chi_msg: int) -> dict:
    """``bp_sweep_sharded`` over all the group's ranks: {"out": (new
    messages, distance), "ranks": ``multichip.rank_report``}."""
    from .multichip import _reset_counts, rank_report

    cell, messages = launch.moved((cell, messages), launch.device())
    _reset_counts()
    t0 = time.perf_counter()
    out = bp_sweep_sharded(cell, messages, N, D, chi, chi_msg, chi_mesh())
    return {"out": out, "seconds": [time.perf_counter() - t0], "ranks": rank_report()}
