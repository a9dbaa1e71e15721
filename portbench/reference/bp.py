"""The reference for a BP sweep: each side's outgoing message, from the
cell's kets and the incoming messages, by the reference's executor.

At N=2 a message has three sites of D² and its bonds (D²) are never cut, so
it is compared as a dense tensor: no gauge of the program's can enter.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Sequence

import torch

from .contract import dense, fuse
from .executor import Recipe, run_plan
from .geometry.compiler import compile_plan
from .geometry.directions import BlockSide
from .geometry.graph import full_graph
from .numerics import Precision


@functools.lru_cache(maxsize=None)
def message_plan(N: int, D: int, chi: int, chi_msg: int, toward: int):
    """The plan of the message out of side `toward`; single-layer from D=6,
    as BP picks its sweep (algo/bp.bp_mode)."""
    sides = tuple(s for s in BlockSide if int(s) != toward)
    plan = compile_plan(full_graph(N, D, chi_msg, sides), BlockSide(toward), chi)
    return dataclasses.replace(plan, single_layer=D >= 6)


def outgoing(kets: Sequence[torch.Tensor], msg_sites: Dict[int, Sequence[torch.Tensor]],
             N: int, chi: int, chi_msg: int, toward: int, prec: Precision,
             recipe: Recipe) -> torch.Tensor:
    """The message out of side `toward`, dense over its 2N−1 legs in the
    side's boundary order (counterclockwise), unit norm."""
    D = kets[0].shape[1]
    kets = [prec.take(k) for k in kets]
    plan = message_plan(N, D, chi, chi_msg, toward)
    fused = None if plan.single_layer else [prec.rnd(fuse(k)) for k in kets]

    def fetch(source):
        if source[0] == "lat":
            return fused[source[1] % 3]
        if source[0] == "ket":
            return kets[source[1] % 3]
        _, side, k = source
        return prec.take(msg_sites[side][k])

    out = dense(run_plan(plan, fetch, prec, recipe))
    return out / torch.linalg.vector_norm(out)


def sweep(kets, msg_sites, N: int, chi: int, chi_msg: int, prec: Precision,
          recipe: Recipe) -> Dict[int, torch.Tensor]:
    """The incoming messages after one synchronous sweep, dense: the message
    out of side S wraps to side S.opposite() with its site order reversed."""
    new = {}
    for side in BlockSide:
        out = outgoing(kets, msg_sites, N, chi, chi_msg, int(side), prec, recipe)
        new[int(side.opposite())] = out.permute(tuple(range(out.ndim - 1, -1, -1)))
    return new
