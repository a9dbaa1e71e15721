"""Small enums shared across the package.
(reference: src/enums/ — ContractionDepth, UpdateMode,
UnitCellFlavor, MessageModel)"""
from __future__ import annotations

import itertools
import random as _random
from enum import Enum, IntEnum
from typing import List, NamedTuple

from .lattices import LatticeDir


class UnitCellFlavor(IntEnum):
    A = 0  # 'up' node of the upper triangle
    B = 1  # 'left'
    C = 2  # 'right'


class UpdateMode(IntEnum):
    """Which unit-cell flavor is the 'center' of the current update pass
    (reference: enums/imaginary_time_evolution.py:8)."""

    A = 0
    B = 1
    C = 2

    @staticmethod
    def random(rng: _random.Random | None = None) -> "UpdateMode":
        r = rng or _random
        return UpdateMode(r.randrange(3))


_NEXT_ABC = {UnitCellFlavor.A: UnitCellFlavor.B, UnitCellFlavor.B: UnitCellFlavor.C,
             UnitCellFlavor.C: UnitCellFlavor.A}

# first→second lattice direction per ordered flavor pair
# (reference: containers/imaginary_time_evolution.py:106-119)
_EDGE_DIRECTION = {
    (UnitCellFlavor.A, UnitCellFlavor.B): LatticeDir.DL,
    (UnitCellFlavor.A, UnitCellFlavor.C): LatticeDir.UL,
    (UnitCellFlavor.B, UnitCellFlavor.A): LatticeDir.DL,
    (UnitCellFlavor.B, UnitCellFlavor.C): LatticeDir.R,
    (UnitCellFlavor.C, UnitCellFlavor.A): LatticeDir.UL,
    (UnitCellFlavor.C, UnitCellFlavor.B): LatticeDir.R,
}


class UpdateEdge(NamedTuple):
    """Ordered pair of unit-cell flavors naming one of the 6 physical edge
    classes of the Kagome lattice (3 in-triangle + 3 between-triangle).
    (reference: containers/imaginary_time_evolution.py:95)"""

    first: UnitCellFlavor
    second: UnitCellFlavor

    def is_in_core(self) -> bool:
        return _NEXT_ABC[self.first] is self.second

    def direction(self) -> LatticeDir:
        return _EDGE_DIRECTION[(self.first, self.second)]

    def __str__(self) -> str:
        return f"({self.first.name},{self.second.name})"

    @staticmethod
    def all_options() -> List["UpdateEdge"]:
        return [
            UpdateEdge(UnitCellFlavor(a), UnitCellFlavor(b))
            for a, b in itertools.permutations(range(3), 2)
        ]

    @staticmethod
    def all_in_random_order(num_edges: int = 6, rng: _random.Random | None = None) -> List["UpdateEdge"]:
        r = rng or _random
        opts = UpdateEdge.all_options()
        r.shuffle(opts)
        while len(opts) < num_edges:
            opts = opts + opts
        return opts[:num_edges]


class MessageModel(str, Enum):
    """The 4 initial-message models (reference: enums/tensor_networks.py
    MessageModel {UQ, RQ, UC, RC}; the classical two raise NotImplemented in
    the reference, here all four are supported by ops/mps.py)."""

    UNIFORM_QUANTUM = "uniform"
    RANDOM_QUANTUM = "random"
    UNIFORM_CLASSIC = "uniform-classic"
    RANDOM_CLASSIC = "random-classic"
