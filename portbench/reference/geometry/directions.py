# Copied from the JAX package, the repo's reference implementation: kagomeperiodicbp_tpu/lattices/directions.py
# (the block's lattice geometry and its plans); the reference imports neither package.
"""Direction algebra for the Kagome block.

Two families of directions, both integer-coded and cheap to hash/compare
(unlike the reference's float-angle classes, cf. src/lattices/directions.py:47):

* ``LatticeDir`` — the 6 nearest-neighbour directions of the triangular /
  Kagome lattice, at angles ``k * 60°``.
* ``BlockSide`` — the 6 faces of the hexagonal block, at angles ``30° + k * 60°``.

All relations (opposite, orthogonal, matching lattice dirs of a block side)
are *derived from the angles* instead of being hand-tabulated
(reference tables: directions.py:239-272).
"""
from __future__ import annotations

import math
from enum import IntEnum
from typing import List

_DEG60 = math.pi / 3.0


class LatticeDir(IntEnum):
    """Lattice directions; value k ↔ angle k·60°."""

    R = 0
    UR = 1
    UL = 2
    L = 3
    DL = 4
    DR = 5

    @property
    def angle(self) -> float:
        return (int(self) * _DEG60) % (2 * math.pi)

    @property
    def unit(self) -> tuple[float, float]:
        return (math.cos(self.angle), math.sin(self.angle))

    def opposite(self) -> "LatticeDir":
        return LatticeDir((int(self) + 3) % 6)

    def rotate_ccw(self, steps: int = 1) -> "LatticeDir":
        """Rotate by steps·60° counterclockwise."""
        return LatticeDir((int(self) + steps) % 6)

    @staticmethod
    def from_angle(angle: float) -> "LatticeDir":
        k = round((angle % (2 * math.pi)) / _DEG60) % 6
        if abs((angle % (2 * math.pi)) - k * _DEG60) > 1e-6 and abs(
            (angle % (2 * math.pi)) - ((k * _DEG60) % (2 * math.pi))
        ) > 1e-6:
            raise ValueError(f"angle {angle} is not a lattice direction")
        return LatticeDir(k)

    @staticmethod
    def all_ccw() -> List["LatticeDir"]:
        return [LatticeDir(k) for k in range(6)]


class BlockSide(IntEnum):
    """Hexagon-block faces; value k ↔ angle 30° + k·60°."""

    UR = 0
    U = 1
    UL = 2
    DL = 3
    D = 4
    DR = 5

    @property
    def angle(self) -> float:
        return (math.pi / 6.0 + int(self) * _DEG60) % (2 * math.pi)

    @property
    def unit(self) -> tuple[float, float]:
        return (math.cos(self.angle), math.sin(self.angle))

    def opposite(self) -> "BlockSide":
        return BlockSide((int(self) + 3) % 6)

    def rotate_ccw(self, steps: int = 1) -> "BlockSide":
        return BlockSide((int(self) + steps) % 6)

    def matching_lattice_dirs(self) -> tuple[LatticeDir, LatticeDir]:
        """The two lattice directions that stick out of this block face,
        ordered counterclockwise (angle-30°, angle+30°).

        (reference: MATCHING_LATTICE_DIRECTIONS_TO_BLOCK_SIDES, directions.py:265)
        """
        a = self.angle
        return (
            LatticeDir.from_angle(a - _DEG60 / 2.0),
            LatticeDir.from_angle(a + _DEG60 / 2.0),
        )

    def orthogonal_ccw(self) -> LatticeDir:
        """Lattice direction at +90° — the direction in which boundary
        nodes of this side are sorted (counterclockwise hexagon traversal).

        (reference: ORTHOGONAL_LATTICE_DIRECTIONS_TO_BLOCK_SIDES, directions.py:256)
        """
        return LatticeDir.from_angle(self.angle + math.pi / 2.0)

    def orthogonal_cw(self) -> LatticeDir:
        return self.orthogonal_ccw().opposite()

    @staticmethod
    def all_ccw() -> List["BlockSide"]:
        # counterclockwise starting from D, to match the canonical env order
        # used by CoreTN assembly (reference kagome_to_core.py:265).
        return [BlockSide.D, BlockSide.DR, BlockSide.UR, BlockSide.U, BlockSide.UL, BlockSide.DL]


def signed_angle(from_vec: tuple[float, float], to_vec: tuple[float, float]) -> float:
    """Signed angle of `to_vec` relative to `from_vec`, in (-pi, pi]."""
    cross = from_vec[0] * to_vec[1] - from_vec[1] * to_vec[0]
    dot = from_vec[0] * to_vec[0] + from_vec[1] * to_vec[1]
    return math.atan2(cross, dot)
