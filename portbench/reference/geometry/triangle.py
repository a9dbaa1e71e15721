# Copied from the JAX package, the repo's reference implementation: kagomeperiodicbp_tpu/lattices/triangle.py
# (the block's lattice geometry and its plans); the reference imports neither package.
"""Hexagonal block of the triangular lattice — index math.

A "size-N" block is a hexagon-shaped patch of the triangular lattice with
``3N² − 3N + 1`` vertices arranged in ``2N − 1`` rows of widths
``N, N+1, …, 2N−1, …, N+1, N`` (reference: src/lattices/triangle.py:31-73).

We use *true equilateral geometry* (nearest-neighbour distance 2, row
spacing √3) so that rows along any of the six directions can be derived
generically by projecting positions — the reference instead hand-codes the
row enumeration per direction (triangle.py:879).
"""
from __future__ import annotations

import functools
import math
from typing import Dict, List, Tuple

import numpy as np

from .directions import BlockSide, LatticeDir

SQRT3 = math.sqrt(3.0)


@functools.cache
def total_vertices(N: int) -> int:
    return 3 * N * N - 3 * N + 1


@functools.cache
def num_rows(N: int) -> int:
    return 2 * N - 1


def row_width(i: int, N: int) -> int:
    if i < 0 or i > 2 * N - 2:
        return 0
    return N + i if i < N else 3 * N - 2 - i


@functools.cache
def _row_starts(N: int) -> Tuple[int, ...]:
    starts = [0]
    for i in range(num_rows(N)):
        starts.append(starts[-1] + row_width(i, N))
    return tuple(starts)


def vertex_index(i: int, j: int, N: int) -> int:
    """Index of vertex at (row i, column j); rows top→bottom, cols left→right."""
    assert 0 <= j < row_width(i, N), f"({i},{j}) outside row"
    return _row_starts(N)[i] + j


@functools.cache
def vertex_coordinates(index: int, N: int) -> Tuple[int, int]:
    starts = _row_starts(N)
    for i in range(num_rows(N)):
        if index < starts[i + 1]:
            return i, index - starts[i]
    raise ValueError(f"index {index} outside lattice of size N={N}")


@functools.cache
def center_vertex_index(N: int) -> int:
    m = num_rows(N) // 2
    return vertex_index(m, row_width(m, N) // 2, N)


def vertex_position(i: int, j: int, N: int) -> Tuple[float, float]:
    """True equilateral position: row spacing √3 (downwards), each row centred."""
    w = row_width(i, N)
    x = 2.0 * j - (w - 1)
    y = -SQRT3 * i
    return (x, y)


def neighbor_coordinates(i: int, j: int, d: LatticeDir, N: int) -> Tuple[int, int]:
    """(row, col) of the neighbour of (i, j) in direction d; may be outside.

    Derivation: in the upper half the rows widen downward so a step UR keeps
    the column in the upper-row frame; in the lower half they narrow.
    (reference math: triangle.py:75-108)
    """
    m = num_rows(N) // 2  # index of the widest (middle) row
    if d == LatticeDir.L:
        return i, j - 1
    if d == LatticeDir.R:
        return i, j + 1
    if d == LatticeDir.UR:
        return (i - 1, j) if i <= m else (i - 1, j + 1)
    if d == LatticeDir.UL:
        return (i - 1, j - 1) if i <= m else (i - 1, j)
    if d == LatticeDir.DL:
        return (i + 1, j) if i < m else (i + 1, j - 1)
    if d == LatticeDir.DR:
        return (i + 1, j + 1) if i < m else (i + 1, j)
    raise ValueError(f"not a lattice direction: {d!r}")


def inside(i: int, j: int, N: int) -> bool:
    return 0 <= i < num_rows(N) and 0 <= j < row_width(i, N)


def neighbor_index(index: int, d: LatticeDir, N: int) -> int | None:
    i, j = vertex_coordinates(index, N)
    i2, j2 = neighbor_coordinates(i, j, d, N)
    if not inside(i2, j2, N):
        return None
    return vertex_index(i2, j2, N)


def all_neighbors(index: int, N: int) -> List[Tuple[int, LatticeDir]]:
    res = []
    for d in LatticeDir.all_ccw():
        n = neighbor_index(index, d, N)
        if n is not None:
            res.append((n, d))
    return res


def boundaries_of_vertex(index: int, N: int) -> List[BlockSide]:
    """Which hexagon faces (if any) the vertex lies on.
    (reference: triangle.py:112-137)"""
    i, j = vertex_coordinates(index, N)
    h, w, m = num_rows(N), row_width(i, N), num_rows(N) // 2
    on = []
    if i == 0:
        on.append(BlockSide.U)
    if i == h - 1:
        on.append(BlockSide.D)
    if j == 0:
        if i <= m:
            on.append(BlockSide.UL)
        if i >= m:
            on.append(BlockSide.DL)
    if j == w - 1:
        if i <= m:
            on.append(BlockSide.UR)
        if i >= m:
            on.append(BlockSide.DR)
    return on


@functools.cache
def all_positions(N: int) -> np.ndarray:
    """[n_vertices, 2] true positions."""
    pos = np.zeros((total_vertices(N), 2))
    for i in range(num_rows(N)):
        for j in range(row_width(i, N)):
            pos[vertex_index(i, j, N)] = vertex_position(i, j, N)
    return pos


def rows_in_direction(N: int, major: BlockSide) -> List[List[int]]:
    """Vertex indices grouped into rows orthogonal to `major`, ordered so the
    first row is the one *furthest opposite* to `major` (i.e. contraction
    toward `major` sweeps rows in order).  Within a row, vertices are sorted
    along `major.orthogonal_ccw()` — generic positional derivation replacing
    the reference's per-direction enumeration (triangle.py:879).
    """
    pos = all_positions(N)
    maj = np.array(major.unit)
    mino = np.array(major.orthogonal_ccw().unit)
    p_major = pos @ maj
    p_minor = pos @ mino
    # group by projection on major axis (rows are exactly √3/2-separated for
    # triangular; rounding to 6 decimals is safe)
    keys = np.round(p_major, 6)
    uniq = np.unique(keys)
    rows = []
    for k in uniq:  # ascending projection = from far side toward `major`
        members = np.where(keys == k)[0]
        members = members[np.argsort(p_minor[members])]
        rows.append([int(v) for v in members])
    return rows


@functools.cache
def _torus_coords(N: int) -> Dict[Tuple[int, int], int]:
    """Integer lattice coordinates (m1, m2) in the (a1=R, a2=DR) basis for
    every cluster vertex."""
    coords: Dict[Tuple[int, int], int] = {}
    for v in range(total_vertices(N)):
        i, j = vertex_coordinates(v, N)
        x, _ = vertex_position(i, j, N)
        m2 = i
        num = round(x) - m2
        # all vertices share the parity of (1 − N); shift to make it even
        num -= (1 - N) % 2
        assert num % 2 == 0
        coords[(num // 2, m2)] = v
    return coords


# unit steps of the 6 lattice directions in the (a1=R, a2=DR) basis
_DIR_STEPS = {
    LatticeDir.R: (1, 0),
    LatticeDir.L: (-1, 0),
    LatticeDir.DR: (0, 1),
    LatticeDir.UL: (0, -1),
    LatticeDir.DL: (-1, 1),
    LatticeDir.UR: (1, -1),
}


@functools.cache
def _superlattice(N: int) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """Translation vectors identifying opposite faces of the hexagonal
    cluster (torus quotient). det = 3N²−3N+1 = cluster size; validated by
    the wrap construction below."""
    return (N, N - 1), (-(N - 1), 2 * N - 1)


@functools.cache
def periodic_shift_permutation(N: int, d: LatticeDir) -> Tuple[int, ...]:
    """Permutation p with p[v] = vertex that v moves to under a one-step
    periodic shift in direction d — the hexagonal cluster viewed as a torus
    (reference: triangle.py:1020 `shift_periodically_in_direction`)."""
    coords = _torus_coords(N)
    inv = {v: c for c, v in coords.items()}
    l1, l2 = _superlattice(N)
    delta = _DIR_STEPS[d]
    nv = total_vertices(N)
    perm = [None] * nv
    for v in range(nv):
        c = inv[v]
        tgt = (c[0] + delta[0], c[1] + delta[1])
        hit = None
        for i in (-1, 0, 1):
            for j in (-1, 0, 1):
                cand = (tgt[0] - i * l1[0] - j * l2[0], tgt[1] - i * l1[1] - j * l2[1])
                if cand in coords:
                    assert hit is None, f"ambiguous wrap for v={v}"
                    hit = coords[cand]
        assert hit is not None, f"no wrap target for v={v}"
        perm[v] = hit
    assert sorted(perm) == list(range(nv)), "shift is not a permutation"
    return tuple(perm)  # type: ignore[arg-type]
