"""Global best-unit-cell store, one record per bond dimension D.

(reference: src/unit_cell/definition.py:302-409
`BestUnitCellData` with energy-encoded filenames ``D={D} energy={E}.dat``)
"""
from __future__ import annotations

import glob
import os
import re
from typing import Optional, Tuple

from ..networks.unit_cell import UnitCell

DEFAULT_FOLDER = "data/unit_cells/best"
_PATTERN = re.compile(r"D=(\d+) energy=(-?[\d.eE+-]+)\.pkl$")


def _paths(folder: str, D: int):
    return glob.glob(os.path.join(folder, f"D={D} energy=*.pkl"))


def load_best(D: int, folder: str = DEFAULT_FOLDER) -> Optional[Tuple[UnitCell, float]]:
    """Lowest-energy stored cell for this D, or None."""
    best = None
    for path in _paths(folder, D):
        m = _PATTERN.search(os.path.basename(path))
        if not m:
            continue
        e = float(m.group(2))
        if best is None or e < best[1]:
            best = (path, e)
    if best is None:
        return None
    return UnitCell.load(best[0]), best[1]


def save_if_best(cell: UnitCell, energy: float, D: int, folder: str = DEFAULT_FOLDER) -> bool:
    """Store the cell iff it beats the current record (replacing it — one
    record per D, like the reference's BestUnitCellData). Returns True if
    saved."""
    cur = load_best(D, folder)
    if cur is not None and cur[1] <= energy:
        return False
    os.makedirs(folder, exist_ok=True)
    old = _paths(folder, D)
    cell.save(os.path.join(folder, f"D={D} energy={energy}.pkl"))
    for path in old:
        try:
            os.remove(path)
        except OSError:
            pass
    return True
