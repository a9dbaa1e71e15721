"""Recover the best unit cell and the energy history from a saved ITE
tracker checkpoint (counterpart of the JAX package's
scripts/unpack_ite_tracker.py, with its flags and printed lines).

    python -m kagomeperiodicbp_tpu_torch.unpack_ite_tracker <tracker.pkl> [--out cell.pkl]

It reads a checkpoint this port's ``ITETracker.save`` wrote
(``algo/ite.ITETracker.load``) or one the JAX package's wrote
(``convert.tracker_from_jax_checkpoint``), both through a restricted
unpickler that builds numpy arrays and the trackers' own record classes and
refuses every other global. ``--out`` saves the best cell with
``UnitCell.save``, a file either package's ``UnitCell.load`` reads. It does
no tensor arithmetic, so it takes no ``--device`` (the cell stays on the CPU).
"""
from __future__ import annotations

import argparse
import pickle

from .algo.ite import ITETracker
from .convert import tracker_from_jax_checkpoint


def load_tracker(path: str) -> ITETracker:
    """A port checkpoint, or else a JAX package one (whose record classes
    the port's table refuses)."""
    try:
        return ITETracker.load(path)
    except pickle.UnpicklingError:
        return tracker_from_jax_checkpoint(path)


def main(argv=None) -> ITETracker:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("tracker", help="path to tracker .pkl")
    p.add_argument("--out", default=None, help="where to save the recovered unit cell")
    args = p.parse_args(argv)

    tracker = load_tracker(args.tracker)
    print(f"segments: {len(tracker.energies)}")
    print(f"best energy/site: {tracker.best_energy}")
    if tracker.energies:
        print(f"last 5 energies: {tracker.energies[-5:]}")
    if args.out and tracker.best_cell is not None:
        tracker.best_cell.save(args.out)
        print(f"unit cell saved to {args.out}")
    return tracker


if __name__ == "__main__":
    main()
