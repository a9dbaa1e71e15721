"""Measure a fixed unit cell on blocks of increasing size N: the enlarged
core-block measurements and N-convergence harness (counterpart of the JAX
package's scripts/increasing_block_measurements.py, with the same flags and
rows; ``--device`` added).

    python -m kagomeperiodicbp_tpu_torch.increasing_block_measurements -D 3 --cell su:q0
    python -m kagomeperiodicbp_tpu_torch.increasing_block_measurements --cell c.pkl --device cpu

Per N: robust BP at χ_msg = 2D², then the six edge RDMs at χ = 2D²+10. Each
row prints as one JSON line and is appended to the CSV (columns N, D,
mean_energy, bp_error, bp_iters; the header is written once, with a new
file). ``--cell`` takes random | zero | <path.pkl>, and every start of
``run_ite`` (q0, su:q0, tnsu:<path>, …) through its ``initial_cell``. It
runs on the card unless ``--device cpu`` is given, and raises without one.
"""
from __future__ import annotations

import argparse
import csv
import json
import logging
import os

import torch

from .algo.bp import BPConfig, robust_belief_propagation
from .algo.measurements import measure_energies_and_observables
from .measure import setup_device
from .networks.unit_cell import UnitCell
from .physics import hamiltonians
from .run_ite import initial_cell

COLUMNS = ["N", "D", "mean_energy", "bp_error", "bp_iters"]


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cell", default="random",
                   help="random | zero | <path.pkl> | a run_ite start (q0, su:q0, tnsu:<path>, …)")
    p.add_argument("-D", type=int, default=2)
    p.add_argument("--n-min", type=int, default=2)
    p.add_argument("--n-max", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dtype", default="complex128", choices=("complex64", "complex128"))
    p.add_argument("--csv", default="data/measurements/n_scaling.csv")
    p.add_argument("--device", default="cuda", help="cuda (default) | cpu")
    return p.parse_args(argv)


def start_cell(args, dtype: torch.dtype, device: torch.device) -> UnitCell:
    """The cell --cell names: random and zero as the JAX script makes them
    (torch's random numbers, not jax.random's), a pickled cell, or a
    run_ite start (d=2, run_ite's default noise, the AFM Hamiltonian)."""
    if args.cell == "random":
        gen = torch.Generator(device=device).manual_seed(args.seed)
        return UnitCell.random(2, args.D, gen, dtype, device)
    if args.cell == "zero":
        return UnitCell.zero_product_state(2, args.D, dtype, device)
    run_ite_args = argparse.Namespace(**vars(args), d=2, init_noise=0.02, hamiltonian="AFM")
    return initial_cell(run_ite_args, dtype, device, logging.getLogger("increasing_block")).astype(dtype)


def measure_rows(cell: UnitCell, D: int, n_min: int, n_max: int, dtype: torch.dtype,
                 csv_path: str | None = None):
    """One row per block size N in [n_min, n_max], printed and, with
    `csv_path`, appended to that CSV."""
    h = hamiltonians.heisenberg_afm()
    if csv_path and not os.path.exists(csv_path):
        os.makedirs(os.path.dirname(os.path.abspath(csv_path)), exist_ok=True)
        with open(csv_path, "w", newline="") as fh:
            csv.writer(fh).writerow(COLUMNS)
    rows = []
    for N in range(n_min, n_max + 1):
        bp_cfg = BPConfig(trunc_dim=2 * D ** 2, dtype=dtype)
        msgs, stats = robust_belief_propagation(cell, None, bp_cfg, N)
        meas = measure_energies_and_observables(cell, msgs, N, chi=2 * D ** 2 + 10,
                                                chi_msg=bp_cfg.trunc_dim, h=h)
        row = dict(N=N, D=D, mean_energy=meas.mean_energy, bp_error=stats.final_error,
                   bp_iters=stats.iterations)
        if csv_path:
            with open(csv_path, "a", newline="") as fh:
                csv.writer(fh).writerow([row[c] for c in COLUMNS])
        rows.append(row)
        print(json.dumps(row))
    return rows


def main(argv=None):
    args = parse_args(argv)
    device = setup_device(args.device)
    dtype = getattr(torch, args.dtype)
    return measure_rows(start_cell(args, dtype, device), args.D, args.n_min, args.n_max, dtype,
                        args.csv)


if __name__ == "__main__":
    main()
