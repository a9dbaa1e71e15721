"""Measurement accuracy on the card: the same robust BP and RDM energy
measurement in complex64 on the card and in complex128 on the CPU, in one
process (counterpart of the JAX package's tools/chip_accuracy.py, whose two
platforms needed a subprocess each; the bar it names is agreement ≤ 1e-6 at
D=3).

    python -m kagomeperiodicbp_tpu_torch.chip_accuracy [D] [N]
    python -m kagomeperiodicbp_tpu_torch.chip_accuracy 2 2 --device cpu

The cell is the best-store record of D, or else a random cell drawn with
numpy from seed 0; BP at χ_msg = 2D², the RDMs at χ = 2D²+10. Prints one JSON
line with both energies and their difference. The complex64 run takes
``--device``, the card unless ``--device cpu`` is given; the complex128
reference always runs on the CPU.
"""
from __future__ import annotations

import argparse
import json

import torch

from .algo.bp import BPConfig, robust_belief_propagation
from .algo.measurements import measure_energies_and_observables
from .convert import numpy_random_cell, unit_cell_from_numpy
from .measure import setup_device
from .physics import hamiltonians
from .utils.best_store import DEFAULT_FOLDER, load_best

BAR = 1e-6


def measure_once(D: int, N: int, dtype: torch.dtype, device, folder: str = DEFAULT_FOLDER) -> dict:
    """Energy and BP error of the record of D (or the seeded random cell) in
    `dtype` on `device`."""
    device = setup_device(device)
    rec = load_best(D, folder)
    if rec is not None:
        cell = rec[0].to_device(device).astype(dtype)
    else:
        cell = unit_cell_from_numpy(numpy_random_cell(D, 0), device, dtype)
    bp = BPConfig(trunc_dim=2 * D * D, dtype=dtype)
    msgs, st = robust_belief_propagation(cell, None, bp, N)
    meas = measure_energies_and_observables(cell, msgs, N, 2 * D * D + 10, bp.trunc_dim,
                                            hamiltonians.heisenberg_afm())
    return {"device": str(device), "dtype": str(dtype).split(".")[-1], "energy": meas.mean_energy,
            "bp_error": st.final_error, "from_best_store": rec is not None}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("D", type=int, nargs="?", default=3)
    p.add_argument("N", type=int, nargs="?", default=2)
    p.add_argument("--device", default="cuda", help="cuda (default) | cpu: the complex64 run")
    p.add_argument("--store-dir", default=DEFAULT_FOLDER, help="the best-store folder")
    args = p.parse_args(argv)
    chip = measure_once(args.D, args.N, torch.complex64, args.device, args.store_dir)
    cpu = measure_once(args.D, args.N, torch.complex128, "cpu", args.store_dir)
    diff = abs(chip["energy"] - cpu["energy"])
    out = {"D": args.D, "N": args.N,
           "energy_cpu_f64": cpu["energy"], "energy_chip_c64": chip["energy"],
           "abs_diff": diff, "meets_1e-6": diff <= BAR,
           "chip_device": chip["device"], "from_best_store": chip["from_best_store"]}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
