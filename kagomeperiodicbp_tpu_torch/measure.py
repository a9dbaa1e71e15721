"""The measurement entry point: the energy of a saved unit cell, by the
production convention of the JAX package (tools/make_measurement_pin.py):
zero-rotation cell, fresh robust BP with ``BPConfig(2D²).for_measurements(2)``
on an (N+1)-block, then the six edge RDMs at contraction χ = 2·(2D²+10).

    python -m kagomeperiodicbp_tpu_torch.measure tests/assets/pin_D3.pkl [--device cpu]

It runs on the card unless the CPU is asked for.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch

from .algo.bp import BPConfig, robust_belief_propagation
from .algo.measurements import measure_energies_and_observables
from .networks.unit_cell import UnitCell
from .physics import hamiltonians


def setup_device(device) -> torch.device:
    """The port's device setup: on a GPU, float32 matrix products must stay
    full float32 (no TF32), since the complex128 pin is held to 1e-9 and the
    complex64 runs to float32 tolerances. Asking for a card where there is
    none raises: the port never falls back to the CPU on its own."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the measurement runs on the card by default; "
                               "pass device='cpu' (--device cpu) to run it on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device


def production_measurement(cell_path: str, N: int = 2, device="cuda",
                           dtype: torch.dtype = torch.complex128) -> dict:
    device = setup_device(device)
    t0 = time.perf_counter()
    cell = UnitCell.load(cell_path, device=device).astype(dtype).force_zero_rotation()
    D = cell.D
    chi = 2 * D * D + 10
    n_m = N + 1
    bp_m = BPConfig(trunc_dim=2 * D * D, dtype=dtype).for_measurements(2.0)
    chi_m = chi * 2
    h = hamiltonians.BY_NAME["AFM"]()

    msgs, stats = robust_belief_propagation(cell, None, bp_m, n_m)
    meas = measure_energies_and_observables(cell, msgs, n_m, chi_m, bp_m.trunc_dim, h)
    return {
        "cell": os.path.basename(cell_path),
        "D": D,
        "N": n_m,
        "chi": chi_m,
        "chi_bp": bp_m.trunc_dim,
        "mean_energy": meas.mean_energy,
        "edge_energies": {k: float(v) for k, v in meas.energies.items()},
        "bp_iterations": stats.iterations,
        "bp_attempts": stats.attempts,
        "bp_error": stats.final_error,
        "bp_mode": stats.mode,
        "seconds": time.perf_counter() - t0,
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("cell")
    ap.add_argument("--N", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="complex128", choices=("complex64", "complex128"))
    args = ap.parse_args()
    print(json.dumps(production_measurement(args.cell, args.N, args.device,
                                            getattr(torch, args.dtype))))


if __name__ == "__main__":
    main()
