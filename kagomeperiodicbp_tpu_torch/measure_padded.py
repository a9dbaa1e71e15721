"""A bond-dimension-annealed record measurement: the best-store cell of a
smaller D, zero-padded (plus noise) to the target D and measured at the
production convention (block N+1, χ×2, fresh robust BP), the convention
``full_ite`` records, so the result is a valid best-store entry
(counterpart of the JAX package's scripts/measure_padded.py, with its flags
and JSON keys; ``--store-dir`` and ``--device`` added).

    python -m kagomeperiodicbp_tpu_torch.measure_padded -D 5 --src 4 --no-store
    python -m kagomeperiodicbp_tpu_torch.measure_padded -D 3 --noise 0 --device cpu --no-store

The pad is exact, so with ``--noise 0`` the energy is the source record's up
to the measurement's truncation. The pad's noise is drawn from a
``torch.Generator`` seeded with ``--seed`` on the device. ``--bp-dtype
complex64`` runs the fixed-point search in complex64 and then a complex128
polish of 12 iterations from its messages before the complex128 measurement.
Unless ``--no-store``, a better energy replaces the target D's record in
``--store-dir``. It runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import time

import torch

from .algo.bp import BPConfig, robust_belief_propagation
from .algo.measurements import measure_energies_and_observables
from .measure import setup_device
from .ops.mps import MPS
from .physics import hamiltonians
from .utils.best_store import DEFAULT_FOLDER, load_best, save_if_best

POLISH_ITERATIONS = 12


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-D", type=int, required=True, help="target bond dimension")
    p.add_argument("--src", type=int, default=None, help="source D (default D-1)")
    p.add_argument("-N", type=int, default=2, help="base block (measures at N+1)")
    p.add_argument("--noise", type=float, default=0.03,
                   help="pad noise fraction (full-rank bonds)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--chi-factor", type=float, default=2.0)
    p.add_argument("--no-store", action="store_true")
    p.add_argument("--store-dir", default=DEFAULT_FOLDER, help="the best-store folder")
    p.add_argument("--bp-dtype", default="complex128", choices=["complex64", "complex128"],
                   help="run the BP fixed-point search in this dtype; complex64 is followed "
                        "by a short complex128 polish before the complex128 measurement")
    p.add_argument("--device", default="cuda", help="cuda (default) | cpu")
    return p.parse_args(argv)


def _to_c128(msgs):
    return {k: MPS(tuple(s.to(torch.complex128) for s in m.sites), m.logscale.to(torch.float64))
            for k, m in msgs.items()}


def main(argv=None) -> dict:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    device = setup_device(args.device)
    t0 = time.perf_counter()
    c128 = torch.complex128
    src = args.src or args.D - 1
    rec = load_best(src, args.store_dir)
    if rec is None:
        raise SystemExit(f"no best-store record for D={src} in {args.store_dir}")
    gen = torch.Generator(device=device).manual_seed(args.seed)
    cell = rec[0].to_device(device).astype(c128).pad_to(args.D, noise_fraction=args.noise,
                                                        generator=gen)

    D = args.D
    chi = 2 * D * D + 10
    n_m = args.N + 1
    bp_m = BPConfig(trunc_dim=2 * D * D, dtype=c128).for_measurements(args.chi_factor)
    chi_m = int(chi * args.chi_factor)
    h = hamiltonians.BY_NAME["AFM"]()

    cell = cell.force_zero_rotation()
    if args.bp_dtype == "complex64":
        # the bulk of the fixed-point search in c64, then a short c128 polish
        # from its messages (a warm start: few iterations)
        bp_lo = dataclasses.replace(bp_m, dtype=torch.complex64)
        msgs, stats = robust_belief_propagation(cell.astype(torch.complex64), None, bp_lo, n_m)
        bp_polish = dataclasses.replace(bp_m, max_iterations=POLISH_ITERATIONS)
        msgs, stats = robust_belief_propagation(cell, _to_c128(msgs), bp_polish, n_m)
    else:
        msgs, stats = robust_belief_propagation(cell, None, bp_m, n_m)
    meas = measure_energies_and_observables(cell, msgs, n_m, chi_m, bp_m.trunc_dim, h)
    out = {
        "D": D, "src_D": src, "src_energy": rec[1],
        "N": n_m, "chi": chi_m, "chi_bp": bp_m.trunc_dim,
        "mean_energy": meas.mean_energy,
        "bp_error": stats.final_error,
        "edge_energies": {k: float(v) for k, v in meas.energies.items()},
        "bp_mode": stats.mode, "bp_dtype": args.bp_dtype,
        "seconds": time.perf_counter() - t0,
    }
    print(json.dumps(out), flush=True)
    if not args.no_store:
        save_if_best(cell.to_device("cpu"), meas.mean_energy, D, args.store_dir)
    return out


if __name__ == "__main__":
    main()
