"""Square-lattice ground-state search: simple-update ITE + BlockBP
measurement, on the card (counterpart of the JAX package's
scripts/run_square.py, with the same flags; ``--device`` takes the place of
``--platform``, and ``--dtype`` picks the working precision).

    python -m kagomeperiodicbp_tpu_torch.run_square -D 4 -m 2 -n 4
    python -m kagomeperiodicbp_tpu_torch.run_square -D 2 --device cpu

It runs on the card unless ``--device cpu`` is given, and raises without one.
The message χ is 2D²·chi_factor and the contraction's χ ten more, as in the
JAX script.
"""
from __future__ import annotations

import argparse
import logging
import time

import torch

from .measure import setup_device
from .physics import hamiltonians
from .square import algo as S

_DTYPES = {n: getattr(torch, n) for n in ("complex64", "complex128")}


def _ladder(start: float, stop: float):
    dts, dt = [], start
    while dt >= stop * 0.999:
        dts.append(dt)
        dt /= 2
    return dts


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-D", type=int, default=2, help="virtual bond dimension")
    p.add_argument("-m", type=int, default=2, help="unit-cell linear size")
    p.add_argument("-n", type=int, default=4, help="measurement block size")
    p.add_argument("--hamiltonian", default="AFM", help="AFM | FM")
    p.add_argument("--dt-start", type=float, default=0.1)
    p.add_argument("--dt-stop", type=float, default=0.001)
    p.add_argument("--sweeps-per-dt", type=int, default=60)
    p.add_argument("--staggered-field", type=float, default=0.4)
    p.add_argument("--chi-factor", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (default) | cpu")
    p.add_argument("--dtype", default="complex128", choices=list(_DTYPES))
    p.add_argument("--full-update", action="store_true",
                   help="polish the SU state with the BP-environment full "
                        "update (square/fullupdate.py; reference "
                        "squareITE.py:2091 environment mode)")
    p.add_argument("--fu-sweeps", type=int, default=6)
    p.add_argument("--fu-dt-start", type=float, default=0.05)
    p.add_argument("--fu-dt-stop", type=float, default=0.002)
    return p.parse_args(argv)


def main(argv=None) -> float:
    """Runs the search and returns the energy per site (after the full
    update where asked)."""
    args = parse_args(argv)
    device = setup_device(args.device)
    dtype = _DTYPES[args.dtype]
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    log = logging.getLogger("run_square")

    h = hamiltonians.BY_NAME[args.hamiltonian]()
    dts = _ladder(args.dt_start, args.dt_stop)
    log.info("SU ladder: %s", [f"{d:.4f}" for d in dts])

    t0 = time.perf_counter()
    cell, _ = S.simple_update(
        h, D=args.D, m=args.m, dts=tuple(dts), sweeps_per_dt=args.sweeps_per_dt,
        generator=torch.Generator().manual_seed(args.seed), dtype=dtype,
        staggered_field=args.staggered_field, device=device)
    log.info("SU: %d sweeps in %.2f s", len(dts) * args.sweeps_per_dt, time.perf_counter() - t0)
    chi_msg = int(2 * args.D**2 * args.chi_factor)
    chi = chi_msg + 10
    t0 = time.perf_counter()
    msgs, err = S.belief_propagation(cell, args.n, args.D, chi_msg=chi_msg,
                                     chi=chi, max_iterations=60, dtype=dtype)
    log.info("BP: mean message distance %.3e, %.2f s", err, time.perf_counter() - t0)
    t0 = time.perf_counter()
    e = S.measure_energy(cell, args.n, args.D, msgs, chi, chi_msg, h)
    log.info("energy/site = %.8f  (square AFM refs: Néel −0.5, "
             "SU D=2 ≈ −0.60, exact ≈ −0.6694); %.2f s", e, time.perf_counter() - t0)

    if args.full_update:
        from .square import fullupdate as FU

        dts = _ladder(args.fu_dt_start, args.fu_dt_stop)
        log.info("FU ladder: %s × %d sweeps", [f"{d:.4f}" for d in dts], args.fu_sweeps)
        cell, e_fu, _ = FU.full_update(
            cell, h, n=args.n, dts=tuple(dts), sweeps_per_dt=args.fu_sweeps,
            chi=chi, chi_msg=chi_msg, logger=log)
        log.info("full-update energy/site = %.8f (SU was %.8f, exact −0.6694)", e_fu, e)
        return e_fu
    return e


if __name__ == "__main__":
    main()
