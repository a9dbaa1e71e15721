"""Main user entry: ground-state search via BlockBP + ITE, on the card
(counterpart of the JAX package's scripts/run_ite.py, with the same flags;
``--device`` takes the place of ``--platform``).

    python -m kagomeperiodicbp_tpu_torch.run_ite -D 3 -N 2 --steps 2
    python -m kagomeperiodicbp_tpu_torch.run_ite -D 2 -N 2 --steps 2 --device cpu

It runs on the card unless ``--device cpu`` is given, and raises without one.
``--live-plots`` writes the convergence dashboards (three PNGs) under
``--out`` after every measured segment.
"""
from __future__ import annotations

import argparse
import logging
import os

import torch

from .algo.ite import ITEConfig, ITETracker, default_time_steps, full_ite
from .algo.simple_update import simple_update
from .config import Config
from .measure import setup_device
from .networks.unit_cell import UnitCell
from .physics import hamiltonians
from .utils.best_store import load_best
from .utils.foreign import tnsu_unit_cell
from .utils.progress import ProgressHierarchy

_DTYPES = {n: getattr(torch, n) for n in ("complex64", "complex128", "float32", "float64")}


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-D", type=int, default=2, help="virtual bond dimension")
    p.add_argument("-N", type=int, default=2, help="block linear size")
    p.add_argument("-d", type=int, default=2, help="physical dimension")
    p.add_argument("--hamiltonian", default="AFM", help="AFM | FM | AFM-T | Ising-AFM")
    p.add_argument("--chi-factor", type=float, default=1.0)
    p.add_argument("--dt-start", type=float, default=1e-2)
    p.add_argument("--dt-stop", type=float, default=1e-4)
    p.add_argument("--steps", type=int, default=None, help="total segments (overrides ladder)")
    p.add_argument("--steps-per-dt", type=int, default=20)
    p.add_argument("--cell", default="random",
                   help="random | product | zero | q0 | q0- | su[:q0|q0-|product] | tnsu[:path] | "
                        "best | pad:<D> | <path.pkl> "
                        "(q0/q0- = 120-degree q=0 product order, either chirality; "
                        "su = simple-update warm start, seeded random or from the named "
                        "state; tnsu = the published tnsu SU state for this D, or the "
                        "tnsu-format set at path; best = current best-store record for "
                        "this D; pad:<D> = the best record of a smaller D, zero-padded)")
    p.add_argument("--init-noise", type=float, default=0.02,
                   help="noise fraction added to structured inits (q0/zero) "
                        "so virtual bonds start full-rank")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--damping", type=float, default=None)
    p.add_argument("--bp-every-edge", action="store_true")
    p.add_argument("--noise", type=float, default=None)
    p.add_argument("--dtype", default="complex128", choices=list(_DTYPES))
    p.add_argument("--optimize-dtype", default=None, choices=list(_DTYPES),
                   help="mixed precision: run BP+ITE segments in this dtype, "
                        "measure in --dtype")
    p.add_argument("--device", default="cuda", help="cuda (default) | cpu")
    p.add_argument("--out", default="data/unit_cells", help="output folder")
    p.add_argument("--measure-n", type=int, default=None,
                   help="block size for measurements (default: N+1, reference convention)")
    p.add_argument("--measure-chi-factor", type=float, default=2.0)
    p.add_argument("--live-plots", action="store_true",
                   help="convergence dashboards, written under --out")
    p.add_argument("--field-start", type=float, default=1e-2,
                   help="AFM-T initial annealing field (reference: 1e-2)")
    p.add_argument("--fixed-edge-order", action="store_true",
                   help="deterministic edge order (reference production runs)")
    p.add_argument("--use-lowest-energy-state", action="store_true",
                   help="revert to the block-best cell at each delta_t "
                        "boundary (reference: always_use_lowest_energy_state)")
    p.add_argument("--mode-reps", type=int, default=None,
                   help="num_mode_repetitions_per_segment (default 5)")
    p.add_argument("--progress-bars", action="store_true",
                   help="hierarchical progress bars on stderr")
    p.add_argument("--measure-every", type=int, default=1,
                   help="measure every K segments (block ends always measured)")
    p.add_argument("--no-best-store", action="store_true",
                   help="do not write the best store")
    p.add_argument("--monitor", action="store_true",
                   help="sample CPU%%/RSS of this process to <out>/monitor.log")
    p.add_argument("--strengthen", type=int, default=0, metavar="K",
                   help="apply Config.strengthen K times before running "
                        "(restart-harder: chi and chi_bp x1.5 each)")
    return p.parse_args(argv)


def initial_cell(args, dtype: torch.dtype, device: torch.device, log) -> UnitCell | None:
    """The start cell that --cell names, on `device` (None: full_ite draws a
    random one from --seed)."""
    gen = torch.Generator(device=device).manual_seed(args.seed)
    if args.cell == "random":
        return None
    if args.cell == "product":
        return UnitCell.random_product_state(args.d, args.D, gen, dtype)
    if args.cell in ("zero", "q0", "q0-"):
        if args.cell == "zero":
            cell = UnitCell.zero_product_state(args.d, args.D, dtype, device)
        else:
            cell = UnitCell.product_state_120(args.d, args.D, +1 if args.cell == "q0" else -1,
                                              dtype, device)
        return cell.add_noise(args.init_noise, gen) if args.init_noise else cell
    if args.cell == "su" or args.cell.startswith("su:"):
        # `su` = random seed; `su:q0` / `su:q0-` / `su:product` seed the SU
        # from a structured state: a random-seeded SU on the kagome lattice
        # tends to freeze into a dimerised local minimum (the JAX package
        # measured −0.326 at D=3 against the published SU −0.41786), while
        # the 120° q=0 seed keeps it in the magnetically ordered basin
        seed_cell = None
        sub = args.cell.partition(":")[2]
        if sub in ("q0", "q0-"):
            seed_cell = UnitCell.product_state_120(args.d, args.D, +1 if sub == "q0" else -1,
                                                   dtype, device)
            seed_cell = seed_cell.add_noise(args.init_noise or 0.05, gen)
        elif sub == "product":
            seed_cell = UnitCell.random_product_state(args.d, args.D, gen, dtype)
        elif sub:
            raise SystemExit(f"unknown su seed '{sub}' (use q0 | q0- | product)")
        log.info("simple-update warm start (D=%d, seed=%s)…", args.D, sub or "random")
        cell, _ = simple_update(hamiltonians.BY_NAME[args.hamiltonian](), D=args.D, d=args.d,
                                dtype=dtype, cell=seed_cell, generator=gen, device=device)
        return cell
    if args.cell == "tnsu" or args.cell.startswith("tnsu:"):
        cell, foreign_e = tnsu_unit_cell(args.D, dtype=dtype, path=args.cell.partition(":")[2] or None,
                                         device=device)
        log.info("warm start from tnsu SU state (D=%d, foreign energy=%s)", args.D, foreign_e)
        return cell.add_noise(args.init_noise, gen) if args.init_noise else cell
    if args.cell == "best":
        rec = load_best(args.D)
        if rec is None:
            raise SystemExit(f"no best-store record for D={args.D}")
        log.info("warm start from best store: energy=%.10f", rec[1])
        return rec[0].astype(dtype).to_device(device)
    if args.cell.startswith("pad:"):
        d_src = int(args.cell.split(":", 1)[1])
        rec = load_best(d_src)
        if rec is None:
            raise SystemExit(f"no best-store record for D={d_src}")
        log.info("warm start: D=%d best (energy=%.10f) padded to D=%d", d_src, rec[1], args.D)
        return rec[0].astype(dtype).to_device(device).pad_to(args.D, generator=gen)
    return UnitCell.load(args.cell, device=device)


def _make_plots(args, ham):
    if not args.live_plots:
        return None
    from .visualizations import ITEPlots

    return ITEPlots(active=True, out_path=os.path.join(args.out, "ite_progress.png"),
                    reference_energy=getattr(ham, "reference", None))


def main(argv=None) -> float:
    args = parse_args(argv)
    device = setup_device(args.device)

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    log = logging.getLogger("run_ite")

    measure_dtype = None
    if args.optimize_dtype and args.optimize_dtype != args.dtype:
        # mixed precision: segments in the optimize dtype, measurements in --dtype
        measure_dtype = _DTYPES[args.dtype]
        dtype = _DTYPES[args.optimize_dtype]
    else:
        dtype = _DTYPES[args.dtype]

    steps = default_time_steps(args.dt_start, args.dt_stop, args.steps_per_dt)
    if args.steps is not None:
        steps = steps[: args.steps]

    ham = hamiltonians.BY_NAME[args.hamiltonian]
    # AFM-T = AFM + a decaying symmetry-breaking field, one value per segment
    ham_field = hamiltonians.DecreasingGlobalField(args.field_start) if args.hamiltonian == "AFM-T" else None

    cell = initial_cell(args, dtype, device, log)

    config = Config.derive_from_dimensions(args.D, args.chi_factor, damping=args.damping,
                                           dtype=dtype)
    for _ in range(args.strengthen):
        config = config.strengthen()
    ite_config = ITEConfig(
        hamiltonian=ham,
        hamiltonian_field=ham_field,
        time_steps=steps,
        bp_every_edge=args.bp_every_edge,
        add_gaussian_noise_fraction=args.noise,
        random_edge_order=not args.fixed_edge_order,
        always_use_lowest_energy_state=args.use_lowest_energy_state,
        seed=args.seed,
    )
    if args.mode_reps is not None:
        ite_config.num_mode_repetitions_per_segment = args.mode_reps

    os.makedirs(args.out, exist_ok=True)
    tracker = ITETracker(checkpoint_path=os.path.join(args.out, f"tracker_D{args.D}_N{args.N}.pkl"))

    monitor = None
    if args.monitor:
        from .utils.logs import ProcessMonitor

        monitor = ProcessMonitor(os.path.join(args.out, "monitor.log")).start()
    try:
        best, cell, tracker = full_ite(
            cell, ite_config, N=args.N, D=args.D, d=args.d, chi=config.chi,
            bp_config=config.bp, logger=log, tracker=tracker, dtype=dtype,
            measurement_N=args.measure_n or args.N + 1,
            measurement_chi_factor=args.measure_chi_factor,
            measure_dtype=measure_dtype,
            measure_every=args.measure_every,
            save_best_store=not args.no_best_store,
            progress=ProgressHierarchy(args.progress_bars),
            plots=_make_plots(args, ham),
            device=device,
        )
    finally:
        if monitor is not None:
            monitor.stop()
    out_path = os.path.join(args.out, f"D={args.D} energy={best}.pkl")
    cell.save(out_path)
    log.info("best energy/site = %.10f  (saved unit cell to %s)", best, out_path)
    if getattr(ham, "reference", None) is not None:
        log.info("reference energy  = %.10f", ham.reference)
    return best


if __name__ == "__main__":
    main()
