"""Parameter-sweep entry point, the HTCondor-sender replacement
(counterpart of the JAX package's scripts/run_sweep.py, with the same flags;
``--device`` takes the place of ``--platform``, and ``--workers`` runs the
points in that many worker processes).

    python -m kagomeperiodicbp_tpu_torch.run_sweep --Ds 2 3 --seeds 0 1 2 --method ite --steps 30
    python -m kagomeperiodicbp_tpu_torch.run_sweep --Ds 2 3 --method bp --workers 4
    python -m kagomeperiodicbp_tpu_torch.run_sweep --Ds 2 --chain su,ite,measure --device cpu

It runs on the card unless ``--device cpu`` is given, and raises without
one; with ``--workers`` above the number of cards the workers share them.
(reference: scripts/condor/main_sender.py:57)
"""
from __future__ import annotations

import argparse
import dataclasses
import functools

from .parallel.sweep import (bp_worker, chain, dag_stage_worker, grid, ite_worker,
                             run_dag, run_sweep)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--Ds", type=int, nargs="+", default=[2])
    p.add_argument("--Ns", type=int, nargs="+", default=[2])
    p.add_argument("--seeds", type=int, nargs="+", default=[0])
    p.add_argument("--chi-factors", type=float, nargs="+", default=[1.0])
    p.add_argument("--noises", type=float, nargs="*", default=[])
    p.add_argument("--method", default="ite", choices=["ite", "bp"])
    p.add_argument("--chain", default=None, metavar="STAGES",
                   help="comma-separated DAG stages per point, e.g. 'su,ite,measure' — "
                        "dependent jobs with each stage consuming its parent's saved cell "
                        "(reference: condor/CondorJobSender.py send_dag_of_jobs)")
    p.add_argument("--steps-per-dt", type=int, default=10)
    p.add_argument("--steps", type=int, default=None, help="limit ITE segments")
    p.add_argument("--dt-start", type=float, default=1e-2)
    p.add_argument("--dt-stop", type=float, default=1e-4)
    p.add_argument("--csv", default="data/sweeps/results.csv")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the default: workers round-robin over the cards), "
                        "'cuda:i' or 'cpu'")
    p.add_argument("--workers", type=int, default=1,
                   help="worker processes (1: the points run one after another in-process)")
    return p.parse_args(argv)


def main(argv=None):
    from .algo.ite import default_time_steps

    args = parse_args(argv)
    noises = [None if n == 0 else n for n in args.noises] or [None]
    points = grid(Ds=args.Ds, Ns=args.Ns, seeds=args.seeds, chi_factors=args.chi_factors,
                  noises=noises, method=args.method)
    print(f"sweep: {len(points)} points → {args.csv} on {args.device}, {args.workers} worker(s)")

    if args.chain:
        stages = [s.strip() for s in args.chain.split(",") if s.strip()]
        extra = (("dt_start", args.dt_start), ("dt_stop", args.dt_stop),
                 ("steps_per_dt", args.steps_per_dt))
        jobs = []
        for pt in points:
            tag = f"D{pt.D}_N{pt.N}_s{pt.seed}"
            jobs.extend(chain(stages, dataclasses.replace(pt, extra=extra), tag=tag))
        print(f"chain mode: {len(stages)} stages × {len(points)} points = {len(jobs)} DAG jobs")
        results = run_dag(jobs, dag_stage_worker, csv_path=args.csv, n_workers=args.workers,
                          child_device=args.device)
        ok = sum(1 for r in results.values() if r and "error" not in r)
        print(f"done: {ok}/{len(jobs)} jobs succeeded")
        return results

    if args.method == "ite":
        steps = default_time_steps(args.dt_start, args.dt_stop, 20)
        if args.steps:
            steps = steps[: args.steps]
        worker = functools.partial(ite_worker, steps=steps)
    else:
        worker = bp_worker
    results = run_sweep(points, worker, csv_path=args.csv, n_workers=args.workers,
                        child_device=args.device)
    ok = sum(1 for r in results if "error" not in r)
    print(f"done: {ok}/{len(points)} succeeded")
    return results


if __name__ == "__main__":
    main()
