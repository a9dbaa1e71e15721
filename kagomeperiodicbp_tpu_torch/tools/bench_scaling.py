"""BP-sweep throughput across bond dimensions on the card (counterpart of
the JAX package's tools/bench_scaling.py, with its rows' keys; ``--sweeps``
and ``--device`` added).

    python -m kagomeperiodicbp_tpu_torch.tools.bench_scaling [Ds ...] [--sweeps 20] [--device cuda]

Per D (default 2 3 4 5): N=2, χ = χ_msg = 2D², complex64, the cell
``convert.numpy_random_cell(D, 0)`` and uniform messages. The sweep is the
one BP runs at that D (``algo/bp.bp_mode``: batched below D=6, single-layer
from it; ``KPBP_SINGLE_LAYER`` and ``KPBP_BP_BATCHED`` steer the rule as they
steer BP). The cell's fused tensors are made once per D, outside the timed
sweeps. The first sweep is timed alone (``first_iteration_seconds``), then
``--sweeps`` sweeps in one window; each window ends in a synchronise.

One JSON line per D, with the JAX tool's keys (D, N, chi, sweep_seconds,
sweeps_per_second, first_iteration_seconds, single_layer, platform) and
bp_mode, device (the card's name and power limit), peak_device_gb,
flops_per_sweep (``tools/flops_model``'s count of one such sweep, real
flops), achieved_gflops (flops_per_sweep over sweep_seconds) and launches
(the kernels' launches by name, from making the fused tensors to the last
timed sweep; on the card K1 once where the sweep is double-layer). As the JAX
tool does, a D that fails prints {"D", "error"} and the next D runs; the
command then exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch

from ..ops import kernels as K
from . import flops_model as FM


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("Ds", type=int, nargs="*", default=[2, 3, 4, 5])
    p.add_argument("--sweeps", type=int, default=20)
    p.add_argument("--device", default="cuda", help="cuda (default) | cpu")
    args = p.parse_args(argv)
    if args.sweeps < 1:
        p.error("--sweeps must be at least 1")
    return args


def device_label(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader", f"--id={device.index or 0}"],
                             capture_output=True, text=True, timeout=30)
        if out.returncode == 0 and out.stdout.strip():
            return out.stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        pass
    return f"{torch.cuda.get_device_name(device)}, power limit not read"


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def bench_D(D: int, device: torch.device, N: int = 2, n_sweeps: int = 20,
            dtype: torch.dtype = torch.complex64):
    """(row, message sites after the 1 + n_sweeps sweeps) at bond dimension D."""
    chi = 2 * D * D
    mode = FM.default_mode(D, chi, dtype)
    K.reset_launch_counts()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    cell, sites = FM.inputs(N, D, chi, device, dtype)
    step = FM.sweep_fn(N, D, chi, chi, mode)
    with torch.no_grad():
        tensors = FM.sweep_tensors(cell, mode)
        _sync(device)
        t0 = time.perf_counter()
        sites, err = step(tensors, sites)
        float(err)
        first_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(n_sweeps):
            sites, err = step(tensors, sites)
        float(err)
        _sync(device)
        dt = (time.perf_counter() - t0) / n_sweeps
    peak = torch.cuda.max_memory_allocated(device) / 1e9 if device.type == "cuda" else None
    launches = K.launch_counts()
    # the count of one more sweep of the same call, on the messages reached
    _, rec = FM.count(step, tensors, sites)
    row = {"D": D, "N": N, "chi": chi, "sweep_seconds": dt, "sweeps_per_second": 1.0 / dt,
           "first_iteration_seconds": first_s, "single_layer": mode == "single",
           "bp_mode": mode, "peak_device_gb": peak, "flops_per_sweep": rec["total"],
           "achieved_gflops": rec["total"] / dt / 1e9, "launches": launches}
    return row, sites


def main(argv=None) -> int:
    from ..measure import setup_device

    args = parse_args(argv)
    device = setup_device(args.device)
    label = device_label(device)
    platform = "gpu" if device.type == "cuda" else "cpu"
    failed = []
    for D in args.Ds:
        try:
            row, _ = bench_D(D, device, n_sweeps=args.sweeps)
            row.update({"platform": platform, "device": label})
            print(json.dumps(row), flush=True)
        except Exception as exc:  # noqa: BLE001 — the row says what failed; the exit code too
            failed.append(D)
            print(json.dumps({"D": D, "error": repr(exc)[:200]}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
