"""Large-D work unit: BP run sweep by sweep, then one ITE edge update, at a
given bond dimension, timed, with peak device memory (counterpart of the JAX
package's tools/large_d_demo.py, with its flags and JSON keys; ``--device``
takes the place of ``--platform``).

    python -m kagomeperiodicbp_tpu_torch.large_d_demo 8 --sweeps 3
    python -m kagomeperiodicbp_tpu_torch.large_d_demo 2 --device cpu --sweeps 2

The cell is random, drawn with numpy from seed 0 (the same on every
device); the messages start uniform at χ_msg = chi_factor·D² and the
contraction runs at χ = χ_msg + 10. BP stops below max(1e-6, 30·eps) or
after ``--sweeps``; the messages are hermitized, then one update of edge
(A,B) with the AFM Heisenberg gate at dt=1e-3. BP swallows single-layer from
D=6 (``algo/bp.bp_mode``), and the update's environment by the blob rule
(``algo/edge_env.env_single_layer``: from D=7 at χ = 2D²+10).

Prints one JSON line: the JAX tool's keys {"D", "N", "chi", "chi_env",
"dtype", "single_layer", "backend", "blob_limit", "bp_sweeps", "bp_err",
"s_per_sweep", "bp_total_s", "ite_step_s", "energy", "peak_rss_gb"} and
"sweep_s" (every sweep), "build_s" (the kernels' build, on the card),
"peak_device_gb" (``max_memory_allocated``; with
"bp_peak_device_gb" and "ite_peak_device_gb"), "swallow_counts" (the last
sweep's swallows by kind), "single_layer_env", "launches" (kernel launches
by name), "ite_health" and "device" (the card's name, or "cpu"). A SIGTERM
(``timeout``) or an exception still prints the line with what was reached
and an "error" key. It runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import json
import os
import resource
import signal
import sys
import time

import torch

from .algo import batched as B
from .algo import bp as BP
from .algo import contraction as C
from .algo import edge_env as E
from .algo import fused as F
from .algo.ite import ITEConfig, ite_update_edge
from .convert import numpy_random_cell, unit_cell_from_numpy
from .enums import UnitCellFlavor, UpdateEdge
from .measure import setup_device
from .ops import contract as CT
from .ops import kernels as K
from .ops.contract import _blob_elem_limit
from .ops.linalg import _real_dtype
from .physics.hamiltonians import heisenberg_afm

SEED = 0  # the random cell's, as the JAX tool's PRNGKey(0)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("D", type=int)
    ap.add_argument("N", type=int, nargs="?", default=2)
    ap.add_argument("--device", default="cuda", help="cuda (default) | cpu")
    ap.add_argument("--f64", action="store_true", help="complex128 (default complex64)")
    ap.add_argument("--sweeps", type=int, default=30)
    ap.add_argument("--chi-factor", type=float, default=2.0,
                    help="chi_msg = chi_factor * D^2 (reference: 2D^2)")
    ap.add_argument("--single-layer", type=int, default=None,
                    help="force single-layer BP on (1) / off (0); default auto (D>=6)")
    return ap.parse_args(argv)


def _peak_gb(device) -> float | None:
    if device.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device) / 1e9


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(args, rec: dict) -> dict:
    """The work unit, filling `rec` as it goes (so that what was reached
    survives an interruption)."""
    device = setup_device(args.device)
    D, N = args.D, args.N
    dtype = torch.complex128 if args.f64 else torch.complex64
    chi_msg = int(args.chi_factor * D * D)
    chi_env = chi_msg + 10                     # reference: chi = 2D²+10
    single = None if args.single_layer is None else bool(args.single_layer)
    cfg = BP.BPConfig(trunc_dim=chi_msg, bubble_trunc_dim=chi_env, max_iterations=args.sweeps,
                      msg_diff_terminate=1e-6, single_layer=single, dtype=dtype)
    mode = BP.bp_mode(cfg, D)
    cell = unit_cell_from_numpy(numpy_random_cell(D, SEED), device, dtype)
    rec.update({
        "D": D, "N": N, "chi": chi_msg, "chi_env": chi_env, "dtype": str(dtype).split(".")[-1],
        "single_layer": mode == "single",
        "single_layer_env": E.env_single_layer(D, chi_env, chi_msg),
        "backend": device.type, "blob_limit": float(_blob_elem_limit()),
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
    })
    print(f"large_d_demo: D={D} N={N} chi_msg={chi_msg} chi_env={chi_env} dtype={rec['dtype']} "
          f"device={rec['device']} bp={mode} env single-layer={rec['single_layer_env']}", flush=True)
    if device.type == "cuda":
        t0 = time.perf_counter()
        K.build()   # the kernels' build stays out of the timed sweeps and update
        rec["build_s"] = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats(device)
    K.reset_launch_counts()

    tensors = C.site_kets(cell) if mode == "single" else C.fused_cells(cell)
    if mode == "batched":
        step_fn = B.bp_iteration_batched(N, D, chi_env, chi_msg, None)
    else:
        step_fn = F.bp_iteration(N, D, chi_env, chi_msg, None, single=mode == "single")
    msg_sites = F._msgs_to_sites(C.initial_messages(N, D, chi_msg, dtype=dtype, device=device))
    # the stop threshold of belief_propagation, clamped to the working precision
    stop = max(cfg.msg_diff_terminate, 30 * torch.finfo(_real_dtype(dtype)).eps)
    sweep_s = rec["sweep_s"] = []
    t_bp = time.perf_counter()
    err = float("inf")
    for it in range(args.sweeps):
        _sync(device)
        CT.reset_swallow_counts()
        t0 = time.perf_counter()
        msg_sites, err_t = step_fn(tensors, msg_sites)
        err = float(err_t)
        sweep_s.append(time.perf_counter() - t0)
        rec.update({"bp_sweeps": len(sweep_s), "bp_err": err, "swallow_counts": CT.swallow_counts(),
                    "bp_peak_device_gb": _peak_gb(device)})
        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
        print(f"  sweep {it}: {sweep_s[-1]:.2f}s err={err:.3e} rss={rss:.1f}GB "
              f"peak device {rec['bp_peak_device_gb']} GB", flush=True)
        if err < stop:
            break
    bp_s = time.perf_counter() - t_bp
    msg_sites = F.hermitize_all(N, D, chi_msg)(msg_sites)
    rec.update({"s_per_sweep": min(sweep_s), "bp_total_s": bp_s})
    print(f"  BP: {len(sweep_s)} sweeps in {bp_s:.1f}s (fastest {min(sweep_s):.2f} s/sweep), "
          f"err={err:.2e}", flush=True)

    edge = UpdateEdge(UnitCellFlavor.A, UnitCellFlavor.B)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    _sync(device)
    t0 = time.perf_counter()
    _, energy, health = ite_update_edge(cell, F._sites_to_msgs(msg_sites), N, chi_env, chi_msg,
                                        edge, heisenberg_afm(), 1e-3,
                                        ITEConfig(hamiltonian=heisenberg_afm))
    rec.update({"ite_step_s": time.perf_counter() - t0, "energy": energy, "ite_health": health,
                "ite_peak_device_gb": _peak_gb(device)})
    print(f"  ITE edge update: {rec['ite_step_s']:.2f}s, energy={energy:.6f}, health={health}, "
          f"peak device {rec['ite_peak_device_gb']} GB", flush=True)
    return rec


def _finish(rec: dict) -> None:
    rec["peak_rss_gb"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    peaks = [rec.get(k) for k in ("bp_peak_device_gb", "ite_peak_device_gb")]
    peaks = [p for p in peaks if p is not None]
    rec["peak_device_gb"] = max(peaks) if peaks else None
    rec["launches"] = K.launch_counts()
    print(json.dumps(rec), flush=True)


def main(argv=None) -> dict:
    args = parse_args(argv)
    rec: dict = {}

    # a SIGTERM from `timeout` still leaves the evidence reached so far
    def _on_term(signum, frame):
        rec["error"] = f"terminated (signal {signum}) mid-run"
        _finish(rec)
        sys.stdout.flush()
        os._exit(124)

    previous = signal.signal(signal.SIGTERM, _on_term)
    try:
        run(args, rec)
    except BaseException as exc:  # still print partial evidence, then re-raise
        rec["error"] = repr(exc)[:300]
        _finish(rec)
        raise
    finally:
        signal.signal(signal.SIGTERM, previous)
    _finish(rec)
    return rec


if __name__ == "__main__":
    main()
