"""Phase profile of one BP outgoing-message contraction: where the time of
``ops/contract.execute_plan`` goes (counterpart of the JAX package's
tools/profile_bp_phases.py, with its flags and JSON keys; ``--device`` takes
the place of ``--platform``).

    python -m kagomeperiodicbp_tpu_torch.tools.profile_bp_phases 6 8 --single
    python -m kagomeperiodicbp_tpu_torch.tools.profile_bp_phases 2 --device cpu

The executor's ``qr_stable`` and ``svd_trunc_auto`` are wrapped in timers
that synchronise the device before and after each call, so the wall time
splits into

    qr     — qr_stable calls (canonicalisation sweeps, blob splits, sketches)
    svd    — svd_trunc_auto calls (bond truncation)
    other  — the swallow contractions and the host's glue,

and beside them "sketch_s", the sketched swallows whole
(``_swallow_ket_gram_split``, its QRs included, which "qr_s" counts too).

The synchronising timers add a wait per call, so their total overstates the
unwrapped call's; one more call, unwrapped, runs under ``torch.profiler``
and its device time is split by kernel name into the same three parts
("device": busy time, qr, svd, other, and the kernels with most time). On
the CPU there is no device split. The cell is random, drawn with numpy from
seed 0; the messages are uniform at χ = 2D², complex64. It runs on the
card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from ..algo import contraction as C
from ..algo import fused as F
from ..convert import numpy_random_cell, unit_cell_from_numpy
from ..measure import setup_device
from ..ops import contract as X

# device kernels by name: cuSOLVER's QR (and K2, CholeskyQR2's factor under
# KPBP_LINALG=gram), and its SVDs and the eigensolvers of the eigh-of-gram SVD
QR_KERNELS = ("geqr", "orgqr", "ungqr", "ormqr", "unmqr", "larf", "chol_inv")
SVD_KERNELS = ("gesvd", "svdj", "jacobi", "bdsqr", "gebrd", "gesdd", "syevd", "heevd", "sytrd",
               "hetrd", "ormtr", "unmtr", "steqr", "stedc")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("Ds", nargs="*", type=int, default=None)
    p.add_argument("--device", default="cuda", help="cuda (default) | cpu")
    p.add_argument("-N", type=int, default=2)
    p.add_argument("--single", action="store_true", help="single-layer swallow mode")
    p.add_argument("--reps", type=int, default=1)
    return p.parse_args(argv)


def _kind(name: str) -> str:
    low = name.lower()
    if any(k in low for k in QR_KERNELS):
        return "qr"
    if any(k in low for k in SVD_KERNELS):
        return "svd"
    return "other"


def device_split(fn, device) -> dict | None:
    """One call of `fn` under torch.profiler: its device time by kind, the
    busy time (the union of kernel intervals) and the top kernels."""
    if device.type != "cuda":
        return None
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize(device)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    events = sorted((e.start_ns() / 1e9, e.end_ns() / 1e9, e.name())
                    for e in prof.profiler.kineto_results.events() if e.device_type() == cuda)
    by_kind, by_name = {"qr": 0.0, "svd": 0.0, "other": 0.0}, {}
    busy, end = 0.0, float("-inf")
    for s, e, name in events:
        by_kind[_kind(name)] += e - s
        by_name[name] = by_name.get(name, 0.0) + e - s
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
    total = sum(by_kind.values()) or 1.0
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"wall_s": wall, "busy_s": busy, "events": len(events),
            **{f"{k}_s": v for k, v in by_kind.items()},
            **{f"{k}_frac": v / total for k, v in by_kind.items()},
            "top": [[n[:80], t] for n, t in top]}


def profile(D: int, N: int, single: bool, reps: int, device) -> dict:
    """The JAX tool's record for one D, with the device split beside it."""
    device = setup_device(device)
    sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" else (lambda: None)
    chi = 2 * D * D
    dtype = torch.complex64
    cell = unit_cell_from_numpy(numpy_random_cell(D, 0), device, dtype)
    msg_sites = F._msgs_to_sites(C.initial_messages(N, D, chi, dtype=dtype, device=device))
    plan = C.to_message_plan(N, D, chi, chi, 0)
    if single:
        plan = C.single_layer_plan(plan)
        fetch = C._make_fetch(None, msg_sites, kets=C.site_kets(cell))
    else:
        fetch = C._make_fetch(C.fused_cells(cell), msg_sites)

    def call():
        out = X.execute_plan(plan, fetch)
        sync()
        return out

    acc = {"qr": 0.0, "svd": 0.0, "sketch": 0.0, "n_qr": 0, "n_svd": 0, "n_sketch": 0}
    real = {"qr": X.qr_stable, "svd": X.svd_trunc_auto, "sketch": X._swallow_ket_gram_split}

    def timed(name):
        def wrap(*a, **k):
            sync()
            t0 = time.perf_counter()
            out = real[name](*a, **k)
            sync()
            acc[name] += time.perf_counter() - t0
            acc["n_" + name] += 1
            return out
        return wrap

    call()  # warm-up: kernel builds, plan caches, library handles
    split = device_split(call, device)
    X.qr_stable, X.svd_trunc_auto, X._swallow_ket_gram_split = (timed(n) for n in real)
    try:
        t0 = time.perf_counter()
        for _ in range(reps):
            call()
        total = (time.perf_counter() - t0) / reps
    finally:
        X.qr_stable, X.svd_trunc_auto, X._swallow_ket_gram_split = real.values()
    qr, svd = acc["qr"] / reps, acc["svd"] / reps
    return {
        "platform": device.type, "D": D, "N": N, "chi": chi, "single_layer": bool(single),
        "total_s": total, "qr_s": qr, "svd_s": svd, "other_s": total - qr - svd,
        "qr_frac": qr / total, "svd_frac": svd / total,
        "n_qr": acc["n_qr"] // reps, "n_svd": acc["n_svd"] // reps,
        "sketch_s": acc["sketch"] / reps, "n_sketch": acc["n_sketch"] // reps,
        "device": split,
    }


def main(argv=None) -> list:
    args = parse_args(argv)
    out = []
    for D in args.Ds or [3, 4, 5]:
        out.append(profile(D, args.N, args.single, args.reps, args.device))
        print(json.dumps(out[-1]), flush=True)
    return out


if __name__ == "__main__":
    main()
