#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (kagomeperiodicbp_tpu_torch) on one
NVIDIA GPU. Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (each raises on failure; any failure exits nonzero with no result):

1. device — a CUDA device is required; prints the card's name and power limit;
2. build — compiles the hand-written kernels (csrc/*.cu, sm_90a);
3. kernels — K1 fused_tensor and K2 chol_inv against their plain PyTorch
   versions on the card, in complex64 and complex128, with median times;
4. the slice in complex128 — production_measurement of tests/assets/pin_D3.pkl
   (BP at N=3, χ=36, then the six edge RDMs at χ=56), once with the default
   linear algebra and once with KPBP_LINALG=gram, against pin_D3.json;
5. the slice in complex64, against the complex128 run (bar 1e-3);
6. one BP sweep at N=2, D=3, χ=18 in complex64, timed;
7. a JSON line with every kernel's launches on the main path, error and
   times; the card's name and power limit; then the result line.
"""
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
PIN_CELL = os.path.join(REPO, "tests", "assets", "pin_D3.pkl")
PIN_GOLD = os.path.join(REPO, "tests", "assets", "pin_D3.json")

PIN_TOL = 1e-9        # the JAX package's pin test bar
SKETCH_TOL = 1e-6     # ceiling when a measured cause (the sketch) explains the gap
C64_TOL = 1e-3        # complex64 energy bar of the c64 dry run
K1_TOL = {"complex64": 1e-6, "complex128": 1e-14}   # absolute, unit-norm ket
K2_TOL = {"complex64": 1e-5, "complex128": 1e-12}   # relative to max|L|, max|W|


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def _ms(torch, fn, budget_ms=300.0, rounds=5) -> float:
    """Median per-call time of `fn` on the card (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    reps = max(1, min(200, int(budget_ms / rounds / max(start.elapsed_time(end), 1e-3))))
    times = []
    for _ in range(rounds):
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def kernel_checks(torch, K, dev):
    """Phase 3: each kernel against its plain version, printed; returns the
    rows measured at the main path's shapes (K1 at D=3 in complex128)."""
    gen = torch.Generator().manual_seed(0)
    rows = {}
    for name in ("complex64", "complex128"):
        dt = getattr(torch, name)
        for D in (2, 3, 5):
            t = torch.randn((2, D, D, D, D), generator=gen, dtype=dt)
            t = (t / torch.linalg.vector_norm(t)).to(dev)
            err = (K.fused_tensor_cuda(t) - K.fused_tensor_ref(t)).abs().max().item()
            ms = _ms(torch, lambda: K.fused_tensor_cuda(t))
            plain = _ms(torch, lambda: K.fused_tensor_ref(t))
            print(f"K1 fused_tensor {name} D={D}: max_abs_err={err:.3e} (tol {K1_TOL[name]:g}) "
                  f"kernel {ms:.4f} ms, plain {plain:.4f} ms")
            if not err < K1_TOL[name]:
                raise AssertionError(f"K1 disagrees with its plain version: {err} at D={D} {name}")
            if D == 3 and name == "complex128":
                rows["fused_tensor"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain}
        for k in (6, 18, 37, 130, 300, 504):
            check_chol_inv(torch, K, dev, gen, dt, name, k)
    return rows


def check_chol_inv(torch, K, dev, gen, dt, name, k):
    b = torch.randn((k, k), generator=gen, dtype=dt)
    g = (b @ b.mH + k * torch.eye(k, dtype=dt)).to(dev)
    l, w = K.chol_inv_cuda(g)
    l_ref, w_ref = K.chol_inv_ref(g)
    err = max(((l - l_ref).abs().max() / l_ref.abs().max()).item(),
              ((w - w_ref).abs().max() / w_ref.abs().max()).item())
    abs_err = max((l - l_ref).abs().max().item(), (w - w_ref).abs().max().item())
    ms = _ms(torch, lambda: K.chol_inv_cuda(g))
    plain = _ms(torch, lambda: K.chol_inv_ref(g))
    print(f"K2 chol_inv {name} k={k}: rel_err={err:.3e} (tol {K2_TOL[name]:g}) "
          f"kernel {ms:.4f} ms, plain {plain:.4f} ms")
    if not err < K2_TOL[name]:
        raise AssertionError(f"K2 disagrees with its plain version: {err} at k={k} {name}")
    return {"max_abs_err": abs_err, "ms": ms, "plain_ms": plain}


def energy_gap(a, b) -> float:
    """max |Δ| over the six edge energies and the mean energy."""
    return max([abs(a["edge_energies"][k] - v) for k, v in b["edge_energies"].items()]
               + [abs(a["mean_energy"] - b["mean_energy"])])


def report_pin(res, gold, label) -> float:
    diffs = {k: res["edge_energies"][k] - v for k, v in gold["edge_energies"].items()}
    diffs["mean"] = res["mean_energy"] - gold["mean_energy"]
    gap = energy_gap(res, gold)
    print(f"{label}: mean_energy={res['mean_energy']!r} edges={json.dumps(res['edge_energies'])}")
    print(f"{label}: diff vs pin_D3.json {json.dumps(diffs)} max|diff|={gap:.3e}; "
          f"{res['seconds']:.2f} s wall; BP {res['bp_iterations']} iterations, "
          f"{res['bp_attempts']} attempt(s), error {res['bp_error']:.3e}")
    return gap


def main() -> int:
    import torch

    # -- 1. device --
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's card path has no CPU fallback",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    smi = _smi()
    print(smi)

    sys.path.insert(0, REPO)
    from kagomeperiodicbp_tpu_torch import measure
    from kagomeperiodicbp_tpu_torch.algo import contraction as C
    from kagomeperiodicbp_tpu_torch.algo import fused as F
    from kagomeperiodicbp_tpu_torch.networks.unit_cell import UnitCell
    from kagomeperiodicbp_tpu_torch.ops import kernels as K
    from kagomeperiodicbp_tpu_torch.ops import linalg as L

    measure.setup_device(dev)
    with open(PIN_GOLD) as fh:
        gold = json.load(fh)

    # -- 2. build --
    t0 = time.perf_counter()
    K.build()
    print(f"build: {time.perf_counter() - t0:.2f} s ({K.library_path().name})")

    # -- 3. kernels against their plain versions --
    rows = kernel_checks(torch, K, dev)

    # -- 4. the slice in complex128 --
    K.reset_launch_counts()
    os.environ.pop("KPBP_LINALG", None)
    res = measure.production_measurement(PIN_CELL, device=dev)
    counts_default = K.launch_counts()
    print(f"c128 default linalg: launches {json.dumps(counts_default)}")
    gap = report_pin(res, gold, "c128 default linalg")

    k_seen = {}
    chol_inv = L.chol_inv

    def recording(g):
        k_seen[g.shape[-1]] = k_seen.get(g.shape[-1], 0) + 1
        return chol_inv(g)

    os.environ["KPBP_LINALG"] = "gram"
    L.chol_inv = recording
    try:
        res_gram = measure.production_measurement(PIN_CELL, device=dev)
    finally:
        L.chol_inv = chol_inv
        os.environ.pop("KPBP_LINALG", None)
    counts = K.launch_counts()
    counts_gram = {n: counts[n] - counts_default[n] for n in counts}
    print(f"c128 KPBP_LINALG=gram: launches {json.dumps(counts_gram)}; "
          f"K2 sizes k:count {json.dumps(dict(sorted(k_seen.items())))}")
    gap_gram = report_pin(res_gram, gold, "c128 KPBP_LINALG=gram")
    if counts_default["fused_tensor"] <= 0 or counts_gram["fused_tensor"] <= 0:
        raise AssertionError("K1 was not launched by a slice run")
    if counts_gram["chol_inv"] <= 0:
        raise AssertionError("K2 was not launched by the gram slice run")

    # the randomized SVD draws its sketch from torch, not jax.random: how far
    # does the sketch move the pin? The same run with another sketch says.
    rsvd = L.rsvd_trunc

    def other_sketch(a, k, **kw):
        m, n = a.shape
        gen = torch.Generator(device=a.device).manual_seed((m * 1000003 + n + 1) % (2**31 - 1))
        omega = torch.randn((n, min(k + L.RSVD_OVERSAMPLE, m, n)), generator=gen,
                            dtype=a.real.dtype, device=a.device)
        return rsvd(a, k, omega=omega, **kw)

    L.rsvd_trunc = other_sketch
    try:
        res_sketch = measure.production_measurement(PIN_CELL, device=dev)
    finally:
        L.rsvd_trunc = rsvd
    sketch = energy_gap(res_sketch, res)
    algebra = energy_gap(res_gram, res)
    print(f"sketch: another sketch moves the energies by {sketch:.3e} "
          f"({res_sketch['seconds']:.2f} s wall); the gram linear algebra, with the same "
          f"sketches, by {algebra:.3e}")
    causes = {"c128 default linalg": {"the randomized-SVD sketch": sketch},
              "c128 KPBP_LINALG=gram": {"the randomized-SVD sketch": sketch,
                                        "the gram linear algebra": algebra if gap < PIN_TOL else 0.0}}
    for label, g in (("c128 default linalg", gap), ("c128 KPBP_LINALG=gram", gap_gram)):
        if g < PIN_TOL:
            continue
        cause = [f"{c}, which alone moves the energies by {v:.3e}"
                 for c, v in causes[label].items() if v >= PIN_TOL]
        if g < SKETCH_TOL and cause:
            print(f"{label}: misses the pin bar {PIN_TOL:g} by {g:.3e}; cause: {'; '.join(cause)}")
            continue
        raise AssertionError(f"{label}: max|diff| {g} vs pin_D3.json")

    # K2 at every size the gram run gave it; the JSON row is the size that
    # carries most of the kernel's time there (calls × ms)
    gen = torch.Generator().manual_seed(1)
    by_k = {k: check_chol_inv(torch, K, dev, gen, torch.complex128, "complex128", k)
            for k in sorted(k_seen)}
    k_main = max(by_k, key=lambda k: k_seen[k] * by_k[k]["ms"])
    rows["chol_inv"] = by_k[k_main]
    kernel_s = sum(k_seen[k] * r["ms"] for k, r in by_k.items()) / 1e3
    plain_s = sum(k_seen[k] * r["plain_ms"] for k, r in by_k.items()) / 1e3
    print(f"K2 on the gram run: k={k_main} carries most of its time; all sizes together "
          f"{kernel_s:.2f} s of kernel time vs {plain_s:.2f} s for the plain version "
          f"(calls × isolated median times)")

    # -- 5. the slice in complex64 --
    K.reset_launch_counts()
    res64 = measure.production_measurement(PIN_CELL, device=dev, dtype=torch.complex64)
    counts64 = K.launch_counts()
    d64 = energy_gap(res64, res)
    print(f"c64: mean_energy={res64['mean_energy']!r}; max|c64 - c128|={d64:.3e} "
          f"(tol {C64_TOL:g}); {res64['seconds']:.2f} s wall; BP {res64['bp_iterations']} "
          f"iterations, {res64['bp_attempts']} attempt(s); launches {json.dumps(counts64)}")
    if not d64 < C64_TOL:
        raise AssertionError(f"c64 slice differs from c128 by {d64}")
    if counts64["fused_tensor"] <= 0:
        raise AssertionError("K1 was not launched by the c64 slice run")

    # -- 6. one BP sweep, N=2, D=3, χ=18, complex64 --
    cell = UnitCell.load(PIN_CELL, device=dev).astype(torch.complex64).force_zero_rotation()
    msgs = F._msgs_to_sites(C.initial_messages(2, cell.D, 18, dtype=torch.complex64, device=dev))
    sweep = F.bp_iteration(2, cell.D, 18, 18, None)
    fused = C.fused_cells(cell)
    sweep_s = []
    for i in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        msgs, err = sweep(fused, msgs)
        float(err)
        sweep_s.append(time.perf_counter() - t0)
    print(f"BP sweep N=2 D=3 chi=18 c64: median {statistics.median(sweep_s[1:]) * 1e3:.1f} ms "
          f"over {len(sweep_s) - 1} sweeps after one warm-up; first {sweep_s[0] * 1e3:.1f} ms; "
          f"distance {float(err):.3e}")

    # -- 7. results --
    launches = {n: counts_default[n] + counts_gram[n] for n in counts_default}
    src = {"fused_tensor": ("kagomeperiodicbp_tpu_torch/csrc/fused_tensor.cu",
                            "kagomeperiodicbp_tpu/ops/pallas_kernels.py:82"),
           "chol_inv": ("kagomeperiodicbp_tpu_torch/csrc/chol_inv.cu",
                        "kagomeperiodicbp_tpu/ops/pallas_kernels.py:194")}
    kernels = [{"name": n, "route": "cuda", "source": src[n][0], "replaces": src[n][1],
                "launches": launches[n], **rows[n]} for n in ("fused_tensor", "chol_inv")]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
