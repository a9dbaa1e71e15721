#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (kagomeperiodicbp_tpu_torch) on one
NVIDIA GPU. Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (each raises on failure; any failure exits nonzero with no result):

1. device — a CUDA device is required; prints the card's name and power limit;
2. build — compiles the hand-written kernels (csrc/*.cu, sm_90a);
3. kernels — K1 fused_tensor, one tensor and a cell's three in one launch,
   against its plain PyTorch version at D=2…8 in complex64 and complex128,
   at D=3 in float32 and float64 and at D=9 (D read at run time), timed
   beside the einsum library call and its bound; K2 chol_inv (the
   variant the plan picks) against its plain version in complex64 and
   complex128, with median times; K2's resident and blocked variants timed
   side by side around their switch, ops/kernels.CHOL_RESIDENT_MAX_K, in
   all four dtypes; and K2 by k, the grams of the pin and of D=6–8
   (k = 324…8832 in complex64, 324, 504, 2952 in complex128): every large-k
   variant that takes k (blocked; tiled at tile widths 64 and 128) held to
   the plain version and timed in turns, per call and on the device,
   beside cuSOLVER (cholesky_ex + solve_triangular), the bound and its
   share, with the k at which the plan switches;
4. the slice in complex128 — production_measurement of tests/assets/pin_D3.pkl
   (BP at N=3, χ=36, then the six edge RDMs at χ=56), once with the default
   linear algebra and once with KPBP_LINALG=gram, against pin_D3.json (a
   gap over the bar passes below 1e-6 only beside a measured cause of that
   size: the gram linear algebra, by these two runs, or the randomized
   SVD's sketch, by a third run with another sketch, made only where no
   other cause is measured); then K2 at every size the gram run gave it,
   against its plain version and the library call
   (torch.linalg.cholesky_ex + solve_triangular);
5. the slice in complex64, against the complex128 run (bar 1e-3);
6. one BP sweep at N=2, D=3, χ=18 in complex64, timed;
7. torch.profiler over one gram BP sweep at the pin's BP size (N=3, χ=36,
   complex128): device busy share and device time by kernel;
8. ITE on the card, the JAX bench's configuration (N=2, D=3, χ_env=28,
   χ_msg=18, edge (A,B), als_iters=10, AFM Heisenberg, dt=1e-3, messages
   from BP on the pin cell): one edge update timed in complex64 and
   complex128, default linear algebra and KPBP_LINALG=gram, with K1's and
   K2's launches per update and a profile of one update; the complex128
   update on the card against the CPU port (default and gram) on what the
   bond gauge leaves fixed; a short full_ite (random D=3 cell, 2 segments
   at dt=0.1, one mode each, BP once per segment, to a stop of 1e-6) that
   must lower the energy with no ITEError;
9. single-layer swallowing, the BP path the JAX package takes from D=6, at
   the production χ of tools/large_d_demo.py (D=6, N=2, χ_msg=72, χ=82):
   the double-layer and the single-layer message (every swallow through its
   blob) agree in complex128 on the pin cell padded to D=6; the sketched
   swallow's message at D=6, χ=24 stays within 1.4× of the direct path's
   distance to a χ=72 oracle; single-layer messages at D=3 on the card
   agree with the CPU port, direct and sketched at full rank; sketched at the
   default rank, walked step by step, every step on the card agrees with
   the CPU's on the same frontier, and where the frontiers, each run on
   its own, part, they part first at a sketched swallow; then, in complex64
   with the default linear algebra, BP (single-layer by the auto switch)
   timed per sweep with its peak device memory and swallows per sweep, a
   profile of one per-side call, one ITE edge update on its messages, and
   one per-side call under KPBP_LINALG=gram, which must launch the K2
   variant the plan picks for its largest gram, with K2 then held to its
   plain version at every size that call gave it, in complex64, and K2's
   share of the call (calls × kernel time over those sizes);
10. the warm start on growing blocks: K1's operator form (a separate bra:
   the x, y, z sandwiches of one site in one launch) against its plain
   version at D=2…8 in complex64 and complex128, timed beside the einsum;
   then, launches counted, the simple update of tests/assets/su_q0_D3.pkl
   (D=3, complex128, the default ladder less its dt=0.1 block: from this
   seed the default ladder moves by O(0.1) under a 1e-15 change in the JAX
   package too) against the JAX package's λ and its block measurements at
   N=2 and, under KPBP_LINALG=gram, N=3 against the JAX script's rows
   (su_q0_D3.json, tools/make_su_pin.py), one N=2 measurement under
   KPBP_LINALG=gram against the default one; the simple update at D=6 in
   complex64 and complex128 over a cut ladder, timed; measure_xyz_sandwich on the pin cell at N=2,
   card against the CPU port, with 1 + 3 K1 launches, and at the pin's
   production convention beside the RDM path's ⟨x, y, z⟩; BP from
   random-classic messages; an arbitrary block tiled from the pin cell
   against the unit-cell path, and a block of 21 independent kets
   (tests/assets/warm_start_D2.npz) against the JAX package's measurement
   of it; pmps_inner of a small chain, card against
   CPU;
11. the batched six-side sweep, which BP takes by itself below D=6 (the
   pin measurements of phases 4-5 and the block measurements of phase 10
   run it; every BP run's sweep is printed phase by phase): one batched
   sweep at N=2, D=3, χ=18 on the pin cell and phase 6's messages against
   the per-side sweep on the card in complex128 and complex64, both timed
   in turns and profiled in complex64; one of each under KPBP_LINALG=gram,
   where the batched sweep launches K2 a third as often, variant by
   variant, with K2 then held to its plain version at every (3, k) size it
   took; at D=5, χ_msg=50, χ=60, from dense random messages, a batched
   and a per-side sweep in complex64, timed with peak memory, then one
   class of the batched sweep against the per-side body in complex128
   with exact SVDs, held; then the square lattice
   (square/*, run_square): the JAX package's values at n=4, m=2, D=2
   (tests/assets/square_D2.npz) and the simple update from its start, card
   against CPU; run_square at D=4, χ 32/42 in complex128 and complex64, its
   SU ladder cut, each step timed with K1's launches (plain and operator
   form); at D=3 the simple update from the JAX package's start, BP and
   the energy against its values (tests/assets/square_D3.npz), then a
   full-update polish (two stages, each BP cut to 6 sweeps) that must
   lower the energy; one square
   BP under KPBP_LINALG=gram, on K2;
12. the distribution layer (parallel/*), every group's ranks sharing
   cuda:0 over gloo (parallel/launch prints the backend and each rank's
   device): the side-sharded sweep on 3 ranks (N=2, D=3, χ=18, the pin
   cell and phase 6's messages) against the batched sweep in this process
   in complex128 and complex64, both timed; on 6 ranks (dp=2, side=3) the
   dryrun_multichip's complex64 and complex128 passes, then the multichain
   ITE step at phase 8's size under KPBP_LINALG=gram (the pin cell and a
   numpy-drawn D=3 cell), each chain's energy held in complex128 to the
   same step in this process, with K1 and K2 launches per rank; one
   single-layer per-side call at phase 9's size (D=6, χ 72/82, c128) with
   its blob rows split over 2 ranks against the unsharded call on the pin
   cell padded to D=6, held with the sketch at full rank, printed at the
   default rank, with each rank's partitioned swallows and rows; run_sweep of bp_worker over 4 points with
   one worker and then four on the card, every point's result the same,
   wall times and points per second; the complex64 sweep of the QR repair
   (N=2, D=2, χ 8/12) per side and batched against complex128;
13. large D and records: the pin cell padded to D=7 with no noise, and its
   BP messages (N=2, χ_msg=98, χ=108, complex128) padded alike, measured
   through the single-layer edge environment the blob rule picks
   (algo/edge_env.env_single_layer), its six edge energies against the
   unpadded pin's at the same N and χ (the pin's BP and measurement are
   the reference, kept out of the launch counts); large_d_demo's D=8 work
   unit (χ_msg=128, χ=138, complex64, a numpy-seeded random cell, uniform
   messages): one single-layer per-side call and one ITE edge update on its
   message, each timed with peak device memory, swallows by kind and K1's
   launch, then one per-side call under KPBP_LINALG=gram; the D=8 edge
   environment at χ 16/26 in complex128, single-layer against double-layer
   with exact SVDs;
   the entry point ``large_d_demo 7 --sweeps 1``; then, as a path of their
   own, measure_padded at D=3 from the repository's D=2 record
   (--no-store), its energy beside the record's, and bp_accuracy and
   load_external_su at D=2, card against the CPU port; then, the launch
   counts read, K2 held to its plain version at every size the D=8 gram
   call gave it and timed there, for K2's share of that call, printed
   beside the default per-side call;
14. the port's own work: tools.bench_scaling at D=2…5 as a command of
   its own, which must exit 0 with the batched sweep at every D, K1 once
   per D and K2 never; the flop model (tools/flops_model) at the JAX
   tool's configuration (N=2, D=3, χ=18, complex64): the batched sweep
   (bench_scaling's D=3 row), the per-side sweep and the ITE edge update
   counted on the card, each equal to the CPU's count of the same call as
   integers, beside data/flops_model.json's XLA count, and phase 6's and
   phase 8's times as achieved GFLOP/s and a share of the FP32 peak;
   create_kagome_elists, plot_afmh_benchmark (its table; the card's
   machine has no matplotlib, so no --plot) and unpack_ite_tracker (on
   phase 8's full_ite tracker, --out read back), each as a command;
15. a JSON line with K1's cases by D, one with the ITE numbers, one with
   the single-layer numbers, one with the warm-start numbers, one with
   phase 11's, one with phase 12's, one with phase 13's, one with phase
   14's, then one with every kernel's launches on the main paths, error,
   times and bound; the card's name and power limit; then the result line.

A kernel's device time per call comes from CUDA events around calls that
wait behind a device-side sleep, so that the host wrapper's time drops
out; its time per call, from CUDA events around calls as the host issues
them. A bound is the least time the card could take for a kernel's work: the
larger of its bytes (each input read once, each output written once) over
3.35 TB/s and its flops over 67 TFLOP/s (H100 SXM: FP32 outside the tensor
cores, and FP64 on them).
"""
import json
import os
import statistics
import subprocess
import sys
import time

T_START = time.perf_counter()
REPO = os.path.dirname(os.path.abspath(__file__))
PIN_CELL = os.path.join(REPO, "tests", "assets", "pin_D3.pkl")
PIN_GOLD = os.path.join(REPO, "tests", "assets", "pin_D3.json")

PIN_TOL = 1e-9        # the JAX package's pin test bar
SKETCH_TOL = 1e-6     # ceiling when a measured cause (the sketch, the gram algebra) explains the gap
C64_TOL = 1e-3        # complex64 energy bar of the c64 dry run
K1_TOL = {"float32": 1e-6, "float64": 1e-14,      # absolute, unit-norm ket
          "complex64": 1e-6, "complex128": 1e-14}
# K1's cases: D=2…8 (the pin's D=3 to the D=8 of simple-update records) in
# both complex types, the real types at the pin's D, and one D above 8,
# where the kernel reads D at run time
K1_CASES = ([(n, D) for n in ("complex64", "complex128") for D in range(2, 9)]
            + [("float32", 3), ("float64", 3), ("complex128", 9)])
K2_TOL = {"complex64": 1e-5, "complex128": 1e-12}   # relative to max|L|, max|W|
K2_VARIANTS = ("chol_inv_resident", "chol_inv_blocked", "chol_inv_tiled")
# K2 by k (phase 3): the pin's grams, both sides of the switch to the tiled
# variant and of its tile width, and D=6, 7 and 8's largest (D²·χ at
# χ = 82, 108, 138)
K2_TABLE = (("complex64", (324, 504, 1296, 1600, 2952, 4096, 5292, 8832)),
            ("complex128", (324, 504, 1152, 1296, 2952)))
K2_BOTH_WIDTHS_MIN_K = 4096   # the tiled variant at both tile widths from here
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = 67e12


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


def bound(flops, nbytes):
    """(ms, what bounds it) for work of `flops` and `nbytes` on this card."""
    t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def chol_inv_work(k, dt, torch):
    """K2's flops and bytes at size k: k³/6 multiply-adds for the factor and
    as many for the inverse (8 flops each in complex, 2 in real); G read
    once, L and W written once."""
    size = torch.empty((), dtype=dt).element_size()
    return (8 if dt.is_complex else 2) * k ** 3 / 3, 3 * k * k * size


def device_events(torch, prof):
    """(name, start µs, end µs) of every device activity a profile saw, read
    from the profiler's raw events: building its FunctionEvents takes tens of
    seconds for a BP sweep's ~10⁵ launches."""
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3)
            for e in prof.profiler.kineto_results.events() if e.device_type() == cuda]


def device_ms(torch, fn, calls=20, sleep_cycles=20_000_000, tries=4):
    """Device time per call of `fn`: CUDA events around `calls` calls queued
    behind a device-side sleep (~10 ms), so the host has enqueued them all
    before the first one runs and its wrapper time drops out. Where the host
    took longer to enqueue them than the device slept, the sleep doubles and
    the calls run again, up to `tries` times in all."""
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        before, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        before.record()
        torch.cuda._sleep(sleep_cycles)
        start.record()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        end.record()
        host_ms = (time.perf_counter() - t0) * 1e3
        end.synchronize()
        if host_ms < before.elapsed_time(start):
            return start.elapsed_time(end) / calls
        sleep_cycles *= 2
    raise AssertionError(f"device_ms: the host took {host_ms:.2f} ms to enqueue, longer than "
                         f"the device slept in each of {tries} tries; the time would include "
                         f"the host's gaps")


def fused_library(torch, t):
    """The one PyTorch call that computes K1's function, on a stacked cell
    t [n, d, D,D,D,D]: an einsum over s, reshaped to [n, D²,D²,D²,D²] (a
    copy, since the einsum's result is a permuted view). A yardstick only:
    the port never calls it."""
    n, D = t.shape[0], t.shape[2]
    return torch.einsum("fsabce,fsABCE->faAbBcCeE", t, t.conj()).reshape((n,) + (D * D,) * 4)


def fused_tensor_work(n, t):
    """K1's flops and bytes for n tensors like t [d, D,D,D,D]: d multiply-adds
    per output element (8 flops each in complex, 2 in real); t read once
    and the D⁸ outputs written once, per tensor."""
    d, D = t.shape[0], t.shape[1]
    return n * (8 if t.dtype.is_complex else 2) * d * D ** 8, n * (d * D ** 4 + D ** 8) * t.element_size()


def k1_checks(torch, K, dev, gen):
    """Phase 3, K1: one tensor (fused_tensor_cuda) and a cell's three in one
    launch (fused_tensors_cuda) against the plain version, timed beside the
    einsum library call. Returns the list of cases and the row at the main
    path's shape (a cell at D=3 in complex128)."""
    by_D, row = [], None
    for name, D in K1_CASES:
        dt = getattr(torch, name)
        cell = [torch.randn((2, D, D, D, D), generator=gen, dtype=dt) for _ in range(3)]
        cell = [(t / torch.linalg.vector_norm(t)).to(dev) for t in cell]
        stacked = torch.stack(cell)
        t = cell[0]
        err1 = (K.fused_tensor_cuda(t) - K.fused_tensor_ref(t)).abs().max().item()
        errc = max((g - w).abs().max().item()
                   for g, w in zip(K.fused_tensors_cuda(cell), K.fused_tensors_ref(cell)))
        if not max(err1, errc) < K1_TOL[name]:
            raise AssertionError(f"K1 disagrees with its plain version: {max(err1, errc)} at D={D} {name}")
        case = {"dtype": name, "D": D, "runtime_D": D > 8, "max_abs_err": max(err1, errc)}
        for label, n, fn, plain, lib in (
                ("one", 1, lambda: K.fused_tensor_cuda(t), lambda: K.fused_tensor_ref(t),
                 lambda: fused_library(torch, stacked[:1])),
                ("cell", 3, lambda: K.fused_tensors_cuda(cell), lambda: K.fused_tensors_ref(cell),
                 lambda: fused_library(torch, stacked))):
            b_ms, b_by = bound(*fused_tensor_work(n, t))
            dev_ms = device_ms(torch, fn)
            case[label] = {"ms": _ms(torch, fn, budget_ms=100.0), "device_ms": dev_ms,
                           "plain_ms": _ms(torch, plain, budget_ms=100.0),
                           "library_ms": _ms(torch, lib, budget_ms=100.0),
                           "library_device_ms": device_ms(torch, lib),
                           "bound_ms": b_ms, "bound_by": b_by, "share_of_bound": b_ms / dev_ms}
        one, c3 = case["one"], case["cell"]
        print(f"K1 fused_tensor {name} D={D}{' (runtime D)' if D > 8 else ''}: max_abs_err "
              f"{err1:.3e} one / {errc:.3e} cell (tol {K1_TOL[name]:g}); " + "; ".join(
                  f"{label}: kernel {r['ms']:.4f} ms, device {r['device_ms']:.4f} ms, einsum "
                  f"{r['library_ms']:.4f} ms (device {r['library_device_ms']:.4f}), plain "
                  f"{r['plain_ms']:.4f} ms, bound {r['bound_ms'] * 1e3:.3f} us ({r['bound_by']}), "
                  f"{100 * r['share_of_bound']:.1f}% of it"
                  for label, r in (("one tensor", one), ("cell of 3, one launch", c3))))
        by_D.append(case)
        if (name, D) == ("complex128", 3):
            row = {"max_abs_err": errc, **{k: c3[k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "device_ms")},
                "shape": f"cell of 3, d=2, D={D}, {name}"}
        del cell, stacked, t
        torch.cuda.empty_cache()
    # K1's targets on this card: half its byte bound or better at D=7 and 8,
    # and no slower on the device than the einsum call at any D
    short = [f"{c['dtype']} D={c['D']} {label}" for c in by_D if c["D"] in (7, 8)
             for label in ("one", "cell") if c[label]["share_of_bound"] < 0.5]
    behind = [f"{c['dtype']} D={c['D']} {label}" for c in by_D for label in ("one", "cell")
              if c[label]["device_ms"] > c[label]["library_device_ms"]]
    print(f"K1 targets: >= 50% of the byte bound at D=7, 8: {'met' if not short else 'missed at ' + ', '.join(short)}; "
          f"no slower than einsum on the device: {'met' if not behind else 'missed at ' + ', '.join(behind)}")
    return by_D, row


def kernel_checks(torch, K, dev):
    """Phase 3: each kernel against its plain version, printed; returns the
    K1 cases, the rows measured at the main path's shapes and K2 by k."""
    gen = torch.Generator().manual_seed(0)
    by_D, k1_row = k1_checks(torch, K, dev, gen)
    rows = {"fused_tensor": k1_row}
    for name in ("complex64", "complex128"):
        dt = getattr(torch, name)
        for k in (1, 6, 18, 37, 72, 81, 130, 300, 504):
            check_chol_inv(torch, K, dev, gen, dt, name, k)
    # the resident/blocked switch (ops/kernels.CHOL_RESIDENT_MAX_K): both
    # variants side by side on either side of it, in every dtype K2 takes,
    # per call on CUDA events (host wrapper included) and on the device
    for name in ("float32", "float64", "complex64", "complex128"):
        dt = getattr(torch, name)
        edge = K.CHOL_RESIDENT_MAX_K
        for k in (16, 24, 32, 48):
            g = _spd(torch, gen, dt, k).to(dev)
            times = {}
            for variant in ("resident", "blocked"):
                fn = lambda: K.chol_inv_cuda(g, variant)  # noqa: E731
                times[variant] = (_ms(torch, fn, budget_ms=100.0), device_ms(torch, fn))
            print(f"K2 switch {name} k={k}: resident {times['resident'][0]:.4f} ms "
                  f"(device {times['resident'][1]:.4f}), blocked {times['blocked'][0]:.4f} ms "
                  f"(device {times['blocked'][1]:.4f}); the plan takes "
                  f"{'resident' if k <= edge else 'blocked'} (switch at k={edge})")
    table = k2_by_k(torch, K, dev)
    rows["chol_inv_tiled"] = table["complex64"]["8832"]["row"]
    return by_D, rows, table


def k2_by_k(torch, K, dev):
    """Phase 3, K2 by k (K2_TABLE): at each size every large-k variant (blocked;
    tiled at the plan's tile width, and from K2_BOTH_WIDTHS_MIN_K at both
    widths where they fit) held to the plain version at K2_TOL and timed in
    turns (each variant, then each again in reverse order, per call on CUDA
    events; on the device in the first turn), beside cuSOLVER's cholesky_ex +
    solve_triangular and the bound. Returns {dtype: {k: ...}}, with each
    size's row for the plan's own choice."""
    gen = torch.Generator(device=dev).manual_seed(4)
    out = {}
    for name, ks in K2_TABLE:
        dt = getattr(torch, name)
        out[name] = {}
        for k in ks:
            b = torch.randn((k, k), generator=gen, dtype=dt, device=dev)
            g = b @ b.mH + k * torch.eye(k, dtype=dt, device=dev)
            del b
            plan = K.chol_inv_plan(k, dt)
            widths = (64, 128) if k >= K2_BOTH_WIDTHS_MIN_K else (K.chol_inv_plan(k, dt, "tiled").tile,)
            cands = [("blocked", 0)] + [("tiled", t) for t in widths
                                        if not _refused(K.chol_inv_plan, k, dt, "tiled", t)]
            l_ref, w_ref = K.chol_inv_ref(g)
            errs = {}
            for variant, tile in cands:
                l, w = K.chol_inv_cuda(g, variant, tile)
                errs[(variant, tile)] = (
                    max(((l - l_ref).abs().max() / l_ref.abs().max()).item(),
                        ((w - w_ref).abs().max() / w_ref.abs().max()).item()),
                    max((l - l_ref).abs().max().item(), (w - w_ref).abs().max().item()))
                del l, w
            del l_ref, w_ref
            big = k >= 4000
            times, dev_times = {c: [] for c in cands}, {}
            for turn, c in enumerate(cands + cands[::-1]):   # in turns: A B C, C B A
                fn = lambda: K.chol_inv_cuda(g, *c)  # noqa: E731
                slow = big and c[0] == "blocked"
                times[c].append(_ms(torch, fn, budget_ms=100.0, rounds=2 if slow else 5))
                if turn < len(cands):
                    # device_ms queues its calls behind a sleep: keep them within
                    # the launch queue (~1000 launches) or the host waits on it
                    calls = max(1, min(2 if slow else 20, 512 // K.chol_inv_plan(k, dt, *c).launches))
                    dev_times[c] = device_ms(torch, fn, calls=calls)
            lib = lambda: _library(torch, g)  # noqa: E731
            lib_ms = _ms(torch, lib, budget_ms=100.0, rounds=3 if big else 5)
            plain_ms = _ms(torch, lambda: K.chol_inv_ref(g), budget_ms=100.0, rounds=3 if big else 5)
            b_ms, b_by = bound(*chol_inv_work(k, dt, torch))
            row = {}
            for (variant, tile), ts in times.items():
                ms, dev_ms = statistics.mean(ts), dev_times[(variant, tile)]
                label = variant if variant == "blocked" else f"tiled{tile}"
                row[label] = {"ms": ms, "device_ms": dev_ms, "turns_ms": ts,
                              "rel_err": errs[(variant, tile)][0], "max_abs_err": errs[(variant, tile)][1],
                              "share_of_bound": b_ms / dev_ms}
            own = row["blocked" if plan.variant == "blocked" else f"tiled{plan.tile}"]
            out[name][str(k)] = {"by_variant": row, "plan": f"{plan.variant}{plan.tile if plan.variant == 'tiled' else ''}",
                                 "library_ms": lib_ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                                 "row": {"max_abs_err": own["max_abs_err"], "ms": own["ms"],
                                         "device_ms": own["device_ms"], "plain_ms": plain_ms,
                                         "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
                                         "shape": f"k={k}, {name}"}}
            print(f"K2 by k {name} k={k} (the plan takes {out[name][str(k)]['plan']}; tiled from "
                  f"k={K.CHOL_TILED_MIN_K[dt]}, tile 128 from k={K.CHOL_WIDE_MIN_K} but in complex128): "
                  + "; ".join(f"{v} {r['ms']:.4f} ms (device {r['device_ms']:.4f}, turns "
                              f"{'/'.join(f'{t:.4f}' for t in r['turns_ms'])}), rel_err {r['rel_err']:.1e}, "
                              f"{100 * r['share_of_bound']:.1f}% of the bound" for v, r in row.items())
                  + f"; cuSOLVER {lib_ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
            bad = {v: r["rel_err"] for v, r in row.items() if not r["rel_err"] < K2_TOL[name]}
            if bad:
                raise AssertionError(f"K2 disagrees with its plain version at k={k} {name}: {bad}")
            del g
            torch.cuda.empty_cache()
    return out


def _refused(fn, *args) -> bool:
    try:
        fn(*args)
    except ValueError:
        return True
    return False


def _spd(torch, gen, dt, k):
    b = torch.randn((k, k), generator=gen, dtype=dt)
    return b @ b.mH + k * torch.eye(k, dtype=dt)


def _library(torch, g):
    """The one library call that computes K2's function: cuSOLVER's potrf
    (cholesky_ex, no error sync) and a triangular solve for L⁻¹."""
    l, _ = torch.linalg.cholesky_ex(g)
    eye = torch.eye(g.shape[-1], dtype=g.dtype, device=g.device)
    return l, torch.linalg.solve_triangular(l, eye, upper=False)


def check_chol_inv(torch, K, dev, gen, dt, name, k):
    g = _spd(torch, gen, dt, k).to(dev)
    variant = K.chol_inv_plan(k, dt).variant
    l, w = K.chol_inv_cuda(g)
    l_ref, w_ref = K.chol_inv_ref(g)
    err = max(((l - l_ref).abs().max() / l_ref.abs().max()).item(),
              ((w - w_ref).abs().max() / w_ref.abs().max()).item())
    abs_err = max((l - l_ref).abs().max().item(), (w - w_ref).abs().max().item())
    ms = _ms(torch, lambda: K.chol_inv_cuda(g))
    plain = _ms(torch, lambda: K.chol_inv_ref(g))
    library = _ms(torch, lambda: _library(torch, g))
    b_ms, b_by = bound(*chol_inv_work(k, dt, torch))
    print(f"K2 chol_inv {name} k={k} ({variant}): rel_err={err:.3e} (tol {K2_TOL[name]:g}) "
          f"kernel {ms:.4f} ms, plain {plain:.4f} ms, library {library:.4f} ms, "
          f"bound {b_ms * 1e3:.2f} us ({b_by})")
    if not err < K2_TOL[name]:
        raise AssertionError(f"K2 disagrees with its plain version: {err} at k={k} {name}")
    return {"variant": variant, "max_abs_err": abs_err, "rel_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library,
            "shape": f"k={k}, {name}", "g": g}


def k2_sizes(L, fn):
    """(fn(), {k: calls}): `fn` run with every gram K2 is given counted by
    its size k."""
    k_seen, chol_inv = {}, L.chol_inv

    def recording(g):
        k_seen[g.shape[-1]] = k_seen.get(g.shape[-1], 0) + 1
        return chol_inv(g)

    L.chol_inv = recording
    try:
        return fn(), k_seen
    finally:
        L.chol_inv = chol_inv


def k2_large(K, k_seen, dt) -> str:
    """The K2 counter of the variant the plan picks for the largest gram a
    path gave K2: the path's large-k variant."""
    return f"chol_inv_{K.chol_inv_plan(max(k_seen), dt).variant}"


def k2_share(k_seen, by_k, seconds) -> float:
    """K2's share of a call of `seconds` that gave it the grams k_seen
    ({k: calls}), from each size's kernel time (by_k[k]["ms"])."""
    return sum(n * by_k[k]["ms"] for k, n in k_seen.items()) / 1e3 / seconds


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


def profile_once(torch, dev, fn):
    """(wall seconds, device events) of one call of `fn` under
    torch.profiler, ending in a synchronise."""
    from torch.profiler import ProfilerActivity, profile

    # a profiler's first session in a process can miss device activity:
    # open one, and drop it, before the session whose numbers are kept
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(1024, device=dev).sum()
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return wall, device_events(torch, prof)


def device_summary(events, wall):
    """(busy share of `wall`, device seconds, device seconds by name)."""
    busy, end = 0.0, float("-inf")
    for _, a, b in sorted(events, key=lambda e: e[1]):
        if b > end:
            busy += b - max(a, end)
            end = b
    by_name = {}
    for name, a, b in events:
        by_name[name] = by_name.get(name, 0.0) + (b - a)
    device = sum(by_name.values())
    if not device > 0:
        raise AssertionError("torch.profiler saw no device time")
    return busy / 1e6 / wall, device / 1e6, by_name


def top_device(by_name, n=6):
    device = sum(by_name.values())
    return [(name[:60], round(100 * t / device, 1))
            for name, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:n]]


def profile_gram_sweep(torch, C, F, UnitCell, dev):
    """One BP sweep at the pin's BP size (N=3, χ=36, complex128) under
    KPBP_LINALG=gram, after one warm-up sweep: device busy share over the
    sweep and the kernels that take most of its device time."""
    cell = UnitCell.load(PIN_CELL, device=dev).astype(torch.complex128).force_zero_rotation()
    fused = C.fused_cells(cell)
    msgs = F._msgs_to_sites(C.initial_messages(3, cell.D, 36, dtype=torch.complex128, device=dev))
    sweep = F.bp_iteration(3, cell.D, 36, 36, None)
    os.environ["KPBP_LINALG"] = "gram"
    try:
        msgs, err = sweep(fused, msgs)
        float(err)
        torch.cuda.synchronize()
        wall, events = profile_once(torch, dev, lambda: float(sweep(fused, msgs)[1]))
    finally:
        os.environ.pop("KPBP_LINALG", None)
    busy, device, by_name = device_summary(events, wall)
    top = ", ".join(f"{name} {pct}%" for name, pct in top_device(by_name))
    k2 = sum(t for name, t in by_name.items() if "chol_inv" in name) / 1e6
    print(f"profile gram sweep N=3 chi=36 c128: {wall:.3f} s wall under the profiler; device "
          f"busy {100 * busy:.1f}% ({len(events)} device events, "
          f"{device:.3f} s of device time, K2 {100 * k2 / device:.1f}% of it); "
          f"top device time: {top}")


# the JAX bench's ITE configuration (bench.py, ite_steps_per_second)
ITE_N, ITE_CHI, ITE_CHI_MSG, ITE_DT, ITE_ALS = 2, 28, 18, 1e-3, 10
ITE_REPS = 3          # timed updates after one warm-up (cut from 5 for phase 14's time)
ITE_TOL = 1e-10       # card against CPU, complex128
# θ and |t'| go through ALS solves whose conditioning amplifies round-off
# (the reduced environment's rj⁻ᵀ, ROADMAP queue 3): there the gap is held to
# 100× what a 1e-15 relative change of the cell moves them on the CPU, and
# never above ITE_CAUSE_TOL
ITE_PERTURB, ITE_CAUSE_TOL = 1e-15, 1e-8
ITE_LINALG = {"default": None, "gram": "gram"}


def _with_env(env, fn):
    """fn() with the environment variables `env` set, then removed."""
    os.environ.update(env)
    try:
        return fn()
    finally:
        for k in env:
            os.environ.pop(k, None)


def _with_linalg(mode, fn):
    return _with_env({"KPBP_LINALG": mode} if mode else {}, fn)


def ite_inputs(torch, C, F, UnitCell, robust_bp, BPConfig, hamiltonians, dev):
    """The pin cell (D=3) and its BP messages at N=2, χ_msg=18 in complex128
    on the card, and the AFM Heisenberg h."""
    cell = UnitCell.load(PIN_CELL, device=dev).astype(torch.complex128).force_zero_rotation()
    t0 = time.perf_counter()
    msgs, st = robust_bp(cell, None, BPConfig(trunc_dim=ITE_CHI_MSG, dtype=torch.complex128), ITE_N)
    print(f"ITE inputs: BP on the pin cell at N={ITE_N}, chi_msg={ITE_CHI_MSG}, c128: "
          f"{st.iterations} iterations, error {st.final_error:.3e}, "
          f"{time.perf_counter() - t0:.2f} s")
    return cell, F._msgs_to_sites(msgs), hamiltonians.heisenberg_afm()


def ite_update_fn(torch, F, edge, cell, sites, h, dtype, dev):
    """One edge update as ite_update_edge runs it: the update, then its
    energy and health read to the host in one sync."""
    cells = tuple(t.to(dtype) for t in (cell.A, cell.B, cell.C))
    sites = {s: tuple(x.to(dtype) for x in ss) for s, ss in sites.items()}
    h_t = torch.as_tensor(h, dtype=dtype, device=dev)
    upd = F.edge_update(ITE_N, cell.D, ITE_CHI, ITE_CHI_MSG, edge, ITE_ALS, True)

    def run():
        new, energy, herm, sum_eig, neg = upd(cells, sites, h_t, ITE_DT)
        return new, torch.stack([energy, herm, sum_eig.real, neg]).tolist()

    return run


def time_ite_updates(torch, K, L, F, edge, inputs, dev):
    """Seconds per edge update (median of ITE_REPS after one warm-up),
    launches and shifted eigh retries (ops/linalg._eigh_shifted) per update and
    a profile of one update, for each dtype and linear-algebra path. Returns
    the results and the launches of the run."""
    cell, sites, h = inputs
    out, launches = {}, {n: 0 for n in K.KERNELS}
    for name in ("complex64", "complex128"):
        for mode, env in ITE_LINALG.items():
            fn = ite_update_fn(torch, F, edge, cell, sites, h, getattr(torch, name), dev)
            _with_linalg(env, fn)
            secs = []
            K.reset_launch_counts()
            L.reset_eigh_retries()
            for _ in range(ITE_REPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _, scalars = _with_linalg(env, fn)
                secs.append(time.perf_counter() - t0)
            per = {n: c / ITE_REPS for n, c in K.launch_counts().items()}
            retries = {site: {n: c / ITE_REPS for n, c in by_n.items()}
                       for site, by_n in L.eigh_retries().items()}
            for n in launches:
                launches[n] += K.launch_counts()[n]
            wall, events = _with_linalg(env, lambda: profile_once(torch, dev, fn))
            busy, device, by_name = device_summary(events, wall)
            med = statistics.median(secs)
            out.setdefault(name, {})[mode] = {
                "s_per_update": med, "steps_per_s": 1 / med, "s_all": secs,
                "launches_per_update": per, "eigh_retries_per_update": retries,
                "energy": scalars[0],
                "device_busy": busy, "device_s": device, "profiled_wall_s": wall,
                "device_events": len(events), "top_device": top_device(by_name)}
            print(f"ITE edge update {name} {mode}: median {med * 1e3:.1f} ms per update "
                  f"({1 / med:.2f} steps/s) over {ITE_REPS} after one warm-up; launches per "
                  f"update {json.dumps(per)}; shifted eigh retries per update (by call site and size) "
                  f"{json.dumps(retries)}; energy {scalars[0]:.10f}; profiled: "
                  f"{wall * 1e3:.1f} ms wall, device busy {100 * busy:.1f}%, {len(events)} "
                  f"device events; top device time: "
                  + ", ".join(f"{n} {pct}%" for n, pct in top_device(by_name)))
    return out, launches


def bond_phase_move(torch, IK, E, edge, cell, sites, h) -> float:
    """How far a phase gauge on the updated bond moves θ of the complex128
    update on the CPU, relative to θ's largest entry. The phase leaves the
    state as it is; the update's θ moves because the reference's
    reduced_env applies rj⁻ᵀ where rj⁻¹ belongs (ROADMAP queue 3)."""
    t1, t2, env, _ = E.edge_environment_sites((cell.A, cell.B, cell.C), sites, ITE_N, ITE_CHI,
                                              ITE_CHI_MSG, edge)
    gen = torch.Generator().manual_seed(0)
    ph = torch.exp(2j * torch.pi * torch.rand(t1.shape[1], generator=gen, dtype=torch.float64))
    gate = IK.gate_from_hamiltonian(torch.as_tensor(h, dtype=torch.complex128), ITE_DT)
    thetas = []
    for a, b in ((t1, t2), (t1 * ph[None, :, None, None, None],
                            t2 * ph.conj()[None, :, None, None, None])):
        n1, n2, _ = IK.apply_gate(gate, cell.D, a, b, env, als_iters=ITE_ALS)
        th = torch.einsum("deabc,fexyz->dabcfxyz", n1, n2)
        thetas.append(th / th.abs().max())
    return (thetas[0] - thetas[1]).abs().max().item()


def ite_card_vs_cpu(torch, F, E, IK, edge, inputs, dev):
    """The complex128 update on the card and on the CPU (plain kernel
    versions), default and gram: energy and health to ITE_TOL; θ across the
    shared bond (relative to its largest entry) and |t'| element by element
    to ITE_TOL, or, where the CPU update itself moves them by more than
    ITE_TOL/100 under a ITE_PERTURB change of the cell (a measured cause),
    to 100× that move and ITE_CAUSE_TOL."""
    cell, sites, h = inputs
    cpu_cell = cell.to_device("cpu")
    gen = torch.Generator().manual_seed(0)
    nudged = cpu_cell._map(lambda t: t + ITE_PERTURB * t.abs().max() * torch.randn(
        t.shape, generator=gen, dtype=t.real.dtype))
    cpu_sites = {s: tuple(x.cpu() for x in ss) for s, ss in sites.items()}
    _, _, _, (p1, p2) = E.edge_environment_sites((cell.A, cell.B, cell.C), sites, ITE_N,
                                                 ITE_CHI, ITE_CHI_MSG, edge)
    f1, f2 = int(edge.first), int(edge.second)

    def gaps(a, b):
        (a_new, a_s), (b_new, b_s) = a, b
        theta = [torch.tensordot(n[f1].cpu(), n[f2].cpu(), dims=([1 + p1[0]], [1 + p2[0]]))
                 for n in (a_new, b_new)]
        return {"scalars": max(abs(x - y) for x, y in zip(a_s, b_s)),
                "theta": ((theta[0] - theta[1]).abs().max() / theta[1].abs().max()).item(),
                "abs_t": max((a_new[f].cpu().abs() - b_new[f].cpu().abs()).abs().max().item()
                             for f in (f1, f2))}

    out = {}
    for mode, env in ITE_LINALG.items():
        card, cpu, moved = (
            _with_linalg(env, ite_update_fn(torch, F, edge, c, ss, h, torch.complex128, d))
            for c, ss, d in ((cell, sites, dev), (cpu_cell, cpu_sites, "cpu"),
                             (nudged, cpu_sites, "cpu")))
        gap, cause = gaps(card, cpu), gaps(moved, cpu)
        print(f"ITE card vs CPU c128 {mode}: energy {card[1][0]!r} vs {cpu[1][0]!r}; max gaps "
              f"{json.dumps(gap)} (tol {ITE_TOL:g}); a {ITE_PERTURB:g} change of the cell "
              f"moves the CPU update by {json.dumps(cause)}")
        for key in ("theta", "abs_t"):
            if gap[key] >= ITE_TOL and cause[key] >= ITE_TOL / 100:
                bar = min(100 * cause[key], ITE_CAUSE_TOL)
                if not gap[key] < bar:
                    raise AssertionError(f"ITE card vs CPU {mode}: {key} gap {gap[key]} above "
                                         f"{bar} (100x its measured cause {cause[key]})")
                print(f"ITE card vs CPU c128 {mode}: {key} misses {ITE_TOL:g} by {gap[key]:.3e}; "
                      f"cause: the update's conditioning, which moves it by {cause[key]:.3e} "
                      f"under a {ITE_PERTURB:g} change of the cell; held to {bar:.3e}")
            elif not gap[key] < ITE_TOL:
                raise AssertionError(f"ITE card vs CPU {mode}: {key} gap {gap[key]}")
        if not gap["scalars"] < ITE_TOL:
            raise AssertionError(f"ITE card vs CPU {mode}: energy/health gap {gap['scalars']}")
        out[mode] = {"gaps": gap, "cpu_moved_by_perturbation": cause}
    out["bond_phase_moves_theta"] = bond_phase_move(torch, IK, E, edge, cpu_cell, cpu_sites, h)
    print(f"ITE c128 on the CPU: a phase gauge on the updated bond moves the update's theta by "
          f"{out['bond_phase_moves_theta']:.3e} of its largest entry (the reference's "
          f"reduced_env is not covariant under it)")
    return out


# the short full_ite's BP stop (BPConfig's default 1e-10; its measurements
# stop at half of it): cut for phase 14's time, as its energy falls by
# 2.2e-2 over the two segments (an H100 took 47.8 s at 1e-10, 30.3 s at 1e-6)
FULL_ITE_BP_STOP = 1e-6


def short_full_ite(torch, I, BPConfig, hamiltonians, dev):
    """full_ite from a seeded random D=3 cell on the card, complex128: two
    segments at dt=0.1, one mode each, BP once per segment (to
    FULL_ITE_BP_STOP), measured after each. It must end with no ITEError
    and a lower energy than it began. Returns its result and its tracker."""
    cfg = I.ITEConfig(hamiltonian=hamiltonians.heisenberg_afm, time_steps=[0.1, 0.1],
                      num_mode_repetitions_per_segment=1, bp_every_edge=False, seed=0)
    t0 = time.perf_counter()
    _, _, tr = I.full_ite(None, cfg, N=ITE_N, D=3, chi=ITE_CHI,
                          bp_config=BPConfig(trunc_dim=ITE_CHI_MSG, msg_diff_terminate=FULL_ITE_BP_STOP),
                          device=dev)
    wall = time.perf_counter() - t0
    res = {"energies": tr.energies, "segment_s": [st.duration for st in tr.stats],
           "errors": tr.error_count, "wall_s": wall}
    print(f"ITE full_ite N=2 D=3 chi=28 c128, 2 segments at dt=0.1, BP stop {FULL_ITE_BP_STOP:g}: "
          f"energies {tr.energies}, seconds per segment {res['segment_s']}, {tr.error_count} ITE "
          f"errors, {wall:.1f} s")
    if tr.error_count or len(tr.energies) != 2 or not tr.energies[-1] < tr.energies[0]:
        raise AssertionError(f"the short full_ite did not lower the energy cleanly: {res}")
    return res, tr


# single-layer swallowing at the production χ of tools/large_d_demo.py, the
# D at which the JAX package switches to it: D=6, N=2, χ_msg = 2D² = 72,
# χ = 2D²+10 = 82
SL_D, SL_N, SL_CHI_MSG, SL_CHI = 6, 2, 72, 82
SL_ID_TOL = 1e-9       # test_single_layer_identical_under_truncation's bar
# the sketch's D=6 point of tools/sketch_rank_curve.py, against a χ=72
# double-layer oracle, held as test_gram_split_message_quality_under_truncation
SL_SKETCH_CHI, SL_ORACLE_CHI, SL_SKETCH_RATIO = 24, 72, 1.4
SL_CARD_TOL = 1e-9     # single-layer messages, card against the CPU port, c128
SL_SWEEPS = 1          # timed sweeps after one warm-up (cut from 2 for phase 12's time)
SL_NO_LIMIT = "1e15"   # KPBP_BLOB_LIMIT above every blob: the direct path only


def _peak_gb(torch) -> float:
    return torch.cuda.max_memory_allocated() / 1e9


def _fresh_peak(torch):
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def sl_message_identity(torch, C, M, UnitCell, BlockSide, dev):
    """The pin cell padded to D=6, uniform messages, the message toward U
    at χ_msg=72, χ=82 in complex128: double-layer against single-layer with
    every swallow through its blob. Returns the distance and the times."""
    c128 = torch.complex128
    gen = torch.Generator(device=dev).manual_seed(0)
    cell = (UnitCell.load(PIN_CELL, device=dev).astype(c128).force_zero_rotation()
            .pad_to(SL_D, generator=gen))
    msgs = C.initial_messages(SL_N, SL_D, SL_CHI_MSG, dtype=c128, device=dev)
    out = {}
    for label, fn in (("double", lambda: C.outgoing_message(
                          cell, msgs, SL_N, SL_D, SL_CHI, SL_CHI_MSG, BlockSide.U)),
                      ("single_direct", lambda: _with_env({"KPBP_BLOB_LIMIT": SL_NO_LIMIT},
                          lambda: C.outgoing_message_single(
                              cell, msgs, SL_N, SL_D, SL_CHI, SL_CHI_MSG, BlockSide.U)))):
        _fresh_peak(torch)
        t0 = time.perf_counter()
        m = fn()
        torch.cuda.synchronize()
        out[label] = {"s": time.perf_counter() - t0, "peak_gb": _peak_gb(torch), "msg": m}
    dist = float(M.distance(out["double"]["msg"], out["single_direct"]["msg"]))
    res = {"distance": dist, **{k: {"s": v["s"], "peak_gb": v["peak_gb"]} for k, v in out.items()}}
    print(f"single-layer identity D={SL_D} N={SL_N} chi_msg={SL_CHI_MSG} chi={SL_CHI} c128 (pin cell "
          f"padded to D={SL_D}, uniform messages, toward U): distance double vs single direct "
          f"{dist:.3e} (tol {SL_ID_TOL:g}); double {res['double']['s']:.2f} s, peak "
          f"{res['double']['peak_gb']:.2f} GB; single direct {res['single_direct']['s']:.2f} s, "
          f"peak {res['single_direct']['peak_gb']:.2f} GB")
    if not dist < SL_ID_TOL:
        raise AssertionError(f"single-layer message differs from double-layer by {dist}")
    return res


def sl_sketch_quality(torch, C, M, CT, UnitCell, BlockSide, dev):
    """D=6, χ=24, a seeded random cell and random messages, c128: the
    message toward U with every eligible swallow sketched (KPBP_BLOB_LIMIT=1)
    against the direct single-layer one, both measured from a χ=72
    double-layer oracle."""
    c128 = torch.complex128
    cell = UnitCell.random(2, SL_D, torch.Generator().manual_seed(1)).to_device(dev)
    msgs = C.initial_messages(SL_N, SL_D, SL_SKETCH_CHI, model="random",
                              generator=torch.Generator().manual_seed(2), dtype=c128, device=dev)
    chi = SL_SKETCH_CHI
    t0 = time.perf_counter()
    oracle = C.outgoing_message(cell, msgs, SL_N, SL_D, SL_ORACLE_CHI, chi, BlockSide.U)
    direct = C.outgoing_message_single(cell, msgs, SL_N, SL_D, chi, chi, BlockSide.U)
    CT.reset_swallow_counts()
    sketch = _with_env({"KPBP_BLOB_LIMIT": "1"}, lambda: C.outgoing_message_single(
        cell, msgs, SL_N, SL_D, chi, chi, BlockSide.U))
    swallows = CT.swallow_counts()
    d_direct, d_sketch = (float(M.distance(m, oracle)) for m in (direct, sketch))
    bar = max(SL_SKETCH_RATIO * d_direct, d_direct + 1e-9)
    res = {"d_direct": d_direct, "d_sketch": d_sketch, "ratio": d_sketch / d_direct, "bar": bar,
           "swallows": swallows, "s": time.perf_counter() - t0}
    print(f"single-layer sketch D={SL_D} chi={chi} c128 (random cell and messages, toward U, "
          f"oracle double-layer at chi={SL_ORACLE_CHI}): d(direct) {d_direct:.4e}, d(sketch) "
          f"{d_sketch:.4e}, ratio {res['ratio']:.3f} (bar {bar:.4e}: {SL_SKETCH_RATIO}x or +1e-9); "
          f"swallows {json.dumps(swallows)}; {res['s']:.2f} s")
    if swallows["sketched"] < 1:
        raise AssertionError("KPBP_BLOB_LIMIT=1 sketched no swallow")
    if not d_sketch < bar:
        raise AssertionError(f"sketched message {d_sketch} from the oracle, above {bar}")
    return res


def _frontier_to(CT, fr, dev):
    """A copy of frontier `fr` on `dev`, gauge markers and scale included."""
    out = CT.Frontier(fr.chi)
    out.sites, out.lc, out.rc = [x.to(dev) for x in fr.sites], fr.lc, fr.rc
    if fr.logscale is not None:
        out.logscale, out.mantissa = fr.logscale.to(dev), fr.mantissa.to(dev)
    return out


def _frontier_distance(M, a, b) -> float:
    """Distance of two frontiers' states (scale-invariant, gauge-free)."""
    if not a.sites:
        return 0.0
    return float(M.distance(*(M.MPS(tuple(x.cpu() for x in f.sites), f.logscale.cpu()) for f in (a, b))))


def sl_sketch_walk(torch, M, CT, plan, fetch_cpu, fetch_card, dev):
    """One single-layer plan, step by step, on the CPU and on the card at
    once. "forced": before every step the card takes a copy of the CPU's
    frontier, so both apply the step to the same tensors, and the two states
    after it are compared; "free": the card runs on its own frontier, as
    outgoing_message_single does. Returns the largest forced distance, the
    free frontiers' final distance, the number of sketched swallows and, if
    the free frontiers part (SL_CARD_TOL or more), the step where they do,
    its swallow, their distance before it and the largest difference of a
    site tensor before it, relative to that site's largest entry (the same
    state in two gauges shows a large one)."""
    cpu, free = CT.Frontier(plan.chi), CT.Frontier(plan.chi)
    forced_max, parted, before, sketched = 0.0, None, 0.0, 0
    for i, step in enumerate(plan.steps):
        site_diff = max((((a - b.cpu()).abs().max() / a.abs().max()).item()
                         if a.shape == b.shape else float("inf")
                         for a, b in zip(cpu.sites, free.sites)), default=0.0)
        forced = _frontier_to(CT, cpu, dev)
        CT.reset_swallow_counts()
        CT.apply_step(cpu, plan, step, CT._fetch_raw(plan, step, fetch_cpu))
        kind = next((k for k, v in CT.swallow_counts().items() if v), "first tensor")
        sketched += kind == "sketched"
        CT.apply_step(forced, plan, step, CT._fetch_raw(plan, step, fetch_card))
        CT.apply_step(free, plan, step, CT._fetch_raw(plan, step, fetch_card))
        forced_max = max(forced_max, _frontier_distance(M, cpu, forced))
        d_free = _frontier_distance(M, cpu, free)
        if parted is None and not d_free < SL_CARD_TOL:
            parted = {"step": i, "swallow": kind, "distance_before": before,
                      "site_difference_before": site_diff, "distance_after": d_free}
        before = d_free
    return {"forced_max": forced_max, "free_final": before, "sketched": sketched, "parted": parted}


def sl_card_vs_cpu(torch, C, M, CT, UnitCell, BlockSide, dev):
    """Single-layer messages at D=3, N=2, χ=12, c128, from a seeded random
    cell and random messages, toward every side, on the card and on the
    CPU: every swallow direct, and every eligible one sketched at full
    retained rank, where the sketch is exact; both must agree to
    SL_CARD_TOL. Then sketched at the default rank 2χ+32, the same factors on
    both (drawn on the CPU). Such a sketch depends on the frontier's bond
    gauge, which QR and SVD fix only up to rounding where a bond spectrum is
    degenerate, so the card's and the CPU's messages may differ: each side's
    plan is walked step by step (sl_sketch_walk), every step on the card,
    given the CPU's frontier, is held to the CPU's result within
    SL_CARD_TOL, and free-running frontiers that part must part first at a
    sketched swallow."""
    D, chi = 3, 12
    cell = UnitCell.random(2, D, torch.Generator().manual_seed(3))
    msgs = C.initial_messages(SL_N, D, chi, model="random", generator=torch.Generator().manual_seed(4))
    cell_d = cell.to_device(dev)
    msgs_d = {s: M.MPS(tuple(x.to(dev) for x in m.sites), m.logscale.to(dev)) for s, m in msgs.items()}

    res = {}
    for label, env in (("direct", {"KPBP_BLOB_LIMIT": SL_NO_LIMIT}),
                       ("sketched, full rank", {"KPBP_BLOB_LIMIT": "1", "KPBP_SKETCH_RANK": "1000000000"})):
        CT.reset_swallow_counts()
        gaps = {}
        for toward in BlockSide:
            card, cpu = (_with_env(env, lambda: C.outgoing_message_single(c, m, SL_N, D, chi, chi, toward))
                         for c, m in ((cell_d, msgs_d), (cell, msgs)))
            card = M.MPS(tuple(x.cpu() for x in card.sites), card.logscale.cpu())
            gaps[toward.name] = float(M.distance(card, cpu))
        if label != "direct" and CT.swallow_counts()["sketched"] < 1:
            raise AssertionError(f"the card-vs-CPU check ({label}) sketched no swallow")
        res[label] = {"distances": gaps}
        print(f"single-layer card vs CPU D={D} N={SL_N} chi={chi} c128, {label}: distances "
              f"{json.dumps(gaps)} (tol {SL_CARD_TOL:g})")
        if not max(gaps.values()) < SL_CARD_TOL:
            raise AssertionError(f"single-layer messages ({label}) on the card differ from the CPU: {gaps}")

    walks = {}
    for toward in BlockSide:
        plan = C.single_layer_plan(C.to_message_plan(SL_N, D, chi, chi, int(toward)))
        fetches = [C._make_fetch(None, {int(s): tuple(m.sites) for s, m in ms.items() if int(s) != int(toward)},
                                 kets=(c.A, c.B, c.C)) for c, ms in ((cell, msgs), (cell_d, msgs_d))]
        walks[toward.name] = _with_env({"KPBP_BLOB_LIMIT": "1"},
                                       lambda: sl_sketch_walk(torch, M, CT, plan, *fetches, dev))
    res["sketched"] = walks
    print(f"single-layer card vs CPU D={D} N={SL_N} chi={chi} c128, sketched, walked step by step "
          f"(each step on the card from the CPU's frontier, tol {SL_CARD_TOL:g}; where the free-running "
          f"frontiers part): " + "; ".join(
              f"{s}: {w['sketched']} sketched, forced max {w['forced_max']:.2e}, final {w['free_final']:.2e}" + (
                  "" if w["parted"] is None else
                  f", part at step {w['parted']['step']} ({w['parted']['swallow']}) from "
                  f"{w['parted']['distance_before']:.1e} with sites {w['parted']['site_difference_before']:.2f} "
                  f"apart to {w['parted']['distance_after']:.2e}")
              for s, w in walks.items()))
    for s, w in walks.items():
        if w["sketched"] < 1 or not w["forced_max"] < SL_CARD_TOL:
            raise AssertionError(f"the sketched walk toward {s} sketched nothing, or a step on the card "
                                 f"differs from the CPU's on the same frontier: {w}")
        if w["parted"] is not None and w["parted"]["swallow"] != "sketched":
            raise AssertionError(f"the sketched messages toward {s} part at a {w['parted']['swallow']} "
                                 f"step, not at a sketched swallow: {w}")
    return res


def sl_production(torch, K, L, C, F, CT, BP, UnitCell, BlockSide, UpdateEdge, hamiltonians, dev):
    """The production configuration in complex64 with the default linear
    algebra: BP (one warm-up sweep, SL_SWEEPS timed) at D=6, N=2, χ_msg=72,
    χ=82 from a seeded random cell and uniform messages, single-layer by the
    auto switch; a profile of one per-side call; one ITE edge update (A,B)
    at χ_env=82 on the messages; then one per-side call under
    KPBP_LINALG=gram. Launch counts are zeroed before BP and read after the
    gram call."""
    c64 = torch.complex64
    cfg = BP.BPConfig(trunc_dim=SL_CHI_MSG, bubble_trunc_dim=SL_CHI, max_iterations=1 + SL_SWEEPS,
                      msg_diff_terminate=0.0, dtype=c64)
    auto = BP.bp_mode(cfg, SL_D) == "single"
    print(f"single-layer production D={SL_D}: BPConfig(single_layer=None) picks "
          f"{'single' if auto else 'double'}-layer (the auto switch turns it on from D=6)")
    if not auto:
        raise AssertionError("the auto switch did not pick single-layer at D=6")
    cell = UnitCell.random(2, SL_D, torch.Generator().manual_seed(0), dtype=c64).to_device(dev)
    kets = (cell.A, cell.B, cell.C)

    # time each sweep of the BP run: wrap the sweep that belief_propagation builds
    bp_iteration, sweeps = F.bp_iteration, []

    def timed_iteration(*args, **kw):
        run = bp_iteration(*args, **kw)

        def timed(tensors, msg_sites):
            if not kw.get("single") or any(a is not b for a, b in zip(tensors, kets)):
                raise AssertionError("BP did not hand the sweep the raw kets, single-layer")
            torch.cuda.synchronize()
            CT.reset_swallow_counts()
            t0 = time.perf_counter()
            out = run(tensors, msg_sites)
            float(out[1])
            sweeps.append({"s": time.perf_counter() - t0, "swallows": CT.swallow_counts()})
            return out

        return timed

    K.reset_launch_counts()
    L.reset_eigh_retries()
    _fresh_peak(torch)
    F.bp_iteration = timed_iteration
    try:
        msgs, stats = BP.belief_propagation(cell, None, cfg, SL_N)
    finally:
        F.bp_iteration = bp_iteration
    torch.cuda.synchronize()
    bp_peak = _peak_gb(torch)
    sites = F._msgs_to_sites(msgs)
    finite = all(torch.isfinite(x).all().item() for ss in sites.values() for x in ss)
    timed_s = [sw["s"] for sw in sweeps[1:]]
    res = {"config": {"D": SL_D, "N": SL_N, "chi_msg": SL_CHI_MSG, "chi": SL_CHI, "dtype": "complex64",
                      "single_layer": auto},
           "sweep_s": [sw["s"] for sw in sweeps], "s_per_sweep": statistics.median(timed_s),
           "swallows_per_sweep": sweeps[-1]["swallows"], "bp_errors": stats.error_history,
           "bp_peak_gb": bp_peak}
    print(f"single-layer BP D={SL_D} N={SL_N} chi_msg={SL_CHI_MSG} chi={SL_CHI} c64: sweeps "
          f"{', '.join(f'{x:.2f}' for x in res['sweep_s'])} s (first a warm-up); "
          f"{res['s_per_sweep']:.2f} s per sweep; peak device memory {bp_peak:.2f} GB; swallows per "
          f"sweep {json.dumps(res['swallows_per_sweep'])}; distances {stats.error_history}")
    if len(sweeps) != 1 + SL_SWEEPS or not finite or not all(e == e for e in stats.error_history):
        raise AssertionError(f"the D={SL_D} BP run did not give finite messages: {res}")

    side = lambda: F._one_side_update(kets, sites, SL_N, SL_D, SL_CHI, SL_CHI_MSG,  # noqa: E731
                                      int(BlockSide.U), None, True)
    wall, events = profile_once(torch, dev, side)
    busy, device, by_name = device_summary(events, wall)
    res["per_side_profile"] = {"wall_s": wall, "device_busy": busy, "device_s": device,
                               "device_events": len(events), "top_device": top_device(by_name)}
    print(f"single-layer per-side call, profiled: {wall:.2f} s wall, device busy {100 * busy:.1f}%, "
          f"{device:.3f} s of device time, {len(events)} device events; top device time: "
          + ", ".join(f"{n} {pct}%" for n, pct in top_device(by_name)))

    h = torch.as_tensor(hamiltonians.heisenberg_afm(), dtype=c64, device=dev)
    edge = UpdateEdge.all_options()[0]  # (A,B)
    upd = F.edge_update(SL_N, SL_D, SL_CHI, SL_CHI_MSG, edge, ITE_ALS, True)
    before = K.launch_counts()["fused_tensor"]
    _fresh_peak(torch)
    t0 = time.perf_counter()
    new, energy, herm, sum_eig, neg = upd(kets, sites, h, ITE_DT)
    scalars = torch.stack([energy, herm, sum_eig.real, neg]).tolist()
    ite_s = time.perf_counter() - t0
    k1 = K.launch_counts()["fused_tensor"] - before
    res["edge_update"] = {"s": ite_s, "k1_launches": k1, "energy": scalars[0], "herm": scalars[1],
                          "sum_eig": scalars[2], "negativity": scalars[3], "peak_gb": _peak_gb(torch),
                          "eigh_retries": L.eigh_retries()}
    print(f"single-layer ITE edge update D={SL_D} chi_env={SL_CHI} edge {edge} c64 on the BP "
          f"messages: {ite_s:.2f} s; K1 launches {k1}; energy {scalars[0]:.8f}, hermiticity "
          f"{scalars[1]:.2e}, eigenvalue sum {scalars[2]:.6f}, negativity {scalars[3]:.2e}; peak "
          f"{res['edge_update']['peak_gb']:.2f} GB; shifted eigh retries by call site "
          f"{json.dumps(L.eigh_retries())}")
    if k1 != 1 or not all(torch.isfinite(t).all().item() for t in new) or not abs(scalars[2] - 1) < C64_TOL:
        raise AssertionError(f"the D={SL_D} edge update failed: {res['edge_update']}")

    before = K.launch_counts()
    t0 = time.perf_counter()
    _, k_seen = k2_sizes(L, lambda: _with_env({"KPBP_LINALG": "gram"},
                                              lambda: [x.sum().item() for x in side()[0][:1]]))
    gram_s = time.perf_counter() - t0
    counts = K.launch_counts()
    gram = {n: counts[n] - before[n] for n in counts}
    large = k2_large(K, k_seen, c64)
    if gram[large] < 1:
        raise AssertionError(f"K2's large-k variant {large} was not launched on the single-layer path under gram")
    # K2 at every size that call gave it, in its dtype, against the plain version
    gen = torch.Generator().manual_seed(2)
    by_k = {k: check_chol_inv(torch, K, dev, gen, c64, "complex64", k) for k in sorted(k_seen)}
    k2 = {str(k): {"calls": k_seen[k], "variant": r["variant"], "max_abs_err": r["max_abs_err"],
                   "ms": r["ms"], "plain_ms": r["plain_ms"], "library_ms": r["library_ms"]}
          for k, r in by_k.items()}
    share = k2_share(k_seen, by_k, gram_s)
    res["gram_per_side"] = {"s": gram_s, "launches": gram, "k2_by_size": k2, "k2_share": share}
    print(f"single-layer per-side call under KPBP_LINALG=gram: {gram_s:.2f} s, K2 {100 * share:.1f}% of it "
          f"(calls × kernel ms over its sizes); launches {json.dumps(gram)}; "
          f"K2 sizes k:calls {json.dumps(dict(sorted(k_seen.items())))}, each held to its plain version "
          f"in complex64 (tol {K2_TOL['complex64']:g}): largest rel_err "
          f"{max(r['rel_err'] for r in by_k.values()):.3e}")
    return res, counts


# the warm start (phase 10): the simple update of tests/assets/su_q0_D3.pkl
# against the JAX package's (tools/make_su_pin.py), measured on growing blocks
SU_PIN_CELL = os.path.join(REPO, "tests", "assets", "su_q0_D3.pkl")
SU_PIN_GOLD = os.path.join(REPO, "tests", "assets", "su_q0_D3.json")
SU_TOL = 1e-8          # λ spectra and block energies, card against the JAX package
SU_CAUSE_TOL = 1e-6    # ceiling when a measured cause explains a larger gap
SU_PERTURB = 1e-15     # the change of the seed whose effect on the CPU is the cause
# the ladder the pin holds: the default one less its 200 sweeps at dt=0.1,
# which from this seed do not settle and amplify round-off to O(0.1) in the
# JAX package itself (su_q0_D3.json "default_ladder")
SU_LADDER = [0.01] * 200 + [1e-3] * 200 + [1e-4] * 100
PUBLISHED_SU = {3: -0.41786, 6: -0.43188}   # BASELINE.md
# the block measurements held against su_q0_D3.json's rows, N=2 with the
# default linear algebra and N=3 under KPBP_LINALG=gram: on an H100 the
# N=3 row took 75.4 s by default and 19.8 s under gram, 9 BP sweeps either
# way (the default path at N=3 stays held on the pin, phase 4)
SU_BLOCK_NS = (2, 3)
SU_BLOCK_GRAM = (3,)
# SU at the published records' D=6: the ladder the card runs
SU6_LADDER = [0.1] * 5 + [0.01] * 3   # cut from 10 + 5 for phase 14's time
SANDWICH_TOL = 1e-10   # sandwich expectations, card against the CPU port, c128
ARB_TOL = 1e-10        # an arbitrary block against the unit-cell path or the JAX package
# a block of 21 independent kets (D=2, N=2) and the JAX package's measurement
# of it, BP included (tools/make_warm_start_cases.py)
ARB_CASE = os.path.join(REPO, "tests", "assets", "warm_start_D2.npz")
PMPS_TOL = 1e-10


def fused_operator_library(torch, ops, t):
    """The one PyTorch call that computes K1's operator form from its inputs
    (ops [n, d, d], t [d, D,D,D,D]): a three-operand einsum, reshaped."""
    n, D = ops.shape[0], t.shape[1]
    return torch.einsum("fxs,sabce,xABCE->faAbBcCeE", ops, t, t.conj()).reshape((n,) + (D * D,) * 4)


def k1_operator_checks(torch, K, dev, gen, pauli):
    """Phase 10.1: K1's operator form (a separate bra), the sandwiches of
    x, y and z at one site in one launch, against its plain version at
    D=2…8 in complex64 and complex128, timed beside the einsum. Returns the
    cases and the row at the main path's shape (D=3, complex128)."""
    cases, row = [], None
    for name in ("complex64", "complex128"):
        dt = getattr(torch, name)
        ops = torch.stack([torch.as_tensor(pauli.ALL[k], dtype=dt) for k in "xyz"]).to(dev)
        for D in range(2, 9):
            t = torch.randn((2, D, D, D, D), generator=gen, dtype=dt)
            t = (t / torch.linalg.vector_norm(t)).to(dev)
            fn = lambda: K.fused_tensors_with_operator_cuda(t, ops)  # noqa: E731
            plain = lambda: [K.fused_tensor_with_operator_ref(t, o) for o in ops]  # noqa: E731
            lib = lambda: fused_operator_library(torch, ops, t)  # noqa: E731
            err = max((g - w).abs().max().item() for g, w in zip(fn(), plain()))
            if not err < K1_TOL[name]:
                raise AssertionError(f"K1's operator form disagrees with its plain version: {err} "
                                     f"at D={D} {name}")
            # t read once (kets and bra come from it), three D⁸ outputs
            # written; d² multiply-adds per ket element besides K1's own
            flops, nbytes = fused_tensor_work(3, t)
            b_ms, b_by = bound(flops + 3 * 8 * t.shape[0] * t.numel(),
                               nbytes - 2 * t.numel() * t.element_size() + ops.numel() * ops.element_size())
            dev_ms = device_ms(torch, fn)
            case = {"dtype": name, "D": D, "max_abs_err": err, "ms": _ms(torch, fn, budget_ms=100.0),
                    "device_ms": dev_ms, "plain_ms": _ms(torch, plain, budget_ms=100.0),
                    "library_ms": _ms(torch, lib, budget_ms=100.0),
                    # the three-operand einsum takes ~0.5 ms of host per call: fewer
                    # calls behind a longer sleep
                    "library_device_ms": device_ms(torch, lib, calls=10, sleep_cycles=60_000_000),
                    "bound_ms": b_ms, "bound_by": b_by, "share_of_bound": b_ms / dev_ms}
            print(f"K1 operator form {name} D={D} (x, y, z at one site, one launch): max_abs_err "
                  f"{err:.3e} (tol {K1_TOL[name]:g}); kernel {case['ms']:.4f} ms, device "
                  f"{dev_ms:.4f} ms, einsum {case['library_ms']:.4f} ms (device "
                  f"{case['library_device_ms']:.4f}), plain {case['plain_ms']:.4f} ms, bound "
                  f"{b_ms * 1e3:.3f} us ({b_by}), {100 * b_ms / dev_ms:.1f}% of it")
            cases.append(case)
            if (name, D) == ("complex128", 3):
                row = {k: case[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                            "library_ms", "device_ms")}
                row["shape"] = f"x, y, z at one site, d=2, D={D}, {name}"
            del t
        torch.cuda.empty_cache()
    return cases, row


def _max_lambda_gap(lams, gold) -> float:
    return max(abs(float(x) - y) for k, v in lams.items()
               for x, y in zip(v.cpu().tolist(), gold[f"{k[0]},{k[1]}"]))


def su_warm_start(torch, K, SU, IBM, UnitCell, gold, dev):
    """Phase 10.2: the simple update of the su:q0 seed at D=3 in complex128
    on the card over SU_LADDER, its λ against the JAX package's, then the
    block measurements at N=2 and 3 (χ_msg = 2D², χ = 2D²+10) against the
    JAX script's rows, and one N=2 measurement under KPBP_LINALG=gram (K2).
    A gap above SU_TOL passes only where the same run on the CPU from a seed
    moved by SU_PERTURB moves as far (a measured cause, printed), and never
    above SU_CAUSE_TOL."""
    from kagomeperiodicbp_tpu_torch.physics import hamiltonians

    c128 = torch.complex128
    D = gold["D"]
    seed = UnitCell.load(SU_PIN_CELL, device=dev, dtype=c128)
    h = hamiltonians.heisenberg_afm()
    sweep, sweeps = SU._sweep, []

    def counted(*a, **kw):
        sweeps.append(1)
        return sweep(*a, **kw)

    SU._sweep = counted
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cell, lams = SU.simple_update(h, D, cell=seed, dtype=c128, time_steps=SU_LADDER)
        torch.cuda.synchronize()
        su_s = time.perf_counter() - t0
    finally:
        SU._sweep = sweep
    lam_gap = _max_lambda_gap(lams, gold["lambdas"])
    rows, rows_s = [], {}
    for n in SU_BLOCK_NS:
        t0 = time.perf_counter()
        env = {"KPBP_LINALG": "gram"} if n in SU_BLOCK_GRAM else {}
        rows += _with_env(env, lambda: IBM.measure_rows(cell, D, n, n, c128))
        rows_s[n] = time.perf_counter() - t0
    gaps = {r["N"]: abs(r["mean_energy"] - g["mean_energy"]) for r, g in zip(rows, gold["rows"])}
    before = K.launch_counts()
    t0 = time.perf_counter()
    row_gram = _with_env({"KPBP_LINALG": "gram"}, lambda: IBM.measure_rows(cell, D, 2, 2, c128))[0]
    gram_s = time.perf_counter() - t0
    after = K.launch_counts()
    gram = {n: after[n] - before[n] for n in after}
    res = {"sweeps": len(sweeps), "su_s": su_s, "s_per_sweep": su_s / len(sweeps),
           "lambda_gap": lam_gap, "rows": rows, "rows_s": rows_s, "energy_gaps": gaps,
           "gram_row": row_gram, "gram_launches": gram, "gram_s": gram_s,
           "gram_gap": abs(row_gram["mean_energy"] - rows[0]["mean_energy"])}
    print(f"SU warm start D={D} su:q0 c128, the default ladder less its dt=0.1 block: {len(sweeps)} "
          f"sweeps in {su_s:.2f} s ({1e3 * su_s / len(sweeps):.2f} ms per sweep); max |lambda - JAX| "
          f"{lam_gap:.3e} (tol {SU_TOL:g})")
    for r in rows:
        print(f"SU warm start D={D} N={r['N']}"
              f"{' under KPBP_LINALG=gram' if r['N'] in SU_BLOCK_GRAM else ''}: mean_energy {r['mean_energy']!r} (JAX "
              f"{gold['rows'][r['N'] - 2]['mean_energy']!r}, gap {gaps[r['N']]:.3e}; published SU "
              f"{PUBLISHED_SU[D]}), BP {r['bp_iters']} iterations, error {r['bp_error']:.3e}, "
              f"{rows_s[r['N']]:.2f} s")
    print(f"SU warm start: N=2 under KPBP_LINALG=gram {row_gram['mean_energy']!r} (gap to default "
          f"{res['gram_gap']:.3e}), {gram_s:.2f} s; gram launches {json.dumps(gram)}")
    worst = max([lam_gap] + list(gaps.values()))
    if not worst < SU_TOL:
        # the measured cause: the same SU and N=2 measurement on the CPU from
        # the seed and from the seed moved by SU_PERTURB of its largest entry
        gen = torch.Generator().manual_seed(0)
        cpu_seed = seed.to_device("cpu")
        nudged = cpu_seed._map(lambda t: t + SU_PERTURB * t.abs().max() * torch.randn(
            t.shape, generator=gen, dtype=t.real.dtype))
        runs = [SU.simple_update(h, D, cell=c, dtype=c128, time_steps=SU_LADDER)
                for c in (cpu_seed, nudged)]
        lam_move = _max_lambda_gap(runs[1][1], {f"{k[0]},{k[1]}": v.tolist()
                                                for k, v in runs[0][1].items()})
        e_move = abs(IBM.measure_rows(runs[0][0], D, 2, 2, c128)[0]["mean_energy"]
                     - IBM.measure_rows(runs[1][0], D, 2, 2, c128)[0]["mean_energy"])
        cause = max(lam_move, e_move)
        res["cause"] = {"lambda_move": lam_move, "energy_move_N2": e_move}
        print(f"SU warm start: misses {SU_TOL:g} by {worst:.3e}; cause: a {SU_PERTURB:g} change of "
              f"the seed moves the CPU port's lambda by {lam_move:.3e} and its N=2 energy by "
              f"{e_move:.3e}")
        bar = min(SU_CAUSE_TOL, max(100 * cause, SU_TOL))
        if not worst < bar:
            raise AssertionError(f"SU warm start: gap {worst} above {bar} (100x its measured "
                                 f"cause {cause}, at most {SU_CAUSE_TOL})")
    if not res["gram_gap"] < SU_TOL:
        raise AssertionError(f"SU cell: the gram measurement differs from the default by {res['gram_gap']}")
    if gram["chol_inv_resident"] < 1 or gram["chol_inv_blocked"] + gram["chol_inv_tiled"] < 1:
        raise AssertionError(f"the gram measurement of the SU cell did not launch K2: {gram}")
    return res, cell


def su_large_d(torch, SU, UnitCell, dev):
    """Phase 10.3: SU at D=6, the published records' width, in complex64
    and complex128 from the su:q0 seed (run_ite's noise), over SU6_LADDER:
    seconds per sweep and in all."""
    from kagomeperiodicbp_tpu_torch.physics import hamiltonians

    D, out = 6, {}
    for name in ("complex64", "complex128"):
        dt = getattr(torch, name)
        seed = UnitCell.product_state_120(2, D, +1, dt, dev).add_noise(
            0.02, torch.Generator(device=dev).manual_seed(0))
        sweep, sweeps = SU._sweep, []

        def timed(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sweep(*a, **kw)
            torch.cuda.synchronize()
            sweeps.append(time.perf_counter() - t0)

        SU._sweep = timed
        try:
            t0 = time.perf_counter()
            cell, lams = SU.simple_update(hamiltonians.heisenberg_afm(), D, cell=seed, dtype=dt,
                                          time_steps=SU6_LADDER)
            torch.cuda.synchronize()
            total = time.perf_counter() - t0
        finally:
            SU._sweep = sweep
        finite = all(torch.isfinite(t).all().item() for _, t in cell.items())
        out[name] = {"sweeps": len(sweeps), "s": total, "s_per_sweep": statistics.median(sweeps),
                     "first_sweep_s": sweeps[0], "lambda_min": min(v.min().item() for v in lams.values())}
        print(f"SU D={D} {name} (su:q0 seed, ladder {len(SU6_LADDER)} sweeps at most): {len(sweeps)} "
              f"sweeps, {total:.2f} s, median {1e3 * out[name]['s_per_sweep']:.1f} ms per sweep "
              f"(first {1e3 * sweeps[0]:.1f} ms); smallest lambda {out[name]['lambda_min']:.3e}")
        if not finite:
            raise AssertionError(f"SU at D={D} in {name} gave a non-finite cell")
    return out


def sandwich_checks(torch, K, F, MS, pin_bp, ite_in, dev):
    """Phase 10.4: measure_xyz_sandwich on the pin cell with its N=2,
    χ_msg=18 BP messages (phase 8's) at χ=28, card against the CPU port in
    complex128, K1 launched 1 + 3 times; then at the pin's production
    convention (N=3, χ=56, χ_msg=36, phase 4's messages), timed, beside the
    RDM path's ⟨x, y, z⟩ from the same messages."""
    cell, sites, _ = ite_in
    before = K.launch_counts()
    t0 = time.perf_counter()
    card = MS.measure_xyz_sandwich(cell, F._sites_to_msgs(sites), 2, 28, 18)
    card_s = time.perf_counter() - t0
    after = K.launch_counts()
    k1 = {n: after[n] - before[n] for n in ("fused_tensor", "fused_tensor_operator")}
    cpu_msgs = F._sites_to_msgs({s: tuple(x.cpu() for x in ss) for s, ss in sites.items()})
    cpu = MS.measure_xyz_sandwich(cell.to_device("cpu"), cpu_msgs, 2, 28, 18)
    gap = max(abs(card[f][k] - cpu[f][k]) for f in "ABC" for k in "xyz")
    print(f"sandwich pin N=2 chi=28 chi_msg=18 c128: card {card_s:.2f} s; K1 launches {json.dumps(k1)}; "
          f"max |card - CPU| over the 9 values {gap:.3e} (tol {SANDWICH_TOL:g})")
    if not gap < SANDWICH_TOL:
        raise AssertionError(f"sandwich card against CPU: {gap}")
    if k1 != {"fused_tensor": 1, "fused_tensor_operator": 3}:
        raise AssertionError(f"measure_xyz_sandwich launched K1 {k1}, not 1 + 3")
    pin_cell, pin_msgs, pin_meas = pin_bp
    t0 = time.perf_counter()
    prod = MS.measure_xyz_sandwich(pin_cell, pin_msgs, 3, 56, 36)
    prod_s = time.perf_counter() - t0
    values = {f: {k: [prod[f][k].real, prod[f][k].imag] for k in "xyz"} for f in "ABC"}
    print(f"sandwich pin N=3 chi=56 chi_msg=36 (phase 4's messages) c128: {prod_s:.2f} s; "
          f"<x,y,z> by the sandwich {json.dumps({f: [round(prod[f][k].real, 10) for k in 'xyz'] for f in 'ABC'})}; "
          f"by the edge RDMs {json.dumps({f: [round(pin_meas.expectations[f][k], 10) for k in 'xyz'] for f in 'ABC'})}")
    return {"n2": {"card_s": card_s, "k1_launches": k1, "gap": gap},
            "production": {"s": prod_s, "sandwich": values, "rdm": pin_meas.expectations}}


def classical_start(torch, BP, MS, ite_in, uniform):
    """Phase 10.5: BP on the pin cell at N=2 from random-classic messages
    must converge; its energy beside that of the uniform start (`uniform`:
    the measurement of phase 8's messages), both measured at χ=28."""
    cell, _, h = ite_in
    cfg = BP.BPConfig(trunc_dim=18, init_model="random-classic", dtype=torch.complex128)
    t0 = time.perf_counter()
    msgs, st = BP.robust_belief_propagation(cell, None, cfg, 2)
    bp_s = time.perf_counter() - t0
    e_rc = MS.measure_energies_and_observables(cell, msgs, 2, 28, 18, h).mean_energy
    e_u = uniform.mean_energy
    res = {"success": st.success, "iterations": st.iterations, "error": st.final_error,
           "attempts": st.attempts, "bp_s": bp_s, "energy_random_classic": e_rc,
           "energy_uniform": e_u, "gap": abs(e_rc - e_u)}
    print(f"BP from random-classic messages, pin N=2 chi_msg=18 c128: success {st.success}, "
          f"{st.iterations} iterations, {st.attempts} attempt(s), error {st.final_error:.3e}, "
          f"{bp_s:.2f} s; energy {e_rc!r} against {e_u!r} from uniform messages (gap {res['gap']:.3e})")
    if not st.success:
        raise AssertionError(f"BP from random-classic messages did not converge: {res}")
    return res


def arbitrary_check(torch, K, A, BP, ite_in, want, dev):
    """Phase 10.6: ArbitraryKagomeTN.from_unit_cell(pin, N=2).measure(h) on
    the card against the unit-cell path on the card (`want`: phase 8's BP
    messages at χ_msg=18, the same BPConfig, measured at χ=28), complex128,
    with K1's launches; then a block of 21 independent kets, where each
    site reads a fused tensor of its own (a tiled block repeats every three
    sites, as K1's launches do), measured on the card (BP at χ_msg=8, the
    energies at χ=18) against the JAX package's measurement of it."""
    import numpy as np

    cell, _, h = ite_in
    before = K.launch_counts()["fused_tensor"]
    t0 = time.perf_counter()
    got = A.ArbitraryKagomeTN.from_unit_cell(cell, 2).measure(h)
    arb_s = time.perf_counter() - t0
    k1 = K.launch_counts()["fused_tensor"] - before
    gap = max([abs(got.mean_energy - want.mean_energy)]
              + [abs(got.energies[k] - v) for k, v in want.energies.items()])
    print(f"arbitrary block N=2 from the pin cell (21 per-site kets) c128: mean_energy "
          f"{got.mean_energy!r} against the unit-cell path's {want.mean_energy!r}, max gap {gap:.3e} "
          f"(tol {ARB_TOL:g}); {arb_s:.2f} s; K1 launches {k1} (one per three sites, in BP and "
          f"in each of the six edge environments)")
    if not gap < ARB_TOL:
        raise AssertionError(f"the arbitrary tiled block differs from the unit-cell path by {gap}")
    with np.load(ARB_CASE) as z:
        case = dict(z)
    tensors = [torch.from_numpy(t).to(dev) for t in case["arb_per_site"]]
    cfg = BP.BPConfig(trunc_dim=8, max_iterations=30, msg_diff_terminate=1e-11)
    before = K.launch_counts()["fused_tensor"]
    t0 = time.perf_counter()
    own = A.ArbitraryKagomeTN(tensors, 2).measure(h, bp_config=cfg, chi=18)
    own_s = time.perf_counter() - t0
    own_k1 = K.launch_counts()["fused_tensor"] - before
    own_gap = max([abs(own.mean_energy - float(case["arb_per_site_mean"]))]
                  + [abs(own.energies[k] - e) for k, e in zip(case["energy_keys"],
                                                              case["arb_per_site_energies"])])
    print(f"arbitrary block N=2 D=2 of 21 independent kets c128: mean_energy {own.mean_energy!r} "
          f"against the JAX package's {float(case['arb_per_site_mean'])!r}, max gap {own_gap:.3e} "
          f"(tol {ARB_TOL:g}); {own_s:.2f} s; K1 launches {own_k1}")
    if not own_gap < ARB_TOL:
        raise AssertionError(f"the block of independent kets differs from the JAX package by {own_gap}")
    if own_k1 < len(tensors) // 3:
        raise AssertionError(f"the block of independent kets launched K1 {own_k1} times, fewer than "
                             f"once per three sites in BP")
    return {"gap": gap, "s": arb_s, "k1_launches": k1, "mean_energy": got.mean_energy,
            "independent": {"gap": own_gap, "s": own_s, "k1_launches": own_k1,
                            "mean_energy": own.mean_energy}}


def pmps_check(torch, P, dev):
    """Phase 10.7: pmps_inner of a small chain (a root with two out legs, a
    truncated swallow, a two-in-leg closure) on the card against the CPU
    port in complex128, with KPBP_LINALG=gram (its tall QRs on K2)."""
    gen = torch.Generator().manual_seed(3)
    shapes = [(2, 6, 5), (2, 6, 4), (2, 5, 7), (2, 4, 7)]
    ts = [torch.randn(s, generator=gen, dtype=torch.complex128) for s in shapes]

    def chain(tensors):
        p = P.pmps_root(tensors[0], out_legs=[0, 1])
        p = P.swallow_bubbleket(p, tensors[1], 0, in_legs=[0], out_legs=[1], chi=8)
        p = P.swallow_bubbleket(p, tensors[2], 1, in_legs=[0], out_legs=[1], chi=8)
        p = P.swallow_bubbleket(p, tensors[3], 0, in_legs=[0, 1], out_legs=[])
        v, l = P.pmps_inner(p)
        return complex(v.item()) * float(torch.exp(l))

    card, cpu = (_with_env({"KPBP_LINALG": "gram"}, lambda d=d: chain([t.to(d) for t in ts]))
                 for d in (dev, "cpu"))
    gap = abs(card - cpu) / abs(cpu)
    print(f"pmps chain c128 under KPBP_LINALG=gram: card {card!r}, CPU {cpu!r}, relative gap "
          f"{gap:.3e} (tol {PMPS_TOL:g})")
    if not gap < PMPS_TOL:
        raise AssertionError(f"pmps_inner card against CPU: {gap}")
    return {"card": [card.real, card.imag], "cpu": [cpu.real, cpu.imag], "gap": gap}


# phase 11: the batched six-side sweep and the square lattice
B_N, B_CHI = 2, 18    # phase 6's sweep (bench.py's bp_sweeps_per_second_D3_N2_chi18)
# batched against per-side, by message distance and mean distance: complex128
# at the parity bar, complex64 at the North star's bp bar
BATCHED_TOL = {"complex128": 1e-10, "complex64": 2e-5}
B_ROUNDS = 1          # timed rounds of per-side, batched, batched, per-side (cut from 2 for phase 13's time)
# the largest D the auto rule runs batched, at χ_msg = 2D², χ = 2D²+10
WIDE_D, WIDE_CHI_MSG, WIDE_CHI = 5, 50, 60
# the square lattice: tests/assets/square_D2.npz (tools/make_square_case.py)
# holds the JAX package's values at n=4, m=2, D=2, χ_msg=8, χ=18
SQ_CASE = os.path.join(REPO, "tests", "assets", "square_D2.npz")
SQ_N, SQ_M, SQ_D, SQ_CHI_MSG, SQ_CHI = 4, 2, 2, 8, 18
SQ_BONDS = [(0, 0), (1, 1)]
SQ_SU_DTS, SQ_SU_SWEEPS = (0.1, 0.05, 0.01), 30       # the asset's SU ladder
SQ_TOL = 1e-10
# run_square at D=4 (χ_msg = 2D² = 32, χ = 42), cut to fit: its SU ladder
# keeps its 7 stages (0.1 → 0.001) at 10 sweeps each in place of 60, and its
# BP stops after SQ_BP_CUT sweeps in place of 60 (~1.1 s each on an H100);
# at 5 and 6 the energy per site is −0.2533, far from the −0.4930 at 10 and
# 10 (an H100), so the cut stays there
SQ_RUN = ["-D", "4", "-m", "2", "-n", "4"]
SQ_SU_CUT = ["--sweeps-per-dt", "10"]
SQ_BP_CUT = 10
SQ_REFS = {"Neel": -0.5, "exact": -0.6694}
# D=3: tests/assets/square_D3.npz holds the JAX package's simple update over
# SQ_FU_SU_DTS x SQ_FU_SU_SWEEPS from run_square's seed-0 start, its BP (at
# most SQ_FU_SU_BP sweeps) and energy at χ_msg=18, χ=28, and how far a 1e-15
# change of the start moves them; the full-update polish from that cell runs
# two dt stages of one sweep, each of its BP runs cut to SQ_FU_BP sweeps
# (full_update's default 40; cut from 12 for phase 14's time: on an H100
# the D=3 check took 99.8 s at 12, −0.5004944 → −0.5004258 → −0.5006036,
# and 74.8 s at 6, → −0.5005110 → −0.5005414); at 12 its first stage alone
# raised the energy, so both stages stay
SQ_CASE_D3 = os.path.join(REPO, "tests", "assets", "square_D3.npz")
SQ_FU_D, SQ_FU_SU_DTS, SQ_FU_SU_SWEEPS, SQ_FU_SU_BP = 3, (0.1, 0.05, 0.02), 30, 60
SQ_FU_DTS, SQ_FU_BP = (0.05, 0.02), 6


def _sq_bar(move) -> float:
    """SQ_TOL, or 100x the JAX package's own move under a 1e-15 change of
    its input where that move exceeds 1e-12 (tests/test_torch_square.py's
    rule)."""
    move = float(move)
    return SQ_TOL if move <= 1e-12 else max(SQ_TOL, 100 * move)


def _delta(K, fn):
    """(fn(), the kernels' launches during it)."""
    before = K.launch_counts()
    out = fn()
    after = K.launch_counts()
    return out, {n: after[n] - before[n] for n in after}


def _add(total, delta):
    for n, c in delta.items():
        total[n] = total.get(n, 0) + c


def _msg_gaps(M, a, b) -> dict:
    """Distance of two message sets, side by side (gauge-free)."""
    return {int(s): float(M.distance(*(M.from_sites(tuple(x.cpu() for x in m[s])) for m in (a, b))))
            for s in a}


def batched_checks(torch, K, L, M, C, F, B, BlockSide, cell64, msgs64, dev):
    """Phase 11.1-11.3: one batched sweep (N=2, D=3, χ=18) on the pin cell
    and phase 6's messages against the per-side sweep on the card, in
    complex128 and complex64; both timed in complex64, in turns, and each
    profiled once; then one sweep of each under KPBP_LINALG=gram, where the
    batched one must launch K2 a third as often, variant by variant, and K2
    is held to its plain version at every (3, k) the batched sweep gave it.
    Returns the results and the batched path's launches (K1's for the
    fused cell included)."""
    D, res, counts = cell64.D, {}, {n: 0 for n in K.KERNELS}
    t_start = time.perf_counter()
    per_side = F.bp_iteration(B_N, D, B_CHI, B_CHI, None)
    batched = B.bp_iteration_batched(B_N, D, B_CHI, B_CHI, None)
    inputs = {}
    for name in ("complex128", "complex64"):
        dt = getattr(torch, name)
        cell = cell64.astype(dt)
        sites = {s: tuple(x.to(dt) for x in ss) for s, ss in msgs64.items()}
        fused, d_k1 = _delta(K, lambda: C.fused_cells(cell))
        _add(counts, d_k1)
        inputs[name] = (fused, sites)
        want, e_want = per_side(fused, sites)
        (got, e_got), d = _delta(K, lambda: batched(fused, sites))
        _add(counts, d)
        gaps = {BlockSide(s).name: g for s, g in _msg_gaps(M, got, want).items()}
        mean_gap = abs(float(e_got) - float(e_want))
        res[name] = {"distances": gaps, "mean_distance_gap": mean_gap,
                     "mean_distance": float(e_got)}
        print(f"batched sweep N={B_N} D={D} chi={B_CHI} {name} (pin cell, phase 6's messages): "
              f"distance to the per-side messages {json.dumps(gaps)}, mean distance {float(e_got):.6e} "
              f"against {float(e_want):.6e} (tol {BATCHED_TOL[name]:g}); {time.perf_counter() - t_start:.1f} s "
              f"into the phase")
        if not max(list(gaps.values()) + [mean_gap]) < BATCHED_TOL[name]:
            raise AssertionError(f"the batched sweep differs from the per-side one in {name}: {res[name]}")

    res["checks_s"] = time.perf_counter() - t_start
    fused, sites = inputs["complex64"]
    times = {"per_side": [], "batched": []}

    def timed(label, sweep):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        float(sweep(fused, sites)[1])
        times[label].append(time.perf_counter() - t0)

    # both sweeps ran on these complex64 inputs just above: no warm-up
    for _ in range(B_ROUNDS):
        for label, sweep in (("per_side", per_side), ("batched", batched),
                             ("batched", batched), ("per_side", per_side)):
            timed(label, sweep)
    res["timing_c64"] = {k: {"s_all": v, "s_median": statistics.median(v)} for k, v in times.items()}
    for label, sweep in (("per_side", per_side), ("batched", batched)):
        wall, events = profile_once(torch, dev, lambda: float(sweep(fused, sites)[1]))
        busy, device, by_name = device_summary(events, wall)
        by_count = {}
        for n, _, _ in events:
            by_count[n[:60]] = by_count.get(n[:60], 0) + 1
        res["timing_c64"][label]["profile"] = {
            "wall_s": wall, "device_busy": busy, "device_s": device, "device_events": len(events),
            "top_device": top_device(by_name),
            "top_by_count": sorted(by_count.items(), key=lambda kv: -kv[1])[:6]}
    t_ps, t_b = (res["timing_c64"][k]["s_median"] for k in ("per_side", "batched"))
    print(f"BP sweep N={B_N} D={D} chi={B_CHI} c64, in turns over {B_ROUNDS} rounds: per-side median "
          f"{t_ps * 1e3:.1f} ms, batched {t_b * 1e3:.1f} ms ({t_ps / t_b:.2f}x); " + "; ".join(
              f"{k} profiled: {p['wall_s'] * 1e3:.1f} ms wall, device busy {100 * p['device_busy']:.1f}%, "
              f"{p['device_events']} device events, top device time "
              + ", ".join(f"{n} {pct}%" for n, pct in p["top_device"][:4])
              + f"; device events by kernel {p['top_by_count'][:4]}"
              for k, p in ((k, res["timing_c64"][k]["profile"]) for k in ("per_side", "batched"))))

    res["timing_s"] = time.perf_counter() - t_start - res["checks_s"]
    fused, sites = inputs["complex128"]
    gram = {}
    with_gram = lambda fn: _with_env({"KPBP_LINALG": "gram"}, fn)  # noqa: E731
    t0 = time.perf_counter()
    (want, _), gram["per_side"] = _delta(K, lambda: with_gram(lambda: per_side(fused, sites)))
    t_ps = time.perf_counter() - t0
    t0 = time.perf_counter()
    ((got, _), k_seen), gram["batched"] = _delta(
        K, lambda: k2_sizes(L, lambda: with_gram(lambda: batched(fused, sites))))
    t_b = time.perf_counter() - t0
    _add(counts, gram["batched"])
    gap = max(_msg_gaps(M, got, want).values())
    print(f"timed sweeps {res['timing_s']:.1f} s; gram sweep N={B_N} D={D} chi={B_CHI} c128: per-side {t_ps:.2f} s, launches "
          f"{json.dumps(gram['per_side'])}; batched {t_b:.2f} s, launches {json.dumps(gram['batched'])}; "
          f"K2 sizes (batch 3) k:calls {json.dumps(dict(sorted(k_seen.items())))}; message distance {gap:.3e}")
    if not sum(gram["batched"][v] for v in K2_VARIANTS) > 0 or any(
            gram["per_side"][v] != 3 * gram["batched"][v] for v in K2_VARIANTS):
        raise AssertionError(f"the batched gram sweep did not launch K2 a third as often: {gram}")
    if not gap < BATCHED_TOL["complex128"]:
        raise AssertionError(f"the batched gram sweep differs from the per-side one by {gap}")
    gen = torch.Generator().manual_seed(11)
    k2 = {}
    for k in sorted(k_seen):
        g = torch.stack([_spd(torch, gen, torch.complex128, k) for _ in range(3)]).to(dev)
        l, w = K.chol_inv_cuda(g)
        l_ref, w_ref = K.chol_inv_ref(g)
        err = max(((l - l_ref).abs().max() / l_ref.abs().max()).item(),
                  ((w - w_ref).abs().max() / w_ref.abs().max()).item())
        flops, nbytes = chol_inv_work(k, torch.complex128, torch)
        b_ms, b_by = bound(3 * flops, 3 * nbytes)
        k2[str(k)] = {"calls": k_seen[k], "variant": K.chol_inv_plan(k, torch.complex128).variant,
                      "rel_err": err, "ms": _ms(torch, lambda: K.chol_inv_cuda(g), budget_ms=60.0),
                      "plain_ms": _ms(torch, lambda: K.chol_inv_ref(g), budget_ms=60.0),
                      "library_ms": _ms(torch, lambda: _library(torch, g), budget_ms=60.0),
                      "bound_ms": b_ms, "bound_by": b_by}
        if not err < K2_TOL["complex128"]:
            raise AssertionError(f"K2 at batch 3, k={k} disagrees with its plain version: {err}")
    print("K2 at batch 3, c128, at every size of the batched gram sweep (tol "
          f"{K2_TOL['complex128']:g}): " + "; ".join(
              f"k={k} ({r['variant']}, {r['calls']} calls) rel_err {r['rel_err']:.1e}, kernel "
              f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f}, library {r['library_ms']:.4f}"
              for k, r in k2.items()))
    res["gram_c128"] = {"per_side": {"s": t_ps, "launches": gram["per_side"]},
                        "batched": {"s": t_b, "launches": gram["batched"]},
                        "distance": gap, "k2_batch3": k2}
    return res, counts


def _dense_messages(torch, C, F, D, chi, seed, dev):
    """Complex64 messages in the canonical padded profile with every entry
    drawn from a seeded Gaussian: generic spectra, unlike the product
    messages of ``initial_messages``."""
    gen = torch.Generator().manual_seed(seed)
    profile = F._msgs_to_sites(C.initial_messages(B_N, D, chi, dtype=torch.complex64))
    return {s: tuple(torch.complex(*(torch.randn(x.shape, generator=gen) for _ in range(2))).to(dev)
                     for x in ss) for s, ss in profile.items()}


def wide_batched(torch, K, L, M, C, F, B, BlockSide, UnitCell, dev):
    """Phase 11.4: D=5, N=2, χ_msg=50, χ=60, on a seeded random cell, from
    seeded dense messages (``_dense_messages``). In complex64, as BP runs:
    a batched and a per-side sweep, each timed with peak device memory,
    their distance printed (a second batched sweep from the first one's
    messages, 4.70 s against the first's 4.69 on an H100, was cut for
    phase 14's time). In complex128 with exact SVDs in place of the
    randomized one (L.RSVD_MIN_DIM lifted), for one class of three sides
    (the exact SVDs take ~15 s per class and body on an H100): the batched
    sweep's vmapped call against the per-side body toward each side, held
    at BATCHED_TOL, far below what the sweep moves the messages. The
    randomized SVD's sweeps are not held: on these
    messages its truncation is far from the exact one, and batched and
    per-side sweeps part by O(0.1) on the card, in complex128 too, while
    with exact SVDs they agree to round-off (tools/batched_rsvd_check.py;
    ROADMAP queue 3)."""
    cell = UnitCell.random(2, WIDE_D, torch.Generator().manual_seed(5), dtype=torch.complex64).to_device(dev)
    batched = B.bp_iteration_batched(B_N, WIDE_D, WIDE_CHI, WIDE_CHI_MSG, None)
    per_side = F.bp_iteration(B_N, WIDE_D, WIDE_CHI, WIDE_CHI_MSG, None)
    runs = {}

    def run(label, sweep, fused, msgs):
        _fresh_peak(torch)
        t0 = time.perf_counter()
        out, err = sweep(fused, msgs)
        err = float(err)
        runs[label] = {"s": time.perf_counter() - t0, "peak_gb": _peak_gb(torch), "msgs": out,
                       "mean_distance": err}

    fused, start = C.fused_cells(cell), _dense_messages(torch, C, F, WIDE_D, WIDE_CHI_MSG, 6, dev)
    run("batched_1", batched, fused, start)
    run("per_side", per_side, fused, start)
    res = {k: {x: v for x, v in r.items() if x != "msgs"} for k, r in runs.items()}
    a, b = runs["batched_1"], runs["per_side"]
    res["complex64"] = {"distances": _msg_gaps(M, a["msgs"], b["msgs"]),
                        "mean_distance_gap": abs(a["mean_distance"] - b["mean_distance"])}

    # one class of three sides in complex128 with exact SVDs: its vmapped
    # call against the per-side body toward each of its sides
    c128, base = torch.complex128, next(iter(B.CLASS_SIDES))
    fused = C.fused_cells(cell._map(lambda t: t.to(c128)))
    start = {s: tuple(x.to(c128) for x in ss) for s, ss in start.items()}
    min_dim = L.RSVD_MIN_DIM
    L.RSVD_MIN_DIM = 10 ** 9
    try:
        t0 = time.perf_counter()
        stacked = B._class_outgoing(B._rotated_fused_stacks(fused), B._stacked_msg_sites(start, base),
                                    B_N, WIDE_D, WIDE_CHI, WIDE_CHI_MSG, base)
        got = {side: tuple(x[k] for x in stacked) for k, side in enumerate(B.CLASS_SIDES[base])}
        t_b = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = {side: F._one_outgoing(tuple(fused), start, B_N, WIDE_D, WIDE_CHI, WIDE_CHI_MSG, side).sites
                for side in got}
        t_p = time.perf_counter() - t0
    finally:
        L.RSVD_MIN_DIM = min_dim
    moved = min(_msg_gaps(M, {s: start[int(BlockSide(s).opposite())] for s in got},
                          {s: tuple(mps.reverse().sites) for s, mps in
                           ((s, M.from_sites(x)) for s, x in want.items())}).values())
    res["complex128_exact_class"] = {"sides": list(got), "batched_s": float(t_b), "per_side_s": float(t_p),
                                     "distances": _msg_gaps(M, got, want), "least_move": moved}
    del fused, start, stacked
    tol = BATCHED_TOL["complex128"]
    r = res["complex128_exact_class"]
    print(f"batched sweep D={WIDE_D} N={B_N} chi_msg={WIDE_CHI_MSG} chi={WIDE_CHI}: c64 " + "; ".join(
        f"{k} {x['s']:.2f} s, peak {x['peak_gb']:.2f} GB, mean distance {x['mean_distance']:.4e}"
        for k, x in res.items() if "s" in x) + f"; batched against per-side from dense messages: "
        f"c64 distances {json.dumps(res['complex64']['distances'])}, mean distance gap "
        f"{res['complex64']['mean_distance_gap']:.2e} (printed only); class of sides {r['sides']} in c128 with "
        f"exact SVDs: vmapped call {t_b:.2f} s, per-side calls {t_p:.2f} s, distances {json.dumps(r['distances'])} "
        f"(tol {tol:g}), each message {moved:.3e} or more from the one it replaces")
    if not max(r["distances"].values()) < tol:
        raise AssertionError(f"the D={WIDE_D} batched class differs from the per-side calls: {res}")
    if not moved > 1e6 * tol:
        raise AssertionError(f"the D={WIDE_D} sweep barely moves its messages: {res}")
    return res


def square_checks(torch, K, L, M, S, FU, run_square, hamiltonians, dev):
    """Phase 11.5-11.9: the square lattice on the card. The asset's cell
    (n=4, m=2, D=2, c128) measured against the JAX package's values; the
    simple update from the JAX package's start, then BP, energy and bond
    expectations, on the card against the same on the CPU port and its λ
    against the JAX package's; run_square at D=4 (χ 32/42) in complex128
    and complex64, each step timed with its launches (its energy printed
    beside the square AFM's references and only held between the exact
    value less 0.03 and 0: nothing else computes it at D=4 to compare);
    at D=3 the simple update from the JAX package's start, its BP and
    energy against the JAX package's (tests/assets/square_D3.npz), then a
    full-update polish that must lower the energy; one BP under
    KPBP_LINALG=gram, which must launch K2. Returns the results and the
    square path's launches."""
    import numpy as np

    from kagomeperiodicbp_tpu_torch.convert import square_cell_from_numpy, square_messages_from_numpy

    with np.load(SQ_CASE) as z:
        case = dict(z)
    h = hamiltonians.heisenberg_afm()
    counts, res = {n: 0 for n in K.KERNELS}, {}
    sides = {}
    for key, x in case.items():
        if key.startswith("msg_"):
            _, s, k = key.split("_")
            sides.setdefault(int(s), {})[int(k)] = x
    want_msgs = {int(s): m.sites for s, m in square_messages_from_numpy(
        {s: [v[k] for k in sorted(v)] for s, v in sides.items()}).items()}

    def measured(cell, msgs=None):
        """BP (from `msgs` or uniform), energy and bond expectations."""
        if msgs is None:
            msgs, _ = S.belief_propagation(cell, SQ_N, SQ_D, SQ_CHI_MSG, chi=SQ_CHI)
        e = S.measure_energy(cell, SQ_N, SQ_D, msgs, SQ_CHI, SQ_CHI_MSG, h)
        bonds = {o: [FU.bond_expectation(cell, SQ_N, SQ_D, msgs, SQ_CHI, SQ_CHI_MSG, h, o, i, j)
                     for i, j in SQ_BONDS] for o in "hv"}
        return {int(s): m.sites for s, m in msgs.items()}, e, bonds

    # the asset's cell on the card against the JAX package
    t0 = time.perf_counter()
    (msgs, e, bonds), d = _delta(K, lambda: measured(square_cell_from_numpy(case["cell"], device=dev)))
    _add(counts, d)
    jax_gap = {"messages": max(_msg_gaps(M, msgs, want_msgs).values()),
               "energy": abs(e - float(case["energy"])),
               **{f"bond_{o}": max(abs(a - b) for a, b in zip(bonds[o], case[f"bond_{o}"])) for o in "hv"}}
    print(f"square n={SQ_N} m={SQ_M} D={SQ_D} c128, the asset's cell on the card against the JAX "
          f"package: energy {e!r} (JAX {float(case['energy'])!r}); gaps {json.dumps(jax_gap)} (tol "
          f"{SQ_TOL:g}); {time.perf_counter() - t0:.2f} s; launches {json.dumps(d)}")

    # the simple update from the JAX package's start, card against CPU
    init = S._initial_cell
    pipeline = {}
    for label, device in (("card", dev), ("cpu", torch.device("cpu"))):
        S._initial_cell = lambda m, D, d, generator, dtype, device=None: [  # noqa: E731
            [torch.from_numpy(case["su_start"][i][j]).to(device=device, dtype=dtype) for j in range(m)]
            for i in range(m)]
        t0 = time.perf_counter()
        try:
            (cell, lams), d = _delta(K, lambda: S.simple_update(h, D=SQ_D, m=SQ_M, dts=SQ_SU_DTS,
                                                                 sweeps_per_dt=SQ_SU_SWEEPS, device=device))
        finally:
            S._initial_cell = init
        su_s = time.perf_counter() - t0
        lam = np.array([[[lams[(o, i, j)].cpu().numpy() for j in range(SQ_M)] for i in range(SQ_M)]
                        for o in "hv"])
        (msgs, e, bonds), d2 = _delta(K, lambda: measured(cell))
        if label == "card":
            _add(counts, d)
            _add(counts, d2)
        pipeline[label] = {"lambda": lam, "msgs": msgs, "energy": e, "bonds": bonds,
                           "s": time.perf_counter() - t0, "su_s": su_s, "cell": cell}
    card, cpu = ({k: v for k, v in pipeline[x].items() if k != "cell"} for x in ("card", "cpu"))
    cpu_gap = {"lambda": float(np.abs(card["lambda"] - cpu["lambda"]).max()),
               "messages": max(_msg_gaps(M, card["msgs"], cpu["msgs"]).values()),
               "energy": abs(card["energy"] - cpu["energy"]),
               **{f"bond_{o}": max(abs(a - b) for a, b in zip(card["bonds"][o], cpu["bonds"][o]))
                  for o in "hv"}}
    jax_gap["su_lambda"] = float(np.abs(card["lambda"] - case["su_lambda"]).max())
    print(f"square SU D={SQ_D} from the JAX package's start ({len(SQ_SU_DTS)} stages x "
          f"{SQ_SU_SWEEPS} sweeps), then BP, energy and bonds: card {card['s']:.2f} s (SU "
          f"{card['su_s']:.2f}), CPU {cpu['s']:.2f} s; energy {card['energy']!r}; card against CPU "
          f"{json.dumps(cpu_gap)}; lambda against the JAX package {jax_gap['su_lambda']:.3e} "
          f"(tol {SQ_TOL:g})")
    res.update(jax_gaps=jax_gap, cpu_gaps=cpu_gap, su_card_s=card["s"], su_energy=card["energy"])
    # the simple update's cell is fixed only up to a gauge on its bonds (each
    # SVD's phases), which the card and the CPU pick apart; λ, energies and
    # bond expectations do not see it, BP messages do: they are compared card
    # against CPU on one cell
    cell_cpu = pipeline["cpu"]["cell"]
    (same, _), d = _delta(K, lambda: S.belief_propagation([[t.to(dev) for t in row] for row in cell_cpu],
                                                           SQ_N, SQ_D, SQ_CHI_MSG, chi=SQ_CHI))
    _add(counts, d)
    cpu_gap["su_cells_messages"] = cpu_gap.pop("messages")
    cpu_gap["messages"] = max(_msg_gaps(M, {int(s): m.sites for s, m in same.items()}, cpu["msgs"]).values())
    print(f"square SU cell: BP on the card from the CPU's SU cell against the CPU's BP: messages "
          f"{cpu_gap['messages']:.3e} (tol {SQ_TOL:g}); the two devices' own SU cells differ by a bond "
          f"gauge, which moves their messages {cpu_gap['su_cells_messages']:.3e} apart")
    held = {k: v for k, v in cpu_gap.items() if k != "su_cells_messages"}
    if not max(list(jax_gap.values()) + list(held.values())) < SQ_TOL:
        raise AssertionError(f"the square lattice on the card misses {SQ_TOL}: JAX {jax_gap}, CPU {cpu_gap}")

    # run_square's path at D=4, each step timed with its launches
    steps = ("simple_update", "belief_propagation", "measure_energy")
    originals = {n: getattr(S, n) for n in steps}
    res["run_square"] = {}
    for name in ("complex128", "complex64"):
        rec = {}

        def timing(n):
            def run(*a, **kw):
                if n == "belief_propagation":
                    kw["max_iterations"] = SQ_BP_CUT
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out, d = _delta(K, lambda: originals[n](*a, **kw))
                torch.cuda.synchronize()
                rec[n] = {"s": time.perf_counter() - t0, "launches": d}
                return out
            return run

        for n in steps:
            setattr(S, n, timing(n))
        t0 = time.perf_counter()
        try:
            e = run_square.main(SQ_RUN + SQ_SU_CUT + ["--dtype", name])
        finally:
            for n in steps:
                setattr(S, n, originals[n])
        wall = time.perf_counter() - t0
        for r in rec.values():
            _add(counts, r["launches"])
        res["run_square"][name] = {"energy": e, "s": wall, "steps": rec}
        print(f"run_square {' '.join(SQ_RUN)} (chi_msg 32, chi 42) {name}, cut to "
              f"{' '.join(SQ_SU_CUT)} (default 60) and BP cut to {SQ_BP_CUT} sweeps (60): energy/site {e!r} (square AFM: Neel "
              f"{SQ_REFS['Neel']}, exact {SQ_REFS['exact']}); {wall:.2f} s; " + "; ".join(
                  f"{n} {r['s']:.2f} s, K1 {r['launches']['fused_tensor']} + operator form "
                  f"{r['launches']['fused_tensor_operator']}" for n, r in rec.items()))
        k1 = sum(r["launches"]["fused_tensor"] for r in rec.values())
        k1_op = sum(r["launches"]["fused_tensor_operator"] for r in rec.values())
        if not SQ_REFS["exact"] - 0.03 < e < 0 or k1 < 1 or k1_op < 1:
            raise AssertionError(f"run_square at D=4 {name}: energy {e}, K1 {k1}, operator form {k1_op}")

    # at D=3, where truncation bites, the simple update from the JAX
    # package's start, BP and the energy against the JAX package's; then a
    # short full-update polish that must lower the energy
    with np.load(SQ_CASE_D3) as z:
        case3 = dict(z)
    t0 = time.perf_counter()

    def polish():
        chi_msg, chi = 2 * SQ_FU_D ** 2, 2 * SQ_FU_D ** 2 + 10
        S._initial_cell = lambda m, D, d, generator, dtype, device=None: [  # noqa: E731
            [torch.from_numpy(case3["start"][i][j]).to(device=device, dtype=dtype) for j in range(m)]
            for i in range(m)]
        try:
            cell, lams = S.simple_update(h, D=SQ_FU_D, m=SQ_M, dts=SQ_FU_SU_DTS, sweeps_per_dt=SQ_FU_SU_SWEEPS,
                                         device=dev)
        finally:
            S._initial_cell = init
        msgs, err = S.belief_propagation(cell, SQ_N, SQ_FU_D, chi_msg, chi=chi, max_iterations=SQ_FU_SU_BP)
        e_su = S.measure_energy(cell, SQ_N, SQ_FU_D, msgs, chi, chi_msg, h)
        lam = np.array([[[lams[(o, i, j)].cpu().numpy() for j in range(SQ_M)] for i in range(SQ_M)]
                        for o in "hv"])
        _, e_fu, hist = FU.full_update(cell, h, n=SQ_N, dts=SQ_FU_DTS, sweeps_per_dt=1, chi=chi,
                                       chi_msg=chi_msg, bp_iters=SQ_FU_BP, bp_tol=1e-7)
        return lam, err, e_su, e_fu, hist

    (lam, err, e_su, e_fu, hist), d = _delta(K, polish)
    _add(counts, d)
    d3 = {"su_lambda": (float(np.abs(lam - case3["su_lambda"]).max()), _sq_bar(case3["su_lambda_move"])),
          "energy": (abs(e_su - float(case3["energy"])), _sq_bar(case3["energy_move"]))}
    res["full_update"] = {"e_su": e_su, "bp_err": err, "e_fu": e_fu, "history": hist,
                          "s": time.perf_counter() - t0, "launches": d,
                          "against_jax": {k: {"gap": g, "tol": b} for k, (g, b) in d3.items()},
                          "jax_run_square_D3_energy": float(case3["rs_energy"])}
    print(f"square D={SQ_FU_D} c128 from the JAX package's start: SU {len(SQ_FU_SU_DTS)} stages x "
          f"{SQ_FU_SU_SWEEPS} sweeps, BP (distance {err:.2e}), energy {e_su!r} (JAX {float(case3['energy'])!r}); "
          f"against the JAX package: " + ", ".join(f"{k} {g:.3e} (tol {b:g})" for k, (g, b) in d3.items()) +
          f"; then a full update of {len(SQ_FU_DTS)} dt stages of one sweep, BP cut to {SQ_FU_BP} sweeps: "
          f"energy {e_su!r} -> {e_fu!r} (history {hist}); {res['full_update']['s']:.2f} s; launches "
          f"{json.dumps(d)} (the JAX package's run_square at D=3, its default ladder from seed 0: "
          f"{float(case3['rs_energy'])!r})")
    if not all(g < b for g, b in d3.values()):
        raise AssertionError(f"the square lattice at D={SQ_FU_D} misses the JAX package's values: {d3}")
    if not e_fu < e_su:
        raise AssertionError(f"the full update did not lower the energy: {res['full_update']}")

    # one BP under gram, on K2
    cell = square_cell_from_numpy(case["cell"], device=dev)
    (msgs, _), d = _delta(K, lambda: _with_env({"KPBP_LINALG": "gram"}, lambda: S.belief_propagation(
        cell, SQ_N, SQ_D, SQ_CHI_MSG, chi=SQ_CHI)))
    _add(counts, d)
    gap = max(_msg_gaps(M, {int(s): m.sites for s, m in msgs.items()}, want_msgs).values())
    res["gram_bp"] = {"launches": d, "distance_to_jax": gap}
    print(f"square BP n={SQ_N} D={SQ_D} under KPBP_LINALG=gram: launches {json.dumps(d)}; messages "
          f"{gap:.3e} from the JAX package's (tol {SQ_TOL:g})")
    if sum(d[v] for v in K2_VARIANTS) < 1 or not gap < SQ_TOL:
        raise AssertionError(f"the gram square BP did not launch K2 or misses {SQ_TOL}: {res['gram_bp']}")
    return res, counts


# phase 12: the distribution layer (parallel/*) on one card. Every group's
# ranks share cuda:0 over gloo (parallel/launch prints its rule and devices).
P_N, P_D, P_CHI = 2, 3, 18        # phase 6's sweep: the pin cell and phase 6's messages
P_SIDE_TOL = {"complex128": 1e-10, "complex64": 2e-5}   # sharded against batched, by distance
P_REPS = 2                        # sweeps per timed run, the first a warm-up
P_CHAIN_SEED = 12                 # the multichain ITE's second chain, drawn with numpy
P_MC_TOL = 1e-8                   # multichain ITE energy against one process, complex128
P_CS_TOL = 1e-9                   # χ-sharded against unsharded, complex128, full-rank sketch
# KPBP_SKETCH_RANK above every row count, and no power iteration: at full
# rank the sketch's Q is square and unitary, so the swallow is exact and the
# power iterations change nothing but the memory (9.35 GiB more per rank at
# D=6 in complex128, which two ranks on one card do not have)
P_CS_FULL_RANK = {"KPBP_SKETCH_RANK": "1000000000", "KPBP_SKETCH_POWER": "0"}
P_SW_SWEEPS = 1                   # bp_worker's BP cut to this many sweeps per point (2 before phase 13)
P_SW_TOL = 1e-10                  # a point's result, one worker against four, complex128
P_Q64 = (2, 2, 8, 12)             # N, D, χ_msg, χ of the complex64 QR repair's sweep
P_Q64_TOL = 2e-5
GROUP_DEVICE = "cuda"             # where the groups and sweep workers run (the card)


def _timed_reps(torch, fn, reps):
    """(last result, seconds per call), each call ended by a synchronise."""
    secs, out = [], None
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return out, secs


def _cpu(x):
    from kagomeperiodicbp_tpu_torch.parallel import launch

    return launch.moved(x, "cpu")


def _rank_launches(reports, total):
    """Add every rank's launches to `total`; return them per rank."""
    per = [r["launches"] for r in reports]
    for c in per:
        _add(total, c)
    return per


def side_sharded_checks(torch, C, B, M, MC, launch, UnitCell, cell64, msgs64, total, dev):
    """Phase 12.1: the side-sharded sweep on 3 ranks against the batched
    sweep in this process, complex128 and complex64, both timed."""
    cell128 = UnitCell.load(PIN_CELL, device=dev).astype(torch.complex128).force_zero_rotation()
    calls, refs = [], {}
    for name, cell in (("complex128", cell128), ("complex64", cell64)):
        dt = getattr(torch, name)
        sites = {s: tuple(x.to(dt) for x in ss) for s, ss in msgs64.items()}
        fused = C.fused_cells(cell)
        run = B.bp_iteration_batched(P_N, P_D, P_CHI, P_CHI, None)
        refs[name] = _timed_reps(torch, lambda: run(fused, sites), P_REPS)
        calls.append((MC.sharded_sweep_task, (_cpu(fused), _cpu(sites), P_N, P_D, P_CHI, P_CHI,
                                              P_REPS)))
    t0 = time.perf_counter()
    got = launch.run_each(3, calls, device=GROUP_DEVICE)
    group_s = time.perf_counter() - t0
    out = {"group_s": group_s}
    for (name, (ref, ref_s)), res in zip(refs.items(), got):
        new, err = res["out"]
        gaps = _msg_gaps(M, new, ref[0])
        row = {"max_distance": max(gaps.values()), "err_gap": abs(float(err) - float(ref[1])),
               "sharded_s": res["seconds"], "batched_s": ref_s,
               "sharded_median_s": statistics.median(res["seconds"][1:]),
               "batched_median_s": statistics.median(ref_s[1:]),
               "devices": [r["device"] for r in res["ranks"]],
               "launches": _rank_launches(res["ranks"], total)}
        out[name] = row
        print(f"side-sharded sweep N={P_N} D={P_D} chi={P_CHI} {name}, 3 ranks on "
              f"{row['devices']}: {row['sharded_median_s'] * 1e3:.1f} ms per sweep (median of "
              f"{P_REPS - 1} after one warm-up) against {row['batched_median_s'] * 1e3:.1f} ms "
              f"batched in one process; messages {row['max_distance']:.3e} apart (tol "
              f"{P_SIDE_TOL[name]:g}), mean distance {row['err_gap']:.3e}")
        if not (row["max_distance"] < P_SIDE_TOL[name] and row["err_gap"] < P_SIDE_TOL[name]):
            raise AssertionError(f"side-sharded sweep {name} differs from the batched one: {row}")
    print(f"side-sharded group: {group_s:.1f} s wall, spawn and both runs")
    return out


def multichain_inputs(torch, C, F, UnitCell, ite_in, dev):
    """Two chains, c128: the pin cell with phase 8's BP messages, and a D=3
    cell drawn with numpy from P_CHAIN_SEED with its own BP messages (N=2,
    χ_msg=18), the messages an ITE step gets in production. (From uniform
    messages one sweep leaves that cell's environment far from BP's, and
    there the update's ALS amplifies the sharded and unsharded sweeps'
    round-off past the bar: the update's conditioning, ROADMAP queue 3.)"""
    import numpy as np

    from kagomeperiodicbp_tpu_torch.algo.bp import BPConfig, robust_belief_propagation
    from kagomeperiodicbp_tpu_torch.convert import unit_cell_from_numpy

    pin, pin_sites, h = ite_in
    rng, shape = np.random.default_rng(P_CHAIN_SEED), (2,) + (pin.D,) * 4

    def one():
        t = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
        return t / np.linalg.norm(t)

    drawn = unit_cell_from_numpy({"A": one(), "B": one(), "C": one()}, device=dev)
    bp, st = robust_belief_propagation(drawn, None, BPConfig(trunc_dim=ITE_CHI_MSG,
                                                             dtype=torch.complex128), ITE_N)
    print(f"multichain inputs: BP on the drawn D={pin.D} cell at N={ITE_N}, "
          f"chi_msg={ITE_CHI_MSG}, c128: {st.iterations} iterations, error {st.final_error:.3e}")
    cells, msgs = [pin, drawn], [pin_sites, F._msgs_to_sites(bp)]
    batch = tuple(torch.stack([c[f] for c in cells]) for f in "ABC")
    msg_batch = {s: tuple(torch.stack([m[s][k] for m in msgs]) for k in range(len(msgs[0][s])))
                 for s in msgs[0]}
    return cells, msgs, batch, msg_batch, torch.as_tensor(h, dtype=torch.complex128, device=dev)


def multichain_checks(torch, C, F, B, MC, launch, UnitCell, UpdateEdge, ite_in, total, dev):
    """Phase 12.4 and 12.2 in one group of 6 ranks (dp=2, side=3):
    dryrun_multichip's c64 and c128 passes; then the multichain ITE step
    under KPBP_LINALG=gram in complex128, twice on the same inputs (the
    first takes 15–19 s on an H100 with the dryrun run before it or not:
    the gram path's first use in each rank, as the dryrun runs default
    linear algebra), timed and held chain by chain to the same step in
    this process."""
    cells, msgs, batch, msg_batch, h = multichain_inputs(torch, C, F, UnitCell, ite_in, dev)
    D, edge = cells[0].D, UpdateEdge.all_options()[0]  # (A,B)
    args = ("ite", _cpu(batch), _cpu(msg_batch), _cpu(h), ITE_N, D, ITE_CHI, ITE_CHI_MSG, edge,
            ITE_DT, ITE_ALS, 2)
    calls = [(MC.dryrun_pass, (name, P_D, P_N, P_CHI)) for name in MC.DRYRUN_PASSES]
    calls += [(launch.with_env, ({"KPBP_LINALG": "gram"}, MC.multichain_task, *args))]
    t0 = time.perf_counter()
    got = launch.run_each(6, calls, device=GROUP_DEVICE)
    group_s = time.perf_counter() - t0

    def one_process():
        out = []
        for cell, sites in zip(cells, msgs):
            new, err = B.bp_iteration_batched(ITE_N, D, ITE_CHI, ITE_CHI_MSG, None)(
                C.fused_cells(cell), sites)
            t1, t2, env = F._edge_env((cell.A, cell.B, cell.C), new, ITE_N, ITE_CHI, ITE_CHI_MSG, edge)
            out.append(F._gate_als(t1, t2, env, h, ITE_DT, D, ITE_ALS, True)[2])
        return torch.stack(out)

    ref, ref_s = _timed_reps(torch, lambda: _with_linalg("gram", one_process), 2)
    ite = got[-1]
    energies = ite["out"][3]
    gaps = (energies - ref.cpu()).abs()
    res = {"energies": energies.tolist(), "one_process_energies": ref.tolist(),
           "gaps": gaps.tolist(), "errs": ite["out"][2].tolist(), "seconds": ite["seconds"],
           "one_process_s": ref_s, "devices": [r["device"] for r in ite["ranks"]],
           "launches": _rank_launches(ite["ranks"], total), "group_s": group_s}
    print(f"multichain ITE step (dp=2, side=3) N={ITE_N} D={D} chi_env={ITE_CHI} chi_msg={ITE_CHI_MSG} "
          f"edge {edge} als_iters={ITE_ALS} dt={ITE_DT} c128 KPBP_LINALG=gram, ranks on "
          f"{res['devices']}: {', '.join(f'{s:.2f}' for s in ite['seconds'])} s per step (the first "
          f"a warm-up) against {', '.join(f'{s:.2f}' for s in ref_s)} s for both chains in one "
          f"process; energies {res['energies']}, against one process {max(res['gaps']):.3e} "
          f"(tol {P_MC_TOL:g}); K1/K2 launches per rank "
          + "; ".join(f"{i}: K1 {c['fused_tensor']}, K2 {c['chol_inv_resident']} resident + "
                      f"{c['chol_inv_blocked']} blocked + {c['chol_inv_tiled']} tiled"
                      for i, c in enumerate(res["launches"])))
    if not max(res["gaps"]) < P_MC_TOL:
        raise AssertionError(f"multichain ITE step differs from one process: {res}")
    dry = {}
    for summary in got[:-1]:
        summary["launches"] = _rank_launches(summary.pop("ranks"), total)
        dry[summary["dtype"]] = summary
    print(f"multichain group (dryrun c64 and c128, ITE step): {group_s:.1f} s wall")
    return {"ite": res, "dryrun": dry}


def chi_shard_checks(torch, C, M, CS, launch, UnitCell, BlockSide, total, dev):
    """Phase 12.3: one single-layer per-side call at phase 9's size (D=6,
    χ 72/82, c128, toward U), its swallow blobs' rows split over 2 ranks,
    against the unsharded call in this process, on phase 9's identity input
    (the pin cell padded to D=6, uniform messages). Held at P_CS_TOL with
    the sketch at full rank, which makes the sketched swallow exact;
    printed at the default rank. (On a random D=6 cell with dense random
    messages the call turns any change of its arithmetic into O(0.1) apart,
    a 1e-15 change of the cell included: tools/chi_shard_check.py, ROADMAP
    queue 3.)"""
    c128 = torch.complex128
    pin6 = (UnitCell.load(PIN_CELL).astype(c128).force_zero_rotation()
            .pad_to(SL_D, generator=torch.Generator().manual_seed(0)))
    uniform = C.initial_messages(SL_N, SL_D, SL_CHI_MSG, dtype=c128)
    cases = [("pin6_full_rank", pin6, uniform, P_CS_FULL_RANK),
             ("pin6_default_rank", pin6, uniform, {})]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    got = launch.run_each(2, [(launch.with_env, (env, CS.outgoing_message_task, cell, msgs, SL_N,
                                                 SL_D, SL_CHI, SL_CHI_MSG, int(BlockSide.U), True))
                              for _, cell, msgs, env in cases], device=GROUP_DEVICE)
    group_s = time.perf_counter() - t0

    def unsharded(cell, msgs, env):
        cell_d, msgs_d = cell.to_device(dev), launch.moved(msgs, dev)
        return _timed_reps(torch, lambda: _with_env(env, lambda: C.outgoing_message_single(
            cell_d, msgs_d, SL_N, SL_D, SL_CHI, SL_CHI_MSG, BlockSide.U)), 1)

    out = {"group_s": group_s}
    for (name, cell, msgs, env), res in zip(cases, got):
        ref, ref_s = unsharded(cell, msgs, env)
        dist = float(M.distance(res["out"], _cpu(ref)))
        parts = [r["partitioned"] for r in res["ranks"]]
        out[name] = {"distance": dist, "sharded_s": res["seconds"], "unsharded_s": ref_s,
                     "partitioned": parts, "launches": _rank_launches(res["ranks"], total)}
        note = f"tol {P_CS_TOL:g}" if name == "pin6_full_rank" else "printed"
        print(f"chi-sharded single-layer per-side call D={SL_D} N={SL_N} chi_msg={SL_CHI_MSG} "
              f"chi={SL_CHI} c128, {name.replace('_', ' ')}, 2 ranks: {res['seconds'][0]:.2f} s "
              f"against {ref_s[0]:.2f} s unsharded; distance {dist:.3e} ({note}); partitioned "
              "swallows and rows per rank "
              + "; ".join(f"{i}: {p['swallows']} swallows, {p['rows']} of {p['of_rows']} rows"
                          for i, p in enumerate(parts)))
        if any(p["swallows"] < 1 or p["rows"] >= p["of_rows"] for p in parts):
            raise AssertionError(f"the χ-sharded call did not split its rows: {parts}")
    if not out["pin6_full_rank"]["distance"] < P_CS_TOL:
        raise AssertionError(f"χ-sharded message differs from the unsharded one: {out}")
    print(f"chi-shard group: {group_s:.1f} s wall")
    return out


def concurrent_sweep_checks(torch, sweep, total):
    """Phase 12.5: run_sweep over 4 points (bp_worker, D=2 and 3, seeds 0
    and 1, BP cut to P_SW_SWEEPS sweeps and one attempt) with one worker,
    then four, all on cuda:0: every point's result the same, wall times and
    points per second."""
    import tempfile

    cut = (("max_iterations", P_SW_SWEEPS), ("allowed_retries", 0))
    pts = [sweep.SweepPoint(D=D, N=2, seed=s, method="bp", extra=cut) for D in (2, 3) for s in (0, 1)]
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for n in (1, 4):
            t0 = time.perf_counter()
            res = sweep.run_sweep(pts, sweep.bp_worker, csv_path=os.path.join(tmp, f"{n}.csv"),
                                  n_workers=n, child_device=GROUP_DEVICE)
            wall = time.perf_counter() - t0
            bad = [r for r in res if "error" in r]
            if bad:
                raise AssertionError(f"run_sweep with {n} worker(s) failed points: {bad}")
            for r in res:
                _add(total, r["launches"])
            runs[n] = {"wall_s": wall, "points_per_s": len(pts) / wall,
                       "bp_s": [r["duration"] for r in res], "devices": [r["device"] for r in res],
                       "results": [{k: r[k] for k in ("bp_error", "iterations")} for r in res]}
            print(f"run_sweep bp_worker, 4 points (D=2, 3 x seeds 0, 1; BP cut to {P_SW_SWEEPS} "
                  f"sweeps), {n} worker(s) on {sorted(set(runs[n]['devices']))}: {wall:.2f} s wall "
                  f"({runs[n]['points_per_s']:.3f} points/s), BP per point "
                  f"{', '.join(f'{s:.2f}' for s in runs[n]['bp_s'])} s")
    gaps = [abs(a["bp_error"] - b["bp_error"]) for a, b in zip(runs[1]["results"], runs[4]["results"])]
    same = all(a["iterations"] == b["iterations"] for a, b in zip(runs[1]["results"], runs[4]["results"]))
    print(f"run_sweep: one worker against four, largest bp_error gap {max(gaps):.3e} (tol "
          f"{P_SW_TOL:g}), iterations {'equal' if same else 'differ'}; speed-up "
          f"{runs[1]['wall_s'] / runs[4]['wall_s']:.2f}x wall")
    if not (same and max(gaps) < P_SW_TOL):
        raise AssertionError(f"run_sweep results differ between one and four workers: {runs}")
    runs["max_gap"] = max(gaps)
    return runs


def c64_qr_sweep(torch, K, C, F, B, M, UnitCell, dev):
    """Phase 12.6: the complex64 sweep of the CPU QR repair (N=2, D=2,
    χ_msg=8, χ=12, uniform messages) on the card, per side and batched (its
    batched complex64 QRs factored in complex128 by ``ops/linalg._qr``: the
    card's batched complex64 QR gave non-finite factors here), against the
    complex128 sweep by distance."""
    n, d, chi_msg, chi = P_Q64
    cell = UnitCell.random(2, d, torch.Generator().manual_seed(0)).to_device(dev)
    out = {}
    for name, make in (("per_side", F.bp_iteration), ("batched", B.bp_iteration_batched)):
        new = {}
        for dt in (torch.complex64, torch.complex128):
            sites = F._msgs_to_sites(C.initial_messages(n, d, chi_msg, dtype=dt, device=dev))
            new[dt] = make(n, d, chi, chi_msg, None)(C.fused_cells(cell.astype(dt)), sites)[0]
        finite = all(bool(torch.isfinite(x).all()) for ss in new[torch.complex64].values() for x in ss)
        up = {s: tuple(x.to(torch.complex128) for x in ss) for s, ss in new[torch.complex64].items()}
        gap = max(_msg_gaps(M, up, new[torch.complex128]).values())
        out[name] = {"finite": finite, "distance_to_c128": gap}
        print(f"c64 sweep N={n} D={d} chi_msg={chi_msg} chi={chi} {name} on the card: finite "
              f"{finite}, {gap:.3e} from the c128 sweep (tol {P_Q64_TOL:g})")
        if not (finite and gap < P_Q64_TOL):
            raise AssertionError(f"the c64 sweep {name} failed on the card: {out[name]}")
    return out


# phase 13: large D and records. The D=7 check holds the pin cell padded to
# D=7 (no noise, its messages padded alike) against the unpadded pin at the
# same N and χ: the padded bonds carry zeros, so the state and its energies
# are the D=3 pin's; at D=7, χ 98/108 the blob rule contracts the edge
# environments single-layer (a·b·D⁶ = 1.25e9 > 3e8)
LD7_D, LD7_N, LD7_CHI_MSG, LD7_CHI = 7, 2, 98, 108
LD7_TOL = 1e-8        # complex128
# the D=8 work unit of large_d_demo (χ_msg = 2D² = 128, χ = 138), complex64,
# on a numpy-seeded random cell from uniform messages
LD8_D, LD8_N, LD8_CHI_MSG, LD8_CHI = 8, 2, 128, 138
REC_TOL = 1e-10       # the record entry points, card against the CPU port, complex128
# measure_padded at D=3 (no noise) against the D=2 record's energy: the JAX
# script's own energies move by up to 1.6e-8 at a zero pad under a 1e-15 move
# of the cell (tools/torch_cpu_checks.py pad); 3× that
REC_PAD_TOL = 5e-8
# the D=8 edge environment, single-layer against double-layer, at a χ where
# the double-layer plans fit: both truncate the same matrices
LD8_ENV_CHI_MSG, LD8_ENV_CHI = 16, 26
# bp_accuracy's exact environment at D=2, N=2 at χ=16, below the script's
# default 40: the card is held to the CPU at the same χ, and at 40 the CPU
# side took 25 s beside 9.5 s on the card (an H100 machine's 8 cores)
REC_EXACT_CHI = 16
BEST_STORE = os.path.join(REPO, "data", "unit_cells", "best")


def ld_padded_pin(torch, C, E, CT, MS, BP, UnitCell, hamiltonians, uncounted, dev):
    """Phase 13.1: the six edge energies of the pin cell padded to D=7, its
    BP messages (N=2, χ_msg=98, χ=108, complex128) padded alike, through the
    single-layer environment the blob rule picks, against the unpadded pin's
    (double-layer) at the same N and χ, held at LD7_TOL. The pin's BP and
    measurement run through `uncounted`. The swallows are printed: the
    bonds' shapes, and so the kinds, do not depend on the values, and no
    lattice step of the environment takes the sketched swallow."""
    c128 = torch.complex128
    h = hamiltonians.heisenberg_afm()
    pin = UnitCell.load(PIN_CELL, device=dev).astype(c128).force_zero_rotation()
    cfg = BP.BPConfig(trunc_dim=LD7_CHI_MSG, bubble_trunc_dim=LD7_CHI, dtype=c128)
    msgs, st = uncounted(BP.robust_belief_propagation, pin, None, cfg, LD7_N)
    rules = {D: E.env_single_layer(D, LD7_CHI, LD7_CHI_MSG) for D in (pin.D, LD7_D)}
    if rules != {pin.D: False, LD7_D: True}:
        raise AssertionError(f"the blob rule picked {rules} (single-layer?) at chi {LD7_CHI_MSG}/{LD7_CHI}")
    t0 = time.perf_counter()
    ref = uncounted(MS.measure_energies_and_observables, pin, msgs, LD7_N, LD7_CHI, LD7_CHI_MSG, h)
    ref_s = time.perf_counter() - t0
    cell7 = pin.pad_to(LD7_D, noise_fraction=0)
    msgs7 = C.pad_messages(msgs, LD7_N, LD7_D, LD7_CHI_MSG)
    CT.reset_swallow_counts()
    _fresh_peak(torch)
    t0 = time.perf_counter()
    got = MS.measure_energies_and_observables(cell7, msgs7, LD7_N, LD7_CHI, LD7_CHI_MSG, h)
    s7, swallows, peak = time.perf_counter() - t0, CT.swallow_counts(), _peak_gb(torch)
    gap = max(abs(got.energies[k] - v) for k, v in ref.energies.items())
    res = {"config": {"D": LD7_D, "N": LD7_N, "chi_msg": LD7_CHI_MSG, "chi": LD7_CHI, "dtype": "complex128",
                      "single_layer_env": True},
           "bp_error": st.final_error, "bp_mode": st.mode, "d3_measure_s": ref_s, "d7_measure_s": s7,
           "d7_peak_gb": peak, "swallows": swallows, "mean_energy": got.mean_energy,
           "d3_mean_energy": ref.mean_energy, "gap": gap}
    print(f"large D: the pin padded to D={LD7_D}, N={LD7_N}, chi_msg={LD7_CHI_MSG}, chi={LD7_CHI}, c128: "
          f"six edge energies {gap:.3e} from the unpadded pin's (tol {LD7_TOL:g}); mean "
          f"{got.mean_energy!r} against {ref.mean_energy!r}; D={LD7_D} measurement {s7:.2f} s, peak "
          f"{peak:.2f} GB, swallows {json.dumps(swallows)}; D=3 measurement {ref_s:.2f} s; BP "
          f"{st.mode}, error {st.final_error:.3e}")
    if not (gap < LD7_TOL and swallows["fused"] == 0 and swallows["direct"] > 0
            and swallows["sketched"] == 0):
        raise AssertionError(f"the padded D={LD7_D} pin, single-layer, against the pin: {res}")
    return res


def ld_d8(torch, K, L, C, F, CT, UnitCell, BlockSide, UpdateEdge, hamiltonians, dev):
    """Phase 13.2: large_d_demo's D=8 work unit in complex64 (N=2, χ_msg=128,
    χ=138) on a numpy-seeded random cell from uniform messages: one
    single-layer per-side call, timed, with peak device memory and swallows
    by kind; one ITE edge update (A,B) on its message and uniform ones (the
    blob rule: single-layer boundary plans), timed with peak memory, which
    must be finite and healthy with one K1 launch; one per-side call under
    KPBP_LINALG=gram, every size it hands K2 recorded. Returns the record and
    the K2 sizes."""
    from kagomeperiodicbp_tpu_torch.convert import numpy_random_cell, unit_cell_from_numpy

    c64 = torch.complex64
    cell = unit_cell_from_numpy(numpy_random_cell(LD8_D, 0), dev, c64)
    kets = (cell.A, cell.B, cell.C)
    sites = F._msgs_to_sites(C.initial_messages(LD8_N, LD8_D, LD8_CHI_MSG, dtype=c64, device=dev))
    side = lambda: F._one_side_update(kets, sites, LD8_N, LD8_D, LD8_CHI, LD8_CHI_MSG,  # noqa: E731
                                      int(BlockSide.U), None, True)
    CT.reset_swallow_counts()
    _fresh_peak(torch)
    t0 = time.perf_counter()
    new, dist = side()
    dist = float(dist)
    per_side = {"s": time.perf_counter() - t0, "peak_gb": _peak_gb(torch),
                "swallows": CT.swallow_counts(), "distance": dist}
    print(f"large D: single-layer per-side call D={LD8_D} N={LD8_N} chi_msg={LD8_CHI_MSG} chi={LD8_CHI} "
          f"c64 (random cell, uniform messages): {per_side['s']:.2f} s, peak {per_side['peak_gb']:.2f} GB, "
          f"swallows {json.dumps(per_side['swallows'])}, distance {dist:.3e}")
    if not (dist == dist and all(bool(torch.isfinite(x).all()) for x in new)):
        raise AssertionError(f"the D={LD8_D} per-side call gave non-finite messages: {per_side}")

    msg = dict(sites)
    msg[int(BlockSide.U.opposite())] = new
    h = torch.as_tensor(hamiltonians.heisenberg_afm(), dtype=c64, device=dev)
    edge = UpdateEdge.all_options()[0]  # (A,B)
    upd = F.edge_update(LD8_N, LD8_D, LD8_CHI, LD8_CHI_MSG, edge, ITE_ALS, True)
    before = K.launch_counts()["fused_tensor"]
    L.reset_eigh_retries()
    _fresh_peak(torch)
    t0 = time.perf_counter()
    cells, energy, herm, sum_eig, neg = upd(kets, msg, h, ITE_DT)
    scalars = torch.stack([energy, herm, sum_eig.real, neg]).tolist()
    update = {"s": time.perf_counter() - t0, "peak_gb": _peak_gb(torch),
              "k1_launches": K.launch_counts()["fused_tensor"] - before, "energy": scalars[0],
              "herm": scalars[1], "sum_eig": scalars[2], "negativity": scalars[3],
              "eigh_retries": L.eigh_retries()}
    finite = all(bool(torch.isfinite(t).all()) for t in cells)
    print(f"large D: ITE edge update D={LD8_D} chi_env={LD8_CHI} edge {edge} c64 (single-layer "
          f"environment): {update['s']:.2f} s, peak {update['peak_gb']:.2f} GB; K1 launches "
          f"{update['k1_launches']}; finite {finite}; energy {scalars[0]:.8f}, hermiticity {scalars[1]:.2e}, "
          f"eigenvalue sum {scalars[2]:.6f}, negativity {scalars[3]:.2e}; shifted eigh retries "
          f"{json.dumps(update['eigh_retries'])}")
    if update["k1_launches"] != 1 or not finite or not abs(scalars[2] - 1) < C64_TOL:
        raise AssertionError(f"the D={LD8_D} edge update failed: {update}")

    before = K.launch_counts()
    _fresh_peak(torch)
    t0 = time.perf_counter()
    _, k_seen = k2_sizes(L, lambda: _with_env({"KPBP_LINALG": "gram"},
                                              lambda: [x.sum().item() for x in side()[0][:1]]))
    counts = K.launch_counts()
    gram = {"s": time.perf_counter() - t0, "peak_gb": _peak_gb(torch),
            "launches": {n: counts[n] - before[n] for n in counts},
            "k2_sizes": {str(k): c for k, c in sorted(k_seen.items())}}
    print(f"large D: per-side call D={LD8_D} under KPBP_LINALG=gram: {gram['s']:.2f} s, peak "
          f"{gram['peak_gb']:.2f} GB; launches {json.dumps(gram['launches'])}; K2 sizes k:calls "
          f"{json.dumps(gram['k2_sizes'])}")
    large = k2_large(K, k_seen, c64)
    if gram["launches"][large] < 1 or gram["launches"]["chol_inv_resident"] < 1:
        raise AssertionError(f"the D={LD8_D} gram per-side call did not launch K2 resident and {large}: {gram}")
    return {"config": {"D": LD8_D, "N": LD8_N, "chi_msg": LD8_CHI_MSG, "chi": LD8_CHI, "dtype": "complex64"},
            "per_side": per_side, "edge_update": update, "gram_per_side": gram}, k_seen


def ld_d8_environment(torch, E, IK, L, UpdateEdge, CT, uncounted, dev):
    """Phase 13.3: the D=8 edge environment of edge (A,B) on a numpy-seeded
    random cell and numpy-drawn product messages at χ_msg=16, χ=26,
    complex128, single-layer (the plans the blob rule picks from D=7)
    against double-layer, which runs through `uncounted`: the pair's
    trace-normalised RDM with exact SVDs (L.RSVD_MIN_DIM lifted), held at
    SL_ID_TOL, with the single-layer swallows by kind; with the default
    randomized SVD (frontier matrices of 1024 rows), whose sketch sees each
    path's own rounding, the two are printed."""
    from kagomeperiodicbp_tpu_torch.convert import numpy_product_messages, numpy_random_cell

    c128 = torch.complex128
    cell_np = numpy_random_cell(LD8_D, 1)
    cells = tuple(torch.as_tensor(cell_np[f], dtype=c128, device=dev) for f in "ABC")
    sites = {s: tuple(torch.as_tensor(x, dtype=c128, device=dev) for x in ss)
             for s, ss in numpy_product_messages(LD8_N, LD8_D, LD8_ENV_CHI_MSG, 2).items()}
    edge = UpdateEdge.all_options()[0]

    def rdm(single):
        t1, t2, env, _ = E.edge_environment_sites(cells, sites, LD8_N, LD8_ENV_CHI, LD8_ENV_CHI_MSG,
                                                  edge, single_layer=single)
        r = IK.rho_ij(t1, t2, env)
        return r / torch.einsum("iijj->", r)

    def pair():
        rho, secs = {}, {}
        for single in (True, False):
            CT.reset_swallow_counts()
            t0 = time.perf_counter()
            rho[single] = rdm(True) if single else uncounted(rdm, False)
            torch.cuda.synchronize()
            secs[single] = time.perf_counter() - t0
            if single:
                swallows = CT.swallow_counts()
        return (rho[True] - rho[False]).abs().max().item(), secs, swallows

    rsvd_gap, _, _ = pair()
    min_dim = L.RSVD_MIN_DIM
    L.RSVD_MIN_DIM = 10 ** 9
    try:
        gap, secs, swallows = pair()
    finally:
        L.RSVD_MIN_DIM = min_dim
    res = {"config": {"D": LD8_D, "N": LD8_N, "chi_msg": LD8_ENV_CHI_MSG, "chi": LD8_ENV_CHI,
                      "dtype": "complex128", "edge": str(edge)},
           "gap": gap, "randomized_svd_gap": rsvd_gap, "single_s": secs[True], "double_s": secs[False],
           "swallows": swallows}
    print(f"large D: edge environment D={LD8_D} chi_msg={LD8_ENV_CHI_MSG} chi={LD8_ENV_CHI} c128, edge {edge}: "
          f"single-layer RDM {gap:.3e} from the double-layer one with exact SVDs (tol {SL_ID_TOL:g}), "
          f"{rsvd_gap:.3e} with the randomized SVD; {secs[True]:.2f} s against {secs[False]:.2f} s; "
          f"single-layer swallows {json.dumps(swallows)}")
    if not (gap < SL_ID_TOL and swallows["direct"] > 0 and swallows["sketched"] == 0):
        raise AssertionError(f"the D={LD8_D} single-layer edge environment: {res}")
    return res


def ld_demo(dev):
    """Phase 13.4: the entry point ``large_d_demo 7 --sweeps 1`` on the card
    (χ_msg=98, χ=108, complex64: one single-layer BP sweep, then one ITE
    edge update through the single-layer environment). It zeroes the
    launch counts itself and returns its own; its record must be whole,
    finite and healthy, with K1 launched."""
    import math

    from kagomeperiodicbp_tpu_torch import large_d_demo

    rec = large_d_demo.main([str(LD7_D), "--sweeps", "1", "--device", str(dev)])
    ok = ("error" not in rec and rec["bp_sweeps"] == 1 and rec["single_layer"]
          and rec["single_layer_env"] and math.isfinite(rec["energy"])
          and abs(rec["ite_health"]["sum_eigenvalues"] - 1) < C64_TOL
          and rec["launches"]["fused_tensor"] >= 1)
    print(f"large D: large_d_demo {LD7_D} --sweeps 1: {rec['s_per_sweep']:.2f} s per sweep, error "
          f"{rec['bp_err']:.3e}, edge update {rec['ite_step_s']:.2f} s, energy {rec['energy']:.8f}, peak "
          f"{rec['peak_device_gb']:.2f} GB; launches {json.dumps(rec['launches'])}")
    if not ok:
        raise AssertionError(f"large_d_demo {LD7_D} failed on the card: {rec}")
    return rec


def ld_k2_checks(torch, K, dev, k_seen):
    """Phase 13.6, after the launch counts are read: K2 at every size the D=8
    gram call gave it, in complex64 on SPD matrices drawn on the card,
    against its plain version (K2_TOL), and its kernel time there (phase 3
    times the largest beside the plain version and the library call)."""
    c64 = torch.complex64
    gen = torch.Generator(device=dev).manual_seed(3)
    out = {}
    for k in sorted(k_seen):
        b = torch.randn((k, k), generator=gen, dtype=c64, device=dev)
        g = b @ b.mH + k * torch.eye(k, dtype=c64, device=dev)
        l, w = K.chol_inv_cuda(g)
        l_ref, w_ref = K.chol_inv_ref(g)
        err = max(((l - l_ref).abs().max() / l_ref.abs().max()).item(),
                  ((w - w_ref).abs().max() / w_ref.abs().max()).item())
        out[k] = {"calls": k_seen[k], "variant": K.chol_inv_plan(k, c64).variant, "rel_err": err,
                  "max_abs_err": max((l - l_ref).abs().max().item(), (w - w_ref).abs().max().item()),
                  "ms": _ms(torch, lambda: K.chol_inv_cuda(g), budget_ms=50.0, rounds=3)}
        del b, g, l, w, l_ref, w_ref
    worst = max(r["rel_err"] for r in out.values())
    print(f"large D: K2 at each D={LD8_D} gram size, complex64, against its plain version: largest rel_err "
          f"{worst:.3e} (tol {K2_TOL['complex64']:g}); " + ", ".join(
              f"k={k} {r['variant']} {r['calls']}×{r['ms']:.3f} ms" for k, r in out.items()))
    if not worst < K2_TOL["complex64"]:
        raise AssertionError(f"K2 disagrees with its plain version at a D={LD8_D} gram size: {out}")
    return out


def ld_records(torch, dev):
    """Phase 13.5: measure_padded at D=3 from the repository's D=2
    record (--no-store, no noise, the complex64 search with its complex128
    polish), its energy beside the record's; bp_accuracy (D=2, N=2; the
    random environment's messages drawn once with numpy, given to both) and
    load_external_su (a tnsu-format set of a numpy-drawn D=2 cell, written
    here), each on the card against the CPU port in complex128."""
    import tempfile

    from kagomeperiodicbp_tpu_torch import bp_accuracy, load_external_su, measure_padded
    from kagomeperiodicbp_tpu_torch.convert import (messages_from_numpy, numpy_product_messages,
                                                    numpy_random_cell, unit_cell_from_numpy)
    from kagomeperiodicbp_tpu_torch.utils.foreign import write_tnsu

    out = {}
    before = sorted(os.listdir(BEST_STORE))
    t0 = time.perf_counter()
    pad = measure_padded.main(["-D", "3", "--src", "2", "--noise", "0", "--no-store", "--bp-dtype",
                               "complex64", "--store-dir", BEST_STORE, "--device", str(dev)])
    gap = abs(pad["mean_energy"] - pad["src_energy"])
    out["measure_padded"] = {**pad, "gap_to_record": gap, "wall_s": time.perf_counter() - t0}
    print(f"records: measure_padded D=3 from the D=2 record: {pad['mean_energy']!r} beside the record's "
          f"{pad['src_energy']!r} ({gap:.3e}, tol {REC_PAD_TOL:g}); BP {pad['bp_mode']}, error "
          f"{pad['bp_error']:.3e}; {out['measure_padded']['wall_s']:.2f} s")
    if sorted(os.listdir(BEST_STORE)) != before or not gap < REC_PAD_TOL:
        raise AssertionError(f"measure_padded at D=3 failed: {out['measure_padded']}")

    D, N = 2, 2
    cell_np = numpy_random_cell(D, 0)
    msgs_np = numpy_product_messages(N, D, 2 * D * D, 11)
    rows, secs = {}, {}
    for label, where in (("card", dev), ("cpu", torch.device("cpu"))):
        t0 = time.perf_counter()
        rows[label] = bp_accuracy.accuracy_rows(
            unit_cell_from_numpy(cell_np, where), N, 2 * D * D, REC_EXACT_CHI,
            messages_from_numpy(msgs_np, where), log=lambda *_: None)
        secs[label] = time.perf_counter() - t0
    acc_gap = max(abs(a[k] - b[k]) for a, b in zip(rows["card"], rows["cpu"]) for k in bp_accuracy.DIGITS)
    out["bp_accuracy"] = {"gap": acc_gap, "rows": len(rows["card"]), "card_s": secs["card"],
                          "cpu_s": secs["cpu"],
                          "min_bp_fidelity": min(r["fidelity_vs_exact"] for r in rows["card"]
                                                 if r["method"] == "bp")}
    print(f"records: bp_accuracy D={D} N={N} (random, bp, exact × 6 edges), card against the CPU port: "
          f"{acc_gap:.3e} (tol {REC_TOL:g}); {secs['card']:.2f} s on the card, {secs['cpu']:.2f} s on the CPU; "
          f"smallest bp fidelity {out['bp_accuracy']['min_bp_fidelity']:.10f}")
    if not acc_gap < REC_TOL:
        raise AssertionError(f"bp_accuracy, card against CPU: {out['bp_accuracy']}")

    tn_cell = numpy_random_cell(D, 41)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, f"tnsu_AFH_D={D}_size=1_PBC.dat")
        write_tnsu(path, [tn_cell[f] for f in "ABC"])
        sets = {where: load_external_su.measure_set(path, N=N, device=where) for where in (str(dev), "cpu")}
    card, cpu = sets[str(dev)], sets["cpu"]
    su_gap = max([abs(card["edge_energies"][k] - v) for k, v in cpu["edge_energies"].items()]
                 + [abs(card["mean_energy"] - cpu["mean_energy"])])
    out["load_external_su"] = {"gap": su_gap, "mean_energy": card["mean_energy"], "chi": card["chi"]}
    print(f"records: load_external_su on a tnsu-format D={D} set: {card['mean_energy']!r} per site, card "
          f"against the CPU port {su_gap:.3e} (tol {REC_TOL:g})")
    if not su_gap < REC_TOL:
        raise AssertionError(f"load_external_su, card against CPU: {out['load_external_su']}")
    return out


# phase 14: the port's own work. The flop model's configuration is the JAX
# tool's (data/flops_model.json: N=2, D=3, χ=18, complex64), which is also
# bench_scaling's D=3 row (χ = 2D²); bench_scaling at D=2…5 with FL_SWEEPS
# timed sweeps each, after its first, timed alone
FL_N, FL_D, FL_CHI = 2, 3, 18
FLOPS_GOLD = os.path.join(REPO, "data", "flops_model.json")
FL_SWEEPS = 2
FL_BENCH_DS = (2, 3, 4, 5)
SUBPROCESS_TIMEOUT = 400


def _module_start(args):
    """python -m <args> from the repository root, started: (process, start time)."""
    return (subprocess.Popen([sys.executable, "-m", *args], cwd=REPO, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True), time.perf_counter())


def _module_finish(started, timeout=SUBPROCESS_TIMEOUT):
    """Wait for a command `_module_start` started: (rc, stdout, seconds from
    its start); its output is printed, indented. One that overruns
    `timeout` is killed and raises."""
    proc, t0 = started
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    secs = time.perf_counter() - t0
    for line in (out + err).splitlines():
        print(f"  | {line}")
    return proc.returncode, out, secs


def bench_scaling_start():
    """Phase 14.1: tools.bench_scaling at D=2…5, as a command of its own."""
    return _module_start(["kagomeperiodicbp_tpu_torch.tools.bench_scaling", *map(str, FL_BENCH_DS),
                          "--sweeps", str(FL_SWEEPS)])


def bench_scaling_check(started):
    """Phase 14.1: bench_scaling exits 0 with one row per D, the batched
    sweep at each, K1 once per D (the fused tensors) and K2 never (default
    linear algebra)."""
    rc, out, secs = _module_finish(started)
    rows = [json.loads(line) for line in out.splitlines() if line.startswith("{")]
    print(f"bench_scaling {' '.join(map(str, FL_BENCH_DS))} --sweeps {FL_SWEEPS}: rc {rc}, {secs:.1f} s; "
          + "; ".join(f"D={r['D']} {r.get('bp_mode')} {r.get('sweep_seconds', float('nan')) * 1e3:.1f} ms "
                      f"per sweep, {r.get('achieved_gflops', float('nan')):.2f} GFLOP/s, launches "
                      f"{json.dumps(r.get('launches'))}" for r in rows))
    if rc != 0 or [r.get("D") for r in rows] != list(FL_BENCH_DS):
        raise AssertionError(f"bench_scaling failed: rc {rc}, rows {rows}")
    for r in rows:
        n = r["launches"]
        if r["bp_mode"] != "batched" or n["fused_tensor"] != 1 or sum(n[v] for v in K2_VARIANTS):
            raise AssertionError(f"bench_scaling at D={r['D']}: {r['bp_mode']}, launches {n}")
    return {"rows": rows, "seconds": secs}


def flops_checks(torch, FM, bench_rows, sweep_s, update_s, dev):
    """Phase 14.2, after bench_scaling has ended: the flop model at the JAX
    tool's configuration, each count on the card equal to the CPU's count of
    the same call as integers: the batched sweep (counted on the card by
    bench_scaling, its D=3 row),
    the per-side sweep and the ITE edge update (counted here), beside the
    JAX tool's XLA count; then phase 6's median sweep time and phase 8's
    complex64 update time as achieved GFLOP/s and a share of the card's
    FP32 peak (PEAK_FLOPS, the rate the kernels' bounds use)."""
    with open(FLOPS_GOLD) as fh:
        gold = json.load(fh)[f"N{FL_N}_D{FL_D}_chi{FL_CHI}"]
    (bench_d3,) = [r for r in bench_rows if r["D"] == FL_D and r["chi"] == FL_CHI and r["N"] == FL_N]
    calls = {"batched_sweep": lambda d: FM.count_sweep(FL_N, FL_D, FL_CHI, FL_CHI, d, "batched"),
             "per_side_sweep": lambda d: FM.count_sweep(FL_N, FL_D, FL_CHI, FL_CHI, d, "double"),
             "ite_update": lambda d: FM.count_ite(FL_N, FL_D, FL_CHI, d)}
    out = {}
    for name, fn in calls.items():
        cpu = fn("cpu")
        if name == "batched_sweep":
            card = {"total": bench_d3["flops_per_sweep"], "split": None, "uncounted": None}
            same = card["total"] == cpu["total"]
        else:
            card = fn(dev)
            same = card["split"] == cpu["split"] and card["total"] == cpu["total"]
        if not same:
            raise AssertionError(f"flop model {name}: the card counts {card} and the CPU {cpu}")
        xla = gold["flops_per_ite_step" if name == "ite_update" else "flops_per_bp_sweep"]
        out[name] = {"flops": cpu["total"], "split": cpu["split"], "uncounted": cpu["uncounted"],
                     "xla_flops": xla, "xla_convention_gemm_over_xla": cpu["split"]["xla_convention_gemm"] / xla}
        print(f"flop model {name} N={FL_N} D={FL_D} chi={FL_CHI} c64: {cpu['total']} real flops on the card"
              f"{' (bench_scaling)' if name == 'batched_sweep' else ''} and on the CPU (equal); split "
              f"{json.dumps(cpu['split'])}; GEMMs at 2 per multiply-add {cpu['split']['xla_convention_gemm']} "
              f"= {out[name]['xla_convention_gemm_over_xla']:.4f} of data/flops_model.json's XLA count {xla:.0f}")
    if out["batched_sweep"]["flops"] != out["per_side_sweep"]["flops"]:
        raise AssertionError(f"the batched and per-side sweeps count differently: {out}")
    for name, secs, what in (("per_side_sweep", sweep_s, "phase 6 median"),
                             ("ite_update", update_s, "phase 8, c64 default")):
        rate = out[name]["flops"] / secs
        out[name].update({"seconds": secs, "achieved_gflops": rate / 1e9, "share_of_fp32_peak": rate / PEAK_FLOPS})
        print(f"flop model {name}: {secs * 1e3:.1f} ms ({what}) is {rate / 1e9:.2f} GFLOP/s, "
              f"{100 * rate / PEAK_FLOPS:.3f}% of {PEAK_FLOPS / 1e12:.0f} TFLOP/s")
    return out


def scripts_start(tmp, tracker_path):
    """Phase 14.3: the three scripts, each as a command of its own, started
    beside bench_scaling (none of them touches the card): create_kagome_elists
    -N 2, plot_afmh_benchmark (without --plot: this machine has no
    matplotlib) and unpack_ite_tracker on phase 8's tracker with --out."""
    outs = {"elist": os.path.join(tmp, "elist.json"), "cell": os.path.join(tmp, "cell.pkl")}
    runs = {"create_kagome_elists": ["-N", "2", "--out", outs["elist"]],
            "plot_afmh_benchmark": [],
            "unpack_ite_tracker": [tracker_path, "--out", outs["cell"]]}
    return outs, {name: _module_start([f"kagomeperiodicbp_tpu_torch.{name}", *argv])
                  for name, argv in runs.items()}


def scripts_check(started, UnitCell, elists, afmh_lines, best_cell):
    """Phase 14.3: each script exits 0; the edge list and the table equal
    this process's, and the unpacked cell, read back, the tracker's best."""
    outs, procs = started
    res, printed = {}, {}
    for name, proc in procs.items():
        rc, printed[name], secs = _module_finish(proc, timeout=120)
        res[name] = {"rc": rc, "seconds": secs}
        if rc != 0:
            raise AssertionError(f"{name} exited {rc}")
    with open(outs["elist"]) as fh:
        if json.load(fh) != elists(2):
            raise AssertionError("create_kagome_elists wrote another edge list than this process makes")
    if printed["plot_afmh_benchmark"].splitlines() != afmh_lines:
        raise AssertionError("plot_afmh_benchmark printed another table than this process makes")
    back = UnitCell.load(outs["cell"])
    gap = max((back[f] - best_cell[f].cpu()).abs().max().item() for f in "ABC")
    res["unpack_ite_tracker"]["cell_gap"] = gap
    if gap != 0.0:
        raise AssertionError(f"unpack_ite_tracker's cell differs from the tracker's best by {gap}")
    print(f"scripts: create_kagome_elists, plot_afmh_benchmark, unpack_ite_tracker exit 0 in "
          + ", ".join(f"{r['seconds']:.1f}" for r in res.values())
          + " s (beside bench_scaling); the edge list and the table equal this process's, the unpacked "
            "cell the tracker's best (gap 0)")
    return res


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
    from kagomeperiodicbp_tpu_torch import increasing_block_measurements as IBM
    from kagomeperiodicbp_tpu_torch import measure
    from kagomeperiodicbp_tpu_torch import run_square
    from kagomeperiodicbp_tpu_torch.algo import arbitrary as A
    from kagomeperiodicbp_tpu_torch.algo import batched as B
    from kagomeperiodicbp_tpu_torch.algo import contraction as C
    from kagomeperiodicbp_tpu_torch.algo import edge_env as E
    from kagomeperiodicbp_tpu_torch.algo import fused as F
    from kagomeperiodicbp_tpu_torch.algo import ite as I
    from kagomeperiodicbp_tpu_torch.algo import bp as BP
    from kagomeperiodicbp_tpu_torch.algo import measurements as MS
    from kagomeperiodicbp_tpu_torch.algo import simple_update as SU
    from kagomeperiodicbp_tpu_torch.algo.bp import BPConfig, robust_belief_propagation
    from kagomeperiodicbp_tpu_torch.enums import UpdateEdge
    from kagomeperiodicbp_tpu_torch.lattices import BlockSide
    from kagomeperiodicbp_tpu_torch.networks.unit_cell import UnitCell
    from kagomeperiodicbp_tpu_torch.ops import contract as CT
    from kagomeperiodicbp_tpu_torch.ops import ite_kernels as IK
    from kagomeperiodicbp_tpu_torch.ops import kernels as K
    from kagomeperiodicbp_tpu_torch.ops import linalg as L
    from kagomeperiodicbp_tpu_torch.ops import mps as M
    from kagomeperiodicbp_tpu_torch.ops import pmps as P
    from kagomeperiodicbp_tpu_torch.physics import hamiltonians, pauli
    from kagomeperiodicbp_tpu_torch.square import algo as S
    from kagomeperiodicbp_tpu_torch.square import fullupdate as FU

    measure.setup_device(dev)
    with open(PIN_GOLD) as fh:
        gold = json.load(fh)

    # the sweep every BP run took (BPStats.mode), printed phase by phase
    modes = []
    bp_run = BP.belief_propagation

    def recorded(cell, messages, config, N):
        out = bp_run(cell, messages, config, N)
        modes.append(f"N={N} D={cell.D} {out[1].mode}")
        return out

    def took(phase):
        seen = {m: modes.count(m) for m in dict.fromkeys(modes)}
        print(f"BP runs of {phase} by sweep: {json.dumps(seen)}")
        modes.clear()
        return seen

    BP.belief_propagation = recorded

    # each phase's wall time, printed as it ends (phases 1-2 from the start)
    phase_s, clock = {}, [T_START]

    def lap(label):
        now = time.perf_counter()
        phase_s[label] = now - clock[0]
        clock[0] = now
        print(f"phase {label}: {phase_s[label]:.1f} s")

    # -- 2. build --
    t0 = time.perf_counter()
    K.build()
    print(f"build: {time.perf_counter() - t0:.2f} s ({K.library_path().name})")

    lap("1-2")

    # -- 3. kernels against their plain versions --
    by_D, rows, k2_table = kernel_checks(torch, K, dev)

    lap("3")

    # -- 4. the slice in complex128 --
    K.reset_launch_counts()
    L.reset_eigh_retries()
    os.environ.pop("KPBP_LINALG", None)
    # keep this run's cell, BP messages and measurement for phase 10's sandwiches
    captured, patched = {}, ("robust_belief_propagation", "measure_energies_and_observables")
    originals = {name: getattr(measure, name) for name in patched}

    def capture(name):
        def run(*a, **kw):
            captured[name] = (a, originals[name](*a, **kw))
            return captured[name][1]
        return run

    for name in patched:
        setattr(measure, name, capture(name))
    try:
        res = measure.production_measurement(PIN_CELL, device=dev)
    finally:
        for name in patched:
            setattr(measure, name, originals[name])
    counts_default = K.launch_counts()
    pin_bp = (captured["robust_belief_propagation"][0][0],
              captured["robust_belief_propagation"][1][0],
              captured["measure_energies_and_observables"][1])
    print(f"c128 default linalg: launches {json.dumps(counts_default)}; "
          f"K1 launches {counts_default['fused_tensor']}; shifted eigh retries "
          f"{json.dumps(L.eigh_retries())}")
    gap = report_pin(res, gold, "c128 default linalg")
    if res["bp_mode"] != "batched":
        raise AssertionError(f"the pin measurement's BP ran {res['bp_mode']}, not the batched sweep")

    L.reset_eigh_retries()
    res_gram, k_seen = k2_sizes(L, lambda: _with_env(
        {"KPBP_LINALG": "gram"}, lambda: measure.production_measurement(PIN_CELL, device=dev)))
    counts = K.launch_counts()
    counts_gram = {n: counts[n] - counts_default[n] for n in counts}
    print(f"c128 KPBP_LINALG=gram: launches {json.dumps(counts_gram)}; "
          f"K1 launches {counts_gram['fused_tensor']}; K2 sizes k:count {json.dumps(dict(sorted(k_seen.items())))}; "
          f"shifted eigh retries {json.dumps(L.eigh_retries())}")
    gap_gram = report_pin(res_gram, gold, "c128 KPBP_LINALG=gram")
    if counts_default["fused_tensor"] <= 0 or counts_gram["fused_tensor"] <= 0:
        raise AssertionError("K1 was not launched by a slice run")
    for variant in ("chol_inv_resident", k2_large(K, k_seen, torch.complex128)):
        if counts_gram[variant] <= 0:
            raise AssertionError(f"K2 ({variant}) was not launched by the gram slice run")

    # A gap over the pin bar passes below SKETCH_TOL where a measured cause
    # moves the energies as far. The gram linear algebra is one, measured by
    # the two runs above (where the default run holds the bar). The
    # randomized SVD's sketch (torch's, not jax.random's) is the other: the
    # same run with another sketch measures it, and runs only where a gap
    # over the bar has no measured cause yet.
    algebra = energy_gap(res_gram, res)
    causes = {"c128 default linalg": {},
              "c128 KPBP_LINALG=gram": {"the gram linear algebra": algebra if gap < PIN_TOL else 0.0}}
    gaps = (("c128 default linalg", gap), ("c128 KPBP_LINALG=gram", gap_gram))
    print(f"the gram linear algebra, with the same sketches, moves the energies by {algebra:.3e}")
    if any(g >= PIN_TOL and not any(v >= PIN_TOL for v in causes[label].values())
           for label, g in gaps):
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
        print(f"sketch: another sketch moves the energies by {sketch:.3e} "
              f"({res_sketch['seconds']:.2f} s wall)")
        for label in causes:
            causes[label]["the randomized-SVD sketch"] = sketch
    for label, g in gaps:
        if g < PIN_TOL:
            continue
        cause = [f"{c}, which alone moves the energies by {v:.3e}"
                 for c, v in causes[label].items() if v >= PIN_TOL]
        if g < SKETCH_TOL and cause:
            print(f"{label}: misses the pin bar {PIN_TOL:g} by {g:.3e}; cause: {'; '.join(cause)}")
            continue
        raise AssertionError(f"{label}: max|diff| {g} vs pin_D3.json")

    # K2 at every size the gram run gave it; each variant's JSON row is the
    # size that carries most of that variant's time there (calls × ms)
    gen = torch.Generator().manual_seed(1)
    by_k = {k: check_chol_inv(torch, K, dev, gen, torch.complex128, "complex128", k)
            for k in sorted(k_seen)}
    for variant in dict.fromkeys(r["variant"] for r in by_k.values()):
        ks = [k for k in by_k if by_k[k]["variant"] == variant]
        k_main = max(ks, key=lambda k: k_seen[k] * by_k[k]["ms"])
        row = by_k[k_main]
        row["device_ms"] = device_ms(torch, lambda: K.chol_inv_cuda(row["g"]))
        print(f"K2 {variant} k={k_main}: device {row['device_ms']:.4f} ms per call "
              f"({K.chol_inv_plan(k_main, torch.complex128).launches} launch(es)) against "
              f"{row['ms']:.4f} ms per call with the host wrapper")
        rows[f"chol_inv_{variant}"] = row
    totals = {key: sum(k_seen[k] * r[key] for k, r in by_k.items()) / 1e3
              for key in ("ms", "plain_ms", "library_ms")}
    print(f"K2 on the gram run: all sizes together {totals['ms']:.2f} s of kernel time vs "
          f"{totals['plain_ms']:.2f} s for the plain version and {totals['library_ms']:.2f} s "
          f"for the library call (calls × isolated median times)")

    lap("4")

    # -- 5. the slice in complex64 --
    K.reset_launch_counts()
    L.reset_eigh_retries()
    res64 = measure.production_measurement(PIN_CELL, device=dev, dtype=torch.complex64)
    counts64 = K.launch_counts()
    d64 = energy_gap(res64, res)
    print(f"c64: mean_energy={res64['mean_energy']!r}; max|c64 - c128|={d64:.3e} "
          f"(tol {C64_TOL:g}); {res64['seconds']:.2f} s wall; BP {res64['bp_iterations']} "
          f"iterations, {res64['bp_attempts']} attempt(s); launches {json.dumps(counts64)}; "
          f"K1 launches {counts64['fused_tensor']}; shifted eigh retries {json.dumps(L.eigh_retries())}")
    if not d64 < C64_TOL:
        raise AssertionError(f"c64 slice differs from c128 by {d64}")
    if counts64["fused_tensor"] <= 0:
        raise AssertionError("K1 was not launched by the c64 slice run")
    took("phases 4-5 (the pin measurements)")

    lap("5")

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
    sweep6 = (cell, msgs)

    lap("6")

    # -- 7. where the device time of a gram sweep goes --
    profile_gram_sweep(torch, C, F, UnitCell, dev)

    lap("7")

    # -- 8. ITE on the card --
    edge = UpdateEdge.all_options()[0]  # (A,B)
    inputs = ite_inputs(torch, C, F, UnitCell, robust_belief_propagation, BPConfig, hamiltonians, dev)
    ite_updates, counts_ite = time_ite_updates(torch, K, L, F, edge, inputs, dev)
    K.reset_launch_counts()
    L.reset_eigh_retries()
    ite_full, ite_tracker = short_full_ite(torch, I, BPConfig, hamiltonians, dev)
    ite_full["eigh_retries"] = L.eigh_retries()
    counts_ite = {n: counts_ite[n] + c for n, c in K.launch_counts().items()}
    print(f"ITE path: launches {json.dumps(counts_ite)}; shifted eigh retries in the short "
          f"full_ite {json.dumps(ite_full['eigh_retries'])}")
    for n in ("fused_tensor", "chol_inv_resident"):
        if counts_ite[n] <= 0:
            raise AssertionError(f"{n} was not launched on the ITE path")
    gram128 = ite_updates["complex128"]["gram"]["launches_per_update"]
    if gram128["fused_tensor"] < 1 or gram128["chol_inv_resident"] < 1:
        raise AssertionError(f"a gram ITE update did not launch K1 and K2 resident: {gram128}")
    ite_gaps = ite_card_vs_cpu(torch, F, E, IK, edge, inputs, dev)
    took("phase 8 (ITE)")

    lap("8")

    # -- 9. single-layer swallowing at D=6 --
    t_sl = time.perf_counter()
    single = {"identity": sl_message_identity(torch, C, M, UnitCell, BlockSide, dev),
              "sketch": sl_sketch_quality(torch, C, M, CT, UnitCell, BlockSide, dev),
              "card_vs_cpu": sl_card_vs_cpu(torch, C, M, CT, UnitCell, BlockSide, dev)}
    single["production"], counts_sl = sl_production(torch, K, L, C, F, CT, BP, UnitCell, BlockSide,
                                                    UpdateEdge, hamiltonians, dev)
    single["wall_s"] = time.perf_counter() - t_sl
    print(f"single-layer phase: {single['wall_s']:.1f} s wall; launches {json.dumps(counts_sl)}")
    took("phase 9 (single-layer)")

    lap("9")

    # -- 10. the warm start on growing blocks, sandwiches, classical messages,
    #        arbitrary blocks, pmps --
    t_ws = time.perf_counter()
    k1_op_cases, rows["fused_tensor_operator"] = k1_operator_checks(
        torch, K, dev, torch.Generator().manual_seed(10), pauli)
    with open(SU_PIN_GOLD) as fh:
        su_gold = json.load(fh)
    K.reset_launch_counts()
    L.reset_eigh_retries()
    warm = {}
    warm["su_d3"], _ = su_warm_start(torch, K, SU, IBM, UnitCell, su_gold, dev)
    warm["su_d3"]["bp_modes"] = took("phase 10.2 (the block measurements)")
    if set(warm["su_d3"]["bp_modes"]) != {f"N={n} D=3 batched" for n in SU_BLOCK_NS}:
        raise AssertionError(f"the block measurements did not run the batched sweep: {warm['su_d3']['bp_modes']}")
    warm["su_d6"] = su_large_d(torch, SU, UnitCell, dev)
    warm["sandwich"] = sandwich_checks(torch, K, F, MS, pin_bp, inputs, dev)
    uniform = MS.measure_energies_and_observables(inputs[0], F._sites_to_msgs(inputs[1]),
                                                  ITE_N, ITE_CHI, ITE_CHI_MSG, inputs[2])
    warm["classical"] = classical_start(torch, BP, MS, inputs, uniform)
    warm["arbitrary"] = arbitrary_check(torch, K, A, BP, inputs, uniform, dev)
    warm["pmps"] = pmps_check(torch, P, dev)
    counts_ws = K.launch_counts()
    warm["launches"] = counts_ws
    warm["eigh_retries"] = L.eigh_retries()
    warm["wall_s"] = time.perf_counter() - t_ws
    print(f"warm-start phase: {warm['wall_s']:.1f} s wall; launches {json.dumps(counts_ws)}")
    # every kernel but K2's tiled variant: the warm start's grams stay below
    # CHOL_TILED_MIN_K, so its large-k variant is blocked
    missing = [n for n, c in counts_ws.items() if c <= 0 and n != "chol_inv_tiled"]
    if missing:
        raise AssertionError(f"the warm-start path launched no {missing}")
    warm["bp_modes"] = took("phase 10.3-10.7")

    lap("10")

    # -- 11. the batched six-side sweep, and the square lattice --
    t_11 = time.perf_counter()
    K.reset_launch_counts()
    L.reset_eigh_retries()
    batched, counts_b = batched_checks(torch, K, L, M, C, F, B, BlockSide, *sweep6, dev)
    batched["wide"] = wide_batched(torch, K, L, M, C, F, B, BlockSide, UnitCell, dev)
    batched["eigh_retries"] = L.eigh_retries()
    K.reset_launch_counts()
    square, counts_sq = square_checks(torch, K, L, M, S, FU, run_square, hamiltonians, dev)
    phase11 = {"batched": batched, "square": square, "wall_s": time.perf_counter() - t_11}
    print(f"batched and square phase: {phase11['wall_s']:.1f} s wall; launches batched "
          f"{json.dumps(counts_b)}, square {json.dumps(counts_sq)}")
    took("phase 11")

    lap("11")

    # -- 12. the distribution layer on one card: ranks share cuda:0 over gloo --
    from kagomeperiodicbp_tpu_torch.parallel import chi_shard as CS
    from kagomeperiodicbp_tpu_torch.parallel import launch
    from kagomeperiodicbp_tpu_torch.parallel import multichip as MC
    from kagomeperiodicbp_tpu_torch.parallel import sweep as SW

    t_12 = time.perf_counter()
    torch.cuda.empty_cache()
    counts_par = {n: 0 for n in counts_default}   # every rank's and worker's launches
    par = {"side_sharded": side_sharded_checks(torch, C, B, M, MC, launch, UnitCell, *sweep6,
                                               counts_par, dev)}
    par.update(multichain_checks(torch, C, F, B, MC, launch, UnitCell, UpdateEdge, inputs,
                                 counts_par, dev))
    par["chi_shard"] = chi_shard_checks(torch, C, M, CS, launch, UnitCell, BlockSide,
                                        counts_par, dev)
    par["sweep_workers"] = concurrent_sweep_checks(torch, SW, counts_par)
    par["c64_qr"] = c64_qr_sweep(torch, K, C, F, B, M, UnitCell, dev)
    par["launches"] = counts_par
    par["wall_s"] = time.perf_counter() - t_12
    print(f"distribution-layer phase: {par['wall_s']:.1f} s wall; launches on the parallel path, "
          f"all ranks and workers {json.dumps(counts_par)}")
    missing = [n for n in ("fused_tensor", "chol_inv_resident") if counts_par[n] <= 0]
    if counts_par["chol_inv_blocked"] + counts_par["chol_inv_tiled"] <= 0:
        missing.append("K2's large-k variants")
    if missing:
        raise AssertionError(f"the parallel path launched no {missing}")
    took("phase 12")

    lap("12")

    # -- 13. large D and records: the D=7 padded pin, the D=8 work unit, the
    #        record entry points --
    t_13 = time.perf_counter()
    torch.cuda.empty_cache()
    K.reset_launch_counts()
    L.reset_eigh_retries()
    reference = {}   # the launches of the D=3 pin's BP and measurement
    uncounted = lambda fn, *a: MC._uncounted(reference, fn, *a)  # noqa: E731
    large = {"padded_pin_d7": ld_padded_pin(torch, C, E, CT, MS, BP, UnitCell, hamiltonians,
                                            uncounted, dev)}
    large["d8"], k_seen8 = ld_d8(torch, K, L, C, F, CT, UnitCell, BlockSide, UpdateEdge, hamiltonians, dev)
    large["d8_environment"] = ld_d8_environment(torch, E, IK, L, UpdateEdge, CT, uncounted, dev)
    seen = K.launch_counts()
    large["demo_d7"] = ld_demo(dev)   # zeroes the counts and returns its own
    counts_ld = {n: seen[n] - reference.get(n, 0) + large["demo_d7"]["launches"][n] for n in seen}
    large["launches"], large["reference_launches"] = counts_ld, reference
    missing = [n for n in ("fused_tensor", "chol_inv_resident", k2_large(K, k_seen8, torch.complex64))
               if counts_ld[n] <= 0]
    if missing:
        raise AssertionError(f"the large-D path launched no {missing}")
    K.reset_launch_counts()
    large["records"] = ld_records(torch, dev)
    counts_rec = K.launch_counts()
    large["records"]["launches"] = counts_rec
    if counts_rec["fused_tensor"] <= 0:
        raise AssertionError(f"the record entry points launched no fused_tensor: {counts_rec}")
    large["k2_by_size"] = ld_k2_checks(torch, K, dev, k_seen8)
    d8 = large["d8"]
    d8["gram_per_side"]["k2_share"] = k2_share(k_seen8, large["k2_by_size"], d8["gram_per_side"]["s"])
    print(f"large D: D={LD8_D} per-side call, default linear algebra {d8['per_side']['s']:.2f} s against "
          f"KPBP_LINALG=gram {d8['gram_per_side']['s']:.2f} s, K2 {100 * d8['gram_per_side']['k2_share']:.1f}% "
          f"of the gram call (calls × kernel ms over its sizes)")
    large["wall_s"] = time.perf_counter() - t_13
    print(f"large-D and records phase: {large['wall_s']:.1f} s wall; launches large D "
          f"{json.dumps(counts_ld)} (the D=3 reference's {json.dumps(reference)} left out), records "
          f"{json.dumps(counts_rec)}")
    took("phase 13")

    lap("13")

    # -- 14. the port's own work: bench_scaling, the flop model, the scripts --
    import tempfile

    from kagomeperiodicbp_tpu_torch import create_kagome_elists, plot_afmh_benchmark
    from kagomeperiodicbp_tpu_torch.tools import flops_model as FM

    t_14 = time.perf_counter()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        tracker_path = os.path.join(tmp, "tracker.pkl")
        ite_tracker.save(tracker_path)
        bench = bench_scaling_start()
        scripts = scripts_start(tmp, tracker_path)
        try:
            afmh = plot_afmh_benchmark.table_lines(plot_afmh_benchmark.rows(
                os.path.join(REPO, "data", "unit_cells", "best")))
            work = {"scripts": scripts_check(scripts, UnitCell, create_kagome_elists.elists, afmh,
                                             ite_tracker.best_cell),
                    "bench_scaling": bench_scaling_check(bench)}
        finally:   # a check that raised leaves no command running
            for proc, _ in (bench, *scripts[1].values()):
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    counts_fl = {n: 0 for n in counts_default}
    for row in work["bench_scaling"]["rows"]:
        _add(counts_fl, row["launches"])
    K.reset_launch_counts()
    work["flop_model"] = flops_checks(torch, FM, work["bench_scaling"]["rows"], statistics.median(sweep_s[1:]),
                                      ite_updates["complex64"]["default"]["s_per_update"], dev)
    _add(counts_fl, K.launch_counts())
    work["launches"] = counts_fl
    work["wall_s"] = time.perf_counter() - t_14
    print(f"the port's own work phase: {work['wall_s']:.1f} s wall; launches (bench_scaling's and this "
          f"process's) {json.dumps(counts_fl)}")
    if counts_fl["fused_tensor"] <= 0:
        raise AssertionError(f"the flop model's path launched no fused_tensor: {counts_fl}")

    lap("14")

    # -- 15. results --
    launches = {n: counts_default[n] + counts_gram[n] + counts_ite[n] + counts_sl[n] + counts_ws[n]
                + counts_b[n] + counts_sq[n] + counts_par[n] + counts_ld[n] + counts_rec[n]
                + counts_fl[n] for n in counts_default}
    by_path = {n: {"measurement": counts_default[n] + counts_gram[n], "ite": counts_ite[n],
                   "single_layer": counts_sl[n], "warm_start": counts_ws[n],
                   "batched_sweep": counts_b[n], "square": counts_sq[n],
                   "parallel": counts_par[n], "large_d": counts_ld[n], "records": counts_rec[n],
                   "flops": counts_fl[n]}
               for n in counts_default}
    k2 = ("kagomeperiodicbp_tpu_torch/csrc/chol_inv.cu", "kagomeperiodicbp_tpu/ops/pallas_kernels.py:194")
    k1 = ("kagomeperiodicbp_tpu_torch/csrc/fused_tensor.cu", "kagomeperiodicbp_tpu/ops/pallas_kernels.py:82")
    src = {"fused_tensor": k1, "fused_tensor_operator": k1,
           "chol_inv_resident": k2, "chol_inv_blocked": k2, "chol_inv_tiled": k2}
    kernels = [{"name": n, "route": "cuda", "source": src[n][0], "replaces": src[n][1],
                "launches": launches[n], "launches_by_path": by_path[n],
                **{k: v for k, v in rows[n].items() if k not in ("g", "rel_err")}}
               for n in ("fused_tensor", "fused_tensor_operator") + K2_VARIANTS]
    print(json.dumps({"fused_tensor_by_D": by_D}))
    print(json.dumps({"chol_inv_by_k": {n: {k: {key: v for key, v in r.items() if key != "row"}
                                            for k, r in t.items()} for n, t in k2_table.items()}}))
    print(json.dumps({"ite": {"config": {"N": ITE_N, "D": inputs[0].D, "chi": ITE_CHI,
                                         "chi_msg": ITE_CHI_MSG, "edge": str(edge),
                                         "als_iters": ITE_ALS, "dt": ITE_DT},
                              "edge_update": ite_updates, "card_vs_cpu": ite_gaps,
                              "full_ite": ite_full, "launches": counts_ite}}))
    print(json.dumps({"single_layer": single}))
    print(json.dumps({"warm_start": {"fused_tensor_operator_by_D": k1_op_cases, **warm}}))
    print(json.dumps({"batched_and_square": phase11}))
    print(json.dumps({"parallel": par}))
    print(json.dumps({"large_d": large}))
    print(json.dumps({"port_work": work}))
    print(json.dumps({"phase_seconds": phase_s}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
