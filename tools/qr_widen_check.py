#!/usr/bin/env python
"""What factoring complex64 QRs in complex128 costs on the card: each case
timed with its peak device memory under two rules for ``ops/linalg._qr``,

* ``plain`` — ``torch.linalg.qr`` in the input's type;
* ``wide`` — every complex64 QR factored in complex128, cast back;

in the order plain, wide, wide, plain. Cases, all complex64:

* ``batched_d3`` — the batched sweep at N=2, D=3, χ=18 on the pin cell from
  uniform messages (chip_smoke.py phase 6's sweep), median of 2 after one
  warm-up per round;
* ``batched_d5`` — the batched sweep at D=5, χ_msg=50, χ=60 on a seeded
  random cell from seeded dense messages (chip_smoke.py phase 11's), one
  sweep per round;
* ``per_side_d3`` — the per-side sweep of ``batched_d3``'s inputs;
* ``single_d6`` — one single-layer per-side call toward U at D=6,
  χ_msg=72, χ=82 on the pin padded to D=6 from uniform messages (phase 9's
  size), median of 2 after one warm-up per round.

Prints one JSON line per case and round, then a summary line. On a machine
with a card (``KPBP_CHECK_DEVICE=cpu`` runs the D=3 cases on the CPU, with no
peak memory):

    python tools/qr_widen_check.py [case ...]
"""
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
PIN_CELL = os.path.join(ROOT, "tests", "assets", "pin_D3.pkl")


def main(argv):
    import torch

    from kagomeperiodicbp_tpu_torch.algo import batched as B
    from kagomeperiodicbp_tpu_torch.algo import contraction as C
    from kagomeperiodicbp_tpu_torch.algo import fused as F
    from kagomeperiodicbp_tpu_torch.lattices import BlockSide
    from kagomeperiodicbp_tpu_torch.networks.unit_cell import UnitCell
    from kagomeperiodicbp_tpu_torch.ops import kernels as K
    from kagomeperiodicbp_tpu_torch.ops import linalg as L

    dev = torch.device(os.environ.get("KPBP_CHECK_DEVICE", "cuda:0"))
    card = dev.type == "cuda"
    if card:
        K.build()

    def sync():
        if card:
            torch.cuda.synchronize()

    c64 = torch.complex64

    def plain(a):
        return torch.linalg.qr(a, mode="reduced")

    def wide(a):
        if a.dtype != c64:
            return plain(a)
        q, r = torch.linalg.qr(a.to(torch.complex128), mode="reduced")
        return q.to(c64), r.to(c64)

    rules = {"plain": plain, "wide": wide}

    def dense(D, chi, seed):
        gen = torch.Generator().manual_seed(seed)
        profile = F._msgs_to_sites(C.initial_messages(2, D, chi, dtype=c64))
        return {s: tuple(torch.complex(*(torch.randn(x.shape, generator=gen) for _ in range(2))).to(dev)
                         for x in ss) for s, ss in profile.items()}

    pin = UnitCell.load(PIN_CELL, device=dev).astype(c64).force_zero_rotation()
    uniform3 = F._msgs_to_sites(C.initial_messages(2, 3, 18, dtype=c64, device=dev))
    cell5 = UnitCell.random(2, 5, torch.Generator().manual_seed(5), dtype=c64).to_device(dev)
    pin6 = pin.pad_to(6, generator=torch.Generator(device=dev).manual_seed(0))
    uniform6 = C.initial_messages(2, 6, 72, dtype=c64, device=dev)

    def sweep_case(run, fused, msgs):
        def call():
            out, err = run(fused, msgs)
            return out, float(err)
        return call

    cases = {
        "batched_d3": (sweep_case(B.bp_iteration_batched(2, 3, 18, 18, None), C.fused_cells(pin), uniform3), 3),
        "batched_d5": (sweep_case(B.bp_iteration_batched(2, 5, 60, 50, None), C.fused_cells(cell5),
                                  dense(5, 50, 6)), 1),
        "per_side_d3": (sweep_case(F.bp_iteration(2, 3, 18, 18, None), C.fused_cells(pin), uniform3), 3),
        "single_d6": (lambda: (C.outgoing_message_single(pin6, uniform6, 2, 6, 82, 72, BlockSide.U), 0.0), 3),
    }
    chosen = argv or list(cases)
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader").read().strip()
    print(smi, flush=True)
    summary = {}
    for name in chosen:
        call, reps = cases[name]
        for rule in ("plain", "wide", "wide", "plain"):
            L._qr = rules[rule]
            secs = []
            if card:
                sync()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
            finite = True
            for _ in range(reps):
                sync()
                t0 = time.perf_counter()
                try:
                    out, err = call()
                    finite = finite and err == err
                except RuntimeError as exc:   # a non-finite factor reaching an SVD
                    finite, out = False, str(exc)[:120]
                sync()
                secs.append(time.perf_counter() - t0)
            row = {"case": name, "rule": rule, "seconds": secs,
                   "s": statistics.median(secs[1:] if reps > 1 else secs),
                   "peak_gb": torch.cuda.max_memory_allocated() / 1e9 if card else None, "finite": finite}
            print(json.dumps(row), flush=True)
            summary.setdefault(name, {}).setdefault(rule, []).append(row)
    ratios = {name: {"wide_over_plain_s": sum(r["s"] for r in by["wide"]) / sum(r["s"] for r in by["plain"]),
                     "peak_gb": {k: v[0]["peak_gb"] and max(r["peak_gb"] for r in v) for k, v in by.items()},
                     "finite": {k: all(r["finite"] for r in v) for k, v in by.items()}}
              for name, by in summary.items()}
    print(json.dumps({"device": smi, "summary": ratios}))


if __name__ == "__main__":
    main(sys.argv[1:])
