"""Where the device time of one K2 call goes, by kernel: for the tiled
variant its diagonal factors, panels and updates; for the others their one
kernel. One gram per case, drawn on the card from seed 0.

    python -m kagomeperiodicbp_tpu_torch.tools.k2_profile 2952:complex64 8832:complex64:tiled:128

Each case is k:dtype[:variant[:tile]] (the plan's variant and tile width
when left out). One call warms up, one more runs under ``torch.profiler``;
one JSON line per case gives the span from the first kernel's start to the
last one's end and, per kernel kind, its launches and device ms. It needs
the card.
"""
from __future__ import annotations

import argparse
import json
from collections import defaultdict

import torch

from ..ops import kernels as K

KINDS = ("diag", "panel", "update", "resident", "blocked")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("cases", nargs="+", help="k:dtype[:variant[:tile]]")
    return p.parse_args(argv)


def profile(k: int, dtype: torch.dtype, variant: str = "", tile: int = 0) -> dict:
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    b = torch.randn((k, k), generator=gen, dtype=dtype, device=dev)
    g = b @ b.mH + k * torch.eye(k, dtype=dtype, device=dev)
    plan = K.chol_inv_plan(k, dtype, variant, tile)
    K.chol_inv_cuda(g, variant, tile)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        K.chol_inv_cuda(g, variant, tile)
        torch.cuda.synchronize()
    ms, launches, spans = defaultdict(float), defaultdict(int), []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA or "chol_inv" not in e.name():
            continue
        kind = next(x for x in KINDS if x in e.name())
        ms[kind] += (e.end_ns() - e.start_ns()) / 1e6
        launches[kind] += 1
        spans.append((e.start_ns(), e.end_ns()))
    return {"k": k, "dtype": str(dtype).removeprefix("torch."), "variant": plan.variant, "tile": plan.tile,
            "device": torch.cuda.get_device_name(0),
            "span_ms": (max(e for _, e in spans) - min(s for s, _ in spans)) / 1e6,
            "by_kind": {kind: {"launches": launches[kind], "ms": ms[kind]} for kind in ms}}


def main(argv=None) -> list:
    args = parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k2_profile needs the card: K2's kernels run only there")
    K.build()
    rows = []
    for case in args.cases:
        k, dtype, *rest = case.split(":")
        rows.append(profile(int(k), getattr(torch, dtype), *(rest[:1]), *(int(t) for t in rest[1:2])))
        print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    main()
