#!/usr/bin/env python
"""K1's plain form (ket = bra) on the card, for the port package found
under a given root: device time per call of one tensor and of a cell of
three (CUDA events around calls queued behind a device-side sleep, the
least of five), and the time per call with the host wrapper, at D=2…8 in
complex64 and complex128. Prints one JSON line.

It compares two versions of the kernel in one call on one card: unpack the
other commit into a git-ignored directory and run them in turns, e.g.

    git archive <commit> kagomeperiodicbp_tpu_torch | tar -x -C _scratch/parent
    python tools/k1_ab.py _scratch/parent parent; python tools/k1_ab.py . change
    python tools/k1_ab.py . change; python tools/k1_ab.py _scratch/parent parent
"""
import json
import os
import sys

ROOT, LABEL = os.path.abspath(sys.argv[1]), sys.argv[2]
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from kagomeperiodicbp_tpu_torch.ops import kernels as K  # noqa: E402

if not K.__file__.startswith(os.path.join(ROOT, "kagomeperiodicbp_tpu_torch")):
    raise SystemExit(f"imported {K.__file__}, not the package under {ROOT}")


def device_ms(fn, calls=20):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def call_ms(fn, reps=200):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    K.build()
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    out = {}
    for name in ("complex64", "complex128"):
        for D in range(2, 9):
            cell = [torch.randn((2, D, D, D, D), generator=gen, dtype=getattr(torch, name)).to(dev)
                    for _ in range(3)]
            one = lambda: K.fused_tensor_cuda(cell[0])  # noqa: E731
            three = lambda: K.fused_tensors_cuda(cell)  # noqa: E731
            out[f"{name} D={D}"] = {"one_dev_us": 1e3 * min(device_ms(one) for _ in range(5)),
                                    "cell_dev_us": 1e3 * min(device_ms(three) for _ in range(5)),
                                    "cell_call_us": 1e3 * min(call_ms(three) for _ in range(3))}
    print(json.dumps({"label": LABEL, "device": torch.cuda.get_device_name(0), "k1": out}))


if __name__ == "__main__":
    main()
