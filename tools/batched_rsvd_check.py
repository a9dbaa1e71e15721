#!/usr/bin/env python
"""How far the batched and per-side BP sweeps part with the randomized SVD
(``ops/linalg.rsvd_trunc``) against with exact SVDs, on a seeded random
cell from seeded dense messages (every entry drawn, as chip_smoke.py's D=5
check draws them), complex128:

* per-side against batched, each with the randomized SVD and with exact
  SVDs (``linalg.RSVD_MIN_DIM`` lifted), and each against the other mode;
* side U's outgoing message over three identical copies of its network in
  one ``torch.func.vmap`` call, each copy against the direct call;
* with ``cpu`` among the devices, the same on the CPU, and every sweep
  against every other, across devices too.

Prints the distances as JSON lines. On a machine with a card:

    python tools/batched_rsvd_check.py D CHI_MSG CHI cuda[,cpu]
    python tools/batched_rsvd_check.py 5 50 60 cuda
"""
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> None:
    import torch

    import chip_smoke as CS
    from kagomeperiodicbp_tpu_torch.algo import batched as B
    from kagomeperiodicbp_tpu_torch.algo import contraction as C
    from kagomeperiodicbp_tpu_torch.algo import fused as F
    from kagomeperiodicbp_tpu_torch.networks.unit_cell import UnitCell
    from kagomeperiodicbp_tpu_torch.ops import linalg as L
    from kagomeperiodicbp_tpu_torch.ops import mps as M

    D, chi_msg, chi = (int(x) for x in sys.argv[1:4])
    devices = sys.argv[4].split(",") if len(sys.argv) > 4 else ["cuda"]
    c128 = torch.complex128
    per_side = F.bp_iteration(2, D, chi, chi_msg, None)
    batched = B.bp_iteration_batched(2, D, chi, chi_msg, None)

    def distance(a, b):
        return float(M.distance(M.from_sites(tuple(x.cpu() for x in a)), M.from_sites(tuple(x.cpu() for x in b))))

    out, times = {}, {}
    for name in devices:
        dev = torch.device(name)
        cell = UnitCell.random(2, D, torch.Generator().manual_seed(5), dtype=torch.complex64)
        fused = C.fused_cells(cell._map(lambda t: t.to(c128)).to_device(dev))
        start = {s: tuple(x.to(c128) for x in ss)
                 for s, ss in CS._dense_messages(torch, C, F, D, chi_msg, 6, dev).items()}
        sweeps = {"per_side": per_side, "batched": batched}
        for exact in (False, True):
            min_dim = L.RSVD_MIN_DIM
            if exact:
                L.RSVD_MIN_DIM = 10 ** 9
            try:
                for label, sweep in sweeps.items():
                    key = f"{name}_{label}" + ("_exact" if exact else "")
                    t0 = time.perf_counter()
                    out[key] = sweep(fused, start)[0]
                    times[key] = time.perf_counter() - t0
            finally:
                L.RSVD_MIN_DIM = min_dim
        one = F._one_outgoing(tuple(fused), start, 2, D, chi, chi_msg, 0).sites
        stacked = (tuple(torch.stack([f] * 3) for f in fused),
                   {s: tuple(torch.stack([x] * 3) for x in ss) for s, ss in start.items() if s != 0})
        copies = torch.func.vmap(lambda f3, ms: tuple(F._one_outgoing(f3, ms, 2, D, chi, chi_msg, 0).sites),
                                 randomness="same")(*stacked)
        print(json.dumps({"D": D, "device": name, "side_U_three_copies_vs_direct":
                          [distance(one, tuple(x[b] for x in copies)) for b in range(3)]}), flush=True)
    keys = list(out)
    pairs = {f"{a} vs {b}": max(distance(out[a][s], out[b][s]) for s in out[a])
             for i, a in enumerate(keys) for b in keys[i + 1:]}
    print(json.dumps({"D": D, "chi_msg": chi_msg, "chi": chi, "max_side_distance": pairs, "s": times}), flush=True)


if __name__ == "__main__":
    main()
