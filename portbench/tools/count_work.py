"""Count a configuration's work per step, once, to freeze it in its file.

    python3 portbench/tools/count_work.py --config kagome_afm_D6 --step bp_sweep [--device cuda]
    python3 portbench/tools/count_work.py --config kagome_afm_D8 --step ite_update

Runs one step of the program at the configuration's shapes under the meter of
``portbench/work.py`` (a copy of ``kagomeperiodicbp_tpu_torch/tools/
flops_model.py``'s closed forms) and prints one JSON line with the integer
and its split by kind. ``bp_sweep``: one sweep of the mode BP picks at that
D, from uniform messages. ``ite_update``: the mean over the 11 updates of the
``ite_updates`` mix's order (each of the six edges counted once, the order's
counts of each summed), on uniform messages. The counts depend on the shapes
alone (every bond is padded to its profile), so the seed does not matter;
the card and the CPU give the same integers. Paste the total into the
configuration's ``work``; the benchmark never counts at run time.
"""
import argparse
import json
import os
import random
import sys
from collections import Counter

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)


def _cell(cfg, device):
    import torch

    from kagomeperiodicbp_tpu_torch.networks.unit_cell import UnitCell

    dtype = getattr(torch, cfg["dtype"])
    gen = torch.Generator(device=device).manual_seed(0)
    return UnitCell.random(cfg["d"], cfg["D"], gen, dtype=dtype, device=device), dtype


def count_sweep(cfg, device):
    from kagomeperiodicbp_tpu_torch.algo import bp as BP
    from kagomeperiodicbp_tpu_torch.algo import contraction as C
    from kagomeperiodicbp_tpu_torch.algo import fused as F
    from portbench import inputs, work

    cell, dtype = _cell(cfg, device)
    N, D, chi, chi_msg = cfg["N"], cfg["D"], cfg["chi"], cfg["chi_msg"]
    mode = BP.bp_mode(BP.BPConfig(trunc_dim=chi_msg, bubble_trunc_dim=chi, dtype=dtype), D)
    if mode == "batched":
        from kagomeperiodicbp_tpu_torch.algo import batched as B

        fn = B.bp_iteration_batched(N, D, chi, chi_msg, None)
    else:
        fn = F.bp_iteration(N, D, chi, chi_msg, None, single=mode == "single")
    tensors = C.site_kets(cell) if mode == "single" else C.fused_cells(cell)
    sites = inputs.uniform_messages(N, D, chi_msg, dtype, cell.A.device)
    _, rec = work.count(fn, tensors, sites)
    rec["mode"] = mode
    return rec


def count_update(cfg, device, dt=1e-3, als_iters=10):
    from kagomeperiodicbp_tpu_torch.algo import fused as F
    from kagomeperiodicbp_tpu_torch.algo import ite as ITE
    from portbench import inputs, work

    cell, dtype = _cell(cfg, device)
    N, D, chi, chi_msg = cfg["N"], cfg["D"], cfg["chi"], cfg["chi_msg"]
    sites = inputs.uniform_messages(N, D, chi_msg, dtype, cell.A.device)
    h = inputs.hamiltonian(cfg["hamiltonian"], dtype, cell.A.device)
    order = ITE._edge_order(ITE.ITEConfig(random_edge_order=False), dt, random.Random(0))
    by_edge = {}
    for edge, _ in order:
        if edge not in by_edge:
            update = F.edge_update(N, D, chi, chi_msg, edge, als_iters, True)
            by_edge[edge] = work.count(update, (cell.A, cell.B, cell.C), sites, h, dt)[1]
    total = sum(by_edge[e]["total"] for e, _ in order)
    split = Counter()
    for e, _ in order:
        split.update(by_edge[e]["split"])
    n = len(order)
    return {"total": round(total / n), "split": {k: round(v / n) for k, v in split.items()},
            "per_edge": {str(e): r["total"] for e, r in by_edge.items()}, "updates": n}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", required=True)
    p.add_argument("--step", required=True, choices=("bp_sweep", "ite_update"))
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    with open(os.path.join(ROOT, "portbench", "configs", args.config + ".json")) as fh:
        cfg = json.load(fh)
    rec = count_sweep(cfg, args.device) if args.step == "bp_sweep" else count_update(cfg, args.device)
    rec.update(config=args.config, step=args.step,
               counted_by="portbench/tools/count_work.py: real flops, GEMMs by "
                          "torch.utils.flop_counter x4 complex, linalg by LAWN 41 and Golub & "
                          "Van Loan closed forms, K1/K2 by formula (portbench/work.py)")
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
