#!/usr/bin/env python
"""How far the χ-sharded single-layer per-side call (``parallel/chi_shard``,
two ranks sharing one card over gloo) parts from the unsharded call, by
input, sketch rank and SVD, at phase 9's size of chip_smoke.py (D=6, N=2,
χ_msg=72, χ=82, complex128, toward U):

* inputs: ``pin6`` (the pin cell padded to D=6, uniform messages, phase
  9's identity input), ``dense`` (a seeded random D=6 cell with seeded
  dense random messages), ``bp3`` (the random cell drawn in complex64, its
  messages after 3 complex64 BP sweeps, both cast to complex128);
* sketch: ``full`` (every row, no power iteration: the sketched swallow is
  exact) or ``default``; SVD: ``rsvd`` (the default) or ``exact``
  (``linalg.RSVD_MIN_DIM`` lifted in the ranks and here).

For each case: the sharded message against the unsharded one in this
process and against rank 0's own unsharded call, with the times. Prints
JSON lines. On a machine with a card (``KPBP_CHECK_DEVICE=cpu`` and
``KPBP_CHECK_SIZES=N,D,CHI_MSG,CHI`` for a small run on the CPU):

    python tools/chi_shard_check.py pin6:full:rsvd dense:default:rsvd dense:full:exact bp3:full:rsvd
"""
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

N, D, CHI_MSG, CHI = (int(x) for x in os.environ.get("KPBP_CHECK_SIZES", "2,6,72,82").split(","))
FULL = {"KPBP_SKETCH_RANK": "1000000000", "KPBP_SKETCH_POWER": "0"}


def _sync(torch):
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _exact(flag):
    from kagomeperiodicbp_tpu_torch.ops import linalg as L

    prev = L.RSVD_MIN_DIM
    if flag:
        L.RSVD_MIN_DIM = 10 ** 9
    return prev


def rank_call(cell, msgs, env, exact, sizes):
    """In each rank: the sharded call, then this rank's unsharded call;
    sizes = (N, D, χ, χ_msg)."""
    import torch

    from kagomeperiodicbp_tpu_torch.algo import contraction as C
    from kagomeperiodicbp_tpu_torch.lattices import BlockSide
    from kagomeperiodicbp_tpu_torch.ops import linalg as L
    from kagomeperiodicbp_tpu_torch.parallel import chi_shard as CS
    from kagomeperiodicbp_tpu_torch.parallel import launch

    os.environ.update(env)
    prev = _exact(exact)
    try:
        cell, msgs = launch.moved((cell, msgs), launch.device())
        _sync(torch)
        t0 = time.perf_counter()
        out = CS.outgoing_message_sharded(cell, msgs, *sizes, BlockSide.U, CS.chi_mesh(), single=True)
        _sync(torch)
        secs = time.perf_counter() - t0
        own = C.outgoing_message_single(cell, msgs, *sizes, BlockSide.U)
    finally:
        L.RSVD_MIN_DIM = prev
        for k in env:
            os.environ.pop(k)
    return launch.moved((out, own, secs), "cpu")


def inputs(name, torch, C, F, BP, UnitCell, M, dev):
    import chip_smoke as S

    c64, c128 = torch.complex64, torch.complex128
    if name == "pin6":
        cell = (UnitCell.load(S.PIN_CELL).astype(c128).force_zero_rotation()
                .pad_to(D, generator=torch.Generator().manual_seed(0)))
        return cell, C.initial_messages(N, D, CHI_MSG, dtype=c128)
    if name == "dense":
        cell = UnitCell.random(2, D, torch.Generator().manual_seed(0), dtype=c128)
        sites = S._dense_messages(torch, C, F, D, CHI_MSG, 6, "cpu")
        return cell, F._sites_to_msgs({s: tuple(x.to(c128) for x in ss) for s, ss in sites.items()})
    if name == "bp3":
        cell = UnitCell.random(2, D, torch.Generator().manual_seed(0), dtype=c64).to_device(dev)
        cfg = BP.BPConfig(trunc_dim=CHI_MSG, bubble_trunc_dim=CHI, max_iterations=3,
                          msg_diff_terminate=0.0, dtype=c64)
        msgs, _ = BP.belief_propagation(cell, None, cfg, N)
        return (cell.astype(c128).to_device("cpu"),
                {s: M.MPS(tuple(x.to(c128).cpu() for x in m.sites), torch.zeros((), dtype=torch.float64))
                 for s, m in msgs.items()})
    raise ValueError(f"unknown input {name!r}")


def main() -> None:
    import torch

    import chip_smoke as S
    from kagomeperiodicbp_tpu_torch import measure
    from kagomeperiodicbp_tpu_torch.algo import bp as BP
    from kagomeperiodicbp_tpu_torch.algo import contraction as C
    from kagomeperiodicbp_tpu_torch.algo import fused as F
    from kagomeperiodicbp_tpu_torch.lattices import BlockSide
    from kagomeperiodicbp_tpu_torch.networks.unit_cell import UnitCell
    from kagomeperiodicbp_tpu_torch.ops import kernels as K
    from kagomeperiodicbp_tpu_torch.ops import mps as M
    from kagomeperiodicbp_tpu_torch.parallel import launch

    dev = measure.setup_device(os.environ.get("KPBP_CHECK_DEVICE", "cuda"))
    if dev.type == "cuda":
        print(S._smi(), flush=True)
        K.build()
    cases = [c.split(":") for c in sys.argv[1:]] or [["pin6", "full", "rsvd"]]
    data = {name: inputs(name, torch, C, F, BP, UnitCell, M, dev) for name in {c[0] for c in cases}}
    calls = [(rank_call, (*data[name], FULL if sketch == "full" else {}, svd == "exact",
                          (N, D, CHI, CHI_MSG)))
             for name, sketch, svd in cases]
    got = launch.run_each(2, calls, device=dev.type)
    torch.cuda.empty_cache()
    for (name, sketch, svd), (out, own, secs) in zip(cases, got):
        cell, msgs = launch.moved(data[name], dev)
        prev = _exact(svd == "exact")
        try:
            t0 = time.perf_counter()
            ref = S._with_env(FULL if sketch == "full" else {}, lambda: C.outgoing_message_single(
                cell, msgs, N, D, CHI, CHI_MSG, BlockSide.U))
            _sync(torch)
            ref_s = time.perf_counter() - t0
        finally:
            from kagomeperiodicbp_tpu_torch.ops import linalg as L

            L.RSVD_MIN_DIM = prev
        ref = launch.moved(ref, "cpu")
        print(json.dumps({"input": name, "sketch": sketch, "svd": svd, "sharded_s": secs,
                          "unsharded_s": ref_s,
                          "sharded_vs_unsharded": float(M.distance(out, ref)),
                          "sharded_vs_rank0_unsharded": float(M.distance(out, own)),
                          "rank0_unsharded_vs_unsharded": float(M.distance(own, ref))}), flush=True)


if __name__ == "__main__":
    main()
