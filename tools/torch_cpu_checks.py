#!/usr/bin/env python
"""CPU measurements behind PERF.md's single-layer and complex64 findings, in
the JAX package and its PyTorch port, complex128 unless stated:

1. ``sketch`` — quality of the sketched single-layer swallow
   (`_swallow_ket_gram_split`) at N=2, D=3, χ=12, message toward U, every
   eligible swallow sketched (KPBP_BLOB_LIMIT=1): d(sketched, oracle) /
   d(direct, oracle), the oracle the port's double-layer message at χ=100.
   On the JAX test's own input (a random cell from PRNGKey(1), random
   messages from PRNGKey(3)) with the JAX package's draw of the sketch
   factors and with the port's; the same on four numpy inputs (seeds 0–3,
   made by the numpy case functions of tests/test_torch_single_layer.py).
2. ``c64`` — the complex64 − complex128 energy gap of one ITE edge update,
   the one chip_smoke.py phase 8 times (N=2, D=3, χ_env=28, χ_msg=18, edge
   (A,B), als_iters=10, dt=1e-3, AFM Heisenberg) on the pin cell
   (tests/assets/pin_D3.pkl) with its BP messages at N=2 (the port's BP,
   c128), then on NUDGES copies of the cell moved by 3e-8 of its largest
   entry (the complex64 rounding scale), so the gap's spread shows beside
   its value.

Prints one JSON line per part.

Usage: python tools/torch_cpu_checks.py [sketch|c64|all] [NUDGES]
"""
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))
N, D, CHI, ORACLE_CHI = 2, 3, 12, 100


def sketch() -> dict:
    import jax
    import numpy as np
    import torch

    from kagomeperiodicbp_tpu.algo import contraction as JC
    from kagomeperiodicbp_tpu.lattices import BlockSide as JBlockSide
    from kagomeperiodicbp_tpu.networks.unit_cell import UnitCell as JUnitCell
    from kagomeperiodicbp_tpu_torch.algo import contraction as C
    from kagomeperiodicbp_tpu_torch.lattices import BlockSide
    from kagomeperiodicbp_tpu_torch.ops import mps as M
    from test_torch_single_layer import both, numpy_cell, numpy_messages, to_port

    def sketched(fn):
        os.environ["KPBP_BLOB_LIMIT"] = "1"
        try:
            return fn()
        finally:
            del os.environ["KPBP_BLOB_LIMIT"]

    def ratios(cell_np, msgs_np):
        """(JAX package's draw, port's draw): d(sketched, oracle) / d(direct, oracle)."""
        (jcell, jmsgs), (cell, msgs) = both(cell_np, msgs_np)
        oracle = C.outgoing_message(cell, msgs, N, D, ORACLE_CHI, CHI, BlockSide.U)
        jax_one = lambda: to_port(JC.outgoing_message_single(jcell, jmsgs, N, D, CHI, CHI,  # noqa: E731
                                                             JBlockSide.U))
        port_one = lambda: C.outgoing_message_single(cell, msgs, N, D, CHI, CHI, BlockSide.U)  # noqa: E731
        out = []
        for one in (jax_one, port_one):
            d_sketch, d_direct = (float(M.distance(m, oracle)) for m in (sketched(one), one()))
            out.append(d_sketch / d_direct)
        return out

    jcell = JUnitCell.random(D=D, d=2, key=jax.random.PRNGKey(1))
    jmsgs = JC.initial_messages(N, D, chi=CHI, model="random", key=jax.random.PRNGKey(3))
    jax_case = ({**{f: np.array(jcell[f]) for f in "ABC"}, "rotated": 0},
                {int(s): [np.array(x) for x in m.sites] for s, m in jmsgs.items()})
    cases = [jax_case] + [(numpy_cell(D, s), numpy_messages(N, D, CHI, s + 10)) for s in range(4)]
    rows = [dict(zip(("jax_draw", "port_draw"), ratios(*case))) for case in cases]
    return {"jax_test_input": rows[0], "numpy_inputs": rows[1:]}


def c64_gap(nudges: int) -> dict:
    import jax.numpy as jnp
    import numpy as np
    import torch

    from kagomeperiodicbp_tpu.algo import fused as JF
    from kagomeperiodicbp_tpu.enums import UpdateEdge as JEdge
    from kagomeperiodicbp_tpu_torch.algo import fused as F
    from kagomeperiodicbp_tpu_torch.algo.bp import BPConfig, robust_belief_propagation
    from kagomeperiodicbp_tpu_torch.enums import UpdateEdge
    from kagomeperiodicbp_tpu_torch.networks.unit_cell import UnitCell
    from kagomeperiodicbp_tpu_torch.physics import hamiltonians

    cell = UnitCell.load(os.path.join(ROOT, "tests", "assets", "pin_D3.pkl"), device="cpu")
    cell = cell.astype(torch.complex128).force_zero_rotation()
    msgs, _ = robust_belief_propagation(cell, None, BPConfig(trunc_dim=18, dtype=torch.complex128), 2)
    sites = {s: [x.numpy() for x in ss] for s, ss in F._msgs_to_sites(msgs).items()}
    h = hamiltonians.heisenberg_afm()
    port = F.edge_update(2, 3, 28, 18, UpdateEdge.all_options()[0], 10, True)
    ref = JF.edge_update(2, 3, 28, 18, JEdge.all_options()[0], 10, True)

    def energies(cells):
        e = {}
        for name, tdt, jdt in (("c128", torch.complex128, jnp.complex128),
                               ("c64", torch.complex64, jnp.complex64)):
            e[("port", name)] = float(port(
                tuple(torch.from_numpy(c).to(tdt) for c in cells),
                {s: tuple(torch.from_numpy(x).to(tdt) for x in ss) for s, ss in sites.items()},
                torch.as_tensor(h, dtype=tdt), 1e-3)[1])
            e[("jax", name)] = float(ref(
                tuple(jnp.asarray(c, jdt) for c in cells),
                {s: tuple(jnp.asarray(x, jdt) for x in ss) for s, ss in sites.items()},
                jnp.asarray(h, jdt), 1e-3)[1])
        return {"c64_minus_c128": {p: e[(p, "c64")] - e[(p, "c128")] for p in ("port", "jax")},
                "port_minus_jax_c128": e[("port", "c128")] - e[("jax", "c128")]}

    cells = [cell.A.numpy(), cell.B.numpy(), cell.C.numpy()]
    rows = [energies(cells)]
    rng = np.random.default_rng(0)
    for _ in range(nudges):
        rows.append(energies([c + 3e-8 * np.abs(c).max() * (rng.standard_normal(c.shape)
                                                           + 1j * rng.standard_normal(c.shape))
                              for c in cells]))
    return {"pin": rows[0], "nudged": rows[1:]}


def main() -> None:
    part = sys.argv[1] if len(sys.argv) > 1 else "all"
    nudges = int(sys.argv[2]) if len(sys.argv) > 2 else 4
    if part not in ("sketch", "c64", "all"):
        raise SystemExit(__doc__)
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import torch

    torch.set_num_threads(8)
    if part in ("sketch", "all"):
        print(json.dumps({"sketch_quality": sketch()}))
    if part in ("c64", "all"):
        print(json.dumps({"c64_gap": c64_gap(nudges)}))


if __name__ == "__main__":
    main()
