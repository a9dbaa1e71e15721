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

3. ``batched`` — the batched sweep's limits: (a) the JAX package's
   ``ArbitraryKagomeTN.measure`` of the 21 independent kets of
   tests/assets/warm_start_D2.npz with its per-side BP program
   (KPBP_BP_BATCHED=0) and with the batched one (=1), whose rotation
   identity holds for a unit cell only; (b) port sweeps at N=2, D=4, χ=32
   from a seeded random cell and from uniform, random (product) or dense
   messages (every entry drawn): the
   first sweep batched against per-side with the randomized SVD and with
   exact SVDs, the per-side sweep against itself on a cell moved by 1e-15
   of each entry, and a second sweep, batched and per-side from the first
   batched sweep's messages, against each other beside its own move.

4. ``square`` — ``run_square -D 3 --device cpu`` (its default ladder and
   BP) in the port from the JAX package's seed-0 start, against the JAX
   package's run of the same steps in tests/assets/square_D3.npz
   (``rs_energy``), beside the square AFM's Néel and exact energies.

5. ``pad`` — where measure_padded's energies at a zero pad move: the D=2
   record (data/unit_cells/best) padded to D=3 with no noise and measured
   as ``-D 3 --src 2 -N 1 --chi-factor 1`` does (N=2, χ_bp=18, χ=28,
   complex128). The JAX package's energies at --noise 0 against its own
   at --noise 1e-15 (seeds 0 and 1) and against the port's; then, in the
   JAX package, the measurement alone on the two cells with one set of
   messages, the port's measurement on the JAX messages, BP run on to an
   error of 1e-14, BP at χ_bp 8 and 24, and the unpadded D=2 cell at
   χ_bp=18, each under the same 1e-15 move.

6. ``flops`` — the port's count of its work (kagomeperiodicbp_tpu_torch/
   tools/flops_model.py) beside the JAX tool's XLA count, live
   (tools/flops_model.py ``model``), at N=2, D=2, 3, 4 (χ = 8, 18, 32, the
   JAX tool's χ_env = 2D²+10), complex64, the JAX tool's cell and uniform
   messages: per sweep and per ITE edge update, the port's GEMM part in
   XLA's unit (2 per multiply-add) against XLA's total, and the update split
   into its stages, each counted in both packages: the edge environment
   (the JAX package's ``_edge_env_jit``), gate + ALS (``apply_gate``) and ρ
   (``rho_ij``, the energy and the RDM's health), the last two jitted apart
   here from the JAX tool's ``_gate_als_jit``. Then, for ``_half`` (one side
   of ρ, which ALS also reaches through ``_half_env``), the multiply-adds of
   the port's pairwise order against opt_einsum's path for the JAX
   package's one six-operand einsum.

Prints one JSON line per part.

Usage: python tools/torch_cpu_checks.py [sketch|c64|batched|square|pad|flops|all] [NUDGES]
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


def batched() -> dict:
    import jax.numpy as jnp
    import numpy as np
    import torch

    from kagomeperiodicbp_tpu.algo import arbitrary as JA
    from kagomeperiodicbp_tpu.algo.bp import BPConfig as JBPConfig
    from kagomeperiodicbp_tpu.physics import hamiltonians
    from kagomeperiodicbp_tpu_torch.algo import batched as B
    from kagomeperiodicbp_tpu_torch.algo import contraction as C
    from kagomeperiodicbp_tpu_torch.algo import fused as F
    from kagomeperiodicbp_tpu_torch.networks.unit_cell import UnitCell
    from kagomeperiodicbp_tpu_torch.ops import linalg as L
    from kagomeperiodicbp_tpu_torch.ops import mps as M

    with np.load(os.path.join(ROOT, "tests", "assets", "warm_start_D2.npz")) as z:
        case = dict(z)
    kets = [jnp.asarray(t) for t in case["arb_per_site"]]
    cfg = JBPConfig(trunc_dim=8, max_iterations=30, msg_diff_terminate=1e-11)
    per_site = {"asset_mean_energy": float(case["arb_per_site_mean"])}
    for env in ("0", "1"):
        os.environ["KPBP_BP_BATCHED"] = env
        meas = JA.ArbitraryKagomeTN(kets, N).measure(hamiltonians.heisenberg_afm(), bp_config=cfg, chi=18)
        per_site["per_side" if env == "0" else "batched"] = meas.mean_energy
    os.environ.pop("KPBP_BP_BATCHED")

    d, chi = 4, 32
    cell = UnitCell.random(2, d, torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(9)
    moved = cell._map(lambda t: t + 1e-15 * t.abs().max() * torch.randn(t.shape, generator=gen,
                                                                       dtype=t.real.dtype))
    sweep = {"per_side": F.bp_iteration(N, d, chi, chi, None),
             "batched": B.bp_iteration_batched(N, d, chi, chi, None)}

    def gap(a, b):
        return max(float(M.distance(M.from_sites(a[s]), M.from_sites(b[s]))) for s in a)

    def dense():
        """Every entry of the padded profile drawn (as chip_smoke.py's D=5 check does)."""
        gen = torch.Generator().manual_seed(6)
        profile = F._msgs_to_sites(C.initial_messages(N, d, chi))
        return {s: tuple(torch.complex(*(torch.randn(x.shape, generator=gen, dtype=torch.float64)
                                         for _ in range(2))) for x in ss) for s, ss in profile.items()}

    rsvd = {}
    for model in ("uniform", "random", "dense"):
        msgs = dense() if model == "dense" else F._msgs_to_sites(C.initial_messages(
            N, d, chi, model=model, generator=torch.Generator().manual_seed(6)))
        run = {k: f(C.fused_cells(cell), msgs)[0] for k, f in sweep.items()}
        second = {k: f(C.fused_cells(cell), run["batched"]) for k, f in sweep.items()}
        r = {"batched_vs_per_side": gap(run["batched"], run["per_side"]),
             "per_side_moved_by_1e-15": gap(run["per_side"],
                                            sweep["per_side"](C.fused_cells(moved), msgs)[0]),
             "second_sweep_batched_vs_per_side": gap(second["batched"][0], second["per_side"][0]),
             "second_sweep_mean_distance": float(second["per_side"][1])}
        min_dim = L.RSVD_MIN_DIM
        L.RSVD_MIN_DIM = 10 ** 9
        try:
            exact = {k: f(C.fused_cells(cell), msgs)[0] for k, f in sweep.items()}
        finally:
            L.RSVD_MIN_DIM = min_dim
        r["exact_svd_batched_vs_per_side"] = gap(exact["batched"], exact["per_side"])
        rsvd[f"{model}_messages"] = r
    return {"jax_per_site_block": per_site, "port_D4_chi32": rsvd}


def square() -> dict:
    import numpy as np
    import torch

    from kagomeperiodicbp_tpu_torch import run_square
    from kagomeperiodicbp_tpu_torch.square import algo as S

    with np.load(os.path.join(ROOT, "tests", "assets", "square_D3.npz")) as z:
        start, want = z["start"], float(z["rs_energy"])
    S._initial_cell = lambda m, D, d, generator, dtype, device=None: [  # noqa: E731
        [torch.from_numpy(start[i][j]).to(dtype) for j in range(m)] for i in range(m)]
    e = run_square.main(["-D", "3", "-m", "2", "-n", "4", "--device", "cpu"])
    return {"D3_energy": {"port": e, "jax": want, "gap": abs(e - want)}, "neel": -0.5, "exact": -0.6694}


def pad() -> dict:
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from kagomeperiodicbp_tpu.algo.bp import BPConfig as JBPConfig
    from kagomeperiodicbp_tpu.algo.bp import robust_belief_propagation as jax_bp
    from kagomeperiodicbp_tpu.algo.measurements import measure_energies_and_observables as jax_measure
    from kagomeperiodicbp_tpu.networks.unit_cell import UnitCell as JUnitCell
    from kagomeperiodicbp_tpu.physics import hamiltonians as jax_hamiltonians
    from kagomeperiodicbp_tpu_torch.algo.bp import BPConfig
    from kagomeperiodicbp_tpu_torch.algo.bp import robust_belief_propagation
    from kagomeperiodicbp_tpu_torch.algo.measurements import measure_energies_and_observables
    from kagomeperiodicbp_tpu_torch.convert import messages_from_numpy, unit_cell_from_numpy

    record = os.path.join(ROOT, "data", "unit_cells", "best", "D=2 energy=-0.40239300631851055.pkl")
    n, chi_bp, chi = 2, 18, 28
    h = jax_hamiltonians.BY_NAME["AFM"]()
    src = JUnitCell.load(record).astype(jnp.complex128)

    def padded(noise, seed=0, D=3):
        return src.pad_to(D, noise_fraction=noise, key=jax.random.PRNGKey(seed)).force_zero_rotation()

    def energies(meas):
        return np.array([float(v) for v in meas.energies.values()] + [meas.mean_energy])

    def jax_run(cell, trunc=chi_bp, **bp):
        cfg = dataclasses.replace(JBPConfig(trunc_dim=trunc, dtype=jnp.complex128).for_measurements(1.0), **bp)
        msgs, stats = jax_bp(cell, None, cfg, n)
        return msgs, stats, energies(jax_measure(cell, msgs, n, chi, trunc, h))

    def move(a, b):
        """(largest edge move, mean move)"""
        return {"edge": float(np.abs(a[:-1] - b[:-1]).max()), "mean": float(abs(a[-1] - b[-1]))}

    c0 = padded(0)
    m0, s0, e0 = jax_run(c0)
    out = {"config": {"N": n, "chi_bp": chi_bp, "chi": chi, "D": 3, "src_D": 2},
           "jax_bp_error": s0.final_error, "jax_iterations": s0.iterations}
    for seed in (0, 1):
        out[f"jax_noise_1e-15_seed{seed}"] = move(jax_run(padded(1e-15, seed))[2], e0)
    cell_np = {f: np.asarray(getattr(c0, f)) for f in "ABC"}
    tc = unit_cell_from_numpy(cell_np)
    tm, ts = robust_belief_propagation(tc, None, BPConfig(trunc_dim=chi_bp, dtype=torch.complex128)
                                       .for_measurements(1.0), n)
    out["port_vs_jax"] = move(energies(measure_energies_and_observables(tc, tm, n, chi, chi_bp, h)), e0)
    out["port_bp_mode"] = ts.mode
    tm_j = messages_from_numpy({int(k): [np.asarray(x) for x in m.sites] for k, m in m0.items()})
    out["port_measure_on_jax_messages"] = move(
        energies(measure_energies_and_observables(tc, tm_j, n, chi, chi_bp, h)), e0)
    out["jax_measure_only_noise_1e-15"] = move(energies(jax_measure(padded(1e-15), m0, n, chi, chi_bp, h)), e0)
    for name, kw in (("jax_bp_to_1e-14", {"msg_diff_terminate": 1e-14, "max_iterations": 60}),
                     ("jax_chi_bp_8", {"trunc": 8}), ("jax_chi_bp_24", {"trunc": 24})):
        trunc = kw.pop("trunc", chi_bp)
        a = jax_run(c0, trunc, **kw)[2]
        b = jax_run(padded(1e-15), trunc, **kw)[2]
        out[name + "_noise_1e-15"] = move(b, a)
    unpadded = src.force_zero_rotation()
    a = jax_run(unpadded)[2]
    b = jax_run(unpadded.add_noise(1e-15, key=jax.random.PRNGKey(0)))[2]
    out["jax_unpadded_D2_noise_1e-15"] = move(b, a)
    return out


def flops() -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import flops_model as jax_flops_model
    from kagomeperiodicbp_tpu.algo import contraction as JC
    from kagomeperiodicbp_tpu.algo import edge_env as JE
    from kagomeperiodicbp_tpu.algo import fused as JF
    from kagomeperiodicbp_tpu.enums import UnitCellFlavor as JFlavor, UpdateEdge as JEdge
    from kagomeperiodicbp_tpu.networks.unit_cell import UnitCell as JUnitCell
    from kagomeperiodicbp_tpu.ops import ite_kernels as JK
    from kagomeperiodicbp_tpu.physics import hamiltonians as jax_hamiltonians
    from kagomeperiodicbp_tpu_torch.algo import edge_env as E
    from kagomeperiodicbp_tpu_torch.algo import fused as F
    from kagomeperiodicbp_tpu_torch.convert import messages_from_numpy, unit_cell_from_numpy
    from kagomeperiodicbp_tpu_torch.enums import UnitCellFlavor, UpdateEdge
    from kagomeperiodicbp_tpu_torch.ops import ite_kernels as IK
    from kagomeperiodicbp_tpu_torch.physics.hamiltonians import heisenberg_afm
    from kagomeperiodicbp_tpu_torch.tools import flops_model as FM

    def xla(fn, *args) -> float:
        cost = jax.jit(fn).lower(*args).compile().cost_analysis()
        return float((cost[0] if isinstance(cost, (list, tuple)) else cost).get("flops", 0.0))

    def gemm(fn, *args) -> int:
        return FM.count(fn, *args)[1]["split"]["xla_convention_gemm"]

    def rho_stage(K, t1, t2, env, h, health):
        rho = K.rho_ij(t1, t2, env)
        return K.expectation(rho, h), health(rho)

    c64, n = jnp.complex64, 2
    rows = []
    for D, chi in ((2, 8), (3, 18), (4, 32)):
        whole = jax_flops_model.model(n, D, chi)
        chi_env = 2 * D * D + 10
        # the JAX tool's inputs, handed to the port as numpy arrays
        jcell = JUnitCell.random(d=2, D=D, key=jax.random.PRNGKey(0), dtype=c64)
        jmsgs = JC.initial_messages(n, D, chi, model="uniform", dtype=c64)
        jsites = JF._msgs_to_sites(jmsgs)
        jcells = (jcell.A, jcell.B, jcell.C)
        jedge = JEdge(JFlavor.A, JFlavor.B)
        t1, t2, env, _ = JE.edge_environment_sites(jcells, jsites, n, chi_env, chi, jedge)
        h = jnp.asarray(jax_hamiltonians.heisenberg_afm(), c64)
        g = JK.gate_from_hamiltonian(h, 1e-3)
        t1n, t2n, _ = JK.apply_gate(g, D, t1, t2, env, als_iters=10)
        jax_stages = {
            "environment": xla(lambda c, s: JE.edge_environment_sites(c, s, n, chi_env, chi, jedge)[:3],
                               jcells, jsites),
            "gate_als": xla(lambda h_, a, b, e: JK.apply_gate(JK.gate_from_hamiltonian(h_, 1e-3), D,
                                                              a, b, e, als_iters=10)[:2], h, t1, t2, env),
            "rho": xla(lambda a, b, e, h_: rho_stage(JK, a, b, e, h_, JF._rho_health), t1n, t2n, env, h),
        }

        c64t = torch.complex64
        cell = unit_cell_from_numpy({f: np.asarray(jcell[f]) for f in "ABC"}, "cpu", c64t)
        sites = F._msgs_to_sites(messages_from_numpy({int(s): [np.asarray(x) for x in m.sites]
                                                      for s, m in jmsgs.items()}, "cpu", c64t))
        cells = (cell.A, cell.B, cell.C)
        edge = UpdateEdge(UnitCellFlavor.A, UnitCellFlavor.B)
        to_t = lambda x: torch.tensor(np.asarray(x), dtype=c64t)  # noqa: E731
        pt1, pt2, penv = to_t(t1), to_t(t2), [to_t(e) for e in env]
        ph = torch.as_tensor(heisenberg_afm(), dtype=c64t)
        port_stages = {
            "environment": gemm(lambda: E.edge_environment_sites(cells, sites, n, chi_env, chi, edge)),
            "gate_als": gemm(lambda: IK.apply_gate(IK.gate_from_hamiltonian(ph, 1e-3), D, pt1, pt2,
                                                   penv, als_iters=10)),
            "rho": gemm(lambda: rho_stage(IK, to_t(t1n), to_t(t2n), penv, ph, F._rho_health)),
        }
        sweep = FM.count_sweep(n, D, chi, chi, "cpu")["split"]["xla_convention_gemm"]
        ite = FM.count_ite(n, D, chi, "cpu")["split"]["xla_convention_gemm"]
        rows.append({
            "D": D, "chi": chi, "chi_env": chi_env,
            "sweep": {"port_gemm": sweep, "xla": whole["flops_per_bp_sweep"],
                      "ratio": sweep / whole["flops_per_bp_sweep"]},
            "ite": {"port_gemm": ite, "xla": whole["flops_per_ite_step"],
                    "ratio": ite / whole["flops_per_ite_step"]},
            "ite_stages": {k: {"port_gemm": port_stages[k], "xla": jax_stages[k],
                               "ratio": port_stages[k] / jax_stages[k]} for k in port_stages},
            "half": half_order(D, chi_env),
        })
        print(json.dumps(rows[-1]), flush=True)
    return {"rows": rows}


def half_order(D: int, chi: int, d: int = 2) -> dict:
    """Multiply-adds of one ``_half`` (ρ's side: t, t*, three env sites →
    [d, d, e, e, p, s]) and one ``_half_env`` (the reduced environment's
    side: t_rest, its conjugate, three env sites → [r, r, p, s]): the
    port's pairwise order against opt_einsum's "optimal" path, which the
    JAX package's single einsum takes (``optimize=True``). Shapes: kets
    [d, D, D, D, D] (every bond D after the update), t_rest [r, D, D, D]
    with r = d·D (a QR of the [D³, d·D] matrix), env sites [χ, D, D, χ]."""
    import opt_einsum

    def macs(spec, *shapes):
        return int(opt_einsum.contract_path(spec, *shapes, shapes=True, optimize="optimal")[1].opt_cost) // 2

    r, t, rest, env = d * D, (d, D, D, D, D), (d * D, D, D, D), (chi, D, D, chi)
    out = {}
    for name, spec, ops, pairs in (
            ("half", "deabc,DExyz,paxq,qbyr,rczs->dDeEps", (t, t, env, env, env),
             (("deabc,paxq->debcpxq", t, env), ("debcpxq,qbyr->decpxyr", (d, D, D, D, chi, D, chi), env),
              ("decpxyr,rczs->depxyzs", (d, D, D, chi, D, D, chi), env),
              ("depxyzs,DExyz->dDeEps", (d, D, chi, D, D, D, chi), t))),
            ("half_env", "tabc,paxq,qbym,mczs,Txyz->tTps", (rest, env, env, env, rest),
             (("tabc,paxq->tbcpxq", rest, env), ("tbcpxq,qbym->tcpxym", (r, D, D, chi, D, chi), env),
              ("tcpxym,mczs->tpxyzs", (r, D, chi, D, D, chi), env),
              ("tpxyzs,Txyz->tTps", (r, chi, D, D, D, chi), rest)))):
        port = sum(macs(sp, a, b) for sp, a, b in pairs)
        path = opt_einsum.contract_path(spec, *ops, shapes=True, optimize="optimal")[0]
        out[name] = {"port_pairwise_macs": port, "einsum_optimal_macs": macs(spec, *ops),
                     "einsum_path": [list(p) for p in path]}
    return out


def main() -> None:
    part = sys.argv[1] if len(sys.argv) > 1 else "all"
    nudges = int(sys.argv[2]) if len(sys.argv) > 2 else 4
    if part not in ("sketch", "c64", "batched", "square", "pad", "flops", "all"):
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
    if part in ("batched", "all"):
        print(json.dumps({"batched": batched()}))
    if part in ("square", "all"):
        print(json.dumps({"square": square()}))
    if part in ("pad", "all"):
        print(json.dumps({"pad": pad()}))
    if part in ("flops", "all"):
        print(json.dumps({"flops": flops()}))


if __name__ == "__main__":
    main()
