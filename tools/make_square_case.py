#!/usr/bin/env python
"""Produce tests/assets/square_D2.npz and square_D3.npz for
tests/test_torch_square.py and chip_smoke.py: what the JAX package's square
lattice (kagomeperiodicbp_tpu/square) computes on that test file's cases
(n=4, m=2, AFM Heisenberg, complex128), so the port is held to it without
running the JAX programs there (eagerly, a square BP takes the JAX package
~15 s at D=2 and ~10 min at D=3).

square_D2.npz (D=2, χ_msg=8, χ=18):

* measurement: the numpy cell ``numpy_square_cell(SEED)`` (``cell``,
  [m, m, d, D,D,D,D]), the JAX BP messages from uniform ones
  (``msg_<side>_<k>``, ``bp_err``), ``measure_energy`` (``energy``) and
  ``bond_expectation`` / ``pair_expectation`` of the bonds at BONDS
  (``bond_<h|v>``, ``pair_<h|v>``);
* simple update over the test's ladder SU_DTS × SU_SWEEPS from the JAX
  package's start (jax.random, PRNGKey(SU_KEY); ``su_start``): its λ
  (``su_lambda``, [h|v, i, j, D]), its cell (``su_cell``), and how far a
  PERTURB relative change of the start moves the JAX package's own λ
  (``su_lambda_move``);
* a one-stage full update from ``su_cell`` (FU_DTS, one sweep): its energy
  (``fu_energy``) and the move of that energy under a PERTURB change of
  ``su_cell`` (``fu_energy_move``);
* run_square's computation at D=2 (scripts/run_square.py: the default
  ladder 0.1 → 0.001 halving, 60 sweeps each, from PRNGKey(0), then BP with
  60 iterations and the energy; ``rs_start``, ``rs_energy``) and the moves
  of its λ and energy under a PERTURB change of the start
  (``rs_lambda_move``, ``rs_energy_move``).

square_D3.npz (D=3, χ_msg=18, χ=28, where truncation bites), from the
start run_square draws at seed 0 (PRNGKey(0); ``start``):

* simple update over D3_SU_DTS × D3_SU_SWEEPS (chip_smoke.py's full-update
  start): λ (``su_lambda``), the cell (``su_cell``) and the move of λ under
  a PERTURB change of the start (``su_lambda_move``);
* BP on that cell from uniform messages, D3_BP_ITERS sweeps at most
  (``msg_<side>_<k>``, ``bp_err``), ``measure_energy`` on it (``energy``),
  and the move of that energy when the whole chain runs from the nudged
  start (``energy_move``);
* the two pieces the CPU test holds: one ``bp_step`` from the messages of
  BP's D3_EARLY-th sweep (``early_msg_<side>_<k>``; ``step_msg_<side>_<k>``,
  the least distance it moves a side, ``step_distance``), and the move of
  that step and of ``measure_energy`` when their inputs (the early
  messages; the cell and the converged messages) move by PERTURB
  (``step_move``, ``measure_move``);
* run_square's own computation at D=3 (the default ladder, 60 sweeps per
  stage, BP of 60 sweeps; ``rs_energy``, ``rs_bp_err``).

It imports both packages and runs on the CPU (D2 a few minutes, D3 ~40):

    JAX_PLATFORMS=cpu python tools/make_square_case.py [D2] [D3]
"""
import contextlib
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> None:
    which = [a for a in sys.argv[1:]] or ["D2", "D3"]
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np

    from kagomeperiodicbp_tpu.physics import hamiltonians
    from kagomeperiodicbp_tpu.square import algo as JS
    from kagomeperiodicbp_tpu.square import fullupdate as JFU
    from tests.test_torch_square import (BONDS, CHI, CHI_MSG, D, D3, D3_BP_ITERS, D3_CHI, D3_CHI_MSG,
                                         D3_EARLY, D3_SU_DTS, D3_SU_SWEEPS, FU_DTS, M, N_BLOCK, PERTURB, RS_DTS,
                                         RS_SWEEPS, SEED, SU_DTS, SU_KEY, SU_SWEEPS, numpy_square_cell)

    h = hamiltonians.heisenberg_afm()

    def jcell(cell):
        return [[jnp.asarray(t) for t in row] for row in cell]

    def nudged(cell, seed):
        """The cell with every entry moved by PERTURB of its largest."""
        rng = np.random.default_rng(seed)
        return [[t + PERTURB * np.abs(t).max() * rng.standard_normal(t.shape) for t in row]
                for row in cell]

    def jax_start(key, D):
        """The start simple_update draws from `key`, as numpy arrays."""
        keys = jax.random.split(key, M * M)
        return [[np.asarray((lambda t: t / jnp.linalg.norm(t))(
                    jax.random.normal(keys[i * M + j], (2, D, D, D, D)).astype(jnp.complex128)))
                 for j in range(M)] for i in range(M)]

    @contextlib.contextmanager
    def start_from(cell):
        """simple_update draws `cell` (row-major) in place of its jax.random start."""
        normal, flat = jax.random.normal, iter([t for row in cell for t in row])
        jax.random.normal = lambda key, shape: jnp.asarray(next(flat))
        try:
            yield
        finally:
            jax.random.normal = normal

    def lambdas(lams):
        return np.array([[[np.asarray(lams[(o, i, j)]) for j in range(M)] for i in range(M)]
                         for o in "hv"])

    def save_messages(arrays, prefix, msgs):
        for s, mm in msgs.items():
            for k, x in enumerate(mm.sites):
                arrays[f"{prefix}_{int(s)}_{k}"] = np.asarray(x)

    def write(name, arrays):
        out = os.path.join(ROOT, "tests", "assets", f"square_{name}.npz")
        np.savez_compressed(out, **arrays)
        print(f"wrote {out}: {sorted(arrays)}", flush=True)

    def d2():
        arrays = {}

        def energy(cell, max_iterations=40):
            msgs, err = JS.belief_propagation(cell, N_BLOCK, D, CHI_MSG, chi=CHI, max_iterations=max_iterations)
            return msgs, err, JS.measure_energy(cell, N_BLOCK, D, msgs, CHI, CHI_MSG, h)

        # measurement of the numpy cell
        cell = numpy_square_cell(SEED)
        arrays["cell"] = np.array(cell)
        msgs, err, e = energy(jcell(cell))
        arrays["bp_err"], arrays["energy"] = np.array(err), np.array(e)
        save_messages(arrays, "msg", msgs)
        for o in "hv":
            arrays[f"bond_{o}"] = np.array([JFU.bond_expectation(jcell(cell), N_BLOCK, D, msgs, CHI, CHI_MSG,
                                                                 h, o, i, j) for i, j in BONDS])
            arrays[f"pair_{o}"] = np.array([JS.pair_expectation(jcell(cell), N_BLOCK, D, msgs, CHI, CHI_MSG,
                                                                h, *JFU.bond_pair(N_BLOCK, o, i, j))
                                            for i, j in BONDS])
        print("measurement:", arrays["energy"], arrays["bond_h"], arrays["bond_v"], flush=True)

        # simple update over the test's ladder, and its sensitivity to the start
        start = jax_start(jax.random.PRNGKey(SU_KEY), D)
        arrays["su_start"] = np.array(start)
        su_cell, lams = JS.simple_update(h, D=D, m=M, dts=SU_DTS, sweeps_per_dt=SU_SWEEPS,
                                         key=jax.random.PRNGKey(SU_KEY))
        arrays["su_lambda"] = lambdas(lams)
        arrays["su_cell"] = np.array([[np.asarray(t) for t in row] for row in su_cell])
        runs = []
        for c in (start, nudged(start, 1)):
            with start_from(c):
                runs.append(lambdas(JS.simple_update(h, D=D, m=M, dts=SU_DTS, sweeps_per_dt=SU_SWEEPS,
                                                     key=jax.random.PRNGKey(SU_KEY))[1]))
        arrays["su_lambda_move"] = np.array(np.abs(runs[0] - runs[1]).max())
        print("SU: lambda move", arrays["su_lambda_move"], flush=True)

        # one full-update stage from the SU cell, and its sensitivity
        fu = [JFU.full_update(jcell(c), h, n=N_BLOCK, dts=FU_DTS, sweeps_per_dt=1, chi=CHI,
                              chi_msg=CHI_MSG, bp_iters=40, bp_tol=1e-7)[1]
              for c in (arrays["su_cell"], nudged(arrays["su_cell"], 2))]
        arrays["fu_energy"], arrays["fu_energy_move"] = np.array(fu[0]), np.array(abs(fu[0] - fu[1]))
        print("FU:", fu, flush=True)

        # run_square at D=2 (scripts/run_square.py's steps), and its sensitivity
        rs_start = jax_start(jax.random.PRNGKey(0), D)
        arrays["rs_start"] = np.array(rs_start)
        rs = []
        for c in (rs_start, nudged(rs_start, 3)):
            with start_from(c):
                c_su, lams = JS.simple_update(h, D=D, m=M, dts=RS_DTS, sweeps_per_dt=RS_SWEEPS,
                                              key=jax.random.PRNGKey(0))
            rs.append((lambdas(lams), energy(c_su, max_iterations=60)[2]))
        c_su, _ = JS.simple_update(h, D=D, m=M, dts=RS_DTS, sweeps_per_dt=RS_SWEEPS, key=jax.random.PRNGKey(0))
        arrays["rs_energy"] = np.array(energy(c_su, max_iterations=60)[2])
        arrays["rs_lambda_move"] = np.array(np.abs(rs[0][0] - rs[1][0]).max())
        arrays["rs_energy_move"] = np.array(abs(rs[0][1] - rs[1][1]))
        print("run_square:", arrays["rs_energy"], "moves", arrays["rs_lambda_move"], arrays["rs_energy_move"])
        write("D2", arrays)

    def d3():
        from kagomeperiodicbp_tpu.ops import mps as JM

        arrays = {}
        start = jax_start(jax.random.PRNGKey(0), D3)
        arrays["start"] = np.array(start)

        def chain(c):
            """SU from start `c`, BP from uniform messages, energy."""
            with start_from(c):
                cell, lams = JS.simple_update(h, D=D3, m=M, dts=D3_SU_DTS, sweeps_per_dt=D3_SU_SWEEPS,
                                              key=jax.random.PRNGKey(0))
            msgs, err = JS.belief_propagation(cell, N_BLOCK, D3, D3_CHI_MSG, chi=D3_CHI,
                                              max_iterations=D3_BP_ITERS)
            return cell, lambdas(lams), msgs, err, JS.measure_energy(cell, N_BLOCK, D3, msgs, D3_CHI,
                                                                     D3_CHI_MSG, h)

        cell, lam, msgs, err, e = chain(start)
        arrays["su_lambda"] = lam
        arrays["su_cell"] = np.array([[np.asarray(t) for t in row] for row in cell])
        arrays["bp_err"], arrays["energy"] = np.array(err), np.array(e)
        save_messages(arrays, "msg", msgs)
        print("D3 chain: energy", e, "bp err", err, flush=True)
        # one sweep from the messages of the D3_EARLY-th sweep, and its move
        early, _ = JS.belief_propagation(cell, N_BLOCK, D3, D3_CHI_MSG, chi=D3_CHI, max_iterations=D3_EARLY)
        save_messages(arrays, "early_msg", early)
        step = JS.bp_step(cell, N_BLOCK, D3, early, D3_CHI, D3_CHI_MSG)
        save_messages(arrays, "step_msg", step)
        arrays["step_distance"] = np.array(min(float(JM.distance(early[s], step[s])) for s in step))

        # the pieces' sensitivity: the cell and the messages moved by PERTURB
        rng = np.random.default_rng(5)

        def moved(ms):
            return {s: JM.MPS(tuple(x + PERTURB * jnp.abs(x).max() * rng.standard_normal(x.shape)
                                    for x in mm.sites), mm.logscale) for s, mm in ms.items()}

        moved_step = JS.bp_step(cell, N_BLOCK, D3, moved(early), D3_CHI, D3_CHI_MSG)
        arrays["step_move"] = np.array(max(float(JM.distance(step[s], moved_step[s])) for s in step))
        moved_cell, moved_msgs = jcell(nudged(arrays["su_cell"], 4)), moved(msgs)
        e_moved = JS.measure_energy(moved_cell, N_BLOCK, D3, moved_msgs, D3_CHI, D3_CHI_MSG, h)
        arrays["measure_move"] = np.array(abs(e_moved - e))
        print("D3 moves: step", arrays["step_move"], "measure", arrays["measure_move"], flush=True)

        # the whole chain from the nudged start
        _, lam2, _, _, e2 = chain(nudged(start, 6))
        arrays["su_lambda_move"] = np.array(np.abs(lam - lam2).max())
        arrays["energy_move"] = np.array(abs(e - e2))
        print("D3 moves: lambda", arrays["su_lambda_move"], "energy", arrays["energy_move"], flush=True)
        write("D3", arrays)

        # run_square's own steps at D=3
        with start_from(start):
            c_su, _ = JS.simple_update(h, D=D3, m=M, dts=RS_DTS, sweeps_per_dt=RS_SWEEPS,
                                       key=jax.random.PRNGKey(0))
        msgs, err = JS.belief_propagation(c_su, N_BLOCK, D3, D3_CHI_MSG, chi=D3_CHI, max_iterations=60)
        arrays["rs_energy"] = np.array(JS.measure_energy(c_su, N_BLOCK, D3, msgs, D3_CHI, D3_CHI_MSG, h))
        arrays["rs_bp_err"] = np.array(err)
        print("D3 run_square:", arrays["rs_energy"], "bp err", err, flush=True)
        write("D3", arrays)

    for name in which:
        {"D2": d2, "D3": d3}[name]()


if __name__ == "__main__":
    main()
