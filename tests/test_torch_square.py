"""The port's square lattice (``square/*``, ``run_square``) against the JAX
package's, on the CPU in complex128, at n=4, m=2, D=2 (χ_msg=8, χ=18) on
a numpy cell from a seed:

* the graph and plans, and one pair expectation, against the JAX package
  live;
* BP messages (by distance), ``measure_energy``, ``bond_expectation`` (h,
  v) and ``pair_expectation`` against the JAX package's values in
  tests/assets/square_D2.npz, written by tools/make_square_case.py (the JAX
  package's square BP takes ~15 s eagerly);
* the simple update from the JAX package's start (drawn there with
  jax.random, patched into ``square.algo._initial_cell``), a one-stage full
  update, and ``run_square --device cpu`` at D=2, each held to the JAX
  package's result at 1e-10 or, where the asset shows the JAX package's own
  result moving by more than 1e-12 under a 1e-15 relative change of its
  input, at 100× that move;
* the scalar plan against the dense oracle and the product state's exact
  energy, as the JAX package's own tests hold it.
"""
import os

import numpy as np
import pytest
import torch

from kagomeperiodicbp_tpu.planner.compiler import sweep_order as jax_sweep_order
from kagomeperiodicbp_tpu.square import algo as JS
from kagomeperiodicbp_tpu.square import lattice as JL
from kagomeperiodicbp_tpu_torch import run_square
from kagomeperiodicbp_tpu_torch.convert import square_cell_from_numpy, square_messages_from_numpy
from kagomeperiodicbp_tpu_torch.ops import exact
from kagomeperiodicbp_tpu_torch.ops import kernels as K
from kagomeperiodicbp_tpu_torch.ops import mps as mpslib
from kagomeperiodicbp_tpu_torch.physics import hamiltonians
from kagomeperiodicbp_tpu_torch.planner.compiler import sweep_order
from kagomeperiodicbp_tpu_torch.square import algo as S
from kagomeperiodicbp_tpu_torch.square import fullupdate as FU
from kagomeperiodicbp_tpu_torch.square import lattice as L

ASSET = os.path.join(os.path.dirname(__file__), "assets", "square_D2.npz")
ASSET_D3 = os.path.join(os.path.dirname(__file__), "assets", "square_D3.npz")
N_BLOCK, M, D = 4, 2, 2
CHI_MSG, CHI = 2 * D * D, 2 * D * D + 10      # run_square's χ rule at chi_factor 1
SEED = 0
BONDS = [(0, 0), (1, 1)]                       # the cell's bond classes measure_energy uses
SU_KEY, SU_DTS, SU_SWEEPS = 1, (0.1, 0.05, 0.01), 30
FU_DTS = (0.05,)
RS_DTS, RS_SWEEPS = tuple(run_square._ladder(0.1, 0.001)), 60   # run_square's defaults
# D=3, where truncation bites: run_square's χ rule, chip_smoke.py's full-update start
D3 = 3
D3_CHI_MSG, D3_CHI = 2 * D3 * D3, 2 * D3 * D3 + 10
D3_SU_DTS, D3_SU_SWEEPS, D3_BP_ITERS = (0.1, 0.05, 0.02), 30, 60
D3_EARLY = 2                                  # BP sweeps before the held one
PERTURB = 1e-15
TOL = 1e-10
BIG = 10**6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def case():
    with np.load(ASSET) as z:
        return dict(z)


@pytest.fixture(scope="module")
def case3():
    with np.load(ASSET_D3) as z:
        return dict(z)


def numpy_square_cell(seed, m=M, D=D, d=2):
    """An m×m cell of unit-norm complex kets [d, U, L, D, R]."""
    rng = np.random.default_rng(seed)

    def one():
        t = rng.standard_normal((d,) + (D,) * 4) + 1j * rng.standard_normal((d,) + (D,) * 4)
        return t / np.linalg.norm(t)

    return [[one() for _ in range(m)] for _ in range(m)]


def _messages(case, prefix="msg"):
    sides = {}
    for key, x in case.items():
        if key.startswith(prefix + "_"):
            s, k = key[len(prefix) + 1:].split("_")
            sides.setdefault(int(s), {})[int(k)] = x
    return square_messages_from_numpy({s: [v[k] for k in sorted(v)] for s, v in sides.items()})


def _bar(move):
    """1e-10, or 100× the JAX package's own move under a PERTURB change of
    its input where that move exceeds 1e-12 (a measured cause)."""
    move = float(move)
    return TOL if move <= 1e-12 else max(TOL, 100 * move)


def test_asset_inputs_are_the_test_cases(case):
    np.testing.assert_array_equal(case["cell"], np.array(numpy_square_cell(SEED)))


def _steps(plan):
    return [(s.source, s.perm, s.start, s.n_in, s.n_out, s.out_dims, s.compress_after)
            for s in plan.steps]


@pytest.mark.parametrize("n", [2, 3, 4])
def test_graph_and_plans_match_jax(n):
    """Nodes, legs and every plan's steps against the JAX package's."""
    for sides in (tuple(range(4)), (1, 2, 3)):
        gj = JL.full_square_graph(n, D, CHI_MSG, tuple(JL.SquareSide(s) for s in sides))
        gt = L.full_square_graph(n, D, CHI_MSG, tuple(L.SquareSide(s) for s in sides))
        assert [(x.nid, x.pos, x.angles, x.dims, x.neighbors, x.source) for x in gt.nodes] == \
               [(x.nid, x.pos, x.angles, x.dims, x.neighbors, x.source) for x in gj.nodes]
        assert sweep_order(gt, L.SquareSide.UP) == jax_sweep_order(gj, JL.SquareSide.UP)
    for toward in range(4):
        pj, pt = JS.message_plan(n, D, CHI, CHI_MSG, toward), S.message_plan(n, D, CHI, CHI_MSG, toward)
        assert _steps(pt) == _steps(pj) and pt.final_sites == pj.final_sites
    assert _steps(S.scalar_plan(n, D, CHI, CHI_MSG)) == _steps(JS.scalar_plan(n, D, CHI, CHI_MSG))
    assert L.square_message_profile(n, D, CHI_MSG) == JL.square_message_profile(n, D, CHI_MSG)
    for side in L.SquareSide:
        assert L.boundary_legs(n, side) == JL.boundary_legs(n, JL.SquareSide(int(side)))


def test_bp_messages_match_jax(case):
    cell = square_cell_from_numpy(case["cell"])
    msgs, err = S.belief_propagation(cell, N_BLOCK, D, CHI_MSG, chi=CHI)
    want = _messages(case)
    for s in L.SquareSide:
        assert float(mpslib.distance(msgs[s], want[s])) < TOL
    assert abs(err - float(case["bp_err"])) < TOL


def test_measure_energy_matches_jax(case):
    cell = square_cell_from_numpy(case["cell"])
    e = S.measure_energy(cell, N_BLOCK, D, _messages(case), CHI, CHI_MSG, hamiltonians.heisenberg_afm())
    assert abs(e - float(case["energy"])) < TOL


@pytest.mark.parametrize("orient", ["h", "v"])
def test_bond_and_pair_expectation_match_jax(case, orient):
    """The RDM path (bond_expectation) and the sandwich path
    (pair_expectation) against the JAX package's values of each."""
    cell = square_cell_from_numpy(case["cell"])
    msgs, h = _messages(case), hamiltonians.heisenberg_afm()
    for (i, j), bond, pair in zip(BONDS, case[f"bond_{orient}"], case[f"pair_{orient}"]):
        assert abs(FU.bond_expectation(cell, N_BLOCK, D, msgs, CHI, CHI_MSG, h, orient, i, j) - bond) < TOL
        v1, v2 = FU.bond_pair(N_BLOCK, orient, i, j)
        assert abs(S.pair_expectation(cell, N_BLOCK, D, msgs, CHI, CHI_MSG, h, v1, v2) - pair) < TOL


def test_pair_expectation_matches_jax_live(case):
    """One pair expectation through both packages on the asset's messages,
    with the port's launches of K1's operator form counted (none on the
    CPU, where the plain version runs)."""
    import jax.numpy as jnp

    from kagomeperiodicbp_tpu.square.lattice import SquareSide as JSide
    from kagomeperiodicbp_tpu.ops.mps import MPS as JMPS

    h = hamiltonians.heisenberg_afm()
    jmsgs = {JSide(int(s)): JMPS(tuple(jnp.asarray(x.numpy()) for x in m.sites), jnp.zeros(()))
             for s, m in _messages(case).items()}
    jcell = [[jnp.asarray(t) for t in row] for row in case["cell"]]
    v1, v2 = FU.bond_pair(N_BLOCK, "h", 1, 1)
    want = JS.pair_expectation(jcell, N_BLOCK, D, jmsgs, CHI, CHI_MSG, h, v1, v2)
    K.reset_launch_counts()
    got = S.pair_expectation(square_cell_from_numpy(case["cell"]), N_BLOCK, D, _messages(case),
                             CHI, CHI_MSG, h, v1, v2)
    assert abs(got - complex(want)) < TOL
    assert K.launch_counts()["fused_tensor_operator"] == 0


def _patched_start(monkeypatch, start):
    seen = []

    def initial_cell(m, D_, d, generator, dtype, device=None):
        seen.append((m, D_, d))
        return [[torch.from_numpy(start[i][j].copy()).to(dtype) for j in range(m)] for i in range(m)]

    monkeypatch.setattr(S, "_initial_cell", initial_cell)
    return seen


def test_simple_update_matches_jax(case, monkeypatch):
    """λ of every bond class after the test's ladder, from the JAX
    package's start."""
    seen = _patched_start(monkeypatch, case["su_start"])
    cell, lams = S.simple_update(hamiltonians.heisenberg_afm(), D=D, m=M, dts=SU_DTS, sweeps_per_dt=SU_SWEEPS)
    assert seen == [(M, D, 2)]
    got = np.array([[[lams[(o, i, j)].numpy() for j in range(M)] for i in range(M)] for o in "hv"])
    assert np.abs(got - case["su_lambda"]).max() < _bar(case["su_lambda_move"])
    assert all(t.shape == (2, D, D, D, D) for row in cell for t in row)


def test_full_update_one_stage_matches_jax(case):
    """One full-update stage (one sweep at dt=0.05) from the JAX package's
    SU cell: the energy it ends on."""
    h = hamiltonians.heisenberg_afm()
    cell = square_cell_from_numpy(case["su_cell"])
    before = [[t.clone() for t in row] for row in cell]
    new, e, hist = FU.full_update(cell, h, n=N_BLOCK, dts=FU_DTS, sweeps_per_dt=1, chi=CHI,
                                  chi_msg=CHI_MSG, bp_iters=40, bp_tol=1e-7)
    assert abs(e - float(case["fu_energy"])) < _bar(case["fu_energy_move"])
    assert [d for d, _ in hist] == list(FU_DTS)
    assert all(torch.equal(a, b) for ra, rb in zip(cell, before) for a, b in zip(ra, rb))


def test_run_square_cpu_matches_jax(case, monkeypatch):
    """python -m kagomeperiodicbp_tpu_torch.run_square -D 2 --device cpu
    from the JAX script's start (PRNGKey(0)): its energy against the JAX
    script's steps."""
    _patched_start(monkeypatch, case["rs_start"])
    e = run_square.main(["-D", str(D), "-m", str(M), "-n", str(N_BLOCK), "--device", "cpu"])
    assert abs(e - float(case["rs_energy"])) < _bar(case["rs_energy_move"])
    assert -0.6694 < e < -0.5   # between the exact ground state and the Néel state


def test_simple_update_d3_matches_jax(case3, monkeypatch):
    """At D=3, where truncation bites: λ after chip_smoke.py's ladder from
    run_square's seed-0 start as the JAX package draws it."""
    _patched_start(monkeypatch, case3["start"])
    _, lams = S.simple_update(hamiltonians.heisenberg_afm(), D=D3, m=M, dts=D3_SU_DTS,
                              sweeps_per_dt=D3_SU_SWEEPS)
    got = np.array([[[lams[(o, i, j)].numpy() for j in range(M)] for i in range(M)] for o in "hv"])
    assert np.abs(got - case3["su_lambda"]).max() < _bar(case3["su_lambda_move"])


def test_bp_step_d3_matches_jax(case3):
    """One BP sweep at D=3 (χ_msg=18, χ=28) on the JAX package's SU cell
    from the messages of its BP's second sweep, against the JAX package's
    sweep by distance; the sweep moves every side by orders of magnitude
    more than the bar."""
    cell = square_cell_from_numpy(case3["su_cell"])
    early, want = _messages(case3, "early_msg"), _messages(case3, "step_msg")
    got = S.bp_step(cell, N_BLOCK, D3, early, D3_CHI, D3_CHI_MSG)
    bar = _bar(case3["step_move"])
    assert float(case3["step_distance"]) > 1e4 * bar
    for s in L.SquareSide:
        assert float(mpslib.distance(got[s], want[s])) < bar


def test_measure_energy_d3_matches_jax(case3):
    """measure_energy at D=3 on the JAX package's SU cell and messages
    (the cell fused, and the unsandwiched network contracted, once)."""
    cell = square_cell_from_numpy(case3["su_cell"])
    e = S.measure_energy(cell, N_BLOCK, D3, _messages(case3), D3_CHI, D3_CHI_MSG, hamiltonians.heisenberg_afm())
    assert abs(e - float(case3["energy"])) < _bar(case3["measure_move"])


def test_run_square_runs_on_the_card_by_default(monkeypatch):
    """Without --device it asks for the card, and raises where there is
    none (the CPU only on request)."""
    assert run_square.parse_args([]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_square.main(["-D", "2", "--sweeps-per-dt", "1"])


def test_square_scalar_matches_dense_oracle():
    """The scalar plan (n=2, no truncation, random messages) against the
    exact dense contraction (the JAX package's own oracle test)."""
    n = 2
    cell = square_cell_from_numpy(numpy_square_cell(5))
    msgs = S.initial_messages(n, D, BIG, model="random", generator=torch.Generator().manual_seed(5))
    msg_sites = {int(s): tuple(m.sites) for s, m in msgs.items()}
    mant, log = S._scalar(S._fused_cell(cell), n, D, msg_sites, BIG, BIG)
    graph = S._graph_for(n, D, BIG, tuple(range(4)))

    def fetch(src):
        if src[0] == "lat":
            i, j = divmod(src[1], n)
            return K.fused_tensor_ref(cell[i % M][j % M])
        _, side, k = src
        return msgs[L.SquareSide(side)].sites[k]

    env, open_legs = exact.contract_dense(graph, fetch, sweep_order(graph, L.SquareSide.UP))
    assert not open_legs
    mlog = sum(float(m.logscale) for m in msgs.values())
    np.testing.assert_allclose(mant * np.exp(log), complex(env) * np.exp(mlog), rtol=1e-9)


def test_square_product_state_energy_exact():
    """|↑…↑⟩: ⟨S·S⟩ = ¼ per bond, so the energy per site is ½ exactly."""
    t = torch.zeros((2, D, D, D, D), dtype=torch.complex128)
    t[0, 0, 0, 0, 0] = 1.0
    cell = [[t for _ in range(M)] for _ in range(M)]
    msgs, _ = S.belief_propagation(cell, N_BLOCK, D, chi_msg=CHI_MSG, max_iterations=20)
    e = S.measure_energy(cell, N_BLOCK, D, msgs, 16, CHI_MSG, hamiltonians.heisenberg_afm())
    assert abs(e - 0.5) < 1e-8
