"""The port's ITE training path against the JAX package, on the CPU in
complex128, from inputs made with numpy from a seed:

* the linear algebra of the update (``robust_solve``, ``eigh_psd_sqrt``,
  ``pinv_reg``), the gate, the reduced environment, the ALS truncation,
  ``apply_gate`` and ``truncation_distance``, each on the same arrays in both
  packages (the JAX side eager);
* ``fused.edge_update`` on three edges at N=2, D=2 (the JAX side jitted);
* ``full_ite`` at N=2, D=2 over two segments;
* the control flow of ``algo/ite`` on the port alone (the tests of
  tests/test_ite_controlflow.py that need no JAX run), the card default of
  ``full_ite`` and ``run_ite``, and the state carried across from the JAX
  package (a tracker checkpoint, a best-store file, saved cells).

Tolerance 1e-10 throughout. The update fixes the shared bond only up to a
phase per value of that leg (the SVDs of θ and of the ALS gauge fix), so the
new tensors are compared through what does not depend on it: θ = Σ_e t1'·t2'
and |t1'|, |t2'| element by element.
"""
import logging
import os
import pickle
import random
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kagomeperiodicbp_tpu.algo import fused as JF
from kagomeperiodicbp_tpu.algo import ite as JI
from kagomeperiodicbp_tpu.algo.bp import BPConfig as JBPConfig
from kagomeperiodicbp_tpu.enums import UpdateEdge as JUpdateEdge
from kagomeperiodicbp_tpu.networks.unit_cell import UnitCell as JUnitCell
from kagomeperiodicbp_tpu.ops import ite_kernels as JK
from kagomeperiodicbp_tpu.ops import linalg as JL
from kagomeperiodicbp_tpu.utils import best_store as jax_best_store
from kagomeperiodicbp_tpu_torch import run_ite
from kagomeperiodicbp_tpu_torch.visualizations import ITEPlots
from kagomeperiodicbp_tpu_torch.algo import contraction as C
from kagomeperiodicbp_tpu_torch.algo import edge_env as E
from kagomeperiodicbp_tpu_torch.algo import fused as F
from kagomeperiodicbp_tpu_torch.algo import ite as I
from kagomeperiodicbp_tpu_torch.algo.bp import BPConfig, BPStats
from kagomeperiodicbp_tpu_torch.convert import unit_cell_from_numpy
from kagomeperiodicbp_tpu_torch.enums import UpdateEdge, UpdateMode
from kagomeperiodicbp_tpu_torch.networks.unit_cell import UnitCell
from kagomeperiodicbp_tpu_torch.ops import ite_kernels as K
from kagomeperiodicbp_tpu_torch.ops import linalg as L
from kagomeperiodicbp_tpu_torch.physics import hamiltonians

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, D, CHI, CHI_MSG = 2, 2, 18, 8
TOL = 1e-10


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's tensors here are small: one torch thread runs them as fast
    and leaves the cores to XLA's compiler, which idle torch worker threads
    measurably slow down."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def numpy_cell(seed, D=D):
    rng = np.random.default_rng(seed)

    def one():
        t = rng.standard_normal((2,) + (D,) * 4) + 1j * rng.standard_normal((2,) + (D,) * 4)
        return t / np.linalg.norm(t)

    return {"A": one(), "B": one(), "C": one()}


def _crandn(rng, *shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _j(a):
    return jnp.asarray(np.asarray(a))


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, tol=TOL, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    assert np.abs(got - want).max() < tol, (what, np.abs(got - want).max())


def _theta(t1, t2):
    """Σ_e t1[d, e, …]·t2[d', e, …]: the pair's state, free of the gauge on e."""
    return np.einsum("deabc,fexyz->dabcfxyz", _np(t1), _np(t2))


def _hold_pair(got1, got2, want1, want2):
    th_g, th_w = _theta(got1, got2), _theta(want1, want2)
    _close(th_g / np.abs(th_w).max(), th_w / np.abs(th_w).max(), what="theta")
    _close(np.abs(_np(got1)), np.abs(_np(want1)), what="|t1'|")
    _close(np.abs(_np(got2)), np.abs(_np(want2)), what="|t2'|")


@pytest.fixture(scope="module")
def pair():
    """(t1, t2, env) of edge (A,B) of a random N=2, D=2 cell with uniform
    messages, from the port's edge environment, as numpy arrays."""
    cells = tuple(_t(a) for a in numpy_cell(seed=11).values())
    msgs = C.initial_messages(N, D, CHI_MSG)
    t1, t2, env, _ = E.edge_environment_sites(cells, F._msgs_to_sites(msgs), N, CHI, CHI_MSG,
                                              UpdateEdge.all_options()[0])
    return _np(t1), _np(t2), [_np(e) for e in env]


H_AFM = hamiltonians.heisenberg_afm()


# ------------------------------ linalg ------------------------------------


@pytest.mark.parametrize("rhs", ["vector", "matrix"])
def test_robust_solve_matches_jax(rhs):
    """A PSD system with a 4-dimensional null space: the null components of
    b are dropped alike."""
    rng = np.random.default_rng(1)
    a = _crandn(rng, 16, 12)
    n = a @ a.conj().T
    b = _crandn(rng, 16) if rhs == "vector" else _crandn(rng, 16, 3)
    _close(L.robust_solve(_t(n), _t(b)), JL.robust_solve(_j(n), _j(b)))


def test_eigh_psd_sqrt_matches_jax():
    """A Hermitian matrix with negative eigenvalues: the same clipped X·X†
    and the same raw eigenvalues."""
    rng = np.random.default_rng(2)
    m = _crandn(rng, 12, 12)
    n = m + m.conj().T
    x, w = L.eigh_psd_sqrt(_t(n))
    xj, wj = JL.eigh_psd_sqrt(_j(n))
    _close(w, wj)
    assert (np.asarray(wj) < 0).any()
    _close(x @ x.mH, np.asarray(xj) @ np.asarray(xj).conj().T)


@pytest.mark.parametrize("side", [1 - 1e-3, 1 + 1e-3])
def test_pinv_reg_cuts_where_jax_does(side):
    """A singular value just below (dropped) or just above (kept) the cut
    rtol·s_max: both packages drop the same ones. The matrix is a permuted
    diagonal with complex phases, whose SVD is exact, so that a kept value
    at 1e-10·s_max is inverted without the 1e10 amplification of round-off
    that a dense matrix would bring."""
    rng = np.random.default_rng(3)
    s = np.array([2.0, 1.0, 0.5, 0.1, 2.0 * L.PINV_RTOL * side])
    a = np.diag(s * np.exp(1j * rng.uniform(0, 2 * np.pi, 5)))[rng.permutation(5)]
    got, want = _np(L.pinv_reg(_t(a))), np.asarray(JL.pinv_reg(_j(a)))
    # kept, the small value's inverse 1/(2e-10) is the largest; dropped, 1/0.1
    assert (np.abs(got).max() > 1e9) == (side > 1)
    _close(got / np.abs(want).max(), want / np.abs(want).max())


# ------------------------------ kernels -----------------------------------


@pytest.mark.parametrize("dt", [1e-3, 0.1])
@pytest.mark.parametrize("ham", ["AFM", "Ising-AFM"])
def test_gate_from_hamiltonian_matches_jax(ham, dt):
    h = hamiltonians.BY_NAME[ham](0.3) if ham != "AFM" else H_AFM
    _close(K.gate_from_hamiltonian(_t(h), dt), JK.gate_from_hamiltonian(_j(h), dt))


def test_reduced_env_matches_jax(pair):
    """_phase_fix keeps the QR factors unique: a1 and a2 agree as they are,
    and so do a_i·t_i_rest, X·X† and the raw eigenvalues w."""
    t1, t2, env = pair
    x, a1, a2, r1, r2, w = (_np(v) for v in K.reduced_env(_t(t1), _t(t2), [_t(e) for e in env]))
    xj, a1j, a2j, r1j, r2j, wj = (np.asarray(v) for v in
                                  JK.reduced_env(_j(t1), _j(t2), [_j(e) for e in env]))
    _close(w, wj, what="w")
    _close(a1, a1j, what="a1")
    _close(a2, a2j, what="a2")
    _close(np.tensordot(a1, r1, ([2], [0])), np.tensordot(a1j, r1j, ([2], [0])), what="a1·t1_rest")
    _close(np.tensordot(a2, r2, ([2], [0])), np.tensordot(a2j, r2j, ([2], [0])), what="a2·t2_rest")
    xx = lambda v: np.einsum("abx,cdx->abcd", v, v.conj())  # noqa: E731
    _close(xx(x), xx(xj), what="X·X†")


@pytest.fixture(scope="module")
def als_inputs(pair):
    """(ea1, ea2, X): the gated pair split by the SVD, as apply_gate makes
    them, from the JAX package's reduced environment."""
    t1, t2, env = pair
    x, a1, a2, _, _, _ = (np.asarray(v) for v in JK.reduced_env(_j(t1), _j(t2), [_j(e) for e in env]))
    g = np.asarray(JK.gate_from_hamiltonian(_j(H_AFM), 0.1))
    d, r1, r2 = a1.shape[0], a1.shape[2], a2.shape[2]
    theta = np.einsum("iIjJ,Ier,Jes->irjs", g, a1, a2).reshape(d * r1, d * r2)
    u, s, vh = np.linalg.svd(theta, full_matrices=False)
    ea1 = (u * np.sqrt(s)).reshape(d, r1, -1).transpose(0, 2, 1)
    ea2 = (np.sqrt(s)[:, None] * vh).reshape(-1, d, r2).transpose(1, 0, 2)
    return ea1, ea2, x


def test_als_optimize_matches_jax(als_inputs):
    ea1, ea2, x = als_inputs
    got = K.als_optimize(D, _t(ea1), _t(ea2), _t(x), n_iter=10)
    want = JK.als_optimize(D, _j(ea1), _j(ea2), _j(x), n_iter=10)
    th = lambda a, b: np.einsum("der,fes->drfs", _np(a), _np(b))  # noqa: E731
    _close(th(*got), th(*want), what="theta")
    for g, w in zip(got, want):
        _close(np.abs(_np(g)), np.abs(np.asarray(w)), what="|a'|")


def test_truncation_distance_matches_jax(als_inputs):
    ea1, ea2, x = als_inputs
    na1, na2 = (np.asarray(v) for v in JK.als_optimize(D, _j(ea1), _j(ea2), _j(x), n_iter=10))
    got = float(K.truncation_distance(*(_t(v) for v in (ea1, ea2, na1, na2, x))))
    want = float(JK.truncation_distance(*(_j(v) for v in (ea1, ea2, na1, na2, x))))
    assert 0 < want < 1 and abs(got - want) < TOL


@pytest.mark.parametrize("gate", ["AFM", "none"])
def test_apply_gate_matches_jax(pair, gate):
    t1, t2, env = pair
    g = H_AFM if gate == "AFM" else None
    got = K.apply_gate(None if g is None else K.gate_from_hamiltonian(_t(g), 0.1), D,
                       _t(t1), _t(t2), [_t(e) for e in env])
    want = JK.apply_gate(None if g is None else JK.gate_from_hamiltonian(_j(g), 0.1), D,
                         _j(t1), _j(t2), [_j(e) for e in env])
    _hold_pair(got[0], got[1], want[0], want[1])
    _close(got[2], want[2], what="w")


# --------------------------- the edge update ------------------------------


@pytest.mark.parametrize("k", range(3), ids=lambda k: str(UpdateEdge.all_options()[k]))
def test_edge_update_matches_jax(k):
    """One whole edge update (env, gate, ALS, RDM, write-back) against the
    JAX package's jitted programs: energy and health, the pair's state
    across the written-back tensors, and the untouched flavour."""
    data = numpy_cell(seed=21)
    msgs = C.initial_messages(N, D, CHI_MSG)
    sites = F._msgs_to_sites(msgs)
    edge, jedge = UpdateEdge.all_options()[k], JUpdateEdge.all_options()[k]
    cells = tuple(_t(a) for a in data.values())
    got = F.edge_update(N, D, CHI, CHI_MSG, edge, 10, True)(cells, sites, _t(H_AFM), 0.1)
    want = JF.edge_update(N, D, CHI, CHI_MSG, jedge, 10, True)(
        tuple(_j(a) for a in data.values()),
        {s: tuple(_j(_np(x)) for x in ss) for s, ss in sites.items()},
        _j(H_AFM), jnp.asarray(0.1))
    for name, g, w in zip(("energy", "herm", "sum_eig", "neg"), got[1:], want[1:]):
        assert abs(complex(g) - complex(w)) < TOL, name
    assert abs(complex(got[1]).imag) == 0 and abs(float(got[3]) - 1) < 1e-10
    _, _, _, (p1, p2) = E.edge_environment_sites(cells, sites, N, CHI, CHI_MSG, edge)
    f1, f2 = int(edge.first), int(edge.second)
    theta = lambda c: np.tensordot(_np(c[f1]), _np(c[f2]), ([1 + p1[0]], [1 + p2[0]]))  # noqa: E731
    th_g, th_w = theta(got[0]), theta(want[0])
    _close(th_g / np.abs(th_w).max(), th_w / np.abs(th_w).max(), what="theta")
    for f in (f1, f2):
        _close(np.abs(_np(got[0][f])), np.abs(np.asarray(want[0][f])), what="|t'|")
    (rest,) = {0, 1, 2} - {f1, f2}
    assert np.array_equal(_np(got[0][rest]), data["ABC"[rest]])


def test_full_ite_matches_jax():
    """Two segments from the same numpy cell, with the same edge and mode
    order from random.Random(seed): tracker energies, edge energies and error
    count as the JAX package's.

    Why als_iterations=2: each ALS sweep's SVD picks the shared bond's
    phase anew and amplifies round-off in it, so after ten sweeps the two
    packages (or the JAX package jitted and eager) leave a bond in
    different phases. That phase is a gauge, but the rest of the run is not
    blind to it: the update depends on it (reduced_env's rj⁻ᵀ), and so do
    the segment's messages, made for the old phase (ROADMAP queue 3;
    test_reduced_env_rj_inverse_makes_the_update_phase_covariant shows the
    first).
    After two sweeps the phases still agree to round-off, and the runs
    within this test's 1e-10."""
    data = numpy_cell(seed=3)
    kw = dict(hamiltonian=hamiltonians.heisenberg_afm, time_steps=[0.1, 0.1],
              num_mode_repetitions_per_segment=1, num_edge_repetitions_per_mode=2,
              bp_every_edge=False, als_iterations=2, seed=5)
    jcfg = JI.ITEConfig(**kw)
    _, _, jtr = JI.full_ite(JUnitCell(*(_j(data[f]) for f in "ABC")), jcfg, N=N, D=D, chi=CHI,
                            bp_config=JBPConfig(trunc_dim=CHI_MSG))
    best, cell, tr = I.full_ite(unit_cell_from_numpy(data), I.ITEConfig(**kw), N=N, D=D,
                                chi=CHI, bp_config=BPConfig(trunc_dim=CHI_MSG), device="cpu")
    assert len(tr.energies) == len(jtr.energies) == 2
    _close(np.array(tr.energies), np.array(jtr.energies), what="tracker energies")
    assert tr.error_count == jtr.error_count == 0
    for seg, jseg in zip(tr.stats, jtr.stats):
        assert seg.edge_energies.keys() == jseg.edge_energies.keys()
        for k, v in jseg.edge_energies.items():
            assert abs(seg.edge_energies[k] - v) < TOL, k
        assert [m.name for m in seg.modes_order] == [m.name for m in jseg.modes_order]
    assert best == tr.best_energy and abs(best - jtr.best_energy) < TOL


# ------------------------------ control flow ------------------------------


def test_mode_order_no_immediate_repeats():
    cfg = I.ITEConfig(num_mode_repetitions_per_segment=50)
    rng = random.Random(0)
    last = None
    for _ in range(10):
        order = I._mode_order(cfg, last, rng)
        assert len(order) == 50
        seq = ([last] if last is not None else []) + order
        assert all(a != b for a, b in zip(seq, seq[1:]))
        last = order[-1]


def test_mode_order_deterministic_when_not_random():
    cfg = I.ITEConfig(num_mode_repetitions_per_segment=6, random_mode_order=False)
    assert I._mode_order(cfg, None, random.Random(0)) == [UpdateMode(i % 3) for i in range(6)]


def test_edge_and_mode_order_are_the_jax_packages():
    """The same random.Random(seed) draws give the same edges, time steps
    and modes in both packages."""
    for seed in range(3):
        cfg, jcfg = I.ITEConfig(seed=seed), JI.ITEConfig(seed=seed)
        rng, jrng = random.Random(seed), random.Random(seed)
        got = [(str(e), dt) for e, dt in I._edge_order(cfg, 1e-2, rng)]
        want = [(str(e), dt) for e, dt in JI._edge_order(jcfg, 1e-2, jrng)]
        assert got == want
        assert ([m.name for m in I._mode_order(cfg, None, rng)]
                == [m.name for m in JI._mode_order(jcfg, None, jrng)])


def test_harden_bp_config_if_struggled():
    log = logging.getLogger("t")
    base = BPConfig(trunc_dim=8)
    ok = BPStats(success=True, final_config=BPConfig(trunc_dim=50))
    cfg, chi = I._harden_bp_config_if_struggled(base, 18, ok, log)
    assert cfg.trunc_dim == 8 and chi == 18
    bad = BPStats(success=False, final_config=BPConfig(trunc_dim=19))
    cfg, chi = I._harden_bp_config_if_struggled(base, 18, bad, log)
    assert cfg.trunc_dim == 19 and chi == int(19 * 1.33)
    mild = BPStats(success=False, final_config=BPConfig(trunc_dim=12))
    cfg, chi = I._harden_bp_config_if_struggled(base, 18, mild, log)
    assert cfg.trunc_dim == 12 and chi == 18


def test_harden_bp_config_respects_cap():
    log = logging.getLogger("t")
    cfg, chi = BPConfig(trunc_dim=8, trunc_dim_cap=32), 18
    for _ in range(60):  # one segment's worth of always-failing edge updates
        escalated = BPStats(success=False,
                            final_config=BPConfig(trunc_dim=int(cfg.trunc_dim * 2.5) + 1))
        cfg, chi = I._harden_bp_config_if_struggled(cfg, chi, escalated, log)
    assert cfg.trunc_dim <= 32 and chi <= int(32 * 1.33)


def _tiny_cell(seed=0, D=D):
    return unit_cell_from_numpy(numpy_cell(seed, D))


def test_full_ite_seeds_trunc_dim_cap(monkeypatch):
    captured = {}

    def fake_robust_bp(cell, messages, bp_cfg, N):
        captured["cfg"] = bp_cfg
        raise I.ITEError("stop here")

    monkeypatch.setattr(I, "robust_belief_propagation", fake_robust_bp)
    cfg = I.ITEConfig(hamiltonian=hamiltonians.heisenberg_afm, time_steps=[1e-3],
                      num_total_errors_threshold=1, seed=0)
    with pytest.raises(I.ITEError):
        I.full_ite(_tiny_cell(), cfg, N=2, D=2, bp_config=BPConfig(trunc_dim=8), device="cpu")
    assert captured["cfg"].trunc_dim_cap == 32


def test_robust_bp_escalation_capped_and_plateau_stops(monkeypatch):
    from kagomeperiodicbp_tpu_torch.algo import bp as bpmod

    calls = []

    def make_fake(errors):
        it = iter(errors)

        def fake_bp(cell, msgs_in, cfg, N):
            err = next(it)
            calls.append(cfg.trunc_dim)
            return {"attempt": len(calls), "err": err}, bpmod.BPStats(success=False, final_error=err)

        return fake_bp

    monkeypatch.setattr(bpmod, "belief_propagation", make_fake([1e-4, 9e-5, 1e-9]))
    msgs, stats = bpmod.robust_belief_propagation(None, None, BPConfig(trunc_dim=8, allowed_retries=5), N=2)
    assert len(calls) == 2 and msgs["err"] == 9e-5 and stats.final_error == 9e-5

    calls.clear()
    monkeypatch.setattr(bpmod, "belief_propagation", make_fake([1e-1, 1e-2, 1e-3, 1e-4, 1e-5, 1e-6]))
    cfg = BPConfig(trunc_dim=8, trunc_dim_cap=21, allowed_retries=5)
    msgs, stats = bpmod.robust_belief_propagation(None, None, cfg, N=2)
    assert calls == [8, 13, 20, 21]
    assert msgs["err"] == 1e-4 and stats.final_config.trunc_dim <= 21


class _FakeMeas:
    def __init__(self, e):
        self.mean_energy = e


def test_tracker_history_revert_and_load(tmp_path):
    path = str(tmp_path / "tracker.pkl")
    tr = I.ITETracker(checkpoint_path=path, history_limit=3)
    cells = [_tiny_cell(s) for s in range(5)]
    for s, c in enumerate(cells):
        tr.log_segment(1e-2, c, _FakeMeas(-0.1 * s), I.ITESegmentStats(
            delta_t=1e-2, bp_stats=[BPStats(final_config=BPConfig(dtype=torch.complex128))],
            modes_order=[UpdateMode.B]))
    assert len(tr.energies) == 5 and len(tr.cells) == 3
    assert tr.best_energy == pytest.approx(-0.4)

    cell = tr.revert_back(1)
    assert len(tr.energies) == 4
    np.testing.assert_array_equal(_np(cell.A), tr.cells[-1]["A"])
    np.testing.assert_array_equal(tr.cells[-1]["A"], _np(cells[3].A))

    tr2 = I.ITETracker.load(path)
    assert tr2.best_energy == pytest.approx(-0.4) and len(tr2.energies) == 5
    np.testing.assert_array_equal(_np(tr2.best_cell.B), _np(cells[4].B))
    assert tr2.stats[-1].bp_stats[0].final_config.dtype is torch.complex128
    assert tr2.stats[-1].modes_order == [UpdateMode.B]


def test_revert_back_beyond_history_raises():
    tr = I.ITETracker(history_limit=2)
    for s in range(3):
        tr.log_segment(1e-2, _tiny_cell(s), _FakeMeas(-1.0), I.ITESegmentStats())
    with pytest.raises(ValueError):
        tr.revert_back(2)


def test_decreasing_global_field_protocol():
    f = hamiltonians.DecreasingGlobalField()
    assert f(None) == 0.0
    v1 = f(1e-3)
    assert v1 == pytest.approx(1e-2 * 0.93)
    v2 = f(1e-3)
    assert v2 == pytest.approx(v1 * 0.93)
    assert f(1e-6) == pytest.approx(v2 * 0.90)
    for _ in range(500):
        f(1e-6)
    assert f(1e-6) == 0.0 and f(None) == 0.0


def test_field_hamiltonian_matches_bare_at_zero():
    h0 = hamiltonians.heisenberg_afm()
    np.testing.assert_allclose(h0, hamiltonians.heisenberg_afm_with_field(0.0))
    assert np.abs(hamiltonians.heisenberg_afm_with_field(0.3) - h0).max() > 1e-3


def _raise_linalg(*args, **kwargs):
    raise torch.linalg.LinAlgError("linalg.eigh: The algorithm failed to converge")


@pytest.mark.parametrize("failure", ["ITEError", "LinAlgError"])
def test_full_ite_rolls_back_on_segment_error(monkeypatch, failure):
    """A segment whose edge update fails — an ITEError, or torch.linalg's
    eigh raising inside the update, which ite_update_edge turns into an
    ITEError — leaves the cell at its pre-segment state and counts one
    error, as the JAX package does with a NaN."""
    calls = {"n": 0}
    if failure == "ITEError":
        def exploding_update(*args):
            calls["n"] += 1
            raise I.ITEError("boom")

        monkeypatch.setattr(I, "ite_update_edge", exploding_update)
    else:
        update = I.ite_update_edge

        def counted(*args):
            calls["n"] += 1
            monkeypatch.setattr(torch.linalg, "eigh", _raise_linalg)
            return update(*args)

        monkeypatch.setattr(I, "ite_update_edge", counted)
    cell0 = _tiny_cell(0)
    cfg = I.ITEConfig(
        hamiltonian=hamiltonians.heisenberg_afm, time_steps=[1e-2],
        num_mode_repetitions_per_segment=1, num_edge_repetitions_per_mode=1,
        add_gaussian_noise_fraction=0.5,  # would visibly change the cell
        randomly_rotate_unit_cell_between_segments=False, bp_every_edge=False,
        num_total_errors_threshold=10,
    )
    _, cell_out, tracker = I.full_ite(cell0, cfg, N=2, D=2, chi=12, bp_config=BPConfig(trunc_dim=8),
                                      measure_every_segment=False, device="cpu")
    assert calls["n"] == 1 and tracker.error_count == 1
    np.testing.assert_array_equal(_np(cell_out.A), _np(cell0.A))


def test_edge_update_with_nan_is_an_ite_error(monkeypatch):
    """A non-finite update fails the health check (the JAX package's `>`
    test lets a NaN through; the port's does not)."""
    def nan_update(*args, **kwargs):
        def run(cells, msg_sites, h, dt):
            nan = torch.tensor(float("nan"), dtype=torch.float64)
            return cells, nan, nan, nan, nan
        return run

    monkeypatch.setattr(F, "edge_update", nan_update)
    cell = _tiny_cell(0)
    msgs = C.initial_messages(N, D, CHI_MSG)
    with pytest.raises(I.ITEError, match="unhealthy"):
        I.ite_update_edge(cell, msgs, N, CHI, CHI_MSG, UpdateEdge.all_options()[0], H_AFM, 0.1,
                          I.ITEConfig())


def test_measure_every_thins_measurements(monkeypatch):
    """The cadence alone: BP, the edge update and the measurement are
    stand-ins that cost nothing."""
    class Meas:
        mean_energy, expectations = -0.1, {}

    monkeypatch.setattr(I, "robust_belief_propagation",
                        lambda cell, msgs, cfg, N: ({}, BPStats(success=True)))
    monkeypatch.setattr(I, "ite_update_edge", lambda cell, *args: (cell, -0.1, {}))
    monkeypatch.setattr(I, "measure_energies_and_observables", lambda *args: Meas())
    cfg = I.ITEConfig(
        hamiltonian=hamiltonians.heisenberg_afm, time_steps=[1e-2] * 5 + [1e-3] * 2,
        num_mode_repetitions_per_segment=1, num_edge_repetitions_per_mode=1,
        symmetric_second_order_trotterization=False,
        randomly_rotate_unit_cell_between_segments=False, bp_every_edge=False,
    )
    _, _, tracker = I.full_ite(_tiny_cell(0), cfg, N=2, D=2, chi=12, bp_config=BPConfig(trunc_dim=8),
                               measure_every=3, device="cpu")
    # segments 0, 3, 6 (every 3rd) + 4 (end of the 1e-2 block) → 4 measurements
    assert len(tracker.energies) == 4


def test_pad_to_preserves_state_exactly():
    """Zero-noise pad: the JAX package's embedding, and each fused tensor is
    the old one zero-padded, so every network built from the cell (given
    messages zero-padded alike) contracts to the same value. (The JAX test
    contracts the whole N=2 network densely, ~1 min here; the fused tensors
    carry the same fact.)"""
    data = numpy_cell(seed=0)
    cell = unit_cell_from_numpy(data).rotate_ccw()
    padded = cell.pad_to(3, noise_fraction=0.0)
    assert padded.D == 3 and padded.A.shape == (2, 3, 3, 3, 3) and padded.rotated == 1
    jpadded = JUnitCell(*(_j(data[f]) for f in "ABC")).rotate_ccw().pad_to(3, noise_fraction=0.0)
    for f, small, big in zip("ABC", C.fused_cells(cell), C.fused_cells(padded)):
        np.testing.assert_array_equal(_np(padded[f]), np.asarray(jpadded[f]))
        keep = np.zeros((9,) * 4, dtype=bool)
        keep[np.ix_(*[[0, 1, 3, 4]] * 4)] = True  # (ket, bra) pairs with both < 2
        big = _np(big)
        np.testing.assert_array_equal(big[keep].reshape((4,) * 4), _np(small))
        assert not big[~keep].any()
    noisy = cell.pad_to(3, generator=torch.Generator().manual_seed(0))
    assert float(torch.linalg.vector_norm(noisy.A - padded.A)) > 1e-4


def test_pad_to_rejects_shrinking():
    with pytest.raises(ValueError):
        _tiny_cell(0, D=3).pad_to(2)


def test_random_and_noise_repeat_with_a_generator():
    """UnitCell.random and add_noise draw from the generator they are given:
    the same seed gives the same cell; the noise has the asked-for norm."""
    def make(seed):
        return UnitCell.random(2, 3, torch.Generator().manual_seed(seed))

    a, b, c = make(4), make(4), make(5)
    for f in "ABC":
        assert torch.equal(a[f], b[f]) and not torch.equal(a[f], c[f])
        assert abs(float(torch.linalg.vector_norm(a[f])) - 1) < 1e-12
    n1 = a.add_noise(0.1, torch.Generator().manual_seed(1))
    n2 = a.add_noise(0.1, torch.Generator().manual_seed(1))
    assert torch.equal(n1.A, n2.A)
    assert abs(float(torch.linalg.vector_norm(n1.A - a.A)) - 0.1) < 1e-12
    assert UnitCell.random(2, 2, dtype=torch.float64).A.dtype == torch.float64


@pytest.mark.parametrize("state", ["zero", "q0", "q0-", "product"])
def test_product_states_match_jax(state):
    """The structured starts of run_ite, as the JAX package builds them
    (the random product state: one random tensor on all three sites)."""
    if state == "product":
        cell = UnitCell.random_product_state(2, 3, torch.Generator().manual_seed(0))
        assert torch.equal(cell.A, cell.B) and torch.equal(cell.A, cell.C)
        return
    if state == "zero":
        got, want = UnitCell.zero_product_state(2, 3), JUnitCell.zero_product_state(2, 3)
    else:
        chirality = +1 if state == "q0" else -1
        got = UnitCell.product_state_120(2, 3, chirality)
        want = JUnitCell.product_state_120(2, 3, chirality)
    for f in "ABC":
        np.testing.assert_array_equal(_np(got[f]), np.asarray(want[f]))
    assert got.replace(rotated=2).rotated == 2 and got.replace(B=got.A).B is got.A


def test_full_ite_and_run_ite_default_to_the_card(monkeypatch, tmp_path):
    """With no device named, full_ite and run_ite ask for the card; without
    CUDA both raise before any work, instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def ran(*args, **kwargs):
        raise AssertionError("ITE ran without a card")

    monkeypatch.setattr(I, "robust_belief_propagation", ran)
    cfg = I.ITEConfig(hamiltonian=hamiltonians.heisenberg_afm, time_steps=[1e-2])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        I.full_ite(None, cfg, N=2, D=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        I.full_ite(_tiny_cell(0), cfg, N=2, D=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_ite.main(["-D", "2", "--steps", "1", "--out", str(tmp_path)])
    assert not os.listdir(tmp_path)


def test_run_ite_live_plots_write_the_dashboards(monkeypatch, tmp_path):
    """run_ite --live-plots on the CPU (one segment, measured at N=2, Agg
    backend): full_ite hands the tracker to ITEPlots after the measured
    segment, which writes its three figures under --out."""
    monkeypatch.setenv("MPLBACKEND", "Agg")
    updates = []
    update = ITEPlots.update

    def counted(self, tracker):
        updates.append(len(tracker.energies))
        return update(self, tracker)

    monkeypatch.setattr(ITEPlots, "update", counted)
    e = run_ite.main(["-D", "2", "-N", "2", "--steps", "1", "--mode-reps", "1", "--device", "cpu",
                      "--out", str(tmp_path), "--no-best-store", "--live-plots", "--measure-n", "2"])
    assert updates == [1] and np.isfinite(e)
    for name in ("ite_progress.png", "ite_progress_health.png", "ite_progress_cores.png"):
        path = tmp_path / name
        assert path.stat().st_size > 1000 and path.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def _reduced_env_rj_inverse(t1, t2, env):
    """``ite_kernels.reduced_env`` with rj⁻¹ on X's r2 leg, where the
    reference takes rj⁻ᵀ (ROADMAP queue 3); it keeps a2·X."""
    a1, t1_rest = K._qr_reduce(t1)
    a2, t2_rest = K._qr_reduce(t2)
    nred = torch.einsum("rRps,qQsp->rqRQ", K._half_env(t1_rest, env[0:3]),
                        K._half_env(t2_rest, env[3:6]))
    r1, r2 = nred.shape[0], nred.shape[1]
    x, w = L.eigh_psd_sqrt(nred.reshape(r1 * r2, r1 * r2))
    x = x.reshape(r1, r2, x.shape[1])
    _, ri = L.qr_stable(x.reshape(r1, -1).T)
    li = ri.T
    li_inv = L.pinv_reg(li)
    _, rj = L.qr_stable(x.permute(0, 2, 1).reshape(-1, r2))
    rj_inv = L.pinv_reg(rj)
    x = torch.tensordot(li_inv, x, dims=([1], [0]))
    t1_rest = torch.tensordot(li_inv, t1_rest, dims=([1], [0]))
    a1 = torch.tensordot(a1, li, dims=([2], [0]))
    x = torch.tensordot(x, rj_inv, dims=([1], [0])).permute(0, 2, 1)
    t2_rest = torch.tensordot(rj_inv.T, t2_rest, dims=([1], [0]))
    a2 = torch.tensordot(a2, rj.T, dims=([2], [0]))
    return x, a1, a2, t1_rest, t2_rest, w


def test_reduced_env_rj_inverse_makes_the_update_phase_covariant(monkeypatch):
    """The reference's reduced_env puts rj⁻ᵀ on X's r2 leg where rj⁻¹
    belongs, so its update is not covariant under a phase gauge on the
    shared bond: θ moves with the phase. With rj⁻¹, which changes X alone,
    θ stays within 1e-10."""
    cell = _tiny_cell(4)
    t1, t2, env, _ = E.edge_environment_sites((cell.A, cell.B, cell.C),
                                              F._msgs_to_sites(C.initial_messages(N, D, CHI_MSG)),
                                              N, CHI, CHI_MSG, UpdateEdge.all_options()[0])
    ref, fixed = K.reduced_env(t1, t2, env), _reduced_env_rj_inverse(t1, t2, env)
    for a, b in zip(ref[1:], fixed[1:]):
        assert torch.equal(a, b)
    g = K.gate_from_hamiltonian(_t(H_AFM), 0.1)
    gen = torch.Generator().manual_seed(1)
    ph = torch.exp(2j * torch.pi * torch.rand(t1.shape[1], generator=gen, dtype=torch.float64))
    p1, p2 = t1 * ph[None, :, None, None, None], t2 * ph.conj()[None, :, None, None, None]

    def moved():
        a = K.apply_gate(g, D, t1, t2, env, als_iters=2)
        b = K.apply_gate(g, D, p1, p2, env, als_iters=2)
        th_a, th_b = _theta(a[0], a[1]), _theta(b[0], b[1])
        return np.abs(th_a - th_b).max() / np.abs(th_a).max()

    reference = moved()
    monkeypatch.setattr(K, "reduced_env", _reduced_env_rj_inverse)
    assert moved() < TOL < reference


# --------------------------- state carried across -------------------------


def test_unit_cell_save_load_both_ways(tmp_path):
    data = numpy_cell(seed=8)
    port = unit_cell_from_numpy(data).rotate_ccw()
    port.save(str(tmp_path / "port.pkl"))
    jcell = JUnitCell.load(str(tmp_path / "port.pkl"))
    assert jcell.rotated == 1
    for f in "ABC":
        np.testing.assert_array_equal(np.asarray(jcell[f]), _np(port[f]))
    JUnitCell(*(_j(data[f]) for f in "ABC"), rotated=2).save(str(tmp_path / "jax.pkl"))
    back = UnitCell.load(str(tmp_path / "jax.pkl"))
    assert back.rotated == 2
    for f in "ABC":
        np.testing.assert_array_equal(_np(back[f]), data[f])


def test_unit_cell_load_refuses_foreign_globals(tmp_path):
    path = tmp_path / "evil.pkl"
    with open(path, "wb") as fh:
        pickle.dump({"A": os.getcwd, "B": 0, "C": 0}, fh)
    with pytest.raises(pickle.UnpicklingError):
        UnitCell.load(str(path))


_READ_JAX_STATE = """
import json, sys
import numpy as np
from kagomeperiodicbp_tpu_torch.convert import tracker_from_jax_checkpoint
from kagomeperiodicbp_tpu_torch.utils.best_store import load_best
tr = tracker_from_jax_checkpoint(sys.argv[1])
cell, energy = load_best(2, folder=sys.argv[2])
out = {"energies": tr.energies, "best": tr.best_energy, "errors": tr.error_count,
       "best_cell": {f: np.abs(tr.best_cell[f].numpy()).sum() for f in "ABC"},
       "cells": [{f: float(np.abs(c[f]).sum()) for f in "ABC"} for c in tr.cells],
       "store": [energy, {f: float(np.abs(cell[f].numpy()).sum()) for f in "ABC"}],
       "modes": [m.name for s in tr.stats for m in s.modes_order],
       "bp_dtype": str(tr.stats[0].bp_stats[0].final_config.dtype),
       "imported": sorted(m for m in sys.modules
                          if m == "jax" or m.startswith("jax.") or m == "kagomeperiodicbp_tpu"
                          or m.startswith("kagomeperiodicbp_tpu."))}
out["best_cell"] = {k: float(v) for k, v in out["best_cell"].items()}
print(json.dumps(out))
"""


def test_jax_checkpoint_and_best_store_read_without_jax(tmp_path):
    """A checkpoint written by the JAX package's ITETracker.save and a
    best-store file written by its save_if_best, read by the port in a
    fresh process that never imports JAX or the JAX package."""
    import json

    from kagomeperiodicbp_tpu.algo.bp import BPStats as JBPStats
    from kagomeperiodicbp_tpu.enums import UpdateMode as JUpdateMode

    path = str(tmp_path / "tracker.pkl")
    jtr = JI.ITETracker(checkpoint_path=path, history_limit=3)
    cells = [numpy_cell(seed=30 + s) for s in range(4)]
    for s, data in enumerate(cells):
        stats = JI.ITESegmentStats(
            delta_t=1e-2, modes_order=[JUpdateMode(s % 3)],
            bp_stats=[JBPStats(iterations=3, final_config=JBPConfig(dtype=jnp.complex128))])
        jtr.log_segment(1e-2, JUnitCell(*(_j(data[f]) for f in "ABC")),
                        _FakeMeas([-0.1, -0.3, -0.2, -0.25][s]), stats)
    folder = str(tmp_path / "best")
    jax_best_store.save_if_best(JUnitCell(*(_j(cells[2][f]) for f in "ABC")), -0.31, 2, folder)
    env = {**os.environ, "PYTHONPATH": REPO}
    res = subprocess.run([sys.executable, "-c", _READ_JAX_STATE, path, folder], env=env,
                         capture_output=True, text=True, timeout=120, cwd=str(tmp_path))
    assert res.returncode == 0, res.stderr
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got["imported"] == []
    assert got["energies"] == [-0.1, -0.3, -0.2, -0.25] and got["best"] == -0.3
    assert got["errors"] == 0 and got["modes"] == ["A", "B", "C", "A"]
    assert got["bp_dtype"] == "torch.complex128"
    abs_sum = lambda d: {f: float(np.abs(d[f]).sum()) for f in "ABC"}  # noqa: E731
    assert got["best_cell"] == pytest.approx(abs_sum(cells[1]), rel=1e-15)
    assert got["cells"] == [pytest.approx(abs_sum(c), rel=1e-15) for c in cells[1:]]
    assert got["store"][0] == -0.31
    assert got["store"][1] == pytest.approx(abs_sum(cells[2]), rel=1e-15)
