"""The port's large-D edge environment and work unit on the CPU, complex128,
on inputs made with numpy from a seed:

* the single-layer environment (``edge_environment_sites``) against the
  double-layer one at full rank and under truncation (1e-10), through the
  measurement and the ITE update too, where the blob rule
  (``KPBP_BLOB_LIMIT``) picks it; its parity with the JAX package's is
  ``test_torch_single_layer.py``'s;
* the blob rule (``edge_env.env_single_layer``): double-layer at D=6, χ 72/82,
  single-layer at D=7, χ 98/108 and at D=6, χ 144/164, a pure size check;
* no lattice step of the environment's boundary plans takes one in-leg, so
  the sketched swallow is never on their path: with every blob over the
  limit each swallow still goes through its blob;
* a cell and its BP messages padded to a larger D (``UnitCell.pad_to`` with no
  noise, ``contraction.pad_messages``) measure as the unpadded ones, through
  either environment (1e-10);
* ``large_d_demo --device cpu`` prints the JAX tool's keys.
"""
import json

import collections

import numpy as np
import pytest
import torch

from kagomeperiodicbp_tpu_torch import large_d_demo
from kagomeperiodicbp_tpu_torch.algo import bp as BP
from kagomeperiodicbp_tpu_torch.algo import contraction as C
from kagomeperiodicbp_tpu_torch.algo import edge_env as E
from kagomeperiodicbp_tpu_torch.algo import fused as F
from kagomeperiodicbp_tpu_torch.algo.ite import ITEConfig, ite_update_edge
from kagomeperiodicbp_tpu_torch.algo.measurements import measure_energies_and_observables
from kagomeperiodicbp_tpu_torch.convert import (messages_from_numpy, numpy_product_messages,
                                                numpy_random_cell, unit_cell_from_numpy)
from kagomeperiodicbp_tpu_torch.enums import UpdateEdge
from kagomeperiodicbp_tpu_torch.ops import contract as CT
from kagomeperiodicbp_tpu_torch.ops import ite_kernels as IK
from kagomeperiodicbp_tpu_torch.physics import hamiltonians

TOL = 1e-10
BIG = 10 ** 6  # no truncation
H = hamiltonians.heisenberg_afm()
# KPBP_BLOB_LIMIT: every blob over it (the rule picks single-layer), none
SINGLE, DOUBLE = "1", "1e30"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _sites(msgs_np):
    return {s: tuple(torch.from_numpy(x) for x in ss) for s, ss in msgs_np.items()}


def _rhos(cells, sites, N, chi, chi_msg, single_layer):
    out = {}
    for edge in UpdateEdge.all_options():
        t1, t2, env, _ = E.edge_environment_sites(cells, sites, N, chi, chi_msg, edge,
                                                  single_layer=single_layer)
        out[str(edge)] = IK.rho_ij(t1, t2, env)
    return out


def test_single_layer_environment_matches_double_layer_at_full_rank(monkeypatch):
    """At full rank the single-layer boundary plans give the double-layer
    environment: every edge's RDM, and the measurement and one ITE update
    with the blob limit set so that the rule picks either."""
    N, D = 2, 2
    cell = unit_cell_from_numpy(numpy_random_cell(D, 63))
    msgs = messages_from_numpy(numpy_product_messages(N, D, BIG, 64))
    sites = F._msgs_to_sites(msgs)
    cells = (cell.A, cell.B, cell.C)
    single, double = (_rhos(cells, sites, N, BIG, BIG, s) for s in (True, False))
    for name in single:
        np.testing.assert_allclose(single[name].numpy(), double[name].numpy(), atol=TOL, err_msg=name)

    edge, cfg = UpdateEdge.all_options()[0], ITEConfig(hamiltonian=hamiltonians.heisenberg_afm)
    m, upd = {}, {}
    for limit in (SINGLE, DOUBLE):
        monkeypatch.setenv("KPBP_BLOB_LIMIT", limit)
        CT.reset_swallow_counts()
        m[limit] = measure_energies_and_observables(cell, msgs, N, BIG, BIG, H)
        upd[limit] = ite_update_edge(cell, msgs, N, BIG, BIG, edge, H, 0.1, cfg)
        kind = "direct" if limit == SINGLE else "fused"
        assert CT.swallow_counts()[kind] > 0 and CT.swallow_counts()["sketched"] == 0
    for k, v in m[DOUBLE].energies.items():
        assert abs(m[SINGLE].energies[k] - v) < TOL
    assert abs(upd[SINGLE][1] - upd[DOUBLE][1]) < TOL
    for k, v in upd[DOUBLE][2].items():
        assert abs(upd[SINGLE][2][k] - v) < TOL


def test_single_layer_environment_matches_double_layer_under_truncation(monkeypatch):
    """N=2, D=3, χ_msg=18, χ=12, where the boundary plans truncate (the
    RDMs move by ≥1e-3 from χ=12 to χ=20): with every blob over the limit
    the single-layer plans take no sketched swallow, and each edge's RDM is
    the double-layer one."""
    N, D, chi_msg, chi = 2, 3, 18, 12
    cell_np = numpy_random_cell(D, 68)
    cells = tuple(torch.from_numpy(cell_np[f]) for f in "ABC")
    sites = _sites(numpy_product_messages(N, D, chi_msg, 69))
    monkeypatch.setenv("KPBP_BLOB_LIMIT", SINGLE)
    CT.reset_swallow_counts()
    single = _rhos(cells, sites, N, chi, chi_msg, True)
    counts = CT.swallow_counts()
    assert counts["sketched"] == 0 and counts["direct"] > 0 and counts["fused"] == 0
    double = _rhos(cells, sites, N, chi, chi_msg, False)
    wider = _rhos(cells, sites, N, 20, chi_msg, False)
    for name in single:
        np.testing.assert_allclose(single[name].numpy(), double[name].numpy(), atol=TOL, err_msg=name)
        assert float((double[name] - wider[name]).abs().max()) > 1e-3 * float(double[name].abs().max())


@pytest.mark.parametrize("N", [2, 3, 4])
def test_environment_plans_take_no_one_in_leg_lattice_step(N):
    """The sketched swallow takes a lattice node with one in-leg and two or
    more out-legs; the six edges' top and bottom plans have none (their
    lattice steps take two in-legs and two out, or three and one)."""
    steps = collections.Counter()
    for edge in UpdateEdge.all_options():
        geo = E.edge_geometry(N, 7, 108, 98, edge.direction())
        for plan in (geo.top_plan, geo.bot_plan):
            steps.update((st.n_in, st.n_out) for st in plan.steps if st.source[0] == "lat")
    assert set(steps) == {(2, 2), (3, 1)}


@pytest.mark.parametrize("D,chi_msg,chi,single", [
    (6, 72, 82, False),     # the D=6 update and BP-size measurements: 2.75e8
    (6, 144, 164, True),    # a D=6 measurement at the production χ×2: 1.1e9
    (7, 98, 108, True),     # 1.25e9
    (8, 128, 138, True),    # 4.6e9
    (3, 36, 56, False),     # the pin's measurement
])
def test_blob_rule_picks_the_environment(D, chi_msg, chi, single, monkeypatch):
    """a·b·D⁶ (a = χ_msg, b = χ) against the executor's blob limit, 3e8 by
    default and KPBP_BLOB_LIMIT where set; nothing is contracted."""
    monkeypatch.delenv("KPBP_BLOB_LIMIT", raising=False)
    assert E.env_single_layer(D, chi, chi_msg) is single
    monkeypatch.setenv("KPBP_BLOB_LIMIT", str(chi_msg * chi * D ** 6))
    assert E.env_single_layer(D, chi, chi_msg) is False
    monkeypatch.setenv("KPBP_BLOB_LIMIT", str(chi_msg * chi * D ** 6 - 1))
    assert E.env_single_layer(D, chi, chi_msg) is True


def test_blob_rule_is_what_the_environment_runs(monkeypatch):
    """single_layer=None takes the rule: with the limit below the blob the
    boundary plans run single-layer, at the default limit double-layer."""
    N, D, chi = 2, 2, 8
    cell_np = numpy_random_cell(D, 65)
    cells = tuple(torch.from_numpy(cell_np[f]) for f in "ABC")
    sites = _sites(numpy_product_messages(N, D, chi, 66))
    calls = []
    plan = C.single_layer_plan
    monkeypatch.setattr(C, "single_layer_plan", lambda p: calls.append(p) or plan(p))
    edge = UpdateEdge.all_options()[0]
    E.edge_environment_sites(cells, sites, N, chi, chi, edge)
    assert calls == []
    monkeypatch.setenv("KPBP_BLOB_LIMIT", SINGLE)
    CT.reset_swallow_counts()
    E.edge_environment_sites(cells, sites, N, chi, chi, edge)
    assert len(calls) == 2   # the top and the bottom plan
    assert CT.swallow_counts()["sketched"] == 0 < CT.swallow_counts()["direct"]


@pytest.mark.parametrize("limit", [DOUBLE, SINGLE])
def test_padded_cell_and_messages_measure_as_unpadded(limit, monkeypatch):
    """A D=2 cell with its BP messages (N=2, χ_msg=8), both zero-padded to
    D=3, measure at χ=18 as the D=2 cell does, through the double- and the
    single-layer environment."""
    N, chi_msg, chi = 2, 8, 18
    cell = unit_cell_from_numpy(numpy_random_cell(2, 67))
    msgs, stats = BP.belief_propagation(cell, None, BP.BPConfig(trunc_dim=chi_msg), N)
    assert stats.success
    want = measure_energies_and_observables(cell, msgs, N, chi, chi_msg, H)
    padded = C.pad_messages(msgs, N, 3, chi_msg)
    for side, m in padded.items():
        assert m.sites[0].shape[1] == 9 and msgs[side].sites[0].shape[1] == 4
    monkeypatch.setenv("KPBP_BLOB_LIMIT", limit)
    got = measure_energies_and_observables(cell.pad_to(3, noise_fraction=0), padded, N, chi,
                                           chi_msg, H)
    for k, v in want.energies.items():
        assert abs(got.energies[k] - v) < TOL
    for f in "ABC":
        for k in "xyz":
            assert abs(got.expectations[f][k] - want.expectations[f][k]) < TOL


JAX_TOOL_KEYS = {"D", "N", "chi", "chi_env", "dtype", "single_layer", "backend", "blob_limit",
                 "bp_sweeps", "bp_err", "s_per_sweep", "bp_total_s", "ite_step_s", "energy",
                 "peak_rss_gb"}


@pytest.mark.parametrize("single", [None, "1"])
def test_large_d_demo_prints_the_jax_tools_keys(single, capsys):
    argv = ["2", "--device", "cpu", "--sweeps", "2"] + (["--single-layer", single] if single else [])
    rec = large_d_demo.main(argv)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(rec))
    assert JAX_TOOL_KEYS | {"peak_device_gb", "swallow_counts", "single_layer_env", "device",
                            "sweep_s"} <= set(rec)
    assert "error" not in rec and rec["bp_sweeps"] == 2 and len(rec["sweep_s"]) == 2
    assert rec["single_layer"] is (single == "1") and rec["single_layer_env"] is False
    assert rec["device"] == "cpu" and rec["peak_device_gb"] is None
    assert rec["dtype"] == "complex64" and rec["chi"] == 8 and rec["chi_env"] == 18
    kind = "direct" if single else "fused"
    assert rec["swallow_counts"][kind] > 0 and np.isfinite(rec["energy"])
    assert rec["ite_health"]["sum_eigenvalues"] == pytest.approx(1, abs=1e-3)

