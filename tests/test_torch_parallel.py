"""The port's distribution layer (``parallel/launch``, ``multichip``,
``chi_shard``) against the JAX package's ``parallel/multichip`` and
``parallel/chi_shard``, on the CPU in complex128 at N=2, D=2, χ=8, from
inputs made with numpy from a seed.

The port's ranks are ``gloo`` processes on the CPU
(``launch.run_group(..., device="cpu")``), one group per group size, each
running every case of that size (``launch.run_each``); the JAX side runs on
conftest's virtual 8-device CPU mesh, each of its three programs in a
process of its own. The groups run in a thread meanwhile, so the module
takes about as long as its slowest JAX compile:

* the side-sharded sweep (6 ranks, dp=2 × side=3) against chain 0 of the
  JAX package's ``multichain_bp_energy_step``, whose sweep is
  ``sharded_bp_step``'s (``bp_sweep_impl`` with the side sharder); one
  program less to compile than calling ``sharded_bp_step`` on its own;
* ``multichain_bp_energy_step`` and ``multichain_ite_step`` (two chains, each
  with its own random messages) at (dp=2, side=3);
* ``outgoing_message_sharded`` over 2 and 4 ranks, toward side 0 against the
  JAX package's over a 2-device mesh and toward side 2 against the port's
  unsharded message, with the per-rank row counts that show the partition;
  ``bp_sweep_sharded`` at the unsharded fixed point;
* ``dryrun_multichip`` over 6 ranks at D=2, χ=8, both dtypes;
* the mesh factoring for 1–8 ranks, the backend rule, and a failing rank.

Messages are compared by MPS distance; the updated pair through θ = Σ_e
t1'·t2', which the bond gauge leaves fixed (as in tests/test_torch_ite.py).
"""
import concurrent.futures as cf

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kagomeperiodicbp_tpu.enums import UnitCellFlavor as JFlavor
from kagomeperiodicbp_tpu.enums import UpdateEdge as JEdge
from kagomeperiodicbp_tpu.lattices import BlockSide as JSide
from kagomeperiodicbp_tpu.networks.unit_cell import UnitCell as JUnitCell
from kagomeperiodicbp_tpu.ops import mps as jmps
from kagomeperiodicbp_tpu.parallel import chi_shard as JCS
from kagomeperiodicbp_tpu.parallel import multichip as JMC
from kagomeperiodicbp_tpu_torch.algo import batched as B
from kagomeperiodicbp_tpu_torch.algo import bp as BP
from kagomeperiodicbp_tpu_torch.algo import contraction as C
from kagomeperiodicbp_tpu_torch.algo import fused as F
from kagomeperiodicbp_tpu_torch.convert import (chain_cells_from_numpy, message_batch_from_numpy,
                                                messages_from_numpy, unit_cell_from_numpy)
from kagomeperiodicbp_tpu_torch.enums import UnitCellFlavor, UpdateEdge
from kagomeperiodicbp_tpu_torch.lattices import BlockSide
from kagomeperiodicbp_tpu_torch.ops import mps as mpslib
from kagomeperiodicbp_tpu_torch.parallel import chi_shard as CS
from kagomeperiodicbp_tpu_torch.parallel import launch
from kagomeperiodicbp_tpu_torch.parallel import multichip as MC
from kagomeperiodicbp_tpu_torch.physics.hamiltonians import heisenberg_afm

N, D, CHI = 2, 2, 8
ALS, DT = 2, 0.1
TOL = 1e-10
EDGE = UpdateEdge(UnitCellFlavor.B, UnitCellFlavor.C)
JEDGE = JEdge(JFlavor.B, JFlavor.C)
H = heisenberg_afm()


def numpy_cell(seed):
    rng = np.random.default_rng(seed)

    def one():
        t = rng.standard_normal((2,) + (D,) * 4) + 1j * rng.standard_normal((2,) + (D,) * 4)
        return t / np.linalg.norm(t)

    return {"A": one(), "B": one(), "C": one()}


def numpy_messages(seed):
    """Random messages in the canonical padded profile, {side: [sites]}."""
    rng = np.random.default_rng(seed)
    return {int(s): [rng.standard_normal(x.shape) + 1j * rng.standard_normal(x.shape)
                     for x in m.sites]
            for s, m in C.initial_messages(N, D, CHI).items()}


CELLS = [numpy_cell(10), numpy_cell(11)]
MSGS = [numpy_messages(110), numpy_messages(111)]
# the ITE step's gate and ALS need a positive environment: from random
# messages one sweep does not make one (the ALS then gives NaN in both
# packages), from uniform ones it does, as in the JAX package's tests
UNIFORM = [{int(s): [x.numpy() for x in m.sites] for s, m in C.initial_messages(N, D, CHI).items()}
           ] * 2


def _sites(x):
    """Port (dict of tuples) or JAX message sites as numpy."""
    return {int(s): [np.asarray(v) for v in ss] for s, ss in x.items()}


def _dist(a, b):
    """Largest MPS distance over the sides of two {side: [sites]}."""
    return max(float(mpslib.distance(mpslib.from_sites([torch.tensor(x) for x in a[s]]),
                                     mpslib.from_sites([torch.tensor(x) for x in b[s]])))
               for s in a)


def _chain(batch, i):
    return {s: [np.asarray(x)[i] for x in xs] for s, xs in batch.items()}


def _port_groups():
    """Every port group of this module, one run_each per size."""
    cells, batch = chain_cells_from_numpy(CELLS), message_batch_from_numpy(MSGS)
    uniform, h = message_batch_from_numpy(UNIFORM), torch.tensor(H)
    cell0, msgs0 = unit_cell_from_numpy(CELLS[0]), messages_from_numpy(MSGS[0])
    # the unsharded fixed point for bp_sweep_sharded
    cell_fp = unit_cell_from_numpy(numpy_cell(3))
    cfg = BP.BPConfig(trunc_dim=CHI, max_iterations=40, msg_diff_terminate=1e-12,
                      hermitize_when_finished=False)
    conv, stats = BP.belief_propagation(cell_fp, messages_from_numpy(numpy_messages(103)), cfg, N)
    out = {"fixed_point": (cell_fp, conv, stats)}
    out[6] = launch.run_each(6, [
        (MC.sharded_sweep_task, (C.fused_cells(cell0), F._msgs_to_sites(msgs0), N, D, CHI, CHI)),
        (MC.multichain_task, ("bp", cells, batch, h, N, D, CHI, CHI, EDGE)),
        (MC.multichain_task, ("ite", cells, uniform, h, N, D, CHI, CHI, EDGE, DT, ALS)),
    ], device="cpu")
    for n in (2, 4):
        calls = [(CS.outgoing_message_task, (cell0, msgs0, N, D, CHI, CHI, t)) for t in (0, 2)]
        if n == 4:
            calls.append((CS.bp_sweep_task, (cell_fp, conv, N, D, CHI, CHI)))
        out[n] = launch.run_each(n, calls, device="cpu")
    out["dryrun"] = MC.dryrun_multichip(6, "cpu", D=D, N=N, chi=CHI)
    return out


def _jax_program(name):
    """One of the JAX package's programs on the same inputs, as numpy. Runs
    in a process of its own (spawned: XLA_FLAGS and JAX_PLATFORMS come from
    conftest through the environment, x64 is set here), so the three
    compile at once."""
    import jax

    jax.config.update("jax_enable_x64", True)
    mesh = JMC.make_mesh(n_devices=6)
    cb = tuple(jnp.stack([jnp.asarray(c[f]) for c in CELLS]) for f in "ABC")

    def batch(msgs):
        return {s: tuple(jnp.stack([jnp.asarray(m[s][k]) for m in msgs])
                         for k in range(len(msgs[0][s])))
                for s in msgs[0]}

    h = jnp.asarray(H)
    if name == "bp":
        out = JMC.multichain_bp_energy_step(N, D, CHI, CHI, mesh, JEDGE)(cb, batch(MSGS), h)
    elif name == "ite":
        out = JMC.multichain_ite_step(N, D, CHI, CHI, mesh, JEDGE, als_iters=ALS)(
            cb, batch(UNIFORM), h, jnp.asarray(DT))
    else:
        jcell = JUnitCell(*(jnp.asarray(CELLS[0][f]) for f in "ABC"))
        jmsgs = {JSide(s): jmps.from_sites([jnp.asarray(x) for x in ss])
                 for s, ss in MSGS[0].items()}
        out = JCS.outgoing_message_sharded(jcell, jmsgs, N, D, CHI, CHI, JSide(0),
                                           JCS.chi_mesh(n_devices=2)).sites
    return jax.tree.map(np.asarray, out)


@pytest.fixture(scope="module")
def results():
    """The port's groups (in a thread) and the JAX package's three programs
    (each in a process of its own), all at once."""
    import multiprocessing as mp

    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with cf.ThreadPoolExecutor(1) as threads, cf.ProcessPoolExecutor(
                3, mp_context=mp.get_context("spawn")) as procs:
            port = threads.submit(_port_groups)
            want = {k: procs.submit(_jax_program, k) for k in ("bp", "ite", "chi")}
            want = {k: f.result() for k, f in want.items()}
            got = port.result()
    finally:
        torch.set_num_threads(prev)
    return got, want


def test_side_sharded_sweep_matches_jax(results):
    got, want = results
    new, err = got[6][0]["out"]
    jmsgs, jerrs = want["bp"][0], want["bp"][1]
    assert _dist(_sites(new), _chain(jmsgs, 0)) < TOL
    assert abs(float(err) - float(jerrs[0])) < 1e-12
    # and the port's own single-process batched sweep
    cell0, msgs0 = unit_cell_from_numpy(CELLS[0]), messages_from_numpy(MSGS[0])
    ref, ref_err = B.bp_iteration_batched(N, D, CHI, CHI, None)(C.fused_cells(cell0),
                                                                  F._msgs_to_sites(msgs0))
    assert _dist(_sites(new), _sites(ref)) < 1e-12
    assert abs(float(err) - float(ref_err)) < 1e-12
    assert [r["device"] for r in got[6][0]["ranks"]] == ["cpu"] * 6


def test_multichain_bp_energy_step_matches_jax(results):
    got, want = results
    msgs, errs, energies, mean = got[6][1]["out"]
    jmsgs, jerrs, jenergies, jmean = want["bp"]
    assert errs.shape == energies.shape == (2,)
    assert np.abs(errs.numpy() - np.asarray(jerrs)).max() < TOL
    assert np.abs(energies.numpy() - np.asarray(jenergies)).max() < 1e-9
    assert abs(float(mean) - float(energies.mean())) < 1e-12
    assert abs(float(mean) - float(jmean)) < 1e-9
    for i in range(2):
        assert _dist(_chain(msgs, i), _chain(jmsgs, i)) < TOL


def _theta(cells, i, perms):
    f1, f2 = int(EDGE.first), int(EDGE.second)
    return np.tensordot(np.asarray(cells[f1])[i], np.asarray(cells[f2])[i],
                        ([1 + perms[0][0]], [1 + perms[1][0]]))


def test_multichain_ite_step_matches_jax(results):
    """Energies after the update, the sweep, and the updated pair through
    θ (the bond gauge's free quantity); the third flavour is untouched."""
    got, want = results
    cells, msgs, errs, energies, mean = got[6][2]["out"]
    jcells, jmsgs, jerrs, jenergies, jmean = want["ite"]
    assert np.abs(energies.numpy() - np.asarray(jenergies)).max() < 1e-9
    assert abs(float(mean) - float(jmean)) < 1e-9
    assert np.abs(errs.numpy() - np.asarray(jerrs)).max() < TOL
    perms = MC.write_back_perms(N, D, EDGE)
    for i in range(2):
        assert _dist(_chain(msgs, i), _chain(jmsgs, i)) < TOL
        th, jth = _theta(cells, i, perms), _theta(jcells, i, perms)
        assert np.abs(th - jth).max() / np.abs(jth).max() < 1e-9
        assert np.array_equal(cells[0][i].numpy(), CELLS[i]["A"])
        assert np.abs(th).max() > 0


@pytest.mark.parametrize("n", [2, 4])
def test_chi_sharded_message_matches_jax(results, n):
    got, want = results
    m0, m2 = got[n][0]["out"], got[n][1]["out"]
    assert _dist({0: [x.numpy() for x in m0.sites]}, {0: want["chi"]}) < TOL
    cell0, msgs0 = unit_cell_from_numpy(CELLS[0]), messages_from_numpy(MSGS[0])
    ref2 = C.outgoing_message(cell0, msgs0, N, D, CHI, CHI, BlockSide(2))
    assert float(mpslib.distance(m2, ref2)) < TOL
    # each rank built only its chunk of the partitioned blobs' rows, and the
    # chunks together made every row
    for task in got[n][:2]:
        parts = [r["partitioned"] for r in task["ranks"]]
        assert all(p["swallows"] > 0 and p["rows"] < p["of_rows"] for p in parts)
        assert len({(p["swallows"], p["of_rows"]) for p in parts}) == 1
        assert sum(p["rows"] for p in parts) == parts[0]["of_rows"]


def test_chi_sharded_sweep_keeps_the_unsharded_fixed_point(results):
    got, _ = results
    _, _, stats = got["fixed_point"]
    assert stats.final_error < 1e-10
    _, err = got[4][2]["out"]
    assert err < 1e-9


def test_dryrun_multichip_holds_its_bars(results):
    """dryrun_multichip raises on a miss; here its summaries."""
    got, _ = results
    for summary, dtype in zip(got["dryrun"], ("complex64", "complex128")):
        bp_tol, e_tol, chi_tol, _ = MC.DRYRUN_PASSES[dtype]
        assert summary["dtype"] == dtype and summary["mesh"] == [2, 3]
        assert max(summary["errs"]) < bp_tol
        assert all(v["gap"] < e_tol for v in summary["single"].values())
        assert summary["chi_shard_distance"] < chi_tol
        assert len(summary["ite_energies"]) == 2


@pytest.mark.parametrize("n", range(1, 9))
def test_mesh_shape_matches_jax(n):
    assert MC.mesh_shape(n) == tuple(JMC.make_mesh(n_devices=n).devices.shape)
    assert MC.make_mesh(n_devices=n) == MC.mesh_shape(n)  # outside a group: the plain shape


def test_plain_mesh_runs_only_unsharded():
    """Outside a group a mesh with more than one rank on an axis raises;
    the degenerate (1, 1) mesh runs the vmapped batched sweep."""
    with pytest.raises(ValueError, match="process group"):
        MC.side_sharder(MC.make_mesh(world=6))
    assert MC.side_sharder(MC.make_mesh(world=1)) is None
    assert CS.chi_mesh() == (1,)


def test_world_one_runs_in_process():
    cell0, msgs0 = unit_cell_from_numpy(CELLS[0]), messages_from_numpy(MSGS[0])
    fused, sites = C.fused_cells(cell0), F._msgs_to_sites(msgs0)
    out = launch.run_group(1, MC.sharded_sweep_task, fused, sites, N, D, CHI, CHI, device="cpu")
    ref, _ = B.bp_iteration_batched(N, D, CHI, CHI, None)(fused, sites)
    assert _dist(_sites(out["out"][0]), _sites(ref)) < 1e-14


def test_backend_rule():
    assert launch.plan(3, "cpu") == ("gloo", ["cpu"] * 3)
    if torch.cuda.is_available():
        count = torch.cuda.device_count()
        assert launch.plan(count, "cuda")[0] == "nccl"
        assert launch.plan(count + 1, "cuda") == ("gloo", [f"cuda:{r % count}"
                                                           for r in range(count + 1)])
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            launch.plan(2, "cuda")


def test_failing_rank_raises_in_the_caller():
    with pytest.raises(launch.RankError, match="rank 1 fails on purpose"):
        launch.run_group(2, MC.failing_task, 1, device="cpu")


def _reference_launches():
    """In a rank: one launch counted as the checked call's, then a
    reference run's three, which ``_uncounted`` keeps out of the report."""
    from kagomeperiodicbp_tpu_torch.ops import kernels

    MC._reset_counts()
    kernels.FUSED_TENSOR.launches += 1

    def reference():
        kernels.FUSED_TENSOR.launches += 1
        kernels.CHOL_INV_VARIANTS["blocked"].launches += 2
        return "ref"

    tally = {}
    out = MC._uncounted(tally, reference)
    report = MC.rank_report(tally)
    MC._reset_counts()
    return out, tally, report


def test_rank_report_leaves_out_reference_launches():
    """dryrun_multichip's checks run single-process references inside the
    group; their launches are tallied apart and the rank's report holds
    only the checked calls' launches."""
    out, tally, report = launch.run_group(1, _reference_launches, device="cpu")
    assert out == "ref"
    assert tally == {"fused_tensor": 1, "fused_tensor_operator": 0, "chol_inv_resident": 0,
                     "chol_inv_blocked": 2, "chol_inv_tiled": 0}
    assert report[0]["launches"] == {"fused_tensor": 1, "fused_tensor_operator": 0,
                                     "chol_inv_resident": 0, "chol_inv_blocked": 0, "chol_inv_tiled": 0}
