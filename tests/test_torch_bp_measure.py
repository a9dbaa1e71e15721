"""The port's BP and measurement against the JAX package and the dense
oracle, at N=2, D=2:

* BP from the same numpy cell and uniform messages reaches the same fixed
  point in the same number of iterations as JAX's per-side sweep
  (``batched=False``, which compiles in seconds here; the port runs its
  default, the batched sweep, which gives the same messages);
* the six edge RDMs match the exact oracle (ported from test_edge_env.py);
* the slice as a whole — the port's ``production_measurement`` — gives the
  six edge energies of the JAX pipeline it replaces, to 1e-9.
"""
import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kagomeperiodicbp_tpu.algo.bp import BPConfig as JBPConfig
from kagomeperiodicbp_tpu.algo.bp import robust_belief_propagation as jax_robust_bp
from kagomeperiodicbp_tpu.algo.measurements import (
    measure_energies_and_observables as jax_measure,
)
from kagomeperiodicbp_tpu.networks.unit_cell import UnitCell as JUnitCell
from kagomeperiodicbp_tpu_torch.algo import contraction as C
from kagomeperiodicbp_tpu_torch.algo import edge_env as E
from kagomeperiodicbp_tpu_torch.algo import fused as F
from kagomeperiodicbp_tpu_torch.algo.bp import BPConfig, robust_belief_propagation
from kagomeperiodicbp_tpu_torch.algo.measurements import expectation_values_with_rdm
from kagomeperiodicbp_tpu_torch.convert import (
    messages_from_numpy,
    to_numpy,
    unit_cell_from_numpy,
)
from kagomeperiodicbp_tpu_torch.enums import UpdateEdge
from kagomeperiodicbp_tpu_torch.lattices import BlockSide, KagomeBlock
from kagomeperiodicbp_tpu_torch import measure
from kagomeperiodicbp_tpu_torch.measure import production_measurement
from kagomeperiodicbp_tpu_torch.ops import exact, ite_kernels as K
from kagomeperiodicbp_tpu_torch.ops import mps as mpslib
from kagomeperiodicbp_tpu_torch.physics import hamiltonians
from kagomeperiodicbp_tpu_torch.planner.compiler import sweep_order

N, D = 2, 2
# the production convention at block N (tools/make_measurement_pin.py with
# its N = 1): BP at χ_msg = χ_bubble = 2·2D², measurement at χ = 2·(2D²+10)
CHI_MSG = 2 * (2 * D * D)
CHI_MEAS = 2 * (2 * D * D + 10)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's tensors here are small: one torch thread runs them as fast
    and leaves the cores to XLA's compiler, which idle torch worker threads
    measurably slow down."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)



def numpy_cell(seed, rotated=0):
    rng = np.random.default_rng(seed)

    def one():
        t = rng.standard_normal((2,) + (D,) * 4) + 1j * rng.standard_normal((2,) + (D,) * 4)
        return t / np.linalg.norm(t)

    return {"A": one(), "B": one(), "C": one(), "rotated": rotated}


@pytest.fixture(scope="module")
def jax_run():
    """JAX pipeline once per module: zero-rotation cell, robust BP with the
    measurement config (per-side sweep), then the edge measurements."""
    data = numpy_cell(seed=42, rotated=1)
    cell = JUnitCell(*(jnp.asarray(data[f]) for f in "ABC"), rotated=data["rotated"])
    cell = cell.astype(jnp.complex128).force_zero_rotation()
    cfg = JBPConfig(trunc_dim=2 * D * D, dtype=jnp.complex128, batched=False).for_measurements(2.0)
    msgs, stats = jax_robust_bp(cell, None, cfg, N)
    meas = jax_measure(cell, msgs, N, CHI_MEAS, cfg.trunc_dim, hamiltonians.heisenberg_afm())
    sites = {int(s): [np.asarray(x) for x in m.sites] for s, m in msgs.items()}
    return data, stats, sites, meas


def test_bp_fixed_point_matches_jax(jax_run):
    data, jstats, jsites, _ = jax_run
    cell = unit_cell_from_numpy(data).astype(torch.complex128).force_zero_rotation()
    cfg = BPConfig(trunc_dim=2 * D * D, dtype=torch.complex128).for_measurements(2.0)
    msgs, stats = robust_belief_propagation(cell, None, cfg, N)
    # retries draw random messages, whose numbers differ between the packages
    assert jstats.attempts == stats.attempts == 1
    assert stats.iterations == jstats.iterations
    assert stats.success
    jmsgs = messages_from_numpy(jsites)
    for side in BlockSide:
        assert float(mpslib.distance(msgs[side], jmsgs[side])) < 1e-9, side
    assert to_numpy(msgs)[0][0].shape == jsites[0][0].shape


def test_production_measurement_matches_jax(jax_run, tmp_path):
    data, _, _, jmeas = jax_run
    path = os.path.join(tmp_path, "cell.pkl")
    with open(path, "wb") as fh:
        pickle.dump(data, fh)
    got = production_measurement(path, N=N - 1, device="cpu")
    assert (got["N"], got["chi"], got["chi_bp"]) == (N, CHI_MEAS, CHI_MSG)
    for k, v in jmeas.energies.items():
        assert abs(got["edge_energies"][k] - v) < 1e-9, k
    assert abs(got["mean_energy"] - jmeas.mean_energy) < 1e-9


def test_production_measurement_defaults_to_the_card(monkeypatch, tmp_path):
    """With no device named, the entry point asks for the card; on a host
    without CUDA it raises before any work, instead of running on the CPU."""
    path = os.path.join(tmp_path, "cell.pkl")
    with open(path, "wb") as fh:
        pickle.dump(numpy_cell(seed=3), fh)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def ran(*args, **kwargs):
        raise AssertionError("the measurement ran without a card")

    monkeypatch.setattr(measure, "robust_belief_propagation", ran)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        production_measurement(path)
    monkeypatch.setattr("sys.argv", ["measure", path])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        measure.main()


def test_damped_sweep_keeps_a_fraction_of_the_old_message():
    """A damped sweep returns compress((1-d)·new + d·old) per side, with the
    distance measured before the mixing."""
    cell = unit_cell_from_numpy(numpy_cell(seed=3))
    msgs = F._msgs_to_sites(C.initial_messages(N, D, 8, model="random",
                                               generator=torch.Generator().manual_seed(1)))
    fused = C.fused_cells(cell)
    new, err = F.bp_iteration(N, D, 8, 8, None)(fused, msgs)
    damped, err_d = F.bp_iteration(N, D, 8, 8, 0.3)(fused, msgs)
    assert abs(float(err) - float(err_d)) < 1e-14
    for s in range(6):
        mix = mpslib.add(mpslib.from_sites(new[s]), mpslib.from_sites(msgs[s]), 0.7, 0.3)
        want = mpslib.compress(mix, 8)
        assert float(mpslib.distance(mpslib.from_sites(damped[s]), want)) < 1e-10


# -------------------- edge RDMs against the dense oracle ------------------

BIG = 256      # machine-exact for N=2, D=2 (true cut ranks ≤ 128)
MSG_CHI = 1    # random rank-1 messages keep engine and oracle small


def _open_phys_fused(t):
    """T ⊗ T* with virtual ket-bra pairs fused, physical legs kept open:
    [d, D,D,D,D] → [D², D², D², D², d_ket, d_bra]."""
    d, Dv = t.shape[0], t.shape[1]
    tt = np.tensordot(t, np.conj(t), 0)
    tt = np.transpose(tt, (1, 6, 2, 7, 3, 8, 4, 9, 0, 5))
    return tt.reshape(Dv * Dv, Dv * Dv, Dv * Dv, Dv * Dv, d, d)


@pytest.fixture(scope="module")
def rdm_setup():
    data = numpy_cell(seed=0)
    cell = unit_cell_from_numpy(data)
    msgs = C.initial_messages(N, D, MSG_CHI, model="random",
                              generator=torch.Generator().manual_seed(5))
    return data, cell, msgs


def _oracle_rho(data, cell, msgs, edge):
    block = KagomeBlock.build(N)
    graph = C._graph_for(N, D, MSG_CHI, tuple(int(s) for s in BlockSide))
    n1, n2 = E.edge_pair(block, edge)
    fused = [t.numpy() for t in C.fused_cells(cell)]

    def fetch(source):
        if source[0] == "lat":
            v = source[1]
            if v in (n1, n2):
                return _open_phys_fused(data["ABC"[v % 3]])
            return fused[v % 3]
        _, side, k = source
        return msgs[BlockSide(side)].sites[k].numpy()

    env, open_legs = exact.contract_dense(graph, fetch, sweep_order(graph, BlockSide.U))
    want = [(n1, 4), (n1, 5), (n2, 4), (n2, 5)]
    assert sorted(open_legs) == sorted(want), open_legs
    rho = np.transpose(env, [open_legs.index(w) for w in want])
    return rho / np.trace(np.trace(rho, axis1=2, axis2=3))


@pytest.mark.parametrize("edge", UpdateEdge.all_options(), ids=str)
def test_edge_rdm_matches_oracle(rdm_setup, edge):
    data, cell, msgs = rdm_setup
    t1, t2, env, (p1, _) = E.edge_environment(cell, msgs, N, BIG, MSG_CHI, edge)
    rho = K.rho_ij(t1, t2, env).numpy()
    np.testing.assert_allclose(rho, _oracle_rho(data, cell, msgs, edge), atol=1e-10)
    # the canonical-ket permutation inverts back to the cell tensor
    inv = [p1.index(i) for i in range(4)]
    n1, _ = E.edge_pair(KagomeBlock.build(N), edge)
    np.testing.assert_array_equal(t1.permute((0,) + tuple(i + 1 for i in inv)).numpy(),
                                  data["ABC"[n1 % 3]])


def test_edge_measurement_matches_oracle_rdm(rdm_setup):
    """One edge's energy and per-site ⟨x/y/z⟩, as the measurement path gives
    them, against the oracle RDM and ``expectation_values_with_rdm``."""
    data, cell, msgs = rdm_setup
    edge = UpdateEdge.all_options()[0]
    h = hamiltonians.heisenberg_afm()
    fn = F.edge_measure(N, D, BIG, MSG_CHI, edge)
    energy, neg, exps = fn((cell.A, cell.B, cell.C), F._msgs_to_sites(msgs), torch.from_numpy(h))
    rho = _oracle_rho(data, cell, msgs, edge)
    np.testing.assert_allclose(complex(energy), np.einsum("iIjJ,iIjJ->", rho, h), atol=1e-10)
    assert float(neg) >= 0.0
    for name, (vi, vj) in expectation_values_with_rdm(rho).items():
        np.testing.assert_allclose([complex(exps[name][0]), complex(exps[name][1])], [vi, vj],
                                   atol=1e-10)
