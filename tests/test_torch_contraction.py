"""The port's plan executor: exact against the dense oracle (ops/exact) at
N=2, D=2 with no truncation (ported from test_contraction_engine.py), and
against the JAX executor at D=3, χ=12 — real truncation — in both
KPBP_LINALG modes, through gauge-invariant overlaps."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kagomeperiodicbp_tpu.algo import contraction as JC
from kagomeperiodicbp_tpu.networks.unit_cell import UnitCell as JUnitCell
from kagomeperiodicbp_tpu.ops.contract import execute_plan as jax_execute_plan
from kagomeperiodicbp_tpu_torch.algo import contraction as C
from kagomeperiodicbp_tpu_torch.algo import fused as F
from kagomeperiodicbp_tpu_torch.convert import messages_from_numpy, unit_cell_from_numpy
from kagomeperiodicbp_tpu_torch.lattices import BlockSide
from kagomeperiodicbp_tpu_torch.lattices.kagome import num_message_sites
from kagomeperiodicbp_tpu_torch.networks.graph import message_bond_profile
from kagomeperiodicbp_tpu_torch.ops import exact, mps as mpslib
from kagomeperiodicbp_tpu_torch.ops.contract import execute_plan
from kagomeperiodicbp_tpu_torch.planner.compiler import sweep_order

BIG = 10**6  # no truncation
# message χ of the oracle tests: zero-padded bonds, small enough that the
# dense oracle and the untruncated frontier stay cheap
MSG_CHI = 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's tensors here are small: one torch thread runs them as fast
    and leaves the cores to XLA's compiler, which idle torch worker threads
    measurably slow down."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)



def numpy_cell(D, seed):
    rng = np.random.default_rng(seed)

    def one():
        t = rng.standard_normal((2,) + (D,) * 4) + 1j * rng.standard_normal((2,) + (D,) * 4)
        return t / np.linalg.norm(t)

    return {"A": one(), "B": one(), "C": one(), "rotated": 0}


def numpy_messages(N, D, chi, seed):
    """Random product messages |v⟩⟨v| per site, zero-padded to the canonical
    bond profile: {side_int: [site arrays]}."""
    rng = np.random.default_rng(seed)
    profile = message_bond_profile(N, D, chi)
    out = {}
    for side in range(6):
        sites = []
        for _ in range(num_message_sites(N)):
            v = rng.standard_normal(D) + 1j * rng.standard_normal(D)
            v /= np.linalg.norm(v)
            sites.append(np.outer(v, v.conj()).reshape(1, D * D, 1))
        for k, target in enumerate(profile):
            pad = target - sites[k].shape[2]
            sites[k] = np.pad(sites[k], ((0, 0), (0, 0), (0, pad)))
            sites[k + 1] = np.pad(sites[k + 1], ((0, pad), (0, 0), (0, 0)))
        out[side] = sites
    return out


def _oracle(graph, fused, msgs, toward):
    def fetch(source):
        if source[0] == "lat":
            return fused[source[1] % 3]
        _, side, k = source
        return msgs[side][k]

    return exact.contract_dense(graph, fetch, sweep_order(graph, toward))


@pytest.fixture(scope="module")
def small():
    N, D = 2, 2
    cell = unit_cell_from_numpy(numpy_cell(D, 0))
    msgs_np = numpy_messages(N, D, MSG_CHI, seed=7)
    fused_np = [t.numpy() for t in C.fused_cells(cell)]
    return N, D, cell, msgs_np, fused_np


@pytest.mark.parametrize("toward", list(BlockSide))
def test_outgoing_message_matches_oracle(small, toward):
    N, D, cell, msgs_np, fused_np = small
    plan = C.to_message_plan(N, D, BIG, MSG_CHI, int(toward))
    raw = C.run_plan(plan, cell, messages_from_numpy(msgs_np))
    dense_engine = mpslib.dense(raw).numpy()

    sides = tuple(int(s) for s in BlockSide if int(s) != int(toward))
    env, open_legs = _oracle(C._graph_for(N, D, MSG_CHI, sides), fused_np, msgs_np, toward)
    env = np.transpose(env, [open_legs.index(site) for site in plan.final_sites])
    assert env.shape == dense_engine.shape
    scale = np.max(np.abs(env))
    assert scale > 0
    np.testing.assert_allclose(dense_engine / scale, env / scale, atol=1e-10)


def test_outgoing_message_is_canonical(small):
    """``outgoing_message`` gives the message of the BP sweep's per-side unit,
    in the canonical padded bond profile and with unit norm."""
    N, D, cell, msgs_np, _ = small
    msgs = messages_from_numpy(msgs_np)
    sites = {int(s): tuple(m.sites) for s, m in msgs.items()}
    fused = C.fused_cells(cell)
    profile = message_bond_profile(N, D, MSG_CHI)
    for toward in BlockSide:
        m = C.outgoing_message(cell, msgs, N, D, BIG, MSG_CHI, toward)
        assert [s.shape[2] for s in m.sites[:-1]] == list(profile)
        mantissa, log = mpslib.inner(m, m)
        assert abs(complex(mantissa) * math.exp(float(log)) - 1.0) < 1e-12
        same = F._one_outgoing(fused, sites, N, D, BIG, MSG_CHI, int(toward))
        assert float(mpslib.distance(m, same)) < 1e-12


def test_full_scalar_matches_oracle(small):
    N, D, cell, msgs_np, fused_np = small
    plan = C.full_scalar_plan(N, D, BIG, MSG_CHI)
    mantissa, log = C.run_plan(plan, cell, messages_from_numpy(msgs_np))
    value = complex(mantissa) * math.exp(float(log))
    env, open_legs = _oracle(C._graph_for(N, D, MSG_CHI, tuple(range(6))), fused_np, msgs_np,
                             BlockSide.U)
    assert not open_legs
    np.testing.assert_allclose(value, complex(env), rtol=1e-9)


def test_mps_compress_and_distance():
    """compress preserves the state without truncation; distance sees a
    truncated one; the sum of a state with itself is collinear with it."""
    rng = np.random.default_rng(3)
    dims = [1, 3, 5, 4, 1]
    m = mpslib.from_sites([torch.from_numpy(rng.standard_normal((dims[i], 4, dims[i + 1]))
                                            + 1j * rng.standard_normal((dims[i], 4, dims[i + 1])))
                           for i in range(4)])
    m2 = mpslib.compress(m, 100)
    np.testing.assert_allclose(mpslib.dense(m).numpy(), mpslib.dense(m2).numpy(), atol=1e-10)
    assert float(mpslib.distance(m, m2)) < 1e-12
    assert float(mpslib.distance(m, mpslib.compress(m, 2))) > 1e-8
    assert float(mpslib.distance(m, mpslib.add(m, m, 1.0, 1.0))) < 1e-10


# ----------------------- against the JAX executor -------------------------


@pytest.mark.parametrize("mode", ["householder", "gram"])
def test_message_plan_matches_jax_executor(monkeypatch, mode):
    N, D, CHI = 2, 3, 12  # CHI below 2D² forces real truncation work
    cell_np = numpy_cell(D, 5)
    msgs_np = numpy_messages(N, D, CHI, seed=11)
    if mode == "gram":
        monkeypatch.setenv("KPBP_LINALG", "gram")
    else:
        monkeypatch.delenv("KPBP_LINALG", raising=False)

    plan_j = JC.to_message_plan(N, D, CHI, CHI, 0)
    jcell = JUnitCell(*(jnp.asarray(cell_np[f]) for f in "ABC"))
    msgs_j = {s: tuple(map(jnp.asarray, ss)) for s, ss in msgs_np.items()}
    a = jax.jit(lambda fu, ms: jax_execute_plan(plan_j, JC._make_fetch(fu, ms)))(
        JC.fused_cells(jcell), msgs_j)

    plan_t = C.to_message_plan(N, D, CHI, CHI, 0)
    fused_t = C.fused_cells(unit_cell_from_numpy(cell_np))
    sites_t = {int(s): tuple(m.sites) for s, m in messages_from_numpy(msgs_np).items()}
    b = execute_plan(plan_t, C._make_fetch(fused_t, sites_t))

    a_t = messages_from_numpy({0: [np.asarray(s) for s in a.sites]})[BlockSide(0)]
    a_t = mpslib.MPS(a_t.sites, torch.tensor(float(a.logscale), dtype=torch.float64))
    assert float(mpslib.distance(a_t, b)) < 1e-9
    assert abs(float(a.logscale) - float(b.logscale)) < 1e-9
