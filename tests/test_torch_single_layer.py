"""The port's single-layer swallowing, two-tier lazy truncation and
iterative compression against the JAX package, on the CPU in complex128
(the cases of test_single_layer.py and test_compression.py), on inputs made
with numpy from a seed:

* the swallow pieces (``_fuse_ket``, ``_swallow_ket_blob``,
  ``_project_rows``) to 1e-12; the sketched swallow exact at full rank;
* single-layer messages, the edge environment and ``chi_lazy`` against
  the JAX functions they replace; the scalar plan and BP against the
  port's double-layer path, which other files hold to the JAX package;
* the BP mode choice against the JAX package's, for every D and every
  ``KPBP_SINGLE_LAYER`` and ``KPBP_BP_BATCHED`` value, without running a
  D=6 contraction.

jax.random streams cannot be drawn in torch: where the sketch is truncated,
the JAX package's factors, drawn by tools/make_sketch_case.py, are handed to
the port through ``ops.contract.sketch_factors``. The JAX side runs as jitted
programs (its eager form compiles every op apart); even so each JAX
contraction costs seconds, so where a port path is held to the JAX package
through another port path (single- against double-layer), the test says so.
"""
import dataclasses
import functools
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kagomeperiodicbp_tpu.algo import bp as JBP
from kagomeperiodicbp_tpu.algo import contraction as JC
from kagomeperiodicbp_tpu.algo import edge_env as JE
from kagomeperiodicbp_tpu.algo import fused as JF
from kagomeperiodicbp_tpu.enums import UpdateEdge as JUpdateEdge
from kagomeperiodicbp_tpu.lattices import BlockSide as JBlockSide
from kagomeperiodicbp_tpu.networks.unit_cell import UnitCell as JUnitCell
from kagomeperiodicbp_tpu.ops import contract as JK
from kagomeperiodicbp_tpu.ops import ite_kernels as JIK
from kagomeperiodicbp_tpu.ops import mps as jmps
from kagomeperiodicbp_tpu.ops.contract import execute_plan as jax_execute_plan
from kagomeperiodicbp_tpu_torch.algo import batched as B
from kagomeperiodicbp_tpu_torch.algo import bp as BP
from kagomeperiodicbp_tpu_torch.algo.arbitrary import ArbitraryKagomeTN
from kagomeperiodicbp_tpu_torch.algo import contraction as C
from kagomeperiodicbp_tpu_torch.algo import edge_env as E
from kagomeperiodicbp_tpu_torch.algo import fused as F
from kagomeperiodicbp_tpu_torch.convert import messages_from_numpy, unit_cell_from_numpy
from kagomeperiodicbp_tpu_torch.enums import UpdateEdge
from kagomeperiodicbp_tpu_torch.lattices import BlockSide
from kagomeperiodicbp_tpu_torch.lattices.kagome import num_message_sites
from kagomeperiodicbp_tpu_torch.networks.graph import message_bond_profile
from kagomeperiodicbp_tpu_torch.ops import contract as K
from kagomeperiodicbp_tpu_torch.ops import ite_kernels as IK
from kagomeperiodicbp_tpu_torch.ops import mps as mpslib
from kagomeperiodicbp_tpu_torch.ops.contract import execute_plan
from kagomeperiodicbp_tpu_torch.physics import hamiltonians

BIG = 10**6  # no truncation


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one torch thread runs them as fast and leaves the
    cores to XLA's compiler."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _c(rng, shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _t(a):
    return torch.from_numpy(np.array(a))  # a copy: arrays from JAX are read-only


def numpy_cell(D, seed):
    rng = np.random.default_rng(seed)

    def one():
        t = _c(rng, (2,) + (D,) * 4)
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
            v = _c(rng, D)
            v /= np.linalg.norm(v)
            sites.append(np.outer(v, v.conj()).reshape(1, D * D, 1))
        for k, target in enumerate(profile):
            pad = target - sites[k].shape[2]
            sites[k] = np.pad(sites[k], ((0, 0), (0, 0), (0, pad)))
            sites[k + 1] = np.pad(sites[k + 1], ((0, pad), (0, 0), (0, 0)))
        out[side] = sites
    return out


def both(cell_np, msgs_np):
    """The same cell and messages for the JAX package and the port."""
    jcell = JUnitCell(*(jnp.asarray(cell_np[f]) for f in "ABC"))
    jmsgs = {JBlockSide(s): jmps.from_sites([jnp.asarray(x) for x in ss])
             for s, ss in msgs_np.items()}
    return (jcell, jmsgs), (unit_cell_from_numpy(cell_np), messages_from_numpy(msgs_np))


def to_port(m):
    """A JAX MPS as the port's, logscale kept."""
    return mpslib.MPS(tuple(_t(s) for s in m.sites), torch.tensor(float(m.logscale)))


def _dense(sites, logscale):
    out = sites[0]
    for s in sites[1:]:
        out = np.tensordot(out, s, axes=([out.ndim - 1], [0]))
    return out * np.exp(logscale)


# ----------------------------- swallow pieces -----------------------------


@pytest.mark.parametrize("n_out", [2, 4])
def test_fuse_ket_matches_jax(n_out):
    tk = _c(np.random.default_rng(n_out), (3,) * n_out + (2,))
    want = np.asarray(JK._fuse_ket(jnp.asarray(tk), n_out))
    np.testing.assert_allclose(K._fuse_ket(_t(tk), n_out).numpy(), want, atol=1e-12)


@pytest.mark.parametrize("n_in,n_out", [(1, 1), (1, 2), (1, 3), (2, 2), (2, 0)])
def test_swallow_ket_blob_matches_jax(n_in, n_out):
    """The ket, then the bra, against the frontier's fused legs: the blob of
    the JAX package's order (its trace after the bra contraction; the port
    traces inside it)."""
    rng = np.random.default_rng(10 * n_in + n_out)
    D, d = 3, 2
    tk = _c(rng, (D,) * (n_in + n_out) + (d,))
    dims = [4, 5, 3]
    sites = [_c(rng, (dims[j], D * D, dims[j + 1])) for j in range(n_in)]
    want = np.asarray(JK._swallow_ket_blob(jnp.asarray(tk), [jnp.asarray(s) for s in sites],
                                           n_in, n_out, D))
    got = K._swallow_ket_blob(_t(tk), [_t(s) for s in sites], n_in, n_out, D).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("n_out", [2, 3])
def test_project_rows_matches_jax(n_out):
    rng = np.random.default_rng(n_out)
    D, a, b, k = 3, 4, 5, 7
    U = _c(rng, (a * D * D, k))
    S = _c(rng, (a, D, D, b))
    tkn = _c(rng, (D,) * (1 + n_out) + (2,))
    want = np.asarray(JK._project_rows(*(jnp.asarray(x) for x in (U, S, tkn)), n_out, a, D, b))
    got = K._project_rows(_t(U), _t(S), _t(tkn), n_out, a, D, b).numpy()
    np.testing.assert_allclose(got, want, atol=1e-12 * np.abs(want).max())


def _jax_gram_split(n_out, D, chi):
    """The JAX package's sketched swallow as one jitted program:
    (tk, site) → (sites, logscale)."""
    def run(tk, site):
        fr = JK.Frontier(chi=chi)
        fr._init_scale(tk.dtype)
        return tuple(JK._swallow_ket_gram_split(tk, [site], n_out, D, chi, fr)), fr.logscale

    return jax.jit(run)


@pytest.mark.parametrize("n_out,a,b,jax_too", [(2, 5, 4, False), (3, 4, 5, True)])
def test_gram_split_exact_at_full_rank(n_out, a, b, jax_too):
    """At a retained rank of all the rows the sketch spans the row space:
    the port's sketched swallow rebuilds its blob path's dense tensor, scale
    included, to 1e-10 of max, and at n_out=3 the JAX package's."""
    rng = np.random.default_rng(0)
    D = 3
    tk = _c(rng, (D,) * (1 + n_out) + (2,))
    site = _c(rng, (a, D * D, b))
    fr = K.Frontier(chi=BIG)
    fr._init_scale(_t(tk))
    got = _dense([x.numpy() for x in K._swallow_ket_gram_split(_t(tk), [_t(site)], n_out, D, BIG, fr)],
                 float(fr.logscale))
    frb = K.Frontier(chi=BIG)
    frb._init_scale(_t(tk))
    blob = frb._absorb_norm(K._swallow_ket_blob(_t(tk), [_t(site)], 1, n_out, D))
    wants = [_dense([x.numpy() for x in K._split_blob(blob, frb)], float(frb.logscale))]
    if jax_too:
        sj, lj = _jax_gram_split(n_out, D, BIG)(jnp.asarray(tk), jnp.asarray(site))
        wants.append(_dense([np.asarray(x) for x in sj], float(lj)))
    for want in wants:
        np.testing.assert_allclose(got, want, atol=1e-10 * np.abs(want).max())


def test_sketch_factors_repeat_and_follow_the_rank(monkeypatch):
    """The default factors come from a CPU generator seeded 0 (the same in
    every sweep and on every device); KPBP_SKETCH_RANK sets s, 0 means
    2χ+32, never above the rows."""
    a1, a2 = K.sketch_factors(3, 3, 5, 7, torch.complex128), K.sketch_factors(3, 3, 5, 7, torch.complex128)
    for x, y in zip(a1[0] + a1[1] + [a1[2]], a2[0] + a2[1] + [a2[2]]):
        assert torch.equal(x, y) and x.shape[1] == 7 and x.dtype == torch.complex128
    assert [x.shape[0] for x in a1[0] + a1[1]] == [3] * 4 and a1[2].shape == (5, 7)
    assert K._sketch_rank(1000, 12) == 56 and K._sketch_rank(40, 12) == 40
    monkeypatch.setenv("KPBP_SKETCH_RANK", "20")
    assert K._sketch_rank(1000, 12) == 20
    monkeypatch.setenv("KPBP_BLOB_LIMIT", "5e2")
    assert K._blob_elem_limit() == 500


# --------------------------- messages and plans ----------------------------


def jax_message_single(jcell, jmsgs, N, D, chi, chi_msg, toward):
    """The JAX package's ``outgoing_message_single``, as one jitted
    program (its eager form compiles every op apart)."""
    plan = JC.single_layer_plan(JC.to_message_plan(N, D, chi, chi_msg, int(toward)))
    sites = {int(s): tuple(m.sites) for s, m in jmsgs.items() if int(s) != int(toward)}

    def run(kets, ms):
        raw = jax_execute_plan(plan, JC._make_fetch(None, ms, kets=kets))
        return JC.message_postprocess(raw, plan, N, D, chi_msg)

    return to_port(jax.jit(run)((jcell.A, jcell.B, jcell.C), sites))


def jax_scalar(plan, jcell, jmsgs):
    """The value of a full contraction plan in the JAX package, one jitted
    program, message logscales added."""
    sites = {int(s): tuple(m.sites) for s, m in jmsgs.items()}

    def run(kets, ms):
        return jax_execute_plan(plan, JC._make_fetch(JC.fused_cells(JUnitCell(*kets)), ms,
                                                     kets=kets))

    m, log = jax.jit(run)((jcell.A, jcell.B, jcell.C), sites)
    return complex(m) * math.exp(float(log) + sum(float(x.logscale) for x in jmsgs.values()))


def port_scalar(plan, cell, msgs):
    m, log = execute_plan(plan, C._make_fetch(C.fused_cells(cell), F._msgs_to_sites(msgs),
                                              kets=(cell.A, cell.B, cell.C)))
    return complex(m) * math.exp(float(log) + sum(float(x.logscale) for x in msgs.values()))


def test_single_layer_message_exact_no_truncation():
    """test_single_layer_message_exact_no_truncation at D=2 toward U: the
    single-layer message is the double-layer one (which
    test_torch_contraction.py holds to the dense oracle with no
    truncation)."""
    N, D = 2, 2
    cell, msgs = unit_cell_from_numpy(numpy_cell(D, 0)), messages_from_numpy(numpy_messages(N, D, 4, seed=7))
    got = C.outgoing_message_single(cell, msgs, N, D, BIG, BIG, BlockSide.U)
    assert float(mpslib.distance(got, C.outgoing_message(cell, msgs, N, D, BIG, BIG, BlockSide.U))) < 1e-10


@pytest.mark.parametrize("toward", [BlockSide.U, BlockSide.DR])
def test_single_layer_message_matches_jax_under_truncation(toward):
    """D=3, χ=12 (truncating), test_single_layer_identical_under_truncation's
    shape: identical plans and truncation points, so the double-layer
    message; the per-side sweep's unit; and toward U the JAX package's
    single-layer message (one JAX contraction costs seconds; DR is held to
    it through the double-layer path)."""
    N, D, chi = 2, 3, 12
    (jcell, jmsgs), (cell, msgs) = both(numpy_cell(D, 1), numpy_messages(N, D, chi, seed=3))
    got = C.outgoing_message_single(cell, msgs, N, D, chi, chi, toward)
    assert float(mpslib.distance(got, C.outgoing_message(cell, msgs, N, D, chi, chi, toward))) < 1e-9
    same = F._one_outgoing((cell.A, cell.B, cell.C), F._msgs_to_sites(msgs), N, D, chi, chi,
                           int(toward), single=True)
    assert float(mpslib.distance(got, same)) < 1e-12
    if toward == BlockSide.U:
        want = jax_message_single(jcell, jmsgs, N, D, chi, chi, toward)
        assert float(mpslib.distance(got, want)) < 1e-9


def test_single_layer_scalar_plan(monkeypatch):
    """test_single_layer_scalar_plan: the value of the full contraction
    (message logscales added) single-layer as double-layer (which
    test_torch_contraction.py holds to the dense oracle), at χ=32, direct
    and with every eligible swallow sketched at full rank (exact), where the
    sketch's scale bookkeeping (‖tk‖ enters twice) shows."""
    N, D, chi = 2, 2, 32
    cell, msgs = unit_cell_from_numpy(numpy_cell(D, 2)), messages_from_numpy(numpy_messages(N, D, 4, seed=5))
    plan = C.full_scalar_plan(N, D, chi=chi, chi_msg=BIG)
    want = port_scalar(plan, cell, msgs)
    K.reset_swallow_counts()
    direct = port_scalar(C.single_layer_plan(plan), cell, msgs)
    assert K.swallow_counts()["sketched"] == 0 < K.swallow_counts()["direct"]
    monkeypatch.setenv("KPBP_BLOB_LIMIT", "1")
    monkeypatch.setenv("KPBP_SKETCH_RANK", str(BIG))
    sketched = port_scalar(C.single_layer_plan(plan), cell, msgs)
    assert K.swallow_counts()["sketched"] > 0
    for got in (direct, sketched):
        np.testing.assert_allclose(got, want, rtol=1e-10)


def test_sketched_message_quality_as_the_jax_package_holds_it(monkeypatch):
    """test_gram_split_message_quality_under_truncation on its own case and
    with its sketch factors (tests/assets/sketch_case_D3.npz, written by
    tools/make_sketch_case.py from the JAX package's jax.random draws): with
    every eligible swallow sketched (KPBP_BLOB_LIMIT=1) the message stays
    within 1.4× of the direct path's distance to a χ=100 double-layer
    oracle. The factors decide the ratio: the JAX package's own draw gives
    1.06–2.23 on four numpy inputs at this shape
    (tools/torch_cpu_checks.py), so the bar is held with its draw."""
    N, D, chi = 2, 3, 12
    case = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets",
                                "sketch_case_D3.npz"))
    cell = unit_cell_from_numpy({f: case[f] for f in "ABC"})
    msgs = messages_from_numpy({s: [case[f"msg_{s}_{k}"] for k in range(num_message_sites(N))]
                                for s in range(6)})

    def jax_draw(n_out, D_, b, s_dim, dtype, device=None):
        f = [_t(case[f"factor_{n_out}_{D_}_{b}_{s_dim}_{j}"]) for j in range(2 * n_out - 1)]
        return f[:n_out - 1], f[n_out - 1:-1], f[-1]

    monkeypatch.setattr(K, "sketch_factors", jax_draw)
    monkeypatch.setenv("KPBP_BLOB_LIMIT", "1")
    K.reset_swallow_counts()
    m_sketch = C.outgoing_message_single(cell, msgs, N, D, chi, chi, BlockSide.U)
    assert K.swallow_counts()["sketched"] > 0
    monkeypatch.delenv("KPBP_BLOB_LIMIT")
    m_direct = C.outgoing_message_single(cell, msgs, N, D, chi, chi, BlockSide.U)
    # the χ=100 oracle is one large contraction and no XLA compile runs
    # beside it: it takes a few threads
    torch.set_num_threads(8)
    try:
        oracle = C.outgoing_message(cell, msgs, N, D, 100, chi, BlockSide.U)
    finally:
        torch.set_num_threads(1)
    d_sketch = float(mpslib.distance(m_sketch, oracle))
    d_direct = float(mpslib.distance(m_direct, oracle))
    assert d_sketch < max(1.4 * d_direct, d_direct + 1e-9)


def test_chi_lazy_matches_jax():
    """Two-tier lazy truncation (test_compression.py's case: Plan.chi_lazy=16
    over χ=8): the JAX package's value of the full contraction,
    double-layer, and the port's single-layer value equal to it; truncating
    later than the eager plan, it gives another value."""
    N, D = 2, 2
    (jcell, jmsgs), (cell, msgs) = both(numpy_cell(D, 5), numpy_messages(N, D, 4, seed=11))
    lazy = dataclasses.replace(C.full_scalar_plan(N, D, chi=8, chi_msg=BIG), chi_lazy=16)
    want = jax_scalar(dataclasses.replace(JC.full_scalar_plan(N, D, chi=8, chi_msg=BIG), chi_lazy=16),
                      jcell, jmsgs)
    np.testing.assert_allclose(port_scalar(lazy, cell, msgs), want, rtol=1e-10)
    np.testing.assert_allclose(port_scalar(C.single_layer_plan(lazy), cell, msgs), want, rtol=1e-10)
    eager = port_scalar(C.full_scalar_plan(N, D, chi=8, chi_msg=BIG), cell, msgs)
    assert abs(eager - want) > 1e-6 * abs(want)


def test_bp_fixed_point_single_layer():
    """test_bp_fixed_point_single_layer: BP with single_layer=True reaches
    the double-layer fixed point, which test_torch_bp_measure.py holds to
    the JAX package's."""
    N, D, chi = 2, 2, 8
    cell = unit_cell_from_numpy(numpy_cell(D, 4))
    cfg = BP.BPConfig(trunc_dim=chi, max_iterations=40)
    msgs, st = BP.belief_propagation(cell, None, dataclasses.replace(cfg, single_layer=True), N)
    msgs_d, st_d = BP.belief_propagation(cell, None, dataclasses.replace(cfg, single_layer=False), N)
    assert st.success and st_d.success
    for side in BlockSide:
        assert float(mpslib.distance(msgs[side], msgs_d[side])) < 1e-7


@functools.lru_cache(maxsize=None)
def _jax_single_layer_rhos():
    """The JAX package's single-layer pair RDMs of the six edges (N=2, D=2,
    χ=8), in one jitted program."""
    N, D, chi = 2, 2, 8
    cell_np, msgs_np = numpy_cell(D, 6), numpy_messages(N, D, chi, seed=9)

    def jax_rhos(cells, sites):
        out = []
        for edge in JUpdateEdge.all_options():
            t1, t2, env, _ = JE.edge_environment_sites(cells, sites, N, chi, chi, edge,
                                                       single_layer=True)
            out.append(JIK.rho_ij(t1, t2, env))
        return out

    rhos = jax.jit(jax_rhos)(tuple(jnp.asarray(cell_np[f]) for f in "ABC"),
                             {s: tuple(map(jnp.asarray, ss)) for s, ss in msgs_np.items()})
    return [np.asarray(r) for r in rhos]


@pytest.mark.parametrize("i", range(6), ids=[str(e) for e in UpdateEdge.all_options()])
def test_edge_environment_single_layer_matches_jax(i):
    """edge_environment_sites(single_layer=True) on each edge (N=2, D=2,
    χ=8: the messages' bonds are 4, so the boundary plans truncate): the
    pair's RDM and its energy as the JAX package's, and as the port's
    double-layer ones."""
    N, D, chi = 2, 2, 8
    cell_np = numpy_cell(D, 6)
    msgs_np = numpy_messages(N, D, chi, seed=9)
    h = hamiltonians.heisenberg_afm()
    edge = UpdateEdge.all_options()[i]
    assert str(JUpdateEdge.all_options()[i]) == str(edge)
    rho_j = _jax_single_layer_rhos()[i]
    cells = tuple(_t(cell_np[f]) for f in "ABC")
    sites = {s: tuple(_t(x) for x in ss) for s, ss in msgs_np.items()}
    e_j = complex(np.einsum("iIjJ,iIjJ->", rho_j, h))
    for single in (True, False):
        t1, t2, env, _ = E.edge_environment_sites(cells, sites, N, chi, chi, edge, single_layer=single)
        rho = IK.rho_ij(t1, t2, env)
        np.testing.assert_allclose(rho.numpy(), rho_j, atol=1e-10)
        assert abs(complex(IK.expectation(rho, torch.from_numpy(h).to(rho.dtype))) - e_j) < 1e-10


# ------------------------------ compression -------------------------------


def _random_mps(seed, n, p, chi):
    rng = np.random.default_rng(seed)
    dims = [1] + [chi] * (n - 1) + [1]
    return [_c(rng, (dims[i], p, dims[i + 1])) for i in range(n)]


def test_compress_iter_no_truncation_is_exact():
    sites = _random_mps(2, 5, 3, 6)
    m = mpslib.from_sites([_t(s) for s in sites])
    out = mpslib.compress_iter(m, chi=100)
    np.testing.assert_allclose(mpslib.dense(out).numpy(), mpslib.dense(m).numpy(), atol=1e-10)
    want = jax.jit(lambda x: jmps.compress_iter(x, chi=100))(jmps.from_sites([jnp.asarray(s) for s in sites]))
    np.testing.assert_allclose(mpslib.dense(out).numpy(), np.asarray(jmps.dense(want)), atol=1e-10)


@pytest.mark.parametrize("chi,sweeps", [(8, 2), (5, 1)])
def test_compress_iter_matches_jax_under_truncation(chi, sweeps):
    """The truncated state: the JAX package's (same guess, same sweeps), at
    the same distance from the original, within 1.5× of the SVD path's, and
    every bond ≤ χ."""
    sites = _random_mps(3, 6, 4, 16)
    m = mpslib.from_sites([_t(s) for s in sites])
    jm = jmps.from_sites([jnp.asarray(s) for s in sites])
    out = mpslib.compress_iter(m, chi, sweeps=sweeps)
    want = jax.jit(lambda x: jmps.compress_iter(x, chi, sweeps=sweeps))(jm)
    assert max(s.shape[2] for s in out.sites[:-1]) <= chi
    assert float(mpslib.distance(out, to_port(want))) < 1e-10
    d_port, d_jax = float(mpslib.distance(m, out)), float(mpslib.distance(m, to_port(want)))
    assert abs(d_port - d_jax) < 1e-10
    assert d_port <= 1.5 * float(mpslib.distance(m, mpslib.compress(m, chi))) + 1e-12


def test_compress_iter_helpers_match_jax():
    """right_canon, upd_left, upd_right: the pieces of the sweeps."""
    rng = np.random.default_rng(4)
    site, b = _c(rng, (3, 4, 5)), _c(rng, (6, 4, 7))
    q, rt = mpslib.right_canon(_t(site))
    np.testing.assert_allclose((rt @ q.reshape(q.shape[0], -1)).numpy().reshape(site.shape), site,
                               atol=1e-12)
    np.testing.assert_allclose((q.reshape(q.shape[0], -1) @ q.reshape(q.shape[0], -1).mH).numpy(),
                               np.eye(q.shape[0]), atol=1e-12)
    cl, qq = _c(rng, (6, 3)), _c(rng, (3, 4, 2))
    cr, qr = _c(rng, (7, 2)), _c(rng, (3, 4, 2))
    l_want = np.einsum("ag,apb,gph->bh", cl, b, qq.conj())
    r_want = np.einsum("apb,bh,gph->ag", b, cr, qr.conj())
    np.testing.assert_allclose(mpslib.upd_left(_t(cl), _t(b), _t(qq)).numpy(), l_want, atol=1e-12)
    np.testing.assert_allclose(mpslib.upd_right(_t(cr), _t(b), _t(qr)).numpy(), r_want, atol=1e-12)


# ------------------------------ mode choice --------------------------------


class _Chose(Exception):
    pass


def _jax_choice(monkeypatch, D, cfg):
    """The sweep the JAX package's belief_propagation builds for a cell of
    bond dimension D, caught before it runs: 'single', 'double' or
    'batched'."""
    jcell = JUnitCell(*(jnp.zeros((2,) + (D,) * 4, jnp.complex128) for _ in range(3)))

    def per_side(*args, single=False, **kw):
        raise _Chose("single" if single else "double")

    def batched(*args, **kw):
        raise _Chose("batched")

    monkeypatch.setattr(JF, "bp_iteration", per_side)
    monkeypatch.setattr("kagomeperiodicbp_tpu.algo.batched.bp_iteration_batched", batched)
    monkeypatch.setattr(JC, "fused_cells", lambda cell: None)
    monkeypatch.setattr(JC, "initial_messages", lambda *a, **k: {})
    with pytest.raises(_Chose) as got:
        JBP.belief_propagation(jcell, None, cfg, 2)
    return str(got.value)


@pytest.mark.parametrize("env", [None, "0", "1", "yes"])
@pytest.mark.parametrize("single_layer", [None, True, False])
@pytest.mark.parametrize("batched", [None, False, True])
def test_mode_choice_matches_jax(monkeypatch, env, single_layer, batched):
    """For D = 2…8, the port picks the sweep the JAX package picks:
    single-layer (on by itself from D=6; KPBP_SINGLE_LAYER=0/1 steering only
    single_layer=None), the batched sweep (auto wherever the sweep is not
    single-layer), or the per-side double-layer sweep."""
    monkeypatch.delenv("KPBP_BP_BATCHED", raising=False)
    if env is None:
        monkeypatch.delenv("KPBP_SINGLE_LAYER", raising=False)
    else:
        monkeypatch.setenv("KPBP_SINGLE_LAYER", env)
    for D in range(2, 9):
        want = _jax_choice(monkeypatch, D, JBP.BPConfig(single_layer=single_layer, batched=batched))
        cfg = BP.BPConfig(single_layer=single_layer, batched=batched)
        assert BP.bp_mode(cfg, D) == want, (D, want)


@pytest.mark.parametrize("env_single", [None, "0", "1"])
@pytest.mark.parametrize("env_batched", ["0", "1", "yes"])
def test_batched_env_steers_auto_as_jax(monkeypatch, env_single, env_batched):
    """KPBP_BP_BATCHED=0/1 steers only batched=None, and single-layer wins
    over it, in the port as in the JAX package (D = 3 and 6)."""
    monkeypatch.setenv("KPBP_BP_BATCHED", env_batched)
    if env_single is None:
        monkeypatch.delenv("KPBP_SINGLE_LAYER", raising=False)
    else:
        monkeypatch.setenv("KPBP_SINGLE_LAYER", env_single)
    for D in (3, 6):
        for batched in (None, False, True):
            want = _jax_choice(monkeypatch, D, JBP.BPConfig(batched=batched))
            assert BP.bp_mode(BP.BPConfig(batched=batched), D) == want, (D, batched, want)


def test_bp_runs_the_sweep_the_mode_choice_picks(monkeypatch):
    """belief_propagation hands the sweep the raw kets with single=True at
    D ≥ 6 and the fused tensors below, to the batched sweep by default and
    with batched=True, to the per-side one with batched=False; a per-site
    view (no rotation symmetry) goes per side, and batched=True on one
    raises. No contraction runs."""
    seen = []

    def fake(N, D, chi, chi_msg, damping, single=False):
        def run(tensors, msg_sites):
            seen.append((D, "single" if single else "double", tensors))
            raise _Chose()
        return run

    def fake_batched(N, D, chi, chi_msg, damping):
        def run(tensors, msg_sites):
            seen.append((D, "batched", tensors))
            raise _Chose()
        return run

    monkeypatch.setattr(F, "bp_iteration", fake)
    monkeypatch.setattr(B, "bp_iteration_batched", fake_batched)
    monkeypatch.setattr(C, "fused_cells", lambda cell: "fused")
    monkeypatch.setattr(C, "initial_messages", lambda *a, **k: {})
    monkeypatch.delenv("KPBP_SINGLE_LAYER", raising=False)
    monkeypatch.delenv("KPBP_BP_BATCHED", raising=False)
    for D in (5, 6):
        cell = unit_cell_from_numpy(numpy_cell(D, 0))
        with pytest.raises(_Chose):
            BP.belief_propagation(cell, None, BP.BPConfig(), 2)
    for batched in (True, False):
        with pytest.raises(_Chose):
            BP.belief_propagation(cell, None, BP.BPConfig(batched=batched, single_layer=False), 2)
    view = ArbitraryKagomeTN.from_unit_cell(unit_cell_from_numpy(numpy_cell(2, 0)), 2).as_cell_view()
    with pytest.raises(_Chose):
        BP.belief_propagation(view, None, BP.BPConfig(), 2)
    with pytest.raises(ValueError):
        BP.belief_propagation(view, None, BP.BPConfig(batched=True), 2)
    (d5, m5, t5), (d6, m6, t6), (_, m_true, _), (_, m_false, _), (_, m_view, _) = seen
    assert (d5, m5, t5) == (5, "batched", "fused")
    assert d6 == 6 and m6 == "single" and isinstance(t6, tuple) and len(t6) == 3
    assert (m_true, m_false, m_view) == ("batched", "double", "double")
