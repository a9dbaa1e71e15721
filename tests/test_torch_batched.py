"""The port's batched BP sweep (``algo/batched``) and K2's vmap rule, on the
CPU in complex128, on inputs made with numpy from a seed:

* the batched sweep against the port's per-side sweep (default and gram
  linear algebra) and against the JAX package's ``bp_iteration_batched``;
* damping passed per call; a converged BP run in auto mode, which is the
  batched sweep in both packages, against the JAX package's;
* ``ops/kernels.chol_inv`` under ``torch.func.vmap``: equal to per-matrix
  calls and one call of its implementation for the whole batch.

Messages are compared by MPS distance, never element by element: batched
LAPACK calls may pick another gauge than the per-matrix ones (elements then
differ by O(1) while the states agree to round-off).
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kagomeperiodicbp_tpu.algo import batched as JB
from kagomeperiodicbp_tpu.algo import bp as JBP
from kagomeperiodicbp_tpu.algo import contraction as JC
from kagomeperiodicbp_tpu.algo import fused as JF
from kagomeperiodicbp_tpu.networks.unit_cell import UnitCell as JUnitCell
from kagomeperiodicbp_tpu_torch.algo import batched as B
from kagomeperiodicbp_tpu_torch.algo import bp as BP
from kagomeperiodicbp_tpu_torch.algo import contraction as C
from kagomeperiodicbp_tpu_torch.algo import fused as F
from kagomeperiodicbp_tpu_torch.convert import messages_from_numpy, unit_cell_from_numpy
from kagomeperiodicbp_tpu_torch.lattices import BlockSide
from kagomeperiodicbp_tpu_torch.ops import kernels as K
from kagomeperiodicbp_tpu_torch.ops import mps as mpslib

N = 2
BATCHED_TOL = 1e-12   # batched against per-side, the same arithmetic
JAX_TOL = 1e-10       # the North star's parity bar


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one torch thread runs them as fast and leaves the
    cores to XLA's compiler."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def numpy_cell(D, seed):
    rng = np.random.default_rng(seed)

    def one():
        t = rng.standard_normal((2,) + (D,) * 4) + 1j * rng.standard_normal((2,) + (D,) * 4)
        return t / np.linalg.norm(t)

    return {"A": one(), "B": one(), "C": one()}


def numpy_messages(D, chi, seed):
    """Random messages in the canonical padded profile, {side: [sites]}."""
    rng = np.random.default_rng(seed)
    msgs = C.initial_messages(N, D, chi)
    out = {}
    for s, m in msgs.items():
        out[int(s)] = [rng.standard_normal(x.shape) + 1j * rng.standard_normal(x.shape)
                       for x in m.sites]
    return out


def inputs(D, chi, seed=0):
    cell = unit_cell_from_numpy(numpy_cell(D, seed))
    sites = F._msgs_to_sites(messages_from_numpy(numpy_messages(D, chi, seed + 1)))
    return cell, C.fused_cells(cell), sites


def max_distance(a, b):
    return max(float(mpslib.distance(mpslib.from_sites(a[s]), mpslib.from_sites(b[s]))) for s in a)


@pytest.mark.parametrize("linalg", ["default", "gram"])
@pytest.mark.parametrize("D,chi", [(2, 8), (3, 18)])
def test_batched_sweep_matches_per_side(monkeypatch, D, chi, linalg):
    """One sweep from random messages: the batched messages and distances
    against the per-side sweep's."""
    if linalg == "gram":
        monkeypatch.setenv("KPBP_LINALG", "gram")
    else:
        monkeypatch.delenv("KPBP_LINALG", raising=False)
    _, fused, sites = inputs(D, chi)
    want, err_want = F.bp_iteration(N, D, chi, chi, None)(fused, sites)
    got, err_got = B.bp_iteration_batched(N, D, chi, chi, None)(fused, sites)
    assert sorted(got) == sorted(want)
    assert max_distance(got, want) < BATCHED_TOL
    assert abs(float(err_got) - float(err_want)) < 1e-10


def test_rotated_stacks_are_the_rotated_cells_fused_tensors():
    """Copy b of the stack is the fused cell of the state rotated b times
    clockwise (R⁻ᵇψ), made by permuting ψ's fused tensors."""
    cell, fused, _ = inputs(2, 8)
    stacks = B._rotated_fused_stacks(fused)
    rotated = [cell, cell.rotate_ccw().rotate_ccw(), cell.rotate_ccw()]
    for b, rc in enumerate(rotated):
        for i, f in enumerate(C.fused_cells(rc)):
            assert torch.equal(stacks[i][b], f)
    with pytest.raises(ValueError):
        B._rotated_fused_stacks(fused + fused)


def test_batched_sweep_matches_jax():
    """One batched sweep at N=2, D=2, χ=8 from the same random messages:
    the port's against the JAX package's bp_iteration_batched."""
    D, chi = 2, 8
    _, fused, sites = inputs(D, chi)
    cell_np, msgs_np = numpy_cell(D, 0), numpy_messages(D, chi, 1)
    jcell = JUnitCell(*(jnp.asarray(cell_np[f]) for f in "ABC"))
    jsites = {s: tuple(jnp.asarray(x) for x in ss) for s, ss in msgs_np.items()}
    jnew, jerr = JB.bp_iteration_batched(N, D, chi, chi, None)(JC.fused_cells(jcell), jsites)
    got, err = B.bp_iteration_batched(N, D, chi, chi, None)(fused, sites)
    want = F._msgs_to_sites(messages_from_numpy({s: [np.asarray(x) for x in ss]
                                                 for s, ss in jnew.items()}))
    assert max_distance(got, want) < JAX_TOL
    assert abs(float(err) - float(jerr)) < JAX_TOL


@pytest.fixture(scope="module")
def c64_case():
    """N=2, D=2, χ_msg=8, χ=12 in complex64 from uniform messages (χ above
    the rank of some swallow blobs): a numpy cell and the JAX package's
    per-side sweep of it."""
    D, chi_msg, chi = 2, 8, 12
    cell_np = numpy_cell(D, 0)
    jcell = JUnitCell(*(jnp.asarray(cell_np[f], jnp.complex64) for f in "ABC"))
    jmsgs = JF._msgs_to_sites(JC.initial_messages(N, D, chi_msg, dtype=jnp.complex64))
    jnew, jerr = JF.bp_iteration(N, D, chi, chi_msg, None)(JC.fused_cells(jcell), jmsgs)
    return cell_np, {s: [np.asarray(x) for x in ss] for s, ss in jnew.items()}, float(jerr)


@pytest.mark.parametrize("batched", [False, True], ids=["per_side", "batched"])
def test_complex64_sweep_on_rank_deficient_blobs_matches_jax(c64_case, batched):
    """torch's CPU complex64 QR gave non-finite factors for a finite
    rank-deficient blob of this sweep (16×12, rank 4); ``ops/linalg`` factors
    complex64 on the CPU in complex128. The port's messages are finite and
    within 2e-5 of the JAX package's by distance (the c64 bar)."""
    D, chi_msg, chi = 2, 8, 12
    cell_np, jnew, jerr = c64_case
    cell = unit_cell_from_numpy(cell_np, dtype=torch.complex64)
    msgs = F._msgs_to_sites(C.initial_messages(N, D, chi_msg, dtype=torch.complex64))
    run = (B.bp_iteration_batched if batched else F.bp_iteration)(N, D, chi, chi_msg, None)
    new, err = run(C.fused_cells(cell), msgs)
    assert all(bool(torch.isfinite(x).all()) for ss in new.values() for x in ss)
    got = {s: [x.to(torch.complex128) for x in ss] for s, ss in new.items()}
    want = F._msgs_to_sites(messages_from_numpy(jnew, dtype=torch.complex128))
    assert max_distance(got, want) < 2e-5
    assert abs(float(err) - jerr) < 2e-5


def test_damping_is_passed_per_call():
    """The batched sweep with damping: the value given per call is the one
    used, as in the per-side sweep built with that damping; a sweep built
    without damping ignores the per-call value, as the JAX package's does."""
    D, chi = 2, 8
    _, fused, sites = inputs(D, chi)
    run = B.bp_iteration_batched(N, D, chi, chi, 0.5)
    for value in (0.2, None):
        got, err = run(fused, sites, damping_value=value)
        want, err_want = F.bp_iteration(N, D, chi, chi, value or 0.5)(fused, sites)
        assert max_distance(got, want) < BATCHED_TOL
        assert abs(float(err) - float(err_want)) < 1e-10
    undamped = F.bp_iteration(N, D, chi, chi, None)(fused, sites)[0]
    got = B.bp_iteration_batched(N, D, chi, chi, None)(fused, sites, damping_value=0.3)[0]
    assert max_distance(got, undamped) < BATCHED_TOL


def test_auto_bp_run_matches_jax(monkeypatch):
    """BP to convergence in auto mode (the batched sweep in both packages)
    at N=2, D=2, χ_msg=8 from uniform messages: the same distances each
    iteration, the same count, the same hermitized messages."""
    monkeypatch.delenv("KPBP_BP_BATCHED", raising=False)
    monkeypatch.delenv("KPBP_SINGLE_LAYER", raising=False)
    D, chi = 2, 8
    cell_np = numpy_cell(D, 3)
    jcell = JUnitCell(*(jnp.asarray(cell_np[f]) for f in "ABC"))
    jmsgs, jst = JBP.belief_propagation(
        jcell, None, JBP.BPConfig(trunc_dim=chi, dtype=jnp.complex128, max_iterations=30), N)
    cfg = BP.BPConfig(trunc_dim=chi, dtype=torch.complex128, max_iterations=30)
    assert BP.bp_mode(cfg, D) == "batched"
    msgs, st = BP.belief_propagation(unit_cell_from_numpy(cell_np), None, cfg, N)
    assert st.mode == "batched"
    assert st.iterations == jst.iterations and st.success == jst.success
    np.testing.assert_allclose(st.error_history, jst.error_history, rtol=0, atol=JAX_TOL)
    want = messages_from_numpy({int(s): [np.asarray(x) for x in m.sites] for s, m in jmsgs.items()})
    for s in BlockSide:
        assert float(mpslib.distance(msgs[s], want[s])) < JAX_TOL


def test_gram_batched_sweep_hands_k2_a_third_of_the_calls(monkeypatch):
    """Under KPBP_LINALG=gram every gram of the batched sweep reaches K2's
    implementation as a batch of 3, in a third as many calls as the
    per-side sweep makes, size by size."""
    monkeypatch.setenv("KPBP_LINALG", "gram")
    D, chi = 2, 8
    _, fused, sites = inputs(D, chi)
    ref, calls = K.chol_inv_ref, []

    def recording(g):
        calls.append(tuple(g.shape))
        return ref(g)

    monkeypatch.setattr(K, "chol_inv_ref", recording)
    F.bp_iteration(N, D, chi, chi, None)(fused, sites)
    per_side, calls[:] = list(calls), []
    B.bp_iteration_batched(N, D, chi, chi, None)(fused, sites)
    assert per_side and all(len(s) == 2 for s in per_side)
    assert all(len(s) == 3 and s[0] == 3 for s in calls)
    by_k = lambda shapes: {k: sum(1 for s in shapes if s[-1] == k) for k in {s[-1] for s in shapes}}  # noqa: E731
    assert {k: 3 * n for k, n in by_k(calls).items()} == by_k(per_side)


@pytest.mark.parametrize("k", [1, 7, 30])
def test_chol_inv_under_vmap_is_one_call(monkeypatch, k):
    """kernels.chol_inv under torch.func.vmap over 3 grams (mapped on axis
    0 or 1): the per-matrix results, from one call of the implementation on
    the [3, k, k] stack; nested maps fold into one batch as well."""
    rng = np.random.default_rng(k)
    a = rng.standard_normal((3, k, k)) + 1j * rng.standard_normal((3, k, k))
    g = torch.from_numpy(a @ np.conj(np.swapaxes(a, 1, 2)) + k * np.eye(k))
    want = [K.chol_inv(g[b]) for b in range(3)]
    ref, calls = K.chol_inv_ref, []

    def recording(x):
        calls.append(tuple(x.shape))
        return ref(x)

    monkeypatch.setattr(K, "chol_inv_ref", recording)
    for stacked, in_dim in ((g, 0), (g.transpose(0, 1), 1)):
        calls.clear()
        l, w = torch.func.vmap(K.chol_inv, in_dims=in_dim)(stacked)
        assert calls == [(3, k, k)]
        for b in range(3):
            torch.testing.assert_close(l[b], want[b][0], rtol=0, atol=1e-12)
            torch.testing.assert_close(w[b], want[b][1], rtol=0, atol=1e-12)
    calls.clear()
    l, _ = torch.func.vmap(torch.func.vmap(K.chol_inv))(torch.stack([g, g]))
    assert calls == [(6, k, k)] and l.shape == (2, 3, k, k)
    torch.testing.assert_close(l[1, 2], want[2][0], rtol=0, atol=1e-12)
