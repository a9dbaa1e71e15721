"""The port's measurement-side modules of the warm-start slice against the JAX
package, on the CPU in complex128 (1e-10 unless stated):

* ``physics/operators`` (exact), the classical message models, K1's operator
  form (``fused_tensor_with_operator``), the full-sandwich expectations
  (``sandwich_expectation``, ``measure_xyz_sandwich``) on messages drawn by
  the JAX package and converted;
* ``ops/pmps``: root, multi-in swallow, ``ptrim`` at full rank and the
  truncated swallow, compared by ``pmps_inner``;
* ``algo/arbitrary``: the shift permutations, and the measurement (BP
  included) of a tiled cell and of a per-site set of 3·n_triangles tensors
  at N=2, D=2.

The sandwich values and the arbitrary blocks' measurements of the JAX
package, with the random-classic messages it draws, are read from
``tests/assets/warm_start_D2.npz``, which ``tools/make_warm_start_cases.py``
computes with the JAX package from this file's numpy cases (compiling those
JAX programs here would take about 40 s); the tests check that the asset's
inputs are these cases.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kagomeperiodicbp_tpu.algo import arbitrary as JA
from kagomeperiodicbp_tpu.algo import contraction as JC
from kagomeperiodicbp_tpu.networks.unit_cell import fused_tensor_with_operator as jax_fused_op
from kagomeperiodicbp_tpu.ops import pmps as JP
from kagomeperiodicbp_tpu.physics import operators as JO
from kagomeperiodicbp_tpu_torch.algo import arbitrary as TA
from kagomeperiodicbp_tpu_torch.algo import contraction as TC
from kagomeperiodicbp_tpu_torch.algo.bp import BPConfig
from kagomeperiodicbp_tpu_torch.algo.measurements import measure_xyz_sandwich, sandwich_expectation
from kagomeperiodicbp_tpu_torch.convert import arbitrary_tn_from_numpy, messages_from_numpy, to_numpy, unit_cell_from_numpy
from kagomeperiodicbp_tpu_torch.lattices import LatticeDir
from kagomeperiodicbp_tpu_torch.networks.unit_cell import UnitCell, fused_tensor_with_operator
from kagomeperiodicbp_tpu_torch.ops import kernels as K
from kagomeperiodicbp_tpu_torch.ops import mps as TM
from kagomeperiodicbp_tpu_torch.ops import pmps as TP
from kagomeperiodicbp_tpu_torch.physics import hamiltonians, operators, pauli

N, D = 2, 2
CHI, CHI_MSG = 16, 8   # the frontier's matrices stay below the randomized SVD's size
TOL = 1e-10
# the arbitrary blocks' BP and measurement
ARB_BP = dict(trunc_dim=8, max_iterations=30, msg_diff_terminate=1e-11)
ARB_CHI = 18
ASSET = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets", "warm_start_D2.npz")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _rand(rng, shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def numpy_cell(seed):
    rng = np.random.default_rng(seed)
    return {f: (lambda t: t / np.linalg.norm(t))(_rand(rng, (2,) + (D,) * 4)) for f in "ABC"}


@pytest.fixture(scope="module")
def asset():
    with np.load(ASSET) as z:
        return dict(z)


# ------------------------------ operators ---------------------------------


@pytest.mark.parametrize("n", [1, 2])
def test_operators_match_jax_exactly(n):
    rng = np.random.default_rng(n)
    op = _rand(rng, (2,) * (2 * n))
    np.testing.assert_array_equal(operators.op_to_mat(op), JO.op_to_mat(op))
    np.testing.assert_array_equal(operators.mat_to_op(JO.op_to_mat(op), (2,) * n),
                                  JO.mat_to_op(JO.op_to_mat(op), (2,) * n))
    np.testing.assert_array_equal(operators.op_dagger(op), JO.op_dagger(op))
    assert operators.op_norm(op) == JO.op_norm(op)
    assert operators.op_trace(op) == JO.op_trace(op)


# --------------------------- classical messages ---------------------------


@pytest.mark.parametrize("model", ["uniform-classic", "random-classic"])
def test_classical_message_sites_are_diagonal_with_trace_one(model):
    gen = torch.Generator().manual_seed(1) if model == "random-classic" else None
    m = TM.classical_message(3, 4, gen)
    for s in m.sites:
        mat = s.reshape(3, 3)
        assert torch.equal(mat, torch.diag(torch.diagonal(mat)))
        assert abs(torch.trace(mat).item() - 1.0) < 1e-14
        assert torch.diagonal(mat).real.min().item() > 0.1 / 3 * 0.99


def test_uniform_classic_messages_equal_jax():
    jm = JC.initial_messages(N, D, 8, model="uniform-classic")
    tm = TC.initial_messages(N, D, 8, model="uniform-classic")
    for side, m in tm.items():
        for a, b in zip(m.sites, jm[side].sites):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ------------------------- K1's operator form -----------------------------


@pytest.mark.parametrize("op", ["x", "y", "z", "random"])
def test_fused_tensor_with_operator_matches_jax(op):
    rng = np.random.default_rng(3)
    t = _rand(rng, (2, 3, 3, 3, 3))
    o = _rand(rng, (2, 2)) if op == "random" else pauli.ALL[op]
    want = np.asarray(jax_fused_op(jnp.asarray(t), o))
    got = fused_tensor_with_operator(torch.from_numpy(t), o)
    assert np.abs(got.numpy() - want).max() < 1e-12
    three = K.fused_tensors_with_operator(torch.from_numpy(t), [o, pauli.ALL["x"], np.eye(2)])
    np.testing.assert_array_equal(three[0].numpy(), got.numpy())
    # the identity's sandwich is the plain double-layer tensor
    assert (three[2] - K.fused_tensor_ref(torch.from_numpy(t))).abs().max().item() < 1e-14


# ------------------------------ sandwich ----------------------------------


@pytest.fixture(scope="module")
def sandwich_case(asset):
    """A numpy cell, random-classic messages drawn by the JAX package
    (converted for the port), and the JAX package's 9 values, from the
    asset."""
    data = numpy_cell(11)
    for f in "ABC":
        np.testing.assert_array_equal(asset[f"cell_{f}"], data[f])
    sides = {}
    for name in sorted((k for k in asset if k.startswith("msg_")), key=lambda k: int(k.split("_")[2])):
        _, side, _ = name.split("_")
        sides.setdefault(int(side), []).append(asset[name])
    assert len(sides) == 6
    want = {f: {k: asset["xyz"][i, j] for j, k in enumerate("xyz")} for i, f in enumerate("ABC")}
    return unit_cell_from_numpy(data), messages_from_numpy(sides), want


def test_measure_xyz_sandwich_matches_jax(sandwich_case):
    cell, msgs, want = sandwich_case
    got = measure_xyz_sandwich(cell, msgs, N, CHI, CHI_MSG)
    for f in "ABC":
        for k in "xyz":
            assert abs(got[f][k] - complex(want[f][k])) < TOL, (f, k)


@pytest.mark.parametrize("flavor", [0, 1, 2])
def test_sandwich_expectation_matches_jax(sandwich_case, flavor):
    cell, msgs, want = sandwich_case
    for k in "xyz":
        got = sandwich_expectation(cell, msgs, N, CHI, CHI_MSG, pauli.ALL[k], flavor=flavor)
        assert abs(got - complex(want["ABC"[flavor]][k])) < TOL, k
    real = sandwich_expectation(cell, msgs, N, CHI, CHI_MSG, pauli.ALL["z"], flavor=flavor,
                                force_real=True)
    assert isinstance(real, float)


def test_sandwich_z_on_product_state_is_exact():
    """|0…0⟩ product cell: ⟨z⟩ = 1 at every site, in any environment."""
    cell = UnitCell.zero_product_state(2, D)
    msgs = TC.initial_messages(N, D, CHI_MSG, model="random",
                               generator=torch.Generator().manual_seed(3))
    out = measure_xyz_sandwich(cell, msgs, N, CHI, CHI_MSG)
    assert all(abs(out[f]["z"] - 1) < TOL for f in "ABC")
    uniform = TC.initial_messages(N, D, CHI_MSG, model="uniform-classic")
    assert abs(sandwich_expectation(cell, uniform, N, CHI, CHI_MSG, pauli.ALL["z"], flavor=1) - 1) < TOL


# -------------------------------- pmps ------------------------------------


def _chain(M, t):
    p = M.pmps_root(t[0], out_legs=[0])
    p = M.swallow_bubbleket(p, t[1], 0, in_legs=[0], out_legs=[1])
    return M.swallow_bubbleket(p, t[2], 0, in_legs=[0], out_legs=[])


def _grid(M, t, chi=None):
    p = M.pmps_root(t[0], out_legs=[0, 1])
    p = M.swallow_bubbleket(p, t[1], 0, in_legs=[0], out_legs=[1], chi=chi)
    p = M.swallow_bubbleket(p, t[2], 1, in_legs=[0], out_legs=[1], chi=chi)
    return M.swallow_bubbleket(p, t[3], 0, in_legs=[0, 1], out_legs=[], chi=chi)


def _trimmed(M, t):
    p = M.pmps_root(t[0], out_legs=[0])
    p = M.swallow_bubbleket(p, t[1], 0, in_legs=[0], out_legs=[1])
    s = p.sites[0]
    full_rank = s.shape[0] * (s.shape[1] // p.purifiers[0]) * s.shape[2]
    assert full_rank < p.purifiers[0]
    return M.ptrim(p, 0, full_rank)


_PMPS_CASES = {
    "chain": (_chain, [(2, 3), (2, 3, 4), (2, 4)]),
    "root_two_out_multi_in": (_grid, [(2, 2, 3), (2, 2, 2), (2, 3, 3), (2, 2, 3)]),
    "ptrim_full_rank": (_trimmed, [(4, 1), (4, 1, 3)]),
    "truncated_swallow": (lambda M, t: _grid(M, t, chi=2), [(2, 2, 3), (2, 2, 2), (2, 3, 3), (2, 2, 3)]),
}


@pytest.mark.parametrize("case", list(_PMPS_CASES))
def test_pmps_matches_jax(case):
    build, shapes = _PMPS_CASES[case]
    rng = np.random.default_rng(7)
    ts = [_rand(rng, s) for s in shapes]
    jp = build(JP, [jnp.asarray(t) for t in ts])
    tp = build(TP, [torch.from_numpy(t) for t in ts])
    assert tp.purifiers == jp.purifiers
    assert [tuple(s.shape) for s in tp.sites] == [tuple(s.shape) for s in jp.sites]
    (jv, jl), (tv, tl) = JP.pmps_inner(jp), TP.pmps_inner(tp)
    want = complex(jv) * np.exp(float(jl))
    got = complex(tv.item()) * np.exp(float(tl))
    assert abs(got - want) < TOL * abs(want)
    if case != "truncated_swallow":  # the exact double-layer norm
        if case == "chain":
            psi = np.einsum("ia,jab,kb->ijk", *ts)
        elif case == "ptrim_full_rank":
            psi = np.einsum("ia,jab->ijb", *ts)
        else:
            psi = np.einsum("iab,jac,kbe,lce->ijkl", *ts)
        assert abs(got - np.sum(np.abs(psi) ** 2)) < 1e-9 * abs(want)


# ------------------------------ arbitrary ---------------------------------


@pytest.mark.parametrize("n", [2, 3])
def test_shift_permutations_match_jax(n):
    assert TA.all_shift_permutations(n) == JA.all_shift_permutations(n)
    for d in (LatticeDir.R, LatticeDir.DR):
        assert TA.kagome_shift_permutation(n, d) == JA.kagome_shift_permutation(
            n, JA.LatticeDir[d.name])


def arbitrary_block(kind):
    """21 per-site kets of an N=2 block: a tiled unit cell, or independent
    tensors."""
    if kind == "tiled":
        data = numpy_cell(5)
        return [data["ABC"[v % 3]] for v in range(3 * 7)]
    rng = np.random.default_rng(6)
    return [(lambda t: t / np.linalg.norm(t))(_rand(rng, (2,) + (D,) * 4)) for _ in range(3 * 7)]


@pytest.mark.parametrize("kind", ["tiled", "per_site"])
def test_arbitrary_measure_matches_jax(kind, asset):
    """BP and the six edge measurements of a block of per-site tensors (a
    tiled unit cell, and 3·n_triangles independent tensors) against the JAX
    package's ``ArbitraryKagomeTN.measure`` of the same tensors, its own BP
    included (from the asset)."""
    tensors = arbitrary_block(kind)
    np.testing.assert_array_equal(asset[f"arb_{kind}"], np.stack(tensors))
    h = hamiltonians.heisenberg_afm()
    tn = arbitrary_tn_from_numpy(tensors, N)
    assert all(np.array_equal(a, b) for a, b in zip(to_numpy(tn), tensors))
    got = tn.measure(h, bp_config=BPConfig(**ARB_BP), chi=ARB_CHI)
    assert abs(got.mean_energy - float(asset[f"arb_{kind}_mean"])) < TOL
    assert sorted(got.energies) == list(asset["energy_keys"])
    for key, e in zip(asset["energy_keys"], asset[f"arb_{kind}_energies"]):
        assert abs(got.energies[key] - e) < TOL, key
    if kind == "tiled":
        cell = unit_cell_from_numpy(numpy_cell(5))
        same = TA.ArbitraryKagomeTN.from_unit_cell(cell, N).measure(h, bp_config=BPConfig(**ARB_BP),
                                                                    chi=ARB_CHI)
        assert abs(same.mean_energy - got.mean_energy) < 1e-14
