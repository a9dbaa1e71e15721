"""The port's CUDA kernels and its main path on the card, against the plain
PyTorch versions. Every test here needs an NVIDIA GPU and skips without one;
the file imports no JAX, so on a machine with a card and no JAX run it as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: K1 absolute on a unit-norm ket (d = 2 products per element); K2
relative to max|L| and max|W| (k-term sums); complex128 paths to 1e-10.
"""
import numpy as np
import pytest
import torch

from kagomeperiodicbp_tpu_torch.algo import contraction as C
from kagomeperiodicbp_tpu_torch.algo.arbitrary import _PerSiteCellView
from kagomeperiodicbp_tpu_torch.algo.measurements import measure_xyz_sandwich
from kagomeperiodicbp_tpu_torch.algo import edge_env as E
from kagomeperiodicbp_tpu_torch.algo import fused as F
from kagomeperiodicbp_tpu_torch.convert import unit_cell_from_numpy
from kagomeperiodicbp_tpu_torch.enums import UpdateEdge
from kagomeperiodicbp_tpu_torch.lattices import BlockSide
from kagomeperiodicbp_tpu_torch.networks.unit_cell import UnitCell
from kagomeperiodicbp_tpu_torch.ops import contract as CT
from kagomeperiodicbp_tpu_torch.ops import ite_kernels as IK
from kagomeperiodicbp_tpu_torch.ops import kernels as K
from kagomeperiodicbp_tpu_torch.ops import linalg as L
from kagomeperiodicbp_tpu_torch.ops import mps as mpslib
from kagomeperiodicbp_tpu_torch.physics import hamiltonians, pauli

DTYPES = {"c64": torch.complex64, "c128": torch.complex128,
          "f32": torch.float32, "f64": torch.float64}
K1_ATOL = {"c64": 1e-6, "c128": 1e-14, "f32": 1e-6, "f64": 1e-14}
K2_RTOL = {"c64": 1e-5, "c128": 1e-12, "f32": 1e-5, "f64": 1e-12}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only on the card")
    K.build()
    return torch.device("cuda")


def _randn(shape, dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=gen, dtype=dtype)


def _gram(k, dtype, batch=()):
    b = _randn(batch + (k, k), dtype, seed=k)
    return b @ b.mH + k * torch.eye(k, dtype=dtype)


def _ket(D, dtype, seed, d=2):
    t = _randn((d, D, D, D, D), dtype, seed=seed)
    return t / torch.linalg.vector_norm(t)


def _k1_launches():
    return K.launch_counts()["fused_tensor"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("D", [2, 3, 5])
def test_fused_tensor_cuda_matches_ref(cuda, D, dtype):
    t = _ket(D, DTYPES[dtype], seed=D).to(cuda)
    before = _k1_launches()
    got = K.fused_tensor(t)
    torch.cuda.synchronize()
    assert _k1_launches() == before + 1
    assert (got - K.fused_tensor_ref(t)).abs().max().item() < K1_ATOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("D", [2, 3, 5, 8])
def test_fused_tensors_cuda_matches_ref(cuda, D, dtype):
    """A cell's three tensors in one launch, against the plain version."""
    cell = [_ket(D, DTYPES[dtype], seed=10 * D + i).to(cuda) for i in range(3)]
    before = _k1_launches()
    got = K.fused_tensors(cell)
    torch.cuda.synchronize()
    assert _k1_launches() == before + 1
    for g, want in zip(got, K.fused_tensors_ref(cell)):
        assert g.shape == want.shape and g.dtype == want.dtype
        assert (g - want).abs().max().item() < K1_ATOL[dtype]


@pytest.mark.cuda
def test_fused_tensor_cuda_takes_strided_input(cuda):
    """A permuted (non-contiguous) tensor launches K1 as it is, with no copy."""
    t = _randn((2, 3, 3, 3, 3), torch.complex128, seed=1).to(cuda).permute(0, 2, 3, 4, 1)
    assert not t.is_contiguous()
    before = _k1_launches()
    got = K.fused_tensor_cuda(t)
    assert _k1_launches() == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), K.fused_tensor_ref(t).cpu().numpy(), atol=1e-14)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("turns", [1, 2])
def test_fused_cells_of_rotated_cell_one_launch(cuda, turns, dtype):
    """A rotated cell's flavours are permuted views of the canonical ones:
    fused_cells makes all three in one launch and matches the plain path."""
    data = {f: _ket(3, DTYPES[dtype], seed=i).numpy() for i, f in enumerate("ABC")}
    cells = {}
    for dev in ("cpu", cuda):
        cells[str(dev)] = unit_cell_from_numpy(data, device=dev)
        for _ in range(turns):
            cells[str(dev)] = cells[str(dev)].rotate_ccw()
    assert not cells[str(cuda)].A.is_contiguous()
    before = _k1_launches()
    got = C.fused_cells(cells[str(cuda)])
    torch.cuda.synchronize()
    assert _k1_launches() == before + 1
    for g, want in zip(got, C.fused_cells(cells["cpu"])):
        assert (g.cpu() - want).abs().max().item() < K1_ATOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,D,d", [("f32", 9, 1), ("c64", 9, 2), ("c128", 9, 1)])
def test_fused_tensors_cuda_runtime_D(cuda, D, d, dtype):
    """Above D=8 the kernel reads D at run time (one body for every D)."""
    cell = [_ket(D, DTYPES[dtype], seed=i, d=d).to(cuda) for i in range(2)]
    got = K.fused_tensors(cell)
    for g, t in zip(got, cell):
        assert (g - K.fused_tensor_ref(t)).abs().max().item() < K1_ATOL[dtype]


@pytest.mark.cuda
def test_fused_tensors_cuda_rejects_mismatched_inputs(cuda):
    a = _ket(2, torch.complex128, seed=0).to(cuda)
    with pytest.raises(ValueError, match="differ in shape"):
        K.fused_tensors_cuda((a, _ket(3, torch.complex128, seed=0).to(cuda)))
    with pytest.raises(TypeError, match="differ in dtype"):
        K.fused_tensors_cuda((a, a.to(torch.complex64)))
    with pytest.raises(ValueError, match="CUDA tensors"):
        K.fused_tensors_cuda((a, a.cpu()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["c64", "c128"])
@pytest.mark.parametrize("D", [2, 3, 6])
def test_fused_tensors_with_operator_cuda_matches_ref(cuda, D, dtype):
    """K1's operator form: the x, y, z sandwiches of one site in one launch,
    counted on its own counter, against the plain version; the bra is read
    through its strides (a permuted view here)."""
    t = _ket(D, DTYPES[dtype], seed=20 + D).to(cuda).permute(0, 2, 1, 4, 3)
    ops = [torch.as_tensor(pauli.ALL[k]) for k in "xyz"]
    before = K.launch_counts()
    got = K.fused_tensors_with_operator(t, ops)
    torch.cuda.synchronize()
    after = K.launch_counts()
    assert {n: after[n] - before[n] for n in after} == {
        "fused_tensor": 0, "fused_tensor_operator": 1, "chol_inv_resident": 0, "chol_inv_blocked": 0,
        "chol_inv_tiled": 0}
    for g, op in zip(got, ops):
        want = K.fused_tensor_with_operator_ref(t, op.to(cuda))
        assert (g - want).abs().max().item() < K1_ATOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [3, 7, 21])
def test_fused_cells_of_per_site_view_one_launch_per_three(cuda, n):
    kets = [_ket(2, torch.complex128, seed=40 + i).to(cuda) for i in range(n)]
    before = _k1_launches()
    got = C.fused_cells(_PerSiteCellView(kets))
    torch.cuda.synchronize()
    assert _k1_launches() == before + -(-n // 3)
    assert len(got) == n
    for g, t in zip(got, kets):
        assert (g - K.fused_tensor_ref(t)).abs().max().item() < K1_ATOL["c128"]


@pytest.mark.cuda
def test_measure_xyz_sandwich_on_card_matches_cpu(cuda):
    """The 9 sandwich values at N=2, D=2 on the card against the CPU port,
    with K1 launched 1 + 3 times (the shared fused cell, then one operator
    launch per flavour)."""
    data = {f: _ket(2, torch.complex128, seed=50 + i).numpy() for i, f in enumerate("ABC")}
    out = {}
    for dev in ("cpu", cuda):
        cell = unit_cell_from_numpy(data, device=dev)
        msgs = C.initial_messages(2, 2, 8, model="random-classic",
                                  generator=torch.Generator().manual_seed(5), device=dev)
        before = K.launch_counts()
        out[str(dev)] = measure_xyz_sandwich(cell, msgs, 2, 16, 8)
        after = K.launch_counts()
        if dev != "cpu":
            assert after["fused_tensor"] - before["fused_tensor"] == 1
            assert after["fused_tensor_operator"] - before["fused_tensor_operator"] == 3
    for f in "ABC":
        for k in "xyz":
            assert abs(out[str(cuda)][f][k] - out["cpu"][f][k]) < 1e-10


def _size(name, dtype):
    """k for a named case: panel edges of the blocked variant (nb) or of the
    tiled one (tb, its 64 wide tile), the resident/blocked switch, the
    blocked/tiled switch (tiled), the largest resident matrix that fits one
    block (fit), or a plain number."""
    size = torch.empty((), dtype=dtype).element_size()
    fit = max(k for k in range(1, 300) if k * (k | 1) * size <= K.SMEM_MAX)
    return int(eval(name, {"__builtins__": {}},
                    {"nb": K.CHOL_NB, "tb": 64, "switch": K.CHOL_RESIDENT_MAX_K,
                     "tiled": K.CHOL_TILED_MIN_K[dtype], "fit": fit}))


def _counts(variant):
    """The launch counts of one K2 call of `variant`."""
    return {"fused_tensor": 0, "fused_tensor_operator": 0,
            **{f"chol_inv_{v}": int(v == variant) for v in ("resident", "blocked", "tiled")}}


def _check_chol_inv(g, dtype, variant="", tile=0):
    """K2 on g against the plain version, and the launch counted on the
    variant the plan (or `variant`, at `tile`) names and on no other."""
    want = K.chol_inv_plan(g.shape[-1], g.dtype, variant, tile).variant
    before = K.launch_counts()
    l, w = K.chol_inv_cuda(g, variant, tile) if variant else K.chol_inv(g)
    torch.cuda.synchronize()
    after = K.launch_counts()
    assert {n: after[n] - before[n] for n in after} == _counts(want)
    l_ref, w_ref = K.chol_inv_ref(g)
    assert ((l - l_ref).abs().max() / l_ref.abs().max()).item() < K2_RTOL[dtype]
    assert ((w - w_ref).abs().max() / w_ref.abs().max()).item() < K2_RTOL[dtype]
    # lower triangular, zeros above, exactly
    assert not torch.triu(l, 1).any() and not torch.triu(w, 1).any()


_K2_SIZES = ["1", "2", "nb-1", "nb", "nb+1", "2*nb+3", "switch-1", "switch", "switch+1",
             "130", "300", "324", "504", "1296", "tiled-1", "tiled", "tiled+1", "2952"]
# the plan's own choice at every size, the blocked variant forced where the
# plan keeps the matrix resident, the resident one forced up to its fit, and
# the tiled one forced on its 64-wide tile's edges and on the pin's grams
_K2_CASES = ([(n, "") for n in _K2_SIZES] + [(n, "blocked") for n in ["1", "2", "switch"]]
             + [(n, "resident") for n in ["nb+1", "81", "fit"]]
             + [(n, "tiled") for n in ["1", "tb-1", "tb", "tb+1", "2*tb+3", "324", "504"]])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("k,variant", _K2_CASES, ids=[f"{n}-{v or 'plan'}" for n, v in _K2_CASES])
def test_chol_inv_cuda_matches_ref(cuda, k, variant, dtype):
    g = _gram(_size(k, DTYPES[dtype]), DTYPES[dtype]).to(cuda)
    _check_chol_inv(g, dtype, variant)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["c64", "f32", "f64"])
@pytest.mark.parametrize("k", [127, 128, 129, 259, 1296])
def test_chol_inv_cuda_tiled_128_matches_ref(cuda, k, dtype):
    """The tiled variant at its 128 wide tile (4- and 8-byte types), on the
    tile's edges."""
    _check_chol_inv(_gram(k, DTYPES[dtype]).to(cuda), dtype, "tiled", 128)


@pytest.mark.cuda
@pytest.mark.parametrize("k,variant", [(18, ""), (40, ""), (130, ""), (40, "resident"), (200, "tiled"),
                                       (1700, "")])
def test_chol_inv_cuda_batched(cuda, k, variant):
    _check_chol_inv(_gram(k, torch.complex128, batch=(3,)).to(cuda), "c128", variant)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("k", [1, 33, 120, 169, 241, 504, 2952, 5292])
def test_chol_inv_plan_smem_matches_kernel(cuda, k, dtype):
    """The plan's shared memory, launches and scratch are what the C side
    launches with, for every variant and tiled tile width that takes k."""
    dt = DTYPES[dtype]
    lib = K.build()
    for variant, tile in (("resident", 0), ("blocked", 0), ("tiled", 0), ("tiled", 64), ("tiled", 128)):
        try:
            plan = K.chol_inv_plan(k, dt, variant, tile)
        except ValueError:
            continue
        code, dcode = K._variant_code(plan), K._DTYPE_CODE[dt]
        assert lib.kpbp_chol_inv_smem(k, dcode, code) == plan.smem_bytes
        assert lib.kpbp_chol_inv_launches(k, dcode, code) == plan.launches
        assert lib.kpbp_chol_inv_scratch(k, dcode, code) == plan.scratch


def _rank_deficient(m, n, seed):
    a = _randn((m, n), torch.complex128, seed=seed)
    a[:, 4] = 0
    a[:, n - 1] = 0
    return a


@pytest.mark.cuda
@pytest.mark.parametrize("m,n", [(30, 10), (400, 324), (2400, 1700)])
def test_cholqr2_rank_deficient_on_card(cuda, m, n):
    """CholeskyQR2 of an A with zero columns (a zero-padded bond): the shift
    and the pivot clamp keep Q and R finite, on the resident (k=10), blocked
    (k=324) and tiled (k=1700) paths."""
    a = _rank_deficient(m, n, seed=3)
    variant = K.chol_inv_plan(n, torch.complex128).variant
    before = K.launch_counts()[f"chol_inv_{variant}"]
    q, r = L.cholqr2(a.to(cuda))
    assert K.launch_counts()[f"chol_inv_{variant}"] == before + 2
    qc, rc = L.cholqr2(a)
    assert torch.isfinite(q).all() and torch.isfinite(r).all()
    np.testing.assert_allclose(q.cpu().numpy(), qc.numpy(), atol=1e-10)
    np.testing.assert_allclose(r.cpu().numpy(), rc.numpy(), atol=1e-10)


@pytest.mark.cuda
@pytest.mark.parametrize("linalg", ["householder", "gram"])
def test_bp_sweep_on_card_matches_cpu(cuda, monkeypatch, linalg):
    """One BP sweep at N=2, D=2, χ=8 in complex128: the card (K1, and K2
    under gram) gives the messages the CPU plain versions give."""
    if linalg == "gram":
        monkeypatch.setenv("KPBP_LINALG", "gram")
    rng = np.random.default_rng(0)
    data = {f: rng.standard_normal((2,) * 5) + 1j * rng.standard_normal((2,) * 5) for f in "ABC"}
    out = {}
    for dev in ("cpu", cuda):
        cell = unit_cell_from_numpy(data, device=dev)
        msgs = C.initial_messages(2, 2, 8, dtype=torch.complex128, device=dev)
        sites, err = F.bp_iteration(2, 2, 8, 8, None)(C.fused_cells(cell), F._msgs_to_sites(msgs))
        out[str(dev)] = (F._sites_to_msgs(sites), float(err))
    (m_cpu, e_cpu), (m_gpu, e_gpu) = out["cpu"], out[str(cuda)]
    assert abs(e_cpu - e_gpu) < 1e-10
    for side, m in m_cpu.items():
        moved = mpslib.MPS(tuple(s.cpu() for s in m_gpu[side].sites), m_gpu[side].logscale.cpu())
        assert float(mpslib.distance(m, moved)) < 1e-10


# ------------------------------ ITE ---------------------------------------


def _ite_inputs(dev, dtype=torch.complex128, D=2, seed=0):
    rng = np.random.default_rng(seed)
    data = {f: rng.standard_normal((2,) + (D,) * 4) + 1j * rng.standard_normal((2,) + (D,) * 4)
            for f in "ABC"}
    cell = unit_cell_from_numpy(data, device=dev, dtype=dtype)
    msgs = C.initial_messages(2, D, 8, dtype=dtype, device=dev)
    h = torch.as_tensor(hamiltonians.heisenberg_afm(), dtype=dtype, device=dev)
    return (cell.A, cell.B, cell.C), F._msgs_to_sites(msgs), h


@pytest.mark.cuda
@pytest.mark.parametrize("linalg", ["householder", "gram"])
def test_edge_update_on_card_matches_cpu(cuda, monkeypatch, linalg):
    """One ITE edge update at N=2, D=2, χ=18 in complex128, on the card and
    on the CPU: energy and health to 1e-10, and the new pair through what
    its bond gauge leaves fixed (θ relative to its largest entry, |t'|).
    Under gram the update launches K1 and K2's resident variant."""
    if linalg == "gram":
        monkeypatch.setenv("KPBP_LINALG", "gram")
    edge = UpdateEdge.all_options()[1]
    out = {}
    for dev in ("cpu", cuda):
        cells, sites, h = _ite_inputs(dev)
        before = K.launch_counts()
        res = F.edge_update(2, 2, 18, 8, edge, 10, True)(cells, sites, h, 0.1)
        torch.cuda.synchronize()
        after = K.launch_counts()
        out[str(dev)] = res, {n: after[n] - before[n] for n in after}
        _, _, _, perms = E.edge_environment_sites(cells, sites, 2, 18, 8, edge)
    (cpu, n_cpu), (gpu, n_gpu) = out["cpu"], out[str(cuda)]
    assert sum(n_cpu.values()) == 0 and n_gpu["fused_tensor"] >= 1
    if linalg == "gram":
        assert n_gpu["chol_inv_resident"] >= 1
    for name, a, b in zip(("energy", "herm", "sum_eig", "neg"), cpu[1:], gpu[1:]):
        assert abs(complex(a) - complex(b.cpu())) < 1e-10, name
    f1, f2 = int(edge.first), int(edge.second)
    theta = lambda c: np.tensordot(c[f1].cpu().numpy(), c[f2].cpu().numpy(),  # noqa: E731
                                   ([1 + perms[0][0]], [1 + perms[1][0]]))
    th_c, th_g = theta(cpu[0]), theta(gpu[0])
    assert np.abs(th_c - th_g).max() / np.abs(th_c).max() < 1e-10
    for f in (f1, f2):
        np.testing.assert_allclose(np.abs(gpu[0][f].cpu().numpy()), np.abs(cpu[0][f].numpy()),
                                   atol=1e-10)


@pytest.mark.cuda
def test_gram_edge_update_complex64_on_pin_cell(cuda, monkeypatch):
    """The D=3 ITE update of the pin cell in complex64 under gram: its
    environment's gram SVD meets a gram of many-fold zero eigenvalue, on
    which cuSOLVER's complex64 eigh fails to converge unless shifted
    (ops/linalg._eigh_shifted). The update must run and stay healthy."""
    import os

    from kagomeperiodicbp_tpu_torch.algo.bp import BPConfig, robust_belief_propagation

    pin = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets", "pin_D3.pkl")
    cell = UnitCell.load(pin, device=cuda).astype(torch.complex128).force_zero_rotation()
    msgs, _ = robust_belief_propagation(cell, None, BPConfig(trunc_dim=18), 2)
    monkeypatch.setenv("KPBP_LINALG", "gram")
    c64 = torch.complex64
    cells = tuple(t.to(c64) for t in (cell.A, cell.B, cell.C))
    sites = {s: tuple(x.to(c64) for x in ss) for s, ss in F._msgs_to_sites(msgs).items()}
    h = torch.as_tensor(hamiltonians.heisenberg_afm(), dtype=c64, device=cuda)
    new, energy, herm, sum_eig, neg = F.edge_update(2, 3, 28, 18, UpdateEdge.all_options()[0],
                                                    10, True)(cells, sites, h, 1e-3)
    assert all(torch.isfinite(t).all() for t in new)
    assert float(herm) < 1e-3 and abs(float(sum_eig) - 1) < 1e-3 and -0.5 < float(energy) < 0.5


@pytest.mark.cuda
def test_apply_gate_complex64_on_card(cuda):
    """apply_gate in complex64 on the card against complex128 on the CPU:
    the new pair's energy in the same env within the c64 energy bar, 1e-3."""
    cells, sites, h = _ite_inputs("cpu")
    t1, t2, env, _ = E.edge_environment_sites(cells, sites, 2, 18, 8, UpdateEdge.all_options()[0])
    energies = []
    for dev, dt in (("cpu", torch.complex128), (cuda, torch.complex64)):
        args = [x.to(device=dev, dtype=dt) for x in (h, t1, t2)]
        env_d = [e.to(device=dev, dtype=dt) for e in env]
        n1, n2, w = IK.apply_gate(IK.gate_from_hamiltonian(args[0], 0.1), 2, args[1], args[2], env_d)
        assert torch.isfinite(n1).all() and torch.isfinite(n2).all() and torch.isfinite(w).all()
        energies.append(complex(IK.expectation(IK.rho_ij(n1, n2, env_d), args[0]).cpu()))
    assert abs(energies[0] - energies[1]) < 1e-3


@pytest.mark.cuda
def test_unit_cell_random_on_card_repeats(cuda):
    """UnitCell.random, add_noise and pad_to draw on the card from the
    generator they are given: the same seed gives the same cell."""
    def make(seed):
        gen = torch.Generator(device=cuda).manual_seed(seed)
        cell = UnitCell.random(2, 3, gen)
        return cell, cell.add_noise(0.1, gen), cell.pad_to(4, generator=gen)

    (a, an, ap), (b, bn, bp), (c, _, _) = make(7), make(7), make(8)
    for f in "ABC":
        assert a[f].is_cuda and an[f].is_cuda and ap[f].is_cuda
        assert torch.equal(a[f], b[f]) and torch.equal(an[f], bn[f]) and torch.equal(ap[f], bp[f])
        assert not torch.equal(a[f], c[f])
        assert abs(float(torch.linalg.vector_norm(an[f] - a[f])) - 0.1) < 1e-12


# ------------------------- single-layer swallowing ---------------------------


def _dense_sites(sites, logscale):
    out = sites[0]
    for x in sites[1:]:
        out = torch.tensordot(out, x, dims=([out.ndim - 1], [0]))
    return (out * torch.exp(logscale)).cpu()


@pytest.mark.cuda
@pytest.mark.parametrize("chi", [3, 10**6])
def test_sketched_swallow_on_card_matches_cpu(cuda, chi):
    """One sketched swallow (n_out=3, D=3) on the card against the CPU, the
    same factors on both: below full rank (χ=3, s = 2χ+32 = 38 of 63 rows)
    and at full rank; the frontier it writes, as a dense tensor, to 1e-10 of
    its largest entry."""
    D, a, b = 3, 7, 6
    tk = _randn((D, D, D, D, 2), torch.complex128, seed=1)
    site = _randn((a, D * D, b), torch.complex128, seed=2)
    dense = []
    for dev in ("cpu", cuda):
        fr = CT.Frontier(chi=chi)
        fr._init_scale(tk.to(dev))
        sites = CT._swallow_ket_gram_split(tk.to(dev), [site.to(dev)], 3, D, chi, fr)
        assert sites[0].shape[2] == min(a * D * D, 2 * chi + 32)
        dense.append(_dense_sites(sites, fr.logscale))
    np.testing.assert_allclose(dense[1].numpy(), dense[0].numpy(),
                               atol=1e-10 * float(dense[0].abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("toward", [BlockSide.U, BlockSide.DR])
def test_single_layer_message_on_card(cuda, monkeypatch, toward):
    """The single-layer message at D=3, χ=12 on the card: the double-layer
    one on the card, and the single-layer one on the CPU, direct and with
    every eligible swallow sketched at full rank, to 1e-9."""
    cell = UnitCell.random(2, 3, torch.Generator().manual_seed(3))
    msgs = C.initial_messages(2, 3, 12, model="random", generator=torch.Generator().manual_seed(4))
    cell_d = cell.to_device(cuda)
    msgs_d = {s: mpslib.MPS(tuple(x.to(cuda) for x in m.sites), m.logscale.to(cuda))
              for s, m in msgs.items()}
    single = C.outgoing_message_single(cell_d, msgs_d, 2, 3, 12, 12, toward)
    double = C.outgoing_message(cell_d, msgs_d, 2, 3, 12, 12, toward)
    assert float(mpslib.distance(single, double)) < 1e-9
    for env in ({}, {"KPBP_BLOB_LIMIT": "1", "KPBP_SKETCH_RANK": "1000000000"}):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        card = C.outgoing_message_single(cell_d, msgs_d, 2, 3, 12, 12, toward)
        cpu = C.outgoing_message_single(cell, msgs, 2, 3, 12, 12, toward)
        card = mpslib.MPS(tuple(x.cpu() for x in card.sites), card.logscale.cpu())
        assert float(mpslib.distance(card, cpu)) < 1e-9


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["c64", "c128"])
@pytest.mark.parametrize("k", [1, 9, 24, 36, 81, 130, 1700])
def test_chol_inv_under_vmap_is_one_launch(cuda, k, dtype):
    """K2 under torch.func.vmap over 3 grams (every variant by k): one call
    of the [3, k, k] path, counted once, each matrix against its plain
    version."""
    g = _gram(k, DTYPES[dtype], batch=(3,)).to(cuda)
    variant = K.chol_inv_plan(k, g.dtype).variant
    before = K.launch_counts()
    l, w = torch.func.vmap(K.chol_inv)(g)
    torch.cuda.synchronize()
    after = K.launch_counts()
    assert {n: after[n] - before[n] for n in after} == _counts(variant)
    for b in range(3):
        l_ref, w_ref = K.chol_inv_ref(g[b])
        assert ((l[b] - l_ref).abs().max() / l_ref.abs().max()).item() < K2_RTOL[dtype]
        assert ((w[b] - w_ref).abs().max() / w_ref.abs().max()).item() < K2_RTOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("linalg", ["default", "gram"])
def test_batched_sweep_on_card_matches_per_side(cuda, monkeypatch, linalg):
    """One batched sweep at N=2, D=3, χ=12 on the card against the per-side
    sweep on the card, c128, by message distance; under gram it launches
    K2 a third as often."""
    from kagomeperiodicbp_tpu_torch.algo import batched as B

    if linalg == "gram":
        monkeypatch.setenv("KPBP_LINALG", "gram")
    cell = UnitCell.random(2, 3, torch.Generator().manual_seed(3)).to_device(cuda)
    msgs = C.initial_messages(2, 3, 12, model="random", generator=torch.Generator().manual_seed(4),
                              device=cuda)
    fused, sites = C.fused_cells(cell), F._msgs_to_sites(msgs)
    counts = []
    out = []
    for sweep in (F.bp_iteration(2, 3, 12, 12, None), B.bp_iteration_batched(2, 3, 12, 12, None)):
        K.reset_launch_counts()
        out.append(sweep(fused, sites))
        torch.cuda.synchronize()
        counts.append(K.launch_counts())
    (a, ea), (b, eb) = out
    for s in a:
        assert float(mpslib.distance(mpslib.from_sites(a[s]), mpslib.from_sites(b[s]))) < 1e-10
    assert abs(float(ea) - float(eb)) < 1e-10
    k2 = ("chol_inv_resident", "chol_inv_blocked", "chol_inv_tiled")
    if linalg == "gram":
        assert sum(counts[0][n] for n in k2) > 0
        assert all(counts[0][n] == 3 * counts[1][n] for n in k2)
    else:
        assert all(counts[0][n] == counts[1][n] == 0 for n in k2)


@pytest.mark.cuda
def test_side_sharded_sweep_on_card_matches_batched(cuda):
    """One side-sharded sweep at N=2, D=3, χ=12 over 3 gloo ranks that share
    cuda:0 (``parallel/launch``'s rule on one card), against the batched
    sweep on the card in one process, c128, by message distance; every rank
    ran on the card."""
    from kagomeperiodicbp_tpu_torch.algo import batched as B
    from kagomeperiodicbp_tpu_torch.parallel import launch
    from kagomeperiodicbp_tpu_torch.parallel import multichip as MC

    cell = UnitCell.random(2, 3, torch.Generator().manual_seed(3))
    msgs = C.initial_messages(2, 3, 12, model="random", generator=torch.Generator().manual_seed(4))
    fused, sites = C.fused_cells(cell), F._msgs_to_sites(msgs)
    got = launch.run_group(3, MC.sharded_sweep_task, fused, sites, 2, 3, 12, 12)
    new, err = got["out"]
    want, err_want = B.bp_iteration_batched(2, 3, 12, 12, None)(
        C.fused_cells(cell.to_device(cuda)), {s: tuple(x.to(cuda) for x in ss)
                                              for s, ss in sites.items()})
    for s in want:
        assert float(mpslib.distance(mpslib.from_sites(new[s]),
                                     mpslib.from_sites([x.cpu() for x in want[s]]))) < 1e-10
    assert abs(float(err) - float(err_want)) < 1e-10
    assert all(r["device"].startswith("cuda") for r in got["ranks"])


@pytest.mark.cuda
@pytest.mark.parametrize("batched", [False, True], ids=["per_side", "batched"])
def test_complex64_sweep_on_rank_deficient_blobs_on_card(cuda, batched):
    """The complex64 sweep at N=2, D=2, χ_msg=8, χ=12 from uniform messages
    on the card: finite, within 2e-5 of the complex128 sweep by distance
    (the batched sweep's vmapped complex64 QR gave non-finite factors on
    its rank-4 blobs until it went through complex128)."""
    from kagomeperiodicbp_tpu_torch.algo import batched as B

    cell = UnitCell.random(2, 2, torch.Generator().manual_seed(0)).to_device(cuda)
    make = B.bp_iteration_batched if batched else F.bp_iteration
    new = {}
    for dt in (torch.complex64, torch.complex128):
        sites = F._msgs_to_sites(C.initial_messages(2, 2, 8, dtype=dt, device=cuda))
        new[dt] = make(2, 2, 12, 8, None)(C.fused_cells(cell.astype(dt)), sites)[0]
    assert all(bool(torch.isfinite(x).all()) for ss in new[torch.complex64].values() for x in ss)
    for s, ss in new[torch.complex64].items():
        a = mpslib.from_sites([x.to(torch.complex128) for x in ss])
        assert float(mpslib.distance(a, mpslib.from_sites(new[torch.complex128][s]))) < 2e-5


@pytest.mark.cuda
def test_padded_pin_d7_single_layer_environment_on_card(cuda, monkeypatch):
    """The pin cell padded to D=7 with no noise, and its BP messages (N=2,
    χ_msg=18, complex128) padded alike, measured at χ=28 through the
    single-layer edge environment (every swallow through its blob; at this
    χ the blob rule would keep it double-layer, so the rule is set to
    single-layer): the six edge energies of the unpadded pin at the same N
    and χ, to 1e-8 (the bar of chip_smoke.py phase 13, which runs χ 98/108,
    where the rule picks single-layer)."""
    import os

    from kagomeperiodicbp_tpu_torch.algo.bp import BPConfig, robust_belief_propagation
    from kagomeperiodicbp_tpu_torch.algo.measurements import measure_energies_and_observables

    pin_path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets", "pin_D3.pkl")
    pin = UnitCell.load(pin_path, device=cuda).astype(torch.complex128)
    h = hamiltonians.heisenberg_afm()
    msgs, stats = robust_belief_propagation(pin, None, BPConfig(trunc_dim=18), 2)
    assert stats.success
    want = measure_energies_and_observables(pin, msgs, 2, 28, 18, h)
    monkeypatch.setattr(E, "env_single_layer", lambda D, chi, chi_msg: True)
    CT.reset_swallow_counts()
    got = measure_energies_and_observables(pin.pad_to(7, noise_fraction=0),
                                           C.pad_messages(msgs, 2, 7, 18), 2, 28, 18, h)
    counts = CT.swallow_counts()
    assert counts["direct"] > 0 and counts["fused"] == 0 and counts["sketched"] == 0
    for k, v in want.energies.items():
        assert abs(got.energies[k] - v) < 1e-8
