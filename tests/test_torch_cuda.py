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
from kagomeperiodicbp_tpu_torch.algo import fused as F
from kagomeperiodicbp_tpu_torch.convert import unit_cell_from_numpy
from kagomeperiodicbp_tpu_torch.ops import kernels as K
from kagomeperiodicbp_tpu_torch.ops import linalg as L
from kagomeperiodicbp_tpu_torch.ops import mps as mpslib

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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("D", [2, 3, 5])
def test_fused_tensor_cuda_matches_ref(cuda, D, dtype):
    t = _randn((2, D, D, D, D), DTYPES[dtype], seed=D)
    t = (t / torch.linalg.vector_norm(t)).to(cuda)
    before = K.fused_tensor_cuda.launches
    got = K.fused_tensor(t)
    torch.cuda.synchronize()
    assert K.fused_tensor_cuda.launches == before + 1
    assert (got - K.fused_tensor_ref(t)).abs().max().item() < K1_ATOL[dtype]


@pytest.mark.cuda
def test_fused_tensor_cuda_takes_strided_input(cuda):
    t = _randn((2, 3, 3, 3, 3), torch.complex128, seed=1).to(cuda).permute(0, 2, 3, 4, 1)
    np.testing.assert_allclose(K.fused_tensor(t).cpu().numpy(),
                               K.fused_tensor_ref(t).cpu().numpy(), atol=1e-14)
    with pytest.raises(ValueError, match="contiguous"):
        K.fused_tensor_cuda(t)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("k", [6, 18, 37, 130, 300, 504])
def test_chol_inv_cuda_matches_ref(cuda, k, dtype):
    g = _gram(k, DTYPES[dtype]).to(cuda)
    before = K.chol_inv_cuda.launches
    l, w = K.chol_inv(g)
    torch.cuda.synchronize()
    assert K.chol_inv_cuda.launches == before + 1
    l_ref, w_ref = K.chol_inv_ref(g)
    assert ((l - l_ref).abs().max() / l_ref.abs().max()).item() < K2_RTOL[dtype]
    assert ((w - w_ref).abs().max() / w_ref.abs().max()).item() < K2_RTOL[dtype]


@pytest.mark.cuda
def test_chol_inv_cuda_batched(cuda):
    g = _gram(40, torch.complex128, batch=(3,)).to(cuda)
    l, w = K.chol_inv_cuda(g)
    l_ref, w_ref = K.chol_inv_ref(g)
    assert (l - l_ref).abs().max().item() < 1e-12 * l_ref.abs().max().item()
    assert (w - w_ref).abs().max().item() < 1e-12 * w_ref.abs().max().item()


@pytest.mark.cuda
def test_cholqr2_rank_deficient_on_card(cuda):
    a = _randn((30, 10), torch.complex128, seed=3)
    a[:, 4] = 0
    a[:, 9] = 0
    q, r = L.cholqr2(a.to(cuda))
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
