"""The port's two kernels (K1 fused_tensor, K2 chol_inv) against the JAX
package's Pallas kernels in interpret mode, and CholeskyQR2 against the JAX
CholeskyQR2. Here the port runs its plain PyTorch versions (CPU tensors);
tests/test_torch_cuda.py holds each CUDA kernel against its plain version on
the card.

Tolerances: complex128 is held to round-off of a few ulps of the result
(1e-12 for K1, 1e-11 for K2 and 1e-10 for CholeskyQR2, whose two passes
square the conditioning); complex64/float32 to the bars of tests/test_pallas.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kagomeperiodicbp_tpu.networks.unit_cell import UnitCell as JUnitCell
from kagomeperiodicbp_tpu.networks.unit_cell import fused_tensor as jax_fused_tensor
from kagomeperiodicbp_tpu.ops import linalg as JL
from kagomeperiodicbp_tpu.ops.pallas_kernels import chol_inv_pallas, fused_tensor_pallas
from kagomeperiodicbp_tpu_torch.convert import unit_cell_from_numpy
from kagomeperiodicbp_tpu_torch.ops import kernels as K
from kagomeperiodicbp_tpu_torch.ops import linalg as TL

DTYPES = {"c64": (np.complex64, torch.complex64), "c128": (np.complex128, torch.complex128),
          "f32": (np.float32, torch.float32), "f64": (np.float64, torch.float64)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's tensors here are small: one torch thread runs them as fast
    and leaves the cores to XLA's compiler, which idle torch worker threads
    measurably slow down."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _ket(D, dt, seed=0):
    rng = np.random.default_rng(seed + D)
    shape = (2, D, D, D, D)
    t = rng.standard_normal(shape)
    if np.issubdtype(dt, np.complexfloating):
        t = t + 1j * rng.standard_normal(shape)
    return (t / np.linalg.norm(t)).astype(dt)


def _gram(k, dt, seed=0):
    rng = np.random.default_rng(seed + k)
    b = rng.standard_normal((k, k))
    if np.issubdtype(dt, np.complexfloating):
        b = b + 1j * rng.standard_normal((k, k))
    return (b @ b.conj().T + k * np.eye(k)).astype(dt)  # well-conditioned PSD


def _tall(m, n, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((m, n)) + 1j * rng.standard_normal((m, n))


# ------------------------------- K1 ---------------------------------------


@pytest.mark.parametrize("dtype,atol", [("c64", 2e-6), ("c128", 1e-12), ("f32", 2e-6)])
@pytest.mark.parametrize("D", [2, 3])
def test_fused_tensor_ref_matches_pallas(D, dtype, atol):
    np_dt, _ = DTYPES[dtype]
    t = _ket(D, np_dt)
    got = K.fused_tensor(torch.from_numpy(t)).numpy()
    assert got.dtype == np_dt and got.shape == (D * D,) * 4
    np.testing.assert_allclose(got, np.asarray(fused_tensor_pallas(jnp.asarray(t), interpret=True)),
                               atol=atol)
    np.testing.assert_allclose(got, np.asarray(jax_fused_tensor(jnp.asarray(t))), atol=atol)


def test_fused_tensor_on_cpu_takes_plain_version():
    K.reset_launch_counts()
    K.fused_tensor(torch.from_numpy(_ket(2, np.complex128)))
    K.fused_tensors([torch.from_numpy(_ket(2, np.complex128, seed=s)) for s in range(3)])
    K.fused_tensors_with_operator(torch.from_numpy(_ket(2, np.complex128)), [np.eye(2)] * 3)
    assert K.launch_counts() == {"fused_tensor": 0, "fused_tensor_operator": 0,
                                 "chol_inv_resident": 0, "chol_inv_blocked": 0, "chol_inv_tiled": 0}
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.fused_tensor_cuda(torch.zeros((2, 2, 2, 2, 2), dtype=torch.complex128))


@pytest.mark.parametrize("D", [2, 3])
def test_fused_tensors_of_rotated_cell_match_jax(D):
    """One numpy cell, rotated once by each package's rotate_ccw (permuted,
    non-contiguous views in the port): the plain path of fused_tensors
    against the JAX fused_tensor of each flavour, complex128."""
    cell_np = {f: _ket(D, np.complex128, seed=10 * i) for i, f in enumerate("ABC")}
    jcell = JUnitCell(*(jnp.asarray(cell_np[f]) for f in "ABC")).rotate_ccw()
    tcell = unit_cell_from_numpy(cell_np).rotate_ccw()
    assert not tcell.A.is_contiguous()
    got = K.fused_tensors((tcell.A, tcell.B, tcell.C))
    assert len(got) == 3
    for f, g in zip("ABC", got):
        assert g.shape == (D * D,) * 4
        np.testing.assert_allclose(g.numpy(), np.asarray(jax_fused_tensor(getattr(jcell, f))),
                                   atol=1e-12)


def test_fused_tensors_checks_its_inputs():
    a, c = (torch.from_numpy(_ket(D, np.complex128)) for D in (2, 3))
    with pytest.raises(ValueError, match="differ in shape"):
        K.fused_tensors((a, a, c))
    with pytest.raises(ValueError, match="1 to 3 tensors"):
        K.fused_tensors((a,) * 4)
    with pytest.raises(ValueError, match=r"\[d, D,D,D,D\]"):
        K.fused_tensors((a[..., :1],))
    with pytest.raises(ValueError, match="CUDA tensors"):
        K.fused_tensors_cuda((a, a, a))


# ------------------------------- K2 ---------------------------------------


@pytest.mark.parametrize("k", [6, 18, 37, 130])
def test_chol_inv_ref_matches_pallas_c64(k):
    g = _gram(k, np.complex64)
    l, w = (x.numpy() for x in K.chol_inv(torch.from_numpy(g)))
    lp, wp = (np.asarray(x) for x in chol_inv_pallas(jnp.asarray(g), interpret=True))
    l_ref = np.linalg.cholesky(g.astype(np.complex128))
    scale = float(np.abs(l_ref).max())
    for got in (l, lp):
        np.testing.assert_allclose(got, l_ref, atol=5e-4 * np.sqrt(k), rtol=2e-4 * scale)
    np.testing.assert_allclose(l, lp, atol=5e-4 * np.sqrt(k), rtol=2e-4 * scale)
    for got in (w, wp):
        np.testing.assert_allclose(got @ l_ref, np.eye(k), atol=5e-4)


@pytest.mark.parametrize("k", [6, 18, 37, 130])
def test_chol_inv_ref_matches_pallas_c128(k):
    g = _gram(k, np.complex128)
    l, w = (x.numpy() for x in K.chol_inv(torch.from_numpy(g)))
    lp, wp = (np.asarray(x) for x in chol_inv_pallas(jnp.asarray(g), interpret=True))
    np.testing.assert_allclose(l, lp, atol=1e-11)
    np.testing.assert_allclose(w, wp, atol=1e-11)
    np.testing.assert_allclose(w @ l, np.eye(k), atol=1e-11)


def test_chol_inv_on_cpu_takes_plain_version():
    K.reset_launch_counts()
    K.chol_inv(torch.from_numpy(_gram(6, np.complex128)))
    assert K.launch_counts()["chol_inv_resident"] == K.launch_counts()["chol_inv_blocked"] == 0
    assert K.launch_counts()["chol_inv_tiled"] == 0
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.chol_inv_cuda(torch.eye(4, dtype=torch.float64))


@pytest.mark.parametrize("dtype", ["c64", "c128", "f32", "f64"])
def test_chol_inv_plan_sends_only_what_fits_to_the_resident_variant(dtype):
    """Every k the plan keeps resident fits one block's shared memory; the
    pin's large grams (k=324, 504 in complex128) go to the blocked variant,
    one launch per 32-wide tile column, and from CHOL_TILED_MIN_K (by dtype)
    every gram goes to the tiled one; every plan fits SMEM_MAX."""
    _, dt = DTYPES[dtype]
    size = torch.empty((), dtype=dt).element_size()
    variants = set()
    switch = K.CHOL_TILED_MIN_K[dt]
    for k in list(range(1, 601)) + [switch + d for d in (-1, 0, 1)] + [2952, 8832]:
        plan = K.chol_inv_plan(k, dt)
        variants.add(plan.variant)
        assert plan.smem_bytes <= K.SMEM_MAX
        if plan.variant == "resident":
            assert plan.smem_bytes == k * (k | 1) * size
            assert (plan.launches, plan.scratch) == (1, 0)
        elif plan.variant == "blocked":
            assert K.CHOL_RESIDENT_MAX_K < k < switch
            assert plan.launches == -(-k // K.CHOL_NB) and plan.scratch == 2 * k * k
        else:
            assert plan.variant == "tiled" and k >= switch
    assert variants == {"resident", "blocked", "tiled"}
    fit = max(k for k in range(1, 601) if k * (k | 1) * size <= K.SMEM_MAX)
    assert K.chol_inv_plan(fit, dt, "resident").smem_bytes <= K.SMEM_MAX
    with pytest.raises(ValueError, match="shared memory"):
        K.chol_inv_plan(fit + 1, dt, "resident")
    assert K.chol_inv_plan(20, dt, "blocked").launches == 1
    if dt == torch.complex128:
        assert K.chol_inv_plan(324, dt).variant == K.chol_inv_plan(504, dt).variant == "blocked"
        assert (K.chol_inv_plan(324, dt).launches, K.chol_inv_plan(504, dt).launches) == (11, 16)


def _tiled_smem(nb, dt):
    """csrc/chol_inv.cu tiled::diag_smem, panel_smem and update_smem."""
    size = torch.empty((), dtype=dt).element_size()
    real = size // 2 if dt.is_complex else size
    tm = 128 if size <= 8 else 64
    diag = nb * (nb + 1) * size + nb * real
    panel = (nb * nb + max(64 * (nb + 1), nb * 65)) * size + nb * real
    return diag, panel, 3 * 16 * (tm + 64) * size


@pytest.mark.parametrize("dtype", ["c64", "c128", "f32", "f64"])
@pytest.mark.parametrize("k", [1, 63, 64, 65, 131, 1295, 1296, 1599, 1600, 1601, 2952, 4096,
                               K.CHOL_WIDE_MIN_K, 5292, 8832])
def test_chol_inv_plan_of_the_tiled_variant(k, dtype):
    """The tiled variant's tile width (64; 128 from CHOL_WIDE_MIN_K but in
    complex128, whose 128-wide diagonal tile does not fit a block), its
    launches (a diagonal factor, a panel and, but the last, an update per
    tile column; at width 64 the update factors the next diagonal tile, so
    only tile column 0 has a factor launch), its scratch (the transposed
    panel, the transposed diagonal factor and 2·NB scales) and its shared
    memory, the largest of its three blocks, within SMEM_MAX."""
    _, dt = DTYPES[dtype]
    plan = K.chol_inv_plan(k, dt, "tiled")
    nb = 128 if dt != torch.complex128 and k >= K.CHOL_WIDE_MIN_K else 64
    nt = -(-k // nb)
    diag, panel, update = _tiled_smem(nb, dt)
    assert plan.variant == "tiled" and plan.tile == nb
    assert plan.launches == (2 * nt if nb == 64 else 3 * nt - 1)
    assert plan.scratch == nb * k + nb * nb + 2 * nb
    assert plan.smem_bytes == max(diag, panel, update) <= K.SMEM_MAX
    assert K.chol_inv_plan(k, dt, "tiled", 64).launches == 2 * -(-k // 64)
    if dt == torch.complex128:
        with pytest.raises(ValueError, match="shared memory"):
            K.chol_inv_plan(k, dt, "tiled", 128)
    else:
        wide = K.chol_inv_plan(k, dt, "tiled", 128)
        assert wide.launches == 3 * -(-k // 128) - 1 and wide.smem_bytes <= K.SMEM_MAX
    for bad in ((k, dt, "tiled", 32), (k, dt, "blocked", 64)):
        with pytest.raises(ValueError, match="tile"):
            K.chol_inv_plan(*bad)


def _tiled_model(g, nb):
    """The tiled variant's schedule (csrc/chol_inv.cu, (c)) in torch, one
    tile column at a time with the kernel's buffers: L and W start unwritten
    (NaN), hold the trailing matrix and X in place, and must end with every
    element written; PT is the transposed panel the update reads. Clamps as
    the kernel's: pivot max(Re a_cc, tiny), divisor max(Re L_tt, tiny)."""
    k, dt = g.shape[-1], g.dtype
    tiny = 1e-300 if g.real.dtype == torch.float64 else 1e-30
    nan = torch.full_like(g, float("nan"))
    l, w, pt = nan.clone(), nan.clone(), torch.full((nb, k), float("nan"), dtype=dt)
    for j in range(-(-k // nb)):
        src, r0 = (g if j == 0 else l), j * nb
        n, below = min(nb, k - r0), r0 + nb
        # diag: A_jj's lower triangle, the identity past k, factored left-looking
        a = torch.eye(nb, dtype=dt)
        a[:n, :n] = torch.tril(src[r0:r0 + n, r0:r0 + n])
        ljj, rs = torch.zeros_like(a), torch.zeros(nb, dtype=g.real.dtype)
        for c in range(nb):
            col = a[c:, c] - ljj[c:, :c] @ ljj[c, :c].conj()
            rs[c] = 1 / torch.sqrt(torch.clamp(col[0].real, min=tiny))
            ljj[c:, c] = col * rs[c]
        l[r0:r0 + n, r0:r0 + n] = ljj[:n, :n]
        dinv = 1 / torch.clamp(ljj.diagonal().real, min=tiny)
        # panel: L_ij = A_ij·L_jj^{-†} by substitution along each row
        if below < k:
            x = src[below:, r0:below].clone()
            for c in range(nb):
                x[:, c] = (x[:, c] - x[:, :c] @ ljj[c, :c].conj()) * rs[c]
            l[below:, r0:below] = x
            pt[:, below:] = x.T
            l[r0:below, below:] = 0
            w[r0:below, below:] = 0
        # W's row block: W_jc = L_jj^{-1}·X_jc, X_jj = I
        ncols = min(below, k)
        y = torch.zeros((nb, ncols), dtype=dt)
        y[:n, :r0] = w[r0:r0 + n, :r0]
        y[torch.arange(n), r0 + torch.arange(n)] = 1
        for u in range(nb):
            y[u] = y[u] * dinv[u]
            y[u + 1:] -= ljj[u + 1:, u:u + 1] * y[u]
        w[r0:r0 + n, :ncols] = torch.where(torch.arange(ncols) > r0 + torch.arange(nb)[:, None], 0, y)[:n]
        # update: trailing A_im −= L_ij·L_mj† (lower triangle), X_ic −= L_ij·W_jc
        if below < k:
            p = pt[:, below:].T
            trail = torch.tril(src[below:, below:]) - p @ p.mH
            keep = torch.tril(torch.ones_like(trail, dtype=torch.bool))
            l[below:, below:] = torch.where(keep, trail, l[below:, below:])
            old = torch.cat([w[below:, :r0], torch.zeros((k - below, nb), dtype=dt)], dim=1)
            w[below:, :below] = old - p @ w[r0:below, :below]
    return l, w


@pytest.mark.parametrize("dtype,tol", [("c128", 1e-11), ("f64", 1e-11), ("c64", 2e-5)])
@pytest.mark.parametrize("k,nb", [(1, 8), (7, 8), (8, 8), (9, 8), (21, 8), (37, 16)])
def test_tiled_schedule_model_matches_plain_version(k, nb, dtype, tol):
    """The tiled schedule, at a small tile width and ragged k, gives the
    plain version's L and W (relative to their largest entries), writes
    every element, and leaves exact zeros above the diagonal."""
    np_dt, dt = DTYPES[dtype]
    g = torch.from_numpy(_gram(k, np_dt))
    l, w = _tiled_model(g, nb)
    l_ref, w_ref = K.chol_inv_ref(g)
    assert torch.isfinite(l).all() and torch.isfinite(w).all()
    assert not torch.triu(l, 1).any() and not torch.triu(w, 1).any()
    assert ((l - l_ref).abs().max() / l_ref.abs().max()).item() < tol
    assert ((w - w_ref).abs().max() / w_ref.abs().max()).item() < tol


@pytest.mark.parametrize("rank_deficient", [False, True], ids=["full", "rank_deficient"])
def test_tiled_schedule_model_matches_pallas(rank_deficient):
    """The tiled schedule against the JAX package's Pallas kernel (interpret
    mode) at a ragged k=21, tile width 8, complex128; rank-deficient: the
    shifted gram of an A with zero columns (a zero-padded bond), where the
    clamps act."""
    rng = np.random.default_rng(5)
    a = rng.standard_normal((40, 21)) + 1j * rng.standard_normal((40, 21))
    if rank_deficient:
        a[:, 13:] = 0
    g = a.conj().T @ a
    g = g + 1e-12 * np.trace(g).real * np.eye(21)
    l, w = (x.numpy() for x in _tiled_model(torch.from_numpy(g), 8))
    lp, wp = (np.asarray(x) for x in chol_inv_pallas(jnp.asarray(g), interpret=True))
    assert np.isfinite(l).all() and np.isfinite(w).all()
    np.testing.assert_allclose(l, lp, atol=1e-10 * np.abs(lp).max())
    np.testing.assert_allclose(w, wp, atol=1e-10 * np.abs(wp).max())


# ---------------------------- CholeskyQR2 ---------------------------------


def _rank_deficient():
    a = _tall(30, 10, seed=1)
    a[:, 4] = 0
    a[:, 9] = 0
    return a


@pytest.mark.parametrize("a", [_tall(24, 8, 0), _tall(100, 17, 2), _rank_deficient()],
                         ids=["24x8", "100x17", "rank_deficient"])
def test_cholqr2_matches_jax(a):
    qj, rj = (np.asarray(x) for x in JL.cholqr2(jnp.asarray(a)))
    qt, rt = (x.numpy() for x in TL.cholqr2(torch.from_numpy(a)))
    assert np.all(np.isfinite(qt)) and np.all(np.isfinite(rt))
    np.testing.assert_allclose(qt, qj, atol=1e-10)
    np.testing.assert_allclose(rt, rj, atol=1e-10)
    np.testing.assert_allclose(qt @ rt, a, atol=1e-10)


def test_gram_mode_routes_tall_qr_through_cholqr2(monkeypatch):
    a = torch.from_numpy(_tall(40, 12, seed=3))
    monkeypatch.setenv("KPBP_LINALG", "gram")
    q1, r1 = TL.qr_stable(a)
    monkeypatch.delenv("KPBP_LINALG")
    q2, r2 = TL.qr_stable(a)
    np.testing.assert_allclose(q1.numpy(), q2.numpy(), atol=1e-10)
    np.testing.assert_allclose(r1.numpy(), r2.numpy(), atol=1e-10)


def test_phase_fix_treats_subnormal_diagonal_as_zero():
    """A subnormal R_jj (complex64 reaches 1e-42 on the pin's rank-deficient
    bonds) keeps phase 1, as under XLA's flush to zero, instead of
    overflowing the division into NaN."""
    r = torch.tensor([[2j, 0.5], [0, 1e-42 + 1e-42j]], dtype=torch.complex64)
    q, r2 = TL._phase_fix(torch.eye(2, dtype=torch.complex64), r)
    assert torch.isfinite(q).all() and torch.isfinite(r2).all()
    assert r2[0, 0] == 2 and r2[1, 1] == r[1, 1]



@pytest.mark.parametrize("shape", [(81, 30), (30, 81)])
def test_svd_trunc_gram_retries_a_failed_eigh_shifted(monkeypatch, shape):
    """Where eigh of the gram fails to converge (cuSOLVER's complex64 eigh
    does on a gram of many-fold zero eigenvalue), the gram SVD takes eigh of
    G + u·tr(G)·I instead, then w − u·tr(G): on a rank-9 matrix the 9 live
    singular values and their subspace as the exact SVD gives them. The
    retry is counted under its call site, by the gram's size."""
    m, n = shape
    a = torch.from_numpy(_tall(m, 9, 1) @ _tall(9, n, 2))
    want = TL.svd_trunc_gram(a, 12)
    eigh, calls = torch.linalg.eigh, []

    def first_fails(g):
        calls.append(g)
        if len(calls) == 1:
            raise torch.linalg.LinAlgError("linalg.eigh: The algorithm failed to converge")
        return eigh(g)

    monkeypatch.setattr(torch.linalg, "eigh", first_fails)
    TL.reset_eigh_retries()
    u, s, vh = TL.svd_trunc_gram(a, 12)
    assert len(calls) == 2 and TL.eigh_retries() == {"svd_trunc_gram": {min(m, n): 1}}
    shift = calls[1] - calls[0]
    assert torch.count_nonzero(shift - torch.diag(torch.diagonal(shift))) == 0
    s_ref = torch.linalg.svdvals(a)[:12]
    np.testing.assert_allclose(s[:9].numpy(), s_ref[:9].numpy(), rtol=1e-12)
    np.testing.assert_allclose(s[:9].numpy(), want[1][:9].numpy(), rtol=1e-12)
    assert s[9:].abs().max() < 1e-6 * s[0]  # √(u·tr) at most
    recon = (u[:, :9] * s[:9].to(a.dtype)) @ vh[:9]
    np.testing.assert_allclose(recon.numpy(), a.numpy(), atol=1e-10 * float(s[0]))


def test_complex64_qr_in_double_takes_every_device(monkeypatch):
    """A batch of complex64 matrices on any device (here meta tensors, with
    a leading batch axis or mapped by ``torch.func.vmap``, as the batched
    sweep's are) is factored in complex128 and cast back; a single one only
    on the CPU; complex128 is left as it is."""
    qr, seen = torch.linalg.qr, []

    def recording(x, mode="reduced"):
        seen.append(x.dtype)
        return qr(x, mode=mode)

    monkeypatch.setattr(torch.linalg, "qr", recording)
    meta = torch.empty((3, 16, 12), dtype=torch.complex64, device="meta")
    assert [t.dtype for t in TL._qr(meta[0])] == [torch.complex64] * 2
    assert [t.dtype for t in TL._qr(meta)] == [torch.complex64] * 2
    q = torch.func.vmap(lambda x: TL._qr(x)[0])(meta)
    assert q.shape == (3, 16, 12) and q.dtype == torch.complex64
    TL._qr(meta.to(torch.complex128))
    TL._qr(torch.zeros((4, 3), dtype=torch.complex64))
    assert seen == [torch.complex64, torch.complex128, torch.complex128, torch.complex128,
                    torch.complex128]


@pytest.mark.parametrize("site", ["robust_solve", "eigh_psd_sqrt"])
def test_ite_solves_retry_a_failed_eigh_shifted(monkeypatch, site):
    """robust_solve and eigh_psd_sqrt, like the gram SVD, take eigh of
    N + u·tr(N)·I where eigh of N fails to converge (cuSOLVER's complex64
    eigh on the larger ALS grams of a D=6 update), then w − u·tr(N): the
    solution of the call that did not fail, to round-off. The retry is
    counted under the function's name, by the matrix size."""
    b = _tall(30, 9, 4)
    n_mat = torch.from_numpy(b @ b.conj().T)  # PSD of rank 9: a rank-deficient ALS system
    rhs = torch.from_numpy(_tall(30, 2, 5))
    fn = {"robust_solve": lambda: TL.robust_solve(n_mat, rhs),
          "eigh_psd_sqrt": lambda: TL.eigh_psd_sqrt(n_mat)}[site]
    want = fn()
    eigh, calls = torch.linalg.eigh, []

    def first_fails(g):
        calls.append(g)
        if len(calls) == 1:
            raise torch.linalg.LinAlgError("linalg.eigh: The algorithm failed to converge")
        return eigh(g)

    monkeypatch.setattr(torch.linalg, "eigh", first_fails)
    TL.reset_eigh_retries()
    got = fn()
    assert len(calls) == 2 and TL.eigh_retries() == {site: {30: 1}}
    shift = calls[1] - calls[0]
    sigma = torch.finfo(torch.float64).eps * torch.diagonal(calls[0]).real.sum()
    assert torch.count_nonzero(shift - torch.diag(torch.diagonal(shift))) == 0
    # u·tr(N), each diagonal entry rounded to the ulp of N_ii (~3% of σ here)
    np.testing.assert_allclose(torch.diagonal(shift).real.numpy(), float(sigma), rtol=0.05)
    if site == "robust_solve":
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-8 * float(want.abs().max()))
        np.testing.assert_allclose((n_mat @ got).numpy(), (n_mat @ want).numpy(),
                                   atol=1e-10 * float((n_mat @ want).abs().max()))
    else:
        (x, w), (x0, w0) = got, want
        np.testing.assert_allclose(w.numpy(), w0.numpy(), atol=1e-10 * float(w0.max()))
        np.testing.assert_allclose((x @ x.mH).numpy(), n_mat.numpy(), atol=1e-10 * float(w0.max()))


def test_k2_profile_needs_the_card():
    """tools/k2_profile times K2's kernels on the card and refuses to run
    without one."""
    from kagomeperiodicbp_tpu_torch.tools import k2_profile

    assert k2_profile.parse_args(["2952:complex64", "8832:complex64:tiled:128"]).cases == [
        "2952:complex64", "8832:complex64:tiled:128"]
    with pytest.raises(SystemExit, match="needs the card"):
        k2_profile.main(["2952:complex64"])
