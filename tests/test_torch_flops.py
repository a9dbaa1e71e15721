"""The port's flop count (kagomeperiodicbp_tpu_torch/tools/flops_model.py) on
the CPU:

* each closed form against a count by hand on a small shape: Cholesky, the
  triangular inverse and the triangular solve by instrumented loops of
  LAPACK's unblocked algorithms, QR, SVD and eigh by evaluating their
  published polynomials by hand; and the meter on one torch call of each;
* the batched and the per-side sweep (N=2, D=3, χ=18, complex64) count the
  same integer, and its GEMM part in XLA's unit lies within [0.85, 1.0] of
  the JAX tool's XLA count in data/flops_model.json (which that tool
  reproduces bit for bit; its programs are not compiled here);
* a kernel's plain version replaced by other torch work leaves the count
  unchanged: what runs inside a kernel wrapper is not counted, so the card,
  whose kernels the meter cannot see, gives the CPU's integer;
* the command line writes its record, never the JAX tool's file.
"""
import json
import os

import pytest
import torch

from kagomeperiodicbp_tpu_torch.ops import kernels as K
from kagomeperiodicbp_tpu_torch.tools import flops_model as FM

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, D, CHI = 2, 3, 18          # the JAX tool's (and bench.py's) configuration


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _xla_count():
    with open(os.path.join(REPO, "data", "flops_model.json")) as fh:
        return json.load(fh)[f"N{N}_D{D}_chi{CHI}"]


# ----------------------------- closed forms ---------------------------------


class _Ops:
    """Counts multiplications (divisions and square roots among them, as
    LAWN 41 counts them) and additions (subtractions among them)."""

    def __init__(self):
        self.muls = self.adds = 0


def _cholesky_by_hand(n):
    """LAPACK's unblocked right-looking Cholesky (dpotf2), counted."""
    c = _Ops()
    for j in range(n):
        c.muls += j          # a_jj − Σ_k l_jk²: j products
        c.adds += j          # and j subtractions
        c.muls += 1          # the square root
        # column below: l_ij = (a_ij − Σ_k l_ik l_jk) / l_jj
        rows = n - j - 1
        c.muls += rows * j + rows
        c.adds += rows * j
    return c


def _triangular_inverse_by_hand(n):
    """LAPACK's dtrti2: column j inverts its diagonal, multiplies the
    (j−1)-triangle into the column above and scales it."""
    c = _Ops()
    for j in range(1, n + 1):
        c.muls += 1                          # 1 / a_jj
        c.muls += (j - 1) * j // 2           # dtrmv on the triangle above
        c.adds += (j - 1) * (j - 2) // 2
        c.muls += j - 1                      # dscal by −a_jj
    return c


def _triangular_solve_by_hand(m, n_rhs):
    """Forward substitution of an [m, m] triangle, n_rhs columns."""
    c = _Ops()
    for _ in range(n_rhs):
        for i in range(m):
            c.muls += i + 1   # i products and a division
            c.adds += i
    return c


@pytest.mark.parametrize("n", [1, 2, 5])
def test_lawn41_cholesky_inverse_and_solve_match_counts_by_hand(n):
    for form, hand in ((FM.potrf(n), _cholesky_by_hand(n)),
                       (FM.trtri(n), _triangular_inverse_by_hand(n)),
                       (FM.trsm(n, 3), _triangular_solve_by_hand(n, 3))):
        assert form == (hand.muls, hand.adds)
    # real: muls + adds; complex: 6 per multiplication, 2 per addition
    assert FM.lawn41([FM.potrf(n)], False) == sum(FM.potrf(n))
    assert FM.lawn41([FM.potrf(n)], True) == 6 * FM.potrf(n)[0] + 2 * FM.potrf(n)[1]


def test_qr_svd_eigh_forms_by_hand():
    # geqrf(4, 3), m > n: FMULS = 3·(3·(1/2 − 1 + 4) + 4 + 23/6) = 55,
    # FADDS = 3·(3·(1/2 − 1 + 4) + 5/6) = 34
    assert FM.geqrf(4, 3) == (55, 34)
    # ungqr(4, 3, 3): FMULS = 3·(24 + 6 − 5/3 + 3·(2 − 7 − 1)) = 31,
    # FADDS = 3·(24 + 3 − 4 + 1/3 + 3·(2 − 7)) = 25
    assert FM.ungqr(4, 3, 3) == (31, 25)
    assert FM.qr_flops(4, 3, "reduced", False) == 55 + 34 + 31 + 25
    assert FM.qr_flops(4, 3, "reduced", True) == 6 * (55 + 31) + 2 * (34 + 25)
    assert FM.qr_flops(4, 3, "r", False) == 55 + 34
    # the wide case, m ≤ n: geqrf(3, 4) = (3·(3·(−1/2 − 1 + 4) + 8 + 23/6), 3·(3·(−1/2 − 1 + 4) + 4 + 5/6))
    assert FM.geqrf(3, 4) == (58, 37)
    # R-SVD of a 5×3 (or 3×5): 6·5·9 + 20·27 = 810 with U₁, V; 2·5·9 + 2·27 = 144 Σ only;
    # full U 4·25·3 + 22·27 = 894; complex 4×
    assert FM.svd_flops(5, 3, True, False, False) == FM.svd_flops(3, 5, True, False, False) == 810
    assert FM.svd_flops(5, 3, False, False, False) == 144
    assert FM.svd_flops(5, 3, True, True, False) == 894
    assert FM.svd_flops(5, 3, True, False, True) == 4 * 810
    assert FM.eigh_flops(3, True, False) == 243 and FM.eigh_flops(3, False, True) == 4 * 36
    # K1 at the pin's cell: 3 tensors of d·D⁸ complex multiply-adds, 8 flops each
    assert FM.k1_flops(3, 2, 3, True) == 8 * 3 * 2 * 3 ** 8
    assert FM.k1_flops(3, 2, 3, True, operator=True) == 8 * 3 * (2 * 3 ** 8 + 4 * 3 ** 4)
    # leading orders: Householder QR 2mn² − 2n³/3 (+ the same to form Q), K2 8k³/3 complex
    assert abs(FM.lawn41([FM.geqrf(4000, 1000)], False) / (2 * 4000 * 1000 ** 2 - 2 * 1000 ** 3 / 3) - 1) < 2e-3
    assert abs(FM.k2_flops(1, 3000, True) / (8 * 3000 ** 3 / 3) - 1) < 1e-3


def test_meter_counts_each_torch_call_by_its_form():
    g = torch.Generator().manual_seed(0)
    a = torch.randn(2, 4, 3, dtype=torch.complex128, generator=g)
    spd = a[0].mH @ a[0] + torch.eye(3, dtype=a.dtype)
    cases = [
        (lambda: torch.linalg.qr(a), "qr", 2 * FM.qr_flops(4, 3, "reduced", True)),
        (lambda: torch.linalg.qr(a, mode="complete"), "qr", 2 * FM.qr_flops(4, 3, "complete", True)),
        (lambda: torch.linalg.svd(a, full_matrices=False), "svd", 2 * 4 * (6 * 4 * 9 + 20 * 27)),
        (lambda: torch.linalg.eigh(spd), "eigh", 4 * 243),
        (lambda: torch.linalg.eigvalsh(spd), "eigh", 4 * 36),
        (lambda: torch.linalg.cholesky(spd), "cholesky_trsm", FM.lawn41([FM.potrf(3)], True)),
        (lambda: torch.linalg.solve_triangular(spd.tril(), a[0].mT, upper=False), "cholesky_trsm",
         FM.lawn41([FM.trsm(3, 4)], True)),
        (lambda: a[0] @ a[0].mH, "gemm", 8 * 4 * 3 * 4),
    ]
    for fn, kind, want in cases:
        _, rec = FM.count(fn)
        assert rec["split"][kind] == want and rec["total"] == want, (kind, rec)
    _, rec = FM.count(lambda: a[0] @ a[0].mH)
    assert rec["split"]["xla_convention_gemm"] == 2 * 4 * 3 * 4
    _, rec = FM.count(lambda: a.real[0] @ a.real[0].mT)
    assert rec["split"]["gemm"] == rec["split"]["xla_convention_gemm"] == 2 * 4 * 3 * 4


# ------------------------------- the model ----------------------------------


@pytest.fixture(scope="module")
def sweeps():
    return {mode: FM.count_sweep(N, D, CHI, CHI, "cpu", mode) for mode in ("batched", "double")}


def test_batched_and_per_side_sweeps_count_the_same_integer(sweeps):
    assert sweeps["batched"]["mode"] == FM.default_mode(D, CHI) == "batched"
    assert sweeps["batched"]["total"] == sweeps["double"]["total"]
    assert sweeps["batched"]["split"] == sweeps["double"]["split"]
    split = sweeps["batched"]["split"]
    assert split["k1"] == split["k2"] == 0   # the sweep takes the fused tensors as given
    assert all(split[k] > 0 for k in ("gemm", "qr", "svd"))
    assert sweeps["batched"]["total"] == sum(split[k] for k in FM.KINDS)


def test_sweep_gemm_in_xla_units_sits_below_the_jax_tools_count(sweeps):
    xla = _xla_count()["flops_per_bp_sweep"]
    assert xla == 2038251762
    ratio = sweeps["batched"]["split"]["xla_convention_gemm"] / xla
    assert 0.85 <= ratio <= 1.0, ratio
    # a complex multiply-add is 8 real flops, not XLA's 2
    split = sweeps["batched"]["split"]
    assert split["gemm"] == 4 * split["xla_convention_gemm"]


def _other_fused_tensors(ts):
    """K1's plain version by another route: a broadcast product summed over
    the physical leg, no matrix product."""
    d, D = ts[0].shape[0], ts[0].shape[1]
    out = []
    for t in ts:
        tt = (t.reshape(d, -1, 1) * t.conj().reshape(d, 1, -1)).sum(0).reshape((D,) * 8)
        out.append(tt.permute(0, 4, 1, 5, 2, 6, 3, 7).reshape((D * D,) * 4))
    return tuple(out)


def _other_chol_inv(g):
    """K2's plain version by another route: the inverse by a general solve."""
    l = torch.linalg.cholesky(g)
    return l, torch.linalg.inv(l)


@pytest.mark.parametrize("linalg", ["default", "gram"])
def test_plain_versions_inside_the_wrappers_are_not_counted(linalg, monkeypatch):
    if linalg == "gram":
        monkeypatch.setenv("KPBP_LINALG", "gram")
    want = FM.count_ite(N, 2, 8, "cpu")
    monkeypatch.setattr(K, "fused_tensors_ref", _other_fused_tensors)
    monkeypatch.setattr(K, "chol_inv_ref", _other_chol_inv)
    got = FM.count_ite(N, 2, 8, "cpu")
    assert got == want
    cell = FM.inputs(N, 2, 8, "cpu", torch.complex128)[0]
    torch.testing.assert_close(_other_fused_tensors((cell.A,))[0], K.fused_tensor_ref(cell.A))
    assert want["split"]["k1"] == FM.k1_flops(3, 2, 2, True)
    assert (want["split"]["k2"] > 0) is (linalg == "gram")
    assert want["split"]["cholesky_trsm"] == 0


def test_command_line_writes_its_record_and_never_the_jax_file(tmp_path, capsys):
    out = tmp_path / "data" / "flops_model_torch.json"
    rec = FM.main(["-D", "2", "--chi", "8", "--device", "cpu", "--out", str(out)])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == rec == json.loads(out.read_text())["N2_D2_chi8"]
    assert {"config", "flops_per_bp_sweep", "flops_per_ite_step", "source", "measured_at"} <= set(rec)
    assert rec["config"]["bp_mode"] == "batched" and rec["device"] == "cpu"
    for key, total in (("bp_sweep_split", "flops_per_bp_sweep"), ("ite_step_split", "flops_per_ite_step")):
        assert rec[total] == sum(rec[key][k] for k in FM.KINDS)
        assert set(rec[key]) == set(FM.KINDS) | {"xla_convention_gemm"}
    assert rec["uncounted"]["ite_step"] == {"linalg_matrix_exp": 1}
    with pytest.raises(SystemExit):
        FM.main(["-D", "2", "--chi", "8", "--device", "cpu", "--out", str(tmp_path / "flops_model.json")])
    assert not (tmp_path / "flops_model.json").exists()
