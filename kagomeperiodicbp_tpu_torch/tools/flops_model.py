"""The work of one BP sweep and of one ITE edge update, in real flops
(counterpart of the JAX package's tools/flops_model.py, with its flags and
record keys; ``--device`` and ``--out`` added).

    python -m kagomeperiodicbp_tpu_torch.tools.flops_model [-N 2 -D 3 --chi 18 --chi-msg M]
        [--device cuda] [--out data/flops_model_torch.json]

It prints one JSON line and merges it into ``--out`` under the JAX tool's key
``N{N}_D{D}_chi{chi}``; it never writes the JAX tool's ``data/flops_model.json``
(XLA's count of the JAX programs). It runs on the card unless ``--device cpu``
is given, and both give the same integers.

What is counted: a count of the work, not of one implementation. One call of
the sweep BP runs at that D (``algo/bp.bp_mode``: batched, per side or
single-layer) from uniform messages at χ_msg, contracting at χ; and one
``fused.edge_update`` of edge (A,B) at χ_env = 2D²+10, ``als_iters=10``,
dt=1e-3, the AFM Heisenberg gate, on the same messages. The cell is
``convert.numpy_random_cell(D, 0)`` in complex64. As in the JAX tool, the
sweep takes the cell's fused tensors as given (K1 is not in it), the update
makes its own.

Units: real floating-point operations. A complex multiply-add is 8, a real
one 2. Each total comes with its split by kind:

* ``gemm`` — aten's matrix products as ``torch.utils.flop_counter`` counts
  them (2 per multiply-add: mm, addmm, bmm, baddbmm), ×4 in a complex dtype.
  Matrix-vector products and dot products are not in its table and are not
  counted. ``xla_convention_gemm`` is the same products at 2 per multiply-add
  whatever the dtype: the unit of XLA's ``cost_analysis``, which
  ``data/flops_model.json`` holds.
* ``qr``, ``svd``, ``eigh``, ``cholesky_trsm`` — every ``torch.linalg``
  factorisation and solve, by a closed form in its shape, from LAPACK Working
  Note 41 (LAWN 41: Blackford & Dongarra, "Installation guide for LAPACK",
  its operation counts) and Golub & Van Loan, *Matrix Computations*, 4th ed.
  The count is the work of the function, not of the iterations one solver
  takes (Jacobi or QR sweeps). For a [..., m, n] input, each matrix of the
  batch:

  - ``linalg_qr``, k = min(m, n): ``geqrf(m, n)``, plus ``ungqr(m, k, k)``
    for the reduced Q or ``ungqr(m, m, k)`` for the complete one (LAWN 41);
  - ``_linalg_svd``, m ≥ n (else transposed): the R-SVD (Golub & Van Loan
    Fig. 8.6.1): 6mn² + 20n³ for Σ, U₁ and V; 4m²n + 22n³ for full U; 2mn² +
    2n³ for Σ alone;
  - ``_linalg_eigh``: 9n³ with the eigenvectors, 4n³/3 without (the
    symmetric QR algorithm, Golub & Van Loan §8.3.5);
  - ``linalg_pinv`` of an [m, n] matrix: its thin SVD (eigh where
    hermitian) and the product V·S⁺·U† (m·n·min(m, n) multiply-adds, under
    ``gemm``), as torch computes it;
  - ``linalg_cholesky_ex``: ``potrf(n)``; ``linalg_solve_triangular`` of an
    [n, n] factor and n_rhs columns: ``trsm(n, n_rhs)`` (LAWN 41).

  LAWN 41 counts multiplications (FMULS) and additions (FADDS) apart: a real
  count is FMULS + FADDS, a complex one 6·FMULS + 2·FADDS. Golub & Van
  Loan's counts are real; a complex one is 4× as large.
* ``k1``, ``k2`` — the port's two CUDA kernels, counted where their wrappers
  in ``ops/kernels`` are called, and nothing inside them again (on the CPU
  their plain versions' torch ops): K1 d·D⁸ multiply-adds per tensor
  (``fused_tensors``, ``fused_tensor``; its operator form adds the d²·D⁴ of
  op·t per operator); K2 ``potrf(k) + trtri(k)`` per matrix (the Cholesky
  factor and its triangular inverse, ``chol_inv``; 8k³/3 at leading order in
  a complex dtype, the count of PERF.md's bound).

Elementwise work (scaling, conjugation, norms, the QR phase fix) is not
counted. That is one reason the JAX file's XLA count of a sweep, which
counts it, stands above ``xla_convention_gemm`` at small D. The other way,
XLA counts QR and SVD custom calls as nothing. A linear-algebra op outside
the table above is listed under ``uncounted`` by name and number of calls
(``linalg_matrix_exp``, the gate's 4×4 exponential).
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
from collections import Counter
from contextlib import contextmanager
from fractions import Fraction as Fr

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

KINDS = ("gemm", "qr", "svd", "eigh", "cholesky_trsm", "k1", "k2")
DEFAULT_OUT = os.path.join("data", "flops_model_torch.json")
SEED = 0              # the cell's numpy seed, as the JAX tool's PRNGKey(0)
ALS_ITERS = 10        # the JAX tool's edge update (bench.py's ITE configuration)
DT = 1e-3

# --------------------------- closed forms ----------------------------------
# LAWN 41's counts as (FMULS, FADDS), exact rationals


def geqrf(m: int, n: int):
    if m > n:
        return (Fr(n) * (n * (Fr(1, 2) - Fr(n, 3) + m) + m + Fr(23, 6)),
                Fr(n) * (n * (Fr(1, 2) - Fr(n, 3) + m) + Fr(5, 6)))
    return (Fr(m) * (m * (-Fr(1, 2) - Fr(m, 3) + n) + 2 * n + Fr(23, 6)),
            Fr(m) * (m * (-Fr(1, 2) - Fr(m, 3) + n) + n + Fr(5, 6)))


def ungqr(m: int, n: int, k: int):
    return (Fr(k) * (2 * m * n + 2 * n - Fr(5, 3) + k * (Fr(2 * k, 3) - (m + n) - 1)),
            Fr(k) * (2 * m * n + n - m + Fr(1, 3) + k * (Fr(2 * k, 3) - (m + n))))


def potrf(n: int):
    return (Fr(n) * ((Fr(n, 6) + Fr(1, 2)) * n + Fr(1, 3)),
            Fr(n) * (Fr(n, 6) * n - Fr(1, 6)))


def trtri(n: int):
    return (Fr(n) * (n * (Fr(n, 6) + Fr(1, 2)) + Fr(1, 3)),
            Fr(n) * (n * (Fr(n, 6) - Fr(1, 2)) + Fr(1, 3)))


def trsm(m: int, n_rhs: int):
    """A triangular [m, m] factor solved against n_rhs columns."""
    return Fr(n_rhs * m * (m + 1), 2), Fr(n_rhs * m * (m - 1), 2)


def lawn41(counts, complex_: bool) -> Fr:
    """Real flops of LAWN 41 (FMULS, FADDS) pairs."""
    muls = sum(c[0] for c in counts)
    adds = sum(c[1] for c in counts)
    return 6 * muls + 2 * adds if complex_ else muls + adds


def svd_flops(m: int, n: int, compute_uv: bool, full: bool, complex_: bool) -> Fr:
    """Golub & Van Loan's R-SVD of an [m, n] matrix."""
    if m < n:
        m, n = n, m
    if not compute_uv:
        f = Fr(2 * m * n * n + 2 * n ** 3)
    elif full:
        f = Fr(4 * m * m * n + 22 * n ** 3)
    else:
        f = Fr(6 * m * n * n + 20 * n ** 3)
    return 4 * f if complex_ else f


def eigh_flops(n: int, compute_v: bool, complex_: bool) -> Fr:
    f = Fr(9 * n ** 3) if compute_v else Fr(4 * n ** 3, 3)
    return 4 * f if complex_ else f


def qr_flops(m: int, n: int, mode: str, complex_: bool) -> Fr:
    k = min(m, n)
    parts = [geqrf(m, n)]
    if mode == "reduced":
        parts.append(ungqr(m, k, k))
    elif mode == "complete":
        parts.append(ungqr(m, m, k))
    return lawn41(parts, complex_)


def k1_flops(n: int, d: int, D: int, complex_: bool, operator: bool = False) -> Fr:
    """K1 on n tensors [d, D,D,D,D]: d·D⁸ multiply-adds each, and op·t's
    d²·D⁴ in the operator form."""
    macs = n * d * D ** 8 + (n * d * d * D ** 4 if operator else 0)
    return Fr(8 * macs if complex_ else 2 * macs)


def k2_flops(batch: int, k: int, complex_: bool) -> Fr:
    """K2 on `batch` [k, k] grams: the Cholesky factor and its inverse."""
    return batch * lawn41([potrf(k), trtri(k)], complex_)


# ------------------------------ the meter ----------------------------------

_aten = torch.ops.aten
_SKIP = {_aten.is_contiguous.default, _aten.is_contiguous.memory_format,
         _aten.is_strides_like_format.default, _aten.is_non_overlapping_and_dense.default,
         _aten.size.default, _aten.sym_size.default, _aten.stride.default,
         _aten.sym_stride.default, _aten.storage_offset.default,
         _aten.sym_storage_offset.default, _aten.numel.default, _aten.sym_numel.default,
         _aten.dim.default, torch.ops.prim.layout.default}
# the linear-algebra ops the table counts; any other of their family (an
# op named linalg_*, or one of _FAMILY) is listed as uncounted
_COUNTED = {"linalg_qr", "_linalg_svd", "_linalg_eigh", "linalg_pinv", "linalg_cholesky_ex",
            "linalg_solve_triangular"}
_FAMILY = {"cholesky", "cholesky_solve", "cholesky_inverse", "triangular_solve", "geqrf",
           "orgqr", "ormqr", "lu_unpack", "inverse", "pinverse", "svd", "qr"}
_NORMS = {"linalg_vector_norm", "linalg_matrix_norm", "linalg_norm"}


def _batch(shape) -> int:
    return math.prod(shape[:-2])


class FlopMeter(TorchDispatchMode):
    """Counts the work of what runs inside it, by kind (module docstring).

    ``count`` makes it the meter of ``ops/kernels`` while it is entered:
    each kernel wrapper's call is then counted by ``kernel``, and the torch
    ops inside the wrapper are not.
    """

    def __init__(self):
        super().__init__()
        self.flops = Counter({k: Fr(0) for k in KINDS})
        self.xla_gemm = 0
        self.uncounted = Counter()
        self._inside_kernel = 0
        self._values_only = 0
        self._gemm = FlopCounterMode(display=False).flop_registry

    @contextmanager
    def kernel(self, name: str, dtype: torch.dtype, *dims: int):
        complex_ = dtype.is_complex
        if name == "k2":
            self.flops["k2"] += k2_flops(*dims, complex_)
        else:   # "k1", "k1_operator": (n, d, D)
            self.flops["k1"] += k1_flops(*dims, complex_, operator=name == "k1_operator")
        self._inside_kernel += 1
        try:
            yield
        finally:
            self._inside_kernel -= 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _SKIP:
            return NotImplemented
        packet = func._overloadpacket
        name = packet.__name__
        # as FlopCounterMode does: an op it has no count for runs decomposed
        # where it has a decomposition, so that the matrix products inside
        # are seen
        if packet not in self._gemm and name not in _COUNTED and func is not torch.ops.prim.device.default:
            with self:
                out = func.decompose(*args, **kwargs)
                if out is not NotImplemented:
                    return out
        out = func(*args, **kwargs)
        if not self._inside_kernel:
            self._count(packet, name, args, kwargs, out)
        return out

    def _count(self, packet, name, args, kwargs, out) -> None:
        if packet in self._gemm:
            xla = self._gemm[packet](*args, **kwargs, out_val=out)
            self.xla_gemm += xla
            self.flops["gemm"] += 4 * xla if args[0].dtype.is_complex else xla
            return
        a = args[0] if args and isinstance(args[0], torch.Tensor) else None
        if a is None:
            return
        complex_ = a.dtype.is_complex
        b, shape = _batch(a.shape), a.shape
        if name == "linalg_qr":
            mode = args[1] if len(args) > 1 else kwargs.get("mode", "reduced")
            self.flops["qr"] += b * qr_flops(shape[-2], shape[-1], mode, complex_)
        elif name == "_linalg_svd":
            full = args[1] if len(args) > 1 else kwargs.get("full_matrices", False)
            uv = args[2] if len(args) > 2 else kwargs.get("compute_uv", True)
            self.flops["svd"] += b * svd_flops(shape[-2], shape[-1], uv, full, complex_)
        elif name == "_linalg_eigh":
            v = args[2] if len(args) > 2 else kwargs.get("compute_v", True)
            self.flops["eigh"] += b * eigh_flops(shape[-1], v and not self._values_only, complex_)
        elif name == "linalg_pinv":
            # the SVD of A [m, n] (eigh where hermitian), then V·S⁺·U† with
            # k = min(m, n)
            m, n = shape[-2], shape[-1]
            k = min(m, n)
            if kwargs.get("hermitian", False):
                self.flops["eigh"] += b * eigh_flops(n, True, complex_)
            else:
                self.flops["svd"] += b * svd_flops(m, n, True, False, complex_)
            self.xla_gemm += b * 2 * m * n * k
            self.flops["gemm"] += b * (8 if complex_ else 2) * m * n * k
        elif name == "linalg_cholesky_ex":
            self.flops["cholesky_trsm"] += b * lawn41([potrf(shape[-1])], complex_)
        elif name == "linalg_solve_triangular":
            rhs = args[1]
            left = kwargs.get("left", True)
            batch = _batch(torch.broadcast_shapes(shape[:-2], rhs.shape[:-2]) + (1, 1))
            n_rhs = rhs.shape[-1] if left else rhs.shape[-2]
            self.flops["cholesky_trsm"] += batch * lawn41([trsm(shape[-1], n_rhs)], complex_)
        elif name not in _NORMS and (name.startswith(("linalg_", "_linalg_")) or name in _FAMILY):
            self.uncounted[name] += 1

    def record(self) -> dict:
        """The total and its split, as integers (each kind rounded once)."""
        split = {k: int(round(v)) for k, v in self.flops.items()}
        split["xla_convention_gemm"] = int(self.xla_gemm)
        return {"total": sum(split[k] for k in KINDS), "split": split,
                "uncounted": dict(self.uncounted)}


class _ValuesOnly(TorchFunctionMode):
    """Marks the calls of ``torch.linalg.eigvalsh``: under a dispatch mode
    torch computes its eigenvectors too, but the function's work is that of
    the values."""

    def __init__(self, meter: FlopMeter):
        super().__init__()
        self.meter = meter

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func is not torch.linalg.eigvalsh:
            return func(*args, **(kwargs or {}))
        self.meter._values_only += 1
        try:
            return func(*args, **(kwargs or {}))
        finally:
            self.meter._values_only -= 1


def count(fn, *args, **kwargs):
    """(fn's result, its count record) for one call of fn under a FlopMeter."""
    from ..ops import kernels

    if kernels.FLOP_METER is not None:
        raise RuntimeError("a FlopMeter is already counting")
    meter = FlopMeter()
    kernels.FLOP_METER = meter
    try:
        with torch.no_grad(), _ValuesOnly(meter), meter:
            out = fn(*args, **kwargs)
    finally:
        kernels.FLOP_METER = None
    return out, meter.record()


# ----------------------------- the model -----------------------------------


def inputs(N: int, D: int, chi_msg: int, device, dtype=torch.complex64):
    """(cell, message sites): the numpy-seeded cell and uniform messages."""
    from ..algo import contraction as C
    from ..algo import fused as F
    from ..convert import numpy_random_cell, unit_cell_from_numpy

    cell = unit_cell_from_numpy(numpy_random_cell(D, SEED), device, dtype)
    sites = F._msgs_to_sites(C.initial_messages(N, D, chi_msg, dtype=dtype, device=device))
    return cell, sites


def sweep_fn(N: int, D: int, chi: int, chi_msg: int, mode: str):
    """The sweep of `mode` ("batched", "double" per side, "single") as
    (tensors of the cell, message sites) → (sites, distance)."""
    from ..algo import batched as B
    from ..algo import fused as F

    if mode == "batched":
        return B.bp_iteration_batched(N, D, chi, chi_msg, None)
    return F.bp_iteration(N, D, chi, chi_msg, None, single=mode == "single")


def sweep_tensors(cell, mode: str):
    from ..algo import contraction as C

    return C.site_kets(cell) if mode == "single" else C.fused_cells(cell)


def default_mode(D: int, chi: int, dtype=torch.complex64) -> str:
    from ..algo import bp as BP

    return BP.bp_mode(BP.BPConfig(trunc_dim=chi, dtype=dtype), D)


def count_sweep(N: int, D: int, chi: int, chi_msg: int, device, mode: str | None = None) -> dict:
    """The count record of one sweep of `mode` (default: BP's own choice)."""
    mode = mode or default_mode(D, chi_msg)
    cell, sites = inputs(N, D, chi_msg, device)
    with torch.no_grad():
        tensors = sweep_tensors(cell, mode)
    _, rec = count(sweep_fn(N, D, chi, chi_msg, mode), tensors, sites)
    rec["mode"] = mode
    return rec


def count_ite(N: int, D: int, chi_msg: int, device) -> dict:
    """The count record of one edge update of (A,B) at χ_env = 2D²+10."""
    from ..algo import fused as F
    from ..enums import UnitCellFlavor, UpdateEdge
    from ..physics.hamiltonians import heisenberg_afm

    chi_env = 2 * D * D + 10
    cell, sites = inputs(N, D, chi_msg, device)
    h = torch.as_tensor(heisenberg_afm(), dtype=cell.A.dtype, device=cell.A.device)
    edge = UpdateEdge(UnitCellFlavor.A, UnitCellFlavor.B)
    update = F.edge_update(N, D, chi_env, chi_msg, edge, ALS_ITERS, True)
    _, rec = count(update, (cell.A, cell.B, cell.C), sites, h, DT)
    rec["chi_env"] = chi_env
    return rec


def _device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def model(N: int, D: int, chi: int, chi_msg: int | None = None, device="cuda") -> dict:
    """The JAX tool's record, in real flops, with the split of each total."""
    from ..measure import setup_device

    device = setup_device(device)
    chi_msg = chi_msg or chi
    sweep = count_sweep(N, D, chi, chi_msg, device)
    ite = count_ite(N, D, chi_msg, device)
    return {
        "config": {"N": N, "D": D, "chi": chi, "chi_msg": chi_msg, "chi_env": ite["chi_env"],
                   "dtype": "complex64", "bp_mode": sweep["mode"]},
        "flops_per_bp_sweep": sweep["total"],
        "flops_per_ite_step": ite["total"],
        "bp_sweep_split": sweep["split"],
        "ite_step_split": ite["split"],
        "uncounted": {"bp_sweep": sweep["uncounted"], "ite_step": ite["uncounted"]},
        "source": "kagomeperiodicbp_tpu_torch.tools.flops_model: real flops of the port's "
                  "calls (GEMMs by torch.utils.flop_counter x4 complex; linalg by LAWN 41 and "
                  "Golub & Van Loan closed forms; K1, K2 by formula)",
        "device": _device_name(device),
        "measured_at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
    }


def merge(out: str, key: str, rec: dict) -> None:
    """Merge `rec` into the JSON file `out` under `key`."""
    if os.path.basename(out) == "flops_model.json":
        raise SystemExit(f"{out}: that file holds the JAX tool's XLA count; write elsewhere")
    try:
        with open(out) as fh:
            recs = json.load(fh)
    except FileNotFoundError:
        recs = {}
    recs[key] = rec
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as fh:
        json.dump(recs, fh, indent=1)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-N", type=int, default=2)
    p.add_argument("-D", type=int, default=3)
    p.add_argument("--chi", type=int, default=18)
    p.add_argument("--chi-msg", type=int, default=None)
    p.add_argument("--device", default="cuda", help="cuda (default) | cpu")
    p.add_argument("--out", default=DEFAULT_OUT)
    args = p.parse_args(argv)

    rec = model(args.N, args.D, args.chi, args.chi_msg, args.device)
    merge(args.out, f"N{args.N}_D{args.D}_chi{args.chi}", rec)
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
