"""The work of a step in real flops: a copy of the closed forms and the meter
of ``kagomeperiodicbp_tpu_torch/tools/flops_model.py`` (its docstring gives
the sources: LAPACK Working Note 41 and Golub & Van Loan; a complex
multiply-add is 8 real flops, a real one 2).

The benchmark never counts at run time. ``portbench/tools/count_work.py``
runs one step of a cell under this meter, once, and the integer it prints is
frozen in the configuration's file, so a cell's work stays the same whatever
implements it. ``count`` makes the meter the port's kernel meter
(``ops/kernels.FLOP_METER``) while it runs, so that K1 and K2 are counted by
formula at their wrappers, as in the original.
"""
from __future__ import annotations

import math
from collections import Counter
from contextlib import contextmanager
from fractions import Fraction as Fr

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

KINDS = ("gemm", "qr", "svd", "eigh", "cholesky_trsm", "k1", "k2")

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
    from kagomeperiodicbp_tpu_torch.ops import kernels

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
