"""The port's two hand-written CUDA kernels, their plain PyTorch versions,
and the build that turns ``csrc/*.cu`` into a shared library.

* K1 ``fused_tensor`` — the double-layer tensor of one site
  (``csrc/fused_tensor.cu``; replaces ``fused_tensor_pallas``);
  ``fused_tensors`` makes those of a whole cell (up to three flavours) in
  one launch. Both read their inputs through the inputs' own strides. Its
  operator form, ``fused_tensors_with_operator``, gives the kernel a bra
  apart from the ket: the sandwiches ⟨ψ| op |ψ⟩ of up to three operators
  at one site in one launch.
* K2 ``chol_inv`` — Cholesky factor L of a Hermitian PSD G and W = L⁻¹
  (``csrc/chol_inv.cu``; replaces ``chol_inv_pallas``), in three variants
  that ``chol_inv_plan`` picks from k: ``resident`` (the matrix in one
  block's shared memory, k ≤ ``CHOL_RESIDENT_MAX_K``), ``blocked`` (one
  launch per 32-wide tile column, each spread over many SMs) and, from
  ``CHOL_TILED_MIN_K`` (by dtype), ``tiled`` (per 64-wide tile column, 128-wide from
  ``CHOL_WIDE_MIN_K`` but in complex128: the diagonal tile factored once,
  the panel solved once by substitution, and one register-tiled complex
  GEMM for the trailing and inverse updates).

Dispatch rule, the same for both: a tensor on the CPU takes the plain
version; a CUDA tensor launches the kernel or raises. Nothing falls back.

The library is compiled with ``nvcc`` for ``sm_90a`` at first use, into
``kagomeperiodicbp_tpu_torch/_build/``, under a name keyed by a hash of the
sources, and bound with ``ctypes`` (a plain C interface: no PyTorch headers,
so the build takes seconds). K1's wrappers count their launches in
``FUSED_TENSOR.launches`` (ket = bra) and ``FUSED_TENSOR_OPERATOR.launches``
(a separate bra), ``chol_inv_cuda`` in those of the variant it ran
(``CHOL_INV_VARIANTS``); ``launch_counts`` reads them by kernel name.
``chol_inv`` is the operator ``kpbp::chol_inv`` of ``torch.library``, with a
vmap rule that hands K2 all mapped copies in one call. While
``tools/flops_model`` counts, each wrapper tells its meter (``FLOP_METER``)
the shapes of its call, on either device (``_metered``).
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import math
import os
import shutil
import struct
import subprocess
from functools import lru_cache
from pathlib import Path
from types import SimpleNamespace
from typing import NamedTuple, Sequence, Tuple

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
_SOURCES = ("fused_tensor.cu", "chol_inv.cu", "chol_inv_tiled.cu")
_HEADERS = ("common.cuh", "chol_inv_tiled.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_DTYPE_CODE = {torch.float32: 0, torch.float64: 1, torch.complex64: 2, torch.complex128: 3}

_lib = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cand = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else shutil.which("nvcc")
    if not cand or not os.path.exists(cand):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return cand


def library_path() -> Path:
    """Where the library built from the current sources lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in _SOURCES + _HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libkpbp_kernels_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> ctypes.CDLL:
    """Compile (if the hashed library is missing) and load the kernels."""
    global _lib
    if _lib is not None:
        return _lib
    out = library_path()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        nvcc = _nvcc()
        objs = [tmp.with_suffix(f".{src}.o") for src in _SOURCES]
        # one nvcc per source, all at once; then one link
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
                                   "-c", "-o", str(obj), str(CSRC / src)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(_SOURCES, objs)]
        logs = [proc.communicate()[0] for proc in procs]
        for src, proc, log in zip(_SOURCES, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src} ({proc.returncode}):\n{log}")
            if verbose:
                print(log)
        res = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                             capture_output=True, text=True)
        for obj in objs:
            obj.unlink()
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{res.stderr}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.kpbp_fused_tensors.argtypes = [_FusedArgs, i, i, i, i, p]
    lib.kpbp_fused_tensors.restype = i
    lib.kpbp_chol_inv.argtypes = [p, p, p, p, i, i, i, i, p]
    lib.kpbp_chol_inv.restype = i
    for query in (lib.kpbp_chol_inv_smem, lib.kpbp_chol_inv_launches, lib.kpbp_chol_inv_scratch):
        query.argtypes = [i, i, i]
        query.restype = ctypes.c_longlong
    _lib = lib
    return lib


def _check_cuda(x: torch.Tensor, who: str) -> int:
    if x.device.type != "cuda":
        raise ValueError(f"{who}: expected a CUDA tensor, got {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{who}: unsupported dtype {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{who}: input must be contiguous")
    return _DTYPE_CODE[x.dtype]


def _stream(x: torch.Tensor) -> int:
    """The raw handle of the current stream on x's device. The handle alone,
    as PyTorch's own generated code takes it: on an H100 host, building the
    ``torch.cuda.Stream`` object cost 7.6–9.3 µs per launch and this
    0.1–0.4 µs (PERF.md)."""
    return torch._C._cuda_getCurrentRawStream(x.get_device())


def _raise_on(rc: int, who: str):
    if rc != 0:
        raise RuntimeError(f"{who}: kernel launch failed with cudaError {rc}")


# ------------------------------- K1 ---------------------------------------


def fused_tensor_ref(t: torch.Tensor) -> torch.Tensor:
    """ket ⊗ bra with ket-bra leg pairs fused: [d, D,D,D,D] → [D²,D²,D²,D²]."""
    D = t.shape[1]
    tt = torch.tensordot(t, t.conj(), dims=([0], [0]))  # [D]*4 + [D*]*4
    tt = tt.permute(0, 4, 1, 5, 2, 6, 3, 7)
    return tt.reshape(D * D, D * D, D * D, D * D)


def fused_tensors_ref(ts: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    return tuple(fused_tensor_ref(t) for t in ts)


def fused_tensor_with_operator_ref(t: torch.Tensor, op: torch.Tensor) -> torch.Tensor:
    """The ket–op–bra sandwich of one site with fused ket-bra pairs:
    [d, D,D,D,D] + op [d, d] → [D²,D²,D²,D²], the double-layer tensor of
    ⟨ψ| op |ψ⟩ there."""
    D = t.shape[1]
    t_op = torch.tensordot(op.to(t.dtype), t, dims=([1], [0]))
    tt = torch.tensordot(t_op, t.conj(), dims=([0], [0]))
    tt = tt.permute(0, 4, 1, 5, 2, 6, 3, 7)
    return tt.reshape(D * D, D * D, D * D, D * D)


class _FusedArgs(ctypes.Structure):
    """csrc/fused_tensor.cu FusedTensorsArgs: up to three kets and as many
    bras (pointer, strides in elements) and the output buffer, passed by
    value."""
    _fields_ = [("t", ctypes.c_void_p * 3), ("stride", (ctypes.c_longlong * 5) * 3),
                ("bra", ctypes.c_void_p * 3), ("bra_stride", (ctypes.c_longlong * 5) * 3),
                ("out", ctypes.c_void_p)]


# the same 37 fields packed in one call: several times cheaper per launch
# than building _FusedArgs from nested tuples
_FUSED_ARGS = struct.Struct("<3q15q3q15qq")
# K1 stages 2·d·D² input elements per block in shared memory
_K1_SMEM_MAX = 48 * 1024


def _fused_dims(ts: Sequence[torch.Tensor], who: str) -> Tuple[int, int]:
    """(d, D) of one cell's 1 to 3 tensors, all of one shape [d, D,D,D,D]."""
    if not 1 <= len(ts) <= 3:
        raise ValueError(f"{who}: takes 1 to 3 tensors, got {len(ts)}")
    shape = ts[0].shape
    if len(shape) != 5 or not shape[1] == shape[2] == shape[3] == shape[4]:
        raise ValueError(f"{who}: expected [d, D,D,D,D], got {tuple(shape)}")
    for t in ts[1:]:
        if t.shape != shape:
            raise ValueError(f"{who}: the flavours differ in shape, {tuple(shape)} and {tuple(t.shape)}")
    return shape[0], shape[1]


def _fused_launch(ts: Sequence[torch.Tensor], lead: Tuple[int, ...], who: str,
                  bras: Sequence[torch.Tensor] = ()) -> torch.Tensor:
    """One K1 launch: Σ_s ts[f] ⊗ conj(bras[f]) with the leg pairs fused,
    for every f, into one new contiguous tensor of shape lead + [D²]*4
    (lead is () or (len(ts),)); without `bras` each ket is its own bra
    (fused_tensor_ref). Each input is read through its own strides."""
    d, D = _fused_dims(ts, who)
    if bras and (len(bras) != len(ts) or any(b.shape != ts[0].shape for b in bras)):
        raise ValueError(f"{who}: the bras must match the kets in number and shape")
    t0 = ts[0]
    dtype, device = t0.dtype, t0.get_device()
    ptrs, strides = [0, 0, 0], [0] * 15
    for f, t in enumerate(ts):
        _fused_input(t, dtype, device, who)
        ptrs[f] = t.data_ptr()
        strides[5 * f:5 * f + 5] = t.stride()
    if bras:
        bra_ptrs, bra_strides = [0, 0, 0], [0] * 15
        for f, t in enumerate(bras):
            _fused_input(t, dtype, device, who)
            bra_ptrs[f] = t.data_ptr()
            bra_strides[5 * f:5 * f + 5] = t.stride()
    else:
        bra_ptrs, bra_strides = ptrs, strides
    code = _DTYPE_CODE.get(dtype)
    if code is None:
        raise TypeError(f"{who}: unsupported dtype {dtype}")
    if 2 * d * D * D * t0.element_size() > _K1_SMEM_MAX:
        raise ValueError(f"{who}: d={d}, D={D} stages more than {_K1_SMEM_MAX} B per block")
    out = torch.empty(lead + (D * D,) * 4, dtype=dtype, device=t0.device)
    args = _FusedArgs.from_buffer_copy(
        _FUSED_ARGS.pack(*ptrs, *strides, *bra_ptrs, *bra_strides, out.data_ptr()))
    rc = build().kpbp_fused_tensors(args, len(ts), d, D, code, _stream(t0))
    (FUSED_TENSOR_OPERATOR if bras else FUSED_TENSOR).launches += 1
    _raise_on(rc, who)
    return out


def _fused_input(t: torch.Tensor, dtype: torch.dtype, device: int, who: str) -> None:
    if not t.is_cuda:
        raise ValueError(f"{who}: expected CUDA tensors, got {t.device}")
    if t.dtype != dtype or t.get_device() != device:
        raise TypeError(f"{who}: the flavours differ in dtype or device")


def fused_tensor_cuda(t: torch.Tensor) -> torch.Tensor:
    """K1 on the card: t [d, D,D,D,D], any strides → [D²,D²,D²,D²]."""
    return _fused_launch((t,), (), "fused_tensor_cuda")


def fused_tensors_cuda(ts: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """K1 on the card for one cell: 1 to 3 tensors [d, D,D,D,D] of one
    shape and dtype, any strides, in one launch → one [D²,D²,D²,D²] each."""
    return _fused_launch(ts, (len(ts),), "fused_tensors_cuda").unbind(0)


def _operator_stack(ops, t: torch.Tensor) -> torch.Tensor:
    """ops — a [n, d, d] tensor or a sequence of [d, d] arrays — as one
    [n, d, d] tensor of t's dtype on t's device."""
    if not isinstance(ops, torch.Tensor):
        ops = torch.stack([torch.as_tensor(op) for op in ops])
    return ops.to(device=t.device, dtype=t.dtype)


def fused_tensors_with_operator_cuda(t: torch.Tensor, ops) -> Tuple[torch.Tensor, ...]:
    """K1's operator form on the card: the sandwich of each of 1 to 3
    operators [d, d] (a [n, d, d] tensor or a sequence) at the site
    t [d, D,D,D,D] (any strides), in one launch. The kets op·t come from
    one matrix product, outside the kernel; the bra is t itself."""
    ops = _operator_stack(ops, t)
    n, d = ops.shape[0], t.shape[0]
    kets = (ops.reshape(n * d, d) @ t.reshape(d, -1)).reshape((n,) + tuple(t.shape))
    return _fused_launch(kets.unbind(0), (n,), "fused_tensors_with_operator_cuda",
                         bras=(t,) * n).unbind(0)


# the launch counts of K1: ket = bra (fused_tensor_cuda, fused_tensors_cuda)
# and its operator form with a separate bra (fused_tensors_with_operator_cuda)
FUSED_TENSOR = SimpleNamespace(launches=0)
FUSED_TENSOR_OPERATOR = SimpleNamespace(launches=0)


def fused_tensor(t: torch.Tensor) -> torch.Tensor:
    with _metered("k1", t.dtype, 1, t.shape[0], t.shape[1]):
        if t.is_cpu:
            return fused_tensor_ref(t)
        return fused_tensor_cuda(t)


def fused_tensors(ts: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """The fused tensors of a cell's 1 to 3 flavours: one K1 launch on the
    card, the plain version on the CPU."""
    d, D = _fused_dims(ts, "fused_tensors")
    with _metered("k1", ts[0].dtype, len(ts), d, D):
        if ts[0].is_cpu:
            return fused_tensors_ref(ts)
        return fused_tensors_cuda(ts)


def fused_tensors_with_operator(t: torch.Tensor, ops) -> Tuple[torch.Tensor, ...]:
    """The sandwiches of 1 to 3 operators (a [n, d, d] tensor or a sequence
    of [d, d] arrays) at the site t: one K1 launch on the card, the plain
    version on the CPU."""
    ops = _operator_stack(ops, t)
    d, D = _fused_dims((t,) * len(ops), "fused_tensors_with_operator")
    with _metered("k1_operator", t.dtype, len(ops), d, D):
        if t.is_cpu:
            return tuple(fused_tensor_with_operator_ref(t, op) for op in ops)
        return fused_tensors_with_operator_cuda(t, ops)


# ------------------------------- K2 ---------------------------------------


def chol_inv_ref(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(L, W): G = L·L† with L lower triangular, and W = L⁻¹."""
    l = torch.linalg.cholesky(g)
    eye = torch.eye(g.shape[-1], dtype=g.dtype, device=g.device).expand_as(g)
    w = torch.linalg.solve_triangular(l, eye, upper=False)
    return l, w


# Shared memory one block may take on Hopper (227 KB), and the blocked
# variant's tile width (csrc/chol_inv.cu NB).
SMEM_MAX = 232_448
CHOL_NB = 32
# The largest k that takes the resident variant, in every dtype: where the
# two variants' times cross on the card (chip_smoke.py phase 3 times both
# side by side; PERF.md). The blocked variant factors its diagonal tile in
# registers and wins from k≈32, though the resident one fits one block's
# shared memory up to k·(k|1) elements (120 in complex128, 169 in
# complex64 and float64, 241 in float32).
CHOL_RESIDENT_MAX_K = 24
# The smallest k that takes the tiled variant, by dtype: where the blocked
# and tiled variants' times cross on the card (chip_smoke.py phase 3 times
# them side by side; PERF.md): between k=1296 and 1600 in complex64,
# between 1152 and 1296 in complex128, whose blocked variant runs at the
# FP64 rate; the real types follow their complex twins.
CHOL_TILED_MIN_K = {torch.float32: 1600, torch.complex64: 1600,
                    torch.float64: 1296, torch.complex128: 1296}
# The tiled variant (csrc/chol_inv.cu, namespace tiled): its default tile
# width, 64, and 128 for 4- and 8-byte types from CHOL_WIDE_MIN_K (a
# 128-wide complex128 diagonal tile does not fit one block; chip_smoke.py
# phase 3 times both widths: in complex64 64 is faster at k=4096, 128 at
# 5292), the rows (or W columns) of one panel block, and its update's
# output tile (TM by element size, × TN), slice depth and ring of stages.
CHOL_WIDE_MIN_K = 4608
_TILED_CHUNK = 64
_TILED_TM = {4: 128, 8: 128, 16: 64}
_TILED_TN = 64
_TILED_KC = 16
_TILED_STAGES = 3


class CholInvPlan(NamedTuple):
    variant: str      # "resident", "blocked" or "tiled"
    smem_bytes: int   # dynamic shared memory of the largest block
    launches: int     # CUDA launches one call enqueues
    scratch: int      # scratch elements per matrix
    tile: int = 0     # tile width (blocked, tiled)


def _tiled_smem(nb: int, size: int, real: int) -> Tuple[int, int, int]:
    """Shared memory of the tiled variant's three blocks at tile width nb:
    the diagonal factor, a panel block and an update block (csrc/chol_inv.cu
    tiled::diag_smem, panel_smem, update_smem)."""
    diag = nb * (nb + 1) * size + nb * real
    stage = max(_TILED_CHUNK * (nb + 1), nb * (_TILED_CHUNK + 1))
    panel = (nb * nb + stage) * size + nb * real
    update = _TILED_STAGES * _TILED_KC * (_TILED_TM[size] + _TILED_TN) * size
    return diag, panel, update


@lru_cache(maxsize=None)
def chol_inv_plan(k: int, dtype: torch.dtype, variant: str = "", tile: int = 0) -> CholInvPlan:
    """How K2 runs a [k, k] gram of `dtype` on the card: ``resident`` up to
    ``CHOL_RESIDENT_MAX_K``, ``blocked`` below ``CHOL_TILED_MIN_K[dtype]``,
    ``tiled`` from there. ``variant`` forces one and ``tile`` the tiled variant's
    width, 64 or 128 (chip_smoke.py times them side by side); a resident
    matrix or a tile that does not fit one block raises."""
    size = torch.empty((), dtype=dtype).element_size()
    real = size // 2 if dtype.is_complex else size
    variant = variant or ("resident" if k <= CHOL_RESIDENT_MAX_K
                          else "blocked" if k < CHOL_TILED_MIN_K[dtype] else "tiled")
    if tile and variant != "tiled":
        raise ValueError(f"chol_inv: only the tiled variant takes a tile width, not {variant!r}")
    if variant == "resident":
        smem = k * (k | 1) * size
        if smem > SMEM_MAX:
            raise ValueError(f"chol_inv: k={k} in {dtype} needs {smem} B of shared memory "
                             f"resident, above the {SMEM_MAX} B a block can take")
        return CholInvPlan("resident", smem, 1, 0)
    if variant == "blocked":
        smem = (3 * CHOL_NB * (CHOL_NB + 1) + 2 * CHOL_NB) * size + 2 * CHOL_NB * real
        return CholInvPlan("blocked", smem, -(-k // CHOL_NB), 2 * k * k, CHOL_NB)
    if variant != "tiled":
        raise ValueError(f"chol_inv: unknown variant {variant!r}")
    nb = tile or (128 if size <= 8 and k >= CHOL_WIDE_MIN_K else 64)
    if nb not in (64, 128):
        raise ValueError(f"chol_inv: the tiled variant takes a tile of 64 or 128, not {nb}")
    diag, panel, update = _tiled_smem(nb, size, real)
    smem = max(diag, panel, update)
    if smem > SMEM_MAX:
        raise ValueError(f"chol_inv: a tile of {nb} in {dtype} needs {smem} B of shared memory, "
                         f"above the {SMEM_MAX} B a block can take")
    # per tile column a diagonal factor, a panel and (but the last) an
    # update; at nb = 64 the update's block at the next diagonal tile
    # factors it (tiled::fuses_diag), so only tile column 0 has a factor launch
    nt = -(-k // nb)
    fused = nb == _TILED_TN and diag <= update
    return CholInvPlan("tiled", smem, 2 * nt if fused else 3 * nt - 1, nb * k + nb * nb + 2 * nb, nb)


_VARIANT_CODE = {"resident": 0, "blocked": 1, "tiled": 2}


def _variant_code(plan: CholInvPlan) -> int:
    """csrc/chol_inv.cu's variant code; the tiled one carries its tile width
    in bits 8 and up."""
    code = _VARIANT_CODE[plan.variant]
    return code | plan.tile << 8 if plan.variant == "tiled" else code


def chol_inv_cuda(g: torch.Tensor, variant: str = "", tile: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2 on the card: g contiguous [k, k] or [batch, k, k]; reads the lower
    triangle of each G. One C call enqueues the plan's launches on the
    current stream; the variant's wrapper counts the call."""
    code = _check_cuda(g, "chol_inv_cuda")
    if g.ndim not in (2, 3) or g.shape[-1] != g.shape[-2] or g.shape[-1] < 1:
        raise ValueError(f"chol_inv_cuda: expected [k,k] or [b,k,k], got {tuple(g.shape)}")
    k = g.shape[-1]
    batch = g.shape[0] if g.ndim == 3 else 1
    plan = chol_inv_plan(k, g.dtype, variant, tile)
    if plan.variant != "resident" and batch > 65535:
        raise ValueError(f"chol_inv_cuda: the {plan.variant} variant takes at most 65535 matrices, "
                         f"got {batch}")
    scratch = torch.empty(batch * plan.scratch, dtype=g.dtype, device=g.device) if plan.scratch else None
    l = torch.empty_like(g)
    w = torch.empty_like(g)
    rc = build().kpbp_chol_inv(g.data_ptr(), scratch.data_ptr() if scratch is not None else None,
                               l.data_ptr(), w.data_ptr(), k, batch, code, _variant_code(plan), _stream(g))
    CHOL_INV_VARIANTS[plan.variant].launches += 1
    _raise_on(rc, f"chol_inv_cuda ({plan.variant})")
    return l, w


# the launch count of each K2 variant (all go through chol_inv_cuda)
CHOL_INV_VARIANTS = {"resident": SimpleNamespace(launches=0),
                     "blocked": SimpleNamespace(launches=0),
                     "tiled": SimpleNamespace(launches=0)}


@torch.library.custom_op("kpbp::chol_inv", mutates_args=())
def _chol_inv_op(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2 as one operator of PyTorch's, so that ``torch.func.vmap`` can run
    it: the plain version on the CPU, the kernel on the card."""
    with _metered("k2", g.dtype, math.prod(g.shape[:-2]), g.shape[-1]):
        if g.device.type == "cpu":
            return chol_inv_ref(g)
        return chol_inv_cuda(g.contiguous())


@_chol_inv_op.register_vmap
def _chol_inv_vmap(info, in_dims, g):
    """Under vmap: the mapped dimension moves to the front and folds, with
    any batch g already has, into K2's own batch axis, so the whole map is
    one call of the operator (one C call on the card, on the [batch, k, k]
    path)."""
    (bdim,) = in_dims
    if bdim is None:
        return _chol_inv_op(g), (None, None)
    g = g.movedim(bdim, 0)
    k = g.shape[-1]
    l, w = _chol_inv_op(g.reshape(-1, k, k))
    return (l.reshape(g.shape), w.reshape(g.shape)), (0, 0)


def chol_inv(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(L, W = L⁻¹) of a Hermitian PSD g [..., k, k]: the plain version on
    the CPU, K2 on the card; inside ``torch.func.vmap`` the mapped copies go
    to K2 together, in one call."""
    return _chol_inv_op(g)


# ------------------------------ counters ----------------------------------

# The meter of tools/flops_model while it counts (a FlopMeter), else None.
FLOP_METER = None


def _metered(kernel: str, dtype: torch.dtype, *dims: int):
    """The context a wrapper's work runs in: while a meter counts, it counts
    the call by its formula from `dims` and leaves the torch ops inside (the
    plain version's, on the CPU) uncounted, so that both devices give the
    same count."""
    if FLOP_METER is None:
        return contextlib.nullcontext()
    return FLOP_METER.kernel(kernel, dtype, *dims)


KERNELS = {"fused_tensor": FUSED_TENSOR,
           "fused_tensor_operator": FUSED_TENSOR_OPERATOR,
           "chol_inv_resident": CHOL_INV_VARIANTS["resident"],
           "chol_inv_blocked": CHOL_INV_VARIANTS["blocked"],
           "chol_inv_tiled": CHOL_INV_VARIANTS["tiled"]}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}
