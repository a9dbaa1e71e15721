"""The port's two hand-written CUDA kernels, their plain PyTorch versions,
and the build that turns ``csrc/*.cu`` into a shared library.

* K1 ``fused_tensor`` — the double-layer tensor of one site
  (``csrc/fused_tensor.cu``; replaces ``fused_tensor_pallas``).
* K2 ``chol_inv`` — Cholesky factor L of a Hermitian PSD G and W = L⁻¹
  (``csrc/chol_inv.cu``; replaces ``chol_inv_pallas``).

Dispatch rule, the same for both: a tensor on the CPU takes the plain
version; a CUDA tensor launches the kernel or raises. Nothing falls back.

The library is compiled with ``nvcc`` for ``sm_90a`` at first use, into
``kagomeperiodicbp_tpu_torch/_build/``, under a name keyed by a hash of the
sources, and bound with ``ctypes`` (a plain C interface: no PyTorch headers,
so the build takes seconds). Each ``*_cuda`` wrapper counts its launches in
its ``launches`` attribute.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Tuple

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
_SOURCES = ("fused_tensor.cu", "chol_inv.cu")
_HEADERS = ("common.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

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
        cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), *(str(CSRC / s) for s in _SOURCES)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
        if verbose:
            print(res.stdout + res.stderr)
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.kpbp_fused_tensor.argtypes = [p, p, i, i, i, p]
    lib.kpbp_fused_tensor.restype = i
    lib.kpbp_chol_inv.argtypes = [p, p, p, p, i, i, i, p]
    lib.kpbp_chol_inv.restype = i
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


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


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


def fused_tensor_cuda(t: torch.Tensor) -> torch.Tensor:
    """K1 on the card: t contiguous [d, D,D,D,D] → [D²,D²,D²,D²]."""
    code = _check_cuda(t, "fused_tensor_cuda")
    if t.ndim != 5 or len(set(t.shape[1:])) != 1:
        raise ValueError(f"fused_tensor_cuda: expected [d, D,D,D,D], got {tuple(t.shape)}")
    d, D = t.shape[0], t.shape[1]
    out = torch.empty((D * D,) * 4, dtype=t.dtype, device=t.device)
    rc = build().kpbp_fused_tensor(t.data_ptr(), out.data_ptr(), d, D, code, _stream())
    fused_tensor_cuda.launches += 1
    _raise_on(rc, "fused_tensor_cuda")
    return out


fused_tensor_cuda.launches = 0


def fused_tensor(t: torch.Tensor) -> torch.Tensor:
    if t.device.type == "cpu":
        return fused_tensor_ref(t)
    return fused_tensor_cuda(t.contiguous())


# ------------------------------- K2 ---------------------------------------


def chol_inv_ref(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(L, W): G = L·L† with L lower triangular, and W = L⁻¹."""
    l = torch.linalg.cholesky(g)
    eye = torch.eye(g.shape[-1], dtype=g.dtype, device=g.device).expand_as(g)
    w = torch.linalg.solve_triangular(l, eye, upper=False)
    return l, w


def chol_inv_cuda(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2 on the card: g contiguous [k, k] or [batch, k, k], one thread block
    per matrix. Reads the lower triangle of each G."""
    code = _check_cuda(g, "chol_inv_cuda")
    if g.ndim not in (2, 3) or g.shape[-1] != g.shape[-2]:
        raise ValueError(f"chol_inv_cuda: expected [k,k] or [b,k,k], got {tuple(g.shape)}")
    k = g.shape[-1]
    batch = g.shape[0] if g.ndim == 3 else 1
    if k * g.element_size() > 48 * 1024:
        raise ValueError(f"chol_inv_cuda: k={k} column exceeds the 48 KB shared-memory default")
    scratch = torch.empty_like(g)
    l = torch.empty_like(g)
    w = torch.empty_like(g)
    rc = build().kpbp_chol_inv(g.data_ptr(), scratch.data_ptr(), l.data_ptr(),
                               w.data_ptr(), k, batch, code, _stream())
    chol_inv_cuda.launches += 1
    _raise_on(rc, "chol_inv_cuda")
    return l, w


chol_inv_cuda.launches = 0


def chol_inv(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    if g.device.type == "cpu":
        return chol_inv_ref(g)
    return chol_inv_cuda(g.contiguous())


# ------------------------------ counters ----------------------------------

KERNELS = {"fused_tensor": fused_tensor_cuda, "chol_inv": chol_inv_cuda}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}
