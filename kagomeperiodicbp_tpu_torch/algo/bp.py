"""Block Belief Propagation: iterate the 6 boundary-MPS messages of the
hexagonal block to a fixed point (counterpart of
kagomeperiodicbp_tpu/algo/bp.py).

Messages live in a canonical padded bond profile; the 6 outgoing messages
are computed synchronously from the current ones, and the wrap is
``in[S.opposite()] = reverse(out[S])``. Each iteration reads one number back
to the host: the mean message distance that decides termination.

The sweep is chosen as the JAX package chooses it (``bp_mode``):
single-layer (``fused.bp_iteration(single=True)``), on by itself from D=6;
below it the batched sweep (``batched.bp_iteration_batched``: two vmapped
calls, one per symmetry class of sides); or, where the config or the
environment asks, the per-side double-layer sweep (``fused.bp_iteration``).
``KPBP_SINGLE_LAYER=0/1`` and ``KPBP_BP_BATCHED=0/1`` steer only what the
config leaves to auto. A per-site view (``algo/arbitrary``) has no rotation
symmetry and is swept per side.
"""
from __future__ import annotations

import dataclasses
import math
import os
import time
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import torch

from ..lattices import BlockSide
from ..networks.unit_cell import UnitCell
from ..ops import mps as mpslib
from ..ops.linalg import _real_dtype
from ..ops.mps import MPS
from . import batched as B
from . import contraction as C
from . import fused as F

MessageDict = Dict[BlockSide, MPS]


@dataclass
class BPConfig:
    trunc_dim: int = 9                  # χ of the messages
    bubble_trunc_dim: Optional[int] = None  # χ inside the contraction (default: trunc_dim)
    max_iterations: int = 50
    msg_diff_terminate: float = 1e-10
    msg_diff_good_enough: float = 1e-5
    allowed_retries: int = 2
    # ceiling on the message χ that retry escalation may reach
    # (None = 4× the trunc_dim at robust-BP entry)
    trunc_dim_cap: Optional[int] = None
    damping: Optional[float] = None     # fraction of the OLD message kept
    hermitize_when_finished: bool = True
    init_model: str = "uniform"         # 'uniform' | 'random' | 'uniform-classic' | 'random-classic'
    seed: int = 0
    dtype: object = None                # torch dtype; default from the unit cell
    # the batched sweep (two vmapped calls of three sides); None = auto: on
    # wherever the sweep is not single-layer
    batched: Optional[bool] = None
    # single-layer ket swallowing (peak swallow memory χ²·d·D⁴ instead of
    # χ²·D⁶); None = auto: on for D ≥ 6, off below
    single_layer: Optional[bool] = None

    @property
    def chi_bubble(self) -> int:
        return self.bubble_trunc_dim or self.trunc_dim

    def for_measurements(self, chi_factor: float = 2.0) -> "BPConfig":
        """Measurement-time hardening: wider message χ, half the termination
        threshold, one extra retry."""
        return dataclasses.replace(
            self,
            trunc_dim=int(self.trunc_dim * chi_factor),
            msg_diff_terminate=self.msg_diff_terminate / 2,
            allowed_retries=self.allowed_retries + 1,
            trunc_dim_cap=(
                None if self.trunc_dim_cap is None
                else int(self.trunc_dim_cap * chi_factor)
            ),
        )


@dataclass
class BPStats:
    iterations: int = 0
    final_error: float = float("inf")
    success: bool = False
    attempts: int = 1
    final_config: Optional[BPConfig] = None
    duration: float = 0.0
    error_history: list = field(default_factory=list)
    mode: str = ""                      # the sweep that ran: bp_mode's answer


def hermitize_message(m: MPS, D: int, chi: int) -> MPS:
    """Project the message (an operator-valued boundary MPS with fused D²
    phys legs) onto its Hermitian part ½(M + M†), where M† is the sitewise
    conjugate with ket-bra swap."""
    sites_dag = []
    for s in m.sites:
        l, p, r = s.shape
        sites_dag.append(s.reshape(l, D, D, r).permute(0, 2, 1, 3).conj().reshape(l, p, r))
    out = mpslib.add(m, MPS(tuple(sites_dag), m.logscale), 0.5, 0.5)
    out = mpslib.compress(out, chi)
    out = mpslib.pad_bonds(out, _profile_of(m, chi, D))
    return MPS(out.sites, torch.zeros_like(out.logscale))


def _profile_of(m: MPS, chi: int, D: int) -> list:
    n = m.n
    p = D * D
    return [min(chi, p ** (k + 1), p ** (n - 1 - k)) for k in range(n - 1)]


def bp_mode(config: BPConfig, D: int) -> str:
    """The sweep BP runs at bond dimension D, as the JAX package decides
    (``kagomeperiodicbp_tpu/algo/bp.py``, off its TPU): "single" (the
    config's choice, or auto from D=6 unless batched=True), else "batched"
    (the config's choice, or auto), else "double" (per side).
    KPBP_SINGLE_LAYER=0/1 and KPBP_BP_BATCHED=0/1 override only what the
    config leaves to auto (None), and single-layer wins over batched."""
    single = config.single_layer
    if single is None:
        single = D >= 6 and config.batched is not True
    batched = config.batched
    if batched is None:
        batched = not single
    env_single = os.environ.get("KPBP_SINGLE_LAYER")
    if config.single_layer is None and env_single in ("0", "1"):
        single = env_single == "1"
    env_batched = os.environ.get("KPBP_BP_BATCHED")
    if config.batched is None and env_batched in ("0", "1"):
        batched = env_batched == "1" and not single
    if single:
        return "single"
    return "batched" if batched else "double"


def belief_propagation(cell: UnitCell, messages: Optional[MessageDict], config: BPConfig,
                       N: int) -> Tuple[MessageDict, BPStats]:
    """Iterate to the message fixed point; keep the minimum-error messages."""
    t0 = time.time()
    D = cell.D
    mode = bp_mode(config, D)
    per_site = len(C.site_kets(cell)) != 3
    if mode == "batched" and per_site:
        if config.batched:
            raise ValueError("batched=True: the batched sweep needs a unit cell, not a per-site view")
        mode = "double"
    chi_msg = config.trunc_dim
    chi = config.chi_bubble
    dtype = config.dtype or cell.A.dtype

    # clamp the thresholds to the working precision: in float32 the message
    # distance floors at ~30·eps, so 1e-10 would never terminate
    eps = torch.finfo(_real_dtype(dtype)).eps
    terminate = max(config.msg_diff_terminate, 30 * eps)
    good_enough = max(config.msg_diff_good_enough, 300 * eps)

    if messages is None:
        messages = C.initial_messages(
            N, D, chi_msg, model=config.init_model,
            generator=torch.Generator().manual_seed(config.seed),
            dtype=dtype, device=cell.A.device,
        )

    stats = BPStats(final_config=config, mode=mode)
    # single-layer swallowing consumes the raw kets, double-layer one K1 launch's fused tensors
    tensors = C.site_kets(cell) if mode == "single" else C.fused_cells(cell)
    if mode == "batched":
        step_fn = B.bp_iteration_batched(N, D, chi, chi_msg, config.damping)
    else:
        step_fn = F.bp_iteration(N, D, chi, chi_msg, config.damping, single=mode == "single")
    msg_sites = F._msgs_to_sites(messages)
    best_err, best_sites = float("inf"), msg_sites
    prev_err = float("inf")
    increases = 0

    for it in range(config.max_iterations):
        msg_sites, err_t = step_fn(tensors, msg_sites)
        err = float(err_t)  # the sweep's one host sync
        stats.error_history.append(err)
        if err < best_err:
            best_err, best_sites = err, msg_sites
        stats.iterations = it + 1
        if err < terminate:
            break
        # failure heuristic: diverging error several times in a row
        increases = increases + 1 if err > prev_err else 0
        prev_err = err
        if increases >= 4 and best_err < good_enough:
            break

    stats.final_error = best_err
    stats.success = best_err < good_enough

    if config.hermitize_when_finished:
        best_sites = F.hermitize_all(N, D, chi_msg)(best_sites)

    stats.duration = time.time() - t0
    return F._sites_to_msgs(best_sites), stats


def robust_belief_propagation(cell: UnitCell, messages: Optional[MessageDict],
                              config: BPConfig, N: int) -> Tuple[MessageDict, BPStats]:
    """Retry loop with χ escalation ×1.5 and fresh random messages on
    failure, returning the best attempt's messages on overall failure.
    Escalation respects ``config.trunc_dim_cap`` and stops early when a retry
    improves the best error by less than 30% (a precision floor)."""
    cap = config.trunc_dim_cap or 4 * config.trunc_dim
    cfg = config
    best: Optional[Tuple[float, MessageDict, BPStats]] = None
    for attempt in range(config.allowed_retries + 1):
        msgs_in = messages if attempt == 0 else None
        out, stats = belief_propagation(cell, msgs_in, cfg, N)
        stats.attempts = attempt + 1
        stats.final_config = cfg
        if stats.success:
            return out, stats
        # NaN-safe ordering: a NaN error is never pinned as best and never
        # triggers the plateau stop
        err_is_nan = math.isnan(stats.final_error)
        plateaued = (
            best is not None
            and not err_is_nan
            and stats.final_error >= 0.7 * best[0]
        )
        if best is None or math.isnan(best[0]) or (
            not err_is_nan and stats.final_error < best[0]
        ):
            best = (stats.final_error, out, stats)
        if plateaued or cfg.trunc_dim >= cap:
            break
        cfg = dataclasses.replace(
            cfg,
            trunc_dim=min(cap, int(cfg.trunc_dim * 1.5) + 1),
            bubble_trunc_dim=min(int(cap * 1.33) + 1, int(cfg.chi_bubble * 1.5) + 1),
            max_iterations=cfg.max_iterations + 11,
            init_model="random",
            seed=cfg.seed + 1,
        )
    _, out, stats = best
    return out, stats
