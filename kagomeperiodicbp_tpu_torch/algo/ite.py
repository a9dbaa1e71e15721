"""Full-update imaginary-time evolution: the training loop (counterpart of
kagomeperiodicbp_tpu/algo/ite.py, with the same order of edges and modes
from ``random.Random(config.seed)``).

(reference: src/algo/imaginary_time_evolution/main.py:704 `full_ite` and
_tn_update.py:165 `ite_update_unit_cell`)

Structure per delta_t (reference semantics):
  segment → [noise? rotation?] → modes × (edge sweep) → measurement
with symmetric 2nd-order Trotter edge ordering (forward + reversed, middle
edge once at 2·dt — main.py:86-96), per-edge BP refresh, energy tracking,
best-state store and error escalation. A linear-algebra failure inside an
edge update (``torch.linalg`` raises where ``jnp.linalg`` returns NaN) fails
that update as a non-finite result does: as an ``ITEError``, which rolls the
segment back.
"""
from __future__ import annotations

import dataclasses
import logging
import pickle
import random
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..convert import to_numpy as _to_numpy
from ..convert import unit_cell_from_numpy
from ..enums import UpdateEdge, UpdateMode
from ..measure import setup_device
from ..networks.unit_cell import NumpyUnpickler, UnitCell
from ..ops.linalg import _real_dtype
from ..utils.progress import get_progress_bar
from . import fused as F
from .bp import BPConfig, BPStats, robust_belief_propagation
from .contraction import MessageDict
from .measurements import measure_energies_and_observables


def default_time_steps(start: float = 1e-2, stop: float = 1e-8, per: int = 100) -> List[float]:
    """Log-spaced δt ladder (reference: run_ite.py:58 / DEFAULT_TIME_STEPS)."""
    steps: List[float] = []
    dt = start
    while dt >= stop * 0.999:
        steps += [dt] * per
        dt /= 10
    return steps


@dataclass
class ITEConfig:
    """(reference: containers/imaginary_time_evolution.py:179 + 157)"""

    hamiltonian: Callable[..., np.ndarray] = None  # type: ignore[assignment]
    # time-dependent protocol (reference HamiltonianFuncAndInputs with
    # arg="delta_t", e.g. run_ite.py:29 decreasing_global_field_func): when
    # set, the per-segment Hamiltonian is hamiltonian(hamiltonian_field(dt)).
    hamiltonian_field: Optional[Callable[[Optional[float]], float]] = None
    time_steps: List[float] = field(default_factory=default_time_steps)
    # orders
    random_edge_order: bool = True
    random_mode_order: bool = True
    symmetric_second_order_trotterization: bool = True
    num_mode_repetitions_per_segment: int = 5  # reference default (iterative_process.py:170)
    num_edge_repetitions_per_mode: int = 6
    # after-update
    normalize_tensors_after_update: bool = True
    # keep the lowest-energy state at each delta_t block boundary
    # (reference: main.py:658 always_use_lowest_energy_state)
    always_use_lowest_energy_state: bool = False
    # skip to the next delta_t when this many segments fail to improve
    # (reference: check_converges + CONVERGENCE_CHECK_LENGTH=3, main.py:455)
    check_converges: bool = False
    convergence_check_length: int = 3
    # optimisation
    add_gaussian_noise_fraction: Optional[float] = None
    randomly_rotate_unit_cell_between_segments: bool = True  # reference default
    # bp
    bp_every_edge: bool = True
    start_segment_with_new_bp_message: bool = True
    # error escalation (reference: iterative_process config)
    num_errors_per_delta_t_threshold: int = 2
    num_total_errors_threshold: int = 10
    # adopt the escalated BP χ for the rest of the run after a struggling BP
    # (reference: iterative_process.py:167 keep_harder_bp_config_between_segments)
    keep_harder_bp_config_between_segments: bool = False
    # als
    als_iterations: int = 10
    seed: int = 0


@dataclass
class ITESegmentStats:
    delta_t: float = 0.0
    mean_energy: float = 0.0
    edge_energies: Dict[str, float] = field(default_factory=dict)
    # per-edge environment health from the last update of each edge this
    # segment: {"hermicity", "negativity", "sum_eigenvalues"} (the reference
    # plots these live in its env-health panel, visualizations/ite.py:280)
    edge_health: Dict[str, dict] = field(default_factory=dict)
    # per-flavor ⟨x/y/z⟩ at measurement time (core-polarization panel)
    expectations: Dict[str, Dict[str, float]] = field(default_factory=dict)
    bp_stats: List[BPStats] = field(default_factory=list)
    modes_order: List[UpdateMode] = field(default_factory=list)
    global_field: float = 0.0
    duration: float = 0.0
    had_error: bool = False


@dataclass
class ITETracker:
    """Full per-segment history + checkpointing + revert
    (reference: containers/_ite_tracker.py:64-162 ITEProgressTracker).

    Keeps, per logged segment: δt, mean energy, the measured unit cell
    (as host numpy — bounded by `history_limit`, oldest dropped first, like
    the reference's MAX_MEMORY-bounded deques) and the segment stats. The
    scalar series (delta_ts/energies) are unbounded — they are cheap and the
    dashboards read them.
    """

    delta_ts: List[float] = field(default_factory=list)
    energies: List[float] = field(default_factory=list)
    stats: List[ITESegmentStats] = field(default_factory=list)
    cells: List[dict] = field(default_factory=list)   # host-numpy {A,B,C}, bounded
    history_limit: int = 25
    best_energy: float = float("inf")
    best_cell: Optional[UnitCell] = None
    error_count: int = 0
    checkpoint_path: Optional[str] = None

    def log_segment(self, dt, cell, measurement, seg_stats):
        self.delta_ts.append(dt)
        self.energies.append(measurement.mean_energy)
        self.stats.append(seg_stats)
        self.cells.append({k: _to_numpy(v) for k, v in cell.items()})
        if len(self.cells) > self.history_limit:
            del self.cells[0]
        if measurement.mean_energy < self.best_energy:
            self.best_energy = measurement.mean_energy
            self.best_cell = cell
        if self.checkpoint_path:
            self.save(self.checkpoint_path)

    def revert_back(self, n: int = 1, device=None) -> UnitCell:
        """Drop the last `n` logged segments and return the unit cell as of
        the new head, on `device` (reference: _ite_tracker.py:130
        `revert_back`). n=0 is a no-op returning the current head cell.
        Raises if the in-memory cell history doesn't reach that far."""
        if n < 0 or n >= len(self.cells):
            raise ValueError(
                f"cannot revert {n} segments: only {len(self.cells)} cells in history"
            )
        if n > 0:
            del self.delta_ts[-n:], self.energies[-n:], self.stats[-n:], self.cells[-n:]
        return unit_cell_from_numpy(self.cells[-1], device)

    def save(self, path: str):
        data = {
            "delta_ts": self.delta_ts,
            "energies": self.energies,
            "stats": self.stats,
            "cells": self.cells,
            "history_limit": self.history_limit,
            "best_energy": self.best_energy,
            "error_count": self.error_count,
            "best_cell": {k: _to_numpy(v) for k, v in self.best_cell.items()}
            if self.best_cell is not None
            else None,
        }
        with open(path, "wb") as fh:
            pickle.dump(data, fh)

    @classmethod
    def load(cls, path: str, device=None) -> "ITETracker":
        """Offline recovery from a checkpoint this package wrote — any state
        the tracker logged can be resumed from (reference:
        scripts/unpack_ite_tracker.py:9). The pickle may hold this module's
        classes, torch dtypes and numpy arrays only; a JAX package
        checkpoint goes through ``convert.tracker_from_jax_checkpoint``."""
        with open(path, "rb") as fh:
            data = NumpyUnpickler(fh, extra=_CHECKPOINT_CLASSES).load()
        return cls.from_checkpoint(data, path, device)

    @classmethod
    def from_checkpoint(cls, data: dict, path: Optional[str] = None, device=None) -> "ITETracker":
        tr = cls(
            delta_ts=list(data.get("delta_ts", [])),
            energies=list(data.get("energies", [])),
            stats=list(data.get("stats", [])),
            cells=list(data.get("cells", [])),
            history_limit=int(data.get("history_limit", 25)),
            best_energy=float(data.get("best_energy", float("inf"))),
            error_count=int(data.get("error_count", 0)),
            checkpoint_path=path,
        )
        bc = data.get("best_cell")
        if bc is not None:
            tr.best_cell = unit_cell_from_numpy(bc, device)
        return tr


class ITEError(RuntimeError):
    pass


# what a checkpoint of this package may hold besides numpy arrays and plain
# values: its own record classes and torch dtypes
_DTYPE_NAMES = ("float32", "float64", "complex64", "complex128")
_CHECKPOINT_CLASSES = {
    **{(c.__module__, c.__qualname__): c
       for c in (ITESegmentStats, BPStats, BPConfig, UpdateMode)},
    **{("torch", n): getattr(torch, n) for n in _DTYPE_NAMES},
}


def _mode_order(config: ITEConfig, last_mode: Optional[UpdateMode],
                rng: random.Random) -> List[UpdateMode]:
    """`num_mode_repetitions_per_segment` update modes, never repeating the
    same mode twice in a row — including across the segment boundary
    (reference: main.py:299 `_mode_order_without_repetitions`)."""
    n = config.num_mode_repetitions_per_segment
    if not config.random_mode_order:
        return [UpdateMode(i % 3) for i in range(n)]
    order: List[UpdateMode] = []
    prev = last_mode
    for _ in range(n):
        choices = [m for m in UpdateMode if m != prev]
        mode = choices[rng.randrange(len(choices))]
        order.append(mode)
        prev = mode
    return order


def _harden_bp_config_if_struggled(
    bp_config: BPConfig, chi: int, stats: BPStats, log: logging.Logger
) -> Tuple[BPConfig, int]:
    """After a BP run that never reached `good_enough`, adopt the escalated
    message χ the robust wrapper ended at, and widen the contraction χ to
    stay ahead of it (reference: main.py:200 `_harden_bp_config_if_struggled`).

    The adopted χ is clamped to ``bp_config.trunc_dim_cap``: hardening runs
    once per edge update (~55× per segment), so without an absolute ceiling
    a persistently-failing BP (e.g. error floored at the complex64
    precision limit) compounds ×1.5-per-retry escalation into χ ~ thousands
    within one segment."""
    if stats.success or stats.final_config is None:
        return bp_config, chi
    new_trunc = stats.final_config.trunc_dim
    if bp_config.trunc_dim_cap is not None:
        new_trunc = min(new_trunc, bp_config.trunc_dim_cap)
    if new_trunc > bp_config.trunc_dim:
        bp_config = dataclasses.replace(bp_config, trunc_dim=new_trunc)
        log.debug("bp trunc_dim hardened to %d", new_trunc)
    if new_trunc >= chi:
        chi = int(new_trunc * 1.33)
        log.debug("contraction chi hardened to %d", chi)
    return bp_config, chi


def _edge_order(config: ITEConfig, dt: float, rng: random.Random) -> List[Tuple[UpdateEdge, float]]:
    """Edge sweep order with symmetric 2nd-order Trotter doubling
    (reference: main.py:74-104)."""
    if config.random_edge_order:
        edges = UpdateEdge.all_in_random_order(config.num_edge_repetitions_per_mode, rng)
    else:
        edges = UpdateEdge.all_options()
    if config.symmetric_second_order_trotterization:
        edges = list(edges) + list(reversed(edges))
        mid = len(edges) // 2 - 1
        edges.pop(mid + 1)
        dts = [2 * dt if i == mid else dt for i in range(len(edges))]
    else:
        dts = [dt] * len(edges)
    return list(zip(edges, dts))


def ite_update_edge(
    cell: UnitCell,
    messages: MessageDict,
    N: int,
    chi: int,
    chi_msg: int,
    edge: UpdateEdge,
    h: np.ndarray,
    dt: float,
    config: ITEConfig,
) -> Tuple[UnitCell, float, dict]:
    """One edge update: env → gate → ALS → write back.
    (reference: _tn_update.py:165). Its energy and health come to the host
    in one read, the update's one sync of its own."""
    D = cell.D
    dtype = cell.A.dtype
    h_t = torch.as_tensor(h if dtype.is_complex else np.real(h), dtype=dtype,
                          device=cell.A.device)
    upd = F.edge_update(
        N, D, chi, chi_msg, edge, config.als_iterations,
        config.normalize_tensors_after_update,
    )
    cells = (cell.A, cell.B, cell.C)
    try:
        new_cells, energy, herm, sum_eig, neg = upd(
            cells, F._msgs_to_sites(messages), h_t, float(dt)
        )
        energy_f, herm_f, sum_f, neg_f = torch.stack(
            [energy, herm, sum_eig.real, neg]).tolist()
    except torch.linalg.LinAlgError as exc:
        raise ITEError(f"linear algebra failed in the edge update: {exc}") from exc
    health = {
        "hermicity": herm_f,
        "negativity": neg_f,
        "sum_eigenvalues": sum_f,
    }
    eps = float(torch.finfo(_real_dtype(dtype)).eps)
    tol = max(1e-3, 3e4 * eps)
    # written so that a NaN fails it (the JAX package's `>` lets NaN through)
    if not (health["hermicity"] <= tol and abs(health["sum_eigenvalues"] - 1) <= tol):
        raise ITEError(f"unhealthy environment after update: {health}")

    cell = UnitCell(new_cells[0], new_cells[1], new_cells[2], rotated=cell.rotated)
    return cell, energy_f, health


def full_ite(
    cell: Optional[UnitCell],
    config: ITEConfig,
    N: int = 2,
    D: int = 3,
    d: int = 2,
    chi: Optional[int] = None,
    bp_config: Optional[BPConfig] = None,
    logger: Optional[logging.Logger] = None,
    tracker: Optional[ITETracker] = None,
    dtype: torch.dtype = torch.complex128,
    measure_every_segment: bool = True,
    measure_every: int = 1,
    save_best_store: bool = False,
    measurement_N: Optional[int] = None,
    measurement_chi_factor: float = 1.0,
    measure_dtype=None,
    progress=None,
    plots=None,
    device="cuda",
) -> Tuple[float, UnitCell, ITETracker]:
    """The main ITE loop (reference: main.py:704).

    It runs on `device`, the card unless the CPU is asked for: a given cell
    is copied there, and with ``cell=None`` a random one is drawn there from
    a generator seeded with ``config.seed``, which also draws the segments'
    noise. Without a card it raises (``measure.setup_device``).

    `progress`: optional utils.progress.ProgressHierarchy for the reference's
    leveled progress bars (visuals.py:31-46). `plots`: optional
    visualizations.ITEPlots, updated after every measured segment."""
    device = setup_device(device)
    log = logger or logging.getLogger("ite")
    rng = random.Random(config.seed)
    gen = torch.Generator(device=device).manual_seed(config.seed)
    if cell is None:
        cell = UnitCell.random(d=d, D=D, generator=gen, dtype=dtype)
    else:
        cell = cell.to_device(device)
    D = cell.D
    chi = chi or 2 * D * D + 10       # reference: global_config.py:43-48
    bp_config = bp_config or BPConfig(trunc_dim=2 * D * D, dtype=dtype)
    if bp_config.trunc_dim_cap is None:
        # absolute ceiling for per-edge hardening + retry escalation across
        # the whole run (see _harden_bp_config_if_struggled)
        bp_config = dataclasses.replace(bp_config, trunc_dim_cap=4 * bp_config.trunc_dim)
    tracker = tracker or ITETracker()

    h = config.hamiltonian() if config.hamiltonian_field is None else None

    messages: Optional[MessageDict] = None
    errors_this_dt = 0
    last_dt = None
    last_mode: Optional[UpdateMode] = None
    block_best: Tuple[float, Optional[UnitCell]] = (float("inf"), None)
    no_improve = 0
    skip_until_new_dt = False

    main_bar = get_progress_bar(progress, len(config.time_steps), "ITE", "ITE-main")
    for step_idx, dt in enumerate(config.time_steps):
        main_bar.next(extra_str=f"dt={dt:.1e}")
        if dt != last_dt:
            errors_this_dt = 0
            last_dt = dt
            if config.always_use_lowest_energy_state and block_best[1] is not None:
                cell = block_best[1]
                if measure_dtype is not None and cell.A.dtype != dtype:
                    cell = cell.astype(dtype)  # back to the working precision
            block_best = (float("inf"), None)
            no_improve = 0
            skip_until_new_dt = False
        if skip_until_new_dt:
            continue
        t0 = time.time()
        seg = ITESegmentStats(delta_t=dt)
        # the annealing field advances once per segment whether or not the
        # segment succeeds (reference: crnt_force_value decays per call)
        if config.hamiltonian_field is not None:
            field_val = config.hamiltonian_field(dt)
            seg.global_field = field_val
            h = config.hamiltonian(field_val)
        cell_backup = cell  # pre-segment state for rollback on ITEError
        # per-segment working BP config/chi: hardening after a struggling BP
        # applies for the rest of the segment unconditionally (reference
        # main.py:533 mutates the per-segment config copy); the keep flag
        # only controls persistence across segments
        bp_seg, chi_seg = bp_config, chi
        try:
            if config.start_segment_with_new_bp_message:
                messages = None
            if config.add_gaussian_noise_fraction:
                cell = cell.add_noise(config.add_gaussian_noise_fraction * dt, gen)
            if config.randomly_rotate_unit_cell_between_segments and rng.random() < 0.5:
                cell = cell.rotate_ccw()

            # per-segment edge order, shared by all modes (reference:
            # main.py:302 _deal_edge_order computed once per segment)
            edge_order = _edge_order(config, dt, rng)
            modes = _mode_order(config, last_mode, rng)
            seg.modes_order = modes
            if modes:
                last_mode = modes[-1]
            seg_bar = get_progress_bar(progress, len(modes),
                                       "segment", "ITE-per-segment")
            for _mode in modes:
                seg_bar.next(extra_str=f"mode={_mode.name}")
                mode_bar = get_progress_bar(progress, len(edge_order),
                                            "edges", "ITE-per-mode")
                for edge, dt_edge in edge_order:
                    mode_bar.next(extra_str=str(edge))
                    if config.bp_every_edge or messages is None:
                        messages, bst = robust_belief_propagation(cell, messages, bp_seg, N)
                        seg.bp_stats.append(bst)
                        bp_seg, chi_seg = _harden_bp_config_if_struggled(
                            bp_seg, chi_seg, bst, log
                        )
                        if config.keep_harder_bp_config_between_segments:
                            bp_config, chi = bp_seg, chi_seg
                    cell, energy, health = ite_update_edge(
                        cell, messages, N, chi_seg, bp_seg.trunc_dim, edge, h, dt_edge, config
                    )
                    seg.edge_energies[str(edge)] = energy
                    seg.edge_health[str(edge)] = health

            # measurement cadence: the reference measures every segment; at
            # large D on one core the (N+1, χ×2) measurement dominates the
            # segment cost, so `measure_every` thins it (always measuring
            # the last segment of each dt block)
            is_block_end = (
                step_idx + 1 >= len(config.time_steps)
                or config.time_steps[step_idx + 1] != dt
            )
            if measure_every_segment and (
                measure_every <= 1 or step_idx % measure_every == 0 or is_block_end
            ):
                # measurement-time hardening: larger block + wider chi +
                # tighter BP + one extra retry (reference:
                # change_config_for_measurements_func, run_ite.py:49-55)
                n_m = measurement_N or N
                bp_m = bp_seg.for_measurements(measurement_chi_factor)
                chi_m = int(chi_seg * measurement_chi_factor)
                cell_m = cell.force_zero_rotation()
                if measure_dtype is not None and cell_m.A.dtype != measure_dtype:
                    # mixed-precision mode: optimize in the working dtype
                    # (c64 — fast compiles, chip-safe), MEASURE in f64 —
                    # the segment-boundary analog of the reference's
                    # measurement-time config hardening (run_ite.py:49-55)
                    cell_m = cell_m.astype(measure_dtype)
                    bp_m = dataclasses.replace(bp_m, dtype=measure_dtype)
                messages_m, bst = robust_belief_propagation(cell_m, None, bp_m, n_m)
                # measure with the field OFF (reference: the field func is
                # called with delta_t=None → 0 at measurement time)
                h_meas = (
                    h if config.hamiltonian_field is None
                    else config.hamiltonian(config.hamiltonian_field(None))
                )
                meas = measure_energies_and_observables(
                    cell_m, messages_m, n_m, chi_m, bp_m.trunc_dim, h_meas
                )
                seg.mean_energy = meas.mean_energy
                seg.expectations = meas.expectations
                if meas.mean_energy < block_best[0]:
                    block_best = (meas.mean_energy, cell_m)
                    no_improve = 0
                else:
                    no_improve += 1
                    if config.check_converges and no_improve >= config.convergence_check_length:
                        skip_until_new_dt = True
                tracker.log_segment(dt, cell_m, meas, seg)
                if plots is not None:
                    plots.update(tracker)
                if save_best_store:
                    from ..utils.best_store import save_if_best

                    save_if_best(cell_m, meas.mean_energy, D)
                log.info(
                    "dt=%.2e  step=%d  energy/site=%.10f  best=%.10f",
                    dt, step_idx, meas.mean_energy, tracker.best_energy,
                )
        except ITEError as exc:
            seg.had_error = True
            errors_this_dt += 1
            tracker.error_count += 1
            # roll back to the pre-segment state: a partially-updated cell
            # from a failed segment is worse than re-trying from the last
            # good one (the reference keeps the pre-segment `unit_cell`
            # binding when ite_per_segment raises, main.py:676-683)
            cell = cell_backup
            messages = None
            log.warning("segment error at dt=%.2e (rolled back): %s", dt, exc)
            if tracker.error_count >= config.num_total_errors_threshold:
                raise ITEError("too many ITE errors — aborting") from exc
            if errors_this_dt >= config.num_errors_per_delta_t_threshold:
                continue  # effectively skip ahead within this dt
        seg.duration = time.time() - t0

    final_cell = tracker.best_cell if tracker.best_cell is not None else cell
    return tracker.best_energy, final_cell, tracker
