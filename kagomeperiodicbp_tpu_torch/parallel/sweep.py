"""Parameter-sweep runner (counterpart of kagomeperiodicbp_tpu/parallel/sweep.py,
the replacement for the reference's HTCondor job sender,
scripts/condor/main_sender.py:57, worker.py:38).

Sweep points run either sequentially in-process or **concurrently in worker
processes** (the reference's `_local_test` mode spawns real local jobs,
main_sender.py:144-156): ``n_workers > 1`` fans the points out over a
spawn-context process pool, results appended to a CSV by the parent. The
JAX package pins its children to the CPU because TPU chips do not multiplex
across processes; CUDA contexts share a card, so here the children go
round-robin over the cards (``child_device="cuda"``, the default) and share
one where there are more workers than cards. ``"cpu"`` runs them on the CPU,
on request only; asking for the card where there is none raises.

Workers read their device with ``worker_device()``. Random starts draw from
a ``torch.Generator`` seeded with the point's seed on the CPU (torch's
numbers, not jax.random's), so a point gives the same numbers on every
device and in every worker. Cells pass between DAG stages as
``UnitCell.save``/``load`` files.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import os
import time
import traceback
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from ..utils.csvs import CSVManager

# the device this process's workers run on: set by the pool's initializer in
# a child, per point in sequential mode
_DEVICE = {"device": None}


@dataclass(frozen=True)
class SweepPoint:
    D: int = 2
    N: int = 2
    chi_factor: float = 1.0
    seed: int = 0
    method: str = "ite"          # 'ite' | 'bp' | custom key
    noise: Optional[float] = None
    extra: tuple = ()

    def as_dict(self) -> Dict[str, Any]:
        d = {k: getattr(self, k) for k in ("D", "N", "chi_factor", "seed", "method", "noise")}
        d.update(dict(self.extra))
        return d


def grid(Ds=(2,), Ns=(2,), seeds=(0,), chi_factors=(1.0,), noises=(None,), method="ite") -> List[SweepPoint]:
    """Cartesian product of sweep parameters
    (reference: main_sender.py:42-52 request_* lists)."""
    return [
        SweepPoint(D=D, N=N, chi_factor=c, seed=s, method=method, noise=n)
        for D, N, c, s, n in itertools.product(Ds, Ns, chi_factors, seeds, noises)
    ]


def worker_device() -> torch.device:
    """The device the current worker runs on."""
    if _DEVICE["device"] is None:
        raise RuntimeError("no worker device: workers run under run_sweep or run_dag")
    return _DEVICE["device"]


def _check_device(device: str) -> None:
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"no CUDA device for child_device={device!r}: the sweep runs on the "
                           "card by default; pass child_device='cpu' to run it on the CPU")


def _resolve(device: str, index: int) -> torch.device:
    """`device`, with a bare "cuda" taken round-robin: worker `index` on
    cuda:(index % count)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", index % torch.cuda.device_count())
    return dev


def _set_device(dev: torch.device) -> None:
    if dev.type == "cuda":
        from ..measure import setup_device

        setup_device(dev)
        torch.cuda.set_device(dev)
    _DEVICE["device"] = dev


def _child_init(device: str, counter) -> None:
    """Process-pool initializer: one torch thread per child, and its device,
    taken round-robin by the order in which the children start."""
    torch.set_num_threads(1)
    with counter.get_lock():
        index = counter.value
        counter.value += 1
    _set_device(_resolve(device, index))


@contextlib.contextmanager
def _on_device(dev: torch.device):
    """Run a point in-process on `dev` (sequential mode)."""
    prev = _DEVICE["device"]
    _DEVICE["device"] = dev
    try:
        if dev.type == "cuda":
            from ..measure import setup_device

            setup_device(dev)
            with torch.cuda.device(dev):
                yield
        else:
            yield
    finally:
        _DEVICE["device"] = prev


def _pool(n_workers: int, device: str):
    import concurrent.futures as cf
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    return cf.ProcessPoolExecutor(max_workers=n_workers, mp_context=ctx, initializer=_child_init,
                                  initargs=(device, ctx.Value("i", 0)))


def _guarded(worker: Callable[[SweepPoint], Dict[str, Any]], pt: SweepPoint) -> Dict[str, Any]:
    t0 = time.time()
    try:
        out = {"status": "ok", "out": worker(pt)}
    except Exception as exc:  # noqa: BLE001 — sweep must survive bad points
        out = {
            "status": f"error: {type(exc).__name__}",
            "out": {"error": str(exc)},
            "traceback": traceback.format_exc(limit=2),
        }
    # measured inside the worker process: actual runtime, not queue wait
    out["exec_time"] = time.time() - t0
    return out


def _row(pt: SweepPoint, res: Dict[str, Any]) -> Dict[str, Any]:
    row = pt.as_dict()
    row["status"] = res["status"]
    row["result"] = json.dumps(res["out"], default=str)
    row["exec_time"] = round(res.get("exec_time", 0.0), 3)
    return row


def run_sweep(
    points: Sequence[SweepPoint],
    worker: Callable[[SweepPoint], Dict[str, Any]],
    csv_path: str = "data/sweeps/results.csv",
    devices: Optional[Sequence] = None,
    n_workers: int = 1,
    child_device: str = "cuda",
) -> List[Dict[str, Any]]:
    """Run `worker` on every point, recording results + timing to CSV.
    Failures are recorded, not fatal (the condor workers' CSV-row semantics,
    worker.py:156).

    * ``n_workers == 1``: sequential in-process, on ``devices[i % len]``
      for point i when `devices` is given, else on `child_device`.
    * ``n_workers > 1``: a spawn-context process pool — real concurrency.
      ``worker`` must be a module-level (picklable) callable; each child runs
      on `child_device` ("cuda": round-robin over the cards) with one torch
      thread.
    """
    _check_device(child_device)
    columns = ["D", "N", "chi_factor", "seed", "method", "noise", "exec_time", "status", "result"]
    csvm = CSVManager(csv_path, columns)
    results: List[Dict[str, Any]] = []

    if n_workers > 1:
        import concurrent.futures as cf

        with _pool(n_workers, child_device) as pool:
            futures = {pool.submit(_guarded, worker, pt): i for i, pt in enumerate(points)}
            ordered: List[Optional[Dict[str, Any]]] = [None] * len(points)
            for fut in cf.as_completed(futures):
                i = futures[fut]
                try:
                    ordered[i] = fut.result()
                except Exception as exc:  # noqa: BLE001 — child died hard
                    ordered[i] = {"status": f"error: {type(exc).__name__}",
                                  "out": {"error": str(exc)}, "exec_time": 0.0}
        for i, pt in enumerate(points):
            res = ordered[i] or {"status": "error: lost", "out": {}, "exec_time": 0.0}
            csvm.append(_row(pt, res))
            results.append(res["out"])
        return results

    for i, pt in enumerate(points):
        dev = torch.device(devices[i % len(devices)]) if devices else _resolve(child_device, 0)
        with _on_device(dev):
            res = _guarded(worker, pt)
        csvm.append(_row(pt, res))
        results.append(res["out"])
    return results


# --------------------------------------------------------------------------
# DAG-dependent jobs (reference: scripts/condor/CondorJobSender.py builds a
# networkx dependency DAG of condor jobs — send_dag_of_jobs — so chained
# campaigns like SU → ITE → measure run per sweep point with each stage
# consuming its parent's output). Here the DAG is scheduled locally with
# Kahn's algorithm over the same worker/pool machinery as run_sweep; a failed
# job skips its descendants (DAGMan semantics) instead of aborting the sweep.
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class DagJob:
    """One node of a dependent-job DAG.

    ``worker(point, parents)`` receives ``parents`` = {parent job name →
    that job's result dict}, so a child stage can consume its parents'
    outputs (e.g. the path of the cell the SU stage saved).
    """

    name: str
    point: SweepPoint = SweepPoint()
    depends_on: tuple = ()


def chain(stages: Sequence[str], point: SweepPoint, tag: str = "") -> List[DagJob]:
    """A linear pipeline (SU → ITE → measure) over one sweep point — the
    reference's chained-condor-jobs use case, one DagJob per stage; each
    stage's ``point.method`` is the stage name."""
    jobs: List[DagJob] = []
    prev: tuple = ()
    for stage in stages:
        name = f"{tag or 'pt'}:{stage}"
        jobs.append(DagJob(name=name, point=dataclasses.replace(point, method=stage),
                           depends_on=prev))
        prev = (name,)
    return jobs


def _guarded_dag(worker, job: DagJob, parents: Dict[str, Dict[str, Any]]) -> Dict[str, Any]:
    t0 = time.time()
    try:
        out = {"status": "ok", "out": worker(job.point, parents)}
    except Exception as exc:  # noqa: BLE001 — a bad node must not kill the DAG
        out = {"status": f"error: {type(exc).__name__}",
               "out": {"error": str(exc)},
               "traceback": traceback.format_exc(limit=2)}
    out["exec_time"] = time.time() - t0
    return out


def run_dag(
    jobs: Sequence[DagJob],
    worker: Callable[[SweepPoint, Dict[str, Dict[str, Any]]], Dict[str, Any]],
    csv_path: str = "data/sweeps/dag_results.csv",
    n_workers: int = 1,
    child_device: str = "cuda",
) -> Dict[str, Dict[str, Any]]:
    """Run a dependency DAG of jobs; returns {job name → result dict}.

    * Ready jobs (all parents succeeded) run concurrently when
      ``n_workers > 1`` (spawn pool on `child_device`, as in run_sweep) or
      sequentially in topological order on `child_device` otherwise.
    * A failed job marks every descendant ``skipped`` (recorded in the CSV,
      like DAGMan's noop-on-upstream-failure), the rest of the DAG continues.
    * Cycles and unknown dependency names raise ValueError up front.
    """
    by_name = {j.name: j for j in jobs}
    if len(by_name) != len(jobs):
        raise ValueError("duplicate DagJob names")
    for j in jobs:
        unknown = [d for d in j.depends_on if d not in by_name]
        if unknown:
            raise ValueError(f"{j.name}: unknown depends_on {unknown}")
    _check_device(child_device)

    indeg = {j.name: len(set(j.depends_on)) for j in jobs}
    children: Dict[str, List[str]] = {j.name: [] for j in jobs}
    for j in jobs:
        for d in set(j.depends_on):
            children[d].append(j.name)

    columns = ["name", "depends_on", "D", "N", "chi_factor", "seed", "method",
               "noise", "exec_time", "status", "result"]
    csvm = CSVManager(csv_path, columns)
    results: Dict[str, Dict[str, Any]] = {}
    status: Dict[str, str] = {}

    def record(job: DagJob, res: Dict[str, Any]) -> None:
        status[job.name] = res["status"]
        results[job.name] = res["out"]
        row = _row(job.point, res)
        row.update(name=job.name, depends_on=";".join(job.depends_on))
        csvm.append(row)

    def skip_descendants(name: str) -> None:
        for c in children[name]:
            if c not in status:
                record(by_name[c], {"status": f"skipped: upstream {name}",
                                    "out": {}, "exec_time": 0.0})
                skip_descendants(c)

    def finished(name: str) -> None:
        if status[name] != "ok":
            skip_descendants(name)
            return
        for c in children[name]:
            indeg[c] -= 1
            if indeg[c] == 0:
                ready.append(c)

    ready = [n for n, d in indeg.items() if d == 0]
    pool = _pool(n_workers, child_device) if n_workers > 1 else None
    import concurrent.futures as cf

    try:
        pending: Dict[Any, str] = {}
        while ready or pending:
            while ready:
                name = ready.pop()
                if name in status:  # already skipped via a failed parent
                    continue
                job = by_name[name]
                parents = {d: results[d] for d in job.depends_on}
                if pool is not None:
                    pending[pool.submit(_guarded_dag, worker, job, parents)] = name
                else:
                    with _on_device(_resolve(child_device, 0)):
                        record(job, _guarded_dag(worker, job, parents))
                    finished(name)
            if pending:
                done, _ = cf.wait(pending, return_when=cf.FIRST_COMPLETED)
                for fut in done:
                    name = pending.pop(fut)
                    try:
                        res = fut.result()
                    except Exception as exc:  # noqa: BLE001 — child died hard
                        res = {"status": f"error: {type(exc).__name__}",
                               "out": {"error": str(exc)}, "exec_time": 0.0}
                    record(by_name[name], res)
                    finished(name)
    finally:
        if pool is not None:
            pool.shutdown()

    if len(status) != len(jobs):
        stuck = sorted(set(by_name) - set(status))
        raise ValueError(f"dependency cycle: {stuck} never became ready")
    return results


# ------------------------------- workers ------------------------------------


def smoke_worker(pt: SweepPoint) -> Dict[str, Any]:
    """Minimal worker used by tests and dry runs: one tiny torch product on
    the worker's device, proving the pool and per-child device wiring."""
    x = torch.arange(pt.D * pt.N, dtype=torch.float32, device=worker_device())
    return {"pid_value": float((x * x).sum()), "device": str(x.device),
            "platform": x.device.type, "seed": pt.seed, "pid": os.getpid()}


def smoke_dag_worker(pt: SweepPoint, parents: Dict[str, Dict[str, Any]]) -> Dict[str, Any]:
    """``smoke_worker`` as a DAG stage: the point's seed plus its parents'
    values, with the process and device that ran it."""
    out = smoke_worker(pt)
    out["value"] = pt.seed + sum(p["value"] for p in parents.values())
    return out


def _random_cell(D: int, seed: int, dtype=torch.complex128):
    from ..networks.unit_cell import UnitCell

    return UnitCell.random(2, D, torch.Generator().manual_seed(seed), dtype).to_device(worker_device())


def bp_worker(pt: SweepPoint) -> Dict[str, Any]:
    """The 'bp' sweep job of the JAX package's scripts/run_sweep.py: robust
    BP on a random cell at the point's D and N, χ_msg = 2D². Entries of the
    point's ``extra`` that name ``BPConfig`` fields override them (e.g.
    ``max_iterations`` and ``allowed_retries`` to cut the run)."""
    from ..algo.bp import BPConfig, robust_belief_propagation
    from ..ops import kernels

    fields = {f.name for f in dataclasses.fields(BPConfig)}
    cfg = dataclasses.replace(BPConfig(trunc_dim=2 * pt.D ** 2),
                              **{k: v for k, v in pt.extra if k in fields})
    before = kernels.launch_counts()
    _, stats = robust_belief_propagation(_random_cell(pt.D, pt.seed), None, cfg, pt.N)
    after = kernels.launch_counts()
    return {"bp_error": stats.final_error, "iterations": stats.iterations,
            "duration": stats.duration, "device": str(worker_device()),
            "launches": {n: after[n] - before[n] for n in after}}


def ite_worker(pt: SweepPoint, steps: Optional[List[float]] = None) -> Dict[str, Any]:
    """Default 'ite' sweep job: run full_ite at the point's parameters
    (reference: condor/send_ite.py)."""
    from ..algo.bp import BPConfig
    from ..algo.ite import ITEConfig, default_time_steps, full_ite
    from ..physics import hamiltonians

    cfg = ITEConfig(
        hamiltonian=hamiltonians.heisenberg_afm,
        time_steps=steps or default_time_steps(1e-2, 1e-4, 20),
        add_gaussian_noise_fraction=pt.noise,
        seed=pt.seed,
    )
    chi = int(2 * pt.D**2 * pt.chi_factor) + 10
    bp = BPConfig(trunc_dim=2 * pt.D * pt.D)
    best, cell, tracker = full_ite(None, cfg, N=pt.N, D=pt.D, chi=chi, bp_config=bp,
                                   device=worker_device())
    return {"best_energy": best, "segments": len(tracker.energies)}


def dag_stage_worker(pt: SweepPoint, parents: Dict[str, Dict[str, Any]]) -> Dict[str, Any]:
    """The chained-campaign stage worker (su → ite → measure per sweep
    point — the reference's dependent condor jobs, send_ite.py chained via
    CondorJobSender DAGs). ``pt.method`` selects the stage; cells flow
    between stages as saved files (``cell_path`` in each result), so stages
    can run in different worker processes. Stage knobs ride ``pt.extra``:
    ``dt_start/dt_stop/steps_per_dt`` (ite), ``out_dir`` (all).
    """
    from ..networks.unit_cell import UnitCell
    from ..physics import hamiltonians

    dev = worker_device()
    extra = dict(pt.extra)
    out_dir = extra.get("out_dir", "data/sweeps/cells")
    os.makedirs(out_dir, exist_ok=True)
    h = hamiltonians.BY_NAME["AFM"]()
    parent_path = next((p["cell_path"] for p in parents.values()
                        if isinstance(p, dict) and p.get("cell_path")), None)
    tag = f"D{pt.D}_s{pt.seed}"

    if pt.method == "su":
        from ..algo.simple_update import simple_update

        cell, _ = simple_update(h, pt.D, time_steps=[0.1] * 60 + [0.01] * 60 + [1e-3] * 40,
                                cell=_random_cell(pt.D, pt.seed))
        if pt.noise:
            cell = cell.add_noise(pt.noise, generator=torch.Generator().manual_seed(pt.seed + 1))
        path = cell.save(os.path.join(out_dir, f"su_{tag}.pkl"))
        return {"cell_path": path, "stage": "su"}

    if pt.method == "ite":
        from ..algo.bp import BPConfig
        from ..algo.ite import ITEConfig, default_time_steps, full_ite

        cell = UnitCell.load(parent_path, device=dev) if parent_path else None
        cfg = ITEConfig(
            hamiltonian=hamiltonians.heisenberg_afm,
            time_steps=default_time_steps(
                float(extra.get("dt_start", 1e-2)),
                float(extra.get("dt_stop", 1e-4)),
                int(extra.get("steps_per_dt", 10))),
            seed=pt.seed)
        chi = int(2 * pt.D**2 * pt.chi_factor) + 10
        best, cell, tracker = full_ite(cell, cfg, N=pt.N, D=pt.D, chi=chi,
                                       bp_config=BPConfig(trunc_dim=2 * pt.D * pt.D), device=dev)
        path = cell.save(os.path.join(out_dir, f"ite_{tag}.pkl"))
        return {"cell_path": path, "best_energy": float(best), "stage": "ite"}

    if pt.method == "measure":
        from ..algo.bp import BPConfig, robust_belief_propagation
        from ..algo.measurements import measure_energies_and_observables

        if parent_path is None:
            raise ValueError("measure stage needs an upstream cell_path")
        cell = UnitCell.load(parent_path, device=dev).astype(torch.complex128).force_zero_rotation()
        # the recording convention: block N+1, χ×2 (reference run_ite defaults)
        n_m = pt.N + 1
        bp_m = BPConfig(trunc_dim=2 * pt.D * pt.D, dtype=torch.complex128).for_measurements(2.0)
        chi_m = 2 * (2 * pt.D * pt.D + 10)
        msgs, stats = robust_belief_propagation(cell, None, bp_m, n_m)
        meas = measure_energies_and_observables(cell, msgs, n_m, chi_m, bp_m.trunc_dim, h)
        return {"energy": meas.mean_energy, "bp_error": stats.final_error,
                "cell_path": parent_path, "stage": "measure"}

    raise ValueError(f"unknown DAG stage {pt.method!r}")
