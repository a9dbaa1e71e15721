"""One run of one cell of the port's benchmark.

Everything a cell is made of is found by name: the cell in ``BENCHMARK.json``
names a configuration (``portbench/configs/<config>.json``) and a traffic mix
(``portbench/traffic/<mix>.json``); the mix names the entry that drives it
(``portbench/entries/<entry>.py``); each metric is a reader of its own
(``portbench/metrics/<metric>.py``, or its parent's where a metric is split
by cells, see ``reader_path``); the limits of the output check are
``portbench/limits/<cell>.json``. A new cell, configuration, mix or metric is
new files, and no existing file changes.

A run: make the cell on the device from the seed, set up and warm only the
shapes the mix uses (``setup_s`` is the time from process start to the first
timed step), measure whole steps for ``--seconds``, read the peak device
memory, free the program's state, check what the timed path produced against
the plain reference in ``portbench/reference``, and print the result as the
last line of standard output.
"""
from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import random
import sys
import time
from typing import Callable, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
BANNED = ("jax", "jaxlib", "flax", "kagomeperiodicbp_tpu")
STEP_SPAN = "portbench."


def banned_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, or the JAX package's
    (compared whole: the port's name begins with the JAX package's)."""
    return sorted(n for n in list(sys.modules) if n.split(".")[0] in BANNED)


def _json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_module(path: str, name: str):
    """A module from a file, under a name of our own (metric file names may
    hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(workload: str, root: str = ROOT, bench: Optional[dict] = None) -> dict:
    """Everything the named cell is made of, found by name."""
    bench = bench if bench is not None else _json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    here = os.path.join(root, "portbench")
    config = _json(os.path.join(here, "configs", cell["config"] + ".json"))
    traffic = _json(os.path.join(here, "traffic", cell["traffic"] + ".json"))
    limits_path = os.path.join(here, "limits", workload + ".json")
    limits = _json(limits_path) if os.path.exists(limits_path) else {}
    metrics = {}
    for kind in ("end_to_end", "per_layer"):
        metrics[kind] = [m for m in bench[kind] if applies(m, workload)]
    return {"workload": workload, "cell": cell, "config": config, "traffic": traffic,
            "limits": limits, "metrics": metrics, "root": root,
            "peaks": _json(os.path.join(here, "peaks.json"))}


def entry_driver(spec: dict):
    """The driver class of the mix's entry (portbench/entries/<entry>.py)."""
    entry = spec["traffic"]["entry"]
    path = os.path.join(spec["root"], "portbench", "entries", entry + ".py")
    return load_module(path, f"portbench_entry_{entry}").Driver


def reader_path(root: str, name: str) -> str:
    """The reader of a metric: portbench/metrics/<name>.py, or else that of
    the name with its last dotted part taken off, so that a metric split by
    cells for a bound of its own (ite_updates_per_s.d8) reads as the one it
    was split from."""
    parts = name.split(".")
    while parts:
        path = os.path.join(root, "portbench", "metrics", ".".join(parts) + ".py")
        if os.path.exists(path):
            return path
        parts.pop()
    raise FileNotFoundError(f"no reader for metric {name!r}")


def read_metrics(spec: dict, kind: str, run: dict) -> Dict[str, dict]:
    """{name: {"value", "unit"}} of the cell's `kind` metrics that their
    readers find something for."""
    out = {}
    for m in spec["metrics"][kind]:
        path = reader_path(spec["root"], m["name"])
        reader = load_module(path, "portbench_metric_" + m["name"].replace(".", "_"))
        value = reader.read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def _counters() -> dict:
    from kagomeperiodicbp_tpu_torch.ops import contract, kernels, linalg

    retries = sum(n for by_n in linalg.eigh_retries().values() for n in by_n.values())
    return {"swallows": contract.swallow_counts(), "launches": kernels.launch_counts(),
            "eigh_retries": retries}


def _delta(after: dict, before: dict) -> dict:
    out = {}
    for k, v in after.items():
        out[k] = _delta(v, before[k]) if isinstance(v, dict) else v - before[k]
    return out


def make_context(spec: dict, seed: int, device: str):
    """The inputs of a run, from the seed: the unit cell (made on the
    device by a generator of its own) and a host RNG for the check's sample."""
    import torch

    from kagomeperiodicbp_tpu_torch.networks.unit_cell import UnitCell

    cfg = spec["config"]
    dtype = getattr(torch, cfg["dtype"])
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (2 ** 63))
    cell = UnitCell.random(cfg["d"], cfg["D"], gen, dtype=dtype, device=device)
    return Context(spec, seed, device, dtype, cell)


class Context:
    """What an entry's driver is given: the configuration, the mix, the
    device and dtype, the cell, and an RNG seeded from the run's seed."""

    def __init__(self, spec, seed, device, dtype, cell):
        self.config = spec["config"]
        self.traffic = spec["traffic"]
        self.device = device
        self.dtype = dtype
        self.cell = cell
        self.rng = random.Random(seed)


def _sync(device: str) -> None:
    import torch

    if device.startswith("cuda"):
        torch.cuda.synchronize()


def measure(spec: dict, seed: int, seconds: float, trace: bool, device: str,
            t_process: float, on_window_end: Optional[Callable] = None) -> dict:
    """Set up, warm, measure and check one run; returns the result's parts."""
    import torch

    ctx = make_context(spec, seed, device)
    driver = entry_driver(spec)(ctx)
    driver.warm()
    _sync(device)
    prof = None
    trace_steps = int(spec["traffic"].get("trace_steps", 1)) if trace else 0
    if trace:
        from torch.profiler import ProfilerActivity, profile

        # a profiler's first session in a process can miss device activity:
        # open one, and drop it, before the session whose numbers are kept
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            torch.ones(1024, device=device).sum()
            _sync(device)
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    counters0 = _counters()

    setup_s = time.time() - t_process
    spans: List[tuple] = []
    attempted = failed = 0
    traced_until = None
    t0 = time.perf_counter()
    if prof is not None:
        prof.__enter__()
    try:
        while time.perf_counter() - t0 < seconds:
            i = attempted
            attempted += 1
            a = time.perf_counter()
            try:
                if prof is not None and traced_until is None:
                    with torch.profiler.record_function(f"{STEP_SPAN}{driver.step_kind} {i}"):
                        driver.step(i)
                else:
                    driver.step(i)
                ok = True
            except driver.step_errors:
                failed += 1
                ok = False
            b = time.perf_counter()
            spans.append((a, b, ok))
            if prof is not None and traced_until is None and attempted >= trace_steps:
                _sync(device)
                prof.__exit__(None, None, None)
                traced_until = attempted
        _sync(device)
    finally:
        if prof is not None and traced_until is None:
            prof.__exit__(None, None, None)
            traced_until = attempted
    window_s = time.perf_counter() - t0
    counters = _delta(_counters(), counters0)
    peak = torch.cuda.max_memory_allocated() if device.startswith("cuda") else 0
    if on_window_end is not None:
        on_window_end()
    # the reference runs after the program's state is freed: a process's
    # peak never falls again
    driver.release()
    gc.collect()
    if device.startswith("cuda"):
        torch.cuda.empty_cache()

    run = {
        "workload": spec["workload"], "config": spec["config"], "traffic": spec["traffic"],
        "peaks": spec["peaks"], "step": driver.step_kind, "setup_s": setup_s,
        "window_s": window_s, "attempted": attempted, "failed": failed,
        "steps": attempted - failed,
        "step_seconds": [b - a for a, b, ok in spans if ok],
        "counters": counters, "trace": None,
    }
    breakdown = None
    if prof is not None:
        run["trace"], breakdown = _read_trace(torch, prof, spans, traced_until)
    checks = driver.check(spec["limits"])
    return {"run": run, "checks": checks, "peak": peak, "breakdown": breakdown}


def _read_trace(torch, prof, spans, traced_until):
    from . import trace as T

    events = T.device_events(torch, prof, STEP_SPAN)
    steps = T.host_ranges(torch, prof, STEP_SPAN)
    if not steps:
        raise AssertionError("the trace holds none of the benchmark's step spans")
    lo, hi = steps[0][1], steps[-1][2]
    window = (hi - lo) / 1e6
    busy = T.busy_seconds(events, lo, hi)
    inside = [e for e in events if e[2] > lo and e[1] < hi]
    by_name: Dict[str, float] = {}
    for name, a, b in inside:
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e6
    rest = [(a, b) for a, b, ok in spans[traced_until:] if ok]
    trace = {"window_s": window, "busy_s": busy, "by_name": by_name,
             "steps": traced_until, "untraced_steps": len(rest),
             "untraced_s": sum(b - a for a, b in rest)}
    breakdown = {"device_ops": T.top_device({k: v * 1e6 for k, v in by_name.items()}),
                 "idle_gaps": T.idle_gaps(inside, steps, lo, hi)}
    return trace, breakdown


def device_record(peak: int, chips: int, trace: Optional[dict]) -> dict:
    import torch

    rec = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
           "memory_peak_bytes": int(peak)}
    if trace is not None:
        rec["busy_s"] = trace["busy_s"]
        rec["window_s"] = trace["window_s"]
    return rec


def judge(checks: Dict[str, dict]) -> bool:
    return bool(checks) and all(c["value"] <= c["limit"] for c in checks.values())


def main(argv=None, t_process: Optional[float] = None) -> int:
    t_process = time.time() if t_process is None else t_process
    p = argparse.ArgumentParser(description="Run one cell of the port's benchmark once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    spec = load_cell(args.workload)
    chips = int(spec["cell"]["chips"])
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    found: List[str] = []

    def guard():
        found.extend(banned_modules())

    out = measure(spec, args.seed, args.seconds, bool(args.trace), "cuda", t_process, guard)
    found.extend(banned_modules())
    if found:
        print("portbench: modules of JAX or of the JAX package were loaded: "
              + ", ".join(sorted(set(found))), file=sys.stderr)
        return 3
    run, checks = out["run"], out["checks"]
    kind = "per_layer" if args.trace else "end_to_end"
    metrics = read_metrics(spec, kind, run)
    result = {"correct": judge(checks), "attempted": run["attempted"], "failed": run["failed"],
              "metrics": metrics, "device": device_record(out["peak"], chips, run["trace"])}
    if args.trace and out["breakdown"] is not None:
        result["breakdown"] = out["breakdown"]
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0
