"""The arithmetic that turns a profiler trace into numbers.

``device_events`` and ``fused_tensor_work`` are copied from ``chip_smoke.py``
(same names), ``top_device`` adapted from it; the busy time is
``chip_smoke.device_summary``'s merge of overlapping events, clipped to the
traced window; the idle gaps and their span labels are the benchmark's own.
"""
from __future__ import annotations

import bisect
from typing import Dict, List, Sequence, Tuple

Event = Tuple[str, float, float]  # (name, start µs, end µs)


def device_events(torch, prof, skip_prefix: str = "") -> List[Event]:
    """(name, start µs, end µs) of every device activity a profile saw, read
    from the profiler's raw events: building its FunctionEvents takes tens of
    seconds for a BP sweep's ~10⁵ launches. (chip_smoke.py; `skip_prefix`
    leaves out the device-side copies of the benchmark's own spans, which
    the profiler lays on the device's timeline too)"""
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3)
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == cuda and not (skip_prefix and e.name().startswith(skip_prefix))]


def host_ranges(torch, prof, prefix: str) -> List[Event]:
    """(name, start µs, end µs) of the host-side ``record_function`` ranges
    whose name starts with `prefix`, on the trace's clock."""
    cpu = torch.autograd.DeviceType.CPU
    return sorted(((e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3)
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == cpu and e.name().startswith(prefix)),
                  key=lambda r: r[1])


def top_device(by_name: Dict[str, float], n: int = 10) -> List[list]:
    """[name, seconds] of the `n` names with the most device time."""
    return [[name, t / 1e6] for name, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:n]]


def fused_tensor_work(n: int, d: int, D: int, element_size: int, complex_: bool):
    """K1's flops and bytes for n tensors [d, D,D,D,D]: d multiply-adds per
    output element (8 flops each in complex, 2 in real); the input read once
    and the D⁸ outputs written once, per tensor. (chip_smoke.py)"""
    return (n * (8 if complex_ else 2) * d * D ** 8,
            n * (d * D ** 4 + D ** 8) * element_size)


def busy_seconds(events: Sequence[Event], lo: float, hi: float) -> float:
    """Seconds within [lo, hi] µs in which some device activity ran."""
    busy, end = 0.0, lo
    for _, a, b in sorted(events, key=lambda e: e[1]):
        a, b = max(a, lo), min(b, hi)
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e6


def idle_gaps(events: Sequence[Event], spans: Sequence[Event], lo: float, hi: float,
              n: int = 10) -> List[list]:
    """The `n` longest stretches of [lo, hi] µs with no device activity, as
    [label, seconds]: the label is the benchmark span open at the gap's
    middle ("between steps" where none is)."""
    gaps = []
    end = lo
    for _, a, b in sorted(events, key=lambda e: e[1]):
        if a > end:
            gaps.append((end, min(a, hi)))
        end = max(end, b)
        if end >= hi:
            break
    if end < hi:
        gaps.append((end, hi))
    starts = [s[1] for s in spans]
    out = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:n]:
        mid = 0.5 * (a + b)
        i = bisect.bisect_right(starts, mid) - 1
        label = spans[i][0] if i >= 0 and spans[i][2] >= mid else "between steps"
        out.append([label, (b - a) / 1e6])
    return out
