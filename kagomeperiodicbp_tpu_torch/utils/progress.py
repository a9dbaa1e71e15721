"""Hierarchical progress reporting.

(reference: src/containers/visuals.py:31-46 — a 6-level
progress-bar hierarchy {ITE-main, ITE-per-delta-t, ITE-per-segment,
ITE-per-mode, BlockBP, bubblecon} each individually activatable; and
src/utils/prints.py ProgressBar.)

Re-designed for headless and piped runs: each level renders a single
rewritable line (TTY) or a throttled plain log line (pipe), indented by its
depth. Levels are named; inactive levels are zero-cost no-ops.
"""
from __future__ import annotations

import sys
import time
from typing import Dict, Optional

LEVELS = (
    "ITE-main",
    "ITE-per-delta-t",
    "ITE-per-segment",
    "ITE-per-mode",
    "BlockBP",
    "bubblecon",
)


class ProgressBar:
    """One level of the hierarchy. `next(extra_str=...)` advances; `clear()`
    ends the line. Inactive bars do nothing."""

    def __init__(self, total: int, desc: str = "", level: int = 0,
                 active: bool = True, stream=None, min_interval: float = 0.25):
        self.total = max(int(total), 1)
        self.desc = desc
        self.level = level
        self.active = active
        self.count = 0
        self._stream = stream or sys.stderr
        self._min_interval = min_interval
        self._last = 0.0
        self._tty = hasattr(self._stream, "isatty") and self._stream.isatty()

    def next(self, extra_str: str = "") -> None:
        self.count += 1
        if not self.active:
            return
        now = time.time()
        if now - self._last < self._min_interval and self.count < self.total:
            return
        self._last = now
        indent = "  " * self.level
        frac = min(self.count / self.total, 1.0)
        n_full = int(frac * 20)
        bar = "█" * n_full + "·" * (20 - n_full)
        line = f"{indent}{self.desc} [{bar}] {self.count}/{self.total} {extra_str}"
        if self._tty:
            self._stream.write("\r" + line[:120].ljust(120))
        else:
            self._stream.write(line + "\n")
        self._stream.flush()

    def clear(self) -> None:
        if self.active and self._tty:
            self._stream.write("\r" + " " * 120 + "\r")
            self._stream.flush()


class ProgressHierarchy:
    """Factory holding the per-level activation map
    (reference: visuals.ProgressBarsConfig)."""

    def __init__(self, active: bool | Dict[str, bool] = False):
        if isinstance(active, bool):
            self.active = {name: active for name in LEVELS}
        else:
            self.active = {name: bool(active.get(name, False)) for name in LEVELS}

    def bar(self, level_name: str, total: int, desc: str = "") -> ProgressBar:
        level = LEVELS.index(level_name) if level_name in LEVELS else 0
        return ProgressBar(
            total, desc=desc or level_name, level=level,
            active=self.active.get(level_name, False),
        )


def get_progress_bar(hierarchy: Optional[ProgressHierarchy], total: int,
                     desc: str, level_name: str) -> ProgressBar:
    """None-safe accessor (reference: main.py get_progress_bar)."""
    if hierarchy is None:
        return ProgressBar(total, desc=desc, active=False)
    return hierarchy.bar(level_name, total, desc)
