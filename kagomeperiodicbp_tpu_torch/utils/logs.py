"""Process monitoring for long runs.

(reference: src/utils/processes.py:93 `monitor_crnt_process` psutil
sampler thread)
"""
from __future__ import annotations

import os
import threading
import time
from typing import Optional


class ProcessMonitor:
    """Daemon thread sampling CPU%/RSS to a log file on an interval
    (reference: processes.py:93-152)."""

    def __init__(self, log_path: str, interval: float = 10.0,
                 track_cpu: bool = True, track_ram: bool = True):
        self.log_path = log_path
        self.interval = interval
        self.track_cpu = track_cpu
        self.track_ram = track_ram
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "ProcessMonitor":
        try:
            import psutil  # noqa: F401
        except ImportError:
            return self  # no psutil → no-op monitor
        os.makedirs(os.path.dirname(os.path.abspath(self.log_path)), exist_ok=True)
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()

    def _run(self) -> None:
        import psutil

        proc = psutil.Process()
        with open(self.log_path, "a") as fh:
            while not self._stop.wait(self.interval):
                parts = [time.strftime("%H:%M:%S")]
                if self.track_cpu:
                    parts.append(f"cpu={proc.cpu_percent():.1f}%")
                if self.track_ram:
                    parts.append(f"rss={proc.memory_info().rss / 2**30:.2f}GB")
                fh.write(" ".join(parts) + "\n")
                fh.flush()
