"""Tiny CSV results manager, a copy of the JAX package's utils/csvs.py
(reference: src/utils/csvs.py
`CSVManager` — used by the condor workers and test scripts)."""
from __future__ import annotations

import csv
import os
import threading
from typing import Dict, List, Sequence


class CSVManager:
    def __init__(self, path: str, columns: Sequence[str]):
        self.path = path
        self.columns = list(columns)
        self._lock = threading.Lock()
        if not os.path.exists(path):
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            with open(path, "w", newline="") as fh:
                csv.writer(fh).writerow(self.columns)

    def append(self, row: Dict) -> None:
        with self._lock, open(self.path, "a", newline="") as fh:
            csv.writer(fh).writerow([row.get(c, "") for c in self.columns])

    def read(self) -> List[Dict]:
        with open(self.path, newline="") as fh:
            return list(csv.DictReader(fh))
