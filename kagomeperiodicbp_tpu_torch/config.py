"""The sizes a run derives from its bond dimension (counterpart of the part
of kagomeperiodicbp_tpu/config.py that the ITE command line reads).

(reference: src/containers/global_config.py:28 `Config` with
dimension-derived defaults and the χ escalation)
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

from .algo.bp import BPConfig


@dataclass
class Config:
    D: int
    bp: BPConfig
    chi_factor: float = 1.0
    trunc_dim: Optional[int] = None  # χ of the bubble contractions; derived from D if None

    @property
    def chi(self) -> int:
        """Bubble χ = 2D²·factor + 10 (reference: global_config.py:43-48)."""
        if self.trunc_dim is not None:
            return self.trunc_dim
        return int(2 * self.D * self.D * self.chi_factor) + 10

    @staticmethod
    def derive_from_dimensions(D: int, chi_factor: float = 1.0, **bp_kwargs) -> "Config":
        """χ_msg = 2D² for BP, the bubble χ from D and `chi_factor`."""
        return Config(D, BPConfig(trunc_dim=2 * D * D, **bp_kwargs), chi_factor)

    def strengthen(self, factor: float = 1.5) -> "Config":
        """χ escalation (reference: global_config.py:92): BP's χ and the
        bubble χ each ×factor + 1. The same escalation that
        `robust_belief_propagation` applies mid-run, for a run restarted
        harder."""
        return dataclasses.replace(
            self, bp=dataclasses.replace(self.bp, trunc_dim=int(self.bp.trunc_dim * factor) + 1),
            trunc_dim=int(self.chi * factor) + 1)
