from .sweep import SweepPoint, run_sweep

__all__ = ["SweepPoint", "run_sweep"]
