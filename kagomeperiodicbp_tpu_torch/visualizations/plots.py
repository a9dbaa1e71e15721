"""Plotting: lattice/TN structure and ITE convergence dashboards.

(counterpart of kagomeperiodicbp_tpu/visualizations/plots.py; reference:
src/visualizations/ite.py:280 `ITEPlots` live
dashboards and src/tensor_networks/visualizations.py — here matplotlib is
imported lazily and everything degrades to no-ops when unavailable/headless.)
"""
from __future__ import annotations

import math
from typing import Optional


def _plt():
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def plot_block(N: int, ax=None, with_messages: bool = True, save: Optional[str] = None):
    """Draw the size-N Kagome block (nodes, edges, boundary legs)."""
    plt = _plt()
    from ..lattices import BlockSide, KagomeBlock

    block = KagomeBlock.build(N)
    if ax is None:
        _, ax = plt.subplots(figsize=(7, 7))
    pos = block.positions
    for v in range(block.n_nodes):
        for leg in range(4):
            n = block.neighbors[v, leg]
            if n >= 0 and n > v:
                ax.plot([pos[v, 0], pos[n, 0]], [pos[v, 1], pos[n, 1]], "b-", lw=0.8)
            elif n < 0 and with_messages:
                d = block.node_dirs(v)[leg]
                ax.plot(
                    [pos[v, 0], pos[v, 0] + 0.8 * d.unit[0]],
                    [pos[v, 1], pos[v, 1] + 0.8 * d.unit[1]],
                    "g--", lw=0.6,
                )
    colors = ["tab:red", "tab:green", "tab:blue"]
    for k in range(3):
        sel = block.kinds == k
        ax.scatter(pos[sel, 0], pos[sel, 1], c=colors[k], s=30, label="ABC"[k], zorder=3)
    ax.legend()
    ax.set_aspect("equal")
    ax.set_title(f"Kagome block N={N} ({block.n_nodes} nodes)")
    if save:
        plt.savefig(save, dpi=120, bbox_inches="tight")
    return ax


def plot_tracker(tracker, reference_energy: Optional[float] = None, save: Optional[str] = None):
    """Energy-vs-segment convergence plot from an ITETracker."""
    plt = _plt()
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11, 4))
    ax1.plot(tracker.energies, ".-", label="energy/site")
    if reference_energy is not None:
        ax1.axhline(reference_energy, color="k", ls=":", label="reference")
    ax1.set_xlabel("segment")
    ax1.set_ylabel("energy/site")
    ax1.legend()
    if reference_energy is not None:
        err = [e - reference_energy for e in tracker.energies]
        ax2.semilogy([abs(e) for e in err], ".-")
        ax2.set_xlabel("segment")
        ax2.set_ylabel("|E − E_ref|")
    ax2b = ax2.twinx()
    ax2b.semilogy(tracker.delta_ts, "r--", alpha=0.5)
    ax2b.set_ylabel("δt", color="r")
    if save:
        fig.savefig(save, dpi=120, bbox_inches="tight")
    return fig


def plot_health(tracker, save: Optional[str] = None):
    """Environment/state health per segment: worst-edge hermicity error,
    worst |Σλ − 1|, and per-edge negativity (reference: the 'environment and
    state health' figure, visualizations/ite.py:280/355)."""
    plt = _plt()
    segs = [s for s in tracker.stats if s.edge_health]
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11, 4))
    if segs:
        herm = [max(h["hermicity"] for h in s.edge_health.values()) for s in segs]
        eig = [max(abs(h["sum_eigenvalues"] - 1.0) for h in s.edge_health.values())
               for s in segs]
        neg = [max(h["negativity"] for h in s.edge_health.values()) for s in segs]
        ax1.semilogy([max(v, 1e-18) for v in herm], ".-", label="max hermicity err")
        ax1.semilogy([max(v, 1e-18) for v in eig], ".-", label="max |Σλ−1|")
        ax1.legend()
        ax2.plot(neg, ".-", color="tab:purple")
    ax1.set_xlabel("segment")
    ax1.set_title("environment health")
    ax2.set_xlabel("segment")
    ax2.set_ylabel("max edge negativity")
    ax2.set_title("entanglement")
    if save:
        fig.savefig(save, dpi=120, bbox_inches="tight")
    return fig


def plot_cores(tracker, save: Optional[str] = None):
    """Core polarization per flavor: |⟨σ⟩| magnitude and the mutual angles of
    the three sublattice spins (reference: the 'cores polarization' Bloch
    figure, visualizations/ite.py:280 — here as series, headless-friendly)."""
    import numpy as np

    plt = _plt()
    segs = [s for s in tracker.stats if s.expectations]
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11, 4))
    if segs:
        vecs = {
            f: np.array([[s.expectations[f][k] for k in "xyz"] for s in segs])
            for f in "ABC"
        }
        for f, v in vecs.items():
            ax1.plot(np.linalg.norm(v, axis=1), ".-", label=f"|⟨σ⟩| {f}")
        ax1.legend()
        for a, b in (("A", "B"), ("B", "C"), ("A", "C")):
            va, vb = vecs[a], vecs[b]
            den = np.linalg.norm(va, axis=1) * np.linalg.norm(vb, axis=1)
            cos = np.einsum("ij,ij->i", va, vb) / np.where(den == 0, 1.0, den)
            ang = np.degrees(np.arccos(np.clip(cos, -1, 1)))
            ax2.plot(ang, ".-", label=f"∠({a},{b})")
        ax2.axhline(120.0, color="k", ls=":", lw=0.8)
        ax2.legend()
    ax1.set_xlabel("measured segment")
    ax1.set_title("core polarization magnitude")
    ax2.set_xlabel("measured segment")
    ax2.set_ylabel("degrees")
    ax2.set_title("sublattice spin angles (120° = q0 order)")
    if save:
        fig.savefig(save, dpi=120, bbox_inches="tight")
    return fig


class ITEPlots:
    """Live dashboards updated per segment (reference: visualizations/ite.py:280
    runs three live figures — main convergence, environment/state health, core
    polarization). Writes three PNGs next to `out_path` (headless-safe)."""

    def __init__(self, active: bool = True, out_path: str = "logs/ite_progress.png",
                 reference_energy: Optional[float] = None):
        self.active = active
        self.out_path = out_path
        self.reference_energy = reference_energy

    def update(self, tracker) -> None:
        if not self.active or not tracker.energies:
            return
        try:
            import os

            base = os.path.abspath(self.out_path)
            os.makedirs(os.path.dirname(base), exist_ok=True)
            root, ext = os.path.splitext(base)
            plt = _plt()
            for fig in (
                plot_tracker(tracker, self.reference_energy, save=base),
                plot_health(tracker, save=f"{root}_health{ext}"),
                plot_cores(tracker, save=f"{root}_cores{ext}"),
            ):
                plt.close(fig)
        except Exception:
            self.active = False  # headless/broken matplotlib → stop trying
