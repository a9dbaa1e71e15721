"""Diagnostic: compare unit cells — energy, per-edge energies, per-site spin
polarisation (magnitude and mutual angles), entanglement negativity
(counterpart of the JAX package's tools/compare_cells.py, with its flags and
printout; ``--device`` added).

    python -m kagomeperiodicbp_tpu_torch.compare_cells cellA.pkl [cellB.pkl ...] [--n 3]
    python -m kagomeperiodicbp_tpu_torch.compare_cells tests/assets/pin_D3.pkl --n 2 --device cpu

Each cell is measured as saved (its dtype, its rotation): robust BP at
χ_msg = 2D²·chi_factor, the RDMs at χ = (2D²+10)·chi_factor. It runs on the
card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from .algo.bp import BPConfig, robust_belief_propagation
from .algo.measurements import measure_energies_and_observables
from .measure import setup_device
from .networks.unit_cell import UnitCell
from .physics.hamiltonians import heisenberg_afm


def analyze(path: str, N: int, chi_factor: float, device="cuda"):
    """Print the comparison block of one cell; returns its measurement."""
    cell = UnitCell.load(path, device=setup_device(device))
    D = cell.D
    chi = int((2 * D * D + 10) * chi_factor)
    cfg = BPConfig(trunc_dim=int(2 * D * D * chi_factor), dtype=cell.A.dtype)
    msgs, stats = robust_belief_propagation(cell, None, cfg, N)
    meas = measure_energies_and_observables(cell, msgs, N, chi, cfg.trunc_dim, heisenberg_afm())
    print(f"\n=== {os.path.basename(path)}  (D={D}, measured N={N}, chi={chi}) ===")
    print(f"mean energy/site: {meas.mean_energy:+.10f}   bp_err={stats.final_error:.2e}")
    print("per-edge:", {k: round(v, 6) for k, v in sorted(meas.energies.items())})
    vecs = {}
    for f in "ABC":
        v = np.array([meas.expectations[f][k] for k in "xyz"])
        vecs[f] = v
        print(f"  <S>_{f} = [{v[0]:+.4f} {v[1]:+.4f} {v[2]:+.4f}]  |S|={np.linalg.norm(v) / 2:.4f}")
    for a, b in ("AB", "BC", "AC"):
        na, nb = np.linalg.norm(vecs[a]), np.linalg.norm(vecs[b])
        if na > 1e-6 and nb > 1e-6:
            cos = float(np.dot(vecs[a], vecs[b]) / (na * nb))
            print(f"  angle({a},{b}) = {np.degrees(np.arccos(np.clip(cos, -1, 1))):.1f} deg")
    # scalar chirality of the polarisation triad
    tri = np.dot(vecs["A"], np.cross(vecs["B"], vecs["C"]))
    print(f"  chirality A.(BxC) = {tri:+.5f}")
    print("negativity:", {k: round(v, 5) for k, v in sorted(meas.entanglement.items())})
    return meas


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("cells", nargs="+")
    p.add_argument("--n", type=int, default=3)
    p.add_argument("--chi-factor", type=float, default=2.0)
    p.add_argument("--device", default="cuda", help="cuda (default) | cpu")
    args = p.parse_args(argv)
    return [analyze(path, args.n, args.chi_factor, args.device) for path in args.cells]


if __name__ == "__main__":
    main()
