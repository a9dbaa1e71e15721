"""Cross-implementation validation: a foreign (tnsu-format) Kagome tensor
set measured with this port's BlockBP pipeline (counterpart of the JAX
package's scripts/load_external_su.py, with its flags and JSON keys;
``--device`` added).

    python -m kagomeperiodicbp_tpu_torch.load_external_su --all
    python -m kagomeperiodicbp_tpu_torch.load_external_su set.dat --device cpu

(reference: scripts/tests/su_itai_vs_roy/main.py:26-80 and
src/unit_cell/get_from/_simple_update.py:272-291.) The tnsu sets are saved
after ``absorb_all_weights()``, so a single-periodic-cell set maps onto
(A, B, C) as it is; ``utils/foreign.load_tnsu`` reads the pickle without the
foreign package. ``--folder`` defaults to ``utils/foreign.DEFAULT_TNSU_FOLDER``.
It runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import re

import numpy as np
import torch

from .algo.arbitrary import ArbitraryKagomeTN
from .algo.bp import BPConfig
from .measure import setup_device
from .networks.unit_cell import UnitCell
from .physics import hamiltonians
from .utils.foreign import DEFAULT_TNSU_FOLDER, load_tnsu


def measure_set(path: str, N: int = 2, average_shifts: bool = False, chi_factor: float = 1.0,
                device="cuda") -> dict:
    """The set's energy per site and its six edge energies at block N, BP at
    χ_msg = 2D², the RDMs at χ = (2D²+10)·chi_factor, in complex128."""
    device = setup_device(device)
    data = load_tnsu(path)
    if len(data["tensors"]) != 3:
        raise SystemExit(
            f"{path}: {len(data['tensors'])} tensors — only single-periodic-cell (3-tensor) "
            "sets are supported (size>=2 sets use the foreign lattice's own node order; map "
            "them externally first)")
    cell = UnitCell(*(torch.tensor(np.asarray(t)).to(device=device, dtype=torch.complex128)
                      for t in data["tensors"]))
    D = cell.D
    chi = int((2 * D * D + 10) * chi_factor)
    h = hamiltonians.BY_NAME["AFM"]()
    tn = ArbitraryKagomeTN.from_unit_cell(cell, N)
    meas = tn.measure(h, BPConfig(trunc_dim=2 * D * D, dtype=torch.complex128), chi=chi,
                      average_shifts=average_shifts)
    energies = {k: float(v) for k, v in meas.energies.items()}
    return {
        "file": os.path.basename(path),
        "D": D,
        "N": N,
        "chi": chi,
        "foreign_energy": data["final_energy"],
        "mean_energy": meas.mean_energy,  # per site: Σ 6 edge classes / 3
        "edge_energies": energies,
        "edge_spread": float(np.ptp(list(energies.values()))),
    }


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("path", nargs="?", help="a tnsu .dat file")
    p.add_argument("--folder", default=DEFAULT_TNSU_FOLDER)
    p.add_argument("-D", type=int, default=None, help="pick the size=1 PBC set of this D")
    p.add_argument("--all", action="store_true", help="measure every size=1 PBC set")
    p.add_argument("-N", type=int, default=2, help="measurement block size")
    p.add_argument("--chi-factor", type=float, default=1.0)
    p.add_argument("--average-shifts", action="store_true")
    p.add_argument("--device", default="cuda", help="cuda (default) | cpu")
    args = p.parse_args(argv)

    if args.path:
        paths = [args.path]
    elif args.all:
        paths = sorted(glob.glob(os.path.join(args.folder, "*size=1_PBC.dat")),
                       key=lambda s: int(re.search(r"D=(\d+)", s).group(1)))
    elif args.D is not None:
        paths = [os.path.join(args.folder, f"tnsu_AFH_D={args.D}_size=1_PBC.dat")]
    else:
        p.error("give a path, -D, or --all")

    out = []
    for path in paths:
        out.append(measure_set(path, N=args.N, average_shifts=args.average_shifts,
                               chi_factor=args.chi_factor, device=args.device))
        print(json.dumps(out[-1]))
    return out


if __name__ == "__main__":
    main()
