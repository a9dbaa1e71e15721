"""Environment-method accuracy: {random, bp, exact} environments of one unit
cell, per edge the RDM's fidelity against the exact environment's, its
energy, ⟨z⟩ on the first site, negativity, entanglement entropy and
hermiticity, to CSV (counterpart of the JAX package's
scripts/bp_accuracy.py, with its flags and columns; ``--device`` added).

    python -m kagomeperiodicbp_tpu_torch.bp_accuracy -D 2 -N 2
    python -m kagomeperiodicbp_tpu_torch.bp_accuracy -D 2 --device cpu --out /tmp/acc.csv

"exact" is BP at χ = ``--exact-chi`` terminated at 1e-14 (reference
scripts/tests/bp.py:53-55); "bp" robust BP at χ = 2D² (``--chi``); "random"
the random product messages. The cell and the random messages are drawn with
numpy from ``--seed`` (``--seed`` + 11 for the messages), the same numbers on
every device. It runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from .algo import edge_env as E
from .algo.bp import BPConfig, robust_belief_propagation
from .convert import messages_from_numpy, numpy_product_messages, numpy_random_cell, unit_cell_from_numpy
from .enums import UpdateEdge
from .measure import setup_device
from .ops import ite_kernels as K
from .physics import metrics as M
from .physics.hamiltonians import heisenberg_afm
from .utils.csvs import CSVManager

COLUMNS = ["D", "N", "chi", "method", "edge", "fidelity_vs_exact", "energy", "z_i",
           "negativity", "entropy", "hermicity"]
# the digits the JAX script writes each number with
DIGITS = {"fidelity_vs_exact": 10, "energy": 10, "z_i": 10, "negativity": 10, "entropy": 10,
          "hermicity": 12}
METHODS = ("random", "bp", "exact")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-D", type=int, default=2)
    p.add_argument("-N", type=int, default=2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--exact-chi", type=int, default=40)
    p.add_argument("--chi", type=int, default=None, help="production env chi (default 2D^2)")
    p.add_argument("--out", default="data/bp_accuracy.csv")
    p.add_argument("--device", default="cuda", help="cuda (default) | cpu")
    return p.parse_args(argv)


def edge_rhos(cell, msgs, N: int, env_chi: int) -> dict:
    """Each edge class's trace-normalised RDM [i, i*, j, j*] as numpy."""
    rhos = {}
    for edge in UpdateEdge.all_options():
        t1, t2, env, _ = E.edge_environment(cell, msgs, N, chi=env_chi, chi_msg=env_chi, edge=edge)
        rho = K.rho_ij(t1, t2, env).cpu().numpy()
        rhos[str(edge)] = rho / np.trace(np.trace(rho, axis1=2, axis2=3)).real
    return rhos


def env_messages(cell, method: str, N: int, chi: int, exact_chi: int, random_msgs, log=print):
    if method == "random":
        return random_msgs
    if method == "bp":
        msgs, stats = robust_belief_propagation(cell, None, BPConfig(trunc_dim=chi), N)
        log(f"  bp converged: err={stats.final_error:.3e} iters={stats.iterations}")
        return msgs
    # exact: high χ, tight termination (reference bp.py:53-55)
    cfg = BPConfig(trunc_dim=exact_chi, msg_diff_terminate=1e-14, max_iterations=200)
    msgs, stats = robust_belief_propagation(cell, None, cfg, N)
    log(f"  exact-env BP: err={stats.final_error:.3e} iters={stats.iterations}")
    return msgs


def accuracy_rows(cell, N: int, chi: int, exact_chi: int, random_msgs, methods=METHODS,
                  csv: CSVManager | None = None, log=print) -> list:
    """One row per method and edge (the JAX script's columns), appended to
    `csv` if given, rounded there as the JAX script rounds them.
    `random_msgs`: the "random" method's messages (a MessageDict at χ = `chi`
    on the cell's device)."""
    D = cell.D
    h_mat = M.rho_tensor_to_matrix(heisenberg_afm())
    sz = np.diag([0.5, -0.5])
    log("computing exact-env reference ...")
    exact_rhos = edge_rhos(cell, env_messages(cell, "exact", N, chi, exact_chi, None, log), N,
                           exact_chi)
    rows = []
    for method in methods:
        log(f"method={method} ...")
        env_chi = exact_chi if method == "exact" else chi
        rhos = (exact_rhos if method == "exact" else
                edge_rhos(cell, env_messages(cell, method, N, chi, exact_chi, random_msgs, log), N,
                          env_chi))
        for edge_name, rho in rhos.items():
            mat = M.rho_tensor_to_matrix(rho)
            fid = M.fidelity(mat, M.rho_tensor_to_matrix(exact_rhos[edge_name]))
            energy = float(np.real(np.trace(mat @ h_mat)))
            z_i = float(np.real(np.trace(np.trace(rho, axis1=2, axis2=3) @ sz)))
            row = {
                "D": D, "N": N, "chi": env_chi, "method": method, "edge": edge_name,
                "fidelity_vs_exact": fid, "energy": energy, "z_i": z_i,
                "negativity": M.negativity(mat), "entropy": M.entanglement_entropy(mat),
                "hermicity": M.hermicity(mat),
            }
            rows.append(row)
            if csv is not None:
                csv.append({k: round(v, DIGITS[k]) if k in DIGITS else v for k, v in row.items()})
            log(f"  {edge_name}: fid={fid:.8f} E={energy:+.6f} neg={row['negativity']:.4f}")
    return rows


def main(argv=None) -> list:
    args = parse_args(argv)
    device = setup_device(args.device)
    D, N = args.D, args.N
    chi = args.chi or 2 * D * D
    cell = unit_cell_from_numpy(numpy_random_cell(D, args.seed), device)
    random_msgs = messages_from_numpy(numpy_product_messages(N, D, chi, args.seed + 11), device)
    print(f"bp_accuracy D={D} N={N} chi={chi} exact_chi={args.exact_chi} device={device}")
    t0 = time.time()
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    rows = accuracy_rows(cell, N, chi, args.exact_chi, random_msgs, csv=CSVManager(args.out, COLUMNS))
    print(f"done in {time.time() - t0:.0f}s -> {args.out}")
    return rows


if __name__ == "__main__":
    main()
