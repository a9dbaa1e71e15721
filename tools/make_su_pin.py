#!/usr/bin/env python
"""Write the simple-update warm-start pin: a D=3 seed cell made with numpy
and what the JAX package makes of it, for the port to be held to on the
card (chip_smoke.py phase 10) and on the CPU (tests/test_torch_su.py).

* tests/assets/su_q0_D3.pkl — the seed: the 120° q=0 product state
  (``run_ite --cell su:q0``'s) plus 2% complex Gaussian noise per tensor
  (run_ite's default --init-noise), from numpy's generator seeded 0; the
  pickle of numpy arrays either package's ``UnitCell.load`` reads;
* tests/assets/su_q0_D3.json — the JAX package's ``simple_update`` of the
  seed in complex128 over LADDER, the default ladder less its 200 sweeps at
  dt=0.1: its λ spectra by edge class, its cell (which the CPU test
  measures with the port), the cell's fingerprint (each flavour's one-site
  density matrix Σ t·t†, which a unitary gauge on the bonds leaves as it
  is), and the rows of ``scripts/increasing_block_measurements.py`` on that
  cell at N=2 and N=3 (BP at χ_msg = 2D², the six edge RDMs at χ = 2D²+10);
  and, under "default_ladder", the λ of the default ladder from the seed
  and from the seed scaled by 1 + 1e-15, and how far apart they are. From
  this seed the default ladder's dt=0.1 block does not settle, and the
  JAX package's own result moves by O(0.1) under that change of the seed,
  so no other implementation can be held to it; without that block the
  simple update settles to one fixed point.

It imports both packages and runs on the CPU (a few minutes):

    JAX_PLATFORMS=cpu python tools/make_su_pin.py
"""
import json
import os
import pickle
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
ASSETS = os.path.join(REPO, "tests", "assets")
D, NOISE, SEED = 3, 0.02, 0
PUBLISHED_SU_D3 = -0.41786   # BASELINE.md
LADDER = [0.01] * 200 + [1e-3] * 200 + [1e-4] * 100
PERTURB = 1e-15


def seed_cell() -> dict:
    """The q=0 product state (chirality +1, UnitCell.product_state_120) plus
    NOISE·‖t‖ of complex Gaussian noise per tensor."""
    rng = np.random.default_rng(SEED)
    out = {"rotated": 0}
    for k, f in enumerate("ABC"):
        alpha = 2.0 * np.pi / 3.0 * k
        t = np.zeros((2,) + (D,) * 4, dtype=np.complex128)
        t[0, 0, 0, 0, 0] = np.cos(alpha / 2.0)
        t[1, 0, 0, 0, 0] = np.sin(alpha / 2.0)
        noise = rng.standard_normal(t.shape) + 1j * rng.standard_normal(t.shape)
        out[f] = t + noise * (NOISE * np.linalg.norm(t) / np.linalg.norm(noise))
    return out


def fingerprint(cell: dict) -> dict:
    """Each flavour's one-site density matrix Σ_v t[s,v] conj(t[s',v]) /
    ‖t‖², as [[re, im], …] rows."""
    res = {}
    for f in "ABC":
        t = np.asarray(cell[f]).reshape(2, -1)
        rho = t @ t.conj().T / np.vdot(t, t).real
        res[f] = [[[z.real, z.imag] for z in row] for row in rho]
    return res


def complex_lists(a) -> dict:
    a = np.asarray(a)
    return {"shape": list(a.shape), "re": a.real.ravel().tolist(), "im": a.imag.ravel().tolist()}


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from kagomeperiodicbp_tpu.algo.simple_update import simple_update
    from kagomeperiodicbp_tpu.networks.unit_cell import UnitCell
    from kagomeperiodicbp_tpu.physics import hamiltonians
    from scripts import increasing_block_measurements as ibm

    seed = seed_cell()
    with open(os.path.join(ASSETS, "su_q0_D3.pkl"), "wb") as fh:
        pickle.dump(seed, fh)
    h = hamiltonians.heisenberg_afm()
    cell = UnitCell(*(jnp.asarray(seed[f]) for f in "ABC"))
    su, lams = simple_update(h, D=D, cell=cell, dtype=jnp.complex128, time_steps=LADDER)
    default = [simple_update(h, D=D, cell=UnitCell(*(jnp.asarray(seed[f] * (1 + e)) for f in "ABC")),
                             dtype=jnp.complex128)[1] for e in (0.0, PERTURB)]
    default_move = max(float(np.abs(np.asarray(default[0][k]) - np.asarray(default[1][k])).max())
                       for k in default[0])
    su_np = {f: np.asarray(su[f]) for f in "ABC"}
    # the JAX script's per-side BP program (the batched one computes the
    # same messages and compiles for minutes on the CPU)
    os.environ["KPBP_BP_BATCHED"] = "0"
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "su.pkl")
        su.save(path)
        rows = ibm.main(["--cell", path, "-D", str(D), "--n-min", "2", "--n-max", "3",
                         "--dtype", "complex128", "--csv", os.path.join(tmp, "rows.csv")])
    res = {
        "seed": f"su:q0 of D={D}: UnitCell.product_state_120 + {NOISE} complex Gaussian noise "
                f"(numpy default_rng({SEED})), tests/assets/su_q0_D3.pkl",
        "D": D,
        "dtype": "complex128",
        "time_steps": "[0.01] * 200 + [1e-3] * 200 + [1e-4] * 100: the default ladder less its dt=0.1 block",
        "lambdas": {f"{k[0]},{k[1]}": np.asarray(v).tolist() for k, v in sorted(lams.items())},
        "default_ladder": {
            "lambdas": {f"{k[0]},{k[1]}": np.asarray(v).tolist() for k, v in sorted(default[0].items())},
            "perturbation": PERTURB,
            "lambda_move": default_move,
        },
        "fingerprint": fingerprint(su_np),
        "su_cell": {f: complex_lists(su_np[f]) for f in "ABC"},
        "rows": rows,
        "chi_msg": 2 * D * D,
        "chi": 2 * D * D + 10,
        "published_su_energy": PUBLISHED_SU_D3,
    }
    with open(os.path.join(ASSETS, "su_q0_D3.json"), "w") as fh:
        json.dump(res, fh, indent=1)
    print(json.dumps({"rows": rows, "lambdas": res["lambdas"], "default_ladder_move": default_move}))


if __name__ == "__main__":
    main()
