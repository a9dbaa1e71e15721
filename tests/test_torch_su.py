"""The warm start of the port against the JAX package, on the CPU in
complex128 (1e-10 unless stated):

* ``algo/simple_update`` from one numpy seed cell over a short ladder: the λ
  spectra, the cells' one-site density matrices and their measured energy,
  all gauge-free;
* ``run_ite``'s ``--cell su:…`` and ``--cell tnsu:<path>`` starts, and
  ``utils/foreign.load_tnsu`` on a tnsu-format pickle written here;
* the D=3 pin ``tests/assets/su_q0_D3.{pkl,json}`` (``tools/make_su_pin.py``):
  the port's simple update of its seed against the JAX package's λ, and one
  ``increasing_block_measurements`` row of the JAX package's SU cell against
  the JAX script's ``main``;
* that no module of the port, nor ``chip_smoke.py``, imports JAX or the JAX
  package, in a fresh process.
"""
import csv
import json
import logging
import os
import pickle
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kagomeperiodicbp_tpu.algo.simple_update import simple_update as jax_simple_update
from kagomeperiodicbp_tpu.networks.unit_cell import UnitCell as JUnitCell
from kagomeperiodicbp_tpu.utils import foreign as jax_foreign
from kagomeperiodicbp_tpu_torch import increasing_block_measurements as ibm
from kagomeperiodicbp_tpu_torch import run_ite
from kagomeperiodicbp_tpu_torch.algo.simple_update import edge_classes, simple_update
from kagomeperiodicbp_tpu_torch.convert import lambdas_from_numpy, to_numpy, unit_cell_from_numpy
from kagomeperiodicbp_tpu_torch.networks.unit_cell import UnitCell
from kagomeperiodicbp_tpu_torch.physics import hamiltonians
from kagomeperiodicbp_tpu_torch.utils import foreign

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(REPO, "tests", "assets")
D = 2
TOL = 1e-10
LADDER = [0.1] * 20 + [0.01] * 20


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def numpy_cell(seed, D=D):
    rng = np.random.default_rng(seed)

    def one():
        t = rng.standard_normal((2,) + (D,) * 4) + 1j * rng.standard_normal((2,) + (D,) * 4)
        return t / np.linalg.norm(t)

    return {"A": one(), "B": one(), "C": one(), "rotated": 0}


def one_site_rho(cell) -> np.ndarray:
    """Each flavour's one-site density matrix: unchanged by a unitary gauge
    on the bonds."""
    out = []
    for f in "ABC":
        t = np.asarray(cell[f]).reshape(2, -1)
        out.append(t @ t.conj().T / np.vdot(t, t).real)
    return np.stack(out)


def _energy(cell: UnitCell, D: int, N: int = 2) -> float:
    return ibm.measure_rows(cell, D, N, N, torch.complex128)[0]["mean_energy"]


# ---------------------------- simple update --------------------------------


def test_simple_update_matches_jax():
    data = numpy_cell(21)
    h = hamiltonians.heisenberg_afm()
    jcell, jlams = jax_simple_update(h, D, time_steps=LADDER,
                                     cell=JUnitCell(*(jnp.asarray(data[f]) for f in "ABC")))
    cell, lams = simple_update(h, D, time_steps=LADDER, cell=unit_cell_from_numpy(data))
    assert sorted(lams) == sorted(jlams) == sorted((int(e.first), int(e.second))
                                                   for e, _, _ in edge_classes())
    want = lambdas_from_numpy({k: np.asarray(v) for k, v in jlams.items()})
    for k, lam in lams.items():
        assert lam.dtype == torch.float64
        assert (lam - want[k]).abs().max().item() < TOL, k
    jnp_cell = {f: np.asarray(jcell[f]) for f in "ABC"}
    assert np.abs(one_site_rho(to_numpy(cell)) - one_site_rho(jnp_cell)).max() < TOL
    # the measured energy of either cell: a gauge leaves it as it is
    e_port, e_jax = _energy(cell, D), _energy(unit_cell_from_numpy(jnp_cell), D)
    assert abs(e_port - e_jax) < TOL
    assert e_port < -0.3


# ------------------------------ run_ite starts ------------------------------


def _start(cell_arg, **extra):
    args = run_ite.parse_args(["-D", str(D), "--cell", cell_arg, "--device", "cpu",
                               *sum((["--" + k.replace("_", "-"), str(v)] for k, v in extra.items()), [])])
    return run_ite.initial_cell(args, torch.complex128, torch.device("cpu"), logging.getLogger("t"))


@pytest.mark.parametrize("seed", ["q0"])
def test_run_ite_su_start(seed, monkeypatch):
    """``--cell su:<seed>`` runs the simple update on the seed run_ite draws
    for it (the same generator, --init-noise): the SU of that seed cell,
    here over the short ladder (the default one's 700 sweeps test nothing
    more of the start)."""
    monkeypatch.setattr(run_ite, "simple_update",
                        lambda *a, **kw: simple_update(*a, **kw, time_steps=LADDER))
    cell = _start(f"su:{seed}")
    gen = torch.Generator().manual_seed(0)
    if seed == "q0":
        seed_cell = UnitCell.product_state_120(2, D, +1).add_noise(0.02, gen)
    else:
        seed_cell = UnitCell.random_product_state(2, D, gen)
    want, _ = simple_update(hamiltonians.heisenberg_afm(), D, cell=seed_cell, time_steps=LADDER)
    for f in "ABC":
        assert cell[f].shape == (2,) + (D,) * 4
        assert torch.equal(cell[f], want[f])
    with pytest.raises(SystemExit):
        _start("su:bogus")


def _tnsu_pickle(path, tensors, final_energy=None):
    """A tnsu-format set (``foreign.write_tnsu``), its `virtual_dim` stale
    as on some published sets: D comes from the tensors."""
    return foreign.write_tnsu(path, tensors, final_energy, virtual_dim=99)


def test_load_tnsu_matches_jax(tmp_path):
    cell = numpy_cell(22)
    tensors = [cell[f] for f in "ABC"]
    path = _tnsu_pickle(tmp_path / "tnsu_AFH_D=2_size=1_PBC.dat", tensors)
    got, want = foreign.load_tnsu(path), jax_foreign.load_tnsu(path)
    assert got["D"] == want["D"] == D and got["final_energy"] is want["final_energy"] is None
    for a, b, t in zip(got["tensors"], want["tensors"], tensors):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, t)
    big = _tnsu_pickle(tmp_path / "size2.dat", tensors * 7, final_energy=-0.38)
    assert foreign.load_tnsu(big)["final_energy"] == jax_foreign.load_tnsu(big)["final_energy"] == -0.38
    with pytest.raises(ValueError, match="21 tensors"):
        foreign.tnsu_unit_cell(D, path=big)
    with pytest.raises(FileNotFoundError):
        foreign.tnsu_unit_cell(D, folder=str(tmp_path / "none"))


def test_run_ite_tnsu_start(tmp_path):
    cell = numpy_cell(23)
    path = _tnsu_pickle(tmp_path / "set.dat", [cell[f] for f in "ABC"], final_energy=-0.1)
    got = _start(f"tnsu:{path}", init_noise=0)
    jcell, energy = jax_foreign.tnsu_unit_cell(D, path=path)
    assert energy == -0.1
    for f in "ABC":
        np.testing.assert_array_equal(got[f].numpy(), np.asarray(jcell[f]))
    noisy = _start(f"tnsu:{path}")   # run_ite's default --init-noise 0.02
    rel = [(noisy[f] - got[f]).norm().item() / got[f].norm().item() for f in "ABC"]
    assert all(abs(r - 0.02) < 1e-12 for r in rel)


# ------------------------ increasing-block measurements ----------------------


@pytest.fixture(scope="module")
def su_pin():
    """tests/assets/su_q0_D3.json (tools/make_su_pin.py) with the JAX
    package's SU cell as numpy arrays."""
    with open(os.path.join(ASSETS, "su_q0_D3.json")) as fh:
        pin = json.load(fh)
    cell = {f: (np.asarray(c["re"]) + 1j * np.asarray(c["im"])).reshape(c["shape"])
            for f, c in pin["su_cell"].items()}
    return pin, cell


def test_increasing_block_row_matches_jax_script(tmp_path, su_pin):
    """The port's command line on a pickled cell (the JAX package's D=3 SU
    cell) against the N=2 row the JAX script's ``main`` gave for the same
    pickle in tools/make_su_pin.py: 1e-9, the measurement pin's bar (the
    JAX script's BP and measurement compile for a minute on this CPU, so its
    row is read from the asset)."""
    pin, cell = su_pin
    path = str(tmp_path / "su.pkl")
    with open(path, "wb") as fh:
        pickle.dump({**cell, "rotated": 0}, fh)
    got = ibm.main(["--cell", path, "-D", str(pin["D"]), "--n-min", "2", "--n-max", "2",
                    "--device", "cpu", "--csv", str(tmp_path / "port.csv")])
    want = next(r for r in pin["rows"] if r["N"] == 2)
    assert len(got) == 1
    assert {k: got[0][k] for k in ("N", "D", "bp_iters")} == {k: want[k] for k in ("N", "D", "bp_iters")}
    assert abs(got[0]["mean_energy"] - want["mean_energy"]) < 1e-9
    assert got[0]["bp_error"] < 1e-10
    with open(tmp_path / "port.csv") as fh:
        rows = list(csv.reader(fh))
    assert rows[0] == ibm.COLUMNS == ["N", "D", "mean_energy", "bp_error", "bp_iters"]
    assert len(rows) == 2 and float(rows[1][2]) == got[0]["mean_energy"]


def test_su_pin_asset_matches_port_simple_update(su_pin):
    """The seed of the pin, su_q0_D3.pkl, through the port's simple update
    on the CPU over the pin's ladder (the default one less its dt=0.1 block,
    which from this seed amplifies round-off to O(0.1) in the JAX package
    itself): the JAX package's λ spectra and the fingerprint of its cell
    (one-site density matrices, gauge-free)."""
    pin, cell = su_pin
    fp = np.stack([np.asarray(pin["fingerprint"][f])[..., 0] + 1j * np.asarray(pin["fingerprint"][f])[..., 1]
                   for f in "ABC"])
    assert np.abs(one_site_rho(cell) - fp).max() < 1e-14
    seed = UnitCell.load(os.path.join(ASSETS, "su_q0_D3.pkl"))
    assert seed.D == pin["D"] == 3
    su, lams = simple_update(hamiltonians.heisenberg_afm(), pin["D"], cell=seed,
                             time_steps=[0.01] * 200 + [1e-3] * 200 + [1e-4] * 100)
    assert pin["default_ladder"]["lambda_move"] > 1e-3
    for (f1, f2), lam in lams.items():
        assert np.abs(lam.numpy() - np.asarray(pin["lambdas"][f"{f1},{f2}"])).max() < TOL
    assert np.abs(one_site_rho(to_numpy(su)) - fp).max() < TOL


# ------------------------------ import boundary -----------------------------

_IMPORT_ALL = """
import importlib, json, pkgutil, sys
import kagomeperiodicbp_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
print(json.dumps({"modules": names,
                  "imported": sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
                                     or m.split(".")[0] == "kagomeperiodicbp_tpu"),
                  "matplotlib": "matplotlib" in sys.modules}))
"""


def test_port_and_chip_smoke_import_no_jax():
    """Every module of the port, the batched sweep, the square lattice,
    run_square, the plots, the distribution layer, the large-D and record
    entry points, the tools and the last scripts among them, and
    chip_smoke.py import in a fresh process without JAX or the JAX package,
    and without matplotlib (the plots import it when they draw)."""
    res = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO, capture_output=True,
                         text=True, timeout=120, env={**os.environ, "PYTHONPATH": REPO})
    assert res.returncode == 0, res.stderr
    got = json.loads(res.stdout.strip().splitlines()[-1])
    pkg = "kagomeperiodicbp_tpu_torch."
    assert {pkg + m for m in ("algo.batched", "square", "square.lattice", "square.algo",
                              "square.fullupdate", "run_square", "visualizations.plots",
                              "parallel.launch", "parallel.multichip", "parallel.chi_shard",
                              "parallel.sweep", "utils.csvs", "run_sweep", "large_d_demo",
                              "measure_padded", "bp_accuracy", "load_external_su", "compare_cells",
                              "chip_accuracy", "tools", "tools.profile_bp_phases",
                              "tools.sketch_rank_curve", "tools.flops_model", "tools.bench_scaling",
                              "tools.k2_profile",
                              "create_kagome_elists", "plot_afmh_benchmark",
                              "unpack_ite_tracker")} <= set(got["modules"])
    assert len(got["modules"]) > 30 and got["imported"] == [] and not got["matplotlib"]
