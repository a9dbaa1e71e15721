"""The port's remaining entry points and tools against the JAX package's
scripts, on the CPU in complex128, on inputs made with numpy from a seed:

* ``measure_padded`` (``-D 3 --src 2 --noise 0``) against
  scripts/measure_padded.py's ``main`` on a temporary best store: mean and
  edge energies, to the JAX script's own reproducibility at the pad
  (PAD_TOL);
* ``bp_accuracy``'s "bp" and "exact" rows against scripts/bp_accuracy.py's,
  1e-8 (its "random" row is a jax.random draw, so it is left out; the JAX
  script's cell is the numpy cell, handed to it through ``UnitCell.random``);
* ``load_external_su.measure_set`` against the JAX script's on a
  tnsu-format pickle written here, 1e-10;
* ``compare_cells.analyze`` on the pin cell against tools/compare_cells.py's,
  1e-10;
* ``tools/profile_bp_phases``, ``tools/sketch_rank_curve`` and
  ``chip_accuracy`` run on the CPU.

The JAX scripts run as they are, with JAX on the CPU as the other parity
tests run it.
"""
import csv
import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kagomeperiodicbp_tpu.networks import unit_cell as jax_unit_cell
from kagomeperiodicbp_tpu.utils import best_store as jax_best_store
from kagomeperiodicbp_tpu_torch import bp_accuracy, chip_accuracy, compare_cells, load_external_su
from kagomeperiodicbp_tpu_torch import measure_padded
from kagomeperiodicbp_tpu_torch.convert import numpy_product_messages, numpy_random_cell, unit_cell_from_numpy
from kagomeperiodicbp_tpu_torch.tools import profile_bp_phases, sketch_rank_curve
from kagomeperiodicbp_tpu_torch.utils.foreign import write_tnsu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PIN_CELL = os.path.join(REPO, "tests", "assets", "pin_D3.pkl")
D2_RECORD = os.path.join(REPO, "data", "unit_cells", "best", "D=2 energy=-0.40239300631851055.pkl")
TOL = 1e-10
# measure_padded at a zero pad: the JAX script's own energies move by up to
# 7.9e-9 (mean) and 1.6e-8 (an edge) when its padded cell moves by 1e-15
# (--noise 1e-15), with its measurement fixed to 2e-16; the move is the BP
# fixed point's, at the pad only (tools/torch_cpu_checks.py pad). 3× that.
PAD_TOL = 5e-8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _json_lines(text):
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


@pytest.fixture
def jax_scripts(monkeypatch):
    """The JAX package's scripts/ and tools/ importable (scripts as a
    namespace package, tools' modules by name)."""
    monkeypatch.syspath_prepend(REPO)
    monkeypatch.syspath_prepend(os.path.join(REPO, "tools"))


# ---------------------------------- tools -----------------------------------


@pytest.mark.parametrize("single", [False, True])
def test_profile_bp_phases_on_the_cpu(single, capsys):
    (rec,) = profile_bp_phases.main(["2", "--device", "cpu"] + (["--single"] if single else []))
    assert _json_lines(capsys.readouterr().out)[-1] == rec
    want = {"platform", "D", "N", "chi", "single_layer", "total_s", "qr_s", "svd_s", "other_s",
            "qr_frac", "svd_frac", "n_qr", "n_svd"}
    assert want <= set(rec) and rec["device"] is None and rec["single_layer"] is single
    assert rec["n_qr"] > 0 and rec["n_svd"] > 0 and 0 < rec["qr_s"] + rec["svd_s"] < rec["total_s"]
    assert profile_bp_phases._kind("void geqr2_kernel<c>") == "qr"
    assert profile_bp_phases._kind("gesvdbj_batch_kernel") == "svd"
    assert profile_bp_phases._kind("ampere_cgemm_64x64") == "other"


def test_sketch_rank_curve_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setenv("KPBP_SKETCH_RANK", "7")
    out = tmp_path / "curve.json"
    rows = sketch_rank_curve.main(["--D", "2", "--chi", "4", "--device", "cpu", "--out", str(out)])
    assert os.environ["KPBP_SKETCH_RANK"] == "7" and "KPBP_BLOB_LIMIT" not in os.environ
    with open(out) as fh:
        assert [json.loads(x) for x in fh] == rows
    assert [r["path"] for r in rows] == ["ordinary"] + ["sketch"] * (len(rows) - 1)
    full = rows[-1]
    assert full["rank"] == sketch_rank_curve.FULL_RANK
    assert abs(full["distance"] - rows[0]["distance"]) < 1e-10   # at full rank the sketch is exact


def test_chip_accuracy_on_the_cpu(tmp_path):
    """Both runs on the CPU (a random D=2 cell: the store is empty): the
    complex64 energy within the c64 bar of the complex128 one."""
    out = chip_accuracy.main(["2", "2", "--device", "cpu", "--store-dir", str(tmp_path)])
    assert set(out) >= {"D", "N", "energy_cpu_f64", "energy_chip_c64", "abs_diff", "meets_1e-6"}
    assert not out["from_best_store"] and out["abs_diff"] < 1e-3
    assert out["abs_diff"] == abs(out["energy_cpu_f64"] - out["energy_chip_c64"])


def test_bp_accuracy_command_line(tmp_path):
    """The port's command line on the CPU: three methods × six edges, the
    JAX script's columns, the numpy-drawn random messages."""
    out = tmp_path / "acc.csv"
    rows = bp_accuracy.main(["-D", "2", "--exact-chi", "8", "--out", str(out), "--device", "cpu"])
    with open(out) as fh:
        written = list(csv.DictReader(fh))
    assert list(written[0]) == bp_accuracy.COLUMNS
    assert [r["method"] for r in written] == [m for m in bp_accuracy.METHODS for _ in range(6)]
    assert len(rows) == 18 and all(np.isfinite(r["energy"]) for r in rows)
    # the random model: one unit-trace projector |v⟩⟨v| per site, bonds padded to the profile
    for sites in numpy_product_messages(2, 2, 8, 11).values():
        assert [s.shape for s in sites] == [(1, 4, 4), (4, 4, 4), (4, 4, 1)]
        for s in sites:
            p = s[0, :, 0].reshape(2, 2)
            assert np.allclose(p, p.conj().T) and abs(np.trace(p) - 1) < 1e-12
            assert np.allclose(p @ p, p) and np.count_nonzero(s) == np.count_nonzero(s[0, :, 0])


# ------------------------------ measure_padded ------------------------------


def test_measure_padded_matches_jax_script(tmp_path, monkeypatch, capsys, jax_scripts):
    """The D=2 record padded to D=3 with no noise (``-D 3 --src 2 --noise
    0``), measured at N=1+1, χ_bp=18, χ=28 (``--chi-factor 1``) by both
    scripts from the same temporary store; the JAX script reads it through
    its ``load_best``, patched to the folder. The bar is PAD_TOL: at this
    pad the BP fixed point is ill-conditioned in the JAX package itself."""
    from scripts import measure_padded as jax_measure_padded

    store = tmp_path / "best"
    store.mkdir()
    shutil.copy(D2_RECORD, store)
    orig = jax_best_store.load_best
    monkeypatch.setattr(jax_best_store, "load_best", lambda D: orig(D, str(store)))
    flags = ["-D", "3", "--src", "2", "-N", "1", "--noise", "0", "--chi-factor", "1", "--no-store"]
    assert jax_measure_padded.main(flags) == 0
    want = _json_lines(capsys.readouterr().out)[-1]
    got = measure_padded.main(flags + ["--store-dir", str(store), "--device", "cpu"])
    assert os.listdir(store) == [os.path.basename(D2_RECORD)]   # --no-store
    for k in ("D", "src_D", "src_energy", "N", "chi", "chi_bp"):
        assert got[k] == want[k]
    assert (got["D"], got["chi_bp"], got["chi"]) == (3, 18, 28)
    assert abs(got["mean_energy"] - want["mean_energy"]) < PAD_TOL
    assert got["edge_energies"].keys() == want["edge_energies"].keys()
    for k, v in want["edge_energies"].items():
        assert abs(got["edge_energies"][k] - v) < PAD_TOL


# ------------------------------- bp_accuracy --------------------------------

ACC_ROW_KEYS = ("fidelity_vs_exact", "energy", "z_i", "negativity", "entropy", "hermicity")


def test_bp_accuracy_rows_match_jax_script(tmp_path, monkeypatch, jax_scripts):
    from scripts import bp_accuracy as jax_bp_accuracy

    D, N, seed, exact_chi = 2, 2, 3, 8
    cell_np = numpy_random_cell(D, seed)
    monkeypatch.setattr(jax_unit_cell.UnitCell, "random", staticmethod(
        lambda **kw: jax_unit_cell.UnitCell(*(jnp.asarray(cell_np[f]) for f in "ABC"))))
    out = tmp_path / "jax.csv"
    jax_bp_accuracy.main(["-D", str(D), "-N", str(N), "--seed", str(seed),
                          "--exact-chi", str(exact_chi), "--out", str(out)])
    with open(out) as fh:
        want = [r for r in csv.DictReader(fh) if r["method"] != "random"]

    cell = unit_cell_from_numpy(cell_np)
    got = bp_accuracy.accuracy_rows(cell, N, 2 * D * D, exact_chi, None, methods=("bp", "exact"),
                                    log=lambda *_: None)
    assert [(r["method"], r["edge"], r["chi"]) for r in got] == \
        [(r["method"], r["edge"], int(r["chi"])) for r in want]
    for g, w in zip(got, want):
        for k in ACC_ROW_KEYS:
            assert abs(g[k] - float(w[k])) < 1e-8, (g["method"], g["edge"], k)
    assert all(r["fidelity_vs_exact"] > 0.99 for r in got)


# ----------------------------- load_external_su -----------------------------


def test_load_external_su_matches_jax_measure_set(tmp_path, capsys, jax_scripts):
    from scripts import load_external_su as jax_load_external_su

    cell = numpy_random_cell(2, 41)
    path = write_tnsu(tmp_path / "tnsu_AFH_D=2_size=1_PBC.dat", [cell[f] for f in "ABC"],
                        final_energy=-0.39)
    want = jax_load_external_su.measure_set(path, N=2)
    got = load_external_su.main(["--folder", str(tmp_path), "-D", "2", "--device", "cpu"])
    assert len(got) == 1 and _json_lines(capsys.readouterr().out)[-1] == got[0]
    got = got[0]
    for k in ("file", "D", "N", "chi", "foreign_energy"):
        assert got[k] == want[k]
    assert abs(got["mean_energy"] - want["mean_energy"]) < TOL
    assert abs(got["edge_spread"] - want["edge_spread"]) < TOL
    for k, v in want["edge_energies"].items():
        assert abs(got["edge_energies"][k] - v) < TOL


# ------------------------------- compare_cells ------------------------------


def test_compare_cells_matches_jax_tool_on_the_pin(capsys, jax_scripts):
    """The pin cell at N=2, χ 9/14 (``--n 2 --chi-factor 0.5``): energies,
    ⟨x, y, z⟩ per flavour and negativities, and the same printout."""
    import compare_cells as jax_compare_cells

    want = jax_compare_cells.analyze(PIN_CELL, 2, 0.5)
    want_out = capsys.readouterr().out
    (got,) = compare_cells.main([PIN_CELL, "--n", "2", "--chi-factor", "0.5", "--device", "cpu"])
    got_out = capsys.readouterr().out
    assert abs(got.mean_energy - want.mean_energy) < TOL
    for k, v in want.energies.items():
        assert abs(got.energies[k] - v) < TOL
        assert abs(got.entanglement[k] - want.entanglement[k]) < TOL
    for f in "ABC":
        for k in "xyz":
            assert abs(got.expectations[f][k] - want.expectations[f][k]) < TOL
    # the printout, bar the BP error's last digits
    strip = lambda s: [ln for ln in s.splitlines() if "bp_err" not in ln]  # noqa: E731
    assert strip(got_out) == strip(want_out)
