"""The port's last tools and scripts against the JAX package's, on the CPU:

* ``tools/bench_scaling`` at D=2 with one timed sweep: its row's keys are a
  superset of the JAX tool's, and the messages it reaches equal the port's
  per-side ``fused.bp_iteration`` run as often (1e-12, complex128);
* ``create_kagome_elists`` at N=2 and 3: the JSON of scripts/create_kagome_elists.py;
* ``plot_afmh_benchmark``: the rows of scripts/plot_afmh_benchmark.py on the
  repository's best store, and its plot;
* ``unpack_ite_tracker`` on a tracker written by the JAX package's
  ``ITETracker.save`` and one written by the port's: the JAX script's printed
  lines, and the ``--out`` cell read back by both packages' ``UnitCell.load``
  to equal arrays.

No JAX program is compiled: the JAX scripts here read files and print.
"""
import json
import os

import numpy as np
import pytest
import torch

from kagomeperiodicbp_tpu.algo import ite as jax_ite
from kagomeperiodicbp_tpu.algo.bp import BPStats as JaxBPStats
from kagomeperiodicbp_tpu.networks.unit_cell import UnitCell as JaxUnitCell
from kagomeperiodicbp_tpu_torch import create_kagome_elists, plot_afmh_benchmark, unpack_ite_tracker
from kagomeperiodicbp_tpu_torch.algo import contraction as C
from kagomeperiodicbp_tpu_torch.algo import fused as F
from kagomeperiodicbp_tpu_torch.algo.ite import ITESegmentStats, ITETracker
from kagomeperiodicbp_tpu_torch.convert import numpy_random_cell, unit_cell_from_numpy
from kagomeperiodicbp_tpu_torch.networks.unit_cell import UnitCell
from kagomeperiodicbp_tpu_torch.ops import mps as M
from kagomeperiodicbp_tpu_torch.tools import bench_scaling
from kagomeperiodicbp_tpu_torch.tools import flops_model as FM

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BEST = os.path.join(REPO, "data", "unit_cells", "best")
JAX_BENCH_KEYS = {"D", "N", "chi", "sweep_seconds", "sweeps_per_second", "first_iteration_seconds",
                  "single_layer", "platform"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def jax_scripts(monkeypatch):
    """The JAX package's scripts/ importable as a namespace package."""
    monkeypatch.syspath_prepend(REPO)


# ------------------------------ bench_scaling -------------------------------


def test_bench_scaling_command_line_on_the_cpu(capsys):
    assert bench_scaling.main(["2", "--sweeps", "1", "--device", "cpu"]) == 0
    (row,) = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert JAX_BENCH_KEYS <= set(row)
    assert {"bp_mode", "device", "peak_device_gb", "flops_per_sweep", "achieved_gflops"} <= set(row)
    assert (row["D"], row["N"], row["chi"], row["bp_mode"], row["single_layer"]) == (2, 2, 8, "batched", False)
    assert row["platform"] == row["device"] == "cpu" and row["peak_device_gb"] is None
    assert row["flops_per_sweep"] == FM.count_sweep(2, 2, 8, 8, "cpu")["total"]
    assert row["achieved_gflops"] == pytest.approx(row["flops_per_sweep"] / row["sweep_seconds"] / 1e9)


def test_bench_scaling_messages_are_the_sweeps():
    """1 + 1 sweeps (the first timed alone), against the per-side sweep."""
    row, sites = bench_scaling.bench_D(2, torch.device("cpu"), n_sweeps=1, dtype=torch.complex128)
    cell, want = FM.inputs(2, 2, 8, "cpu", torch.complex128)
    step, fused = F.bp_iteration(2, 2, 8, 8, None), C.fused_cells(cell)
    for _ in range(2):
        want, _ = step(fused, want)
    got, exp = F._sites_to_msgs(sites), F._sites_to_msgs(want)
    gaps = [abs(float(M.distance(got[s], exp[s]))) for s in exp]
    assert max(gaps) < 1e-12, gaps
    assert row["bp_mode"] == "batched"


def test_bench_scaling_failing_D_prints_an_error_row_and_exits_nonzero(monkeypatch, capsys):
    real = bench_scaling.bench_D

    def fails_at_3(D, *a, **kw):
        if D == 3:
            raise RuntimeError("boom")
        return real(D, *a, **kw)

    monkeypatch.setattr(bench_scaling, "bench_D", fails_at_3)
    assert bench_scaling.main(["3", "2", "--sweeps", "1", "--device", "cpu"]) == 1
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert rows[0] == {"D": 3, "error": "RuntimeError('boom')"} and rows[1]["D"] == 2


# --------------------------------- scripts ----------------------------------


@pytest.mark.parametrize("N", [2, 3])
def test_create_kagome_elists_matches_jax_script(N, tmp_path, capsys, jax_scripts):
    from scripts import create_kagome_elists as jax_script

    jax_script.main(["-N", str(N), "--out", str(tmp_path / "jax.json")])
    create_kagome_elists.main(["-N", str(N), "--out", str(tmp_path / "port.json")])
    assert capsys.readouterr().out.splitlines() == [f"wrote {tmp_path / 'jax.json'}",
                                                    f"wrote {tmp_path / 'port.json'}"]
    assert (tmp_path / "port.json").read_text() == (tmp_path / "jax.json").read_text()
    data = json.loads((tmp_path / "port.json").read_text())
    assert data["N"] == N and len(data["flavors"]) == data["n_nodes"] and len(data["boundary_legs"]) == 6


def test_plot_afmh_benchmark_matches_jax_script(tmp_path, capsys, jax_scripts):
    from scripts import plot_afmh_benchmark as jax_script

    want = jax_script.main(["--best-folder", BEST])
    jax_out = capsys.readouterr().out
    png = tmp_path / "afmh.png"
    got = plot_afmh_benchmark.main(["--best-folder", BEST, "--plot", str(png)])
    out = capsys.readouterr().out.splitlines()
    assert got == want
    assert [r[4] is not None for r in got[:3]] == [True, True, True]   # D=2, 3, 4 are stored
    assert out[:-1] == jax_out.splitlines() and out[-1] == f"plot saved to {png}"
    assert png.stat().st_size > 0


def _cells():
    return [numpy_random_cell(2, seed) for seed in (3, 4)]


def _jax_tracker(path):
    """A tracker the JAX package's ITETracker.save writes, with one segment's
    stats (its own record classes)."""
    cells = _cells()
    best = JaxUnitCell(*(np.asarray(cells[1][f]) for f in "ABC"))
    stats = [jax_ite.ITESegmentStats(delta_t=0.01, mean_energy=-0.21, bp_stats=[JaxBPStats(iterations=3)]),
             jax_ite.ITESegmentStats(delta_t=0.01, mean_energy=-0.32)]
    tr = jax_ite.ITETracker(delta_ts=[0.01, 0.01], energies=[-0.21, -0.32], stats=stats,
                            cells=cells, best_energy=-0.32, best_cell=best)
    tr.save(str(path))
    return cells[1]


def _port_tracker(path):
    cells = _cells()
    tr = ITETracker(delta_ts=[0.1] * 6, energies=[-0.1, -0.2, -0.15, -0.3, -0.25, -0.28],
                    stats=[ITESegmentStats(delta_t=0.1)] * 6, cells=cells, best_energy=-0.3,
                    best_cell=unit_cell_from_numpy(cells[0]))
    tr.save(str(path))
    return cells[0]


@pytest.mark.parametrize("writer", [_jax_tracker, _port_tracker], ids=["jax_tracker", "port_tracker"])
def test_unpack_ite_tracker_matches_jax_script(writer, tmp_path, capsys, jax_scripts):
    from scripts import unpack_ite_tracker as jax_script

    tracker = tmp_path / "tracker.pkl"
    best = writer(tracker)
    jax_script.main([str(tracker), "--out", str(tmp_path / "jax_cell.pkl")])
    jax_lines = capsys.readouterr().out.splitlines()
    unpack_ite_tracker.main([str(tracker), "--out", str(tmp_path / "cell.pkl")])
    lines = capsys.readouterr().out.splitlines()
    assert lines[:-1] == jax_lines[:-1] and len(lines) == 4
    assert lines[-1] == f"unit cell saved to {tmp_path / 'cell.pkl'}"
    by_jax, by_port = JaxUnitCell.load(str(tmp_path / "cell.pkl")), UnitCell.load(str(tmp_path / "cell.pkl"))
    for f in "ABC":
        np.testing.assert_array_equal(np.asarray(by_jax[f]), best[f])
        np.testing.assert_array_equal(by_port[f].numpy(), best[f])
