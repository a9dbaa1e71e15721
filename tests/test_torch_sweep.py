"""The port's sweep runner (``parallel/sweep``, ``run_sweep``) against the
JAX package's ``parallel/sweep`` (the semantics of tests/test_sweep.py and
tests/test_sweep_dag.py), on the CPU (``child_device="cpu"``):

* the grid, the CSV rows of a sequential sweep with a failing point and of a
  DAG with a failing stage, each against the JAX package's run of the same
  worker (its sequential mode is plain Python); the DAG ordering, skips and
  cycle checks;
* process pools of ``smoke_worker`` / ``smoke_dag_worker`` (module-level
  workers of the port, so the children import no JAX);
* ``bp_worker`` and ``python -m kagomeperiodicbp_tpu_torch.run_sweep`` on
  the CPU, and the card default, which raises without a card.
"""
import csv
import os

import pytest
import torch

from kagomeperiodicbp_tpu.parallel import sweep as jsweep
from kagomeperiodicbp_tpu_torch import run_sweep
from kagomeperiodicbp_tpu_torch.parallel import sweep
from kagomeperiodicbp_tpu_torch.parallel.sweep import DagJob, SweepPoint, chain, run_dag


def _rows(path):
    with open(path) as fh:
        return list(csv.DictReader(fh))


def _stable(rows):
    """The CSV rows without the timing column."""
    return [{k: v for k, v in r.items() if k != "exec_time"} for r in rows]


def test_grid_matches_jax():
    kw = dict(Ds=(2, 3), Ns=(2, 3), seeds=(0, 1), chi_factors=(1.0, 1.5), noises=(None, 0.01),
              method="bp")
    got, want = sweep.grid(**kw), jsweep.grid(**kw)
    assert len(got) == 32 and [p.as_dict() for p in got] == [p.as_dict() for p in want]


def _worker(pt):
    if pt.seed == 1:
        raise RuntimeError("bad point")
    return {"ok": pt.D}


def test_run_sweep_sequential_records_failures_as_jax(tmp_path):
    pts = sweep.grid(Ds=(2,), seeds=(0, 1, 2))
    res = sweep.run_sweep(pts, _worker, csv_path=str(tmp_path / "r.csv"), child_device="cpu")
    want = jsweep.run_sweep(jsweep.grid(Ds=(2,), seeds=(0, 1, 2)), _worker,
                            csv_path=str(tmp_path / "j.csv"))
    assert res == want and res[0] == {"ok": 2} and "error" in res[1]
    rows = _rows(tmp_path / "r.csv")
    assert _stable(rows) == _stable(_rows(tmp_path / "j.csv"))
    assert rows[0]["status"] == "ok" and rows[1]["status"].startswith("error")


def test_sequential_points_run_on_the_given_devices(tmp_path):
    res = sweep.run_sweep(sweep.grid(seeds=(0, 1)), sweep.smoke_worker,
                          csv_path=str(tmp_path / "r.csv"), devices=["cpu"], child_device="cpu")
    assert [r["device"] for r in res] == ["cpu", "cpu"]
    assert [r["pid"] for r in res] == [os.getpid()] * 2


def test_run_sweep_concurrent_pool(tmp_path):
    """n_workers > 1 fans out to child processes, each on its device;
    results come back in point order."""
    pts = sweep.grid(Ds=(2,), seeds=(0, 1, 2, 3))
    res = sweep.run_sweep(pts, sweep.smoke_worker, csv_path=str(tmp_path / "r.csv"),
                          n_workers=2, child_device="cpu")
    assert [r["seed"] for r in res] == [0, 1, 2, 3]
    assert all(r["platform"] == "cpu" and r["pid"] != os.getpid() for r in res)
    assert [r["pid_value"] for r in res] == [float(sum(i * i for i in range(4)))] * 4
    assert all(r["status"] == "ok" for r in _rows(tmp_path / "r.csv"))


def _dag_worker(pt, parents):
    """Stage result = parent sum + own seed; records who its parents were."""
    if pt.method == "boom":
        raise RuntimeError("stage exploded")
    return {"value": sum(p["value"] for p in parents.values()) + pt.seed,
            "parents": sorted(parents)}


def test_chain_passes_parent_results_downstream(tmp_path):
    jobs = chain(["su", "ite", "measure"], SweepPoint(D=2, seed=5), tag="p0")
    res = run_dag(jobs, _dag_worker, csv_path=str(tmp_path / "dag.csv"), child_device="cpu")
    assert res["p0:su"] == {"value": 5, "parents": []}
    assert res["p0:ite"] == {"value": 10, "parents": ["p0:su"]}
    assert res["p0:measure"] == {"value": 15, "parents": ["p0:ite"]}
    assert [j.name for j in jobs] == [j.name for j in jsweep.chain(
        ["su", "ite", "measure"], jsweep.SweepPoint(D=2, seed=5), tag="p0")]


def test_diamond_dependency_order(tmp_path):
    jobs = [
        DagJob("a", SweepPoint(seed=1)),
        DagJob("b", SweepPoint(seed=2), depends_on=("a",)),
        DagJob("c", SweepPoint(seed=3), depends_on=("a",)),
        DagJob("d", SweepPoint(seed=4), depends_on=("b", "c")),
    ]
    res = run_dag(jobs, _dag_worker, csv_path=str(tmp_path / "dag.csv"), child_device="cpu")
    assert res["a"]["value"] == 1
    assert res["d"]["value"] == (1 + 2) + (1 + 3) + 4
    assert res["d"]["parents"] == ["b", "c"]


def test_failure_skips_descendants_not_siblings_as_jax(tmp_path):
    def jobs(mod):
        return [
            mod.DagJob("root", mod.SweepPoint(seed=1)),
            mod.DagJob("bad", mod.SweepPoint(seed=2, method="boom"), depends_on=("root",)),
            mod.DagJob("child_of_bad", mod.SweepPoint(seed=3), depends_on=("bad",)),
            mod.DagJob("sibling", mod.SweepPoint(seed=4), depends_on=("root",)),
        ]

    res = run_dag(jobs(sweep), _dag_worker, csv_path=str(tmp_path / "dag.csv"), child_device="cpu")
    want = jsweep.run_dag(jobs(jsweep), _dag_worker, csv_path=str(tmp_path / "jdag.csv"))
    assert res == want
    assert res["root"]["value"] == 1 and "error" in res["bad"]
    assert res["child_of_bad"] == {} and res["sibling"]["value"] == 5
    rows = _rows(tmp_path / "dag.csv")
    assert _stable(rows) == _stable(_rows(tmp_path / "jdag.csv"))
    text = (tmp_path / "dag.csv").read_text()
    assert "skipped: upstream bad" in text and "error: RuntimeError" in text


def test_cycle_and_unknown_dep_raise(tmp_path):
    path = str(tmp_path / "dag.csv")
    with pytest.raises(ValueError, match="cycle"):
        run_dag([DagJob("a", depends_on=("b",)), DagJob("b", depends_on=("a",))],
                _dag_worker, csv_path=path, child_device="cpu")
    with pytest.raises(ValueError, match="unknown depends_on"):
        run_dag([DagJob("a", depends_on=("nope",))], _dag_worker, csv_path=path,
                child_device="cpu")
    with pytest.raises(ValueError, match="duplicate"):
        run_dag([DagJob("a"), DagJob("a")], _dag_worker, csv_path=path, child_device="cpu")


def test_dag_process_pool(tmp_path):
    """The fan-out layer runs in child processes; the join consumes both."""
    jobs = [
        DagJob("x", SweepPoint(seed=1)),
        DagJob("y", SweepPoint(seed=2)),
        DagJob("join", SweepPoint(seed=0), depends_on=("x", "y")),
    ]
    res = run_dag(jobs, sweep.smoke_dag_worker, csv_path=str(tmp_path / "dag.csv"),
                  n_workers=2, child_device="cpu")
    assert res["join"]["value"] == 3
    assert all(r["device"] == "cpu" and r["pid"] != os.getpid() for r in res.values())


def test_bp_worker_on_the_cpu(tmp_path):
    """bp_worker: robust BP on the seed's random cell; the same point gives
    the same result twice."""
    cut = (("max_iterations", 10), ("allowed_retries", 0))
    pts = [SweepPoint(D=2, seed=s, method="bp", extra=cut) for s in (0, 0)]
    res = sweep.run_sweep(pts, sweep.bp_worker, csv_path=str(tmp_path / "r.csv"),
                          child_device="cpu")
    assert res[0]["device"] == "cpu" and 0 < res[0]["iterations"] <= 10
    assert res[0]["bp_error"] == res[1]["bp_error"] < 1e-3


def test_run_sweep_cli_on_the_cpu(tmp_path):
    path = str(tmp_path / "cli.csv")
    res = run_sweep.main(["--Ds", "2", "--method", "bp", "--device", "cpu", "--csv", path])
    assert len(res) == 1 and "error" not in res[0] and res[0]["device"] == "cpu"
    assert [r["status"] for r in _rows(path)] == ["ok"]


def test_the_card_is_the_default():
    """Without a card the default device raises before any point runs."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_sweep.main(["--Ds", "2", "--method", "bp", "--csv", os.devnull])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sweep.run_sweep(sweep.grid(), sweep.smoke_worker, csv_path=os.devnull)
