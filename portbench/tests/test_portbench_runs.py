"""Runs of the harness on the CPU at D=2: both mixes against the reference,
a cell added as files alone, the control, the faults the check must catch,
the import guard and the refusal without a card."""
import json
import os
import subprocess
import sys

import pytest
import torch

from portbench import harness
from portbench.tests.conftest import REPO

SEED = 2 ** 31 + 977


def _run(root, workload, seconds=1.5, trace=False, seed=SEED):
    spec = harness.load_cell(workload, root)
    out = harness.measure(spec, seed, seconds, trace, "cpu", 0.0)
    return spec, out


@pytest.mark.parametrize("workload", ["tiny.bp", "tiny.ite"])
def test_rehearsal_against_the_reference(tiny_root, workload):
    spec, out = _run(tiny_root, workload, trace=True)
    run = out["run"]
    assert run["steps"] >= 1 and run["failed"] == 0
    assert harness.judge(out["checks"]), out["checks"]
    e2e = harness.read_metrics(spec, "end_to_end", run)
    assert set(e2e) == {"setup_s", "bp_sweeps_per_s" if workload == "tiny.bp" else "ite_updates_per_s"}
    per_layer = harness.read_metrics(spec, "per_layer", run)
    assert ("mfu.bp" if workload == "tiny.bp" else "mfu.ite") in per_layer
    # no device on the CPU: the device metrics read nothing, never 0
    for name in ("device_idle.bp", "device_idle.ite", "qr_share.bp", "linalg_share.ite",
                 "k1_roofline.ite"):
        assert name not in per_layer


def test_a_cell_added_as_files_alone_is_picked_up(tiny_root):
    root = tiny_root
    with open(os.path.join(root, "portbench", "traffic", "bp_sweeps.json")) as fh:
        mix = json.load(fh)
    mix.update(warm_sweeps=2, check_within_first=1)
    with open(os.path.join(root, "portbench", "traffic", "bp_two.json"), "w") as fh:
        json.dump(mix, fh)
    with open(os.path.join(root, "portbench", "metrics", "sweeps_done.new.py"), "w") as fh:
        fh.write("def read(run):\n    return run['steps'] * run['traffic']['warm_sweeps']\n")
    with open(os.path.join(root, "portbench", "limits", "tiny.bp2.json"), "w") as fh:
        json.dump({"msg_gap": {"limit": 1e-4}}, fh)
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    bench["workloads"].append({"name": "tiny.bp2", "config": "tiny", "traffic": "bp_two",
                               "chips": 1, "why": "two warm sweeps"})
    for m in bench["end_to_end"]:
        if m["name"] == "bp_sweeps_per_s":
            m["workloads"].append("tiny.bp2")
    bench["per_layer"].append({"name": "sweeps_done.new", "unit": "sweeps", "better": "higher",
                               "source": "program_counter", "layer": "BP driver algo/bp",
                               "moves": "bp_sweeps_per_s", "workloads": ["tiny.bp2"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(bench, fh)
    spec, out = _run(root, "tiny.bp2", trace=True)
    assert harness.judge(out["checks"])
    assert harness.read_metrics(spec, "per_layer", out["run"])["sweeps_done.new"]["value"] >= 2


@pytest.mark.parametrize("workload", ["tiny.bp", "tiny.ite"])
def test_control_reads_above_the_program(tiny_root, workload):
    from portbench import control

    rows = control.main(["--workload", workload, "--seeds", "5", "6", "7", "--device", "cpu"],
                        root=tiny_root)
    limits = harness.load_cell(workload, tiny_root)["limits"]
    for row in rows:
        for name, lim in limits.items():
            assert row["program"][name] <= lim["limit"] < row["control"][name], row


def _faulted(monkeypatch, module, name, wrap):
    original = getattr(module, name)
    monkeypatch.setattr(module, name, wrap(original))


def _bp_unchanged(original):
    def fn(cell, messages, config, N):
        out, stats = original(cell, messages, config, N)
        return messages, stats
    return fn


def _bp_altered(original):
    def fn(cell, messages, config, N):
        out, stats = original(cell, messages, config, N)
        side = next(iter(out))
        m = out[side]
        sites = list(m.sites)
        sites[1] = sites[1] * (1 + 1e-2 * torch.randn_like(sites[1].real))
        out[side] = type(m)(tuple(sites), m.logscale)
        return out, stats
    return fn


def _ite_unchanged(original):
    def fn(cell, *args, **kwargs):
        new, energy, health = original(cell, *args, **kwargs)
        return cell, energy, health
    return fn


def _ite_altered(original):
    def fn(cell, *args, **kwargs):
        new, energy, health = original(cell, *args, **kwargs)
        from kagomeperiodicbp_tpu_torch.networks.unit_cell import UnitCell

        a = new.A * (1 + 1e-2 * torch.randn_like(new.A.real))
        return UnitCell(a, new.B, new.C, rotated=new.rotated), energy, health
    return fn


@pytest.mark.parametrize("fault", ["unchanged", "altered"])
def test_the_check_fails_a_broken_sweep(tiny_root, monkeypatch, fault):
    from kagomeperiodicbp_tpu_torch.algo import bp

    _faulted(monkeypatch, bp, "belief_propagation",
             _bp_unchanged if fault == "unchanged" else _bp_altered)
    _, out = _run(tiny_root, "tiny.bp")
    assert not harness.judge(out["checks"]), out["checks"]


@pytest.mark.parametrize("fault", ["unchanged", "altered"])
def test_the_check_fails_a_broken_update(tiny_root, monkeypatch, fault):
    from kagomeperiodicbp_tpu_torch.algo import ite

    _faulted(monkeypatch, ite, "ite_update_edge",
             _ite_unchanged if fault == "unchanged" else _ite_altered)
    _, out = _run(tiny_root, "tiny.ite")
    assert not harness.judge(out["checks"]), out["checks"]


def test_nothing_loaded_is_jax_or_the_jax_package(tiny_root):
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from portbench import harness, control, work, trace, inputs\n"
        "from portbench.tools import count_work\n"
        "for w in ('tiny.bp', 'tiny.ite'):\n"
        "    spec = harness.load_cell(w, %r)\n"
        "    out = harness.measure(spec, 3, 0.5, True, 'cpu', 0.0)\n"
        "    harness.read_metrics(spec, 'per_layer', out['run'])\n"
        "print(','.join(harness.banned_modules()) or 'none')\n"
        "print(','.join(sorted(m for m in sys.modules if m.split('.')[0] == 'kagomeperiodicbp_tpu_torch'))[:40])\n"
    ) % (REPO, tiny_root)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert res.returncode == 0, res.stderr[-2000:]
    lines = res.stdout.strip().splitlines()
    assert lines[-2] == "none", lines[-2]
    assert lines[-1], "the port was not loaded"


def test_the_reference_imports_nothing_of_the_port():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import portbench.reference.bp, portbench.reference.ite, portbench.reference.numerics\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & "
        "{'jax', 'jaxlib', 'flax', 'kagomeperiodicbp_tpu', 'kagomeperiodicbp_tpu_torch'}))\n"
    ) % REPO
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1] == "[]"


def test_banned_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "kagomeperiodicbp_tpu_torch_x", sys)
    assert "kagomeperiodicbp_tpu_torch_x" not in harness.banned_modules()
    monkeypatch.setitem(sys.modules, "kagomeperiodicbp_tpu.ops", sys)
    assert harness.banned_modules() == ["kagomeperiodicbp_tpu.ops"]


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is the CPU's")
    res = subprocess.run([sys.executable, os.path.join(REPO, "portbench", "run.py"),
                          "--workload", "afm_d3.bp", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, timeout=300, cwd=REPO)
    assert res.returncode != 0
    assert not res.stdout.strip()


def test_work_copy_counts_the_d3_sweep():
    from portbench.tools import count_work

    with open(os.path.join(REPO, "portbench", "configs", "kagome_afm_D6.json")) as fh:
        cfg = json.load(fh)
    cfg.update(D=3, chi=18, chi_msg=18)
    rec = count_work.count_sweep(cfg, "cpu")
    assert rec["mode"] == "batched"
    assert rec["total"] == 46_776_189_690  # data/flops_model_torch.json, N2_D3_chi18


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["afm_d3.bp", "afm_d8.ite", "afm_d6.ite"])
def test_cell_runs_correct_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    res = subprocess.run([sys.executable, os.path.join(REPO, "portbench", "run.py"),
                          "--workload", workload, "--seed", str(SEED), "--seconds", "5",
                          "--trace", "0"], capture_output=True, text=True, timeout=900, cwd=REPO)
    assert res.returncode == 0, res.stderr[-3000:]
    assert json.loads(res.stdout.strip().splitlines()[-1])["correct"]
