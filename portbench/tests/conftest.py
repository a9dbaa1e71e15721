"""A benchmark root of its own for each test that runs a cell on the CPU:
a copy of portbench/ with a D=2 configuration ("tiny") and its two cells
beside the real ones, so that a run takes seconds. The ITE cell takes the
mix with BP sweeps in its set-up."""
import json
import os
import shutil
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

TINY_LIMITS = {"tiny.bp": {"msg_gap": {"limit": 1e-4}},
               "tiny.ite": {"rho_gap": {"limit": 1e-4}, "pair_gap": {"limit": 1e-4}}}


def make_root(path, D=2):
    """A benchmark root at `path` holding the repo's BENCHMARK.json and
    portbench/, plus the D=`D` configuration "tiny" and cells tiny.bp and
    tiny.ite on both mixes."""
    shutil.copytree(os.path.join(REPO, "portbench"), os.path.join(path, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    with open(os.path.join(REPO, "portbench", "configs", "kagome_afm_D6.json")) as fh:
        cfg = json.load(fh)
    cfg.update(name="tiny", D=D, chi_msg=2 * D * D, chi=2 * D * D + (4 if D == 2 else 10),
               work={"bp_sweep": 10 ** 9, "ite_update": 10 ** 8})
    with open(os.path.join(path, "portbench", "configs", "tiny.json"), "w") as fh:
        json.dump(cfg, fh)
    bench["configs"].append({"name": "tiny", "source": "test", "file": "portbench/configs/tiny.json",
                             "reduced": ["D"], "why": "test"})
    bench["workloads"] += [
        {"name": "tiny.bp", "config": "tiny", "traffic": "bp_sweeps", "chips": 1, "why": "test"},
        {"name": "tiny.ite", "config": "tiny", "traffic": "ite_updates_bp2", "chips": 1, "why": "test"}]
    # the tiny cells report what the D=6 cells report
    for m in bench["end_to_end"] + bench["per_layer"]:
        for real, tiny in (("afm_d3.bp", "tiny.bp"), ("afm_d6.ite", "tiny.ite")):
            if real in m.get("workloads", ()):
                m["workloads"].append(tiny)
    with open(os.path.join(path, "BENCHMARK.json"), "w") as fh:
        json.dump(bench, fh)
    for w, lim in TINY_LIMITS.items():
        with open(os.path.join(path, "portbench", "limits", w + ".json"), "w") as fh:
            json.dump(lim, fh)
    return str(path)


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path)
