"""The output check's two readings for a cell, on many seeds in one process.

    python3 portbench/control.py --workload <cell> --seeds 1 2 3 [--subjects program control]

For each seed: set up the cell as a run does, run its timed steps up to the
check's sample (no window), and print one JSON line with the numbers the
check compares for each subject: ``program`` (the port, as a run judges it)
and ``control`` (the reference put in the program's place, computed in the
precision below the configuration's: bfloat16 for complex64). The limits in
``portbench/limits/<cell>.json`` lie between the program's largest reading
and the control's smallest. Each line also gives the port's swallows of
each kind per timed step (``ops/contract.swallow_counts``). Runs on the
card (``--device cpu`` for tests). The benchmark's own runs never run the
control.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from portbench import harness  # noqa: E402


def readings(spec: dict, seed: int, device: str, subjects) -> dict:
    import torch

    t = time.time()
    ctx = harness.make_context(spec, seed, device)
    driver = harness.entry_driver(spec)(ctx)
    driver.warm()
    before = harness._counters()["swallows"]
    for i in range(driver.sample + 1):
        driver.step(i)
    swallows = harness._delta(harness._counters()["swallows"], before)
    driver.release()
    if device.startswith("cuda"):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    out = {"workload": spec["workload"], "seed": seed, "run_s": time.time() - t,
           "swallows_per_step": {k: v / (driver.sample + 1) for k, v in swallows.items()}}
    for subject in subjects:
        t = time.time()
        out[subject] = driver.readings(subject)
        out[subject + "_s"] = time.time() - t
    return out


def main(argv=None, root: str = harness.ROOT):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--subjects", nargs="+", default=["program", "control"])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    spec = harness.load_cell(args.workload, root)
    rows = []
    for seed in args.seeds:
        row = readings(spec, seed, args.device, args.subjects)
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    main()
