"""mfu.bp: the cell's frozen real flops per step (the configuration's
work.bp_sweep, counted once by portbench/tools/count_work.py) times the steps
completed after the traced ones, over their seconds (the traced ones
where no other ran), as a share of the
card's peak for the configuration's dtype (portbench/peaks.json: 67 TFLOP/s
FP32 for complex64, FP64 tensor cores for complex128), %. Host clock."""


def read(run):
    tr = run["trace"]
    work = run["config"].get("work", {}).get("bp_sweep")
    if run["step"] != "bp_sweep" or tr is None or not work:
        return None
    if tr["untraced_steps"]:
        steps, seconds = tr["untraced_steps"], tr["untraced_s"]
    else:  # every step was traced: the traced window, profiler and all
        steps, seconds = tr["steps"], tr["window_s"]
    if not steps or not seconds > 0:
        return None
    return 100.0 * work * steps / seconds / run["peaks"]["flops_per_s"][run["config"]["dtype"]]
