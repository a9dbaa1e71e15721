"""device_idle.ite: share of the traced window (the mix's trace_steps steps)
in which no kernel, copy or set ran on the card, %. torch.profiler."""


def read(run):
    tr = run["trace"]
    if run["step"] != "ite_update" or tr is None or not tr["window_s"] > 0 or not tr["busy_s"] > 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
