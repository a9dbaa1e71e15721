"""bp_sweeps_per_s: BP sweeps completed over the whole window, per second of
it. Host clock; every step ends in the sweep's own host read."""


def read(run):
    if run["step"] != "bp_sweep":
        return None
    return run["steps"] / run["window_s"]
