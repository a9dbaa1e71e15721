"""ite_updates_per_s: ITE edge updates completed over the whole window, per
second of it. Host clock; every update ends in its own host read."""


def read(run):
    if run["step"] != "ite_update":
        return None
    return run["steps"] / run["window_s"]
