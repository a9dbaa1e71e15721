"""eigh_retries.ite: eigh calls that failed and were retried shifted
(ops/linalg.eigh_retries(), summed over call sites and sizes), counted over
the whole window, per update completed. Program counter."""


def read(run):
    if run["step"] != "ite_update" or run["trace"] is None or not run["steps"]:
        return None
    return run["counters"]["eigh_retries"] / run["steps"]
