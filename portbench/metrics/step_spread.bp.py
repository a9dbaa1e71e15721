"""step_spread.bp: (slowest − median) / median of the benchmark's own spans
around each BP step of the window, %. Host clock; the traced step is left
out, since the profiler slows it."""
import statistics


def read(run):
    if run["step"] != "bp_sweep" or run["trace"] is None:
        return None
    secs = run["step_seconds"][run["trace"]["steps"]:]
    if len(secs) < 2:
        return None
    med = statistics.median(secs)
    return 100.0 * (max(secs) - med) / med
