"""qr_share.bp: device time in cuSOLVER's Householder QR kernels (geqr*,
larf*, orgqr/ungqr, ormqr/unmqr) over the device's busy time in the traced
sweep, %. torch.profiler. The GEMMs of QR's blocked updates run as cuBLAS
GEMMs and are not in it."""

PATTERNS = ("geqr", "larf", "orgqr", "ungqr", "ormqr", "unmqr", "orm2r", "unm2r", "org2r", "ung2r")


def read(run):
    tr = run["trace"]
    if run["step"] != "bp_sweep" or tr is None or not tr["busy_s"] > 0:
        return None
    t = sum(v for k, v in tr["by_name"].items() if any(p in k.lower() for p in PATTERNS))
    if not t > 0:
        return None
    return 100.0 * t / tr["busy_s"]
