"""linalg_share.ite: device time in cuSOLVER's QR, SVD and eigh kernels
over the device's busy time in the traced updates, %. torch.profiler."""

PATTERNS = ("geqr", "larf", "orgqr", "ungqr", "ormqr", "unmqr", "orm2r", "unm2r", "org2r",
            "ung2r", "gesvd", "gesvdj", "bdsqr", "gebrd", "labrd", "jacobi", "syevd", "heevd",
            "sytrd", "hetrd", "latrd", "stedc", "steqr", "sterf", "ormtr", "unmtr", "syevj",
            "heevj", "svd", "eig")


def read(run):
    tr = run["trace"]
    if run["step"] != "ite_update" or tr is None or not tr["busy_s"] > 0:
        return None
    t = sum(v for k, v in tr["by_name"].items() if any(p in k.lower() for p in PATTERNS))
    if not t > 0:
        return None
    return 100.0 * t / tr["busy_s"]
