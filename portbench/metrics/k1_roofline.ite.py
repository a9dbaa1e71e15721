"""k1_roofline.ite: kernel K1's least time over its measured time, %. The
least time is the byte bound of one launch on a cell of three kets, (d·D⁴ +
D⁸)·size bytes per ket read once and written once at 3.35 TB/s
(chip_smoke.py's fused_tensor_work; the flop bound is below it); the
measured time is K1's device time per launch in the traced updates
(kernel fused_tensors_kernel). torch.profiler."""
from portbench.trace import fused_tensor_work

KERNEL = "fused_tensors_kernel"
SIZE = {"complex64": 8, "complex128": 16, "float32": 4, "float64": 8}


def read(run):
    tr = run["trace"]
    if run["step"] != "ite_update" or tr is None:
        return None
    launches = run["counters"]["launches"].get("fused_tensor", 0)
    t = sum(v for k, v in tr["by_name"].items() if KERNEL in k)
    if not launches or not t > 0:
        return None
    cfg = run["config"]
    # launches counted over the whole window; the trace saw its first steps
    per_step = launches / run["steps"] if run["steps"] else 0
    traced_launches = per_step * tr["steps"]
    if not traced_launches:
        return None
    flops, nbytes = fused_tensor_work(3, cfg["d"], cfg["D"], SIZE[cfg["dtype"]],
                                      cfg["dtype"].startswith("complex"))
    bound = max(nbytes / run["peaks"]["hbm_bytes_per_s"], flops / run["peaks"]["flops_per_s"][cfg["dtype"]])
    return 100.0 * bound / (t / traced_launches)
