"""Run one cell of the benchmark of kagomeperiodicbp_tpu_torch once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the card(s) the cell asks for.
The last line of standard output is the result as one JSON object; the
numbers the output check compared, each beside its limit, are the last lines
of standard error. See portbench/harness.py.
"""
import os
import sys
import time

T_PROCESS = time.time()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".portbench_cache")
# build and kernel caches at fixed paths inside the checkout (the port's own
# nvcc builds go to kagomeperiodicbp_tpu_torch/_build/ by themselves)
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["CUDA_CACHE_PATH"] = os.path.join(CACHE, "cuda")
os.environ.setdefault("USE_FLAX", "0")
sys.path.insert(0, ROOT)

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], t_process=T_PROCESS))
