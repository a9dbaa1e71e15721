"""The benchmark of kagomeperiodicbp_tpu_torch (the PyTorch and CUDA port):
``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``. It imports neither JAX nor the JAX package."""
