"""kagomeperiodicbp_tpu_torch — the PyTorch / CUDA port of kagomeperiodicbp_tpu.

Block Belief Propagation environments and edge-RDM measurements of Kagome
iPEPS unit cells, in plain PyTorch on tensors, with the two kernels the JAX
package wrote in Pallas written by hand in CUDA C++ for Hopper
(``csrc/``, bound in ``ops/kernels.py``). The JAX package stays the reference.
"""

__version__ = "0.1.0"
