#!/usr/bin/env python
"""Produce tests/assets/sketch_case_D3.npz for tests/test_torch_single_layer.py:
the inputs of the JAX package's test_gram_split_message_quality_under_truncation
(a random D=3 cell from PRNGKey(1), random messages at χ=12 from PRNGKey(3))
and the Khatri-Rao sketch factors its `_swallow_ket_gram_split` draws
(PRNGKey(0), split as it splits) for every sketched swallow of the message
toward U with KPBP_BLOB_LIMIT=1, keyed by (n_out, D, b, s). With them the
PyTorch port's sketched message is held to that test's bar on its own case
without drawing jax.random in the test.

Usage: python tools/make_sketch_case.py [out.npz]
"""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> None:
    out = sys.argv[1] if len(sys.argv) > 1 else os.path.join(ROOT, "tests", "assets",
                                                             "sketch_case_D3.npz")
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np
    import torch

    from kagomeperiodicbp_tpu.algo import contraction as JC
    from kagomeperiodicbp_tpu.networks.unit_cell import UnitCell
    from kagomeperiodicbp_tpu_torch.algo import contraction as C
    from kagomeperiodicbp_tpu_torch.convert import messages_from_numpy, unit_cell_from_numpy
    from kagomeperiodicbp_tpu_torch.lattices import BlockSide
    from kagomeperiodicbp_tpu_torch.ops import contract as K

    N, D, chi = 2, 3, 12
    jcell = UnitCell.random(D=D, d=2, key=jax.random.PRNGKey(1))
    jmsgs = JC.initial_messages(N, D, chi=chi, model="random", key=jax.random.PRNGKey(3))
    arrays = {f: np.asarray(jcell[f]) for f in "ABC"}
    for s, m in jmsgs.items():
        for k, x in enumerate(m.sites):
            arrays[f"msg_{int(s)}_{k}"] = np.asarray(x)

    def jax_factors(n_out, D_, b, s_dim, dtype, device=None):
        keys = jax.random.split(jax.random.PRNGKey(0), 2 * (n_out - 1) + 1)
        drawn = [jax.random.normal(kk, (D_ if j < len(keys) - 1 else b, s_dim, 2), jnp.float64)
                 for j, kk in enumerate(keys)]
        drawn = [np.array(g[..., 0] + 1j * g[..., 1]) for g in drawn]
        for j, g in enumerate(drawn):
            arrays[f"factor_{n_out}_{D_}_{b}_{s_dim}_{j}"] = g
        t = [torch.from_numpy(g) for g in drawn]
        return t[:n_out - 1], t[n_out - 1:-1], t[-1]

    cell = unit_cell_from_numpy({**{f: arrays[f] for f in "ABC"}, "rotated": 0})
    msgs = messages_from_numpy({int(s): [np.asarray(x) for x in m.sites] for s, m in jmsgs.items()})
    K.sketch_factors = jax_factors
    os.environ["KPBP_BLOB_LIMIT"] = "1"
    C.outgoing_message_single(cell, msgs, N, D, chi, chi, BlockSide.U)
    np.savez_compressed(out, **arrays)
    print(f"{out}: {len(arrays)} arrays, {sum(a.nbytes for a in arrays.values())} bytes")


if __name__ == "__main__":
    main()
