#!/usr/bin/env python
"""Produce tests/assets/warm_start_D2.npz for tests/test_torch_sandwich.py:
what the JAX package computes on that file's numpy cases (d=2, D=2, N=2,
complex128), so the tests hold the port to it without compiling the JAX
programs there.

* sandwich: the numpy cell ``numpy_cell(11)`` (``cell_A`` … ``cell_C``), the
  random-classic messages the JAX package draws from PRNGKey(4) at χ_msg=8
  (``msg_<side>_<k>``; torch cannot draw jax.random's) and the 9 values of
  the JAX ``measure_xyz_sandwich`` at χ=16 (``xyz``, [flavour, x/y/z]);
* arbitrary: the 21 per-site kets of each of the test's two blocks, a tiled
  unit cell and 3·n_triangles independent tensors (``arb_<kind>``), and the
  JAX ``ArbitraryKagomeTN.measure`` of each, its own BP included (χ_msg=8,
  30 iterations at most, to 1e-11; the six edge energies at χ=18, in the
  order of ``energy_keys``, ``arb_<kind>_energies``, and their mean,
  ``arb_<kind>_mean``).

It imports both packages and runs on the CPU (about a minute):

    JAX_PLATFORMS=cpu python tools/make_warm_start_cases.py [out.npz]
"""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> None:
    out = sys.argv[1] if len(sys.argv) > 1 else os.path.join(ROOT, "tests", "assets",
                                                             "warm_start_D2.npz")
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np

    from kagomeperiodicbp_tpu.algo import arbitrary as JA
    from kagomeperiodicbp_tpu.algo import contraction as JC
    from kagomeperiodicbp_tpu.algo.bp import BPConfig
    from kagomeperiodicbp_tpu.algo.measurements import measure_xyz_sandwich
    from kagomeperiodicbp_tpu.networks.unit_cell import UnitCell
    from kagomeperiodicbp_tpu.physics import hamiltonians
    from tests.test_torch_sandwich import ARB_BP, ARB_CHI, CHI, CHI_MSG, N, arbitrary_block, numpy_cell

    # the per-side BP program (the batched one computes the same messages and
    # compiles for minutes on the CPU)
    os.environ["KPBP_BP_BATCHED"] = "0"
    arrays = {}
    cell = numpy_cell(11)
    jmsgs = JC.initial_messages(N, 2, CHI_MSG, model="random-classic", key=jax.random.PRNGKey(4))
    for f in "ABC":
        arrays[f"cell_{f}"] = cell[f]
    for s, m in jmsgs.items():
        for k, x in enumerate(m.sites):
            arrays[f"msg_{int(s)}_{k}"] = np.asarray(x)
    xyz = measure_xyz_sandwich(UnitCell(*(jnp.asarray(cell[f]) for f in "ABC")), jmsgs, N, CHI, CHI_MSG)
    arrays["xyz"] = np.array([[complex(xyz[f][k]) for k in "xyz"] for f in "ABC"])

    h = hamiltonians.heisenberg_afm()
    cfg = BPConfig(**ARB_BP)
    keys = None
    for kind in ("tiled", "per_site"):
        tensors = arbitrary_block(kind)
        meas = JA.ArbitraryKagomeTN([jnp.asarray(t) for t in tensors], N).measure(h, bp_config=cfg,
                                                                                    chi=ARB_CHI)
        keys = keys or sorted(meas.energies)
        arrays[f"arb_{kind}"] = np.stack(tensors)
        arrays[f"arb_{kind}_energies"] = np.array([meas.energies[k] for k in keys])
        arrays[f"arb_{kind}_mean"] = np.array(meas.mean_energy)
        print(kind, meas.mean_energy)
    arrays["energy_keys"] = np.array(keys)
    np.savez_compressed(out, **arrays)
    print(f"wrote {out}: {sorted(arrays)}")


if __name__ == "__main__":
    main()
