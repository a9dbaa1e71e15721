"""The port's host layer against the JAX package: the plan compiler must give
the same step list, and the unit cell the same tensors, so every parity test
downstream compares the same contraction."""
import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kagomeperiodicbp_tpu.algo import contraction as JC
from kagomeperiodicbp_tpu.algo import edge_env as JE
from kagomeperiodicbp_tpu.lattices import LatticeDir as JLatticeDir
from kagomeperiodicbp_tpu.networks.unit_cell import UnitCell as JUnitCell
from kagomeperiodicbp_tpu_torch.algo import contraction as TC
from kagomeperiodicbp_tpu_torch.algo import edge_env as TE
from kagomeperiodicbp_tpu_torch.convert import to_numpy, unit_cell_from_numpy
from kagomeperiodicbp_tpu_torch.lattices import LatticeDir
from kagomeperiodicbp_tpu_torch.networks.unit_cell import UnitCell

ASSETS = os.path.join(os.path.dirname(__file__), "assets")


def _steps(plan):
    return [(s.source, s.perm, s.start, s.n_in, s.n_out, s.out_dims, s.compress_after)
            for s in plan.steps]


def _same_plan(pj, pt):
    assert _steps(pt) == _steps(pj)
    assert pt.chi == pj.chi
    assert pt.final_sites == pj.final_sites
    assert pt.final_dims == pj.final_dims
    assert pt.final_targets == pj.final_targets


@pytest.mark.parametrize("toward", range(6))
@pytest.mark.parametrize("D", [2, 3])
@pytest.mark.parametrize("N", [2, 3])
def test_message_plan_matches_jax(N, D, toward):
    chi = 2 * D * D
    _same_plan(JC.to_message_plan(N, D, chi, chi, toward),
               TC.to_message_plan(N, D, chi, chi, toward))


@pytest.mark.parametrize("axis", ["R", "DL", "UL"])
@pytest.mark.parametrize("N", [2, 3])
def test_edge_geometry_plans_match_jax(N, axis):
    D, chi, chi_msg = 2, 18, 8
    gj = JE.edge_geometry(N, D, chi, chi_msg, JLatticeDir[axis])
    gt = TE.edge_geometry(N, D, chi, chi_msg, LatticeDir[axis])
    _same_plan(gj.top_plan, gt.top_plan)
    _same_plan(gj.bot_plan, gt.bot_plan)
    assert gt.chain == gj.chain
    assert (gt.top_site_of, gt.bot_site_of) == (gj.top_site_of, gj.bot_site_of)


def test_full_scalar_plan_matches_jax():
    _same_plan(JC.full_scalar_plan(2, 2, 64, 8), TC.full_scalar_plan(2, 2, 64, 8))


def test_unit_cell_load_and_rotations_match_jax():
    path = os.path.join(ASSETS, "pin_D3.pkl")
    cj = JUnitCell.load(path).astype(jnp.complex128)
    ct = UnitCell.load(path).astype(torch.complex128)
    for _ in range(3):
        cj, ct = cj.rotate_ccw(), ct.rotate_ccw()
        assert ct.rotated == cj.rotated
        for f in "ABC":
            np.testing.assert_array_equal(ct[f].numpy(), np.asarray(cj[f]))
    zj, zt = cj.rotate_ccw().force_zero_rotation(), ct.rotate_ccw().force_zero_rotation()
    assert zt.rotated == zj.rotated == 0
    nj, nt = zj.normalize(), zt.normalize()
    for f in "ABC":
        np.testing.assert_allclose(nt[f].numpy(), np.asarray(nj[f]), atol=1e-15)


def test_unit_cell_numpy_round_trip():
    """convert's dict is the one UnitCell.save pickles, both ways."""
    with open(os.path.join(ASSETS, "pin_D3.pkl"), "rb") as fh:
        data = pickle.load(fh)
    cell = unit_cell_from_numpy(data)
    back = to_numpy(cell.rotate_ccw())
    assert back["rotated"] == (data.get("rotated", 0) + 1) % 3
    again = to_numpy(unit_cell_from_numpy(back).rotate_ccw().rotate_ccw())
    for f in "ABC":
        np.testing.assert_array_equal(again[f], data[f])
