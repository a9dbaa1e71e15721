"""The reference against the port on the CPU in complex128, with the randomized
SVD and the sketched swallow forced at D=3 by lowering the two sizes that pick
them (in both). The exact path agrees to rounding. On the randomized paths the
two agree to rounding as far as the draws let them: where singular values lie
close, rounding turns the gauge of a bond a little, and the next draw is
applied in that gauge (1e-11 to 5e-11 here)."""
import dataclasses

import pytest
import torch

from portbench.reference import bp as ref_bp
from portbench.reference import ite as ref_ite
from portbench.reference.executor import Recipe
from portbench.reference.numerics import REFERENCE, phase_gap

D, CHI, CHI_MSG = 3, 28, 18
FORCED = {"exact": (256, 3e8), "rsvd": (20, 3e8), "sketch": (256, 2e5)}


def _inputs():
    from kagomeperiodicbp_tpu_torch.algo import contraction as C
    from kagomeperiodicbp_tpu_torch.algo import fused as F
    from kagomeperiodicbp_tpu_torch.networks.unit_cell import UnitCell

    cell = UnitCell.random(2, D, torch.Generator().manual_seed(1), dtype=torch.complex128)
    sites = F._msgs_to_sites(C.initial_messages(2, D, CHI_MSG, dtype=torch.complex128))
    sweep = F.bp_iteration(2, D, CHI, CHI_MSG, None, single=True)
    sites, _ = sweep(C.site_kets(cell), sites)  # messages with real bonds
    return cell, sites, sweep


def _force(monkeypatch, path):
    from kagomeperiodicbp_tpu_torch.ops import linalg

    rsvd_min, blob = FORCED[path]
    monkeypatch.setattr(linalg, "RSVD_MIN_DIM", rsvd_min)
    monkeypatch.setenv("KPBP_BLOB_LIMIT", str(blob))
    return Recipe(draw_dtype=torch.float64, rsvd_min_dim=rsvd_min, blob_limit=blob)


@pytest.mark.parametrize("path", sorted(FORCED))
def test_single_layer_sweep_follows_the_port(monkeypatch, path):
    from kagomeperiodicbp_tpu_torch.algo import contraction as C
    from kagomeperiodicbp_tpu_torch.ops import mps

    recipe = _force(monkeypatch, path)
    cell, sites, sweep = _inputs()
    new, _ = sweep(C.site_kets(cell), sites)
    plan = ref_bp.message_plan
    monkeypatch.setattr(ref_bp, "message_plan",
                        lambda *a: dataclasses.replace(plan(*a), single_layer=True))
    ref = ref_bp.sweep((cell.A, cell.B, cell.C), sites, 2, CHI, CHI_MSG, REFERENCE, recipe)
    gap = max(phase_gap(mps.dense(mps.from_sites(new[s])), ref[s]) for s in range(6))
    assert gap < (1e-12 if path == "exact" else 1e-9)


@pytest.mark.parametrize("path", sorted(FORCED))
def test_pair_density_matrix_follows_the_port(monkeypatch, path):
    from kagomeperiodicbp_tpu_torch.algo import edge_env
    from kagomeperiodicbp_tpu_torch.enums import UpdateEdge

    recipe = _force(monkeypatch, path)
    cell, sites, _ = _inputs()
    for edge in UpdateEdge.all_options()[:4]:  # the three axes
        t1, t2, env, _ = edge_env.edge_environment_sites((cell.A, cell.B, cell.C), sites, 2,
                                                         CHI, CHI_MSG, edge)
        got = ref_ite.rho_ij(t1, t2, env)
        ref = ref_ite.pair_rho((cell.A, cell.B, cell.C), sites, 2, CHI, CHI_MSG,
                               int(edge.first), int(edge.second), REFERENCE, recipe)
        assert float(torch.linalg.vector_norm(got - ref) / torch.linalg.vector_norm(ref)) < 1e-11
