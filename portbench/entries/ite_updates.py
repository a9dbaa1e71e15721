"""Entry ``ite_updates``: one step is one call of the port's
``algo/ite.ite_update_edge`` (environment → gate → ALS → write-back) on the
cell the last step left, with the messages fixed from set-up. The edges come
in ``UpdateEdge.all_options()`` order with the second-order Trotter doubling
of ``algo/ite._edge_order`` (random order off: 11 updates, the middle one at
2·dt), cycled.

Set-up makes the messages (the mix's ``setup_bp_sweeps`` BP sweeps from
uniform messages, or the uniform messages where it has none) and
runs the first ``warm_updates`` updates of the order, which take every edge
axis. The check covers the first of those (from the seed's cell) and one
timed update drawn from the seed: the environment the program built, by the
pair's density matrix against the reference's own contraction, and the pair
it wrote back against the reference's gate and ALS from that environment.
"""
from __future__ import annotations

import random

import torch

from portbench import inputs
from portbench.reference import ite as ref_ite
from portbench.reference.executor import recipe_for
from portbench.reference.numerics import phase_gap, precision


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.to(torch.complex128), b.to(torch.complex128)
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


class Driver:
    step_kind = "ite_update"

    def __init__(self, ctx):
        from kagomeperiodicbp_tpu_torch.algo import bp as BP
        from kagomeperiodicbp_tpu_torch.algo import ite as ITE
        from kagomeperiodicbp_tpu_torch.lattices import BlockSide
        from kagomeperiodicbp_tpu_torch.ops import mps

        cfg, mix = ctx.config, ctx.traffic
        self.ctx = ctx
        self.ITE = ITE
        self.N, self.chi, self.chi_msg = cfg["N"], cfg["chi"], cfg["chi_msg"]
        self.step_errors = (ITE.ITEError, torch.linalg.LinAlgError)
        self.h = inputs.hamiltonian(cfg["hamiltonian"], ctx.dtype, ctx.device)
        self.rtol = ref_ite.rtol_for(ctx.dtype)
        self.config = ITE.ITEConfig(hamiltonian=None, random_edge_order=False,
                                    als_iterations=int(mix.get("als_iterations", 10)),
                                    num_edge_repetitions_per_mode=6)
        self.order = ITE._edge_order(self.config, float(mix["dt"]), random.Random(0))
        start = inputs.uniform_messages(self.N, cfg["D"], self.chi_msg, ctx.dtype, ctx.device)
        msgs = {BlockSide(s): mps.from_sites(ss) for s, ss in start.items()}
        n_bp = int(mix.get("setup_bp_sweeps", 0))
        if n_bp:
            bp_cfg = BP.BPConfig(trunc_dim=self.chi_msg, bubble_trunc_dim=self.chi,
                                 max_iterations=n_bp, dtype=ctx.dtype)
            msgs, _ = BP.belief_propagation(ctx.cell, msgs, bp_cfg, self.N)
        self.msgs = msgs
        self.msg_sites = {int(s): tuple(m.sites) for s, m in msgs.items()}
        self.cell = ctx.cell
        self.warm_n = int(mix.get("warm_updates", 4))
        self.sample = ctx.rng.randrange(int(mix.get("check_within_first", 1)))
        self.recipe = recipe_for(cfg)
        self.kept = {}

    def _update(self, k: int, keep=None):
        edge, dt = self.order[k % len(self.order)]
        if keep is None:
            self.cell, _, _ = self.ITE.ite_update_edge(
                self.cell, self.msgs, self.N, self.chi, self.chi_msg, edge, self.h, dt,
                self.config)
            return
        from kagomeperiodicbp_tpu_torch.algo import edge_env

        box = []
        original = edge_env.edge_environment_sites

        def capturing(*args, **kwargs):
            out = original(*args, **kwargs)
            box.append(out)
            return out

        before = (self.cell.A, self.cell.B, self.cell.C)
        edge_env.edge_environment_sites = capturing
        try:
            self.cell, _, _ = self.ITE.ite_update_edge(
                self.cell, self.msgs, self.N, self.chi, self.chi_msg, edge, self.h, dt,
                self.config)
        finally:
            edge_env.edge_environment_sites = original
        self.kept[keep] = {"edge": (int(edge.first), int(edge.second)), "dt": dt,
                           "before": before, "env": box[0],
                           "after": (self.cell.A, self.cell.B, self.cell.C)}

    def warm(self):
        for k in range(self.warm_n):
            self._update(k, "start" if k == 0 else None)

    def step(self, i: int):
        self._update(self.warm_n + i, "sample" if i == self.sample else None)

    def release(self):
        self.cell = None

    def readings(self, subject: str = "program") -> dict:
        ref = precision("reference", self.ctx.config)
        out = {"rho_gap": 0.0, "pair_gap": 0.0}
        for key in ("start", "sample"):
            if key not in self.kept:
                return {k: float("inf") for k in out}
            k = self.kept[key]
            first, second = k["edge"]
            t1, t2, env, (p1, p2) = k["env"]
            rho_ref = ref_ite.pair_rho(k["before"], self.msg_sites, self.N, self.chi,
                                       self.chi_msg, first, second, ref, self.recipe)
            r1, r2 = ref_ite.gate_and_truncate(t1, t2, env, self.h, k["dt"],
                                               self.config.als_iterations, self.rtol, ref)
            if subject == "program":
                rho = ref_ite.rho_ij(*(x.to(torch.complex128) for x in (t1, t2)),
                                     [e.to(torch.complex128) for e in env])
                n1 = k["after"][first].permute((0,) + tuple(q + 1 for q in p1))
                n2 = k["after"][second].permute((0,) + tuple(q + 1 for q in p2))
            else:
                low = precision(subject, self.ctx.config)
                rho = ref_ite.pair_rho(k["before"], self.msg_sites, self.N, self.chi,
                                       self.chi_msg, first, second, low, self.recipe)
                n1, n2 = ref_ite.gate_and_truncate(t1, t2, env, self.h, k["dt"],
                                                   self.config.als_iterations, self.rtol, low)
            out["rho_gap"] = max(out["rho_gap"], _rel(rho, rho_ref))
            out["pair_gap"] = max(out["pair_gap"], phase_gap(ref_ite.pair_state(n1, n2),
                                                             ref_ite.pair_state(r1, r2)))
        return out

    def check(self, limits: dict) -> dict:
        return {k: {"value": v, "limit": limits[k]["limit"]} for k, v in self.readings().items()}
