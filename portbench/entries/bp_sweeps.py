"""Entry ``bp_sweeps``: one step is one call of the port's
``algo/bp.belief_propagation`` at the configuration's χ, running one
synchronous sweep from the messages the last step left; set-up runs
``warm_sweeps`` from BP's uniform start messages.

The check covers one timed step drawn from the seed, from the messages the
program made before it: each side's outgoing message against the
reference's. A sweep from the uniform start messages is not compared: its
boundary matrices have exactly repeated singular values, whose singular
vectors rounding picks, and the randomized SVD then applies its draw in
that pick, so two sound computations of that sweep differ by the
truncation's own error (PERF.md §2).
"""
from __future__ import annotations

import torch

from portbench import inputs
from portbench.reference import bp as ref_bp
from portbench.reference.executor import recipe_for
from portbench.reference.numerics import phase_gap, precision


class Driver:
    step_kind = "bp_sweep"

    def __init__(self, ctx):
        from kagomeperiodicbp_tpu_torch.algo import bp as BP

        cfg, mix = ctx.config, ctx.traffic
        self.ctx = ctx
        self.N, self.chi, self.chi_msg = cfg["N"], cfg["chi"], cfg["chi_msg"]
        self.cell = ctx.cell
        self.step_errors = (torch.linalg.LinAlgError, FloatingPointError)
        self.bp = BP
        self.bp_config = BP.BPConfig(
            trunc_dim=self.chi_msg, bubble_trunc_dim=self.chi,
            max_iterations=1,
            hermitize_when_finished=False, dtype=ctx.dtype)
        self.start = inputs.uniform_messages(self.N, cfg["D"], self.chi_msg, ctx.dtype, ctx.device)
        self.sample = ctx.rng.randrange(int(mix.get("check_within_first", 1)))
        self.recipe = recipe_for(cfg)
        self.kept = {}

    # the port's messages: {BlockSide: MPS}; the benchmark's: {side: sites}
    def _to_port(self, sites):
        from kagomeperiodicbp_tpu_torch.lattices import BlockSide
        from kagomeperiodicbp_tpu_torch.ops import mps

        return {BlockSide(s): mps.from_sites(ss) for s, ss in sites.items()}

    @staticmethod
    def _from_port(msgs):
        return {int(s): tuple(m.sites) for s, m in msgs.items()}

    def _sweep(self, sites):
        msgs, stats = self.bp.belief_propagation(self.cell, self._to_port(sites),
                                                 self.bp_config, self.N)
        if stats.iterations < 1:
            raise FloatingPointError("BP ran no sweep")
        return self._from_port(msgs)

    def warm(self):
        sites = self.start
        for _ in range(int(self.ctx.traffic.get("warm_sweeps", 1))):
            sites = self._sweep(sites)
        self.msgs = sites

    def step(self, i: int):
        new = self._sweep(self.msgs)
        if i == self.sample:
            self.kept["sample"] = (self.msgs, new)
        self.msgs = new

    def release(self):
        """Drop the program's state that the check does not read."""
        self.msgs = None

    def _kets(self):
        return (self.cell.A, self.cell.B, self.cell.C)

    def subject_outputs(self, subject: str, msgs_in, msgs_out):
        """What is judged: the program's messages, or the control's (the
        reference in the precision below the configuration's) in its place."""
        if subject == "program":
            from portbench.reference.contract import dense

            return {s: dense(ss) for s, ss in msgs_out.items()}
        return ref_bp.sweep(self._kets(), msgs_in, self.N, self.chi, self.chi_msg,
                            precision(subject, self.ctx.config), self.recipe)

    def readings(self, subject: str = "program") -> dict:
        if "sample" not in self.kept:
            return {"msg_gap": float("inf")}
        msgs_in, msgs_out = self.kept["sample"]
        ref = ref_bp.sweep(self._kets(), msgs_in, self.N, self.chi, self.chi_msg,
                           precision("reference", self.ctx.config), self.recipe)
        got = self.subject_outputs(subject, msgs_in, msgs_out)
        return {"msg_gap": max(phase_gap(got[side], ref[side]) for side in range(6))}

    def check(self, limits: dict) -> dict:
        return {k: {"value": v, "limit": limits[k]["limit"]} for k, v in self.readings().items()}
