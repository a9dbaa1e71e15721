"""Batched BP: the six outgoing messages of a sweep as two vmapped calls,
one per symmetry class (counterpart of kagomeperiodicbp_tpu/algo/batched.py).

The Kagome block is invariant under 120° rotation about its centre (the
rotation maps upper triangles to upper triangles, cycling the flavours
A→B→C, as ``UnitCell.rotate_ccw`` does). Hence the six block sides fall into
two symmetry classes, {U, DL, DR} and {D, UR, UL}, and

    out_msg(ψ, toward=R·s) = out_msg(R⁻¹ψ, toward=s)   with messages
    relabeled σ → R·σ,     where R = rotate 120° ccw.

One contraction plan per class therefore serves all six sides: the three
rotated copies of the network are stacked along a leading batch axis and
the per-side body (``fused._one_outgoing``) runs once over the stack under
``torch.func.vmap``. Every library call of the body is then made once for
three sides, on a stacked batch, and K2 takes the three copies' grams in one
call (``ops/kernels.chol_inv``'s vmap rule).

The rotation identity needs a unit cell's three fused tensors: a per-site
view (``algo/arbitrary``) has no such symmetry, and ``algo/bp`` sweeps it
per side.

Host reads cannot happen inside the vmapped body, and do not: the executor
and the message post-processing read nothing back. Counters kept in Python
count once per class call, not once per side: ``ops/contract.swallow_counts``
and ``ops/linalg.eigh_retries`` (a failing batched ``eigh`` is retried
shifted for all three copies, and counted once).

Damping is a number passed per call (``run(..., damping_value=)``).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from ..lattices import BlockSide
from ..networks.graph import message_bond_profile
from ..networks.unit_cell import _ROT_PERM, _ROT_SRC, FLAVORS
from ..ops import mps as mpslib
from ..ops.mps import MPS
from . import fused as F

MsgSites = Dict[int, Tuple[torch.Tensor, ...]]

# the two class representatives and the sides of each, in rotation order:
# side = base.rotate_ccw(2*b)
CLASS_SIDES = {
    int(BlockSide.U): [int(BlockSide.U.rotate_ccw(2 * b)) for b in range(3)],
    int(BlockSide.D): [int(BlockSide.D.rotate_ccw(2 * b)) for b in range(3)],
}

_FIDX = {f: i for i, f in enumerate(FLAVORS)}


def _rotate_fused_once(fused: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """Fused tensors of the 120°-ccw-rotated state (leg permutations only:
    fusing commutes with permuting the virtual legs)."""
    return tuple(fused[_FIDX[_ROT_SRC[f]]].permute(_ROT_PERM[f]) for f in FLAVORS)


def _rotated_fused_stacks(fused: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """[ψ, R⁻¹ψ, R⁻²ψ] as one stacked tensor per flavour, [3, p, p, p, p]
    (R⁻¹ = R², the rotations forming Z₃). K1 is not launched again."""
    if len(fused) != 3:
        raise ValueError(f"the batched sweep needs a unit cell's 3 fused tensors, got {len(fused)}")
    f0 = tuple(fused)
    f2 = _rotate_fused_once(f0)               # R¹ψ  (= R⁻²ψ)
    f1 = _rotate_fused_once(f2)               # R²ψ  (= R⁻¹ψ)
    per_b = (f0, f1, f2)
    return tuple(torch.stack([per_b[b][i] for b in range(3)]) for i in range(3))


def _stacked_msg_sites(msg_sites: MsgSites, base: int) -> MsgSites:
    """Per plan slot σ (≠ base), the messages of sides σ·R^b stacked over b:
    the rotated copy b of the network carries M[σ.rotate_ccw(2b)] at σ."""
    return {int(sigma): tuple(
                torch.stack([msg_sites[int(sigma.rotate_ccw(2 * b))][k] for b in range(3)])
                for k in range(len(msg_sites[int(sigma)])))
            for sigma in BlockSide if int(sigma) != base}


def _class_outgoing(fused_stack, msg_stack: MsgSites, N: int, D: int, chi: int, chi_msg: int,
                    base: int) -> Tuple[torch.Tensor, ...]:
    """The outgoing messages of one symmetry class over the stacked
    three-rotation batch: a tuple of stacked sites [3, Dl, p, Dr]. The
    per-side body runs unchanged under vmap; "same" randomness gives the
    three copies one sketch, as the JAX package's shape-folded key does.
    Its QRs are batched, so ``ops/linalg._qr`` factors complex64 ones in
    complex128 (the card's batched complex64 QR fails where the per-side
    one does not)."""

    def one(fused3, msgs):
        return tuple(F._one_outgoing(fused3, msgs, N, D, chi, chi_msg, base).sites)

    return torch.func.vmap(one, randomness="same")(fused_stack, msg_stack)


def bp_sweep_impl(N: int, D: int, chi: int, chi_msg: int, damped: bool,
                  class_outgoing: Optional[Callable] = None):
    """One synchronous BP sweep, (fused3, msg_sites, damping) →
    (new_msg_sites, mean distance):

    * fused3 — the unit cell's three fused tensors;
    * msg_sites — side int → tuple of message site tensors;
    * damping — the fraction of the old message kept (read only when
      `damped`).

    `class_outgoing` is how a class's three rotations are computed, with
    ``_class_outgoing``'s arguments and result; None is that function (one
    vmapped call). ``parallel/multichip.side_sharder`` gives one that lays
    the rotations over the ranks of a mesh axis. The mean distance stays a
    0-dim device tensor."""
    class_outgoing = class_outgoing or _class_outgoing

    def impl(fused3, msg_sites: MsgSites, damping: float):
        fstacks = _rotated_fused_stacks(fused3)
        out_sides = {}
        for base, sides in CLASS_SIDES.items():
            stacked = class_outgoing(fstacks, _stacked_msg_sites(msg_sites, base),
                                     N, D, chi, chi_msg, base)
            for b, side in enumerate(sides):
                out_sides[side] = tuple(s[b] for s in stacked)

        new: MsgSites = {}
        dists = []
        for side in BlockSide:
            wrapped = mpslib.from_sites(out_sides[int(side)]).reverse()
            tgt = int(side.opposite())
            old = mpslib.from_sites(msg_sites[tgt])
            dists.append(mpslib.distance(old, wrapped))
            if damped:
                mixed = mpslib.add(wrapped, old, 1.0 - damping, damping)
                mixed = mpslib.compress(mixed, chi_msg)
                mixed = mpslib.pad_bonds(mixed, message_bond_profile(N, D, chi_msg))
                wrapped = MPS(mixed.sites, torch.zeros_like(mixed.logscale))
            new[tgt] = tuple(wrapped.sites)
        return new, torch.stack(dists).mean()

    return impl


def bp_iteration_batched(N: int, D: int, chi: int, chi_msg: int, damping: Optional[float]):
    """The batched counterpart of ``fused.bp_iteration``: run(fused,
    msg_sites, damping_value=None) → (new_msg_sites, mean distance), the
    damping changeable per call."""
    impl = bp_sweep_impl(N, D, chi, chi_msg, damped=bool(damping))

    def run(fused, msg_sites: MsgSites, damping_value: Optional[float] = None):
        d = damping_value if damping_value is not None else (damping or 0.0)
        return impl(tuple(fused), msg_sites, float(d))

    return run
