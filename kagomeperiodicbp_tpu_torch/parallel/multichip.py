"""Multi-rank execution: BP sweeps and edge updates over a (dp, side) mesh of
ranks (counterpart of kagomeperiodicbp_tpu/parallel/multichip.py).

The reference's two distribution layers, as in the JAX package:

* the 6-way message parallelism (src/utils/parallels.py:88-109)
  is the mesh's **side** axis: the batched sweep's three 120°-rotated copies
  of the network (``algo/batched``) are laid over 3 ranks, side rank b
  contracting rotation b's outgoing message of each symmetry class, and the
  sites are gathered over the side group;
* the HTCondor parameter sweeps (scripts/condor/) are the
  **dp** axis: independent chains split over the dp group, each dp rank
  running its chains one after another, every result gathered back, the
  mean energy an all-reduce.

Where the JAX package has GSPMD insert the collectives into one program, the
ranks here are processes (``launch.run_group``) and the collectives are
explicit (``launch.all_gather``, ``launch.all_reduce_sum``). Every rank gets
the full inputs and returns the full results. ``dt`` and the damping are
numbers per call.
"""
from __future__ import annotations

import time
from typing import Dict, Optional, Sequence, Tuple

import torch

from ..algo import batched as B
from ..algo import contraction as C
from ..algo import edge_env as E
from ..algo import fused as F
from ..enums import UpdateEdge
from ..lattices.kagome import KagomeBlock
from ..networks.unit_cell import UnitCell
from ..ops import ite_kernels as K
from . import launch

DIMS = ("dp", "side")
MsgSites = Dict[int, Tuple[torch.Tensor, ...]]


def mesh_shape(n: int) -> Tuple[int, int]:
    """(dp, side) for n ranks: with n ≥ 3 the largest 3-divisible subset,
    (n // 3, 3), since the rotation batch is the latency-critical axis; pure
    data-parallel (n, 1) below 3 (the JAX package's ``make_mesh`` factoring)."""
    if n < 1:
        raise ValueError(f"a mesh needs at least one rank, got {n}")
    return (n // 3, 3) if n >= 3 else (n, 1)


def make_mesh(world: Optional[int] = None, n_devices: Optional[int] = None):
    """The (dp, side) mesh of `n_devices` (or `world`, or the group's) ranks:
    a ``DeviceMesh`` with dims ("dp", "side") inside a group, the plain
    (dp, side) shape outside one. ``launch.run_group`` starts exactly dp·side
    ranks, so the mesh covers the group."""
    n = n_devices or world
    if n is None:
        import torch.distributed as dist

        n = dist.get_world_size() if dist.is_initialized() else 1
    return launch.mesh(mesh_shape(n), DIMS)


def side_sharder(mesh):
    """The side axis as ``algo/batched``'s class hook: side rank b runs the
    per-side body (``fused._one_outgoing``) on rotation b alone and the
    outgoing sites are gathered over the side group, stacked [3, …] as the
    vmapped call returns them. None (the vmapped default) when the side axis
    has one rank. The sites have the static padded bond profile, so every
    rank gathers equal shapes."""
    group, size, b = launch.axis(mesh, "side", DIMS)
    if size == 1:
        return None
    if size != 3:
        raise ValueError(f"the side axis carries the 3 rotations, not {size}")

    def class_outgoing(fused_stack, msg_stack: MsgSites, N: int, D: int, chi: int,
                       chi_msg: int, base: int):
        fused3 = tuple(f[b] for f in fused_stack)
        msgs = {s: tuple(x[b] for x in xs) for s, xs in msg_stack.items()}
        sites = F._one_outgoing(fused3, msgs, N, D, chi, chi_msg, base).sites
        return tuple(torch.stack(launch.all_gather(s, group)) for s in sites)

    return class_outgoing


def sharded_bp_step(N: int, D: int, chi: int, chi_msg: int, mesh, damped: bool = False):
    """Single-chain BP sweep with the rotation batch over the side axis:
    run(fused, msg_sites, damping_value=0.0) → (new_msg_sites, mean
    distance), the contract of ``batched.bp_iteration_batched``."""
    impl = B.bp_sweep_impl(N, D, chi, chi_msg, damped, class_outgoing=side_sharder(mesh))

    def run(fused, msg_sites: MsgSites, damping_value: float = 0.0):
        return impl(tuple(fused), msg_sites, float(damping_value))

    return run


def _my_chains(n: int, mesh) -> Tuple[range, object]:
    group, dp, r = launch.axis(mesh, "dp", DIMS)
    if n % dp:
        raise ValueError(f"{n} chains do not split over a dp axis of {dp}")
    k = n // dp
    return range(r * k, (r + 1) * k), group


def _chain_msgs(msg_batch: MsgSites, i: int) -> MsgSites:
    return {s: tuple(x[i] for x in xs) for s, xs in msg_batch.items()}


def _gather(xs: Sequence[torch.Tensor], group) -> torch.Tensor:
    """This dp rank's per-chain values stacked, gathered over the dp group
    in chain order."""
    return torch.cat(launch.all_gather(torch.stack(list(xs)), group))


def _gather_msgs(outs: Sequence[MsgSites], group) -> MsgSites:
    return {s: tuple(_gather([o[s][k] for o in outs], group) for k in range(len(outs[0][s])))
            for s in outs[0]}


def _energy(t1, t2, env, h):
    return K.expectation(K.rho_ij(t1, t2, env), h).real


def multichain_bp_energy_step(N: int, D: int, chi: int, chi_msg: int, mesh, edge: UpdateEdge):
    """run(cells_batch, msg_sites_batch, h) → (new_msg_sites_batch, err[n],
    energy[n], mean_energy):

    * cells_batch — (A, B, C), each [n_chains, d, D, D, D, D];
    * msg_sites_batch — side → tuple of [n_chains, …] site tensors;
    * h — the 2-site Hamiltonian [d, d, d, d].

    Each chain runs one synchronous BP sweep (rotations over the side axis)
    and measures the edge energy from the new messages (the reference's
    per-worker unit, scripts/condor/worker.py:38). Chains split over dp."""
    sweep = B.bp_sweep_impl(N, D, chi, chi_msg, False, class_outgoing=side_sharder(mesh))

    def one_chain(cells, msg_sites, h):
        new, err = sweep(C.fused_cells(UnitCell(*cells)), msg_sites, 0.0)
        t1, t2, env = F._edge_env(cells, new, N, chi, chi_msg, edge)
        return new, err, _energy(t1, t2, env, h)

    def run(cells_batch, msg_sites_batch: MsgSites, h):
        n = cells_batch[0].shape[0]
        mine, group = _my_chains(n, mesh)
        outs = [one_chain(tuple(c[i] for c in cells_batch), _chain_msgs(msg_sites_batch, i), h)
                for i in mine]
        energies = _gather([o[2] for o in outs], group)
        mean = launch.all_reduce_sum(torch.stack([o[2] for o in outs]).sum(), group) / n
        return (_gather_msgs([o[0] for o in outs], group), _gather([o[1] for o in outs], group),
                energies, mean)

    return run


def write_back_perms(N: int, D: int, edge: UpdateEdge):
    """The virtual-leg permutations of the edge pair's kets (static, from
    shapes only), which the update's write-back undoes."""
    block = KagomeBlock.build(N)
    n1, n2 = E.edge_pair(block, edge)
    dummy = torch.zeros((2, D, D, D, D))
    _, p1 = E._canonical_ket(lambda v: dummy, block, n1, edge.direction())
    _, p2 = E._canonical_ket(lambda v: dummy, block, n2, edge.direction().opposite())
    return p1, p2


def multichain_ite_step(N: int, D: int, chi: int, chi_msg: int, mesh, edge: UpdateEdge,
                        als_iters: int = 10):
    """run(cells_batch, msg_sites_batch, h, dt) → (new_cells_batch,
    new_msg_sites_batch, err[n], energy[n], mean_energy).

    The full work unit per chain: one synchronous BP sweep (rotations over
    the side axis), then one ITE edge update (Trotter gate, ALS truncation,
    write-back of the normalised pair) and the pair's energy after the
    update in the old environment. This is the reference's ITE inner loop
    (src/algo/imaginary_time_evolution/_tn_update.py:165). Chains split over
    dp; every rank returns all of them."""
    sweep = B.bp_sweep_impl(N, D, chi, chi_msg, False, class_outgoing=side_sharder(mesh))
    p1, p2 = write_back_perms(N, D, edge)

    def one_chain(cells, msg_sites, h, dt):
        new, err = sweep(C.fused_cells(UnitCell(*cells)), msg_sites, 0.0)
        t1, t2, env = F._edge_env(cells, new, N, chi, chi_msg, edge)
        t1n, t2n, energy, *_ = F._gate_als(t1, t2, env, h, dt, D, als_iters, normalize=True)
        out = list(cells)
        out[int(edge.first)] = F._unpermute(t1n, p1)
        out[int(edge.second)] = F._unpermute(t2n, p2)
        return tuple(out), new, err, energy

    def run(cells_batch, msg_sites_batch: MsgSites, h, dt: float):
        n = cells_batch[0].shape[0]
        mine, group = _my_chains(n, mesh)
        outs = [one_chain(tuple(c[i] for c in cells_batch), _chain_msgs(msg_sites_batch, i), h,
                          float(dt))
                for i in mine]
        cells = tuple(_gather([o[0][f] for o in outs], group) for f in range(3))
        mean = launch.all_reduce_sum(torch.stack([o[3] for o in outs]).sum(), group) / n
        return (cells, _gather_msgs([o[1] for o in outs], group),
                _gather([o[2] for o in outs], group), _gather([o[3] for o in outs], group), mean)

    return run


# ---------------- rank functions (run under launch.run_group) ---------------


def _timed(fn, reps: int):
    """fn()'s result and its wall time per call (s), each call ended by a
    synchronise of the rank's device."""
    dev = launch.device()
    times, out = [], None
    for _ in range(reps):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        times.append(time.perf_counter() - t0)
    return out, times


def rank_report(uncounted: Optional[dict] = None) -> list:
    """Every rank's device, K1/K2 launches and partitioned swallows since
    the counts were last reset, less this rank's `uncounted` launches (those
    of reference runs inside a check, ``_uncounted``), in rank order."""
    from ..ops import contract as CT
    from ..ops import kernels

    launches = {n: c - (uncounted or {}).get(n, 0) for n, c in kernels.launch_counts().items()}
    return launch.all_ranks({"device": str(launch.device()), "launches": launches,
                             "partitioned": CT.partition_counts()})


def _uncounted(tally: dict, fn, *args):
    """fn(*args), its kernel launches added to `tally` (a reference run
    inside a check, whose launches ``rank_report`` leaves out)."""
    from ..ops import kernels

    before = kernels.launch_counts()
    out = fn(*args)
    for n, c in kernels.launch_counts().items():
        tally[n] = tally.get(n, 0) + c - before[n]
    return out


def _reset_counts():
    from ..ops import contract as CT
    from ..ops import kernels

    kernels.reset_launch_counts()
    CT.reset_swallow_counts()


def sharded_sweep_task(fused, msg_sites: MsgSites, N: int, D: int, chi: int, chi_msg: int,
                       reps: int = 1) -> dict:
    """One side-sharded sweep of (fused, msg_sites) over the group's (dp,
    side) mesh, `reps` times: {"out": (new_msg_sites, mean distance),
    "seconds": per sweep, "ranks": ``rank_report``}."""
    fused, msg_sites = launch.moved((tuple(fused), msg_sites), launch.device())
    step = sharded_bp_step(N, D, chi, chi_msg, make_mesh())
    _reset_counts()
    out, times = _timed(lambda: step(fused, msg_sites), reps)
    return {"out": out, "seconds": times, "ranks": rank_report()}


def multichain_task(kind: str, cells_batch, msg_batch: MsgSites, h, N: int, D: int, chi: int,
                    chi_msg: int, edge: UpdateEdge, dt: float = 0.0, als_iters: int = 10,
                    reps: int = 1) -> dict:
    """``multichain_bp_energy_step`` (kind "bp") or ``multichain_ite_step``
    (kind "ite") over the group's (dp, side) mesh, `reps` times on the same
    inputs: {"out": the step's result, "seconds", "ranks"}."""
    cells_batch, msg_batch, h = launch.moved((tuple(cells_batch), msg_batch, h), launch.device())
    mesh = make_mesh()
    if kind == "bp":
        step = multichain_bp_energy_step(N, D, chi, chi_msg, mesh, edge)
        call = lambda: step(cells_batch, msg_batch, h)  # noqa: E731
    elif kind == "ite":
        step = multichain_ite_step(N, D, chi, chi_msg, mesh, edge, als_iters)
        call = lambda: step(cells_batch, msg_batch, h, dt)  # noqa: E731
    else:
        raise ValueError(f"unknown multichain step {kind!r}")
    _reset_counts()
    out, times = _timed(call, reps)
    return {"out": out, "seconds": times, "ranks": rank_report()}


def failing_task(rank: int) -> None:
    """Raises on `rank` (tests show that a failing rank fails the group)."""
    import torch.distributed as dist

    if dist.get_rank() == rank:
        raise RuntimeError(f"rank {rank} fails on purpose")
    dist.barrier()


# ------------------------------- dry run ------------------------------------


DRYRUN_PASSES = {  # dtype: (bp, energy, χ-shard tolerances, max sweeps) (MULTICHIP_r05.json)
    "complex64": (2e-5, 1e-3, 1e-5, 80),
    "complex128": (1e-9, 1e-8, 1e-10, 140),
}


def dryrun_multichip(world: int, device: str = "cuda", D: int = 3, N: int = 2,
                     chi: int = 18, dtypes: Sequence[str] = ("complex64", "complex128")) -> list:
    """The multi-rank training step over a (dp, side) mesh of `world` ranks,
    run to BP convergence and held to the single-process path (the
    counterpart of ``__graft_entry__.dryrun_multichip``), once per dtype:

    1. the sharded BP converges (every chain's distance below the bp bar);
    2. chain 0's and the last chain's edge energy equal a fresh
       single-process BP (as many sweeps) and measurement of the same cell;
    3. the χ-sharded outgoing message (``chi_shard``, one contraction over
       all ranks) equals the unsharded one at chain 0's fixed point;
    4. the full ITE step runs on the converged messages and keeps the
       cells' shapes.

    Raises on a miss; returns rank 0's summary of each pass, whose rank
    reports count the launches of the sharded calls only (the
    single-process references of checks 2 and 3 are left out). Both
    passes run in one group."""
    return launch.run_each(world, [(dryrun_pass, (dt, D, N, chi)) for dt in dtypes], device=device)


def dryrun_pass(dtype_name: str, D: int, N: int, chi: int) -> dict:
    """One pass of ``dryrun_multichip`` in `dtype_name` (a rank function)."""
    import torch.distributed as dist

    from ..algo import bp as BP
    from ..enums import UnitCellFlavor
    from ..lattices import BlockSide
    from ..ops import mps as mpslib
    from ..physics.hamiltonians import heisenberg_afm
    from . import chi_shard as CS

    bp_tol, e_tol, chi_tol, max_sweeps = DRYRUN_PASSES[dtype_name]
    dtype, dev = getattr(torch, dtype_name), launch.device()
    _reset_counts()
    say = print if dist.get_rank() == 0 else (lambda *a, **k: None)
    say(f"--- dryrun pass: dtype={dtype_name}, tolerances (bp {bp_tol:.0e}, energy "
        f"{e_tol:.0e}, χ-shard {chi_tol:.0e}) ---", flush=True)
    mesh = make_mesh()
    n_chains = mesh_shape(dist.get_world_size())[0]
    # the same cells on every rank: drawn on the CPU, then moved
    cells = [UnitCell.random(2, D, torch.Generator().manual_seed(i), dtype).to_device(dev)
             for i in range(n_chains)]
    cells_batch = tuple(torch.stack([c[f] for c in cells]) for f in "ABC")
    msgs = C.initial_messages(N, D, chi, model="uniform", dtype=dtype, device=dev)
    msg_batch = {int(s): tuple(x.expand((n_chains,) + x.shape) for x in m.sites)
                 for s, m in msgs.items()}
    h = torch.as_tensor(heisenberg_afm(), dtype=dtype, device=dev)
    edge = UpdateEdge(UnitCellFlavor.B, UnitCellFlavor.C)

    # 1. the sharded BP to convergence
    bp_step = multichain_bp_energy_step(N, D, chi, chi, mesh, edge)
    batch = msg_batch
    for sweep in range(max_sweeps):
        batch, errs, energies, _ = bp_step(cells_batch, batch, h)
        max_err = float(errs.max())
        if max_err < bp_tol:
            break
    if not max_err < bp_tol:
        raise AssertionError(f"sharded BP did not converge: err={max_err:.2e} after "
                             f"{sweep + 1} sweeps")
    out = {"dtype": dtype_name, "mesh": list(mesh_shape(dist.get_world_size())),
           "sweeps": sweep + 1, "errs": errs.tolist(), "energies": energies.tolist()}
    say(f"dryrun_multichip({dist.get_world_size()}): mesh (dp, side) {tuple(out['mesh'])} — "
        f"sharded BP converged in {sweep + 1} sweeps, errs={[f'{e:.1e}' for e in out['errs']]}, "
        f"edge energies={[round(e, 6) for e in out['energies']]}", flush=True)

    # 2. each checked chain against a fresh single-process BP + measurement,
    # run for as many sweeps as the sharded one (a BP stopped at its own
    # first sweep below the bar can sit a sweep away, further than the
    # energy bar), on the side-0 rank of the dp rank that owns the chain, so
    # the dp ranks check their chains at once
    # (the reference runs' launches are kept out of the rank's counts)
    mine, _ = _my_chains(n_chains, mesh)
    single, reference = {}, {}
    if launch.axis(mesh, "side", DIMS)[2] == 0:
        for i in sorted({0, n_chains - 1} & set(mine)):
            cfg = BP.BPConfig(trunc_dim=chi, max_iterations=sweep + 1, msg_diff_terminate=0.0,
                              hermitize_when_finished=False, dtype=dtype)
            conv, _ = _uncounted(reference, BP.belief_propagation, cells[i], msgs, cfg, N)
            kets = (cells[i].A, cells[i].B, cells[i].C)
            e_single = float(_energy(*_uncounted(reference, F._edge_env, kets,
                                                 F._msgs_to_sites(conv), N, chi, chi, edge), h))
            single[i] = {"sharded": float(energies[i]), "single": e_single,
                         "gap": abs(float(energies[i]) - e_single)}
    out["single"] = {i: v for part in launch.all_ranks(single) for i, v in part.items()}
    for i, v in sorted(out["single"].items()):
        say(f"  chain {i}: sharded E={v['sharded']:.6f}  single-process E={v['single']:.6f}  "
            f"|Δ|={v['gap']:.2e}", flush=True)
        if not v["gap"] < e_tol:
            raise AssertionError(f"chain {i}: sharded {v['sharded']} vs single {v['single']}")

    # 3. one contraction χ-sharded over every rank, at chain 0's fixed point
    conv0 = F._sites_to_msgs(_chain_msgs(batch, 0))
    toward = BlockSide(0)
    m_ref = _uncounted(reference, C.outgoing_message, cells[0], conv0, N, D, chi, chi, toward)
    m_shd = CS.outgoing_message_sharded(cells[0], conv0, N, D, chi, chi, toward, CS.chi_mesh())
    out["chi_shard_distance"] = chi_dist = float(mpslib.distance(m_shd, m_ref))
    say(f"  χ-sharded contraction over {dist.get_world_size()} ranks: message distance vs "
        f"single-process = {chi_dist:.2e}", flush=True)
    if not chi_dist < chi_tol:
        raise AssertionError(f"χ-sharded contraction mismatch: {chi_dist}")

    # 4. the full training step on the converged messages
    step = multichain_ite_step(N, D, chi, chi, mesh, edge)
    new_cells, _, _, energies2, mean2 = step(cells_batch, batch, h, 1e-3)
    if [tuple(x.shape) for x in new_cells] != [tuple(x.shape) for x in cells_batch]:
        raise AssertionError("the update must keep the cells' shapes")
    out["ite_energies"], out["ite_mean"] = energies2.tolist(), float(mean2)
    say(f"  ITE step on converged messages: post-update edge energies="
        f"{[round(e, 6) for e in out['ite_energies']]}, mean={out['ite_mean']:.6f}", flush=True)
    out["ranks"] = rank_report(reference)
    return out
