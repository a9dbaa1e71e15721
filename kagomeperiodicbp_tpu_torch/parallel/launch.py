"""Process groups for the port's distribution layer (no counterpart in the
JAX package, where GSPMD places one program over a device mesh; here every
rank is a process of its own and the collectives are explicit).

``run_group(world, fn, *args)`` starts `world` ranks with
``torch.multiprocessing.spawn``, runs ``fn(*args)`` in each and returns what
rank 0 returned, moved to the CPU. The ranks meet through a ``FileStore`` in
a temporary directory, so no TCP port is needed.

The backend rule, printed with each group's devices when it starts:

* ``nccl`` when every rank has a card of its own
  (``world <= torch.cuda.device_count()``), rank r on ``cuda:r``;
* ``gloo`` with rank r on ``cuda:(r % count)`` when ranks share cards (NCCL
  refuses two ranks of one communicator on one GPU);
* ``gloo`` on the CPU only when the caller passes ``device="cpu"``.

Asking for the card where there is none raises; nothing falls back to the
CPU. Gloo takes no ``all_gather`` of CUDA tensors, so ``all_gather`` and
``all_reduce_sum`` below, which every module of the layer uses, copy a CUDA
tensor through the host under gloo and back to its device; under NCCL they
hand it over as it is.

A rank's exception ends the group: the other ranks are terminated and
``run_group`` raises ``RankError`` with the rank's traceback. Each rank sets
its torch thread count (1 by default) and calls ``destroy_process_group``
before it exits. The kernels are built in the caller before any rank
starts, so ranks do not race ``nvcc`` into the build directory.

With ``world == 1`` no group is made: ``fn`` runs in the calling process, and
the mesh functions of ``multichip`` and ``chi_shard`` return a plain shape
whose axes have size 1 (the degenerate mesh, the same code path).
"""
from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# this process's rank device, set by run_group (in-process for world 1)
_STATE = {"device": None}
_MESHES: dict = {}


class RankError(RuntimeError):
    """A rank of a group raised; the message carries its traceback."""


def plan(world: int, device: str = "cuda") -> Tuple[str, List[str]]:
    """(backend, each rank's device) for `world` ranks, by the rule above."""
    if world < 1:
        raise ValueError(f"a group needs at least one rank, got {world}")
    if torch.device(device).type == "cpu":
        return "gloo", ["cpu"] * world
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the group runs on the card by default; "
                           "pass device='cpu' to run it on the CPU")
    count = torch.cuda.device_count()
    if world <= count:
        return "nccl", [f"cuda:{r}" for r in range(world)]
    return "gloo", [f"cuda:{r % count}" for r in range(world)]


def device() -> torch.device:
    """This rank's device (the caller's choice when no group runs)."""
    if _STATE["device"] is None:
        raise RuntimeError("no rank device: call this under launch.run_group")
    return _STATE["device"]


def _setup_device(dev: torch.device) -> torch.device:
    from ..measure import setup_device

    dev = setup_device(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return dev


def moved(x, dev):
    """`x` with every tensor in it on `dev`: tensors, unit cells, and
    dataclasses (``MPS``), lists, tuples and dicts of them."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(dev)
    if hasattr(x, "to_device"):
        return x.to_device(dev)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{f.name: moved(getattr(x, f.name), dev)
                                         for f in dataclasses.fields(x)})
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(moved(v, dev) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(moved(v, dev) for v in x)
    if isinstance(x, dict):
        return {k: moved(v, dev) for k, v in x.items()}
    return x


def _to_cpu(x):
    return moved(x, "cpu")


def _rank_main(rank: int, world: int, backend: str, devices: Sequence[str], tmp: str,
               threads: int, fn: Callable, args: tuple) -> None:
    torch.set_num_threads(threads)
    _STATE["device"] = _setup_device(torch.device(devices[rank]))
    dist.init_process_group(backend, init_method=f"file://{os.path.join(tmp, 'store')}",
                            rank=rank, world_size=world)
    try:
        out = fn(*args)
        if rank == 0:
            torch.save(_to_cpu(out), os.path.join(tmp, "result.pt"))
        dist.barrier()
    except BaseException:
        # the first rank to fail writes first; the others fail after it
        # (their peer is gone), so the earliest record is the cause
        with open(os.path.join(tmp, f"error.{rank}"), "w") as fh:
            fh.write(f"{time.time()!r}\n{traceback.format_exc()}")
        raise
    finally:
        dist.destroy_process_group()


def _first_error(tmp: str):
    """(rank, traceback) of the rank that failed first, if any wrote one."""
    found = []
    for name in os.listdir(tmp):
        if name.startswith("error."):
            with open(os.path.join(tmp, name)) as fh:
                when, tb = fh.read().split("\n", 1)
            found.append((float(when), int(name.split(".")[1]), tb))
    return min(found)[1:] if found else None


def run_group(world: int, fn: Callable, *args, device: str = "cuda", threads: int = 1) -> Any:
    """Run ``fn(*args)`` on `world` ranks; return rank 0's result on the
    CPU. The ranks are spawned processes, so `fn` is a module-level function
    they can import by name (this package's, not a test module's)."""
    backend, devices = plan(world, device)
    if world == 1:
        prev = _STATE["device"]
        _STATE["device"] = _setup_device(torch.device(devices[0]))
        try:
            return _to_cpu(fn(*args))
        finally:
            _STATE["device"] = prev
    print(f"launch: {world} ranks, backend {backend}, rank devices {devices}", flush=True)
    if devices[0] != "cpu":
        from ..ops import kernels

        kernels.build()
    tmp = tempfile.mkdtemp(prefix="kpbp_group_")
    try:
        try:
            torch.multiprocessing.spawn(_rank_main, nprocs=world, join=True,
                                        args=(world, backend, devices, tmp, threads, fn, args))
        except (torch.multiprocessing.ProcessRaisedException,
                torch.multiprocessing.ProcessExitedException) as exc:
            first = _first_error(tmp)
            if first is None:
                raise RankError(f"rank {exc.error_index} of {world} failed:\n{exc}") from None
            raise RankError(f"rank {first[0]} of {world} raised:\n{first[1]}") from None
        return torch.load(os.path.join(tmp, "result.pt"), weights_only=False)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def run_each(world: int, calls: Sequence[Tuple[Callable, tuple]], device: str = "cuda",
             threads: int = 1) -> list:
    """Several collective calls in one group: every rank runs ``fn(*args)``
    for each (fn, args) in order; rank 0's results, as a list."""
    return run_group(world, _each, list(calls), device=device, threads=threads)


def _each(calls):
    return [fn(*args) for fn, args in calls]


def with_env(env: dict, fn: Callable, *args):
    """fn(*args) with the environment variables `env` set for its duration
    (a rank function: the switches the port reads at each call, such as
    ``KPBP_LINALG``, for one call of a group)."""
    prev = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return fn(*args)
    finally:
        for k, v in prev.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


# ------------------------------ meshes -------------------------------------


def mesh(shape: Tuple[int, ...], names: Tuple[str, ...]):
    """A ``DeviceMesh`` of `shape` over the group's ranks, or `shape` itself
    outside a group. Its device type is ``cuda`` under NCCL and ``cpu``
    under gloo, where the collectives go through the host (the tensors stay
    on their rank's device either way). One mesh per shape and process."""
    n = 1
    for s in shape:
        n *= s
    if not dist.is_initialized():
        return tuple(shape)
    if n != dist.get_world_size():
        raise ValueError(f"a {shape} mesh needs {n} ranks; the group has {dist.get_world_size()}")
    key = (tuple(shape), tuple(names))
    if key not in _MESHES:
        from torch.distributed.device_mesh import init_device_mesh

        kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
        _MESHES[key] = init_device_mesh(kind, tuple(shape), mesh_dim_names=tuple(names))
    return _MESHES[key]


def axis(m, name: str, names: Sequence[str]) -> Tuple[Optional[object], int, int]:
    """(process group, size, this rank's index) of the mesh axis `name`; a
    plain shape has no group, and any of its axes longer than one raises:
    such work runs only under ``run_group``."""
    if isinstance(m, tuple):
        size = m[list(names).index(name)]
        if size != 1:
            raise ValueError(f"a {m} shape with a {name} axis of {size} needs a process group: "
                             "run it under launch.run_group")
        return None, 1, 0
    return m.get_group(name), m.size(m.mesh_dim_names.index(name)), m.get_local_rank(name)


# ---------------------------- collectives ----------------------------------


def all_ranks(obj) -> list:
    """Every rank's picklable `obj`, in rank order ([obj] outside a group)."""
    if not dist.is_initialized():
        return [obj]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def _host_path(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _flat(t: torch.Tensor) -> torch.Tensor:
    t = t.resolve_conj().contiguous()
    return torch.view_as_real(t) if t.is_complex() else t


def all_gather(t: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank's `t` (equal shapes), in the group's rank order. Under gloo
    a CUDA tensor goes through the host and comes back to its device."""
    if group is None:
        return [t]
    host = _host_path(t, group)
    src = _flat(t.cpu() if host else t)
    out = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, src, group=group)
    if t.is_complex():
        out = [torch.view_as_complex(o) for o in out]
    return [o.to(t.device) for o in out] if host else out


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's `t`, on `t`'s device."""
    if group is None:
        return t
    host = _host_path(t, group)
    buf = _flat(t.cpu() if host else t).clone()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    if t.is_complex():
        buf = torch.view_as_complex(buf)
    return buf.to(t.device) if host else buf
