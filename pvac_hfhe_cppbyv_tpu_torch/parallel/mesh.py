"""The (dp, tp) mesh of a torch.distributed world.

Counterpart of the JAX package's parallel/mesh.py.  A world of dp * tp
processes is laid out as the JAX mesh's device grid, rank = dp_rank * tp +
tp_rank:

- ``dp`` (data parallel) splits PRF lanes and σ edges; no collectives.
- ``tp`` (tensor parallel) splits the LPN secret contraction (kernel A's
  word windows, whose partial bits XOR over the tp group) and H's columns
  (kernel C's column blocks).

A rank talks over two kinds of process group:

- device groups, for CUDA tensors: NCCL where each rank has a card of its
  own, gloo where ranks share one (NCCL refuses two ranks on one device;
  gloo stages CUDA tensors through the host);
- a gloo host group over the world, for control messages and numpy arrays.

:func:`spawn_world` starts a world of processes and runs a function on
every rank; :func:`make_mesh` builds the mesh inside an initialised world.
"""
from __future__ import annotations

import dataclasses
import datetime
import multiprocessing as mp
import os
import tempfile
import time
import traceback
from multiprocessing import connection

import torch
import torch.distributed as dist


def default_mesh_shape(n_devices: int) -> tuple[int, int]:
    """Split devices into (dp, tp): tp gets up to 4, dp the rest."""
    tp = 1
    for cand in (4, 2):
        if n_devices % cand == 0 and n_devices >= cand:
            tp = cand
            break
    return n_devices // tp, tp


def shard_bounds(n: int, parts: int, part: int) -> tuple[int, int]:
    """Rows [lo, hi) of part ``part`` when n rows split into ``parts`` runs
    as evenly as they go, the first n % parts one longer."""
    base, extra = divmod(n, parts)
    lo = part * base + min(part, extra)
    return lo, lo + base + (part < extra)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of a (dp, tp) mesh: its place, its device and its
    process groups (``group``: the world, for device tensors; ``dp_group``:
    the ranks of its tp position; ``tp_group``: the ranks of its dp row;
    ``host``: gloo over the world)."""
    dp: int
    tp: int
    rank: int
    device: torch.device
    group: object
    dp_group: object
    tp_group: object
    host: object

    @property
    def size(self) -> int:
        return self.dp * self.tp

    @property
    def dp_rank(self) -> int:
        return self.rank // self.tp

    @property
    def tp_rank(self) -> int:
        return self.rank % self.tp


def rank_device(rank: int, device_type: str) -> torch.device:
    """Rank ``rank``'s device: cuda:(rank % cards), or the CPU."""
    if device_type == "cuda":
        return torch.device("cuda", rank % torch.cuda.device_count())
    if device_type == "cpu":
        return torch.device("cpu")
    raise ValueError(f"unsupported device type {device_type!r}")


def make_mesh(shape: tuple[int, int] | None = None, device_type: str = "cuda") -> Mesh:
    """The mesh of the initialised default group, ``shape`` (dp, tp) or
    :func:`default_mesh_shape` of the world.  Call it on every rank, in
    the same order: it creates process groups."""
    from torch.distributed.device_mesh import init_device_mesh

    world, rank = dist.get_world_size(), dist.get_rank()
    dp, tp = shape or default_mesh_shape(world)
    if dp * tp != world:
        raise ValueError(f"mesh {(dp, tp)} != {world} ranks")
    dm = init_device_mesh(device_type, (dp, tp), mesh_dim_names=("dp", "tp"))
    host = (dist.group.WORLD if dist.get_backend() == "gloo"
            else dist.new_group(backend="gloo"))
    return Mesh(dp, tp, rank, rank_device(rank, device_type), dist.group.WORLD,
                dm.get_group("dp"), dm.get_group("tp"), host)


def _rank_main(rank, shape, device_type, backend, init, timeout_s, fn, args, conn):
    """One rank of :func:`spawn_world`: join the world, build the mesh, run
    fn(mesh, *args) and send (ok, result or traceback) to the parent."""
    try:
        device = rank_device(rank, device_type)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group(backend, init_method=init, rank=rank,
                                world_size=shape[0] * shape[1],
                                timeout=datetime.timedelta(seconds=timeout_s))
        out = fn(make_mesh(shape, device_type), *args)
    except BaseException:  # noqa: BLE001 - reported to the parent, which fails the world
        conn.send((False, f"rank {rank}:\n{traceback.format_exc()}"))
        conn.close()
        os._exit(1)  # skip the group's teardown: peers may be stuck in a collective
    conn.send((True, out))
    conn.close()
    dist.destroy_process_group()


def spawn_world(fn, shape: tuple[int, int], device_type: str = "cuda",
                timeout_s: float = 600.0, args: tuple = ()) -> list:
    """Run fn(mesh, *args) on every rank of a new world of dp * tp
    processes (the ``spawn`` start method; ``fn`` and ``args`` are
    pickled) and return the ranks' results in rank order.

    Rank i takes cuda:(i % cards) for ``device_type="cuda"``, which raises
    without a card; the device groups are NCCL where every rank has a card
    of its own and gloo otherwise.  The ranks meet
    at a fresh temporary file, so concurrent worlds never share a port.  A
    rank that raises or dies fails the whole world at once: the others are
    killed and this raises with its traceback.  So does a world that has
    not finished within ``timeout_s``, which also bounds every collective."""
    dp, tp = shape
    world = dp * tp
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available for device='cuda'; pass "
                           "device_type='cpu' for the host route")
    backend = "nccl" if device_type == "cuda" and torch.cuda.device_count() >= world else "gloo"
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="pvac_world_") as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        procs, pipes = [], {}
        try:
            for rank in range(world):
                recv, send = ctx.Pipe(duplex=False)
                p = ctx.Process(target=_rank_main, daemon=True, args=(
                    rank, shape, device_type, backend, init, timeout_s, fn, args, send))
                p.start()
                send.close()
                procs.append(p)
                pipes[rank] = recv
            return _collect(procs, pipes, time.monotonic() + timeout_s, shape, timeout_s)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()


def _collect(procs, pipes, deadline, shape, timeout_s) -> list:
    """Every rank's result, or raise at the first rank that fails."""
    results = {}
    while pipes:
        left = deadline - time.monotonic()
        if left <= 0:
            raise TimeoutError(f"world {shape} did not finish in {timeout_s} s")
        ready = connection.wait([*pipes.values(), *(procs[r].sentinel for r in pipes)], left)
        for rank, conn in list(pipes.items()):
            if conn in ready or (procs[rank].sentinel in ready and conn.poll()):
                try:
                    ok, val = conn.recv()
                except EOFError:
                    procs[rank].join()
                    raise RuntimeError(f"rank {rank} of world {shape} exited with code "
                                       f"{procs[rank].exitcode} and no result") from None
                del pipes[rank]
                if not ok:
                    raise RuntimeError(f"world {shape} failed at {val}")
                results[rank] = val
            elif procs[rank].sentinel in ready:
                procs[rank].join()
                raise RuntimeError(f"rank {rank} of world {shape} exited with code "
                                   f"{procs[rank].exitcode} and no result")
    for p in procs:
        p.join(timeout=max(1.0, deadline - time.monotonic()))
    return [results[r] for r in range(len(procs))]
