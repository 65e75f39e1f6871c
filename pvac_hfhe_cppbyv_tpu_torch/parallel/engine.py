"""The engine on a (dp, tp) mesh: one controller, the other ranks serve.

Counterpart of the JAX package's ``DeviceEngine(mesh=...)`` (its
parallel/engine.py) and of its MulGrid's round-robin over the mesh
devices (parallel/mulgrid.py).  Rank 0, the controller, runs the user's
program (keygen, enc_value_batch, ct_mul, dec_value_batch, ...) with a
:class:`MeshEngine` attached to its public key; ranks 1..W-1 run
:func:`serve` until the controller calls :func:`shutdown`
(:func:`controller` does both).  The ops do not run on every rank: they
draw from the OS CSPRNG, and their host paths depend on the data
(rejected cores, fallback lanes, edge budgets), so ranks would build
different ciphertexts and issue different collectives.

Each engine call on the controller broadcasts an op and its host inputs
over the host group (the seeds of a PRF pass, the stream words of a σ
pass).  Every rank computes its dp shard in passes of at most PRF_CHUNK
cores or SIGMA_CHUNK edges: PRF cores through kernel D, kernel A on its
word window of the secret, the XOR over tp and kernel E; σ rows through
kernel B and kernel C on its block of H's columns.  The ranks' parts are
summed into zeros over the device group (each value comes from one rank
only; NCCL and gloo both all-reduce CUDA tensors), so the results are
tensors on the controller's device, as a CudaEngine's are.  σ rows are
whole on rank 0.

Key material reaches each rank once, when an engine attaches (or first
needs H) or binds a secret key: its block of H's columns, its window of
the LPN secret and the key-derivation prefix (prf_k || canon_tag ||
H_digest), whose midstate the rank computes once for kernel D (every tp
rank derives its dp shard's keys: kernel A needs them on each window).
An engine attached with the public key alone sends no
secret.  MeshEngine.close (engine.disable_device) releases them on every
rank.

The dense grid of a large ct_mul runs its layer blocks round-robin over
the ranks, block k on rank k % W: the blocks' outputs are disjoint, so
each rank finalizes its own and sends the nonzero buckets to the
controller, which hands them out in block order.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch
import torch.distributed as dist

from .. import kernels
from ..core.bits import from_np_u32
from ..crypto import lpn, matrix
from ..crypto.prf_keys import key_msg
from ..crypto.lpn_ybits import tp_window
from ..crypto.sha256_ctr import lanes_from_u64
from ..engine import CudaEngine
from ..mulgrid import MulGrid
from ..types import PubKey, SecKey
from .mesh import Mesh, shard_bounds
from .sharding import tp_combine


def h_block(mw: int, tp: int, tp_rank: int) -> tuple[int, int]:
    """tp rank ``tp_rank``'s words [c0, c1) of every σ row and H row: mw / tp
    of them, where that is a whole number of kernel C's 2-word slices; the
    whole row on every rank otherwise."""
    if tp == 1 or mw % (2 * tp):
        return 0, mw
    w = mw // tp
    return tp_rank * w, (tp_rank + 1) * w


def _bcast(mesh: Mesh, obj=None):
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=mesh.host)
    return box[0]


def _scatter(mesh: Mesh, objs=None):
    box = [None]
    dist.scatter_object_list(box, objs if mesh.rank == 0 else None, src=0, group=mesh.host)
    return box[0]


def _gather(mesh: Mesh, obj):
    out = [None] * mesh.size if mesh.rank == 0 else None
    dist.gather_object(obj, out, dst=0, group=mesh.host)
    return out


class Shard:
    """One rank's part of an engine: its block of H's columns and its window
    of the LPN secret on the rank's device, and the work of its dp shard."""

    def __init__(self, mesh: Mesh, prm):
        self.mesh, self.prm = mesh, prm
        self.c0, self.c1 = h_block(prm.sigma_words32, mesh.tp, mesh.tp_rank)
        self.window = tp_window(prm.s_words64, mesh.tp, mesh.tp_rank)
        self.combine = tp_combine(mesh, self.window)
        self.H = self.s32 = self.key_msg = None
        self.mulgrid = MulGrid(prm, mesh.device)
        self.stats = {"prf_cores": 0, "sigma_edges": 0, "sigma_fused_edges": 0,
                      "sigma_banked_edges": 0, "mulgrid_blocks": 0}

    def bind(self, s32_window: np.ndarray, prefix: bytes) -> None:
        self.s32 = from_np_u32(s32_window, self.mesh.device)
        self.key_msg = key_msg(prefix)

    def prf(self, seeds: np.ndarray, dh: np.ndarray) -> torch.Tensor:
        """This rank's part of the cores of seeds [N, 3] uint64 and dom
        hashes [N] uint64: [N, 5] int64, its dp shard's limbs and rejection
        flag on tp rank 0, zeros elsewhere."""
        m = self.mesh
        out = torch.zeros((seeds.shape[0], 5), dtype=torch.int64, device=m.device)
        lo, hi = shard_bounds(seeds.shape[0], m.dp, m.dp_rank)
        if hi > lo:
            r, rej = lpn.prf_cores_device_seeds(
                self.prm, self.key_msg, lpn.seed_fields(seeds[lo:hi], dh[lo:hi], m.device),
                self.s32, self.window, self.combine)
            if m.tp_rank == 0:
                out[lo:hi, :4] = r
                out[lo:hi, 4] = rej
            self.stats["prf_cores"] += hi - lo
        return out

    def sigma(self, words: np.ndarray) -> torch.Tensor:
        """This rank's part of the σ rows of stream words [E, 7] uint64:
        [E, mw + 1] int32, its dp shard's words [c0, c1) of each row, and on
        tp rank 0 the fallback flag in the last column; zeros elsewhere.
        Where H is whole on every tp rank, only tp rank 0 computes."""
        m, prm = self.mesh, self.prm
        mw = prm.sigma_words32
        out = torch.zeros((words.shape[0], mw + 1), dtype=torch.int32, device=m.device)
        lo, hi = shard_bounds(words.shape[0], m.dp, m.dp_rank)
        if hi > lo and (m.tp_rank == 0 or (self.c0, self.c1) != (0, mw)):
            if matrix.fused_engages(prm, self.H, 32 * self.c0):
                self.stats["sigma_fused_edges"] += hi - lo
                self.stats["sigma_banked_edges"] += hi - lo
            sig, fb = matrix.sigma_device(prm, self.H, lanes_from_u64(words[lo:hi], m.device),
                                          32 * self.c0)
            out[lo:hi, self.c0:self.c1] = sig
            if m.tp_rank == 0:
                out[lo:hi, mw] = fb.to(torch.int32)
            self.stats["sigma_edges"] += hi - lo
        return out

    def grid(self, blocks: list) -> list:
        """Run this rank's grid blocks [(k, start arguments)]: all queued,
        then each finalized -> [(k, nonzero buckets)]."""
        fins = [(k, self.mulgrid.start(*args)) for k, args in blocks]
        self.stats["mulgrid_blocks"] += len(fins)
        return [(k, fin()) for k, fin in fins]

    def report(self) -> dict:
        return {"launches": dict(kernels.LAUNCHES), "stats": dict(self.stats),
                "secret": self.s32 is not None, "device": str(self.mesh.device),
                "engines": len(_held)}


# this process's parts of the live engines, by engine id
_held: dict[int, Shard] = {}


def _run(mesh: Mesh, eid: int, op: str, arg, payload=None):
    """One op of engine ``eid`` on this rank after its header went out:
    the same code on the controller (which passes the per-rank ``payload``
    of a scatter) and on every worker.  Returns what the op gives on this
    rank."""
    if op == "attach":
        _held[eid] = Shard(mesh, arg)
        return None
    if op == "detach":
        del _held[eid]
        return None
    shard = _held[eid]
    if op == "H":
        shard.H = matrix.hx_tensor(_scatter(mesh, payload), mesh.device)
    elif op == "bind":
        shard.bind(*_scatter(mesh, payload))
    elif op == "prf":
        out = shard.prf(*arg)
        dist.all_reduce(out, group=mesh.group)
        return out
    elif op == "sigma":
        out = shard.sigma(arg)
        dist.all_reduce(out, group=mesh.group)
        return out
    elif op == "grid":
        return _gather(mesh, shard.grid(_scatter(mesh, payload)))
    elif op == "report":
        return _gather(mesh, shard.report())
    else:
        raise ValueError(f"unknown engine op {op!r}")
    return None


def serve(mesh: Mesh) -> None:
    """A worker's loop: hold its part of every engine the controller
    attaches, until it is closed, and run each op the controller sends,
    until it sends stop."""
    while True:
        op, eid, arg = _bcast(mesh)
        if op == "stop":
            _held.clear()
            return
        _run(mesh, eid, op, arg)


def shutdown(mesh: Mesh) -> None:
    """On the controller: end every worker's :func:`serve`."""
    _bcast(mesh, ("stop", 0, None))
    _held.clear()


def controller(mesh: Mesh, fn, *args):
    """Call on every rank of a world: rank 0 runs fn(mesh, *args), then
    stops the workers, and returns its result; the other ranks serve
    meanwhile and return None.  If fn raises, rank 0 raises without
    stopping them (they may be inside a collective), and the world's
    launcher (mesh.spawn_world) fails the world."""
    if mesh.rank != 0:
        serve(mesh)
        return None
    out = fn(mesh, *args)
    shutdown(mesh)
    return out


class MeshMulGrid:
    """ct_mul's dense grid over the mesh's ranks.  ``start`` has MulGrid's
    contract; the k-th block started goes to rank k % W.  Blocks wait until
    the first finalize() of one not yet run, which sends every waiting
    block to its rank at once, runs rank 0's here, and gathers the
    nonzero buckets of all of them."""

    def __init__(self, eng: "MeshEngine"):
        self.eng = eng
        self._next = 0
        self._waiting = []
        self._done = {}

    def start(self, slotsA, wA, LA: int, slotsB, wB, LB: int):
        k = self._next
        self._next += 1
        self._waiting.append((k, (np.asarray(slotsA), np.asarray(wA), LA,
                                  np.asarray(slotsB), np.asarray(wB), LB)))

        def finalize():
            if k not in self._done:
                self._flush()
            return self._done.pop(k)

        return finalize

    def _flush(self) -> None:
        blocks, self._waiting = self._waiting, []
        W = self.eng.mesh.size
        per_rank = [[b for b in blocks if b[0] % W == r] for r in range(W)]
        for part in self.eng._call("grid", payload=per_rank):
            self._done.update(part)


class MeshEngine:
    """The controller's engine on a mesh: CudaEngine's interface (the ops
    route through it the same way) with the work spread over the ranks.
    Create it on rank 0 with every other rank in :func:`serve`."""

    PRF_CHUNK = CudaEngine.PRF_CHUNK
    SIGMA_CHUNK = CudaEngine.SIGMA_CHUNK
    _ids = itertools.count(1)

    def __init__(self, pk: PubKey, sk: SecKey | None, mesh: Mesh):
        if mesh.rank != 0:
            raise ValueError("a MeshEngine lives on rank 0; the other ranks run serve(mesh)")
        self.pk, self.prm, self.mesh, self.device = pk, pk.prm, mesh, mesh.device
        self.eid = next(self._ids)
        self.sk = None
        self.has_H = False
        self.stats = {"prf_cores": 0, "sigma_edges": 0, "mulgrid_blocks": 0}
        self._call("attach", self.prm)
        if pk.H is not None:
            self._send_H()
        self.mulgrid = MeshMulGrid(self)
        if sk is not None:
            self.bind_sk(sk)

    def _call(self, op: str, arg=None, payload=None):
        if op != "attach" and self.eid not in _held:
            raise RuntimeError("this mesh engine is closed")
        _bcast(self.mesh, (op, self.eid, arg))
        return _run(self.mesh, self.eid, op, arg, payload)

    def _send_H(self) -> None:
        """Send each rank its block of H's columns (h_block)."""
        m, mw = self.mesh, self.prm.sigma_words32
        self._call("H", payload=[np.ascontiguousarray(
            self.pk.H[:, slice(*h_block(mw, m.tp, r % m.tp))]) for r in range(m.size)])
        self.has_H = True

    def close(self) -> None:
        """Release this engine's part on every rank: its block of H, its
        window of the secret and its grid.  The engine takes no op after
        it; engine.disable_device calls it."""
        if self.eid in _held:
            self._call("detach")

    def bind_sk(self, sk: SecKey) -> None:
        """Send each rank its window of sk's LPN secret and the
        key-derivation prefix, once per sk (CudaEngine.bind_sk)."""
        if sk is self.sk:
            return
        m = self.mesh
        s32 = sk.s_words32().reshape(-1)
        prefix = lpn.derive_layout(self.pk, sk).prefix
        wins = [tp_window(self.prm.s_words64, m.tp, r % m.tp) for r in range(m.size)]
        self._call("bind", payload=[(s32[2 * w.lo:2 * w.hi].copy(), prefix) for w in wins])
        self.sk = sk

    def prf_cores_async_seeds(self, seeds_u64: np.ndarray, dom_hashes: np.ndarray):
        """CudaEngine.prf_cores_async_seeds over the mesh, in ops of at most
        PRF_CHUNK cores per dp rank."""
        N = seeds_u64.shape[0]
        self.stats["prf_cores"] += N
        seeds = np.ascontiguousarray(seeds_u64, dtype=np.uint64)
        dh = np.ascontiguousarray(dom_hashes, dtype=np.uint64)
        C = self.PRF_CHUNK * self.mesh.dp
        outs = [self._call("prf", (seeds[o:o + C], dh[o:o + C])) for o in range(0, N, C)]
        if not outs:
            return (torch.zeros((0, 4), dtype=torch.int64, device=self.device),
                    torch.zeros(0, dtype=torch.bool, device=self.device))
        out = torch.cat(outs)
        return out[:, :4].contiguous(), out[:, 4] != 0

    def sigma(self, words: np.ndarray):
        """CudaEngine.sigma over the mesh, in ops of at most SIGMA_CHUNK
        edges per dp rank."""
        prm = self.prm
        matrix.check_H(prm, self.pk.H)
        if not self.has_H:
            self._send_H()
        E, mw = words.shape[0], prm.sigma_words32
        self.stats["sigma_edges"] += E
        words = np.ascontiguousarray(words, dtype=np.uint64)
        C = self.SIGMA_CHUNK * self.mesh.dp
        outs = [self._call("sigma", words[o:o + C]) for o in range(0, E, C)]
        if not outs:
            return (torch.zeros((0, mw), dtype=torch.int32, device=self.device),
                    torch.zeros(0, dtype=torch.bool, device=self.device))
        out = torch.cat(outs)
        return out[:, :mw].contiguous(), out[:, mw] != 0

    def report(self) -> list[dict]:
        """Every rank's kernel launch counts, its work for this engine
        (stats), whether it holds a window of a secret key and how many
        engines' parts it holds, in rank order."""
        return self._call("report")
