"""Device engine: the scheme's two device programs on one torch device.

``keygen``, ``load_pklite`` and ``keys_from_numpy`` attach an engine on
the card to the public key unless they are given ``device="cpu"``;
:func:`enable_device` attaches one by hand.  With an engine attached the
operations route their bulk compute through it:

- prf_R cores (crypto/lpn.prf_cores_device_seeds): both AES keys and
  nonces of every core from its raw seed in one pass (kernel D, from the
  midstate of the key pair's derivation prefix), the 127 LPN bits of
  every core from its AES-256-CTR stream in one pass (kernel A), and the
  core from its Toeplitz key and those bits in one pass (kernel E: the
  one-block Toeplitz stream, the hash and the field map), with the LPN
  secret resident on the device;
- σ generation (crypto/matrix.sigma_device): both SHA-256-CTR draw
  streams of every edge and their first-k-unique selection (kernel B),
  and the XOR of the taken H rows plus the noise bits (kernel C), in one
  launch on a card (crypto/sigma_fused.py), with H and its zero row
  resident on the device;
- ct_mul's dense grid (mulgrid.MulGrid) for products too large for the
  host aggregator.

Every call returns device tensors without synchronising; callers read
them when they need the values.  A kernel that fails to build or launch
raises; nothing falls back to the host.

Chunk sizes bound the transient device memory of one pass, nothing else.
At default Params (measured on an H100 with kernel_ab.py and chip_smoke.py)
a PRF pass of 16384 cores holds 0.77 MiB above its inputs, since no
keystream leaves kernels A and E, and a σ pass of 65536 edges 84 MiB: its
64 MiB of rows, 18 MiB of noise positions and a 2 MiB ring of taken
indices, since no draw leaves the fused kernel (B then C hold all 34 MiB
of taken indices: 98 MiB).
"""
from __future__ import annotations

import numpy as np
import torch

from .crypto import lpn, matrix
from .mulgrid import MulGrid
from .types import PubKey, SecKey


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device, a CUDA one with its index.  Raises,
    naming the device, if it is a CUDA device and none is available:
    nothing falls back to the host."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"no CUDA device is available for device={str(device)!r}; "
                               f"pass device='cpu' for the host route")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


class CudaEngine:
    """Device-resident key material for one (pk, sk) on one device."""

    PRF_CHUNK = 16384
    SIGMA_CHUNK = 65536

    def __init__(self, pk: PubKey, sk: SecKey | None = None, device="cuda"):
        device = resolve_device(device)
        self.pk = pk
        self.prm = pk.prm
        self.device = device
        self.H_dev = None if pk.H is None else matrix.hx_tensor(pk.H, device)
        self.sk = self.s32_dev = self.key_msg = None
        if sk is not None:
            self.bind_sk(sk)
        # the dense-grid ct_mul program (it holds no device memory between
        # products); ops/arithmetic._stage_device counts its blocks in stats
        self.mulgrid = MulGrid(self.prm, device)
        # work routed through this engine, for reports; sigma_fused_edges:
        # the σ edges that took the fused launch of kernels B and C;
        # sigma_banked_edges: those whose rows it wrote in bank order
        self.stats = {"prf_cores": 0, "sigma_edges": 0, "sigma_fused_edges": 0,
                      "sigma_banked_edges": 0, "mulgrid_blocks": 0}

    def bind_sk(self, sk: SecKey) -> None:
        """Hold ``sk``'s parts for the device: the LPN secret on the device,
        and the key-derivation message's midstate and tail (lpn.derive_msg
        of prf_k || canon_tag || H_digest), which each launch of kernel D
        carries in its parameters, so PRF keys derive on the device.  An
        engine attached with the public key alone binds the sk that the
        first operation passes; a different sk rebinds."""
        if sk is self.sk:
            return
        self.s32_dev = lpn.s32_tensor(sk, self.device)
        self.key_msg = lpn.derive_msg(self.pk, sk)
        self.sk = sk

    def prf_cores_async_seeds(self, seeds_u64: np.ndarray,
                              dom_hashes: np.ndarray):
        """seeds_u64 [N, 3] uint64 (ztag, nonce_lo, nonce_hi) + dom_hashes
        [N] uint64 -> (limbs [N, 4] int64, rej [N] bool) on the device, in
        passes of at most PRF_CHUNK cores.  Only the raw seeds cross to the
        device; the keys derive there."""
        N = seeds_u64.shape[0]
        self.stats["prf_cores"] += N
        seeds = np.ascontiguousarray(seeds_u64, dtype=np.uint64)
        dh = np.ascontiguousarray(dom_hashes, dtype=np.uint64)
        rs, rejs = [], []
        for off in range(0, N, self.PRF_CHUNK):
            sl = slice(off, off + self.PRF_CHUNK)
            r, rej = lpn.prf_cores_device_seeds(
                self.prm, self.key_msg, lpn.seed_fields(seeds[sl], dh[sl], self.device),
                self.s32_dev)
            rs.append(r)
            rejs.append(rej)
        if not rs:
            return (torch.zeros((0, 4), dtype=torch.int64, device=self.device),
                    torch.zeros(0, dtype=torch.bool, device=self.device))
        if len(rs) == 1:  # one pass: no copy
            return rs[0], rejs[0]
        return torch.cat(rs), torch.cat(rejs)

    def sigma(self, words: np.ndarray):
        """words [E, 7] uint64 σ stream fields -> (σ [E, mw] int32,
        fallback [E] bool) on the device."""
        if self.H_dev is None:
            matrix.check_H(self.prm, self.pk.H)
            self.H_dev = matrix.hx_tensor(self.pk.H, self.device)
        self.stats["sigma_edges"] += words.shape[0]
        if matrix.fused_engages(self.prm, self.H_dev):
            self.stats["sigma_fused_edges"] += words.shape[0]
            self.stats["sigma_banked_edges"] += words.shape[0]
        return matrix.sigma_tensors(self.prm, self.H_dev, words, self.SIGMA_CHUNK)

    def drain(self) -> None:
        """Wait for all work queued on the device; surfaces a kernel fault
        at this point."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def enable_device(pk: PubKey, sk: SecKey | None = None, device="cuda",
                  mesh=None) -> CudaEngine:
    """Attach a CudaEngine to pk; ops route their device programs through
    it.  Raises if ``device`` is a CUDA device and none is available.

    With ``mesh`` (a parallel.mesh.Mesh, on its rank 0 while every other
    rank runs parallel.engine.serve) the engine is a
    parallel.engine.MeshEngine on the mesh's devices instead, and
    ``device`` is not read."""
    if mesh is not None:
        from .parallel.engine import MeshEngine

        eng = MeshEngine(pk, sk, mesh)
    else:
        eng = CudaEngine(pk, sk, device)
    pk._engine = eng
    return eng


def disable_device(pk: PubKey) -> None:
    """Detach pk's engine; a mesh engine also releases its part on every
    rank (parallel.engine.MeshEngine.close)."""
    eng = getattr(pk, "_engine", None)
    if eng is not None:
        del pk._engine
        close = getattr(eng, "close", None)
        if close is not None:
            close()
