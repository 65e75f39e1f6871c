"""Core data types (reference: include/pvac/core/types.hpp).

The ciphertext uses a structure-of-arrays edge table held on the host in
numpy: layer ids, indices, signs and the [E, 4] u32 weight limbs.  σ may
stay on the device as a torch tensor, or as a :class:`LazySigma` view of
one, until something reads its bits; a deep product keeps only the recipe
of its σ (:class:`VirtualSigma`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .core import bits
from .core.random import csprng_u64
from .params import Params


class Dom:
    """Domain-separation strings (types.hpp:14-32)."""

    H_GEN = "pvac.dom.h_gen"
    X_SEED = "pvac.dom.x_seed"
    NOISE = "pvac.dom.noise"
    PRF_LPN = "pvac.dom.prf_lpn"
    TOEP = "pvac.dom.toeplitz"
    ZTAG = "pvac.dom.ztag"
    COMMIT = "pvac.dom.commit"
    PRF_R1 = "pvac.prf.r.1"
    PRF_R2 = "pvac.prf.r.2"
    PRF_R3 = "pvac.prf.r.3"
    PRF_NOISE1 = "pvac.prf.noise.1"
    PRF_NOISE2 = "pvac.prf.noise.2"
    PRF_NOISE3 = "pvac.prf.noise.3"


RRULE_BASE = 0
RRULE_PROD = 1

SGN_P = 0
SGN_M = 1


def sgn_val(ch: int) -> int:
    return 1 if ch == SGN_P else -1


@dataclasses.dataclass
class Nonce128:
    lo: int
    hi: int


def make_nonce128() -> Nonce128:
    return Nonce128(csprng_u64(), csprng_u64())


@dataclasses.dataclass
class RSeed:
    ztag: int
    nonce: Nonce128


@dataclasses.dataclass
class Layer:
    rule: int  # RRULE_BASE / RRULE_PROD
    seed: RSeed
    pa: int = 0
    pb: int = 0


@dataclasses.dataclass
class Ubk:
    perm: np.ndarray  # int32 [m_bits]
    inv: np.ndarray   # int32 [m_bits]


def sigma_to_host(sig) -> np.ndarray:
    """σ rows as a host uint32 array, whatever holds them."""
    if isinstance(sig, torch.Tensor):
        return sig.detach().cpu().contiguous().numpy().view(np.uint32)
    return np.asarray(sig, dtype=np.uint32)


class LazySigma:
    """Device-resident σ view: a (torch base matrix, host row indices) pair.

    Slicing, permutation (shuffle) and same-base concatenation compose on
    the host index array with no device work.  ``np.asarray`` materializes
    by gathering only the referenced rows on the device (``index_select``)
    and copying them to the host in one transfer.  Ops that never read σ
    (decrypt, ct_add) never pay anything.

    ``fixup`` (optional) is a callable ``(out, rows) -> out`` applied at
    materialization: it patches the rare scalar-fallback lanes (bounded
    rejection or overshoot exhaustion in the vectorized draws), so
    producers skip reading the fallback flags at creation time
    (crypto/matrix.py sigma_deferred).

    ``salt`` (optional) is the [base rows] uint64 salt each row of the
    base was generated with, shared by every view of that base, so a row
    can be rebuilt with ``matrix.sigma_from_H`` from its edge's layer
    seed, idx and ch (:attr:`salts` gives the view's own).
    """

    __slots__ = ("base", "rows", "fixup", "salt")

    def __init__(self, base, rows, fixup=None, salt=None):
        self.base = base
        self.rows = np.asarray(rows, dtype=np.int64)
        self.fixup = fixup
        self.salt = salt

    @property
    def salts(self):
        """Each view row's salt, or None where the producer kept none."""
        return None if self.salt is None else self.salt[self.rows]

    @property
    def shape(self):
        return (self.rows.shape[0], self.base.shape[1])

    @property
    def dtype(self):
        return np.uint32

    def __len__(self):
        return int(self.rows.shape[0])

    def __getitem__(self, key):
        if isinstance(key, slice) or (isinstance(key, np.ndarray) and key.dtype != np.bool_):
            return LazySigma(self.base, self.rows[key], self.fixup, self.salt)
        return np.asarray(self)[key]

    def copy(self) -> "LazySigma":
        return LazySigma(self.base, self.rows.copy(), self.fixup, self.salt)

    def __array__(self, dtype=None, copy=None):
        if self.rows.shape[0] == 0:
            out = np.zeros((0, self.base.shape[1]), dtype=np.uint32)
        elif isinstance(self.base, torch.Tensor):
            out = bits.rows_to_np_u32(self.base, self.rows)
        else:
            out = np.asarray(self.base)[self.rows]
        if self.fixup is not None and self.rows.shape[0]:
            out = self.fixup(out, self.rows)
        if dtype is not None:
            out = out.astype(dtype)
        return out


class MixedLazySigma:
    """Device-resident σ over several bases: a LazySigma whose rows come
    from more than one σ pass.  ``srcs`` holds each base's (base, fixup,
    salt), ``part`` [n] the source of each row and ``rows`` [n] its row in
    that base.  A sum of ciphertexts whose σ came from different passes (a
    matvec row's pool ciphertexts, a product's σ beside its squares') stays
    on the device: concatenation (:func:`concat_lazy_sigma`), slicing and
    permutation compose on the host index arrays, and ``np.asarray``
    gathers each base's rows once."""

    __slots__ = ("srcs", "part", "rows")

    def __init__(self, srcs, part, rows):
        self.srcs = srcs
        self.part = np.asarray(part, dtype=np.int32)
        self.rows = np.asarray(rows, dtype=np.int64)

    @property
    def salts(self):
        """Each row's salt, or None where a producer kept none."""
        if any(salt is None for _, _, salt in self.srcs):
            return None
        out = np.empty(len(self), dtype=np.uint64)
        for j, (_, _, salt) in enumerate(self.srcs):
            sel = self.part == j
            out[sel] = salt[self.rows[sel]]
        return out

    @property
    def shape(self):
        return (self.rows.shape[0], self.srcs[0][0].shape[1])

    @property
    def dtype(self):
        return np.uint32

    def __len__(self):
        return int(self.rows.shape[0])

    def __getitem__(self, key):
        if isinstance(key, slice) or (isinstance(key, np.ndarray) and key.dtype != np.bool_):
            return MixedLazySigma(self.srcs, self.part[key], self.rows[key])
        return np.asarray(self)[key]

    def copy(self) -> "MixedLazySigma":
        return MixedLazySigma(self.srcs, self.part.copy(), self.rows.copy())

    def __array__(self, dtype=None, copy=None):
        out = np.empty(self.shape, dtype=np.uint32)
        for j, (base, fixup, salt) in enumerate(self.srcs):
            sel = np.nonzero(self.part == j)[0]
            if sel.size:
                out[sel] = np.asarray(LazySigma(base, self.rows[sel], fixup, salt))
        if dtype is not None:
            out = out.astype(dtype)
        return out


def concat_lazy_sigma(parts) -> "LazySigma | MixedLazySigma":
    """Concatenate LazySigma and MixedLazySigma views of device bases with
    no device work: a LazySigma where every row is of one base (and fixup),
    else a MixedLazySigma over each distinct base once."""
    srcs, where, part, rows = [], {}, [], []
    for p in parts:
        own = ([(p.base, p.fixup, p.salt)] if isinstance(p, LazySigma) else p.srcs)
        remap = []
        for src in own:
            key = (id(src[0]), id(src[1]))
            if key not in where:
                where[key] = len(srcs)
                srcs.append(src)
            remap.append(where[key])
        own_part = (np.zeros(len(p), dtype=np.int32) if isinstance(p, LazySigma)
                    else p.part)
        part.append(np.asarray(remap, dtype=np.int32)[own_part])
        rows.append(p.rows)
    if len(srcs) == 1:
        base, fixup, salt = srcs[0]
        return LazySigma(base, np.concatenate(rows), fixup, salt)
    return MixedLazySigma(srcs, np.concatenate(part), np.concatenate(rows))


class StackedSigma:
    """Zero-copy host σ view: an ordered list of row-block arrays whose
    vertical stack IS the σ matrix.

    ct_add's output σ is exactly [A.sigma; B.sigma] (reference
    arithmetic.hpp:25-26), so add is a pure metadata op; consumers that
    need the bits (serialization) materialize via ``np.asarray``.  Parts
    are treated as immutable."""

    __slots__ = ("parts", "_n")

    def __init__(self, parts):
        self.parts = parts
        self._n = sum(int(p.shape[0]) for p in parts)

    @property
    def shape(self):
        mw = self.parts[0].shape[1] if self.parts else 0
        return (self._n, mw)

    @property
    def dtype(self):
        return np.uint32

    def __len__(self):
        return self._n

    def copy(self):
        return StackedSigma(list(self.parts))

    def __getitem__(self, key):
        return np.asarray(self)[key]

    def __array__(self, dtype=None, copy=None):
        out = (np.concatenate([np.asarray(p) for p in self.parts])
               if self.parts else np.zeros((0, 0), dtype=np.uint32))
        if dtype is not None and out.dtype != dtype:
            out = out.astype(dtype)
        return out


class VirtualSigma:
    """Recipe-backed σ: the per-edge generation inputs instead of the bits.

    Decryption never reads σ and homomorphic ops only emit fresh σ
    (reference ops/arithmetic.hpp:90-101), so a deep product's m_bits per
    edge (1 KB at default Params; 45 GB at the depth sweep's 44 M-edge step
    4, where the reference dies of std::bad_alloc) need not exist until
    something reads them.  σ is a pure function of pk, the layer seed, idx,
    ch and the creation-time salt, so rows materialize bit-identically to
    eager generation, on the attached engine's device.

    Storage: ltab [U, 3] uint64 (per-layer ztag, nonce_lo, nonce_hi),
    packed [E] uint32 = lid << 11 | idx << 1 | ch (lid < 2^21, idx < 2^10),
    salt [E] uint64, and the owning PubKey for H and the engine.
    """

    __slots__ = ("pk", "ltab", "packed", "salt", "_mw")

    def __init__(self, pk, ltab, packed, salt):
        self.pk = pk
        self.ltab = np.asarray(ltab, dtype=np.uint64)
        self.packed = np.asarray(packed, dtype=np.uint32)
        self.salt = np.asarray(salt, dtype=np.uint64)
        self._mw = pk.prm.sigma_words32

    @property
    def shape(self):
        return (self.packed.shape[0], self._mw)

    @property
    def dtype(self):
        return np.uint32

    def __len__(self):
        return int(self.packed.shape[0])

    def __getitem__(self, key):
        if isinstance(key, (slice, np.ndarray)):
            return VirtualSigma(self.pk, self.ltab, self.packed[key],
                                self.salt[key])
        return np.asarray(self)[key]

    def copy(self) -> "VirtualSigma":
        return VirtualSigma(self.pk, self.ltab, self.packed.copy(),
                            self.salt.copy())

    def materialize(self, rows=None) -> np.ndarray:
        """Generate the σ bits of the selected rows (all rows if None)."""
        from .crypto import matrix

        packed = self.packed if rows is None else self.packed[rows]
        salt = self.salt if rows is None else self.salt[rows]
        if packed.shape[0] == 0:
            return np.zeros((0, self._mw), dtype=np.uint32)
        trip = self.ltab[(packed >> np.uint32(11)).astype(np.int64)]
        return matrix.sigma_words(
            self.pk, trip[:, 0], trip[:, 1], trip[:, 2],
            ((packed >> np.uint32(1)) & np.uint32(0x3FF)).astype(np.uint64),
            (packed & np.uint32(1)).astype(np.uint64), salt)

    def popcnt_total(self, chunk: int = 1 << 20) -> int:
        """Total set bits, streamed in chunks of rows (σ-density)."""
        from .core import bitvec as BV

        return sum(int(BV.popcnt(self.materialize(slice(off, off + chunk))).sum())
                   for off in range(0, len(self), chunk))

    def density_sample(self, max_rows: int = 16384) -> float:
        """Mean bit density from a deterministic strided row sample.

        16384 rows x m_bits >= 8.4 M sampled bits put the estimator's
        3-sigma error below 0.0006, an order of magnitude finer than
        recrypt's balance band [0.495, 0.505] (recrypt.hpp:21-24)."""
        from .core import bitvec as BV

        E = len(self)
        if E <= max_rows:
            return self.popcnt_total() / float(max(1, E) * self.pk.prm.m_bits)
        rows = np.arange(0, E, (E + max_rows - 1) // max_rows)
        ones = int(BV.popcnt(self.materialize(rows)).sum())
        return ones / float(len(rows) * self.pk.prm.m_bits)

    def __array__(self, dtype=None, copy=None):
        out = self.materialize()
        if dtype is not None:
            out = out.astype(dtype)
        return out


def concat_virtual_sigma(parts) -> VirtualSigma:
    """Concatenate VirtualSigmas of one PubKey, merging their layer tables."""
    offs = np.cumsum([0] + [p.ltab.shape[0] for p in parts[:-1]])
    packed = np.concatenate([p.packed + np.uint32(int(off) << 11)
                             for p, off in zip(parts, offs)])
    return VirtualSigma(parts[0].pk, np.concatenate([p.ltab for p in parts]),
                        packed, np.concatenate([p.salt for p in parts]))


class Cipher:
    """Layered multigraph ciphertext; edge table as SoA numpy arrays.

    Columns (all length E):
      layer_id int32, idx int32, ch int8, w uint32 [E, 4] (field limbs),
      sigma uint32 [E, m_bits/32] (packed syndrome bits), or a view of
      device rows.
    ``Cipher(sigma_words=W)`` is the empty ciphertext with W σ words.
    """

    __slots__ = ("layers", "layer_id", "idx", "ch", "w", "sigma")

    def __init__(self, layers=None, layer_id=None, idx=None, ch=None, w=None,
                 sigma=None, sigma_words: int = 0):
        self.layers: list[Layer] = layers if layers is not None else []
        if layer_id is None:
            layer_id, idx, ch = (np.zeros(0, dtype=dt) for dt in (np.int32, np.int32, np.int8))
            w = np.zeros((0, 4), dtype=np.uint32)
            sigma = np.zeros((0, sigma_words), dtype=np.uint32)
        self.layer_id = np.asarray(layer_id, dtype=np.int32)
        self.idx = np.asarray(idx, dtype=np.int32)
        self.ch = np.asarray(ch, dtype=np.int8)
        self.w = np.asarray(w, dtype=np.uint32)
        self.sigma = (
            sigma if isinstance(sigma, (torch.Tensor, LazySigma, MixedLazySigma,
                                        StackedSigma, VirtualSigma))
            else np.asarray(sigma, dtype=np.uint32)
        )

    @property
    def n_edges(self) -> int:
        return int(self.layer_id.shape[0])

    @property
    def n_layers(self) -> int:
        return len(self.layers)

    def copy(self) -> "Cipher":
        return Cipher(
            [dataclasses.replace(L, seed=RSeed(L.seed.ztag, Nonce128(L.seed.nonce.lo, L.seed.nonce.hi))) for L in self.layers],
            self.layer_id.copy(), self.idx.copy(), self.ch.copy(),
            self.w.copy(), self.sigma.clone() if isinstance(self.sigma, torch.Tensor)
            else self.sigma.copy(),
        )

    def __repr__(self):
        return f"Cipher(L={self.n_layers}, E={self.n_edges})"


@dataclasses.dataclass
class PubKey:
    prm: Params
    canon_tag: int
    H: Optional[np.ndarray]          # uint32 [n_bits, m_words32] packed columns
    ubk: Optional[Ubk]
    H_digest: bytes                  # 32 bytes
    omega_B: int                     # field element (python int)
    powg_B: list[int]                # B field elements (python ints)

    def powg_limbs(self) -> torch.Tensor:
        """[B, 4] int64 limb table on the host (cached)."""
        cached = getattr(self, "_powg_limbs", None)
        if cached is None:
            from .core import fieldv

            cached = fieldv.from_ints(self.powg_B)
            object.__setattr__(self, "_powg_limbs", cached)
        return cached


@dataclasses.dataclass
class SecKey:
    prf_k: list[int]            # 4 u64
    lpn_s_bits: list[int]       # u64 words, lpn_n bits

    def __deepcopy__(self, memo):
        # the derived _s32 cache must not survive a copy: a copy exists to
        # be mutated, and a stale packed secret would decrypt with the old key
        import copy

        return SecKey(
            prf_k=copy.deepcopy(self.prf_k, memo),
            lpn_s_bits=copy.deepcopy(self.lpn_s_bits, memo),
        )

    def s_words32(self) -> np.ndarray:
        """The LPN secret as little-endian u32 words [2 * s_words64]."""
        cached = getattr(self, "_s32", None)
        if cached is None:
            from .core import bitvec

            cached = bitvec.from_u64_words(
                np.asarray(self.lpn_s_bits, dtype=np.uint64)
            )
            object.__setattr__(self, "_s32", cached)
        return cached


@dataclasses.dataclass
class EvalKey:
    """Recryption key (recrypt.hpp:12-19): encryptions of zero and of one."""

    zero_pool: list[Cipher]
    enc_one: Cipher
