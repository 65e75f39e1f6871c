"""Native host runtime loader.

Compiles src/pvacnative.cpp with g++ on first use into ``_build/`` beside
this file and exposes ctypes bindings for the host hot paths the port
uses: SHA-256 key derivation, exact SHA-256-CTR index choice (gen_H),
u64-limb reduction, ct_mul's cross-product aggregation and the .ct codec.
Every consumer has a pure-Python path, so a missing toolchain degrades
gracefully: ``lib()`` returns None and callers skip the fast path.
"""
from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess
import tempfile
import threading

import numpy as np

_SRC = pathlib.Path(__file__).parent / "src" / "pvacnative.cpp"
_BUILD = pathlib.Path(__file__).parent / "_build"
_lock = threading.Lock()
_lib = None
_tried = False


def _compile() -> pathlib.Path | None:
    out = _BUILD / "pvacnative.so"
    if out.exists() and out.stat().st_mtime >= _SRC.stat().st_mtime:
        return out
    _BUILD.mkdir(parents=True, exist_ok=True)
    for flags in (["-march=native"], []):
        # build to a private name, then rename: concurrent test workers may
        # compile at the same time
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
        os.close(fd)
        try:
            subprocess.run(
                ["g++", "-std=c++17", "-O2", "-shared", "-fPIC", "-pthread",
                 *flags, "-o", tmp, str(_SRC)],
                check=True, capture_output=True, timeout=300,
            )
            os.replace(tmp, out)
            return out
        except (subprocess.CalledProcessError, FileNotFoundError,
                subprocess.TimeoutExpired):
            os.unlink(tmp)
    return None


def lib():
    """The loaded native library, or None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = _compile()
        if path is None:
            return None
        try:
            L = ctypes.CDLL(str(path))
        except OSError:
            return None
        u8p = ctypes.POINTER(ctypes.c_uint8)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        i64p = ctypes.POINTER(ctypes.c_int64)
        i32p = ctypes.POINTER(ctypes.c_int32)
        i8p = ctypes.POINTER(ctypes.c_int8)
        u64 = ctypes.c_uint64
        L.pvacn_sha256_fields.argtypes = [u8p, u64, u64p, u64, u64, u8p]
        L.pvacn_sha256_fields.restype = None
        L.pvacn_choose_k.argtypes = [u8p, u64, u64p, u64, u64, ctypes.c_uint32,
                                     u64, i32p]
        L.pvacn_choose_k.restype = None
        L.pvacn_reduce_u64_limbs.argtypes = [u64p, u64, u32p]
        L.pvacn_reduce_u64_limbs.restype = None
        L.pvacn_mul_cross_agg.argtypes = [i32p, i32p, i8p, u32p, u64,
                                          i32p, i32p, i8p, u32p, u64,
                                          u64, u64, u64, i64p, u32p]
        L.pvacn_mul_cross_agg.restype = ctypes.c_int64
        L.pvacn_ct_scan.argtypes = [u8p, u64, u64, u64p, u64p, u64p, u64p]
        L.pvacn_ct_scan.restype = ctypes.c_int
        L.pvacn_ct_decode.argtypes = [u8p, u64, u64, u64p, i32p, i32p, i8p,
                                      u64p, u64p]
        L.pvacn_ct_decode.restype = ctypes.c_int
        L.pvacn_ct_encoded_size.argtypes = [u64, u64p, u64, u64]
        L.pvacn_ct_encoded_size.restype = u64
        L.pvacn_ct_encode.argtypes = [u64, u64p, u64, u64, i32p, i32p, i8p,
                                      u64p, u64p, u8p]
        L.pvacn_ct_encode.restype = None
        _lib = L
        return _lib


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def sha256_fields(prefix: bytes, fields: np.ndarray) -> np.ndarray | None:
    """Batched SHA-256(prefix || le64-fields) digests: fields [N, F]
    uint64 -> [N, 32] uint8 digest bytes (threaded SHA-NI when present)."""
    L = lib()
    if L is None:
        return None
    fields = np.ascontiguousarray(fields, dtype=np.uint64)
    N, F = fields.shape
    pre = np.frombuffer(prefix, dtype=np.uint8).copy()
    out = np.empty((N, 32), dtype=np.uint8)
    L.pvacn_sha256_fields(
        _ptr(pre, ctypes.c_uint8), len(prefix),
        _ptr(fields, ctypes.c_uint64), F, N, _ptr(out, ctypes.c_uint8),
    )
    return out


def choose_k(label: bytes, words: np.ndarray, k: int, N: int) -> np.ndarray | None:
    """[L, n_words] u64 stream words -> [L, k] int32 unique indices, in
    stream order (exact prg_choose_k, rejections included)."""
    L_ = lib()
    if L_ is None or N > 65536:
        return None
    words = np.ascontiguousarray(words, dtype=np.uint64)
    lanes = words.shape[0]
    out = np.empty((lanes, k), dtype=np.int32)
    lb = np.frombuffer(label, dtype=np.uint8)
    L_.pvacn_choose_k(
        _ptr(lb, ctypes.c_uint8), len(label),
        _ptr(words, ctypes.c_uint64), words.shape[1],
        lanes, k, N, _ptr(out, ctypes.c_int32),
    )
    return out


def reduce_u64_limbs(acc: np.ndarray) -> np.ndarray | None:
    """[n, 4] uint64 limb accumulators (weight 2^32k) -> canonical
    [n, 4] uint32 field limbs."""
    L = lib()
    if L is None:
        return None
    acc = np.ascontiguousarray(acc, dtype=np.uint64)
    out = np.empty((acc.shape[0], 4), dtype=np.uint32)
    L.pvacn_reduce_u64_limbs(
        _ptr(acc, ctypes.c_uint64), acc.shape[0], _ptr(out, ctypes.c_uint32)
    )
    return out


# Dense-accumulator cap for mul_cross_agg: 2^24 keys x 16 B = 256 MB peak.
CROSS_AGG_KEYSPACE_MAX = 1 << 24


def mul_cross_agg(lidA, idxA, chA, wA, lidB, idxB, chB, wB,
                  LA: int, LB: int, Bmod: int):
    """ct_mul edge cross product, aggregated per (layer-pair, idx, sign)
    bucket in F_p.  Returns (keys [n] int64 ascending, w [n, 4] uint32) of
    the nonzero buckets, or None when native is unavailable or the dense
    keyspace LA*LB*B*2 exceeds the cap (caller falls back to numpy)."""
    L = lib()
    if L is None:
        return None
    keyspace = LA * LB * Bmod * 2
    if keyspace == 0 or keyspace > CROSS_AGG_KEYSPACE_MAX:
        return None
    nA, nB = len(lidA), len(lidB)
    cap = int(min(nA * nB, keyspace))
    if cap == 0:
        return (np.zeros(0, dtype=np.int64), np.zeros((0, 4), dtype=np.uint32))
    lidA = np.ascontiguousarray(lidA, dtype=np.int32)
    idxA = np.ascontiguousarray(idxA, dtype=np.int32)
    chA = np.ascontiguousarray(chA, dtype=np.int8)
    wA = np.ascontiguousarray(wA, dtype=np.uint32)
    lidB = np.ascontiguousarray(lidB, dtype=np.int32)
    idxB = np.ascontiguousarray(idxB, dtype=np.int32)
    chB = np.ascontiguousarray(chB, dtype=np.int8)
    wB = np.ascontiguousarray(wB, dtype=np.uint32)
    keys = np.empty(cap, dtype=np.int64)
    w = np.empty((cap, 4), dtype=np.uint32)
    cnt = L.pvacn_mul_cross_agg(
        _ptr(lidA, ctypes.c_int32), _ptr(idxA, ctypes.c_int32),
        _ptr(chA, ctypes.c_int8), _ptr(wA, ctypes.c_uint32), nA,
        _ptr(lidB, ctypes.c_int32), _ptr(idxB, ctypes.c_int32),
        _ptr(chB, ctypes.c_int8), _ptr(wB, ctypes.c_uint32), nB,
        LA, LB, Bmod,
        _ptr(keys, ctypes.c_int64), _ptr(w, ctypes.c_uint32),
    )
    if cnt < 0:
        return None
    return keys[:cnt], w[:cnt]


def ct_decode_all(data: bytes, count: int):
    """Decode ``count`` serialized Ciphers from data (starting after the
    file header).  Returns a list of dicts, or None."""
    L = lib()
    if L is None:
        return None
    buf = np.frombuffer(data, dtype=np.uint8)
    out = []
    off = 16  # magic + ver + count
    for _ in range(count):
        nL = ctypes.c_uint64()
        nE = ctypes.c_uint64()
        nb = ctypes.c_uint64()
        end = ctypes.c_uint64()
        rc = L.pvacn_ct_scan(
            _ptr(buf, ctypes.c_uint8), len(data), off,
            ctypes.byref(nL), ctypes.byref(nE), ctypes.byref(nb),
            ctypes.byref(end),
        )
        if rc:
            return None
        layers = np.zeros((nL.value, 5), dtype=np.uint64)
        lid = np.zeros(nE.value, dtype=np.int32)
        idx = np.zeros(nE.value, dtype=np.int32)
        ch = np.zeros(nE.value, dtype=np.int8)
        w = np.zeros((nE.value, 2), dtype=np.uint64)
        nw = (nb.value + 63) // 64
        sigma = np.zeros((nE.value, nw), dtype=np.uint64)
        rc = L.pvacn_ct_decode(
            _ptr(buf, ctypes.c_uint8), len(data), off,
            _ptr(layers, ctypes.c_uint64), _ptr(lid, ctypes.c_int32),
            _ptr(idx, ctypes.c_int32), _ptr(ch, ctypes.c_int8),
            _ptr(w, ctypes.c_uint64), _ptr(sigma, ctypes.c_uint64),
        )
        if rc:
            return None
        out.append(dict(layers=layers, lid=lid, idx=idx, ch=ch, w=w,
                        sigma=sigma, nbits=nb.value))
        off = end.value
    return out


def ct_encode_one(layers: np.ndarray, lid, idx, ch, w, sigma,
                  nbits: int) -> bytes | None:
    L = lib()
    if L is None:
        return None
    layers = np.ascontiguousarray(layers, dtype=np.uint64)
    lid = np.ascontiguousarray(lid, dtype=np.int32)
    idx = np.ascontiguousarray(idx, dtype=np.int32)
    ch = np.ascontiguousarray(ch, dtype=np.int8)
    w = np.ascontiguousarray(w, dtype=np.uint64)
    sigma = np.ascontiguousarray(sigma, dtype=np.uint64)
    nE = lid.shape[0]
    sz = L.pvacn_ct_encoded_size(layers.shape[0], _ptr(layers, ctypes.c_uint64),
                                 nE, nbits)
    out = np.empty(sz, dtype=np.uint8)
    L.pvacn_ct_encode(
        layers.shape[0], _ptr(layers, ctypes.c_uint64), nE, nbits,
        _ptr(lid, ctypes.c_int32), _ptr(idx, ctypes.c_int32),
        _ptr(ch, ctypes.c_int8), _ptr(w, ctypes.c_uint64),
        _ptr(sigma, ctypes.c_uint64), _ptr(out, ctypes.c_uint8),
    )
    return out.tobytes()
