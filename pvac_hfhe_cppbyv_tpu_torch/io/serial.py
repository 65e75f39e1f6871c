"""Bit-exact binary serialization of ciphertexts and keys.

Formats (all little-endian; the reference keeps them in
tests/bounty2_test.cpp:17-252 and tools/refharness/hser.hpp):
- .ct  : magic 0x66699666, ver 1, u64 count, then per Cipher:
         u32 nL, u32 nE; layers (u8 rule; BASE: ztag,nonce.lo,nonce.hi u64;
         PROD: pa,pb u32); edges (u32 layer, u16 idx, u8 ch, u8 pad,
         Fp = 2*u64, BitVec = u32 nbits + u64 words)
- sk   : magic 0x66666999, ver 1, prf_k 4*u64, u64 nwords, lpn_s words
- pk   : magic 0x06660666, ver 1 — the full reference pk.bin layout
         (tests/bounty2_test.cpp:165-236), including its quirks: m_bits but
         NOT n_bits/h_col_wt/x_col_wt/err_wt; noise/depth as u32 casts;
         tuple2_fraction as raw double bits; H as n_bits records of
         (u32 nbits, u64 words)
- pklite: harness container with ALL params + canon_tag + H_digest +
         omega + powg table — H and ubk regenerate from canon_tag
- params.json: the 10-field bounty layout (params.py)
"""
from __future__ import annotations

import struct

import numpy as np

from .. import native
from ..core import bitvec as BV
from ..core import fieldv as FV
from ..params import Params, params_from_json, params_to_json
from ..types import (
    Cipher, Layer, Nonce128, PubKey, RSeed, SecKey, Ubk,
    RRULE_BASE, RRULE_PROD, sigma_to_host,
)

MAGIC_CT = 0x66699666
MAGIC_SK = 0x66666999
MAGIC_PK = 0x06660666
MAGIC_PKLITE = 0x504B4C54
VER = 1

U64MAX = (1 << 64) - 1


class _W:
    def __init__(self):
        self.parts = []

    def u8(self, x): self.parts.append(struct.pack("<B", x & 0xFF))
    def u16(self, x): self.parts.append(struct.pack("<H", x & 0xFFFF))
    def u32(self, x): self.parts.append(struct.pack("<I", x & 0xFFFFFFFF))
    def u64(self, x): self.parts.append(struct.pack("<Q", x & U64MAX))
    def f64raw(self, d): self.parts.append(struct.pack("<d", d))
    def raw(self, b): self.parts.append(bytes(b))

    def bytes(self) -> bytes:
        return b"".join(self.parts)


class _R:
    def __init__(self, data: bytes):
        self.d = data
        self.o = 0

    def u8(self): x = self.d[self.o]; self.o += 1; return x
    def u16(self): x = struct.unpack_from("<H", self.d, self.o)[0]; self.o += 2; return x
    def u32(self): x = struct.unpack_from("<I", self.d, self.o)[0]; self.o += 4; return x
    def u64(self): x = struct.unpack_from("<Q", self.d, self.o)[0]; self.o += 8; return x
    def f64raw(self): x = struct.unpack_from("<d", self.d, self.o)[0]; self.o += 8; return x
    def raw(self, n): x = self.d[self.o : self.o + n]; self.o += n; return x


def _put_layer(w: _W, L: Layer) -> None:
    w.u8(L.rule)
    if L.rule == RRULE_BASE:
        w.u64(L.seed.ztag)
        w.u64(L.seed.nonce.lo)
        w.u64(L.seed.nonce.hi)
    elif L.rule == RRULE_PROD:
        w.u32(L.pa)
        w.u32(L.pb)
    else:
        w.u64(0); w.u64(0); w.u64(0)


def _get_layer(r: _R) -> Layer:
    rule = r.u8()
    if rule == RRULE_BASE:
        return Layer(rule, RSeed(r.u64(), Nonce128(r.u64(), r.u64())))
    if rule == RRULE_PROD:
        return Layer(rule, RSeed(0, Nonce128(0, 0)), r.u32(), r.u32())
    r.u64(); r.u64(); r.u64()
    return Layer(rule, RSeed(0, Nonce128(0, 0)))


def _put_cipher(w: _W, C: Cipher, sig: np.ndarray) -> None:
    w.u32(C.n_layers)
    w.u32(C.n_edges)
    for L in C.layers:
        _put_layer(w, L)
    wlo, whi = FV.to_u64_pairs(C.w)
    sig64 = (BV.to_u64_words(sig) if sig.shape[1]
             else np.zeros((C.n_edges, 0), dtype=np.uint64))
    nbits = sig.shape[1] * 32
    for e in range(C.n_edges):
        w.u32(int(C.layer_id[e]))
        w.u16(int(C.idx[e]))
        w.u8(int(C.ch[e]))
        w.u8(0)
        w.u64(int(wlo[e]))
        w.u64(int(whi[e]))
        w.u32(nbits)
        w.raw(sig64[e].astype("<u8").tobytes())


def _get_cipher(r: _R) -> Cipher:
    nL = r.u32()
    nE = r.u32()
    layers = [_get_layer(r) for _ in range(nL)]
    lid = np.zeros(nE, dtype=np.int32)
    idx = np.zeros(nE, dtype=np.int32)
    ch = np.zeros(nE, dtype=np.int8)
    wlo = np.zeros(nE, dtype=np.uint64)
    whi = np.zeros(nE, dtype=np.uint64)
    sig = None
    for e in range(nE):
        lid[e] = r.u32()
        idx[e] = r.u16()
        ch[e] = r.u8()
        r.u8()
        wlo[e] = r.u64()
        whi[e] = r.u64()
        nbits = r.u32()
        nw = (nbits + 63) // 64
        words = np.frombuffer(r.raw(8 * nw), dtype="<u8")
        if sig is None:
            sig = np.zeros((nE, 2 * nw), dtype=np.uint32)
        sig[e] = BV.from_u64_words(words)
    if sig is None:
        sig = np.zeros((nE, 0), dtype=np.uint32)
    return Cipher(layers, lid, idx, ch, FV.from_u64_pairs(wlo, whi), sig)


def save_cts(cts: list[Cipher], path: str) -> None:
    parts = [struct.pack("<IIQ", MAGIC_CT, VER, len(cts))]
    use_native = native.lib() is not None
    for c in cts:
        sig = sigma_to_host(c.sigma)
        enc = None
        if use_native:
            layers = np.zeros((c.n_layers, 5), dtype=np.uint64)
            for i, L in enumerate(c.layers):
                layers[i, 0] = L.rule
                if L.rule == RRULE_BASE:
                    layers[i, 1] = L.seed.ztag
                    layers[i, 2] = L.seed.nonce.lo
                    layers[i, 3] = L.seed.nonce.hi
                else:
                    layers[i, 4] = (L.pa << 32) | L.pb
            wlo, whi = FV.to_u64_pairs(c.w)
            enc = native.ct_encode_one(
                layers, c.layer_id, c.idx, c.ch, np.stack([wlo, whi], axis=-1),
                BV.to_u64_words(sig), sig.shape[1] * 32,
            )
        if enc is None:
            w = _W()
            _put_cipher(w, c, sig)
            enc = w.bytes()
        parts.append(enc)
    with open(path, "wb") as f:
        f.write(b"".join(parts))


def load_cts(path: str) -> list[Cipher]:
    with open(path, "rb") as f:
        data = f.read()
    r = _R(data)
    if r.u32() != MAGIC_CT or r.u32() != VER:
        raise ValueError(f"bad CT: {path}")
    count = r.u64()
    decoded = native.ct_decode_all(data, count)
    if decoded is None:
        return [_get_cipher(r) for _ in range(count)]
    out = []
    for d in decoded:
        layers = []
        for row in d["layers"]:
            rule = int(row[0])
            if rule == RRULE_PROD:
                layers.append(Layer(rule, RSeed(0, Nonce128(0, 0)),
                                    int(row[4] >> 32), int(row[4] & 0xFFFFFFFF)))
            else:
                layers.append(Layer(rule, RSeed(int(row[1]),
                                                Nonce128(int(row[2]), int(row[3])))))
        out.append(Cipher(
            layers, d["lid"], d["idx"], d["ch"],
            FV.from_u64_pairs(d["w"][:, 0], d["w"][:, 1]),
            BV.from_u64_words(d["sigma"]) if d["sigma"].shape[1] else
            np.zeros((d["lid"].shape[0], 0), dtype=np.uint32),
        ))
    return out


def save_sk(sk: SecKey, path: str) -> None:
    w = _W()
    w.u32(MAGIC_SK)
    w.u32(VER)
    for k in sk.prf_k:
        w.u64(k)
    w.u64(len(sk.lpn_s_bits))
    for x in sk.lpn_s_bits:
        w.u64(x)
    with open(path, "wb") as f:
        f.write(w.bytes())


def load_sk(path: str) -> SecKey:
    with open(path, "rb") as f:
        r = _R(f.read())
    if r.u32() != MAGIC_SK or r.u32() != VER:
        raise ValueError(f"bad SK: {path}")
    prf_k = [r.u64() for _ in range(4)]
    n = r.u64()
    return SecKey(prf_k=prf_k, lpn_s_bits=[r.u64() for _ in range(n)])


def _h_record(nw64: int) -> np.dtype:
    """One H column of pk.bin: u32 nbits, then nw64 u64 words (packed)."""
    return np.dtype([("nbits", "<u4"), ("words", "<u8", (nw64,))])


def save_pk(pk: PubKey, path: str) -> None:
    """Full reference pk.bin layout (tests/bounty2_test.cpp:165-191).
    Needs the host H and ubk: a key loaded from pklite must be loaded
    with ``with_H=True``."""
    if pk.H is None or pk.ubk is None:
        raise ValueError("save_pk needs the public key's host H and ubk: "
                         "load it with with_H=True")
    w = _W()
    w.u32(MAGIC_PK)
    w.u32(VER)
    p = pk.prm
    w.u32(p.m_bits)
    w.u32(p.B)
    w.u32(p.lpn_t)
    w.u32(p.lpn_n)
    w.u32(p.lpn_tau_num)
    w.u32(p.lpn_tau_den)
    w.u32(int(p.noise_entropy_bits))
    w.u32(int(p.depth_slope_bits))
    w.f64raw(p.tuple2_fraction)
    w.u32(p.edge_budget)
    w.u64(pk.canon_tag)
    w.raw(pk.H_digest)
    w.u64(pk.H.shape[0])
    nw64 = (p.m_bits + 63) // 64
    rec = np.zeros(pk.H.shape[0], dtype=_h_record(nw64))
    rec["nbits"] = p.m_bits
    rec["words"] = BV.to_u64_words(pk.H)[:, :nw64]
    w.raw(rec.tobytes())
    w.u64(len(pk.ubk.perm))
    w.raw(np.asarray(pk.ubk.perm, dtype="<i4").tobytes())
    w.u64(len(pk.ubk.inv))
    w.raw(np.asarray(pk.ubk.inv, dtype="<i4").tobytes())
    w.u64(pk.omega_B & U64MAX)
    w.u64(pk.omega_B >> 64)
    w.u64(len(pk.powg_B))
    for g in pk.powg_B:
        w.u64(g & U64MAX)
        w.u64(g >> 64)
    with open(path, "wb") as f:
        f.write(w.bytes())


def load_pk(path: str, device="cuda") -> PubKey:
    """Read the reference pk.bin layout.  Fields absent from the format
    (n_bits, h_col_wt, x_col_wt, err_wt, recrypt band) keep their Params
    defaults, as the reference loader does (tests/bounty2_test.cpp:193-236),
    so a pk.bin of other n_bits loads with the default n_bits beside an H
    of its own size.  The H records are read in one pass; every one must
    have the same nbits.  With a CUDA ``device`` (the default) a
    :class:`CudaEngine` on it is attached, holding H and no secret key;
    ``device="cpu"`` attaches none.  Raises if no CUDA device is
    available."""
    from ..engine import enable_device, resolve_device

    device = resolve_device(device)
    with open(path, "rb") as f:
        data = f.read()
    r = _R(data)
    if r.u32() != MAGIC_PK or r.u32() != VER:
        raise ValueError(f"bad PK: {path}")
    p = Params()
    p.m_bits = r.u32()
    p.B = r.u32()
    p.lpn_t = r.u32()
    p.lpn_n = r.u32()
    p.lpn_tau_num = r.u32()
    p.lpn_tau_den = r.u32()
    p.noise_entropy_bits = float(r.u32())
    p.depth_slope_bits = float(r.u32())
    p.tuple2_fraction = r.f64raw()
    p.edge_budget = r.u32()
    canon = r.u64()
    digest = bytes(r.raw(32))
    nH = r.u64()
    H = None
    if nH:
        nbits = struct.unpack_from("<I", data, r.o)[0]
        rec_t = _h_record((nbits + 63) // 64)
        rec = np.frombuffer(data, dtype=rec_t, count=nH, offset=r.o)
        if (rec["nbits"] != nbits).any():
            raise ValueError(f"bad PK: H columns of unequal nbits: {path}")
        r.o += nH * rec_t.itemsize
        H = BV.from_u64_words(rec["words"])
    perm = np.frombuffer(r.raw(4 * r.u64()), dtype="<i4").astype(np.int32)
    inv = np.frombuffer(r.raw(4 * r.u64()), dtype="<i4").astype(np.int32)
    omega = r.u64() | (r.u64() << 64)
    powg = [r.u64() | (r.u64() << 64) for _ in range(r.u64())]
    pk = PubKey(prm=p, canon_tag=canon, H=H, ubk=Ubk(perm, inv), H_digest=digest,
                omega_B=omega, powg_B=powg)
    if device.type != "cpu":
        enable_device(pk, None, device)
    return pk


def save_pklite(pk: PubKey, path: str) -> None:
    """Harness pk-lite container (tools/refharness/hser.hpp)."""
    w = _W()
    w.u32(MAGIC_PKLITE)
    w.u32(VER)
    p = pk.prm
    w.u32(p.B); w.u32(p.m_bits); w.u32(p.n_bits)
    w.u32(p.h_col_wt); w.u32(p.x_col_wt); w.u32(p.err_wt)
    w.f64raw(p.noise_entropy_bits)
    w.f64raw(p.tuple2_fraction)
    w.f64raw(p.depth_slope_bits)
    w.u64(p.edge_budget)
    w.u32(p.lpn_n); w.u32(p.lpn_t)
    w.u32(p.lpn_tau_num); w.u32(p.lpn_tau_den)
    w.f64raw(p.recrypt_lo); w.f64raw(p.recrypt_hi)
    w.u32(p.recrypt_rounds)
    w.u64(pk.canon_tag)
    w.raw(pk.H_digest)
    w.u64(pk.omega_B & U64MAX); w.u64(pk.omega_B >> 64)
    w.u64(len(pk.powg_B))
    for g in pk.powg_B:
        w.u64(g & U64MAX); w.u64(g >> 64)
    with open(path, "wb") as f:
        f.write(w.bytes())


def load_pklite(path: str, with_H: bool = False, device="cuda") -> PubKey:
    """Load pk-lite; optionally regenerate H/ubk from canon_tag and check
    the regenerated H against the stored digest (decrypt does not need H,
    encrypt does).  With a CUDA ``device`` (the default) a
    :class:`CudaEngine` on it is attached, holding no secret key: the
    first operation binds the sk it is given.  ``device="cpu"`` attaches
    none.  Raises if no CUDA device is available."""
    from ..engine import enable_device, resolve_device

    device = resolve_device(device)
    with open(path, "rb") as f:
        r = _R(f.read())
    if r.u32() != MAGIC_PKLITE or r.u32() != VER:
        raise ValueError(f"bad pklite: {path}")
    p = Params()
    p.B = r.u32(); p.m_bits = r.u32(); p.n_bits = r.u32()
    p.h_col_wt = r.u32(); p.x_col_wt = r.u32(); p.err_wt = r.u32()
    p.noise_entropy_bits = r.f64raw()
    p.tuple2_fraction = r.f64raw()
    p.depth_slope_bits = r.f64raw()
    p.edge_budget = r.u64()
    p.lpn_n = r.u32(); p.lpn_t = r.u32()
    p.lpn_tau_num = r.u32(); p.lpn_tau_den = r.u32()
    p.recrypt_lo = r.f64raw(); p.recrypt_hi = r.f64raw()
    p.recrypt_rounds = r.u32()
    canon = r.u64()
    digest = bytes(r.raw(32))
    omega = r.u64() | (r.u64() << 64)
    powg = []
    for _ in range(r.u64()):
        powg.append(r.u64() | (r.u64() << 64))
    pk = PubKey(prm=p, canon_tag=canon, H=None, ubk=None, H_digest=digest,
                omega_B=omega, powg_B=powg)
    if with_H:
        from ..crypto import matrix

        matrix.gen_H(pk)
        if pk.H_digest != digest:
            raise ValueError("regenerated H digest mismatch")
        pk.ubk = matrix.gen_ubk_public(canon, p.m_bits)
    if device.type != "cpu":
        enable_device(pk, None, device)
    return pk


def save_params(p: Params, path: str) -> None:
    with open(path, "w") as f:
        f.write(params_to_json(p))


def load_params(path: str) -> Params:
    with open(path) as f:
        return params_from_json(f.read())
