"""Plain reference of the PVAC-HFHE decryption, for judging the port's output.

Written from the scheme's definition (vasihh2009/pvac_hfhe_cppbyv:
include/pvac/crypto/{matrix,lpn,toeplitz}.hpp, ops/decrypt.hpp) with
hashlib for SHA-256 and a byte-oriented AES-256 in plain PyTorch ops, so it
runs on the card or the CPU.  It imports nothing of the program under test
and takes none of its derived state: from a key pair it takes only the raw
random draws (prf_k, the LPN secret, canon_tag, the subgroup generator g)
and works out H's digest again itself.

    R(seed)  = core(seed, R1) * core(seed, R2) * core(seed, R3)   (mod p)
    core     = field(toeplitz(top, y)), y_r = <a_r, s> ^ [x_r % 8 == 0]
    dec(ct)  = sum_e sign_e * w_e * g^idx_e / R(layer_e)           (mod p)

where a_r and x_r are row r's 64 words and noise word of an AES-256-CTR
stream keyed by SHA-256(prf_k || canon_tag || H_digest || seed || dom), and
a PROD layer's R is the product of its parents'.
"""
from __future__ import annotations

import hashlib
import struct

import numpy as np
import torch

P = (1 << 127) - 1
U64 = (1 << 64) - 1

R_DOMS = ("pvac.prf.r.1", "pvac.prf.r.2", "pvac.prf.r.3")
TOEP_DOM = "pvac.dom.toeplitz"
H_DOM = b"pvac.dom.h_gen"
RULE_BASE = 0
SIGN_PLUS = 0
ROWS = 127  # only LPN rows 0..126 reach the 127 Toeplitz output bits


def fnv1a(s: str) -> int:
    h = 0xCBF29CE484222325
    for b in s.encode():
        h = ((h ^ b) * 0x100000001B3) & U64
    return h


# ---------------------------------------------------------------------------
# AES-256 (FIPS-197), byte oriented
# ---------------------------------------------------------------------------

def _xtime(a: int) -> int:
    a <<= 1
    return (a ^ 0x11B) if a & 0x100 else a


def _gmul(a: int, b: int) -> int:
    r = 0
    while b:
        if b & 1:
            r ^= a
        a, b = _xtime(a), b >> 1
    return r


def _sbox() -> list[int]:
    exp, log, x = [0] * 255, [0] * 256, 1
    for i in range(255):  # 3 generates the multiplicative group of GF(2^8)
        exp[i], log[x] = x, i
        x = _gmul(x, 3)
    out = []
    for a in range(256):
        inv = exp[(255 - log[a]) % 255] if a else 0
        s = inv
        for k in range(1, 5):
            s ^= ((inv << k) | (inv >> (8 - k))) & 0xFF
        out.append(s ^ 0x63)
    return out


SBOX = _sbox()
XTIME = [_xtime(a) & 0xFF for a in range(256)]
# state byte i = row i % 4, column i // 4; ShiftRows takes row r left by r
SHIFT_ROWS = [(i + 4 * (i % 4)) % 16 for i in range(16)]


def expand_key(keys: torch.Tensor) -> torch.Tensor:
    """keys [N, 32] uint8 -> round keys [N, 15, 16] uint8."""
    sbox = torch.tensor(SBOX, dtype=torch.uint8, device=keys.device)
    w = list(keys.reshape(-1, 8, 4).unbind(1))
    rcon = 1
    for i in range(8, 60):
        t = w[i - 1]
        if i % 8 == 0:
            t = sbox[t.roll(-1, dims=1).long()].clone()
            t[:, 0] ^= rcon
            rcon = _xtime(rcon) & 0xFF
        elif i % 8 == 4:
            t = sbox[t.long()]
        w.append(w[i - 8] ^ t)
    return torch.stack(w, 1).reshape(-1, 15, 16)


def aes256_encrypt(rk: torch.Tensor, blocks: torch.Tensor) -> torch.Tensor:
    """rk [N, 15, 16], blocks [N, B, 16] uint8 -> ciphertext [N, B, 16]."""
    dev = blocks.device
    sbox = torch.tensor(SBOX, dtype=torch.uint8, device=dev)
    xt = torch.tensor(XTIME, dtype=torch.uint8, device=dev)
    shift = torch.tensor(SHIFT_ROWS, device=dev)
    s = blocks ^ rk[:, None, 0]
    for r in range(1, 15):
        s = sbox[s.long()][..., shift]
        if r < 14:
            c = s.reshape(*s.shape[:-1], 4, 4)  # [..., column, row]
            a0, a1, a2, a3 = c.unbind(-1)
            t = a0 ^ a1 ^ a2 ^ a3
            s = torch.stack([a0 ^ t ^ xt[(a0 ^ a1).long()], a1 ^ t ^ xt[(a1 ^ a2).long()],
                             a2 ^ t ^ xt[(a2 ^ a3).long()], a3 ^ t ^ xt[(a3 ^ a0).long()]],
                            -1).reshape(s.shape)
        s = s ^ rk[:, None, r]
    return s


def ctr_stream(keys: torch.Tensor, nonces: list[int], n_blocks: int) -> torch.Tensor:
    """AES-256-CTR keystream [N, n_blocks * 16] uint8: block k encrypts
    le64(nonce + k) || 0^8."""
    dev = keys.device
    base = torch.tensor([n - (1 << 64) if n >> 63 else n for n in nonces],
                        dtype=torch.int64, device=dev)
    ctr = base[:, None] + torch.arange(n_blocks, device=dev)  # wraps mod 2^64
    shifts = torch.arange(0, 64, 8, device=dev)
    lo = ((ctr[..., None] >> shifts) & 0xFF).to(torch.uint8)
    blocks = torch.cat([lo, torch.zeros_like(lo)], -1)
    return aes256_encrypt(expand_key(keys), blocks).reshape(len(nonces), -1)


# ---------------------------------------------------------------------------
# key material
# ---------------------------------------------------------------------------

def h_digest(canon_tag: int, m: int, n: int, wt: int) -> bytes:
    """SHA-256 over H (matrix.hpp:191-251): column c holds the first wt
    distinct draws x % m, x <= 2^64 - 1 - ((2^64 - 1) % m), of the stream
    SHA-256(H_DOM || le64(m, n, wt, c, canon_tag) || le64(ctr))."""
    refills = (wt + 24 + 3) // 4
    pre = [hashlib.sha256(H_DOM + struct.pack("<5Q", m, n, wt, c, canon_tag & U64))
           for c in range(n)]
    buf = bytearray()
    for h in pre:
        for j in range(refills):
            g = h.copy()
            g.update(struct.pack("<Q", j))
            buf += g.digest()
    x = np.frombuffer(bytes(buf), dtype="<u8").reshape(n, 4 * refills)
    lim = U64 - (U64 % m)
    v = (x % np.uint64(m)).astype(np.int64)
    order = np.argsort(v, axis=1, kind="stable")
    sv = np.take_along_axis(v, order, 1)
    first_sorted = np.ones_like(sv, dtype=bool)
    first_sorted[:, 1:] = sv[:, 1:] != sv[:, :-1]
    first = np.zeros_like(first_sorted)
    np.put_along_axis(first, order, first_sorted, 1)
    taken = first & (np.cumsum(first, axis=1) <= wt)
    short = (taken.sum(1) < wt) | (x > np.uint64(lim)).any(1)
    cols, _ = np.nonzero(taken)
    cols, r = cols[~short[cols]], v[taken][~short[cols]]
    for c in np.nonzero(short)[0]:  # a stream that needs more draws
        cols = np.concatenate([cols, np.full(wt, c)])
        r = np.concatenate([r, _choose_k_slow(pre[c], wt, m)])
    col_bytes = np.zeros((n, m // 8), dtype=np.uint8)  # bit r of a column: byte r // 8, bit r % 8
    np.bitwise_or.at(col_bytes, (cols, r // 8), (1 << (r % 8)).astype(np.uint8))
    hsh = hashlib.sha256(b"H|v2" + struct.pack("<3Q", m, n, wt))
    hsh.update(col_bytes.tobytes())
    return hsh.digest()


def _choose_k_slow(h0, k: int, m: int) -> list[int]:
    lim, out, j = U64 - (U64 % m), [], 0
    while len(out) < k:
        g = h0.copy()
        g.update(struct.pack("<Q", j))
        j += 1
        for (x,) in struct.iter_unpack("<Q", g.digest()):
            if x <= lim and x % m not in out and len(out) < k:
                out.append(x % m)
    return out


class Key:
    """The raw draws of a key pair and what the reference derives from them.

    ``g`` must generate the order-B subgroup; H's digest is recomputed from
    canon_tag."""

    def __init__(self, prf_k, lpn_s_words, canon_tag: int, g: int, params: dict):
        B = params["B"]
        if g in (0, 1) or pow(g, B, P) != 1:
            raise ValueError("g does not generate the order-B subgroup")
        self.powg = [pow(g, i, P) for i in range(B)]
        digest = h_digest(canon_tag, params["m_bits"], params["n_bits"], params["h_col_wt"])
        self.prefix = struct.pack("<5Q", *[k & U64 for k in prf_k], canon_tag & U64) + digest
        s = np.asarray([w & U64 for w in lpn_s_words], dtype=np.uint64)
        self.s_words = s.view(np.int64)

    # -----------------------------------------------------------------------

    def _derive(self, seed, dom_hash: int) -> bytes:
        z, lo, hi = seed
        return hashlib.sha256(self.prefix + struct.pack("<4Q", z, lo, hi, dom_hash)).digest()

    def cores(self, seeds: list, dom: str, device, chunk: int = 256) -> list[int]:
        """core(seed, dom) for each (ztag, nonce_lo, nonce_hi) seed."""
        dh, th = fnv1a(dom), fnv1a(TOEP_DOM)
        sw = self.s_words.shape[0]
        per_row = 8 * (sw + 1)                     # the row's words, then its noise word
        n_blocks = (ROWS * per_row + 15) // 16 + 2  # + slack for a rejected noise draw
        s = torch.from_numpy(self.s_words.copy()).to(device)
        out = []
        for c0 in range(0, len(seeds), chunk):
            part = seeds[c0:c0 + chunk]
            keys = torch.tensor(np.frombuffer(b"".join(self._derive(sd, dh) for sd in part),
                                              dtype=np.uint8).reshape(-1, 32), device=device)
            tkeys = torch.tensor(np.frombuffer(b"".join(self._derive(sd, th) for sd in part),
                                               dtype=np.uint8).reshape(-1, 32), device=device)
            stream = ctr_stream(keys, [dh ^ sd[1] for sd in part], n_blocks)
            top = ctr_stream(tkeys, [th ^ sd[1] ^ dh for sd in part], 1).cpu().numpy()
            words = stream[:, :ROWS * per_row].reshape(len(part), ROWS, sw + 1, 8)
            words = words.contiguous().view(torch.int64)[..., 0]  # [n, rows, sw + 1]
            acc = words[..., :sw] & s
            while acc.shape[-1] > 1:  # xor-fold the row to one word, then to its parity
                h = acc.shape[-1] // 2
                acc = torch.cat([acc[..., :h] ^ acc[..., h:2 * h], acc[..., 2 * h:]], -1)
            par = acc[..., 0]
            for sh in (32, 16, 8, 4, 2, 1):
                par = par ^ (par >> sh)
            noise = words[..., sw]
            y = (par & 1) ^ ((noise & 7) == 0).long()
            rejected = (noise >= -8) & (noise < 0)  # x >= 2^64 - 8: the draw repeats
            y, rejected = y.cpu().numpy(), rejected.any(1).cpu().numpy()
            raw = stream.cpu().numpy() if rejected.any() else None
            for i in range(len(part)):
                bits = (self._walk(raw[i], sw) if rejected[i] else int.from_bytes(
                    np.packbits(y[i].astype(np.uint8), bitorder="little").tobytes(), "little"))
                t = int.from_bytes(top[i].tobytes()[:16], "little") & P
                out.append(_field(_conv127(bits, t)))
        return out

    def _walk(self, stream: np.ndarray, sw: int) -> int:
        """The 127 LPN bits of one core, consuming the stream draw by draw."""
        u = [int(x) for x in stream.view("<u8")]
        s = [int(x) & U64 for x in self.s_words]
        pos, y = 0, 0
        for r in range(ROWS):
            dot = 0
            for k in range(sw):
                dot ^= u[pos + k] & s[k]
            pos += sw
            while u[pos] >= U64 - 7:
                pos += 1
            e = int(u[pos] % 8 == 0)
            pos += 1
            y |= ((bin(dot).count("1") & 1) ^ e) << r
        return y

    def layer_values(self, seeds: list, device) -> list[int]:
        """R(seed) of each BASE layer seed."""
        cs = [self.cores(seeds, d, device) for d in R_DOMS]
        return [a * b % P * c % P for a, b, c in zip(*cs)]

    def decrypt(self, ct: dict, base_R: dict) -> int:
        """One ciphertext: ``layers`` [(rule, (ztag, lo, hi), pa, pb)],
        ``layer_id``, ``idx``, ``ch`` and ``w`` ([E, 4] u32 limbs);
        ``base_R`` maps a BASE seed to its R."""
        layers = ct["layers"]
        R = [None] * len(layers)

        def value(lid):
            if R[lid] is None:
                rule, seed, pa, pb = layers[lid]
                R[lid] = base_R[seed] if rule == RULE_BASE else value(pa) * value(pb) % P
            return R[lid]

        inv = [pow(value(i), P - 2, P) for i in range(len(layers))]
        w = np.asarray(ct["w"], dtype=np.uint64)
        wv = [int(a) | int(b) << 32 | int(c) << 64 | int(d) << 96 for a, b, c, d in w.tolist()]
        acc = 0
        for lid, i, ch, x in zip(ct["layer_id"].tolist(), ct["idx"].tolist(),
                                 ct["ch"].tolist(), wv):
            t = x * self.powg[i] % P * inv[lid]
            acc += t if ch == SIGN_PLUS else -t
        return acc % P


def _conv127(y: int, top: int) -> int:
    acc = 0
    while y:
        low = y & -y
        acc ^= top << (low.bit_length() - 1)
        y ^= low
    return acc & P


def _field(v: int) -> int:
    """127 bits -> a nonzero element of F_p (lpn.hpp:25-37)."""
    v = v % P
    return v if v else 1


def decrypt_all(key: Key, cts: list[dict], device) -> list[int]:
    """Decrypt every ciphertext record, the BASE layers' R in one batch."""
    seeds = sorted({L[1] for ct in cts for L in ct["layers"] if L[0] == RULE_BASE})
    base_R = dict(zip(seeds, key.layer_values(seeds, device)))
    return [key.decrypt(ct, base_R) for ct in cts]
