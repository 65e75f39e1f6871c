"""Key generation (reference: include/pvac/crypto/keygen.hpp:14-137).

Replicates the reference's observable behaviour exactly, including the
126-bit -> 64-bit exponent truncation in the omega_B search
(keygen.hpp:101) — omega_B is dead code in the scheme but serialized into
pk.bin, so the quirk is reproduced (not fixed) for wire compatibility.
"""
from __future__ import annotations

from ..core import field as F
from ..core.random import csprng_u64
from ..params import Params
from ..types import PubKey, SecKey
from . import matrix


def factor_small(n: int) -> list[int]:
    out = []
    x = n
    d = 2
    while d * d <= x:
        if x % d == 0:
            out.append(d)
            while x % d == 0:
                x //= d
        d += 1
    if x > 1:
        out.append(x)
    return out


def _rand_fp_nonzero() -> int:
    while True:
        x = F.fp_from_words(csprng_u64(), csprng_u64() & F.MASK63)
        if x:
            return x


def keygen(prm: Params, device="cuda") -> tuple[PubKey, SecKey]:
    """A fresh key pair.  With a CUDA ``device`` (the default) a
    :class:`CudaEngine` on it is attached to pk, so the operations on these
    keys run there; ``device="cpu"`` attaches none (the host route).
    Raises before any work if no CUDA device is available."""
    from ..engine import enable_device, resolve_device

    device = resolve_device(device)
    pm1 = F.P - 1
    if pm1 % prm.B != 0:
        raise ValueError("[keygen] B|(p-1) fail")

    pk = PubKey(
        prm=prm,
        canon_tag=csprng_u64(),
        H=None,
        ubk=None,
        H_digest=b"\x00" * 32,
        omega_B=0,
        powg_B=[],
    )
    matrix.gen_H(pk)
    pk.ubk = matrix.gen_ubk_public(pk.canon_tag, prm.m_bits)

    sk = SecKey(prf_k=[csprng_u64() for _ in range(4)], lpn_s_bits=[])

    # generator of the order-B subgroup: g = h^((p-1)/B) for random h != 0,
    # first h with g != 1 (keygen.hpp:67-88)
    E = pm1 // prm.B
    while True:
        h = _rand_fp_nonzero()
        acc = pow(h, E, F.P)
        if acc != 1:
            g = acc
            break

    pk.powg_B = [1]
    for _ in range(1, prm.B):
        pk.powg_B.append(F.fp_mul(pk.powg_B[-1], g))

    # omega_B primitive-root search — NOTE the reference truncates the
    # 126-bit exponent (p-1)/B to uint64 (keygen.hpp:101); replicated.
    primes = factor_small(prm.B)
    e_trunc = E & ((1 << 64) - 1)
    while True:
        h = _rand_fp_nonzero()
        w = pow(h, e_trunc, F.P)
        if w == 1:
            continue
        if all(pow(w, prm.B // p, F.P) != 1 for p in primes):
            pk.omega_B = w
            break

    s_words = prm.s_words64
    sk.lpn_s_bits = [csprng_u64() for _ in range(s_words)]
    if prm.lpn_n & 63:
        sk.lpn_s_bits[-1] &= (1 << (prm.lpn_n & 63)) - 1
    if device.type != "cpu":
        enable_device(pk, sk, device)
    return pk, sk
