"""Client / evaluator role separation.

The reference's deployment story (README example) is: the *client* holds sk
and encrypts/decrypts; the *server* (evaluator) holds only pk (+ optional
EvalKey) and computes on ciphertexts.  These thin wrappers make the split
explicit.  Each role computes on the engine attached to the public key it
holds: a client made by :meth:`Client.generate` holds one on the card that
binds its sk; an evaluator given a key from ``load_pk(path)`` holds its own
engine on the card with H and no secret key.
"""
from __future__ import annotations

from .crypto.keygen import keygen
from .models import circuits
from .ops.arithmetic import (
    ct_add, ct_div_const, ct_mul, ct_mul_batch, ct_neg, ct_scale, ct_sub,
)
from .ops.decrypt import dec_value_batch
from .ops.encrypt import enc_value_batch
from .ops.recrypt import ct_recrypt, make_evalkey
from .params import Params
from .types import Cipher, EvalKey, PubKey, SecKey
from .utils.text import dec_text, enc_text


class Client:
    """Holds the secret key; encrypts and decrypts."""

    def __init__(self, pk: PubKey, sk: SecKey):
        self.pk = pk
        self.sk = sk

    @classmethod
    def generate(cls, prm: Params | None = None, device="cuda") -> "Client":
        """A fresh key pair on ``device`` (keygen's rule: the card unless
        ``device="cpu"``; raises where there is no card)."""
        return cls(*keygen(prm or Params(), device=device))

    def encrypt(self, values) -> list[Cipher]:
        if isinstance(values, int):
            return enc_value_batch(self.pk, self.sk, [values])
        return enc_value_batch(self.pk, self.sk, list(values))

    def decrypt(self, cts) -> list[int]:
        if isinstance(cts, Cipher):
            cts = [cts]
        return dec_value_batch(self.pk, self.sk, cts)

    def encrypt_text(self, msg: str) -> list[Cipher]:
        return enc_text(self.pk, self.sk, msg)

    def decrypt_text(self, cts) -> str:
        return dec_text(self.pk, self.sk, cts)

    def evaluation_key(self, pool_size: int = 8, depth_hint: int = 0) -> EvalKey:
        return make_evalkey(self.pk, self.sk, pool_size, depth_hint)

    def evaluator(self, ek: EvalKey | None = None) -> "Evaluator":
        return Evaluator(self.pk, ek)


class Evaluator:
    """Holds only public material; computes on ciphertexts."""

    def __init__(self, pk: PubKey, ek: EvalKey | None = None):
        self.pk = pk
        self.ek = ek

    def add(self, a: Cipher, b: Cipher) -> Cipher:
        return ct_add(self.pk, a, b)

    def sub(self, a: Cipher, b: Cipher) -> Cipher:
        return ct_sub(self.pk, a, b)

    def neg(self, a: Cipher) -> Cipher:
        return ct_neg(self.pk, a)

    def mul(self, a: Cipher, b: Cipher) -> Cipher:
        return ct_mul(self.pk, a, b)

    def mul_batch(self, pairs) -> list[Cipher]:
        return ct_mul_batch(self.pk, list(pairs))

    def scale(self, a: Cipher, k: int) -> Cipher:
        return ct_scale(self.pk, a, k)

    def div_const(self, a: Cipher, k: int) -> Cipher:
        return ct_div_const(self.pk, a, k)

    def recrypt(self, a: Cipher) -> Cipher:
        if self.ek is None:
            raise ValueError("evaluator has no EvalKey")
        return ct_recrypt(self.pk, self.ek, a)

    # The circuits of models/circuits.py on this evaluator's key; every
    # product goes through self.mul_batch, read at call time.

    def dot_product(self, xs, ys) -> Cipher:
        """sum_i xs[i] * ys[i]: the products as one batch, a tree sum."""
        return circuits.dot_product(self.pk, list(xs), list(ys), mul_batch=self.mul_batch)

    def matvec(self, xs, rows) -> list[Cipher]:
        """Each public row of u64 weights dotted with the encrypted vector:
        one batched scale and one tree sum a row."""
        return circuits.matvec(self.pk, list(xs), [list(r) for r in rows])

    def mean_and_scaled_variance(self, xs) -> tuple[Cipher, Cipher]:
        """(S, V): S = sum x_i and V = n sum x_i^2 - S^2 over the n samples."""
        return circuits.mean_and_scaled_variance(self.pk, list(xs), mul_batch=self.mul_batch)
