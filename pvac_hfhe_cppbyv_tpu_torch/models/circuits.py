"""Encrypted-computation recipes (application layer).

Mirrors the homomorphic demo circuits of examples/basic_usage.cpp (25
sections: polynomials, linear combos, fib/factorial chains, powers with
growth control) as reusable helpers over the batched ops, which run their
device programs on the engine attached to ``pk``.
"""
from __future__ import annotations

from ..ops.arithmetic import ct_add, ct_mul, ct_scale
from ..ops.encrypt import enc_value
from ..ops.recrypt import ct_recrypt
from ..types import Cipher, EvalKey, PubKey, SecKey


def eval_polynomial(pk: PubKey, coeffs: list[int], x: Cipher,
                    enc_const) -> Cipher:
    """Evaluate sum_i coeffs[i] * x^i homomorphically (Horner).

    ``enc_const(v)`` must return a fresh encryption of v (e.g.
    ``lambda v: enc_value(pk, sk, v)`` client-side, or evalkey-scaled
    enc_one server-side).
    """
    acc = enc_const(coeffs[-1])
    for c in reversed(coeffs[:-1]):
        acc = ct_mul(pk, acc, x)
        if c:
            acc = ct_add(pk, acc, enc_const(c))
    return acc


def linear_combination(pk: PubKey, cts: list[Cipher], ks: list[int]) -> Cipher:
    """sum_i ks[i] * cts[i] (scalar weights)."""
    assert cts and len(cts) == len(ks)
    acc = ct_scale(pk, cts[0], ks[0])
    for c, k in zip(cts[1:], ks[1:]):
        acc = ct_add(pk, acc, ct_scale(pk, c, k))
    return acc


def fibonacci_chain(pk: PubKey, sk: SecKey, n: int) -> Cipher:
    """Encrypted F(n) by additive chaining (basic_usage fib section)."""
    a = enc_value(pk, sk, 0)
    b = enc_value(pk, sk, 1)
    for _ in range(n):
        a, b = b, ct_add(pk, a, b)
    return a


def factorial_chain(pk: PubKey, sk: SecKey, n: int) -> Cipher:
    """Encrypted n! by scalar-multiplying an encrypted 1."""
    acc = enc_value(pk, sk, 1)
    for k in range(2, n + 1):
        acc = ct_scale(pk, acc, k)
    return acc


def power_chain(pk: PubKey, x: Cipher, e: int,
                ek: EvalKey | None = None) -> Cipher:
    """x^e by square-and-multiply over ct_mul, with optional recrypt-based
    growth control after each squaring."""
    assert e >= 1
    bits = bin(e)[3:]  # after the leading 1
    acc = x
    for b in bits:
        acc = ct_mul(pk, acc, acc)
        if ek is not None:
            acc = ct_recrypt(pk, ek, acc)
        if b == "1":
            acc = ct_mul(pk, acc, x)
            if ek is not None:
                acc = ct_recrypt(pk, ek, acc)
    return acc


def sum_chain(pk: PubKey, cts: list[Cipher]) -> Cipher:
    """Balanced-tree sum of many ciphertexts (log-depth layer growth).

    Each tree level runs as ONE ct_add_batch call, so an n-leaf sum costs
    ceil(log2 n) batched rounds instead of n-1 python-dispatch adds."""
    from ..ops.arithmetic import ct_add_batch

    assert cts
    layer = list(cts)
    while len(layer) > 1:
        pairs = [(layer[i], layer[i + 1])
                 for i in range(0, len(layer) - 1, 2)]
        nxt = ct_add_batch(pk, pairs)
        if len(layer) % 2:
            nxt.append(layer[-1])
        layer = nxt
    return layer[0]


def dot_product(pk: PubKey, xs: list[Cipher], ys: list[Cipher],
                ek: EvalKey | None = None) -> Cipher:
    """Encrypted <x, y> = sum_i xs[i]*ys[i]: the products run as one
    ct_mul_batch (each product's cross-aggregation and σ generation
    batched/pipelined on the engine), then a batched tree sum."""
    from ..ops.arithmetic import ct_mul_batch

    assert xs and len(xs) == len(ys)
    prods = ct_mul_batch(pk, list(zip(xs, ys)))
    if ek is not None:
        prods = [ct_recrypt(pk, ek, p) for p in prods]
    return sum_chain(pk, prods)


def mean_and_scaled_variance(pk: PubKey, cts: list[Cipher],
                             ek: EvalKey | None = None
                             ) -> tuple[Cipher, Cipher]:
    """Encrypted aggregate statistics over n samples x_i:

    returns (S, V) with S = sum x_i  (mean = S / n, a dec-side division or
    ct_div_const) and V = n * sum x_i^2 - S^2  (= n^2 * variance), computed
    entirely homomorphically — the standard one-pass aggregation shape."""
    from ..ops.arithmetic import ct_mul_batch, ct_sub

    n = len(cts)
    assert n >= 1
    S = sum_chain(pk, cts)
    sq = ct_mul_batch(pk, [(c, c) for c in cts])
    if ek is not None:
        sq = [ct_recrypt(pk, ek, p) for p in sq]
    sum_sq = sum_chain(pk, sq)
    S2 = ct_mul(pk, S, S)
    return S, ct_sub(pk, ct_scale(pk, sum_sq, n), S2)


def matvec(pk: PubKey, enc_vec: list[Cipher],
           matrix_rows: list[list[int]]) -> list[Cipher]:
    """Plain matrix x encrypted vector: row_j . enc_vec via scalar scales
    and one batched tree sum per row — the linear-layer primitive for
    encrypted inference over public weights."""
    return [linear_combination(pk, enc_vec, row) for row in matrix_rows]
