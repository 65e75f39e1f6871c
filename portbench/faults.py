"""Faults planted under the harness, for the control and the fault tests.

Each fault wraps the roles' calls on one deployment, so that the rest of a
run, the check included, runs as it stands.  ``answer_altered`` is the
control: it breaks the guarantee every configuration states, exact
results, in every answer of a request.  The benchmark's own runs plant
none of them.
"""
from __future__ import annotations

import numpy as np

P = (1 << 127) - 1


def _wrap(obj, name: str, after) -> None:
    orig = getattr(obj, name)
    setattr(obj, name, lambda *a, **k: after(orig(*a, **k)))


def _alter_w(cts):
    for c in cts:
        c.w = np.array(c.w)
        c.w[0, 0] ^= 1
    return cts


def _zero_w(cts):
    for c in cts:
        c.w = np.zeros_like(c.w)
    return cts


def _zero_sigma(cts):
    for c in cts:
        c.sigma = np.zeros(c.sigma.shape, dtype=np.uint32)
    return cts


def answer_altered(dep) -> None:
    """One bit of a weight limb flipped in every ciphertext and product;
    every decrypted value off by one."""
    _wrap(dep.client, "encrypt", _alter_w)
    _wrap(dep.client, "decrypt", lambda vs: [(v + 1) % P for v in vs])
    if dep.evaluator is not None:
        _wrap(dep.evaluator, "mul_batch", _alter_w)


def state_unchanged(dep) -> None:
    """Each step hands back what it started from: ciphertexts with the
    weights of a zeroed buffer, the left factor in place of the product,
    zero for a decryption."""
    _wrap(dep.client, "encrypt", _zero_w)
    _wrap(dep.client, "decrypt", lambda vs: [0] * len(vs))
    if dep.evaluator is not None:
        orig = dep.evaluator.mul_batch
        dep.evaluator.mul_batch = lambda pairs: (orig(pairs), [a for a, _ in pairs])[1]


def half_batch(dep) -> None:
    """Every call answers the first half of its batch only."""
    half = lambda xs: xs[: len(xs) // 2]  # noqa: E731
    for role, name in ((dep.client, "encrypt"), (dep.client, "decrypt"),
                       (dep.evaluator, "mul_batch")):
        if role is not None:
            _wrap(role, name, half)


def sigma_zero(dep) -> None:
    """σ left as a zeroed buffer in every ciphertext and product."""
    _wrap(dep.client, "encrypt", _zero_sigma)
    if dep.evaluator is not None:
        _wrap(dep.evaluator, "mul_batch", _zero_sigma)


def control(dep) -> None:
    """The control: every answer altered where it is produced, its weights
    (one bit) and its σ rows (left zero), so that it breaks the well-formed,
    exact result that the configurations state, in every number a cell
    compares."""
    answer_altered(dep)
    sigma_zero(dep)


FAULTS = {f.__name__: f for f in (control, answer_altered, state_unchanged, half_batch,
                                  sigma_zero)}
