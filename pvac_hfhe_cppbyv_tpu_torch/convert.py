"""Key material from plain numpy arrays and ints.

:func:`keys_from_numpy` builds this package's PubKey and SecKey from the
fields of another implementation's keypair, given only as numpy arrays,
ints, bytes and a mapping of parameter fields.  It is how both
implementations compute with the same keys without importing each other.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .params import Params
from .types import PubKey, SecKey, Ubk


def keys_from_numpy(pk_fields: dict, sk_fields: dict,
                    device="cuda") -> tuple[PubKey, SecKey]:
    """pk_fields: ``prm`` (a mapping of Params field names to values),
    ``canon_tag``, ``H`` ([n_bits, m_words32] uint32 or None), ``ubk_perm``
    and ``ubk_inv`` (int32 [m_bits] or None), ``H_digest`` (32 bytes),
    ``omega_B`` and ``powg_B`` (ints).  sk_fields: ``prf_k`` (4 u64) and
    ``lpn_s_bits`` (u64 words).  Returns (PubKey, SecKey).  With a CUDA
    ``device`` (the default) a :class:`CudaEngine` on it is attached to pk;
    ``device="cpu"`` attaches none.  Raises if no CUDA device is
    available."""
    from .engine import enable_device, resolve_device

    device = resolve_device(device)
    names = {f.name for f in dataclasses.fields(Params)}
    prm = Params(**{k: v for k, v in dict(pk_fields["prm"]).items() if k in names})
    H = pk_fields.get("H")
    perm, inv = pk_fields.get("ubk_perm"), pk_fields.get("ubk_inv")
    pk = PubKey(
        prm=prm,
        canon_tag=int(pk_fields["canon_tag"]),
        H=None if H is None else np.ascontiguousarray(H, dtype=np.uint32),
        ubk=None if perm is None else Ubk(np.asarray(perm, dtype=np.int32),
                                          np.asarray(inv, dtype=np.int32)),
        H_digest=bytes(pk_fields["H_digest"]),
        omega_B=int(pk_fields["omega_B"]),
        powg_B=[int(g) for g in pk_fields["powg_B"]],
    )
    sk = SecKey(prf_k=[int(k) for k in sk_fields["prf_k"]],
                lpn_s_bits=[int(w) for w in sk_fields["lpn_s_bits"]])
    if device.type != "cpu":
        enable_device(pk, sk, device)
    return pk, sk
