"""Deployments: who holds which key, by the configuration's ``deployment``.

- ``keyholder``: one process holds the key pair; keygen attaches an engine
  on the card with H, the LPN secret and kernel D's midstate.
- ``split``: a client holds the key pair; an evaluator holds only the
  ``pk.bin`` that the client saved and ``load_pk`` read back, with an
  engine of its own (H, no secret key).  Both share the card and pass
  Python objects.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile


class Deployment:
    def __init__(self, pv, device, client, evaluator=None):
        self.pv = pv
        self.device = device
        self.client = client
        self.evaluator = evaluator
        self.params = dict(vars(client.pk.prm))

    def engines(self) -> list:
        """The engines the roles compute on (none on the host route)."""
        roles = [self.client] + ([self.evaluator] if self.evaluator else [])
        out = []
        for r in roles:
            eng = getattr(r.pk, "_engine", None)
            if eng is not None and all(eng is not e for e in out):
                out.append(eng)
        return out

    def sync(self) -> None:
        """Wait for all work queued on the card."""
        if self.device != "cpu":
            import torch

            torch.cuda.synchronize()

    def key_material(self) -> dict:
        """The key pair's raw draws, which the reference derives from."""
        sk, pk = self.client.sk, self.client.pk
        return {"prf_k": list(sk.prf_k), "lpn_s_words": list(sk.lpn_s_bits),
                "canon_tag": pk.canon_tag, "g": pk.powg_B[1]}


def build(config: dict, device: str) -> Deployment:
    import pvac_hfhe_cppbyv_tpu_torch as pv

    prm = pv.Params(**config["params"])
    client = pv.Client.generate(prm, device=device)
    kind = config["deployment"]
    if kind == "keyholder":
        return Deployment(pv, device, client)
    if kind == "split":
        with tempfile.TemporaryDirectory(prefix="portbench-") as tmp:  # under $TMPDIR
            path = os.path.join(tmp, "pk.bin")
            pv.save_pk(client.pk, path)
            pk = pv.load_pk(path, device=device)
        if pk.prm != prm:
            # pk.bin stores no n_bits or column weights: outside the
            # defaults (a CPU test's small Params) they come from the config
            pk.prm = dataclasses.replace(prm)
        return Deployment(pv, device, client, pv.Evaluator(pk))
    raise ValueError(f"unknown deployment {kind!r}")
