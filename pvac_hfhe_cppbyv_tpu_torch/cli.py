"""Command-line tooling.

Replaces the reference's out-of-library binaries (tests/add.cpp: load
a.ct/b.ct -> sum.ct; tests/decode_ct.cpp: inspect/decode dumps):

    python -m pvac_hfhe_cppbyv_tpu_torch [--device DEV] keygen  KEYDIR [--small]
    python -m pvac_hfhe_cppbyv_tpu_torch [--device DEV] enc     KEYDIR VALUE... [-o out.ct]
    python -m pvac_hfhe_cppbyv_tpu_torch [--device DEV] dec     KEYDIR FILE.ct
    python -m pvac_hfhe_cppbyv_tpu_torch [--device DEV] add     KEYDIR A.ct B.ct -o SUM.ct
    python -m pvac_hfhe_cppbyv_tpu_torch [--device DEV] mul     KEYDIR A.ct B.ct -o PROD.ct
    python -m pvac_hfhe_cppbyv_tpu_torch [--device DEV] enc-text KEYDIR "message" -o out.ct
    python -m pvac_hfhe_cppbyv_tpu_torch [--device DEV] dec-text KEYDIR FILE.ct
    python -m pvac_hfhe_cppbyv_tpu_torch inspect FILE.ct [-v]

(installed, also as ``pvac-torch``).  ``--device`` may also follow the
subcommand.  It defaults to ``cuda``: every subcommand but ``inspect``
computes on the card and exits non-zero, naming the device, where there
is none; ``--device cpu`` runs on the host.

KEYDIR layout: pklite.bin + sk.bin + params.json (H/ubk regenerate from
canon_tag on load), the same bytes the JAX package's CLI writes and reads.
"""
from __future__ import annotations

import argparse
import pathlib

from .core import bitvec as BV
from .crypto.keygen import keygen
from .engine import resolve_device
from .io.serial import (
    load_cts, load_pklite, load_sk, save_cts, save_params, save_pklite, save_sk,
)
from .ops.arithmetic import ct_add, ct_mul
from .ops.decrypt import dec_value_batch
from .ops.encrypt import enc_value_batch
from .params import Params, small_test_params
from .types import RRULE_BASE
from .utils.text import dec_text, enc_text


def _load_keys(keydir: str, need_H: bool, device):
    d = pathlib.Path(keydir)
    pk = load_pklite(str(d / "pklite.bin"), with_H=need_H, device=device)
    sk_path = d / "sk.bin"
    sk = load_sk(str(sk_path)) if sk_path.exists() else None
    return pk, sk


def cmd_keygen(args):
    prm = small_test_params() if args.small else Params()
    pk, sk = keygen(prm, device=args.device)
    d = pathlib.Path(args.keydir)
    d.mkdir(parents=True, exist_ok=True)
    save_pklite(pk, str(d / "pklite.bin"))
    save_sk(sk, str(d / "sk.bin"))
    save_params(prm, str(d / "params.json"))
    print(f"wrote {d}/pklite.bin, sk.bin, params.json")


def cmd_enc(args):
    pk, sk = _load_keys(args.keydir, True, args.device)
    cts = enc_value_batch(pk, sk, [int(v) for v in args.values])
    save_cts(cts, args.output)
    print(f"wrote {args.output} ({len(cts)} cipher(s))")


def cmd_dec(args):
    pk, sk = _load_keys(args.keydir, False, args.device)
    for v in dec_value_batch(pk, sk, load_cts(args.file)):
        print(f"{v & ((1 << 64) - 1)} {v >> 64}")


def cmd_add(args):
    pk, _ = _load_keys(args.keydir, False, args.device)
    save_cts([ct_add(pk, load_cts(args.a)[0], load_cts(args.b)[0])], args.output)
    print(f"wrote {args.output}")


def cmd_mul(args):
    pk, _ = _load_keys(args.keydir, True, args.device)
    save_cts([ct_mul(pk, load_cts(args.a)[0], load_cts(args.b)[0])], args.output)
    print(f"wrote {args.output}")


def cmd_enc_text(args):
    pk, sk = _load_keys(args.keydir, True, args.device)
    save_cts(enc_text(pk, sk, args.message), args.output)
    print(f"wrote {args.output}")


def cmd_dec_text(args):
    pk, sk = _load_keys(args.keydir, False, args.device)
    print(dec_text(pk, sk, load_cts(args.file)))


def cmd_inspect(args):
    """Structural dump of a .ct file (decode_ct.cpp equivalent)."""
    cts = load_cts(args.file)
    print(f"{args.file}: {len(cts)} cipher(s)")
    for i, c in enumerate(cts):
        mbits = c.sigma.shape[1] * 32
        dens = (float(BV.popcnt(c.sigma).sum()) / (c.n_edges * mbits)
                if c.n_edges else 0.0)
        n_base = sum(1 for L in c.layers if L.rule == RRULE_BASE)
        print(f"  [{i}] layers={c.n_layers} (base={n_base}) edges={c.n_edges} "
              f"sigma_bits={mbits} density={dens:.4f}")
        if args.verbose:
            for j, L in enumerate(c.layers):
                if L.rule == RRULE_BASE:
                    print(f"      L{j}: BASE ztag={L.seed.ztag:#018x}")
                else:
                    print(f"      L{j}: PROD pa={L.pa} pb={L.pb}")


DEVICE_HELP = "torch device to compute on (default: cuda; cpu for the host route)"


def main(argv=None):
    p = argparse.ArgumentParser(prog="pvac_hfhe_cppbyv_tpu_torch")
    p.add_argument("--device", default="cuda", help=DEVICE_HELP)
    sub = p.add_subparsers(dest="cmd", required=True)

    def command(name, fn):
        s = sub.add_parser(name)
        s.add_argument("--device", default=argparse.SUPPRESS, help=DEVICE_HELP)
        s.set_defaults(fn=fn)
        return s

    s = command("keygen", cmd_keygen)
    s.add_argument("keydir")
    s.add_argument("--small", action="store_true")

    s = command("enc", cmd_enc)
    s.add_argument("keydir")
    s.add_argument("values", nargs="+")
    s.add_argument("-o", "--output", default="out.ct")

    s = command("dec", cmd_dec)
    s.add_argument("keydir")
    s.add_argument("file")

    for name, fn in (("add", cmd_add), ("mul", cmd_mul)):
        s = command(name, fn)
        s.add_argument("keydir")
        s.add_argument("a")
        s.add_argument("b")
        s.add_argument("-o", "--output", required=True)

    s = command("enc-text", cmd_enc_text)
    s.add_argument("keydir")
    s.add_argument("message")
    s.add_argument("-o", "--output", default="text.ct")

    s = command("dec-text", cmd_dec_text)
    s.add_argument("keydir")
    s.add_argument("file")

    s = sub.add_parser("inspect")
    s.add_argument("file")
    s.add_argument("-v", "--verbose", action="store_true")
    s.set_defaults(fn=cmd_inspect)

    args = p.parse_args(argv)
    if args.fn is not cmd_inspect:
        try:
            args.device = resolve_device(args.device)
        except RuntimeError as e:
            p.exit(2, f"{p.prog}: error: {e}\n")
    args.fn(args)


if __name__ == "__main__":
    main()
