#!/usr/bin/env python3
"""Time the PRF pass and the σ pass of one checkout of the port on one CUDA
card, and the stages that kernels B and E take over, at the shapes the main
path launches them with.

    python3 kernel_ab.py [--root DIR] [--label NAME] [--reps N] [--out DIR] [--paths] [--service]

``--root`` is the checkout whose ``pvac_hfhe_cppbyv_tpu_torch`` is imported
(default: the directory of this file).  To compare two checkouts, run this
script once per checkout in one command on one card, in turns (parent,
change, change, parent): every run makes the same inputs from the same
seed, so equal digests mean equal results.

At default Params it measures, each with its wall time (CUDA events over
back-to-back calls), device time and kernel count (torch.profiler) and a
digest of its output:

- one PRF pass of 16384 cores (``CudaEngine.PRF_CHUNK``) from raw AES keys,
  ``lpn.prf_cores_device``, and its peak device memory above its inputs;
  kernel A alone (``lpn_ybits_cuda``); the E stage, from kernel A's LPN
  bits and the Toeplitz keys to the cores (``toep_core.toep_core`` where
  the checkout has it, else ``round_keys``, the one-block AES kernel and
  ``cores_from_ybits``);
- the σ pass ``matrix.sigma_device`` at 16384 edges (``SIGMA_DISPATCH``)
  and 65536 edges (``SIGMA_CHUNK``) against a random 16 MB H, with the
  65536-edge pass's peak device memory above its inputs; the B stage,
  ``matrix.taken_indices``, at both sizes; kernel C with H cold in the L2
  cache (a 64 MB write before each timed launch) and warm.

With ``--paths`` it also runs slice 1 (enc 4096 -> ct_add 2048 -> dec 6144)
and BASELINE config 2 (enc 2048 -> ct_mul 1024 -> ct_sub 512 -> dec 1536)
at default Params through the public entry points, once warm and untraced
for the wall time, then once under torch.profiler (device activity only)
for the device busy time, the idle share of the wall clock and the device
operations that take the most time; every decrypted value is checked.

With ``--service`` it also runs the service path's three heaviest circuits
at default Params on an evaluator's key loaded from ``pk.bin``:
``dot_product`` of 1024 encrypted pairs, ``matvec`` of 8 public rows over
1024 ciphertexts and ``mean_and_scaled_variance`` of 32 values, each
decrypted by the client and checked once, then profiled as the paths are,
and once under cProfile for the host functions that take the most time of
their own.

It prints one JSON line, also written to ``DIR/kernel_ab_<label>.json``
with ``--out DIR``, and exits non-zero without a CUDA card.
"""
import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np

from chip_smoke import cuda_ms, cuda_ms_cold, device_profile, peak_mib

SEED = 20261016


def digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def path_profile(torch, fn, top: int = 8) -> dict:
    """Wall seconds of one warm untraced run of ``fn`` (host clock up to a
    synchronize), then one run under torch.profiler: its wall seconds, the
    device busy ms (the sum of device activity), the idle share of its
    wall clock and the ``top`` device operations by time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.time()
    fn()
    torch.cuda.synchronize()
    wall = time.time() - t0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        traced = time.time() - t0
    ops = []
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total", None)
        if t is None:
            t = getattr(ev, "self_cuda_time_total", 0)
        if t > 0:
            ops.append((t / 1e3, ev.count, ev.key[:80]))
    ops.sort(reverse=True)
    busy = sum(t for t, _, _ in ops)
    return dict(wall_s=wall, traced_wall_s=traced, device_ms=busy,
                idle_share=1 - busy / 1e3 / traced, kernels=sum(n for _, n, _ in ops),
                top=[dict(ms=t, count=n, name=k) for t, n, k in ops[:top]])


def paths(pv, torch, rng, prm) -> dict:
    """Slice 1 and config 2 at default Params, each profiled by
    :func:`path_profile`; every decrypted value is checked."""
    pk, sk = pv.keygen(prm)
    vals = [int(v) for v in rng.integers(0, 1 << 64, 4096, dtype=np.uint64)]

    def slice1():
        cts = pv.enc_value_batch(pk, sk, vals)
        sums = pv.ct_add_batch(pk, [(cts[2 * i], cts[2 * i + 1]) for i in range(2048)])
        dec = pv.dec_value_batch(pk, sk, cts + sums)
        assert dec == vals + [(vals[2 * i] + vals[2 * i + 1]) % pv.P for i in range(2048)]

    def config2():
        cts = pv.enc_value_batch(pk, sk, vals[:2048])
        prods = pv.ct_mul_batch(pk, [(cts[2 * i], cts[2 * i + 1]) for i in range(1024)])
        diffs = pv.ct_sub_batch(pk, [(prods[2 * i], prods[2 * i + 1]) for i in range(512)])
        dec = pv.dec_value_batch(pk, sk, prods + diffs)
        pw = [vals[2 * i] * vals[2 * i + 1] % pv.P for i in range(1024)]
        assert dec == pw + [(pw[2 * i] - pw[2 * i + 1]) % pv.P for i in range(512)]

    return dict(slice1=path_profile(torch, slice1), config2=path_profile(torch, config2))


def host_profile(fn, top: int = 10) -> list:
    """The ``top`` host functions by their own time in one cProfile run of
    ``fn``, with their call counts and cumulative time."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    prof.enable()
    fn()
    prof.disable()
    rows = sorted(((tt, ct, nc, f"{os.path.basename(f)}:{line}({name})")
                   for (f, line, name), (_, nc, tt, ct, _) in pstats.Stats(prof).stats.items()),
                  reverse=True)
    return [dict(own_s=tt, cum_s=ct, calls=nc, name=k) for tt, ct, nc, k in rows[:top]]


def service(pv, torch, rng, prm) -> dict:
    """dot_product, matvec and mean_and_scaled_variance on an evaluator's
    key loaded from pk.bin, each checked once by the client's decryption,
    then profiled by :func:`path_profile` and :func:`host_profile`."""
    import tempfile

    from pvac_hfhe_cppbyv_tpu_torch.models import circuits as C

    client = pv.Client.generate(prm)
    with tempfile.TemporaryDirectory() as tmp:
        pv.save_pk(client.pk, os.path.join(tmp, "pk.bin"))
        pk_e = pv.load_pk(os.path.join(tmp, "pk.bin"))
    n, samples, P = 1024, 32, pv.P
    xv, yv, sv = ([int(v) for v in rng.integers(0, 1 << 32, k, dtype=np.uint64)]
                  for k in (n, n, samples))
    rows = rng.integers(0, 1 << 16, (8, n), dtype=np.int64).tolist()
    cts = client.encrypt(xv + yv + sv)
    xs, ys, ss = cts[:n], cts[n:2 * n], cts[2 * n:]
    s = sum(sv)
    runs = {
        "dot_product": (lambda: [C.dot_product(pk_e, xs, ys)],
                        [sum(x * y for x, y in zip(xv, yv)) % P]),
        "matvec": (lambda: C.matvec(pk_e, xs, rows),
                   [sum(w * x for w, x in zip(r, xv)) % P for r in rows]),
        "mean_and_scaled_variance": (lambda: list(C.mean_and_scaled_variance(pk_e, ss)),
                                     [s % P, (samples * sum(v * v for v in sv) - s * s) % P]),
    }
    out = {}
    for name, (fn, want) in runs.items():
        assert client.decrypt(fn()) == want, f"{name} decrypts wrong"
        out[name] = dict(path_profile(torch, fn), host_top=host_profile(fn))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(__file__)))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", default=None)
    ap.add_argument("--paths", action="store_true",
                    help="also profile slice 1 and config 2 (torch.profiler)")
    ap.add_argument("--service", action="store_true",
                    help="also profile the service path's three heaviest circuits")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    import pvac_hfhe_cppbyv_tpu_torch as pv
    from pvac_hfhe_cppbyv_tpu_torch import kernels
    from pvac_hfhe_cppbyv_tpu_torch.core.bits import from_np_u32
    from pvac_hfhe_cppbyv_tpu_torch.crypto import lpn, lpn_ybits, matrix, sha256_ctr, sigma_xor

    assert os.path.abspath(pv.__file__).startswith(os.path.abspath(args.root)), pv.__file__
    try:
        from pvac_hfhe_cppbyv_tpu_torch.crypto import toep_core
    except ImportError:
        toep_core = None
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    t0 = time.time()
    kernels.lib()
    out = dict(label=args.label, card=smi, fused_e=toep_core is not None,
               build_s=time.time() - t0)
    rng = np.random.default_rng(SEED)
    prm = pv.Params()

    def timed(name, fn):
        """Wall ms, device ms, kernel count and output digest of fn."""
        out[f"{name}_ms"] = cuda_ms(torch, fn, args.reps)
        prof = device_profile(torch, fn)
        out[f"{name}_device_ms"], out[f"{name}_kernels"] = prof["device_ms"], prof["kernels"]
        res = fn()
        out[f"{name}_digest"] = digest(*(res if isinstance(res, tuple) else (res,)))

    # the PRF pass: 16384 cores from raw keys
    N = 16384
    rows = min(127, prm.lpn_t)

    def halves(n):
        nonces = rng.integers(0, 1 << 64, n, dtype=np.uint64)
        h = nonces.view(np.uint32).reshape(n, 2)
        return (from_np_u32(np.ascontiguousarray(h[:, 0]), dev),
                from_np_u32(np.ascontiguousarray(h[:, 1]), dev))

    keys = torch.from_numpy(rng.integers(0, 256, (N, 32), dtype=np.uint8)).to(dev)
    tkeys = torch.from_numpy(rng.integers(0, 256, (N, 32), dtype=np.uint8)).to(dev)
    nlo, nhi = halves(N)
    tnlo, tnhi = halves(N)
    s32 = from_np_u32(rng.integers(0, 1 << 32, 2 * prm.s_words64, dtype=np.uint64)
                      .astype(np.uint32), dev)

    def kern_a():
        return lpn_ybits.lpn_ybits_cuda(keys, nlo, nhi, s32, rows,
                                        prm.lpn_tau_num, prm.lpn_tau_den)

    y = kern_a()[0]
    if toep_core is not None:
        def e_stage():
            return toep_core.toep_core(tkeys, tnlo, tnhi, y)
    else:
        from pvac_hfhe_cppbyv_tpu_torch.crypto import aes_ctr

        def e_stage():
            top = aes_ctr.aes_ctr_keystream_rk(aes_ctr.round_keys(tkeys), tnlo, tnhi, 1)
            return lpn.cores_from_ybits(y, top)

    def prf_pass():
        return lpn.prf_cores_device(prm, keys, nlo, nhi, tkeys, tnlo, tnhi, s32)

    out["a_kernel_ms"] = cuda_ms(torch, kern_a, args.reps)
    timed("e_stage", e_stage)
    timed("prf_pass", prf_pass)
    torch.cuda.empty_cache()
    out["prf_pass_peak_mib"] = peak_mib(torch, prf_pass)

    # the σ pass, the B stage and kernel C at 16384 and 65536 edges
    H = rng.integers(0, 1 << 32, (prm.n_bits, prm.sigma_words32),
                     dtype=np.uint64).astype(np.uint32)
    Hx = matrix.hx_tensor(H, dev)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    words = rng.integers(0, 1 << 64, (65536, 7), dtype=np.uint64)
    for E in (16384, 65536):
        lanes = sha256_ctr.lanes_from_u64(words[:E], dev)
        timed(f"b_stage_{E}", lambda: matrix.taken_indices(prm, lanes))
        timed(f"sigma_pass_{E}", lambda: matrix.sigma_device(prm, Hx, lanes))
        torch.cuda.empty_cache()
        out[f"sigma_pass_peak_mib_{E}"] = peak_mib(
            torch, lambda: matrix.sigma_device(prm, Hx, lanes))
        ridx, nbit, _ = matrix.taken_indices(prm, lanes)

        def kern_c():
            return sigma_xor.sigma_rows_cuda(Hx, ridx, nbit)
        out[f"c_kernel_cold_ms_{E}"] = cuda_ms_cold(torch, kern_c, args.reps, flush)
        out[f"c_kernel_warm_ms_{E}"] = cuda_ms(torch, kern_c, args.reps)
        del ridx, nbit
    del Hx, flush, keys, tkeys, y
    if args.paths:
        out["paths"] = paths(pv, torch, rng, prm)
    if args.service:
        out["service"] = service(pv, torch, rng, prm)

    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, f"kernel_ab_{args.label}.json"), "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
