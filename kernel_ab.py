#!/usr/bin/env python3
"""Time the PRF pass and the σ pass of one checkout of the port on one CUDA
card, at the shapes the main path launches them with.

    python3 kernel_ab.py [--root DIR] [--label NAME] [--reps N] [--out DIR]

``--root`` is the checkout whose ``pvac_hfhe_cppbyv_tpu_torch`` is imported
(default: the directory of this file).  To compare two checkouts, run this
script once per checkout in one command on one card, in turns (parent,
change, change, parent): every run makes the same inputs from the same
seed, so equal digests mean equal results.

At default Params it measures:

- one PRF pass of 16384 cores (``CudaEngine.PRF_CHUNK``) from raw AES keys:
  the keystream kernel alone (kernel A: ``aes_ctr_keystream_cuda`` in a
  checkout that still writes the keystream to device memory,
  ``lpn_ybits_cuda`` in one that fuses the LPN parity into it), the whole
  pass ``lpn.prf_cores_device`` (kernel A, kernel E and the torch tail),
  the pass's peak device memory above its inputs, its device time and
  kernel count (torch.profiler), and a digest of the core values;
- kernel C at 16384 edges (``SIGMA_DISPATCH``) and 65536 edges
  (``SIGMA_CHUNK``) on real draws against a random 16 MB H, with H cold in
  the L2 cache (a 64 MB write before each timed launch), and the whole σ
  pass ``matrix.sigma_device`` at 16384 edges, with its device time and
  kernel count and a digest of its rows.

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

from chip_smoke import cuda_ms, cuda_ms_cold

SEED = 20261016


def digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def device_profile(torch, fn) -> dict:
    """Device time (sum of kernel times, torch.profiler) and the number of
    kernels of one call of ``fn``; None where the profiler saw no device."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    us = n = 0
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total", None)
        if t is None:
            t = getattr(ev, "self_cuda_time_total", 0)
        if t > 0:
            us += t
            n += ev.count
    return dict(device_ms=us / 1e3 if n else None, kernels=n if n else None)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(__file__)))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    import pvac_hfhe_cppbyv_tpu_torch as pv
    from pvac_hfhe_cppbyv_tpu_torch import kernels
    from pvac_hfhe_cppbyv_tpu_torch.core.bits import from_np_u32, u32_to_i32
    from pvac_hfhe_cppbyv_tpu_torch.crypto import aes_ctr, lpn, matrix, sha256_ctr, shactr
    from pvac_hfhe_cppbyv_tpu_torch.crypto import sigma_xor

    assert os.path.abspath(pv.__file__).startswith(os.path.abspath(args.root)), pv.__file__
    fused = not hasattr(aes_ctr, "aes_ctr_keystream_cuda")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    t0 = time.time()
    kernels.lib()
    out = dict(label=args.label, card=smi, fused_a=fused, build_s=time.time() - t0)
    rng = np.random.default_rng(SEED)
    prm = pv.Params()

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
    if fused:
        from pvac_hfhe_cppbyv_tpu_torch.crypto import lpn_ybits

        def kern_a():
            return lpn_ybits.lpn_ybits_cuda(keys, nlo, nhi, s32, rows,
                                            prm.lpn_tau_num, prm.lpn_tau_den)
    else:
        nb = lpn.n_ybits_blocks(prm)

        def kern_a():
            return aes_ctr.aes_ctr_keystream_cuda(keys, nlo, nhi, nb)

    def prf_pass():
        return lpn.prf_cores_device(prm, keys, nlo, nhi, tkeys, tnlo, tnhi, s32)

    out["a_kernel_ms"] = cuda_ms(torch, kern_a, args.reps)
    out["prf_pass_ms"] = cuda_ms(torch, prf_pass, args.reps)
    prof = device_profile(torch, prf_pass)
    out["prf_pass_device_ms"], out["prf_pass_kernels"] = prof["device_ms"], prof["kernels"]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    r, rej = prf_pass()
    torch.cuda.synchronize()
    out["prf_pass_peak_mib"] = (torch.cuda.max_memory_allocated() - base) / 2**20
    out["prf_digest"] = digest(r, rej)
    del r, rej

    # the σ pass: kernel C cold at 16384 and 65536 edges, the whole pass at 16384
    H = rng.integers(0, 1 << 32, (prm.n_bits, prm.sigma_words32),
                     dtype=np.uint64).astype(np.uint32)
    Hx = matrix.hx_tensor(H, dev)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    words = rng.integers(0, 1 << 64, (65536, 7), dtype=np.uint64)
    for E in (16384, 65536):
        lanes = sha256_ctr.lanes_from_u64(words[:E], dev)
        if fused:
            ridx, nbit, _ = matrix.taken_indices(prm, lanes)

            def kern_c():
                return sigma_xor.sigma_rows_cuda(Hx, ridx, nbit)
        else:
            cv, ct, _ = shactr.draws_and_take(prm.x_col_wt, prm.n_bits, pv.Dom.X_SEED, lanes)
            nv, nt, _ = shactr.draws_and_take(prm.err_wt, prm.m_bits, pv.Dom.NOISE, lanes)
            cidx = torch.where(ct, cv, prm.n_bits).to(torch.int32).contiguous()
            nword = (nv >> 5).to(torch.int32).contiguous()
            nmask = u32_to_i32(torch.where(nt, 1 << (nv & 31), 0)).contiguous()

            def kern_c():
                return sigma_xor.sigma_rows_cuda(Hx, cidx, nword, nmask)
        out[f"c_kernel_cold_ms_{E}"] = cuda_ms_cold(torch, kern_c, args.reps, flush)
        out[f"c_kernel_warm_ms_{E}"] = cuda_ms(torch, kern_c, args.reps)
        out[f"c_digest_{E}"] = digest(kern_c())
        if E == 16384:
            out["sigma_pass_ms_16384"] = cuda_ms(
                torch, lambda: matrix.sigma_device(prm, Hx, lanes), args.reps)
            prof = device_profile(torch, lambda: matrix.sigma_device(prm, Hx, lanes))
            out["sigma_pass_device_ms_16384"] = prof["device_ms"]
            out["sigma_pass_kernels_16384"] = prof["kernels"]
            sig, fb = matrix.sigma_device(prm, Hx, lanes)
            out["sigma_pass_digest_16384"] = digest(sig, fb)
            del sig, fb

    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, f"kernel_ab_{args.label}.json"), "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
