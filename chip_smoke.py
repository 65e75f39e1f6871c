#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card.  Phases,
each printing its own line; any failure raises and exits non-zero:

1. the card (nvidia-smi name and power limit), torch and CUDA versions;
2. build the CUDA kernels from the checkout's sources (nvcc, sm_90a);
3. each kernel against its plain torch twin on the card at the shapes the
   main path gives it, bit-exact, with both times (CUDA events);
4. the reference goldens (default Params) decrypt to 42 / 17 / 59;
5. the main path at default Params: keygen, enc_value_batch of 4096
   seeded u64 values, ct_add_batch on 2048 pairs, dec_value_batch of all
   6144 ciphertexts checked exactly, σ rows against the scalar reference,
   and a .ct save/load round trip.  Kernel launch counts are reset just
   before and read just after the main path.

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.  Without a CUDA device, or
without the package beside it, the script exits non-zero and prints no
result.  It imports nothing of JAX.
"""
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 20261016


def say(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean milliseconds per call over ``reps`` calls after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def max_abs_err(torch, a, b) -> int:
    """Largest |a - b| over u32 values held as int32 bit patterns."""
    d = (a.to(torch.int64) & 0xFFFFFFFF) - (b.to(torch.int64) & 0xFFFFFFFF)
    return int(d.abs().max().item()) if d.numel() else 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import pvac_hfhe_cppbyv_tpu_torch as pv
    from pvac_hfhe_cppbyv_tpu_torch import kernels
    from pvac_hfhe_cppbyv_tpu_torch.core.bits import from_np_u32, u32_to_i32
    from pvac_hfhe_cppbyv_tpu_torch.crypto import (
        aes, aes_ctr, lpn, matrix, sha256_ctr, shactr, sigma_xor)

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    kind = torch.cuda.get_device_name(0)
    say(f"[card] {smi}")
    say(f"[versions] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {kind} count {torch.cuda.device_count()}")

    # 2. build
    t0 = time.time()
    kernels.lib()
    say(f"[build] kernels built and loaded in {time.time() - t0:.2f} s")
    for line in kernels.BUILD_LOG.splitlines():
        if "Used" in line or "spill" in line or "Compiling entry" in line:
            say(f"[build] {line.strip()}")

    prm = pv.Params()
    report = {}

    # 3a. kernel A: 2048 PRF cores x 4128 blocks
    N, nb = 2048, lpn.n_ybits_blocks(prm)
    keys_np = rng.integers(0, 256, (N, 32), dtype=np.uint8)
    nonces = rng.integers(0, 1 << 64, N, dtype=np.uint64)
    nonces[:4] = [(1 << 64) - 5, (1 << 32) - 3, (1 << 64) - 1, 0]
    halves = nonces.view(np.uint32).reshape(N, 2)
    keys = torch.from_numpy(keys_np).to(dev)
    nlo = from_np_u32(np.ascontiguousarray(halves[:, 0]), dev)
    nhi = from_np_u32(np.ascontiguousarray(halves[:, 1]), dev)
    got = aes_ctr.aes_ctr_keystream_cuda(keys, nlo, nhi, nb)
    want = aes_ctr.aes_ctr_keystream_plain(keys, nlo, nhi, nb)
    err = max_abs_err(torch, got, want)
    w = got[:4, :8].cpu().numpy().view(np.uint32).astype(np.uint64)
    for n in range(4):
        oracle = aes.AesCtr256(bytes(keys_np[n]), int(nonces[n])).fill_u64(16)
        mine = [int(x) for x in (w[n, :, 0::2] | (w[n, :, 1::2] << np.uint64(32))).reshape(-1)]
        assert mine == oracle, f"kernel A lane {n} differs from the scalar AES oracle"
    assert err == 0 and torch.equal(got, want), f"kernel A differs from its twin: {err}"
    ms = cuda_ms(torch, lambda: aes_ctr.aes_ctr_keystream_cuda(keys, nlo, nhi, nb), 20)
    plain = cuda_ms(torch, lambda: aes_ctr.aes_ctr_keystream_plain(keys, nlo, nhi, nb), 2)
    report["aes_ctr"] = dict(max_abs_err=err, ms=ms, plain_ms=plain)
    say(f"[kernel A aes_ctr] {N} cores x {nb} blocks: bit-exact vs twin and oracle; "
        f"kernel {ms:.3f} ms, twin {plain:.3f} ms")

    # 3b. kernel B: 16384 lanes x R=36 for both labels
    L, D = 16384, prm.x_col_wt + 16
    R = (D + 3) // 4
    words = rng.integers(0, 1 << 64, (L, 7), dtype=np.uint64)
    lanes = sha256_ctr.lanes_from_u64(words, dev)
    tot_ms = tot_plain = 0.0
    err_b = 0
    for label in (pv.Dom.X_SEED, pv.Dom.NOISE):
        lb = label.encode()
        got = sha256_ctr.shactr_states_cuda(lb, lanes, R)
        want = sha256_ctr.shactr_states_plain(lb, lanes, R)
        e = max_abs_err(torch, got, want)
        u64 = shactr.stream_u64s(label, lanes[:2], 8).cpu().numpy()
        st = shactr.CtrStream(label, [int(x) for x in words[0]])
        assert [int(u64[0, j, 0]) | int(u64[0, j, 1]) << 32 for j in range(8)] == \
            [st.rnd() for _ in range(8)], f"kernel B stream differs from CtrStream ({label})"
        assert e == 0 and torch.equal(got, want), f"kernel B differs from its twin ({label}): {e}"
        err_b = max(err_b, e)
        m = cuda_ms(torch, lambda: sha256_ctr.shactr_states_cuda(lb, lanes, R), 20)
        p = cuda_ms(torch, lambda: sha256_ctr.shactr_states_plain(lb, lanes, R), 2)
        tot_ms += m
        tot_plain += p
        say(f"[kernel B sha256_ctr] {label}: {L} lanes x R={R}: bit-exact vs twin and "
            f"CtrStream; kernel {m:.3f} ms, twin {p:.3f} ms")
    report["sha256_ctr"] = dict(max_abs_err=err_b, ms=tot_ms, plain_ms=tot_plain)

    # 3c. kernel C: 16384 edges x 256 words against a 16 MB H, real draws
    H = rng.integers(0, 1 << 32, (prm.n_bits, prm.sigma_words32), dtype=np.uint64).astype(np.uint32)
    Hx = matrix.hx_tensor(H, dev)
    cv, ct, _ = shactr.draws_and_take(prm.x_col_wt, prm.n_bits, pv.Dom.X_SEED, lanes)
    nv, nt, _ = shactr.draws_and_take(prm.err_wt, prm.m_bits, pv.Dom.NOISE, lanes)
    cidx = torch.where(ct, cv, prm.n_bits).to(torch.int32).contiguous()
    nword = (nv >> 5).to(torch.int32).contiguous()
    nmask = u32_to_i32(torch.where(nt, 1 << (nv & 31), 0)).contiguous()
    got = sigma_xor.sigma_rows_cuda(Hx, cidx, nword, nmask)
    want = sigma_xor.sigma_rows_plain(Hx, cidx, nword, nmask)
    err = max_abs_err(torch, got, want)
    assert err == 0 and torch.equal(got, want), f"kernel C differs from its twin: {err}"
    ms = cuda_ms(torch, lambda: sigma_xor.sigma_rows_cuda(Hx, cidx, nword, nmask), 20)
    plain = cuda_ms(torch, lambda: sigma_xor.sigma_rows_plain(Hx, cidx, nword, nmask), 2)
    report["sigma"] = dict(max_abs_err=err, ms=ms, plain_ms=plain)
    say(f"[kernel C sigma] {L} edges x {prm.sigma_words32} words, H {H.nbytes >> 20} MB: "
        f"bit-exact vs twin; kernel {ms:.3f} ms, twin {plain:.3f} ms")
    del Hx, got, want, lanes

    # 4. default goldens
    g = os.path.join(ROOT, "tests", "golden", "default")
    gpk = pv.load_pklite(os.path.join(g, "pklite.bin"))
    gsk = pv.load_sk(os.path.join(g, "sk.bin"))
    pv.enable_device(gpk, gsk, "cuda")
    for name, want_v in (("a", 42), ("b", 17), ("sum", 59)):
        v = pv.dec_value_batch(gpk, gsk, pv.load_cts(os.path.join(g, f"{name}.ct")))
        assert v == [want_v], f"golden {name}: got {v}, want {want_v}"
    say("[goldens] default a/b/sum decrypt on the card to 42/17/59")

    # 5. main path
    t0 = time.time()
    pk, sk = pv.keygen(prm)
    keygen_s = time.time() - t0
    eng = pv.enable_device(pk, sk, "cuda")
    values = [int(v) for v in rng.integers(0, 1 << 64, 4096, dtype=np.uint64)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.time()
    cts = pv.enc_value_batch(pk, sk, values)
    eng.drain()
    t_enc = time.time() - t0
    sums = pv.ct_add_batch(pk, [(cts[2 * i], cts[2 * i + 1]) for i in range(2048)])
    t0 = time.time()
    dec = pv.dec_value_batch(pk, sk, cts + sums)
    eng.drain()
    t_dec = time.time() - t0
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    want_dec = values + [(values[2 * i] + values[2 * i + 1]) % pv.P for i in range(2048)]
    bad = sum(a != b for a, b in zip(dec, want_dec))
    assert len(dec) == 6144 and bad == 0, f"{bad} of {len(dec)} ciphertexts decrypt wrong"
    for k, n in launches.items():
        assert n > 0, f"kernel {k} was not launched on the main path"
    say(f"[main] keygen {keygen_s:.2f} s; enc 4096 values in {t_enc:.3f} s "
        f"({4096 / t_enc:.1f} ct/s); dec 6144 ciphertexts in {t_dec:.3f} s "
        f"({6144 / t_dec:.1f} ct/s); all exact")
    say(f"[main] PRF cores {eng.stats['prf_cores']}, sigma edges {eng.stats['sigma_edges']}, "
        f"peak device memory {peak / 2**20:.1f} MiB, launches {launches}")

    # σ rows of the main path's program against the scalar reference
    sel = rng.integers(0, 1 << 64, (64, 7), dtype=np.uint64)
    sel[:, 4] %= np.uint64(prm.B)
    sel[:, 5] &= np.uint64(1)
    rows = matrix.sigma_words(pk, *(sel[:, j] for j in range(1, 7)))
    for e in range(64):
        ref = matrix._scalar_sigma_row(pk, prm, [pk.canon_tag, *sel[e, 1:]])
        assert np.array_equal(rows[e], ref), f"sigma row {e} differs from the scalar path"
    say("[main] 64 sigma rows on the card equal the scalar reference")

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "rt.ct")
        sub = cts[:8] + sums[:8]
        pv.save_cts(sub, path)
        back = pv.load_cts(path)
        pv.save_cts(back, path + "2")
        with open(path, "rb") as f1, open(path + "2", "rb") as f2:
            assert f1.read() == f2.read(), ".ct round trip is not byte-exact"
        assert pv.dec_value_batch(pk, sk, back) == want_dec[:8] + want_dec[4096:4104]
    say("[main] .ct save/load round trip byte-exact; 16 reloaded ciphertexts decrypt")

    src = {"aes_ctr": ("kernels/aes_ctr.cu", "pvac_hfhe_cppbyv_tpu/crypto/aes_fused.py:95"),
           "sha256_ctr": ("kernels/sha256_ctr.cu", "pvac_hfhe_cppbyv_tpu/crypto/sha256_pallas.py:173"),
           "sigma": ("kernels/sigma.cu", "pvac_hfhe_cppbyv_tpu/crypto/onehot_pallas.py:37")}
    rows_out = [dict(name=k, route="cuda", source="pvac_hfhe_cppbyv_tpu_torch/" + src[k][0],
                     replaces=src[k][1], launches=launches[k], **report[k]) for k in src]
    say(smi)  # the card and its power limit, as nvidia-smi prints them
    say(json.dumps({"kernels": rows_out}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
