#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card.  Phases,
each printing its own line; any failure raises and exits non-zero:

1. the card (nvidia-smi name and power limit), torch and CUDA versions;
2. build the five CUDA kernels from the checkout's sources (nvcc, sm_90a,
   one process per source, in parallel);
3. each kernel against its plain torch twin on the card at the shapes the
   main paths give it, bit-exact, with both times (CUDA events): A
   (AES-256-CTR, raw keys), B (SHA-256-CTR), C (σ rows), D (SHA-256 of
   the PRF key-derivation messages), E (AES-256-CTR from expanded keys);
4. the reference goldens (default Params) decrypt to 42 / 17 / 59, and
   the port's ct_mul of golden a x b decrypts to 714;
5. keygen at default Params; 4096 PRF cores keyed on the card (kernel D)
   equal the same cores keyed on the host;
6. slice 1 at default Params: enc_value_batch of 4096 seeded u64 values,
   ct_add_batch on 2048 pairs, dec_value_batch of all 6144 ciphertexts
   checked exactly, σ rows against the scalar reference, and a .ct
   save/load round trip;
7. slice 2, BASELINE config 2 at default Params: enc_value_batch of 2048
   values, ct_mul_batch on 1024 pairs, ct_sub_batch on 512 pairs of
   products, dec_value_batch of all 1536 results checked exactly against
   a*b and a1*b1 - a2*b2 mod p, and a .ct round trip of some of them.
Kernel launch counts are reset just before and read just after each of
the two main paths (6 and 7); each must launch all five kernels.

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.  Without a CUDA device, or
without the package beside it, the script exits non-zero and prints no
result.  It imports nothing of JAX.
"""
import hashlib
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
    from pvac_hfhe_cppbyv_tpu_torch.core.hash import MsgLayout
    from pvac_hfhe_cppbyv_tpu_torch.core.bits import from_np_u32, u32_to_i32
    from pvac_hfhe_cppbyv_tpu_torch.crypto import (
        aes, aes_ctr, lpn, matrix, sha256_blocks, sha256_ctr, shactr, sigma_xor)

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

    # 3d. kernel D: the derivation messages of 16384 PRF cores, main and
    # Toeplitz keys in one launch (2 x 16384 messages of 2 blocks)
    n_core = 16384
    prefix = bytes(rng.integers(0, 256, 72, dtype=np.uint8))  # prf_k||canon||H_digest
    layout = MsgLayout(prefix, 4)
    f64 = rng.integers(0, 1 << 64, (2 * n_core, 4), dtype=np.uint64)
    f64[n_core:, :3] = f64[:n_core, :3]
    f64[n_core:, 3] = lpn.DOM_HASH[pv.Dom.TOEP]
    fields = torch.from_numpy(f64.view(np.uint32).reshape(-1, 4, 2).astype(np.int64)).to(dev)
    blocks = u32_to_i32(layout.build_blocks(fields, layout.template_tensor(dev))).contiguous()
    got = sha256_blocks.sha256_blocks_cuda(blocks)
    want = sha256_blocks.sha256_blocks_plain(blocks)
    err = max_abs_err(torch, got, want)
    assert err == 0 and torch.equal(got, want), f"kernel D differs from its twin: {err}"
    dg = got.cpu().numpy().view(np.uint32).astype(">u4")
    for i in (0, 1, n_core, 2 * n_core - 1):
        want_d = hashlib.sha256(prefix + f64[i].astype("<u8").tobytes()).digest()
        assert dg[i].tobytes() == want_d, f"kernel D message {i} differs from hashlib"
    ms = cuda_ms(torch, lambda: sha256_blocks.sha256_blocks_cuda(blocks), 20)
    plain = cuda_ms(torch, lambda: sha256_blocks.sha256_blocks_plain(blocks), 2)
    report["sha256_blocks"] = dict(max_abs_err=err, ms=ms, plain_ms=plain)
    say(f"[kernel D sha256_blocks] {2 * n_core} messages x {layout.n_blocks} blocks: "
        f"bit-exact vs twin and hashlib; kernel {ms:.3f} ms, twin {plain:.3f} ms")

    # 3e. kernel E: the Toeplitz stream of 16384 cores (1 block each), and
    # 256 lanes x 40 blocks whose counters cross the 2^32 and 2^64 wraps
    err_e = 0
    for n_lane, nbk in ((n_core, 1), (256, 40)):
        keys_np = rng.integers(0, 256, (n_lane, 32), dtype=np.uint8)
        nonces = rng.integers(0, 1 << 64, n_lane, dtype=np.uint64)
        nonces[:3] = [(1 << 64) - 17, (1 << 32) - 9, (1 << 64) - 1]
        halves = nonces.view(np.uint32).reshape(n_lane, 2)
        nlo = from_np_u32(np.ascontiguousarray(halves[:, 0]), dev)
        nhi = from_np_u32(np.ascontiguousarray(halves[:, 1]), dev)
        rk = aes_ctr.round_keys(torch.from_numpy(keys_np).to(dev))
        got = aes_ctr.aes_ctr_keystream_rk_cuda(rk, nlo, nhi, nbk)
        want = aes_ctr.aes_ctr_keystream_rk_plain(rk, nlo, nhi, nbk)
        e = max_abs_err(torch, got, want)
        assert e == 0 and torch.equal(got, want), f"kernel E differs from its twin: {e}"
        err_e = max(err_e, e)
        w = got[:4].cpu().numpy().view(np.uint32).astype(np.uint64)
        for n in range(4):
            oracle = aes.AesCtr256(bytes(keys_np[n]), int(nonces[n])).fill_u64(2 * nbk)
            mine = [int(x) for x in (w[n, :, 0::2] | (w[n, :, 1::2] << np.uint64(32))).reshape(-1)]
            assert mine == oracle, f"kernel E lane {n} differs from the scalar AES oracle"
        if nbk == 1:
            ms = cuda_ms(torch, lambda: aes_ctr.aes_ctr_keystream_rk_cuda(rk, nlo, nhi, 1), 20)
            plain = cuda_ms(torch, lambda: aes_ctr.aes_ctr_keystream_rk_plain(rk, nlo, nhi, 1), 2)
            say(f"[kernel E aes_ctr_rk] {n_lane} lanes x 1 block: bit-exact vs twin and "
                f"oracle; kernel {ms:.3f} ms, twin {plain:.3f} ms")
        else:
            say(f"[kernel E aes_ctr_rk] {n_lane} lanes x {nbk} blocks across the 2^32 "
                f"and 2^64 counter wraps: bit-exact vs twin and oracle")
    report["aes_ctr_rk"] = dict(max_abs_err=err_e, ms=ms, plain_ms=plain)
    del blocks, fields, got, want, rk

    # 4. default goldens, and the port's product of two of them
    g = os.path.join(ROOT, "tests", "golden", "default")
    gpk = pv.load_pklite(os.path.join(g, "pklite.bin"), with_H=True)
    gsk = pv.load_sk(os.path.join(g, "sk.bin"))
    pv.enable_device(gpk, gsk, "cuda")
    gcts = {}
    for name, want_v in (("a", 42), ("b", 17), ("sum", 59)):
        gcts[name] = pv.load_cts(os.path.join(g, f"{name}.ct"))
        v = pv.dec_value_batch(gpk, gsk, gcts[name])
        assert v == [want_v], f"golden {name}: got {v}, want {want_v}"
    gprod = pv.ct_mul(gpk, gcts["a"][0], gcts["b"][0])
    assert pv.dec_value_batch(gpk, gsk, [gprod]) == [714], "golden a x b does not decrypt to 714"
    say(f"[goldens] default a/b/sum decrypt on the card to 42/17/59; the port's "
        f"ct_mul of a x b ({gprod.n_layers} layers, {gprod.n_edges} edges) decrypts to 714")
    pv.disable_device(gpk)

    # 5. keygen; PRF cores keyed on the card against host-keyed cores
    t0 = time.time()
    pk, sk = pv.keygen(prm)
    keygen_s = time.time() - t0
    eng = pv.enable_device(pk, sk, "cuda")
    seeds = rng.integers(0, 1 << 64, (4096, 3), dtype=np.uint64)
    doms = [lpn.DOM_HASH[d] for d in (pv.Dom.PRF_R1, pv.Dom.PRF_R2, pv.Dom.PRF_NOISE3)]
    dh = np.array(doms, dtype=np.uint64)[np.arange(4096) % 3]
    r_dev, rej_dev = eng.prf_cores_async_seeds(seeds, dh)
    hkeys, hnonces = lpn.derive_keys_batch(pk, sk, seeds, dh)
    tkeys, tbase = lpn.derive_keys_batch(pk, sk, seeds,
                                         np.full(4096, lpn.DOM_HASH[pv.Dom.TOEP], np.uint64))
    r_host, rej_host = lpn.prf_cores_tensors(prm, hkeys, hnonces, tkeys, tbase ^ dh,
                                             eng.s32_dev, eng.PRF_CHUNK)
    assert torch.equal(r_dev, r_host) and torch.equal(rej_dev, rej_host), \
        "PRF cores keyed on the card differ from host-keyed cores"
    say(f"[prf] keygen {keygen_s:.2f} s; 4096 PRF cores keyed on the card (kernel D) "
        f"equal the host-keyed cores")
    del r_dev, rej_dev, r_host, rej_host

    def drive(label, fn):
        """Run one main path with launch counts and engine stats from 0."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        eng.stats = dict.fromkeys(eng.stats, 0)
        kernels.reset_launches()
        out = fn()
        eng.drain()
        counts = dict(kernels.LAUNCHES)
        for k, n in counts.items():
            assert n > 0, f"kernel {k} was not launched on the {label} path"
        return out, counts, torch.cuda.max_memory_allocated(), dict(eng.stats)

    # 6. slice 1: enc 4096 -> add 2048 -> dec 6144
    values = [int(v) for v in rng.integers(0, 1 << 64, 4096, dtype=np.uint64)]
    times = {}

    def slice1():
        t0 = time.time()
        cts = pv.enc_value_batch(pk, sk, values)
        eng.drain()
        times["enc"] = time.time() - t0
        sums = pv.ct_add_batch(pk, [(cts[2 * i], cts[2 * i + 1]) for i in range(2048)])
        t0 = time.time()
        dec = pv.dec_value_batch(pk, sk, cts + sums)
        eng.drain()
        times["dec"] = time.time() - t0
        return cts, sums, dec

    (cts, sums, dec), launches1, peak, stats = drive("slice-1", slice1)
    want_dec = values + [(values[2 * i] + values[2 * i + 1]) % pv.P for i in range(2048)]
    bad = sum(a != b for a, b in zip(dec, want_dec))
    assert len(dec) == 6144 and bad == 0, f"{bad} of {len(dec)} ciphertexts decrypt wrong"
    say(f"[slice 1] enc 4096 values in {times['enc']:.3f} s ({4096 / times['enc']:.1f} ct/s); "
        f"dec 6144 ciphertexts in {times['dec']:.3f} s ({6144 / times['dec']:.1f} ct/s); all exact")
    say(f"[slice 1] PRF cores {stats['prf_cores']}, sigma edges {stats['sigma_edges']}, "
        f"peak device memory {peak / 2**20:.1f} MiB, launches {launches1}")

    # σ rows of the main path's program against the scalar reference
    sel = rng.integers(0, 1 << 64, (64, 7), dtype=np.uint64)
    sel[:, 4] %= np.uint64(prm.B)
    sel[:, 5] &= np.uint64(1)
    rows = matrix.sigma_words(pk, *(sel[:, j] for j in range(1, 7)))
    for e in range(64):
        ref = matrix._scalar_sigma_row(pk, prm, [pk.canon_tag, *sel[e, 1:]])
        assert np.array_equal(rows[e], ref), f"sigma row {e} differs from the scalar path"
    say("[slice 1] 64 sigma rows on the card equal the scalar reference")

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "rt.ct")
        sub = cts[:8] + sums[:8]
        pv.save_cts(sub, path)
        back = pv.load_cts(path)
        pv.save_cts(back, path + "2")
        with open(path, "rb") as f1, open(path + "2", "rb") as f2:
            assert f1.read() == f2.read(), ".ct round trip is not byte-exact"
        assert pv.dec_value_batch(pk, sk, back) == want_dec[:8] + want_dec[4096:4104]
    say("[slice 1] .ct save/load round trip byte-exact; 16 reloaded ciphertexts decrypt")
    del cts, sums, dec

    # 7. slice 2, BASELINE config 2: enc 2048 -> mul 1024 -> sub 512 -> dec 1536
    vals2 = [int(v) for v in rng.integers(0, 1 << 64, 2048, dtype=np.uint64)]

    def slice2():
        t0 = time.time()
        cts = pv.enc_value_batch(pk, sk, vals2)
        eng.drain()
        times["enc2"] = time.time() - t0
        t0 = time.time()
        prods = pv.ct_mul_batch(pk, [(cts[2 * i], cts[2 * i + 1]) for i in range(1024)])
        eng.drain()
        times["mul"] = time.time() - t0
        t0 = time.time()
        diffs = pv.ct_sub_batch(pk, [(prods[2 * i], prods[2 * i + 1]) for i in range(512)])
        times["sub"] = time.time() - t0
        t0 = time.time()
        dec = pv.dec_value_batch(pk, sk, prods + diffs)
        eng.drain()
        times["dec2"] = time.time() - t0
        return prods, diffs, dec

    (prods, diffs, dec), launches, peak, stats = drive("config-2", slice2)
    pw = [vals2[2 * i] * vals2[2 * i + 1] % pv.P for i in range(1024)]
    want2 = pw + [(pw[2 * i] - pw[2 * i + 1]) % pv.P for i in range(512)]
    bad = sum(a != b for a, b in zip(dec, want2))
    assert len(dec) == 1536 and bad == 0, f"{bad} of {len(dec)} config-2 results decrypt wrong"
    edges = [C.n_edges for C in prods]
    say(f"[config 2] enc 2048 values in {times['enc2']:.3f} s; ct_mul 1024 pairs in "
        f"{times['mul']:.3f} s ({1024 / times['mul']:.1f} ops/s; {min(edges)}..{max(edges)} "
        f"edges, {prods[0].n_layers} layers per product); ct_sub 512 pairs in "
        f"{times['sub']:.3f} s; dec 1536 results in {times['dec2']:.3f} s "
        f"({1536 / times['dec2']:.1f} ct/s); all exact")
    say(f"[config 2] PRF cores {stats['prf_cores']}, sigma edges {stats['sigma_edges']}, "
        f"peak device memory {peak / 2**20:.1f} MiB, launches {launches}")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "c2.ct")
        pv.save_cts(prods[:4] + diffs[:4], path)
        back = pv.load_cts(path)
        assert pv.dec_value_batch(pk, sk, back) == want2[:4] + want2[1024:1028]
    say("[config 2] 4 products and 4 differences reloaded from .ct decrypt exactly")

    src = {"aes_ctr": ("kernels/aes_ctr.cu", "pvac_hfhe_cppbyv_tpu/crypto/aes_fused.py:95"),
           "sha256_ctr": ("kernels/sha256_ctr.cu", "pvac_hfhe_cppbyv_tpu/crypto/sha256_pallas.py:173"),
           "sigma": ("kernels/sigma.cu", "pvac_hfhe_cppbyv_tpu/crypto/onehot_pallas.py:37"),
           "sha256_blocks": ("kernels/sha256_blocks.cu",
                             "pvac_hfhe_cppbyv_tpu/crypto/sha256_pallas.py:69"),
           "aes_ctr_rk": ("kernels/aes_ctr_rk.cu", "pvac_hfhe_cppbyv_tpu/crypto/aes_pallas.py:124")}
    # launches: the config-2 path's count; launches_slice1: the slice-1 path's
    rows_out = [dict(name=k, route="cuda", source="pvac_hfhe_cppbyv_tpu_torch/" + src[k][0],
                     replaces=src[k][1], launches=launches[k],
                     launches_slice1=launches1[k], **report[k]) for k in src]
    say(smi)  # the card and its power limit, as nvidia-smi prints them
    say(json.dumps({"kernels": rows_out}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
