#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card.  Phases,
each printing its own line; any failure raises and exits non-zero:

1. the card (nvidia-smi name and power limit), torch and CUDA versions;
2. build the five CUDA kernels from the checkout's sources (nvcc, sm_90a,
   one process per source, in parallel);
3. each kernel against its plain torch twin on the card at the shapes the
   main paths give it, bit-exact, with both times (CUDA events): A (the
   LPN bits of PRF cores from raw AES keys), B (σ draws to taken
   indices, also on the dense test params where windows run short), C
   (σ rows), D (SHA-256 of the PRF key-derivation messages), E (PRF
   cores from Toeplitz keys and LPN bits); A, B and E also against the
   scalar reference; the PRF pass and the σ pass with their wall time,
   device time, kernel count and peak memory;
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
   a*b and a1*b1 - a2*b2 mod p, and a .ct round trip of some of them;
8. the depth sweep, BASELINE config 4 at default Params: enc_value of a
   seeded u64 v, then four squarings with ct_mul, each step decrypted
   with dec_value and checked against v^(2^k) mod p.  Step 3 stages
   through the native host aggregator; step 4 (about 44 M edges) runs
   through the dense grid on the card and keeps a VirtualSigma.  Then
   the step-3 product staged on the card's grid against the host
   aggregator, and 4096 rows of step 4's virtual σ generated on the card
   against eager σ and the scalar reference;
9. recrypt, text and commit on the default goldens: make_evalkey +
   ct_recrypt of sum.ct decrypts to 59, recrypt_sum.ct to 59, text.ct to
   "hello pvac on tpu!";
10. the service path at default Params: Client.generate on the card
   writes pk.bin, pklite.bin, sk.bin and params.json and makes an
   EvalKey; an Evaluator loads pk.bin into an engine of its own that
   holds no secret key and runs the circuits (dot_product of 1024 pairs,
   matvec of 8 rows over 1024 ciphertexts, mean_and_scaled_variance of
   32, eval_polynomial, power_chain with recrypt, and sub / neg / scale /
   div_const; the client runs fibonacci_chain and factorial_chain), each
   decrypted by the client and checked exactly; the CLI as subprocesses
   (keygen, enc of 1024 values and dec, enc / mul / add / dec, enc-text /
   dec-text, inspect); prf_R, prf_R_noise and sigma_from_H on the card
   against a host copy of the key; and op_report.
Kernel launch counts are reset just before and read just after each of
the four main paths (6, 7, 8 and 10); each must launch all five kernels.

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.  Without a CUDA device, or
without the package beside it, the script exits non-zero and prints no
result.  It imports nothing of JAX.
"""
import hashlib
import json
import os
import shutil
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


def peak_mib(torch, fn) -> float:
    """Peak device memory of one call of ``fn`` above what was allocated
    before it, in MiB."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    del out
    return (torch.cuda.max_memory_allocated() - base) / 2**20


def max_abs_err(torch, a, b) -> int:
    """Largest |a - b| over u32 values held as int32 bit patterns."""
    d = (a.to(torch.int64) & 0xFFFFFFFF) - (b.to(torch.int64) & 0xFFFFFFFF)
    return int(d.abs().max().item()) if d.numel() else 0


# Squarings of the depth sweep (BASELINE config 4; reference
# tests/test_depth.cpp).  Step 4 is where the grid and the virtual σ run.
DEPTH_STEPS = 4


class StageClock:
    """Wall seconds of ct_mul's stages for one product, taken by wrapping
    the functions ops.arithmetic looks up when ct_mul runs.

    stage_start holds mul_layers (the PROD layer grid and its seeds),
    agg_slots and grid_dispatch (queueing the grid's blocks); device_wait
    is the wait for the card at the start of the staging's finalize;
    stage_finalize is the host aggregation, or the grid's fetch of nonzero
    buckets and their assembly; compact_edges is guard_budget's.  With a
    card, grid_device_span is the time on the card from the first grid
    block's start to the last one's end (CUDA events)."""

    WRAPPED = (("_mul_layers", "mul_layers"), ("_agg_slots", "agg_slots"),
               ("guard_budget", "compact_edges"), ("compact_layers", "compact_layers"))

    def __init__(self, torch, arith, eng):
        self.torch, self.arith, self.eng = torch, arith, eng
        self.split = dict.fromkeys(("stage_start", "mul_layers", "agg_slots", "grid_dispatch",
                                    "device_wait", "stage_finalize", "compact_edges",
                                    "compact_layers"), 0.0)
        self.events = []
        self._saved = {}

    def _timed(self, fn, key):
        def run(*a):
            t0 = time.time()
            out = fn(*a)
            self.split[key] += time.time() - t0
            return out
        return run

    def __enter__(self):
        arith, torch, split = self.arith, self.torch, self.split
        names = [n for n, _ in self.WRAPPED] + ["_ct_mul_stage_start"]
        self._saved = {n: getattr(arith, n) for n in names}
        for name, key in self.WRAPPED:
            setattr(arith, name, self._timed(self._saved[name], key))
        start = self._saved["_ct_mul_stage_start"]

        def stage_start(*a):
            t0 = time.time()
            fin = start(*a)
            split["stage_start"] += time.time() - t0

            def finalize():
                t0 = time.time()
                torch.cuda.synchronize()
                t1 = time.time()
                out = fin()
                split["device_wait"] += t1 - t0
                split["stage_finalize"] += time.time() - t1
                return out
            return finalize

        grid_start = self.eng.mulgrid.start
        events = self.events

        def grid_block(*a):
            if torch.cuda.is_available() and not events:
                events.append(torch.cuda.Event(enable_timing=True))
                events[0].record()
            fin = self._timed(grid_start, "grid_dispatch")(*a)
            if torch.cuda.is_available():
                events[1:] = [torch.cuda.Event(enable_timing=True)]
                events[1].record()
            return fin

        arith._ct_mul_stage_start = stage_start
        self.eng.mulgrid.start = grid_block
        return self

    def __exit__(self, *exc):
        for name, fn in self._saved.items():
            setattr(self.arith, name, fn)
        del self.eng.mulgrid.start
        if len(self.events) == 2:
            self.torch.cuda.synchronize()
            self.split["grid_device_span"] = self.events[0].elapsed_time(self.events[1]) / 1e3


def depth_sweep(pv, torch, pk, sk, eng, v: int, times: dict):
    """enc_value(v), then DEPTH_STEPS squarings, each decrypted and checked;
    returns the ciphertexts of every step (index 0: the fresh one)."""
    from pvac_hfhe_cppbyv_tpu_torch import native
    from pvac_hfhe_cppbyv_tpu_torch.ops import arithmetic as arith

    cts = [pv.enc_value(pk, sk, v)]
    want = v % pv.P
    assert pv.dec_value(pk, sk, cts[0]) == want, "the fresh ciphertext does not decrypt"
    for k in range(1, DEPTH_STEPS + 1):
        c = cts[-1]
        npairs = c.n_edges * c.n_edges
        blocks0 = eng.stats["mulgrid_blocks"]
        clock = StageClock(torch, arith, eng)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        with clock:
            sq = pv.ct_mul(pk, c, c)
            eng.drain()
        mul_s = time.time() - t0
        want = want * want % pv.P
        t0 = time.time()
        got = pv.dec_value(pk, sk, sq)
        dec_s = time.time() - t0
        assert got == want, f"depth step {k}: got {got}, want v^(2^{k}) = {want}"
        blocks = eng.stats["mulgrid_blocks"] - blocks0
        virtual = isinstance(sq.sigma, pv.VirtualSigma)
        if k == 1:
            assert pv.check_mul_gsum_all(pk, c, c, sq), "step 1 breaks the layer g-sum invariant"
        if k == 3:
            assert blocks == 0 and native.lib() is not None and arith._native_agg_viable(
                c.n_layers, c.n_layers, pk.prm.B, npairs), \
                "step 3 did not stage through the native aggregator"
        if k == 4:
            assert blocks > 0, "step 4 ran no grid block on the card"
            assert virtual, "step 4's sigma is not a VirtualSigma"
        t0 = time.time()
        dens = sq.sigma.density_sample() if virtual else pv.sigma_density(pk, sq)
        dens_s = time.time() - t0
        peak = torch.cuda.max_memory_allocated()
        times[k] = dict(edges=sq.n_edges, layers=sq.n_layers, pairs=npairs,
                        sigma="virtual" if virtual else "eager", density=dens,
                        density_s=dens_s, mul_s=mul_s, dec_s=dec_s, grid_blocks=blocks,
                        peak=peak, split=dict(clock.split))
        say(f"[depth] step {k}: edges {sq.n_edges}, layers {sq.n_layers}, sigma "
            f"{'virtual' if virtual else 'eager'}, density {dens:.6f} "
            f"({'16384-row sample' if virtual else 'exact'}), mul {mul_s:.3f} s, "
            f"dec {dec_s:.3f} s, grid blocks {blocks}, peak device memory "
            f"{peak / 2**20:.1f} MiB; decrypts to v^(2^{k}) mod p")
        cts.append(sq)
    return cts


def depth_checks(pv, torch, pk, sk, eng, cts, rng) -> None:
    """The card's grid against the host aggregator on the step-3 product,
    and step 4's virtual σ generated on the card against eager σ."""
    from pvac_hfhe_cppbyv_tpu_torch.crypto import matrix
    from pvac_hfhe_cppbyv_tpu_torch.ops import arithmetic as arith

    c2 = cts[2]
    layers, base = arith._mul_layers(pk, c2, c2)
    t0 = time.time()
    dev = arith._stage_device(pk, eng, c2, c2, layers, base)()
    grid_s = time.time() - t0
    t0 = time.time()
    host = arith._ct_mul_stage_host(pk, layers, base, c2, c2)
    host_s = time.time() - t0
    cols = ("out_lid", "out_idx", "out_ch", "out_w")
    order = [np.lexsort((s["out_ch"], s["out_idx"], s["out_lid"])) for s in (dev, host)]
    for k in cols:
        assert np.array_equal(dev[k][order[0]], host[k][order[1]]), \
            f"grid and native aggregator differ in {k} on the step-3 product"
    say(f"[depth] step-3 product staged on the card's grid ({grid_s:.3f} s) equals the "
        f"native aggregator's ({host_s:.3f} s): {len(dev['out_lid'])} edges in canonical order")

    vs = cts[4].sigma
    rows = np.sort(rng.choice(len(vs), 4096, replace=False))
    t0 = time.time()
    got = vs.materialize(rows)
    mat_s = time.time() - t0
    sub = vs[rows]
    trip = sub.ltab[(sub.packed >> np.uint32(11)).astype(np.int64)]
    idx = ((sub.packed >> np.uint32(1)) & np.uint32(0x3FF)).astype(np.uint64)
    ch = (sub.packed & np.uint32(1)).astype(np.uint64)
    want = matrix.sigma_words(pk, trip[:, 0], trip[:, 1], trip[:, 2], idx, ch, sub.salt)
    assert np.array_equal(got, want), "virtual sigma rows differ from eager sigma"
    for e in range(8):
        ref = matrix._scalar_sigma_row(
            pk, pk.prm, [pk.canon_tag, *trip[e], idx[e], ch[e], sub.salt[e]])
        assert np.array_equal(got[e], ref), f"virtual sigma row {e} differs from the scalar path"
    say(f"[depth] 4096 rows of step 4's virtual sigma generated on the card in {mat_s:.3f} s "
        f"equal eager sigma for the same recipe; 8 equal the scalar reference")


def recrypt_text_commit(pv, gdir: str) -> None:
    """Recrypt, the text codec and commit on the default goldens."""
    gpk = pv.load_pklite(os.path.join(gdir, "pklite.bin"), with_H=True)
    gsk = pv.load_sk(os.path.join(gdir, "sk.bin"))
    try:
        (gsum,) = pv.load_cts(os.path.join(gdir, "sum.ct"))
        ek = pv.make_evalkey(gpk, gsk, 2, 1)
        rec = pv.ct_recrypt(gpk, ek, gsum)
        assert pv.dec_value(gpk, gsk, rec) == 59, "recrypt of golden sum does not decrypt to 59"
        assert pv.dec_value_batch(gpk, gsk, pv.load_cts(
            os.path.join(gdir, "recrypt_sum.ct"))) == [59], "golden recrypt_sum is not 59"
        text = pv.dec_text(gpk, gsk, pv.load_cts(os.path.join(gdir, "text.ct")))
        assert text == "hello pvac on tpu!", f"golden text decodes to {text!r}"
        mine = pv.enc_text(gpk, gsk, "depth sweep on the card")
        assert pv.dec_text(gpk, gsk, mine) == "depth sweep on the card"
        (ga,) = pv.load_cts(os.path.join(gdir, "a.ct"))
        with tempfile.TemporaryDirectory() as tmp:
            pv.save_cts([ga], os.path.join(tmp, "a.ct"))
            (back,) = pv.load_cts(os.path.join(tmp, "a.ct"))
        commit = pv.commit_ct(gpk, ga)
        assert commit == pv.commit_ct(gpk, back) != pv.commit_ct(gpk, gsum), \
            "commit_ct is not a deterministic, distinguishing digest"
    finally:
        pv.disable_device(gpk)
    say(f"[recrypt] make_evalkey + ct_recrypt of golden sum decrypts to 59 "
        f"({rec.n_edges} edges); golden recrypt_sum decrypts to 59; golden text decodes "
        f"to {text!r}; enc_text/dec_text round trip; commit_ct(a) {commit.hex()[:16]}...")


# Sizes of the service phase: the encrypted vectors of the dot product
# and of matvec, matvec's public rows, the samples of the variance (its
# final product grows as their square) and op_report's batch.
SERVICE_N = 1024
SERVICE_ROWS = 8
SERVICE_SAMPLES = 32
SERVICE_OP_BATCH = 256


def run_cli(waves, env, cwd, timeout=600) -> list:
    """Run each wave of CLI commands as subprocesses, the commands of a
    wave all at once; returns every command's standard output in order.
    Raises if one exits non-zero; stops every process it started."""
    outs = []
    for wave in waves:
        procs = [subprocess.Popen([sys.executable, "-m", "pvac_hfhe_cppbyv_tpu_torch",
                                   *map(str, args)], cwd=cwd, env=env, text=True,
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE)
                 for args in wave]
        try:
            res = [p.communicate(timeout=timeout) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for args, p, (out, err) in zip(wave, procs, res):
            assert p.returncode == 0, f"CLI {args[0]} exited {p.returncode}: {err[-2000:]}"
            outs.append(out)
    return outs


def service_path(pv, torch, rng, prm, device="cuda", n=SERVICE_N) -> dict:
    """Phase 10: the Client / Evaluator split, the circuits, the CLI, the
    scalar API and op_report.  A client made by Client.generate writes
    pk.bin, pklite.bin, sk.bin and params.json; an evaluator loads pk.bin
    into its own engine, which holds no secret key, and runs the circuits;
    the client decrypts every result, checked exactly mod p.  Then the CLI
    as subprocesses on a KEYDIR of its own, prf_R / prf_R_noise /
    sigma_from_H on the card against a host copy of the key, and
    op_report.  With ``device="cpu"`` (a rehearsal) CPU engines stand in
    for the card's and the CLI runs with --device cpu."""
    import dataclasses

    from pvac_hfhe_cppbyv_tpu_torch.crypto import shactr
    from pvac_hfhe_cppbyv_tpu_torch.models import circuits as C
    from pvac_hfhe_cppbyv_tpu_torch.utils.profiling import op_report

    P = pv.P
    wall = {}

    def timed(name, fn):
        t0 = time.time()
        out = fn()
        wall[name] = time.time() - t0
        return out

    def attach(pk, sk=None):
        if device == "cpu":
            pv.enable_device(pk, sk, "cpu")
        return pk._engine

    tmp = tempfile.mkdtemp(prefix="pvac_service_")
    try:
        # the client, and the files it hands out
        client = timed("keygen", lambda: pv.Client.generate(prm, device=device))
        c_eng = attach(client.pk, client.sk)
        files = {k: os.path.join(tmp, k) for k in ("pk.bin", "pklite.bin", "sk.bin",
                                                     "params.json")}
        pv.save_pk(client.pk, files["pk.bin"])
        pv.save_pklite(client.pk, files["pklite.bin"])
        pv.save_sk(client.sk, files["sk.bin"])
        pv.save_params(prm, files["params.json"])
        ek = timed("evaluation_key", lambda: client.evaluation_key(pool_size=8, depth_hint=1))

        # the evaluator: pk.bin alone, in an engine of its own
        pk_e = timed("load_pk", lambda: pv.load_pk(files["pk.bin"], device=device))
        if prm != pv.Params():
            # pk.bin stores no n_bits or column weights: outside the
            # defaults they come from the client's Params
            pk_e.prm = dataclasses.replace(prm)
        e_eng = attach(pk_e)
        ev = pv.Evaluator(pk_e, ek)
        a, b = pk_e, client.pk
        assert e_eng is not c_eng and e_eng.sk is None and e_eng.s32_dev is None
        assert (a.prm, a.canon_tag, a.H_digest, a.omega_B, a.powg_B) == \
            (b.prm, b.canon_tag, b.H_digest, b.omega_B, b.powg_B), "pk.bin loads other fields"
        assert np.array_equal(a.H, b.H) and np.array_equal(a.ubk.perm, b.ubk.perm) and \
            np.array_equal(a.ubk.inv, b.ubk.inv), "pk.bin loads another H or ubk"
        if device != "cpu":
            assert e_eng.device.type == "cuda" and e_eng.H_dev is not None

        # the circuits on the evaluator's key, decrypted by the client
        xv = [int(v) for v in rng.integers(0, 1 << 32, n, dtype=np.uint64)]
        yv = [int(v) for v in rng.integers(0, 1 << 32, n, dtype=np.uint64)]
        cts = timed("encrypt", lambda: client.encrypt(xv + yv))
        xs, ys = cts[:n], cts[n:]
        rows = rng.integers(0, 1 << 16, (SERVICE_ROWS, n), dtype=np.int64).tolist()
        sv = [int(v) for v in rng.integers(0, 1 << 32, SERVICE_SAMPLES, dtype=np.uint64)]
        s_cts = client.encrypt(sv)
        x0, p0, q0 = (int(v) for v in rng.integers(1, 1 << 63, 3, dtype=np.uint64))
        xc, pc, qc = client.encrypt([x0, p0, q0])
        got = {
            "dot_product": timed("dot_product", lambda: C.dot_product(pk_e, xs, ys)),
            "matvec": timed("matvec", lambda: C.matvec(pk_e, xs, rows)),
            "mean_and_scaled_variance": timed(
                "mean_and_scaled_variance", lambda: C.mean_and_scaled_variance(pk_e, s_cts)),
            "eval_polynomial": timed("eval_polynomial", lambda: C.eval_polynomial(
                pk_e, [7, 0, 3, 2], xc, lambda v: client.encrypt(v)[0])),
            "power_chain": timed("power_chain", lambda: C.power_chain(pk_e, xc, 5, ek)),
            "fibonacci_chain": timed("fibonacci_chain",
                                     lambda: C.fibonacci_chain(client.pk, client.sk, 20)),
            "factorial_chain": timed("factorial_chain",
                                     lambda: C.factorial_chain(client.pk, client.sk, 12)),
            "evaluator_ops": timed("evaluator_ops", lambda: [
                ev.sub(pc, qc), ev.neg(pc), ev.scale(pc, 1000003), ev.div_const(pc, 7)]),
        }
        s = sum(sv)
        want = {
            "dot_product": [sum(x * y for x, y in zip(xv, yv)) % P],
            "matvec": [sum(w * x for w, x in zip(r, xv)) % P for r in rows],
            "mean_and_scaled_variance": [s % P, (SERVICE_SAMPLES * sum(v * v for v in sv)
                                                 - s * s) % P],
            "eval_polynomial": [(7 + 3 * x0 ** 2 + 2 * x0 ** 3) % P],
            "power_chain": [pow(x0, 5, P)],
            "fibonacci_chain": [6765],
            "factorial_chain": [479001600],
            "evaluator_ops": [(p0 - q0) % P, (-p0) % P, p0 * 1000003 % P,
                              p0 * pow(7, -1, P) % P],
        }
        t0 = time.time()
        for name, out in got.items():
            out = list(out) if isinstance(out, (list, tuple)) else [out]
            dec = client.decrypt(out)
            assert dec == want[name], f"{name}: decrypts to {dec}, want {want[name]}"
        wall["decrypt"] = time.time() - t0
        assert e_eng.sk is None and e_eng.s32_dev is None, "the evaluator's engine bound a key"
        assert e_eng.stats["sigma_edges"] > 0 and e_eng.stats["prf_cores"] == 0

        # the CLI as subprocesses, on a KEYDIR of its own
        env = dict(os.environ, OMP_NUM_THREADS="2",
                   PYTHONPATH=os.pathsep.join(
                       p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
        flags = ["--device", "cpu"] if device == "cpu" else []
        small = ["--small"] if prm == pv.small_test_params() else []
        kd = os.path.join(tmp, "keys")
        vals = [int(v) for v in rng.integers(0, 1 << 64, n, dtype=np.uint64)]
        msg = "".join(chr(97 + int(c)) for c in rng.integers(0, 26, 200))
        t0 = time.time()
        outs = run_cli([
            [[*flags, "keygen", kd, *small]],
            [[*flags, "enc", kd, *vals, "-o", "v.ct"], [*flags, "enc", kd, 6, "-o", "a.ct"],
             [*flags, "enc", kd, 7, "-o", "b.ct"], [*flags, "enc-text", kd, msg, "-o", "t.ct"]],
            [[*flags, "dec", kd, "v.ct"], [*flags, "mul", kd, "a.ct", "b.ct", "-o", "p.ct"],
             [*flags, "add", kd, "a.ct", "b.ct", "-o", "s.ct"], [*flags, "dec-text", kd, "t.ct"],
             ["inspect", "v.ct"]],
            [[*flags, "dec", kd, "p.ct"], [*flags, "dec", kd, "s.ct"]],
        ], env, tmp)
        wall["cli"] = time.time() - t0
        dec_v = [int(t) for t in outs[5].split()]
        assert dec_v[0::2] == vals and not any(dec_v[1::2]), "CLI dec of 1024 values differs"
        assert outs[8] == msg + "\n", "CLI dec-text differs"
        assert f"{n} cipher(s)" in outs[9], "CLI inspect"
        assert outs[10].split() == ["42", "0"] and outs[11].split() == ["13", "0"], \
            f"CLI mul / add: {outs[10]!r} {outs[11]!r}"
        kpk = pv.load_pklite(os.path.join(kd, "pklite.bin"), device=device)
        ksk = pv.load_sk(os.path.join(kd, "sk.bin"))
        attach(kpk)
        assert pv.dec_value_batch(kpk, ksk, pv.load_cts(os.path.join(tmp, "p.ct"))) == [42]
        pv.disable_device(kpk)

        # the scalar API: the client's key on the card against a host copy
        c = client.pk
        pkf = dict(prm=dataclasses.asdict(c.prm), canon_tag=c.canon_tag, H=c.H,
                   ubk_perm=c.ubk.perm, ubk_inv=c.ubk.inv, H_digest=c.H_digest,
                   omega_B=c.omega_B, powg_B=c.powg_B)
        hpk, hsk = pv.keys_from_numpy(pkf, dict(prf_k=client.sk.prf_k,
                                                lpn_s_bits=client.sk.lpn_s_bits), device="cpu")
        seeds = rng.integers(0, 1 << 64, (8, 3), dtype=np.uint64)
        rs = [pv.RSeed(int(z), pv.Nonce128(int(lo), int(hi))) for z, lo, hi in seeds]
        t0 = time.time()
        for noise, fn in ((False, pv.prf_R), (True, pv.prf_R_noise)):
            card = [fn(client.pk, client.sk, r) for r in rs]
            host = [fn(hpk, hsk, r) for r in rs]
            batch = pv.fieldv.to_ints(pv.prf_R_batch(client.pk, client.sk, seeds, noise=noise))
            assert card == host == batch and all(0 < v < P for v in card), \
                f"{fn.__name__} on the card differs from the host"
        edges = rng.integers(0, 1 << 64, (8, 4), dtype=np.uint64)
        for e, (z, lo, hi, salt) in enumerate(edges):
            args = (int(z), pv.Nonce128(int(lo), int(hi)), e % prm.B, e % 2, int(salt))
            assert np.array_equal(pv.sigma_from_H(client.pk, *args), pv.sigma_from_H(hpk, *args)), \
                f"sigma_from_H edge {e} on the card differs from the host"
        for k, N, label in ((prm.x_col_wt, prm.n_bits, pv.Dom.X_SEED),
                            (prm.err_wt, prm.m_bits, pv.Dom.NOISE)):
            w = [int(v) for v in rng.integers(0, 1 << 64, 7, dtype=np.uint64)]
            assert pv.prg_choose_k(k, N, label, w) == shactr.choose_k_scalar(k, N, label, w)
        wall["scalar_api"] = time.time() - t0

        ops = op_report(client.pk, client.sk, batch=min(SERVICE_OP_BATCH, n))
        stats = {"client": dict(c_eng.stats), "evaluator": dict(e_eng.stats)}
        return dict(wall=wall, ops=ops, stats=stats)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# Peak rates of one H100 SXM at its 1.98 GHz boost clock: device memory
# from NVIDIA's data sheet; 32-bit integer instructions (64 INT32 lanes per
# SM) and 4-byte shared-memory loads (32 banks per SM) over its 132 SMs.
HBM_BYTES_S = 3.35e12
INT_OPS_S = 132 * 64 * 1.98e9
SHARED_LOADS_S = 132 * 32 * 1.98e9
# Work counts.  An AES-256 block by T-tables: 224 table loads and about 560
# integer instructions (13 rounds of 16 byte extracts, rotations and XORs,
# then the S-box round); folding its two stream words into the LPN bits:
# about 16 more (AND, popcount, XOR, bit select).  The AES-256 key
# schedule: 52 table loads (13 S-box words) and about 360 instructions.
# The 127-bit GF(2) product, canonicalisation and zero map of a PRF core:
# about 1350 (127 steps of a mask and 2.5 words' shift, AND and XOR).  A
# SHA-256 compression: about 1450 (64 rounds of about 15, 48 schedule
# steps of about 10).  A σ draw after its compression: about 30 (byte
# swaps, x mod N, the bounded test, the bitmap, match and ballot steps).
AES_TABLE_LOADS = 224
AES_INT_OPS = 560
PARITY_INT_OPS = 16
KEY_SCHEDULE_TABLE_LOADS = 52
KEY_SCHEDULE_INT_OPS = 360
TOEP_CORE_INT_OPS = 1350
SHA_INT_OPS = 1450
DRAW_INT_OPS = 30


def bound(nbytes: float, int_ops: float = 0.0, shared_loads: float = 0.0) -> dict:
    """The least time the card could take for the work: the larger of the
    bytes it must move (each input read once, each output written once)
    over the memory rate and its operations over their peak rate."""
    t = {"HBM bytes": nbytes / HBM_BYTES_S, "int ops": int_ops / INT_OPS_S,
         "shared loads": shared_loads / SHARED_LOADS_S}
    kind = max(t, key=t.get)
    return dict(bound_ms=t[kind] * 1e3,
                bound_by="bytes" if kind == "HBM bytes" else "operations",
                bound_detail=kind)


def cuda_ms_cold(torch, fn, reps: int, flush) -> float:
    """Mean milliseconds per call, each call timed alone right after a
    write of ``flush`` (64 MB) that evicts the 50 MB L2 cache."""
    fn()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(stop)
    return total / reps


def kernel_checks(pv, torch, dev, rng, prm) -> dict:
    """Phase 3: every kernel against its plain twin on the card at the
    shapes the main paths launch it with, bit-exact, with the kernel's time
    (CUDA events over back-to-back calls; where a kernel is shorter than
    its wrapper's host work this is the host's launch rate, so
    ``device_ms`` adds the device time of one call, torch.profiler, L2
    warm), the twin's and the kernel's bound.  Returns one report entry
    per kernel, keyed by its launch counter's name."""
    import dataclasses

    from pvac_hfhe_cppbyv_tpu_torch.core.bits import from_np_u32, u32_to_i32
    from pvac_hfhe_cppbyv_tpu_torch.core.hash import MsgLayout
    from pvac_hfhe_cppbyv_tpu_torch.crypto import (
        aes, lpn, lpn_ybits, matrix, sha256_blocks, sha256_ctr, shactr, sigma_draws,
        sigma_xor, toep_core, toeplitz)
    from pvac_hfhe_cppbyv_tpu_torch.engine import CudaEngine
    from pvac_hfhe_cppbyv_tpu_torch.ops.arithmetic import SIGMA_DISPATCH

    report = {}

    def halves(nonces):
        h = np.ascontiguousarray(nonces, dtype=np.uint64).view(np.uint32).reshape(-1, 2)
        return (from_np_u32(np.ascontiguousarray(h[:, 0]), dev),
                from_np_u32(np.ascontiguousarray(h[:, 1]), dev))

    def same(got, want, what) -> int:
        err = max_abs_err(torch, got, want)
        assert err == 0 and torch.equal(got, want), f"{what} differs from its twin: {err}"
        return err

    def secret(sw):
        return from_np_u32(rng.integers(0, 1 << 32, 2 * sw, dtype=np.uint64).astype(np.uint32), dev)

    def pass_report(fn, reps):
        """Wall ms per call (CUDA events over back-to-back calls), device
        ms and kernel count of one call (torch.profiler), peak MiB."""
        prof = device_profile(torch, fn)
        return dict(wall_ms=cuda_ms(torch, fn, reps), device_ms=prof["device_ms"],
                    kernels=prof["kernels"], peak_mib=peak_mib(torch, fn))

    # 3a. kernel A: one PRF pass of 16384 cores at default Params, 512 cores
    # at lpn_n 320 (a 5-word secret, stride 6), 8 cores of the default
    # goldens' keys against the scalar lpn_make_ybits
    rows, tau = min(127, prm.lpn_t), (prm.lpn_tau_num, prm.lpn_tau_den)
    N = CudaEngine.PRF_CHUNK
    keys = torch.from_numpy(rng.integers(0, 256, (N, 32), dtype=np.uint8)).to(dev)
    nonces = rng.integers(0, 1 << 64, N, dtype=np.uint64)
    nonces[:4] = [(1 << 64) - 5, (1 << 32) - 3, (1 << 64) - 1, 0]
    nlo, nhi = halves(nonces)
    s32 = secret(prm.s_words64)
    a_args = (keys, nlo, nhi, s32, rows, *tau)
    got, want = lpn_ybits.lpn_ybits_cuda(*a_args), lpn_ybits.lpn_ybits_plain(*a_args)
    err = max(same(got[0], want[0], "kernel A y"), same(got[1], want[1], "kernel A rej"))
    y_a = got[0]
    del got, want
    args320 = (keys[:512], nlo[:512], nhi[:512], secret(pv.Params(lpn_n=320).s_words64),
               rows, *tau)
    got, want = lpn_ybits.lpn_ybits_cuda(*args320), lpn_ybits.lpn_ybits_plain(*args320)
    same(got[0], want[0], "kernel A y at lpn_n 320")
    same(got[1], want[1], "kernel A rej at lpn_n 320")
    gdir = os.path.join(ROOT, "tests", "golden", "default")
    gpk = pv.load_pklite(os.path.join(gdir, "pklite.bin"), device="cpu")
    gsk = pv.load_sk(os.path.join(gdir, "sk.bin"))
    seeds = [pv.RSeed(int(a), pv.Nonce128(int(b), int(c)))
             for a, b, c in rng.integers(0, 1 << 64, (8, 3), dtype=np.uint64)]
    kn = [lpn.derive_aes_key(gpk, gsk, sd, pv.Dom.PRF_R1) for sd in seeds]
    k8 = torch.frombuffer(bytearray(b"".join(k for k, _ in kn)), dtype=torch.uint8)
    y8 = lpn_ybits.lpn_ybits_cuda(k8.reshape(8, 32).to(dev), *halves([n for _, n in kn]),
                                  lpn.s32_tensor(gsk, dev), rows, *tau)[0]
    y8_np = y8.cpu().numpy().view(np.uint32)
    ybits8 = []
    for i, sd in enumerate(seeds):
        yb = lpn.lpn_make_ybits(gpk, gsk, sd, pv.Dom.PRF_R1, rows)
        ybits8.append(yb)
        v = (yb[0] | yb[1] << 64) & ((1 << rows) - 1)
        assert [int(w) for w in y8_np[i]] == [(v >> (32 * k)) & 0xFFFFFFFF for k in range(4)], \
            f"kernel A core {i} differs from the scalar lpn_make_ybits"
    ms = cuda_ms(torch, lambda: lpn_ybits.lpn_ybits_cuda(*a_args), 20)
    plain = cuda_ms(torch, lambda: lpn_ybits.lpn_ybits_plain(*a_args), 2)
    nb = lpn_ybits.n_stream_blocks(rows, prm.s_words64)
    report["lpn_ybits"] = dict(
        shape=f"{N} cores x {nb} AES blocks", max_abs_err=err, ms=ms, plain_ms=plain,
        device_ms=device_profile(torch, lambda: lpn_ybits.lpn_ybits_cuda(*a_args))["device_ms"],
        **bound(N * (32 + 8 + 16 + 1) + s32.numel() * 4,
                N * nb * (AES_INT_OPS + PARITY_INT_OPS), N * nb * AES_TABLE_LOADS))
    say(f"[kernel A lpn_ybits] {N} cores x {nb} blocks: bit-exact vs twin, 512 cores at "
        f"lpn_n 320 too, 8 cores vs the scalar lpn_make_ybits; kernel {ms:.3f} ms, twin "
        f"{plain:.3f} ms, bound {report['lpn_ybits']['bound_ms']:.3f} ms")
    del a_args, args320

    # 3b. kernel B: the σ draws of SIGMA_DISPATCH and SIGMA_CHUNK edges at
    # default Params; of 4096 edges of the dense test params, where most
    # windows run short of first occurrences and the lanes are flagged; and
    # of 4096 edges at moduli that are not powers of two, with int32 indices
    words = rng.integers(0, 1 << 64, (CudaEngine.SIGMA_CHUNK, 7), dtype=np.uint64)
    dense = dataclasses.replace(pv.small_test_params(), m_bits=64, n_bits=64, h_col_wt=8,
                                x_col_wt=16, err_wt=48)
    wide = dataclasses.replace(prm, n_bits=40000, m_bits=33000)
    err_b = 0
    for p_name, p, L in (("default", prm, SIGMA_DISPATCH),
                         ("default", prm, CudaEngine.SIGMA_CHUNK), ("dense", dense, 4096),
                         ("wide", wide, 4096)):
        lanes = sha256_ctr.lanes_from_u64(words[:L], dev)
        got = sigma_draws.taken_indices_cuda(p, lanes)
        want = sigma_draws.taken_indices_plain(p, lanes)
        for g, w, what in zip(got, want, ("ridx", "nbit", "fb")):
            err_b = max(err_b, same(g, w, f"kernel B {what} ({p_name}, {L} edges)"))
        n_flag = int(got[2].sum())
        if p_name == "dense":
            assert n_flag > 0, "no dense-params lane was flagged"
            say(f"[kernel B sigma_draws] dense params, {L} edges: ridx, nbit and fb bit-exact "
                f"vs twin, {n_flag} lanes flagged")
            continue
        ridx, nbit = got[0].cpu().numpy(), got[1].cpu().numpy()
        for e in range(8):
            w = [int(x) for x in words[e]]
            assert ridx[e].tolist() == shactr.choose_k_scalar(
                p.x_col_wt, p.n_bits, pv.Dom.X_SEED, w), f"kernel B rows of edge {e}"
            assert [int(b) for b in nbit[e] if b >= 0] == shactr.choose_k_scalar(
                p.err_wt, p.m_bits, pv.Dom.NOISE, w), f"kernel B noise bits of edge {e}"
        del got, want
        if p_name == "wide":
            say(f"[kernel B sigma_draws] n_bits {p.n_bits}, m_bits {p.m_bits}, {L} edges: "
                f"int32 ridx, nbit and fb bit-exact vs twin, 8 edges vs the scalar prg_choose_k")
            continue
        ms = cuda_ms(torch, lambda: sigma_draws.taken_indices_cuda(p, lanes), 20)
        plain = cuda_ms(torch, lambda: sigma_draws.taken_indices_plain(p, lanes), 2)
        D0, D1 = p.x_col_wt + shactr.OVERSHOOT, p.err_wt + shactr.OVERSHOOT
        comps = 2 + (D0 + 3) // 4 + (D1 + 3) // 4  # the midstate once per stream
        ridx_b, nbit_b = (torch.tensor([], dtype=dt).element_size()
                          for dt in sigma_draws.index_dtypes(p))
        b = bound(L * (7 * 8 + ridx_b * p.x_col_wt + nbit_b * D1 + 1),
                  L * (comps * SHA_INT_OPS + (D0 + D1) * DRAW_INT_OPS))
        say(f"[kernel B sigma_draws] {L} edges, {comps} compressions an edge: ridx, nbit and "
            f"fb bit-exact vs twin, {n_flag} flagged, 8 edges vs the scalar prg_choose_k; "
            f"kernel {ms:.3f} ms, twin {plain:.3f} ms, bound {b['bound_ms']:.3f} ms")
        if L == SIGMA_DISPATCH:
            report["sigma_draws"] = dict(
                shape=f"{L} edges x 2 streams x {comps // 2 - 1} refills", max_abs_err=0,
                ms=ms, plain_ms=plain, device_ms=device_profile(
                    torch, lambda: sigma_draws.taken_indices_cuda(p, lanes))["device_ms"], **b)
        else:
            report["sigma_draws"].update(ms_65536=ms, plain_ms_65536=plain,
                                         bound_ms_65536=b["bound_ms"])
    report["sigma_draws"]["max_abs_err"] = err_b

    # 3c. kernel C: SIGMA_DISPATCH and SIGMA_CHUNK edges of real draws
    # against a random 16 MB H, H cold in L2 (B runs between launches on
    # the real path); then the whole σ pass (B and C) at both sizes
    H = rng.integers(0, 1 << 32, (prm.n_bits, prm.sigma_words32), dtype=np.uint64).astype(np.uint32)
    Hx = matrix.hx_tensor(H, dev)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    err_c = 0
    sigma_pass = {}
    for E in (SIGMA_DISPATCH, CudaEngine.SIGMA_CHUNK):
        lanes = sha256_ctr.lanes_from_u64(words[:E], dev)
        ridx, nbit, _ = matrix.taken_indices(prm, lanes)
        err_c = max(err_c, same(sigma_xor.sigma_rows_cuda(Hx, ridx, nbit),
                                sigma_xor.sigma_rows_plain(Hx, ridx, nbit), f"kernel C ({E} edges)"))
        ms = cuda_ms_cold(torch, lambda: sigma_xor.sigma_rows_cuda(Hx, ridx, nbit), 20, flush)
        plain = cuda_ms(torch, lambda: sigma_xor.sigma_rows_plain(Hx, ridx, nbit), 2)
        k, mw = ridx.shape[1], prm.sigma_words32
        n_noise = int((nbit >= 0).sum())
        b = bound(Hx.numel() * 4 + ridx.numel() * ridx.element_size()
                  + nbit.numel() * nbit.element_size() + E * mw * 4, E * k * mw + n_noise)
        say(f"[kernel C sigma] {E} edges x {k} taken rows x {mw} words, H {H.nbytes >> 20} MB "
            f"cold: bit-exact vs twin; kernel {ms:.3f} ms, twin {plain:.3f} ms, bound "
            f"{b['bound_ms']:.3f} ms")
        if E == SIGMA_DISPATCH:
            report["sigma"] = dict(shape=f"{E} edges x {k} rows x {mw} words, H cold",
                                   max_abs_err=0, ms=ms, plain_ms=plain, device_ms=device_profile(
                                       torch, lambda: sigma_xor.sigma_rows_cuda(Hx, ridx, nbit))[
                                       "device_ms"], **b)
        else:
            report["sigma"].update(ms_65536=ms, plain_ms_65536=plain, bound_ms_65536=b["bound_ms"])
        del ridx, nbit
        sigma_pass[E] = pass_report(lambda: matrix.sigma_device(prm, Hx, lanes), 10)
    report["sigma"]["max_abs_err"] = err_c
    del Hx, flush

    # the PRF pass from raw keys (kernels A and E), beside the σ passes
    tkeys = torch.from_numpy(rng.integers(0, 256, (N, 32), dtype=np.uint8)).to(dev)
    tnonces = rng.integers(0, 1 << 64, N, dtype=np.uint64)
    tnonces[:3] = [(1 << 64) - 17, (1 << 32) - 9, (1 << 64) - 1]
    tn = halves(tnonces)
    prf_pass = pass_report(lambda: lpn.prf_cores_device(prm, keys, nlo, nhi, tkeys, *tn, s32), 10)
    report["lpn_ybits"].update(prf_pass_ms=prf_pass["wall_ms"],
                               prf_pass_device_ms=prf_pass["device_ms"],
                               prf_pass_kernels=prf_pass["kernels"],
                               prf_pass_peak_mib=prf_pass["peak_mib"])
    for what, r in ((f"PRF pass, {N} cores from raw keys (A, E)", prf_pass),
                    *((f"sigma pass, {E} edges (B, C)", sigma_pass[E]) for E in sigma_pass)):
        say(f"[pass] {what}: wall {r['wall_ms']:.3f} ms, device {r['device_ms']} ms in "
            f"{r['kernels']} kernels, peak device memory {r['peak_mib']:.2f} MiB above its inputs")
    report["sigma_draws"].update(
        **{f"sigma_pass_{k}_{E}": v for E, r in sigma_pass.items() for k, v in r.items()})
    del keys

    # 3d. kernel D: the derivation messages of 16384 PRF cores, main and
    # Toeplitz keys in one launch (2 x 16384 messages of 2 blocks)
    prefix = bytes(rng.integers(0, 256, 72, dtype=np.uint8))  # prf_k||canon||H_digest
    layout = MsgLayout(prefix, 4)
    f64 = rng.integers(0, 1 << 64, (2 * N, 4), dtype=np.uint64)
    f64[N:, :3] = f64[:N, :3]
    f64[N:, 3] = lpn.DOM_HASH[pv.Dom.TOEP]
    fields = torch.from_numpy(f64.view(np.uint32).reshape(-1, 4, 2).astype(np.int64)).to(dev)
    blocks = u32_to_i32(layout.build_blocks(fields, layout.template_tensor(dev))).contiguous()
    got = sha256_blocks.sha256_blocks_cuda(blocks)
    err = same(got, sha256_blocks.sha256_blocks_plain(blocks), "kernel D")
    dg = got.cpu().numpy().view(np.uint32).astype(">u4")
    for i in (0, 1, N, 2 * N - 1):
        want_d = hashlib.sha256(prefix + f64[i].astype("<u8").tobytes()).digest()
        assert dg[i].tobytes() == want_d, f"kernel D message {i} differs from hashlib"
    ms = cuda_ms(torch, lambda: sha256_blocks.sha256_blocks_cuda(blocks), 20)
    plain = cuda_ms(torch, lambda: sha256_blocks.sha256_blocks_plain(blocks), 2)
    nm, nbk = blocks.shape[0], layout.n_blocks
    report["sha256_blocks"] = dict(shape=f"{nm} messages x {nbk} blocks", max_abs_err=err,
                                   ms=ms, plain_ms=plain, device_ms=device_profile(
                                       torch, lambda: sha256_blocks.sha256_blocks_cuda(blocks))[
                                       "device_ms"],
                                   **bound(nm * (nbk * 64 + 32), nm * nbk * SHA_INT_OPS))
    say(f"[kernel D sha256_blocks] {nm} messages x {nbk} blocks: bit-exact vs twin and "
        f"hashlib; kernel {ms:.3f} ms, twin {plain:.3f} ms, bound "
        f"{report['sha256_blocks']['bound_ms']:.4f} ms")
    del blocks, fields, got

    # 3e. kernel E: 16384 PRF cores from Toeplitz keys and kernel A's LPN
    # bits, 64 of them with y = 0; 8 cores of the default goldens' keys
    # against the scalar toep_127 + hash_to_fp_nonzero of 3a's scalar bits
    y_e = y_a.clone()
    y_e[-64:] = 0
    e_args = (tkeys, *tn, y_e)
    got = toep_core.toep_core_cuda(*e_args)
    err_e = same(got, toep_core.toep_core_plain(*e_args), "kernel E")
    assert bool((got[-64:] == torch.tensor([1, 0, 0, 0], device=dev)).all()), \
        "kernel E does not map y = 0 to 1"
    tk = [lpn._toep_key_nonce(gpk, gsk, sd, pv.Dom.PRF_R1) for sd in seeds]
    tk8 = torch.frombuffer(bytearray(b"".join(k for k, _ in tk)), dtype=torch.uint8)
    r8 = toep_core.toep_core_cuda(tk8.reshape(8, 32).to(dev), *halves([n for _, n in tk]), y8)
    r8 = r8.cpu().tolist()
    for i, (key, tnonce) in enumerate(tk):
        lo, hi = toeplitz.toep_127_scalar(aes.AesCtr256(key, tnonce).fill_u64(2), ybits8[i])
        want_v = lpn.hash_to_fp_nonzero(lo, hi)
        assert sum(int(x) << (32 * j) for j, x in enumerate(r8[i])) == want_v, \
            f"kernel E core {i} differs from the scalar toep_127 chain"
    ms = cuda_ms(torch, lambda: toep_core.toep_core_cuda(*e_args), 20)
    plain = cuda_ms(torch, lambda: toep_core.toep_core_plain(*e_args), 2)
    report["toep_core"] = dict(
        shape=f"{N} cores x 1 AES block + 127-bit product", max_abs_err=err_e, ms=ms,
        plain_ms=plain,
        device_ms=device_profile(torch, lambda: toep_core.toep_core_cuda(*e_args))["device_ms"],
        **bound(N * (32 + 8 + 16 + 32),
                N * (AES_INT_OPS + KEY_SCHEDULE_INT_OPS + TOEP_CORE_INT_OPS),
                N * (AES_TABLE_LOADS + KEY_SCHEDULE_TABLE_LOADS)))
    say(f"[kernel E toep_core] {N} cores: bit-exact vs twin, y = 0 gives 1, 8 golden cores "
        f"vs the scalar toep_127 + hash_to_fp_nonzero; kernel {ms:.4f} ms, twin "
        f"{plain:.3f} ms, bound {report['toep_core']['bound_ms']:.4f} ms; device time of one "
        f"call {report['toep_core']['device_ms']} ms")
    del tkeys, e_args, got

    # the floor under any launch: one back-to-back one-element torch add
    one = torch.zeros(1, device=dev)
    launch_ms = cuda_ms(torch, lambda: one.add_(1), 100)
    say(f"[launch] a one-element torch kernel: {launch_ms:.4f} ms per launch")
    for r in report.values():
        r["bound_share"] = r["bound_ms"] / r["ms"]
        r["launch_floor_ms"] = launch_ms
        r["library_ms"] = None  # no single PyTorch call computes these functions
    return report


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import pvac_hfhe_cppbyv_tpu_torch as pv
    from pvac_hfhe_cppbyv_tpu_torch import kernels
    from pvac_hfhe_cppbyv_tpu_torch.crypto import lpn, matrix

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

    # 3. every kernel against its twin at the main path's shapes, timed
    report = kernel_checks(pv, torch, dev, rng, prm)

    # 4. default goldens, and the port's product of two of them; the
    # loaded public key carries an engine on the card, which binds gsk
    g = os.path.join(ROOT, "tests", "golden", "default")
    gpk = pv.load_pklite(os.path.join(g, "pklite.bin"), with_H=True)
    gsk = pv.load_sk(os.path.join(g, "sk.bin"))
    assert gpk._engine.device.type == "cuda" and gpk._engine.sk is None
    gcts = {}
    for name, want_v in (("a", 42), ("b", 17), ("sum", 59)):
        gcts[name] = pv.load_cts(os.path.join(g, f"{name}.ct"))
        v = pv.dec_value_batch(gpk, gsk, gcts[name])
        assert v == [want_v], f"golden {name}: got {v}, want {want_v}"
    gprod = pv.ct_mul(gpk, gcts["a"][0], gcts["b"][0])
    assert pv.dec_value_batch(gpk, gsk, [gprod]) == [714], "golden a x b does not decrypt to 714"
    assert gpk._engine.sk is gsk and gpk._engine.stats["prf_cores"] > 0
    say(f"[goldens] default a/b/sum decrypt on the card to 42/17/59; the port's "
        f"ct_mul of a x b ({gprod.n_layers} layers, {gprod.n_edges} edges) decrypts to 714")
    pv.disable_device(gpk)

    # 5. keygen; PRF cores keyed on the card against host-keyed cores
    t0 = time.time()
    pk, sk = pv.keygen(prm)
    keygen_s = time.time() - t0
    eng = pk._engine  # keygen attaches an engine on the card by default
    assert isinstance(eng, pv.CudaEngine) and eng.device.type == "cuda" and eng.sk is sk
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
    del prods, diffs, dec

    # 8. the depth sweep (BASELINE config 4) to step 4
    v = int(rng.integers(0, 1 << 64, dtype=np.uint64))
    steps = {}
    depth_cts, launches_d, peak, stats = drive(
        "depth", lambda: depth_sweep(pv, torch, pk, sk, eng, v, steps))
    s4 = steps[DEPTH_STEPS]
    # depth_sweep resets the peak at each step, so the path's peak is theirs
    peak = max([peak] + [st["peak"] for st in steps.values()])
    say(f"[depth] PRF cores {stats['prf_cores']}, sigma edges {stats['sigma_edges']}, "
        f"grid blocks {stats['mulgrid_blocks']}, peak device memory {peak / 2**20:.1f} MiB, "
        f"launches {launches_d}")
    sp = s4["split"]
    rest = s4["mul_s"] - sum(sp[k] for k in ("stage_start", "device_wait", "stage_finalize",
                                               "compact_edges", "compact_layers"))
    say(f"[depth] step {DEPTH_STEPS} ct_mul split (s): " + ", ".join(
        f"{k} {t:.3f}" for k, t in sp.items()) + f"; rest of ct_mul {rest:.3f} "
        f"(the VirtualSigma recipe, Cipher assembly); dec {s4['dec_s']:.3f}; "
        f"density sample {s4['density_s']:.3f}")
    depth_checks(pv, torch, pk, sk, eng, depth_cts, rng)
    del depth_cts

    # 9. recrypt, text and commit on the default goldens
    recrypt_text_commit(pv, g)

    # 10. the service path: client and evaluator, circuits, CLI, scalar API
    t0 = time.time()
    svc, launches_s, peak, _ = drive("service", lambda: service_path(pv, torch, rng, prm))
    say("[service] wall s: " + ", ".join(f"{k} {t:.3f}" for k, t in svc["wall"].items())
        + f"; phase {time.time() - t0:.3f}")
    say("[service] op_report us/op: " + ", ".join(f"{k} {t:.1f}" for k, t in svc["ops"].items())
        + f" (batch {SERVICE_OP_BATCH})")
    say(f"[service] engines: client {svc['stats']['client']}, evaluator (no secret key) "
        f"{svc['stats']['evaluator']}; peak device memory {peak / 2**20:.1f} MiB, "
        f"launches {launches_s}; every circuit, CLI and scalar-API result exact")

    src = {"lpn_ybits": ("kernels/lpn_ybits.cu", "pvac_hfhe_cppbyv_tpu/crypto/aes_fused.py:140"),
           "sigma_draws": ("kernels/sigma_draws.cu",
                           "pvac_hfhe_cppbyv_tpu/crypto/sha256_pallas.py:261"),
           "sigma": ("kernels/sigma.cu", "pvac_hfhe_cppbyv_tpu/crypto/onehot_pallas.py:57"),
           "sha256_blocks": ("kernels/sha256_blocks.cu",
                             "pvac_hfhe_cppbyv_tpu/crypto/sha256_pallas.py:115"),
           "toep_core": ("kernels/toep_core.cu", "pvac_hfhe_cppbyv_tpu/crypto/aes_pallas.py:194")}
    # launches: the config-2 path's count; launches_slice1, launches_depth
    # and launches_service: the slice-1, depth-sweep and service paths'
    rows_out = [dict(name=k, route="cuda", source="pvac_hfhe_cppbyv_tpu_torch/" + src[k][0],
                     replaces=src[k][1], launches=launches[k],
                     launches_slice1=launches1[k], launches_depth=launches_d[k],
                     launches_service=launches_s[k],
                     **report[k]) for k in src]
    say(smi)  # the card and its power limit, as nvidia-smi prints them
    say(json.dumps({"kernels": rows_out}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
