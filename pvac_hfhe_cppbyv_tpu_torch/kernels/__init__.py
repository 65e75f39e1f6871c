"""Build and load the hand-written CUDA kernels.

The sources beside this file (lpn_ybits.cu, sigma_draws.cu, sigma.cu,
sigma_fused.cu, prf_keys.cu, toep_core.cu; the C interface in pvac_kernels.h;
device code shared between kernels in aes.cuh (A, E), sha256.cuh (B, D),
sigma_draw.cuh (B's draw phases, run by the fused launch's producers too) and
sigma_gather.cuh (C's slice gather and noise launch, also the fused launch's))
compile with ``nvcc`` for ``sm_90a``, one process per source run in parallel,
into one shared library with a plain C interface, loaded with ctypes.
The build happens on first use, into ``_build/`` beside this file, under a
name that hashes the sources and flags, so a changed source rebuilds.
Nothing here runs at import time: the CPU test suite imports every
module and has no ``nvcc``.

A build failure, a missing ``nvcc`` or a failed launch raises; there is no
fallback to the plain torch versions for CUDA tensors.

``LAUNCHES`` counts kernel launches by name.  Each wrapper adds one where
it launches its kernel and nowhere else, so a run can show which kernels
its main path went through.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading

import torch

HERE = pathlib.Path(__file__).parent
SOURCES = ("lpn_ybits.cu", "sigma_draws.cu", "sigma.cu", "sigma_fused.cu", "prf_keys.cu",
           "toep_core.cu")
HEADERS = ("pvac_kernels.h", "aes.cuh", "sha256.cuh", "sigma_draw.cuh", "sigma_gather.cuh")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES = {"lpn_ybits": 0, "sigma_draws": 0, "sigma": 0, "sigma_fused": 0,
            "prf_keys": 0, "toep_core": 0}

_lock = threading.Lock()
_lib = None
BUILD_LOG = ""


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (pathlib.Path(cand) / "bin" / "nvcc").exists():
            return str(pathlib.Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _build() -> pathlib.Path:
    """Compile every source to an object in its own nvcc process, all
    started together, then link the shared library."""
    global BUILD_LOG
    h = hashlib.sha256()
    for name in (*SOURCES, *HEADERS):
        h.update((HERE / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    out_dir = HERE / "_build"
    out = out_dir / f"libpvac_kernels_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs = [os.path.join(tmp, s + ".o") for s in SOURCES]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", o, str(HERE / s)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for s, o in zip(SOURCES, objs)]
        try:
            logs = [p.communicate(timeout=900)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        failed = [(s, p.returncode, log) for s, p, log in zip(SOURCES, procs, logs)
                  if p.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"{s} ({rc}):\n{log}" for s, rc, log in failed))
        so = os.path.join(tmp, "lib.so")
        res = subprocess.run([nvcc, "-shared", "-o", so, *objs],
                             capture_output=True, text=True, timeout=300)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                               f"{res.stdout}\n{res.stderr}")
        BUILD_LOG = "".join(logs) + res.stdout + res.stderr
        os.replace(so, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library; builds it on first use."""
    global _lib
    with _lock:
        if _lib is None:
            L = ctypes.CDLL(str(_build()))
            p, i = ctypes.c_void_p, ctypes.c_int
            L.pvk_lpn_ybits.argtypes = [i, p, p, p, p, p, i, i, i, i, i, i, i, i, p, p]
            L.pvk_sigma_draws.argtypes = [i, p, p, i, i, p, i, i, i, i, i, i, i, i,
                                          i, p, i, p, i, p]
            L.pvk_sigma.argtypes = [i, p, p, i, i, p, i, i, p, i, i, i, i, p]
            L.pvk_sigma_fused_plan.argtypes = [i, i, i, i, i, i, i, p, i, i, i, i, i, i, i,
                                               i, i, p]
            L.pvk_sigma_fused.argtypes = [i, p, p, i, i, p, i, i, p, i, i, i, i, i, i, i, i,
                                          i, p, i, i, p, i, p, p, i, i, p]
            L.pvk_prf_keys.argtypes = [i, p, p, i, p, p, i, i, ctypes.c_uint64, p, p]
            L.pvk_toep_core.argtypes = [i, p, p, p, p, p, i, p]
            for fn in (L.pvk_lpn_ybits, L.pvk_sigma_draws, L.pvk_sigma,
                       L.pvk_sigma_fused_plan, L.pvk_sigma_fused, L.pvk_prf_keys,
                       L.pvk_toep_core):
                fn.restype = i
            _lib = L
        return _lib


def check_cuda(*tensors: torch.Tensor, dtypes) -> torch.device:
    """Validate kernel arguments: all on one CUDA device, contiguous, of
    the expected dtypes.  Returns the device."""
    dev = tensors[0].device
    for t, dt in zip(tensors, dtypes):
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"kernel arguments must share one CUDA device, got {t.device}")
        if t.dtype != dt:
            raise TypeError(f"expected {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("kernel arguments must be contiguous")
    return dev


def launch(name: str, fn, dev: torch.device, *args) -> None:
    """Launch through a C entry point on torch's current stream; raise on
    a launch error and count the launch."""
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(dev.index if dev.index is not None else torch.cuda.current_device(),
            stream, *args)
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error {rc}")
    LAUNCHES[name] += 1
