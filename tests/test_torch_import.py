"""The PyTorch port imports neither JAX nor the JAX package, and
chip_smoke.py refuses to run without a card or without the package."""
import pathlib
import shutil
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent


def test_port_imports_no_jax():
    code = (
        "import sys, pvac_hfhe_cppbyv_tpu_torch\n"
        "import pvac_hfhe_cppbyv_tpu_torch.engine, pvac_hfhe_cppbyv_tpu_torch.kernels\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'pvac_hfhe_cppbyv_tpu' or m.startswith('pvac_hfhe_cppbyv_tpu.')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


def test_chip_smoke_refuses_without_cuda():
    """This test host has no CUDA device: the script must fail, print no
    result line, and not touch JAX."""
    res = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_kernel_build_hash_covers_every_source():
    """The library's name hashes kernels.SOURCES and kernels.HEADERS: every
    CUDA source and header beside them must be listed (a header left out
    would let a stale library serve a changed header), and every listed
    file must exist.  Nothing is built: kernels builds on first use."""
    from pvac_hfhe_cppbyv_tpu_torch import kernels

    on_disk = {p.name for p in kernels.HERE.iterdir() if p.suffix in (".cu", ".cuh", ".h")}
    listed = set(kernels.SOURCES) | set(kernels.HEADERS)
    assert len(listed) == len(kernels.SOURCES) + len(kernels.HEADERS)
    assert on_disk == listed, (sorted(on_disk - listed), sorted(listed - on_disk))


def test_kernel_includes_are_listed_headers():
    """Every local #include of a kernel source or header names a listed
    header, so the hash covers what nvcc reads."""
    import re

    from pvac_hfhe_cppbyv_tpu_torch import kernels

    for name in (*kernels.SOURCES, *kernels.HEADERS):
        text = (kernels.HERE / name).read_text()
        for inc in re.findall(r'^\s*#include\s+"([^"]+)"', text, flags=re.M):
            assert inc in kernels.HEADERS, f"{name} includes {inc}, which HEADERS does not list"
