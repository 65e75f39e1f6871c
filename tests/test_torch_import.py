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
