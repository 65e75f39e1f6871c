"""The roofline table: work per unit as floors, and the bound arithmetic."""
import json

import pytest

from portbench import manifest, readers

KERNELS = ["lpn_ybits", "sigma", "sigma_draws", "prf_keys", "toep_core"]
# T-table counts of one AES-256 block and one SHA-256 compression, as the
# kernel table's share column counts them (560 and 1450 instructions)
T_TABLE_AES, SHA_COUNTED = 560, 1450


@pytest.mark.parametrize("k", KERNELS)
def test_entries(k):
    spec = manifest.roofline(k)
    assert spec["kernel"] == k and spec["device_ops"] and spec["derivation"]
    assert spec["counter"] in ("prf_cores", "sigma_edges")
    assert spec["int_ops_per_unit"] > 0 and spec["bytes_per_unit"] > 0


def test_peaks():
    p = manifest.peaks()
    assert p["hbm_bytes_per_s"] == 3.35e12
    assert p["int32_ops_per_s"] == pytest.approx(132 * 64 * 1.98e9)


def test_lpn_ybits_is_a_floor():
    spec = manifest.roofline("lpn_ybits")
    blocks = -(-127 * 65 // 2)
    assert blocks == 4128
    # below the T-table count, and below a bitsliced count of 68.5 a round
    assert spec["int_ops_per_unit"] < blocks * T_TABLE_AES
    assert spec["int_ops_per_unit"] < blocks * 68.5 * 14
    assert spec["int_ops_per_unit"] == blocks * (316 + 4) + 104


def test_sigma_is_a_floor():
    spec = manifest.roofline("sigma")
    # the dense XOR of 128 rows of 256 words in 3-input ops, and the noise flips,
    # below the sparse count of 128 columns x 192 bits
    assert spec["int_ops_per_unit"] == 256 * 64 + 128 < 128 * 192
    assert spec["bytes_per_unit"] == 8192 // 8


def test_sha_floors():
    sha = 64 * 14 + 48 * 10
    assert sha < SHA_COUNTED
    assert manifest.roofline("prf_keys")["int_ops_per_unit"] == 2 * sha
    assert manifest.roofline("sigma_draws")["int_ops_per_unit"] == 66 * sha


def test_bound_arithmetic():
    peaks = {"hbm_bytes_per_s": 1e3, "int32_ops_per_s": 1e6}
    ops_bound = {"bytes_per_unit": 1, "int_ops_per_unit": 2000}
    bytes_bound = {"bytes_per_unit": 5, "int_ops_per_unit": 10}
    assert readers.bound_s(ops_bound, 10, peaks) == pytest.approx(0.02)
    assert readers.bound_s(bytes_bound, 10, peaks) == pytest.approx(0.05)


def test_kernel_a_at_its_measured_speed_reads_under_100():
    """Kernel A took 2.958 ms of device time for 16384 cores on an H100
    (PERF.md's kernel table); its share on this floor reads below 100%."""
    spec, peaks = manifest.roofline("lpn_ybits"), manifest.peaks()
    share = 100 * readers.bound_s(spec, 16384, peaks) / 2.958e-3
    assert 30 < share < 100


def test_derivations_are_text():
    for k in KERNELS:
        json.dumps(manifest.roofline(k)["derivation"])
