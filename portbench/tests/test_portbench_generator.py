"""The traffic generator: seeded, log-uniform levels, every level once a block."""
import itertools
import pytest

from portbench import generator, manifest

MIXES = ["bulk_enc", "mul_d1", "roundtrip_d1"]
BIG_SEED = 2**31 + 12345


def take(mix, seed, n):
    return list(itertools.islice(generator.requests(mix, seed), n))


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_requests(name):
    mix = manifest.traffic(name)
    assert take(mix, BIG_SEED, 20) == take(mix, BIG_SEED, 20)
    assert take(mix, BIG_SEED, 20) != take(mix, BIG_SEED + 1, 20)


@pytest.mark.parametrize("name", MIXES)
def test_levels_log_uniform_in_range(name):
    size = manifest.traffic(name)["size"]
    lv = generator.levels(size)
    assert len(lv) == size["levels"] and lv == sorted(lv)
    assert size["min"] <= lv[0] and lv[-1] <= size["max"]
    k = size["levels"]
    for i, n in enumerate(lv):  # the (i + 1/2) / k quantile of log-uniform [min, max]
        exact = size["min"] * (size["max"] / size["min"]) ** ((i + 0.5) / k)
        assert abs(n - exact) <= 0.5


@pytest.mark.parametrize("name", MIXES)
def test_every_block_holds_every_level_once(name):
    mix = manifest.traffic(name)
    k = mix["size"]["levels"]
    reqs = take(mix, 7, 3 * k)
    for b in range(3):
        assert sorted(r["n"] for r in reqs[b * k:(b + 1) * k]) == generator.levels(mix["size"])


@pytest.mark.parametrize("name", MIXES)
def test_request_contents(name):
    mix = manifest.traffic(name)
    for r in take(mix, 3, 40):
        n = r["n"]
        if mix.get("pool"):
            assert len(r["picks"]) == 2 * n == len(set(r["picks"]))
            assert all(0 <= i < mix["pool"] for i in r["picks"])
        else:
            vals = r["values"]
            assert len(vals) == n * mix.get("values_per_unit", 1)
            assert all(0 <= v < 2**64 for v in vals)
        keep = mix["check"]["per_request"]
        assert r["sample"] == sorted(set(r["sample"])) and all(0 <= i < n for i in r["sample"])
        assert len(r["sample"]) == (n if keep is None else min(keep, n))


def test_negative_and_large_seeds():
    mix = manifest.traffic("bulk_enc")
    assert take(mix, -5, 2) == take(mix, -5, 2)
    assert take(mix, 2**40, 2) != take(mix, 2**40 + 1, 2)


@pytest.mark.parametrize("name", MIXES)
def test_warm_request_at_largest_level(name):
    mix = manifest.traffic(name)
    w = generator.warm_request(mix, 11)
    assert w["n"] == max(generator.levels(mix["size"])) and w["sample"] == []


def test_pool_values_seeded():
    mix = manifest.traffic("mul_d1")
    a, b = generator.pool_values(mix, 5), generator.pool_values(mix, 5)
    assert a == b and len(a) == mix["pool"] and len(set(a)) == len(a)
