"""The reader of the bank-ordered σ share: silent without its counter."""
from types import SimpleNamespace

from portbench import manifest


def test_banked_share_reads_the_counter():
    base = SimpleNamespace(setup_seconds=1.0, window_s=1.0, units=8, latencies_ms=[],
                           spans=[], counters={"sigma_edges": 1212}, trace=None)
    read = manifest.reader("mul.sigma_banked_pct")
    assert read(base) is None
    base.counters.update(sigma_banked_edges=1212)
    assert read(base) == 100.0
