"""The port's buffered CSPRNG serves each byte once, even when many
threads draw at the same time (its take-and-advance step holds a lock)."""
import sys
import threading

from pvac_hfhe_cppbyv_tpu_torch.core import random as R


def test_concurrent_draws_never_repeat():
    n_threads, per_thread = 32, 3000
    out = [[] for _ in range(n_threads)]

    def work(i):
        for _ in range(per_thread):
            out[i].append(R.csprng_u64())

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    draws = [x for part in out for x in part]
    assert len(draws) == n_threads * per_thread
    # 96000 uniform u64s collide with probability ~2^-34; a lost update in
    # the shared buffer would hand two threads the same 8 bytes
    assert len(set(draws)) == len(draws)
