"""The port's DISPATCH_STATS under concurrency: per-thread counters and the
aggregate view, as ``tests/test_dispatch_stats.py`` holds the reference.

A server's dispatcher and a mutator warming the next plan both dispatch;
each thread mutates only its own counter holder, and
`DispatchStats.aggregate()` sums every thread that ever touched the stats,
so no increment is lost whatever the interleaving.  Everything runs on the
CPU (``device="cpu"``); the concurrent batches must equal the
single-threaded run bit for bit.
"""
import sys
import threading

import numpy as np

from repro_torch.core import engine as _engine
from repro_torch.core import snn as tsnn
from repro_torch.core.join import single_query


def test_counters_thread_isolated_and_aggregated():
    n_threads, bumps = 8, 500
    # reset BEFORE reading the baseline: the reset zeroes this thread's
    # counters from earlier tests, which would otherwise skew the delta
    _engine.DISPATCH_STATS.reset()
    base = _engine.DispatchStats.aggregate()["kernel_launches"]
    start = threading.Barrier(n_threads)
    per_thread = {}

    def work(tid):
        _engine.DISPATCH_STATS.reset()
        start.wait()
        for _ in range(bumps):
            _engine.DISPATCH_STATS.kernel_launches += 1
        per_thread[tid] = _engine.DISPATCH_STATS.kernel_launches

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)   # interleave the increments as much as we can
    try:
        threads = [threading.Thread(target=work, args=(t,))
                   for t in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30.0)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert per_thread == {t: bumps for t in range(n_threads)}
    assert _engine.DISPATCH_STATS.kernel_launches == 0
    agg = _engine.DispatchStats.aggregate()
    assert agg["kernel_launches"] - base == n_threads * bumps


def test_concurrent_fused_serving_batches():
    # overlapping batches through one shared pack on worker threads, the
    # fused path engaged: each thread's counters record its own queries and
    # every result is bit-identical to the single-threaded run
    rng = np.random.default_rng(0)
    x = rng.normal(size=(500, 6)).astype(np.float32)
    index = tsnn.build_index(x, n_components=3, device="cpu")
    pack = _engine.pack_from_index(index, device="cpu")
    q = rng.normal(size=(32, 6)).astype(np.float32)
    want = single_query(index, q, 1.0, pack=pack)
    want2 = single_query(index, q, 1.0, pack=pack)   # the fused path
    assert np.array_equal(want.indptr, want2.indptr)

    results, snaps = {}, {}
    start = threading.Barrier(4)

    def worker(tid):
        _engine.DISPATCH_STATS.reset()
        start.wait()
        for _ in range(3):
            results[tid] = single_query(index, q, 1.0, pack=pack)
        snaps[tid] = _engine.DISPATCH_STATS.snapshot()

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60.0)
        assert not t.is_alive()
    assert sorted(results) == [0, 1, 2, 3]
    for tid, res in results.items():
        assert np.array_equal(res.indptr, want.indptr), tid
        assert np.array_equal(res.indices, want.indices), tid
        assert np.array_equal(res.distances, want.distances), tid
    # each worker's own counters: three fused queries, 3 passes and 1 copy
    # each
    for tid, snap in snaps.items():
        assert snap["kernel_launches"] == 9, (tid, snap)
        assert snap["host_transfers"] == 3, (tid, snap)
