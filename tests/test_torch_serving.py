"""The port's server (`serving/`) against the JAX package, and its contracts.

The JAX package builds a `StreamingSNNIndex` (base + one delta) from seeded
numpy data; the port takes its exact state through
`StreamingSNNIndex.from_state(*state_leaves(), device="cpu")`.  Each side
wraps its index in its own `TenantRuntime` and serves the same mixed batch
(radius, a join block with per-row radii, counts, reverse, kNN with mixed
k) through `run_batch`, with no threads.  Everything runs on the CPU, where
the port's engine runs the plain versions of the kernels.

Tolerances, and why: ``indices``, ``indptr`` and ``counts`` must be equal
exactly (the data is drawn so that no pair lies in the float32 rounding
band).  ``sq_dists`` are float64 squared distances rebuilt from float32
half distances that the two packages take from different GEMM libraries,
so they may differ by the float32 rounding of one dot product:
``|a - b| <= 4 * 2^-23 * (||x||^2 + ||q||^2)``, a few float32 ulp of the
operands' scale.

The port-only cases mirror ``tests/test_serving_runtime.py`` and
``tests/test_serving_fused.py``: admission, FIFO order, validation, fused
dispatch counts, degraded paths, plan swaps under a mutator, tenants and
LRU eviction, the checkpoint drill, and `rebuild`.  Every test that starts
the dispatcher stops it in ``finally``; every `result()` has a timeout of
a few seconds.
"""
import gc
import queue
import threading
import time
import weakref

import numpy as np
import pytest

from repro.configs.snn_default import SNNConfig as JSNNConfig
from repro.core import streaming as jst
from repro.serving import runtime as jrun
from repro_torch.configs.snn_default import SNNConfig
from repro_torch.core import engine as _engine
from repro_torch.core import snn as tsnn
from repro_torch.core import streaming as tst
from repro_torch.ft.elastic import FailureInjector, ReplicaDrill
from repro_torch.serving import (IndexRegistry, Request, ServiceClock,
                                 TenantRuntime, collect_batch)
from repro_torch.serving import runtime as trun
from repro_torch.serving.server import SNNServer

EPS32 = 2.0 ** -23
WAIT = 10.0     # seconds any test waits for one response or thread


def _server(n=2000, d=6, seed=0, **cfg):
    rng = np.random.default_rng(seed)
    data = rng.random((n, d)).astype(np.float32)
    return SNNServer(data, SNNConfig(**cfg), device="cpu"), data, rng


def _stamp(req):
    """Stamp ``_t0`` as `submit` does, without a server."""
    req._t0 = time.monotonic()
    return req


def _collect(rt, batch):
    out = {}
    rt.run_batch(batch, lambda resp: out.__setitem__(resp.id, resp))
    return out


# ------------------------------------------------------ against the JAX side
METRICS = {"euclidean": (2.6, (2.0, 3.2)), "cosine": (0.45, (0.3, 0.6))}


def _mixed_batch(cls, rng_seed, d, metric):
    rng = np.random.default_rng(rng_seed)
    r0, (lo, hi) = METRICS[metric]
    q = rng.normal(size=(40, d)).astype(np.float32)
    reqs = [cls(query=q[i], radius=float(rng.uniform(lo, hi)), id=i)
            for i in range(8)]
    reqs.append(cls(query=q[8:20], radius=rng.uniform(lo, hi, 12), id=8))
    reqs += [cls(query=q[20 + i], radius=r0, count_only=True, id=9 + i)
             for i in range(4)]
    reqs.append(cls(query=q[24:28], radius=r0, count_only=True, id=13))
    reqs += [cls(query=q[28 + i], reverse=True, id=14 + i) for i in range(3)]
    reqs.append(cls(query=q[31:34], reverse=True, id=17))
    ks = [1, 5, 17, 3, 9, 40]
    reqs += [cls(query=q[34 + i], k=ks[i], id=18 + i) for i in range(6)]
    return reqs


@pytest.mark.parametrize("metric", sorted(METRICS))
def test_mixed_batch_equals_the_jax_runtime(metric):
    rng = np.random.default_rng(7 + len(metric))
    n, d = 3000, 12
    x = rng.normal(size=(n, d)).astype(np.float32)
    jidx = jst.StreamingSNNIndex(x, metric=metric)
    jidx.append(rng.normal(size=(200, d)).astype(np.float32))
    tidx = tst.StreamingSNNIndex.from_state(*jidx.state_leaves(),
                                            device="cpu")
    assert len(tidx.parts) == 2
    jrt = jrun.TenantRuntime(jidx, JSNNConfig(metric=metric))
    trt = TenantRuntime(tidx, SNNConfig(metric=metric))
    rr = np.random.default_rng(3).uniform(*METRICS[metric][1], n + 200)
    jrt.set_reverse_radii(rr)
    trt.set_reverse_radii(rr)
    want = _collect(jrt, _mixed_batch(jrun.Request, 5, d, metric))
    got = _collect(trt, _mixed_batch(Request, 5, d, metric))
    assert sorted(got) == sorted(want) == list(range(24))
    x64 = np.concatenate([x, np.asarray(jidx.raw[n:])]).astype(np.float64)
    nnz = 0
    for rid in range(24):
        w, g = want[rid], got[rid]
        assert g.error is None and w.error is None, (rid, g.error, w.error)
        assert g.generation == w.generation == 1
        for field in ("indptr", "counts"):
            a, b = getattr(w, field), getattr(g, field)
            assert (a is None) == (b is None), (rid, field)
            if a is not None:
                np.testing.assert_array_equal(b, a)
        np.testing.assert_array_equal(g.indices, w.indices)
        assert g.truncated == w.truncated
        nnz += g.indices.size
        if g.indices.size:
            # the band of one float32 dot product at the operands' scale
            scale = 2.0 * np.max(np.einsum("ij,ij->i", x64, x64)) + 2.0 * d
            np.testing.assert_allclose(g.sq_dists, w.sq_dists, rtol=0,
                                       atol=4 * EPS32 * scale)
    assert nnz > 500


# --------------------------------------------------------------- admission
def _queued(n, slo_ms=None, old_s=0.0):
    q = queue.Queue()
    for i in range(n):
        r = _stamp(Request(query=np.zeros(4, np.float32), radius=0.5, id=i,
                           slo_ms=slo_ms))
        if i == 0:
            r._t0 -= old_s
        q.put(r)
    return q


@pytest.mark.parametrize("case", ["lone", "expired", "backlog", "ewma",
                                  "window"])
def test_admission_policies(case):
    clock = ServiceClock()
    if case == "lone":       # light load: no wait for the 5 s budget
        cfg = SNNConfig(serve_slo_ms=5000.0, serve_batch=64)
        q, want, left = _queued(1), [0], 0
    elif case == "expired":  # an expired budget flushes the first alone
        cfg = SNNConfig(serve_slo_ms=1.0, serve_batch=64)
        q, want, left = _queued(8, old_s=1.0), [0], 7
    elif case == "backlog":  # FIFO, capped at serve_batch
        cfg = SNNConfig(serve_slo_ms=10_000.0, serve_batch=5)
        q, want, left = _queued(12), [0, 1, 2, 3, 4], 7
    elif case == "ewma":     # a 10 s service estimate forces early flushes
        cfg = SNNConfig(serve_slo_ms=50.0, serve_batch=64)
        clock = ServiceClock(alpha=1.0)
        clock.observe(10.0)
        q, want, left = _queued(6), [0], 5
    else:                    # the fixed window waits for more arrivals
        cfg = SNNConfig(serve_policy="window", serve_timeout_ms=30.0,
                        serve_batch=8)
        q, want, left = _queued(3), [0, 1, 2], 0
    t0 = time.monotonic()
    batch = collect_batch(q, cfg, clock)
    took = time.monotonic() - t0
    assert [r.id for r in batch] == want
    assert q.qsize() == left
    if case == "window":
        assert took >= 0.025
    else:
        assert took < 0.5


def test_service_clock_ewma():
    c = ServiceClock(alpha=0.5)
    assert c.estimate() == 0.0
    c.observe(2.0)
    assert c.estimate() == 2.0       # the first sample seeds the average
    c.observe(4.0)
    assert c.estimate() == 3.0
    c.observe(-1.0)                  # negative service times count as 0
    assert c.estimate() == 1.5
    assert collect_batch(queue.Queue(), SNNConfig(), c, poll_s=0.01) == []


def test_fifo_no_starvation_under_sustained_load():
    server, data, rng = _server(n=800, serve_batch=4, serve_slo_ms=200.0)
    server.start()
    try:
        n_req, done_order = 40, []
        lock = threading.Lock()

        def waiter(i):
            server.result(i, timeout=WAIT)
            with lock:
                done_order.append(i)

        threads = []
        for i in range(n_req):
            server.submit(Request(query=rng.random(6).astype(np.float32),
                                  radius=0.3, id=i))
            t = threading.Thread(target=waiter, args=(i,))
            t.start()
            threads.append(t)
            time.sleep(0.001)
        for t in threads:
            t.join(WAIT)
            assert not t.is_alive()
        assert len(done_order) == n_req
        pos = {rid: p for p, rid in enumerate(done_order)}
        for i in range(n_req - 4):
            assert pos[i] < pos[i + 4] + 4
    finally:
        server.stop()


BAD_REQUESTS = {
    "neither": dict(),
    "both": dict(radius=0.5, k=3),
    "reverse+radius": dict(radius=0.5, reverse=True),
    "reverse+k": dict(k=3, reverse=True),
    "reverse, no radii": dict(reverse=True),
    "knn+count": dict(k=3, count_only=True),
    "knn on a block": dict(k=3, block=True),
    "radius vector length": dict(radius=np.array([0.1, 0.2, 0.3]),
                                 block=True),
    "3-d query": dict(radius=0.5, cube=True),
    "reverse+count": dict(reverse=True, count_only=True, radii=True),
    "unknown tenant": dict(radius=0.5, tenant="nope"),
}


@pytest.mark.parametrize("case", sorted(BAD_REQUESTS))
def test_submit_rejects_malformed_requests(case):
    server, _, _ = _server(n=50, d=3)
    kw = dict(BAD_REQUESTS[case])
    q = np.zeros(3, np.float32)
    if kw.pop("block", False):
        q = np.zeros((2, 3), np.float32)
    if kw.pop("cube", False):
        q = np.zeros((2, 2, 3), np.float32)
    if kw.pop("radii", False):
        server.set_reverse_radii(np.full(50, 0.1))
    err = KeyError if case == "unknown tenant" else ValueError
    with pytest.raises(err):
        server.submit(Request(query=q, id=0, **kw))
    assert server._q.qsize() == 0
    with pytest.raises(ValueError):
        server.set_reverse_radii(np.full(49, 0.1))


# ---------------------------------------------------------- fused dispatch
@pytest.mark.parametrize("kinds", ["radius", "mixed", "mixed+knn", "count",
                                   "knn"])
def test_batches_fuse_and_equal_single_shot(kinds):
    """One fused CSR execution a batch (3 launches, 1 copy once the plan
    has seen the shape), an all-count batch the count pass alone, and
    every answer bit-identical to its request served alone."""
    server, data, rng = _server(n=3000, d=8)
    rr = rng.uniform(0.05, 0.35, data.shape[0])
    server.set_reverse_radii(rr)
    qs = rng.random((40, 8)).astype(np.float32)
    if kinds == "radius":
        radii = rng.uniform(0.1, 0.8, 24)
        radii[0], radii[1] = 0.0, 10.0
        batch = [Request(query=qs[i], radius=float(radii[i]), id=i)
                 for i in range(24)]
    elif kinds.startswith("mixed"):
        batch = [Request(query=qs[0], radius=0.4, id=0),
                 Request(query=qs[1:9], radius=rng.uniform(0.1, 0.5, 8),
                         id=1),
                 Request(query=qs[9:12], radius=0.45, count_only=True, id=2),
                 Request(query=qs[12:16], reverse=True, id=3),
                 Request(query=qs[16], reverse=True, id=4)]
        if kinds == "mixed+knn":
            batch += [Request(query=qs[17 + i], k=int(k), id=5 + i)
                      for i, k in enumerate((5, 1, 8))]
    elif kinds == "count":
        batch = [Request(query=qs[i], radius=float(r), count_only=True, id=i)
                 for i, r in enumerate(rng.uniform(0.2, 0.6, 6))]
    else:
        batch = [Request(query=qs[i], k=int(k), id=i)
                 for i, k in enumerate(rng.integers(1, 9, 12))]
    for r in batch:
        _stamp(r)
    server._run_batch(batch)           # the first batch learns the capacity
    first = dict(server._results)
    server._results.clear()
    _engine.DISPATCH_STATS.reset()
    server._run_batch(batch)
    stats = _engine.DISPATCH_STATS.snapshot()
    csr = [r for r in batch if r.kind != "snn-knn"]
    if kinds == "count":
        assert stats == dict(stats, kernel_launches=1, host_transfers=1)
    elif kinds == "knn":
        assert 2 <= stats["kernel_launches"] <= 8, stats
    elif kinds == "mixed+knn":
        assert 5 <= stats["kernel_launches"] <= 11, stats
    else:
        assert stats["kernel_launches"] == 3, stats
        assert stats["host_transfers"] == 1, stats
    idx = server.index
    for r in batch:
        resp = server._results[r.id]
        assert resp.error is None
        assert resp.generation == server.generation
        assert resp.service_ms > 0.0 and resp.queue_delay_ms >= 0.0
        assert resp.latency_ms >= resp.queue_delay_ms
        np.testing.assert_array_equal(resp.indices, first[r.id].indices)
        q2 = np.atleast_2d(r.query)
        if r.kind == "snn-knn":
            ids, sq = idx.query_knn(q2, r.k, native=False)
            np.testing.assert_array_equal(resp.indices, ids[0])
            np.testing.assert_array_equal(resp.sq_dists, sq[0])
            continue
        if r.kind == "snn-reverse":
            d = np.sqrt(((data[None].astype(np.float64)
                          - q2[:, None]) ** 2).sum(-1))
            for t in range(q2.shape[0]):
                lo, hi = ((resp.indptr[t], resp.indptr[t + 1])
                          if resp.indptr is not None else (0, None))
                np.testing.assert_array_equal(
                    np.sort(resp.indices[lo:hi]), np.nonzero(d[t] <= rr)[0])
            continue
        want = idx.query_radius_csr(q2, r.radius, native=False)
        if r.kind == "snn-count":
            np.testing.assert_array_equal(resp.counts, np.diff(want.indptr))
            assert resp.indices.size == 0
        elif r.kind == "snn-join":
            np.testing.assert_array_equal(resp.indptr, want.indptr)
            np.testing.assert_array_equal(resp.indices, want.indices)
            np.testing.assert_array_equal(resp.sq_dists, want.distances)
        else:
            wi, wd = want.row(0)
            np.testing.assert_array_equal(resp.indices, wi)
            np.testing.assert_array_equal(resp.sq_dists, wd)
            assert not resp.truncated
    # the batch found pairs (the checks above are not of empty answers)
    assert len(csr) == 0 or sum(
        server._results[r.id].indices.size
        + (0 if server._results[r.id].counts is None
           else int(server._results[r.id].counts.sum())) for r in csr) > 0


def test_requests_end_to_end_through_the_dispatcher():
    """radius, kNN and reverse requests through submit/result, against a
    float64 brute force."""
    server, data, rng = _server(n=800, d=5, serve_batch=16)
    rr = rng.uniform(0.05, 0.4, 800)
    server.set_reverse_radii(rr)
    qs = rng.random((30, 5)).astype(np.float32)
    server.start()
    try:
        for i in range(10):
            server.submit(Request(query=qs[i], radius=0.3, id=i))
            server.submit(Request(query=qs[10 + i], k=4, id=10 + i))
            server.submit(Request(query=qs[20 + i], reverse=True, id=20 + i))
        d = np.sqrt(((data[None].astype(np.float64)
                      - qs[:, None]) ** 2).sum(-1))
        for i in range(30):
            resp = server.result(i, timeout=WAIT)
            assert resp.error is None
            if i < 10:
                want = np.nonzero(d[i] <= 0.3)[0]
            elif i < 20:
                want = np.argsort(d[i], kind="stable")[:4]
                np.testing.assert_array_equal(resp.indices, want)
                continue
            else:
                want = np.nonzero(d[i] <= rr)[0]
            np.testing.assert_array_equal(np.sort(resp.indices), want)
    finally:
        server.stop()


# -------------------------------------------------------- degraded paths
def test_fixed_path_serves_radius_and_fails_the_rest_fast():
    """serve_exact=False: radius requests through the filter, K-bounded,
    ``truncated`` right; join/count/reverse get an error Response now."""
    server, data, rng = _server(n=600, serve_exact=False, max_neighbors=16)
    server.set_reverse_radii(np.full(data.shape[0], 0.3))
    qs = rng.random((4, 6)).astype(np.float32)
    batch = [_stamp(Request(query=qs[0], radius=0.3, id=0)),
             _stamp(Request(query=qs[1], radius=0.6, id=4)),
             _stamp(Request(query=qs[1:3], radius=0.4, id=1)),
             _stamp(Request(query=qs[3], radius=0.4, count_only=True, id=2)),
             _stamp(Request(query=qs[0], reverse=True, id=3))]
    server._run_batch(batch)
    d = np.sqrt(((data[None].astype(np.float64) - qs[:, None]) ** 2).sum(-1))
    for rid, qi, r in ((0, 0, 0.3), (4, 1, 0.6)):
        resp = server._results[rid]
        assert resp.error is None
        want = np.nonzero(d[qi] <= r)[0]
        assert resp.truncated == (want.size > 16)
        near = want[np.argsort(d[qi, want], kind="stable")][:16]
        assert set(resp.indices.tolist()) == set(near.tolist())
    assert server._results[4].truncated
    for rid in (1, 2, 3):
        assert server._results[rid].error is not None
        assert server._results[rid].indices.size == 0
    server.start()
    try:
        server.submit(Request(query=qs[1:3], radius=0.4, id=9))
        t0 = time.monotonic()
        assert server.result(9, timeout=WAIT).error is not None
        assert time.monotonic() - t0 < 5.0
    finally:
        server.stop()


def test_executor_failure_sweep_answers_every_request(monkeypatch):
    server, data, rng = _server(n=400)
    rt = server.runtime()

    def boom(*a, **k):
        raise RuntimeError("engine down")

    for name in ("_respond_csr_family", "_respond_fixed", "_respond_knn"):
        monkeypatch.setattr(rt, name, boom)
    batch = [_stamp(Request(query=rng.random(6).astype(np.float32),
                            radius=0.4, id=0)),
             _stamp(Request(query=rng.random(6).astype(np.float32), k=3,
                            id=1))]
    server._run_batch(batch)
    assert server._results[0].error is not None
    assert server._results[1].error is not None
    # unknown tenants reaching the dispatcher are answered, not dropped
    server._run_batch([Request(query=rng.random(6).astype(np.float32),
                               radius=0.5, id=2, tenant="nope")])
    assert server._results[2].error is not None


def test_result_backlog_caps_orphaned_responses():
    server, _, _ = _server(n=100, serve_batch=1)
    assert server._max_backlog == 1024
    for rid in range(1100):                 # responses nobody waits for
        server._store(trun.error_response(
            Request(query=np.zeros(6, np.float32), radius=0.1, id=rid), "x"))
    assert len(server._results) == 1024
    assert 0 not in server._results and 1099 in server._results
    with pytest.raises(TimeoutError):
        server.result(5000, timeout=0.05)


# ------------------------------------------------------------ plan epochs
def test_plan_swap_is_atomic_and_warm_across_rebuild():
    server, data, rng = _server(n=1500)
    qs = rng.random((30, 6)).astype(np.float32)
    stop, errors = threading.Event(), []

    def hammer():
        while not stop.is_set():
            try:
                g0 = server.generation
                got = server.index.query_radius_csr(qs, 0.4)
                again = server.index.query_radius_csr(qs, 0.4)
                if g0 == server.generation and not (
                        np.array_equal(got.indptr, again.indptr)
                        and np.array_equal(got.indices, again.indices)):
                    errors.append("mismatch within a generation")
            except Exception as e:  # pragma: no cover
                errors.append(repr(e))

    t = threading.Thread(target=hammer)
    t.start()
    try:
        for _ in range(3):
            server.append(rng.random((60, 6)).astype(np.float32))
            server.rebuild()
            assert server.index._state[2] is not None   # published warm
    finally:
        stop.set()
        t.join(WAIT)
    assert not t.is_alive()
    assert not errors, errors
    assert server.index.warm_failures == 0
    fresh = tst.StreamingSNNIndex(server.data, device="cpu")
    a = server.index.query_radius_csr(qs, 0.4)
    b = fresh.query_radius_csr(qs, 0.4)
    np.testing.assert_array_equal(a.indptr, b.indptr)
    for i in range(qs.shape[0]):
        assert set(a.row(i)[0]) == set(b.row(i)[0])


def test_warming_mutator_adds_no_launches_to_the_serving_thread():
    server, data, rng = _server(n=1200)
    qs = rng.random((16, 6)).astype(np.float32)
    batch = [_stamp(Request(query=qs[i], radius=0.4, id=i))
             for i in range(16)]
    server._run_batch(batch)                 # plan built, bucket 128 seen
    done = threading.Event()
    mutator = {}

    def mutate():
        _engine.DISPATCH_STATS.reset()
        server.append(rng.random((40, 6)).astype(np.float32))
        server.rebuild()
        mutator.update(_engine.DISPATCH_STATS.snapshot())
        done.set()

    _engine.DISPATCH_STATS.reset()
    agg0 = _engine.DispatchStats.aggregate()["kernel_launches"]
    t = threading.Thread(target=mutate)
    t.start()
    t.join(WAIT)
    assert done.is_set()
    assert _engine.DISPATCH_STATS.snapshot()["kernel_launches"] == 0
    assert mutator["kernel_launches"] >= 2           # two warm dispatches
    assert (_engine.DispatchStats.aggregate()["kernel_launches"] - agg0
            == mutator["kernel_launches"])
    assert server.index.warm_runs == 2 and server.index.warm_failures == 0
    server._results.clear()
    server._run_batch(batch)                 # the warmed plan: fused at once
    snap = _engine.DISPATCH_STATS.snapshot()
    assert snap["kernel_launches"] == 3 and snap["host_transfers"] == 1
    assert all(server._results[i].generation == server.generation == 2
               for i in range(16))


def test_rebuild_forces_a_full_reindex_and_bumps_generation():
    server, data, rng = _server(n=400, d=4)
    server.append(rng.random((20, 4)).astype(np.float32))
    assert len(server.index.parts) == 2
    g0, mu0 = server.generation, server.index.base.mu.copy()
    new = rng.random((30, 4)).astype(np.float32) + 0.5
    server.rebuild(new)
    assert server.generation > g0
    assert len(server.index.parts) == 1
    assert server.index._n_at_build == 450
    assert not np.array_equal(server.index.base.mu, mu0)
    ids, _ = server.query_batch(new[0][None], 1e-5)[0]
    assert 420 in ids.tolist()
    g1 = server.generation
    server.rebuild()
    assert server.generation > g1 and len(server.index.parts) == 1


def test_rebuild_does_not_build_twice_when_append_triggers_it(monkeypatch):
    rng = np.random.default_rng(3)
    server = SNNServer(rng.random((100, 4)).astype(np.float32),
                       SNNConfig(rebuild_ratio=2.0), device="cpu")
    calls = []
    real = tsnn.build_index
    monkeypatch.setattr(tsnn, "build_index",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    server.rebuild(rng.random((400, 4)).astype(np.float32))
    assert len(calls) == 1
    assert server.index._n_at_build == 500
    assert len(server.index.parts) == 1


# ----------------------------------------------------------------- tenants
def test_registry_routes_tenants_and_isolates_answers():
    rng = np.random.default_rng(3)
    cfg = SNNConfig()
    reg = IndexRegistry(cfg, device="cpu")
    reg.create("a", rng.random((500, 5)).astype(np.float32))
    reg.create("b", rng.random((700, 5)).astype(np.float32))
    server = SNNServer(registry=reg, cfg=cfg, device="cpu")
    q = rng.random(5).astype(np.float32)
    server._run_batch([_stamp(Request(query=q, radius=0.5, id=0,
                                      tenant="a")),
                       _stamp(Request(query=q, radius=0.5, id=1,
                                      tenant="b"))])
    for rid, name in ((0, "a"), (1, "b")):
        want = reg.get(name).index.query_radius_csr(q[None], 0.5)
        np.testing.assert_array_equal(server._results[rid].indices,
                                      want.row(0)[0])
    assert server._results[0].indices.size and server._results[1].indices.size
    with pytest.raises(ValueError):
        reg.create("a", rng.random((5, 5)).astype(np.float32))


@pytest.mark.parametrize("case", ["lru", "active"])
def test_registry_eviction(case):
    """LRU eviction drops the cold tenant's plan only, and it answers
    bit-identically after re-admission; the active tenant is never
    evicted, whatever the budget."""
    rng = np.random.default_rng(4)
    qs = rng.random((8, 5)).astype(np.float32)
    if case == "active":
        reg = IndexRegistry(SNNConfig(registry_memory_mb=0.0), device="cpu")
        reg.create("only", rng.random((400, 5)).astype(np.float32))
        reg.get("only").index.query_radius_csr(qs, 0.4)
        assert reg.plan_bytes("only") > 0
        assert reg.enforce_budget(active="only") == []
        assert reg.plan_bytes("only") > 0
        return
    reg = IndexRegistry(SNNConfig(registry_memory_mb=0.2), device="cpu")
    for name, seed in (("cold", 5), ("hot", 6)):
        reg.create(name, np.random.default_rng(seed)
                   .random((600, 5)).astype(np.float32))
    want = reg.get("cold").index.query_radius_csr(qs, 0.5)
    reg.touch("cold")
    assert reg.plan_bytes("cold") > 0
    reg.get("hot").index.query_radius_csr(qs, 0.5)
    reg.touch("hot")
    assert reg.bytes_planned() > reg.budget_bytes
    assert reg.enforce_budget(active="hot") == ["cold"]
    assert reg.plan_bytes("cold") == 0 and reg.plan_bytes("hot") > 0
    assert reg._evictions == 1 and reg.get("cold").index.n == 600
    again = reg.get("cold").index.query_radius_csr(qs, 0.5)
    np.testing.assert_array_equal(want.indptr, again.indptr)
    np.testing.assert_array_equal(want.indices, again.indices)
    np.testing.assert_array_equal(want.distances, again.distances)


def test_server_evicts_the_cold_tenant_between_batches():
    rng = np.random.default_rng(12)
    reg = IndexRegistry(SNNConfig(registry_memory_mb=0.2), device="cpu")
    for name, seed in (("a", 1), ("b", 2)):
        reg.create(name, np.random.default_rng(seed)
                   .random((600, 5)).astype(np.float32))
    server = SNNServer(registry=reg, cfg=reg.cfg, device="cpu")
    qs = rng.random((4, 5)).astype(np.float32)
    seen = {}
    for rnd, name in enumerate(("a", "b", "a", "b")):
        batch = [_stamp(Request(query=qs[i], radius=0.5, id=10 * rnd + i,
                                tenant=name)) for i in range(4)]
        server._run_batch(batch)
        assert reg.plan_bytes(name) > 0            # the active one stays
        got = [server._results[10 * rnd + i].indices for i in range(4)]
        if name in seen:
            for a, b in zip(seen[name], got):
                np.testing.assert_array_equal(a, b)
        seen[name] = got
    assert reg._evictions == 3


# ------------------------------------------------------- checkpoint drills
def test_checkpoint_save_kill_restore_parity(tmp_path):
    rng = np.random.default_rng(8)
    reg = IndexRegistry(SNNConfig(), checkpoint_root=str(tmp_path),
                        device="cpu")
    reg.create("t", rng.random((500, 5)).astype(np.float32))
    reg.get("t").index.append(rng.random((30, 5)).astype(np.float32))
    assert len(reg.get("t").index.parts) > 1
    step = reg.save("t")
    assert step == reg.get("t").index.generation == 1
    qs = rng.random((12, 5)).astype(np.float32)

    def serve(s):
        csr = reg.get("t").index.query_radius_csr(qs[s][None], 0.5)
        return csr.indptr.copy(), csr.indices.copy(), csr.distances.copy()

    want = [serve(s) for s in range(12)]
    drill = ReplicaDrill(serve_fn=serve,
                         restore_fn=lambda: reg.restore("t", device="cpu"),
                         total_steps=12)
    results, killed = drill.run(FailureInjector({5: "replica killed",
                                                 9: "replica killed"}))
    assert killed == [5, 9] and len(results) == 12
    for (a, b, c), (wa, wb, wc) in zip(results, want):
        np.testing.assert_array_equal(a, wa)
        np.testing.assert_array_equal(b, wb)
        np.testing.assert_array_equal(c, wc)
    restored = reg.get("t").index
    assert restored.n == 530 and restored.generation == 1
    ia, da = restored.query_knn(qs, 3)
    ib, db = tst.StreamingSNNIndex.from_state(
        *restored.state_leaves(), device="cpu").query_knn(qs, 3)
    np.testing.assert_array_equal(ia, ib)
    np.testing.assert_array_equal(da, db)
    with pytest.raises(FileNotFoundError):
        reg.restore("missing", device="cpu")


def test_a_dropped_server_frees_its_index_without_the_cycle_collector():
    """Nothing in a server, its registry and runtimes refers back to its
    owner, so dropping the server frees the index (and so its device
    memory) at once, warming on, after serving, appending and a tenant."""
    server, data, rng = _server(n=500)
    server.registry.create("other", rng.random((300, 6)).astype(np.float32))
    server._run_batch([_stamp(Request(query=data[0], radius=0.3, id=0)),
                       _stamp(Request(query=data[1], k=3, id=1))])
    server.append(rng.random((20, 6)).astype(np.float32))
    refs = [weakref.ref(server.index), weakref.ref(server.index.plan()),
            weakref.ref(server.registry.get("other").index)]
    gc.disable()
    try:
        del server
        assert all(r() is None for r in refs)
    finally:
        gc.enable()
