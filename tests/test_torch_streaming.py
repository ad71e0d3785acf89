"""The port's streaming LSM index (`core.streaming`) against the JAX
reference, with the engine pieces it needs (`SegmentPack.extend`,
`warm_plan`, `planned_bytes`).

The port takes the reference's state through `StreamingSNNIndex.from_state`
(the leaves of a JAX `state_leaves()` call), so both packages start from
the very same parts; then both take the same appends.  Everything runs on
the CPU (``device="cpu"``), where the port's engine runs the plain versions
of the kernels.  Inputs are seeded numpy data, a few thousand rows, d <= 32.

Tolerances, and why:
* every delta and every merge is bit-equal to the reference's, leaf for
  leaf (`state_leaves`): both are computed by the same numpy and the same
  arithmetic-free merge;
* CSR indices and counts equal the reference's, with no pair inside the
  float32 band (`_assert_parity`); distances to rtol 1e-5;
* after a port-side `rebuild()` (its own power iteration) neighbour sets are
  checked against a float64 oracle, up to pairs inside the band;
* the packed and looped executors, a warmed and a cold plan, and a
  `from_state` copy answer bit for bit alike.
"""
import numpy as np
import pytest
from test_torch_snn import METRIC_CASES, _assert_parity

from repro.core import streaming as jst
from repro_torch.core import engine as tengine
from repro_torch.core import snn as tsnn
from repro_torch.core import streaming as tst

EPS32 = 2.0 ** -23


def _draw(rng, k, d):
    x = rng.normal(size=(k, d)).astype(np.float32)
    x[:, d // 2:] *= 0.5
    return x


def _pair(x, metric="euclidean", **kw):
    js = jst.StreamingSNNIndex(x, metric=metric, block=128, **kw)
    return js, tst.StreamingSNNIndex.from_state(*js.state_leaves(),
                                                device="cpu")


def _same_state(js, ts):
    jl, je = js.state_leaves()
    tl, te = ts.state_leaves()
    assert te == je
    assert len(tl) == len(jl)
    for a, b in zip(jl, tl):
        assert b.dtype == a.dtype and b.shape == a.shape
        np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("metric", sorted(METRIC_CASES))
def test_append_sequence_matches_reference_bit_for_bit(metric):
    rng = np.random.default_rng(3 + len(metric))
    d = 10
    js, ts = _pair(_draw(rng, 2500, d), metric, delta_ratio=10.0,
                   max_deltas=4, rebuild_ratio=100.0)
    q = _draw(rng, 30, d)
    radius = METRIC_CASES[metric][0]
    n_parts = []
    for gen in range(6):
        b = _draw(rng, 120, d)
        if metric == "mips":
            b *= np.float32(0.5)   # inside the base's lift: no rebuild
        js.append(b)
        ts.append(b)
        n_parts.append(len(ts.parts))
        assert ts.generation == js.generation == gen + 1
        _same_state(js, ts)
        want = js.query_radius_csr(q, radius)
        got = ts.query_radius_csr(q, radius)
        assert _assert_parity(js.base, q, radius, want, got) == 0
        np.testing.assert_allclose(got.distances, want.distances, rtol=1e-5)
        np.testing.assert_array_equal(ts.query_counts_device(q, radius),
                                      np.diff(got.indptr))
        np.testing.assert_array_equal(ts.query_counts(q, radius),
                                      js.query_counts(q, radius))
    # four deltas, then the fifth append merges into the base
    assert n_parts == [2, 3, 4, 5, 1, 2]


def test_merge_keeps_equal_alphas_of_the_first_run_first():
    # rows repeated across the base and the deltas tie in alpha exactly
    rng = np.random.default_rng(11)
    base = rng.integers(-2, 3, size=(400, 6)).astype(np.float32)
    js, ts = _pair(base, delta_ratio=0.1, max_deltas=8, rebuild_ratio=100.0)
    for b in (base[:30], base[10:60]):
        js.append(b)
        ts.append(b)
    assert len(ts.parts) == 1     # the second append merged (ratio 0.1)
    _same_state(js, ts)
    al = ts.base.alphas.numpy()
    assert np.all(np.diff(al) >= 0) and np.any(np.diff(al) == 0)
    # a merge of two tied runs is the stable sort of their concatenation
    a_ = ts.base
    b_ = tsnn.SNNIndex(a_.mu, a_.v1, a_.xs[::3].clone(),
                       a_.alphas[::3].clone(), a_.half_norms[::3].clone(),
                       a_.order[::3] + a_.n, vs=a_.vs,
                       projs=a_.projs[:, ::3].clone())
    m = tst.merge_sorted_indexes(a_, b_)
    cat = np.concatenate([a_.alphas.numpy(), b_.alphas.numpy()])
    perm = np.argsort(cat, kind="stable")
    np.testing.assert_array_equal(m.alphas.numpy(), cat[perm])
    np.testing.assert_array_equal(
        m.order, np.concatenate([a_.order, b_.order])[perm])
    np.testing.assert_array_equal(
        m.xs.numpy(), np.concatenate([a_.xs.numpy(), b_.xs.numpy()])[perm])


def test_rebuild_answers_match_a_float64_oracle():
    rng = np.random.default_rng(21)
    d = 8
    raw = _draw(rng, 2000, d)
    ts = tst.StreamingSNNIndex(raw, block=128, device="cpu")
    for _ in range(3):
        b = _draw(rng, 200, d)
        ts.append(b)
        raw = np.concatenate([raw, b])
    ts.rebuild()
    assert len(ts.parts) == 1 and ts.n == raw.shape[0]
    q = _draw(rng, 25, d)
    got = ts.query_radius_csr(q, 1.9)
    sq = np.sum((q.astype(np.float64)[:, None] - raw[None]) ** 2, axis=2)
    scale = np.sum(raw.astype(np.float64) ** 2, axis=1)[None] + np.sum(
        q.astype(np.float64) ** 2, axis=1)[:, None]
    band = np.abs(sq - 1.9 ** 2) <= 8 * d * EPS32 * (scale + 1.9 ** 2)
    for i in range(q.shape[0]):
        diff = np.setxor1d(got.row(i)[0], np.nonzero(sq[i] <= 1.9 ** 2)[0])
        assert np.all(band[i, diff])
    assert got.nnz > 0


def test_warmed_epochs_take_the_fused_path_and_count_their_warms():
    rng = np.random.default_rng(31)
    d = 12
    js, ts = _pair(_draw(rng, 3000, d), delta_ratio=10.0, max_deltas=2)
    ts.set_plan_warming(m_pads=(128,))
    q = _draw(rng, 60, d)
    ts.query_radius_csr(q, 2.0)   # the first plan learns its capacity
    for gen in range(4):          # extends, extends, merges, extends
        b = _draw(rng, 150, d)
        ts.append(b)
        js.append(b)
        tengine.DISPATCH_STATS.reset()
        got = ts.query_radius_csr(q, 2.0)
        s = tengine.DISPATCH_STATS.snapshot()
        assert s["kernel_launches"] == 3 and s["host_transfers"] == 1, gen
        assert ts.plan().epoch == ts.generation
        want = js.query_radius_csr(q, 2.0)
        np.testing.assert_array_equal(got.indices, want.indices)
    assert ts.warm_runs == 4 and ts.warm_failures == 0
    assert ts.plan_bytes() > 0
    ts.drop_plan()
    assert ts.plan_bytes() == 0
    again = ts.query_radius_csr(q, 2.0)
    np.testing.assert_array_equal(again.indices, got.indices)
    np.testing.assert_array_equal(again.distances, got.distances)


def test_a_warm_failure_is_counted_and_the_plan_still_answers(capsys):
    rng = np.random.default_rng(41)
    d = 8
    js, ts = _pair(_draw(rng, 1500, d))

    def broken(plan, spec_from):
        raise RuntimeError("warming failed on purpose")

    ts.set_plan_warming(warmer=broken)
    b = _draw(rng, 100, d)
    ts.append(b)
    js.append(b)
    assert ts.warm_runs == 1 and ts.warm_failures == 1
    assert "warming failed on purpose" in capsys.readouterr().err
    q = _draw(rng, 20, d)
    np.testing.assert_array_equal(ts.query_radius_csr(q, 1.8).indices,
                                  js.query_radius_csr(q, 1.8).indices)


def test_packed_false_and_from_state_answer_bit_identically():
    rng = np.random.default_rng(51)
    d = 16
    _, ts = _pair(_draw(rng, 2000, d))
    for _ in range(3):
        ts.append(_draw(rng, 200, d))
    q = _draw(rng, 40, d)
    packed = ts.query_radius_csr(q, 2.4)
    looped = ts.query_radius_csr(q, 2.4, packed=False)
    copy = tst.StreamingSNNIndex.from_state(*ts.state_leaves(), device="cpu")
    for res in (looped, copy.query_radius_csr(q, 2.4)):
        np.testing.assert_array_equal(res.indptr, packed.indptr)
        np.testing.assert_array_equal(res.indices, packed.indices)
        np.testing.assert_array_equal(res.distances, packed.distances)
    assert packed.nnz > 0
    np.testing.assert_array_equal(copy.query_knn(q, 8)[0],
                                  ts.query_knn(q, 8)[0])


def test_fixed_and_batch_paths_merge_parts_as_the_reference():
    rng = np.random.default_rng(61)
    d = 10
    js, ts = _pair(_draw(rng, 1800, d))
    for _ in range(2):
        b = _draw(rng, 300, d)
        js.append(b)
        ts.append(b)
    q = _draw(rng, 25, d)
    wi, ws, wv, wc = js.query_radius_fixed(q, 2.2, 20)
    gi, gs, gv, gc = ts.query_radius_fixed(q, 2.2, 20)
    np.testing.assert_array_equal(gc, wc)
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gs, ws, rtol=1e-5, atol=1e-5)
    for a, b in zip(ts.query_radius_batch(q, 2.2, return_distance=False),
                    js.query_radius_batch(q, 2.2, return_distance=False)):
        np.testing.assert_array_equal(a, b)


def test_append_rejects_bad_shapes_and_copies_its_batch():
    rng = np.random.default_rng(71)
    _, ts = _pair(_draw(rng, 500, 6))
    with pytest.raises(ValueError, match="append expects"):
        ts.append(np.zeros((3, 5), np.float32))
    ts.append(np.zeros((0, 6), np.float32))
    assert ts.generation == 0
    b = _draw(rng, 10, 6)
    ts.append(b)
    b[:] = 99.0
    assert not np.any(ts.raw == 99.0)


def test_extend_equals_a_pack_built_whole():
    rng = np.random.default_rng(81)
    idx = tsnn.build_index(_draw(rng, 900, 8), device="cpu")
    segs = tengine.segments_from_index(idx, rows_per_segment=256, block=128)
    first = tengine.SegmentPack.build(segs[:2])
    first.stacked()
    first.stacked_projs()
    ext = first.extend(segs[2:])
    whole = tengine.SegmentPack.build(segs)
    assert ext.epoch == first.epoch + 1 and ext._stacked is not None
    for a, b in zip(ext.stacked(), whole.stacked()):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(ext.stacked_projs().numpy(),
                                  whole.stacked_projs().numpy())
    for f in ("alpha_lo", "alpha_hi", "proj_lo", "proj_hi", "xnorm_max"):
        np.testing.assert_array_equal(getattr(ext, f), getattr(whole, f))
    assert first.extend([]) is first
    # a plan not yet stacked stays lazy
    assert tengine.SegmentPack.build(segs[:2]).extend(segs[2:])._stacked \
        is None
