"""The port's kernel modules against the JAX reference (repro.kernels).

The same inputs, made from a numpy seed, go through the JAX package's plain
versions (and, on one small case, its Pallas TPU kernels in interpret mode)
and through the port's.  The inputs are integer lattices, on which every
product and every threshold is exact in float32, so the tolerance is zero:
counts and flat ids equal, dhalf bit-equal.

The CUDA kernels themselves run only on the card; ``test_torch_cuda.py``
holds them against their plain versions there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import snn_query as jsq
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import registry as treg
from repro_torch.kernels import snn_query as tsq


def _lattice_stack(seed, ke, S=2, n_pad=256, d=5, d_pad=128, m=27, m_pad=32):
    """A segment stack of lattice points (alpha = coordinate 0, the extra
    projections = coordinates 1..ke) and lattice queries, padded by the
    reference contract; returns float32 numpy operands."""
    rng = np.random.default_rng(seed)
    big = np.float32(jref.BIG)
    xs = np.zeros((S, n_pad, d_pad), np.float32)
    al = np.full((S, n_pad), big, np.float32)
    hn = np.full((S, n_pad), big, np.float32)
    px = np.full((S, ke, n_pad), big, np.float32)
    for s in range(S):
        n_s = n_pad - 40 * (s + 1)
        pts = rng.integers(-3, 4, size=(n_s, d)).astype(np.float32)
        pts[:, 0] += 5 * s
        pts = pts[np.argsort(pts[:, 0], kind="stable")]
        xs[s, :n_s, :d] = pts
        al[s, :n_s] = pts[:, 0]
        hn[s, :n_s] = 0.5 * np.sum(pts * pts, axis=1)
        px[s, :, :n_s] = pts[:, 1:1 + ke].T
    qi = rng.integers(-3, 4, size=(m, d)).astype(np.float32)
    qi[:, 0] += rng.integers(0, 6, size=m)
    r = rng.choice([1.0, 1.5, 2.0, 2.5, 3.0], size=m).astype(np.float32)
    th = ((r * r - np.sum(qi * qi, axis=1)) / 2.0).astype(np.float32)
    q, aq, r, th, _ = tops.pad_queries(qi, qi[:, 0], r, th, tq=m_pad)
    pq = tops.pad_components(qi[:, 1:1 + ke].T, m_pad)
    return q, aq, r, th, xs, al, hn, (pq if ke else None), (px if ke else None)


def _torch(arrs):
    return [None if a is None else torch.from_numpy(np.ascontiguousarray(a))
            for a in arrs]


def _jax(arrs):
    return [None if a is None else jnp.asarray(a) for a in arrs]


@pytest.mark.parametrize("ke", [0, 2])
@pytest.mark.parametrize("mixed", [False, True])
def test_plain_count_stacked_matches_reference(ke, mixed):
    ops = _lattice_stack(11 + ke, ke)
    want = np.asarray(jref.snn_count_stacked_ref(*_jax(ops), n_seg=2,
                                                 mixed=mixed))
    got, partials = tref.snn_count_stacked_ref(*_torch(ops), bn=128,
                                               mixed=mixed,
                                               with_partials=True)
    assert want.sum() > 0
    np.testing.assert_array_equal(got.numpy(), want)
    # the per-row-block partials sum to the counts
    np.testing.assert_array_equal(partials.sum(dim=2).numpy(), want)


@pytest.mark.parametrize("ke", [0, 2])
def test_plain_compact_stacked_and_prefix_match_reference(ke):
    ops = _lattice_stack(21 + ke, ke)
    q, aq, r, th, xs, al, hn, pq, px = ops
    per = jref.snn_count_stacked_ref(*_jax(ops), n_seg=2)
    counts_j, indptr_j, off_j = jref.stacked_prefix(per)
    counts_t, indptr_t, off_t = tref.stacked_prefix(
        torch.from_numpy(np.array(per)))
    for a, b in ((counts_j, counts_t), (indptr_j, indptr_t),
                 (off_j, off_t)):
        assert b.dtype == torch.int32
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    total = int(indptr_j[-1])
    nnz = tops.csr_capacity(total)
    assert nnz == jops.csr_capacity(total)
    wi, wd = jref.snn_compact_stacked_ref(
        *_jax((q, aq, r, th)), off_j, *_jax((xs, al, hn, pq, px)), n_seg=2,
        nnz=nnz)
    gi, gd = tref.snn_compact_stacked_ref(
        *_torch((q, aq, r, th)), off_t, *_torch((xs, al, hn, pq, px)),
        nnz=nnz)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gd.numpy().view(np.int32),
                                  np.asarray(wd).view(np.int32))
    assert (gi.numpy()[total:] == -1).all()
    # the overflow guard writes nothing
    oi, od = tref.snn_compact_stacked_ref(
        *_torch((q, aq, r, th)), off_t, *_torch((xs, al, hn, pq, px)),
        nnz=total)
    assert (oi.numpy() == -1).all() and (od.numpy() == tref.BIG).all()


@pytest.mark.parametrize("mixed", [False, True])
def test_plain_versions_match_pallas_tpu_interpret(mixed):
    # the TPU kernels themselves, run by Pallas' interpreter, on one small
    # case with the box prune on
    ops = _lattice_stack(5, 2, n_pad=128, m=13, m_pad=16)
    q, aq, r, th, xs, al, hn, pq, px = ops
    per_k = np.asarray(jsq.snn_count_stacked(*_jax(ops), tq=16, bn=64,
                                             interpret=True, mixed=mixed))
    per_t = tref.snn_count_stacked_ref(*_torch(ops), bn=64, mixed=mixed)
    assert per_k.sum() > 0
    np.testing.assert_array_equal(per_t.numpy(), per_k)
    if mixed:
        return
    _, _, off = tref.stacked_prefix(per_t)
    nnz = tops.csr_capacity(int(per_t.sum()))
    ki, kd = jsq.snn_compact_stacked(
        *_jax((q, aq, r, th)), jnp.asarray(off.numpy()),
        *_jax((xs, al, hn, pq, px)), nnz=nnz, tq=16, bn=64, interpret=True)
    ti, td = tref.snn_compact_stacked_ref(
        *_torch((q, aq, r, th)), off, *_torch((xs, al, hn, pq, px)), nnz=nnz)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ki))
    np.testing.assert_array_equal(td.numpy().view(np.int32),
                                  np.asarray(kd).view(np.int32))


def test_formulas_match_reference():
    rng = np.random.default_rng(3)
    m, n = 9, 40
    r = rng.uniform(0.1, 2.0, m).astype(np.float32)
    r[-1] = -jref.BIG                       # a padding query overflows to inf
    th = rng.uniform(-2.0, 1.0, m).astype(np.float32)
    th[-1] = -jref.BIG
    hn = rng.uniform(0.0, 3.0, n).astype(np.float32)
    hn[-3:] = jref.BIG                      # padding rows
    pq = rng.normal(size=(2, m)).astype(np.float32)
    px = rng.normal(size=(2, n)).astype(np.float32)
    for a, b in zip(jref.norm_scales(*_jax((r, th, hn))),
                    tref.norm_scales(*_torch((r, th, hn)))):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    np.testing.assert_array_equal(
        tref.box_mask(*_torch((pq, px, r, th, hn))).numpy(),
        np.asarray(jref.box_mask(*_jax((pq, px, r, th, hn)))))
    assert (tref.BIG, tref.BOX_EPS, tref.MIX_EPS) == \
        (jref.BIG, jref.BOX_EPS, jref.MIX_EPS)


def test_padding_contract_matches_reference():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(700, 13)).astype(np.float32)
    al = np.sort(rng.normal(size=700)).astype(np.float32)
    hn = rng.uniform(size=700).astype(np.float32)
    want = jops.pad_database(x, al, hn, bn=512)
    got = tops.pad_database(*_torch((x, al, hn)), bn=512)
    for a, b in zip(want[:3], got[:3]):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert want[3:] == got[3:]
    q = rng.normal(size=(37, 13)).astype(np.float32)
    for bucket in (False, True):
        w = jops.pad_queries(q, q[:, 0], q[:, 1], q[:, 2], tq=32,
                             bucket=bucket)
        g = tops.pad_queries(q, q[:, 0], q[:, 1], q[:, 2], tq=32,
                             bucket=bucket)
        for a, b in zip(w[:4], g[:4]):
            np.testing.assert_array_equal(b, np.asarray(a))
        assert w[4] == g[4]
    p = rng.normal(size=(2, 37)).astype(np.float32)
    np.testing.assert_array_equal(tops.pad_components(p, 64, tops.BIG),
                                  np.asarray(jops.pad_components(p, 64,
                                                                 jops.BIG)))
    for m in (0, 1, 128, 129, 1000):
        assert tops.bucket_rows(m) == jops.bucket_rows(m)
    for t in (0, 1, 127, 128, 5000):
        assert tops.csr_capacity(t) == jops.csr_capacity(t)


def test_registry_sends_cpu_tensors_to_plain_versions():
    ops = _torch(_lattice_stack(9, 2))
    tsq.reset_launch_counts()
    treg.reset_compile_counts()
    per = treg.snn_count_stacked(*ops, bn=128)
    again = treg.snn_count_stacked(*ops, bn=128)
    np.testing.assert_array_equal(
        per.numpy(), tref.snn_count_stacked_ref(*ops, bn=128).numpy())
    assert torch.equal(per, again)
    # no kernel launched for CPU tensors; one signature for two calls
    assert tsq.snn_count_stacked.launches == 0
    assert treg.compile_counts() == {"snn_count_stacked": 1}


def test_kernel_wrappers_refuse_cpu_tensors():
    ops = _torch(_lattice_stack(9, 0))
    q, aq, r, th, xs, al, hn, pq, px = ops
    tsq.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA tensors"):
        tsq.snn_count_stacked(*ops, bn=128)
    off = torch.zeros((2, q.shape[0]), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tsq.snn_compact_stacked(q, aq, r, th, off, xs, al, hn, nnz=128,
                                bn=128)
    assert tsq.snn_count_stacked.launches == 0
    assert tsq.snn_compact_stacked.launches == 0
