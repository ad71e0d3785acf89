#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` (nvcc, into
the ignored ``src/repro_torch/kernels/_build``), then runs three phases and
prints one ``ok``/``FAIL``/``--`` line per check or note:

1. each kernel against its plain PyTorch version on the card, on integer
   lattice inputs where every product is exact: counts equal, flat ids
   equal, dhalf bit-equal, sentinels in unwritten and trash slots, and the
   overflow guard writing nothing;
2. the port's main path at full size, on the SIFT-1M deployment of
   ``benchmarks/bench_table45_realworld.py`` (n = 1,000,000, d = 128,
   euclidean; data from that bench's stand-in recipe, seeded): ``build_index``
   on the card, ``query_radius_csr`` twice (classic, then fused),
   ``query_counts`` and ``mixed=True``, with the kernels' launch counts,
   and 64 sampled queries held against a float64 brute force;
3. each kernel's time at the main path's shapes beside its plain version,
   its bound and ``torch.matmul`` of the same product.

Exits non-zero on any failed check, and without a CUDA device.  The last
lines are the kernel table as JSON, the card's name and power limit, and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

SEED = 0
N_ROWS, DIM, N_QUERIES = 1_000_000, 128, 1024
TARGET_NEIGHBOURS = 1000
N_ORACLE = 64
# NVIDIA's data sheet for the H100 SXM at its 700 W limit: FP32 outside the
# tensor cores (FLOP/s) and device memory (bytes/s)
FP32_PEAK = 67e12
HBM_RATE = 3.35e12
EPS32 = 2.0 ** -23
DEVICE = "cuda"


class Checks:
    def __init__(self):
        self.failed: list[str] = []

    def ok(self, cond, msg: str) -> bool:
        cond = bool(cond)
        print(f"  {'ok' if cond else 'FAIL'}  {msg}", flush=True)
        if not cond:
            self.failed.append(msg)
        return cond

    @staticmethod
    def note(msg: str) -> None:
        print(f"  --  {msg}", flush=True)


def sift_standin(n: int, d: int, seed: int) -> np.ndarray:
    """benchmarks/bench_table45_realworld.py::_standin for the sift rows:
    |gaussian| with a decaying principal spectrum std_k ~ (k+1)^-0.7."""
    rng = np.random.default_rng(seed)
    spectrum = (np.arange(d) + 1.0) ** -0.7
    x = rng.normal(size=(n, d)) * spectrum[None, :]
    return np.abs(x).astype(np.float32)


def timed(torch, fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds of ``fn()`` on the card, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# --------------------------------------------------------------------------- #
# phase 1                                                                      #
# --------------------------------------------------------------------------- #
def lattice_operands(torch, ref, ke: int, seed: int):
    """A 2-segment stack of integer lattice points with exact alphas, half
    norms and thresholds (alpha = coordinate 0, extra projections =
    coordinates 1..ke), and 100 lattice queries padded to 128."""
    rng = np.random.default_rng(seed)
    S, n_pad, d, d_pad, m, m_pad = 2, 1024, 5, 128, 100, 128
    big = np.float32(ref.BIG)
    xs = np.zeros((S, n_pad, d_pad), np.float32)
    al = np.full((S, n_pad), big, np.float32)
    hn = np.full((S, n_pad), big, np.float32)
    px = np.full((S, max(ke, 1), n_pad), big, np.float32)
    for s, n_s in enumerate((900, 700)):
        pts = rng.integers(-4, 5, size=(n_s, d)).astype(np.float32)
        pts[:, 0] += 8 * s   # segment 1 sits further along alpha
        pts = pts[np.argsort(pts[:, 0], kind="stable")]
        xs[s, :n_s, :d] = pts
        al[s, :n_s] = pts[:, 0]
        hn[s, :n_s] = 0.5 * np.sum(pts * pts, axis=1)
        px[s, :ke, :n_s] = pts[:, 1:1 + ke].T
    q = np.zeros((m_pad, d_pad), np.float32)
    qi = rng.integers(-4, 5, size=(m, d)).astype(np.float32)
    qi[:, 0] += rng.integers(0, 9, size=m)
    q[:m, :d] = qi
    r = np.full(m_pad, -big, np.float32)
    th = np.full(m_pad, -big, np.float32)
    r[:m] = rng.choice([1.0, 1.5, 2.0, 2.5, 3.0], size=m)
    th[:m] = (r[:m] * r[:m] - np.sum(qi * qi, axis=1)) / 2.0
    aq = q[:, 0].copy()
    pq = np.ascontiguousarray(q[:, 1:1 + ke].T)
    dev = DEVICE
    ops = [torch.from_numpy(a).to(dev) for a in (q, aq, r, th, xs, al, hn)]
    if ke:
        ops += [torch.from_numpy(pq).to(dev),
                torch.from_numpy(np.ascontiguousarray(px[:, :ke])).to(dev)]
    else:
        ops += [None, None]
    return ops


def phase_kernels(torch, chk: Checks, K, ref, ops_mod) -> None:
    print("phase 1: kernels vs plain versions on exact lattice inputs")
    bn = 512
    for ke in (0, 2):
        q, aq, r, th, xs, al, hn, pq, px = lattice_operands(torch, ref, ke,
                                                            SEED + ke)
        args = (q, aq, r, th)
        p_per, p_part = ref.snn_count_stacked_ref(
            *args, xs, al, hn, pq, px, bn=bn, with_partials=True)
        total = int(p_per.sum())
        for mixed in (False, True):
            k_per, k_part = K.snn_count_stacked(
                *args, xs, al, hn, pq, px, bn=bn, mixed=mixed,
                with_partials=True)
            pm = ref.snn_count_stacked_ref(*args, xs, al, hn, pq, px, bn=bn,
                                           mixed=mixed)
            torch.cuda.synchronize()
            chk.ok(torch.equal(k_per, pm) and torch.equal(pm, p_per),
                   f"count ke={ke} mixed={mixed}: kernel == plain "
                   f"({total} survivors)")
            chk.ok(torch.equal(k_part, p_part),
                   f"count ke={ke} mixed={mixed}: per-block partials == plain")
        _, _, offsets = ref.stacked_prefix(p_per)
        nnz = ops_mod.csr_capacity(total)
        p_idx, p_dh = ref.snn_compact_stacked_ref(
            *args, offsets, xs, al, hn, pq, px, nnz=nnz)
        for handed in (True, False):
            part = K.snn_count_stacked(*args, xs, al, hn, pq, px, bn=bn,
                                       with_partials=True)[1] if handed else None
            k_idx, k_dh = K.snn_compact_stacked(
                *args, offsets, xs, al, hn, pq, px, nnz=nnz, bn=bn,
                partials=part)
            torch.cuda.synchronize()
            tag = f"compact ke={ke} partials={'handed' if handed else 'recounted'}"
            chk.ok(torch.equal(k_idx, p_idx), f"{tag}: idx == plain (nnz={total})")
            chk.ok(torch.equal(k_dh.view(torch.int32), p_dh.view(torch.int32)),
                   f"{tag}: dhalf bit-equal to plain")
            chk.ok(bool((k_idx[total:] == -1).all())
                   and bool((k_dh[total:] == ref.BIG).all())
                   and bool((k_idx[:total] >= 0).all()),
                   f"{tag}: -1/+BIG in the {nnz - total} unwritten and "
                   f"trash slots, every data slot written")
        k_idx, k_dh = K.snn_compact_stacked(*args, offsets, xs, al, hn, pq,
                                            px, nnz=total, bn=bn)
        torch.cuda.synchronize()
        chk.ok(bool((k_idx == -1).all()) and bool((k_dh == ref.BIG).all()),
               f"compact ke={ke}: overflow guard (nnz={total} < total + 1) "
               f"writes nothing")


# --------------------------------------------------------------------------- #
# phase 2                                                                      #
# --------------------------------------------------------------------------- #
def calibrate_radius(torch, index, q: np.ndarray) -> float:
    """A radius that gives about TARGET_NEIGHBOURS neighbours per query on
    average over 64 queries: the matching quantile of their pooled
    distances to every row."""
    xq, _ = index.prepare_queries(q[:64], 1.0)
    qd = torch.from_numpy(xq).to(DEVICE)
    d2 = (2.0 * index.half_norms[:, None] - 2.0 * (index.xs @ qd.T)
          + (qd * qd).sum(1)[None, :])
    kth = torch.kthvalue(d2.reshape(-1).cpu(), TARGET_NEIGHBOURS * 64).values
    return float(np.sqrt(max(float(kth), 0.0)))


def oracle_rows(index, xs64, hn64, q: np.ndarray, radius: float):
    """Float64 brute force over the index's own float32 rows: per query the
    sorted positions with ||x - q||^2 <= r^2 (as dhalf64 <= thresh64), the
    dhalf64 values, thresh64 and the rounding band's half width
    d * 2^-23 * (hn + sum_k |q_k x_k|) + 2^-23 * |thresh|."""
    xq, r = index.prepare_queries(q, radius)
    xq64 = xq.astype(np.float64)
    thresh64 = (r * r - np.einsum("ij,ij->i", xq64, xq64)) / 2.0
    dhalf64 = hn64[:, None] - xs64 @ xq64.T
    absdot = np.abs(xs64) @ np.abs(xq64).T
    tol = DIM * EPS32 * (hn64[:, None] + absdot) + EPS32 * np.abs(thresh64)
    return dhalf64, thresh64, tol


def compare_with_oracle(index, res, rows, xs64, hn64, q, radius):
    """(band pairs, equal pairs, pairs outside the band that differ)."""
    dhalf64, thresh64, tol = oracle_rows(index, xs64, hn64, q[rows], radius)
    inv = np.empty_like(index.order)
    inv[index.order] = np.arange(index.order.size)
    band = equal = bad = 0
    for k, i in enumerate(rows):
        got = inv[res.row(i)[0]]                   # sorted positions
        keep64 = dhalf64[:, k] <= thresh64[k]
        want = np.nonzero(keep64)[0]
        inband = np.abs(dhalf64[:, k] - thresh64[k]) <= tol[:, k]
        diff = np.setxor1d(got, want)
        band += int(inband[diff].sum())
        bad += int((~inband[diff]).sum())
        g = got[~inband[got]]
        w = want[~inband[want]]
        if not np.array_equal(g, w):   # same set outside the band, same order
            bad += 1
        equal += int(np.intersect1d(got, want).size)
    return band, equal, bad


def fused_split(torch, chk: Checks, index, q, radius, engine, snn) -> None:
    """Host-clock split of one fused batch into the stages of
    `engine.query_csr_packed`: host query prep, the engine (device passes
    and the one device-to-host copy), and the host float64 finalize."""
    from repro_torch.kernels import ops as ops_mod

    pack = index.pack(512, DEVICE)
    t0 = time.perf_counter()
    xq, aq, r, th, qsq = snn.prepare_query_predicates(index, q, radius)
    qp, aqp, rp, thp, m = ops_mod.pad_queries(xq, aq, r, th, tq=128,
                                              bucket=True)
    pq = snn.query_extra_projections(index, xq)
    pqp = ops_mod.pad_components(pq, qp.shape[0])
    t1 = time.perf_counter()
    indptr, counts, ids, dh = engine.run_csr_packed(pack, qp, aqp, rp, thp,
                                                    m, pq=pqp)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    snn.csr_finalize(index, indptr, ids, dh, xq, qsq, counts, True)
    t3 = time.perf_counter()
    chk.note(f"fused batch split (host clock): prep {1e3 * (t1 - t0):.3f} ms, "
             f"engine incl. copy {1e3 * (t2 - t1):.3f} ms, float64 finalize "
             f"{1e3 * (t3 - t2):.3f} ms")


def phase_main_path(torch, chk: Checks, K, snn, engine, join):
    print(f"phase 2: main path, n={N_ROWS} d={DIM} m={N_QUERIES} "
          "(sift1m of bench_table45_realworld, euclidean)")
    t0 = time.perf_counter()
    x = sift_standin(N_ROWS, DIM, SEED)
    q = sift_standin(N_QUERIES, DIM, SEED + 1)
    chk.note(f"data made in {time.perf_counter() - t0:.2f} s (host, set-up)")

    def clock(label, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        chk.note(f"{label}: {1e3 * (time.perf_counter() - t):.3f} ms "
                 "(host clock, synchronized)")
        return out

    index = clock("build_index", lambda: snn.build_index(x, device=DEVICE))
    chk.ok(index.device.type == torch.device(DEVICE).type,
           f"index built on {index.device}")
    radius = calibrate_radius(torch, index, q)
    chk.note(f"radius {radius!r} (about {TARGET_NEIGHBOURS} neighbours a "
             "query over 64 queries)")

    K.reset_launch_counts()
    stats = engine.DISPATCH_STATS
    stats.reset()
    classic = clock("query_radius_csr #1 (classic)",
                    lambda: snn.query_radius_csr(index, q, radius,
                                                 device=DEVICE))
    s_classic = stats.snapshot()
    stats.reset()
    fused = clock("query_radius_csr #2 (fused)",
                  lambda: snn.query_radius_csr(index, q, radius,
                                               device=DEVICE))
    s_fused = stats.snapshot()
    fused_split(torch, chk, index, q, radius, engine, snn)
    counts = clock("query_counts",
                   lambda: join.query_counts(index, q, radius,
                                            device=DEVICE))
    mixed = clock("query_radius_csr mixed=True",
                  lambda: snn.query_radius_csr(index, q, radius, mixed=True,
                                                device=DEVICE))
    torch.cuda.synchronize()
    launches = {"snn_count_stacked": K.snn_count_stacked.launches,
                "snn_compact_stacked": K.snn_compact_stacked.launches}
    chk.note(f"dispatch: classic {s_classic}, fused {s_fused}")
    chk.note(f"main-path kernel launches {launches}; nnz {classic.nnz} "
             f"({classic.nnz / N_QUERIES:.1f} per query); peak device memory "
             f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    chk.ok(all(v > 0 for v in launches.values()),
           "both kernels launched on the main path")
    chk.ok(s_classic["host_transfers"] == 3 and s_fused["host_transfers"] == 1,
           "first batch classic (3 host transfers), second fused (1)")
    chk.ok(np.array_equal(classic.indptr, fused.indptr)
           and np.array_equal(classic.indices, fused.indices)
           and np.array_equal(classic.distances, fused.distances),
           "classic and fused batches bit-identical")
    chk.ok(np.array_equal(classic.indptr, mixed.indptr)
           and np.array_equal(classic.indices, mixed.indices)
           and np.array_equal(classic.distances, mixed.distances),
           "mixed=True identical to mixed=False")
    chk.ok(np.array_equal(counts, np.diff(classic.indptr)),
           "query_counts == diff(indptr)")
    chk.ok(bool(np.all(np.isfinite(classic.distances)))
           and bool(np.all(classic.distances <= radius * (1 + 1e-4)))
           and classic.indices.min() >= 0 and classic.indices.max() < N_ROWS,
           "finite distances within the radius, ids in range")

    t = time.perf_counter()
    xs64 = index.xs.cpu().numpy().astype(np.float64)
    hn64 = 0.5 * np.einsum("ij,ij->i", xs64, xs64)
    rows = np.random.default_rng(SEED + 2).choice(N_QUERIES, N_ORACLE,
                                                  replace=False)
    band, equal, bad = compare_with_oracle(index, classic, rows, xs64, hn64,
                                           q, radius)
    chk.note(f"float64 brute force on {N_ORACLE} queries: "
             f"{time.perf_counter() - t:.2f} s (host)")
    chk.ok(bad == 0, f"{N_ORACLE} sampled queries vs float64 brute force: "
           f"{equal} pairs equal, {band} pairs inside the rounding band "
           f"d*2^-23*(hn + sum|q x|) + 2^-23*|thresh| excluded, {bad} outside")
    return index, q, radius, launches, xs64, hn64


# --------------------------------------------------------------------------- #
# phase 3                                                                      #
# --------------------------------------------------------------------------- #
def csr_pairs(per, idx, dh):
    """{(query, pack-flat id): dhalf} of a flat CSR output."""
    counts = per.sum(0).cpu().numpy()
    total = int(counts.sum())
    qrow = np.repeat(np.arange(counts.size), counts)
    ids = idx[:total].cpu().numpy()
    return qrow, ids, dh[:total].cpu().numpy()


def phase_times(torch, chk: Checks, K, ref, ops_mod, snn, index, q, radius,
                launches, xs64, hn64):
    print("phase 3: kernel times at the main path's shapes")
    pack = index.pack(512, DEVICE)
    xq, aq, r32, th, _ = snn.prepare_query_predicates(index, q, radius)
    qp, aqp, rp, thp, m = ops_mod.pad_queries(xq, aq, r32, th, tq=128,
                                              bucket=True)
    pq = snn.query_extra_projections(index, xq)
    pqp = ops_mod.pad_components(pq, qp.shape[0])
    dev = torch.device(DEVICE)
    qd, aqd, rd, thd, pqd = (torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                             for a in (qp, aqp, rp, thp, pqp))
    xs, al, hn, _ = pack.stacked()
    px = pack.stacked_projs()
    S, n_pad, d_pad = xs.shape
    m_pad = qd.shape[0]
    bn = pack.block
    args = (qd, aqd, rd, thd)

    k_per, k_part = K.snn_count_stacked(*args, xs, al, hn, pqd, px, bn=bn,
                                        with_partials=True)
    p_per = ref.snn_count_stacked_ref(*args, xs, al, hn, pqd, px, bn=bn)
    _, _, k_off = ref.stacked_prefix(k_per)
    _, _, p_off = ref.stacked_prefix(p_per)
    k_total, p_total = int(k_per.sum()), int(p_per.sum())
    nnz = ops_mod.csr_capacity(max(k_total, p_total))
    k_idx, k_dh = K.snn_compact_stacked(*args, k_off, xs, al, hn, pqd, px,
                                        nnz=nnz, bn=bn, partials=k_part)
    p_idx, p_dh = ref.snn_compact_stacked_ref(*args, p_off, xs, al, hn, pqd,
                                              px, nnz=nnz)
    torch.cuda.synchronize()
    count_err = int((k_per - p_per).abs().max())
    # pair sets: differences may only lie in the rounding band
    kq, kid, kdh = csr_pairs(k_per, k_idx, k_dh)
    pq_, pid, pdh = csr_pairs(p_per, p_idx, p_dh)
    kkey = kq.astype(np.int64) * (S * n_pad) + kid
    pkey = pq_.astype(np.int64) * (S * n_pad) + pid
    common, ki, pi = np.intersect1d(kkey, pkey, return_indices=True)
    diff = np.setxor1d(kkey, pkey)
    dq, dj = diff // (S * n_pad), diff % (S * n_pad)
    thr = thp.astype(np.float64)
    xq64 = qp.astype(np.float64)
    d64 = hn64[dj] - np.einsum("ij,ij->i", xs64[dj], xq64[dq, :DIM])
    tol_d = DIM * EPS32 * (hn64[dj] + np.einsum(
        "ij,ij->i", np.abs(xs64[dj]), np.abs(xq64[dq, :DIM]))) \
        + EPS32 * np.abs(thr[dq])
    out_of_band = int((np.abs(d64 - thr[dq]) > tol_d).sum())
    cj, cq = kid[ki], kq[ki]
    tol_c = DIM * EPS32 * (hn64[cj] + np.einsum(
        "ij,ij->i", np.abs(xs64[cj]), np.abs(xq64[cq, :DIM])))
    dh_err = np.abs(kdh[ki].astype(np.float64) - pdh[pi].astype(np.float64))
    compact_err = float(dh_err.max()) if dh_err.size else 0.0
    chk.ok(out_of_band == 0 and bool(np.all(dh_err <= tol_c)),
           f"kernel vs plain at main-path shapes: {common.size} pairs common, "
           f"{diff.size} differing pairs all inside the band; count max |diff| "
           f"{count_err}; dhalf max |diff| {compact_err:.3e} within "
           "d*2^-23*(hn + sum|q x|)")

    reps = 10
    k_count_ms = timed(torch, lambda: K.snn_count_stacked(
        *args, xs, al, hn, pqd, px, bn=bn, with_partials=True), reps)
    k_mixed_ms = timed(torch, lambda: K.snn_count_stacked(
        *args, xs, al, hn, pqd, px, bn=bn, mixed=True, with_partials=True),
        reps)
    k_compact_ms = timed(torch, lambda: K.snn_compact_stacked(
        *args, k_off, xs, al, hn, pqd, px, nnz=nnz, bn=bn, partials=k_part),
        reps)
    p_count_ms = timed(torch, lambda: ref.snn_count_stacked_ref(
        *args, xs, al, hn, pqd, px, bn=bn, with_partials=True), 3)
    p_compact_ms = timed(torch, lambda: ref.snn_compact_stacked_ref(
        *args, p_off, xs, al, hn, pqd, px, nnz=nnz), 3)
    xs0 = xs[0]
    lib_ms = timed(torch, lambda: torch.matmul(qd, xs0.T), reps)

    # the work this data needs: every pair inside its query's alpha window
    al_host = al[0].cpu().numpy().astype(np.float64)
    aq64, r64 = aqp[:m].astype(np.float64), rp[:m].astype(np.float64)
    lo = np.searchsorted(al_host, aq64 - r64, side="left")
    hi = np.searchsorted(al_host, aq64 + r64, side="right")
    pairs = int(np.sum(hi - lo))
    flops = 2.0 * DIM * pairs
    in_bytes = 4 * (qd.numel() + 3 * m_pad + xs.numel() + 2 * S * n_pad
                    + pqd.numel() + px.numel())
    count_bytes = in_bytes + 4 * S * m_pad * (1 + n_pad // bn)
    compact_bytes = in_bytes + 4 * S * m_pad * (1 + n_pad // bn) + 8 * nnz

    def bound(nbytes):
        t_ops, t_bytes = flops / FP32_PEAK, nbytes / HBM_RATE
        return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                           else "bytes")

    c_bound, c_by = bound(count_bytes)
    p_bound, p_by = bound(compact_bytes)
    chk.note(f"alpha-window pairs {pairs} of {m * N_ROWS} "
             f"({pairs / (m * N_ROWS):.4f}); {flops:.4e} FP32 operations a pass")
    chk.note(f"count   kernel {k_count_ms:.4f} ms, mixed {k_mixed_ms:.4f} ms, "
             f"plain {p_count_ms:.4f} ms, bound {c_bound:.4f} ms ({c_by}), "
             f"torch.matmul {lib_ms:.4f} ms; "
             f"{flops / k_count_ms / 1e9:.2f} TFLOP/s")
    chk.note(f"compact kernel {k_compact_ms:.4f} ms, plain {p_compact_ms:.4f} "
             f"ms, bound {p_bound:.4f} ms ({p_by}); "
             f"{flops / k_compact_ms / 1e9:.2f} TFLOP/s")
    src = "src/repro_torch/kernels/csrc/snn_query.cu"
    return [
        {"name": "snn_count_stacked", "route": "cuda", "source": src,
         "replaces": "src/repro/kernels/snn_query.py:447",
         "launches": launches["snn_count_stacked"],
         "max_abs_err": float(count_err), "ms": k_count_ms,
         "plain_ms": p_count_ms, "bound_ms": c_bound, "bound_by": c_by,
         "library_ms": lib_ms, "mixed_ms": k_mixed_ms},
        {"name": "snn_compact_stacked", "route": "cuda", "source": src,
         "replaces": "src/repro/kernels/snn_query.py:549",
         "launches": launches["snn_compact_stacked"],
         "max_abs_err": compact_err, "ms": k_compact_ms,
         "plain_ms": p_compact_ms, "bound_ms": p_bound, "bound_by": p_by,
         "library_ms": lib_ms},
    ]


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout
    return out.strip().splitlines()[0]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    # full float32 in every PyTorch product this script compares against
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import engine, join, snn
    from repro_torch.kernels import ops as ops_mod
    from repro_torch.kernels import ref
    from repro_torch.kernels import snn_query as K

    t_start = time.perf_counter()
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t = time.perf_counter()
    lib = K.build()
    print(f"build: {lib.relative_to(ROOT)} in {time.perf_counter() - t:.2f} s")
    for line in K.build_log().splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            print(f"  {line.strip()}")
    chk = Checks()
    phase_kernels(torch, chk, K, ref, ops_mod)
    if chk.failed:
        print(f"FAILED: {chk.failed}", file=sys.stderr)
        return 1
    index, q, radius, launches, xs64, hn64 = phase_main_path(
        torch, chk, K, snn, engine, join)
    kernels = phase_times(torch, chk, K, ref, ops_mod, snn, index, q, radius,
                          launches, xs64, hn64)
    if chk.failed:
        print(f"FAILED: {chk.failed}", file=sys.stderr)
        return 1
    print(f"run: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
