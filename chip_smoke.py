#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one nvcc per
source, all at once, into the ignored ``src/repro_torch/kernels/_build``),
then runs thirteen phases and prints one ``ok``/``FAIL``/``--`` line per check
or note, and each phase's time:

1. each kernel against its plain PyTorch version on the card, on integer
   lattice inputs where every product is exact: the stacked count and
   compact, the single-segment count, compact and filter; counts equal,
   flat ids equal, dhalf bit-equal, sentinels in unwritten and trash slots,
   the overflow guard writing nothing, and a capacity that cuts the rows
   short; on a small stack and on a sparse-survivor stack (most query
   tiles without a survivor in most row blocks, one tile with survivors
   for one query only, two survivors across a 128-row sub-tile boundary,
   a ragged m_pad of 300), each with the launch geometry it gets; and
   embedding_bag bit for bit on
   integer-valued float32 and bfloat16 tables (D 1/32/64/128, bags of
   1/40/100 ids with -1 padding and an all-padding bag, sum and mean);
2. the port's main path at full size, on the SIFT-1M deployment of
   ``benchmarks/bench_table45_realworld.py`` (n = 1,000,000, d = 128,
   euclidean; data from that bench's stand-in recipe, seeded): ``build_index``
   on the card, ``query_radius_csr`` twice (classic, then fused),
   ``query_counts`` and ``mixed=True``, with the kernels' launch counts, 64
   sampled queries held against a float64 brute force, and the looped
   executor (``packed=False``) bit-identical to the packed one;
2b. the eps-neighbour graph and DBSCAN on the first 262,144 of phase 2's
   rows, indexed on their own (the graph's work grows as n^2, so its depth
   is cut to keep the whole run well inside its time limit): the plain and
   the symmetric self-join at ``query_chunk=2048`` and 512-row segments
   (eps giving about 30 neighbours a point), DBSCAN labels of both, the
   graph's pairs and clusters equal to the recorded ones, sampled
   rows against ``query_radius_csr`` and a float64 brute force, the rows
   where the two graphs differ against the float64 brute force, the
   stacked kernels against their plain versions (and timed) on one graph
   chunk's live stack, and the looped executor over 8 sampled query chunks
   bit-identical to the packed one;
2d. (run after 2b) the sharded SNN on the same index, queries, radius and
   eps: ``query_radius_csr_sharded`` over 8 shards, packed twice (classic,
   then fused) and looped, bit-identical to phase 2's rows;
   ``build_neighbor_graph_sharded`` over the 8 shards of phase 2b's rows
   bit-identical to phase 2b's plain graph, timed beside it with its live shards a chunk,
   and sampled chunks' dhalf bit-identical to the 512-row segments'; NCCL
   at world size 1 (a file store in a temporary directory) with
   ``launch.mesh.make_host_mesh``: the count, percount and top-k functions
   (the filter kernel) against phase 2's CSR counts and rows;
   ``launch.snn_cell``'s service step, both ``prune`` variants, on the
   point-query cell against phase 2's counts (and its stacked count
   against the plain version at that stack) and at ``svc_10m``
   (10,485,760 x 128, seeded on the card) against a float64 brute force
   on 16 published queries and 64 perturbed data rows spread over the
   sorted order (pairs past byte 2^32 of the stack and in its last slab
   required), timed by CUDA events on the published traffic, its
   brute-force-equivalent FLOP rate, the window's work against the FP32
   peak, and its window fraction beside ``measured_window_fraction``;
2c. the front-ends over the engine on the same index and queries:
   ``query_knn`` at k = 100 (its expansion rounds and launches) against a
   float64 brute force top-100 on 64 queries, a per-query k and k > n;
   ``join_counts`` against the CSR counts, ``degree_histogram`` of phase 2b's
   points against its graph, ``reverse_neighbors`` against the
   forward CSR's transpose; the host Algorithm 2 ``query_radius_batch`` and
   ``query_radius_fixed`` (K = 1024, through the filter) against the CSR
   rows; DBSCAN's host backend ``snn`` against ``snn-csr`` on a 20,000-row
   subset; and the streaming index over the 1M rows with 8 warmed appends
   of 8,192 rows (a merge at the fifth), each generation against a float64
   brute force, then its looped executor, its kNN against a fresh index,
   a ``state_leaves``/``from_state`` restore and ``rebuild()``;
3. each kernel's time at the shapes its path gives it (by CUDA events a
   call, and the kernel alone on the card's clock by torch.profiler) beside
   its plain version, its bound and one PyTorch call of the same product,
   with the launch geometry, and at the graph's segment shape a block for
   every SM; the filter's finite entries at the main shape equal to the
   compact's survivors there bit for bit, and the pairs its 128 x 128
   tiles compute with the queries in alpha order, in the given order and
   in the alpha windows;
3b. the SNN server (``repro_torch.serving``) on phase 2's rows, queries and
   radius: one mixed batch (64 radius requests, a 64-row join of per-row
   radii, 32 counts, 16 reverse targets, 8 kNN at k = 100) as one fused
   CSR execution plus kNN's passes (`DISPATCH_STATS` across threads),
   every answer against the float64 brute force and bit for bit against
   the same request served alone; 2,048 requests at t = 0 under the
   deadline and the window policy, then Poisson arrivals at half the
   deadline policy's saturation rate (latency and queue delay p50/p99,
   qps, mean batch); a steady stream while a mutator thread appends 8 x
   8,192 rows and rebuilds (no warm failure, generations non-decreasing,
   no warm launch on the dispatcher, the first batch of each generation
   fused, then a batch equal to a ``from_state`` copy); a second tenant of
   1,000,000 rows under a budget just above one plan (evictions,
   bit-identical re-admission); a checkpoint drill (``ReplicaDrill``
   killing the replica twice, restores through ``IndexRegistry.restore``,
   a corrupt newest checkpoint skipped); the fixed path through the filter
   and the looped executor.  It fails on any error response, any batch
   that left the exact path and any failed warm;
4. the recsys serving path through ``launch.steps.build_step`` at full
   width: DLRM (the MLPerf stacked table, 187,767,424 x 128 bfloat16,
   48.07 GB), Wide & Deep and MIND, each at ``serve_p99`` (512) and
   ``serve_bulk`` (262,144), DLRM also on a batch drawn from each field's
   whole vocabulary; per step the embedding_bag launches, 512 sampled
   outputs against a float64 forward (and a TF32 control), the batch time
   and a torch.profiler breakdown of one bulk batch, and each lookup's ids
   held against the plain version bit for bit, with the path and order it
   took (for the blocked order, its range list against a torch.sort of the
   range keys), and timed beside the earlier design's recorded time, the
   plain version, F.embedding_bag, the write floor (every id -1) and the
   bound;
   the last rows of the 48 GB table; MIND's ``retrieval_cand`` (GEMM +
   top-100 over 1,000,000 items) and ``retrieve_above`` of its 4 capsules
   against a float64 brute force;
4b. recsys training and the ranking models' candidate scoring at full
   width: ``train_batch`` (65,536) of DLRM, Wide & Deep and MIND through
   `launch.train`'s step, one step held against the same step through the
   plain versions (bit for bit) and, for Wide & Deep and MIND, through a
   dense scatter-add gradient, DLRM's row gradient (78 rows) against a
   float64 sum of its 1.7M occurrences' gradients; then 5 steps, each
   timed by CUDA events, their losses finite, the launches, the peak
   memory (DLRM: less than a second table above the first, so no (V, D)
   gradient), a torch.profiler breakdown of a DLRM step and the row
   gradient's time; DLRM's and Wide & Deep's ``retrieval_cand`` over
   1,000,000 candidates, timed, its top-100 against a host stable sort of
   the whole score vector and sampled scores against a float64 forward of
   the bfloat16-rounded parameters;
5. LM serving through ``launch.steps.build_step`` with the parameters
   seeded on the card in bfloat16: (c) the 14 reduced serving cells on the
   card against the CPU; for nemotron-4-15b and internlm2-20b at 8
   layers, minicpm3-4b at 16 (the run's time limit) and
   llama4-scout-17b-a16e and qwen3-moe-235b-a22b at 4 layers (one card's
   80 GB), ``prefill_32k`` at batch 1 (ms, tokens/s,
   model FLOP/s against the bf16 dense peak, peak memory), (d) 16 greedy
   tokens for 4 prompts of 256, (a) each of those decode steps against the
   forward's logits (bfloat16; float32 compute with a capacity that drops
   nothing for the MoE models), ``decode_32k`` (nemotron at batch 8,
   internlm2 4, minicpm3 32, llama4 8, qwen3 32) and llama4's
   ``long_500k`` (ms a step, bytes a step against the HBM peak, peak
   memory); (b) minicpm3-4b's bfloat16 prefill against float32 compute
   over the same weights, and cuBLAS's reduced-precision bfloat16
   reductions on against off; a profiled prefill (llama4) and decode step
   (nemotron); BERT4Rec's ``serve_p99``, ``serve_bulk`` and
   ``retrieval_cand`` at full width, timed and held against the CPU;
6. training through ``launch.steps.build_step`` and `launch.train`'s
   step (float32 parameters, gradients and AdamW moments): each LM's
   training state counted; (c) the 10 reduced training cells (the five
   LMs' ``train_4k``, BERT4Rec's ``train_batch``, the four ``gat-cora``
   shapes) on the card against the CPU, three steps; minicpm3-4b's
   ``train_4k`` at full width and 16 of 62 layers (the run's time limit)
   and
   qwen3-moe-235b-a22b's at 1 of 94 layers, each microbatch one sequence
   of 4,096 tokens, 2 and 8 microbatches a step: the first step by hand
   with the in-place AdamW of sampled leaves held bit for bit against the
   functional one, then 3 timed steps on the trainer's token stream (ms,
   tokens/s, model FLOP/s against the bf16 dense peak, peak memory, the
   losses), a profiled step and qwen3's dropped share; BERT4Rec's
   ``train_batch`` (65,536 sequences) and the four ``gat-cora`` shapes at
   full size (ogb_products: 2,449,029 nodes, 64,308,169 edges), 3 timed
   steps each after one untimed;
7. the distributed layer (``repro_torch.distributed``) under one NCCL
   group at world size 1 (a file store in a temporary directory, as 2d),
   ``make_host_mesh()`` on the card, with PyTorch's deterministic
   algorithms on (the MoE's scatter-adds otherwise differ run to run):
   (a) ``ring_allgather_matmul`` against a float64 product and
   ``compressed_psum`` in "none" and "int8" mode against the exact sum and
   the quantization done by hand; (b) the five reduced LMs' ``train_4k``
   on a (1, 1) mesh (ZeRO-3, tensor parallelism and the sequence
   parallelism of ``act_btd``, every collective a copy), its
   ``init_args`` shards gathering to the unsharded init, and 3
   steps bit-equal to the unsharded step (losses, norms, parameters,
   moments); (c) internlm2-20b at 4 of 48 layers and minicpm3-4b at 8 of
   62 at full width, the unsharded step then the sharded one (3 timed
   steps after an untimed one, 2 sequences of 4,096 tokens, peak memory),
   the sharded state bit-equal to the unsharded one; (d) the sharded
   serving steps on the (1, 1) mesh: the five reduced LMs' ``prefill_32k``
   and ``decode_32k`` and llama4's ``long_500k``, and nemotron-4-15b at 8
   of 32 layers and full width (``prefill_32k`` at batch 1,
   ``decode_32k`` at batch 8), each ``init_args`` gathering to the
   unsharded init and its logits and cache bit-equal to the unsharded
   step's, the full-width ones timed beside it with their peak memory;
   (e) the recsys and GAT steps on the (1, 1) mesh (the tables' row
   blocks through the embedding_bag kernel, the batch or the edges over
   the data axes): every reduced cell of the four recsys archs and the
   four ``gat-cora`` shapes, its ``init_args`` gathering to the unsharded
   init and its outputs (a training step's metrics and updated state)
   bit-equal to the unsharded step's; at full width Wide & Deep's,
   MIND's and BERT4Rec's ``train_batch`` (one step), ``serve_bulk`` and
   ``retrieval_cand`` and ``ogb_products`` (one step) bit-equal to the
   unsharded step and timed beside it; DLRM over one copy of its 48.07 GB
   table, shared by the unsharded model and the sharded one:
   ``serve_bulk`` and ``retrieval_cand`` bit-equal to the unsharded
   forward, and a sharded ``train_batch`` step whose loss equals the
   unsharded loss of the same batch, computed before it; the sharded
   steps' embedding_bag launches counted into the kernel line; one line
   with the forward calls of the sequence-parallel ops (the gathers and
   scatters of the sequence over "model", the prefill's last token) and
   of the GAT's node-row ops (``to_edges``, ``node_scatter``), each of
   which must have run;
8. the engine's host lane and the dry-run: (a) on the SIFT-1M stand-in
   (phase 2's data, index, queries and radius, made again) with the
   index's arrays on the host, ``oracle=True``: the compacted executor
   with the index's extra components, the pruned one (``compacted=False``)
   and the dense one under ``memory_budget_mb=512``, which its 4 GB filter
   sends to the looped host path; each against the card's CSR (pairs may
   differ only inside the float32 band) and a float64 brute force on 64
   queries, timed on the host clock with the CPU named; (b)
   ``snn_csr_compacted_stacked`` on CUDA tensors against the stacked
   kernels on the same pack (256 queries), with a ``ccap`` and an
   ``nnz_cap`` too small detected and rerun; (c) ``launch.dryrun`` at a
   (1, 1) mesh against the same sharded ``train_4k`` step on the card
   (internlm2-20b at 4 of 48 layers, minicpm3-4b at 8 of 62): its flops
   within 1% of FlopCounterMode's count there, its peak within 15% of
   ``max_memory_allocated``, the measured step beside the roofline's
   terms; then its estimates at (16, 16) and (2, 16, 16) for
   internlm2-20b ``train_4k``, minicpm3-4b ``train_4k`` (40 MLA heads
   over a "model" of 16: three on the traced rank) and ``snn-service``
   ``svc_10m``; (d) the
   card's bf16 and FP32 matmul peaks and a 4 GiB copy, each beside the
   data sheet's constant.

Before phase 1 it prints each kernel's registers, static shared memory
and spills from the build.  Exits non-zero on any failed check, without
a CUDA device, and when copied alone without the repository beside it.  The last lines are the kernel table as JSON, the
card's name and power limit, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import bisect
import dataclasses
import importlib
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from unittest import mock

import numpy as np

ROOT = Path(__file__).resolve().parent

SEED = 0
N_ROWS, DIM, N_QUERIES = 1_000_000, 128, 1024
TARGET_NEIGHBOURS = 1000
N_ORACLE = 64
# the graph phase: neighbours a point, DBSCAN's min_samples, the graph
# builder's schedule, and the rows and chunks it samples
GRAPH_NEIGHBOURS = 30
MIN_SAMPLES = 5
QUERY_CHUNK, SEGMENT_ROWS = 2048, 512
N_GRAPH_ROWS, N_GRAPH_ORACLE, N_LOOPED_CHUNKS = 256, 64, 8
# the graph's points: the first GRAPH_N rows of phase 2's data, an index of
# their own (128 query chunks of 512 segments each)
GRAPH_N = 262_144
# rows in which the plain and the symmetric graph may differ, each checked
# against the float64 brute force
MAX_DIFF_ROWS = 1024
# phase 2c: neighbours a kNN query (the k of ann-benchmarks' ground truth
# for sift-128-euclidean), query_radius_fixed's K, the rows of DBSCAN's host
# backend, and benchmarks/bench_streaming.py's full-size cell: appends of
# 8,192 rows, 8 of them, and the queries of the last generation's
# kernel-against-plain check on the streaming plan
KNN_K = 100
FIXED_K = 1024
DBSCAN_ROWS = 20_000
APPEND_ROWS, N_APPENDS = 8192, 8
STREAM_CHECK_Q = 256
# the graph of the GRAPH_N rows and its DBSCAN labelling as this script's
# earlier runs on the H100 found them (PERF.md, section 6): pairs,
# clusters, noise points, points in the largest cluster; an exact pass
# gives them again
GRAPH_RECORD = (8_204_206, 37, 57_145, 204_845)
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


def traced(torch, fn, reps: int = 1, kernels=(), launches=None,
           need: int | None = None):
    """The device activity of ``reps`` calls of ``fn`` under torch.profiler:
    for each call whose records are all there its (name, milliseconds)
    records, and the calls' wall milliseconds.

    The profiler can lose device records: CUPTI asks for its activity
    buffers when records arrive, and a record made before a buffer is there
    is dropped (the kernel is missing from the trace while its launch is in
    it).  It lost MIND's lookup, the first kernel of its forward, and after
    heavy work (phase 2c) the records of the first measured calls.  So
    two calls of ``fn`` run first in the same trace, and each measured
    call runs in a range of its own, the card synchronized after it, so a
    record belongs to the last call that began before it.  With ``kernels``
    (parts of kernel names) and ``launches`` (the wrappers' launch count so
    far), each call's records of those kernels are counted against the
    launches its wrappers made, and a call that lost one is left out.  A
    trace that keeps fewer than ``need`` calls (default: all) is taken
    again, up to three times; then the measurement fails."""
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.autograd.DeviceType.CUDA
    need, tries = (reps if need is None else need), 3
    for attempt in range(tries):
        torch.cuda.synchronize()
        made = [0] * reps
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(2):
                fn()
            torch.cuda.synchronize()
            t = time.perf_counter()
            for i in range(reps):
                with record_function(f"measured {i}"):
                    before = launches() if launches else 0
                    fn()
                    torch.cuda.synchronize()
                    made[i] = (launches() if launches else 0) - before
            wall = 1e3 * (time.perf_counter() - t)
        events = prof.events()
        starts = sorted((e.time_range.start, int(e.name.split()[1]))
                        for e in events if e.name.startswith("measured ")
                        and e.device_type != cuda)
        bounds = [st for st, _ in starts]
        calls: list[list] = [[] for _ in range(reps)]
        for e in events:
            if e.device_type == cuda and not e.name.startswith("measured"):
                k = bisect.bisect_right(bounds, e.time_range.start) - 1
                if k >= 0:
                    us = getattr(e, "device_time_total", None)
                    us = e.cuda_time_total if us is None else us
                    calls[starts[k][1]].append((e.name, us / 1e3))
        seen = [sum(any(k in name for k in kernels) for name, _ in c)
                for c in calls]
        whole = [c for c, m, n in zip(calls, made, seen)
                 if not launches or m == n]
        if len(whole) < reps:
            lost = [i for i, (m, n) in enumerate(zip(made, seen)) if m != n]
            print(f"  the profiler lost records of {len(lost)} of {reps} "
                  f"calls, calls {lost[:8]} (trace {attempt + 1} of {tries})")
        if len(whole) >= need:
            return whole, wall
    raise RuntimeError(f"torch.profiler kept {len(whole)} whole calls of "
                       f"{reps} in each of {tries} traces, {need} needed")


def device_ms(torch, K, fn, reps: int) -> float:
    """Mean milliseconds a call of ``fn()`` spends in the port's kernels
    (``snn_*``) on the card's own clock (torch.profiler, `traced`), without
    the host's time between launches, over the calls whose every launch has
    its record in the trace (at least half of them)."""
    calls, _ = traced(torch, fn, reps, kernels=("snn_",),
                      launches=lambda: sum(getattr(K, k).launches
                                           for k in SNN_KERNELS),
                      need=max(1, reps // 2))
    return sum(ms for c in calls for name, ms in c
               if "snn_" in name) / len(calls)


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


def sparse_operands(torch, ref, ke: int, seed: int):
    """A 2-segment stack of 12,288-row segments on which survivors are rare,
    and 290 queries padded to a ragged 300, all on exact lattice points.

    Each segment's rows form groups of 16 at one alpha (coordinate 0, two
    apart from group to group; segment 1 sits beyond segment 0), the 16 on a
    4 x 4 grid of pitch 3 in coordinates 1-2, with (0, 0) last in odd groups
    and first in even ones: rows 127 and 128, the last row of one 128-row
    sub-tile and the first of the next, are (14, 0, 0) and (16, 0, 0).
    Query 0, at (15, 0, 0) with r = 1, has exactly those two survivors;
    queries 1-127 sit between the lattice points with r = 1 (their windows
    meet rows, their balls none), so every query tile that holds query 0
    has survivors for that one query only; queries 128-289 sit on random
    rows of row blocks 5 and 17 with r = 1 (one survivor) or r = 3 (up to
    seven), or between the points with r = 0.5 (none)."""
    rng = np.random.default_rng(seed)
    S, n_pad, d, d_pad, m, m_pad = 2, 12288, 3, 128, 290, 300
    n_s, a_seg = n_pad - 200, 2000.0
    big = np.float32(ref.BIG)
    grid = np.array([(y, z) for y in (0, 3, 6, 9) for z in (0, 3, 6, 9)],
                    np.float32)
    xs = np.zeros((S, n_pad, d_pad), np.float32)
    al = np.full((S, n_pad), big, np.float32)
    hn = np.full((S, n_pad), big, np.float32)
    px = np.full((S, max(ke, 1), n_pad), big, np.float32)
    for s in range(S):
        g = np.arange(n_s) // 16
        pos = np.arange(n_s) % 16
        pos = np.where(g % 2 == 1, 15 - pos, pos)   # (0, 0) last in odd groups
        pts = np.zeros((n_s, d), np.float32)
        pts[:, 0] = 2.0 * g + a_seg * s
        pts[:, 1:3] = grid[pos]
        xs[s, :n_s, :d] = pts
        al[s, :n_s] = pts[:, 0]
        hn[s, :n_s] = 0.5 * np.sum(pts * pts, axis=1)
        px[s, :ke, :n_s] = pts[:, 1:1 + ke].T
    qi = np.zeros((m, d), np.float32)
    r = np.ones(m, np.float32)
    # the queries off the lattice sit between two groups anywhere; the
    # others on rows of two row blocks of a segment
    def between(k):
        a = 2.0 * rng.integers(0, n_s // 16 - 1, k) + 1
        return np.stack([a + a_seg * rng.integers(0, S, k), np.ones(k),
                         np.ones(k)], 1)

    qi[0] = (15.0, 0.0, 0.0)
    qi[1:128] = between(127)
    kind = rng.integers(0, 3, m - 128)
    rows = 512 * rng.choice([5, 17], m - 128) + rng.integers(0, 512, m - 128)
    segs = rng.integers(0, S, m - 128)
    qi[128:] = xs[segs, rows, :d]
    r[128:] = np.where(kind == 0, 1.0, np.where(kind == 1, 3.0, 0.5))
    off = kind == 2
    qi[128:][off] = between(int(off.sum()))
    q = np.zeros((m_pad, d_pad), np.float32)
    q[:m, :d] = qi
    rp = np.full(m_pad, -big, np.float32)
    th = np.full(m_pad, -big, np.float32)
    rp[:m] = r
    th[:m] = (r * r - np.sum(qi * qi, axis=1)) / 2.0
    aq = q[:, 0].copy()
    pq = np.ascontiguousarray(q[:, 1:1 + ke].T)
    dev = DEVICE
    ops = [torch.from_numpy(a).to(dev) for a in (q, aq, rp, th, xs, al, hn)]
    if ke:
        ops += [torch.from_numpy(pq).to(dev),
                torch.from_numpy(np.ascontiguousarray(px[:, :ke])).to(dev)]
    else:
        ops += [None, None]
    return ops


def geometry_note(K, xs, m_pad: int, bn: int, ke: int) -> str:
    """The query tile, threads and blocks each pass launches on a stack."""
    S, n_pad = int(xs.shape[0]), int(xs.shape[1])
    parts = []
    for kernel in ("count", "compact"):
        g = K.launch_geometry(kernel, S, m_pad, n_pad, bn, ke)
        parts.append(f"{kernel} {g['query_tile']}-query tiles, "
                     f"{g['blocks']} blocks of {g['threads']}")
    return "; ".join(parts)


def phase_kernels(torch, chk: Checks, K, ref, ops_mod) -> None:
    print("phase 1: kernels vs plain versions on exact lattice inputs")
    for ke in (0, 2):
        stack_checks(torch, chk, K, ref, ops_mod,
                     lattice_operands(torch, ref, ke, SEED + ke), f"ke={ke}",
                     "lattice stack")
    for ke in (0, 2):
        ops = sparse_operands(torch, ref, ke, SEED + 20 + ke)
        sparse_properties(torch, chk, ref, ops, f"sparse ke={ke}")
        stack_checks(torch, chk, K, ref, ops_mod, ops, f"sparse ke={ke}",
                     "sparse-survivor stack")


def sparse_properties(torch, chk: Checks, ref, ops, tag: str) -> None:
    """What the sparse-survivor stack is built to hold, read from the plain
    versions' partials."""
    bn = 512
    q, aq, r, th, xs, al, hn, pq, px = ops
    per, part = ref.snn_count_stacked_ref(q, aq, r, th, xs, al, hn, pq, px,
                                          bn=bn, with_partials=True)
    S, m_pad, nb = part.shape
    empty = []
    for tq in (128, 32, 8):
        n_t = -(-m_pad // tq)
        padded = torch.zeros((S, n_t * tq, nb), dtype=part.dtype,
                             device=part.device)
        padded[:, :m_pad] = part
        tiles = padded.reshape(S, n_t, tq, nb)
        empty.append(float((tiles.sum(2) == 0).float().mean()))
    seg0 = part[0, 0]
    tile0 = part[:, :8].sum(2) > 0       # the smallest tile holding query 0
    chk.ok(min(empty) > 0.9 and int(per[:, 0].sum()) == 2
           and int(seg0[0]) == 2 and int(tile0.sum()) == 1
           and int((part[:, 1:128] > 0).sum()) == 0 and m_pad % 128 != 0,
           f"{tag}: {min(empty):.4f} of the (query tile, row block) cells "
           "empty at every tile size (128/32/8); query 0 has 2 survivors, "
           f"both in row block 0; queries 1-127 none; m_pad={m_pad}, "
           f"{int(per.sum())} survivors")
    keep = ref.snn_filter_ref(q, aq, r, th, xs[0], al[0], hn[0], pq,
                              None if px is None else px[0])[0] < ref.BIG
    chk.ok(torch.equal(torch.nonzero(keep).flatten().cpu(),
                       torch.tensor([127, 128])),
           f"{tag}: query 0's survivors are rows 127 and 128, the last row "
           "of one 128-row sub-tile and the first of the next")


def stack_checks(torch, chk: Checks, K, ref, ops_mod, ops, tag: str,
                 what: str) -> None:
    """The stacked count (mixed off and on) and compact (partials handed and
    recounted, the overflow guard) on one stack, then the single-segment
    kernels on each of its segments, all against the plain versions."""
    bn = 512
    q, aq, r, th, xs, al, hn, pq, px = ops
    args = (q, aq, r, th)
    m_pad, ke = q.shape[0], 0 if pq is None else pq.shape[0]
    chk.note(f"{tag} ({what}, S={xs.shape[0]}, n_pad={xs.shape[1]}, "
             f"m_pad={m_pad}): stacked "
             f"{geometry_note(K, xs, m_pad, bn, ke)}; one segment "
             f"{geometry_note(K, xs[:1], m_pad, bn, ke)}")
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
               f"count {tag} mixed={mixed}: kernel == plain "
               f"({total} survivors)")
        chk.ok(torch.equal(k_part, p_part),
               f"count {tag} mixed={mixed}: per-block partials == plain")
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
        t2 = f"compact {tag} partials={'handed' if handed else 'recounted'}"
        chk.ok(torch.equal(k_idx, p_idx), f"{t2}: idx == plain (nnz={total})")
        chk.ok(torch.equal(k_dh.view(torch.int32), p_dh.view(torch.int32)),
               f"{t2}: dhalf bit-equal to plain")
        chk.ok(bool((k_idx[total:] == -1).all())
               and bool((k_dh[total:] == ref.BIG).all())
               and bool((k_idx[:total] >= 0).all()),
               f"{t2}: -1/+BIG in the {nnz - total} unwritten and "
               f"trash slots, every data slot written")
    k_idx, k_dh = K.snn_compact_stacked(*args, offsets, xs, al, hn, pq,
                                        px, nnz=total, bn=bn)
    torch.cuda.synchronize()
    chk.ok(bool((k_idx == -1).all()) and bool((k_dh == ref.BIG).all()),
           f"compact {tag}: overflow guard (nnz={total} < total + 1) "
           f"writes nothing")
    k_per = K.snn_count_stacked(*args, xs, al, hn, pq, px, bn=bn)
    for s in range(xs.shape[0]):
        seg = (xs[s].contiguous(), al[s].contiguous(), hn[s].contiguous(),
               pq, None if px is None else px[s].contiguous())
        single_segment_checks(torch, chk, K, ref, ops_mod, args, seg,
                              k_per[s], f"{tag} segment {s}")


def single_segment_checks(torch, chk: Checks, K, ref, ops_mod, args, seg,
                          stacked_row, tag: str) -> None:
    """snn_count (mixed off and on), snn_compact and snn_filter on one
    segment of the lattice stack against their plain versions."""
    bn = 512
    xs, al, hn, pq, px = seg
    ops = (*args, xs, al, hn, pq, px)
    p_cnt, p_part = ref.snn_count_ref(*ops, bn=bn, with_partials=True)
    for mixed in (False, True):
        k_cnt, k_part = K.snn_count(*ops, bn=bn, mixed=mixed,
                                    with_partials=True)
        pm = ref.snn_count_ref(*ops, bn=bn, mixed=mixed)
        torch.cuda.synchronize()
        chk.ok(torch.equal(k_cnt, pm) and torch.equal(pm, p_cnt)
               and torch.equal(k_part, p_part),
               f"snn_count {tag} mixed={mixed}: counts and per-block "
               f"partials == plain ({int(p_cnt.sum())} survivors)")
        if not mixed:
            chk.ok(torch.equal(k_cnt, stacked_row),
                   f"snn_count {tag}: == its row of snn_count_stacked")
    total = int(p_cnt.sum())
    lead = 3   # offsets start at 3: the first slots stay unwritten
    off = torch.cumsum(p_cnt, 0, dtype=torch.int32) - p_cnt + lead
    nnz = ops_mod.csr_capacity(total + lead)
    p_idx, p_dh = ref.snn_compact_ref(*args, off, xs, al, hn, pq, px,
                                      nnz=nnz)
    for handed in (True, False):
        part = K.snn_count(*ops, bn=bn, with_partials=True)[1] \
            if handed else None
        k_idx, k_dh = K.snn_compact(*args, off, xs, al, hn, pq, px, nnz=nnz,
                                    bn=bn, partials=part)
        torch.cuda.synchronize()
        t2 = f"snn_compact {tag} partials={'handed' if handed else 'recounted'}"
        chk.ok(torch.equal(k_idx, p_idx), f"{t2}: idx == plain")
        chk.ok(torch.equal(k_dh.view(torch.int32), p_dh.view(torch.int32)),
               f"{t2}: dhalf bit-equal to plain")
        unwritten = torch.cat([k_idx[:lead], k_idx[lead + total:]])
        unwritten_dh = torch.cat([k_dh[:lead], k_dh[lead + total:]])
        chk.ok(bool((unwritten == -1).all())
               and bool((unwritten_dh == ref.BIG).all())
               and bool((k_idx[lead:lead + total] >= 0).all()),
               f"{t2}: -1/+BIG in the {nnz - total} unwritten and trash "
               "slots, every data slot written")
    # a capacity that cuts the rows short: slots at or past nnz - 1 (the
    # trash slot) are skipped, as in the plain version
    short = lead + total // 2 + 1
    k_idx, k_dh = K.snn_compact(*args, off, xs, al, hn, pq, px, nnz=short,
                                bn=bn)
    p_idx, p_dh = ref.snn_compact_ref(*args, off, xs, al, hn, pq, px,
                                      nnz=short)
    torch.cuda.synchronize()
    chk.ok(torch.equal(k_idx, p_idx)
           and torch.equal(k_dh.view(torch.int32), p_dh.view(torch.int32)),
           f"snn_compact {tag} nnz={short} for {total} survivors: the slots "
           "in range == plain, none written past them")
    k_f = K.snn_filter(*ops, bn=bn)
    p_f = ref.snn_filter_ref(*ops)
    torch.cuda.synchronize()
    chk.ok(torch.equal(k_f.view(torch.int32), p_f.view(torch.int32))
           and int((k_f < ref.BIG).sum()) == total,
           f"snn_filter {tag}: bit-equal to plain, {total} finite entries")


def phase_bag_lattice(torch, chk: Checks, K, ref, ops_mod) -> None:
    """embedding_bag against its plain version on integer-valued tables:
    float32 and bfloat16, D in {1, 32, 64, 128}, F in {1, 40, 100}, a fifth
    of the ids -1 and one bag all padding; sums reach 400 in magnitude, so
    bfloat16 rounds on the way (after each add, in slot order, on both
    sides).  Sum and mean mode bit for bit."""
    print("phase 1b: embedding_bag vs its plain version on lattice tables")
    rng = np.random.default_rng(SEED + 10)
    n_bags, n_rows = 300, 1000
    for dtype in (torch.float32, torch.bfloat16):
        bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
        for d in (1, 32, 64, 128):
            same = padded_zero = 0
            for f in (1, 40, 100):
                ids = rng.integers(0, n_rows, (n_bags, f)).astype(np.int32)
                ids[rng.random((n_bags, f)) < 0.2] = -1
                ids[1, :] = -1
                tab = rng.integers(-4, 5, (n_rows, d)).astype(np.float32)
                ids_d = torch.from_numpy(ids).to(DEVICE)
                tab_d = torch.from_numpy(tab).to(DEVICE).to(dtype)
                k = K.embedding_bag(ids_d, tab_d)
                p = ref.embedding_bag_ref(ids_d, tab_d)
                km = ops_mod.embedding_bag(ids_d, tab_d, mode="mean")
                pm = ops_mod.embedding_bag(ids_d.cpu(), tab_d.cpu(),
                                           mode="mean")
                torch.cuda.synchronize()
                same += int(torch.equal(k.view(bits), p.view(bits))
                            and torch.equal(km.cpu().view(bits),
                                            pm.view(bits)))
                padded_zero += int(not bool(k[1].any()))
            chk.ok(same == 3 and padded_zero == 3,
                   f"embedding_bag {str(dtype)[6:]} D={d}, F=1/40/100: "
                   f"kernel == plain bit for bit in sum and mean mode "
                   f"({same}/3), the all-padding bag zero ({padded_zero}/3)")


# --------------------------------------------------------------------------- #
# phase 2                                                                      #
# --------------------------------------------------------------------------- #
def calibrate_radius(torch, index, q: np.ndarray,
                     target: int = TARGET_NEIGHBOURS) -> float:
    """A radius that gives about ``target`` neighbours per query on average
    over 64 queries: the matching quantile of their pooled distances to
    every row."""
    xq, _ = index.prepare_queries(q[:64], 1.0)
    qd = torch.from_numpy(xq).to(DEVICE)
    d2 = (2.0 * index.half_norms[:, None] - 2.0 * (index.xs @ qd.T)
          + (qd * qd).sum(1)[None, :])
    kth = torch.kthvalue(d2.reshape(-1).cpu(), target * 64).values
    return float(np.sqrt(max(float(kth), 0.0)))


def oracle_rows(index, xs64, hn64, q: np.ndarray, radius: float):
    """Float64 brute force over the index's own float32 rows: per query the
    sorted positions with ||x - q||^2 <= r^2 (as dhalf64 <= thresh64), the
    dhalf64 values, thresh64 and the rounding band's half width
    d * 2^-23 * (hn + sum_k |q_k x_k|) + 2^-23 * |thresh| (d the index's
    width, 65 for the lifted MIPS index)."""
    xq, r = index.prepare_queries(q, radius)
    xq64 = xq.astype(np.float64)
    thresh64 = (r * r - np.einsum("ij,ij->i", xq64, xq64)) / 2.0
    dhalf64 = hn64[:, None] - xs64 @ xq64.T
    absdot = np.abs(xs64) @ np.abs(xq64).T
    tol = (xs64.shape[1] * EPS32 * (hn64[:, None] + absdot)
           + EPS32 * np.abs(thresh64))
    return dhalf64, thresh64, tol


def compare_with_oracle(index, res, rows, xs64, hn64, q, radius,
                        oracle=None):
    """(band pairs, equal pairs, pairs outside the band that differ);
    ``oracle`` is `oracle_rows`' output for ``q[rows]``, made here when
    not given."""
    dhalf64, thresh64, tol = oracle or oracle_rows(index, xs64, hn64,
                                                   q[rows], radius)
    inv = np.empty_like(index.order)
    inv[index.order] = np.arange(index.order.size)
    band = equal = bad = 0
    for k, i in enumerate(rows):
        got = inv[res.indices[res.indptr[i]:res.indptr[i + 1]]]  # sorted pos.
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


def phase_main_path(torch, chk: Checks, K, snn, engine, join, clock):
    print(f"phase 2: main path, n={N_ROWS} d={DIM} m={N_QUERIES} "
          "(sift1m of bench_table45_realworld, euclidean)")
    t0 = time.perf_counter()
    x = sift_standin(N_ROWS, DIM, SEED)
    q = sift_standin(N_QUERIES, DIM, SEED + 1)
    chk.note(f"data made in {time.perf_counter() - t0:.2f} s (host, set-up)")
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

    # the looped executor on the same batch: its own path, its own counts
    K.reset_launch_counts()
    looped = clock("query_radius_csr packed=False (looped)",
                   lambda: snn.query_radius_csr(index, q, radius,
                                                packed=False, device=DEVICE))
    looped_launches = {"snn_count": K.snn_count.launches,
                       "snn_compact": K.snn_compact.launches}
    chk.note(f"looped kernel launches {looped_launches}")
    chk.ok(all(v > 0 for v in looped_launches.values())
           and K.snn_count_stacked.launches == 0,
           "packed=False ran the single-segment kernels, not the stacked")
    chk.ok(np.array_equal(looped.indptr, classic.indptr)
           and np.array_equal(looped.indices, classic.indices)
           and np.array_equal(looped.distances.view(np.int64),
                              classic.distances.view(np.int64)),
           "looped (packed=False) bit-identical to packed: indptr, indices, "
           "distances")
    return (index, x, q, radius, launches, looped_launches, xs64, hn64,
            classic)


# --------------------------------------------------------------------------- #
# phase 2b                                                                     #
# --------------------------------------------------------------------------- #
def graph_rows(g, rows: np.ndarray):
    """(counts, concatenated indices) of the given rows of a CSR graph."""
    counts = np.diff(g.indptr)[rows]
    idx = np.concatenate([g.indices[g.indptr[i]:g.indptr[i + 1]]
                          for i in rows])
    return counts, idx


def graph_data(snn, x, clock) -> SimpleNamespace:
    """The graph's points: the first GRAPH_N of phase 2's rows, their index
    on the card and its rows in float64 with their half norms."""
    x = x[:GRAPH_N]
    index = clock(f"build_index of the graph's {GRAPH_N} rows",
                  lambda: snn.build_index(x, device=DEVICE))
    xs64 = index.xs.cpu().numpy().astype(np.float64)
    hn64 = 0.5 * np.einsum("ij,ij->i", xs64, xs64)
    return SimpleNamespace(index=index, x=x, xs64=xs64, hn64=hn64)


def phase_graph(torch, chk: Checks, K, ref, snn, engine, join, graph,
                dbscan, ops_mod, x, clock):
    print(f"phase 2b: eps-neighbour graph and DBSCAN, n={GRAPH_N} d={DIM} "
          f"(the first {GRAPH_N} of phase 2's rows, indexed on their own), "
          f"query_chunk={QUERY_CHUNK}, {SEGMENT_ROWS}-row segments")
    gd = graph_data(snn, x, clock)
    index, x, xs64, hn64 = gd.index, gd.x, gd.xs64, gd.hn64
    n = index.n
    rng = np.random.default_rng(SEED + 3)
    sample = rng.choice(n, 64, replace=False)
    eps = calibrate_radius(torch, index, x[sample], GRAPH_NEIGHBOURS)
    chk.note(f"eps {eps!r} (about {GRAPH_NEIGHBOURS} neighbours a point, "
             "itself included, over 64 points)")
    kw = dict(index=index, query_chunk=QUERY_CHUNK,
              segment_rows=SEGMENT_ROWS, device=DEVICE)

    K.reset_launch_counts()
    stats = engine.DISPATCH_STATS
    stats.reset()
    t_plain = time.perf_counter()
    plain = clock("build_neighbor_graph symmetric=False",
                  lambda: graph.build_neighbor_graph(x, eps, **kw))
    t_plain = time.perf_counter() - t_plain
    s_plain = stats.snapshot()
    stats.reset()
    sym = clock("build_neighbor_graph symmetric=True",
                lambda: graph.build_neighbor_graph(x, eps, symmetric=True,
                                                   **kw))
    s_sym = stats.snapshot()
    launches = {"snn_count_stacked": K.snn_count_stacked.launches,
                "snn_compact_stacked": K.snn_compact_stacked.launches}
    chk.note(f"graph nnz {plain.nnz} ({plain.nnz / n:.2f} a point); "
             f"dispatch: plain {s_plain}, symmetric {s_sym}")
    chk.note(f"graph kernel launches (both builds) {launches}")
    chk.ok(all(v > 0 for v in launches.values())
           and K.snn_count.launches == 0,
           "the graph builds ran the stacked kernels")
    chk.ok(plain.m == n and plain.indices.min() >= 0
           and plain.indices.max() < n
           and bool(np.all(np.diff(plain.indptr) >= 1)),
           "graph rows cover every point, ids in range, no empty row")

    # plain vs symmetric: pairs may differ only exactly at the boundary
    n_diff, diff_rows = 0, np.zeros(0, np.int64)
    if not (np.array_equal(plain.indptr, sym.indptr)
            and np.array_equal(plain.indices, sym.indices)):
        def keys(g):
            rows_ = np.repeat(np.arange(n, dtype=np.int64), np.diff(g.indptr))
            return rows_ * n + g.indices
        diff = np.setxor1d(keys(plain), keys(sym))
        n_diff, diff_rows = int(diff.size), np.unique(diff // n)
    # both graphs' differing rows against the float64 brute force, every
    # one of them: each pair in which either graph departs from it must lie
    # in the band
    band = bad = 0
    for g in (plain, sym):
        for b0 in range(0, min(diff_rows.size, MAX_DIFF_ROWS), N_GRAPH_ORACLE):
            b_, _, x_ = compare_with_oracle(
                index, g, diff_rows[b0:b0 + N_GRAPH_ORACLE], xs64, hn64, x,
                eps)
            band, bad = band + b_, bad + x_
    chk.ok(bad == 0 and diff_rows.size <= MAX_DIFF_ROWS,
           f"plain vs symmetric graph: {n_diff} pairs differ (expected 0), "
           f"in {diff_rows.size} rows (at most {MAX_DIFF_ROWS} checked); in "
           f"those rows {band} pairs where a graph departs from the float64 "
           f"brute force, all inside the float32 rounding band")

    t = time.perf_counter()
    lab_plain = dbscan.labels_from_graph(plain, MIN_SAMPLES)
    lab_sym = dbscan.labels_from_graph(sym, MIN_SAMPLES)
    n_clusters = int(lab_plain.max()) + 1
    largest = (int(np.bincount(lab_plain[lab_plain >= 0]).max())
               if n_clusters else 0)
    found = (int(plain.nnz), n_clusters, int((lab_plain < 0).sum()), largest)
    chk.note(f"DBSCAN min_samples={MIN_SAMPLES}: {n_clusters} clusters, "
             f"{found[2]} noise points, {largest} in the largest; labels of "
             f"both graphs in {time.perf_counter() - t:.2f} s (host)")
    chk.ok(np.array_equal(lab_plain, lab_sym),
           "DBSCAN labels of the plain and the symmetric graph identical")
    chk.ok(found == GRAPH_RECORD,
           f"graph pairs, clusters, noise points and largest cluster {found} "
           f"== the recorded {GRAPH_RECORD}")

    rows = rng.choice(n, N_GRAPH_ROWS, replace=False)
    t = time.perf_counter()
    same = 0
    for i in rows:
        res = snn.query_radius_csr(index, x[i:i + 1], eps,
                                   return_distance=False, device=DEVICE)
        same += int(np.array_equal(res.indices,
                                   plain.indices[plain.indptr[i]:
                                                 plain.indptr[i + 1]]))
    chk.ok(same == N_GRAPH_ROWS,
           f"{same} of {N_GRAPH_ROWS} sampled graph rows bit-identical to "
           f"query_radius_csr(index, x[i:i+1], eps) "
           f"({time.perf_counter() - t:.2f} s)")
    orows = rows[:N_GRAPH_ORACLE]
    band, equal, bad = compare_with_oracle(index, plain, orows, xs64, hn64,
                                           x, eps)
    chk.ok(bad == 0, f"{N_GRAPH_ORACLE} sampled graph rows vs float64 brute "
           f"force: {equal} pairs equal, {band} inside the rounding band, "
           f"{bad} outside")

    # the looped executor over sampled chunks of the sorted order; the
    # chunks stay aligned to the graph's own, so each is one graph chunk
    n_chunks = -(-n // QUERY_CHUNK)
    picks = np.unique(np.linspace(0, n_chunks - 1, N_LOOPED_CHUNKS)
                      .round().astype(np.int64))
    srows = np.concatenate([np.arange(c * QUERY_CHUNK,
                                      min((c + 1) * QUERY_CHUNK, n))
                            for c in picks])
    xq, aq, r, th, _ = snn.prepare_query_predicates(
        index, x[index.order[srows]], eps)
    segments = engine.segments_from_index(index, rows_per_segment=SEGMENT_ROWS,
                                          block=512, device=DEVICE)
    jkw = dict(query_chunk=QUERY_CHUNK, segs_per_chunk=0)
    # the host side of the packed executor's prune for one chunk: the
    # (S, m) float64 interval test of `SegmentPack.live_mask`
    pack = engine.SegmentPack.build(segments)
    c0 = (n_chunks // 2) * QUERY_CHUNK
    cxq, caq, cr, cth, _ = snn.prepare_query_predicates(
        index, x[index.order[c0:c0 + QUERY_CHUNK]], eps)
    qp, aqp, rp, thp, m = ops_mod.pad_queries(cxq, caq, cr, cth)
    pqp = ops_mod.pad_components(snn.query_extra_projections(index, cxq),
                                 qp.shape[0])
    host, kq, pq64, qn64, dev_ops = engine._query_operands(
        pack, m, qp, aqp, rp, thp, pqp)
    t = time.perf_counter()
    for _ in range(3):
        live = engine._live_idx(pack, host[1], host[2], m, 0, pq64, qn64)
    chk.note(f"host segment prune of chunk {c0 // QUERY_CHUNK}: "
             f"{1e3 * (time.perf_counter() - t) / 3:.1f} ms a chunk, "
             f"{live.size} of {len(segments)} segments live")
    graph_shape = stacked_kernels(
        torch, chk, K, ref, ops_mod, engine, pack, live, kq, dev_ops, host, m,
        "stacked kernels at the graph chunk's shape")
    del pack
    packed = clock(f"packed executor over {picks.size} sampled chunks",
                   lambda: join.chunked_join(index, segments, xq, aq, r, th,
                                             packed=True, **jkw))
    K.reset_launch_counts()
    looped = clock(f"looped executor over {picks.size} sampled chunks",
                   lambda: join.chunked_join(index, segments, xq, aq, r, th,
                                             packed=False, **jkw))
    looped_launches = {"snn_count": K.snn_count.launches,
                       "snn_compact": K.snn_compact.launches}
    chk.note(f"sampled chunks {picks.tolist()}; looped kernel launches "
             f"{looped_launches}")
    chk.ok(all(v > 0 for v in looped_launches.values())
           and K.snn_count_stacked.launches == 0,
           "the looped chunks ran the single-segment kernels")
    chk.ok(all(np.array_equal(a, b) for a, b in zip(looped[:2], packed[:2]))
           and np.array_equal(looped[2].view(np.int32),
                              packed[2].view(np.int32)),
           f"looped == packed on {srows.size} sampled rows: counts, ids, "
           "dhalf bit-identical")
    g_counts, g_idx = graph_rows(plain, index.order[srows])
    chk.ok(np.array_equal(looped[0], g_counts)
           and np.array_equal(looped[1], g_idx),
           "looped rows bit-identical to the packed graph's rows")
    del segments
    return launches, looped_launches, eps, graph_shape, plain, t_plain, gd



# --------------------------------------------------------------------------- #
# phase 2c                                                                     #
# --------------------------------------------------------------------------- #
SNN_KERNELS = ("snn_count_stacked", "snn_compact_stacked", "snn_count",
               "snn_compact", "snn_filter")


def launch_counts(K) -> dict:
    """The launches of each query kernel since the last reset."""
    return {k: getattr(K, k).launches for k in SNN_KERNELS}


# --------------------------------------------------------------------------- #
# phase 2d                                                                     #
# --------------------------------------------------------------------------- #
# the decomposition's shard count, the top-k function's k a shard, and the
# service cell: its shape, its queries held against the float64 brute force,
# its timed calls and its data's seed
N_SHARDS = 8
SHARD_TOPK = 1024
SVC_SHAPE = "svc_10m"
N_SVC_ORACLE = 16
N_SVC_ROWS = 64
SVC_REPS = 5
SVC_SEED = SEED + 7


def oracle_counts(torch, xs, q64: np.ndarray, thr64: np.ndarray,
                  rows: int = 1 << 20):
    """Float64 brute force on the card over the float32 rows ``xs`` (real
    rows only), a million rows at a time: per query the rows with
    dhalf64 <= thr64, and the pairs inside the float32 rounding band
    d*2^-23*(hn + sum|q x|) + 2^-23*|thresh|."""
    qd = torch.from_numpy(q64).to(xs.device)
    th = torch.from_numpy(thr64).to(xs.device)
    keep = torch.zeros(q64.shape[0], dtype=torch.int64, device=xs.device)
    band = torch.zeros_like(keep)
    for c0 in range(0, xs.shape[0], rows):
        x = xs[c0:c0 + rows].double()
        hn = 0.5 * (x * x).sum(1)
        dh = hn[:, None] - x @ qd.T
        tol = (xs.shape[1] * EPS32 * (hn[:, None] + x.abs() @ qd.abs().T)
               + EPS32 * th.abs()[None, :])
        keep += (dh <= th[None, :]).sum(0)
        band += ((dh - th[None, :]).abs() <= tol).sum(0)
        del x, dh, tol
    return keep.cpu().numpy(), band.cpu().numpy()


def query64(index, q: np.ndarray, radius):
    """(q64, thr64): the queries' centred rows and thresholds in float64."""
    xq, r = index.prepare_queries(q, radius)
    q64 = xq.astype(np.float64)
    return q64, (r * r - np.einsum("ij,ij->i", q64, q64)) / 2.0


def counts_in_band(torch, index, q, radius, got, want) -> tuple[bool, int]:
    """Do two count vectors differ only by pairs inside the float32 band?
    (holds, the band pairs of the queries where they differ)"""
    off = np.nonzero(np.asarray(got) != np.asarray(want))[0]
    if off.size == 0:
        return True, 0
    q64, thr64 = query64(index, q[off], radius)
    _, band = oracle_counts(torch, index.xs, q64, thr64)
    diff = np.abs(np.asarray(got)[off].astype(np.int64) - want[off])
    return bool(np.all(diff <= band)), int(band.sum())


def same_csr(a, b) -> bool:
    return (np.array_equal(a.indptr, b.indptr)
            and np.array_equal(a.indices, b.indices)
            and (a.distances is None) == (b.distances is None)
            and (a.distances is None
                 or np.array_equal(a.distances.view(np.int64),
                                   b.distances.view(np.int64))))


def sharded_csr(torch, chk: Checks, K, engine, sharded, index, q, radius,
                csr, card, clock) -> dict:
    """(a) the 8-shard decomposition of the point-query cell, packed twice
    (classic, then fused) and looped, against phase 2's rows."""
    stats = engine.DISPATCH_STATS
    pack = clock(f"mesh_pack, {N_SHARDS} shards",
                 lambda: sharded.mesh_pack(index, N_SHARDS))
    K.reset_launch_counts()
    runs = []
    for i, tag in enumerate(("classic", "fused")):
        stats.reset()
        runs.append(clock(f"query_radius_csr_sharded #{i + 1} ({tag})",
                          lambda: sharded.query_radius_csr_sharded(
                              index, N_SHARDS, q, radius, pack=pack)))
        runs.append(stats.snapshot())
    packed = launch_counts(K)
    K.reset_launch_counts()
    looped = clock("query_radius_csr_sharded packed=False",
                   lambda: sharded.query_radius_csr_sharded(
                       index, N_SHARDS, q, radius, packed=False))
    loop_launches = launch_counts(K)
    (c1, s1, c2, s2) = runs
    chk.note(f"sharded CSR launches: packed {packed}, looped "
             f"{loop_launches}; dispatch {s1} then {s2}")
    chk.ok(s1["host_transfers"] == 3 and s2["kernel_launches"] == 3
           and s2["host_transfers"] == 1,
           "sharded packed: first batch classic (3 transfers), second fused "
           "(3 launches, 1 transfer)")
    chk.ok(packed["snn_count_stacked"] == 2
           and packed["snn_compact_stacked"] == 2
           and loop_launches["snn_count"] > 0
           and loop_launches["snn_compact"] > 0
           and loop_launches["snn_count_stacked"] == 0,
           "the packed runs launched the stacked kernels, the looped one "
           "the single-segment kernels")
    chk.ok(same_csr(c1, csr) and same_csr(c2, csr) and same_csr(looped, csr),
           f"{N_SHARDS}-shard query_radius_csr_sharded (classic, fused, "
           "looped) bit-identical to phase 2's query_radius_csr: indptr, "
           "indices, distances")
    del pack
    out = dict(packed)
    for k, v in loop_launches.items():
        out[k] += v
    return out


def sharded_graph(torch, chk: Checks, K, snn, engine, join, graph, sharded,
                  index, x, eps, plain, t_plain, card) -> dict:
    """(b) build_neighbor_graph_sharded over the 8 shards against phase 2b's
    plain graph; the live segments of each chunk; the distances (dhalf) of
    sampled chunks against the 512-row segments' bit for bit."""
    live = []
    live_idx = engine._live_idx

    def tap(*a, **k):
        out = live_idx(*a, **k)
        live.append(out.size)
        return out

    K.reset_launch_counts()
    engine._live_idx = tap
    try:
        torch.cuda.synchronize()
        t = time.perf_counter()
        g = graph.build_neighbor_graph_sharded(x, N_SHARDS, eps, index=index,
                                               query_chunk=QUERY_CHUNK,
                                               device=DEVICE)
        torch.cuda.synchronize()
        t_sh = time.perf_counter() - t
    finally:
        engine._live_idx = live_idx
    launches = launch_counts(K)
    live = np.asarray(live)
    chk.note(f"build_neighbor_graph_sharded, {N_SHARDS} shards: "
             f"{1e3 * t_sh:.3f} ms against phase 2b's plain build "
             f"{1e3 * t_plain:.3f} ms (host clock, synchronized) [{card}]; "
             f"live segments a chunk: min {live.min()}, mean "
             f"{live.mean():.3f}, max {live.max()} over {live.size} chunks "
             f"(phase 2b: of {-(-index.n // SEGMENT_ROWS)}); launches "
             f"{launches}")
    chk.ok(np.array_equal(g.indptr, plain.indptr)
           and np.array_equal(g.indices, plain.indices)
           and g.nnz == GRAPH_RECORD[0],
           f"sharded graph bit-identical to phase 2b's plain graph "
           f"({g.nnz} pairs recorded, {GRAPH_RECORD[0]} expected)")
    del g
    # the distances: the sharded schedule's chunks against the 512-row
    # segments', the same sampled chunks as phase 2b's looped check
    n = index.n
    n_chunks = -(-n // QUERY_CHUNK)
    picks = np.unique(np.linspace(0, n_chunks - 1, N_LOOPED_CHUNKS)
                      .round().astype(np.int64))
    srows = np.concatenate([np.arange(c * QUERY_CHUNK,
                                      min((c + 1) * QUERY_CHUNK, n))
                            for c in picks])
    xq, aq, r, th, _ = snn.prepare_query_predicates(
        index, x[index.order[srows]], eps)
    jkw = dict(query_chunk=QUERY_CHUNK, segs_per_chunk=0)
    got = join.chunked_join(index, sharded.mesh_segments(index, N_SHARDS),
                            xq, aq, r, th, **jkw)
    want = join.chunked_join(
        index, engine.segments_from_index(index,
                                          rows_per_segment=SEGMENT_ROWS,
                                          device=DEVICE), xq, aq, r, th,
        **jkw)
    chk.ok(all(np.array_equal(a, b) for a, b in zip(got[:2], want[:2]))
           and np.array_equal(got[2].view(np.int32), want[2].view(np.int32)),
           f"{picks.size} sampled chunks ({srows.size} rows): the shards' "
           "counts, ids and dhalf bit-identical to the 512-row segments'")
    return launches


def sharded_collectives(torch, chk: Checks, K, snn, sharded, mesh, index, q,
                        radius, csr, xs64, hn64, card, clock) -> dict:
    """(c) the count, percount and top-k functions over NCCL at world size
    1 on the point-query cell, against phase 2's CSR rows."""
    shard = sharded.shard_index(index, mesh)
    qa = sharded.prepare_query_arrays(index, q, radius)
    K.reset_launch_counts()
    count = clock("sharded count (filter + all_reduce)",
                  lambda: sharded.make_sharded_count_fn(mesh)(*shard[:3],
                                                              *qa))
    per = clock("sharded percount (filter + all_gather)",
                lambda: sharded.make_sharded_percount_fn(mesh)(*shard[:3],
                                                               *qa))
    ids, dh = clock(f"sharded top-k, k={SHARD_TOPK} a shard (filter + "
                    "top-k + all_gather)",
                    lambda: sharded.make_sharded_topk_fn(mesh, SHARD_TOPK)(
                        *shard, *qa))
    launches = launch_counts(K)
    del shard
    counts = np.diff(csr.indptr)
    got = count.cpu().numpy()
    ok, band = counts_in_band(torch, index, q, radius, got, counts)
    chk.ok(launches["snn_filter"] == 3 and sum(launches.values()) == 3,
           f"the three functions launched the filter kernel once each "
           f"({launches})")
    chk.ok(count.dtype == torch.int32 and ok,
           f"sharded count == phase 2's CSR counts on "
           f"{int(np.sum(got == counts))} of {counts.size} queries; the rest "
           f"differ by {band} pairs inside the float32 band at most")
    chk.ok(tuple(per.shape) == (1, counts.size)
           and np.array_equal(per.cpu().numpy()[0], got),
           "sharded percount (1, m) == the count at world size 1")
    ids, dh = ids.cpu().numpy(), dh.cpu().numpy()
    qi, diff_ids = [], []
    rows = np.nonzero(counts <= SHARD_TOPK)[0]
    for i in rows:
        d = np.setxor1d(ids[i][ids[i] >= 0],
                        csr.indices[csr.indptr[i]:csr.indptr[i + 1]])
        qi += [i] * d.size
        diff_ids += d.tolist()
    in_band = (pair_band(index, xs64, hn64, q, radius,
                         np.asarray(qi, np.int64),
                         np.asarray(diff_ids, np.int64))[0]
               if diff_ids else True)
    chk.ok(in_band and bool(np.all(np.diff(dh, axis=1) >= 0)),
           f"sharded top-k == the CSR row as a set on the {rows.size} rows "
           f"with count <= {SHARD_TOPK}: {len(diff_ids)} pairs differ, all "
           "inside the float32 band; each row ascending")
    return launches


def svc_counts_vs(torch, chk, index, q, radius, got, want, tag) -> None:
    ok, band = counts_in_band(torch, index, q, radius, got, want)
    chk.ok(ok, f"{tag}: equal on {int(np.sum(got == want))} of {want.size} "
           f"queries, the rest within {band} pairs inside the float32 band")


def service_cell(torch, chk: Checks, K, ref, snn, sharded, snn_cell, mesh,
                 index, q, radius, csr, card) -> dict:
    """(c) snn_cell's service step, both variants, on the 1M cell (rows
    padded to a multiple of n_chunk) and at svc_10m on seeded data."""
    launches = {"snn_count_stacked": 0}
    n_chunk = 65536
    qa = sharded.prepare_query_arrays(index, q, radius)
    xs, al, hn, _, _, _ = sharded._pad_for_shards(index, 1, block=n_chunk)
    counts = np.diff(csr.indptr)
    for prune in (True, False):
        fn = snn_cell.make_service_count_step(mesh, "data", prune=prune)
        K.reset_launch_counts()
        got = fn(xs, al, hn, *qa).cpu().numpy()
        launches["snn_count_stacked"] += K.snn_count_stacked.launches
        svc_counts_vs(torch, chk, index, q, radius, got, counts,
                      f"service step prune={prune} on the 1M cell "
                      f"({xs.shape[0] // n_chunk} slabs of {n_chunk}) vs "
                      "phase 2's CSR counts")
    # the step's launch against its plain version at this stack shape
    perm = torch.argsort(qa[1], stable=True)
    ops = [t[perm].contiguous() for t in qa]
    stack = (xs.reshape(-1, n_chunk, DIM), al.reshape(-1, n_chunk),
             hn.reshape(-1, n_chunk))
    k_per = K.snn_count_stacked(*ops, *stack, bn=512)
    p_per = ref.snn_count_stacked_ref(*ops, *stack, bn=512)
    k_q = k_per.sum(0).cpu().numpy()
    p_q = p_per.sum(0).cpu().numpy()
    svc_counts_vs(torch, chk, index, q[perm.cpu().numpy()], radius, k_q, p_q,
                  f"snn_count_stacked vs its plain version at the step's "
                  f"({stack[0].shape[0]}, {n_chunk}, {DIM}) stack")
    del xs, al, hn, stack, k_per, p_per
    torch.cuda.empty_cache()

    sh = snn_cell.SNN_SHAPES[SVC_SHAPE]
    n, d, m, r0, s = sh["n"], sh["d"], sh["m"], sh["radius"], sh["aniso_s"]
    t = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(SVC_SEED)
    scale = torch.full((d,), s, device=DEVICE)
    scale[0] = 1.0
    xd = torch.randn((n, d), generator=gen, device=DEVICE) * scale
    qd = torch.randn((m, d), generator=gen, device=DEVICE) * scale
    xh, qh = xd.cpu().numpy(), qd.cpu().numpy()
    del xd, qd
    chk.note(f"{SVC_SHAPE}: n={n} d={d} m={m} radius {r0}, std [1, {s}, "
             f"...] (torch.Generator on the card, seed {SVC_SEED}) in "
             f"{time.perf_counter() - t:.2f} s (set-up) [{card}]")
    t = time.perf_counter()
    big = snn.build_index(xh, n_components=1, device=DEVICE)
    torch.cuda.synchronize()
    chk.note(f"{SVC_SHAPE} build_index in {time.perf_counter() - t:.2f} s "
             f"[{card}]")
    # at this radius the published traffic has next to no neighbours, so the
    # correctness call also asks data rows at even steps through the sorted
    # order, slightly perturbed: each has its own row inside the radius, in
    # every part of the stack up to the last slab
    rng = np.random.default_rng(SVC_SEED)
    slots = rng.permutation(m)
    rows, hit = slots[:N_SVC_ORACLE], slots[N_SVC_ORACLE:][:N_SVC_ROWS]
    pos = np.linspace(0, n - 1, N_SVC_ROWS).round().astype(np.int64)
    noise = rng.standard_normal((N_SVC_ROWS, d)).astype(np.float32)
    qc = qh.copy()
    qc[hit] = xh[big.order[pos]] + 0.01 * noise * scale.cpu().numpy()
    del xh
    shard = sharded.shard_index(big, mesh, block=n_chunk)
    sq = sharded.prepare_query_arrays(big, qh, r0)
    sc = sharded.prepare_query_arrays(big, qc, r0)
    sel = np.concatenate([rows, hit])
    q64, thr64 = query64(big, qc[sel], r0)
    want, band = oracle_counts(torch, big.xs, q64, thr64)
    # the pairs in the rows past byte 2^32 of the stack, and in its last slab
    far_row = (1 << 32) // (4 * shard[0].shape[1])
    last_row = (n // n_chunk - 1) * n_chunk
    far = int(oracle_counts(torch, big.xs[far_row:], q64, thr64)[0].sum())
    last = int(oracle_counts(torch, big.xs[last_row:], q64, thr64)[0].sum())
    chk.ok(int(want[N_SVC_ORACLE:].min()) >= 1 and far > 0 and last > 0,
           f"{SVC_SHAPE} oracle: {int(want.sum())} pairs on {sel.size} "
           f"queries ({N_SVC_ORACLE} of the published traffic, "
           f"{N_SVC_ROWS} perturbed data rows), {far} of them in rows past "
           f"{far_row} (byte 2^32 of the stack), {last} in the last slab "
           f"(rows from {last_row}); every data-row query has a neighbour")
    aq64 = sq[1].double().cpu().numpy()
    r64 = sq[2].double().cpu().numpy()
    frac = window_pairs(big.host_alphas(), aq64, r64) / (m * n)
    for prune in (True, False):
        fn, specs, flops, _ = snn_cell.build_service_step(
            SVC_SHAPE, prune=prune, mesh=mesh)
        chk.ok([tuple(t.shape) for t in shard[:3]]
               == [sp[0] for sp in specs[:3]],
               f"the shard's shapes are build_service_step's specs "
               f"{[sp[0] for sp in specs[:3]]}")
        K.reset_launch_counts()
        got = fn(*shard[:3], *sc).cpu().numpy()[sel]
        pub = fn(*shard[:3], *sq).cpu().numpy()
        ms = timed(torch, lambda: fn(*shard[:3], *sq), SVC_REPS)
        launches["snn_count_stacked"] += K.snn_count_stacked.launches
        diff = np.abs(got.astype(np.int64) - want)
        chk.ok(int(want.sum()) > 0 and bool(np.all(diff <= band)),
               f"{SVC_SHAPE} step prune={prune}: {sel.size} queries vs the "
               f"float64 brute force, {int(want.sum())} pairs checked, "
               f"{int(np.sum(diff))} counted differently, all within the "
               f"{int(band.sum())} pairs inside the float32 band")
        # the model FLOPs are the brute force's; the window skips most of
        # them, so the card's share counts the window's pairs alone
        work = flops * (frac if prune else 1.0)
        chk.note(f"{SVC_SHAPE} step prune={prune}: {ms:.3f} ms a call "
                 f"(CUDA events, {SVC_REPS} calls, published traffic) "
                 f"[{card}]; brute-force equivalent {flops:.4e} model FLOPs "
                 f"at {flops / ms / 1e9:.2f} TFLOP/s (not a share of the "
                 f"card); work in the window {work:.4e} FLOPs (window "
                 f"fraction {frac if prune else 1.0:.6f}) at "
                 f"{work / ms / 1e9:.2f} TFLOP/s = "
                 f"{work / (ms / 1e3) / FP32_PEAK:.4f} of the FP32 peak; "
                 f"mean {pub.mean():.4f} neighbours a query")
    want_frac = snn_cell.measured_window_fraction(d, r0, aniso_s=s,
                                                  device=DEVICE)
    chk.note(f"{SVC_SHAPE} window fraction: {frac:.6f} of the (query, row) "
             f"pairs on this data; measured_window_fraction "
             f"{want_frac:.6f} (n_sample 200,000, 256 queries)")
    del shard, big
    torch.cuda.empty_cache()
    return launches


def phase_sharded(torch, chk: Checks, K, ref, snn, engine, join, graph, index,
                  q, radius, eps, csr, gd, plain, t_plain, xs64, hn64, clock):
    """Phase 2d: the sharded SNN.  Returns {path: {kernel: launches}}."""
    import os
    import tempfile

    import torch.distributed as dist

    from repro_torch.core import sharded
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import snn_cell

    card = card_line()
    print(f"phase 2d: the sharded SNN, n={index.n} d={DIM} m={N_QUERIES} at "
          f"{N_SHARDS} shards, NCCL at world size 1, and {SVC_SHAPE}")
    paths = {"sharded_csr": sharded_csr(torch, chk, K, engine, sharded,
                                        index, q, radius, csr, card, clock)}
    paths["sharded_graph"] = sharded_graph(torch, chk, K, snn, engine, join,
                                           graph, sharded, gd.index, gd.x,
                                           eps, plain, t_plain, card)
    # one rank, its store in a temporary directory and its bootstrap on the
    # loopback interface: nothing leaves the machine
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl", init_method=f"file://{tmp}/store", rank=0, world_size=1,
            device_id=torch.device("cuda", torch.cuda.current_device()))
        try:
            mesh = mesh_mod.make_host_mesh()
            chk.ok(dist.get_backend() == "nccl"
                   and tuple(mesh.shape) == (1, 1)
                   and mesh.mesh_dim_names == ("data", "model"),
                   f"NCCL process group, world size {dist.get_world_size()}, "
                   f"make_host_mesh {tuple(mesh.shape)} "
                   f"{mesh.mesh_dim_names} on {mesh.device_type}")
            paths["sharded_collectives"] = sharded_collectives(
                torch, chk, K, snn, sharded, mesh, index, q, radius, csr,
                xs64, hn64, card, clock)
            torch.cuda.empty_cache()
            paths["snn_cell"] = service_cell(torch, chk, K, ref, snn,
                                             sharded, snn_cell, mesh, index,
                                             q, radius, csr, card)
        finally:
            dist.destroy_process_group()
    return {p: {k: v for k, v in c.items() if v} for p, c in paths.items()}


def knn_oracle(index, xs64, hn64, q: np.ndarray, k: int):
    """Float64 brute force over the index's own float32 rows: per query the
    k nearest (ties by id) as (ids (m, k), squared distances (m, k)), all
    squared distances (m, n) and their float32 rounding band in squared
    units, 2 * (d*2^-23*(hn + sum|q x|))."""
    xq, _ = index.prepare_queries(q, 1.0)
    xq64 = xq.astype(np.float64)
    sq = (2.0 * hn64[None, :] - 2.0 * (xq64 @ xs64.T)
          + np.einsum("ij,ij->i", xq64, xq64)[:, None])
    tol = 2.0 * DIM * EPS32 * (hn64[None, :] + np.abs(xq64) @ np.abs(xs64).T)
    ids = np.empty((q.shape[0], k), np.int64)
    for i in range(q.shape[0]):
        near = np.argpartition(sq[i], k + 64)[:k + 64]
        pick = near[np.lexsort((index.order[near], sq[i, near]))][:k]
        ids[i] = index.order[pick]
    return ids, sq, tol


def knn_agreement(index, got_ids, want_ids, sq, tol):
    """Ranks where the kNN ids differ from the oracle's (in-band ties) and
    ranks where the k-th squared distances differ by more than the band."""
    inv = np.empty_like(index.order)
    inv[index.order] = np.arange(index.order.size)
    ties = bad = 0
    for i in range(got_ids.shape[0]):
        g, w = inv[got_ids[i]], inv[want_ids[i]]
        gap = np.abs(sq[i, g] - sq[i, w])
        band = np.maximum(tol[i, g], tol[i, w])
        ties += int(np.sum(g != w))
        bad += int(np.sum(gap > band))
    return ties, bad


def stream_oracle(torch, stream, raw: np.ndarray, q: np.ndarray, radius):
    """Float64 brute force over every row a streaming index holds, in its
    index space (the raw rows centred by the frozen base mean in float32,
    as its parts hold them): per query the original ids within the radius
    and those inside the float32 rounding band, computed on the card."""
    base = stream.base
    mu = torch.from_numpy(base.mu).to(DEVICE)
    xc = (torch.from_numpy(raw).to(DEVICE) - mu[None, :]).double()
    xq, r = base.prepare_queries(q, radius)
    xq64 = torch.from_numpy(xq.astype(np.float64)).to(DEVICE)
    thr = torch.from_numpy((r * r - np.einsum(
        "ij,ij->i", xq.astype(np.float64), xq.astype(np.float64))) / 2.0
                           ).to(DEVICE)
    hn = 0.5 * (xc * xc).sum(1)
    dh = hn[:, None] - xc @ xq64.T
    tol = (DIM * EPS32 * (hn[:, None] + xc.abs() @ xq64.abs().T)
           + EPS32 * thr.abs()[None, :])
    keep = (dh <= thr[None, :]).T.cpu().numpy()
    band = ((dh - thr[None, :]).abs() <= tol).T.cpu().numpy()
    del xc, dh, tol
    return keep, band


def sets_vs_oracle(res, rows, keep, band):
    """(band pairs, pairs outside the band that differ) of CSR rows against
    `stream_oracle` masks, as sets of original ids."""
    n_band = n_bad = 0
    for k, i in enumerate(rows):
        got = res.indices[res.indptr[i]:res.indptr[i + 1]]
        diff = np.setxor1d(got, np.nonzero(keep[k])[0])
        n_band += int(band[k, diff].sum())
        n_bad += int((~band[k, diff]).sum())
    return n_band, n_bad


def phase_knn(torch, chk: Checks, K, snn, knn, index, q, xs64, hn64, clock):
    """query_knn at k = 100 for the main path's queries, against a float64
    brute force on 64 of them; a per-query k and k > n."""
    # warm on the oracle's few queries: cuBLAS and the engine's first
    # plans; the whole batch takes 20-30 s, nearly all the host refine
    knn.query_knn(index, q[:N_ORACLE], KNN_K, device=DEVICE)
    K.reset_launch_counts()
    knn.KNN_STATS.reset()
    ids, dist = clock(f"query_knn k={KNN_K} (warm)",
                      lambda: knn.query_knn(index, q, KNN_K, device=DEVICE))
    launches = launch_counts(K)
    st = knn.KNN_STATS.snapshot()
    chk.note(f"query_knn: {st['rounds']} expansion rounds, "
             f"{st['candidates']} candidates in the final pass "
             f"({st['candidates'] / N_QUERIES:.1f} a query); host seconds "
             + ", ".join(f"{k} {v:.3f}" for k, v in st["seconds"].items())
             + f"; kernel launches {launches}")
    chk.ok(launches["snn_count_stacked"] >= knn.KNN_STATS.rounds + 1
           and launches["snn_compact_stacked"] >= 1,
           "query_knn ran the stacked count (each round and the final "
           "pass) and the compact")
    chk.ok(ids.shape == (N_QUERIES, KNN_K) and ids.min() >= 0
           and bool(np.all(np.isfinite(dist)))
           and bool(np.all(np.diff(dist, axis=1) >= 0)),
           f"query_knn: {KNN_K} ids a query, finite ascending distances")
    t = time.perf_counter()
    rows = np.random.default_rng(SEED + 4).choice(N_QUERIES, N_ORACLE,
                                                  replace=False)
    want, sq, tol = knn_oracle(index, xs64, hn64, q[rows], KNN_K)
    ties, bad = knn_agreement(index, ids[rows], want, sq, tol)
    inv = np.empty_like(index.order)
    inv[index.order] = np.arange(index.order.size)
    d_err = max(float(np.max(np.abs(
        np.sqrt(np.maximum(sq[k, inv[ids[i]]], 0.0)) - dist[i])))
        for k, i in enumerate(rows))
    chk.note(f"float64 top-{KNN_K} of {N_ORACLE} queries: "
             f"{time.perf_counter() - t:.2f} s (host)")
    chk.ok(bad == 0, f"query_knn vs float64 top-{KNN_K} on {N_ORACLE} "
           f"queries: {ties} ranks with another id, all in-band ties; "
           f"{bad} ranks whose distances differ past the band; max "
           f"|distance - float64| {d_err:.3e}")
    chk.ok(d_err <= 1e-4, "query_knn distances within 1e-4 of the float64 "
           "brute force")
    kv = np.random.default_rng(SEED + 5).integers(0, KNN_K + 1, N_ORACLE)
    kv[0] = KNN_K
    ids_v = knn.query_knn(index, q[rows], kv, return_distance=False,
                          device=DEVICE)
    cols = np.arange(KNN_K)[None, :]
    chk.ok(np.array_equal(np.where(cols < kv[:, None], ids[rows], -1), ids_v),
           f"per-query k vector (0..100) on {N_ORACLE} queries: each row the "
           "prefix of its k = 100 row, -1 past its k")
    small = snn.build_index(xs64[:50].astype(np.float32) + index.mu,
                            device=DEVICE)
    si, sd = knn.query_knn(small, q[:8], 80, device=DEVICE)
    chk.ok(bool(np.all(si[:, 50:] == -1)) and bool(np.all(np.isinf(sd[:, 50:])))
           and bool(np.all(np.sort(si[:, :50], axis=1) == np.arange(50))),
           "k = 80 > n = 50: every row once, then id -1 and +inf")
    return launches


def phase_counts(torch, chk: Checks, K, snn, join, index, x, q, radius, gd,
                 eps, degrees, csr, clock):
    """join_counts, degree_histogram and reverse_neighbors on the card."""
    out = {}
    K.reset_launch_counts()
    jc = clock("join_counts of the main path's queries",
               lambda: join.join_counts(q, None, radius, b_index=index,
                                        device=DEVICE))
    out["join_counts"] = launch_counts(K)
    chk.ok(np.array_equal(jc, np.diff(csr.indptr))
           and out["join_counts"]["snn_compact_stacked"] == 0,
           "join_counts == diff(query_radius_csr indptr), no compact launch")
    K.reset_launch_counts()
    hist, deg = clock(f"degree_histogram of phase 2b's {gd.index.n} points "
                      "at the graph's eps",
                      lambda: join.degree_histogram(gd.x, eps,
                                                    index=gd.index,
                                                    device=DEVICE))
    out["degree_histogram"] = launch_counts(K)
    chk.ok(np.array_equal(deg, degrees)
           and np.array_equal(hist, np.bincount(degrees)),
           f"degree_histogram == diff(graph indptr) of phase 2b, hist == "
           f"bincount (mean degree {deg.mean():.2f}, max {deg.max()})")
    radii = radius * np.random.default_rng(SEED + 6).uniform(0.9, 1.1,
                                                             N_QUERIES)
    fwd = snn.query_radius_csr(index, q, radii, return_distance=False,
                               device=DEVICE)
    K.reset_launch_counts()
    rev = clock("reverse_neighbors of the main path's queries",
                lambda: join.reverse_neighbors(q, x, radii,
                                               target_index=index,
                                               device=DEVICE))
    out["reverse_neighbors"] = launch_counts(K)
    rows = np.repeat(np.arange(N_QUERIES), np.diff(fwd.indptr))
    order = np.lexsort((rows, fwd.indices))
    back = np.repeat(np.arange(index.n), np.diff(rev.indptr))
    chk.ok(rev.m == index.n and np.array_equal(back, fwd.indices[order])
           and np.array_equal(rev.indices, rows[order]),
           f"reverse_neighbors with per-query radii == the transpose of the "
           f"forward CSR ({rev.nnz} pairs)")
    return out


def pair_band(index, xs64, hn64, q: np.ndarray, radius, qi, ids):
    """For pairs (query ``qi[j]`` of ``q``, original id ``ids[j]``): whether
    each lies inside the float32 rounding band of its threshold."""
    inv = np.empty_like(index.order)
    inv[index.order] = np.arange(index.order.size)
    pos = inv[ids]
    xq, r = index.prepare_queries(q, radius)
    q64 = xq.astype(np.float64)
    thr = (r * r - np.einsum("ij,ij->i", q64, q64)) / 2.0
    return outside_band(xs64, hn64, q64, thr, qi, pos) == 0, pos


def phase_host(torch, chk: Checks, K, snn, index, q, radius, csr, xs64,
               hn64, clock):
    """The host Algorithm 2 batch and query_radius_fixed through the
    filter, against the CSR path."""
    out = {}
    rows = np.random.default_rng(SEED + 2).choice(N_QUERIES, N_ORACLE,
                                                  replace=False)
    K.reset_launch_counts()
    batch = clock(f"query_radius_batch of {N_ORACLE} queries (host "
                  "Algorithm 2, one GEMM a group on the card)",
                  lambda: snn.query_radius_batch(index, q[rows], radius,
                                                 return_distance=False))
    out["query_radius_batch"] = launch_counts(K)
    qi, ids = [], []
    for k, i in enumerate(rows):
        d = np.setxor1d(batch[k], csr.indices[csr.indptr[i]:csr.indptr[i + 1]])
        qi += [k] * d.size
        ids += d.tolist()
    in_band = (pair_band(index, xs64, hn64, q[rows], radius,
                         np.asarray(qi, np.int64),
                         np.asarray(ids, np.int64))[0] if ids else True)
    chk.ok(in_band and sum(out["query_radius_batch"].values()) == 0,
           f"query_radius_batch == the CSR rows as sets on {N_ORACLE} "
           f"queries, {len(ids)} pairs differing, all inside the float32 "
           "band; no query kernel launched")

    K.reset_launch_counts()
    fi, fs, fv, fc = clock(f"query_radius_fixed K={FIXED_K}",
                           lambda: snn.query_radius_fixed(index, q, radius,
                                                          FIXED_K))
    torch.cuda.synchronize()
    out["query_radius_fixed"] = launch_counts(K)
    chk.ok(out["query_radius_fixed"]["snn_filter"] == 1,
           "query_radius_fixed launched the filter kernel once")
    counts = np.diff(csr.indptr)
    off = np.nonzero(fc != counts)[0]
    # a query whose count differs: every pair between the two thresholds
    # (the fixed path rounds its threshold in float32 as the reference's
    # does, the CSR path from float64) must lie inside the band
    in_band, _ = counts_in_band(torch, index, q, radius, fc, counts)
    chk.ok(in_band, f"query_radius_fixed counts == CSR counts on "
           f"{N_QUERIES - off.size} of {N_QUERIES} queries; the other "
           f"{off.size} differ by pairs inside the float32 band")
    inv = np.empty_like(index.order)
    inv[index.order] = np.arange(index.order.size)
    same = 0
    for i in range(N_QUERIES):
        s, e = csr.indptr[i], csr.indptr[i + 1]
        cid = csr.indices[s:e]
        want = cid[np.lexsort((inv[cid], csr.distances[s:e]))][:FIXED_K]
        same += int(np.array_equal(fi[i][fv[i]], want))
    chk.ok(same >= N_QUERIES - off.size,
           f"query_radius_fixed valid ids == the {FIXED_K} nearest of the "
           f"CSR row (ties by sorted row) on {same} of {N_QUERIES} queries "
           f"(all but the {off.size} in-band count differences)")
    truncated = int(np.sum(fc > FIXED_K))
    chk.note(f"query_radius_fixed: {truncated} queries hold more than "
             f"K = {FIXED_K} neighbours (cut, counts exact)")
    return out


def phase_dbscan_host(torch, chk: Checks, snn, dbscan, x, clock):
    """DBSCAN's host backend ``snn`` against the engine's ``snn-csr`` on a
    seeded subset: graphs equal up to band pairs, labels equal."""
    sub = np.sort(np.random.default_rng(SEED + 7).choice(
        x.shape[0], DBSCAN_ROWS, replace=False))
    xsub = x[sub]
    sidx = snn.build_index(xsub, device=DEVICE)
    eps = calibrate_radius(torch, sidx, xsub[:64], GRAPH_NEIGHBOURS)
    host = clock(f"neighbor_graph backend='snn' on {DBSCAN_ROWS} rows "
                 "(host Algorithm 2)",
                 lambda: dbscan.neighbor_graph(xsub, eps, "snn",
                                               device=DEVICE))
    eng = clock(f"neighbor_graph backend='snn-csr' on {DBSCAN_ROWS} rows",
                lambda: dbscan.neighbor_graph(xsub, eps, "snn-csr",
                                              device=DEVICE))

    def keys(g):
        r = np.repeat(np.arange(g.m, dtype=np.int64), np.diff(g.indptr))
        return r * g.m + g.indices

    diff = np.setxor1d(keys(host), keys(eng))
    xs64 = sidx.xs.cpu().numpy().astype(np.float64)
    hn64 = 0.5 * np.einsum("ij,ij->i", xs64, xs64)
    qi, ids = diff // DBSCAN_ROWS, diff % DBSCAN_ROWS
    ok = (pair_band(sidx, xs64, hn64, xsub, eps, qi, ids)[0]
          if diff.size else True)
    lab_h = dbscan.labels_from_graph(host, MIN_SAMPLES)
    lab_e = dbscan.labels_from_graph(eng, MIN_SAMPLES)
    core = (np.diff(host.indptr) >= MIN_SAMPLES) | (
        np.diff(eng.indptr) >= MIN_SAMPLES)
    touched = bool(core[qi].any() or core[ids].any()) if diff.size else False
    chk.ok(ok, f"DBSCAN graphs, backend snn vs snn-csr at eps {eps:.4f}: "
           f"{host.nnz} pairs, {diff.size} differing, all inside the float32 "
           "band")
    chk.ok(touched or np.array_equal(lab_h, lab_e),
           f"DBSCAN labels of both backends equal ({int(lab_h.max()) + 1} "
           f"clusters, {int((lab_h < 0).sum())} noise points)"
           + ("; a band pair touches a core point" if touched else ""))


def phase_streaming(torch, chk: Checks, K, ref, ops_mod, engine, snn, knn,
                    streaming, x, q, radius, clock):
    """The streaming index over the stand-in: 8 appends of 8,192 rows
    (bench_streaming's full-size cell at d = 128), exact at every
    generation against a float64 brute force, through a merge.  At the
    last generation the stacked kernels are held against their plain
    versions on the plan's own live stack.  Returns the launches of the
    streaming index's own queries, {kernel: launches}."""
    stats = engine.DISPATCH_STATS
    rows = np.random.default_rng(SEED + 8).choice(N_QUERIES, N_ORACLE,
                                                  replace=False)
    K.reset_launch_counts()
    stream = clock(f"StreamingSNNIndex over {x.shape[0]} rows",
                   lambda: streaming.StreamingSNNIndex(x, device=DEVICE))
    stream.set_plan_warming(m_pads=(N_QUERIES,))
    raw = x
    append_ms, query_ms, fused, n_band, n_bad = [], [], 0, 0, 0
    for gen in range(N_APPENDS + 1):
        if gen:
            batch = sift_standin(APPEND_ROWS, DIM, SEED + gen)
            torch.cuda.synchronize()
            t = time.perf_counter()
            stream.append(batch)
            torch.cuda.synchronize()
            append_ms.append(1e3 * (time.perf_counter() - t))
            raw = np.concatenate([raw, batch])
        stats.reset()
        t = time.perf_counter()
        res = stream.query_radius_csr(q, radius)
        query_ms.append(1e3 * (time.perf_counter() - t))
        s = stats.snapshot()
        if gen:
            fused += int(s["kernel_launches"] == 3
                         and s["host_transfers"] == 1)
        keep, band = stream_oracle(torch, stream, raw, q[rows], radius)
        b_, x_ = sets_vs_oracle(res, rows, keep, band)
        n_band, n_bad = n_band + b_, n_bad + x_
        counts = stream.query_counts_device(q, radius)
        chk.ok(np.array_equal(counts, np.diff(res.indptr))
               and stream.n == raw.shape[0] and res.indices.max() < raw.shape[0],
               f"generation {gen}: {len(stream.parts)} parts, {stream.n} rows, "
               f"query_counts_device == diff(indptr), {res.nnz} pairs")
    chk.note("append ms per batch: " + ", ".join(f"{t:.1f}" for t in append_ms))
    chk.note("query ms per generation (host clock, the first batch after "
             "each publish): " + ", ".join(f"{t:.1f}" for t in query_ms))
    chk.ok(n_bad == 0, f"every generation vs float64 brute force over all "
           f"its rows on {N_ORACLE} queries: {n_band} pairs inside the band, "
           f"{n_bad} outside")
    chk.ok(fused == N_APPENDS, f"the first batch after each warmed publish "
           f"took the fused path (3 launches, 1 transfer): {fused} of "
           f"{N_APPENDS}")
    chk.ok(stream.warm_runs == N_APPENDS and stream.warm_failures == 0
           and stream.plan_bytes() > 0,
           f"plan warming: {stream.warm_runs} warms, {stream.warm_failures} "
           f"failed; plan_bytes {stream.plan_bytes()}")
    chk.ok(stream.generation == N_APPENDS and len(stream.parts) == 4,
           "the fifth append merged the four deltas into the base "
           f"(parts now {len(stream.parts)})")

    # the last generation: looped, kNN against a fresh index, a restore
    looped = stream.query_radius_csr(q, radius, packed=False)
    chk.ok(np.array_equal(looped.indptr, res.indptr)
           and np.array_equal(looped.indices, res.indices)
           and np.array_equal(looped.distances.view(np.int64),
                              res.distances.view(np.int64)),
           "streaming packed=False bit-identical to packed")
    si, sd = stream.query_knn(q[rows], KNN_K)
    # what follows until the next reset is not the streaming path: a fresh
    # index's kNN, and the kernels against their plain versions
    launches = launch_counts(K)
    fresh = snn.build_index(raw, device=DEVICE)
    fi, fd = knn.query_knn(fresh, q[rows], KNN_K, device=DEVICE)
    del fresh
    plan_kernels(torch, chk, K, ref, ops_mod, engine, snn, stream,
                 q[:STREAM_CHECK_Q], radius)
    K.reset_launch_counts()
    xn2 = float(np.max(np.einsum("ij,ij->i", raw, raw)))
    qn2 = np.einsum("ij,ij->i", q[rows].astype(np.float64), q[rows])[:, None]
    tol = 4.0 * DIM * EPS32 * (xn2 + qn2 + np.sqrt(xn2 * qn2))
    gap = np.abs(sd * sd - fd * fd)
    chk.ok(bool(np.all(gap <= tol)),
           f"streaming query_knn == query_knn on a fresh build_index of all "
           f"{raw.shape[0]} rows, {N_ORACLE} queries: {int(np.sum(si != fi))} "
           "ranks with another id, every rank's distance within the float32 "
           "band")
    leaves, extra = stream.state_leaves()
    back = streaming.StreamingSNNIndex.from_state(leaves, extra,
                                                  device=DEVICE)
    del leaves
    again = back.query_radius_csr(q, radius)
    chk.ok(np.array_equal(again.indptr, res.indptr)
           and np.array_equal(again.indices, res.indices)
           and np.array_equal(again.distances, res.distances),
           "state_leaves -> from_state answers bit-identically")
    del back, again
    torch.cuda.synchronize()
    t = time.perf_counter()
    stream.rebuild()
    torch.cuda.synchronize()
    chk.note(f"rebuild() of {stream.n} rows: "
             f"{1e3 * (time.perf_counter() - t):.1f} ms")
    res = stream.query_radius_csr(q, radius)
    keep, band = stream_oracle(torch, stream, raw, q[rows], radius)
    b_, x_ = sets_vs_oracle(res, rows, keep, band)
    chk.ok(x_ == 0 and stream.warm_failures == 0,
           f"after rebuild(): {N_ORACLE} queries vs float64 brute force, "
           f"{b_} pairs inside the band, {x_} outside")
    launches = {k: v + launch_counts(K)[k] for k, v in launches.items()}
    del stream
    return launches


def plan_kernels(torch, chk: Checks, K, ref, ops_mod, engine, snn, stream,
                 q: np.ndarray, radius) -> None:
    """`stacked_kernels` on the streaming plan's live stack for ``q``,
    prepared as the streaming query prepares it: the base and its deltas,
    each padded to the base's rows, so the stack is mostly padding.  The
    plain versions hold (m, S * n_pad) products, so ``q`` is a slice of the
    batch."""
    pack, base = stream.plan(), stream.parts[0]
    xq, aq, r32, th, _ = snn.prepare_query_predicates(base, q, radius)
    qp, aqp, rp, thp, m = ops_mod.pad_queries(xq, aq, r32, th, tq=128,
                                              bucket=True)
    pqp = ops_mod.pad_components(snn.query_extra_projections(base, xq),
                                 qp.shape[0])
    host, kq, pq64, qn64, dev_ops = engine._query_operands(
        pack, m, qp, aqp, rp, thp, pqp)
    live = engine._live_idx(pack, host[1], host[2], m, 0, pq64, qn64)
    chk.ok(live.size == pack.n_segments,
           f"every one of the plan's {pack.n_segments} segments live for "
           f"{m} queries")
    stacked_kernels(torch, chk, K, ref, ops_mod, engine, pack, live, kq,
                    dev_ops, host, m,
                    "stacked kernels at the streaming plan's shape")


def phase_front_ends(torch, chk: Checks, K, ref, ops_mod, snn, engine, join,
                     dbscan, index, x, q, radius, gd, eps, degrees, xs64,
                     hn64, clock):
    """Phase 2c: the front-ends over the engine on the main path's data.
    Returns each path's kernel launches, {path: {kernel: launches}}."""
    print(f"phase 2c: kNN, count-only joins, host Algorithm 2, "
          f"query_radius_fixed, DBSCAN's host backend and the streaming "
          f"index, n={index.n} d={DIM} m={N_QUERIES}")
    knn = importlib.import_module("repro_torch.core.knn")
    streaming = importlib.import_module("repro_torch.core.streaming")
    paths = {}
    csr = snn.query_radius_csr(index, q, radius, device=DEVICE)
    paths["query_knn"] = phase_knn(torch, chk, K, snn, knn, index, q, xs64,
                                   hn64, clock)
    paths.update(phase_counts(torch, chk, K, snn, join, index, x, q, radius,
                              gd, eps, degrees, csr, clock))
    paths.update(phase_host(torch, chk, K, snn, index, q, radius, csr, xs64,
                            hn64, clock))
    phase_dbscan_host(torch, chk, snn, dbscan, x, clock)
    paths["streaming"] = phase_streaming(torch, chk, K, ref, ops_mod, engine,
                                         snn, knn, streaming, x, q, radius,
                                         clock)
    torch.cuda.empty_cache()
    return {p: {k: v for k, v in c.items() if v} for p, c in paths.items()}


# --------------------------------------------------------------------------- #
# phase 3                                                                      #
# --------------------------------------------------------------------------- #
def outside_band(x64, hn64, q64, thr64, dq, dj) -> int:
    """How many of the pairs (query ``dq[i]``, row ``dj[i]``) have a float64
    half distance farther from the threshold than the float32 rounding band
    d*2^-23*(hn + sum|q x|) + 2^-23*|thresh|."""
    d64 = hn64[dj] - np.einsum("ij,ij->i", x64[dj], q64[dq])
    tol = DIM * EPS32 * (hn64[dj] + np.einsum(
        "ij,ij->i", np.abs(x64[dj]), np.abs(q64[dq]))) \
        + EPS32 * np.abs(thr64[dq])
    return int((np.abs(d64 - thr64[dq]) > tol).sum())


def pair_check(k, p, n_cols, x64, hn64, q64, thr64):
    """Kernel vs plain CSR outputs ((counts, idx, dhalf) on the card, idx
    in ``[0, n_cols)``): pairs may differ only inside the float32 rounding
    band, and common pairs' dhalf within d*2^-23*(hn + sum|q x|).
    ``x64``/``hn64`` are the rows in float64, ``q64``/``thr64`` the
    queries'.  Returns (common pairs, differing pairs, pairs outside the
    band, max |dhalf| difference, every common dhalf within its bound)."""
    sides = []
    for cnt, idx, dh in (k, p):
        c = cnt.cpu().numpy().astype(np.int64)
        total = int(c.sum())
        qrow = np.repeat(np.arange(c.size), c)
        sides.append((qrow * n_cols + idx[:total].cpu().numpy(),
                      dh[:total].cpu().numpy()))
    (kkey, kdh), (pkey, pdh) = sides
    common, ki, pi = np.intersect1d(kkey, pkey, return_indices=True)
    diff = np.setxor1d(kkey, pkey)
    out_of_band = outside_band(x64, hn64, q64, thr64, diff // n_cols,
                               diff % n_cols)
    cq, cj = common // n_cols, common % n_cols
    tol_c = DIM * EPS32 * (hn64[cj] + np.einsum(
        "ij,ij->i", np.abs(x64[cj]), np.abs(q64[cq])))
    err = np.abs(kdh[ki].astype(np.float64) - pdh[pi].astype(np.float64))
    return (int(common.size), int(diff.size), out_of_band,
            float(err.max()) if err.size else 0.0, bool(np.all(err <= tol_c)))


def window_pairs(al_rows: np.ndarray, aq64, r64) -> int:
    """(query, row) pairs inside each query's alpha window, over the
    segment's sorted real alphas: the pairs whose product the data needs."""
    lo = np.searchsorted(al_rows, aq64 - r64, side="left")
    hi = np.searchsorted(al_rows, aq64 + r64, side="right")
    return int(np.sum(hi - lo))


def bound_ms(flops: float, nbytes: float):
    t_ops, t_bytes = flops / FP32_PEAK, nbytes / HBM_RATE
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def compact_work(torch, partials, al, aq64, r64, d_pad: int, ke: int,
                 bn: int):
    """The work the compact pass needs once the count's partials are known:
    the alpha-window rows of every (segment, query, row block) cell with a
    survivor, and nothing of the other cells.  ``partials`` (S, m_pad, nb)
    and ``al`` (S, n_pad, each segment sorted, +BIG padding) are on the card,
    ``aq64``/``r64`` the m real queries' alphas and radii in float64.
    Returns (window pairs of those cells, FP32 operations (2*DIM a pair),
    bytes: read once, the union of those rows (d_pad features, alpha, half
    norm and ke projections a row), the listed queries (d_pad features, aq,
    r, th and ke projections), every partial and the listed cells' bases;
    written once, the (id, dhalf) of each survivor)."""
    dev = partials.device
    part = partials.reshape(-1, *partials.shape[-2:])
    S, m_pad, nb = part.shape
    m = aq64.size
    listed = part[:, :m] > 0
    al64 = al.reshape(S, -1).double().contiguous()
    n_pad = al64.shape[1]
    aq = torch.from_numpy(aq64).to(dev)
    rr = torch.from_numpy(r64).to(dev)
    lo = torch.searchsorted(al64, (aq - rr).expand(S, m).contiguous(),
                            side="left")
    hi = torch.searchsorted(al64, (aq + rr).expand(S, m).contiguous(),
                            side="right")
    b0 = torch.arange(nb, device=dev) * bn
    start = torch.maximum(lo[..., None], b0)
    end = torch.minimum(hi[..., None], b0 + bn)
    live = listed & (end > start)
    pairs = int(torch.where(live, end - start, 0).sum())
    # the union of the listed windows' rows: +1 at each start, -1 at each
    # end, a running sum along each segment
    seg = torch.arange(S, device=dev).view(S, 1, 1).expand_as(start)[live]
    base = seg * (n_pad + 1)
    marks = torch.zeros(S * (n_pad + 1), dtype=torch.int32, device=dev)
    ones = torch.ones(base.numel(), dtype=torch.int32, device=dev)
    marks.index_add_(0, base + start[live], ones)
    marks.index_add_(0, base + end[live], -ones)
    rows = int((marks.view(S, n_pad + 1).cumsum(1) > 0).sum())
    n_q = int(listed.any(2).any(0).sum())
    nbytes = 4 * (rows * (d_pad + 2 + ke) + n_q * (d_pad + 3 + ke)
                  + part.numel() + int(listed.sum())) + 8 * int(part.sum())
    return pairs, 2.0 * DIM * pairs, nbytes


def stacked_kernels(torch, chk: Checks, K, ref, ops_mod, engine, pack, live,
                    kq: int, dev_ops, host, m: int, tag: str) -> dict:
    """snn_count_stacked and snn_compact_stacked on the live stack of
    ``pack``, gathered as `engine.run_csr_packed` gathers it, for the query
    operands of `engine._query_operands`: each against its plain version
    (the count's partials handed to the compact), then timed beside it, its
    bound and one torch.matmul of the same product.  Returns
    {"snn_count_stacked": {...}, "snn_compact_stacked": {...}}."""
    qd, aqd, rd, thd, pqd = dev_ops
    xs, al, hn, _, px = engine._gather_live_stacked(pack, live, kq)
    S, n_pad, d_pad = xs.shape
    m_pad, bn = int(qd.shape[0]), pack.block
    args = (qd, aqd, rd, thd)
    k_per, k_part = K.snn_count_stacked(*args, xs, al, hn, pqd, px, bn=bn,
                                        with_partials=True)
    p_per, p_part = ref.snn_count_stacked_ref(*args, xs, al, hn, pqd, px,
                                              bn=bn, with_partials=True)
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
    part_diff = int((k_part - p_part).abs().sum())
    x64 = xs.reshape(S * n_pad, d_pad)[:, :DIM].double().cpu().numpy()
    hn64 = 0.5 * np.einsum("ij,ij->i", x64, x64)
    common, ndiff, oob, dh_err, dh_ok = pair_check(
        (k_per.sum(0), k_idx, k_dh), (p_per.sum(0), p_idx, p_dh), S * n_pad,
        x64, hn64, host[0][:, :DIM].astype(np.float64),
        host[3].astype(np.float64))
    del x64, hn64
    tag = f"{tag} (S={S}, m_pad={m_pad}, n_pad={n_pad})"
    chk.ok(oob == 0 and dh_ok and part_diff <= ndiff
           and int((k_per - p_per).abs().sum()) <= ndiff,
           f"{tag}: kernel vs plain, {common} pairs common, {ndiff} "
           f"differing all inside the band; counts and partials differ only "
           f"by those pairs (count max |diff| {count_err}, partials "
           f"{part_diff}); dhalf max |diff| {dh_err:.3e} within "
           "d*2^-23*(hn + sum|q x|)")
    chk.ok(bool((k_idx[:k_total] >= 0).all())
           and bool((k_idx[k_total:] == -1).all())
           and bool((k_dh[k_total:] == ref.BIG).all()),
           f"{tag}: every one of the {k_total} data slots written, -1/+BIG "
           f"in the {nnz - k_total} unwritten and trash slots")

    reps = 10
    k_count_ms = timed(torch, lambda: K.snn_count_stacked(
        *args, xs, al, hn, pqd, px, bn=bn, with_partials=True), reps)
    k_mixed_ms = timed(torch, lambda: K.snn_count_stacked(
        *args, xs, al, hn, pqd, px, bn=bn, mixed=True, with_partials=True),
        reps)
    k_compact_ms = timed(torch, lambda: K.snn_compact_stacked(
        *args, k_off, xs, al, hn, pqd, px, nnz=nnz, bn=bn, partials=k_part),
        reps)
    k_count_dev = device_ms(torch, K, lambda: K.snn_count_stacked(
        *args, xs, al, hn, pqd, px, bn=bn, with_partials=True), reps)
    k_compact_dev = device_ms(torch, K, lambda: K.snn_compact_stacked(
        *args, k_off, xs, al, hn, pqd, px, nnz=nnz, bn=bn, partials=k_part),
        reps)
    p_count_ms = timed(torch, lambda: ref.snn_count_stacked_ref(
        *args, xs, al, hn, pqd, px, bn=bn, with_partials=True), 2)
    p_compact_ms = timed(torch, lambda: ref.snn_compact_stacked_ref(
        *args, p_off, xs, al, hn, pqd, px, nnz=nnz), 2)
    xf = xs.reshape(S * n_pad, d_pad)
    lib_ms = timed(torch, lambda: torch.matmul(qd, xf.T), reps)

    # the work this data needs: every pair inside its query's alpha window
    al_rows = al.reshape(-1).cpu().numpy().astype(np.float64)
    al_rows = np.sort(al_rows[al_rows < ref.BIG])
    pairs = window_pairs(al_rows, host[1][:m].astype(np.float64),
                         host[2][:m].astype(np.float64))
    flops = 2.0 * DIM * pairs
    in_bytes = 4 * sum(t.numel() for t in (qd, aqd, rd, thd, xs, al, hn, pqd,
                                           px) if t is not None)
    count_bytes = in_bytes + 4 * S * m_pad * (1 + n_pad // bn)
    c_bound, c_by = bound_ms(flops, count_bytes)
    ke = 0 if pqd is None else int(pqd.shape[0])
    p_pairs, p_flops, p_bytes = compact_work(
        torch, k_part, al, host[1][:m].astype(np.float64),
        host[2][:m].astype(np.float64), d_pad, ke, bn)
    p_bound, p_by = bound_ms(p_flops, p_bytes)
    chk.note(f"{tag}: {pairs} alpha-window pairs of {m * al_rows.size} "
             f"({pairs / (m * al_rows.size):.4f}), {flops:.4e} FP32 "
             f"operations for the count; the compact's: {p_pairs} window "
             f"pairs in the row blocks its partials list, {p_flops:.4e} "
             f"operations, {p_bytes / 1e6:.2f} MB")
    chk.note(f"{tag}: snn_count_stacked {k_count_ms:.4f} ms "
             f"({flops / k_count_ms / 1e9:.2f} TFLOP/s; the kernel alone "
             f"{k_count_dev:.4f} ms), mixed "
             f"{k_mixed_ms:.4f} ms, plain {p_count_ms:.4f} ms, bound "
             f"{c_bound:.4f} ms ({c_by}); snn_compact_stacked "
             f"{k_compact_ms:.4f} ms (alone {k_compact_dev:.4f} ms), plain "
             f"{p_compact_ms:.4f} ms, bound "
             f"{p_bound:.4f} ms ({p_by}); torch.matmul {lib_ms:.4f} ms")
    geo = geometries(K, S, m_pad, n_pad, bn, pqd)
    chk.note(f"{tag}: launches {geo}")
    shape = {"S": int(S), "m_pad": m_pad, "n_pad": int(n_pad)}
    return {
        "snn_count_stacked": dict(
            shape, max_abs_err=float(count_err), ms=k_count_ms,
            device_ms=k_count_dev, plain_ms=p_count_ms, bound_ms=c_bound,
            bound_by=c_by, library_ms=lib_ms, mixed_ms=k_mixed_ms,
            geometry=geo["count"]),
        "snn_compact_stacked": dict(
            shape, max_abs_err=dh_err, ms=k_compact_ms,
            device_ms=k_compact_dev, plain_ms=p_compact_ms, bound_ms=p_bound,
            bound_by=p_by, library_ms=lib_ms, geometry=geo["compact"]),
    }


def geometries(K, S, m_pad, n_pad, bn, pq) -> dict:
    ke = 0 if pq is None else int(pq.shape[0])
    return {k: K.launch_geometry(k, int(S), int(m_pad), int(n_pad), bn, ke)
            for k in ("count", "compact")}


def phase_times(torch, chk: Checks, K, ref, ops_mod, snn, engine, index, q,
                radius, launches):
    print("phase 3: kernel times at the main path's shapes")
    pack = index.pack(512, DEVICE)
    xq, aq, r32, th, _ = snn.prepare_query_predicates(index, q, radius)
    qp, aqp, rp, thp, m = ops_mod.pad_queries(xq, aq, r32, th, tq=128,
                                              bucket=True)
    pqp = ops_mod.pad_components(snn.query_extra_projections(index, xq),
                                 qp.shape[0])
    host, kq, _, _, dev_ops = engine._query_operands(pack, m, qp, aqp, rp,
                                                     thp, pqp)
    recs = stacked_kernels(torch, chk, K, ref, ops_mod, engine, pack,
                           np.arange(pack.n_segments), kq, dev_ops, host, m,
                           "stacked kernels at the point-query shape")
    src = "src/repro_torch/kernels/csrc/snn_query.cu"
    return [{"name": name, "route": "cuda", "source": src,
             "replaces": f"src/repro/kernels/snn_query.py:{line}",
             "launches": launches[name], **recs[name]}
            for name, line in (("snn_count_stacked", 447),
                               ("snn_compact_stacked", 549))]


def segment_operands(torch, ops_mod, snn, engine, index, qraw, radius,
                     row0: int, n_rows: int):
    """The single-segment kernels' operands for the queries ``qraw`` against
    sorted rows ``row0 : row0 + n_rows`` of the index, as the looped
    executor builds them: (ops on the card, the segment, the padded host
    queries, their alphas, radii and thresholds, m)."""
    xq, aq, r32, th, _ = snn.prepare_query_predicates(index, qraw, radius)
    qp, aqp, rp, thp, m = ops_mod.pad_queries(xq, aq, r32, th, tq=128,
                                              bucket=True)
    pqp = ops_mod.pad_components(snn.query_extra_projections(index, xq),
                                 qp.shape[0])
    dev = torch.device(DEVICE)
    qd, aqd, rd, thd, pqd = (torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                             for a in (qp, aqp, rp, thp, pqp))
    sl = slice(row0, row0 + n_rows)
    seg = engine.make_segment(index.xs[sl], index.alphas[sl],
                              index.half_norms[sl], index.order[sl],
                              block=512, projs=index.projs[1:, sl])
    ops = (qd, aqd, rd, thd, seg.xs, seg.alphas, seg.half_norms, pqd,
           seg.projs)
    return ops, seg, qp, aqp, rp, thp, m


def single_shape(torch, chk: Checks, K, ref, ops_mod, snn, engine, index,
                 qraw, radius, row0: int, n_rows: int, xs64, hn64, tag: str,
                 reps: int, plain_reps: int):
    """Times of snn_count and snn_compact on one segment (sorted rows
    ``row0 : row0 + n_rows`` of the index) for the queries ``qraw``, beside
    their plain versions and torch.matmul, with the kernel-vs-plain check.
    Returns {"count": {...}, "compact": {...}, "ops": ..., "csr": the
    kernels' (counts, idx, dhalf), ...}."""
    ops, seg, qp, aqp, rp, thp, m = segment_operands(
        torch, ops_mod, snn, engine, index, qraw, radius, row0, n_rows)
    qd, pqd = ops[0], ops[7]
    m_pad, n_pad = qd.shape[0], seg.xs.shape[0]
    sl = slice(row0, row0 + n_rows)
    k_cnt, k_part = K.snn_count(*ops, with_partials=True)
    p_cnt = ref.snn_count_ref(*ops)
    k_off = torch.cumsum(k_cnt, 0, dtype=torch.int32) - k_cnt
    p_off = torch.cumsum(p_cnt, 0, dtype=torch.int32) - p_cnt
    nnz = ops_mod.csr_capacity(max(int(k_cnt.sum()), int(p_cnt.sum())))
    k_idx, k_dh = K.snn_compact(*ops[:4], k_off, *ops[4:], nnz=nnz,
                                partials=k_part)
    p_idx, p_dh = ref.snn_compact_ref(*ops[:4], p_off, *ops[4:], nnz=nnz)
    # the same compiled predicate as the stacked kernels: bit-identical
    st_ops = (*ops[:4], seg.xs[None], seg.alphas[None], seg.half_norms[None],
              pqd, seg.projs[None])
    s_cnt = K.snn_count_stacked(*st_ops)
    s_idx, s_dh = K.snn_compact_stacked(*st_ops[:4], k_off[None], *st_ops[4:],
                                        nnz=nnz, partials=k_part[None])
    torch.cuda.synchronize()
    chk.ok(torch.equal(s_cnt[0], k_cnt) and torch.equal(s_idx, k_idx)
           and torch.equal(s_dh.view(torch.int32), k_dh.view(torch.int32)),
           f"{tag}: snn_count/snn_compact bit-identical to the stacked "
           "kernels on a stack of one")
    count_err = int((k_cnt - p_cnt).abs().max())
    common, ndiff, oob, dh_err, dh_ok = pair_check(
        (k_cnt, k_idx, k_dh), (p_cnt, p_idx, p_dh), n_pad, xs64[sl],
        hn64[sl], qp[:, :DIM].astype(np.float64), thp.astype(np.float64))
    chk.ok(oob == 0 and dh_ok,
           f"{tag}: kernel vs plain, {common} pairs common, {ndiff} differing "
           f"all inside the band; count max |diff| {count_err}; dhalf max "
           f"|diff| {dh_err:.3e} within d*2^-23*(hn + sum|q x|)")

    k_count_ms = timed(torch, lambda: K.snn_count(*ops, with_partials=True),
                       reps)
    k_mixed_ms = timed(torch, lambda: K.snn_count(*ops, mixed=True,
                                                  with_partials=True), reps)
    k_compact_ms = timed(torch, lambda: K.snn_compact(
        *ops[:4], k_off, *ops[4:], nnz=nnz, partials=k_part), reps)
    k_count_dev = device_ms(torch, K, lambda: K.snn_count(
        *ops, with_partials=True), reps)
    k_compact_dev = device_ms(torch, K, lambda: K.snn_compact(
        *ops[:4], k_off, *ops[4:], nnz=nnz, partials=k_part), reps)
    p_count_ms = timed(torch, lambda: ref.snn_count_ref(
        *ops, with_partials=True), plain_reps)
    p_compact_ms = timed(torch, lambda: ref.snn_compact_ref(
        *ops[:4], p_off, *ops[4:], nnz=nnz), plain_reps)
    xs1 = seg.xs
    lib_ms = timed(torch, lambda: torch.matmul(qd, xs1.T), reps)

    al_rows = seg.alphas[:seg.n].cpu().numpy().astype(np.float64)
    pairs = window_pairs(al_rows, aqp[:m].astype(np.float64),
                         rp[:m].astype(np.float64))
    flops = 2.0 * DIM * pairs
    in_bytes = 4 * (qd.numel() + 3 * m_pad + seg.xs.numel() + 2 * n_pad
                    + pqd.numel() + seg.projs.numel())
    part_bytes = 4 * m_pad * (1 + n_pad // 512)
    c_bound, c_by = bound_ms(flops, in_bytes + part_bytes)
    p_pairs, p_flops, p_bytes = compact_work(
        torch, k_part, seg.alphas, aqp[:m].astype(np.float64),
        rp[:m].astype(np.float64), int(qd.shape[1]), int(pqd.shape[0]), 512)
    p_bound, p_by = bound_ms(p_flops, p_bytes)
    chk.note(f"{tag}: m_pad={m_pad} n_pad={n_pad}, {pairs} window pairs "
             f"(the compact's row blocks with a survivor: {p_pairs}); "
             f"snn_count {k_count_ms:.4f} ms (the kernel alone "
             f"{k_count_dev:.4f}, mixed {k_mixed_ms:.4f}), plain "
             f"{p_count_ms:.4f}, bound {c_bound:.4f} ({c_by}); snn_compact "
             f"{k_compact_ms:.4f} ms (alone {k_compact_dev:.4f}), plain "
             f"{p_compact_ms:.4f}, bound {p_bound:.4f} ({p_by}); "
             f"torch.matmul {lib_ms:.4f} ms")
    geo = geometries(K, 1, m_pad, n_pad, 512, pqd)
    chk.note(f"{tag}: launches {geo}")
    shape = {"m_pad": int(m_pad), "n_pad": int(n_pad)}
    return {
        "count": dict(shape, ms=k_count_ms, device_ms=k_count_dev,
                      mixed_ms=k_mixed_ms, plain_ms=p_count_ms,
                      bound_ms=c_bound, bound_by=c_by, library_ms=lib_ms,
                      max_abs_err=float(count_err), geometry=geo["count"]),
        "compact": dict(shape, ms=k_compact_ms, device_ms=k_compact_dev,
                        plain_ms=p_compact_ms, bound_ms=p_bound, bound_by=p_by,
                        library_ms=lib_ms, max_abs_err=dh_err,
                        geometry=geo["compact"]),
        "ops": ops, "pairs": pairs, "qp": qp, "csr": (k_cnt, k_idx, k_dh),
    }


def tile_pairs(al, aq, r, order) -> tuple[int, np.ndarray]:
    """Pairs of the 128 x 128 tiles that the filter computes when its query
    tiles take the queries in ``order``: a tile is computed when the float32
    window of one of its queries meets the tile's alpha range (the kernel's
    slot_meets).  ``al`` (n_pad,) are the segment's sorted alphas, ``aq``,
    ``r`` (m_pad,) the padded queries', all float32 numpy.  Returns (pairs,
    the (query tiles, row tiles) bool map of computed tiles)."""
    hi, lo = aq + r, aq - r                   # float32, as on the card
    meets = ((hi[:, None] >= al[0::128][None, :])
             & (lo[:, None] <= al[127::128][None, :]))[order]
    meets = np.pad(meets, ((0, (-len(order)) % 128), (0, 0)))
    tiles = meets.reshape(-1, 128, meets.shape[1]).any(1)
    return int(tiles.sum()) * 128 * 128, tiles


def filter_checks(torch, chk: Checks, ref, f, ops, csr, pairs: int,
                  ptxas: dict) -> None:
    """The filter's output ``f`` at the main shape against the compact's
    survivors there (``csr``: the kernels' counts, ids, dhalf).  Notes the
    pairs its alpha-ordered tiles compute against the given order and the
    window pairs: a host copy of the kernel's skip test, not a measurement,
    so they stay out of the kernels line."""
    k_cnt, k_idx, k_dh = csr
    m_pad, n_pad = f.shape
    total = int(k_cnt.sum())
    finite = f < ref.BIG
    fq, fj = torch.nonzero(finite, as_tuple=True)
    rows = torch.arange(m_pad, device=f.device).repeat_interleave(
        k_cnt.long())
    same = (fq.numel() == total and torch.equal(fq, rows)
            and torch.equal(fj, k_idx[:total].long())
            and torch.equal(f[fq, fj].view(torch.int32),
                            k_dh[:total].view(torch.int32)))
    chk.ok(same, f"snn_filter at m_pad={m_pad} n_pad={n_pad}: its "
           f"{fq.numel()} finite entries are snn_compact's {total} "
           "survivors, (query, row) for (query, row), dhalf bit for bit")
    del fq, fj, rows
    aq, r = ops[1], ops[2]
    order = torch.argsort(aq, stable=True)     # the wrapper's order
    al = ops[5].cpu().numpy()
    aq_h, r_h = aq.cpu().numpy(), r.cpu().numpy()
    alpha_pairs, tiles = tile_pairs(al, aq_h, r_h, order.cpu().numpy())
    given_pairs, _ = tile_pairs(al, aq_h, r_h, np.arange(m_pad))
    # a tile the host count calls skipped holds no finite entry
    nqt, nrt = tiles.shape
    fin_tiles = finite.view(m_pad, nrt, 128).any(2)[order]
    fin_tiles = torch.nn.functional.pad(fin_tiles, (0, 0, 0, nqt * 128
                                                    - m_pad))
    fin_tiles = fin_tiles.view(nqt, 128, nrt).any(1).cpu().numpy()
    chk.ok(not (fin_tiles & ~tiles).any(),
           f"snn_filter: every finite entry lies in one of the {tiles.sum()} "
           f"of {tiles.size} 128 x 128 tiles computed in alpha order")
    chk.note(f"snn_filter pairs computed: {alpha_pairs} in 128 x 128 tiles "
             f"with the queries in alpha order, {given_pairs} in the given "
             f"order (also the single-segment count's at this shape), "
             f"{pairs} window pairs; alpha order computes "
             f"{alpha_pairs / given_pairs:.4f} of the given order's pairs, "
             f"{alpha_pairs / pairs:.4f} of the window pairs")
    for name, v in ptxas.items():
        if name.startswith("snn_filter_kernel"):
            chk.note(f"{name}: {v.get('registers')} registers, spills "
                     f"{v.get('spill_stores')} B stored / "
                     f"{v.get('spill_loads')} B loaded")


def phase_times_single(torch, chk: Checks, K, ref, ops_mod, snn, engine,
                       index, q, radius, xs64, hn64, gd, eps, looped, ptxas):
    """The three single-segment kernels: count and compact at both shapes
    the looped executor gives them, and the filter through its public op."""
    print("phase 3 (single-segment kernels)")
    n = index.n
    main = single_shape(torch, chk, K, ref, ops_mod, snn, engine, index, q,
                        radius, 0, n, xs64, hn64,
                        "query_radius_csr(packed=False) shape", 10, 3)
    gi = gd.index
    mid = (gi.n // QUERY_CHUNK // 2) * QUERY_CHUNK
    g = single_shape(torch, chk, K, ref, ops_mod, snn, engine, gi,
                     gd.x[gi.order[mid:mid + QUERY_CHUNK]], eps, mid,
                     SEGMENT_ROWS, gd.xs64, gd.hn64,
                     "graph segment shape (the chunk's own segment)", 200, 20)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = {k: g[k]["geometry"]["blocks"] for k in ("count", "compact")}
    chk.ok(min(blocks.values()) >= sms,
           f"graph segment shape: blocks a launch {blocks}, at least one for "
           f"each of the card's {sms} SMs")

    # snn_filter: the public op at the main path's shapes, a path of its own
    ops = main["ops"]
    qd, xs1, hn1 = ops[0], ops[4], ops[6]
    m_pad, n_pad = qd.shape[0], xs1.shape[0]
    K.reset_launch_counts()
    f = ops_mod.snn_filter(*ops)
    torch.cuda.synchronize()
    f_launches = K.snn_filter.launches
    chk.ok(f_launches == 1, "kernels.ops.snn_filter launched the kernel once")
    filter_checks(torch, chk, ref, f, ops, main["csr"], main["pairs"], ptxas)
    pf = ref.snn_filter_ref(*ops)
    kf, kp = f < ref.BIG, pf < ref.BIG
    both = kf & kp
    err = (f - pf).abs()[both]
    f_err = float(err.max()) if err.numel() else 0.0
    qi, j = torch.nonzero(both, as_tuple=True)
    absdot = (ops[0][qi, :DIM].abs() * xs1[j, :DIM].abs()).sum(1)
    tol = DIM * EPS32 * (hn1[j] + absdot)
    within = bool((err <= tol).all())
    dq, dj = (t.cpu().numpy() for t in torch.nonzero(kf ^ kp, as_tuple=True))
    oob = outside_band(xs64, hn64, main["qp"][:, :DIM].astype(np.float64),
                       ops[3].cpu().numpy().astype(np.float64), dq, dj)
    chk.ok(oob == 0 and within,
           f"snn_filter at m_pad={m_pad} n_pad={n_pad}: {int(both.sum())} "
           f"finite entries common, {dq.size} differing all inside the band; "
           f"max |diff| {f_err:.3e} within d*2^-23*(hn + sum|q x|)")
    del f, pf, kf, kp, both, err, qi, j, absdot, tol
    k_ms = timed(torch, lambda: K.snn_filter(*ops), 5)
    k_dev = device_ms(torch, K, lambda: K.snn_filter(*ops), 5)
    p_ms = timed(torch, lambda: ref.snn_filter_ref(*ops), 2)
    hn_row = hn1[None, :]
    lib_ms = timed(torch, lambda: torch.addmm(hn_row, qd, xs1.T, beta=1.0,
                                              alpha=-1.0), 5)
    in_bytes = 4 * sum(t.numel() for t in ops)
    f_bound, f_by = bound_ms(2.0 * DIM * main["pairs"],
                             in_bytes + 4 * m_pad * n_pad)
    chk.note(f"snn_filter {k_ms:.4f} ms (the kernel alone {k_dev:.4f}), "
             f"plain {p_ms:.4f}, bound "
             f"{f_bound:.4f} ({f_by}; {4 * m_pad * n_pad / 1e9:.2f} GB "
             f"written), torch.addmm {lib_ms:.4f} ms")

    src = "src/repro_torch/kernels/csrc/snn_query.cu"
    out = []
    for name, key, line in (("snn_count", "count", 274),
                            ("snn_compact", "compact", 373)):
        rec = dict(main[key])
        by_path = {"query_radius_csr packed=False": looped[0][name],
                   "graph: looped sampled chunks": looped[1][name]}
        out.append({"name": name, "route": "cuda", "source": src,
                    "replaces": f"src/repro/kernels/snn_query.py:{line}",
                    "launches": sum(by_path.values()),
                    "launches_by_path": by_path, **rec,
                    "graph_shape": g[key]})
    out.append({"name": "snn_filter", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/snn_filter.cu",
                "replaces": "src/repro/kernels/snn_query.py:245",
                "launches": f_launches,
                "launches_by_path": {"kernels.ops.snn_filter": f_launches},
                "max_abs_err": f_err, "ms": k_ms, "device_ms": k_dev,
                "plain_ms": p_ms, "bound_ms": f_bound, "bound_by": f_by,
                "library_ms": lib_ms, "m_pad": int(m_pad),
                "n_pad": int(n_pad)})
    return out


# --------------------------------------------------------------------------- #
# phase 3b                                                                     #
# --------------------------------------------------------------------------- #
# the serving phase on the point-query cell's rows, queries and radius: the
# mixed batch (radius requests, one join block of per-row radii, counts,
# reverse targets, kNN queries at KNN_K), the open loop's requests, the
# live stream's appends (phase 2c's: APPEND_ROWS rows, N_APPENDS of them,
# seeds 1-8), the second tenant's seed, the drill's probe steps and kills,
# and the fixed path's requests
MIX_RADIUS, MIX_JOIN, MIX_COUNT, MIX_REVERSE, MIX_KNN = 64, 64, 32, 16, 8
OPEN_LOOP_REQUESTS = 2048
SECOND_TENANT_SEED = 20
DRILL_STEPS, DRILL_KILLS = 12, (3, 8)
FIXED_REQUESTS = 256
# the live stream's rate: a share of the deadline policy's saturation rate,
# capped so that a stall of the dispatcher during a rebuild stays inside the
# server's backlog of 4 x 1,024 requests
LIVE_SHARE, LIVE_QPS = 0.25, 2000.0
# a request's SLO budget where the test needs one batch of all it submitted,
# and how long `result` waits: a slow request is a latency, not an error
ONE_BATCH_SLO_MS = 600_000.0
RESULT_S = 300.0
# a dispatcher batch's (kernel launches, host copies) on the exact path:
# fused (count, prefix and compact, one copy); a speculation overflow (the
# fused passes, then the exact-sized ones); and the exact-sized passes of a
# batch shape the plan has not run yet, with rows or with none
FUSED, OVERFLOW = (3, 1), (6, 4)
EXACT_PATH = (FUSED, OVERFLOW, (3, 3), (2, 1))


def pctl(values, p) -> float:
    """The p-th percentile, nan for no values."""
    if not len(values):
        return float("nan")
    return float(np.percentile(np.asarray(values, np.float64), p))


def same_answer(a, b) -> bool:
    """Bit for bit: ids, float64 squared distances (as bits), CSR offsets,
    counts and the truncation flag."""
    def eq(u, v):
        if u is None or v is None:
            return u is None and v is None
        u, v = np.asarray(u), np.asarray(v)
        if u.dtype.kind == "f":
            u, v = u.view(np.int64), v.view(np.int64)
        return u.shape == v.shape and bool(np.array_equal(u, v))
    return (eq(a.indices, b.indices) and eq(a.sq_dists, b.sq_dists)
            and eq(a.indptr, b.indptr) and eq(a.counts, b.counts)
            and a.truncated == b.truncated and a.error is None
            and b.error is None)


class BatchLog:
    """Wraps a server's `_run_batch` (the dispatcher thread's batch body):
    each batch's request ids and the dispatcher's own `DISPATCH_STATS`
    (kernel launches, host transfers) across it, read before and after, so
    the counters of other threads are untouched."""

    def __init__(self, server, engine):
        self.batches: list[tuple[list[int], int, int]] = []
        inner, stats = server._run_batch, engine.DISPATCH_STATS

        def run(batch):
            s0 = stats.snapshot()
            inner(batch)
            s1 = stats.snapshot()
            self.batches.append(
                ([r.id for r in batch],
                 s1["kernel_launches"] - s0["kernel_launches"],
                 s1["host_transfers"] - s0["host_transfers"]))

        server._run_batch = run
        self._server = server

    def shapes(self, start: int = 0, stop: int | None = None) -> dict:
        """{(launches, copies): batches} of batches ``start:stop``."""
        out: dict = {}
        for _, nl, nc in self.batches[start:stop]:
            out[nl, nc] = out.get((nl, nc), 0) + 1
        return out

    def close(self) -> None:
        """Give the server back its own `_run_batch`."""
        del self._server._run_batch


class Tally:
    """The serving path's kernel launches, summed over the stretches the
    phase counts: `take` adds the counts since the last reset and resets;
    `aside` runs a comparison outside them, its launches kept apart in
    ``aside_counts``."""

    def __init__(self):
        self.counts = dict.fromkeys(SNN_KERNELS, 0)
        self.aside_counts = dict.fromkeys(SNN_KERNELS, 0)

    def take(self, K) -> dict:
        now = launch_counts(K)
        for k, v in now.items():
            self.counts[k] += v
        K.reset_launch_counts()
        return now

    def aside(self, K, fn):
        """``fn()``, its launches not counted as the path's."""
        self.take(K)
        try:
            return fn()
        finally:
            for k, v in launch_counts(K).items():
                self.aside_counts[k] += v
            K.reset_launch_counts()


class FixedPathCalls:
    """Counts the calls of `TenantRuntime._respond_fixed`, the fixed-shape
    path that a batch takes with ``serve_exact`` off or after the exact
    path raised, from every runtime while it is installed."""

    def __init__(self, TenantRuntime):
        self.calls = 0
        self._cls, self._inner = TenantRuntime, TenantRuntime._respond_fixed
        inner = self._inner

        def respond_fixed(rt, batch, sel):
            self.calls += 1
            return inner(rt, batch, sel)

        TenantRuntime._respond_fixed = respond_fixed

    def close(self) -> None:
        self._cls._respond_fixed = self._inner


def submit_all(server, reqs) -> dict:
    """Submit ``reqs`` to a started server, then wait for every answer."""
    for r in reqs:
        server.submit(r)
    return {r.id: server.result(r.id, RESULT_S) for r in reqs}


def one_batch(server, reqs) -> dict:
    """Queue ``reqs`` before the dispatcher starts, so they are admitted as
    one batch (their SLO budget covers the submission), and serve them."""
    for r in reqs:
        server.submit(r)
    server.start()
    try:
        return {r.id: server.result(r.id, RESULT_S) for r in reqs}
    finally:
        server.stop()


def mixed_requests(Request, q, radius, join_radii, ids):
    """The mixed batch: radius, a join block of per-row radii, counts,
    reverse targets and kNN queries, on distinct query rows."""
    a, b = MIX_RADIUS, MIX_RADIUS + MIX_JOIN
    c, d = b + MIX_COUNT, b + MIX_COUNT + MIX_REVERSE
    slo = ONE_BATCH_SLO_MS
    reqs = [Request(query=q[i], radius=radius, id=next(ids), slo_ms=slo)
            for i in range(a)]
    reqs.append(Request(query=q[a:b], radius=join_radii, id=next(ids),
                        slo_ms=slo))
    reqs += [Request(query=q[i], radius=radius, count_only=True,
                     id=next(ids), slo_ms=slo) for i in range(b, c)]
    reqs += [Request(query=q[i], reverse=True, id=next(ids), slo_ms=slo)
             for i in range(c, d)]
    reqs += [Request(query=q[i], k=KNN_K, id=next(ids), slo_ms=slo)
             for i in range(d, d + MIX_KNN)]
    return reqs


def reverse_oracle(torch, stream, raw: np.ndarray, targets: np.ndarray,
                   rr: np.ndarray):
    """Float64 brute force of reverse neighbours over every row a streaming
    index holds, in its index space, on the card: per target the original
    ids i with ||x_i - t||^2 <= rr_i^2, and those inside the float32 band
    of that threshold, 2*d*2^-23*(hn + sum|t x|) + 2^-23*(|t|^2 + rr_i^2)
    (the server decides from a float32 half distance)."""
    base = stream.base
    mu = torch.from_numpy(base.mu).to(DEVICE)
    xc = (torch.from_numpy(raw).to(DEVICE) - mu[None, :]).double()
    xt, _ = base.prepare_queries(targets, 1.0)
    t64 = torch.from_numpy(xt.astype(np.float64)).to(DEVICE)
    hn = 0.5 * (xc * xc).sum(1)
    tsq = (t64 * t64).sum(1)
    sq = 2.0 * hn[:, None] - 2.0 * (xc @ t64.T) + tsq[None, :]
    r2 = torch.from_numpy(np.asarray(rr, np.float64) ** 2).to(DEVICE)[:, None]
    tol = (2.0 * DIM * EPS32 * (hn[:, None] + xc.abs() @ t64.abs().T)
           + EPS32 * (tsq[None, :] + r2))
    keep = (sq <= r2).T.cpu().numpy()
    band = ((sq - r2).abs() <= tol).T.cpu().numpy()
    del xc, sq, tol
    return keep, band


def ids_vs_masks(rows: list, keep, band):
    """(band pairs, pairs outside the band that differ) of answers given as
    original-id arrays, one a row, against oracle masks."""
    n_band = n_bad = 0
    for k, got in enumerate(rows):
        diff = np.setxor1d(got, np.nonzero(keep[k])[0])
        n_band += int(band[k, diff].sum())
        n_bad += int((~band[k, diff]).sum())
    return n_band, n_bad


def serving_mixed(torch, chk: Checks, K, engine, tally, server, Request,
                  index, q, radius, xs64, hn64, ids):
    """Step 1: the mixed batch on the card, fused, against the float64
    brute force and against each request served alone."""
    rng = np.random.default_rng(SEED + 10)
    join_radii = radius * rng.uniform(0.9, 1.1, MIX_JOIN)
    first_reqs = mixed_requests(Request, q, radius, join_radii, ids)
    first = one_batch(server, first_reqs)
    chk.ok(all(r.error is None for r in first.values()),
           f"first mixed batch (the plan built by it): {len(first)} "
           f"answers, no error; service "
           f"{max(r.service_ms for r in first.values()):.1f} ms")
    tally.take(K)
    agg0 = engine.DispatchStats.aggregate()
    reqs = mixed_requests(Request, q, radius, join_radii, ids)
    got = one_batch(server, reqs)
    agg1 = engine.DispatchStats.aggregate()
    launches = launch_counts(K)
    d_launch = agg1["kernel_launches"] - agg0["kernel_launches"]
    d_copy = agg1["host_transfers"] - agg0["host_transfers"]
    rounds = launches["snn_count_stacked"] - 2
    csr_ms = max(got[r.id].service_ms for r in reqs if r.kind != "snn-knn")
    all_ms = max(r.service_ms for r in got.values())
    chk.note(f"mixed batch ({len(reqs)} requests, "
             f"{MIX_RADIUS + MIX_JOIN + MIX_COUNT + MIX_REVERSE} CSR rows + "
             f"{MIX_KNN} kNN at k={KNN_K}): service {all_ms:.1f} ms, the "
             f"CSR family's last answer at {csr_ms:.1f} ms; latency p50 "
             f"{pctl([r.latency_ms for r in got.values()], 50):.1f} ms; "
             f"dispatch {d_launch} launches, {d_copy} copies; kernels "
             f"{launches}")
    chk.ok(launches["snn_compact_stacked"] == 2 and rounds >= 1
           and launches["snn_filter"] == 0 and launches["snn_count"] == 0
           and d_launch == 3 + rounds + 3 and d_copy == 1 + rounds + 1,
           f"one batch: one fused CSR execution for every CSR-family row "
           f"(3 launches, 1 copy) plus kNN's {rounds} expansion count(s) "
           f"and its fused final pass (3 launches, 1 copy)")
    chk.ok(all(same_answer(got[r.id], first[f.id])
               for r, f in zip(reqs, first_reqs)),
           "second mixed batch == the first, bit for bit")

    # each request alone, through the same runtime (a comparison: its
    # launches are not the path's)
    rt = server.runtime()

    def alone() -> int:
        n = 0
        for r in reqs:
            out = {}
            solo = Request(query=r.query, radius=r.radius, k=r.k,
                           count_only=r.count_only, reverse=r.reverse,
                           id=r.id)
            rt.run_batch([solo], lambda resp: out.__setitem__(resp.id, resp))
            n += same_answer(out[r.id], got[r.id])
        return n

    alone_ok = tally.aside(K, alone)
    chk.ok(alone_ok == len(reqs), f"each of the {len(reqs)} answers == the "
           f"same request served alone, bit for bit ({alone_ok})")

    # the float64 brute force
    a, b = MIX_RADIUS, MIX_RADIUS + MIX_JOIN
    c, d = b + MIX_COUNT, b + MIX_COUNT + MIX_REVERSE
    by_id = [got[r.id] for r in reqs]
    radius_rows = [resp.indices for resp in by_id[:a]]
    join = by_id[a]
    join_rows = [join.indices[join.indptr[t]:join.indptr[t + 1]]
                 for t in range(MIX_JOIN)]
    radii = np.concatenate([np.full(a, radius), join_radii])
    keep, band = stream_oracle(torch, server.index, server.data, q[:b], radii)
    nb, nx = ids_vs_masks(radius_rows + join_rows, keep, band)
    ckeep, cband = stream_oracle(torch, server.index, server.data, q[b:c],
                                 radius)
    counts = np.concatenate([by_id[a + 1 + i].counts for i in range(MIX_COUNT)])
    c_ok = np.abs(counts - ckeep.sum(1)) <= cband.sum(1)
    rr = server.runtime().reverse_radii
    rkeep, rband = reverse_oracle(torch, server.index, server.data, q[c:d], rr)
    rb, rx = ids_vs_masks([resp.indices for resp in
                           by_id[a + 1 + MIX_COUNT:a + 1 + MIX_COUNT
                                 + MIX_REVERSE]], rkeep, rband)
    knn_ids = np.stack([resp.indices for resp in by_id[-MIX_KNN:]])
    want, sq, tol = knn_oracle(index, xs64, hn64, q[d:d + MIX_KNN], KNN_K)
    ties, kbad = knn_agreement(index, knn_ids, want, sq, tol)
    del keep, band, ckeep, cband, rkeep, rband, sq, tol, rt
    chk.ok(nx == 0 and rx == 0 and kbad == 0 and bool(c_ok.all()),
           f"float64 brute force: radius and join rows {nb} band pairs, "
           f"{nx} outside; counts within their rows' band on "
           f"{int(c_ok.sum())} of {MIX_COUNT}; reverse {rb} band pairs, "
           f"{rx} outside; kNN {ties} ranks with another id, {kbad} past "
           f"the band")


def open_loop(server, Request, q, radius, arrivals, ids, log) -> dict:
    """Requests at ``arrivals`` (seconds from the start, honoured by the
    clock whatever the completions); the answers' latency split."""
    reqs = [Request(query=q[i % N_QUERIES], radius=radius, id=next(ids))
            for i in range(arrivals.size)]
    n_before = len(log.batches)
    t0 = time.perf_counter()
    for r, t_arr in zip(reqs, arrivals):
        lag = t0 + float(t_arr) - time.perf_counter()
        if lag > 0:
            time.sleep(lag)
        server.submit(r)
    resps = [server.result(r.id, RESULT_S) for r in reqs]
    wall = time.perf_counter() - t0
    sizes = [len(b[0]) for b in log.batches[n_before:]]
    return {"errors": sum(r.error is not None for r in resps),
            "qps": arrivals.size / wall,
            "latency_ms": [r.latency_ms for r in resps],
            "queue_delay_ms": [r.queue_delay_ms for r in resps],
            "mean_batch": float(np.mean(sizes)) if sizes else 0.0}


def serving_open_loop(chk: Checks, engine, SNNServer, IndexRegistry, Request,
                      server, cfg, q, radius, ids):
    """Step 2: 2,048 requests at t = 0 under both admission policies, then
    Poisson arrivals at half the deadline policy's saturation rate."""
    reg_w = IndexRegistry(cfg, device=DEVICE)
    reg_w.add("default", server.runtime())
    cfg_w = dataclasses.replace(cfg, serve_policy="window")
    servers = {"deadline": server,
               "window": SNNServer(registry=reg_w, cfg=cfg_w, device=DEVICE)}
    logs = {p: BatchLog(s, engine) for p, s in servers.items()}
    runs, errors = {}, 0
    rng = np.random.default_rng(SEED + 11)
    for p, s in servers.items():
        s.start()
    try:
        for p, s in servers.items():   # warm both buckets through each
            submit_all(s, [Request(query=q[i % N_QUERIES], radius=radius,
                                   id=next(ids))
                           for i in range(2 * cfg.serve_batch)])
        warm_end = {p: len(logs[p].batches) for p in servers}
        for p, s in servers.items():
            runs["saturation", p] = open_loop(
                s, Request, q, radius, np.zeros(OPEN_LOOP_REQUESTS), ids,
                logs[p])
        rate = 0.5 * runs["saturation", "deadline"]["qps"]
        arrivals = np.cumsum(rng.exponential(1.0 / rate, OPEN_LOOP_REQUESTS))
        for p, s in servers.items():
            runs["poisson", p] = open_loop(s, Request, q, radius, arrivals,
                                           ids, logs[p])
    finally:
        for p, s in servers.items():
            s.stop()
            logs[p].close()
    for (load, p), m in runs.items():
        errors += m["errors"]
        chk.note(f"{load} {p}: {m['qps']:.0f} qps completed, latency p50 "
                 f"{pctl(m['latency_ms'], 50):.2f} p99 "
                 f"{pctl(m['latency_ms'], 99):.2f} ms, queue delay p50 "
                 f"{pctl(m['queue_delay_ms'], 50):.2f} p99 "
                 f"{pctl(m['queue_delay_ms'], 99):.2f} ms, mean batch "
                 f"{m['mean_batch']:.1f}")
    chk.ok(errors == 0, f"open loop: {4 * OPEN_LOOP_REQUESTS} requests at "
           f"saturation and at {rate:.0f} qps (half the deadline policy's "
           f"saturation), no error response")
    shapes = {p: (logs[p].shapes(0, warm_end[p]), logs[p].shapes(warm_end[p]))
              for p in servers}
    chk.ok(all(set(w) <= set(EXACT_PATH) and set(m) <= {FUSED, OVERFLOW}
               for w, m in shapes.values()),
           "open loop: every dispatcher batch on the exact path, fused or a "
           "speculation overflow once both buckets ran; {(launches, "
           "copies): batches} " + "; ".join(
               f"{p} warm-up {w}, measured {m}"
               for p, (w, m) in shapes.items()))
    return runs


def serving_live(torch, chk: Checks, K, engine, streaming, tally,
                 TenantRuntime, Request, server, cfg, q, radius, rate, ids):
    """Step 3: a steady stream while a mutator thread appends 8 batches of
    8,192 rows and rebuilds; the latency of the requests submitted before,
    during the appends, during the rebuild and after.  Returns each
    window's p99."""
    import threading

    log = BatchLog(server, engine)
    stop_stream, sent_all = threading.Event(), threading.Event()
    mut_done = threading.Event()
    sent: list = []          # (id, submit time)
    answers: dict = {}
    mutator: dict = {}
    rng = np.random.default_rng(SEED + 12)
    gaps = rng.exponential(1.0 / rate, 1 << 20)
    index = server.index
    warm0 = (index.warm_runs, index.warm_failures)
    # each warm: (its thread, its buckets, its launches and copies)
    warms: list = []
    warm_plan = engine.warm_plan

    def warm(pack, *, m_pads=(128,), **kw):
        s0 = engine.DISPATCH_STATS.snapshot()
        try:
            return warm_plan(pack, m_pads=m_pads, **kw)
        finally:
            s1 = engine.DISPATCH_STATS.snapshot()
            warms.append((threading.get_ident(),
                          len({int(b) for b in m_pads if int(b) > 0}),
                          s1["kernel_launches"] - s0["kernel_launches"],
                          s1["host_transfers"] - s0["host_transfers"]))

    def client():
        t0, i = time.perf_counter(), 0
        t_next = t0
        while not stop_stream.is_set():
            t_next += gaps[i % gaps.size]
            lag = t_next - time.perf_counter()
            if lag > 0:
                time.sleep(lag)
            r = Request(query=q[i % N_QUERIES], radius=radius, id=next(ids))
            sent.append((r.id, time.perf_counter()))
            server.submit(r)
            i += 1

    def consumer():
        k = 0
        while not (sent_all.is_set() and k >= len(sent)):
            if k >= len(sent):
                time.sleep(1e-4)
                continue
            rid, _ = sent[k]
            resp = server.result(rid, RESULT_S)
            answers[rid] = (resp.generation, resp.latency_ms, resp.error)
            k += 1

    def mutate():
        mutator["thread"] = threading.get_ident()
        s0 = engine.DISPATCH_STATS.snapshot()
        mutator["appends"] = (time.perf_counter(),)
        for gen in range(1, N_APPENDS + 1):
            server.append(sift_standin(APPEND_ROWS, DIM, SEED + gen))
        mutator["appends"] += (time.perf_counter(),)
        server.rebuild()
        mutator["rebuild"] = (mutator["appends"][1], time.perf_counter())
        s1 = engine.DISPATCH_STATS.snapshot()
        mutator.update({k: s1[k] - s0[k] for k in ("kernel_launches",
                                                    "host_transfers")})
        mut_done.set()

    agg0 = engine.DispatchStats.aggregate()
    engine.warm_plan = warm
    server.start()
    threads = [threading.Thread(target=client),
               threading.Thread(target=consumer)]
    try:
        for th in threads:
            th.start()
        time.sleep(1.0)                      # the steady window
        t_mut0 = time.perf_counter()
        mt = threading.Thread(target=mutate)
        mt.start()
        mt.join(RESULT_S)
        t_mut1 = time.perf_counter()
        time.sleep(0.3)                      # the stream after the last publish
    finally:
        stop_stream.set()
        threads[0].join(RESULT_S)        # the client's last submission
        sent_all.set()
        threads[1].join(RESULT_S)
        server.stop()
        engine.warm_plan = warm_plan
    agg1 = engine.DispatchStats.aggregate()
    log.close()
    chk.ok(mut_done.is_set() and not any(th.is_alive() for th in threads)
           and len(answers) == len(sent),
           f"live stream: {len(sent)} requests answered while the mutator "
           f"appended {N_APPENDS} x {APPEND_ROWS} rows in "
           f"{np.diff(mutator.get('appends', (0, 0)))[0]:.2f} s and "
           f"rebuilt {index.n} rows in "
           f"{np.diff(mutator.get('rebuild', (0, 0)))[0]:.2f} s")
    errs = sum(a[2] is not None for a in answers.values())
    gens = [answers[rid][0] for rid, _ in sent if rid in answers]
    chk.ok(errs == 0 and all(g1 >= g0 for g0, g1 in zip(gens, gens[1:])),
           f"no error response; generations non-decreasing in submission "
           f"order ({gens[0]} to {gens[-1]})")
    windows = {"steady": (0.0, t_mut0),
               "appends": mutator.get("appends", (0.0, 0.0)),
               "rebuild": mutator.get("rebuild", (0.0, 0.0)),
               "during": (t_mut0, t_mut1),
               "after": (t_mut1, float("inf"))}
    lat = {w: [answers[rid][1] for rid, t in sent
               if lo <= t < hi and rid in answers]
           for w, (lo, hi) in windows.items()}
    chk.note(f"live stream at {rate:.0f} qps, latency by submission "
             "window: " + "; ".join(
                 f"{w} p50 {pctl(v, 50):.2f} p99 {pctl(v, 99):.2f} max "
                 f"{max(v):.2f} ms ({len(v)} requests)"
                 for w, v in lat.items() if v))
    warm = (index.warm_runs - warm0[0], index.warm_failures - warm0[1])
    serving_l = sum(b[1] for b in log.batches)
    serving_c = sum(b[2] for b in log.batches)
    chk.ok(warm[1] == 0 and warm[0] == N_APPENDS + 1,
           f"plan warming: {warm[0]} warms on the mutator, {warm[1]} failed")
    # a warm runs one zero-match dispatch a bucket: fused (3 launches) or
    # exact-sized with no rows (2 launches), one copy either way
    chk.ok(len(warms) == warm[0]
           and all(w[0] == mutator.get("thread") and w[3] == w[1]
                   and 2 * w[1] <= w[2] <= 3 * w[1] for w in warms)
           and sum(w[2] for w in warms) == mutator.get("kernel_launches")
           and sum(w[3] for w in warms) == mutator.get("host_transfers"),
           f"every warm on the mutator's thread, one dispatch a bucket "
           f"({sum(w[1] for w in warms)} buckets over {len(warms)} warms); "
           f"they are all the mutator's launches "
           f"({sum(w[2] for w in warms)} of "
           f"{mutator.get('kernel_launches')}) and copies "
           f"({sum(w[3] for w in warms)} of "
           f"{mutator.get('host_transfers')})")
    chk.ok(set(log.shapes()) <= {FUSED, OVERFLOW}
           and agg1["kernel_launches"] - agg0["kernel_launches"]
           == serving_l + mutator.get("kernel_launches", -1)
           and agg1["host_transfers"] - agg0["host_transfers"]
           == serving_c + mutator.get("host_transfers", -1),
           f"the dispatcher's own counters: {len(log.batches)} batches, "
           f"each fused or a speculation overflow, {{(launches, copies): "
           f"batches}} {log.shapes()}, no warm launch; "
           f"DispatchStats.aggregate() holds them and the mutator's "
           f"{mutator.get('kernel_launches')} launches")
    gen_of = {rid: answers[rid][0] for rid, _ in sent if rid in answers}
    first_of: dict = {}
    for bids, nl, nc in log.batches:
        g = gen_of.get(bids[0])
        if g is not None and g not in first_of:
            first_of[g] = (nl, nc)
    later = {g: v for g, v in first_of.items() if g > min(first_of)}
    chk.ok(len(later) >= 1 and all(v == (3, 1) for v in later.values()),
           f"the first batch of each new generation fused (3 launches, 1 "
           f"copy): {sum(v == (3, 1) for v in later.values())} of "
           f"{len(later)} generations served")

    # the mutated tenant against a copy of its state
    leaves, extra = index.state_leaves()
    copy = streaming.StreamingSNNIndex.from_state(leaves, extra,
                                                  device=DEVICE)
    del leaves
    twin = TenantRuntime(copy, dataclasses.replace(cfg,
                                                   serve_warm_plans=False))
    batch = [Request(query=q[i], radius=radius, id=next(ids))
             for i in range(MIX_RADIUS)]
    server.start()
    try:
        got = submit_all(server, batch)
    finally:
        server.stop()
    want: dict = {}
    tally.aside(K, lambda: twin.run_batch(
        [Request(query=r.query, radius=r.radius, id=r.id) for r in batch],
        lambda resp: want.__setitem__(resp.id, resp)))
    chk.ok(all(same_answer(got[r.id], want[r.id]) for r in batch)
           and got[batch[0].id].generation == index.generation,
           f"after the mutations (generation {index.generation}, "
           f"{len(index.parts)} part): a batch == a from_state copy of "
           f"state_leaves(), bit for bit")
    del twin, copy
    torch.cuda.empty_cache()
    return {w: pctl(v, 99) for w, v in lat.items()}


def serving_tenants(torch, chk: Checks, engine, SNNServer, IndexRegistry,
                    TenantRuntime, Request, server, cfg, q, radius, ids):
    """Step 4: a second tenant of as many rows; a budget just above one
    tenant's plan makes serving the two in turn evict the other's plan."""
    rt_a = server.runtime()
    x2 = sift_standin(N_ROWS, DIM, SEED + SECOND_TENANT_SEED)
    t = time.perf_counter()
    rt_b = TenantRuntime(x2, cfg, name="second", device=DEVICE)
    torch.cuda.synchronize()
    chk.note(f"second tenant: {N_ROWS} rows indexed in "
             f"{time.perf_counter() - t:.2f} s")
    del x2
    rt_a.index.drop_plan()        # both tenants' plans hold one batch shape
    for rt in (rt_a, rt_b):
        rt.run_batch([Request(query=q[i], radius=radius, id=next(ids))
                      for i in range(MIX_RADIUS)], lambda resp: None)
    one = max(rt_a.index.plan_bytes(), rt_b.index.plan_bytes())
    cfg_t = dataclasses.replace(cfg, registry_memory_mb=(one + 2**20) / 2**20)
    reg = IndexRegistry(cfg_t, device=DEVICE)
    reg.add("default", rt_a)
    reg.add("second", rt_b)
    del rt_a, rt_b
    srv = SNNServer(registry=reg, cfg=cfg_t, device=DEVICE)
    chk.note(f"plan_bytes a tenant {one} ({one / 2**30:.2f} GiB, the "
             f"MemoryPlan ledger's worst case); budget "
             f"{reg.budget_bytes} bytes")
    answers, kept = {}, True
    log = BatchLog(srv, engine)
    srv.start()
    try:
        for rnd, name in enumerate(("default", "second") * 2):
            reqs = [Request(query=q[i], radius=radius, id=next(ids),
                            tenant=name) for i in range(MIX_RADIUS)]
            got = submit_all(srv, reqs)
            other = "second" if name == "default" else "default"
            kept &= reg.plan_bytes(name) > 0 and reg.plan_bytes(other) == 0
            answers.setdefault(name, []).append([got[r.id] for r in reqs])
    finally:
        srv.stop()
        log.close()
    same = all(same_answer(a, b) for name in answers
               for a, b in zip(*answers[name]))
    chk.ok(kept and reg._evictions == 4 and same
           and set(log.shapes()) <= set(EXACT_PATH),
           f"two tenants served in turn: {reg._evictions} evictions, the "
           f"tenant being served never dropped, the other's plan dropped; "
           f"answers after re-admission == before eviction, bit for bit; "
           f"every batch on the exact path, {{(launches, copies): "
           f"batches}} {log.shapes()}")
    reg.drop("second")
    del srv, reg, answers
    torch.cuda.empty_cache()


def serving_drill(torch, chk: Checks, K, tally, FailureInjector,
                  ReplicaDrill, Request, server, q, radius, ids):
    """Step 5: checkpoint the mutated tenant, kill and restore the replica
    mid-probe, then fall back past a corrupt newest checkpoint."""
    import shutil
    import tempfile

    reg = server.registry
    ckpt = tempfile.mkdtemp(prefix=".serving_ckpt_", dir=ROOT)
    try:
        torch.cuda.synchronize()
        t = time.perf_counter()
        step = reg.save("default", ckpt)
        save_s = time.perf_counter() - t
        nbytes = sum(p.stat().st_size for p in Path(ckpt).rglob("*")
                     if p.is_file())
        chk.note(f"checkpoint of {server.index.n} rows at generation "
                 f"{step}: {nbytes} bytes in {save_s:.2f} s")
        probes = [[Request(query=q[s * 8 + i], radius=radius, id=0)
                   for i in range(8)] for s in range(DRILL_STEPS)]
        restore_s = []

        def serve(s):
            out = []
            reg.get("default").run_batch(
                [Request(query=r.query, radius=r.radius, id=next(ids))
                 for r in probes[s]], out.append)
            return out

        def restore():
            t = time.perf_counter()
            reg.restore("default", ckpt, device=DEVICE)
            torch.cuda.synchronize()
            restore_s.append(time.perf_counter() - t)

        # the uninterrupted run, to compare with (not the path's count)
        want = tally.aside(K, lambda: [serve(s) for s in range(DRILL_STEPS)])
        drill = ReplicaDrill(serve_fn=serve, restore_fn=restore,
                             total_steps=DRILL_STEPS)
        got, killed = drill.run(FailureInjector(
            {s: "replica killed" for s in DRILL_KILLS}))
        same = all(same_answer(a, b) for ws, gs in zip(want, got)
                   for a, b in zip(ws, gs))
        chk.ok(killed == list(DRILL_KILLS) and same
               and reg.get("default").index.generation == step,
               f"ReplicaDrill: killed at steps {killed}, restored in "
               + ", ".join(f"{s:.2f}" for s in restore_s)
               + f" s; {DRILL_STEPS} probe answers == the uninterrupted "
               "run's, bit for bit")
        # a newer checkpoint, corrupted: restore falls back to the previous
        idx = reg.get("default").index
        n_before = idx.n
        idx.append(sift_standin(APPEND_ROWS, DIM, SEED + N_APPENDS + 1))
        newer = reg.save("default", ckpt)
        shard = Path(ckpt) / f"step_{newer:09d}" / "shard_00000.npz"
        with open(shard, "r+b") as f:
            f.seek(4096)
            f.write(b"\x00" * 64)
        del idx
        reg.restore("default", ckpt, device=DEVICE)
        back = reg.get("default").index
        again = serve(0)
        chk.ok(newer > step and back.generation == step
               and back.n == n_before
               and all(same_answer(a, b) for a, b in zip(again, want[0])),
               f"the newest checkpoint (step {newer}) corrupted: restore "
               f"fell back to step {step}, {back.n} rows, answers as before")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.empty_cache()


def serving_other_paths(torch, chk: Checks, K, tally, fixed_path, SNNServer,
                        IndexRegistry, TenantRuntime, Request, server, cfg,
                        q, radius, ids):
    """Step 6: the fixed-shape path (the filter) and the looped executor
    on the default tenant's index."""
    index = server.index
    out = {}
    for name, over in (("fixed", dict(serve_exact=False)),
                       ("looped", dict(serve_packed=False))):
        c = dataclasses.replace(cfg, serve_warm_plans=False, **over)
        reg = IndexRegistry(c, device=DEVICE)
        reg.add("default", TenantRuntime(index, c))
        out[name] = SNNServer(registry=reg, cfg=c, device=DEVICE)
    fixed = [Request(query=q[i % N_QUERIES], radius=radius, id=next(ids))
             for i in range(FIXED_REQUESTS)]
    tally.take(K)
    calls0 = fixed_path.calls
    out["fixed"].start()
    try:
        got = submit_all(out["fixed"], fixed)
    finally:
        out["fixed"].stop()
    fl = tally.take(K)
    fixed_calls = fixed_path.calls - calls0
    # the exact rows and the float64 band, to hold the answers against
    qf = np.stack([r.query for r in fixed])
    csr = tally.aside(K, lambda: index.query_radius_csr(qf, radius,
                                                        native=False))
    _, band = stream_oracle(torch, index, index.raw, qf, radius)
    inv = np.empty_like(index.base.order)
    inv[index.base.order] = np.arange(index.base.order.size)
    counts = np.diff(csr.indptr)
    near = explained = 0
    for j, r in enumerate(fixed):
        s, e = csr.indptr[j], csr.indptr[j + 1]
        cid = csr.indices[s:e]
        want = cid[np.lexsort((inv[cid], csr.distances[s:e]))][:FIXED_K]
        resp = got[r.id]
        if (np.array_equal(resp.indices, want)
                and resp.truncated == (counts[j] > FIXED_K)):
            near += 1
        else:
            # the fixed path rounds its threshold in float32, the exact path
            # from float64: a row may differ by pairs inside the band
            diff = np.setxor1d(resp.indices, want)
            explained += int(bool(band[j, diff].all())
                             and abs(int(counts[j]) - FIXED_K)
                             <= int(band[j].sum()))
    del band
    chk.ok(len(index.parts) == 1 and fl["snn_filter"] >= 1
           and fl["snn_count_stacked"] == 0 and fl["snn_count"] == 0
           and fixed_calls >= 1
           and all(got[r.id].error is None for r in fixed)
           and near + explained == FIXED_REQUESTS,
           f"serve_exact=False: {FIXED_REQUESTS} requests through the filter "
           f"({fixed_calls} fixed-path batches, {fl['snn_filter']} "
           f"launches, no count launch); {near} answers "
           f"== the {FIXED_K} nearest of the exact row with truncated == "
           f"count > {FIXED_K} ({int(np.sum(counts > FIXED_K))} cut), "
           f"{explained} off by pairs inside the float32 band")
    rng = np.random.default_rng(SEED + 13)
    family = [r for r in mixed_requests(
        Request, q, radius, radius * rng.uniform(0.9, 1.1, MIX_JOIN), ids)
        if r.kind in ("snn-radius", "snn-join", "snn-count")]
    def batch():
        return [Request(query=r.query, radius=r.radius,
                        count_only=r.count_only, id=r.id,
                        slo_ms=ONE_BATCH_SLO_MS) for r in family]

    calls0 = fixed_path.calls
    results = {"looped": one_batch(out["looped"], batch())}
    ll = tally.take(K)
    # the packed executor's answers, to compare with
    results["packed"] = tally.aside(K, lambda: one_batch(server, batch()))
    chk.ok(ll["snn_count"] > 0 and ll["snn_compact"] > 0
           and ll["snn_count_stacked"] == ll["snn_compact_stacked"] == 0
           and fixed_path.calls == calls0
           and all(same_answer(results["looped"][r.id],
                               results["packed"][r.id]) for r in family),
           f"serve_packed=False: {len(family)} radius, join and count "
           f"requests through the looped executor ({ll['snn_count']} "
           f"single-segment counts, {ll['snn_compact']} compacts, no "
           f"fixed-path batch) == the packed executor's, bit for bit")
    del out, results


def phase_serving(torch, chk: Checks, K, engine, index, x, q, radius, xs64,
                  hn64, clock):
    """Phase 3b: the SNN server on the point-query cell.  Returns the
    kernels' launches on the serving path, {kernel: launches}."""
    import itertools

    from repro_torch.configs.snn_default import SNNConfig
    from repro_torch.ft.elastic import FailureInjector, ReplicaDrill
    from repro_torch.serving import (IndexRegistry, Request, SNNServer,
                                     TenantRuntime)

    streaming = importlib.import_module("repro_torch.core.streaming")
    print(f"phase 3b: the SNN server, n={N_ROWS} d={DIM}, radius {radius!r}")
    ids = itertools.count()
    cfg = SNNConfig()
    tally = Tally()
    fixed_path = FixedPathCalls(TenantRuntime)
    K.reset_launch_counts()
    try:
        server = clock(f"SNNServer over {N_ROWS} rows",
                       lambda: SNNServer(x, cfg, device=DEVICE))
        chk.ok(server.index.base.xs.device.type == torch.device(DEVICE).type,
               f"server index on {server.device}")
        server.set_reverse_radii(radius * np.random.default_rng(
            SEED + 9).uniform(0.9, 1.1, N_ROWS))
        t = time.perf_counter()
        serving_mixed(torch, chk, K, engine, tally, server, Request, index,
                      q, radius, xs64, hn64, ids)
        chk.note(f"step 1 (mixed batch) took {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        runs = serving_open_loop(chk, engine, SNNServer, IndexRegistry,
                                 Request, server, cfg, q, radius, ids)
        chk.note(f"step 2 (open loop) took {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        rate = min(LIVE_SHARE * runs["saturation", "deadline"]["qps"],
                   LIVE_QPS)
        live = serving_live(torch, chk, K, engine, streaming, tally,
                            TenantRuntime, Request, server, cfg, q, radius,
                            rate, ids)
        chk.note(f"step 3 (live mutation) took "
                 f"{time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        serving_tenants(torch, chk, engine, SNNServer, IndexRegistry,
                        TenantRuntime, Request, server, cfg, q, radius, ids)
        chk.note(f"step 4 (two tenants) took {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        serving_drill(torch, chk, K, tally, FailureInjector, ReplicaDrill,
                      Request, server, q, radius, ids)
        chk.note(f"step 5 (checkpoint drill) took "
                 f"{time.perf_counter() - t:.1f} s")
        tally.take(K)
        off = {k: tally.counts[k] + tally.aside_counts[k]
               for k in ("snn_filter", "snn_count", "snn_compact")}
        chk.ok(fixed_path.calls == 0 and not any(off.values()),
               f"steps 1-5 on the exact path only: {fixed_path.calls} "
               f"batches on the fixed path, launches {off}")
        t = time.perf_counter()
        serving_other_paths(torch, chk, K, tally, fixed_path, SNNServer,
                            IndexRegistry, TenantRuntime, Request, server,
                            cfg, q, radius, ids)
        chk.note(f"step 6 (fixed and looped) took "
                 f"{time.perf_counter() - t:.1f} s")
    finally:
        fixed_path.close()
    chk.note("live stream p99: " + ", ".join(f"{w} {v:.2f} ms"
                                             for w, v in live.items())
             + f"; launches on the path "
             f"{ {k: v for k, v in tally.counts.items() if v} }")
    del server
    torch.cuda.empty_cache()
    return {k: v for k, v in tally.counts.items() if v}


# --------------------------------------------------------------------------- #
# phase 4                                                                      #
# --------------------------------------------------------------------------- #
# embedding_bag launches per forward of each model's serve step
LOOKUPS = {"dlrm-mlperf": 1, "wide-deep": 2, "mind": 1}
N_SAMPLE = 512
# outputs against float64: float32 GEMMs summed in another order stay near
# 2^-20 of an output's scale at these depths (up to 8 layers, K <= 1293);
# TF32 products (inputs rounded to 2^-11) land near 2^-10 and bfloat16 near
# 2^-7, so 2^-14 of the scale refuses both and passes float32
REL_TOL = 2.0 ** -14


def path_bags(rs, arch: str, model, batch):
    """(name, ids, table) of every lookup a serve step of ``arch`` makes,
    with the ids the model hands the kernel."""
    if arch == "dlrm-mlperf":
        return [("lookup", rs.lookup_ids(batch["sparse"], model.offsets),
                 model.table)]
    if arch == "wide-deep":
        return [("deep lookup", rs.lookup_ids(batch["sparse"], model.offsets),
                 model.emb),
                ("wide bag", batch["sparse"] + model.offsets[None, :],
                 model.wide)]
    return [("history gather", batch["hist"].reshape(-1, 1), model.items)]


# the earlier design's time of each bulk lookup's kernel, before the bag
# kernels were redesigned (one thread a 16-byte column chunk of a bag):
# PERF.md section 6, row 11 at commit b2e471f, this script's phase 4 on an
# NVIDIA H100 80GB HBM3 at 700.00 W.  Shown beside this run's times, not
# measured here.  (path, lookup) -> ms
EARLIER_BAG_MS = {
    ("dlrm-mlperf:serve_bulk:serve", "lookup"): 0.854,
    ("dlrm-mlperf:serve_bulk:serve full-vocabulary", "lookup"): 1.146,
    ("wide-deep:serve_bulk:serve", "deep lookup"): 0.977,
    ("wide-deep:serve_bulk:serve", "wide bag"): 0.132,
    ("mind:serve_bulk:serve", "history gather"): 2.282,
}
# the kernels of the embedding_bag op, by name in the build's ptxas report
# and in a profiler trace
BAG_KERNELS = ("embedding_bag_kernel", "bag_of_one_kernel",
               "bag_range_histogram_kernel", "bag_range_scatter_kernel",
               "staged_bag_kernel")
# record_function ranges of the package (`models.recsys.row_grad`), which
# the profiler also puts on the card's timeline
RANGES = ("row_grad",)
# the one kernel of those that each embedding_bag call ends with
BAG_GATHERS = ("embedding_bag_kernel", "bag_of_one_kernel",
               "staged_bag_kernel")


def bag_write_floor(torch, K, ids, table, reps: int) -> float:
    """Milliseconds of the lookup's kernel in bag order with every id -1:
    each bag reads row 0, which stays in L1 and L2, and writes its output
    row, so the call costs the ids and the output's writes alone (as the
    filter's every-tile-skipped run did).  Calls the C function directly,
    so no launch is counted."""
    (n_bags, n_slots), (v, d) = ids.shape, table.shape
    pad = torch.full_like(ids, -1)
    out = torch.empty((n_bags, d), dtype=table.dtype, device=table.device)
    lib = K._library()

    def call():
        rc = lib.embedding_bag(
            pad.data_ptr(), None, table.data_ptr(), out.data_ptr(), n_bags,
            n_slots, d, v, K._BAG_DTYPES[table.dtype],
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"embedding_bag: CUDA error {rc}")

    return timed(torch, call, reps)


def range_list_check(torch, chk: Checks, K, ref, ids, table, path: dict,
                     tag: str) -> None:
    """The blocked order's list against a plain torch.sort of the bags'
    range keys: a permutation of the bags, each with its own id, grouped by
    range in range order, and the histogram's counts."""
    v = table.shape[0]
    rows, n_ranges = path["rows_per_range"], path["n_ranges"]
    pairs, counts = K.bag_range_list(ids, v, rows, n_ranges)
    keys = ref.bag_range_keys(ids[:, 0], v, rows)
    sorted_keys = torch.sort(keys).values
    bags = pairs[:, 0].long()
    perm = torch.equal(torch.sort(bags).values,
                       torch.arange(ids.shape[0], device=ids.device))
    own = torch.equal(pairs[:, 1], ids[bags, 0]) if perm else False
    grouped = torch.equal(keys[bags], sorted_keys) if perm else False
    hist = torch.equal(counts.long(), torch.bincount(keys,
                                                     minlength=n_ranges))
    chk.ok(perm and own and grouped and hist,
           f"{tag}: the blocked order's list of {ids.shape[0]} (bag, id) "
           f"pairs is a permutation of the bags with their own ids "
           f"({perm and own}), grouped by range as torch.sort of the range "
           f"keys orders them ({grouped}), counts == bincount ({hist}); "
           f"{n_ranges} ranges of {rows} rows")


def bag_stats(torch, chk: Checks, K, ref, ids, table, tag: str,
              reps: int, earlier_ms: float | None = None) -> dict:
    """embedding_bag against its plain version on one path's ids, bit for
    bit, then timed beside the earlier design's time (`EARLIER_BAG_MS`,
    shown in the note only: it was not measured here), the plain version, one
    F.embedding_bag call of the same bags (``per_sample_weights`` = the
    padding mask), the write floor (`bag_write_floor`) and its bound: the
    distinct rows the bags need and the output rows, each moved once, and
    the ids, over the card's memory rate.  For the blocked order, also the
    range list (`range_list_check`)."""
    import torch.nn.functional as F

    n_bags, n_slots = ids.shape
    d, size = table.shape[1], table.element_size()
    bits = torch.int16 if size == 2 else torch.int32
    path = K.bag_path(ids, table)
    k = K.embedding_bag(ids, table)
    p = ref.embedding_bag_ref(ids, table)
    torch.cuda.synchronize()
    same = torch.equal(k.view(bits), p.view(bits))
    err = float((k.float() - p.float()).abs().max())
    del p
    valid = ids >= 0
    safe, weights = ids.clamp_min(0), valid.to(table.dtype)
    lib = F.embedding_bag(safe, table, mode="sum", per_sample_weights=weights)
    lib_diff = float((lib.float() - k.float()).abs().max())
    del k, lib
    distinct = int(torch.unique(ids[valid]).numel())
    nbytes = (distinct + n_bags) * d * size + 4 * ids.numel()
    bound = 1e3 * nbytes / HBM_RATE
    order = (f"{path['path']}, {path['order']} order" if path["path"] ==
             "bag of one" else f"{path['path']} path")
    chk.ok(same, f"{tag}: embedding_bag == plain bit for bit ({n_bags} bags "
           f"of {n_slots} over ({table.shape[0]}, {d}) "
           f"{str(table.dtype)[6:]}, {distinct} distinct rows; {order})")
    if path["order"] == "blocked":
        range_list_check(torch, chk, K, ref, ids, table, path, tag)
    ms = timed(torch, lambda: K.embedding_bag(ids, table), reps)
    floor = bag_write_floor(torch, K, ids, table, reps)
    plain_ms = timed(torch, lambda: ref.embedding_bag_ref(ids, table), 3)
    lib_ms = timed(torch, lambda: F.embedding_bag(
        safe, table, mode="sum", per_sample_weights=weights), reps)
    was = (" (earlier design: not recorded at this shape)"
           if earlier_ms is None else
           f" (earlier design, b2e471f: {earlier_ms} ms, PERF.md row 11)")
    chk.note(f"{tag}: kernel {ms:.4f} ms{was}, write floor {floor:.4f} ms "
             f"({n_bags * d * size / floor / 1e9:.3f} TB/s of output), "
             f"plain {plain_ms:.4f} ms, F.embedding_bag {lib_ms:.4f} ms (max "
             f"|diff| vs the kernel {lib_diff:.3e}, not asserted: it sums in "
             f"its own order), bound {bound:.4f} ms (bytes, "
             f"{nbytes / 1e9:.3f} GB); {order}")
    return {"shape": [int(n_bags), int(n_slots), int(d)],
            "dtype": str(table.dtype)[6:], "distinct_rows": distinct,
            "path": path["path"], "order": path["order"],
            "n_ranges": path["n_ranges"], "max_abs_err": err, "ms": ms,
            "write_floor_ms": floor, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": "bytes", "library_ms": lib_ms,
            "library_max_abs_diff": lib_diff}


def as64(torch, t, bf16: bool = False):
    """``t`` in float64 on the host; with ``bf16``, rounded to bfloat16
    first (the ranking retrieval's cast of every float32 parameter)."""
    t = t.detach()
    return (t.to(torch.bfloat16) if bf16 else t).double().cpu()


def mlp64(torch, mlp, x, bf16: bool = False):
    """An `models.layers.MLP` in float64 on the host."""
    last = len(mlp.layers) - 1
    for i, lin in enumerate(mlp.layers):
        x = x @ as64(torch, lin.weight, bf16).T + as64(torch, lin.bias, bf16)
        if i < last or mlp.final_relu:
            x = x.clamp_min(0.0)
    return x


def dlrm64(torch, model, dense, sparse, bf16: bool = False):
    gid = (sparse + model.offsets[None, :]).long()
    emb = as64(torch, model.table[gid])
    bot = mlp64(torch, model.bot, as64(torch, dense, bf16), bf16)
    z = torch.cat([bot[:, None, :], emb], dim=1)
    zz = z @ z.transpose(1, 2)
    x = torch.cat([bot, zz[:, model.iu.cpu(), model.ju.cpu()]], dim=1)
    return mlp64(torch, model.top, x, bf16)[:, 0]


def widedeep64(torch, model, dense, sparse, bf16: bool = False):
    """(deep, wide, sum of |terms| of the wide term) in float64."""
    gid = (sparse + model.offsets[None, :]).long()
    d64 = as64(torch, dense, bf16)
    emb = as64(torch, model.emb[gid], bf16).reshape(gid.shape[0], -1)
    deep = mlp64(torch, model.deep, torch.cat([d64, emb], dim=1), bf16)[:, 0]
    terms = torch.cat([as64(torch, model.wide[gid][..., 0], bf16),
                       d64 * as64(torch, model.wide_dense[:, 0], bf16)[None]],
                      1)
    return deep, terms.sum(1), terms.abs().sum(1)


def mind64(torch, model, hist):
    cfg = model.cfg
    mask = (hist >= 0).cpu()[..., None]
    e = model.items[hist.clamp_min(0).long()].double().cpu() * mask
    eh = e @ model.bilinear.double().cpu()
    b_logit = torch.zeros(tuple(hist.shape) + (cfg.n_interests,),
                          dtype=torch.float64)
    u = None
    for _ in range(cfg.capsule_iters):
        c = torch.where(mask, torch.softmax(b_logit, dim=-1), 0.0)
        z = torch.einsum("bsk,bsd->bkd", c, eh)
        n2 = (z * z).sum(-1, keepdim=True)
        u = (n2 / (1.0 + n2)) * z / torch.sqrt(n2 + 1e-9)
        b_logit = b_logit + torch.einsum("bkd,bsd->bsk", u, eh)
    return u


def sample_check(torch, chk: Checks, arch: str, model, batch, out, tag):
    """``N_SAMPLE`` rows of a serve step's output against a float64 forward
    from the same parameters on the host, within ``REL_TOL`` of the
    output's scale; then the same sample with TF32 products, which must
    fail that tolerance (for Wide & Deep, the deep tower's)."""
    b = out.shape[0]
    rows = (np.arange(b) if b <= N_SAMPLE else np.sort(
        np.random.default_rng(SEED + 20).choice(b, N_SAMPLE, replace=False)))
    rows_d = torch.from_numpy(rows).to(out.device)
    sub = {k: v[rows_d] for k, v in batch.items()}
    got = out[rows_d].double().cpu()
    with torch.inference_mode():
        if arch == "dlrm-mlperf":
            want = dlrm64(torch, model, sub["dense"], sub["sparse"])
            tol = REL_TOL * float(want.abs().max())
            err = float((got - want).abs().max())
            chk.ok(err <= tol, f"{tag}: {rows.size} logits vs float64, max "
                   f"|diff| {err:.3e} <= 2^-14 x their scale ({tol:.3e})")
            control, c_want, c_tol = (
                lambda: model(sub["dense"], sub["sparse"]), want, tol)
        elif arch == "wide-deep":
            deep, wide, wabs = widedeep64(torch, model, sub["dense"],
                                          sub["sparse"])
            d_tol = REL_TOL * float(deep.abs().max())
            n_terms = sub["sparse"].shape[1] + sub["dense"].shape[1] + 2
            tol = d_tol + n_terms * 2.0 ** -24 * (wabs + deep.abs()
                                                  + wide.abs())
            err = (got - (deep + wide)).abs()
            chk.ok(bool((err <= tol).all()),
                   f"{tag}: {rows.size} logits vs float64, max |diff| "
                   f"{float(err.max()):.3e}, each within 2^-14 x the deep "
                   f"tower's scale + the wide sum's recursive-summation "
                   f"bound {n_terms} * 2^-24 * sum|terms| (largest "
                   f"{float(tol.max()):.3e})")
            dk = model.deep_logit(sub["dense"], sub["sparse"]).double().cpu()
            d_err = float((dk - deep).abs().max())
            chk.ok(d_err <= d_tol, f"{tag}: the deep tower alone on the "
                   f"sample vs float64, max |diff| {d_err:.3e} <= 2^-14 x "
                   f"its scale ({d_tol:.3e})")
            control, c_want, c_tol = (
                lambda: model.deep_logit(sub["dense"], sub["sparse"]), deep,
                d_tol)
        else:
            want = mind64(torch, model, sub["hist"])
            tol = REL_TOL * float(want.abs().max())
            err = float((got - want).abs().max())
            chk.ok(err <= tol, f"{tag}: {rows.size} users' capsules vs "
                   f"float64, max |diff| {err:.3e} <= 2^-14 x their scale "
                   f"({tol:.3e})")
            control, c_want, c_tol = lambda: model(sub["hist"]), want, tol
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            c = control().double().cpu()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
    c_err = float((c - c_want).abs().max())
    chk.ok(c_err > c_tol, f"{tag}: TF32 control, the same sample with TF32 "
           f"products, fails the tolerance: max |diff| {c_err:.3e}, "
           f"{c_err / c_tol:.2f} x the tolerance")


def serve_path(torch, chk: Checks, K, ref, rs, arch, sd, model, batch,
               tag: str, reps: int, path: str):
    """One serve step through ``sd.fn`` with the launch counts read around
    it, its output checked, the batch timed, and each lookup of the path
    held against the plain version and timed.  Returns (launches, record).
    """
    K.reset_launch_counts()
    torch.cuda.synchronize()
    out = sd.fn(model, batch)
    torch.cuda.synchronize()
    launches = K.embedding_bag.launches
    chk.ok(launches == LOOKUPS[arch],
           f"{tag}: the serve step launched embedding_bag {launches} "
           f"time(s), expected {LOOKUPS[arch]}")
    n = next(iter(batch.values())).shape[0]
    cfg = model.cfg
    shape = ((n,) if arch != "mind"
             else (n, cfg.n_interests, cfg.embed_dim))
    chk.ok(tuple(out.shape) == shape and bool(torch.isfinite(out).all()),
           f"{tag}: output {tuple(out.shape)}, all finite")
    sample_check(torch, chk, arch, model, batch, out, tag)
    del out
    ms = timed(torch, lambda: sd.fn(model, batch), reps)
    chk.note(f"{tag}: {ms:.4f} ms a batch (CUDA events, warm), "
             f"{n / ms * 1e3:.4e} samples/s, model FLOPs "
             f"{sd.model_flops / ms / 1e9:.3f} TFLOP/s")
    bags = {name: bag_stats(torch, chk, K, ref, ids, table,
                            f"{tag} {name}", 2 * reps,
                            EARLIER_BAG_MS.get((path, name)))
            for name, ids, table in path_bags(rs, arch, model, batch)}
    return launches, {"batch_ms": ms, "samples_per_s": n / ms * 1e3,
                      "bags": bags}


def device_breakdown(torch, chk: Checks, K, fn, tag: str) -> dict:
    """One call of ``fn`` under torch.profiler (`traced`, after two calls
    in the same trace, its lookups' gather kernels counted against the
    wrapper's launches): wall time, the card's busy time (the sum of its
    kernels and copies), and that time split into the embedding_bag op's
    kernels (`BAG_KERNELS`), GEMMs and the rest; and the span of each
    `RANGES` range the call ran, from its first kernel to its last."""
    calls, wall = traced(torch, fn, 1, kernels=BAG_GATHERS,
                         launches=lambda: K.embedding_bag.launches)
    by_name: dict[str, float] = {}
    spans: dict[str, float] = {}
    for name, ms in calls[0]:
        # a record_function range inside the call (the row gradient's)
        # is on the card's timeline too, over its kernels: not one of them
        into = spans if name in RANGES else by_name
        into[name] = into.get(name, 0.0) + ms
    busy = sum(by_name.values())
    groups = {"embedding_bag": 0.0, "gemm": 0.0, "other": 0.0}
    for name, v in by_name.items():
        low = name.lower()
        key = ("embedding_bag" if any(k in low for k in BAG_KERNELS)
               else "gemm"
               if any(s in low for s in ("gemm", "cutlass", "xmma", "cublas"))
               else "other")
        groups[key] += v
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    within = "".join(f"; the {k} range spans {v:.3f} ms of the card's "
                     f"timeline ({100 * v / busy:.1f}% of its busy time)"
                     for k, v in spans.items())
    bag = {re.search(r"\w+_kernel(<[^>]*>)?", k).group(0): v
           for k, v in by_name.items() if any(b in k for b in BAG_KERNELS)}
    chk.note(f"{tag} (torch.profiler, one call): wall {wall:.3f} ms, card "
             f"busy {busy:.3f} ms ({100 * busy / wall:.1f}%); embedding_bag "
             f"{groups['embedding_bag']:.3f} ms ("
             + ", ".join(f"{k} {v:.3f}" for k, v in bag.items())
             + f"), GEMMs {groups['gemm']:.3f} ms, other "
             f"{groups['other']:.3f} ms; most time: "
             + "; ".join(f"{k[:60]} {v:.3f} ms" for k, v in top) + within)
    return {"wall_ms": wall, "busy_ms": busy,
            **{f"{k}_ms": v for k, v in groups.items()},
            **{f"{k}_range_ms": v for k, v in spans.items()},
            "embedding_bag_kernels_ms": bag}


def full_vocab_batch(torch, cfg, batch, seed: int) -> dict:
    """The reference batch's dense features with sparse ids drawn from each
    field's own vocabulary, so the lookups touch the whole table."""
    rng = np.random.default_rng(seed)
    n = batch["dense"].shape[0]
    sparse = np.stack([rng.integers(0, v, n) for v in cfg.vocab_sizes], 1)
    return {"dense": batch["dense"],
            "sparse": torch.from_numpy(sparse.astype(np.int32)).to(DEVICE)}


def last_rows_check(torch, chk: Checks, K, ref, table) -> None:
    """Bags of one over the table's last 1024 rows, and the first row past
    element 2^31: their offsets need 64 bits."""
    v, d = table.shape
    nbytes = table.numel() * table.element_size()
    share = nbytes / torch.cuda.get_device_properties(0).total_memory
    chk.note(f"the MLPerf stacked table ({v}, {d}) {str(table.dtype)[6:]}: "
             f"{nbytes / 1e9:.2f} GB, {share:.1%} of the card's memory")
    first = max(v - 1024, 0)
    ids = torch.arange(first, v, dtype=torch.int32, device=table.device)
    ids[0] = min(2 ** 31 // d, v - 1)
    ids = ids[:, None].contiguous()
    k = K.embedding_bag(ids, table)
    p = ref.embedding_bag_ref(ids, table)
    rows = table[ids[:, 0].long()]
    torch.cuda.synchronize()
    bits = torch.int16
    chk.ok(torch.equal(k.view(bits), p.view(bits))
           and torch.equal(k.view(bits), rows.view(bits)),
           f"embedding_bag over rows {int(ids[0])} and {first + 1}..{v - 1} "
           f"of the ({v}, {d}) table (element offsets up to "
           f"{(v - 1) * d:.3e}): == plain and == the rows, bit for bit")


def phase_recsys(torch, chk: Checks, K, ref, snn, clock):
    from repro_torch.launch import steps
    from repro_torch.models import recsys as rs

    print("phase 4: recsys serving through launch.steps.build_step at full "
          "width")
    by_path: dict[str, int] = {}
    paths: dict[str, dict] = {}
    breakdown: dict[str, dict] = {}
    for arch in ("dlrm-mlperf", "wide-deep", "mind"):
        for shape in ("serve_p99", "serve_bulk"):
            sd = steps.build_step(arch, shape)
            model, batch = clock(f"{sd.name}: init_args (parameters from a "
                                 "seeded torch.Generator on the card)",
                                 lambda: sd.init_args(DEVICE))
            if arch == "dlrm-mlperf" and shape == "serve_p99":
                last_rows_check(torch, chk, K, ref, model.table)
            reps = 20 if shape == "serve_p99" else 5
            kind = ("reference batch (ids < min(vocab))"
                    if arch == "dlrm-mlperf" else "reference batch")
            runs = [(sd.name, kind, batch)]
            if arch == "dlrm-mlperf":
                runs.append((f"{sd.name} full-vocabulary",
                             "full-vocabulary batch",
                             full_vocab_batch(torch, model.cfg, batch,
                                              SEED + 30)))
            for path, what, b in runs:
                n, rec = serve_path(torch, chk, K, ref, rs, arch, sd, model,
                                    b, f"{sd.name} {what}", reps, path)
                by_path[path], paths[path] = n, rec
            if shape == "serve_bulk":
                breakdown[sd.name] = device_breakdown(
                    torch, chk, K, lambda: sd.fn(model, b), f"{sd.name} {what}")
            del model, batch, runs, b
            torch.cuda.empty_cache()
            chk.note(f"device memory held after {sd.name}: "
                     f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB")
    ra = mind_retrieval(torch, chk, K, ref, snn, steps, rs, clock, by_path,
                        paths)
    return by_path, paths, breakdown, ra


def mind_retrieval(torch, chk: Checks, K, ref, snn, steps, rs, clock,
                   by_path, paths) -> dict:
    """MIND's retrieval_cand step (GEMM + top-100 over 1,000,000 items),
    then retrieve_above of the user's 4 capsules at a threshold halfway
    between the 100th and 101st max-over-capsules score."""
    sd = steps.build_step("mind", "retrieval_cand")
    n_cand = steps.get_arch("mind").shapes["retrieval_cand"]["n_candidates"]
    model, query = sd.init_args(DEVICE)
    K.reset_launch_counts()
    torch.cuda.synchronize()
    vals, idx = clock(f"{sd.name} (first call)", lambda: sd.fn(model, query))
    by_path[sd.name] = n = K.embedding_bag.launches
    chk.ok(n == LOOKUPS["mind"], f"{sd.name}: the step launched "
           f"embedding_bag {n} time(s), expected {LOOKUPS['mind']}")
    chk.ok(tuple(idx.shape) == (1, 100) and bool(torch.isfinite(vals).all()),
           f"{sd.name}: top-100 of {n_cand} items, finite scores")
    ms = timed(torch, lambda: sd.fn(model, query), 10)
    chk.note(f"{sd.name}: GEMM + top-100 {ms:.4f} ms (CUDA events, warm)")
    hist = query["hist"]
    paths[sd.name] = {"batch_ms": ms, "bags": {"history gather": bag_stats(
        torch, chk, K, ref, hist.reshape(-1, 1), model.items,
        f"{sd.name} history gather", 20,
        EARLIER_BAG_MS.get((sd.name, "history gather")))}}
    with torch.inference_mode():
        u = model(hist)[0]                                    # (4, 64)
        cand = model.items[:n_cand]
        top = torch.topk((u @ cand.T).amax(dim=0), 101)
    s = top.values.double().cpu().numpy()
    thr = float((s[99] + s[100]) / 2)
    top100 = np.sort(idx[0].cpu().numpy())
    chk.ok(np.array_equal(np.sort(top.indices[:100].cpu().numpy()), top100),
           f"{sd.name}: the step's top-100 == the max over the capsules' "
           "scores")
    chk.note(f"threshold {thr!r} halfway between the 100th and 101st "
             f"max-over-capsules scores (gap {s[99] - s[100]:.3e})")
    cand_np = cand.detach().cpu().numpy()
    index = clock("build_index(items, metric='mips') on the card",
                  lambda: snn.build_index(cand_np, metric="mips",
                                          device=DEVICE))
    K.reset_launch_counts()
    n_caps = u.shape[0]
    res = clock(f"retrieve_above, {n_caps} capsules",
                lambda: rs.retrieve_above(u, None, thr, index=index,
                                          device=DEVICE))
    ra = {"snn_count_stacked": K.snn_count_stacked.launches,
          "snn_compact_stacked": K.snn_compact_stacked.launches}
    rows = [res.indices[res.indptr[k]:res.indptr[k + 1]]
            for k in range(n_caps)]
    chk.note(f"retrieve_above kernel launches {ra}; {res.nnz} pairs, rows "
             f"{[r.size for r in rows]}")
    chk.ok(all(v > 0 for v in ra.values()),
           "retrieve_above ran the stacked kernels on the mips index")
    xs64 = index.xs.cpu().numpy().astype(np.float64)
    hn64 = 0.5 * np.einsum("ij,ij->i", xs64, xs64)
    u_np = u.cpu().numpy()
    dhalf64, thresh64, tol = oracle_rows(index, xs64, hn64, u_np, thr)
    # an item is undecided where a float32 rounding may put it on either
    # side of the threshold: inside the lifted index's dhalf band for some
    # capsule (the join), or within the float32 GEMM's recursive-summation
    # bound of it (the top-100); the sets must agree on every other item
    s64 = cand_np.astype(np.float64) @ u_np.astype(np.float64).T
    gemm_tol = (u_np.shape[1] * 2.0 ** -24
                * (np.abs(cand_np).astype(np.float64) @ np.abs(u_np).T.astype(
                    np.float64)) + EPS32 * abs(thr))
    undecided = np.union1d(
        index.order[np.nonzero((np.abs(dhalf64 - thresh64[None, :])
                                <= tol).any(1))[0]],
        np.nonzero((np.abs(s64 - thr) <= gemm_tol).any(1))[0])
    union = np.setdiff1d(np.unique(res.indices), undecided)
    want64 = np.setdiff1d(np.nonzero(s64.max(1) >= thr)[0], undecided)
    chk.ok(np.array_equal(union, np.setdiff1d(top100, undecided))
           and np.array_equal(union, want64),
           f"union of the {n_caps} CSR rows ({np.unique(res.indices).size} "
           f"items) == the GEMM's top-100 set == the float64 set above the "
           f"threshold, outside the {undecided.size} item(s) a float32 "
           "rounding may put on either side")
    band, equal, bad = compare_with_oracle(index, res, np.arange(n_caps),
                                           xs64, hn64, u_np, thr)
    chk.ok(bad == 0, f"the {n_caps} rows vs a float64 brute force over the "
           f"lifted index: {equal} pairs equal, {band} inside the float32 "
           f"band, {bad} outside")
    ip64 = np.concatenate([cand_np[r].astype(np.float64)
                           @ u_np[k].astype(np.float64)
                           for k, r in enumerate(rows)])
    inv = np.empty_like(index.order)
    inv[index.order] = np.arange(index.order.size)
    tol_pairs = np.concatenate([tol[inv[r], k] for k, r in enumerate(rows)])
    ip_err = np.abs(res.distances - ip64)
    chk.ok(bool(np.all(ip_err <= tol_pairs)),
           f"reported inner products vs float64: max |diff| "
           f"{ip_err.max():.3e}, each within its float32 dhalf bound "
           f"(largest {tol_pairs.max():.3e})")
    return ra


# --------------------------------------------------------------------------- #
# phase 4b                                                                     #
# --------------------------------------------------------------------------- #
# training steps of the measured run (the first one untimed) and the
# candidates of the ranking retrieval's float64 sample
TRAIN_STEPS = 5
N_RANK_SAMPLE = 256
# bfloat16's unit roundoff (8 bits of precision) and float32's
U16, U32 = 2.0 ** -8, 2.0 ** -24
# a ranking score against the float64 forward of the same bfloat16-rounded
# parameters: each bfloat16 layer rounds its product and its bias sum (half
# an ulp, at most u16 of the value, each: Wide & Deep's four deep layers,
# DLRM's bottom three before its float32 interaction and top), about 2^-6
# of the score's scale when the errors add up; twice that here
# (`ranking_sample` adds the wide term's roundings)
RANK_REL_TOL = 2.0 ** -5


def touched_rows(torch, arch: str, model, batch) -> dict:
    """{table parameter: the unique rows a training batch reads}, the only
    rows of a table that its step's row update can change."""
    def uniq(ids, n_rows):
        ids = ids.reshape(-1)
        return torch.unique(ids[ids >= 0].long().clamp_max(n_rows - 1))

    if arch == "mind":
        ids = torch.cat([batch["hist"].reshape(-1), batch["target"],
                         batch["negatives"]])
        return {"items": uniq(ids, model.items.shape[0])}
    gid = batch["sparse"] + model.offsets[None, :]
    if arch == "dlrm-mlperf":
        return {"table": uniq(gid, model.table.shape[0])}
    return {"emb": uniq(gid, model.emb.shape[0]),
            "wide": uniq(gid, model.wide.shape[0])}


def train_state(torch, model, opt_state, rows: dict) -> dict:
    """Copies of what a training step can change: every parameter (a
    table's ``rows`` alone) and every leaf of the optimizer's state."""
    from repro_torch.utils import tree_leaves

    out = {name: (p.detach()[rows[name]] if name in rows
                  else p.detach()).clone()
           for name, p in model.named_parameters()}
    out["optimizer"] = [t.clone() for t in tree_leaves(opt_state)]
    return out


def restore_state(torch, model, opt_state, rows: dict, snap: dict) -> None:
    from repro_torch.utils import tree_leaves

    with torch.no_grad():
        for name, p in model.named_parameters():
            if name in rows:
                p.index_put_((rows[name],), snap[name])
            else:
                p.copy_(snap[name])
        for t, v in zip(tree_leaves(opt_state), snap["optimizer"]):
            t.copy_(v)


def state_gap(torch, a: dict, b: dict) -> tuple[bool, float]:
    """(bit-identical, the largest difference of a leaf relative to that
    leaf's largest magnitude) between two `train_state` copies."""
    same, rel = True, 0.0
    for k in a:
        for x, y in zip(*((a[k], b[k]) if k == "optimizer"
                          else ([a[k]], [b[k]]))):
            same &= bool(torch.equal(x, y))
            if x.is_floating_point() and x.numel():
                scale = float(x.float().abs().max()) or 1.0
                rel = max(rel, float((x.float() - y.float()).abs().max())
                          / scale)
    return same, rel


def dlrm_rows_vs_float64(torch, chk: Checks, rs, model, batch, tag: str):
    """DLRM's row gradient of one batch against a float64 sum of its
    occurrences' gradients (the cotangents the lookup receives, bfloat16 as
    in JAX): the same rows, each within the final rounding to bfloat16
    (u16 of the sum) plus the float32 summation bound (k u32 sum|g| for a
    row of k occurrences).  Returns the lookup's ids and cotangents."""
    seen = {}
    real = rs.bag_lookup

    def hooked(ids, table):
        out = real(ids, table)
        out.register_hook(lambda g: seen.__setitem__("cot", g.detach()))
        seen["ids"] = ids
        return out

    with mock.patch.object(rs, "bag_lookup", hooked):
        _, grads = rs.value_and_grad(rs.dlrm_loss, model, batch)
    g = grads["emb"]["table"]
    ids, cot = seen["ids"], seen["cot"]
    uniq, inv = torch.unique(ids[:, 0].long(), return_inverse=True)
    d = cot.shape[1]
    exact = torch.zeros((uniq.numel(), d), dtype=torch.float64,
                        device=cot.device).index_add_(0, inv, cot.double())
    mag = torch.zeros_like(exact).index_add_(0, inv, cot.double().abs())
    k = torch.bincount(inv).double()[:, None]
    err = (g.values().double() - exact).abs()
    bound = U16 * exact.abs() + k * U32 * mag
    same_rows = bool(torch.equal(g.indices()[0], uniq))
    chk.ok(same_rows and bool((err <= bound).all()),
           f"{tag}: the row gradient has the {uniq.numel()} rows the batch "
           f"touched ({same_rows}; {ids.shape[0]} occurrences, up to "
           f"{int(k.max())} a row), each within u16 |sum| + k u32 sum|g| of "
           f"the float64 sum of its occurrences' gradients (max |diff| "
           f"{float(err.max()):.3e}, {float((err / bound).max()):.3f} of its "
           f"bound)")
    return ids, cot


def timed_steps(torch, sd, model, opt_state, batches) -> tuple:
    """(losses, ms) of one training step a batch, each timed by CUDA
    events."""
    losses, ms = [], []
    for b in batches:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = sd.fn(model, opt_state, b)
        end.record()
        torch.cuda.synchronize()
        losses.append(float(out["loss"]))
        ms.append(start.elapsed_time(end))
    return losses, ms


def dlrm_full_vocab(torch, chk: Checks, K, rs, sd, model, opt_state, batch,
                    tag: str) -> tuple:
    """DLRM's training step on full-vocabulary batches (the reference
    batch's dense features and labels, each field's ids drawn from its own
    vocabulary: lookups spread over the whole table, as Criteo's are,
    where the trainer's synthetic ids put them on 78 rows).  The row
    gradient of one batch against float64 sums of its rows, then
    ``TRAIN_STEPS`` steps timed by CUDA events with their peak memory, one
    profiled step and the row gradient alone.  Returns (launches,
    record)."""
    tag = f"{tag}, full vocabulary"
    batches = [{**batch, **full_vocab_batch(torch, model.cfg, batch,
                                            SEED + 50 + i)}
               for i in range(TRAIN_STEPS)]
    ids, cot = dlrm_rows_vs_float64(torch, chk, rs, model, batches[0], tag)
    rows = int(torch.unique(ids).numel())
    table_bytes = model.table.numel() * model.table.element_size()
    K.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    losses, ms = timed_steps(torch, sd, model, opt_state, batches)
    launches = K.embedding_bag.launches
    peak = torch.cuda.max_memory_allocated()
    n = batch["dense"].shape[0]
    warm = float(np.mean(ms[1:]))
    chk.ok(all(np.isfinite(losses)) and launches == TRAIN_STEPS,
           f"{tag}: losses of {TRAIN_STEPS} steps "
           f"{[round(x, 6) for x in losses]}, all finite; embedding_bag "
           f"launched {launches} times, expected {TRAIN_STEPS}")
    chk.ok(peak - base < table_bytes,
           f"{tag}: peak device memory {peak / 2**30:.3f} GiB, "
           f"{(peak - base) / 2**30:.3f} GiB above the model and optimizer "
           f"state: less than the {table_bytes / 2**30:.3f} GiB table, so "
           "no (V, D) gradient was ever allocated")
    breakdown = device_breakdown(
        torch, chk, K, lambda: sd.fn(model, opt_state, batches[-1]),
        f"{tag} step")
    row_ms = timed(torch, lambda: rs.row_grad(ids, cot, model.table.shape[0]),
                   5)
    chk.note(f"{tag}: steps {[round(x, 3) for x in ms]} ms (CUDA events; "
             f"the first one cold), warm mean {warm:.3f} ms, "
             f"{n / warm * 1e3:.4e} samples/s, model FLOPs "
             f"{sd.model_flops / warm / 1e9:.3f} TFLOP/s; the row gradient "
             f"alone ({ids.shape[0]} occurrences on {rows} rows) "
             f"{row_ms:.3f} ms (CUDA events), {100 * row_ms / warm:.1f}% of "
             "a warm step")
    return launches, {"step_ms": ms, "warm_step_ms": warm,
                      "samples_per_s": n / warm * 1e3,
                      "model_tflops": sd.model_flops / warm / 1e9,
                      "losses": losses, "peak_gib": peak / 2**30,
                      "peak_above_state_gib": (peak - base) / 2**30,
                      "rows": rows, "row_grad_ms": row_ms,
                      "row_grad_share": row_ms / warm,
                      "device_breakdown": breakdown}


def train_arch(torch, chk: Checks, K, ref, rs, train, arch: str, clock):
    """One arch's ``train_batch`` at full width through `launch.train`'s
    step: the step held against the same step through the plain versions
    (and, for Wide & Deep and MIND, through a dense scatter-add gradient;
    for DLRM, its row gradient against float64), then ``TRAIN_STEPS`` steps
    from the initial state, each timed by CUDA events, with their losses,
    the launches and the peak memory; DLRM then on full-vocabulary batches
    (`dlrm_full_vocab`).  Returns ({run: launches}, record)."""
    sd, model, opt_state, batch_at = clock(
        f"{arch}:train_batch: train.setup (parameters from a seeded "
        "torch.Generator on the card)",
        lambda: train.setup(arch, device=DEVICE))
    batches = [batch_at(i) for i in range(TRAIN_STEPS)]
    batch = batches[0]
    n = next(iter(batch.values())).shape[0]
    rows = touched_rows(torch, arch, model, batch)
    tables = {name: p for name, p in model.named_parameters()
              if name in rows}
    whole = ({} if arch == "dlrm-mlperf" else
             {name: p.detach().clone() for name, p in tables.items()})
    snap = train_state(torch, model, opt_state, rows)
    tag = f"{sd.name} (batch {n})"

    loss_k = float(sd.fn(model, opt_state, batch)["loss"])
    after_k = train_state(torch, model, opt_state, rows)
    restore_state(torch, model, opt_state, rows, snap)
    with mock.patch.object(K, "embedding_bag", ref.embedding_bag_ref):
        loss_p = float(sd.fn(model, opt_state, batch)["loss"])
    after_p = train_state(torch, model, opt_state, rows)
    same, rel = state_gap(torch, after_k, after_p)
    chk.ok(loss_k == loss_p and rel <= 2.0 ** -20,
           f"{tag}: one step through the kernel == through the plain "
           f"versions: loss {loss_k!r} == {loss_p!r}, every parameter and "
           f"optimizer leaf within 2^-20 of its scale (largest {rel:.3e}; "
           f"bit-identical: {same})")
    restore_state(torch, model, opt_state, rows, snap)
    if arch == "dlrm-mlperf":
        ids, cot = dlrm_rows_vs_float64(torch, chk, rs, model, batch, tag)
    else:
        # a differentiable plain gather: autograd's dense scatter-add
        with mock.patch.object(rs, "bag_lookup", ref.embedding_bag_ref):
            loss_d = float(sd.fn(model, opt_state, batch)["loss"])
        after_d = train_state(torch, model, opt_state, rows)
        ok, worst, changed = loss_d == loss_k, 0.0, 0
        for name, p in tables.items():
            x, y = after_k[name], after_d[name]
            ulp = torch.abs(torch.nextafter(x, torch.full_like(x, np.inf))
                            - x)
            ok &= bool(((x - y).abs() <= ulp).all())
            worst = max(worst, float(((x - y).abs() / ulp).max()))
            changed += int((x != y).sum())
            keep = torch.ones(p.shape[0], dtype=torch.bool, device=p.device)
            keep[rows[name]] = False
            ok &= bool(torch.equal(p.detach()[keep], whole[name][keep]))
        dense = {k: v for k, v in after_d.items() if k not in tables}
        same_d, rel_d = state_gap(torch, {k: after_k[k] for k in dense},
                                  dense)
        ok &= rel_d <= 2.0 ** -20
        chk.ok(ok, f"{tag}: the row-gradient step == the step through a "
               f"dense scatter-add gradient: loss {loss_d!r}, the touched "
               f"table rows within one float32 ulp ({changed} of "
               f"{sum(after_k[t].numel() for t in tables)} elements differ, "
               f"at most {worst:.0f} ulp: the occurrences summed in another "
               f"order), every other row untouched, the dense leaves within "
               f"2^-20 (bit-identical: {same_d})")
        del whole, after_d
        restore_state(torch, model, opt_state, rows, snap)
    del after_k, after_p, snap

    table_bytes = max(p.numel() * p.element_size() for p in tables.values())
    K.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    losses, ms = timed_steps(torch, sd, model, opt_state, batches)
    launches = K.embedding_bag.launches
    counts = {sd.name: launches}
    peak = torch.cuda.max_memory_allocated()
    total = torch.cuda.get_device_properties(0).total_memory
    warm = float(np.mean(ms[1:]))
    chk.ok(all(np.isfinite(losses)), f"{tag}: losses of {TRAIN_STEPS} "
           f"steps {[round(x, 6) for x in losses]}, all finite")
    chk.ok(launches == LOOKUPS[arch] * TRAIN_STEPS,
           f"{tag}: {TRAIN_STEPS} steps launched embedding_bag {launches} "
           f"times, expected {LOOKUPS[arch] * TRAIN_STEPS}")
    # DLRM: a (V, D) gradient of the 48 GB table would take as much again
    dense_free = arch != "dlrm-mlperf" or peak - base < table_bytes
    chk.ok(peak < total and dense_free,
           f"{tag}: peak device memory {peak / 2**30:.3f} GiB of "
           f"{total / 2**30:.3f}, {(peak - base) / 2**30:.3f} GiB above "
           f"the model and optimizer state"
           + (f": less than the {table_bytes / 2**30:.3f} GiB table, so no "
              "(V, D) gradient was ever allocated"
              if arch == "dlrm-mlperf" else ""))
    chk.note(f"{tag}: steps {[round(x, 3) for x in ms]} ms (CUDA events; "
             f"the first one cold), warm mean {warm:.3f} ms, "
             f"{n / warm * 1e3:.4e} samples/s, model FLOPs "
             f"{sd.model_flops / warm / 1e9:.3f} TFLOP/s")
    rec = {"step_ms": ms, "warm_step_ms": warm,
           "samples_per_s": n / warm * 1e3,
           "model_tflops": sd.model_flops / warm / 1e9, "losses": losses,
           "peak_gib": peak / 2**30}
    if arch == "dlrm-mlperf":
        rec["device_breakdown"] = device_breakdown(
            torch, chk, K, lambda: sd.fn(model, opt_state, batches[-1]),
            f"{tag} step")
        row_ms = timed(torch, lambda: rs.row_grad(ids, cot,
                                                  model.table.shape[0]), 5)
        rec.update(row_grad_ms=row_ms, row_grad_share=row_ms / warm)
        chk.note(f"{tag}: the row gradient alone (sort, segment sum, on "
                 f"the step's {ids.shape[0]} cotangents) {row_ms:.3f} ms "
                 f"(CUDA events), {100 * row_ms / warm:.1f}% of a warm step")
        del ids, cot
        n_full, rec["full_vocabulary"] = dlrm_full_vocab(
            torch, chk, K, rs, sd, model, opt_state, batch, tag)
        counts[f"{sd.name} full-vocabulary"] = n_full
    del model, opt_state, batches, batch, tables
    torch.cuda.empty_cache()
    return counts, rec


def ranking_sample(torch, arch: str, model, query, scores, rows) -> tuple:
    """(got, float64 scores, tolerance) of candidates ``rows``: the float64
    forward with the parameters (and the dense features) rounded to
    bfloat16, as the step casts them.  The tolerance is `RANK_REL_TOL` of
    the sample's scale (of the deep tower's, for Wide & Deep), and for Wide
    & Deep half a bfloat16 ulp (at most u16 of the value) of each value the
    wide term rounds after the deep tower: every partial sum of the 40-id
    bag in slot order, the dense linear term, their sum, and the score."""
    rows_d = torch.from_numpy(rows).to(DEVICE)
    sparse = query["sparse"].expand(rows.size, -1).clone()
    sparse[:, 0] = query["cand_ids"][rows_d]
    dense = query["dense"].expand(rows.size, -1)
    got = scores[rows_d].double().cpu()
    if arch == "dlrm-mlperf":
        want = dlrm64(torch, model, dense, sparse, bf16=True)
        return got, want, RANK_REL_TOL * float(want.abs().max())
    deep, wide, _ = widedeep64(torch, model, dense, sparse, bf16=True)
    gid = (sparse + model.offsets[None, :]).long()
    bag = as64(torch, model.wide[gid][..., 0], True)
    walk = bag.cumsum(1).abs().sum(1)      # the bag's partial sums, in order
    score = deep + wide
    tol = (RANK_REL_TOL * float(deep.abs().max())
           + U16 * (walk + (wide - bag.sum(1)).abs() + wide.abs()
                    + score.abs()))
    return got, score, tol


def rank_retrieval(torch, chk: Checks, K, ref, rs, steps, arch: str, clock):
    """The ranking ``retrieval_cand`` step of ``arch`` over 1,000,000
    candidates: launches, time, peak memory, the scores through the
    kernel against the same scores through its plain version (on the
    step's candidates and on candidates spread over field 0's vocabulary),
    the top-100 against a host stable sort of the whole score vector, and
    a sample of scores against a float64 forward.  Returns (launches,
    record)."""
    sd = steps.build_step(arch, "retrieval_cand")
    c = steps.get_arch(arch).shapes["retrieval_cand"]["n_candidates"]
    model, q = clock(f"{sd.name}: init_args", lambda: sd.init_args(DEVICE))
    K.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    vals, idx = clock(f"{sd.name} (first call)", lambda: sd.fn(model, q))
    launches = K.embedding_bag.launches
    peak = torch.cuda.max_memory_allocated()
    chunks = -(-c // rs.RANK_CHUNK)
    want_launches = chunks * LOOKUPS[arch]
    chk.ok(launches == want_launches,
           f"{sd.name}: {c} candidates in {chunks} chunks launched "
           f"embedding_bag {launches} times, expected {want_launches}")
    ms = timed(torch, lambda: sd.fn(model, q), 3)
    breakdown = device_breakdown(torch, chk, K, lambda: sd.fn(model, q),
                                 sd.name)
    chk.note(f"{sd.name}: {ms:.3f} ms a call (CUDA events, warm), "
             f"{c / ms * 1e3:.4e} candidates/s, model FLOPs "
             f"{sd.model_flops / ms / 1e9:.3f} TFLOP/s; peak device memory "
             f"{peak / 2**30:.3f} GiB, {(peak - base) / 2**30:.3f} GiB above "
             "the model")
    with torch.inference_mode():
        scores = rs.rank_candidates(model, q["dense"], q["sparse"],
                                    q["cand_ids"])
    spread = torch.from_numpy(np.random.default_rng(SEED + 41).integers(
        0, model.cfg.vocab_sizes[0], c).astype(np.int32)).to(DEVICE)
    for what, cand in (("the step's", q["cand_ids"]),
                       ("field 0's whole vocabulary of", spread)):
        with torch.inference_mode():
            got = (scores if cand is q["cand_ids"] else rs.rank_candidates(
                model, q["dense"], q["sparse"], cand))
            with mock.patch.object(K, "embedding_bag",
                                   ref.embedding_bag_ref):
                plain = rs.rank_candidates(model, q["dense"], q["sparse"],
                                           cand)
        chk.ok(torch.equal(got.view(torch.int32), plain.view(torch.int32)),
               f"{sd.name}: the {c} scores of {what} "
               f"{int(torch.unique(cand).numel())} distinct candidate ids "
               f"through embedding_bag == through its plain version, bit "
               f"for bit ({chunks} chunks x {LOOKUPS[arch]} lookups of "
               f"{', '.join(model.TABLES)} cast to bfloat16)")
        del got, plain
    del spread
    s = scores.cpu().numpy()
    order = np.argsort(-s, kind="stable")[:100]
    got_idx, got_vals = idx.cpu().numpy(), vals.cpu().numpy()
    distinct = (np.unique(s).size, int(torch.unique(q["cand_ids"]).numel()))
    chk.ok(np.array_equal(got_idx, order)
           and np.array_equal(got_vals.view(np.int32), s[order].view(np.int32)),
           f"{sd.name}: the step's top-100 == a host stable sort of the "
           f"{c} scores (descending, ties by index) and its values == those "
           f"scores; {distinct[0]} distinct scores for {distinct[1]} "
           f"distinct candidate ids")
    rng = np.random.default_rng(SEED + 40)
    rows = np.union1d(rng.choice(c, N_RANK_SAMPLE, replace=False), order)
    with torch.inference_mode():
        got, want, tol = ranking_sample(torch, arch, model, q, scores, rows)
    err = (got - want).abs()
    chk.ok(bool((err <= tol).all()),
           f"{sd.name}: {rows.size} sampled scores (the top-100 among them) "
           f"vs a float64 forward of the bfloat16-rounded parameters, max "
           f"|diff| {float(err.max()):.3e}, each within 2^-5 of the scale"
           + (" of the deep tower + u16 of each rounded wide value"
              if arch == "wide-deep" else "")
           + f" (largest tolerance {float(torch.as_tensor(tol).max()):.3e})")
    del model, q, scores
    torch.cuda.empty_cache()
    return launches, {"ms": ms, "candidates_per_s": c / ms * 1e3,
                      "model_tflops": sd.model_flops / ms / 1e9,
                      "peak_gib": peak / 2**30,
                      "distinct_scores": distinct[0],
                      "device_breakdown": breakdown}


def phase_recsys_train(torch, chk: Checks, K, ref, clock):
    from repro_torch.launch import steps, train
    from repro_torch.models import recsys as rs

    print("phase 4b: recsys training (train_batch through launch.train) and "
          "the ranking retrieval_cand at full width")
    launches, recs = {}, {}
    for arch in ("dlrm-mlperf", "wide-deep", "mind"):
        counts, recs[f"{arch}:train_batch:train"] = train_arch(
            torch, chk, K, ref, rs, train, arch, clock)
        launches.update(counts)
        chk.note(f"device memory held after {arch}'s training: "
                 f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB")
    for arch in ("dlrm-mlperf", "wide-deep"):
        name = f"{arch}:retrieval_cand:retrieval"
        launches[name], recs[name] = rank_retrieval(torch, chk, K, ref, rs,
                                                    steps, arch, clock)
    return launches, recs


# --------------------------------------------------------------------------- #
# Phase 5: LM serving and BERT4Rec's serving                                   #
# --------------------------------------------------------------------------- #
# H100 SXM dense bfloat16 peak, NVIDIA's data sheet (not measured here)
BF16_PEAK = 989e12
# arch: (layers kept, None = all; decode_32k batch), in the order they run.
# One card's 80 GB cuts the MoE models to one pattern period of 4 layers
# (4.4 and 5.0 GB of bfloat16 weights a layer).  The dense models keep 8,
# 8 and 16 layers: a 32k prefill takes 0.7-0.9 s a layer, and at full depth
# the three took 110 s of the run's time limit.  The decode batches are
# what the caches left room for at full depth (4.3 GB of cache a nemotron
# sequence), kept so that a step reads the same cache a layer.
LM_RUNS = {
    "nemotron-4-15b": (8, 8),
    "internlm2-20b": (8, 4),
    "minicpm3-4b": (16, 32),
    "llama4-scout-17b-a16e": (4, 8),
    "qwen3-moe-235b-a22b": (4, 32),
}
# (a) and (d): prompts of TF_PROMPT tokens, TF_BATCH sequences, GEN_TOKENS
# greedy tokens
TF_PROMPT, TF_BATCH, GEN_TOKENS = 256, 4, 16
# bounds, written in PERF.md before the chip call that checks them:
# (a) decode against the forward's logits: the largest difference as a
# share of the largest logit, and the share of rows with the same top-1
# token; in bfloat16 for the dense models, for the MoE models in float32
# compute and cache over the same bfloat16 weights (bfloat16 moves tokens
# across the router's top-k boundary) with a capacity that drops nothing
# (the forward's groups of 271 tokens would drop what decode keeps)
A_BOUND = {"bf16": (0.08, 0.75), "f32": (1e-3, 0.95)}
# (b) minicpm3-4b's bfloat16 prefill logits against float32 compute
B_BOUND, B_BATCH, B_TOKENS = (0.08, 0.75), 8, 512
# (c) the reduced cells on the card against the CPU: float32 outputs within
# 2^-16 of their largest magnitude, bfloat16 caches within one ulp at theirs
C_REL = 2.0 ** -16
LM_PROFILED = {"prefill": "llama4-scout-17b-a16e", "decode": "nemotron-4-15b"}


def bf16_ulp(magnitude: float) -> float:
    """One bfloat16 ulp at ``magnitude``: 2^(e - 7) in [2^e, 2^(e + 1))."""
    return 2.0 ** (np.floor(np.log2(max(magnitude, 2.0 ** -126))) - 7)


def tree_bytes(torch, tree) -> int:
    from repro_torch.utils import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def rows_agree(torch, got, want) -> tuple[float, float]:
    """(largest |got - want| over the largest |want|, the share of rows
    whose top-1 entries agree) of two (..., V) logit tensors."""
    g, w = got.float().flatten(0, -2), want.float().flatten(0, -2)
    rel = float((g - w).abs().max() / w.abs().max())
    return rel, float((g.argmax(-1) == w.argmax(-1)).float().mean())


def lm_config(steps, arch: str, shape: str, layers):
    cfg = steps.get_arch(arch).make_config(shape, False)
    return dataclasses.replace(cfg, n_layers=layers) if layers else cfg


def prefilled(tf, params, cfg, prompt, n: int, cache_dtype):
    """The prompt's prefill logits and a cache of P + n positions holding
    its K/V, for n tokens to decode."""
    b, p = prompt.shape
    logits, cache = tf.prefill(params, prompt, cfg, cache_dtype)
    full = tf.init_cache(cfg, b, p + n, dtype=cache_dtype,
                         device=prompt.device)
    for k in full:
        full[k][:, :, :p] = cache[k]
    return logits, full


def greedy(torch, tf, params, cfg, prompt, n: int):
    """(d): ``n`` greedy tokens after the prompt (prefill, then n - 1
    decode steps) and each step's logits."""
    p = prompt.shape[1]
    logits, full = prefilled(tf, params, cfg, prompt, n, torch.bfloat16)
    rows, toks = [logits], [logits.argmax(-1)]
    for i in range(n - 1):
        logits, _ = tf.decode_step(params, full, toks[-1], p + i, cfg)
        rows.append(logits)
        toks.append(logits.argmax(-1))
    return torch.stack(toks, 1), torch.stack(rows, 1)


def teacher_forced(torch, tf, params, cfg, prompt, gen, cache_dtype):
    """(a): the prefill's logits and each decode step's, fed the generated
    tokens ``gen``, against the forward over prompt + gen at positions
    P - 1 ... P + n - 2 (the JAX package's teacher-forcing test)."""
    p = prompt.shape[1]
    logits, full = prefilled(tf, params, cfg, prompt, gen.shape[1],
                             cache_dtype)
    rows = [logits]
    for i in range(gen.shape[1] - 1):
        rows.append(tf.decode_step(params, full, gen[:, i], p + i, cfg)[0])
    del full
    hidden, _ = tf.forward(params, torch.cat([prompt, gen[:, :-1]], 1), cfg)
    want = hidden[:, p - 1:] @ params["lm_head"].to(cfg.dtype)
    return torch.stack(rows, 1), want


def lm_profile(torch, chk: Checks, fn, tag: str) -> dict:
    """One call of ``fn`` under torch.profiler, after a call outside the
    trace and a few small kernels inside it (CUPTI's first records can be
    lost): wall time, the card's busy time (its kernels and copies from
    the call's start), GEMMs, softmax and the rest, and the top kernels.
    A lost record makes the busy share smaller, never larger."""
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.autograd.DeviceType.CUDA
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(4):
            torch.ones(1, device=DEVICE).add_(1)
        torch.cuda.synchronize()
        t = time.perf_counter()
        with record_function("measured"):
            fn()
            torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t)
    events = prof.events()
    start = min(e.time_range.start for e in events
                if e.name == "measured" and e.device_type != cuda)
    return profile_summary(chk, [e for e in events if e.device_type == cuda
                                 and e.name != "measured"
                                 and e.time_range.start >= start], wall, tag)


def profile_summary(chk: Checks, events, wall: float, tag: str) -> dict:
    """The note and record of a profiled call from its device events:
    busy time, GEMMs, softmax and the rest, the top kernels."""
    by_name: dict[str, float] = {}
    for e in events:
        us = getattr(e, "device_time_total", None)
        us = e.cuda_time_total if us is None else us
        by_name[e.name] = by_name.get(e.name, 0.0) + us / 1e3
    busy = sum(by_name.values())
    groups = {"gemm": 0.0, "softmax": 0.0, "other": 0.0}
    for name, ms in by_name.items():
        low = name.lower()
        key = ("gemm" if any(s in low for s in ("gemm", "cutlass", "xmma",
                                                 "cublas", "nvjet", "sm90_"))
               else "softmax" if "softmax" in low else "other")
        groups[key] += ms
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    chk.note(f"{tag} (torch.profiler, one call): wall {wall:.1f} ms, card "
             f"busy {busy:.1f} ms ({100 * busy / wall:.1f}%): GEMMs "
             f"{groups['gemm']:.1f}, softmax {groups['softmax']:.1f}, other "
             f"{groups['other']:.1f} ms; most time: "
             + "; ".join(f"{k[:70]} {v:.1f} ms" for k, v in top))
    return {"wall_ms": wall, "busy_ms": busy,
            **{f"{k}_ms": v for k, v in groups.items()},
            "top": [[k[:120], v] for k, v in top]}


def lm_prefill(torch, chk: Checks, steps, tf, arch: str, layers, card: str):
    """prefill_32k at batch 1: time, tokens/s, model FLOP/s and peak
    memory; then (d) greedy generation, (a) decode against the forward
    and, for minicpm3-4b, (b) bfloat16 against float32 compute."""
    cut = {"n_layers": layers} if layers else None
    sd = steps.build_step(arch, "prefill_32k", cfg_override=cut,
                          shape_override={"global_batch": 1})
    params, tokens = sd.init_args()
    cfg = lm_config(steps, arch, "prefill_32k", layers)
    rec = {"layers": cfg.n_layers, "weights_gb": tree_bytes(torch, params)
           / 1e9}
    with torch.inference_mode():
        sd.fn(params, tokens[:, :cfg.chunk_q])       # cuBLAS warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        logits, cache = sd.fn(params, tokens)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t)
    peak = torch.cuda.max_memory_allocated() / 1e9
    s = tokens.shape[1]
    rec.update(prefill_ms=ms, tokens_per_s=s / (ms / 1e3),
               model_tflops=sd.model_flops / (ms / 1e3) / 1e12,
               bf16_peak_share=sd.model_flops / (ms / 1e3) / BF16_PEAK,
               prefill_peak_gb=peak)
    chk.ok(bool(torch.isfinite(logits).all())
           and all(bool(torch.isfinite(c).all()) for c in cache.values())
           and tuple(logits.shape) == (1, cfg.vocab),
           f"{sd.name} ({cfg.n_layers} layers, {rec['weights_gb']:.2f} GB of "
           f"bfloat16 weights, batch 1 x {s}): logits and cache finite; "
           f"{ms:.1f} ms (host clock, synchronized), {rec['tokens_per_s']:.0f}"
           f" tokens/s, {rec['model_tflops']:.1f} TFLOP/s of model FLOPs = "
           f"{100 * rec['bf16_peak_share']:.1f}% of the bf16 dense peak "
           f"(989 TFLOP/s, data sheet), peak memory {peak:.2f} GB [{card}]")
    del logits, cache
    if LM_PROFILED["prefill"] == arch:
        rec["prefill_profile"] = lm_profile(
            torch, chk, lambda: sd.fn(params, tokens), f"{sd.name} profile")
    del tokens
    rng = np.random.default_rng(SEED + 50)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (
        TF_BATCH, TF_PROMPT)).astype(np.int64)).to(DEVICE)
    with torch.inference_mode():
        gen, rows = greedy(torch, tf, params, cfg, prompt, GEN_TOKENS)
        chk.ok(bool(torch.isfinite(rows).all())
               and tuple(gen.shape) == (TF_BATCH, GEN_TOKENS),
               f"{arch} (d): {GEN_TOKENS} greedy tokens for {TF_BATCH} "
               f"prompts of {TF_PROMPT} (bfloat16), every logit finite; "
               f"first sequence {gen[0].tolist()}")
        if cfg.moe is None:
            kind, cfg_a = "bf16", cfg
        else:
            e = cfg.moe
            kind = "f32"
            cfg_a = dataclasses.replace(cfg, dtype=torch.float32, moe=(
                dataclasses.replace(e, capacity_factor=e.n_experts
                                    / e.top_k)))
        got, want = teacher_forced(torch, tf, params, cfg_a, prompt, gen,
                                   cfg_a.dtype)
        rel, top1 = rows_agree(torch, got, want)
        bound, share = A_BOUND[kind]
        rec.update(a_rel=rel, a_top1=top1)
        chk.ok(rel <= bound and top1 >= share,
               f"{arch} (a) decode vs forward ({kind}"
               + ("" if kind == "bf16" else " compute and cache, "
                  "capacity_factor E/k: nothing dropped")
               + f"), {got.shape[0] * got.shape[1]} rows: "
               f"largest difference {rel:.4g} of the largest logit (bound "
               f"{bound}), top-1 agree {top1:.3f} (bound {share})")
        del got, want, rows
        if arch == "minicpm3-4b":
            rec.update(bf16_vs_f32(torch, chk, steps, params, arch,
                                   layers))
    del params
    torch.cuda.empty_cache()
    return rec


def bf16_vs_f32(torch, chk: Checks, steps, params, arch: str,
                layers) -> dict:
    """(b): the bfloat16 prefill step's logits against the same weights
    run at ``cfg_override={"dtype": float32}``; and the bfloat16 step with
    cuBLAS's reduced-precision bfloat16 reductions off, against it on (the
    default, which the package leaves alone)."""
    shape = {"global_batch": B_BATCH, "seq_len": B_TOKENS}
    cut = {"n_layers": layers} if layers else {}
    bf = steps.build_step(arch, "prefill_32k", shape_override=shape,
                          cfg_override=cut or None)
    f32 = steps.build_step(arch, "prefill_32k", shape_override=shape,
                           cfg_override={**cut, "dtype": torch.float32})
    vocab = steps.get_arch(arch).make_config("prefill_32k", False).vocab
    tokens = torch.from_numpy(np.random.default_rng(SEED + 51).integers(
        0, vocab, (B_BATCH, B_TOKENS)).astype(np.int32)).to(DEVICE)
    flag = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    try:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            True
        lb = bf.fn(params, tokens)[0]
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
        lb_full = bf.fn(params, tokens)[0]
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            flag
    l32 = f32.fn(params, tokens)[0]
    rel, top1 = rows_agree(torch, lb, l32)
    bound, share = B_BOUND
    chk.ok(l32.dtype == torch.float32 and rel <= bound and top1 >= share,
           f"{arch} (b) bfloat16 prefill logits vs float32 compute, same "
           f"bfloat16 weights, {B_BATCH} x {B_TOKENS} tokens: largest "
           f"difference {rel:.4g} of the largest logit (bound {bound}), "
           f"top-1 agree {top1:.3f} (bound {share})")
    rrel, rtop1 = rows_agree(torch, lb, lb_full)
    chk.ok(rrel <= bound and rtop1 >= share,
           f"{arch}: cuBLAS bfloat16 reduced-precision reductions on (the "
           f"default) vs off: largest difference {rrel:.4g} of the largest "
           f"logit, top-1 agree {rtop1:.3f}, within (b)'s bound")
    return {"b_rel": rel, "b_top1": top1, "reduced_reduction_rel": rrel,
            "reduced_reduction_top1": rtop1}


def lm_decode(torch, chk: Checks, steps, arch: str, shape: str, layers,
              batch, card: str) -> dict:
    """A decode step at ``shape`` (the cache zeros up to Smax, position
    Smax / 2, as the reference's init_args): ms a step, bytes a step
    (the weights but the embedding table, whose B rows are gathered, and
    the whole cache, which attention reads under its mask) against the HBM
    peak, peak memory."""
    cut = {"n_layers": layers} if layers else None
    over = {"global_batch": batch} if batch else None
    sd = steps.build_step(arch, shape, cfg_override=cut, shape_override=over)
    params, cache, toks, pos = sd.init_args()
    step_bytes = (tree_bytes(torch, params) - tree_bytes(torch, params[
        "embed"]) + tree_bytes(torch, cache))
    with torch.inference_mode():
        logits, _ = sd.fn(params, cache, toks, pos)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = timed(torch, lambda: sd.fn(params, cache, toks, pos), 3, 0)
    peak = torch.cuda.max_memory_allocated() / 1e9
    b = toks.shape[0]
    rec = {f"{shape}_batch": b, f"{shape}_step_ms": ms,
           f"{shape}_tokens_per_s": b / (ms / 1e3),
           f"{shape}_step_gb": step_bytes / 1e9,
           f"{shape}_hbm_share": step_bytes / (ms / 1e3) / HBM_RATE,
           f"{shape}_peak_gb": peak,
           f"{shape}_model_tflops": sd.model_flops / (ms / 1e3) / 1e12}
    chk.ok(bool(torch.isfinite(logits).all()),
           f"{sd.name} (batch {b}, cache of {cache[next(iter(cache))].shape[2]}"
           f" at position {pos}): logits finite; {ms:.2f} ms a step (CUDA "
           f"events, 3 steps), {rec[f'{shape}_tokens_per_s']:.0f} tokens/s, "
           f"{step_bytes / 1e9:.2f} GB read a step (weights and cache) = "
           f"{100 * rec[f'{shape}_hbm_share']:.1f}% of the HBM peak "
           f"(3.35 TB/s), peak memory {peak:.2f} GB [{card}]")
    if LM_PROFILED["decode"] == arch and shape == "decode_32k":
        rec["decode_profile"] = lm_profile(
            torch, chk, lambda: sd.fn(params, cache, toks, pos),
            f"{sd.name} profile")
    del params, cache, logits
    torch.cuda.empty_cache()
    return rec


def reduced_on_cpu(torch, chk: Checks, steps) -> None:
    """(c): every reduced serving cell on the card and on the CPU with the
    same parameters and inputs (TF32 is off)."""
    from repro_torch.configs.registry import all_cells
    from repro_torch.utils import tree_leaves, tree_map

    def cpu(x):
        return x.cpu() if isinstance(x, torch.Tensor) else x

    worst = {}
    for arch, shape, _ in all_cells():
        if shape not in ("prefill_32k", "decode_32k", "long_500k",
                         "serve_p99", "serve_bulk", "retrieval_cand") or (
                steps.get_arch(arch).family == "recsys"
                and arch != "bert4rec"):
            continue
        sd = steps.build_step(arch, shape, reduced=True)
        args = sd.init_args()
        host = tree_map(cpu, list(args))
        out = tree_leaves(sd.fn(*args))
        want = tree_leaves(sd.fn(*host))
        errs = []
        for g, w in zip(out, want):
            g = g.cpu()
            if not g.is_floating_point():
                errs.append(0.0 if torch.equal(g, w) else float("inf"))
                continue
            top = max(float(w.float().abs().max()), 1e-30)
            tol = C_REL * top if g.dtype == torch.float32 else bf16_ulp(top)
            errs.append(float((g.float() - w.float()).abs().max()) / tol)
        worst[sd.name] = max(errs)
    bad = {k: v for k, v in worst.items() if v > 1.0}
    chk.ok(len(worst) == 14 and not bad,
           f"(c) {len(worst)} reduced serving cells on the card vs the CPU: "
           f"float32 outputs within 2^-16 and bfloat16 caches within one "
           f"ulp at their largest magnitude, ids equal; worst "
           f"{max(worst.values()):.3f} of the tolerance"
           + (f"; beyond it: {bad}" if bad else ""))


def bert4rec_serving(torch, chk: Checks, steps, rs, card: str) -> dict:
    """BERT4Rec at full width: serve_p99 (512 sequences), serve_bulk
    (262,144, in chunks of BERT4REC_CHUNK) and retrieval_cand (one user
    against 1,000,000 items, top-100); time each call, and hold sampled
    users and the retrieval's top-100 against the same step on the
    CPU."""
    from repro_torch.utils import tree_map

    recs = {}
    host = None
    for shape in ("serve_p99", "serve_bulk", "retrieval_cand"):
        sd = steps.build_step("bert4rec", shape)
        params, batch = sd.init_args()
        if host is None:
            host = tree_map(lambda t: t.cpu(), params)
        reps = 5 if shape != "serve_bulk" else 1
        out = sd.fn(params, batch)
        ms = timed(torch, lambda: sd.fn(params, batch), reps, 0)
        n = batch["seq"].shape[0]
        if shape == "retrieval_cand":
            want = sd.fn(host, {"seq": batch["seq"].cpu()})
            rel = float((out[0].cpu() - want[0]).abs().max()
                        / want[0].abs().max())
            same = bool(torch.equal(out[1].cpu(), want[1]))
            chk.ok(rel <= C_REL and same and tuple(out[1].shape) == (1, 100),
                   f"{sd.name}: top-100 of 1,000,000 items equal to the "
                   f"CPU's, scores within {rel:.3g} of the largest; "
                   f"{ms:.2f} ms a call (CUDA events) [{card}]")
        else:
            idx = torch.arange(0, n, max(1, n // 64))
            want = rs.bert4rec_user_repr(
                host, batch["seq"][idx].cpu(),
                steps.get_arch("bert4rec").make_config(shape, False))
            rel = float((out[idx].cpu() - want).abs().max()
                        / want.abs().max())
            chk.ok(bool(torch.isfinite(out).all()) and rel <= C_REL
                   and out.shape == (n, host["pos"].shape[1]),
                   f"{sd.name}: {n} users finite, {len(idx)} sampled against "
                   f"the CPU within {rel:.3g} of the largest; {ms:.2f} ms a "
                   f"batch (CUDA events, {reps} calls), "
                   f"{n / (ms / 1e3):.0f} sequences/s [{card}]")
        recs[sd.name] = {"ms": ms, "rel_vs_cpu": rel}
        del params, batch, out
        torch.cuda.empty_cache()
    return recs


def phase_lm(torch, chk: Checks, card: str) -> dict:
    from repro_torch.launch import steps
    from repro_torch.models import recsys as rs
    from repro_torch.models import transformer as tf

    print("phase 5: LM serving (prefill and decode of the five LM "
          "architectures through launch.steps.build_step, bfloat16 "
          "parameters seeded on the card) and BERT4Rec's serving")
    reduced_on_cpu(torch, chk, steps)
    recs = {}
    for arch, (layers, batch) in LM_RUNS.items():
        t = time.perf_counter()
        rec = lm_prefill(torch, chk, steps, tf, arch, layers, card)
        for shape in steps.get_arch(arch).runnable_shapes():
            if shape != "prefill_32k" and shape != "train_4k":
                rec.update(lm_decode(torch, chk, steps, arch, shape, layers,
                                     batch if shape == "decode_32k" else None,
                                     card))
        rec["seconds"] = time.perf_counter() - t
        recs[arch] = rec
        chk.note(f"{arch}: {rec['seconds']:.1f} s; device memory held "
                 f"after it: {torch.cuda.memory_allocated() / 2**30:.3f} GiB")
    recs["bert4rec"] = bert4rec_serving(torch, chk, steps, rs, card)
    return recs


# --------------------------------------------------------------------------- #
# phase 6                                                                      #
# --------------------------------------------------------------------------- #
# arch: layers kept (None = all) at train_4k's full width and chunk_q 1024,
# one 4,096-token sequence a microbatch and the reference's accumulation
# (`steps.lm_accum`: 2 dense, 8 MoE): a global batch of 2 and 8 sequences,
# not 256.  Float32 parameters, gradients and AdamW moments take 16 bytes a
# parameter: minicpm3-4b's 4.262B at all 62 layers are 68.2 GB and fit, but
# a step there takes 6.8 s, so it keeps 16 layers; qwen3-moe's first layer
# (with its embedding and head) 3.733B, 59.7 GB; a second layer would not
# fit on one card (PERF.md section 4).
LM_TRAIN_RUNS = {"minicpm3-4b": 16, "qwen3-moe-235b-a22b": 1}
# timed steps of each phase-6 run (after one step that is not timed)
P6_STEPS = 3
# (c) every reduced training cell on the card against the CPU: the losses
# within 2^-16; the parameters after three steps with at least 999 in 1,000
# elements within 2^-16 of the leaf's largest magnitude plus 2^-12 of the lr
# a step, every element within 2 lr a step (AdamW amplifies the rounding of
# a gradient whose moments are small; a near-tied router takes the other
# expert); lr is the family's largest (BERT4Rec's row-wise SGD)
P6_LOSS_REL = 2.0 ** -16
P6_LR = {"lm": 3e-4, "recsys": 1e-2, "gnn": 5e-3}
# leaves of an LM whose in-place AdamW update is held against the
# functional one (the embedding's first rows: the update is elementwise)
P6_SAMPLED = (("final_norm",), ("layers", "attn_norm"),
              ("layers", "attn", "wkv_a"), ("layers", "ffn", "router"),
              ("embed",))
P6_EMBED_ROWS = 4096


def sync_ms(torch, fn):
    """(fn(), its milliseconds on the host clock, the card synchronized)."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t)


def train_close(torch, got_tree, want_tree, lr: float, steps: int):
    """(within (c)'s bounds, the largest difference in units of lr, the
    share of elements past the tight bound) of the card's parameters
    against the CPU's."""
    from repro_torch.utils import tree_leaves

    far = total = 0
    worst = 0.0
    for a, b in zip(tree_leaves(want_tree), tree_leaves(got_tree)):
        err = (a.float() - b.cpu().float()).abs()
        worst = max(worst, float(err.max()) / lr)
        tol = 2.0 ** -16 * float(a.abs().max()) + 2.0 ** -12 * lr * steps
        far += int((err > tol).sum())
        total += err.numel()
    return (worst <= 2 * steps and far * 1000 <= total), worst, far / total


def train_profile(torch, chk: Checks, fn, tag: str) -> dict:
    """One call of ``fn`` (a warm training step) traced with the card's
    activity alone: a step launches some 10^5 kernels, and with the host's
    operator events beside them the trace took most of a minute to read.
    A few small kernels run first in the trace (CUPTI's first records can
    be lost); every device record counts toward the busy time."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.autograd.DeviceType.CUDA
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(4):
            torch.ones(1, device=DEVICE).add_(1)
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t)
    return profile_summary(chk, [e for e in prof.events()
                                 if e.device_type == cuda], wall, tag)


def reduced_training_on_cpu(torch, chk: Checks, steps) -> None:
    """(c): the reduced training cells of the LMs, BERT4Rec and the GAT on
    the card and on the CPU, three steps each from the same state (TF32
    off)."""
    from repro_torch.configs.registry import all_cells
    from repro_torch.utils import tree_map

    worst, bad = {}, {}
    for arch, shape, _ in all_cells():
        family = steps.get_arch(arch).family
        if not (shape == "train_4k" or family == "gnn"
                or (arch, shape) == ("bert4rec", "train_batch")):
            continue
        sd = steps.build_step(arch, shape, reduced=True)
        args = sd.init_args()
        host = tree_map(lambda t: t.to("cpu", copy=True), list(args))
        rel = 0.0
        for _ in range(3):
            got = float(sd.fn(*args)["loss"])
            want = float(sd.fn(*host)["loss"])
            rel = max(rel, abs(got - want) / abs(want))
        ok, lr_units, share = train_close(torch, args[0], host[0],
                                          P6_LR[family], 3)
        worst[sd.name] = (rel, lr_units, share)
        if not ok or rel > P6_LOSS_REL or not np.isfinite(got):
            bad[sd.name] = worst[sd.name]
    chk.ok(len(worst) == 10 and not bad,
           f"(c) {len(worst)} reduced training cells on the card vs the CPU, "
           f"3 steps each: losses within 2^-16 (worst "
           f"{max(v[0] for v in worst.values()):.3g}), parameters within "
           f"(c)'s bounds (largest difference "
           f"{max(v[1] for v in worst.values()):.3g} lr, at most "
           f"{max(v[2] for v in worst.values()):.2e} of the elements past "
           f"2^-16 of the leaf + 2^-12 lr a step)"
           + (f"; beyond them: {bad}" if bad else ""))


def sampled_leaves(params, state, grads) -> dict:
    """{path: (param, mu, nu, grad)} of the `P6_SAMPLED` leaves the config
    has, the embedding cut to its first rows (views, not copies)."""
    out = {}
    for path in P6_SAMPLED:
        trees = [params, state["mu"], state["nu"], grads]
        try:
            for key in path:
                trees = [t[key] for t in trees]
        except KeyError:
            continue
        if path == ("embed",):
            trees = [t[:P6_EMBED_ROWS] for t in trees]
        out[".".join(path)] = tuple(trees)
    return out


def inplace_vs_functional(torch, chk: Checks, steps, cfg, accum, params,
                          state, batch, tag: str) -> float:
    """The run's first step by hand, as the step runs it (`lm_grads`,
    the in-place clip and `update_`), with the sampled leaves' AdamW held
    against the functional `adamw.update` and `apply_updates` on copies of
    their parameters, moments and clipped gradients, bit for bit.  Returns
    the step's loss."""
    from repro_torch.optim import apply_updates, clip_by_global_norm_

    loss, grads = steps.lm_grads(params, batch, cfg, accum)
    clip_by_global_norm_(grads, 1.0)
    picked = sampled_leaves(params, state, grads)
    before = {k: tuple(t.clone() for t in v) for k, v in picked.items()}
    step0 = state["step"].clone()
    opt = steps.make_lm_optimizer()
    opt.update_(grads, state, params)
    del grads
    sub_p = {k: v[0] for k, v in before.items()}
    upd, new = opt.update({k: v[3] for k, v in before.items()},
                          {"mu": {k: v[1] for k, v in before.items()},
                           "nu": {k: v[2] for k, v in before.items()},
                           "step": step0}, sub_p)
    apply_updates(sub_p, upd)
    same = all(torch.equal(sub_p[k], picked[k][0])
               and torch.equal(new["mu"][k], picked[k][1])
               and torch.equal(new["nu"][k], picked[k][2]) for k in picked)
    n = sum(v[0].numel() for v in picked.values())
    chk.ok(same and len(picked) >= 4 and int(state["step"]) == 1,
           f"{tag}: the in-place AdamW of step 0 (clip, then update_, one "
           f"leaf at a time) == the functional adamw.update + apply_updates "
           f"on the same clipped gradients, bit for bit, on "
           f"{len(picked)} sampled leaves ({', '.join(picked)}; {n:,} "
           f"parameters), moments included")
    return float(loss)


def dropped_share(torch, tf, params, cfg, batch) -> float:
    """The MoE layers' mean share of dropped assignments over the first
    microbatch's forward (the sequence alone, as the step runs it)."""
    shares = []
    real = tf.moe_apply

    def recording(p, x, mcfg):
        y, aux = real(p, x, mcfg)
        shares.append(float(aux["dropped_frac"]))
        return y, aux
    with torch.no_grad(), mock.patch.object(tf, "moe_apply", recording):
        tf.forward(params, batch["tokens"][:1], cfg)
    return float(np.mean(shares))


def lm_train(torch, chk: Checks, steps, train, tf, arch: str, layers,
             card: str) -> dict:
    """``train_4k`` at full width: one untimed step by hand (the in-place
    optimizer against the functional one), `P6_STEPS` steps through
    ``build_step``'s step on `launch.train`'s token stream, each timed
    (host clock, synchronized), tokens/s, model FLOP/s against the bf16
    dense peak, peak memory, the losses; a profiled step; the MoE's
    dropped share."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.utils import tree_leaves

    from repro_torch.utils import tree_leaves, tree_map

    cfg = lm_config(steps, arch, "train_4k", layers)
    accum = steps.lm_accum(cfg, False)
    cut = {"n_layers": layers} if layers else None
    sd = steps.build_step(arch, "train_4k", cfg_override=cut,
                          shape_override={"global_batch": accum})
    torch.cuda.reset_peak_memory_stats()
    (params, state, fixed), init_ms = sync_ms(torch, sd.init_args)
    batch_at = train.make_batch_source(get_arch(arch), cfg, fixed, DEVICE)
    n_params = sum(t.numel() for t in tree_leaves(params))
    full = get_arch(arch).make_config("train_4k", False).n_layers
    tag = (f"{sd.name} ({cfg.n_layers} of {full} layers, "
           f"{n_params / 1e9:.3f}B float32 parameters, {accum} x 1 x "
           f"{cfg.max_seq} tokens a step)")
    loss0, ms0 = sync_ms(torch, lambda: inplace_vs_functional(
        torch, chk, steps, cfg, accum, params, state, batch_at(0), tag))
    rec = {"layers": cfg.n_layers, "accum": accum, "params_b": n_params / 1e9,
           "init_ms": init_ms, "step0_ms": ms0, "loss0": loss0}
    torch.cuda.reset_peak_memory_stats()
    losses, norms, times = [loss0], [], []
    for i in range(1, P6_STEPS + 1):
        batch = batch_at(i)
        m, ms = sync_ms(torch, lambda: sd.fn(params, state, batch))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        times.append(ms)
    peak = torch.cuda.max_memory_allocated() / 1e9
    ms = float(np.mean(times))
    tokens = accum * cfg.max_seq
    rec.update(step_ms=times, mean_step_ms=ms,
               tokens_per_s=tokens / (ms / 1e3),
               model_tflops=sd.model_flops / (ms / 1e3) / 1e12,
               bf16_peak_share=sd.model_flops / (ms / 1e3) / BF16_PEAK,
               peak_gb=peak, losses=losses, grad_norms=norms)
    ln_v = float(np.log(cfg.vocab))
    chk.ok(all(np.isfinite(losses + norms)) and abs(loss0 - ln_v) <= 1.0
           and int(state["step"]) == P6_STEPS + 1,
           f"{tag}: losses {[round(x, 4) for x in losses]} (step 0 against "
           f"ln V = {ln_v:.3f}), gradient norms "
           f"{[round(x, 3) for x in norms]}, all finite; step 0 (by hand, "
           f"cuBLAS warm-up) {ms0:.1f} ms; steps 1-{P6_STEPS} "
           f"{[round(t, 1) for t in times]} ms (host clock, synchronized), "
           f"{rec['tokens_per_s']:.0f} tokens/s, {rec['model_tflops']:.1f} "
           f"TFLOP/s of model FLOPs = {100 * rec['bf16_peak_share']:.1f}% of "
           f"the bf16 dense peak (989 TFLOP/s, data sheet), peak memory "
           f"{peak:.2f} GB [{card}]")
    batch = batch_at(P6_STEPS + 1)
    rec["profile"] = train_profile(
        torch, chk, lambda: sd.fn(params, state, batch),
        f"{sd.name} training step profile")
    if cfg.moe is not None:
        rec["dropped_share"] = dropped_share(torch, tf, params, cfg,
                                             batch_at(0))
        chk.note(f"{sd.name}: dropped share of the MoE assignments over one "
                 f"sequence's forward {rec['dropped_share']:.4f} "
                 f"(capacity factor {cfg.moe.capacity_factor}, "
                 f"{accum} microbatches of one sequence)")
    del params, state, fixed
    torch.cuda.empty_cache()
    return rec


def setup_train(torch, train, arch: str, shape: str):
    """`launch.train.setup` on the card, its time, and the peak memory
    counted from it."""
    torch.cuda.reset_peak_memory_stats()
    return sync_ms(torch, lambda: train.setup(arch, shape, device=DEVICE))


def timed_train(torch, chk: Checks, sd, model, state, batch_at, unit: str,
                per_step: int, peak_ref: str, card: str) -> dict:
    """One untimed step, then `P6_STEPS` timed ones (host clock,
    synchronized) through the trainer's step: ms, ``unit``/s, model FLOP/s
    against the FP32 peak (these models run in float32), peak memory,
    losses finite."""
    losses = [float(sd.fn(model, state, batch_at(0))["loss"])]
    times = []
    for i in range(1, P6_STEPS + 1):
        batch = batch_at(i)
        m, ms = sync_ms(torch, lambda: sd.fn(model, state, batch))
        losses.append(float(m["loss"]))
        times.append(ms)
    peak = torch.cuda.max_memory_allocated() / 1e9
    ms = float(np.mean(times))
    rec = {"step_ms": times, "mean_step_ms": ms,
           f"{unit}_per_s": per_step / (ms / 1e3),
           "model_tflops": sd.model_flops / (ms / 1e3) / 1e12,
           "fp32_peak_share": sd.model_flops / (ms / 1e3) / FP32_PEAK,
           "peak_gb": peak, "losses": losses}
    chk.ok(all(np.isfinite(losses)),
           f"{sd.name} ({per_step:,} {unit} a step): losses "
           f"{[round(x, 4) for x in losses]} finite; steps "
           f"{[round(t, 1) for t in times]} ms (host clock, synchronized), "
           f"{rec[f'{unit}_per_s']:.0f} {unit}/s, "
           f"{rec['model_tflops']:.2f} TFLOP/s of model FLOPs = "
           f"{100 * rec['fp32_peak_share']:.1f}% of the FP32 peak (67 "
           f"TFLOP/s, data sheet; float32 model, TF32 off), peak memory "
           f"{peak:.2f} GB ({peak_ref}) [{card}]")
    return rec


def bert4rec_train(torch, chk: Checks, train, card: str) -> dict:
    """BERT4Rec's ``train_batch`` (65,536 sequences of 200) at full width
    through `launch.train`: the encoder and the loss in chunks of
    `BERT4REC_TRAIN_CHUNK` sequences, the MLPerf optimizer split."""
    (sd, params, state, batch_at), init_ms = setup_train(
        torch, train, "bert4rec", "train_batch")
    n = batch_at(0)["seq"].shape[0]
    rec = timed_train(torch, chk, sd, params, state, batch_at, "sequences",
                      n, "from train.setup on", card)
    rec["init_ms"] = init_ms
    del params, state, batch_at
    torch.cuda.empty_cache()
    return rec


def gnn_train(torch, chk: Checks, train, card: str) -> dict:
    """The four ``gat-cora`` shapes at full size through `launch.train`:
    cora's full graph, the reddit-sized minibatch (1,024 seeds, fanout 15
    x 10), ogb_products' full graph (2,449,029 nodes, 64,308,169 edges
    with the self loops) and 128 molecules."""
    recs = {}
    for shape in ("full_graph_sm", "minibatch_lg", "ogb_products",
                  "molecule"):
        (sd, params, state, batch_at), init_ms = setup_train(
            torch, train, "gat-cora", shape)
        b = batch_at(0)
        if "edge_mask" in b:
            per, unit = int(b["edge_mask"].sum()), "edges"
        elif "x0" in b:
            per, unit = b["x0"].shape[0], "seeds"
        else:
            per, unit = b["x"].shape[0], "graphs"
        recs[shape] = timed_train(torch, chk, sd, params, state, batch_at,
                                  unit, per, "from train.setup on, the "
                                  "batch made on the host included", card)
        recs[shape]["init_ms"] = init_ms
        del params, state, batch_at, b
        torch.cuda.empty_cache()
    return recs


def training_state_note(chk: Checks, steps, tf) -> None:
    """Each LM's training state at full depth and at one pattern period
    (the least depth the config allows): 16 bytes a parameter (float32
    parameters, gradients and AdamW's two moments), counted on the meta
    device."""
    parts = []
    for arch in LM_RUNS:
        cfg = lm_config(steps, arch, "train_4k", None)
        period = dataclasses.replace(cfg, n_layers=cfg.pattern_period)
        n, n1 = (tf.param_count(tf.init_params(c, device="meta"))
                 for c in (cfg, period))
        parts.append(f"{arch} {n / 1e9:.3f}B parameters, {16 * n / 1e9:.1f}"
                     f" GB at {cfg.n_layers} layers, {16 * n1 / 1e9:.1f} GB "
                     f"at {cfg.pattern_period}")
    chk.note("training state (16 bytes a parameter) of each LM: "
             + "; ".join(parts))


def phase_training(torch, chk: Checks, card: str) -> dict:
    from repro_torch.launch import steps, train
    from repro_torch.models import transformer as tf

    print("phase 6: training at full width through launch.train's step "
          "and launch.steps.build_step: the LMs' train_4k, BERT4Rec's "
          "train_batch and the four gat-cora shapes")
    training_state_note(chk, steps, tf)
    reduced_training_on_cpu(torch, chk, steps)
    recs = {}
    for arch, layers in LM_TRAIN_RUNS.items():
        recs[arch] = lm_train(torch, chk, steps, train, tf, arch, layers,
                              card)
    recs["bert4rec"] = bert4rec_train(torch, chk, train, card)
    recs["gat-cora"] = gnn_train(torch, chk, train, card)
    return recs


# phase 7: the distributed layer at world size 1 (NCCL)
P7_STEPS = 3
P7_RING = (4096, 2048, 2048)    # M, K, N of the ring matmul
P7_PSUM = 1 << 24               # elements of the compressed all-reduce
P7_REDUCED = ("nemotron-4-15b", "internlm2-20b", "minicpm3-4b",
              "llama4-scout-17b-a16e", "qwen3-moe-235b-a22b")
# (c): full width at a cut depth (internlm2's 2.7B parameters are 43.5 GB
# of training state, minicpm3's 0.88B 14 GB)
P7_FULL = {"internlm2-20b": 4, "minicpm3-4b": 8}
# (d): the serving cells on the (1, 1) mesh (each arch's prefill_32k and
# these), and one at full width: arch, layers, prefill and decode batch
P7_SERVE = (("nemotron-4-15b", ("decode_32k",)),
            ("internlm2-20b", ("decode_32k",)),
            ("minicpm3-4b", ("decode_32k",)),
            ("llama4-scout-17b-a16e", ("decode_32k", "long_500k")),
            ("qwen3-moe-235b-a22b", ("decode_32k",)))
P7_SERVE_FULL = ("nemotron-4-15b", 8, 1, 8)
# (e): the recsys and GAT cells on the (1, 1) mesh: every reduced one, and
# these at full width (DLRM apart, over one copy of its table)
P7_RS = ("dlrm-mlperf", "wide-deep", "mind", "bert4rec")
P7_RS_SHAPES = ("train_batch", "serve_p99", "serve_bulk", "retrieval_cand")
P7_GNN_SHAPES = ("full_graph_sm", "minibatch_lg", "ogb_products", "molecule")
P7_RS_FULL = (("wide-deep", "mind", "bert4rec"),
              ("train_batch", "serve_bulk", "retrieval_cand"))


def p7_collectives(torch, chk: Checks, mesh, card: str) -> dict:
    """(a) the ring matmul and the compressed all-reduce on the card."""
    from repro_torch.distributed import compression
    from repro_torch.distributed.collective_matmul import (
        ring_allgather_matmul)

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    m, k, n = P7_RING
    x = torch.randn(m, k, generator=gen, device=DEVICE)
    w = torch.randn(k, n, generator=gen, device=DEVICE)
    got = ring_allgather_matmul(x, w, mesh, "model")
    exact = x.double() @ w.double()
    # float32 products of K terms: within K * 2^-24 of |x| @ |w|
    bound = k * 2.0 ** -24 * (x.double().abs() @ w.double().abs())
    err = (got.double() - exact).abs()
    ring_ms = timed(torch, lambda: ring_allgather_matmul(x, w, mesh,
                                                         "model"), 5)
    mm_ms = timed(torch, lambda: x @ w, 5)
    chk.ok(got.shape == (m, n) and bool((err <= bound).all()),
           f"ring_allgather_matmul ({m} x {k}) @ ({k} x {n}) over a 'model' "
           f"ring of 1: max error {float(err.max()):.3e} against the float64 "
           f"product (bound K 2^-24 |x||w|), bit-equal to x @ w: "
           f"{bool(torch.equal(got, x @ w))}; {ring_ms:.3f} ms beside x @ w "
           f"{mm_ms:.3f} ms (CUDA events) [{card}]")
    del x, w, got, exact, bound, err
    g = torch.randn(P7_PSUM, generator=gen, device=DEVICE)
    none = compression.compressed_psum({"g": g}, None, "none")["g"]
    q = compression.compressed_psum({"g": g}, None, "int8")["g"]
    scale = compression._scale(g)
    by_hand = compression._quantize(g, scale, torch.int32).float() * scale
    chk.ok(torch.equal(none, g) and torch.equal(q, by_hand)
           and float((q - g).abs().max()) <= 0.5 * float(scale) * 1.001,
           f"compressed_psum over a group of 1 ({P7_PSUM:,} elements): "
           f"'none' the exact sum bit for bit, 'int8' the quantization by "
           f"hand bit for bit and within half its scale "
           f"({float(scale):.4e}) of the sum")
    return {"ring_ms": ring_ms, "matmul_ms": mm_ms}


def p7_same(torch, a_tree, b_tree) -> bool:
    from repro_torch.utils import tree_leaves

    a, b = tree_leaves(a_tree), tree_leaves(b_tree)
    return len(a) == len(b) and all(torch.equal(x.cpu() if x.device !=
                                                y.device else x, y)
                                    for x, y in zip(a, b))


def p7_reduced(torch, chk: Checks, steps, parallel, mesh) -> None:
    """(b) each reduced LM's sharded step on the (1, 1) mesh against the
    unsharded step on the card, bit for bit."""
    for arch in P7_REDUCED:
        sd = steps.build_step(arch, "train_4k", reduced=True, mesh=mesh)
        plain = steps.build_step(arch, "train_4k", reduced=True)
        params, state, batch = sd.init_args()
        p0, s0, b0 = plain.init_args()
        pspec, ospec = sd.in_shardings[0], sd.in_shardings[1]
        same_init = p7_same(torch, parallel.gather_tree(params, pspec, mesh),
                            p0) and p7_same(torch, batch, b0)
        got, want = [], []
        for _ in range(P7_STEPS):
            m = sd.fn(params, state, batch)
            m0 = plain.fn(p0, s0, b0)
            got.append((float(m["loss"]), float(m["grad_norm"])))
            want.append((float(m0["loss"]), float(m0["grad_norm"])))
        same = got == want and p7_same(
            torch, parallel.gather_tree(params, pspec, mesh), p0)
        for key in ("mu", "nu"):
            same &= p7_same(torch, parallel.gather_tree(
                state[key], ospec[key], mesh), s0[key])
        chk.ok(same_init and same,
               f"{sd.name} (reduced) on a (1, 1) mesh: init_args gathered "
               f"== the unsharded init {same_init}; {P7_STEPS} steps "
               f"(losses {[round(l, 5) for l, _ in got]}) bit-equal to the "
               f"unsharded step in losses, norms, parameters and moments: "
               f"{same}")
        del params, state, batch, p0, s0, b0
    torch.cuda.empty_cache()


def p7_run(torch, sd):
    """``sd``'s init and one untimed step, then `P7_STEPS` timed ones: (the
    state, the losses and norms, the step times, the peak memory)."""
    torch.cuda.reset_peak_memory_stats()
    params, state, batch = sd.init_args()
    metrics, times = [], []
    for i in range(P7_STEPS + 1):
        m, ms = sync_ms(torch, lambda: sd.fn(params, state, batch))
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
        if i:
            times.append(ms)
    peak = torch.cuda.max_memory_allocated() / 1e9
    return params, state, metrics, times, peak


def p7_full(torch, chk: Checks, steps, parallel, mesh, arch: str,
            layers: int, card: str) -> dict:
    """(c) ``arch`` at full width and ``layers`` layers: the unsharded
    step, its state copied to the host, then the sharded one on the (1, 1)
    mesh, gathered leaf by leaf against the copy."""
    from repro_torch.utils import tree_leaves, tree_map

    cfg = lm_config(steps, arch, "train_4k", layers)
    accum = steps.lm_accum(cfg, False)
    seq = steps.get_arch(arch).shapes["train_4k"]["seq_len"]
    kw = dict(cfg_override={"n_layers": layers},
              shape_override={"global_batch": accum})
    plain = steps.build_step(arch, "train_4k", **kw)
    params, state, m0, t0, peak0 = p7_run(torch, plain)
    n_params = sum(t.numel() for t in tree_leaves(params))
    host = {k: tree_map(lambda t: t.cpu(), v) for k, v in
            (("params", params), ("mu", state["mu"]), ("nu", state["nu"]))}
    del params, state
    torch.cuda.empty_cache()
    sd = steps.build_step(arch, "train_4k", mesh=mesh, **kw)
    params, state, m1, t1, peak1 = p7_run(torch, sd)
    pspec, ospec = sd.in_shardings[0], sd.in_shardings[1]
    same = m0 == m1
    for key, tree, spec in (("params", params, pspec),
                            ("mu", state["mu"], ospec["mu"]),
                            ("nu", state["nu"], ospec["nu"])):
        same &= p7_same(torch, parallel.gather_tree(tree, spec, mesh),
                        host[key])
    del params, state, host
    torch.cuda.empty_cache()
    full = lm_config(steps, arch, "train_4k", None).n_layers
    ms0, ms1 = float(np.mean(t0)), float(np.mean(t1))
    rec = {"layers": layers, "params_b": n_params / 1e9, "accum": accum,
           "plain_step_ms": t0, "sharded_step_ms": t1,
           "overhead": ms1 / ms0, "plain_peak_gb": peak0,
           "sharded_peak_gb": peak1, "losses": [l for l, _ in m1],
           "bit_equal": bool(same)}
    chk.ok(same and all(np.isfinite([l for l, _ in m1])),
           f"{sd.name} at {layers} of {full} layers ({n_params / 1e9:.3f}B "
           f"float32 parameters, {accum} x {seq:,} tokens a step) on a (1, 1) "
           f"mesh: steps {[round(t, 1) for t in t1]} ms beside the "
           f"unsharded {[round(t, 1) for t in t0]} ms (x{ms1 / ms0:.3f}, "
           f"host clock, synchronized), peak {peak1:.2f} GB beside "
           f"{peak0:.2f} GB, losses {[round(l, 4) for l, _ in m1]}, "
           f"{P7_STEPS + 1} steps bit-equal to the unsharded ones (losses, "
           f"norms, parameters, moments): {same} [{card}]")
    return rec


def p7_serve_reduced(torch, chk: Checks, steps, parallel, mesh) -> None:
    """(d) each reduced LM's serving steps on the (1, 1) mesh against the
    unsharded ones on the card, bit for bit."""
    for arch, shapes in P7_SERVE:
        for shape in ("prefill_32k",) + shapes:
            sd = steps.build_step(arch, shape, reduced=True, mesh=mesh)
            plain = steps.build_step(arch, shape, reduced=True)
            args, want_args = sd.init_args(), plain.init_args()
            same_init = p7_same(torch, parallel.gather_tree(
                args[0], sd.in_shardings[0], mesh), want_args[0]) and \
                p7_same(torch, args[1:3], want_args[1:3]) and \
                args[3:] == want_args[3:]       # (tokens[, cache], pos)
            got, want = sd.fn(*args), plain.fn(*want_args)
            chk.ok(same_init and p7_same(torch, got, want),
                   f"{sd.name} (reduced) on a (1, 1) mesh: init_args "
                   f"gathered == the unsharded init {same_init}; logits "
                   f"{tuple(got[0].shape)} and cache bit-equal to the "
                   f"unsharded step: {p7_same(torch, got, want)}")
            del args, want_args, got, want
    torch.cuda.empty_cache()


def p7_serve_full(torch, chk: Checks, steps, parallel, mesh,
                  card: str) -> dict:
    """(d) `P7_SERVE_FULL`'s prefill and decode at full width and a cut
    depth: the unsharded step, then the sharded one on the (1, 1) mesh
    (each warmed up, then one prefill, or 3 decode steps by CUDA events,
    the peak memory of each), logits and caches bit-equal."""
    arch, layers, pb, db = P7_SERVE_FULL
    rec = {"layers": layers}
    for shape, batch in (("prefill_32k", pb), ("decode_32k", db)):
        kw = dict(cfg_override={"n_layers": layers},
                  shape_override={"global_batch": batch})
        sds = {"plain": steps.build_step(arch, shape, **kw),
               "sharded": steps.build_step(arch, shape, mesh=mesh, **kw)}
        args = {k: sd.init_args() for k, sd in sds.items()}
        same_init = p7_same(torch, parallel.gather_tree(
            args["sharded"][0], sds["sharded"].in_shardings[0], mesh),
            args["plain"][0])
        outs, ms, peak = {}, {}, {}
        for k, sd in sds.items():
            a = args[k]
            if shape == "prefill_32k":
                sd.fn(a[0], a[1][:, :2048])           # cuBLAS warm-up
                torch.cuda.reset_peak_memory_stats()
                outs[k], ms[k] = sync_ms(torch, lambda: sd.fn(*a))
            else:
                torch.cuda.reset_peak_memory_stats()
                outs[k] = sd.fn(*a)
                ms[k] = timed(torch, lambda: sd.fn(*a), 3, 0)
            peak[k] = torch.cuda.max_memory_allocated() / 1e9
        same = p7_same(torch, outs["sharded"], outs["plain"])
        tag = shape.split("_")[0]
        rec.update({f"{tag}_batch": batch, f"{tag}_plain_ms": ms["plain"],
                    f"{tag}_sharded_ms": ms["sharded"],
                    f"{tag}_plain_peak_gb": peak["plain"],
                    f"{tag}_sharded_peak_gb": peak["sharded"],
                    f"{tag}_bit_equal": bool(same and same_init)})
        how = ("one call, host clock, synchronized" if tag == "prefill"
               else "a step, CUDA events, 3 steps")
        chk.ok(same and same_init,
               f"{sds['sharded'].name} at {layers} layers, full width, batch "
               f"{batch}, on a (1, 1) mesh: init_args gathered == the "
               f"unsharded init {same_init}; logits and cache bit-equal to "
               f"the unsharded step {same}; {ms['sharded']:.2f} ms beside "
               f"{ms['plain']:.2f} ({how}), peak {peak['sharded']:.2f} GB "
               f"beside {peak['plain']:.2f} GB [{card}]")
        del sds, args, outs
        torch.cuda.empty_cache()
    return rec


def p7_tree(model):
    return model if isinstance(model, dict) else model.tree()


def p7_call(sd, args):
    """One call of a recsys or GAT step: a training step's metrics and the
    parameters and state it updated in place, else its outputs."""
    out = sd.fn(*args)
    if sd.name.endswith(":train"):
        return [out, p7_tree(args[0]), args[1]]
    return out


def p7_pair(torch, K, sds: dict, args: dict) -> tuple:
    """``p7_call`` of the unsharded and the sharded step, each timed on
    the host clock (synchronized): (outputs, ms, the sharded step's
    embedding_bag launches)."""
    outs, ms = {}, {}
    for k in ("plain", "sharded"):
        K.reset_launch_counts()
        outs[k], ms[k] = sync_ms(torch, lambda: p7_call(sds[k], args[k]))
        if k == "sharded":
            launches = K.embedding_bag.launches
    return outs, ms, launches


def p7_same_init(torch, parallel, mesh, sds: dict, args: dict) -> bool:
    sd = sds["sharded"]
    return p7_same(torch, parallel.gather_tree(
        p7_tree(args["sharded"][0]), sd.in_shardings[0], mesh),
        p7_tree(args["plain"][0])) and p7_same(torch, args["sharded"][1:],
                                               args["plain"][1:])


def p7_rs_reduced(torch, chk: Checks, K, steps, parallel, mesh) -> int:
    """(e) every reduced recsys and GAT cell on the (1, 1) mesh against
    the unsharded step on the card, bit for bit; returns the sharded
    steps' embedding_bag launches."""
    total = 0
    cells = [(a, s) for a in P7_RS for s in P7_RS_SHAPES] + [
        ("gat-cora", s) for s in P7_GNN_SHAPES]
    for arch, shape in cells:
        sds = {"plain": steps.build_step(arch, shape, reduced=True),
               "sharded": steps.build_step(arch, shape, reduced=True,
                                           mesh=mesh)}
        args = {k: sd.init_args() for k, sd in sds.items()}
        same_init = p7_same_init(torch, parallel, mesh, sds, args)
        outs, _, n = p7_pair(torch, K, sds, args)
        total += n
        same = p7_same(torch, outs["sharded"], outs["plain"])
        chk.ok(same_init and same and (n > 0 or arch in ("bert4rec",
                                                         "gat-cora")),
               f"{sds['sharded'].name} (reduced) on a (1, 1) mesh: "
               f"init_args gathered == the unsharded init {same_init}; "
               f"outputs bit-equal to the unsharded step {same}; "
               f"embedding_bag launches {n}")
        del sds, args, outs
    torch.cuda.empty_cache()
    return total


def p7_rs_full(torch, chk: Checks, K, steps, parallel, mesh,
               card: str) -> tuple:
    """(e) Wide & Deep, MIND and BERT4Rec at full width (`P7_RS_FULL`) and
    ``ogb_products`` (one step): the unsharded and the sharded step from
    their own seeded init, bit for bit and timed.  Returns (record, the
    sharded steps' embedding_bag launches)."""
    rec, total = {}, 0
    archs, shapes = P7_RS_FULL
    cells = [(a, s) for a in archs for s in shapes] + [("gat-cora",
                                                        "ogb_products")]
    for arch, shape in cells:
        sds = {"plain": steps.build_step(arch, shape),
               "sharded": steps.build_step(arch, shape, mesh=mesh)}
        args = {k: sd.init_args() for k, sd in sds.items()}
        same_init = p7_same_init(torch, parallel, mesh, sds, args)
        outs, ms, n = p7_pair(torch, K, sds, args)
        total += n
        same = p7_same(torch, outs["sharded"], outs["plain"])
        name = sds["sharded"].name
        rec[name] = {"plain_ms": ms["plain"], "sharded_ms": ms["sharded"],
                     "bit_equal": bool(same and same_init), "launches": n}
        chk.ok(same_init and same,
               f"{name} at full width on a (1, 1) mesh: init_args gathered "
               f"== the unsharded init {same_init}; outputs bit-equal to "
               f"the unsharded step {same}; {ms['sharded']:.2f} ms beside "
               f"{ms['plain']:.2f} (one call, host clock, synchronized); "
               f"embedding_bag launches {n} [{card}]")
        del sds, args, outs
        torch.cuda.empty_cache()
    return rec, total


def p7_dlrm(torch, chk: Checks, K, steps, parallel, mesh, card: str) -> tuple:
    """(e) DLRM at the full MLPerf tables, one copy of the 48.07 GB table
    on the card: the sharded model over the unsharded model's tree (at (1,
    1) the table's block is the table itself, the MLPs copied);
    ``serve_bulk`` and ``retrieval_cand`` against the unsharded forward,
    bit for bit; a sharded ``train_batch`` step whose loss equals the
    unsharded loss of its batch, computed before the step.  Returns
    (record, the sharded steps' embedding_bag launches)."""
    from repro_torch.models import recsys as rs

    train = {k: steps.build_step("dlrm-mlperf", "train_batch",
                                 mesh=mesh if k == "sharded" else None)
             for k in ("plain", "sharded")}
    model, _, batch = train["plain"].init_args()
    cfg = model.cfg
    shard = rs.from_tree("dlrm-mlperf", cfg, parallel.shard_tree(
        model.tree(), train["sharded"].in_shardings[0], mesh))
    one_copy = shard.table.data_ptr() == model.table.data_ptr()
    rng = np.random.default_rng(SEED)
    b = steps.get_arch("dlrm-mlperf").shapes["serve_bulk"]["batch"]
    serve_batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in
                   steps._rs_batch("dlrm-mlperf", cfg, b, rng,
                                   "rs_serve").items()}
    c = steps.get_arch("dlrm-mlperf").shapes["retrieval_cand"]["n_candidates"]
    vmax = min(cfg.vocab_sizes)
    query = {k: torch.from_numpy(v).to(DEVICE) for k, v in {
        "dense": rng.normal(size=(1, cfg.n_dense)).astype(np.float32),
        "sparse": rng.integers(0, vmax, (1, cfg.n_sparse)).astype(np.int32),
        "cand_ids": rng.integers(0, vmax, (c,)).astype(np.int32)}.items()}
    rec, total = {"one_table_copy": one_copy}, 0
    for shape, inputs in (("serve_bulk", serve_batch),
                          ("retrieval_cand", query)):
        sds = {k: steps.build_step("dlrm-mlperf", shape,
                                   mesh=mesh if k == "sharded" else None)
               for k in ("plain", "sharded")}
        args = {"plain": (model, inputs), "sharded": (shard, inputs)}
        outs, ms, n = p7_pair(torch, K, sds, args)
        total += n
        same = p7_same(torch, outs["sharded"], outs["plain"])
        rec[shape] = {"plain_ms": ms["plain"], "sharded_ms": ms["sharded"],
                      "bit_equal": bool(same), "launches": n}
        chk.ok(same and one_copy and n > 0,
               f"{sds['sharded'].name} at the full MLPerf tables on a (1, 1) "
               f"mesh, one copy of the table ({one_copy}): outputs bit-equal "
               f"to the unsharded forward {same}; {ms['sharded']:.2f} ms "
               f"beside {ms['plain']:.2f} (one call, host clock, "
               f"synchronized); embedding_bag launches {n} [{card}]")
        del outs
    with torch.no_grad():
        want = rs.dlrm_loss(model, batch)
    state = steps.train_optimizer().init(shard.tree())
    K.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    m, ms = sync_ms(torch, lambda: train["sharded"].fn(shard, state, batch))
    n = K.embedding_bag.launches
    total += n
    peak = torch.cuda.max_memory_allocated() / 1e9
    same = bool(torch.equal(m["loss"], want))
    rec["train_batch"] = {"sharded_ms": ms, "loss": float(m["loss"]),
                          "loss_equal": same, "launches": n, "peak_gb": peak}
    chk.ok(same and n > 0 and bool(torch.isfinite(m["loss"])),
           f"{train['sharded'].name} at the full MLPerf tables on a (1, 1) "
           f"mesh: the sharded step's loss {float(m['loss']):.6f} equal to "
           f"the unsharded loss of its batch {float(want):.6f}: {same}; "
           f"{ms:.2f} ms (one step, host clock, synchronized), peak "
           f"{peak:.2f} GB; embedding_bag launches {n} [{card}]")
    del model, shard, state, batch, serve_batch, query, m, want
    torch.cuda.empty_cache()
    return rec, total


def p7_recsys_gat(torch, chk: Checks, K, steps, parallel, mesh,
                  card: str) -> dict:
    """(e): `p7_rs_reduced`, `p7_rs_full` and `p7_dlrm`; the record with
    the sharded steps' embedding_bag launches (``bag_launches``)."""
    t = time.perf_counter()
    n = p7_rs_reduced(torch, chk, K, steps, parallel, mesh)
    full, n_full = p7_rs_full(torch, chk, K, steps, parallel, mesh, card)
    dlrm, n_dlrm = p7_dlrm(torch, chk, K, steps, parallel, mesh, card)
    return {"full_width": full, "dlrm": dlrm,
            "bag_launches": {"reduced": n, "full width": n_full,
                             "dlrm": n_dlrm},
            "seconds": time.perf_counter() - t}


def p7_ops(chk: Checks, parallel, gat: bool) -> dict:
    """The sequence-parallel ops of (b)-(d) (the reference's ``act_btd``)
    and, with (e), the GAT's node-row ops, by their forward calls in this
    phase: each must have run (a copy through NCCL at world size 1)."""
    ops = dict(parallel.OP_COUNTS)
    want = ("gather_seq", "scatter_seq", "last_token") + (
        ("to_edges", "node_scatter") if gat else ())
    chk.ok(all(ops.get(k, 0) > 0 for k in want),
           f"sequence-parallel and node-row ops run by the sharded steps of "
           f"(b)-(e), forward calls: {ops}")
    return ops


def phase_distributed(torch, chk: Checks, card: str, K=None) -> dict:
    """Phase 7: the distributed layer and the sharded LM training and
    serving steps, then (with the kernels' module ``K``) the sharded
    recsys and GAT steps, on one card, under NCCL at world size 1."""
    import os
    import tempfile
    import warnings

    import torch.distributed as dist

    from repro_torch.distributed import parallel
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import steps

    print("phase 7: the distributed layer, the sharded train_4k step, the "
          "sharded serving steps and the sharded recsys and GAT steps (the "
          "residual stream cut along the sequence, the GAT's hidden node "
          "rows over the data ranks), NCCL at world size 1, deterministic "
          "algorithms")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    rec = {}
    with tempfile.TemporaryDirectory() as tmp, \
            warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        dist.init_process_group(
            "nccl", init_method=f"file://{tmp}/store", rank=0, world_size=1,
            device_id=torch.device("cuda", torch.cuda.current_device()))
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            mesh = mesh_mod.make_host_mesh()
            chk.ok(dist.get_backend() == "nccl"
                   and tuple(mesh.shape) == (1, 1)
                   and mesh.device_type == "cuda",
                   f"NCCL process group, make_host_mesh {tuple(mesh.shape)} "
                   f"{mesh.mesh_dim_names} on {mesh.device_type}")
            rec["collectives"] = p7_collectives(torch, chk, mesh, card)
            parallel.OP_COUNTS.clear()
            p7_reduced(torch, chk, steps, parallel, mesh)
            for arch, layers in P7_FULL.items():
                rec[arch] = p7_full(torch, chk, steps, parallel, mesh,
                                    arch, layers, card)
            t = time.perf_counter()
            p7_serve_reduced(torch, chk, steps, parallel, mesh)
            rec["serving"] = p7_serve_full(torch, chk, steps, parallel,
                                           mesh, card)
            rec["serving"]["seconds"] = time.perf_counter() - t
            if K is not None:
                rec["recsys_gat"] = p7_recsys_gat(torch, chk, K, steps,
                                                  parallel, mesh, card)
            rec["seq_node_ops"] = p7_ops(chk, parallel, K is not None)
        finally:
            torch.use_deterministic_algorithms(False)
            dist.destroy_process_group()
    kinds = sorted({str(w.message).split(".")[0][:120] for w in caught
                    if "determinis" in str(w.message)})
    chk.note(f"operations without a deterministic implementation: {kinds}")
    return rec


# --------------------------------------------------------------------------- #
# phase 8                                                                      #
# --------------------------------------------------------------------------- #
P8_BUDGET_MB = 512
P8_SVC_Q = 256                 # (b): queries of the compacted op's batch
P8_PEAK_N = 8192               # (d): the peaks' matmul side
P8_COPY_BYTES = 4 << 30        # (d): the device-to-device copy


def host_cpu() -> str:
    """The host CPU's model (lscpu's, else /proc/cpuinfo's) and the threads
    torch uses on it."""
    import platform

    import torch

    model = ""
    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True,
                             check=True).stdout
        for line in out.splitlines():
            if line.strip().startswith("Model name:"):
                model = line.split(":", 1)[1].strip()
                break
    except (OSError, subprocess.CalledProcessError):
        pass
    if not model or model.lower() == "unknown":
        # the model name may be hidden in a virtual machine: name the
        # vendor, family and model numbers instead
        fields = {}
        try:
            for line in Path("/proc/cpuinfo").read_text().splitlines():
                k, _, v = line.partition(":")
                fields.setdefault(k.strip().lower(), v.strip())
        except OSError:
            pass
        name = fields.get("model name", "")
        model = name if name and name.lower() != "unknown" else " ".join(
            f"{k} {fields[k]}" for k in ("vendor_id", "cpu family", "model")
            if fields.get(k))
    model = f"{model or 'unnamed'} ({platform.machine()})"
    return f"{model}, {os.cpu_count()} cores, {torch.get_num_threads()} " \
        "torch threads"


def csr_band_agree(index, a, b, xs64, hn64, q, radius) -> tuple:
    """(rows equal, pairs differing, pairs outside the float32 band): two
    CSR results over the same queries may differ only in pairs inside the
    rounding band, and their common pairs keep the same order."""
    if np.array_equal(a.indptr, b.indptr) \
            and np.array_equal(a.indices, b.indices):
        return a.m, 0, 0
    qi, ids, same_rows = [], [], 0
    for i in range(a.m):
        ra = a.indices[a.indptr[i]:a.indptr[i + 1]]
        rb = b.indices[b.indptr[i]:b.indptr[i + 1]]
        if np.array_equal(ra, rb):
            same_rows += 1
            continue
        diff = np.setxor1d(ra, rb)
        if not np.array_equal(ra[~np.isin(ra, diff)], rb[~np.isin(rb, diff)]):
            return same_rows, -1, -1
        qi += [i] * diff.size
        ids += diff.tolist()
    inband, _ = pair_band(index, xs64, hn64, q, radius, np.asarray(qi),
                          np.asarray(ids, np.int64))
    return same_rows, len(ids), 0 if inband else len(ids)


def host_lane(torch, chk: Checks, snn, engine, index, q, radius, card_csr,
              xs64, hn64, cpu: str, card: str) -> dict:
    """(a) the engine's host lane (``oracle=True``) on the index's arrays on
    the host: compacted, pruned, and the dense executor past its budget."""
    from repro_torch.kernels import ops as ops_mod

    rec = {}
    rows = np.random.default_rng(SEED + 2).choice(q.shape[0],
                                                  min(N_ORACLE, q.shape[0]),
                                                  replace=False)
    t = time.perf_counter()
    pack = index.pack(512, "cpu")
    chk.note(f"the index's plan on the host: {time.perf_counter() - t:.2f} s "
             f"(set-up)")
    looped = []
    real_run_csr = engine.run_csr

    def spy(*a, **k):
        looped.append(k.get("memory_budget_mb"))
        return real_run_csr(*a, **k)

    def dense():
        xq, aq, r, th, qsq = snn.prepare_query_predicates(index, q, radius)
        qp, aqp, rp, thp, m = ops_mod.pad_queries(xq, aq, r, th, tq=128,
                                                  bucket=True)
        with mock.patch.object(engine, "run_csr", spy):
            out = engine.run_csr_packed(pack, qp, aqp, rp, thp, m,
                                        oracle=True,
                                        memory_budget_mb=P8_BUDGET_MB)
        indptr, counts, ids, dh = out
        return snn.csr_finalize(index, indptr, ids, dh, xq, qsq, counts, True)

    oracle = oracle_rows(index, xs64, hn64, q[rows], radius)
    runs = (("compacted", lambda: snn.query_radius_csr(
                index, q, radius, device="cpu", oracle=True)),
            ("pruned", lambda: snn.query_radius_csr(
                index, q, radius, device="cpu", oracle=True,
                compacted=False)),
            (f"dense, memory_budget_mb={P8_BUDGET_MB}", dense))
    for name, fn in runs:
        engine.DISPATCH_STATS.reset()
        t = time.perf_counter()
        res = fn()
        s = time.perf_counter() - t
        stats = engine.DISPATCH_STATS.snapshot()
        same, differ, outside = csr_band_agree(index, res, card_csr, xs64,
                                               hn64, q, radius)
        band, equal, bad = compare_with_oracle(index, res, rows, xs64, hn64,
                                               q, radius, oracle)
        rec[name] = {"s": s, "nnz": int(res.nnz), "rows_equal": same,
                     "pairs_differing": differ,
                     "launches": stats["kernel_launches"],
                     "host_transfers": stats["host_transfers"]}
        chk.ok(differ >= 0 and outside == 0 and bad == 0,
               f"host lane {name}: {s:.2f} s (host clock) [{cpu}; {card}], "
               f"{res.nnz} pairs, {stats['kernel_launches']} launches; "
               f"{same} of {q.shape[0]} rows equal to the card's CSR, "
               f"{differ} pairs differing, all inside the float32 band; "
               f"{len(rows)} sampled rows vs float64: {equal} equal, {band} "
               f"in the band, {bad} outside")
    need = N_QUERIES * pack.n_pad * 4 / 2**20
    chk.ok(looped == [P8_BUDGET_MB],
           f"the dense executor's filter ({need:.0f} MB) passes "
           f"memory_budget_mb={P8_BUDGET_MB}: it took the looped host path "
           f"({len(looped)} call), whose pass-1 filter is not cached "
           f"({rec[runs[2][0]]['launches']} filter launches)")
    return rec


def compacted_on_card(torch, chk: Checks, K, ref, ops_mod, snn, engine,
                      index, q, radius, xs64, hn64) -> dict:
    """(b) `snn_csr_compacted_stacked` on CUDA tensors against the stacked
    kernels on the same pack and queries; a ``ccap`` or ``nnz_cap`` set
    too small is detected and rerun."""
    from repro_torch.kernels import registry

    qb = q[:P8_SVC_Q]
    pack = index.pack(512, DEVICE)
    xs, al, hn, ids = pack.stacked()
    px = pack.stacked_projs()
    xq, aq, r, th, _ = snn.prepare_query_predicates(index, qb, radius)
    qp, aqp, rp, thp, m = ops_mod.pad_queries(xq, aq, r, th, tq=128)
    pq = ops_mod.pad_components(snn.query_extra_projections(index, xq),
                                qp.shape[0])
    dev = [torch.from_numpy(np.ascontiguousarray(a)).to(DEVICE)
           for a in (qp, aqp, rp, thp, pq)]
    args = dev[:4] + [xs, al, hn, dev[4], px]
    per, part = registry.snn_count_stacked(*args, bn=pack.block,
                                           with_partials=True)
    _, indptr_k, offsets = ref.stacked_prefix(per)
    total = int(indptr_k[-1])
    fi_k, _ = registry.snn_compact_stacked(
        *args[:4], offsets, *args[4:], nnz=ops_mod.csr_capacity(total),
        bn=pack.block, partials=part)
    torch.cuda.synchronize()
    t = time.perf_counter()
    probe = ops_mod.snn_csr_compacted_stacked(*args, ptile=16, ccap=128,
                                              nnz_cap=128)
    torch.cuda.synchronize()
    cand_max, total_probe = int(probe[4]), int(probe[3])
    ccap = ops_mod.csr_capacity(cand_max)
    tries = [(128, 128, cand_max > 128 or total_probe + 1 > 128)]
    small = ops_mod.snn_csr_compacted_stacked(
        *args, ptile=16, ccap=ccap, nnz_cap=ops_mod.csr_capacity(total) // 4)
    tries.append((ccap, ops_mod.csr_capacity(total) // 4,
                  int(small[3]) + 1 > ops_mod.csr_capacity(total) // 4))
    out = ops_mod.snn_csr_compacted_stacked(
        *args, ptile=16, ccap=ccap, nnz_cap=ops_mod.csr_capacity(total))
    torch.cuda.synchronize()
    s = time.perf_counter() - t
    indptr_c = out[0].cpu().numpy()[:m + 1].astype(np.int64)
    tot_c = int(indptr_c[-1])
    fi_c = out[1][:tot_c].cpu().numpy()
    flat_ids = ids.reshape(-1)
    a = SimpleNamespace(indptr=indptr_c, indices=flat_ids[fi_c], m=m)
    ik = indptr_k.cpu().numpy()[:m + 1].astype(np.int64)
    b = SimpleNamespace(indptr=ik, indices=flat_ids[
        fi_k[:int(ik[-1])].cpu().numpy()], m=m)
    same, differ, outside = csr_band_agree(index, a, b, xs64, hn64, qb,
                                           radius)
    chk.ok(all(bad for _, _, bad in tries) and int(out[4]) <= ccap
           and tot_c + 1 <= ops_mod.csr_capacity(total),
           f"snn_csr_compacted_stacked on the card: ccap=128 and nnz_cap="
           f"{tries[1][1]} detected as too small (cand_max {cand_max}, total "
           f"{int(small[3])}), rerun at ccap={ccap}, nnz_cap="
           f"{ops_mod.csr_capacity(total)}; {(s * 1e3):.1f} ms for the three "
           f"(host clock, synchronized)")
    chk.ok(differ >= 0 and outside == 0,
           f"snn_csr_compacted_stacked == the stacked kernels on the same "
           f"pack ({m} queries, {xs.shape[1]:,} rows): {same} of {m} rows "
           f"equal, {differ} pairs differing, all inside the float32 band "
           f"({tot_c} and {int(ik[-1])} pairs)")
    return {"cand_max": cand_max, "ccap": ccap, "pairs": tot_c,
            "kernel_pairs": int(ik[-1]), "s": s}


def card_step(torch, steps, arch: str, layers: int) -> dict:
    """The sharded ``train_4k`` step of ``arch`` at ``layers`` layers on a
    (1, 1) mesh on the card (NCCL at world size 1): one untimed step, one
    under FlopCounterMode, one timed; flops, peak memory and step time."""
    import os
    import tempfile

    import torch.distributed as dist
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch import mesh as mesh_mod

    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    cfg = lm_config(steps, arch, "train_4k", layers)
    kw = dict(cfg_override={"n_layers": layers},
              shape_override={"global_batch": steps.lm_accum(cfg, False)})
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl", init_method=f"file://{tmp}/store", rank=0, world_size=1,
            device_id=torch.device("cuda", torch.cuda.current_device()))
        try:
            sd = steps.build_step(arch, "train_4k",
                                  mesh=mesh_mod.make_host_mesh(), **kw)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            params, state, batch = sd.init_args()
            sd.fn(params, state, batch)
            counter = FlopCounterMode(display=False)
            with counter:
                sd.fn(params, state, batch)
            _, ms = sync_ms(torch, lambda: sd.fn(params, state, batch))
            peak = torch.cuda.max_memory_allocated()
            del params, state, batch
        finally:
            dist.destroy_process_group()
    torch.cuda.empty_cache()
    return {"flops": float(counter.get_total_flops()), "peak_bytes": peak,
            "step_ms": ms, "kw": kw}


# the production cells of (c): minicpm3-4b's 40 MLA heads over "model" 16
# split unevenly (the traced rank holds three)
P8_PRODUCTION = (("internlm2-20b", "train_4k"), ("minicpm3-4b", "train_4k"),
                 ("snn-service", "svc_10m"))


def production_dryruns(out_dir: str):
    """Start the dry-run of each `P8_PRODUCTION` cell at (16, 16) and
    (2, 16, 16) in one process of its own on the CPU (a fake process group
    each, records under ``out_dir``): it traces on one core while (a)
    runs.  Returns the process and its log's path."""
    code = ("import sys; from repro_torch.launch import dryrun\n"
            f"for arch, shape in {P8_PRODUCTION!r}:\n"
            "    for mp in (False, True):\n"
            "        dryrun.run_cell(arch, shape, multi_pod=mp, "
            f"out_dir={out_dir!r})\n")
    log = Path(out_dir) / "dryrun.log"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    with open(log, "w") as f:
        proc = subprocess.Popen([sys.executable, "-c", code], stdout=f,
                                stderr=subprocess.STDOUT, env=env, cwd=ROOT)
    return proc, log


def dryrun_vs_card(torch, chk: Checks, card: str) -> dict:
    """(c) the dry-run at a (1, 1) mesh against the same step on the
    card."""
    from repro_torch.launch import dryrun, steps

    out = {}
    for arch, layers in P7_FULL.items():
        got = card_step(torch, steps, arch, layers)
        rec = dryrun.run_cell(arch, "train_4k", mesh_shape=(1, 1),
                              fit_lm=False, verbose=False, **got["kw"])
        rel = abs(rec["flops_per_device"] - got["flops"]) / got["flops"]
        mem = abs(rec["peak_memory_bytes"] - got["peak_bytes"]) \
            / got["peak_bytes"]
        ratio = got["step_ms"] / (1e3 * rec["roofline_step_time_s"])
        out[arch] = {"layers": layers, "card_flops": got["flops"],
                     "dryrun_flops": rec["flops_per_device"],
                     "card_peak_bytes": got["peak_bytes"],
                     "dryrun_peak_bytes": rec["peak_memory_bytes"],
                     "step_ms": got["step_ms"],
                     "roofline_ms": 1e3 * rec["roofline_step_time_s"],
                     "t_compute_ms": 1e3 * rec["t_compute_s"],
                     "t_memory_ms": 1e3 * rec["t_memory_s"],
                     "t_collective_ms": 1e3 * rec["t_collective_s"],
                     "bottleneck": rec["bottleneck"]}
        chk.ok(rel <= 0.01 and mem <= 0.15,
               f"dry-run of {arch} train_4k at {layers} layers, (1, 1): "
               f"{rec['flops_per_device']:.4e} flops beside "
               f"FlopCounterMode's {got['flops']:.4e} on the card (rel "
               f"{rel:.2e}), peak {rec['peak_memory_bytes'] / 1e9:.2f} GB "
               f"beside max_memory_allocated {got['peak_bytes'] / 1e9:.2f} "
               f"GB (rel {mem:.3f})")
        chk.note(f"{arch}: step {got['step_ms']:.1f} ms measured (host "
                 f"clock, synchronized) against the roofline's "
                 f"{1e3 * rec['roofline_step_time_s']:.1f} ms (x{ratio:.2f}): "
                 f"compute {1e3 * rec['t_compute_s']:.1f} ms, memory "
                 f"{1e3 * rec['t_memory_s']:.1f} ms (every op's bytes, "
                 f"unfused), collective {1e3 * rec['t_collective_s']:.3f} ms,"
                 f" bottleneck {rec['bottleneck']} [{card}]")
    return out


def production_estimates(chk: Checks, proc, log: Path, card: str) -> dict:
    """(c) the production meshes' records of `production_dryruns`."""
    try:
        rc = proc.wait(timeout=300)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = "killed after 300 s"
    out = {}
    chk.ok(rc == 0, f"the production dry-runs' process exited {rc} "
           f"(its log: {log.read_text()[-400:]!r})" if rc else
           "the production dry-runs' process exited 0")
    for arch, shape in P8_PRODUCTION:
        for mp in (False, True):
            suffix = "multi" if mp else "single"
            name = (f"{arch}__{shape}__{suffix}"
                    + ("__snn" if arch == "snn-service" else "") + ".json")
            path = log.parent / name
            if not path.exists():
                chk.ok(False, f"dry-run record {name} written")
                continue
            rec = json.loads(path.read_text())
            key = f"{arch}:{shape}:{'x'.join(map(str, rec['mesh']))}"
            out[key] = {k: rec.get(k) for k in (
                "flops_per_device", "hbm_bytes_per_device",
                "collective_bytes_per_device", "collective_breakdown",
                "peak_memory_bytes", "t_compute_s", "t_memory_s",
                "t_collective_s", "bottleneck", "roofline_step_time_s",
                "mfu_at_roofline", "window_fraction", "compile_s",
                "trace_s", "skipped")}
            if "skipped" in rec:
                chk.ok(False, f"dry-run {key}: skipped, {rec['skipped']}")
                continue
            chk.ok(bool(rec["bottleneck"]),
                   f"dry-run {key}: estimates from the data sheet's "
                   f"constants, compute {1e3 * rec['t_compute_s']:.2f} ms, "
                   f"memory {1e3 * rec['t_memory_s']:.2f} ms, collective "
                   f"{1e3 * rec['t_collective_s']:.2f} ms, bottleneck "
                   f"{rec['bottleneck']}, peak "
                   f"{rec['peak_memory_bytes'] / 1e9:.2f} GB a rank, "
                   f"MFU at the roofline {rec['mfu_at_roofline']:.3f} (not "
                   f"measured; printed beside {card})")
    return out


def card_peaks(torch, chk: Checks, card: str) -> dict:
    """(d) the card's peaks, measured: bf16 and FP32 (no TF32) matmuls of
    side `P8_PEAK_N`, and a 4 GiB device-to-device copy."""
    from repro_torch.launch import hlo_analysis as hlo

    n = P8_PEAK_N
    out = {}
    for name, dtype, sheet in (("bf16", torch.bfloat16, hlo.PEAK_FLOPS),
                               ("fp32", torch.float32,
                                hlo.PEAK_FLOPS_FP32)):
        a = torch.randn(n, n, device=DEVICE, dtype=dtype)
        b = torch.randn(n, n, device=DEVICE, dtype=dtype)
        ms = timed(torch, lambda: torch.matmul(a, b), reps=10, warmup=3)
        rate = 2.0 * n ** 3 / (ms / 1e3)
        out[name] = {"ms": ms, "flops_per_s": rate, "sheet": sheet}
        chk.ok(rate > 0.2 * sheet,
               f"{name} {n}^3 torch.matmul: {ms:.3f} ms, {rate / 1e12:.1f} "
               f"TFLOP/s beside the data sheet's {sheet / 1e12:.0f} "
               f"({rate / sheet:.2f}) [{card}]")
        del a, b
    src = torch.empty(P8_COPY_BYTES, dtype=torch.uint8, device=DEVICE)
    dst = torch.empty_like(src)
    ms = timed(torch, lambda: dst.copy_(src), reps=10, warmup=2)
    rate = 2.0 * P8_COPY_BYTES / (ms / 1e3)
    out["copy"] = {"ms": ms, "bytes_per_s": rate, "sheet": hlo.HBM_BW}
    chk.ok(rate > 0.2 * hlo.HBM_BW,
           f"4 GiB device-to-device copy: {ms:.3f} ms, {rate / 1e12:.2f} "
           f"TB/s read and written beside the data sheet's "
           f"{hlo.HBM_BW / 1e12:.2f} ({rate / hlo.HBM_BW:.2f}) [{card}]")
    del src, dst
    torch.cuda.empty_cache()
    return out


def phase_host_and_dryrun(torch, chk: Checks, K, ref, ops_mod, snn, engine,
                          card: str) -> dict:
    """Phase 8: the engine's host lane and the candidate-compacted op on
    the SIFT-1M stand-in, the dry-run against the card, the card's
    peaks."""
    import tempfile

    cpu = host_cpu()
    print(f"phase 8: the host lane and the dry-run (host: {cpu})")
    with tempfile.TemporaryDirectory() as tmp:
        proc, log = production_dryruns(tmp)
        try:
            rec = host_and_card(torch, chk, K, ref, ops_mod, snn, engine,
                                cpu, card)
            t = time.perf_counter()
            rec["dryrun"].update(production_estimates(chk, proc, log, card))
            chk.note(f"(c) production records waited for "
                     f"{time.perf_counter() - t:.1f} s")
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return rec


def host_and_card(torch, chk: Checks, K, ref, ops_mod, snn, engine,
                  cpu: str, card: str) -> dict:
    """Phase 8's (a), (b), (c) at (1, 1) and (d), in that order."""
    x = sift_standin(N_ROWS, DIM, SEED)
    q = sift_standin(N_QUERIES, DIM, SEED + 1)
    index = snn.build_index(x, device=DEVICE)
    radius = calibrate_radius(torch, index, q)
    card_csr = snn.query_radius_csr(index, q, radius, device=DEVICE)
    xs64 = index.xs.cpu().numpy().astype(np.float64)
    hn64 = 0.5 * np.einsum("ij,ij->i", xs64, xs64)
    rec = {"radius": radius, "host": cpu}
    t = time.perf_counter()
    rec["host_lane"] = host_lane(torch, chk, snn, engine, index, q, radius,
                                 card_csr, xs64, hn64, cpu, card)
    chk.note(f"(a) took {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    rec["compacted_stacked"] = compacted_on_card(
        torch, chk, K, ref, ops_mod, snn, engine, index, q, radius, xs64,
        hn64)
    chk.note(f"(b) took {time.perf_counter() - t:.1f} s")
    del index, x, xs64, hn64, card_csr
    torch.cuda.empty_cache()
    t = time.perf_counter()
    rec["dryrun"] = dryrun_vs_card(torch, chk, card)
    chk.note(f"(c) took {time.perf_counter() - t:.1f} s")
    rec["peaks"] = card_peaks(torch, chk, card)
    return rec


def ptxas_table(log: str, nvcc: str) -> dict:
    """{kernel: {"registers", "smem_bytes" (static), "spill_stores",
    "spill_loads"}} from nvcc's ``-Xptxas -v`` output, the names demangled
    with the toolkit's cu++filt where it has one."""
    table, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            table[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            table[name].update(spill_stores=int(m[1]), spill_loads=int(m[2]))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            smem = re.search(r"(\d+) bytes smem", line)
            table[name].update(registers=int(m[1]),
                               smem_bytes=int(smem[1]) if smem else 0)
    names = list(table)
    try:
        out = subprocess.run([str(Path(nvcc).with_name("cu++filt"))],
                             input="\n".join(names), capture_output=True,
                             text=True, check=True).stdout.splitlines()
    except (OSError, subprocess.CalledProcessError):
        out = names
    short = {}
    for mangled, plain in zip(names, out):
        m = (re.search(r"\w+_kernel(<[^>]*>)?", plain) if plain != mangled
             else re.search(r"[a-z_]+_kernel(I\w+?E)?", mangled))
        short[m.group(0) if m else mangled] = table[mangled]
    return short


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
    if not (ROOT / "src" / "repro_torch").is_dir():
        # the script copied alone, without the port beside it
        print(f"chip_smoke: no src/repro_torch beside {Path(__file__).name};"
              " run it from a checkout of the repository", file=sys.stderr)
        return 1
    # full float32 in every PyTorch product: the kernels' comparisons and
    # the recsys models' MLPs, whose float64 check refuses TF32 (the
    # package leaves these switches to its caller)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import engine, graph, snn
    from repro_torch.kernels import ops as ops_mod
    from repro_torch.kernels import ref
    from repro_torch.kernels import snn_query as K

    # the package exports functions named `join` and `dbscan`, which shadow
    # the modules of those names
    join = importlib.import_module("repro_torch.core.join")
    dbscan = importlib.import_module("repro_torch.core.dbscan")

    card = card_line()

    def clock(label, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        Checks.note(f"{label}: {1e3 * (time.perf_counter() - t):.3f} ms "
                    f"(host clock, synchronized) [{card}]")
        return out

    def phase_done(name, t0):
        print(f"{name} took {time.perf_counter() - t0:.1f} s [{card}]",
              flush=True)
        if chk.failed:
            print(f"FAILED: {chk.failed}", file=sys.stderr)
        return not chk.failed

    t_start = time.perf_counter()
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t = time.perf_counter()
    lib = K.build()
    print(f"build: {lib.relative_to(ROOT)} in {time.perf_counter() - t:.2f} s")
    ptxas = ptxas_table(K.build_log(), K._nvcc())
    for name, v in ptxas.items():
        print(f"  {name}: {v.get('registers')} registers, "
              f"{v.get('smem_bytes')} B static shared memory, spills "
              f"{v.get('spill_stores')} B stored / {v.get('spill_loads')} B "
              "loaded")
    chk = Checks()
    t = time.perf_counter()
    phase_kernels(torch, chk, K, ref, ops_mod)
    phase_bag_lattice(torch, chk, K, ref, ops_mod)
    if not phase_done("phase 1", t):
        return 1
    t = time.perf_counter()
    (index, x, q, radius, launches, looped_main, xs64, hn64,
     csr) = phase_main_path(torch, chk, K, snn, engine, join, clock)
    if not phase_done("phase 2", t):
        return 1
    t = time.perf_counter()
    g_launches, looped_graph, eps, g_shape, plain, t_plain, gd = phase_graph(
        torch, chk, K, ref, snn, engine, join, graph, dbscan, ops_mod, x,
        clock)
    if not phase_done("phase 2b", t):
        return 1
    t = time.perf_counter()
    front = phase_sharded(torch, chk, K, ref, snn, engine, join, graph,
                          index, q, radius, eps, csr, gd, plain, t_plain,
                          xs64, hn64, clock)
    degrees = np.diff(plain.indptr)
    del plain, csr
    torch.cuda.empty_cache()
    if not phase_done("phase 2d", t):
        return 1
    t = time.perf_counter()
    front.update(phase_front_ends(torch, chk, K, ref, ops_mod, snn, engine,
                                  join, dbscan, index, x, q, radius, gd,
                                  eps, degrees, xs64, hn64, clock))
    del degrees
    if not phase_done("phase 2c", t):
        return 1
    t = time.perf_counter()
    kernels = phase_times(torch, chk, K, ref, ops_mod, snn, engine, index, q,
                          radius, launches)
    for rec in kernels:
        by_path = {"query_radius_csr": rec["launches"],
                   "build_neighbor_graph": g_launches[rec["name"]]}
        rec.update(launches=sum(by_path.values()), launches_by_path=by_path,
                   graph_shape=g_shape[rec["name"]])
    kernels += phase_times_single(torch, chk, K, ref, ops_mod, snn, engine,
                                  index, q, radius, xs64, hn64, gd, eps,
                                  (looped_main, looped_graph), ptxas)
    del gd
    for rec in kernels:
        for path, counts in front.items():
            if counts.get(rec["name"]):
                rec["launches_by_path"][path] = counts[rec["name"]]
                rec["launches"] += counts[rec["name"]]
    if not phase_done("phase 3", t):
        return 1
    t = time.perf_counter()
    serving = phase_serving(torch, chk, K, engine, index, x, q, radius, xs64,
                            hn64, clock)
    for rec in kernels:
        if serving.get(rec["name"]):
            rec["launches_by_path"]["serving"] = serving[rec["name"]]
            rec["launches"] += serving[rec["name"]]
    if not phase_done("phase 3b", t):
        return 1
    del index, x, q, xs64, hn64
    torch.cuda.empty_cache()
    t = time.perf_counter()
    Checks.note(f"device memory held before phase 4: "
                f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB")
    bag_launches, bag_paths, breakdown, ra = phase_recsys(torch, chk, K, ref,
                                                          snn, clock)
    for rec in kernels:
        if rec["name"] in ra:
            rec["launches_by_path"]["retrieve_above"] = ra[rec["name"]]
            rec["launches"] += ra[rec["name"]]
    main_bag = bag_paths["dlrm-mlperf:serve_bulk:serve full-vocabulary"]
    kernels.append({
        "name": "embedding_bag", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/embedding_bag.cu",
        "replaces": "src/repro/kernels/embedding_bag.py:41",
        "launches": sum(bag_launches.values()),
        "launches_by_path": bag_launches, **main_bag["bags"]["lookup"],
        "paths": bag_paths, "device_breakdown": breakdown})
    if not phase_done("phase 4", t):
        return 1
    t = time.perf_counter()
    train_launches, train_recs = phase_recsys_train(torch, chk, K, ref,
                                                    clock)
    bag = kernels[-1]
    bag["launches_by_path"].update(train_launches)
    bag["launches"] += sum(train_launches.values())
    bag["training_and_ranking"] = train_recs
    if not phase_done("phase 4b", t):
        return 1
    t = time.perf_counter()
    Checks.note(f"device memory held before phase 5: "
                f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB")
    lm = phase_lm(torch, chk, card)
    print("phase 5 record: " + json.dumps(lm))
    if not phase_done("phase 5", t):
        return 1
    t = time.perf_counter()
    Checks.note(f"device memory held before phase 6: "
                f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB")
    training = phase_training(torch, chk, card)
    print("phase 6 record: " + json.dumps(training))
    if not phase_done("phase 6", t):
        return 1
    t = time.perf_counter()
    Checks.note(f"device memory held before phase 7: "
                f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB")
    distributed = phase_distributed(torch, chk, card, K)
    print("phase 7 record: " + json.dumps(distributed))
    if not phase_done("phase 7", t):
        return 1
    bag = next(r for r in kernels if r["name"] == "embedding_bag")
    for part, n in distributed["recsys_gat"]["bag_launches"].items():
        bag["launches_by_path"][f"sharded recsys steps (phase 7 (e), "
                                f"{part})"] = n
        bag["launches"] += n
    t = time.perf_counter()
    host = phase_host_and_dryrun(torch, chk, K, ref, ops_mod, snn, engine,
                                 card)
    print("phase 8 record: " + json.dumps(host))
    if not phase_done("phase 8", t):
        return 1
    for rec in kernels:
        base = {"snn_count": "snn_count_stacked",
                "snn_compact": "snn_compact_stacked"}.get(rec["name"],
                                                          rec["name"])
        prefixes = (BAG_KERNELS if base == "embedding_bag"
                    else (f"{base}_kernel",))
        rec["ptxas"] = {k: v for k, v in ptxas.items()
                        if k.startswith(prefixes)}
    print(f"run: {time.perf_counter() - t_start:.1f} s [{card}]")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
