"""The sharded SNN across the cards of one host: one shard a card over NCCL.

    torchrun --standalone --nproc-per-node 4 experiments/sharded_snn/run.py \
        [--parts sift svc_10m svc_100m] [--out sharded_snn.json]

    torchrun --standalone --nproc-per-node 4 experiments/sharded_snn/run.py \
        --device cpu --reduced          # a rehearsal: gloo, small sizes

Each rank joins one NCCL group (torchrun's rendezvous on this host) on its
own card, and the ranks form ``launch.mesh.make_host_mesh()``, (world, 1)
over ("data", "model"): the database sorted by its first principal
component and cut into contiguous shards along "data", one a card.  The
parts, each checked against one card:

* ``sift``: the SIFT-1M stand-in of ``chip_smoke.py``'s phase 2
  (1,000,000 x 128, m = 1,024, the radius giving about 1,000 neighbours a
  query), built from the same seed on every card.  Every rank first runs
  one card's ``query_radius_csr`` and ``build_neighbor_graph(symmetric=
  False)`` over all 1M rows (eps giving about 30 neighbours a point);
  then ``sharded.shard_index`` over the mesh (a quarter of the rows on
  each card) and the count, percount and top-k functions over NCCL
  against the one-card CSR (counts within the float32 band, percount
  columns summing to the count, top-k sets); and the decomposition,
  ``query_radius_csr_sharded`` (packed twice, classic then fused, then
  ``packed=False``) and ``build_neighbor_graph_sharded`` with the mesh,
  bit-identical to the one-card results on every rank, timed, with the
  live shards a graph chunk.
* ``svc_10m``: ``launch.snn_cell.build_service_step("svc_10m", mesh=...)``
  at D = world, both ``prune`` variants: rank 0 seeds the 10,485,760 x
  128 rows on its card as phase 2d does and builds the index, and
  broadcasts the sorted arrays; each rank's shard is a run of the one-card
  stack's 65,536-row chunks, so the counts must equal the one-card step
  on the same arrays bit for bit, and the float64 brute force on phase
  2d's 16 published queries and 64 perturbed data rows (each rank's
  block, summed) within the float32 band.  Timed by CUDA events on the
  published traffic beside the one-card step and a bare ``all_reduce``
  of the counts.
* ``svc_100m``: 100,663,296 x 128 (51.54 GB), which no card holds with
  its build's copies.  Rank 0 seeds the rows on its card a block at a
  time into host memory, builds the index on the host
  (``snn.build_index(..., device="cpu")``, every core) and sends each
  rank its shard (``sharded.shard_block``: cut without a padded copy of
  the index) through NCCL, one at a time; the float64 brute force runs
  on each card over its block.  Skipped, with the reason recorded, when
  the host's available memory cannot hold the build (four copies of the
  rows: raw, centred, sorted and the half norms' square).

Rank 0 prints one JSON line a part with the card's name and power limit;
``--out`` also writes the lines there, after each part.  ``--device cpu
--reduced`` runs the same over gloo on the CPU at small sizes.  Imports
no JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.core import engine, graph, sharded, snn  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch import snn_cell  # noqa: E402

SVC_CHUNK = 65536
GRAPH_NEIGHBOURS = 30
SHARD_TOPK = 1024
# sizes: the full cells, and the rehearsal's
SIZES = {False: dict(n=cs.N_ROWS, m=cs.N_QUERIES, target=cs.TARGET_NEIGHBOURS,
                     svc_10m=None, svc_100m=None, gen_rows=1 << 22),
         True: dict(n=12_000, m=128, target=50,
                    svc_10m=dict(n=8 * SVC_CHUNK, m=128),
                    svc_100m=dict(n=12 * SVC_CHUNK, m=128), gen_rows=1 << 16)}


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout
    return out.strip().splitlines()[0]


class Run:
    """The rank's device, mesh and sizes, and its timing helpers."""

    def __init__(self, device: str, reduced: bool):
        self.cuda = device == "cuda"
        self.reduced = reduced
        self.size = SIZES[reduced]
        self.mesh = mesh_mod.make_host_mesh(device_type=device)
        self.rank, self.world = dist.get_rank(), dist.get_world_size()
        self.dev = sharded._mesh_device(self.mesh)
        self.group = self.mesh.get_group("data")
        from repro_torch.kernels import snn_query
        self.K = snn_query

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def host_ms(self, fn):
        """(fn(), the slowest rank's ms on the host clock), every rank at a
        barrier before it and synchronized."""
        dist.barrier()
        self.sync()
        t = time.perf_counter()
        out = fn()
        self.sync()
        ms = torch.tensor([1e3 * (time.perf_counter() - t)], device=self.dev)
        dist.all_reduce(ms, op=dist.ReduceOp.MAX)
        return out, float(ms)

    def event_ms(self, fn, reps: int) -> float:
        """Mean ms of ``fn()`` by CUDA events (the host clock on the CPU),
        after a warm-up call and a barrier."""
        fn()
        dist.barrier()
        if self.cuda:
            return cs.timed(torch, fn, reps, warmup=0)
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        return 1e3 * (time.perf_counter() - t) / reps

    def every_rank(self, flag: bool) -> bool:
        """``flag`` held on every rank."""
        t = torch.tensor([int(bool(flag))], device=self.dev)
        dist.all_reduce(t, op=dist.ReduceOp.MIN)
        return bool(t.item())

    def total(self, a: np.ndarray) -> np.ndarray:
        """An int64 array summed over the ranks."""
        t = torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(self.dev)
        dist.all_reduce(t)
        return t.cpu().numpy()

    def peaks(self) -> list:
        peak = torch.tensor([torch.cuda.max_memory_allocated() / 1e9
                             if self.cuda else 0.0], device=self.dev)
        out = [torch.zeros_like(peak) for _ in range(self.world)]
        dist.all_gather(out, peak)
        return [float(p) for p in out]

    def reset_peak(self):
        if self.cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()

    def launches(self) -> dict:
        return {k: getattr(self.K, k).launches for k in cs.SNN_KERNELS}

    def bcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """``t`` (on rank ``src``; an empty tensor of its shape and dtype
        elsewhere) on every rank's device."""
        t = t.to(self.dev).contiguous()
        dist.broadcast(t, src)
        return t


def tap_live():
    """Record the live segments of each graph chunk (`engine._live_idx`);
    returns (the list, a function that undoes the tap)."""
    live, fn = [], engine._live_idx

    def tap(*a, **k):
        out = fn(*a, **k)
        live.append(out.size)
        return out
    engine._live_idx = tap
    return live, lambda: setattr(engine, "_live_idx", fn)


def topk_sets(index, q, radius, csr, ids, rows) -> tuple:
    """The top-k lists (-1 padding dropped) against the CSR rows as sets,
    on the ``rows`` whose count fits k: (pairs that differ, all inside the
    float32 band)."""
    xs64 = index.xs.double().cpu().numpy()
    hn64 = 0.5 * np.einsum("ij,ij->i", xs64, xs64)
    qi, diff_ids = [], []
    for i in rows:
        d = np.setxor1d(ids[i][ids[i] >= 0],
                        csr.indices[csr.indptr[i]:csr.indptr[i + 1]])
        qi += [i] * d.size
        diff_ids += d.tolist()
    if not diff_ids:
        return 0, True
    return len(diff_ids), bool(cs.pair_band(
        index, xs64, hn64, q, radius, np.asarray(qi, np.int64),
        np.asarray(diff_ids, np.int64))[0])


def part_sift(run: Run) -> dict:
    sz, mesh, dev = run.size, run.mesh, run.dev
    x = cs.sift_standin(sz["n"], cs.DIM, cs.SEED)
    q = cs.sift_standin(sz["m"], cs.DIM, cs.SEED + 1)
    index, build_ms = run.host_ms(lambda: snn.build_index(x, device=dev))
    sums = torch.stack([index.xs.double().sum(), index.alphas.double().sum(),
                        torch.tensor(float(np.sum(index.order[:1000] *
                                                  np.arange(1000))),
                                     dtype=torch.float64, device=dev)])
    got = [torch.zeros_like(sums) for _ in range(run.world)]
    dist.all_gather(got, sums)
    rec = {"part": "sift", "n": index.n, "d": cs.DIM, "m": sz["m"],
           "build_index_ms": build_ms,
           "index_same_on_every_rank": all(torch.equal(g, got[0])
                                           for g in got)}
    # rank 0's radius and eps on every rank
    radius = cs.calibrate_radius(torch, index, q, sz["target"])
    rng = np.random.default_rng(cs.SEED + 3)
    sample = rng.choice(index.n, 64, replace=False)
    eps = cs.calibrate_radius(torch, index, x[sample], GRAPH_NEIGHBOURS)
    re = run.bcast(torch.tensor([radius, eps], dtype=torch.float64))
    radius, eps = float(re[0]), float(re[1])
    rec.update(radius=radius, eps=eps)

    # one card
    csr, rec["one_card_csr_ms"] = run.host_ms(
        lambda: snn.query_radius_csr(index, q, radius, device=dev))
    gkw = dict(index=index, query_chunk=cs.QUERY_CHUNK, device=dev)
    plain, rec["one_card_graph_ms"] = run.host_ms(
        lambda: graph.build_neighbor_graph(x, eps, segment_rows=cs.SEGMENT_ROWS,
                                           **gkw))
    rec.update(csr_nnz=int(csr.nnz), graph_nnz=int(plain.nnz))

    # the collectives over NCCL, one shard a card
    shard = sharded.shard_index(index, mesh)
    rec["shard_rows"] = int(shard[0].shape[0])
    qa = sharded.prepare_query_arrays(index, q, radius)
    cnt = sharded.make_sharded_count_fn(mesh)
    pct = sharded.make_sharded_percount_fn(mesh)
    top = sharded.make_sharded_topk_fn(mesh, SHARD_TOPK)
    run.K.reset_launch_counts()
    count, rec["count_ms"] = run.host_ms(lambda: cnt(*shard[:3], *qa))
    per, rec["percount_ms"] = run.host_ms(lambda: pct(*shard[:3], *qa))
    (ids, dh), rec["topk_ms"] = run.host_ms(lambda: top(*shard, *qa))
    rec["collective_launches"] = run.launches()
    counts = np.diff(csr.indptr)
    got = count.cpu().numpy()
    ok, band = cs.counts_in_band(torch, index, q, radius, got, counts)
    per = per.cpu().numpy()
    rows = np.nonzero(counts <= SHARD_TOPK)[0]
    n_diff, in_band = topk_sets(index, q, radius, csr, ids.cpu().numpy(),
                                rows)
    dh = dh.cpu().numpy()
    rec["count_equal_queries"] = int(np.sum(got == counts))
    rec["count_band_pairs"] = band
    rec["count_in_band"] = run.every_rank(ok and count.dtype == torch.int32)
    rec["percount_shape"] = list(per.shape)
    rec["percount_sums_to_count"] = run.every_rank(
        per.shape == (run.world, counts.size)
        and np.array_equal(per.sum(0), got))
    rec["topk_rows"], rec["topk_pairs_differing"] = int(rows.size), n_diff
    # each shard's list ascending, the lists in rank order
    rec["topk_sets_in_band"] = run.every_rank(
        in_band and ids.shape[1] == run.world * SHARD_TOPK
        and bool(np.all(np.diff(dh.reshape(dh.shape[0], run.world, -1),
                                axis=2) >= 0)))
    del shard, ids, dh

    # the decomposition: every segment on this rank's card
    pack, rec["mesh_pack_ms"] = run.host_ms(lambda: sharded.mesh_pack(index,
                                                                      mesh))
    run.K.reset_launch_counts()
    runs = []
    for tag in ("classic", "fused"):
        engine.DISPATCH_STATS.reset()
        c, rec[f"sharded_csr_{tag}_ms"] = run.host_ms(
            lambda: sharded.query_radius_csr_sharded(index, mesh, q, radius,
                                                     pack=pack))
        runs.append(c)
        rec[f"sharded_csr_{tag}_dispatch"] = engine.DISPATCH_STATS.snapshot()
    looped, rec["sharded_csr_looped_ms"] = run.host_ms(
        lambda: sharded.query_radius_csr_sharded(index, mesh, q, radius,
                                                 packed=False))
    rec["sharded_csr_launches"] = run.launches()
    rec["sharded_csr_bit_identical_every_rank"] = run.every_rank(
        all(cs.same_csr(c, csr) for c in runs + [looped]))
    del pack, runs, looped
    live, undo = tap_live()
    run.K.reset_launch_counts()
    try:
        g, rec["sharded_graph_ms"] = run.host_ms(
            lambda: graph.build_neighbor_graph_sharded(x, mesh, eps, **gkw))
    finally:
        undo()
    rec["sharded_graph_launches"] = run.launches()
    live = np.asarray(live)
    rec["live_shards_a_chunk"] = {"min": int(live.min()),
                                  "mean": float(live.mean()),
                                  "max": int(live.max()),
                                  "chunks": int(live.size)}
    rec["sharded_graph_bit_identical_every_rank"] = run.every_rank(
        np.array_equal(g.indptr, plain.indptr)
        and np.array_equal(g.indices, plain.indices))
    # every rank computed the same graph: a checksum of it, gathered
    h = torch.tensor([float(np.sum(g.indices[::7].astype(np.float64))),
                      float(g.nnz)], dtype=torch.float64, device=run.dev)
    hs = [torch.zeros_like(h) for _ in range(run.world)]
    dist.all_gather(hs, h)
    rec["graph_same_on_every_rank"] = all(torch.equal(a, hs[0]) for a in hs)
    rec["peak_gb"] = run.peaks()
    del g, plain, csr, index
    run.reset_peak()
    return rec


def svc_queries(n, d, m, xh_rows, qh, order, scale, seed):
    """Phase 2d's correctness queries: the published traffic with 64 of its
    slots replaced by data rows at even steps through the sorted order,
    slightly perturbed; (queries, the 16 published and 64 perturbed
    slots).  ``xh_rows(ids)`` reads raw data rows."""
    rng = np.random.default_rng(seed)
    slots = rng.permutation(m)
    rows = slots[:cs.N_SVC_ORACLE]
    hit = slots[cs.N_SVC_ORACLE:][:cs.N_SVC_ROWS]
    pos = np.linspace(0, n - 1, cs.N_SVC_ROWS).round().astype(np.int64)
    noise = rng.standard_normal((cs.N_SVC_ROWS, d)).astype(np.float32)
    qc = qh.copy()
    qc[hit] = xh_rows(order[pos]) + 0.01 * noise * scale
    return qc, np.concatenate([rows, hit])


def svc_steps(run: Run, name: str, shard, sq, sc, sel, want, band,
              one_card=None) -> dict:
    """Both ``prune`` variants of ``name``'s sharded step on this rank's
    shard: counts against the float64 brute force (and, with
    ``one_card``, the one-card step on the whole arrays bit for bit),
    timed by CUDA events on the published traffic."""
    out = {}
    reps = 2 if run.reduced else cs.SVC_REPS
    for prune in (True, False):
        fn, specs, flops, _ = snn_cell.build_service_step(
            name, prune=prune, mesh=run.mesh)
        tag = "pruned" if prune else "brute"
        r = {"specs_match": [tuple(t.shape) for t in shard]
             == [sp[0] for sp in specs[:3]]}
        run.K.reset_launch_counts()
        got = fn(*shard, *sc).cpu().numpy()
        pub = fn(*shard, *sq).cpu().numpy()
        r["launches"] = run.launches()["snn_count_stacked"]
        diff = np.abs(got[sel].astype(np.int64) - want)
        r["oracle_pairs"] = int(want.sum())
        r["counted_differently"] = int(diff.sum())
        r["oracle_in_band_every_rank"] = run.every_rank(
            want.sum() > 0 and bool(np.all(diff <= band)))
        r["ms"] = run.event_ms(lambda: fn(*shard, *sq), reps)
        r["mean_neighbours"] = float(pub.mean())
        r["model_flops"] = flops
        if one_card is not None:
            fn1, _, _, _ = snn_cell.build_service_step(name, prune=prune)
            whole = one_card
            got1 = fn1(*whole, *sc).cpu().numpy()
            pub1 = fn1(*whole, *sq).cpu().numpy()
            r["bit_equal_to_one_card_every_rank"] = run.every_rank(
                np.array_equal(got, got1) and np.array_equal(pub, pub1))
            r["one_card_ms"] = run.event_ms(lambda: fn1(*whole, *sq), reps)
        out[tag] = r
    counts = torch.zeros(sq[0].shape[0], dtype=torch.int32, device=run.dev)
    out["all_reduce_ms"] = run.event_ms(
        lambda: dist.all_reduce(counts, group=run.group), reps)
    return out


def oracle_over(run: Run, xs_local, q64, thr64, far_row=None):
    """The float64 brute force over this rank's rows, summed over the
    ranks: (pairs a query, band pairs a query, pairs in rows at or past
    ``far_row`` of a shard)."""
    keep, band = cs.oracle_counts(torch, xs_local, q64, thr64)
    far = 0
    if far_row is not None and xs_local.shape[0] > far_row:
        far = int(cs.oracle_counts(torch, xs_local[far_row:], q64,
                                   thr64)[0].sum())
    return (run.total(keep), run.total(band),
            int(run.total(np.asarray([far]))[0]))


def part_svc_10m(run: Run) -> dict:
    name = "svc_10m"
    sh = dict(snn_cell.SNN_SHAPES[name])
    if run.size["svc_10m"]:
        sh.update(run.size["svc_10m"])
        snn_cell.SNN_SHAPES[name] = sh
    n, d, m, r0, s = sh["n"], sh["d"], sh["m"], sh["radius"], sh["aniso_s"]
    dev = run.dev
    scale = np.full(d, s, np.float32)
    scale[0] = 1.0
    rec = {"part": name, "n": n, "d": d, "m": m, "radius": r0,
           "shards": run.world}
    t = time.perf_counter()
    arrays = [torch.empty((n, d), device=dev), torch.empty(n, device=dev),
              torch.empty(n, device=dev)]
    order = torch.empty(n, dtype=torch.int64, device=dev)
    preds = [torch.empty((m, d), device=dev)] + [
        torch.empty(m, device=dev) for _ in range(3)]
    preds_c = [torch.empty_like(p) for p in preds]
    sel = torch.empty(cs.N_SVC_ORACLE + cs.N_SVC_ROWS, dtype=torch.int64,
                      device=dev)
    q64 = torch.empty((sel.shape[0], d), dtype=torch.float64, device=dev)
    thr64 = torch.empty(sel.shape[0], dtype=torch.float64, device=dev)
    if run.rank == 0:
        # phase 2d's data: seeded on the card, the index built there
        gen = torch.Generator(device=dev).manual_seed(cs.SVC_SEED)
        sc_t = torch.from_numpy(scale).to(dev)
        xd = torch.randn((n, d), generator=gen, device=dev) * sc_t
        qd = torch.randn((m, d), generator=gen, device=dev) * sc_t
        xh, qh = xd.cpu().numpy(), qd.cpu().numpy()
        del xd, qd
        big = snn.build_index(xh, n_components=1, device=dev)
        qc, s_ = svc_queries(n, d, m, lambda ids: xh[ids], qh, big.order,
                             scale, cs.SVC_SEED)
        del xh
        a64, t64 = cs.query64(big, qc[s_], r0)
        arrays = [big.xs, big.alphas, big.half_norms]
        order = torch.from_numpy(big.order).to(dev)
        preds = list(sharded.prepare_query_arrays(big, qh, r0))
        preds_c = list(sharded.prepare_query_arrays(big, qc, r0))
        sel, q64, thr64 = (torch.from_numpy(v) for v in (s_, a64, t64))
        del big
    arrays = [run.bcast(a) for a in arrays]
    order = run.bcast(order).cpu().numpy()
    sq = [run.bcast(p) for p in preds]
    sc = [run.bcast(p) for p in preds_c]
    sel = run.bcast(sel).cpu().numpy()
    q64, thr64 = run.bcast(q64).cpu().numpy(), run.bcast(thr64).cpu().numpy()
    run.sync()
    rec["set_up_s"] = time.perf_counter() - t
    # every rank: the sorted arrays as an index, its shard by shard_index
    index = snn.SNNIndex(np.zeros(d, np.float32), np.zeros(d, np.float32),
                         arrays[0], arrays[1], arrays[2], order)
    shard = sharded.shard_index(index, run.mesh, block=SVC_CHUNK)[:3]
    rec["shard_rows"] = int(shard[0].shape[0])
    rec["shard_chunks"] = rec["shard_rows"] // SVC_CHUNK
    want, band, _ = oracle_over(run, shard[0], q64, thr64)
    rec["oracle_pairs"], rec["band_pairs"] = int(want.sum()), int(band.sum())
    rec["every_perturbed_query_has_a_neighbour"] = bool(
        want[cs.N_SVC_ORACLE:].min() >= 1)
    run.reset_peak()
    rec.update(svc_steps(run, name, shard, sq, sc, sel, want, band,
                         one_card=tuple(arrays)))
    rec["peak_gb"] = run.peaks()
    del shard, index, arrays
    run.reset_peak()
    return rec


def host_memory() -> dict:
    """The host's total and available memory, GB (``/proc/meminfo``)."""
    out = {}
    for line in Path("/proc/meminfo").read_text().splitlines():
        key, val = line.split(":", 1)
        if key in ("MemTotal", "MemAvailable"):
            out[key] = int(val.split()[0]) * 1024 / 1e9
    return out


def part_svc_100m(run: Run) -> dict:
    name = "svc_100m"
    sh = dict(snn_cell.SNN_SHAPES[name])
    if run.size["svc_100m"]:
        sh.update(run.size["svc_100m"])
        snn_cell.SNN_SHAPES[name] = sh
    n, d, m, r0, s = sh["n"], sh["d"], sh["m"], sh["radius"], sh["aniso_s"]
    dev, world = run.dev, run.world
    rows_gb = n * d * 4 / 1e9
    mem = host_memory()
    need = 4 * rows_gb + 8.0
    rec = {"part": name, "n": n, "d": d, "m": m, "radius": r0,
           "shards": world, "rows_gb": rows_gb, "host_memory_gb": mem,
           "host_build_needs_gb": need}
    fits = run.every_rank(mem.get("MemAvailable", 0.0) >= need)
    if not fits:
        rec["skipped"] = (f"the host has {mem.get('MemAvailable', 0.0):.1f} "
                          f"GB available; the host build of {rows_gb:.2f} GB "
                          f"of rows needs about {need:.1f}")
        return rec
    per = n // world
    if n % (world * SVC_CHUNK):
        raise ValueError(f"{n} rows do not cut into {world} shards of "
                         f"{SVC_CHUNK}-row chunks")
    scale = np.full(d, s, np.float32)
    scale[0] = 1.0
    shard = None if run.rank == 0 else [
        torch.empty((per, d), device=dev), torch.empty(per, device=dev),
        torch.empty(per, device=dev)]
    preds = [torch.empty((m, d), device=dev)] + [
        torch.empty(m, device=dev) for _ in range(3)]
    preds_c = [torch.empty_like(p) for p in preds]
    sel = torch.empty(cs.N_SVC_ORACLE + cs.N_SVC_ROWS, dtype=torch.int64,
                      device=dev)
    q64 = torch.empty((sel.shape[0], d), dtype=torch.float64, device=dev)
    thr64 = torch.empty(sel.shape[0], dtype=torch.float64, device=dev)
    t0 = time.perf_counter()
    if run.rank == 0:
        gen = torch.Generator(device=dev).manual_seed(cs.SVC_SEED)
        sc_t = torch.from_numpy(scale).to(dev)
        x = torch.empty((n, d), dtype=torch.float32)
        step = run.size["gen_rows"]
        for c0 in range(0, n, step):
            c1 = min(n, c0 + step)
            x[c0:c1] = (torch.randn((c1 - c0, d), generator=gen, device=dev)
                        * sc_t).cpu()
        qh = (torch.randn((m, d), generator=gen, device=dev)
              * sc_t).cpu().numpy()
        rec["generate_s"] = time.perf_counter() - t0
        threads = torch.get_num_threads()
        torch.set_num_threads(len(os.sched_getaffinity(0)))
        t = time.perf_counter()
        big = snn.build_index(x.numpy(), n_components=1, device="cpu")
        rec["host_build_s"] = time.perf_counter() - t
        rec["host_build_threads"] = torch.get_num_threads()
        torch.set_num_threads(threads)
        xr = x.numpy()
        qc, s_ = svc_queries(n, d, m, lambda ids: xr[ids], qh, big.order,
                             scale, cs.SVC_SEED)
        del x, xr
        a64, t64 = cs.query64(big, qc[s_], r0)
        preds = list(sharded.prepare_query_arrays(big, qh, r0))
        preds_c = list(sharded.prepare_query_arrays(big, qc, r0))
        sel, q64, thr64 = (torch.from_numpy(v) for v in (s_, a64, t64))
        # each rank's shard through NCCL, one at a time
        t = time.perf_counter()
        for k in range(world):
            blk = sharded.shard_block(big, world, k, block=SVC_CHUNK)[:3]
            if k == 0:
                shard = [b.to(dev).contiguous() for b in blk]
                continue
            for b in blk:
                on_card = b.to(dev).contiguous()
                dist.send(on_card, dst=k)
                del on_card
            run.sync()
        rec["send_s"] = time.perf_counter() - t
        del big
    else:
        for b in shard:
            dist.recv(b, src=0)
    sq = [run.bcast(p) for p in preds]
    sc = [run.bcast(p) for p in preds_c]
    sel = run.bcast(sel).cpu().numpy()
    q64, thr64 = run.bcast(q64).cpu().numpy(), run.bcast(thr64).cpu().numpy()
    run.sync()
    dist.barrier()
    rec["set_up_s"] = time.perf_counter() - t0
    rec["shard_rows"] = per
    rec["shard_chunks"] = per // SVC_CHUNK
    rec["shard_gb"] = per * d * 4 / 1e9
    far_row = (1 << 32) // (4 * d)
    want, band, far = oracle_over(run, shard[0], q64, thr64, far_row)
    rec.update(oracle_pairs=int(want.sum()), band_pairs=int(band.sum()),
               pairs_past_byte_2_32_of_a_shard=far,
               every_perturbed_query_has_a_neighbour=bool(
                   want[cs.N_SVC_ORACLE:].min() >= 1))
    run.reset_peak()
    rec.update(svc_steps(run, name, tuple(shard), sq, sc, sel, want, band))
    rec["peak_gb"] = run.peaks()
    del shard
    run.reset_peak()
    return rec


PARTS = {"sift": part_sift, "svc_10m": part_svc_10m,
         "svc_100m": part_svc_100m}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parts", nargs="+", default=list(PARTS))
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--reduced", action="store_true")
    args = ap.parse_args()
    # the host build of svc_100m holds the other ranks at a barrier
    timeout = timedelta(minutes=60)
    if args.device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        local = int(os.environ["LOCAL_RANK"])
        torch.cuda.set_device(local)
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
        dist.init_process_group("nccl", timeout=timeout,
                                device_id=torch.device("cuda", local))
    else:
        torch.set_num_threads(1)
        dist.init_process_group("gloo", timeout=timeout)
        cs.DEVICE = "cpu"
    try:
        if args.device == "cuda":
            # one build of the kernels, then every rank loads it
            from repro_torch.kernels import snn_query
            if dist.get_rank() == 0:
                snn_query.build()
            dist.barrier()
        run = Run(args.device, args.reduced)
        card = card_line() if run.cuda else args.device
        lines = []
        for part in args.parts:
            t = time.perf_counter()
            rec = PARTS[part](run)
            rec["part_s"] = time.perf_counter() - t
            rec["card"] = card
            if run.rank == 0:
                print(json.dumps(rec), flush=True)
                lines.append(rec)
                if args.out:
                    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
                    Path(args.out).write_text("\n".join(
                        json.dumps(r) for r in lines) + "\n")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
