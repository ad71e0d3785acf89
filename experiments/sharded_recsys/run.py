"""The sharded recsys and GAT steps across the cards of one host.

    torchrun --standalone --nproc-per-node 4 experiments/sharded_recsys/run.py \
        [--parts dlrm gat] [--meshes 1x4 2x2 4x1] [--gat-meshes 4x1 2x2] \
        [--steps 3] [--out sharded_recsys.json]

    torchrun --standalone --nproc-per-node 4 experiments/sharded_recsys/run.py \
        --device cpu --reduced          # a rehearsal: gloo, the reduced configs

Each rank joins one NCCL group (torchrun's rendezvous on this host) on its
own card and, for each mesh (data x model):

* ``dlrm``: DLRM at the full MLPerf tables (187,767,424 x 128 bfloat16,
  48.07 GB).  Every rank makes the unsharded model from the seeded init
  (the whole table on its card, as one card holds it) and computes on it
  the one-card loss of ``train_batch``'s 65,536 samples (and on the first
  mesh ``serve_bulk``'s 262,144 outputs and ``retrieval_cand``'s top 100
  of 1,000,000 candidates), then cuts its shards
  (``parallel.shard_tree``, the table's row block copied, the unsharded
  model freed) and runs the sharded steps
  (``build_step(..., mesh=...)``): on the first mesh the serving and
  retrieval steps against the one-card outputs, then one untimed and
  ``--steps`` timed training steps (host clock, every card synchronized
  and the ranks at a barrier before each step), the first loss against
  the one-card loss;
* ``gat``: ``gat-cora`` ``ogb_products`` (2,449,029 nodes, 64,308,169
  edges with the self loops): every rank runs the unsharded step on the
  whole graph from the seeded init (its loss, gradient norm and updated
  parameters), then the sharded step (the edges over the data ranks, and
  between layers its block of the padded node rows) from the same init
  and batch, one untimed and ``--steps`` timed.

Rank 0 prints one JSON line per part and mesh: the step times, every
card's peak memory, the losses beside the one-card ones and their
relative gaps, the card's name and power limit; ``--out`` also writes the
lines there.  ``--device cpu --reduced`` runs the same over gloo on the
CPU at the reduced configs.  Imports no JAX.
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

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.distributed import parallel  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import recsys as rs  # noqa: E402
from repro_torch.utils import tree_leaves, tree_map  # noqa: E402


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout
    return out.strip().splitlines()[0]


class Run:
    """The device, its synchronization and the peak memory of each card."""

    def __init__(self, device: str):
        self.device = device
        self.cuda = device == "cuda"

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def reset_peak(self):
        if self.cuda:
            torch.cuda.reset_peak_memory_stats()

    def peaks(self) -> list:
        peak = torch.tensor([torch.cuda.max_memory_allocated() / 1e9
                             if self.cuda else 0.0], device=self.device)
        out = [torch.zeros_like(peak) for _ in range(dist.get_world_size())]
        dist.all_gather(out, peak)
        return [float(p) for p in out]

    def timed(self, fn):
        dist.barrier()
        self.sync()
        t = time.perf_counter()
        out = fn()
        self.sync()
        return out, 1e3 * (time.perf_counter() - t)

    def free(self):
        if self.cuda:
            torch.cuda.empty_cache()


def rel(got: float, want: float) -> float:
    return abs(got - want) / max(abs(want), 1e-30)


def mesh_of(shape: tuple, run: Run):
    return init_device_mesh(run.device, shape,
                            mesh_dim_names=("data", "model"))


def dlrm(shape: tuple, n_steps: int, run: Run, reduced: bool,
         serve: bool) -> dict:
    """DLRM ``train_batch`` (and with ``serve`` its ``serve_bulk`` and
    ``retrieval_cand``) on a mesh of ``shape`` against one card."""
    mesh = mesh_of(shape, run)
    kw = dict(reduced=reduced)
    sds = {k: steps.build_step("dlrm-mlperf", k, mesh=mesh, **kw)
           for k in ("train_batch", "serve_bulk", "retrieval_cand")}
    plain = {k: steps.build_step("dlrm-mlperf", k, **kw) for k in sds}
    run.reset_peak()
    t = time.perf_counter()
    model, _, batch = plain["train_batch"].init_args(device=run.device)
    run.sync()
    init_s = time.perf_counter() - t
    rec = {"part": "dlrm", "mesh": list(shape), "init_s": init_s,
           "table_gb": model.table.numel() * 2 / 1e9}
    with torch.no_grad():
        want_loss = float(rs.dlrm_loss(model, batch))
    outs = {}
    if serve:
        # serve_bulk's batch (its step's own draw) and one user's query
        sbatch = {k: torch.from_numpy(v).to(run.device) for k, v in
                  steps._rs_batch("dlrm-mlperf", model.cfg,
                                  _bulk(reduced), _rng(), "rs_serve").items()}
        query = _query(model.cfg, reduced, run.device)
        (want_out, rec["one_card_serve_ms"]) = run.timed(
            lambda: plain["serve_bulk"].fn(model, sbatch))
        (want_top, rec["one_card_retrieval_ms"]) = run.timed(
            lambda: plain["retrieval_cand"].fn(model, query))
        outs = {"serve": want_out, "top": want_top}
    shard = rs.from_tree("dlrm-mlperf", model.cfg, parallel.shard_tree(
        model.tree(), sds["train_batch"].in_shardings[0], mesh))
    del model
    run.free()
    rec["local_table_gb"] = shard.table.numel() * 2 / 1e9
    if serve:
        rows = parallel.data_rows(sbatch["dense"].shape[0], 1, shape[0],
                                  mesh.get_coordinate()[0])
        local = {k: v[rows] for k, v in sbatch.items()}
        got, rec["serve_ms"] = run.timed(
            lambda: sds["serve_bulk"].fn(shard, local))
        rec["serve_rel"] = float((got.float() - outs["serve"].float()).abs()
                                 .max() / outs["serve"].float().abs().max())
        crow = parallel.data_rows(query["cand_ids"].shape[0], 1, shape[0],
                                  mesh.get_coordinate()[0])
        lq = {**query, "cand_ids": query["cand_ids"][crow]}
        top, rec["retrieval_ms"] = run.timed(
            lambda: sds["retrieval_cand"].fn(shard, lq))
        rec["top100_equal"] = bool(torch.equal(top[1], outs["top"][1]))
        rec["top100_vals_equal"] = bool(torch.equal(top[0], outs["top"][0]))
        del got, top, outs, sbatch, local, lq, query
    rows = parallel.data_rows(batch["dense"].shape[0], 1, shape[0],
                              mesh.get_coordinate()[0])
    local = {k: v[rows] for k, v in batch.items()}
    state = steps.train_optimizer().init(shard.tree())
    losses, times = [], []
    for i in range(n_steps + 1):
        m, ms = run.timed(lambda: sds["train_batch"].fn(shard, state, local))
        losses.append(float(m["loss"]))
        if i:
            times.append(ms)
    rec.update({"one_card_loss": want_loss, "losses": losses,
                "first_loss_rel": rel(losses[0], want_loss),
                "step_ms": times, "samples_per_s": batch["dense"].shape[0]
                / (sum(times) / len(times) / 1e3),
                "peak_gb": run.peaks()})
    del shard, state, batch, local
    run.free()
    return rec


def _rng():
    import numpy as np

    return np.random.default_rng(steps.SEED)


def _bulk(reduced: bool) -> int:
    return 8 if reduced else steps.get_arch("dlrm-mlperf").shapes[
        "serve_bulk"]["batch"]


def _query(cfg, reduced: bool, device) -> dict:
    """One user and the candidates (``retrieval_cand``'s draw order)."""
    import numpy as np

    rng = np.random.default_rng(steps.SEED + 1)
    c = 128 if reduced else steps.get_arch("dlrm-mlperf").shapes[
        "retrieval_cand"]["n_candidates"]
    vmax = min(cfg.vocab_sizes)
    q = {"dense": rng.normal(size=(1, cfg.n_dense)).astype(np.float32),
         "sparse": rng.integers(0, vmax, (1, cfg.n_sparse)).astype(np.int32),
         "cand_ids": rng.integers(0, vmax, (c,)).astype(np.int32)}
    return {k: torch.from_numpy(v).to(device) for k, v in q.items()}


def gat(shape: tuple, n_steps: int, run: Run, reduced: bool) -> dict:
    """``ogb_products`` on a mesh of ``shape`` against one card."""
    cell = "full_graph_sm" if reduced else "ogb_products"
    mesh = mesh_of(shape, run)
    plain = steps.build_step("gat-cora", cell, reduced=reduced)
    params, state, batch = plain.init_args(device=run.device)
    m0, one_ms = run.timed(lambda: plain.fn(params, state, batch))
    want = {"loss": float(m0["loss"]), "grad_norm": float(m0["grad_norm"])}
    want_params = tree_map(lambda t: t.clone(), params)
    del params, state, batch
    run.free()
    sd = steps.build_step("gat-cora", cell, reduced=reduced, mesh=mesh)
    run.reset_peak()
    params, state, batch = sd.init_args(device=run.device)
    metrics, times = [], []
    for i in range(n_steps + 1):
        m, ms = run.timed(lambda: sd.fn(params, state, batch))
        metrics.append({k: float(v) for k, v in m.items()})
        if i == 0:
            gap = max(float((a - b).abs().max() / b.abs().max())
                      for a, b in zip(tree_leaves(params),
                                      tree_leaves(want_params)))
        else:
            times.append(ms)
    rec = {"part": "gat", "cell": cell, "mesh": list(shape),
           "local_edges": int(batch["src"].shape[0]),
           # the padded node rows between layers, over the data ranks
           "local_node_rows": int(batch["x"].shape[0]) // shape[0],
           "one_card": want, "one_card_step_ms": one_ms,
           "metrics": metrics,
           "first_loss_rel": rel(metrics[0]["loss"], want["loss"]),
           "first_grad_norm_rel": rel(metrics[0]["grad_norm"],
                                      want["grad_norm"]),
           "params_after_one_step_rel": gap, "step_ms": times,
           "peak_gb": run.peaks()}
    del params, state, batch, want_params
    run.free()
    return rec


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parts", nargs="+", default=["dlrm", "gat"])
    ap.add_argument("--meshes", nargs="+", default=["1x4", "2x2", "4x1"])
    ap.add_argument("--gat-meshes", nargs="+", default=["4x1", "2x2"])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--reduced", action="store_true")
    args = ap.parse_args()
    local_rank = int(os.environ["LOCAL_RANK"])
    run = Run(args.device)
    if run.cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.cuda.set_device(local_rank)
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
        dist.init_process_group("nccl", timeout=timedelta(minutes=5),
                                device_id=torch.device("cuda", local_rank))
    else:
        torch.set_num_threads(1)
        dist.init_process_group("gloo")
    try:
        card = card_line() if dist.get_rank() == 0 and run.cuda \
            else args.device
        lines = []
        todo = []
        if "dlrm" in args.parts:
            todo += [("dlrm", m, i == 0) for i, m in enumerate(args.meshes)]
        if "gat" in args.parts:
            todo += [("gat", m, False) for m in args.gat_meshes]
        for part, m, first in todo:
            shape = tuple(int(v) for v in m.split("x"))
            rec = (dlrm(shape, args.steps, run, args.reduced, first)
                   if part == "dlrm" else
                   gat(shape, args.steps, run, args.reduced))
            rec["card"] = card
            if dist.get_rank() == 0:
                print(json.dumps(rec), flush=True)
                lines.append(rec)
                if args.out:     # after each mesh: a later one may not fit
                    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
                    Path(args.out).write_text("\n".join(
                        json.dumps(r) for r in lines) + "\n")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
