"""The sharded ``train_4k`` step across the cards of one host.

    torchrun --standalone --nproc-per-node 4 experiments/sharded_lm/run.py \
        [--arch llama4-scout-17b-a16e] [--layers 4] [--meshes 2x2 1x4 4x1] \
        [--batch N] [--steps 3] [--out sharded_lm.json]

    torchrun --standalone --nproc-per-node 4 experiments/sharded_lm/run.py \
        --arch nemotron-4-15b --layers 0 --meshes 1x4 2x2   # all 32 layers

    torchrun --standalone --nproc-per-node 4 experiments/sharded_lm/run.py \
        --arch minicpm3-4b --layers 2 --meshes 1x4 --heads 38 \
        --one-card step --f32           # heads "model" does not divide

    torchrun --standalone --nproc-per-node 4 experiments/sharded_lm/run.py \
        --arch nemotron-4-15b --layers 2 --meshes 4x1 --batch 12 \
        --one-card grads --f32          # microbatches of 6 over 4 ranks

    torchrun --standalone --nproc-per-node 4 experiments/sharded_lm/run.py \
        --device cpu --reduced          # a rehearsal: gloo, the reduced config

Each rank joins one NCCL group (torchrun's rendezvous on this host) on its
own card and, for each ``--meshes`` entry (data x model), builds
``launch.steps.build_step(arch, "train_4k", mesh=...)`` at full width and
``--layers`` layers (0: the config's own depth) with a global batch of
``--batch`` sequences of ``--seq`` tokens (4,096
by default; by default one sequence a data rank in each of the config's
microbatches: 8 for an MoE model, 2 dense), makes its
shards with ``init_args`` (one full leaf at a time), runs one untimed step
and ``--steps`` timed ones (host clock, every card synchronized and the
ranks at a barrier before each step).  Rank 0 prints one JSON line per
mesh: the step times, every card's peak memory, the losses and the step-0
loss beside ln V, the card's name and power limit; ``--out`` also writes
the lines there.  At one period of llama4-scout (174 GB of training
state) the (4, 1) mesh fits an 80 GB card only with
``PYTORCH_CUDA_ALLOC_CONF=expandable_segments:True`` in the environment
(75.3 GB at its peak).  A rank that runs out of device memory prints one
JSON line of its own before it fails (``"oom": true``: where, the card's
peak and what was allocated then, the rank's parameter and optimizer
shards among it, the allocator's message) and appends it to
``<--out>.oom``; torchrun then ends the other ranks.  ``--device cpu``
runs the same over gloo on the CPU (with ``--reduced``: the arch's
reduced config, 4 sequences of 32 tokens).

``--heads H [--kv-heads K]`` replaces the published head counts
(`heads.head_override`): 38 MLA heads over a "model" of 4 give its ranks
10, 10, 9 and 9 whole heads, 10 query heads over 2 KV heads 3, 3, 2 and
2, rank 1's reading both KV heads, 2 query heads 1, 1, 0 and 0.  The
splits GSPMD pads: ``--seq 4094`` cuts the sequence over a "model" of 4
into 1,024, 1,024, 1,024 and 1,022 (with ``--chunk-q 2047``: the query
chunk must divide it); ``--batch 12`` gives a dense model's two
microbatches of 6 sequences, 2, 2, 2 and 0 rows over 4 data ranks;
``--dispatch-groups G`` sets an MoE's ``dispatch_groups`` (4,094 tokens a microbatch: gcd(4094, 32) = 2
groups over 4 data ranks); ``--xent-chunk N`` sets the cross-entropy's
tokens a chunk (one card's reference holds a chunk's float32 logits).
``--f32`` computes in float32 (the
parameters are float32 either way).  ``--one-card`` first runs one card's
reference on rank 0 from the same seeded init and batch (the other ranks
wait): ``step``, the unsharded step (its loss and gradient norm),
``grads``, the same loss and norm from the step's ``grad_fn`` (no
optimizer state: half the memory), or ``loss``, the loss alone under
``no_grad`` (a model whose gradients one card cannot hold); the record
then holds the sharded step-0 loss (and norm) beside it.  Imports no
JAX.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT / "src"))

from heads import described, head_override  # noqa: E402
from repro_torch.distributed import parallel  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.utils import tree_leaves  # noqa: E402


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout
    return out.strip().splitlines()[0]


def one_card_reference(arch: str, over: dict, shape: dict, mode: str,
                       device: str, reduced: bool) -> dict:
    """Rank 0's unsharded reference from the step's seeded init and batch:
    ``step`` runs the unsharded step once (loss, gradient norm), ``grads``
    its ``grad_fn`` (the same loss and norm, without optimizer state),
    ``loss`` the loss alone under ``no_grad`` (the parameters alone on the
    card, as `steps.build_step`'s ``init_args`` makes them)."""
    kw = (dict(reduced=True, cfg_override=over) if reduced else
          dict(cfg_override=over, shape_override=shape))
    plain = steps.build_step(arch, "train_4k", **kw)
    if mode in ("step", "grads"):
        params, state, data = plain.init_args(device=device)
        if mode == "grads":
            del state
            loss, grads = plain.grad_fn(params, data)
            gn = torch.sqrt(sum(torch.sum(torch.square(g))
                                for g in tree_leaves(grads)))
            return {"loss": float(loss), "grad_norm": float(gn)}
        m = plain.fn(params, state, data)
        return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}
    batch = shape["global_batch"]
    cfg = dataclasses.replace(
        steps.get_arch(arch).make_config("train_4k", reduced), **over)
    if reduced:
        cfg = dataclasses.replace(cfg, max_seq=64)
    s = plain.arg_specs[2]["tokens"].shape[1]
    gen = torch.Generator(device=device).manual_seed(steps.SEED)
    params = tf.init_params(cfg, generator=gen, device=device)
    rng = np.random.default_rng(steps.SEED)
    tokens = torch.from_numpy(steps._lm_tokens(rng, cfg, (batch, s))).to(
        device)
    labels = torch.from_numpy(steps._lm_tokens(rng, cfg, (batch, s))).to(
        device)
    accum = steps.lm_accum(cfg, reduced)
    mb = batch // accum
    with torch.no_grad():
        total = sum(float(tf.loss_fn(params, {"tokens": tokens[i:i + mb],
                                              "labels": labels[i:i + mb]},
                                     cfg))
                    for i in range(0, batch, mb))
    return {"loss": total / accum if accum > 1 else total}


def run_mesh(arch: str, layers: int, shape: tuple, batch: int,
             n_steps: int, device: str, reduced: bool, over: dict | None = None,
             one_card: str | None = None, seq: int | None = None) -> dict:
    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    mesh = init_device_mesh(device, shape, mesh_dim_names=("data", "model"))
    cfg = steps.get_arch(arch).make_config("train_4k", reduced)
    over = dict(over or {})
    if reduced:
        batch = 4
    else:
        if layers:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        batch = batch or steps.lm_accum(cfg, False) * shape[0]
        over["n_layers"] = cfg.n_layers
    cfg = dataclasses.replace(cfg, **over)
    cell = {"global_batch": batch}
    if seq:
        cell["seq_len"] = seq
    ref = None
    if one_card:
        # before the shards: one card holds the reference alone
        if dist.get_rank() == 0:
            ref = one_card_reference(arch, over, cell, one_card, device,
                                     reduced)
        if cuda:
            torch.cuda.empty_cache()
        dist.barrier()
    if reduced:
        sd = steps.build_step(arch, "train_4k", mesh=mesh, reduced=True,
                              cfg_override=over or None)
    else:
        sd = steps.build_step(arch, "train_4k", mesh=mesh,
                              cfg_override=over, shape_override=cell)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    where, state_gb = "init_args", 0.0
    try:
        t = time.perf_counter()
        params, state, data = sd.init_args(device=device)
        sync()
        init_s = time.perf_counter() - t
        local = sum(p.numel() for p in tree_leaves(params))
        state_gb = sum(t.numel() * t.element_size()
                       for t in tree_leaves((params, state))) / 1e9
        losses, norms, times = [], [], []
        for i in range(n_steps + 1):
            where = f"step {i}"
            dist.barrier()
            sync()
            t = time.perf_counter()
            m = sd.fn(params, state, data)
            sync()
            ms = 1e3 * (time.perf_counter() - t)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            if i:
                times.append(ms)
    except torch.cuda.OutOfMemoryError as e:
        raise OutOfMemory({
            "oom": True, "arch": arch, "layers": cfg.n_layers,
            "mesh": list(shape), "global_batch": batch,
            "rank": dist.get_rank(), "where": where,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "allocated_gb": torch.cuda.memory_allocated() / 1e9,
            "reserved_gb": torch.cuda.memory_reserved() / 1e9,
            "params_and_optimizer_gb": state_gb,
            "error": str(e).splitlines()[0][:400]}) from e
    peak = torch.tensor([torch.cuda.max_memory_allocated() / 1e9
                         if cuda else 0.0], device=device)
    peaks = [torch.zeros_like(peak) for _ in range(dist.get_world_size())]
    dist.all_gather(peaks, peak)
    slowest = torch.tensor([max(times)], device=device)
    dist.all_reduce(slowest, op=dist.ReduceOp.MAX)
    del params, state, data
    if cuda:
        torch.cuda.empty_cache()
    seq_len = sd.arg_specs[2]["tokens"].shape[1]
    data_tokens = batch * seq_len
    mean_ms = sum(times) / len(times)
    accum = steps.lm_accum(cfg, reduced)
    extra = {"heads": described(over), "compute_dtype": str(cfg.dtype),
             "seq_len": seq_len, "chunk_q": cfg.chunk_q,
             # each data rank's rows of a microbatch
             "rows_a_rank": [len(parallel.data_rows(batch, accum, shape[0], r))
                             // accum for r in range(shape[0])]}
    if cfg.moe is not None:
        extra["dispatch_groups"] = cfg.moe.dispatch_groups
    if ref is not None:
        extra["one_card"] = ref
        extra["first_loss_rel"] = abs(losses[0] - ref["loss"]) / abs(
            ref["loss"])
        if "grad_norm" in ref:
            extra["first_grad_norm_rel"] = abs(
                norms[0] - ref["grad_norm"]) / abs(ref["grad_norm"])
    return {**extra, "arch": arch, "layers": cfg.n_layers, "mesh": list(shape),
            "global_batch": batch, "tokens_a_step": data_tokens,
            "accum": accum,
            "local_params_b": local / 1e9, "init_s": init_s,
            "step_ms": times, "tokens_per_s": data_tokens / (mean_ms / 1e3),
            "model_tflops_per_card": sd.model_flops / (mean_ms / 1e3) / 1e12
            / dist.get_world_size(),
            "peak_gb": [float(p) for p in peaks], "losses": losses,
            "grad_norms": norms, "ln_v": math.log(cfg.vocab),
            "slowest_rank_step_ms": float(slowest)}


class OutOfMemory(RuntimeError):
    """A rank ran out of device memory; ``args[0]`` is its record."""


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama4-scout-17b-a16e")
    ap.add_argument("--layers", type=int, default=4,
                    help="layers at full width; 0: the config's own")
    ap.add_argument("--meshes", nargs="+", default=["2x2", "1x4", "4x1"])
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--heads", type=int, default=None)
    ap.add_argument("--kv-heads", type=int, default=None)
    ap.add_argument("--f32", action="store_true")
    ap.add_argument("--one-card", choices=["step", "grads", "loss"],
                    default=None)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--chunk-q", type=int, default=None)
    ap.add_argument("--xent-chunk", type=int, default=None)
    ap.add_argument("--dispatch-groups", type=int, default=None)
    args = ap.parse_args()
    over = head_override(args.arch, args.heads, args.kv_heads, args.reduced)
    if args.f32:
        over["dtype"] = torch.float32
    if args.chunk_q:
        over["chunk_q"] = args.chunk_q
    if args.xent_chunk:
        over["xent_chunk"] = args.xent_chunk
    if args.dispatch_groups:
        moe = steps.get_arch(args.arch).make_config("train_4k",
                                                    args.reduced).moe
        over["moe"] = dataclasses.replace(
            moe, dispatch_groups=args.dispatch_groups)
    local_rank = int(os.environ["LOCAL_RANK"])
    if args.device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.cuda.set_device(local_rank)
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
        # a one-card reference holds the other ranks at a barrier
        dist.init_process_group("nccl", timeout=timedelta(minutes=20),
                                device_id=torch.device("cuda", local_rank))
    else:
        torch.set_num_threads(1)
        dist.init_process_group("gloo")
    try:
        card = (card_line() if dist.get_rank() == 0 and args.device == "cuda"
                else args.device)
        lines = []
        for m in args.meshes:
            shape = tuple(int(v) for v in m.split("x"))
            try:
                rec = run_mesh(args.arch, args.layers, shape, args.batch,
                               args.steps, args.device, args.reduced, over,
                               args.one_card, args.seq)
            except OutOfMemory as e:
                rec = dict(e.args[0], card=card_line())
                print(json.dumps(rec), flush=True)
                if args.out:
                    with open(f"{args.out}.oom", "a") as f:
                        f.write(json.dumps(rec) + "\n")
                raise
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
