"""The sharded LM serving steps across the cards of one host.

    torchrun --standalone --nproc-per-node 4 experiments/sharded_lm/serve.py \
        [--parts full prefill period nemotron long] [--meshes 1x4 2x2] \
        [--out serve.json]

    torchrun --standalone --nproc-per-node 4 experiments/sharded_lm/serve.py \
        --device cpu --reduced        # a rehearsal: gloo, the reduced configs

Each rank joins one NCCL group (torchrun's rendezvous on this host) on its
own card and runs, for each ``--meshes`` entry (data x model), the parts
asked for, every step built by ``launch.steps.build_step(arch, shape,
mesh=...)``:

* ``full``: llama4-scout-17b-a16e at all 48 layers and full width (about
  216 GB of bfloat16 weights, a quarter a card), its weights seeded a
  block at a time on each card (`random_shards`: the unsharded init
  would make each 64 GB expert stack whole first).  ``prefill_32k`` at
  one sequence a data rank (after a 2,048-token warm-up), then
  ``decode_32k`` at batch 8 (one untimed step, then `STEPS` timed, each
  after a barrier and synchronized); ms, tokens/s, every card's peak GB.
  Then the check that needs no one-card reference: 4 prompts of 2,044
  tokens prefilled, their cache gathered into a 2,048-entry decode cache
  and re-cut, 4 decode steps reading tokens 2,044-2,047 (teacher forced),
  against the prefill of the 2,048 tokens: the largest logit difference
  as a share of the largest logit and the rows whose top-1 token agrees,
  held to phase 5 (a)'s bfloat16 bounds of ``chip_smoke.py``, with the
  MoE's capacity at E / k (nothing dropped), in bfloat16 and in float32
  compute over the same weights, at the first 4, 12, 24 and all 48
  layers (`DEPTHS`).
* ``prefill``: ``full``'s ``prefill_32k`` alone.
* ``period``: llama4-scout (or ``--arch``) at one pattern period (4
  layers; ``--period-layers`` another depth), its
  ``init_args`` shards (the unsharded init, cut): ``prefill_32k`` at one
  sequence a data rank and ``decode_32k`` at batch 8 over a seeded random
  cache at position 16,384, and ``long_500k`` at batch 1 over a seeded
  random 524,288-entry cache at position 262,144, each in bfloat16 (as
  served) and in float32 compute over the same weights; the gathered
  logits (and, in float32 compute, caches) against the unsharded steps
  run afterwards on rank 0's card alone: the float32 logits within
  phase 5 (a)'s float32 bound, the caches within one bfloat16 ulp; and
  the decode-against-a-longer-prefill check, sharded and on rank 0's card
  from the same weights (a fault of the layout fails the sharded one
  alone; the top-1 router's sensitivity to the bfloat16 cache, both).
* ``nemotron``: nemotron-4-15b at all 32 layers (31 GB of bfloat16
  weights, which one card holds) on the first mesh: the unsharded
  ``prefill_32k`` (batch 1) and ``decode_32k`` (batch 8, a seeded random
  cache) on rank 0's card first, then the sharded steps, logits against
  logits (a dense model: bfloat16 routes no token); and the
  decode-against-a-longer-prefill check at all 32 layers, sharded and on
  rank 0's card from the same weights.
* ``long``: ``long_500k`` of llama4-scout at 16 of 48 layers (at 48 its
  216 GB of weights and 103 GB of cache pass the 320 GB of four cards):
  batch 1, the cache's sequence over data x model, `STEPS` timed steps at
  position 262,144.

``--heads H [--kv-heads K]`` replaces the published head counts of
every step (`heads.head_override`), so that a "model" of four cards gets
heads it does not divide: ``--arch minicpm3-4b --period-layers 2
--heads 38`` (10, 10, 9 and 9 MLA heads a rank; its ``long_500k`` is a
skipped cell of the registry and is left out), llama4-scout with
``--heads 10 --kv-heads 2`` (3, 3, 2 and 2 query heads, rank 1's reading
both KV heads), or ``--heads 2 --kv-heads 1`` (1, 1, 0 and 0: two ranks
with no head).  ``--seq 4094 --chunk-q 2047 --cells prefill_32k`` runs
the period part's prefill alone at a prompt that "model" does not divide
(blocks of 1,024, 1,024, 1,024 and 1,022; the query chunk must divide
the prompt), its cache gathered from those blocks.

Rank 0 prints one JSON line a (part, mesh) with the card's name and power
limit; ``--out`` also writes them there, after each one.  A part that
does not fit stops the launch with the rank's traceback: run the parts
as separate launches to keep the others.  ``--device cpu`` runs the same
over gloo on the CPU (with ``--reduced``: the reduced configs, prompts
of 12 + 4 and 32 tokens).
Imports no JAX.
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
import zlib
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
from repro_torch.utils import (tree_leaves, tree_map,  # noqa: E402
                               tree_map_with_path)

LLAMA4, NEMOTRON = "llama4-scout-17b-a16e", "nemotron-4-15b"
STEPS = 3
SEED = 0
# phase 5 (a)'s bfloat16 bounds in chip_smoke.py: the largest difference as
# a share of the largest value, and the share of rows with the same top-1
BOUND, TOP1 = 0.08, 0.75
# sizes: full widths, and the reduced configs' rehearsal
SIZES = {False: dict(layers=48, period=4, long_layers=16, decode_batch=8,
                     prompt=2044, more=4, warm=2048),
         True: dict(layers=None, period=None, long_layers=None,
                    decode_batch=4, prompt=12, more=4, warm=None)}


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout
    return out.strip().splitlines()[0]


class Run:
    """The rank's device, mesh and sizes, and the helpers every part
    uses."""

    def __init__(self, device: str, reduced: bool, mesh_shape: tuple,
                 arch: str = LLAMA4, over: dict | None = None,
                 period: int | None = None, prompt: dict | None = None,
                 cells: tuple | None = None):
        self.device, self.reduced = device, reduced
        # the period part's arch, depth and the head override of every step
        self.arch, self.over, self.period = arch, dict(over or {}), period
        # the period part's prefill: its length and query chunk ("seq",
        # "chunk_q"), and the cells it runs (None: all)
        self.prompt, self.cells = dict(prompt or {}), cells
        self.cuda = device == "cuda"
        self.dev = torch.device(device, torch.cuda.current_device()) \
            if self.cuda else torch.device("cpu")
        self.mesh = init_device_mesh(device, mesh_shape,
                                     mesh_dim_names=("data", "model"))
        self.shape = mesh_shape
        self.size = SIZES[reduced]

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def timed(self, fn):
        """(fn(), its ms on the host clock): every rank at a barrier before
        it, and synchronized; the slowest rank's time."""
        dist.barrier()
        self.sync()
        t = time.perf_counter()
        out = fn()
        self.sync()
        ms = torch.tensor([1e3 * (time.perf_counter() - t)], device=self.dev)
        dist.all_reduce(ms, op=dist.ReduceOp.MAX)
        return out, float(ms)

    def peaks(self) -> list:
        """Every card's peak GB since the last reset."""
        peak = torch.tensor([torch.cuda.max_memory_allocated() / 1e9
                             if self.cuda else 0.0], device=self.dev)
        out = [torch.zeros_like(peak) for _ in range(dist.get_world_size())]
        dist.all_gather(out, peak)
        return [round(float(p), 3) for p in out]

    def reset_peak(self):
        if self.cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()

    def step(self, arch, shape, layers, batch=None, seq=None, mesh=True,
             cfg_over=None):
        """``build_step`` at full width and ``layers`` layers (or the
        reduced config), on the mesh or unsharded; ``cfg_over`` replaces
        more fields of the config."""
        kw = {"mesh": self.mesh} if mesh else {}
        cfg_over = {**self.over, **(cfg_over or {})} or None
        if self.reduced:
            return steps.build_step(arch, shape, reduced=True,
                                    cfg_override=cfg_over, **kw)
        over = {"global_batch": batch} if batch else {}
        if seq:
            over["seq_len"] = seq
        return steps.build_step(arch, shape, cfg_override={
            "n_layers": layers, **(cfg_over or {})}, shape_override=over,
            **kw)

    def cfg(self, arch, shape, layers):
        cfg = dataclasses.replace(
            steps.get_arch(arch).make_config(shape, self.reduced),
            **self.over)
        if self.reduced:
            return dataclasses.replace(cfg, max_seq=64)
        return dataclasses.replace(cfg, n_layers=layers)

    def rows(self, b: int, long: bool = False) -> slice:
        """The global rows of a batch of ``b`` this rank holds."""
        if long:
            return slice(None)
        dp, pos = self.shape[0], self.mesh.get_coordinate()[0]
        return slice(pos * b // dp, (pos + 1) * b // dp)

    def tokens(self, cfg, b: int, s: int, seed: int):
        rng = np.random.default_rng(seed)
        return torch.from_numpy(rng.integers(0, cfg.vocab, (b, s)).astype(
            np.int64)).to(self.dev)


def _seed(*parts) -> int:
    return zlib.crc32(repr(parts).encode()) & 0x7FFFFFFF


def random_shards(run: Run, sd, cfg) -> dict:
    """This rank's shards of seeded random weights for ``sd``'s layout:
    each block uniform in ``1 / sqrt(fan_in)`` as `layers.uniform_init`
    draws a full leaf (the norms ones), from a generator seeded by the
    leaf and the block, so that replicated blocks agree, made on the card
    one block at a time."""
    meta = tf.init_params(cfg, dtype=cfg.dtype, device="meta")

    def leaf(path, t, spec):
        sl = parallel.local_slices(spec, t.shape, run.mesh)
        shape = tuple(len(range(*s.indices(n))) for s, n in zip(sl, t.shape))
        core = t.shape[2:] if "layers" in path else t.shape
        if len(core) == 1:
            return torch.ones(shape, dtype=cfg.dtype, device=run.dev)
        gen = torch.Generator(device=run.dev).manual_seed(
            _seed(path, [(s.start, s.stop) for s in sl]))
        bound = 1.0 / math.sqrt(core[0])
        return torch.empty(shape, dtype=cfg.dtype, device=run.dev).uniform_(
            -bound, bound, generator=gen)

    return tree_map_with_path(leaf, meta, sd.in_shardings[0])


def fill_random(run: Run, cache: dict, full: tuple, spec, seed: int):
    """Fill ``cache`` (this rank's block of an (L, B, S, ...) cache of the
    ``full`` shapes by name, laid out by ``spec``; ``spec`` None: the whole
    cache) in place with seeded random bfloat16 values, the same on every
    rank, made a layer at a time."""
    for name, c in cache.items():
        shape = full[name]
        sl = (parallel.local_slices(spec[name], shape, run.mesh)
              if spec is not None else (slice(None),) * len(shape))
        for li in range(shape[0]):
            gen = torch.Generator(device=run.dev).manual_seed(
                _seed(seed, name, li))
            layer = torch.randn(shape[1:], generator=gen, device=run.dev)
            c[li] = layer[sl[1:]]
            del layer
    return cache


def agree(got, want) -> dict:
    """The largest difference as a share of the largest magnitude of
    ``want``, and (for logits) the share of rows with the same argmax."""
    got, want = got.float(), want.float()
    rel = float((got - want).abs().max() / want.abs().max())
    out = {"rel": rel}
    if want.ndim == 2:
        out["top1"] = float((got.argmax(-1) == want.argmax(-1)).float()
                            .mean())
    return out


def within(a: dict) -> bool:
    return a["rel"] <= BOUND and a.get("top1", 1.0) >= TOP1


def part_prefill(run: Run) -> dict:
    """llama4 at full depth: prefill_32k alone, timed."""
    rec = {"part": "prefill", "arch": LLAMA4}
    full_prefill(run, rec)
    return rec


def full_prefill(run: Run, rec: dict) -> tuple:
    """llama4 at full depth, its weights seeded a block at a time, and
    prefill_32k at one sequence a data rank timed after a warm-up, into
    ``rec``; returns (the weights, the config)."""
    z, dp = run.size, run.shape[0]
    pre = run.step(LLAMA4, "prefill_32k", z["layers"], batch=dp)
    cfg = run.cfg(LLAMA4, "prefill_32k", z["layers"])
    run.reset_peak()
    params = random_shards(run, pre, cfg)
    run.sync()
    rec["local_weights_gb"] = sum(t.numel() * t.element_size()
                                  for t in tree_leaves(params)) / 1e9
    s_full = 32 if run.reduced else \
        steps.get_arch(LLAMA4).shapes["prefill_32k"]["seq_len"]
    toks = run.tokens(cfg, dp, s_full, SEED)[run.rows(dp)]
    if z["warm"]:
        pre.fn(params, toks[:, :z["warm"]])
    (logits, cache), ms = run.timed(lambda: pre.fn(params, toks))
    rec.update(prefill_batch=dp, prefill_tokens=s_full, prefill_ms=ms,
               prefill_tokens_per_s=dp * s_full / (ms / 1e3),
               prefill_finite=bool(torch.isfinite(logits).all()),
               prefill_peak_gb=run.peaks())
    return params, cfg


def part_full(run: Run) -> dict:
    """llama4 at full depth: prefill_32k and decode_32k timed, and decode
    against a longer prefill."""
    z, dp = run.size, run.shape[0]
    rec = {"part": "full", "arch": LLAMA4}
    params, cfg = full_prefill(run, rec)
    b = z["decode_batch"]
    dec = run.step(LLAMA4, "decode_32k", z["layers"], batch=b)
    s_dec = 32 if run.reduced else \
        steps.get_arch(LLAMA4).shapes["decode_32k"]["seq_len"]
    run.reset_peak()
    tp = run.shape[1]
    cache = tf.init_cache(cfg, b // dp, s_dec // tp, device=run.dev)
    dtoks = run.tokens(cfg, b, 1, SEED + 1)[run.rows(b), 0]
    dec.fn(params, cache, dtoks, s_dec // 2)
    times = []
    for _ in range(STEPS):
        (logits, _), ms = run.timed(
            lambda: dec.fn(params, cache, dtoks, s_dec // 2))
        times.append(ms)
    rec.update(decode_batch=b, decode_cache=s_dec, decode_ms=times,
               decode_tokens_per_s=b / (np.mean(times) / 1e3),
               decode_finite=bool(torch.isfinite(logits).all()),
               decode_peak_gb=run.peaks())
    del cache, logits
    # the same check at the first 4, 12, 24 and all 48 layers of these
    # weights: a fault of the layout shows at any depth, the bfloat16
    # cache's rounding reaching the top-1 router's near ties grows with it
    for layers in DEPTHS if not run.reduced else (None,):
        sub = params if layers in (None, z["layers"]) else {
            **params, "layers": tree_map(lambda a: a[:layers // 4],
                                         params["layers"])}
        for tag, over in longer_prefill_configs(cfg):
            rec[f"longer_prefill_{tag}_{layers or 4}"] = \
                check_longer_prefill(run, LLAMA4, sub, cfg, over, layers)
    return rec


# the depths of part_full's check: one period, a quarter, a half, all
DEPTHS = (4, 12, 24, 48)


def longer_prefill_configs(cfg) -> tuple:
    """(tag, config override) of the decode-against-a-longer-prefill
    check: an MoE's capacity at E / k drops nothing (a prefill's groups of
    256 tokens would drop what a decode step keeps), as phase 5 (a) of
    chip_smoke.py; in the serving dtype, and in float32 compute over the
    same bfloat16 weights (bfloat16 moves tokens across the router's top-k
    boundary)."""
    keep = {}
    if cfg.moe is not None:
        e = cfg.moe
        keep["moe"] = dataclasses.replace(e, capacity_factor=e.n_experts
                                          / e.top_k)
    return (("bf16", keep), ("f32", {**keep, "dtype": torch.float32}))


def check_longer_prefill(run: Run, arch, params, cfg, over: dict, layers,
                         mesh: bool = True) -> dict:
    """4 prompts of P tokens prefilled, their cache gathered into a decode
    cache of P + 4 (and re-cut), 4 teacher-forced decode steps, against the
    last-token logits of the prefill of the P + 4 tokens; the steps of
    ``arch`` at ``layers`` layers, on the mesh or unsharded, their config
    with ``over``."""
    z = run.size
    p, n, b = z["prompt"], z["more"], 4
    toks = run.tokens(cfg, b, p + n, SEED + 2)
    rows = run.rows(b) if mesh else slice(None)
    pre = run.step(arch, "prefill_32k", layers, batch=b, seq=p + n,
                   cfg_over=over, mesh=mesh)
    dec = run.step(arch, "decode_32k", layers, batch=b, seq=p + n,
                   cfg_over=over, mesh=mesh)
    _, cache = pre.fn(params, toks[rows, :p])
    if mesh:
        cache = parallel.gather_tree(cache, steps.lm_cache_spec(
            dec.arg_specs[1], "prefill_32k"), run.mesh)
    padded = {k: torch.zeros(c.shape[:2] + (p + n,) + c.shape[3:],
                             dtype=c.dtype, device=run.dev)
              for k, c in cache.items()}
    for k in padded:
        padded[k][:, :, :p] = cache[k]
    cache = parallel.shard_tree(padded, dec.in_shardings[1], run.mesh) \
        if mesh else padded
    del padded
    for pos in range(p, p + n):
        logits, cache = dec.fn(params, cache, toks[rows, pos], pos)
    want, _ = pre.fn(params, toks[rows])
    a = agree(logits, want)
    return {"rel": a["rel"], "top1": a["top1"], "ok": within(a)}


def longer_prefill_both(run: Run, arch, params, plain_params, cfg,
                        layers) -> dict:
    """`check_longer_prefill` of the sharded steps and, on rank 0's card,
    of the unsharded ones from the same weights (``plain_params()`` makes
    them there): a fault of the layout fails the sharded check alone."""
    out = {}
    for tag, over in longer_prefill_configs(cfg):
        out[f"longer_prefill_{tag}"] = check_longer_prefill(
            run, arch, params, cfg, over, layers)

    def plain():
        full = plain_params()
        got = {f"longer_prefill_{tag}_one_card": check_longer_prefill(
            run, arch, full, cfg, over, layers, mesh=False)
            for tag, over in longer_prefill_configs(cfg)}
        del full
        if run.cuda:
            torch.cuda.empty_cache()
        return got
    out.update(one_card(run, plain) or {})
    return out


def one_card(run: Run, fn) -> dict | None:
    """``fn()`` on rank 0 alone (the others wait at a barrier)."""
    out = fn() if dist.get_rank() == 0 else None
    dist.barrier()
    return out


def cache_shapes(cfg, batch: int, s: int) -> dict:
    return {k: tuple(v.shape) for k, v in
            tf.init_cache(cfg, batch, s, device="meta").items()}


def serve_once(run: Run, sd, params, toks, cache=None, pos=None,
               rows=slice(None), timer=None):
    """One call of ``sd``, a prefill of ``toks`` or (with a ``cache``) a
    decode step at ``pos``, after an untimed one (a prefill of the first
    2,048 tokens, or of all of a prompt up to 8,192; the decode step
    itself, which writes the same entry):
    (its outputs, its ms by ``timer``, `Run.timed` by default)."""
    timer = timer or run.timed
    if cache is None:
        warm = run.size["warm"]
        # (a short prompt warms up whole: its query chunk divides it alone)
        sd.fn(params, toks[rows, :warm if warm and toks.shape[1] > 4 * warm
                           else toks.shape[1]])
        return timer(lambda: sd.fn(params, toks[rows]))
    sd.fn(params, cache, toks[rows], pos)
    return timer(lambda: sd.fn(params, cache, toks[rows], pos))


def part_period(run: Run) -> dict:
    """llama4 at one period: the sharded steps against the unsharded ones
    on rank 0's card, in the serving dtype (timed) and in float32 compute
    over the same bfloat16 weights (the check: bfloat16 moves single
    tokens across the top-1 router's near ties, and each such token's
    later keys and values with it)."""
    z, dp, arch = run.size, run.shape[0], run.arch
    layers = None if run.reduced else (run.period or z["period"])
    rec = {"part": "period", "arch": arch,
           "layers": layers or run.cfg(arch, "prefill_32k", None).n_layers,
           "heads": described(run.over)}
    skip = steps.get_arch(arch).skip_shapes
    cells = tuple((shape, batch) for shape, batch in (
        ("prefill_32k", dp), ("decode_32k", z["decode_batch"]),
        ("long_500k", 1)) if shape not in skip
        and shape in (run.cells or (shape,)))
    for shape, batch in cells:
        if run.reduced:
            batch = 4
        seq, chunk = None, {}
        if shape == "prefill_32k":
            seq = run.prompt.get("seq")
            if run.prompt.get("chunk_q"):
                chunk = {"chunk_q": run.prompt["chunk_q"]}
        sds = {v: run.step(arch, shape, layers, batch=batch, seq=seq,
                           cfg_over={**(o or {}), **chunk})
               for v, o in VARIANTS.items()}
        plains = {v: run.step(arch, shape, layers, batch=batch, seq=seq,
                              mesh=False, cfg_over={**(o or {}), **chunk})
                  for v, o in VARIANTS.items()}
        cfg = run.cfg(arch, shape, layers)
        long = shape == "long_500k"
        run.reset_peak()
        args = sds["bf16"].init_args(device=run.device)
        if shape == "prefill_32k":
            s = sds["bf16"].arg_specs[1].shape[1]
            toks = run.tokens(cfg, batch, s, SEED)
            cspec = steps.lm_cache_spec(tf.init_cache(
                cfg, batch, s, device="meta"), "prefill_32k")
        else:
            s = next(iter(sds["bf16"].arg_specs[1].values())).shape[2]
            toks = run.tokens(cfg, batch, 1, SEED + 4)[:, 0]
            cspec = sds["bf16"].in_shardings[1]
        got = {}
        for v, sd in sds.items():
            cache = None if shape == "prefill_32k" else fill_random(
                run, args[1], cache_shapes(cfg, batch, s), cspec, SEED + 3)
            out, ms = serve_once(run, sd, args[0], toks, cache, s // 2,
                                 rows=run.rows(batch, long))
            # (a prompt that "model" does not divide: unequal blocks)
            got[v] = (out[0], ms, parallel.gather_tree(
                out[1], cspec, run.mesh, cache_shapes(cfg, batch, s))
                if v == "f32" else None)
            del out, cache
        peaks = run.peaks()
        del args
        ref = one_card(run, lambda: reference(run, plains, cfg, shape,
                                              batch, s, toks, got))
        del got
        tag = "long" if long else shape.split("_")[0]
        rec.update({f"{tag}_batch": batch, f"{tag}_tokens": s,
                    f"{tag}_peak_gb": peaks})
        if ref is not None:
            rec.update({f"{tag}_{k}": v for k, v in ref.items()})
        if run.cuda:
            torch.cuda.empty_cache()
    rec.update(longer_prefill_at(run, arch, layers))
    return rec


def longer_prefill_at(run: Run, arch, layers) -> dict:
    """`longer_prefill_both` from ``arch``'s ``init_args`` weights at
    ``layers`` layers: sharded, and unsharded on rank 0's card."""
    pre = run.step(arch, "prefill_32k", layers, batch=run.shape[0])
    params = pre.init_args(device=run.device)[0]
    out = longer_prefill_both(
        run, arch, params, lambda: run.step(
            arch, "prefill_32k", layers, batch=run.shape[0],
            mesh=False).init_args(device=run.device)[0],
        run.cfg(arch, "prefill_32k", layers), layers)
    del params
    if run.cuda:
        torch.cuda.empty_cache()
    return out


# the period's variants: as served, and float32 compute (the check)
VARIANTS = {"bf16": None, "f32": {"dtype": torch.float32}}
# phase 5 (a)'s float32 bound in chip_smoke.py (its MoE models)
F32_BOUND, F32_TOP1 = 1e-3, 0.95


def bf16_ulp(magnitude: float) -> float:
    """One bfloat16 ulp at ``magnitude``: 2^(e - 7) in [2^e, 2^(e + 1))."""
    return 2.0 ** (math.floor(math.log2(max(magnitude, 2.0 ** -126))) - 7)


def reference(run: Run, plains, cfg, shape, batch, s, toks, got) -> dict:
    """The unsharded steps (each variant) on this card on the same
    weights and inputs, and the sharded outputs against them: in float32
    compute the logits within `F32_BOUND` (top-1 `F32_TOP1`) and the
    cache within one bfloat16 ulp at its largest magnitude; the serving
    dtype's logits reported."""
    args = plains["bf16"].init_args(device=run.device)
    out = {}
    for v, plain in plains.items():
        cache = None if shape == "prefill_32k" else fill_random(
            run, args[1], cache_shapes(cfg, batch, s), None, SEED + 3)
        (want, cache), ms = serve_once(run, plain, args[0], toks, cache,
                                       s // 2,
                                       timer=lambda fn: _host_ms(run, fn))
        logits, sharded_ms, got_cache = got[v]
        out[f"{v}_sharded_ms"], out[f"{v}_plain_ms"] = sharded_ms, ms
        out[f"{v}_logits"] = agree(logits, want)
        if got_cache is not None:
            out[f"{v}_cache_ulps"] = {
                k: float((got_cache[k].float() - c.float()).abs().max())
                / bf16_ulp(float(c.float().abs().max()))
                for k, c in cache.items()}
        del want, cache
    lg = out["f32_logits"]
    out["ok"] = (lg["rel"] <= F32_BOUND and lg["top1"] >= F32_TOP1
                 and all(u <= 1.0 for u in out["f32_cache_ulps"].values()))
    del args
    if run.cuda:
        torch.cuda.empty_cache()
    return out


def _host_ms(run: Run, fn):
    run.sync()
    t = time.perf_counter()
    out = fn()
    run.sync()
    return out, 1e3 * (time.perf_counter() - t)


def part_nemotron(run: Run) -> dict:
    """nemotron-4-15b at full depth: the unsharded steps on rank 0's card,
    then the sharded ones, logits against logits."""
    rec = {"part": "nemotron", "arch": NEMOTRON}
    layers = None if run.reduced else 32
    cells = (("prefill_32k", 1 if not run.reduced else 4),
             ("decode_32k", run.size["decode_batch"]))
    for shape, batch in cells:
        plain = run.step(NEMOTRON, shape, layers, batch=batch, mesh=False)
        sd = run.step(NEMOTRON, shape, layers, batch=batch)
        cfg = run.cfg(NEMOTRON, shape, layers)
        tag = shape.split("_")[0]
        if shape == "prefill_32k":
            s = plain.arg_specs[1].shape[1]
            toks = run.tokens(cfg, batch, s, SEED)
        else:
            s = plain.arg_specs[1]["k"].shape[2]
            toks = run.tokens(cfg, batch, 1, SEED + 4)[:, 0]

        def unsharded():
            args = plain.init_args(device=run.device)
            cache = None if shape == "prefill_32k" else fill_random(
                run, args[1], cache_shapes(cfg, batch, s), None, SEED + 3)
            (lg, _), ms = serve_once(run, plain, args[0], toks, cache,
                                     s // 2,
                                     timer=lambda fn: _host_ms(run, fn))
            out = (lg.cpu(), ms)
            del args, cache, lg
            if run.cuda:
                torch.cuda.empty_cache()
            return out

        want = one_card(run, unsharded)
        run.reset_peak()
        args = sd.init_args(device=run.device)
        cache = None if shape == "prefill_32k" else fill_random(
            run, args[1], cache_shapes(cfg, batch, s), sd.in_shardings[1],
            SEED + 3)
        (logits, _), ms = serve_once(run, sd, args[0], toks, cache, s // 2,
                                     rows=run.rows(batch))
        rec.update({f"{tag}_batch": batch, f"{tag}_sharded_ms": ms,
                    f"{tag}_peak_gb": run.peaks()})
        if want is not None:
            a = agree(logits.cpu(), want[0])
            rec.update({f"{tag}_plain_ms": want[1], f"{tag}_logits": a,
                        f"{tag}_ok": within(a)})
        del args, cache, logits
        if run.cuda:
            torch.cuda.empty_cache()
    rec.update(longer_prefill_at(run, NEMOTRON, layers))
    return rec


def part_long(run: Run) -> dict:
    """llama4's long_500k at a cut depth: decode steps timed."""
    layers = run.size["long_layers"]
    rec = {"part": "long", "arch": LLAMA4, "layers": layers or 4}
    sd = run.step(LLAMA4, "long_500k", layers)
    cfg = run.cfg(LLAMA4, "long_500k", layers)
    s = sd.arg_specs[1]["k"].shape[2]
    b = sd.arg_specs[1]["k"].shape[1]
    run.reset_peak()
    params = random_shards(run, sd, cfg)
    parts = run.shape[0] * run.shape[1]
    cache = tf.init_cache(cfg, b, s // parts, device=run.dev)
    toks = run.tokens(cfg, b, 1, SEED + 1)[:, 0]
    sd.fn(params, cache, toks, s // 2)
    times = []
    for _ in range(STEPS):
        (logits, _), ms = run.timed(lambda: sd.fn(params, cache, toks,
                                                  s // 2))
        times.append(ms)
    rec.update(batch=b, cache=s, position=s // 2, decode_ms=times,
               cache_gb_a_card=sum(c.numel() * c.element_size()
                                   for c in cache.values()) / 1e9,
               finite=bool(torch.isfinite(logits).all()),
               peak_gb=run.peaks())
    return rec


PARTS = {"full": part_full, "prefill": part_prefill, "period": part_period,
         "nemotron": part_nemotron, "long": part_long}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parts", nargs="+",
                    default=["full", "period", "nemotron", "long"])
    ap.add_argument("--meshes", nargs="+", default=["1x4", "2x2"])
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--arch", default=LLAMA4,
                    help="the period part's arch")
    ap.add_argument("--period-layers", type=int, default=None)
    ap.add_argument("--heads", type=int, default=None)
    ap.add_argument("--kv-heads", type=int, default=None)
    ap.add_argument("--seq", type=int, default=None,
                    help="the period part's prompt length")
    ap.add_argument("--chunk-q", type=int, default=None,
                    help="the period part's prefill query chunk")
    ap.add_argument("--cells", nargs="+", default=None,
                    help="the period part's cells (default: all)")
    args = ap.parse_args()
    over = head_override(args.arch, args.heads, args.kv_heads, args.reduced)
    local_rank = int(os.environ["LOCAL_RANK"])
    if args.device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.cuda.set_device(local_rank)
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
        dist.init_process_group("nccl", timeout=timedelta(minutes=10),
                                device_id=torch.device("cuda", local_rank))
    else:
        torch.set_num_threads(1)
        dist.init_process_group("gloo", timeout=timedelta(minutes=10))
    lines = []
    try:
        card = (card_line() if dist.get_rank() == 0 and args.device == "cuda"
                else args.device)
        for part in args.parts:
            # nemotron's comparison runs on the first mesh only
            meshes = args.meshes[:1] if part == "nemotron" else args.meshes
            for m in meshes:
                shape = tuple(int(v) for v in m.split("x"))
                t = time.perf_counter()
                rec = PARTS[part](Run(args.device, args.reduced, shape,
                                      args.arch, over, args.period_layers,
                                      {"seq": args.seq,
                                       "chunk_q": args.chunk_q},
                                      args.cells))
                rec.update(mesh=list(shape), card=card,
                           seconds=time.perf_counter() - t)
                if dist.get_rank() == 0:
                    print(json.dumps(rec), flush=True)
                    lines.append(rec)
                    if args.out:
                        Path(args.out).parent.mkdir(parents=True,
                                                    exist_ok=True)
                        Path(args.out).write_text("\n".join(
                            json.dumps(r) for r in lines) + "\n")
                if args.device == "cuda":
                    torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
