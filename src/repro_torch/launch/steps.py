"""Step builders of the port: per (arch x shape) the step function, its
analytic model FLOPs, and a constructor of concrete arguments.

The counterpart of ``repro.launch.steps`` for its three families:

* the LMs: ``train`` (``train_4k``: gradient accumulation over
  microbatches, the global-norm clip, AdamW) and the serving kinds
  ``prefill`` (``prefill_32k``) and ``decode`` (``decode_32k``,
  ``long_500k``), through `models.transformer`;
* the GAT (``gat-cora``): ``gnn_full`` (``full_graph_sm``,
  ``ogb_products``), ``gnn_minibatch`` (``minibatch_lg``) and
  ``gnn_batched`` (``molecule``), each a training step, through
  `models.gnn`;
* the recsys kinds ``rs_train``, ``rs_serve`` and ``rs_retrieval`` (MIND's
  capsules and BERT4Rec's user representation against the items; DLRM's
  and Wide & Deep's ranking forward over the candidates).

``StepDef`` has the JAX package's fields: ``arg_specs`` is a tree of
``ArgSpec(shape, dtype)`` a positional argument (computed on the ``meta``
device, so a full-width cell allocates nothing), ``in_shardings`` and
``out_shardings`` trees of `distributed.Spec` (the reference's
PartitionSpecs leaf for leaf: `lm_param_spec`, `rs_param_spec`, the
GAT's replicated leaves and each family's batch specs), and
``donate_argnums`` (a decode step writes its cache in place where the
reference donates it).  With ``mesh=`` every step runs sharded
(`distributed.parallel`): an LM's ``train_4k`` (ZeRO-3 over the data
axes, tensor and sequence parallelism over "model": the reference's
``act_btd``) and its serving kinds (the cache in the reference's
``kv_cache``/``mla_cache`` layout, `lm_cache_spec`; a prefill's residual
over "model" by the sequence too); the recsys steps with the tables' rows
over "model" (through the embedding-bag kernel on the rank's block) and
the batch, or the ranking archs' candidates, over the data axes; the
GAT's with the full graph's edges and hidden node rows, or the batch,
over the data axes (`build_rs_step`, `build_gnn_step`).  An LM step on a
mesh takes every split that the reference's GSPMD compiles, the uneven
ones too (`distributed.parallel.block`), and refuses, before any
collective, the arguments that the reference's jit refuses
(`check_args`).  The batch
or the tokens are the JAX package's numpy arrays for the same
``default_rng(0)``; the parameters are made on the device from a seeded
``torch.Generator`` (``params_from_jax`` of `models.recsys`,
`models.transformer` and `models.gnn` carries the JAX package's own
instead).  An LM's serving
steps hold its parameters in its compute dtype (bfloat16 at full width),
which they compute in anyway; its training step holds them in float32
(``cfg.param_dtype``), as the reference.  A training step updates the
parameters and the optimizer state in place and returns its metrics
(``{"loss"}``; with ``"grad_norm"`` for the LMs and the GAT, whose
AdamW runs in place, `optim.adamw`'s ``update_``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from ..configs.registry import ArchSpec, get_arch, list_archs  # noqa: F401
from ..distributed.sharding import Spec
from ..kernels import registry as _registry
from ..models import gnn as gnn_mod
from ..models import recsys as rs
from ..models import transformer as tf
from ..models.layers import rope_freqs
from ..optim import (adamw, apply_updates, clip_by_global_norm_,
                     partition_optimizer, sgd)
from ..optim.optimizers import _clip_scale
from ..utils import top_k, tree_leaves, tree_map, tree_map_with_path

SEED = 0


class ArgSpec(NamedTuple):
    """A positional argument's leaf: the reference's ShapeDtypeStruct."""
    shape: tuple
    dtype: torch.dtype


@dataclasses.dataclass
class StepDef:
    name: str
    fn: Callable
    model_flops: float
    init_args: Callable   # (device=None) -> concrete args, on the card by default
    arg_specs: tuple = ()       # a tree of ArgSpec a positional argument
    in_shardings: tuple = ()    # the matching trees of Spec
    out_shardings: Any = None   # or None (no layout asked)
    donate_argnums: tuple = ()
    # an LM's or the GAT's training step before its update: (params,
    # batch) -> (the global loss, the gradients in params' layout, on a
    # mesh this rank's shards of the whole gradient)
    grad_fn: Callable | None = None


def _path_keys(path) -> list[str]:
    return [str(k) for k in path]


def arg_specs_of(tree):
    """The `ArgSpec` tree of a tree of tensors (``meta`` ones included)."""
    return tree_map(lambda t: ArgSpec(tuple(t.shape), t.dtype), tree)


def tree_specs(tree, spec_fn):
    """``spec_fn(path, leaf)`` over a tree of (meta) tensors."""
    return tree_map_with_path(spec_fn, tree)


def _replicated(path, leaf) -> Spec:
    return Spec(*(None,) * len(leaf.shape))


def _dp(multi_pod: bool):
    return ("pod", "data") if multi_pod else "data"


# --------------------------------------------------------------------------- #
# LM family                                                                    #
# --------------------------------------------------------------------------- #
def lm_model_flops(cfg: tf.TransformerConfig, shape: dict) -> float:
    """Analytic useful FLOPs of one step: ``2 * N_active * T`` (6x for
    ``train``) plus the attention term; ``repro.launch.steps``'s count,
    in its order of floating-point operations."""
    d, l = cfg.d_model, cfg.n_layers
    h, hd, hkv = cfg.n_heads, cfg.head_dim, cfg.n_kv_heads
    if cfg.attn == "mla":
        m = cfg.mla
        attn_p = d * m.q_lora + m.q_lora * h * (m.qk_nope + m.qk_rope) + \
            d * (m.kv_lora + m.qk_rope) + \
            m.kv_lora * h * (m.qk_nope + m.v_head) + h * m.v_head * d
        a_dim = m.qk_nope + m.qk_rope
    else:
        attn_p = d * h * hd + 2 * d * hkv * hd + h * hd * d
        a_dim = hd
    if cfg.moe is not None:
        e = cfg.moe
        # a float, as the reference's sum with its zero float terms
        ffn_p = float(e.top_k * 3 * d * e.d_ff
                      + 3 * d * e.d_ff * e.n_shared_experts)
        ffn_p += d * e.n_experts  # router
    else:
        ffn_p = (3 if cfg.gated_ffn else 2) * d * cfg.d_ff
    n_active = l * (attn_p + ffn_p) + d * cfg.vocab  # + lm_head
    kind = shape["kind"]
    s, b = shape["seq_len"], shape["global_batch"]
    # attention score/value flops per layer (causal ~ S/2 mean context)
    if kind == "decode":
        att = l * 4 * h * a_dim * s * b
        return 2 * n_active * b + att
    t = b * s
    ctx = s / 2
    if cfg.layer_pattern != ("full",):
        # 3/4 local (window) + 1/4 global
        w = min(cfg.local_window, s)
        ctx = 0.75 * min(w / 2, s / 2) + 0.25 * s / 2
    att_fwd = l * 4 * h * a_dim * ctx * t
    if kind == "train":
        return 6 * n_active * t + 3 * att_fwd
    return 2 * n_active * t + att_fwd  # prefill


def lm_param_spec(path, leaf, dp) -> Spec:
    """The reference's layout of an LM leaf: Megatron TP over "model" and
    ZeRO-3 over the data axes ``dp`` for the 2D+ matmul weights (the layer
    stacks' two leading axes replicated)."""
    keys = _path_keys(path)
    name = keys[-1]
    ndim = len(leaf.shape)
    if name == "step" or ndim == 0:
        return Spec()
    prefix = (None, None) if "layers" in keys else ()
    core = ndim - len(prefix)
    if name == "embed":
        return Spec("model", dp)
    if name == "lm_head":
        return Spec(dp, "model")
    if core == 1:   # norms, biases
        return Spec(*(prefix + (None,)))
    if name in ("wq", "wk", "wv", "w1", "w3", "router", "wq_b", "wkv_b"):
        if name in ("wq_b", "wkv_b"):
            return Spec(*(prefix + (None, "model")))
        if core == 3:   # MoE expert stacks (E, d, f)
            return Spec(*(prefix + ("model", dp, None)))
        return Spec(*(prefix + (dp, "model")))
    if name in ("wo", "w2"):
        if core == 3:   # (E, f, d)
            return Spec(*(prefix + ("model", None, dp)))
        return Spec(*(prefix + ("model", dp)))
    if name in ("wq_a", "wkv_a"):
        return Spec(*(prefix + (dp, None)))
    if name == "pos":
        return Spec(None, None)
    return Spec(*(prefix + (None,) * core))


def _lm_tokens(rng, cfg, shape) -> np.ndarray:
    return rng.integers(0, cfg.vocab, shape).astype(np.int32)


def make_lm_optimizer():
    return adamw(lr=3e-4, weight_decay=0.1)


def lm_accum(cfg: tf.TransformerConfig, reduced: bool) -> int:
    """The reference's microbatches a training step: deeper for MoE, whose
    dispatch working set grows with the microbatch's tokens."""
    return 1 if reduced else (8 if cfg.moe is not None else 2)


def lm_grads(params, batch, cfg: tf.TransformerConfig, accum: int, *,
             rope=None):
    """(loss, float32 gradients in ``params``' layout) of `loss_fn` over
    ``batch`` in ``accum`` microbatches of consecutive sequences: each
    microbatch's backward adds its gradient into one tree (``(0 + g1) +
    g2 + ...``, the reference's scan), and the loss and the sums are
    divided by ``accum`` (where it is above 1, as in the reference)."""
    dev = batch["tokens"].device
    grads = tree_map(torch.zeros_like, params)
    view = tf.train_view(params, grads, cfg)
    total = torch.zeros((), dtype=torch.float32, device=dev)
    b = batch["tokens"].shape[0]
    if b % accum:
        raise ValueError(f"{accum} microbatches do not divide a batch of {b}")
    mb = b // accum
    # (a data rank may hold no row of a microbatch: it still runs each,
    # empty, for the collectives of its forward and backward)
    for i in range(accum):
        loss = tf.loss_fn(view, {k: v[i * mb:(i + 1) * mb]
                                 for k, v in batch.items()}, cfg, rope=rope)
        loss.backward()
        total = total + loss.detach()
    if accum == 1:
        return total, grads
    for g in tree_leaves(grads):
        g.div_(accum)
    return total / accum, grads


def adamw_step_(opt, grads, opt_state, params) -> torch.Tensor:
    """Clip ``grads`` to a global norm of 1 and apply ``opt``'s AdamW,
    both in place; returns the norm before the clip."""
    gn = clip_by_global_norm_(grads, 1.0)
    opt.update_(grads, opt_state, params)
    return gn


def _lm_leaf_spec(dp):
    """``(name, ndim) -> Spec`` of an LM leaf as `ParallelContext` asks for
    it: ``embed`` and ``lm_head`` as they are, a layer's leaf without the
    stacks' two leading axes."""
    def spec_of(name, ndim):
        if name in ("embed", "lm_head"):
            return lm_param_spec((name,), torch.empty((1,) * ndim,
                                                      device="meta"), dp)
        full = lm_param_spec(("layers", name),
                             torch.empty((1,) * (ndim + 2), device="meta"), dp)
        return Spec(*tuple(full)[2:])
    return spec_of


def _uneven_heads(cfg: tf.TransformerConfig, tp: int) -> bool:
    """Does "model" fail to cut the heads into whole groups a rank: query
    heads it does not divide, or (GQA) KV heads it neither divides nor is
    a multiple of?"""
    if cfg.mla is not None:
        return cfg.mla.n_heads % tp != 0
    return bool(cfg.n_heads % tp
                or (cfg.n_kv_heads % tp and tp % cfg.n_kv_heads))


def _head_widths(cfg: tf.TransformerConfig) -> dict:
    """Each head leaf's columns (``wo``: rows) a head, and whether they
    follow the query heads or the KV heads."""
    if cfg.mla is not None:
        m = cfg.mla
        return {"wq_b": (m.qk_nope + m.qk_rope, "q"),
                "wkv_b": (m.qk_nope + m.v_head, "q"), "wo": (m.v_head, "q")}
    d = cfg.head_dim
    return {"wq": (d, "q"), "wo": (d, "q"), "wk": (d, "kv"), "wv": (d, "kv")}


def _local_cfg(cfg: tf.TransformerConfig, ctx) -> tf.TransformerConfig:
    """``cfg`` with this model rank's heads, laying them out in ``ctx``
    (the MoE keeps its global expert count: every rank routes over all
    of them).  Where "model" divides them, ``H / tp`` a rank, and with
    fewer KV heads than ranks one whole KV head a rank (`ParallelContext.
    replicate_kv`); otherwise the balanced split of `ParallelContext.
    split_heads` (GQA: the KV heads the rank's query heads read)."""
    tp = ctx.tp_size
    mla = cfg.mla
    if not _uneven_heads(cfg, tp):
        if mla is None:
            ctx.replicate_kv(cfg.n_kv_heads)
        heads, kv = cfg.n_heads // tp, max(cfg.n_kv_heads // tp, 1)
        mla_heads = None if mla is None else mla.n_heads // tp
    else:
        ctx.split_heads(cfg.n_heads if mla is None else mla.n_heads,
                        _head_widths(cfg), None if mla is not None
                        else cfg.n_heads // cfg.n_kv_heads)
        h0, h1 = ctx.head_spans[ctx.tp_rank]
        heads = kv = mla_heads = h1 - h0
        if mla is None:
            k0, k1 = ctx.kv_spans[ctx.tp_rank]
            kv = k1 - k0
    over = {"n_heads": heads, "n_kv_heads": kv}
    if mla is not None:
        over["mla"] = dataclasses.replace(mla, n_heads=mla_heads)
    return dataclasses.replace(cfg, **over)


def _mesh_sizes(mesh, multi_pod: bool) -> dict:
    """Each axis's ranks; a mesh-like object (``mesh_dim_names`` and
    ``size(i)``) is enough, so that the checks need no process group."""
    want = ("pod", "data", "model") if multi_pod else ("data", "model")
    if tuple(mesh.mesh_dim_names) != want:
        raise ValueError(f"the mesh's axes are {tuple(mesh.mesh_dim_names)}"
                         f", the step wants {want}")
    return dict(zip(want, (mesh.size(i) for i in range(len(want)))))


def _check_mesh(mesh, multi_pod: bool) -> tuple:
    """(data ranks, model ranks) of the mesh (`_mesh_sizes`)."""
    sizes = _mesh_sizes(mesh, multi_pod)
    return math.prod(sizes.values()) // sizes["model"], sizes["model"]


def check_args(names: tuple, arg_specs: tuple, in_shardings: tuple,
               sizes: dict) -> None:
    """ValueError where a dimension of a step's argument (``names`` the
    positional arguments') does not divide into the ranks of the mesh
    axes its `Spec` names (``sizes``).  The reference's ``jax.jit``
    refuses exactly such an argument ("... should be divisible by ...");
    what the arguments leave to the step (query heads fewer than the
    "model" ranks, a sequence, a microbatch or MoE groups that the ranks
    do not divide) GSPMD pads and the port cuts as it does
    (`distributed.parallel.block`).  So the vocabulary, the experts, the
    head columns, the ZeRO dimensions, the batch, a decode or
    ``long_500k`` cache: each must divide."""
    def walk(path, arg, spec):
        if isinstance(spec, Spec):
            for dim, n in enumerate(arg.shape):
                axes = spec.axes(dim)
                parts = math.prod(sizes[a] for a in axes)
                if n % parts:
                    raise ValueError(
                        f"{'/'.join(map(str, path))}: dimension {dim} ({n}) "
                        f"does not divide over {' x '.join(axes)} ({parts} "
                        "ranks); the reference's jit refuses such an "
                        "argument too")
        elif isinstance(spec, dict):     # in JAX's order of a pytree's keys
            for k in sorted(spec):
                walk(path + (k,), arg[k], spec[k])
        else:
            for i, v in enumerate(spec):
                walk(path + (i,), arg[i], v)
    for name, arg, spec in zip(names, arg_specs, in_shardings):
        walk((name,), arg, spec)


def build_lm_step(spec: ArchSpec, shape_name: str, *, reduced: bool,
                  multi_pod: bool = False, mesh=None,
                  shape_override: dict | None = None,
                  cfg_override: dict | None = None) -> StepDef:
    cfg = spec.make_config(shape_name, reduced)
    if cfg_override:
        cfg = dataclasses.replace(cfg, **cfg_override)
    shape = dict(spec.shapes[shape_name])
    if shape_override:
        shape.update(shape_override)
    if reduced:
        shape = {**shape, "seq_len": 32, "global_batch": 4}
        cfg = dataclasses.replace(cfg, max_seq=64)
    kind = shape["kind"]
    flops = lm_model_flops(cfg, shape) if not reduced else 0.0
    b, s = shape["global_batch"], shape["seq_len"]
    dp = _dp(multi_pod)
    tables = {}

    meta = tf.init_params(cfg, device="meta")
    params_spec = arg_specs_of(meta)
    pspec = tree_specs(meta, lambda p, l: lm_param_spec(p, l, dp))

    def rope(device):
        """The config's RoPE tables on ``device``, made once."""
        if device not in tables:
            tables[device] = rope_freqs(cfg.rope_dim, cfg.max_seq,
                                        cfg.rope_theta, device=device)
        return tables[device]

    def init_params(device):
        dev = _registry.resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        return dev, tf.init_params(cfg, dtype=cfg.dtype, generator=gen,
                                   device=dev)

    if kind == "train":
        opt = make_lm_optimizer()
        accum = lm_accum(cfg, reduced)
        ospec = tree_specs(opt.init(meta),
                           lambda p, l: lm_param_spec(p, l, dp))
        tok = ArgSpec((b, s), torch.int32)
        shard_kw = dict(arg_specs=(params_spec, arg_specs_of(opt.init(meta)),
                                   {"tokens": tok, "labels": tok}),
                        in_shardings=(pspec, ospec,
                                      {"tokens": Spec(dp, None),
                                       "labels": Spec(dp, None)}),
                        out_shardings=(pspec, ospec, None),
                        donate_argnums=(0, 1))
        if mesh is not None:
            return _sharded_lm_train(spec, shape_name, cfg, b, s, accum, opt,
                                     mesh, multi_pod, pspec, flops, rope,
                                     shard_kw)

        def grad_fn(params, batch):
            return lm_grads(params, batch, cfg, accum,
                            rope=rope(batch["tokens"].device))

        def step(params, opt_state, batch):
            loss, grads = grad_fn(params, batch)
            gn = adamw_step_(opt, grads, opt_state, params)
            return {"loss": loss, "grad_norm": gn}

        def init_args(device=None):
            dev = _registry.resolve_device(device)
            gen = torch.Generator(device=dev).manual_seed(SEED)
            params = tf.init_params(cfg, generator=gen, device=dev)
            rng = np.random.default_rng(SEED)
            batch = {"tokens": _lm_tokens(rng, cfg, (b, s)),
                     "labels": _lm_tokens(rng, cfg, (b, s))}
            return params, opt.init(params), _on(dev, batch)

        return StepDef(name=f"{spec.arch_id}:{shape_name}:train", fn=step,
                       model_flops=flops, init_args=init_args,
                       grad_fn=grad_fn, **shard_kw)

    if kind == "prefill":
        shard_kw = dict(arg_specs=(params_spec, ArgSpec((b, s), torch.int32)),
                        in_shardings=(pspec, Spec(dp, None)))
        if mesh is not None:
            return _sharded_lm_serve(spec, shape_name, kind, cfg, b, s, mesh,
                                     multi_pod, flops, rope, shard_kw)

        @torch.inference_mode()
        def step(params, tokens):
            return tf.prefill(params, tokens, cfg, rope=rope(tokens.device))

        def init_args(device=None):
            dev, params = init_params(device)
            rng = np.random.default_rng(SEED)
            return params, torch.from_numpy(_lm_tokens(rng, cfg,
                                                       (b, s))).to(dev)

        return StepDef(name=f"{spec.arch_id}:{shape_name}:prefill", fn=step,
                       model_flops=flops, init_args=init_args, **shard_kw)

    cache = tf.init_cache(cfg, b, s, device="meta")
    cspec = lm_cache_spec(cache, shape_name, multi_pod)
    ndp = 32 if multi_pod else 16
    tok_sharding = Spec(dp) if b % ndp == 0 else Spec(None)
    shard_kw = dict(arg_specs=(params_spec, arg_specs_of(cache),
                               ArgSpec((b,), torch.int32),
                               ArgSpec((), torch.int32)),
                    in_shardings=(pspec, cspec, tok_sharding, Spec()),
                    out_shardings=(None, cspec), donate_argnums=(1,))
    if mesh is not None:
        return _sharded_lm_serve(spec, shape_name, kind, cfg, b, s, mesh,
                                 multi_pod, flops, rope, shard_kw)

    @torch.inference_mode()
    def step(params, cache, tokens, pos):
        return tf.decode_step(params, cache, tokens, pos, cfg,
                              rope=rope(tokens.device))

    def init_args(device=None):
        dev, params = init_params(device)
        rng = np.random.default_rng(SEED)
        return (params, tf.init_cache(cfg, b, s, device=dev),
                torch.from_numpy(_lm_tokens(rng, cfg, (b,))).to(dev), s // 2)

    return StepDef(name=f"{spec.arch_id}:{shape_name}:decode", fn=step,
                   model_flops=flops, init_args=init_args, **shard_kw)


def lm_cache_spec(cache, shape_name: str, multi_pod: bool = False) -> dict:
    """The reference's layout of a KV cache tree (leaves (L, B, S, ...)):
    ``long_500k``'s sequence over every mesh axis (batch replicated), any
    other cell's batch over the data axes and sequence over "model" (the
    rules' ``kv_cache``/``mla_cache``; the sharded prefill's cache too)."""
    if shape_name == "long_500k":
        seq = ("pod", "data", "model") if multi_pod else ("data", "model")
        return {k: Spec(*((None, None, seq) + (None,) * (len(v.shape) - 3)))
                for k, v in cache.items()}
    return {k: Spec(*((None, _dp(multi_pod), "model")
                      + (None,) * (len(v.shape) - 3)))
            for k, v in cache.items()}


def _sharded_lm_train(spec, shape_name, cfg, b, s, accum, opt, mesh,
                      multi_pod, pspec, flops, rope, shard_kw) -> StepDef:
    """``train_4k`` over ``mesh``: the parameters and the AdamW moments as
    this rank's shards of ``pspec``, the batch as its rows of each
    microbatch; returns the global loss and gradient norm on every rank.
    The step's arguments are checked (`check_args`) before its context
    (groups, this rank's heads) is made."""
    from ..distributed import parallel
    from ..distributed.sharding import rules_for_family, sharding_rules

    check_args(("params", "opt_state", "batch"), shard_kw["arg_specs"],
               shard_kw["in_shardings"], _mesh_sizes(mesh, multi_pod))
    dp = _dp(multi_pod)
    ctx = parallel.ParallelContext(mesh, multi_pod=multi_pod,
                                   spec_of=_lm_leaf_spec(dp))
    ctx.batch_rows = b // accum
    lcfg = _local_cfg(cfg, ctx)
    rules = rules_for_family("lm", multi_pod=multi_pod)

    def grad_fn(params, batch):
        ctx.seq_len = batch["tokens"].shape[1]
        with sharding_rules(rules, ctx):
            loss, grads = lm_grads(params, batch, lcfg, accum,
                                   rope=rope(batch["tokens"].device))
        ctx.sum_replicated_grads(grads, pspec)
        return ctx.data_sum(loss), grads

    def step(params, opt_state, batch):
        loss, grads = grad_fn(params, batch)
        with torch.no_grad():
            gn = ctx.global_norm(grads, pspec)
            scale = _clip_scale(gn, 1.0)
            for g in tree_leaves(grads):
                g.mul_(scale)
        opt.update_(grads, opt_state, params)
        return {"loss": loss, "grad_norm": gn}

    def init_args(device=None):
        dev = _registry.resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        params = parallel.init_shards(
            lambda: tf.init_params(cfg, generator=gen, device=dev),
            lambda: tf.init_params(cfg, device="meta"),
            lambda p, l: lm_param_spec(p, l, dp), mesh)
        rng = np.random.default_rng(SEED)
        rows = parallel.data_rows(b, accum, ctx.dp_size, ctx.dp_rank)
        batch = {"tokens": _lm_tokens(rng, cfg, (b, s))[rows],
                 "labels": _lm_tokens(rng, cfg, (b, s))[rows]}
        return params, opt.init(params), _on(dev, batch)

    return StepDef(name=f"{spec.arch_id}:{shape_name}:train", fn=step,
                   model_flops=flops, init_args=init_args, grad_fn=grad_fn,
                   **shard_kw)


def _sharded_lm_serve(spec, shape_name, kind, cfg, b, s, mesh, multi_pod,
                      flops, rope, shard_kw) -> StepDef:
    """``prefill`` or ``decode`` over ``mesh``: the bfloat16 (compute
    dtype) parameters as this rank's shards of `lm_param_spec`, gathered
    over the data axes at use, the heads, the vocabulary and the experts
    over "model" (`_sharded_lm_train`'s layout); a prefill takes the
    rank's token rows and returns the whole (B, V) logits and the rank's
    block of the cache in the decode layout; a decode step takes the
    rank's rows and cache block (`lm_cache_spec`; ``long_500k``: every row
    and a block of the sequence over the data axes and "model") and
    returns the whole logits, writing its block in place.  The StepDef's
    specs stay the reference's (its token spec tests the batch against
    the production data size); the rows a rank holds follow ``mesh``."""
    from ..distributed import parallel
    from ..distributed.sharding import rules_for_family, sharding_rules

    long = shape_name == "long_500k"
    check_args(("params", "tokens") if kind == "prefill" else
               ("params", "cache", "tokens", "pos"), shard_kw["arg_specs"],
               shard_kw["in_shardings"], _mesh_sizes(mesh, multi_pod))
    dp = _dp(multi_pod)
    ctx = parallel.ParallelContext(mesh, multi_pod=multi_pod,
                                   spec_of=_lm_leaf_spec(dp))
    ctx.serve_layout(long, kind == "prefill")
    ctx.batch_rows = b
    lcfg = _local_cfg(cfg, ctx)
    rules = rules_for_family("lm", multi_pod=multi_pod)
    rows = (np.arange(b) if long else
            parallel.data_rows(b, 1, ctx.dp_size, ctx.dp_rank))

    def params_and_rng(device):
        dev = _registry.resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        params = parallel.init_shards(
            lambda: tf.init_params(cfg, dtype=cfg.dtype, generator=gen,
                                   device=dev),
            lambda: tf.init_params(cfg, dtype=cfg.dtype, device="meta"),
            lambda p, l: lm_param_spec(p, l, dp), mesh)
        return dev, params, np.random.default_rng(SEED)

    if kind == "prefill":
        @torch.inference_mode()
        def step(params, tokens):
            ctx.seq_len = tokens.shape[1]
            with sharding_rules(rules, ctx):
                return tf.prefill(params, tokens, lcfg,
                                  rope=rope(tokens.device))

        def init_args(device=None):
            dev, params, rng = params_and_rng(device)
            tokens = _lm_tokens(rng, cfg, (b, s))[rows]
            return params, torch.from_numpy(tokens).to(dev)
    else:
        @torch.inference_mode()
        def step(params, cache, tokens, pos):
            with sharding_rules(rules, ctx):
                return tf.decode_step(params, cache, tokens, pos, lcfg,
                                      rope=rope(tokens.device))

        def init_args(device=None):
            dev, params, rng = params_and_rng(device)
            tokens = _lm_tokens(rng, cfg, (b,))[rows]
            cache = tf.init_cache(cfg, len(rows), s // ctx.seq_size,
                                  device=dev)
            return (params, cache, torch.from_numpy(tokens).to(dev),
                    s // 2)

    return StepDef(name=f"{spec.arch_id}:{shape_name}:{kind}", fn=step,
                   model_flops=flops, init_args=init_args, **shard_kw)


# --------------------------------------------------------------------------- #
# GNN family                                                                   #
# --------------------------------------------------------------------------- #
def gnn_model_flops(cfg: gnn_mod.GATConfig, shape: dict) -> float:
    """Analytic model FLOPs of one training step (forward and twice its
    backward): ``repro.launch.steps``'s count."""
    kind = shape["kind"]
    h, dh, c = cfg.n_heads, cfg.d_hidden, cfg.n_classes
    if kind == "gnn_minibatch":
        b = shape["batch_nodes"]
        f1, f2 = shape["fanout"]
        n_eff = b * (1 + f1 + f1 * f2)
        e_eff = b * f1 + b * f1 * f2 + b * (f1 + 1)
        d_in = shape["d_feat"]
    elif kind == "gnn_batched":
        n_eff = shape["batch"] * shape["n_nodes"]
        e_eff = shape["batch"] * shape["n_edges"]
        d_in = shape["d_feat"]
    else:
        n_eff, e_eff, d_in = (shape["n_nodes"], shape["n_edges"],
                              shape["d_feat"])
    l1 = 2 * n_eff * d_in * h * dh + e_eff * h * (4 * dh + 8)
    l2 = 2 * n_eff * (h * dh) * c + e_eff * (4 * c + 8)
    return 3 * (l1 + l2)


# the reference's reduced graphs
GNN_REDUCED = {"gnn_full": {"n_nodes": 64, "n_edges": 256},
               "gnn_minibatch": {"batch_nodes": 8, "fanout": (3, 2)},
               "gnn_batched": {"batch": 4, "n_nodes": 10, "n_edges": 20}}
# the full graph's nodes and edges are padded to multiples of this
GNN_PAD = 512


def _gnn_full_batch(rng, cfg, shape) -> dict:
    """The reference's full-graph batch: E random edges plus a self loop a
    node, nodes and edges padded to multiples of `GNN_PAD` (padded edges
    masked, padded nodes out of the loss)."""
    n, e, d = shape["n_nodes"], shape["n_edges"], shape["d_feat"]
    etot = e + n
    npad = -(-n // GNN_PAD) * GNN_PAD
    epad = -(-etot // GNN_PAD) * GNN_PAD
    src = rng.integers(0, n, etot).astype(np.int32)
    dst = rng.integers(0, n, etot).astype(np.int32)
    src[e:etot] = np.arange(n)
    dst[e:etot] = np.arange(n)
    return {
        "x": np.pad(rng.normal(size=(n, d)).astype(np.float32),
                    ((0, npad - n), (0, 0))),
        "src": np.pad(src, (0, epad - etot)),
        "dst": np.pad(dst, (0, epad - etot)),
        "edge_mask": np.arange(epad) < etot,
        "labels": np.pad(rng.integers(0, cfg.n_classes, n).astype(np.int32),
                         (0, npad - n)),
        "mask": np.arange(npad) < n,
    }


def _gnn_minibatch_batch(rng, cfg, shape) -> dict:
    b, (f1, f2), d = shape["batch_nodes"], shape["fanout"], shape["d_feat"]
    return {
        "x0": rng.normal(size=(b, d)).astype(np.float32),
        "x1": rng.normal(size=(b, f1, d)).astype(np.float32),
        "x2": rng.normal(size=(b, f1, f2, d)).astype(np.float32),
        "labels": rng.integers(0, cfg.n_classes, b).astype(np.int32),
    }


def _gnn_batched_batch(rng, cfg, shape) -> dict:
    g, n, e, d = (shape["batch"], shape["n_nodes"], shape["n_edges"],
                  shape["d_feat"])
    return {
        "x": rng.normal(size=(g, n, d)).astype(np.float32),
        "src": rng.integers(0, n, (g, e)).astype(np.int32),
        "dst": rng.integers(0, n, (g, e)).astype(np.int32),
        "labels": rng.integers(0, cfg.n_classes, g).astype(np.int32),
    }


GNN_REGIMES = {"gnn_full": (gnn_mod.loss_full, _gnn_full_batch),
               "gnn_minibatch": (gnn_mod.loss_minibatch,
                                 _gnn_minibatch_batch),
               "gnn_batched": (gnn_mod.loss_batched_graphs,
                               _gnn_batched_batch)}


def _gnn_batch_specs(shape: dict, dp) -> tuple:
    """(ArgSpec tree, Spec tree) of a regime's batch: the reference's."""
    f32, i32 = torch.float32, torch.int32
    kind, d = shape["kind"], shape["d_feat"]
    if kind == "gnn_full":
        n, e = shape["n_nodes"], shape["n_edges"]
        npad = -(-n // GNN_PAD) * GNN_PAD
        epad = -(-(e + n) // GNN_PAD) * GNN_PAD
        return ({"x": ArgSpec((npad, d), f32), "src": ArgSpec((epad,), i32),
                 "dst": ArgSpec((epad,), i32),
                 "edge_mask": ArgSpec((epad,), torch.bool),
                 "labels": ArgSpec((npad,), i32),
                 "mask": ArgSpec((npad,), torch.bool)},
                {"x": Spec(None, None), "src": Spec(dp), "dst": Spec(dp),
                 "edge_mask": Spec(dp), "labels": Spec(None),
                 "mask": Spec(None)})
    if kind == "gnn_minibatch":
        b, (f1, f2) = shape["batch_nodes"], shape["fanout"]
        return ({"x0": ArgSpec((b, d), f32), "x1": ArgSpec((b, f1, d), f32),
                 "x2": ArgSpec((b, f1, f2, d), f32),
                 "labels": ArgSpec((b,), i32)},
                {"x0": Spec(dp, None), "x1": Spec(dp, None, None),
                 "x2": Spec(dp, None, None, None), "labels": Spec(dp)})
    g, n, e = shape["batch"], shape["n_nodes"], shape["n_edges"]
    return ({"x": ArgSpec((g, n, d), f32), "src": ArgSpec((g, e), i32),
             "dst": ArgSpec((g, e), i32), "labels": ArgSpec((g,), i32)},
            {"x": Spec(dp, None, None), "src": Spec(dp, None),
             "dst": Spec(dp, None), "labels": Spec(dp)})


def _parallel_context(mesh, multi_pod: bool, layout: str):
    """The recsys and GAT steps' `distributed.parallel.ParallelContext`:
    "model" cuts the tables' rows alone, the data axes the batch's rows
    (``layout="rows"``) or the full graph's edges (``"edges"``)."""
    from ..distributed import parallel

    return parallel.ParallelContext(mesh, multi_pod=multi_pod, layout=layout)


def _split(what: str, n: int, parts: int) -> None:
    if n % parts:
        raise ValueError(f"{what} ({n}) does not split over {parts} ranks")


def check_gnn_sharding(shape: dict, dp: int) -> None:
    """What a sharded GAT step needs of the mesh: the full graph's padded
    edges and padded nodes, or the batch's rows, split over the ``dp``
    data ranks."""
    kind = shape["kind"]
    if kind == "gnn_full":
        epad = -(-(shape["n_edges"] + shape["n_nodes"]) // GNN_PAD) * GNN_PAD
        _split("the padded edges", epad, dp)
        _split("the padded nodes", -(-shape["n_nodes"] // GNN_PAD) * GNN_PAD,
               dp)
    elif kind == "gnn_minibatch":
        _split("the batch's seed nodes", shape["batch_nodes"], dp)
    else:
        _split("the batch's graphs", shape["batch"], dp)


def _gnn_local_batch(batch: dict, kind: str, pc) -> dict:
    """The rank's part of a GAT batch: the full graph's block of the edges
    (the node features, labels and mask whole: the model cuts its hidden
    node rows itself), or the batch's block of rows."""
    from ..distributed import parallel

    keys = ("src", "dst", "edge_mask") if kind == "gnn_full" else tuple(batch)
    n = batch[keys[0]].shape[0]
    rows = parallel.data_rows(n, 1, pc.dp_size, pc.dp_rank)
    return {k: v[rows] if k in keys else v for k, v in batch.items()}


def build_gnn_step(spec: ArchSpec, shape_name: str, *, reduced: bool,
                   multi_pod: bool = False, mesh=None,
                   shape_override: dict | None = None) -> StepDef:
    """A GAT training step: the regime's loss and its gradient, the clip at
    a global norm of 1 and AdamW(5e-3), in place.  The batch is drawn from
    the builder's ``default_rng(0)`` when ``init_args`` is called, as in
    the reference (a second call draws the next batch).

    With a ``mesh`` the parameters and their AdamW state are replicated
    on every rank (the reference's specs); ``gnn_full`` holds the rank's
    block of the padded edges, the input features, labels and mask whole,
    and between layers its block of the padded node rows
    (`models.gnn.forward_full`), its loss whole on every rank;
    ``gnn_minibatch`` and ``gnn_batched`` hold the rank's rows of the
    batch, their loss over the global count.  The gradients are summed
    over the data ranks.  "model" replicates every rank's work.  The
    returned loss is the global one on every rank."""
    cfg = spec.make_config(shape_name, reduced)
    shape = dict(spec.shapes[shape_name])
    if shape_override:
        shape.update(shape_override)
    kind = shape["kind"]
    if reduced:
        shape.update(GNN_REDUCED[kind])
        shape["d_feat"] = cfg.d_in
        shape["n_classes"] = cfg.n_classes
    opt = adamw(lr=5e-3)
    flops = gnn_model_flops(cfg, shape) if not reduced else 0.0
    loss_f, make_batch = GNN_REGIMES[kind]
    rng = np.random.default_rng(SEED)
    meta = gnn_mod.init_params(cfg, device="meta")
    pspec = tree_specs(meta, _replicated)
    pc = rules = None
    if mesh is not None:
        from ..distributed.sharding import rules_for_family, sharding_rules

        check_gnn_sharding(shape, _check_mesh(mesh, multi_pod)[0])
        pc = _parallel_context(mesh, multi_pod,
                               "edges" if kind == "gnn_full" else "rows")
        rules = rules_for_family("gnn", multi_pod=multi_pod)

    def grad_fn(params, batch):
        if pc is None:
            return gnn_mod.value_and_grad(loss_f, params, batch, cfg)
        with sharding_rules(rules, pc):
            loss, grads = gnn_mod.value_and_grad(loss_f, params, batch, cfg)
        pc.sum_replicated_grads(grads, pspec)
        return (pc.data_sum(loss) if pc.layout == "rows" else loss), grads

    def step(params, opt_state, batch):
        loss, grads = grad_fn(params, batch)
        gn = adamw_step_(opt, grads, opt_state, params)
        return {"loss": loss, "grad_norm": gn}

    def init_args(device=None):
        dev = _registry.resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        params = gnn_mod.init_params(cfg, generator=gen, device=dev)
        batch = make_batch(rng, cfg, shape)
        if pc is not None:
            batch = _gnn_local_batch(batch, kind, pc)
        return params, opt.init(params), _on(dev, batch)

    meta_state = opt.init(meta)
    ospec = tree_specs(meta_state, _replicated)
    batch_spec, bspec = _gnn_batch_specs(shape, _dp(multi_pod))
    return StepDef(name=f"{spec.arch_id}:{shape_name}:train", fn=step,
                   model_flops=flops, init_args=init_args,
                   arg_specs=(arg_specs_of(meta), arg_specs_of(meta_state),
                              batch_spec),
                   in_shardings=(pspec, ospec, bspec),
                   out_shardings=(pspec, ospec, None), donate_argnums=(0, 1),
                   grad_fn=grad_fn)


# --------------------------------------------------------------------------- #
# RecSys family                                                                #
# --------------------------------------------------------------------------- #
def rs_param_spec(path, leaf) -> Spec:
    """The reference's layout of a recsys leaf: the tables' rows over
    "model", the wide MLP weights column- (or row-) split over "model"."""
    keys = _path_keys(path)
    name = keys[-1]
    if len(leaf.shape) == 0 or name == "step":
        return Spec()
    if name in ("table", "items") or (name == "embed"
                                      and "layers" not in keys):
        return Spec("model", None)
    if name == "lm_head":
        return Spec(None, "model")
    if name == "w" and len(leaf.shape) == 2 and max(leaf.shape) >= 256:
        if leaf.shape[1] % 16 == 0 and leaf.shape[1] >= 256:
            return Spec(None, "model")
        if leaf.shape[0] % 16 == 0 and leaf.shape[0] >= 256:
            return Spec("model", None)
    return Spec(*(None,) * len(leaf.shape))


def _rs_batch_sharding(batch: dict, dp) -> dict:
    out = {}
    for k, v in batch.items():
        if k == "negatives":
            out[k] = Spec(None)
        elif v.ndim == 1:
            out[k] = Spec(dp)
        else:
            out[k] = Spec(*((dp,) + (None,) * (v.ndim - 1)))
    return out


def _np_arg_specs(batch: dict) -> dict:
    return {k: ArgSpec(v.shape, getattr(torch, v.dtype.name))
            for k, v in batch.items()}


def _mlp_flops(sizes):
    return sum(2 * a * b for a, b in zip(sizes[:-1], sizes[1:]))


def rs_model_flops(arch_id, cfg, shape) -> float:
    """Analytic model FLOPs of one step: ``repro.launch.steps``'s count for
    the ported archs."""
    kind = shape["kind"]
    b = shape.get("batch", 1)
    if arch_id == "dlrm-mlperf":
        n_int = (cfg.n_sparse + 1) * cfg.n_sparse // 2
        per = _mlp_flops((cfg.n_dense,) + cfg.bot_mlp) + \
            (cfg.n_sparse + 1) ** 2 * cfg.embed_dim * 2 + \
            _mlp_flops((n_int + cfg.bot_mlp[-1],) + cfg.top_mlp)
    elif arch_id == "wide-deep":
        n_f = len(cfg.vocab_sizes)
        per = _mlp_flops((n_f * cfg.embed_dim + cfg.n_dense,) + cfg.deep_mlp
                         + (1,))
    elif arch_id == "mind":
        d, s, k = cfg.embed_dim, cfg.hist_len, cfg.n_interests
        per = 2 * s * d * d + cfg.capsule_iters * (4 * s * k * d)
        if kind == "rs_train":
            per += 2 * k * d * (1 + cfg.n_neg)
    elif arch_id == "bert4rec":
        d, s = cfg.embed_dim, cfg.seq_len
        per_layer = 2 * s * (4 * d * d + 3 * d * 4 * d) + 4 * s * s * d
        per = cfg.n_blocks * per_layer
        if kind == "rs_train":
            per += 2 * s * d * (1 + cfg.n_neg)
    else:
        raise KeyError(arch_id)
    if kind == "rs_retrieval":
        if arch_id in ("mind", "bert4rec"):
            per += 2 * shape["n_candidates"] * cfg.embed_dim * (
                cfg.n_interests if arch_id == "mind" else 1)
        else:
            per = per * shape["n_candidates"]  # a ranking forward a candidate
        return per * b
    return per * b * (3 if kind == "rs_train" else 1)


def _rs_init_model(arch_id, cfg, generator, device):
    if arch_id == "dlrm-mlperf":
        return rs.dlrm_init(cfg, generator=generator, device=device)
    if arch_id == "wide-deep":
        return rs.widedeep_init(cfg, generator=generator, device=device)
    if arch_id == "mind":
        return rs.mind_init(cfg, generator=generator, device=device)
    if arch_id == "bert4rec":
        return rs.bert4rec_init(cfg, generator=generator, device=device)
    raise KeyError(arch_id)


def _rs_batch(arch_id, cfg, b, rng, kind):
    """The concrete numpy batch of ``repro.launch.steps._rs_batch``: the
    same arrays for the same generator state."""
    if arch_id in ("dlrm-mlperf", "wide-deep"):
        nf = cfg.n_sparse if arch_id == "dlrm-mlperf" else len(cfg.vocab_sizes)
        vmax = min(cfg.vocab_sizes)
        batch = {
            "dense": rng.normal(size=(b, cfg.n_dense)).astype(np.float32),
            "sparse": rng.integers(0, vmax, (b, nf)).astype(np.int32),
            "labels": rng.integers(0, 2, b).astype(np.float32),
        }
    elif arch_id == "mind":
        batch = {
            "hist": rng.integers(-1, cfg.n_items,
                                 (b, cfg.hist_len)).astype(np.int32),
            "target": rng.integers(0, cfg.n_items, b).astype(np.int32),
            "negatives": rng.integers(0, cfg.n_items,
                                      cfg.n_neg).astype(np.int32),
        }
    else:  # bert4rec
        lab = rng.integers(0, cfg.n_items, (b, cfg.seq_len)).astype(np.int32)
        masked = rng.random((b, cfg.seq_len)) < 0.2
        batch = {
            "seq": np.where(masked, cfg.n_items,
                            rng.integers(0, cfg.n_items,
                                         (b, cfg.seq_len))).astype(np.int32),
            "labels": np.where(masked, lab, -1).astype(np.int32),
            "negatives": rng.integers(0, cfg.n_items,
                                      cfg.n_neg).astype(np.int32),
        }
    if kind == "rs_serve":
        batch.pop("labels", None)
        batch.pop("negatives", None)
        batch.pop("target", None)
    return batch


def _on(device, arrays: dict) -> dict:
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}


def route(path) -> str:
    """The MLPerf recipe's routing: the embedding tables to row-wise SGD,
    every other leaf to AdamW (``repro.launch.steps``'s route over the
    same paths)."""
    keys = [str(k) for k in path]
    return "rows" if any(k in ("table", "items", "embed")
                         and "layers" not in keys for k in keys) else "dense"


def train_optimizer():
    return partition_optimizer(route, {"rows": sgd(lr=1e-2),
                                       "dense": adamw(lr=1e-3)})


def check_rs_sharding(arch_id: str, meta, shape: dict, dp: int,
                      tp: int) -> None:
    """What a sharded recsys step needs of the mesh: every leaf that
    `rs_param_spec` cuts over "model" (the tables' rows, the wide MLP
    weights) split into ``tp`` blocks, and the batch's rows (training,
    serving) or the ranking archs' candidates over the ``dp`` data ranks.
    ValueError where they do not: no table is padded silently."""
    def leaf(path, t):
        spec = rs_param_spec(path, t)
        for dim, n in enumerate(t.shape):
            if spec.axes(dim):
                _split(f"{arch_id} {'.'.join(map(str, path))} dim {dim}", n,
                       tp)
    tree_map_with_path(leaf, meta)
    kind = shape["kind"]
    if kind != "rs_retrieval":
        _split("the batch's rows", shape["batch"], dp)
    elif arch_id in ("dlrm-mlperf", "wide-deep"):
        _split("the candidates", shape["n_candidates"], dp)


def _local_top_k(pc, scores, lo: int, counts, over: str, k: int = 100):
    """The top ``k`` of a rank's (B, n) ``scores`` of the candidates
    ``lo .. lo + n - 1``, merged with the other ranks' over ``over``
    (`ParallelContext.merge_top_k`; ``counts``: every rank's n)."""
    vals, idx = top_k(scores, min(k, scores.shape[1]))
    return pc.merge_top_k(vals, idx + lo, k, [min(k, c) for c in counts],
                          over)


def build_rs_step(spec: ArchSpec, shape_name: str, *, reduced: bool,
                  multi_pod: bool = False, mesh=None,
                  shape_override: dict | None = None) -> StepDef:
    """A recsys step: ``rs_train`` (the loss, its gradient and the MLPerf
    split: row-wise SGD on the tables, AdamW on the rest), ``rs_serve``
    (the forward, or BERT4Rec's user representation) or ``rs_retrieval``
    (the top 100 of the candidates).

    With a ``mesh`` every leaf is held as the rank's shard of
    `rs_param_spec` (the tables' rows over "model"; a module over the
    shards, `models.recsys.from_tree`), and the batch's rows (or the
    ranking archs' candidates) are the rank's block over the data axes
    (the negatives replicated).  A training step's loss is the global
    mean, its table gradients the row gradients of every data rank's
    occurrences and its dense gradients summed over the data ranks; a
    serving step returns the whole batch's outputs on every rank; a
    retrieval step merges the ranks' top lists (the ranking archs' over
    the data ranks, MIND's and BERT4Rec's candidate rows, ``table[:C]``,
    over the model ranks that hold them), in `utils.top_k`'s order."""
    arch_id = spec.arch_id
    cfg = spec.make_config(shape_name, reduced)
    shape = dict(spec.shapes[shape_name])
    if shape_override:
        shape.update(shape_override)
    if reduced:
        shape = {**shape, "batch": 8, "n_candidates": 128}
    kind = shape["kind"]
    rng = np.random.default_rng(SEED)
    flops = rs_model_flops(arch_id, cfg, shape) if not reduced else 0.0
    b = shape.get("batch", 1)
    dp = _dp(multi_pod)
    meta_model = _rs_init_model(arch_id, cfg, None, "meta")
    meta = meta_model if isinstance(meta_model, dict) else meta_model.tree()
    pspec = tree_specs(meta, rs_param_spec)
    pc = rules = None
    if mesh is not None:
        from ..distributed import parallel
        from ..distributed.sharding import rules_for_family, sharding_rules

        n_dp, n_tp = _check_mesh(mesh, multi_pod)
        check_rs_sharding(arch_id, meta, shape, n_dp, n_tp)
        pc = _parallel_context(mesh, multi_pod, "rows")
        rules = rules_for_family("recsys", multi_pod=multi_pod)
        rows = parallel.data_rows(b, 1, pc.dp_size, pc.dp_rank) \
            if kind != "rs_retrieval" else None

    def sharded(fn):
        """``fn`` under the step's rules (as it is without a mesh)."""
        if pc is None:
            return fn

        def run(*args):
            with sharding_rules(rules, pc):
                return fn(*args)
        return run

    def init_model(device):
        dev = _registry.resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        model = _rs_init_model(arch_id, cfg, gen, dev)
        if pc is None:
            return dev, model
        tree = model if isinstance(model, dict) else model.tree()
        return dev, rs.from_tree(arch_id, cfg,
                                 parallel.shard_tree(tree, pspec, mesh))

    def local_batch(dev, np_batch):
        if pc is not None:
            np_batch = {k: v if k == "negatives" else v[rows]
                        for k, v in np_batch.items()}
        return _on(dev, np_batch)

    if kind == "rs_train":
        opt = train_optimizer()
        np_batch = _rs_batch(arch_id, cfg, b, rng, kind)
        if arch_id == "bert4rec":
            def value_and_grad(params, batch):
                return (*rs.bert4rec_value_and_grad(params, batch, cfg),
                        params)
        else:
            loss_f = rs.LOSSES[arch_id]

            def value_and_grad(model, batch):
                return (*rs.value_and_grad(loss_f, model, batch),
                        model.tree())
        value_and_grad = sharded(value_and_grad)

        def step(model, opt_state, batch):
            loss, grads, params = value_and_grad(model, batch)
            if pc is not None:
                pc.sum_replicated_grads(grads, pspec)
                loss = pc.data_sum(loss)
            upd, new_state = opt.update(grads, opt_state, params)
            apply_updates(params, upd)
            with torch.no_grad():
                tree_map(lambda old, new: old.copy_(new), opt_state, new_state)
            return {"loss": loss}

        def init_args(device=None):
            dev, model = init_model(device)
            params = model if isinstance(model, dict) else model.tree()
            return model, opt.init(params), local_batch(dev, np_batch)

        meta_state = opt.init(meta)
        ospec = tree_specs(meta_state, rs_param_spec)
        return StepDef(name=f"{arch_id}:{shape_name}:train", fn=step,
                       model_flops=flops, init_args=init_args,
                       arg_specs=(arg_specs_of(meta),
                                  arg_specs_of(meta_state),
                                  _np_arg_specs(np_batch)),
                       in_shardings=(pspec, ospec,
                                     _rs_batch_sharding(np_batch, dp)),
                       out_shardings=(pspec, ospec, None),
                       donate_argnums=(0, 1))

    if kind == "rs_serve":
        np_batch = _rs_batch(arch_id, cfg, b, rng, kind)
        fwd = {"dlrm-mlperf": lambda m, b_: m(b_["dense"], b_["sparse"]),
               "wide-deep": lambda m, b_: m(b_["dense"], b_["sparse"]),
               "mind": lambda m, b_: m(b_["hist"]),
               "bert4rec": lambda p, b_: rs.bert4rec_user_repr(p, b_["seq"],
                                                               cfg)}[arch_id]
        fwd = sharded(fwd)

        @torch.inference_mode()
        def step(model, batch):
            out = fwd(model, batch)
            return out if pc is None else pc.gather_data_rows(out)

        def init_args(device=None):
            dev, model = init_model(device)
            return model, local_batch(dev, np_batch)

        return StepDef(name=f"{arch_id}:{shape_name}:serve", fn=step,
                       model_flops=flops, init_args=init_args,
                       arg_specs=(arg_specs_of(meta), _np_arg_specs(np_batch)),
                       in_shardings=(pspec, _rs_batch_sharding(np_batch, dp)))

    # rs_retrieval: one query scored against n_candidates, top-100 in
    # jax.lax.top_k's order (equal scores by candidate index)
    c = shape["n_candidates"]
    i32 = torch.int32
    if arch_id in ("mind", "bert4rec"):
        qfield = "hist" if arch_id == "mind" else "seq"
        qlen = cfg.hist_len if arch_id == "mind" else cfg.seq_len
        q_spec = {qfield: ArgSpec((b, qlen), i32)}
        qshard = {qfield: Spec(None, None)}
        table_rows = (cfg.n_items if arch_id == "mind"
                      else cfg.tf_config().vocab)

        def candidates(table):
            """(the rank's rows of ``table[:c]``, the first one's index,
            every model rank's count of them)."""
            if pc is None:
                return table[:c], 0, [c]
            v = table_rows // pc.tp_size
            counts = [min(max(c - r * v, 0), v) for r in range(pc.tp_size)]
            return table[:counts[pc.tp_rank]], pc.tp_rank * v, counts

        def merged(scores, lo, counts):
            if pc is None:
                return top_k(scores, 100)
            return _local_top_k(pc, scores, lo, counts, "model")
    else:
        nf = cfg.n_sparse if arch_id == "dlrm-mlperf" else len(cfg.vocab_sizes)
        q_spec = {"dense": ArgSpec((1, cfg.n_dense), torch.float32),
                  "sparse": ArgSpec((1, nf), i32), "cand_ids": ArgSpec((c,), i32)}
        qshard = {"dense": Spec(None, None), "sparse": Spec(None, None),
                  "cand_ids": Spec(dp)}
    if arch_id == "bert4rec":
        @torch.inference_mode()
        @sharded
        def step(params, query):
            u = rs.bert4rec_user_repr(params, query["seq"], cfg)
            cand, lo, counts = candidates(params["embed"])
            return merged(u @ cand.T, lo, counts)

        def init_args(device=None):
            dev, params = init_model(device)
            seq = rng.integers(0, cfg.n_items, (b, cfg.seq_len))
            return params, _on(dev, {"seq": seq.astype(np.int32)})
    elif arch_id == "mind":
        @torch.inference_mode()
        @sharded
        def step(model, query):
            cand, lo, counts = candidates(model.items)
            return merged(model.score_candidates(query["hist"], cand), lo,
                          counts)

        def init_args(device=None):
            dev, model = init_model(device)
            hist = rng.integers(0, cfg.n_items, (b, cfg.hist_len))
            return model, _on(dev, {"hist": hist.astype(np.int32)})
    else:
        # ranking archs: a fixed user, field 0 set to each candidate id
        vmax = min(cfg.vocab_sizes)

        @torch.inference_mode()
        @sharded
        def step(model, query):
            scores = rs.rank_candidates(model, query["dense"],
                                        query["sparse"], query["cand_ids"])
            if pc is None:
                vals, idx = top_k(scores[None], 100)
            else:
                n = scores.shape[0]
                vals, idx = _local_top_k(pc, scores[None], pc.dp_rank * n,
                                         [n] * pc.dp_size, "data")
            return vals[0], idx[0]

        def init_args(device=None):
            dev, model = init_model(device)
            q = {"dense": rng.normal(size=(1, cfg.n_dense)).astype(np.float32),
                 "sparse": rng.integers(0, vmax, (1, nf)).astype(np.int32),
                 "cand_ids": rng.integers(0, vmax, (c,)).astype(np.int32)}
            if pc is not None:
                q["cand_ids"] = q["cand_ids"][parallel.data_rows(
                    c, 1, pc.dp_size, pc.dp_rank)]
            return model, _on(dev, q)

    return StepDef(name=f"{arch_id}:{shape_name}:retrieval", fn=step,
                   model_flops=flops, init_args=init_args,
                   arg_specs=(arg_specs_of(meta), q_spec),
                   in_shardings=(pspec, qshard))


# --------------------------------------------------------------------------- #
# Entry                                                                        #
# --------------------------------------------------------------------------- #
def build_step(arch_id: str, shape_name: str, *, multi_pod: bool = False,
               reduced: bool = False, shape_override: dict | None = None,
               cfg_override: dict | None = None, mesh=None) -> StepDef:
    """The step of ``arch_id`` at ``shape_name``: ``reduced`` = the arch's
    small config (LMs: 4 sequences of 32 tokens; the GAT: the reference's
    small graphs; recsys: batch 8 and 128 candidates, as in the JAX
    package); ``shape_override`` replaces entries of the shape,
    ``cfg_override`` fields of an LM's config;
    ``multi_pod`` lays the specs (and a ``mesh``'s data axes) over ("pod",
    "data").  With a ``mesh`` (a `DeviceMesh` over ("data", "model"), or
    ("pod", "data", "model") with ``multi_pod``) every family's steps run
    sharded over it: the LMs' (`build_lm_step`), the recsys steps'
    (`build_rs_step`: the tables' rows over "model", the batch over the
    data axes) and the GAT's (`build_gnn_step`: the full graph's edges, or
    the batch, over the data axes)."""
    spec = get_arch(arch_id)
    if shape_name in spec.skip_shapes:
        raise ValueError(f"{arch_id}:{shape_name} skipped: "
                         f"{spec.skip_shapes[shape_name]}")
    if spec.family == "lm":
        return build_lm_step(spec, shape_name, reduced=reduced,
                             multi_pod=multi_pod, mesh=mesh,
                             shape_override=shape_override,
                             cfg_override=cfg_override)
    if spec.family == "recsys":
        return build_rs_step(spec, shape_name, reduced=reduced,
                             multi_pod=multi_pod, mesh=mesh,
                             shape_override=shape_override)
    return build_gnn_step(spec, shape_name, reduced=reduced,
                          multi_pod=multi_pod, mesh=mesh,
                          shape_override=shape_override)
