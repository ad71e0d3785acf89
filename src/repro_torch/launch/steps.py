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

``StepDef`` keeps the JAX package's ``name``, ``fn``, ``model_flops`` and
``init_args``; its PartitionSpec, sharding and donation fields have no
meaning on one card and are left out (a decode step writes its cache in
place, where the reference donates it).  The batch or the tokens are the
JAX package's numpy arrays for the same ``default_rng(0)``; the parameters
are made on the device from a seeded ``torch.Generator``
(``params_from_jax`` of `models.recsys`, `models.transformer` and
`models.gnn` carries the JAX package's own instead).  An LM's serving
steps hold its parameters in its compute dtype (bfloat16 at full width),
which they compute in anyway; its training step holds them in float32
(``cfg.param_dtype``), as the reference.  A training step updates the
parameters and the optimizer state in place and returns its metrics
(``{"loss"}``; with ``"grad_norm"`` for the LMs and the GAT, whose
AdamW runs in place, `optim.adamw`'s ``update_``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..configs.registry import ArchSpec, get_arch, list_archs  # noqa: F401
from ..kernels import registry as _registry
from ..models import gnn as gnn_mod
from ..models import recsys as rs
from ..models import transformer as tf
from ..models.layers import rope_freqs
from ..optim import (adamw, apply_updates, clip_by_global_norm_,
                     partition_optimizer, sgd)
from ..utils import top_k, tree_leaves, tree_map

SEED = 0


@dataclasses.dataclass
class StepDef:
    name: str
    fn: Callable
    model_flops: float
    init_args: Callable   # (device=None) -> concrete args, on the card by default


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
    for i in range(0, b, mb):
        loss = tf.loss_fn(view, {k: v[i:i + mb] for k, v in batch.items()},
                          cfg, rope=rope)
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


def build_lm_step(spec: ArchSpec, shape_name: str, *, reduced: bool,
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
    tables = {}

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

        def step(params, opt_state, batch):
            loss, grads = lm_grads(params, batch, cfg, accum,
                                   rope=rope(batch["tokens"].device))
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
                       model_flops=flops, init_args=init_args)

    if kind == "prefill":
        @torch.inference_mode()
        def step(params, tokens):
            return tf.prefill(params, tokens, cfg, rope=rope(tokens.device))

        def init_args(device=None):
            dev, params = init_params(device)
            rng = np.random.default_rng(SEED)
            return params, torch.from_numpy(_lm_tokens(rng, cfg,
                                                       (b, s))).to(dev)

        return StepDef(name=f"{spec.arch_id}:{shape_name}:prefill", fn=step,
                       model_flops=flops, init_args=init_args)

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
                   model_flops=flops, init_args=init_args)


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


def build_gnn_step(spec: ArchSpec, shape_name: str, *, reduced: bool,
                   shape_override: dict | None = None) -> StepDef:
    """A GAT training step: the regime's loss and its gradient, the clip at
    a global norm of 1 and AdamW(5e-3), in place.  The batch is drawn from
    the builder's ``default_rng(0)`` when ``init_args`` is called, as in
    the reference (a second call draws the next batch)."""
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

    def step(params, opt_state, batch):
        loss, grads = gnn_mod.value_and_grad(loss_f, params, batch, cfg)
        gn = adamw_step_(opt, grads, opt_state, params)
        return {"loss": loss, "grad_norm": gn}

    def init_args(device=None):
        dev = _registry.resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        params = gnn_mod.init_params(cfg, generator=gen, device=dev)
        return params, opt.init(params), _on(dev, make_batch(rng, cfg, shape))

    return StepDef(name=f"{spec.arch_id}:{shape_name}:train", fn=step,
                   model_flops=flops, init_args=init_args)


# --------------------------------------------------------------------------- #
# RecSys family                                                                #
# --------------------------------------------------------------------------- #
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


def build_rs_step(spec: ArchSpec, shape_name: str, *, reduced: bool,
                  shape_override: dict | None = None) -> StepDef:
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

    def init_model(device):
        dev = _registry.resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        return dev, _rs_init_model(arch_id, cfg, gen, dev)

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

        def step(model, opt_state, batch):
            loss, grads, params = value_and_grad(model, batch)
            upd, new_state = opt.update(grads, opt_state, params)
            apply_updates(params, upd)
            with torch.no_grad():
                tree_map(lambda old, new: old.copy_(new), opt_state, new_state)
            return {"loss": loss}

        def init_args(device=None):
            dev, model = init_model(device)
            params = model if isinstance(model, dict) else model.tree()
            return model, opt.init(params), _on(dev, np_batch)

        return StepDef(name=f"{arch_id}:{shape_name}:train", fn=step,
                       model_flops=flops, init_args=init_args)

    if kind == "rs_serve":
        np_batch = _rs_batch(arch_id, cfg, b, rng, kind)
        fwd = {"dlrm-mlperf": lambda m, b_: m(b_["dense"], b_["sparse"]),
               "wide-deep": lambda m, b_: m(b_["dense"], b_["sparse"]),
               "mind": lambda m, b_: m(b_["hist"]),
               "bert4rec": lambda p, b_: rs.bert4rec_user_repr(p, b_["seq"],
                                                               cfg)}[arch_id]

        @torch.inference_mode()
        def step(model, batch):
            return fwd(model, batch)

        def init_args(device=None):
            dev, model = init_model(device)
            return model, _on(dev, np_batch)

        return StepDef(name=f"{arch_id}:{shape_name}:serve", fn=step,
                       model_flops=flops, init_args=init_args)

    # rs_retrieval: one query scored against n_candidates, top-100 in
    # jax.lax.top_k's order (equal scores by candidate index)
    c = shape["n_candidates"]
    if arch_id == "bert4rec":
        @torch.inference_mode()
        def step(params, query):
            u = rs.bert4rec_user_repr(params, query["seq"], cfg)
            return top_k(u @ params["embed"][:c].T, 100)

        def init_args(device=None):
            dev, params = init_model(device)
            seq = rng.integers(0, cfg.n_items, (b, cfg.seq_len))
            return params, _on(dev, {"seq": seq.astype(np.int32)})
    elif arch_id == "mind":
        @torch.inference_mode()
        def step(model, query):
            cand = model.items[:c]
            return top_k(model.score_candidates(query["hist"], cand), 100)

        def init_args(device=None):
            dev, model = init_model(device)
            hist = rng.integers(0, cfg.n_items, (b, cfg.hist_len))
            return model, _on(dev, {"hist": hist.astype(np.int32)})
    else:
        # ranking archs: a fixed user, field 0 set to each candidate id
        nf = cfg.n_sparse if arch_id == "dlrm-mlperf" else len(cfg.vocab_sizes)
        vmax = min(cfg.vocab_sizes)

        @torch.inference_mode()
        def step(model, query):
            scores = rs.rank_candidates(model, query["dense"],
                                        query["sparse"], query["cand_ids"])
            vals, idx = top_k(scores[None], 100)
            return vals[0], idx[0]

        def init_args(device=None):
            dev, model = init_model(device)
            q = {"dense": rng.normal(size=(1, cfg.n_dense)).astype(np.float32),
                 "sparse": rng.integers(0, vmax, (1, nf)).astype(np.int32),
                 "cand_ids": rng.integers(0, vmax, (c,)).astype(np.int32)}
            return model, _on(dev, q)

    return StepDef(name=f"{arch_id}:{shape_name}:retrieval", fn=step,
                   model_flops=flops, init_args=init_args)


# --------------------------------------------------------------------------- #
# Entry                                                                        #
# --------------------------------------------------------------------------- #
def build_step(arch_id: str, shape_name: str, *, reduced: bool = False,
               shape_override: dict | None = None,
               cfg_override: dict | None = None) -> StepDef:
    """The step of ``arch_id`` at ``shape_name``: ``reduced`` = the arch's
    small config (LMs: 4 sequences of 32 tokens; the GAT: the reference's
    small graphs; recsys: batch 8 and 128 candidates, as in the JAX
    package); ``shape_override`` replaces entries of the shape,
    ``cfg_override`` fields of an LM's config."""
    spec = get_arch(arch_id)
    if shape_name in spec.skip_shapes:
        raise ValueError(f"{arch_id}:{shape_name} skipped: "
                         f"{spec.skip_shapes[shape_name]}")
    if spec.family == "lm":
        return build_lm_step(spec, shape_name, reduced=reduced,
                             shape_override=shape_override,
                             cfg_override=cfg_override)
    builder = {"gnn": build_gnn_step, "recsys": build_rs_step}[spec.family]
    return builder(spec, shape_name, reduced=reduced,
                   shape_override=shape_override)
