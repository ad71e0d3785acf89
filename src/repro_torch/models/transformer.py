"""Decoder-only transformer LM of the port: ``repro.models.transformer``
(the five LM architectures), serving and training.

* GQA or MLA attention; dense (gated or plain) or MoE FFN in each layer.
* Layer patterns, cycled: 'full' | 'local' (chunked window, llama4's
  iRoPE) | 'global_nope' (full attention without RoPE).  The layers'
  parameters are stacked (G, p, ...): G groups of one pattern period p, as
  the reference scans them; here a Python loop walks them.
* `forward` (hidden states), `prefill` (last-token logits and the KV
  cache) and `decode_step` (one token, the cache written in place where
  the reference donates it).
* `lm_loss` (the cross-entropy, chunked over the tokens by
  ``cfg.xent_chunk``) and `loss_fn`.  Under autograd `forward` runs each
  pattern group under ``torch.utils.checkpoint`` when ``cfg.remat`` is
  set, and `lm_loss` each chunk under its own: the reference's
  ``jax.checkpoint`` boundaries, so the backward recomputes what JAX's
  does.

Every step casts each parameter to ``cfg.dtype`` at use, as the reference
does, so parameters held in ``cfg.dtype`` (`init_params(dtype=cfg.dtype)`,
half the memory of the reference's float32 tree) give the same bits as the
float32 tree.  Training holds them in ``cfg.param_dtype`` (float32) and
casts each layer inside its checkpointed group, so the backward recomputes
the bfloat16 copies instead of keeping them.  The parameters are a plain
dict of tensors in the JAX pytree's layout (`params_from_jax` /
`params_to_jax` carry them across); `train_view` makes its leaves autograd
leaves whose gradients land in a tree of the same layout.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..distributed.parallel import gather_seq
from ..distributed.sharding import (constrain, current_context,
                                    gather_layer_params, scoped)
from ..kernels import registry as _registry
from ..utils import (grad_view, to_numpy, to_tensor, tree_leaves, tree_map,
                     tree_map_with_path)
from .attention import (MLADims, gqa_decode, gqa_forward, gqa_params,
                        mla_decode, mla_forward, mla_params)
from .layers import ACTIVATIONS, rms_norm, rope_freqs, uniform_init
from .moe import MoEConfig, moe_apply, moe_params


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    act: str = "silu"
    gated_ffn: bool = True               # SwiGLU-style if True, plain MLP else
    attn: str = "gqa"                    # 'gqa' | 'mla'
    mla: MLADims | None = None
    moe: MoEConfig | None = None
    rope_theta: float = 10000.0
    max_seq: int = 8192
    layer_pattern: tuple = ("full",)
    local_window: int = 8192
    chunk_q: int | None = None
    xent_chunk: int | None = None        # tokens a cross-entropy chunk
    remat: bool = True                   # recompute each group's forward
    dtype: torch.dtype = torch.float32   # compute dtype
    param_dtype: torch.dtype = torch.float32
    aux_loss_weight: float = 0.01
    z_loss_weight: float = 1e-3

    @property
    def pattern_period(self) -> int:
        return len(self.layer_pattern)

    @property
    def n_groups(self) -> int:
        if self.n_layers % self.pattern_period:
            raise ValueError(f"{self.n_layers} layers are not whole periods "
                             f"of {self.layer_pattern}")
        return self.n_layers // self.pattern_period

    @property
    def rope_dim(self) -> int:
        return self.mla.qk_rope if self.attn == "mla" else self.head_dim


# --------------------------------------------------------------------------- #
# Params                                                                       #
# --------------------------------------------------------------------------- #
def init_params(cfg: TransformerConfig, *, dtype=None, generator=None,
                device=None) -> dict:
    """Random parameters in the reference's layout, each layer leaf stacked
    (G, p, ...), uniform in ``1 / sqrt(fan_in)`` and the norms ones.  In
    ``dtype`` (a serving step holds them in ``cfg.dtype``); by default the
    reference's dtypes, ``cfg.param_dtype`` and a float32 MoE router."""
    pdt = cfg.param_dtype if dtype is None else dtype
    lead = (cfg.n_groups, cfg.pattern_period)
    kw = dict(lead=lead, dtype=pdt, generator=generator, device=device)
    if cfg.attn == "mla":
        m = cfg.mla
        attn = mla_params(cfg.d_model, cfg.n_heads, m.q_lora, m.kv_lora,
                          m.qk_nope, m.qk_rope, m.v_head, **kw)
    else:
        attn = gqa_params(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                          cfg.head_dim, **kw)
    if cfg.moe is not None:
        ffn = moe_params(cfg.moe, router_dtype=torch.float32
                         if dtype is None else dtype, **kw)
    else:
        d, f = cfg.d_model, cfg.d_ff
        ffn = {"w1": uniform_init((d, f), **kw)}
        if cfg.gated_ffn:
            ffn["w3"] = uniform_init((d, f), **kw)
        ffn["w2"] = uniform_init((f, d), **kw)
    ones = dict(dtype=pdt, device=device)
    flat = dict(dtype=pdt, generator=generator, device=device)
    return {
        "embed": uniform_init((cfg.vocab, cfg.d_model), **flat),
        "layers": {"attn": attn, "ffn": ffn,
                   "attn_norm": torch.ones(lead + (cfg.d_model,), **ones),
                   "ffn_norm": torch.ones(lead + (cfg.d_model,), **ones)},
        "final_norm": torch.ones((cfg.d_model,), **ones),
        "lm_head": uniform_init((cfg.d_model, cfg.vocab), **flat),
    }


def param_count(params) -> int:
    return sum(int(p.numel()) for p in tree_leaves(params))


def params_from_jax(tree, cfg: TransformerConfig, device=None,
                    dtype=None) -> dict:
    """The JAX package's parameter pytree (numpy leaves; bfloat16 leaves
    moved as their bits) as tensors on ``device`` (default: the card), cast
    to ``dtype`` if given.  The tree must have `init_params`' structure and
    shapes for ``cfg``."""
    dev = _registry.resolve_device(device)
    want = init_params(cfg, device="meta")
    if _keys(tree) != _keys(want):
        raise ValueError("the tree's structure is not the config's")

    def leaf(path, a, w):
        t = to_tensor(a, dev)
        if tuple(t.shape) != tuple(w.shape):
            raise ValueError(f"{'.'.join(map(str, path))} has shape "
                             f"{tuple(t.shape)}, the config wants "
                             f"{tuple(w.shape)}")
        return t if dtype is None else t.to(dtype)

    return tree_map_with_path(leaf, tree, want)


def _keys(tree):
    """A dict tree's nested keys, its leaves None."""
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()}
    return None


def params_to_jax(params) -> dict:
    """The inverse of `params_from_jax`: numpy leaves (a bfloat16 leaf as
    the float32 array of its values)."""
    return tree_map(to_numpy, params)


# --------------------------------------------------------------------------- #
# Forward                                                                      #
# --------------------------------------------------------------------------- #
def _rope(cfg: TransformerConfig, rope, device):
    """The (cos, sin) tables given, or the config's, on ``device``."""
    if rope is not None:
        return rope
    return rope_freqs(cfg.rope_dim, cfg.max_seq, cfg.rope_theta,
                      device=device)


def group_params(params, gi: int):
    """Group ``gi``'s parameters, each leaf (p, ...): a view of the stacked
    (G, p, ...) leaves, or the group's own tree where `train_view` split
    the stack into a list of groups."""
    layers = params["layers"]
    if isinstance(layers, list):
        return layers[gi]
    return tree_map(lambda a: a[gi], layers)


def layer_params(params, cfg: TransformerConfig):
    """(layer index, kind, the layer's parameters in ``cfg.dtype``) in
    order: group by group, the pattern within each; in the sharded step
    each layer's shards gathered at use (`gather_layer_params`)."""
    for gi in range(cfg.n_groups):
        gp = group_params(params, gi)
        for j, kind in enumerate(cfg.layer_pattern):
            yield gi * cfg.pattern_period + j, kind, gather_layer_params(
                tree_map(lambda a: a[j], gp), cfg.dtype)


def train_view(params, grads, cfg: TransformerConfig) -> dict:
    """``params`` for a backward: every leaf an autograd leaf over the
    leaf's own storage whose ``.grad`` is the matching leaf of ``grads``
    (`utils.grad_view`), the layer stacks split into a list of their G
    groups (one leaf a group, so that a group's backward writes its slice
    of the stack's gradient and no (G, p, ...) tensor of zeros around
    it)."""
    out = {k: grad_view(v, grads[k]) for k, v in params.items()
           if k != "layers"}
    out["layers"] = [grad_view(tree_map(lambda a: a[gi], params["layers"]),
                               tree_map(lambda a: a[gi], grads["layers"]))
                     for gi in range(cfg.n_groups)]
    return out


def ffn_apply(lp, x, cfg: TransformerConfig):
    """The FFN over x: (..., d) -> (y, MoE aux values or None).  Under
    tensor parallelism y is this rank's partial sum (its FFN columns or
    experts), which the caller constrains to ``act_btd``; under sequence
    parallelism x is the rank's block of the sequence, (B, S / tp, d), and
    y is over the whole sequence, (B, S, d)."""
    if cfg.moe is not None:
        return moe_apply(lp, x, cfg.moe)
    act = ACTIVATIONS[cfg.act]
    x = gather_seq(x)
    h = constrain(x @ lp["w1"], "act_btf")
    h = act(h) * (x @ lp["w3"]) if cfg.gated_ffn else act(h)
    return h @ lp["w2"], None


def _attn_apply(lp, h, kind, cos, sin, positions, cfg: TransformerConfig):
    if cfg.attn == "mla":
        return mla_forward(lp, h, cos, sin, positions, cfg.mla, causal=True,
                           chunk_q=cfg.chunk_q)
    return gqa_forward(
        lp, h, cos, sin, positions, n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim, causal=True,
        chunk_q=cfg.chunk_q,
        local_window=cfg.local_window if kind == "local" else None,
        use_rope=(kind != "global_nope"))


def embed_tokens(params, tokens, cfg: TransformerConfig):
    """The tokens' embedding rows in ``cfg.dtype``: gathered, then cast
    (the reference casts the table, then gathers: the same values without
    a cast copy of the whole table).  The gather is ``F.embedding``, whose
    backward sums a repeated id's rows in parallel segments; an indexing
    backward sums them one row after another (BERT4Rec's [MASK] id is a
    fifth of a batch's tokens).  In the sharded step the rank's rows of
    its vocabulary range (`ParallelContext.embed`), summed at
    ``act_btd`` (BERT4Rec's: summed at once)."""
    ctx = current_context()
    if ctx is not None:
        return ctx.embed(params["embed"], tokens).to(cfg.dtype)
    return F.embedding(tokens, params["embed"]).to(cfg.dtype)


def _group_apply(gp, x, aux_acc, cos, sin, positions,
                 cfg: TransformerConfig):
    """One pattern group over x: each layer cast to ``cfg.dtype`` here (and
    in the sharded step gathered, `gather_layer_params`), so that under a
    checkpoint the cast is recomputed, not kept.  The attention's and the
    FFN's outputs are constrained to ``act_btd`` (in the sharded step: the
    model ranks' partial outputs summed into the rank's block of the
    sequence, which is what ``x`` holds)."""
    for j, kind in enumerate(cfg.layer_pattern):
        lp = gather_layer_params(tree_map(lambda a: a[j], gp), cfg.dtype)
        h = rms_norm(x, lp["attn_norm"])
        attn_out, _ = _attn_apply(lp["attn"], h, kind, cos, sin, positions,
                                  cfg)
        x = x + constrain(attn_out, "act_btd")
        y, aux = ffn_apply(lp["ffn"], rms_norm(x, lp["ffn_norm"]), cfg)
        x = x + constrain(y, "act_btd")
        if aux is not None:
            aux_acc = aux_acc + cfg.aux_loss_weight * aux["load_balance"] \
                + cfg.z_loss_weight * aux["z_loss"]
    return x, aux_acc


def forward(params, tokens, cfg: TransformerConfig, positions=None, *,
            rope=None):
    """tokens: (B, S) -> final hidden (B, S, d), total aux loss (scalar).
    Under sequence parallelism the hidden is the rank's block of the
    sequence, (B, S / tp, d)."""
    b, s = tokens.shape
    if positions is None:
        positions = torch.arange(s, device=tokens.device).expand(b, s)
    x = constrain(embed_tokens(params, tokens, cfg), "act_btd")
    cos, sin = _rope(cfg, rope, x.device)
    aux_acc = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for gi in range(cfg.n_groups):
        args = (group_params(params, gi), x, aux_acc, cos, sin, positions,
                cfg)
        x, aux_acc = (checkpoint(scoped(_group_apply), *args,
                                 use_reentrant=False)
                      if remat else _group_apply(*args))
    x = rms_norm(x, params["final_norm"].to(cfg.dtype))
    return x, aux_acc / cfg.n_layers


def _xent_chunk(hc, yc, w):
    """(sum of the cross-entropy over the labels >= 0, their count) of the
    hidden rows ``hc`` against the head ``w``: the logits in the compute
    dtype, the log-sum-exp and the label's logit in float32."""
    logits = constrain((hc @ w).float(), "logits_2d")
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(1, yc.clamp_min(0)[:, None].long())[:, 0]
    valid = yc >= 0
    return torch.where(valid, lse - ll, 0.0).sum(), valid.sum()


def lm_loss(params, hidden, labels, cfg: TransformerConfig):
    """Mean cross-entropy over the labels >= 0, in chunks of
    ``cfg.xent_chunk`` tokens (each under a checkpoint in a backward, so
    one chunk's (chunk, V) logits are held at a time), summed in chunk
    order, as the reference's scan.  In the sharded step the hidden rows
    are the rank's block of the sequence, gathered whole (the reference's
    ``logits``: every token, a slice of the vocabulary), the head's columns
    are the rank's vocabulary range (`ParallelContext.xent_chunk`) and the
    mean divides by the label count of every data rank's tokens."""
    ctx = current_context()
    xent = _xent_chunk
    if ctx is None:
        w = params["lm_head"].to(cfg.dtype)
    else:
        w = ctx.gather_vocab("lm_head", params["lm_head"], cfg.dtype)
        hidden = gather_seq(hidden)
        if ctx.tp_size > 1:
            xent = ctx.xent_chunk
    b, s, d = hidden.shape
    h = hidden.reshape(b * s, d)
    y = labels.reshape(b * s)
    t, ck = b * s, cfg.xent_chunk
    if ck is None or ck >= t:
        tot, cnt = xent(h, y, w)
    else:
        if t % ck:
            raise ValueError(f"xent_chunk {ck} does not divide {t} tokens")
        tot = torch.zeros((), dtype=torch.float32, device=h.device)
        cnt = torch.zeros((), dtype=torch.int32, device=h.device)
        remat = torch.is_grad_enabled()
        for i in range(0, t, ck):
            args = (h[i:i + ck], y[i:i + ck], w)
            l, c = (checkpoint(scoped(xent), *args, use_reentrant=False)
                    if remat else xent(*args))
            tot, cnt = tot + l, cnt + c
    if ctx is not None:
        cnt = ctx.data_sum(cnt)
    return tot / torch.clamp_min(cnt, 1)


def loss_fn(params, batch, cfg: TransformerConfig, *, rope=None):
    """The training loss: `lm_loss` of the forward plus its MoE aux
    losses.  ``batch``: ``tokens`` and ``labels`` (B, S)."""
    hidden, aux = forward(params, batch["tokens"], cfg, rope=rope)
    return lm_loss(params, hidden, batch["labels"], cfg) + aux


# --------------------------------------------------------------------------- #
# Serving: prefill + decode                                                    #
# --------------------------------------------------------------------------- #
def _cache_shapes(cfg: TransformerConfig, batch: int, max_seq: int) -> dict:
    lb = (cfg.n_layers, batch, max_seq)
    if cfg.attn == "mla":
        return {"ckv": lb + (cfg.mla.kv_lora,), "kpe": lb + (cfg.mla.qk_rope,)}
    kv = lb + (cfg.n_kv_heads, cfg.head_dim)
    return {"k": kv, "v": kv}


def init_cache(cfg: TransformerConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device=None) -> dict:
    """A zero cache: GQA ``k``/``v`` (L, B, S, Hkv, D), MLA ``ckv``
    (L, B, S, r) and ``kpe`` (L, B, S, dr)."""
    return {k: torch.zeros(s, dtype=dtype, device=device)
            for k, s in _cache_shapes(cfg, batch, max_seq).items()}


def _head(params, x, cfg: TransformerConfig):
    """``x @ lm_head`` in ``cfg.dtype``; in the sharded step the rank's
    vocabulary columns, the logits gathered whole (`ParallelContext.
    gather_logits`)."""
    ctx = current_context()
    if ctx is None:
        return x @ params["lm_head"].to(cfg.dtype)
    w = ctx.gather_vocab("lm_head", params["lm_head"], cfg.dtype)
    return ctx.gather_logits(x @ w)


def prefill(params, tokens, cfg: TransformerConfig,
            cache_dtype=torch.bfloat16, *, rope=None):
    """Run the prompt; returns (last-token logits (B, V), cache over S).
    In the sharded step the residual stream is the rank's block of the
    sequence (the attention's K and V come from the gathered sequence),
    the cache the rank's block of the decode layout
    (`ParallelContext.cache_block`), and the last token's row reaches
    every rank (`ParallelContext.last_token`)."""
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    ctx = current_context()
    x = constrain(embed_tokens(params, tokens, cfg), "act_btd")
    cos, sin = _rope(cfg, rope, x.device)
    names, cache = tuple(_cache_shapes(cfg, b, s)), {}
    for li, kind, lp in layer_params(params, cfg):
        h = rms_norm(x, lp["attn_norm"])
        attn_out, kv = _attn_apply(lp["attn"], h, kind, cos, sin, positions,
                                   cfg)
        for name, t in zip(names, kv):
            if ctx is not None:
                t = ctx.cache_block(t.to(cache_dtype))
            if name not in cache:
                cache[name] = torch.empty((cfg.n_layers,) + tuple(t.shape),
                                          dtype=cache_dtype, device=x.device)
            cache[name][li] = t            # rounded to the cache's dtype
        x = x + constrain(attn_out, "act_btd")
        y, _ = ffn_apply(lp["ffn"], rms_norm(x, lp["ffn_norm"]), cfg)
        x = x + constrain(y, "act_btd")
    x = rms_norm(x, params["final_norm"].to(cfg.dtype))
    last = x[:, -1, :] if ctx is None else ctx.last_token(x)
    return _head(params, last, cfg), cache


def decode_step(params, cache, tokens, pos, cfg: TransformerConfig, *,
                rope=None):
    """One decode step.  tokens: (B,); pos: the next position (an int).
    Writes the cache in place at ``pos``; returns (logits (B, V), cache).
    In the sharded step ``cache`` is the rank's block of the cache."""
    pos = int(pos)
    x = constrain(embed_tokens(params, tokens, cfg), "act_btd")
    cos, sin = _rope(cfg, rope, x.device)
    for li, kind, lp in layer_params(params, cfg):
        h = rms_norm(x, lp["attn_norm"])
        if cfg.attn == "mla":
            attn_out, _, _ = mla_decode(lp["attn"], h, cache["ckv"][li],
                                        cache["kpe"][li], pos, cos, sin,
                                        cfg.mla)
        else:
            attn_out, _, _ = gqa_decode(
                lp["attn"], h, cache["k"][li], cache["v"][li], pos, cos, sin,
                n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                head_dim=cfg.head_dim,
                local_window=cfg.local_window if kind == "local" else None,
                use_rope=(kind != "global_nope"))
        x = x + constrain(attn_out, "act_btd")
        y, _ = ffn_apply(lp["ffn"], rms_norm(x, lp["ffn_norm"]), cfg)
        x = x + constrain(y, "act_btd")
    x = rms_norm(x, params["final_norm"].to(cfg.dtype))
    return _head(params, x, cfg), cache
