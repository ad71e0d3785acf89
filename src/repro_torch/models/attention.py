"""Attention variants of the port: the counterpart of
``repro.models.attention``.

* GQA (nemotron-4, internlm2, llama4, qwen3-moe): grouped KV heads; query
  head ``i`` reads KV head ``i // g`` (``repeat_interleave``, JAX's
  ``jnp.repeat``).
* MLA (minicpm3): multi-head latent attention with a compressed KV cache
  and the absorbed-matmul decode.
* Query-chunked causal attention for long prefill, and llama4's chunked
  local attention (tokens attend causally within windows).

The arithmetic is the reference's: the products are ``torch.einsum`` in
the compute dtype, the softmax scale is ``1 / sqrt(d)`` rounded to that
dtype (in bfloat16 ``sqrt(128)`` is 11.3125), masked scores are
``NEG_INF`` in that dtype, and the softmax runs in float32 and is rounded
back.

Memory: the reference holds one query chunk's (B, H, chunk, S) scores at
once (``jax.checkpoint`` under ``lax.scan``); here `_attend` computes a
call's scores in pieces of whole (query, head) rows, heads in whole KV
groups, so that no piece holds more than `SCORE_BYTES` of float32 scores
(nemotron's 32k prefill chunk would be 12.9 GB).  Each row is computed by
the same formula in a piece as in the whole (on the CPU bit for bit; the
card's GEMM library may order a row's sums by the shapes it is given).
Under autograd each query chunk and each local window runs under
``torch.utils.checkpoint``, as the reference's are ``jax.checkpoint``
bodies: a backward holds one chunk's scores at a time.  Params are plain
dicts of tensors, the JAX pytree's layout.

The sharding hooks sit where the reference's are: ``constrain`` of the
queries (``act_bthd``) and the scores (``attn_scores``), and, for tensor
parallelism, `gather_seq` at the input of each column-parallel product
(the heads' projections: GQA's input; MLA's normalised latents and the
shared RoPE key), which under sequence parallelism gathers the rank's
block of the sequence (MLA's replicated ``wq_a``/``wkv_a`` and their
norms run on the block, so the narrow latents are gathered, not ``x``)
and otherwise is `copy_to_model`.  Under tensor parallelism the caller
passes this rank's head counts and its heads' weights, and the output
projection's result is the rank's partial sum over the whole sequence.

A decode step under a context whose cache is cut along the sequence
(`distributed.parallel.ParallelContext.serve_layout`) holds this rank's
block of the cache: the new token's queries and KV entries are gathered
over "model" (every head), the rank whose block holds ``pos`` writes the
entry at ``pos - offset``, the masks are over global positions, every
head is scored over the block, the partial softmaxes are combined over
the sequence group (`ParallelContext.seq_attend`), and the rank's own
heads go on into ``wo``.  Without a context, or at a sequence group of
one rank, the unsharded code runs.  Where "model" does not divide the
heads (`ParallelContext.split_heads`), a rank's query heads need not be
whole groups of its KV heads: the prefill and training attention read
one KV head a query head by the context's index (`_kv_of_heads`), and
decode gathers the ranks' unequal head counts.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch.utils.checkpoint import checkpoint

from ..distributed.parallel import gather_seq
from ..distributed.sharding import constrain, current_context, scoped
from .layers import apply_rope, rms_norm, uniform_init

NEG_INF = -1e30
# float32 score bytes one `_sdpa` call may hold (a piece of a query chunk)
SCORE_BYTES = 1 << 31


# --------------------------------------------------------------------------- #
# Params (each leaf stacked under ``lead``)                                    #
# --------------------------------------------------------------------------- #
def gqa_params(d_model: int, n_heads: int, n_kv_heads: int, head_dim: int,
               *, lead: tuple = (), dtype=torch.float32, generator=None,
               device=None) -> dict:
    kw = dict(lead=lead, dtype=dtype, generator=generator, device=device)
    return {
        "wq": uniform_init((d_model, n_heads * head_dim), **kw),
        "wk": uniform_init((d_model, n_kv_heads * head_dim), **kw),
        "wv": uniform_init((d_model, n_kv_heads * head_dim), **kw),
        "wo": uniform_init((n_heads * head_dim, d_model), **kw),
    }


def mla_params(d_model: int, n_heads: int, q_lora: int, kv_lora: int,
               qk_nope: int, qk_rope: int, v_head: int, *, lead: tuple = (),
               dtype=torch.float32, generator=None, device=None) -> dict:
    kw = dict(lead=lead, dtype=dtype, generator=generator, device=device)
    ones = dict(dtype=dtype, device=device)
    return {
        "wq_a": uniform_init((d_model, q_lora), **kw),
        "q_norm": torch.ones(tuple(lead) + (q_lora,), **ones),
        "wq_b": uniform_init((q_lora, n_heads * (qk_nope + qk_rope)), **kw),
        "wkv_a": uniform_init((d_model, kv_lora + qk_rope), **kw),
        "kv_norm": torch.ones(tuple(lead) + (kv_lora,), **ones),
        "wkv_b": uniform_init((kv_lora, n_heads * (qk_nope + v_head)), **kw),
        "wo": uniform_init((n_heads * v_head, d_model), **kw),
    }


# --------------------------------------------------------------------------- #
# Softmax attention cores                                                      #
# --------------------------------------------------------------------------- #
def softmax_scale(d: int, dtype: torch.dtype) -> torch.Tensor:
    """``1.0 / jnp.sqrt(d).astype(dtype)``: the root in float32, rounded to
    ``dtype``, and the quotient in ``dtype``.  A 0-d CPU tensor, which a
    product with a CUDA tensor reads as a scalar (no copy to the card, no
    wait)."""
    return 1.0 / torch.tensor(math.sqrt(d), dtype=torch.float32).to(dtype)


def _sdpa(q, k, v, mask, scale):
    """q: (B, Sq, H, D), k/v: (B, Skv, Hkv, D[v]); mask broadcastable to
    (B, H, Sq, Skv).  KV heads repeat by group to H."""
    h, hkv = q.shape[2], k.shape[2]
    if h != hkv:
        k = k.repeat_interleave(h // hkv, dim=2)
        v = v.repeat_interleave(h // hkv, dim=2)
    scores = torch.einsum("bqhd,bshd->bhqs", q, k) * scale
    scores = constrain(scores, "attn_scores")
    scores = torch.where(mask, scores, NEG_INF)
    w = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqs,bshv->bqhv", w, v)


def _attend(q, k, v, scale, mask_rows):
    """`_sdpa` of every query row against all of k/v, in pieces of at most
    `SCORE_BYTES` float32 scores: blocks of whole KV groups of heads, and,
    where one group's rows exceed it, blocks of query rows.
    ``mask_rows(r0, r1)`` is the mask of query rows [r0, r1)."""
    b, sq, h, _ = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    per = b * skv * 4                       # one (query, head) row's scores
    heads, rows = h, sq
    if sq * h * per > SCORE_BYTES:          # (a rank with no head: never)
        g = h // hkv
        heads = max(g, SCORE_BYTES // (sq * per) // g * g)
        rows = max(1, min(sq, SCORE_BYTES // (heads * per)))
    if heads == h and rows == sq:
        return _sdpa(q, k, v, mask_rows(0, sq), scale)
    out = q.new_empty(b, sq, h, v.shape[-1])
    for r0 in range(0, sq, rows):
        r1 = min(sq, r0 + rows)
        mask = mask_rows(r0, r1)
        for h0 in range(0, h, heads):
            h1 = min(h, h0 + heads)
            out[:, r0:r1, h0:h1] = _sdpa(
                q[:, r0:r1, h0:h1], k[:, :, h0 // g:h1 // g],
                v[:, :, h0 // g:h1 // g], mask, scale)
    return out


def _attend_chunk(q, k, v, scale, mask_rows):
    """`_attend` of one query chunk or window: under a checkpoint when a
    backward will follow."""
    if torch.is_grad_enabled():
        return checkpoint(scoped(_attend), q, k, v, scale, mask_rows,
                          use_reentrant=False)
    return _attend(q, k, v, scale, mask_rows)


def full_attention(q, k, v, *, causal: bool, scale,
                   chunk_q: int | None = None):
    """Softmax attention of queries at positions 0 .. Sq - 1 over keys at
    0 .. Skv - 1; queries in chunks of ``chunk_q`` (which must divide Sq),
    as in the reference."""
    b, sq, h, _ = q.shape
    skv = k.shape[1]
    kpos = torch.arange(skv, device=q.device)

    def mask_from(base):
        def mask_rows(r0, r1):
            if not causal:
                return torch.ones((1, 1, 1, skv), dtype=torch.bool,
                                  device=q.device)
            qpos = torch.arange(base + r0, base + r1, device=q.device)
            return (qpos[:, None] >= kpos[None, :])[None, None]
        return mask_rows

    if chunk_q is None or chunk_q >= sq:
        return _attend(q, k, v, scale, mask_from(0))
    if sq % chunk_q:
        raise ValueError(f"chunk_q {chunk_q} does not divide {sq} queries")
    out = q.new_empty(b, sq, h, v.shape[-1])
    for c0 in range(0, sq, chunk_q):
        out[:, c0:c0 + chunk_q] = _attend_chunk(q[:, c0:c0 + chunk_q], k, v,
                                                scale, mask_from(c0))
    return out


def local_chunked_attention(q, k, v, *, window: int, scale):
    """llama4's chunked local attention: causal within chunks of ``window``
    tokens, none across them.  Sq == Skv, a multiple of ``window``."""
    b, s, h, _ = q.shape
    if s % window:
        raise ValueError(f"window {window} does not divide {s} tokens")
    kpos = torch.arange(window, device=q.device)

    def mask_rows(r0, r1):
        qpos = torch.arange(r0, r1, device=q.device)
        return (qpos[:, None] >= kpos[None, :])[None, None]

    out = q.new_empty(b, s, h, v.shape[-1])
    for w0 in range(0, s, window):
        sl = slice(w0, w0 + window)
        out[:, sl] = _attend_chunk(q[:, sl], k[:, sl], v[:, sl], scale,
                                   mask_rows)
    return out


# --------------------------------------------------------------------------- #
# GQA block (prefill + decode)                                                 #
# --------------------------------------------------------------------------- #
def gqa_forward(p, x, cos, sin, positions, *, n_heads, n_kv_heads, head_dim,
                causal=True, chunk_q=None, local_window=None, use_rope=True):
    """x: (B, S, d) -> (out (B, S, d), (k, v) after RoPE); under sequence
    parallelism x is the rank's block (B, S / tp, d) and the rest over the
    whole sequence."""
    x = gather_seq(x)
    b, s, _ = x.shape
    q = (x @ p["wq"]).reshape(b, s, n_heads, head_dim)
    k = (x @ p["wk"]).reshape(b, s, n_kv_heads, head_dim)
    v = (x @ p["wv"]).reshape(b, s, n_kv_heads, head_dim)
    if use_rope:
        q = apply_rope(q, positions, cos, sin)
        k = apply_rope(k, positions, cos, sin)
    q = constrain(q, "act_bthd")
    scale = softmax_scale(head_dim, x.dtype)
    ka, va = _kv_of_heads(k, v)
    if local_window is not None and local_window < s:
        out = local_chunked_attention(q, ka, va, window=local_window,
                                      scale=scale)
    else:
        # a window of at least the sequence is full causal attention
        out = full_attention(q, ka, va, causal=causal, scale=scale,
                             chunk_q=chunk_q)
    return out.reshape(b, s, n_heads * head_dim) @ p["wo"], (k, v)


def _kv_of_heads(k, v):
    """k, v (B, S, KV heads, D) as the attention reads them: as they are,
    or, where the sharded step gave this rank query heads that are not
    whole groups of its KV heads (`ParallelContext.split_heads`), one KV
    head a query head, picked by the context's ``kv_index``."""
    ctx = current_context()
    if getattr(ctx, "kv_index", None) is None:
        return k, v
    idx = ctx.kv_index_on(k.device)
    return k.index_select(2, idx), v.index_select(2, idx)


def gqa_decode(p, x, cache_k, cache_v, pos: int, cos, sin, *, n_heads,
               n_kv_heads, head_dim, local_window=None, use_rope=True):
    """One-token decode.  x: (B, d); cache: (B, Smax, Hkv, D), written at
    ``pos`` in place (the reference returns an updated copy).

    Returns (out (B, d), cache_k, cache_v)."""
    b = x.shape[0]
    q = (x @ p["wq"]).reshape(b, 1, n_heads, head_dim)
    k = (x @ p["wk"]).reshape(b, 1, n_kv_heads, head_dim)
    v = (x @ p["wv"]).reshape(b, 1, n_kv_heads, head_dim)
    posb = torch.full((b, 1), pos, dtype=torch.long, device=x.device)
    if use_rope:
        q = apply_rope(q, posb, cos, sin)
        k = apply_rope(k, posb, cos, sin)
    ctx = current_context()
    if ctx is not None and ctx.seq_size > 1:
        out = _gqa_decode_block(ctx, q[:, 0], k[:, 0], v[:, 0], cache_k,
                                cache_v, pos, local_window)
        return out @ p["wo"], cache_k, cache_v
    cache_k[:, pos] = k[:, 0]
    cache_v[:, pos] = v[:, 0]
    kpos = torch.arange(cache_k.shape[1], device=x.device)
    if local_window is not None:
        # only within the current chunk [pos - pos % window, pos]
        valid = (kpos >= pos - pos % local_window) & (kpos <= pos)
    else:
        valid = kpos <= pos
    scale = softmax_scale(head_dim, x.dtype)
    # grouped einsum, no KV-head repeat: query head kv * g + j reads kv
    g = n_heads // n_kv_heads
    qg = q.reshape(b, 1, n_kv_heads, g, head_dim)
    ck, cv = cache_k.to(q.dtype), cache_v.to(q.dtype)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, ck) * scale
    scores = torch.where(valid, scores, NEG_INF)
    w = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskv->bqkgv", w, cv)
    return out.reshape(b, n_heads * head_dim) @ p["wo"], cache_k, cache_v


def _write_block(ctx, cache, new, pos: int) -> int:
    """Write ``new`` at global position ``pos`` of the rank's cache block
    (B, S_local, ...) if the block holds it; the block's offset."""
    s_loc = cache.shape[1]
    off = ctx.seq_pos * s_loc
    if off <= pos < off + s_loc:
        cache[:, pos - off] = new
    return off


def _gqa_decode_block(ctx, q, k, v, cache_k, cache_v, pos: int,
                      local_window):
    """`gqa_decode`'s attention over the rank's sequence block of the
    cache: q (B, heads of the rank, D), the new k, v (B, KV heads of the
    rank, D).  Returns the rank's heads' outputs (B, heads x D)."""
    b, hl, d = q.shape
    q = ctx.gather_heads(q)
    k, v = ctx.gather_kv_heads(k), ctx.gather_kv_heads(v)
    off = _write_block(ctx, cache_k, k, pos)
    _write_block(ctx, cache_v, v, pos)
    kpos = off + torch.arange(cache_k.shape[1], device=q.device)
    if local_window is not None:
        valid = (kpos >= pos - pos % local_window) & (kpos <= pos)
    else:
        valid = kpos <= pos
    scale = softmax_scale(d, q.dtype)
    h, hkv = q.shape[1], k.shape[1]
    qg = q.reshape(b, 1, hkv, h // hkv, d)
    ck, cv = cache_k.to(q.dtype), cache_v.to(q.dtype)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, ck) * scale
    scores = torch.where(valid, scores, NEG_INF)
    out = ctx.seq_attend(
        scores, lambda w: torch.einsum("bkgqs,bskv->bkgqv", w, cv))
    lo = ctx.own_heads(hl)
    return out.reshape(b, h, d)[:, lo:lo + hl].reshape(b, hl * d)


# --------------------------------------------------------------------------- #
# MLA block (prefill + absorbed decode)                                        #
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class MLADims:
    n_heads: int
    q_lora: int
    kv_lora: int
    qk_nope: int
    qk_rope: int
    v_head: int


def _mla_qkv(p, x, cos, sin, positions, md: MLADims):
    """(q_nope, q_pe, c_kv, k_pe) of x (B, S, d); the latents pass
    `gather_seq` after their norms (under sequence parallelism x is the
    rank's block of the sequence and the outputs are whole)."""
    h, dn, dr = md.n_heads, md.qk_nope, md.qk_rope
    q = gather_seq(rms_norm(x @ p["wq_a"], p["q_norm"])) @ p["wq_b"]
    b, s = q.shape[:2]
    q = q.reshape(b, s, h, dn + dr)
    q_nope, q_pe = q[..., :dn], q[..., dn:]
    q_pe = apply_rope(q_pe, positions, cos, sin)
    kv_a = x @ p["wkv_a"]
    c_kv = gather_seq(rms_norm(kv_a[..., :md.kv_lora],
                               p["kv_norm"]))                  # (b, s, r)
    k_pe = apply_rope(gather_seq(kv_a[..., md.kv_lora:])[:, :, None, :],
                      positions, cos, sin)
    return q_nope, q_pe, c_kv, k_pe[:, :, 0, :]


def mla_forward(p, x, cos, sin, positions, md: MLADims, *, causal=True,
                chunk_q=None):
    """x: (B, S, d) -> (out (B, S, d), (c_kv (B, S, r), k_pe (B, S, dr)));
    under sequence parallelism x is the rank's block (B, S / tp, d) and
    the rest over the whole sequence."""
    h, dn, dr, dv = md.n_heads, md.qk_nope, md.qk_rope, md.v_head
    q_nope, q_pe, c_kv, k_pe = _mla_qkv(p, x, cos, sin, positions, md)
    b, s = c_kv.shape[:2]
    kv = (c_kv @ p["wkv_b"]).reshape(b, s, h, dn + dv)
    k_nope, v = kv[..., :dn], kv[..., dn:]
    # the shared RoPE part of k broadcast over the heads
    q = constrain(torch.cat([q_nope, q_pe], dim=-1), "act_bthd")
    k = torch.cat([k_nope, k_pe[:, :, None, :].expand(b, s, h, dr)], dim=-1)
    scale = softmax_scale(dn + dr, x.dtype)
    out = full_attention(q, k, v, causal=causal, scale=scale, chunk_q=chunk_q)
    return out.reshape(b, s, h * dv) @ p["wo"], (c_kv, k_pe)


def mla_decode(p, x, cache_ckv, cache_kpe, pos: int, cos, sin, md: MLADims):
    """Absorbed-matmul decode: scores and output in latent space.
    cache_ckv: (B, Smax, r); cache_kpe: (B, Smax, dr), written at ``pos``
    in place."""
    b = x.shape[0]
    h, dn, dr, dv, r = md.n_heads, md.qk_nope, md.qk_rope, md.v_head, \
        md.kv_lora
    posb = torch.full((b, 1), pos, dtype=torch.long, device=x.device)
    q_nope, q_pe, c_kv_new, k_pe_new = _mla_qkv(p, x[:, None, :], cos, sin,
                                                posb, md)
    ctx = current_context()
    if ctx is not None and ctx.seq_size > 1:
        out = _mla_decode_block(ctx, p, q_nope, q_pe, c_kv_new, k_pe_new,
                                cache_ckv, cache_kpe, pos, md)
        return out @ p["wo"], cache_ckv, cache_kpe
    cache_ckv[:, pos] = c_kv_new[:, 0]
    cache_kpe[:, pos] = k_pe_new[:, 0]
    wkv_b = p["wkv_b"].reshape(r, h, dn + dv)
    w_uk, w_uv = wkv_b[..., :dn], wkv_b[..., dn:]
    # absorb W_uk into q: (b, 1, h, dn) x (r, h, dn) -> (b, h, r)
    q_lat = torch.einsum("bqhd,rhd->bhr", q_nope, w_uk)
    ckv, kpe = cache_ckv.to(x.dtype), cache_kpe.to(x.dtype)
    scores = (torch.einsum("bhr,bsr->bhs", q_lat, ckv)
              + torch.einsum("bqhd,bsd->bhs", q_pe, kpe))
    scale = softmax_scale(dn + dr, x.dtype)
    mask = (torch.arange(ckv.shape[1], device=x.device) <= pos)[None, None]
    scores = torch.where(mask, scores * scale, NEG_INF)
    w = torch.softmax(scores.float(), dim=-1).to(x.dtype)
    o_lat = torch.einsum("bhs,bsr->bhr", w, ckv)
    out = torch.einsum("bhr,rhv->bhv", o_lat, w_uv).reshape(b, h * dv)
    return out @ p["wo"], cache_ckv, cache_kpe


def _mla_decode_block(ctx, p, q_nope, q_pe, c_kv_new, k_pe_new, cache_ckv,
                      cache_kpe, pos: int, md: MLADims):
    """`mla_decode`'s absorbed attention over the rank's sequence block:
    the latent queries of every head (gathered over "model") against the
    block, combined over the sequence group; the new latents, whole on
    every model rank, written by the rank whose block holds ``pos``.
    Returns the rank's heads' outputs (B, heads x dv)."""
    b = q_nope.shape[0]
    h, dn, dr, dv, r = md.n_heads, md.qk_nope, md.qk_rope, md.v_head, \
        md.kv_lora
    off = _write_block(ctx, cache_ckv, c_kv_new[:, 0], pos)
    _write_block(ctx, cache_kpe, k_pe_new[:, 0], pos)
    wkv_b = p["wkv_b"].reshape(r, h, dn + dv)
    w_uk, w_uv = wkv_b[..., :dn], wkv_b[..., dn:]
    q_lat = ctx.gather_heads(torch.einsum("bqhd,rhd->bhr", q_nope, w_uk))
    q_pe = ctx.gather_heads(q_pe[:, 0])
    dt = q_lat.dtype
    ckv, kpe = cache_ckv.to(dt), cache_kpe.to(dt)
    scores = (torch.einsum("bhr,bsr->bhs", q_lat, ckv)
              + torch.einsum("bhd,bsd->bhs", q_pe, kpe))
    scale = softmax_scale(dn + dr, dt)
    kpos = off + torch.arange(ckv.shape[1], device=ckv.device)
    scores = torch.where((kpos <= pos)[None, None], scores * scale, NEG_INF)
    o_lat = ctx.seq_attend(scores,
                           lambda w: torch.einsum("bhs,bsr->bhr", w, ckv))
    lo = ctx.own_heads(h)
    return torch.einsum("bhr,rhv->bhv", o_lat[:, lo:lo + h],
                        w_uv).reshape(b, h * dv)
