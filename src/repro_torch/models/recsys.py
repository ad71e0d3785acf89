"""RecSys models of the port: DLRM (MLPerf), Wide & Deep, MIND, BERT4Rec.

The counterpart of ``repro.models.recsys``: serving, training (the losses
and their gradients) and candidate scoring of DLRM, Wide & Deep, MIND and
BERT4Rec.  Each of the three is an ``nn.Module`` over the
same parameters as the JAX pytree (`params_from_jax` carries them across,
`params_to_jax` back; ``model.tree()`` is that layout over the module's
own storage) and computes the same forward.  BERT4Rec is the
transformer's parameter dict (plus ``pos``) and functions over it, as the
LMs in `models.transformer` are.

Shared substrate: a *stacked* embedding table (all categorical fields
concatenated row-wise, each field at its row offset).  Every table lookup
of the three goes through `bag_lookup`, whose forward is
`kernels.ops.embedding_bag`, so on the card each one is a launch of the
hand-written CUDA embedding-bag kernel (BERT4Rec's item embedding is the
transformer's row gather, as in JAX, where the item embedding is no
embedding bag either):

* DLRM's and Wide & Deep's deep lookups are bags of one id (the (B, F) ids
  as (B * F, 1) bags);
* Wide & Deep's wide term is one bag of F ids a sample, summed over the
  (V, 1) wide table;
* MIND's history gather is a bag of one id a history slot, whose -1
  padding the kernel masks to a zero row; its loss looks up the histories,
  the targets and the negatives in one call.

The JAX models do these lookups with ``jnp.take`` (and, for the wide term,
a sum over the fields).  A bag of one is ``0 + 1 * row``, bit-identical to
the gathered row in float32 and bfloat16 alike; MIND's masked gather
(``where(mask, take(max(id, 0)), 0)``) is the kernel's padding contract
exactly.  The wide sum adds its F terms in field order and differs from
XLA's reduction only in summation order, within the recursive-summation
bound ``F * 2^-24 * sum |w|``.

The gradient of a lookup is the table's *row gradient* (`row_grad`): the
unique ids touched and their summed gradients, a sparse COO tensor, never
a dense (V, D) one: DLRM's 48 GB table could not hold a dense twin on one
card.  JAX computes it as XLA's scatter-add (the VJP of ``jnp.take``); the
port sorts the occurrences by id and sums each id's in float32, in a
fixed order, then rounds once to the table's dtype.  BERT4Rec's table is
read three times a step (the input items, the positives, the sampled
negatives) by plain row gathers, and its gradient is one dense (V, D)
tensor, as JAX's (256 MB at full width).

In the sharded step (`launch.steps.build_step(..., mesh=...)`, under a
`distributed.parallel.ParallelContext`) each table is this rank's row
block over "model" (the reference's ``table_rows``) and a module holds
the rank's shards (`from_tree`).  `bag_lookup` localizes the ids to the
block (an id outside it becomes -1 padding), runs the same kernel on the
block and sums the partial bags over "model": a bag of one id has one
rank with a non-zero row, so DLRM's, Wide & Deep's deep and MIND's
lookups are the unsharded ones bit for bit, and Wide & Deep's wide bag
is summed a rank at a time, then over the ranks.  Its row gradient
gathers the occurrences (the localized ids and the output's gradient
rows) over the data ranks in rank order, so that one `row_grad` on the
block sums every data rank's occurrences, in the order of the global
batch's rows (the unsharded order wherever the data ranks' rows are the
global batch's blocks: every lookup but MIND's, whose shared negatives
follow each rank's rows): the table's gradient, summed over the data
ranks, and no dense (V, D) one.  The MLPs' weights are gathered whole at
use (`layers.MLP`), the losses are means over the global batch
(`ParallelContext.batch_mean`), and BERT4Rec's item rows come from the
blocks of its vocabulary (`ParallelContext.vocab_rows`, which the
transformer's `embed_tokens` reaches through `ParallelContext.embed`).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core import join as _join
from ..distributed.sharding import current_context
from ..kernels import ops as _ops
from ..kernels import registry as _registry
from ..utils import to_numpy, to_tensor
from ..utils import top_k as _top_k
from ..utils import tree_map as _tree_map
from . import transformer as tf
from .attention import gqa_forward
from .layers import MLP, mlp_params, rms_norm, rope_freqs, uniform_init
from .transformer import TransformerConfig


# --------------------------------------------------------------------------- #
# Stacked embedding table                                                      #
# --------------------------------------------------------------------------- #
# The JAX package pads the stacked table's rows to a multiple of 64 (for
# sharding across a mesh); the port keeps the row count so that its tables
# have the JAX tables' shapes.  The padded rows are never indexed.
PAD_ROWS_TO = 64
# Half width of the uniform init of every embedding table, as in JAX.
TABLE_SCALE = 0.01


def stacked_rows(vocab_sizes) -> int:
    """Rows of the stacked table: the vocabularies' sum, padded to a
    multiple of ``PAD_ROWS_TO``."""
    total = int(np.sum(vocab_sizes))
    return -(-total // PAD_ROWS_TO) * PAD_ROWS_TO


def stacked_table_params(vocab_sizes, dim: int, *, dtype=torch.float32,
                         generator: torch.Generator | None = None,
                         device=None) -> torch.Tensor:
    """A (stacked_rows, dim) table, uniform in ``[-TABLE_SCALE,
    TABLE_SCALE]``."""
    return uniform_init((stacked_rows(vocab_sizes), dim), scale=TABLE_SCALE,
                        dtype=dtype, generator=generator, device=device)


def field_offsets(vocab_sizes, device=None) -> torch.Tensor:
    """Row offset of each field within the stacked table, (F,) int32."""
    off = np.concatenate([[0], np.cumsum(vocab_sizes)[:-1]])
    return torch.as_tensor(off.astype(np.int32), device=device)


def lookup_ids(ids: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """(B, F) per-field local ids -> (B * F, 1) stacked-table ids: the bags
    of one a stacked lookup hands to the kernel."""
    return (ids + offsets[None, :]).reshape(-1, 1)


def row_grad(ids: torch.Tensor, grad_out: torch.Tensor,
             n_rows: int) -> torch.Tensor:
    """The gradient of ``embedding_bag(ids, table)`` for a table of
    ``n_rows`` rows, given the output's gradient ``grad_out`` (B, D): a
    sparse COO (n_rows, D) tensor of the unique ids touched (ascending) and
    their summed rows, in ``grad_out``'s dtype.

    Every id >= 0 of bag b adds ``grad_out[b]`` to its row (an id past the
    table to row n_rows - 1, which the forward read); padding adds nothing.
    The occurrences are sorted by id (stably), and each id's are summed in
    float32 in that order by one segment sum, then rounded once: the same
    bits every run, and no atomics on the hot rows (DLRM's synthetic ids
    put 1.7M occurrences a step on 78 rows)."""
    from torch._subclasses.fake_tensor import is_fake

    with torch.profiler.record_function("row_grad"):
        f = ids.shape[1]
        flat = ids.reshape(-1)
        if is_fake(flat):
            # a dry-run trace (`launch.hlo_analysis`): no values, so no
            # data-dependent sizes; every occurrence taken as valid and
            # unique (the sort and the gather the step does)
            sorted_ids, order = torch.sort(flat.clamp(0, n_rows - 1).long(),
                                           stable=True)
            return torch.sparse_coo_tensor(
                sorted_ids[None], grad_out[order // f],
                (n_rows, grad_out.shape[1]), is_coalesced=True,
                check_invariants=False)
        valid = flat >= 0
        occ = torch.nonzero(valid).flatten()
        rows_of = flat[occ].clamp_max(n_rows - 1).long()
        sorted_ids, order = torch.sort(rows_of, stable=True)
        uniq, counts = torch.unique_consecutive(sorted_ids,
                                                return_counts=True)
        g = grad_out.float()[occ[order] // f]
        sums = (torch.segment_reduce(g, "sum", lengths=counts, axis=0)
                if counts.numel() else g)            # no id: no row
        return torch.sparse_coo_tensor(
            uniq[None], sums.to(grad_out.dtype), (n_rows, grad_out.shape[1]),
            is_coalesced=True, check_invariants=False)


class _BagLookup(torch.autograd.Function):
    """The bag lookup; its table gradient is `row_grad`, over the
    occurrences of every data rank where a context ``pc`` is given."""

    @staticmethod
    def forward(ctx, ids, table, pc=None):
        ctx.save_for_backward(ids)
        ctx.n_rows = table.shape[0]
        ctx.pc = pc
        return _ops.embedding_bag(ids, table)

    @staticmethod
    def backward(ctx, grad_out):
        if not ctx.needs_input_grad[1]:
            return None, None, None
        (ids,) = ctx.saved_tensors
        if ctx.pc is not None:
            ids = ctx.pc.gather_data_rows(ids)
            grad_out = ctx.pc.gather_data_rows(grad_out)
        return None, row_grad(ids, grad_out, ctx.n_rows), None


def bag_lookup(ids: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``kernels.ops.embedding_bag(ids, table)`` (the CUDA kernel for a CUDA
    table, the plain version for a CPU one) whose gradient with respect to
    the table is its row gradient (`row_grad`).  In the sharded step
    ``table`` is the rank's row block: the ids localized to it, the same
    kernel on the block, the bags summed over "model"."""
    pc = current_context()
    if pc is None:
        return _BagLookup.apply(ids, table)
    local = pc.localize_rows(ids, table.shape[0])
    return pc.model_sum(_BagLookup.apply(local, table, pc))


def _batch_mean(x: torch.Tensor) -> torch.Tensor:
    """``torch.mean(x)`` over the batch's rows; in the sharded step the
    global batch's (`ParallelContext.batch_mean`)."""
    pc = current_context()
    return torch.mean(x) if pc is None else pc.batch_mean(x)


def _item_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``F.embedding(ids, table)``; in the sharded step over the blocks of
    the vocabulary (`ParallelContext.vocab_rows`)."""
    pc = current_context()
    return F.embedding(ids, table) if pc is None else pc.vocab_rows(table,
                                                                    ids)


def stacked_lookup(table: torch.Tensor, ids: torch.Tensor,
                   offsets: torch.Tensor) -> torch.Tensor:
    """ids: (B, F) per-field local ids -> (B, F, dim), in one launch."""
    b, f = ids.shape
    return bag_lookup(lookup_ids(ids, offsets), table).view(b, f, -1)


# --------------------------------------------------------------------------- #
# DLRM (MLPerf config)                                                         #
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    name: str
    vocab_sizes: tuple
    n_dense: int = 13
    embed_dim: int = 128
    bot_mlp: tuple = (512, 256, 128)
    top_mlp: tuple = (1024, 1024, 512, 256, 1)
    dtype: torch.dtype = torch.float32

    @property
    def n_sparse(self) -> int:
        return len(self.vocab_sizes)


class DLRM(nn.Module):
    """``dlrm_forward``: bottom MLP on the dense features, the stacked
    lookup (a bfloat16 table, as in the JAX package), the dot interaction's
    strict upper triangle in ``triu_indices`` order, and the top MLP."""

    TABLES = ("table",)

    def __init__(self, cfg: DLRMConfig, table: torch.Tensor, bot: MLP,
                 top: MLP):
        super().__init__()
        self.cfg = cfg
        self.table = nn.Parameter(table)
        self.bot, self.top = bot, top
        dev = table.device
        self.register_buffer("offsets", field_offsets(cfg.vocab_sizes, dev))
        iu, ju = torch.triu_indices(cfg.n_sparse + 1, cfg.n_sparse + 1,
                                    offset=1, device=dev)
        self.register_buffer("iu", iu)
        self.register_buffer("ju", ju)

    def _interact(self, bot, emb):
        """[bot, the strict upper triangle of z z^T], z = [bot, emb]; a
        bfloat16 ``bot`` meets the float32 ``emb`` in float32, as in JAX."""
        z = torch.cat([bot[:, None, :], emb], dim=1)            # (B, 27, D)
        zz = torch.bmm(z, z.transpose(1, 2))                    # interaction
        return torch.cat([bot, zz[:, self.iu, self.ju]], dim=1)  # (B, 479)

    def forward(self, dense, sparse_ids):
        """dense: (B, 13) float32; sparse_ids: (B, 26) int32 -> (B,)."""
        bot = self.bot(dense)
        emb = stacked_lookup(self.table, sparse_ids,
                             self.offsets).to(self.cfg.dtype)  # (B, 26, D)
        return self.top(self._interact(bot, emb))[:, 0]

    def score_bf16(self, dense, sparse_ids, table):
        """The ranking retrieval's forward, with every float32 parameter
        cast to bfloat16 (``table``: this model's table so cast) under JAX's
        promotion: the bottom MLP in bfloat16, the lookup widened to
        ``cfg.dtype`` (float32), so the interaction and the top MLP run in
        float32 on the bfloat16-rounded weights.  -> (B,) float32."""
        bot = self.bot.bf16_forward(dense.to(torch.bfloat16))
        emb = stacked_lookup(table, sparse_ids,
                             self.offsets).to(self.cfg.dtype)
        return self.top.bf16_forward(self._interact(bot, emb))[:, 0]

    def tree(self, leaf=lambda p: p.detach()) -> dict:
        """The JAX parameter pytree's layout (`MLP.tree`)."""
        return {"emb": {"table": leaf(self.table)},
                "bot": self.bot.tree(leaf), "top": self.top.tree(leaf)}


def dlrm_init(cfg: DLRMConfig, *, generator: torch.Generator | None = None,
              device=None) -> DLRM:
    n_int = (cfg.n_sparse + 1) * cfg.n_sparse // 2
    kw = dict(generator=generator, device=device)
    table = stacked_table_params(cfg.vocab_sizes, cfg.embed_dim,
                                 dtype=torch.bfloat16, **kw)
    bot = mlp_params((cfg.n_dense,) + cfg.bot_mlp, final_relu=True,
                     dtype=cfg.dtype, **kw)
    top = mlp_params((n_int + cfg.bot_mlp[-1],) + cfg.top_mlp,
                     dtype=cfg.dtype, **kw)
    return DLRM(cfg, table, bot, top)


# --------------------------------------------------------------------------- #
# Wide & Deep                                                                  #
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class WideDeepConfig:
    name: str
    vocab_sizes: tuple                 # 40 sparse fields
    n_dense: int = 13
    embed_dim: int = 32
    deep_mlp: tuple = (1024, 512, 256)
    dtype: torch.dtype = torch.float32


class WideDeep(nn.Module):
    """``widedeep_forward``: the deep tower over [dense, stacked lookup] plus
    the wide term (a bag of the F ids over the (V, 1) wide table, and a
    linear term of the dense features)."""

    TABLES = ("emb", "wide")

    def __init__(self, cfg: WideDeepConfig, emb: torch.Tensor,
                 wide: torch.Tensor, wide_dense: torch.Tensor, deep: MLP):
        super().__init__()
        self.cfg = cfg
        self.emb = nn.Parameter(emb)
        self.wide = nn.Parameter(wide)
        self.wide_dense = nn.Parameter(wide_dense)
        self.deep = deep
        self.register_buffer("offsets",
                             field_offsets(cfg.vocab_sizes, emb.device))

    def deep_logit(self, dense, sparse_ids):
        b = dense.shape[0]
        emb = stacked_lookup(self.emb, sparse_ids, self.offsets).reshape(b, -1)
        return self.deep(torch.cat([dense, emb], dim=1))[:, 0]

    def wide_logit(self, dense, sparse_ids):
        wide = bag_lookup(sparse_ids + self.offsets[None, :], self.wide)[:, 0]
        return wide + (dense @ self.wide_dense)[:, 0]

    def forward(self, dense, sparse_ids):
        """dense: (B, 13) float32; sparse_ids: (B, 40) int32 -> (B,)."""
        return (self.deep_logit(dense, sparse_ids)
                + self.wide_logit(dense, sparse_ids))

    def score_bf16(self, dense, sparse_ids, emb, wide):
        """The ranking retrieval's forward, wholly in bfloat16 (``emb`` and
        ``wide``: the tables cast to it) -> (B,) bfloat16."""
        bf = torch.bfloat16
        d = dense.to(bf)
        e = stacked_lookup(emb, sparse_ids, self.offsets).reshape(d.shape[0],
                                                                  -1)
        deep = self.deep.bf16_forward(torch.cat([d, e], dim=1))[:, 0]
        w = bag_lookup(sparse_ids + self.offsets[None, :], wide)[:, 0]
        return deep + (w + (d @ self.wide_dense.to(bf))[:, 0])

    def tree(self, leaf=lambda p: p.detach()) -> dict:
        return {"emb": {"table": leaf(self.emb)},
                "wide": {"table": leaf(self.wide)},
                "wide_dense": leaf(self.wide_dense),
                "deep": self.deep.tree(leaf)}


def widedeep_init(cfg: WideDeepConfig, *,
                  generator: torch.Generator | None = None,
                  device=None) -> WideDeep:
    n_f = len(cfg.vocab_sizes)
    d_in = n_f * cfg.embed_dim + cfg.n_dense
    kw = dict(generator=generator, device=device)
    emb = stacked_table_params(cfg.vocab_sizes, cfg.embed_dim,
                               dtype=cfg.dtype, **kw)
    wide = stacked_table_params(cfg.vocab_sizes, 1, dtype=cfg.dtype, **kw)
    wide_dense = uniform_init((cfg.n_dense, 1), dtype=cfg.dtype, **kw)
    deep = mlp_params((d_in,) + cfg.deep_mlp + (1,), dtype=cfg.dtype, **kw)
    return WideDeep(cfg, emb, wide, wide_dense, deep)


# --------------------------------------------------------------------------- #
# MIND (multi-interest capsule routing)                                        #
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class MINDConfig:
    name: str
    n_items: int = 1_000_000
    embed_dim: int = 64
    n_interests: int = 4
    capsule_iters: int = 3
    hist_len: int = 50
    n_neg: int = 1024
    dtype: torch.dtype = torch.float32


def _squash(z, dim: int = -1):
    n2 = torch.sum(z * z, dim=dim, keepdim=True)
    return (n2 / (1.0 + n2)) * z / torch.sqrt(n2 + 1e-9)


class MIND(nn.Module):
    """``mind_user_tower``: the history gather (bags of one, -1 padding),
    a shared bilinear map, and ``capsule_iters`` rounds of dynamic (B2I)
    routing into ``n_interests`` capsules."""

    def __init__(self, cfg: MINDConfig, items: torch.Tensor,
                 bilinear: torch.Tensor):
        super().__init__()
        self.cfg = cfg
        self.items = nn.Parameter(items)
        self.bilinear = nn.Parameter(bilinear)

    def forward(self, hist_ids):
        """hist_ids: (B, S) int32 with -1 padding -> (B, K, D) capsules."""
        b, s = hist_ids.shape
        e = bag_lookup(hist_ids.reshape(b * s, 1),
                       self.items).view(b, s, -1)               # (B, S, D)
        return self.capsules(e, hist_ids >= 0)

    def capsules(self, e, valid):
        """The routing over gathered histories ``e`` (B, S, D), zero where
        ``valid`` (B, S) is False -> (B, K, D)."""
        mask = valid[..., None]
        eh = e @ self.bilinear                                  # (B, S, D)
        b_logit = torch.zeros(tuple(valid.shape) + (self.cfg.n_interests,),
                              dtype=torch.float32, device=e.device)
        u = None
        for _ in range(self.cfg.capsule_iters):
            c = torch.where(mask, torch.softmax(b_logit, dim=-1), 0.0)
            z = torch.einsum("bsk,bsd->bkd", c, eh)
            u = _squash(z)
            b_logit = b_logit + torch.einsum("bkd,bsd->bsk", u, eh)
        return u

    def score_candidates(self, hist_ids, cand_emb):
        """``mind_score_candidates``: (B, S) histories against (C, D)
        candidates -> (B, C), the max over the capsules."""
        u = self(hist_ids)
        return torch.matmul(u, cand_emb.T).amax(dim=1)

    def tree(self, leaf=lambda p: p.detach()) -> dict:
        return {"items": leaf(self.items), "bilinear": leaf(self.bilinear)}


def mind_init(cfg: MINDConfig, *, generator: torch.Generator | None = None,
              device=None) -> MIND:
    kw = dict(generator=generator, device=device)
    items = uniform_init((cfg.n_items, cfg.embed_dim), scale=TABLE_SCALE,
                         dtype=cfg.dtype, **kw)
    bilinear = uniform_init((cfg.embed_dim, cfg.embed_dim), dtype=cfg.dtype,
                            **kw)
    return MIND(cfg, items, bilinear)


# --------------------------------------------------------------------------- #
# BERT4Rec: a bidirectional transformer over item sequences                   #
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class Bert4RecConfig:
    name: str
    n_items: int = 1_000_000
    embed_dim: int = 64
    n_blocks: int = 2
    n_heads: int = 2
    seq_len: int = 200
    n_neg: int = 1024
    dtype: torch.dtype = torch.float32

    def tf_config(self) -> TransformerConfig:
        vocab = -(-(self.n_items + 1) // 64) * 64   # +1 = [MASK]; padded
        return TransformerConfig(
            name=self.name + "-core", n_layers=self.n_blocks,
            d_model=self.embed_dim, n_heads=self.n_heads,
            n_kv_heads=self.n_heads, head_dim=self.embed_dim // self.n_heads,
            d_ff=4 * self.embed_dim, vocab=vocab, max_seq=self.seq_len,
            remat=False, dtype=self.dtype)


# Sequences one BERT4Rec forward encodes at once: `serve_bulk`'s 262,144
# sequences of 200 at once would hold 53.7 GB of FFN activations (and 84 GB
# of attention weights, which `attention._attend` splits anyway).
BERT4REC_CHUNK = 16_384


def bert4rec_init(cfg: Bert4RecConfig, *,
                  generator: torch.Generator | None = None,
                  device=None) -> dict:
    """The reference's tree: the transformer's (``embed`` (vocab, D), the
    stacked layers, ``final_norm``, ``lm_head``) and ``pos`` (S, D)."""
    params = tf.init_params(cfg.tf_config(), generator=generator,
                            device=device)
    params["pos"] = uniform_init((cfg.seq_len, cfg.embed_dim), scale=0.02,
                                 dtype=cfg.dtype, generator=generator,
                                 device=device)
    return params


def _bert4rec_hidden(params, seq_ids, cfg: Bert4RecConfig):
    """Bidirectional encoding; -1 pads, ``n_items`` is [MASK] -> (B, S, D):
    the transformer's layers with non-causal full attention (every block
    'full', RoPE on) and its dense gated FFN."""
    tcfg = cfg.tf_config()
    b, s = seq_ids.shape
    x = tf.embed_tokens(params, seq_ids.clamp_min(0), tcfg) + \
        params["pos"][None, :s, :]
    cos, sin = rope_freqs(tcfg.rope_dim, tcfg.max_seq, tcfg.rope_theta,
                          device=x.device)
    positions = torch.arange(s, device=x.device).expand(b, s)
    for _, _, lp in tf.layer_params(params, tcfg):
        h = rms_norm(x, lp["attn_norm"])
        attn_out, _ = gqa_forward(
            lp["attn"], h, cos, sin, positions, n_heads=tcfg.n_heads,
            n_kv_heads=tcfg.n_kv_heads, head_dim=tcfg.head_dim,
            causal=False)
        x = x + attn_out
        y, _ = tf.ffn_apply(lp["ffn"], rms_norm(x, lp["ffn_norm"]), tcfg)
        x = x + y
    return rms_norm(x, params["final_norm"].to(tcfg.dtype))


def bert4rec_user_repr(params, seq_ids, cfg: Bert4RecConfig):
    """(B, S) -> (B, D): the hidden state at the last (mask) position.
    The sequences are encoded in chunks of at most `BERT4REC_CHUNK`; a
    sequence's encoding depends on that sequence alone."""
    return torch.cat([_bert4rec_hidden(params, chunk, cfg)[:, -1, :]
                      for chunk in torch.split(seq_ids, BERT4REC_CHUNK)])


def _bert4rec_chunk(hc, lc, table, neg):
    """(sum of the masked-item losses, their count) of hidden states hc
    (C, S, D) with labels lc (C, S) (-1: not masked): each masked slot's
    positive item against the shared negatives ``neg`` (N, D), the
    log-sum-exp over the 1 + N scores in float32.  The unmasked slots
    gather row 0, as the reference's ``take(table, max(lc, 0))`` does
    (``F.embedding``: their zero gradients, four fifths of the slots, are
    summed in parallel, see `transformer.embed_tokens`)."""
    pos = _item_rows(table, lc.clamp_min(0))                    # (C, S, D)
    s_pos = torch.einsum("bsd,bsd->bs", hc, pos)[..., None]
    s_neg = torch.einsum("bsd,nd->bsn", hc, neg)
    scores = torch.cat([s_pos, s_neg], -1).float()
    lse = torch.logsumexp(scores, dim=-1)
    valid = lc >= 0
    per = torch.where(valid, lse - scores[..., 0], 0.0)
    return per.sum(), valid.sum()


def bert4rec_loss(params, batch, cfg: Bert4RecConfig,
                  batch_chunk: int = 4096):
    """Masked-item prediction with sampled negatives, the reference's:
    ``seq`` (B, S) with [MASK] = n_items at the masked slots, ``labels``
    (B, S) (-1: not masked), ``negatives`` (n_neg,).  The (B, S, 1 + N)
    scores are the memory hot spot, so the loss is taken in chunks of
    ``batch_chunk`` sequences where they divide B, each under a
    checkpoint in a backward.  The encoder runs over the whole batch; a
    training step at 65,536 sequences takes `bert4rec_value_and_grad`."""
    h = _bert4rec_hidden(params, batch["seq"], cfg)
    labels = batch["labels"]
    table = params["embed"].to(cfg.dtype)
    neg = _item_rows(table, batch["negatives"])                 # (N, D)
    b = h.shape[0]
    if b <= batch_chunk or b % batch_chunk:
        tot, cnt = _bert4rec_chunk(h, labels, table, neg)
    else:
        tot = torch.zeros((), dtype=torch.float32, device=h.device)
        cnt = torch.zeros((), dtype=torch.int32, device=h.device)
        remat = torch.is_grad_enabled()
        for i in range(0, b, batch_chunk):
            args = (h[i:i + batch_chunk], labels[i:i + batch_chunk], table,
                    neg)
            l, c = (checkpoint(_bert4rec_chunk, *args, use_reentrant=False)
                    if remat else _bert4rec_chunk(*args))
            tot, cnt = tot + l, cnt + c
    return tot / torch.clamp_min(_batch_count(cnt), 1)


def _batch_count(n: torch.Tensor) -> torch.Tensor:
    """A count over the batch; in the sharded step the global batch's."""
    pc = current_context()
    return n if pc is None else pc.batch_count(n)


# Sequences a training step encodes and differentiates at once: the
# encoder's backward over 65,536 x 200 tokens would hold 42 GB of attention
# weights; the loss chunks of the reference are this size.
BERT4REC_TRAIN_CHUNK = 4096


def bert4rec_value_and_grad(params, batch, cfg: Bert4RecConfig,
                            chunk: int = BERT4REC_TRAIN_CHUNK):
    """(loss, gradients in ``params``' layout) of `bert4rec_loss`, the
    encoder and the loss taken ``chunk`` sequences at a time.

    The loss is ``sum_c tot_c / cnt`` over the whole batch's count cnt,
    so chunk c's backward starts from ``1 / cnt``, as the reference's
    division gives every chunk; each gradient is the sum of the chunks'
    (added into one tree in chunk order): the reference's function, its
    sums over the sequences in another order.  The table's gradient is
    one dense tensor."""
    labels = batch["labels"]
    cnt = torch.clamp_min(_batch_count((labels >= 0).sum()), 1)
    scale = torch.ones((), dtype=torch.float32, device=labels.device) / cnt
    grads = _tree_map(torch.zeros_like, params)
    view = tf.train_view(params, grads, cfg.tf_config())
    tot = torch.zeros((), dtype=torch.float32, device=labels.device)
    for i in range(0, labels.shape[0], chunk):
        h = _bert4rec_hidden(view, batch["seq"][i:i + chunk], cfg)
        table = view["embed"].to(cfg.dtype)
        l, _ = _bert4rec_chunk(h, labels[i:i + chunk], table,
                               _item_rows(table, batch["negatives"]))
        l.backward(scale)
        tot = tot + l.detach()
    return tot / cnt, grads


# --------------------------------------------------------------------------- #
# Losses and their gradients                                                   #
# --------------------------------------------------------------------------- #
def bce_loss(logits, labels):
    """Mean binary cross-entropy on logits, in float32 (``jnp.maximum``'s
    even split of the gradient at 0 is ``torch.maximum``'s too)."""
    logits = logits.float()
    return _batch_mean(torch.maximum(logits, torch.zeros_like(logits))
                       - logits * labels
                       + torch.log1p(torch.exp(-torch.abs(logits))))


def dlrm_loss(model: DLRM, batch: dict):
    return bce_loss(model(batch["dense"], batch["sparse"]), batch["labels"])


def widedeep_loss(model: WideDeep, batch: dict):
    return bce_loss(model(batch["dense"], batch["sparse"]), batch["labels"])


def mind_loss(model: MIND, batch: dict):
    """Sampled softmax with label-aware (max over the interests) scoring:
    ``hist`` (B, S), ``target`` (B,), ``negatives`` (N,).

    One lookup gathers the histories, the targets and the negatives (one
    row gradient for the table).  JAX scores the (B, 1 + N, D) candidates
    ``[pos, broadcast(neg)]``; here the positive (``(u * pos).sum(-1)``)
    and the shared negatives (``u @ neg.T``) are scored apart and the
    (B, K, 1 + N) scores concatenated: the same function, each score a
    float32 dot product of D terms summed in another order (a few ulp),
    without the (B, N, D) copy of the negatives (17.2 GB at B = 65,536)."""
    hist, target, neg = batch["hist"], batch["target"], batch["negatives"]
    b, s = hist.shape
    ids = torch.cat([hist.reshape(-1), target, neg])[:, None]
    rows = bag_lookup(ids, model.items)
    e, pos, negs = torch.split(rows, [b * s, b, neg.shape[0]])
    u = model.capsules(e.view(b, s, -1), hist >= 0)           # (B, K, D)
    scores = torch.cat([(u * pos[:, None, :]).sum(-1, keepdim=True),
                        u @ negs.T], dim=-1).amax(dim=1)       # (B, 1 + N)
    lse = torch.logsumexp(scores.float(), dim=-1)
    return _batch_mean(lse - scores[:, 0])


LOSSES = {"dlrm-mlperf": dlrm_loss, "wide-deep": widedeep_loss,
          "mind": mind_loss}


def value_and_grad(loss_fn, model: nn.Module, batch: dict):
    """(loss, gradients in the JAX layout ``model.tree()``) of
    ``loss_fn(model, batch)``: ``jax.value_and_grad``.  A table's gradient
    is its row gradient (`row_grad`); a weight's is the (in, out) view of
    the Linear weight's gradient."""
    params = list(model.parameters())
    loss = loss_fn(model, batch)
    grads = torch.autograd.grad(loss, params)
    by_param = {id(p): g for p, g in zip(params, grads)}
    return loss.detach(), model.tree(lambda p: by_param[id(p)])


# --------------------------------------------------------------------------- #
# Shared retrieval scoring                                                     #
# --------------------------------------------------------------------------- #
def score_candidates(user_repr, cand_emb, top_k: int = 100):
    """(B, D) x (C, D) -> the top-k MIPS scores and ids via one GEMM, in
    ``jax.lax.top_k``'s order (`utils.top_k`: equal scores by id)."""
    return _top_k(user_repr @ cand_emb.T, top_k)


# candidates a ranking model scores in one forward: DLRM's 1,000,000 at
# once would hold 6.7 GB of bfloat16 lookups, 13.3 GB of their float32 copy
# and 13.8 GB of interaction inputs beside its 48.07 GB table
RANK_CHUNK = 131_072


def rank_candidates(model, dense, sparse, cand_ids) -> torch.Tensor:
    """The ranking retrieval's scores (C,) float32 of DLRM or Wide & Deep:
    one user (``dense`` (1, n_dense), ``sparse`` (1, F)) with its field 0
    set to each of the C candidate ids, through `score_bf16` (the
    parameters cast to bfloat16, as the JAX step casts them).

    Each candidate's score depends on that candidate alone, so the
    candidates go through in equal chunks of at most `RANK_CHUNK` (the
    last one padded with its final id): every chunk has
    the same shapes, so runs the same GEMMs, and the chunking changes no
    candidate's arithmetic but for what the GEMM library does with a row's
    place in its tiles."""
    c, nf = cand_ids.shape[0], sparse.shape[1]
    tables = [getattr(model, name).to(torch.bfloat16) for name in
              model.TABLES]
    n_chunks = max(1, -(-c // RANK_CHUNK))
    size = -(-c // n_chunks)
    pad = n_chunks * size - c
    ids = torch.cat([cand_ids, cand_ids[-1:].expand(pad)]) if pad else \
        cand_ids
    d = dense.expand(size, dense.shape[1])
    out = []
    for lo in range(0, n_chunks * size, size):
        sp = sparse.expand(size, nf).clone()
        sp[:, 0] = ids[lo:lo + size]
        out.append(model.score_bf16(d, sp, *tables).float())
    return torch.cat(out)[:c]


def _host_rows(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float32)


def retrieve_above(user_repr, cand_emb, threshold, *, index=None,
                   device=None):
    """Exact threshold MIPS retrieval through the bichromatic join.

    ``join(user_repr, cand_emb, threshold, metric="mips")`` on ``device``
    (default: the card): row b of the returned CSR lists every candidate
    with ``score >= threshold`` for ``user_repr[b]``, the inner products as
    distances.  ``threshold`` may be per row; pass a prebuilt ``index``
    (`core.build_index(cand_emb, metric="mips")`) to lift the candidates
    once across calls.  MIND joins all K capsules of a user in one call.
    """
    user_repr = _host_rows(user_repr)
    if user_repr.ndim == 1:
        user_repr = user_repr[None, :]
    cand = None if index is not None else _host_rows(cand_emb)
    return _join(user_repr, cand, threshold, metric="mips", b_index=index,
                 device=device)


# --------------------------------------------------------------------------- #
# Weights carried over from the JAX package                                    #
# --------------------------------------------------------------------------- #
def _mlp(params, sizes, device, **kw) -> MLP:
    return MLP(sizes, device=device, **kw).load_jax(
        [{k: to_tensor(v, device) for k, v in p.items()} for p in params])


def _checked(t: torch.Tensor, shape, what: str) -> torch.Tensor:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what} has shape {tuple(t.shape)}, the config "
                         f"wants {tuple(shape)}")
    return t


def params_from_jax(arch_id: str, tree, device=None, *,
                    reduced: bool = False):
    """The port's model of ``arch_id`` with the values of a JAX parameter
    pytree (``repro.launch.steps.build_step(...).init_args()[0]`` with its
    leaves as numpy arrays, or `params_to_jax`'s), on ``device`` (default:
    the card): an ``nn.Module``, or for BERT4Rec the parameter dict (the
    transformer's, `transformer.params_from_jax`, and ``pos``).
    ``reduced`` picks the arch's reduced config, as in `launch.steps`."""
    from ..configs.registry import get_arch

    dev = _registry.resolve_device(device)
    cfg = get_arch(arch_id).make_config("serve_p99", reduced)
    with torch.no_grad():
        if arch_id == "dlrm-mlperf":
            n_int = (cfg.n_sparse + 1) * cfg.n_sparse // 2
            # a bfloat16 table given as float32 values (`params_to_jax`)
            table = _checked(to_tensor(tree["emb"]["table"], dev),
                             (stacked_rows(cfg.vocab_sizes), cfg.embed_dim),
                             "emb.table").to(torch.bfloat16)
            bot = _mlp(tree["bot"], (cfg.n_dense,) + cfg.bot_mlp, dev,
                       final_relu=True)
            top = _mlp(tree["top"], (n_int + cfg.bot_mlp[-1],) + cfg.top_mlp,
                       dev)
            return DLRM(cfg, table, bot, top)
        if arch_id == "wide-deep":
            rows = stacked_rows(cfg.vocab_sizes)
            d_in = len(cfg.vocab_sizes) * cfg.embed_dim + cfg.n_dense
            return WideDeep(
                cfg,
                _checked(to_tensor(tree["emb"]["table"], dev),
                         (rows, cfg.embed_dim), "emb.table"),
                _checked(to_tensor(tree["wide"]["table"], dev), (rows, 1),
                         "wide.table"),
                _checked(to_tensor(tree["wide_dense"], dev), (cfg.n_dense, 1),
                         "wide_dense"),
                _mlp(tree["deep"], (d_in,) + cfg.deep_mlp + (1,), dev))
        if arch_id == "mind":
            return MIND(
                cfg,
                _checked(to_tensor(tree["items"], dev),
                         (cfg.n_items, cfg.embed_dim), "items"),
                _checked(to_tensor(tree["bilinear"], dev),
                         (cfg.embed_dim, cfg.embed_dim), "bilinear"))
    if arch_id == "bert4rec":
        pos = _checked(to_tensor(tree["pos"], dev),
                       (cfg.seq_len, cfg.embed_dim), "pos")
        core = {k: v for k, v in tree.items() if k != "pos"}
        return {**tf.params_from_jax(core, cfg.tf_config(), dev), "pos": pos}
    raise KeyError(arch_id)


def from_tree(arch_id: str, cfg, tree):
    """The port's model of ``arch_id`` (at ``cfg``'s widths) over the
    tensors of a tree in the JAX layout (``model.tree()``'s), sharing their
    storage: in the sharded step the rank's shards (a table's row block,
    the MLP leaves as ``rs_param_spec`` cuts them).  BERT4Rec's model is
    the tree itself."""
    if arch_id == "dlrm-mlperf":
        n_int = (cfg.n_sparse + 1) * cfg.n_sparse // 2
        return DLRM(cfg, tree["emb"]["table"],
                    MLP.from_tree(tree["bot"], (cfg.n_dense,) + cfg.bot_mlp,
                                  final_relu=True),
                    MLP.from_tree(tree["top"], (n_int + cfg.bot_mlp[-1],)
                                  + cfg.top_mlp))
    if arch_id == "wide-deep":
        d_in = len(cfg.vocab_sizes) * cfg.embed_dim + cfg.n_dense
        return WideDeep(cfg, tree["emb"]["table"], tree["wide"]["table"],
                        tree["wide_dense"],
                        MLP.from_tree(tree["deep"], (d_in,) + cfg.deep_mlp
                                      + (1,)))
    if arch_id == "mind":
        return MIND(cfg, tree["items"], tree["bilinear"])
    if arch_id == "bert4rec":
        return tree
    raise KeyError(arch_id)


def params_to_jax(model) -> dict:
    """``model``'s parameters as the JAX package's pytree (``model.tree()``'s
    layout: an MLP weight (in, out); BERT4Rec's dict as it is) of numpy
    arrays, the inverse of `params_from_jax`.  Numpy has no bfloat16: a
    bfloat16 leaf comes back as the float32 array of the same values
    (``.astype(jnp.bfloat16)`` is exact)."""
    return _tree_map(to_numpy, model if isinstance(model, dict)
                     else model.tree())

