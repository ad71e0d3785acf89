"""RecSys serving models of the port: DLRM (MLPerf), Wide & Deep, MIND.

The counterpart of ``repro.models.recsys`` for the serving path.  Each
model is an ``nn.Module`` over the same parameters as the JAX pytree
(`params_from_jax` carries them across) and computes the same forward.

Shared substrate: a *stacked* embedding table (all categorical fields
concatenated row-wise, each field at its row offset).  Every table lookup
goes through `kernels.ops.embedding_bag`, so on the card each one is a
launch of the hand-written CUDA embedding-bag kernel:

* DLRM's and Wide & Deep's deep lookups are bags of one id (the (B, F) ids
  as (B * F, 1) bags);
* Wide & Deep's wide term is one bag of F ids a sample, summed over the
  (V, 1) wide table;
* MIND's history gather is a bag of one id a history slot, whose -1
  padding the kernel masks to a zero row.

The JAX models do these lookups with ``jnp.take`` (and, for the wide term,
a sum over the fields).  A bag of one is ``0 + 1 * row``, bit-identical to
the gathered row in float32 and bfloat16 alike; MIND's masked gather
(``where(mask, take(max(id, 0)), 0)``) is the kernel's padding contract
exactly.  The wide sum adds its F terms in field order and differs from
XLA's reduction only in summation order, within the recursive-summation
bound ``F * 2^-24 * sum |w|``.

Not ported yet (``ROADMAP.md``): training (losses), BERT4Rec, and the
ranking models' candidate-scoring step.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from ..core import join as _join
from ..kernels import ops as _ops
from ..kernels import registry as _registry
from .layers import MLP, mlp_params, uniform_init


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


def stacked_lookup(table: torch.Tensor, ids: torch.Tensor,
                   offsets: torch.Tensor) -> torch.Tensor:
    """ids: (B, F) per-field local ids -> (B, F, dim), in one launch."""
    b, f = ids.shape
    return _ops.embedding_bag(lookup_ids(ids, offsets), table).view(b, f, -1)


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


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

    def __init__(self, cfg: DLRMConfig, table: torch.Tensor, bot: MLP,
                 top: MLP):
        super().__init__()
        self.cfg = cfg
        self.table = _frozen(table)
        self.bot, self.top = bot, top
        dev = table.device
        self.register_buffer("offsets", field_offsets(cfg.vocab_sizes, dev))
        iu, ju = torch.triu_indices(cfg.n_sparse + 1, cfg.n_sparse + 1,
                                    offset=1, device=dev)
        self.register_buffer("iu", iu)
        self.register_buffer("ju", ju)

    def forward(self, dense, sparse_ids):
        """dense: (B, 13) float32; sparse_ids: (B, 26) int32 -> (B,)."""
        bot = self.bot(dense)
        emb = stacked_lookup(self.table, sparse_ids,
                             self.offsets).to(self.cfg.dtype)  # (B, 26, D)
        z = torch.cat([bot[:, None, :], emb], dim=1)            # (B, 27, D)
        zz = torch.bmm(z, z.transpose(1, 2))                    # interaction
        inter = zz[:, self.iu, self.ju]                         # (B, 351)
        x = torch.cat([bot, inter], dim=1)
        return self.top(x)[:, 0]


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

    def __init__(self, cfg: WideDeepConfig, emb: torch.Tensor,
                 wide: torch.Tensor, wide_dense: torch.Tensor, deep: MLP):
        super().__init__()
        self.cfg = cfg
        self.emb = _frozen(emb)
        self.wide = _frozen(wide)
        self.wide_dense = _frozen(wide_dense)
        self.deep = deep
        self.register_buffer("offsets",
                             field_offsets(cfg.vocab_sizes, emb.device))

    def deep_logit(self, dense, sparse_ids):
        b = dense.shape[0]
        emb = stacked_lookup(self.emb, sparse_ids, self.offsets).reshape(b, -1)
        return self.deep(torch.cat([dense, emb], dim=1))[:, 0]

    def wide_logit(self, dense, sparse_ids):
        wide = _ops.embedding_bag(sparse_ids + self.offsets[None, :],
                                  self.wide)[:, 0]
        return wide + (dense @ self.wide_dense)[:, 0]

    def forward(self, dense, sparse_ids):
        """dense: (B, 13) float32; sparse_ids: (B, 40) int32 -> (B,)."""
        return (self.deep_logit(dense, sparse_ids)
                + self.wide_logit(dense, sparse_ids))


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
        self.items = _frozen(items)
        self.bilinear = _frozen(bilinear)

    def forward(self, hist_ids):
        """hist_ids: (B, S) int32 with -1 padding -> (B, K, D) capsules."""
        b, s = hist_ids.shape
        e = _ops.embedding_bag(hist_ids.reshape(b * s, 1),
                               self.items).view(b, s, -1)       # (B, S, D)
        mask = (hist_ids >= 0)[..., None]
        eh = e @ self.bilinear                                  # (B, S, D)
        b_logit = torch.zeros((b, s, self.cfg.n_interests),
                              dtype=torch.float32, device=hist_ids.device)
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


def mind_init(cfg: MINDConfig, *, generator: torch.Generator | None = None,
              device=None) -> MIND:
    kw = dict(generator=generator, device=device)
    items = uniform_init((cfg.n_items, cfg.embed_dim), scale=TABLE_SCALE,
                         dtype=cfg.dtype, **kw)
    bilinear = uniform_init((cfg.embed_dim, cfg.embed_dim), dtype=cfg.dtype,
                            **kw)
    return MIND(cfg, items, bilinear)


# --------------------------------------------------------------------------- #
# Shared retrieval scoring                                                     #
# --------------------------------------------------------------------------- #
def score_candidates(user_repr, cand_emb, top_k: int = 100):
    """(B, D) x (C, D) -> the top-k MIPS scores and ids via one GEMM."""
    return torch.topk(user_repr @ cand_emb.T, top_k, dim=1)


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
def _tensor(a, device) -> torch.Tensor:
    """A host array as a tensor on ``device``; a bfloat16 array (numpy's
    ``bfloat16`` extension type) moves its bits, not its values."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:      # torch tensors share writable memory
        a = a.copy()
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _mlp(params, sizes, device, **kw) -> MLP:
    return MLP(sizes, device=device, **kw).load_jax(
        [{k: _tensor(v, device) for k, v in p.items()} for p in params])


def _checked(t: torch.Tensor, shape, what: str) -> torch.Tensor:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what} has shape {tuple(t.shape)}, the config "
                         f"wants {tuple(shape)}")
    return t


def params_from_jax(arch_id: str, tree, device=None, *,
                    reduced: bool = False) -> nn.Module:
    """The port's model of ``arch_id`` with the values of a JAX parameter
    pytree (``repro.launch.steps.build_step(...).init_args()[0]`` with its
    leaves as numpy arrays), on ``device`` (default: the card).
    ``reduced`` picks the arch's reduced config, as in `launch.steps`."""
    from ..configs.registry import get_arch

    dev = _registry.resolve_device(device)
    cfg = get_arch(arch_id).make_config("serve_p99", reduced)
    with torch.no_grad():
        if arch_id == "dlrm-mlperf":
            n_int = (cfg.n_sparse + 1) * cfg.n_sparse // 2
            table = _checked(_tensor(tree["emb"]["table"], dev),
                             (stacked_rows(cfg.vocab_sizes), cfg.embed_dim),
                             "emb.table")
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
                _checked(_tensor(tree["emb"]["table"], dev),
                         (rows, cfg.embed_dim), "emb.table"),
                _checked(_tensor(tree["wide"]["table"], dev), (rows, 1),
                         "wide.table"),
                _checked(_tensor(tree["wide_dense"], dev), (cfg.n_dense, 1),
                         "wide_dense"),
                _mlp(tree["deep"], (d_in,) + cfg.deep_mlp + (1,), dev))
        if arch_id == "mind":
            return MIND(
                cfg,
                _checked(_tensor(tree["items"], dev),
                         (cfg.n_items, cfg.embed_dim), "items"),
                _checked(_tensor(tree["bilinear"], dev),
                         (cfg.embed_dim, cfg.embed_dim), "bilinear"))
    raise KeyError(arch_id)
