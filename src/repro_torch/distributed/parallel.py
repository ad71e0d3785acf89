"""The sharded training machinery of the port: what GSPMD does for the
reference's LM step, over ``torch.distributed`` and a `DeviceMesh` with
axes ("data", "model") or ("pod", "data", "model").

* **Layout.**  Every leaf of the parameter and optimizer trees is held as
  this rank's shard of the reference's spec (`launch.steps.lm_param_spec`):
  each dimension named with mesh axes is cut into equal contiguous blocks,
  several axes on one dimension row-major (the first the slowest), as JAX
  lays out a ``NamedSharding``.  `shard_tree` cuts a full tree, `gather_tree`
  (DTensor's ``full_tensor`` over `sharding.to_placements`) rebuilds it, and
  `init_shards` makes a model's shards from the same seeded generator as
  its unsharded init, one full leaf at a time.
* **ZeRO-3 over the data axes.**  `ParallelContext.gather_weight` casts a
  layer's shard to the compute dtype and all-gathers it over the data axes
  to its TP-only layout (`sharding.gathered_spec`); the backward
  reduce-scatters the gradient in float32 into the shard's gradient.
  Leaves not split over the data axes (the norms, MLA's ``wq_b`` and
  ``wkv_b``) get a partial gradient on each data rank, summed once after
  the backward (`ParallelContext.sum_replicated_grads`).
* **Tensor and sequence parallelism over "model"** (Megatron with
  sequence parallelism, the reference's ``act_btd`` = (dp, "model",
  None)): between layers a rank holds ``(B / dp, S / tp, d)``, its
  contiguous block of the sequence in the order of the "model" ranks.
  The norms run on the block; the input of each column-parallel product
  is the sequence gathered over "model" (`gather_seq`: all-gather along
  S, its backward reduce-scatters the ranks' partial gradients), and a
  row-parallel product's partial output is reduce-scattered back into
  the blocks where the model constrains it to ``act_btd``
  (`ParallelContext.scatter_seq`; its backward all-gathers).  The
  embedding rows and the head's columns are split over "model" too: a
  rank looks up every token of its vocabulary range (zero elsewhere,
  reduce-scattered at ``act_btd``), and the cross-entropy gathers the
  sequence and reduces its log-sum-exp and label logit over "model"
  (`ParallelContext.xent_chunk`); a prefill gathers its last token's row
  (`ParallelContext.last_token`).  The leaves replicated over "model"
  (the norms, MLA's ``wq_a``/``wkv_a``, applied to the rank's block) get
  a partial gradient on each model rank, summed after the backward
  (`ParallelContext.sum_replicated_grads`).  The MoE routes the rank's
  block with the router whole (its logits gathered, their gradient the
  same on every rank; the router's own gradient reduce-scattered over
  "model"), gathers the sequence, so that the reference's groups,
  capacities and aux losses are unchanged, runs its own experts'
  capacity slots and scatters its partial output at ``act_btd``.  Decode
  steps and ``long_500k`` (one token, or tokens replicated; the
  reference applies no ``act_btd`` rule there) keep the whole residual on
  every model rank: the inputs pass `copy_to_model` and the partial
  outputs are summed (`reduce_from_model`).
* **Fewer KV heads than model ranks** (GQA, "model" a multiple of the
  KV heads): consecutive model ranks share a KV head, gathered whole over
  their run and its gradient reduce-scattered back
  (`ParallelContext.replicate_kv`), as Megatron replicates KV heads; the
  storage layout stays the reference's even column split.
* **Query heads that "model" does not divide** (40 over 16, or GQA KV
  heads that neither divide "model" nor are divided by it;
  `ParallelContext.split_heads`): storage stays the reference's equal
  column (``wo``: row) blocks over "model", and each rank uses whole
  heads, ``H // tp`` of them and one more on the first ``H % tp`` ranks
  (`head_split`).  The head leaves are gathered over "model" as well as
  the data axes and this rank's heads' columns kept (a ``"regroup"``
  step of `_Gather`: its backward puts the slice's gradient into a zero
  leaf and reduce-scatters it over "model" in float32).  A GQA rank
  computes the KV heads its query heads read (`kv_span`), maps each
  query head to its KV head by an index (``kv_index``), and a KV head
  that several ranks read gets their gradients summed by that
  reduce-scatter.  Decode gathers the ranks' unequal head counts padded
  to the largest (`gather_heads`), and keeps one copy of each KV head,
  its first owner's (`gather_kv_heads`, `cache_block`).
* **Data parallelism.**  A data rank holds its rows of every microbatch,
  the loss divides by the microbatch's global label count, and the MoE
  aux losses are means over the microbatch's global groups, so that the
  sum over data ranks of the rank losses is the global loss.
* **Splits that the ranks do not divide**, which the reference's GSPMD
  pads: a sequence over "model" (training and prefill), a microbatch over
  the data ranks and the MoE groups over them are cut into `block`'s
  blocks, ``ceil(n / ranks)`` a rank and the last ranks short or empty.
  The sequence's gathers and reduce-scatters pad each block to that width
  and drop the padding (`_AllGather`, `_ReduceScatter`), so no padded row
  reaches a norm, the router, the loss or the cache (`cache_block`), and
  `last_token` reads the rank that holds the last token.  A data rank
  without rows runs every microbatch empty and joins every collective
  (an empty tensor moves nothing: its whole group holds none).  MoE
  groups that the data ranks do not hold as their own tokens move there
  and back (`moe_groups`, `to_groups`, `from_groups`), and a rank's aux
  values are its sum over all the groups.  Query heads fewer than the
  "model" ranks leave the last ranks none (`head_split`): they compute no
  attention, add a zero block to the row-parallel sums and join every
  gather with zero-width pieces.  What the reference's jit refuses (an
  argument that an axis does not divide) the step refuses before any
  collective (`launch.steps.check_args`).
* **Serving** (`ParallelContext.serve_layout`): the KV cache is the
  reference's ``kv_cache``/``mla_cache`` layout, (L, B / dp, S / tp, ...)
  (batch over the data axes, sequence over "model"), or for
  ``long_500k`` (L, B, S / (dp tp), ...) with the batch replicated and
  the sequence over the data axes and "model" row-major: the *sequence
  group*.  A decode step gathers the new token's per-head queries and
  KV entries over "model" (`gather_heads`), the rank holding ``pos``
  writes the entry, every rank scores all heads over its block, and the
  partial softmaxes are combined over the sequence group
  (`seq_attend`: the float32 row max all-reduced, then the exp-sums and
  the unnormalised outputs summed); the rank's heads go on into ``wo``.
  Prefill computes its heads over the whole prompt and moves its cache
  into the decode layout (`cache_block`: an all-to-all over "model" for
  GQA's heads; MLA's latent cache is whole on every model rank), and the
  vocabulary-parallel head's logits are gathered whole
  (`gather_logits`).
* **The recsys and GAT steps** (``layout="rows"`` or ``"edges"``: "model"
  cuts the tables' rows and nothing else; every other product is replicated
  over it, so `copy_to_model` and `reduce_from_model` are identities).
  A table is held as this rank's row block over "model": a lookup
  localizes its ids (`localize_rows`: an id outside the block becomes
  -1, an id past the table is first clamped to the last row, as the
  unsharded kernel reads it), runs the embedding-bag kernel on the block
  and sums the partial bags over "model" (`model_sum`); BERT4Rec's item
  rows are read the same way (`vocab_rows`, and `embed` under this
  layout).  The MLP weights are
  stored by the reference's ``rs_param_spec`` and gathered whole at use
  (`gather_linear`).  The batch's rows are over the data axes
  (``layout="rows"``): a loss divides by the global count (`batch_mean`), a
  serving step gathers every row (`gather_data_rows`), a top-k merges
  the ranks' lists (`merge_top_k`).  The GAT's full-graph step holds its
  edges over the data axes (``layout="edges"``) and, between layers, its
  block of the padded node rows (the reference's ``nodes_nd``): a layer
  computes ``x @ w`` and the attention logits on its rows, the node
  tensors its edges read are gathered (`to_edges`: all-gather, its
  backward reduce-scatters the edges' partial gradients), the segment
  max is all-reduced (MAX, `edge_max`, which keeps the single card's
  rule for the gradient of a tie) and the softmax denominators summed
  (`edge_sum`), both read whole by the rank's edges (`edge_whole`:
  their backward sums the edges' partial gradients), and the messages
  are reduce-scattered into the rank's rows (`node_scatter`); the last
  layer's output is summed whole instead (`edge_sum`), as the reference
  constrains only between layers.  The parameters' gradients are then
  partial over the data ranks and summed after the backward.

Every op runs its collectives on a mesh whose axes have size 1 too (each
a copy there: the sequence's and the node rows' gathers and scatters
among them), except where the arithmetic would change: the
cross-entropy, the sums over "model" and the serving layout's ops take
the plain path when their group has size 1, and so do the GAT's
whole-node sums and maxes and the batch means when the data axes have
size 1, so a (1, 1) mesh is bit-equal to the unsharded step.
`OP_COUNTS` counts the sequence's and the node rows' ops as they run.
"""
from __future__ import annotations

import collections
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from .sharding import Spec, current_context, gathered_spec, to_placements

# the port gathers these to their vocabulary-parallel layouts
_VOCAB_GATHERED = {"embed": Spec("model", None), "lm_head": Spec(None, "model")}
# the router is used whole on every model rank
_WHOLE = {"router"}
# a GQA layer's KV projections, whole heads a model rank (`replicate_kv`)
_KV = {"wk", "wv"}
# the sequence-parallel and node-row ops run (forward calls, by name)
OP_COUNTS: collections.Counter = collections.Counter()
# what the mesh cuts: "tp" the LMs' weights (Megatron over "model", ZeRO
# over the data axes); "rows" the recsys tables' rows over "model" and the
# batch's rows over the data axes; "edges" the full graph's edges over the
# data axes ("model" cuts nothing in either)
_LAYOUTS = ("tp", "rows", "edges")


def _groups_of(mesh, axes: tuple):
    """(this rank's group over ``axes`` of ``mesh``, its size, this rank's
    position in it, row-major over the axes).  A single axis is the mesh's
    own group; several are one group whose ranks run row-major over them
    (made once per mesh; every rank makes every group, in one order)."""
    names = tuple(mesh.mesh_dim_names)
    coord = mesh.get_coordinate()
    size, pos = 1, 0
    for a in axes:
        n = mesh.size(names.index(a))
        size, pos = size * n, pos * n + coord[names.index(a)]
    if len(axes) == 1:
        return mesh.get_group(axes[0]), size, pos
    # held by the mesh object itself: two meshes of one shape compare
    # equal, also over different process groups, so a mapping keyed by
    # the mesh would hand one the other's groups (or lose them when the
    # other is freed)
    cache = mesh.__dict__.setdefault("_flat_groups", {})
    if axes not in cache:
        grid = mesh.mesh
        dims = [names.index(a) for a in axes]
        rest = [i for i in range(grid.ndim) if i not in dims]
        flat = grid.permute(rest + dims).reshape(-1, size)
        cache[axes] = dist.new_subgroups_by_enumeration(
            [row.tolist() for row in flat])[0]
    return cache[axes], size, pos


def head_split(n_heads: int, tp: int) -> list:
    """Each model rank's query heads ``[h0, h1)``, balanced: ``n_heads //
    tp`` a rank and one more on the first ``n_heads % tp`` ranks (40 over
    16: three on ranks 0-7, two on ranks 8-15)."""
    q, extra = divmod(n_heads, tp)
    spans, h0 = [], 0
    for r in range(tp):
        h1 = h0 + q + (r < extra)
        spans.append((h0, h1))
        h0 = h1
    return spans


def kv_span(h0: int, h1: int, group: int) -> tuple:
    """The KV heads ``[k0, k1)`` that query heads ``[h0, h1)`` read, with
    ``group`` query heads a KV head (none for no query head)."""
    if h1 == h0:
        return h0 // group, h0 // group
    return h0 // group, (h1 - 1) // group + 1


def block(total: int, parts: int, pos: int) -> tuple:
    """GSPMD's block of a dimension of ``total`` entries cut over ``parts``
    ranks: ``ceil(total / parts)`` entries a rank, the last ranks short or
    empty (30 over 4: 8, 8, 8, 6; 5 over 4: 2, 2, 1, 0).  (the block's
    width, rank ``pos``'s first entry, its count)."""
    width = -(-total // parts)
    lo = min(total, pos * width)
    return width, lo, min(total, lo + width) - lo


def _block(n: int, parts: int, name: str) -> int:
    if n % parts:
        raise ValueError(f"{name}: {n} does not split into {parts} shards")
    return n // parts


def local_slices(spec: Spec, shape, mesh, name: str = "leaf") -> tuple:
    """This rank's block of a ``shape`` leaf laid out by ``spec``."""
    out = []
    for dim, n in enumerate(shape):
        axes = spec.axes(dim)
        if not axes:
            out.append(slice(None))
            continue
        _, size, pos = _groups_of(mesh, axes)
        b = _block(n, size, name)
        out.append(slice(pos * b, (pos + 1) * b))
    return tuple(out)


def _spec_at(specs, path):
    for k in path:
        specs = specs[k]
    return specs


def _map_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def shard_tree(full, specs, mesh):
    """This rank's shards of the tensors of ``full``, laid out by the
    matching `Spec`s of ``specs``: a copy of each block smaller than its
    leaf (so that the full leaf can be freed), a leaf whole on this rank
    as it is (made contiguous)."""
    def one(path, t):
        spec = _spec_at(specs, path)
        piece = t[local_slices(spec, t.shape, mesh,
                               ".".join(map(str, path)))]
        return piece.clone(memory_format=torch.contiguous_format) \
            if piece.numel() < t.numel() else piece.contiguous()
    return _map_path(one, full)


def gather_tree(local, specs, mesh, shapes=None):
    """The full tensors of a tree of shards (`shard_tree`'s inverse), on
    every rank: each a DTensor of its spec's placements, ``full_tensor``.
    ``shapes`` (a tree of the full shapes) is needed where a dimension is
    cut into unequal blocks (`block`: a prefill's cache of a prompt that
    "model" does not divide)."""
    from torch.distributed.tensor import DTensor

    def one(path, t):
        spec = _spec_at(specs, path)
        if not any(spec.axes(d) for d in range(t.ndim)):
            return t.clone()
        shape = (list(_spec_at(shapes, path)) if shapes is not None else
                 [n * _groups_of(mesh, spec.axes(d))[1] if spec.axes(d)
                  else n for d, n in enumerate(t.shape)])
        dt = DTensor.from_local(t.contiguous(), mesh,
                                to_placements(spec, mesh),
                                shape=torch.Size(shape),
                                stride=torch.empty(shape,
                                                   device="meta").stride())
        return dt.full_tensor()
    return _map_path(one, local)


def init_shards(make_full, make_meta, spec_fn, mesh):
    """This rank's shards of the tree ``make_full()`` builds, bit-equal to
    cutting that tree, holding one full leaf at a time: ``make_meta()``
    builds the same tree on the ``meta`` device, which gives the order in
    which `layers.uniform_init` makes the leaves; ``make_full`` then runs
    with each new leaf cut to its shard (`layers.LEAF_HOOK`) as soon as it
    is made.  Leaves made otherwise (the norms' ones) are cut afterwards.
    ``spec_fn(path, leaf)`` is a leaf's spec."""
    from ..models.layers import LEAF_HOOK

    made: list = []
    tok = LEAF_HOOK.set(lambda t: made.append(t) or t)
    try:
        meta = make_meta()
    finally:
        LEAF_HOOK.reset(tok)
    where = {}
    _map_path(lambda path, t: where.setdefault(id(t), path), meta)
    order = [where[id(t)] for t in made]
    cuts: list = []

    def cut(t):
        path = order[len(cuts)]
        spec = spec_fn(path, t)
        piece = t[local_slices(spec, t.shape, mesh,
                               ".".join(map(str, path)))].clone()
        cuts.append(piece)
        return piece

    tok = LEAF_HOOK.set(cut)
    try:
        tree = make_full()
    finally:
        LEAF_HOOK.reset(tok)
    done = {id(t) for t in cuts}
    return _map_path(
        lambda path, t: t if id(t) in done else t[local_slices(
            spec_fn(path, t), t.shape, mesh)].clone(), tree)


# --------------------------------------------------------------------------- #
# Collectives along a tensor dimension                                        #
# --------------------------------------------------------------------------- #
def _collective(name: str, old: str):
    """``torch.distributed``'s ``name`` (torch 2.13 deprecates the ``old``
    spelling, which earlier versions alone have)."""
    return getattr(dist, name, None) or getattr(dist, old)


def _all_gather(x, dim: int, group, n: int, keep: int | None = None):
    """``x`` gathered along ``dim`` over ``group``, contiguous (the layout
    of the unsharded weight, so that a product takes the same GEMM); with
    ``keep``, its first ``keep`` entries along ``dim`` (the ranks' blocks
    padded to one width, the padding at the end).  An empty ``x`` (every
    rank of the group holds none: a data rank without rows) moves
    nothing."""
    x = x.movedim(dim, 0).contiguous()
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    if out.numel():
        _collective("all_gather_single", "all_gather_into_tensor")(
            out, x, group=group)
    if keep is not None and keep != out.shape[0]:
        out = out[:keep]
    return out.movedim(0, dim).contiguous()


def _reduce_scatter(g, dim: int, group, n: int):
    g = g.movedim(dim, 0).contiguous()
    out = g.new_empty((g.shape[0] // n,) + tuple(g.shape[1:]))
    if out.numel():
        _collective("reduce_scatter_single", "reduce_scatter_tensor")(
            out, g, op=dist.ReduceOp.SUM, group=group)
    return out.movedim(0, dim)


def _pad_to(x, dim: int, width: int):
    """``x`` zero-padded along ``dim`` to ``width`` entries."""
    pad = width - x.shape[dim]
    if not pad:
        return x
    return torch.cat([x, x.new_zeros(x.shape[:dim] + (pad,)
                                     + x.shape[dim + 1:])], dim)


class _Gather(torch.autograd.Function):
    """A shard cast to ``dtype`` and gathered along ``plan``'s dimensions:
    (dim, group, size, position, kind) in order; a ``"regroup"`` step then
    keeps columns ``[lo, hi)`` of the gathered ``full`` (its position is
    ``(lo, hi, full)``).  Backward, in the shard's dtype: a ``"sum"`` step
    reduce-scatters (the data ranks' partial gradients), a ``"same"`` step
    takes this rank's block (a gradient the same on every rank of the
    group), a ``"regroup"`` step puts the kept columns' gradient into a
    zero leaf and reduce-scatters it (the ranks' columns, a column that
    several ranks keep summed)."""

    @staticmethod
    def forward(ctx, local, dtype, plan):
        ctx.plan, ctx.dtype = plan, local.dtype
        x = local if dtype is None else local.to(dtype)
        for dim, group, n, pos, kind in plan:
            x = _all_gather(x, dim, group, n)
            if kind == "regroup":
                x = x.narrow(dim, pos[0], pos[1] - pos[0]).contiguous()
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.to(ctx.dtype)
        for dim, group, n, pos, kind in reversed(ctx.plan):
            if kind == "regroup":
                lo, hi, full = pos
                shape = list(g.shape)
                shape[dim] = full
                z = g.new_zeros(shape)
                z.narrow(dim, lo, hi - lo).copy_(g)
                g = _reduce_scatter(z, dim, group, n)
            elif kind == "sum":
                g = _reduce_scatter(g, dim, group, n)
            else:
                b = g.shape[dim] // n
                g = g.narrow(dim, pos * b, b)
        return g, None, None


class _AllGather(torch.autograd.Function):
    """Blocks gathered along ``dim`` over ``group`` (``n`` ranks, this one
    at ``pos``); the backward reduce-scatters the ranks' partial
    gradients, or with ``same`` takes this rank's block of a gradient the
    same on every rank.  With ``width`` and ``full`` the blocks are
    unequal (`block`): each is padded to ``width``, and the first ``full``
    entries of the gather kept."""

    @staticmethod
    def forward(ctx, x, dim, group, n, pos, same, width=None, full=None):
        ctx.args = (dim, group, n, pos, same, width, x.shape[dim])
        if width is not None:
            x = _pad_to(x, dim, width)
        return _all_gather(x, dim, group, n, full)

    @staticmethod
    def backward(ctx, g):
        dim, group, n, pos, same, width, count = ctx.args
        none = (None,) * 7
        b = g.shape[dim] // n if width is None else width
        if same:
            # (an empty trailing block may start past the kept entries)
            lo = min(pos * b, g.shape[dim])
            return (g.narrow(dim, lo, count),) + none
        g = _reduce_scatter(_pad_to(g, dim, n * b), dim, group, n)
        if count != b:
            g = g.narrow(dim, 0, count)
        return (g.contiguous(),) + none


class _ReduceScatter(torch.autograd.Function):
    """The ranks' partial sums reduce-scattered along ``dim``: this rank's
    block of the sum (``pos``'s of `block`: a dimension that ``n`` does
    not divide is padded to ``n`` blocks of its width), contiguous (as the
    unsharded tensor is, so that the reductions that read it sum in its
    order); the backward all-gathers."""

    @staticmethod
    def forward(ctx, x, dim, group, n, pos):
        full = x.shape[dim]
        width, _, count = block(full, n, pos)
        ctx.args = (dim, group, n, width, full)
        out = _reduce_scatter(_pad_to(x, dim, n * width), dim, group, n)
        if count != width:
            out = out.narrow(dim, 0, count)
        return out.contiguous()

    @staticmethod
    def backward(ctx, g):
        dim, group, n, width, full = ctx.args
        return (_all_gather(_pad_to(g, dim, width), dim, group, n, full),
                None, None, None, None)


class _CopyToModel(torch.autograd.Function):
    """Identity; the backward sums the gradient over "model"."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    """The sum over "model"; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class MoEGroups(NamedTuple):
    """A rank's MoE groups (`ParallelContext.moe_groups`): ``count`` groups
    of ``size`` tokens of the ``total`` global ones; the rank's part of a
    mean over the groups is its own mean times ``share``, or with ``share``
    None its sum over ``total``; ``move``, where not None, the layout
    `ParallelContext.to_groups` and `from_groups` move its tokens by."""
    count: int
    size: int
    share: float | None
    total: int
    move: tuple | None


def _tensor_parallel(ctx) -> bool:
    return ctx is not None and ctx.tp_size > 1 and ctx.layout == "tp"


def gather_seq(x):
    """The input of a column-parallel product: under sequence parallelism
    (`ParallelContext.seq_parallel`) the rank's block of the sequence
    (B, S / tp, ...) gathered over "model" to (B, S, ...)
    (`ParallelContext.gather_seq`); otherwise `copy_to_model`."""
    ctx = current_context()
    if ctx is not None and ctx.seq_parallel:
        return ctx.gather_seq(x)
    return copy_to_model(x)


def copy_to_model(x):
    """The input of a column-parallel product (Megatron's f): identity;
    under a tensor-parallel context with "model" larger than 1 its
    backward sums the gradient over "model"."""
    ctx = current_context()
    if not _tensor_parallel(ctx):
        return x
    return _CopyToModel.apply(x, ctx.tp_group)


def reduce_from_model(x):
    """A row-parallel product's partial output summed over "model"
    (Megatron's g); identity without a tensor-parallel context or at
    "model" size 1."""
    ctx = current_context()
    if not _tensor_parallel(ctx):
        return x
    return _ReduceFromModel.apply(x, ctx.tp_group)


class _EdgeMax(torch.autograd.Function):
    """A segment max of the rank's edges' scores (``m``, the rank's
    `models.gnn.segment_max` of ``e`` over ``seg``) all-reduced (MAX) over
    the data ranks; the backward splits a segment's (whole) gradient
    evenly among its entries equal to the max on every rank, as
    `models.gnn.segment_max` does on one card (``scatter_reduce``'s rule:
    the gradient over the tie count, gathered, times the entry's tie
    indicator), and passes none to the rank's own max."""

    @staticmethod
    def forward(ctx, m, e, seg, group):
        m = m.clone()
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
        ctx.save_for_backward(e, seg, m)
        ctx.group = group
        return m

    @staticmethod
    def backward(ctx, g):
        e, seg, m = ctx.saved_tensors
        tie = (e == m.index_select(0, seg)).to(g.dtype)
        count = g.new_zeros(m.shape).index_add_(0, seg, tie)
        dist.all_reduce(count, op=dist.ReduceOp.SUM, group=ctx.group)
        return None, tie * (g / count).index_select(0, seg), None, None


# --------------------------------------------------------------------------- #
# The context                                                                  #
# --------------------------------------------------------------------------- #
class ParallelContext:
    """A mesh's groups and this rank's place in them, and what the model's
    hooks (`sharding.constrain`, `sharding.gather_layer_params`,
    `copy_to_model`, ...) do under the step's rules.  ``spec_of(name,
    ndim)`` is the storage spec of a layer leaf named ``name`` (the layer
    stacks' leading axes dropped); ``layout`` is one of `_LAYOUTS`."""

    def __init__(self, mesh, *, multi_pod: bool = False, spec_of=None,
                 layout: str = "tp"):
        if layout not in _LAYOUTS:
            raise ValueError(f"layout {layout!r} is none of {_LAYOUTS}")
        want = ("pod", "data", "model") if multi_pod else ("data", "model")
        if tuple(mesh.mesh_dim_names) != want:
            raise ValueError(f"the mesh's axes are {mesh.mesh_dim_names}, "
                             f"the step wants {want}")
        if mesh.mesh.numel() != dist.get_world_size():
            raise ValueError("the mesh must hold every rank of the group")
        self.mesh = mesh
        self.dp_axes = want[:-1]
        self.dp_group, self.dp_size, self.dp_rank = _groups_of(
            mesh, self.dp_axes)
        self.tp_group, self.tp_size, self.tp_rank = _groups_of(
            mesh, ("model",))
        self.spec_of = spec_of
        # the global rows of the batch the data ranks split (`data_rows`),
        # a microbatch's in training; set by the step
        self.batch_rows = None
        # the sequence the residual stream is cut along (`gather_seq`,
        # `last_token`); set by the step from its tokens
        self.seq_len = None
        self.kv_rep, self.kv_group, self.kv_pos = 1, None, 0
        # the serving cache's sequence axes (`serve_layout`)
        self.seq_group, self.seq_size, self.seq_pos = (
            self.tp_group, self.tp_size, self.tp_rank)
        self.tokens_replicated = False
        # query heads that "model" does not divide (`split_heads`): every
        # model rank's heads and KV heads, this rank's head columns of
        # each head leaf, and its query heads' local KV heads
        self.head_spans = self.kv_spans = None
        self.head_cols: dict = {}
        self.kv_index = None
        self._indices: dict = {}
        self.layout = layout
        # the residual stream cut along the sequence over "model" between
        # layers (``act_btd``): the LMs' training and prefill steps
        self.seq_parallel = layout == "tp"

    def serve_layout(self, long: bool, prefill: bool) -> None:
        """The serving steps' layout: the cache's sequence over "model"
        and the tokens' rows over the data axes, or with ``long``
        (``long_500k``) the sequence over the data axes and "model"
        (row-major) and the tokens replicated on every rank.  Only a
        prefill of rows over the data axes cuts its residual stream along
        the sequence (`seq_parallel`); a decode step's one token and
        ``long_500k``'s replicated tokens stay whole."""
        if long:
            self.seq_group, self.seq_size, self.seq_pos = _groups_of(
                self.mesh, self.dp_axes + ("model",))
        self.tokens_replicated = long
        self.seq_parallel = prefill and not long

    def replicate_kv(self, n_kv_heads: int) -> None:
        """Megatron's GQA layout where "model" is wider than the KV heads
        (``tp`` a multiple of ``n_kv_heads``): each run of ``tp /
        n_kv_heads`` consecutive model ranks shares one KV head, whose
        ``wk``/``wv`` columns it holds in equal blocks (the reference's
        spec cuts the columns evenly over "model").  The layer's gather
        all-gathers the head over that run, and its backward
        reduce-scatters the run's summed gradient back into the blocks.
        Every rank makes every run's group, in one order."""
        rep = self.tp_size // n_kv_heads
        if rep <= 1:
            return
        grid = self.mesh.mesh
        rows = grid.reshape(-1, grid.shape[-1])
        runs = [row[h * rep:(h + 1) * rep].tolist()
                for row in rows for h in range(n_kv_heads)]
        self.kv_group = dist.new_subgroups_by_enumeration(runs)[0]
        self.kv_rep, self.kv_pos = rep, self.tp_rank % rep

    def split_heads(self, n_heads: int, widths: dict,
                    group: int | None = None) -> None:
        """Whole heads a model rank where "model" does not divide them:
        ``n_heads`` query heads by `head_split`; ``widths`` maps each head
        leaf to (its columns a head, ``"q"`` or ``"kv"``): ``"q"`` columns
        follow the rank's query heads, ``"kv"`` columns (GQA's ``wk``,
        ``wv``, ``group`` query heads a KV head) the KV heads they read
        (`kv_span`).  `gather_weight` then gathers those leaves over
        "model" too and keeps the rank's columns."""
        self.head_spans = head_split(n_heads, self.tp_size)
        h0, h1 = self.head_spans[self.tp_rank]
        if group is not None:
            self.kv_spans = [kv_span(a, b, group)
                             for a, b in self.head_spans]
            k0 = self.kv_spans[self.tp_rank][0]
            self.kv_index = tuple(h // group - k0 for h in range(h0, h1))
        for name, (width, of) in widths.items():
            lo, hi = (self.kv_spans[self.tp_rank] if of == "kv"
                      else (h0, h1))
            self.head_cols[name] = (lo * width, hi * width)

    def _index_on(self, key, entries, device):
        """The int64 index ``entries`` on ``device``, copied there once: a
        host list copied to the card at each call would wait for the
        card's stream every layer."""
        t = self._indices.get((key, device))
        if t is None:
            t = torch.tensor(entries, dtype=torch.long).to(device)
            self._indices[(key, device)] = t
        return t

    def kv_index_on(self, device):
        """``kv_index`` (each local query head's local KV head) as a
        tensor on ``device``."""
        return self._index_on("kv_index", self.kv_index, device)

    def own_heads(self, n_local: int) -> int:
        """The first of this rank's ``n_local`` query heads."""
        if self.head_spans is not None:
            return self.head_spans[self.tp_rank][0]
        return self.tp_rank * n_local

    # ---- the MoE's split (the step checked the divisions) ----
    def local_experts(self, n_experts: int) -> tuple:
        el = n_experts // self.tp_size
        return self.tp_rank * el, el

    def moe_groups(self, shape: tuple, dispatch_groups: int) -> MoEGroups:
        """This rank's part of the reference's ``gcd(T, dispatch_groups)``
        MoE groups over the T global tokens of the batch (`batch_rows`
        rows, ``shape`` = (this rank's rows, ..., d) its tokens), as
        GSPMD cuts them over the data ranks (`block`: ``ceil(G / dp)`` a
        rank, the last ranks fewer or none).  Where the data ranks divide
        the rows and the groups, a rank's tokens are its groups and its
        aux values are its mean times ``1 / dp``; otherwise the tokens
        move to the ranks of their groups (`to_groups`) unless they are
        there already, and a rank's part of the global mean is its sum
        over G.  Tokens replicated over the data ranks (``long_500k``)
        are all the global tokens: every rank runs all their groups."""
        t = math.prod(shape[:-1])
        dg = max(dispatch_groups, 1)
        if self.tokens_replicated:
            g = math.gcd(t, dg)
            return MoEGroups(g, t // g, 1.0, g, None)
        dp, rows = self.dp_size, self.batch_rows
        per_row = math.prod(shape[1:-1])
        total = rows * per_row
        g = math.gcd(total, dg)
        size = total // g
        if rows % dp == 0 and g % dp == 0:
            return MoEGroups(g // dp, size, 1.0 / dp, g, None)
        tokens = [tuple(v * per_row for v in block(rows, dp, r)[1:])
                  for r in range(dp)]
        groups = [tuple(v * size for v in block(g, dp, r)[1:])
                  for r in range(dp)]
        count = groups[self.dp_rank][1] // size
        move = None if tokens == groups else (
            block(rows, dp, 0)[0] * per_row, block(g, dp, 0)[0] * size,
            total, tokens[self.dp_rank], groups[self.dp_rank])
        return MoEGroups(count, size, None, g, move)

    def to_groups(self, x, move):
        """A rank's tokens (t, ...) as the tokens of its MoE groups: every
        data rank's gathered (padded to the widest rank's), and this
        rank's groups' kept; the backward reduce-scatters the groups'
        gradients back to the ranks that hold their tokens."""
        width, _, total, _, (lo, count) = move
        x = _AllGather.apply(x, 0, self.dp_group, self.dp_size,
                             self.dp_rank, False, width, total)
        return x.narrow(0, lo, count)

    def from_groups(self, y, move):
        """`to_groups`' inverse: every rank's groups' outputs gathered
        (padded to the most groups a rank), and this rank's tokens'
        kept."""
        _, width, total, (lo, count), _ = move
        y = _AllGather.apply(y, 0, self.dp_group, self.dp_size,
                             self.dp_rank, False, width, total)
        return y.narrow(0, lo, count)

    # ---- the model's hooks ----
    def constrain(self, x, name, spec):
        if name == "act_btd":
            return (self.scatter_seq(x) if self.seq_parallel
                    else reduce_from_model(x))
        return x

    # ---- sequence parallelism over "model" ----
    def gather_seq(self, x, same: bool = False):
        """The rank's block of the sequence, (B, S / tp, ...), gathered
        over "model" to (B, S, ...); the backward reduce-scatters the
        model ranks' partial gradients, or with ``same`` (a gradient the
        same on every model rank) takes the rank's block.  A sequence that
        "model" does not divide is cut as GSPMD pads it (`block`): each
        block padded to ``ceil(S / tp)`` for the gather, the padding
        dropped."""
        OP_COUNTS["gather_seq"] += 1
        width = block(self.seq_len, self.tp_size, 0)[0]
        return _AllGather.apply(x, 1, self.tp_group, self.tp_size,
                                self.tp_rank, same, width, self.seq_len)

    def scatter_seq(self, x):
        """A row-parallel product's partial output (B, S, ...) summed over
        "model" into the rank's block of the sequence, (B, S / tp, ...),
        or its `block` where "model" does not divide S; the backward
        all-gathers."""
        OP_COUNTS["scatter_seq"] += 1
        return _ReduceScatter.apply(x, 1, self.tp_group, self.tp_size,
                                    self.tp_rank)

    def last_token(self, x):
        """The last token's rows (B, d) of the residual (B, S / tp, d), on
        every rank: each rank's last row gathered (zeros from an empty
        block), the one of the rank whose block holds token S - 1 kept
        (the last rank's where "model" divides S); the whole residual's
        last row without sequence parallelism."""
        if not self.seq_parallel:
            return x[:, -1, :]
        OP_COUNTS["last_token"] += 1
        row = x[:, -1:, :] if x.shape[1] else x.new_zeros(
            (x.shape[0], 1) + tuple(x.shape[2:]))
        owner = (self.seq_len - 1) // block(self.seq_len, self.tp_size, 0)[0]
        return _all_gather(row, 1, self.tp_group, self.tp_size)[:, owner, :]

    def _plan(self, storage: Spec, gathered: Spec, ndim: int,
              model_kind: str = "same") -> tuple:
        plan = []
        for dim in range(ndim):
            keep = set(gathered.axes(dim))
            for kind, axes in (("sum", self.dp_axes),
                               (model_kind, ("model",))):
                have = tuple(a for a in storage.axes(dim) if a in axes)
                if have and not keep & set(have):
                    group, n, pos = _groups_of(self.mesh, have)
                    plan.append((dim, group, n, pos, kind))
        return tuple(plan)

    def gather_weight(self, name, local, dtype):
        """``local`` cast to ``dtype`` and gathered to its compute layout
        (`sharding.gathered_spec`; the router whole: under sequence
        parallelism it routes the rank's block of the sequence, so its
        gradient is partial over "model" and reduce-scattered, else the
        same on every model rank); a leaf without one (a norm) is cast
        alone."""
        want = gathered_spec(name, local.ndim)
        model_kind = "same"
        if name in self.head_cols:
            return self._gather_heads_of(name, local, dtype)
        if name in _WHOLE:
            want = Spec(*(None,) * local.ndim)
            model_kind = "sum" if self.seq_parallel else "same"
        if want is None:
            return local if dtype is None else local.to(dtype)
        plan = self._plan(self.spec_of(name, local.ndim), want, local.ndim,
                          model_kind)
        if self.kv_rep > 1 and name in _KV:
            plan += ((local.ndim - 1, self.kv_group, self.kv_rep,
                      self.kv_pos, "sum"),)
        if not plan:
            return local if dtype is None else local.to(dtype)
        return _Gather.apply(local, dtype, plan)

    def _gather_heads_of(self, name, local, dtype):
        """A head leaf under `split_heads`: gathered whole over the data
        axes and "model", this rank's head columns (rows of ``wo``)
        kept."""
        lo, hi = self.head_cols[name]
        plan = tuple(
            (dim, group, n, (lo, hi, n * local.shape[dim]), kind)
            if kind == "regroup" else (dim, group, n, pos, kind)
            for dim, group, n, pos, kind in self._plan(
                self.spec_of(name, local.ndim), Spec(*(None,) * local.ndim),
                local.ndim, "regroup"))
        return _Gather.apply(local, dtype, plan)

    def gather_vocab(self, name, local, dtype=None):
        """``embed`` or ``lm_head`` gathered over the data axes to its
        vocabulary-parallel layout."""
        plan = self._plan(self.spec_of(name, local.ndim),
                          _VOCAB_GATHERED[name], local.ndim)
        return _Gather.apply(local, dtype, plan)

    def _block_ids(self, ids, v_local: int):
        """``ids`` as offsets into this rank's row block (``v_local`` rows
        a model rank), and whether the block holds each."""
        loc = ids - self.tp_rank * v_local
        return loc, (loc >= 0) & (loc < v_local)

    def _own_rows(self, table, ids):
        """``F.embedding(ids, table)`` over this rank's row block
        ``table``: its rows, zero for the ids the block does not hold."""
        if self.tp_size == 1:
            return torch.nn.functional.embedding(ids, table)
        loc, own = self._block_ids(ids, table.shape[0])
        rows = torch.nn.functional.embedding(loc.clamp(0, table.shape[0] - 1),
                                             table)
        return torch.where(own[..., None], rows, 0.0)

    def embed(self, table, tokens):
        """The rows of this rank's vocabulary range for ``tokens`` (zero for
        the other tokens; the sum over "model" at ``act_btd``, under
        sequence parallelism a reduce-scatter into the rank's block of
        the sequence, is the lookup).  Under the recsys layout the table is not cut over the
        data axes and no ``act_btd`` sum follows: `vocab_rows`."""
        if self.layout != "tp":
            return self.vocab_rows(table, tokens)
        return self._own_rows(self.gather_vocab("embed", table), tokens)

    def xent_chunk(self, hc, yc, w):
        """`transformer._xent_chunk` over a head whose columns are this
        rank's vocabulary range: the log-sum-exp's max and sum and the
        label's logit reduced over "model"."""
        logits = (hc @ w).float()
        v = w.shape[1]
        m = logits.detach().amax(dim=-1)
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=self.tp_group)
        se = reduce_from_model(torch.exp(logits - m[:, None]).sum(dim=-1))
        lse = torch.log(se) + m
        ids = yc.clamp_min(0).long() - self.tp_rank * v
        own = (ids >= 0) & (ids < v)
        ll = logits.gather(1, ids.clamp(0, v - 1)[:, None])[:, 0]
        ll = reduce_from_model(torch.where(own, ll, 0.0))
        valid = yc >= 0
        return torch.where(valid, lse - ll, 0.0).sum(), valid.sum()

    def data_sum(self, x):
        """``x`` summed over the data ranks (no gradient)."""
        x = x.detach().clone()
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=self.dp_group)
        return x

    # ---- serving (no gradient) ----
    def gather_logits(self, x):
        """The head's (B_local, V / tp) logits gathered over "model" to
        every vocabulary column and over the data ranks to every row: the
        whole (B, V) on every rank."""
        if self.tp_size > 1:
            x = _all_gather(x, x.ndim - 1, self.tp_group, self.tp_size)
        if self.dp_size > 1 and not self.tokens_replicated:
            x = _all_gather(x, 0, self.dp_group, self.dp_size)
        return x

    def gather_heads(self, x):
        """A decode step's per-head tensor (B, heads of this rank, ...)
        gathered over "model" to every head, in head order; under
        `split_heads` each rank's heads padded to the largest count and
        the padding dropped."""
        if self.tp_size == 1:
            return x
        if self.head_spans is None:
            return _all_gather(x, 1, self.tp_group, self.tp_size)
        return self._gather_spans(x, self.head_spans, 1)

    def _gather_spans(self, x, spans, dim: int):
        """``x``'s entries ``spans[r]`` (an unequal count a rank) along
        ``dim`` gathered over "model": each rank's padded to the largest
        count, then one copy of each entry kept, its first owner's."""
        width = max(b - a for a, b in spans)
        got = _all_gather(_pad_to(x, dim, width), dim, self.tp_group,
                          self.tp_size)
        return got.index_select(dim, self._owners_on(spans, width,
                                                     got.device))

    def _owners_on(self, spans, width: int, device):
        return self._index_on(("owners", tuple(spans), width),
                              self._first_owners(spans, width), device)

    @staticmethod
    def _first_owners(spans, width: int) -> list:
        """Each entry's place in the padded gather: its first owning
        rank's slot."""
        idx, seen = [], 0
        for r, (a, b) in enumerate(spans):
            for j in range(max(a, seen), b):
                idx.append(r * width + j - a)
            seen = max(seen, b)
        return idx

    def gather_kv_heads(self, x):
        """The new token's (B, KV heads of this rank, D) over "model" to
        (B, Hkv, D): under `replicate_kv` a run of ranks holds one head,
        under `split_heads` neighbouring ranks may share one; one copy of
        each is kept."""
        if self.kv_spans is not None:
            return self._gather_spans(x, self.kv_spans, 1)
        x = self.gather_heads(x)
        return x[:, ::self.kv_rep] if self.kv_rep > 1 else x

    def seq_attend(self, scores, values):
        """Softmax attention over the sequence group: ``scores`` (...,
        S_local) this rank's masked scores (masked ones the finite
        ``NEG_INF``), ``values(w)`` the product of weights (..., S_local)
        with the rank's values, (..., Dv).  The float32 row max is
        all-reduced first, so each rank's exponentials are relative to the
        global max (a block with no valid position weighs exp(-1e30 - M)
        = 0); the exp-sums and unnormalised outputs are then summed over
        the group and divided, in float32."""
        s = scores.float()
        m = s.amax(dim=-1, keepdim=True)
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=self.seq_group)
        e = torch.exp(s - m)
        part = torch.cat([values(e.to(scores.dtype)).float(),
                          e.sum(dim=-1, keepdim=True)], dim=-1)
        dist.all_reduce(part, op=dist.ReduceOp.SUM, group=self.seq_group)
        return (part[..., :-1] / part[..., -1:]).to(scores.dtype)

    def cache_block(self, t):
        """A prefill layer's cache entry, (B, S, this rank's KV heads, D)
        for GQA or (B, S, r) for MLA's latents, as this rank's block of
        the decode layout: (B, S / tp, Hkv, D) through an all-to-all over
        "model" (sequence block j of this rank's heads to rank j; under
        `replicate_kv` one copy of each head kept), or MLA's block of the
        latents, which every model rank holds whole.  A prompt that
        "model" does not divide gives the blocks of `block` (the prompt
        padded for the all-to-all, the padding dropped)."""
        if self.tp_size == 1:
            return t
        b, s, n = t.shape[0], t.shape[1], self.tp_size
        blk, lo, count = block(s, n, self.tp_rank)
        if t.ndim == 3:
            return t[:, lo:lo + count]
        spans = self.kv_spans
        if spans is not None:        # (`split_heads`) unequal KV heads
            width = max(k1 - k0 for k0, k1 in spans)
            t = _pad_to(t, 2, width)
        # a prompt that "model" does not divide: blocks of ceil(S / tp)
        t = _pad_to(t, 1, n * blk)
        send = t.reshape(b, n, blk, *t.shape[2:]).movedim(1, 0).contiguous()
        got = torch.empty_like(send)
        dist.all_to_all_single(got, send, group=self.tp_group)
        got = got.movedim(0, 2).reshape(b, blk, -1, t.shape[-1])
        if count != blk:
            got = got[:, :count]
        if spans is not None:
            return got.index_select(2, self._owners_on(spans, width,
                                                       got.device))
        return got[:, :, ::self.kv_rep] if self.kv_rep > 1 else got

    # ---- the recsys and GAT steps ----
    def model_sum(self, x):
        """A lookup's partial rows (this rank's table rows; zero for the
        others) summed over "model"; identity backward.  The plain value
        at "model" size 1."""
        if self.tp_size == 1:
            return x
        return _ReduceFromModel.apply(x, self.tp_group)

    def localize_rows(self, ids, v_local: int):
        """Table ids as this rank's row block of a table of ``v_local`` rows
        a model rank: ``id - row0``, -1 outside the block (padding, -1,
        stays -1).  An id past the whole table is first clamped to its last
        row, which the unsharded kernel reads (`kernels.ops.embedding_bag`
        clamps; unclamped, every rank would read its block's last row)."""
        loc, own = self._block_ids(ids.clamp_max(v_local * self.tp_size - 1),
                                   v_local)
        return torch.where(own, loc, torch.full_like(loc, -1))

    def vocab_rows(self, table, ids):
        """``F.embedding(ids, table)`` over the row blocks of a table cut
        over "model" (BERT4Rec's items): the rows of this rank's block,
        zero for the other ids, summed over "model"."""
        return self.model_sum(self._own_rows(table, ids))

    def gather_linear(self, w, full: tuple):
        """An ``nn.Linear`` weight (out, in) whose (in, out) leaf is stored
        by the reference's ``rs_param_spec`` (columns or rows over
        "model"), gathered whole and contiguous (the unsharded module's
        layout, so the product is the unsharded GEMM); its gradient is the
        same on every model rank, whose block the backward keeps."""
        if tuple(w.shape) == tuple(full):
            return w.contiguous()
        dim = 0 if w.shape[0] != full[0] else 1
        return _Gather.apply(w, None, ((dim, self.tp_group, self.tp_size,
                                        self.tp_rank, "same"),))

    def gather_data_rows(self, x):
        """``x``'s rows over the data ranks, in rank order (no gradient):
        the whole batch's outputs of a serving step, or the occurrences of
        a table's row gradient."""
        if self.dp_size == 1:
            return x
        return _all_gather(x, 0, self.dp_group, self.dp_size)

    def batch_mean(self, x):
        """The global batch's mean of a per-row ``x`` of this rank's rows:
        their sum over the global count (the ranks' results sum to the
        mean); ``torch.mean`` where the rows are not split."""
        if self.layout != "rows" or self.dp_size == 1:
            return torch.mean(x)
        return x.sum() / (x.numel() * self.dp_size)

    def batch_count(self, n):
        """A count over this rank's rows as the global batch's count."""
        if self.layout != "rows" or self.dp_size == 1:
            return n
        return self.data_sum(n)

    def merge_top_k(self, vals, idx, k: int, counts, over: str):
        """The ``k`` largest of the ranks' top lists over ``over`` ("data"
        or "model"), in `utils.top_k`'s order: ``vals`` (B, counts[pos])
        this rank's list (descending, equal values in ascending index
        order) and ``idx`` its global indices, the ranks' index ranges
        ascending with their position.  The lists are gathered and
        concatenated in rank order, so equal values stand in ascending
        index order, and one `utils.top_k` picks the k."""
        from ..utils import top_k

        group, n = ((self.dp_group, self.dp_size) if over == "data" else
                    (self.tp_group, self.tp_size))
        if n == 1:
            return vals, idx
        pad = max(counts) - vals.shape[1]
        pairs = torch.stack([vals.double(), idx.double()])
        if pad:
            pairs = torch.nn.functional.pad(pairs, (0, pad))
        got = _all_gather(pairs[None], 0, group, n)      # (n, 2, B, kmax)
        allv = torch.cat([got[r, 0, :, :c] for r, c in enumerate(counts)], 1)
        alli = torch.cat([got[r, 1, :, :c] for r, c in enumerate(counts)], 1)
        v, pos = top_k(allv.float(), k)
        return v, alli.gather(1, pos).long()

    def node_rows(self, x):
        """The rank's block of a node tensor's (padded) rows over the data
        ranks: the reference's ``nodes_nd``."""
        b = _block(x.shape[0], self.dp_size, "the padded nodes")
        return x.narrow(0, self.dp_rank * b, b)

    def to_edges(self, x):
        """A node tensor held as the rank's rows (`node_rows`), gathered
        whole for the rank's edges to read: all-gather over the data
        ranks; the backward reduce-scatters the edges' partial
        gradients."""
        OP_COUNTS["to_edges"] += 1
        return _AllGather.apply(x, 0, self.dp_group, self.dp_size,
                                self.dp_rank, False)

    def node_scatter(self, x):
        """The ranks' partial sums over their edges of a node tensor,
        reduce-scattered into the rank's rows; the backward all-gathers."""
        OP_COUNTS["node_scatter"] += 1
        return _ReduceScatter.apply(x, 0, self.dp_group, self.dp_size,
                                    self.dp_rank)

    def edge_sum(self, x):
        """The ranks' partial sums over their edges of a node tensor,
        summed over the data ranks; identity backward (the result is whole
        on every rank, and so is its gradient)."""
        return _ReduceFromModel.apply(x, self.dp_group)

    def edge_whole(self, x):
        """A node tensor whole on every data rank (`edge_sum`'s,
        `edge_max`'s) as the rank's edges read it: identity; the backward
        sums the ranks' partial gradients (Megatron's f over the data
        axes)."""
        return _CopyToModel.apply(x, self.dp_group)

    def edge_max(self, m, e, seg):
        """The segment max ``m`` of the rank's edges ``e`` over ``seg``, as
        the max over every rank's edges (`_EdgeMax`)."""
        return _EdgeMax.apply(m, e, seg, self.dp_group)

    # ---- after the backward ----
    def _replicated_over(self, spec: Spec, ndim: int) -> set:
        named = {a for d in range(ndim) for a in spec.axes(d)}
        return {a for a in self.mesh.mesh_dim_names if a not in named}

    @torch.no_grad()
    def sum_replicated_grads(self, grads, specs):
        """Sum over the data ranks the gradients of the leaves that are not
        split over the data axes (each rank holds its tokens' part), and
        under sequence parallelism with "model" larger than 1 over "model"
        those not split over "model" (each model rank holds its block of
        the sequence's part).  A sparse row gradient
        (`models.recsys.row_grad`) is the sum already: its lookup gathered
        every data rank's occurrences."""
        over_model = self.seq_parallel and self.tp_size > 1

        def one(path, g):
            spec = _spec_at(specs, path)
            if g.is_sparse:
                return
            rep = self._replicated_over(spec, g.ndim)
            groups = [self.dp_group] if set(self.dp_axes) <= rep else []
            if over_model and "model" in rep:
                groups.append(self.tp_group)
            if not groups:
                return
            # (an MLP weight's gradient is a transposed view)
            t = g if g.is_contiguous() else g.contiguous()
            for group in groups:
                dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
            if t is not g:
                g.copy_(t)
        _map_path(one, grads)

    @torch.no_grad()
    def global_norm(self, grads, specs) -> torch.Tensor:
        """The global norm of a tree of gradient shards, each element
        counted once: a leaf replicated over some axes counts on the ranks
        at position 0 of them; the squares summed over every rank."""
        coord = dict(zip(self.mesh.mesh_dim_names,
                         self.mesh.get_coordinate()))
        parts = []

        def one(path, g):
            spec = _spec_at(specs, path)
            if all(coord[a] == 0
                   for a in self._replicated_over(spec, g.ndim)):
                parts.append(torch.sum(torch.square(g.float())))
        _map_path(one, grads)
        dev = next(iter(_leaves(grads))).device
        sq = sum(parts) if parts else torch.zeros((), device=dev)
        sq = sq.reshape(1).clone()
        dist.all_reduce(sq, op=dist.ReduceOp.SUM)
        return torch.sqrt(sq[0])


def _leaves(tree):
    out: list = []
    _map_path(lambda _, t: out.append(t), tree)
    return out


def data_rows(batch_rows: int, accum: int, dp_size: int, dp_rank: int
              ) -> np.ndarray:
    """The global batch rows a data rank holds: its block of each of the
    ``accum`` microbatches (consecutive rows of the global batch, as the
    reference reshapes it), microbatch after microbatch; a microbatch that
    the data ranks do not divide is cut as GSPMD pads it (`block`: the
    last ranks hold fewer rows or none)."""
    mb = batch_rows // accum
    if batch_rows % accum:
        raise ValueError(f"{accum} microbatches do not divide a batch of "
                         f"{batch_rows}")
    _, lo, count = block(mb, dp_size, dp_rank)
    return np.concatenate([np.arange(i * mb + lo, i * mb + lo + count)
                           for i in range(accum)])
