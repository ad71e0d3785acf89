"""Distributed SNN: the sorted index sharded contiguously over a mesh axis.

The counterpart of ``repro.core.sharded``.  Layout: shard k of the ``data``
axis holds padded sorted rows ``[k*n_pad/D, (k+1)*n_pad/D)``.  Because the
global sort order is preserved within and across shards, every shard runs
the same alpha-window pruning locally; a query's window touches at most a
contiguous run of shards, and the kernels skip every row tile outside it.

A "mesh" is a `torch.distributed.device_mesh.DeviceMesh` with a named
``axis`` (`launch.mesh`), or, for the decomposition alone, a plain int
shard count.  Two kinds of entry point:

* **The decomposition** (`mesh_segments`, `mesh_pack`,
  `query_radius_csr_sharded`) needs no collective and runs in one process:
  one engine `Segment` a shard, the whole list on the index's device, the
  CSR query through the packed or the looped executor.  Its rows,
  distances included, are bit-identical to the single-device
  `snn.query_radius_csr` on the same index: every kernel sums a pair's
  product in one fixed order, whichever segment holds the row.
* **The collectives** (`shard_index`, `make_sharded_count_fn`,
  `make_sharded_percount_fn`, `make_sharded_topk_fn`) run in every rank of
  the axis's process group (``mesh.get_group(axis)``): each rank filters its
  own shard (`_local_filter`: the CUDA filter kernel on a CUDA shard, its
  plain version on a CPU shard), then one ``all_reduce`` or ``all_gather``
  combines the ranks in rank order.  Outputs have fixed shapes (counts,
  per-shard counts, per-shard top-k); exact variable-length extraction
  stays with the decomposition, as in the single-device API.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import registry as _registry
from ..kernels.ref import BIG as _BIG
from ..kernels.snn_query import ROW_TILE as _ROW_TILE
from . import engine as _engine
from . import snn as _snn

_LANE = 128


def _axes(axis) -> tuple:
    return axis if isinstance(axis, tuple) else (axis,)


def _axis_size(mesh, axis) -> int:
    """Shards along ``axis`` (a name or a tuple of names) of a
    `DeviceMesh`, or ``mesh`` itself when it is an int shard count."""
    if isinstance(mesh, (int, np.integer)):
        return int(mesh)
    names = mesh.mesh_dim_names
    return int(np.prod([mesh.size(names.index(a)) for a in _axes(axis)]))


def _axis_rank(mesh, axis) -> int:
    """This rank's shard along ``axis``; over a tuple of names the
    row-major position (the first name the slowest, as in JAX's
    ``P(("pod", "data"))``)."""
    rank = 0
    for a in _axes(axis):
        rank = (rank * mesh.size(mesh.mesh_dim_names.index(a))
                + mesh.get_local_rank(a))
    return rank


def _mesh_device(mesh) -> torch.device:
    """The device this rank's shards live on: its current card for a CUDA
    mesh, the CPU for a CPU one."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _pad_for_shards(index: _snn.SNNIndex, nshards: int, block: int = 512):
    """Shard padding: rows to a (nshards * block) multiple.

    Returns (xs, alphas, half_norms, order, projs, rows_per_shard): tensors
    on the index's device but ``order``, a host int64 array.  Padding rows
    carry +BIG alpha and half norm (and +BIG extra projections, when the
    index has them) so they never match, and order -1.
    """
    unit = nshards * block
    n, d = index.xs.shape
    npad = max(-(-n // unit), 1) * unit
    dev = index.device

    def big(*shape):
        return torch.full(shape, _BIG, dtype=torch.float32, device=dev)

    xs = torch.cat([index.xs, torch.zeros((npad - n, d), dtype=torch.float32,
                                          device=dev)])
    al = torch.cat([index.alphas, big(npad - n)])
    hn = torch.cat([index.half_norms, big(npad - n)])
    od = np.concatenate([index.order, np.full(npad - n, -1, np.int64)])
    ep = _engine._index_extra_projs(index)
    pj = None if ep is None else torch.cat(
        [ep.to(torch.float32), big(ep.shape[0], npad - n)], 1)
    return xs, al, hn, od, pj, npad // nshards


def shard_block(index: _snn.SNNIndex, nshards: int, k: int,
                block: int = 512):
    """Shard ``k`` of `_pad_for_shards`' padded arrays, cut from the index
    without padding a copy of all of it: (xs, alphas, half_norms, order)
    of padded sorted rows ``[k*n_pad/D, (k+1)*n_pad/D)``, views of the
    index's rows where the block holds no padding, else the block's real
    rows with the padding rows (+BIG alpha and half norm, order -1, zero
    rows) after them.  For an index too large to copy whole (a host
    index of 51.5 GB cut into one card's shard at a time)."""
    unit = nshards * block
    n, d = index.xs.shape
    per = max(-(-n // unit), 1) * unit // nshards
    lo = min(k * per, n)
    hi = min((k + 1) * per, n)
    pad = per - (hi - lo)
    xs, al = index.xs[lo:hi], index.alphas[lo:hi]
    hn, od = index.half_norms[lo:hi], index.order[lo:hi]
    if pad:
        dev = index.device
        big = torch.full((pad,), _BIG, dtype=torch.float32, device=dev)
        xs = torch.cat([xs, torch.zeros((pad, d), dtype=torch.float32,
                                        device=dev)])
        al, hn = torch.cat([al, big]), torch.cat([hn, big])
        od = np.concatenate([od, np.full(pad, -1, np.int64)])
    return xs, al, hn, od


def shard_index(index: _snn.SNNIndex, mesh, axis: str = "data",
                block: int = 512, device=None):
    """This rank's shard of the padded sorted database.

    Returns (xs (n_pad/D, d), alphas, half_norms, order) on ``device``
    (default: the mesh's device of this rank), rank k of ``axis`` holding
    padded sorted rows ``[k*n_pad/D, (k+1)*n_pad/D)``.  Padding rows carry
    +BIG alpha and half norm and order -1.  The shard is cut from the
    index (`shard_block`); no padded copy of the whole index is made.
    """
    nshards, k = _axis_size(mesh, axis), _axis_rank(mesh, axis)
    dev = _mesh_device(mesh) if device is None else torch.device(device)
    xs, al, hn, od = shard_block(index, nshards, k, block)
    return (xs.to(dev).contiguous(), al.to(dev).contiguous(),
            hn.to(dev).contiguous(), torch.from_numpy(od).to(dev))


def _local_filter(xs, alphas, half_norms, xq, aq, r, thresh):
    """Per-shard masked halved distances (m, n_local); +BIG where pruned.

    ``hn - xq @ xs.T`` where the alpha window and the threshold keep the
    pair: the filter kernel (no projections) for CUDA tensors, its plain
    version for CPU ones (`kernels.registry`).  The operands are padded to
    the kernel's contract here (queries to a 128-row tile with r = thresh =
    -BIG, features to 128 lanes with zeros, rows to 128 with +BIG) and the
    output trimmed back; operands already in shape are not copied.
    """
    m, d = xq.shape
    n = xs.shape[0]
    dp, npd, mp = (-d) % _LANE, (-n) % _ROW_TILE, (-m) % _ROW_TILE
    if dp or npd:
        xs = F.pad(xs, (0, dp, 0, npd))
    if npd:
        alphas = F.pad(alphas, (0, npd), value=_BIG)
        half_norms = F.pad(half_norms, (0, npd), value=_BIG)
    if dp or mp:
        xq = F.pad(xq, (0, dp, 0, mp))
    if mp:
        aq = F.pad(aq, (0, mp))
        r = F.pad(r, (0, mp), value=-_BIG)
        thresh = F.pad(thresh, (0, mp), value=-_BIG)
    dh = _registry.snn_filter(xq, aq, r, thresh, xs, alphas, half_norms,
                              bn=_ROW_TILE)
    return dh[:m, :n]


def make_sharded_count_fn(mesh, axis: str = "data"):
    """Returns count(xs, alphas, hn, xq, aq, r, thresh) -> (m,) int32.

    Queries replicated; the database is this rank's shard (`shard_index`);
    one ``all_reduce`` (sum) over the axis's group.  These counts come from
    the filter, another program than the CSR passes' count, so they must
    not source scatter offsets (see `query_radius_csr_sharded`).
    """
    import torch.distributed as dist

    group = mesh.get_group(axis)

    def count(xs, alphas, hn, xq, aq, r, thresh):
        dh = _local_filter(xs, alphas, hn, xq, aq, r, thresh)
        local = (dh < _BIG).sum(dim=1, dtype=torch.int32)
        del dh
        dist.all_reduce(local, op=dist.ReduceOp.SUM, group=group)
        return local

    return count


def _gather(t: torch.Tensor, group) -> list[torch.Tensor]:
    """``t`` from every rank of ``group``, in rank order."""
    import torch.distributed as dist

    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return parts


def make_sharded_topk_fn(mesh, k_per_shard: int, axis: str = "data"):
    """Returns topk(xs, alphas, hn, order, xq, aq, r, thresh) ->
    (idx (m, D*k), dhalf (m, D*k)) gathering each shard's k best candidates.

    Each rank takes its shard's ``k_per_shard`` smallest masked half
    distances (ascending, equal values in ascending row order, as
    ``jax.lax.top_k`` orders them: `snn._smallest_k`), with original ids
    ``order[row]``, or -1 where the pair is pruned (dhalf +BIG); the ranks'
    lists are concatenated along axis 1 in rank order.  Exact as long as no
    shard holds more than ``k_per_shard`` true neighbours of a query
    (callers check with the count function and query again with a larger
    k).
    """
    group = mesh.get_group(axis)
    k = int(k_per_shard)

    def topk(xs, alphas, hn, order, xq, aq, r, thresh):
        dh = _local_filter(xs, alphas, hn, xq, aq, r, thresh)
        vals, loc = _snn._smallest_k(dh, k)
        del dh
        ids = torch.where(vals < _BIG, order[loc], -1)
        return (torch.cat(_gather(ids, group), dim=1),
                torch.cat(_gather(vals, group), dim=1))

    return topk


def make_sharded_percount_fn(mesh, axis: str = "data"):
    """Returns percount(xs, alphas, hn, xq, aq, r, thresh) -> (D, m) int32.

    Each rank counts its own shard's survivors; one ``all_gather`` stacks
    the (shard, query) matrix in rank order, from which the host can derive
    the global CSR offsets and each shard's write base.  Like the count,
    it must not source scatter offsets: its filter is another program than
    the CSR passes.
    """
    group = mesh.get_group(axis)

    def percount(xs, alphas, hn, xq, aq, r, thresh):
        dh = _local_filter(xs, alphas, hn, xq, aq, r, thresh)
        local = (dh < _BIG).sum(dim=1, dtype=torch.int32)
        del dh
        return torch.stack(_gather(local, group))

    return percount


def query_radius_csr_sharded(
    index: _snn.SNNIndex,
    mesh,
    q: np.ndarray,
    radius,
    return_distance: bool = True,
    axis: str = "data",
    block: int = 512,
    query_tile: int = 128,
    native: bool = True,
    packed: bool = True,
    pack=None,
) -> _snn.CSRNeighbors:
    """Exact variable-length CSR results over the mesh's shard decomposition.

    ``radius`` is a scalar or a per-query (m,) vector in the native metric,
    as in `snn.query_radius_csr`.  Each shard's padded slice is one engine
    `Segment` (`mesh_segments`), so the engine's one count -> prefix sum ->
    compact orchestration places shard k's survivors of query i at
    ``indptr[i] + sum(counts[:k, i])``: the merged rows are bit-identical
    to the single-device `snn.query_radius_csr`.  Both passes share one
    predicate pipeline, which is load-bearing: counts from a differently
    computed float32 filter (`make_sharded_percount_fn`) could disagree by
    an ulp and corrupt the scatter layout, so they never source offsets.

    ``packed=True`` (default) stacks the shard segments into one
    `engine.SegmentPack` and runs each pass as one stacked launch; callers
    issuing repeated batches against a static index build the plan once
    with `mesh_pack` and pass it as ``pack`` (this one-shot entry otherwise
    rebuilds it per call, and a reused plan takes the fused path).
    ``packed=False`` runs the looped executor, two launches a live shard.
    The mesh fixes the decomposition either way; every segment lives on
    the index's device.
    """
    if packed:
        if pack is None:
            pack = mesh_pack(index, mesh, axis=axis, block=block)
        return _engine.query_csr_packed(index, pack, q, radius,
                                        return_distance,
                                        query_tile=query_tile, native=native)
    segments = mesh_segments(index, mesh, axis=axis, block=block)
    return _engine.query_csr(index, segments, q, radius, return_distance,
                             query_tile=query_tile, native=native)


def mesh_segments(index: _snn.SNNIndex, mesh, axis: str = "data",
                  block: int = 512) -> list:
    """One engine `Segment` per shard of ``axis``, on the index's device
    (the decomposition of `query_radius_csr_sharded` and of
    `graph.build_neighbor_graph_sharded`).

    Per-shard padded slices of the contiguously sharded sort order: row
    padding inside a shard is a no-op (rows per shard are a block
    multiple); `engine.make_segment` pads d to the 128-lane multiple.
    """
    nshards = _axis_size(mesh, axis)
    xs, al, hn, od, pj, per = _pad_for_shards(index, nshards, block)
    segments = []
    for k in range(nshards):
        rows = slice(k * per, (k + 1) * per)
        segments.append(_engine.make_segment(
            xs[rows], al[rows], hn[rows], od[rows], block=block,
            projs=None if pj is None else pj[:, rows]))
    return segments


def mesh_pack(index: _snn.SNNIndex, mesh, axis: str = "data",
              block: int = 512, epoch: int = 0):
    """The mesh's shard decomposition as one `engine.SegmentPack` plan.

    Shards are equal-size slices of the padded sort order, so the pack is
    exactly `mesh_segments` stacked.  Long-lived owners build it once per
    index epoch and pass it to `query_radius_csr_sharded` (or
    `engine.query_csr_packed`) for every batch.
    """
    return _engine.SegmentPack.build(
        mesh_segments(index, mesh, axis=axis, block=block), epoch=epoch)


def prepare_query_arrays(index: _snn.SNNIndex, q: np.ndarray, radius):
    """The float32 predicate inputs (xq, aq, r, thresh) of the collective
    functions, as tensors on the index's device (see
    `snn.prepare_query_predicates`, their one source)."""
    xq, aq, r, thresh, _ = _snn.prepare_query_predicates(index, q, radius)
    return tuple(torch.from_numpy(np.ascontiguousarray(a, np.float32))
                 .to(index.device) for a in (xq, aq, r, thresh))
