"""Kernel dispatch: the tensors' device picks the implementation.

The JAX package chooses one backend lane per process.  Here the choice is
made per call and has one rule: CUDA tensors go to the hand-written kernels
(`kernels.snn_query`), CPU tensors to their plain versions (`kernels.ref`).
No environment variable, lane name or fallback sends a CUDA tensor to a
plain version; a tensor on any other device raises.

The entry points, each with the launch it makes on the card:

* `snn_count_stacked` / `snn_compact_stacked`: the packed executor's two
  passes, one launch each over a (S, n_pad, d_pad) segment stack; the count
  a one-dimensional grid of m_pad / 128 x n_pad / 128 x S blocks of 256
  threads, the compact m_pad / 128 x n_pad / bn x S blocks of 256 threads
  (`kernels.snn_query.launch_geometry`);
* `snn_count` / `snn_compact`: the looped executor's two passes over one
  (n_pad, d_pad) segment, the same kernels on a stack of one.  Where the
  full query tile would leave SMs without a block, as at a graph chunk's
  own 512-row segment, the count takes 32-query tiles (blocks of 64
  threads) and the compact 32- or 8-query tiles;
* `snn_filter`: the dense (m_pad, n_pad) masked half distances, a
  one-dimensional grid of m_pad / 128 x n_pad / 128 blocks of 256 threads,
  the queries tiled in alpha order (a stable argsort on the card first);
  `snn_filter_stacked` flattens a stack into it;
* `embedding_bag`: the recsys table lookup, (B, F) ids over a (V, D) table:
  bags of one a block for every 256 bags (with fewer than 256 an SM, one
  thread a 16-byte chunk), in bag order or, over a table larger than the
  L2 with more ids than rows, after a range histogram and a scatter
  (three launches and a memset in one call); the wide bag's
  narrow rows a block of one warp of bags with its ids staged in shared
  memory; other shapes one thread a 16-byte (or one-element) column chunk
  of a bag (`kernels.snn_query.bag_path`).

Three more entry points have no kernel, because the reference runs them
as XLA on every lane: `snn_filter_tiles`, `snn_count_tiles` and
`snn_csr_compacted_stacked`, the candidate-compacted evaluation of the
engine's host lane (a batched product over gathered candidate rows).  They
are torch operations on whatever device their tensors are on.

Meta and fake tensors (``FakeTensorMode``, as `launch.dryrun` traces a
step) go to the plain versions, which then only compute shapes: a trace
counts the work without doing it.  A fake tensor reports the device it
stands for, so the dry-run makes its fake tensors on the CPU.  CUDA
tensors still go only to the kernels.

Every call also records a (op, shapes, static arguments) launch signature;
the first sighting of a signature bumps ``engine.DISPATCH_STATS.
jit_compiles``, the measure of how many distinct launch shapes a stream of
batches produces (the query-bucket ladder keeps it O(log m)).
"""
from __future__ import annotations

import threading

import torch

from . import ref as _ref
from . import snn_query as _kernels

_sig_lock = threading.Lock()
_signatures: dict[str, set] = {}


def note_launch_signature(op: str, key: tuple) -> None:
    """Record one (op, signature) pair; a first sighting counts in the
    calling thread's ``DISPATCH_STATS.jit_compiles``."""
    with _sig_lock:
        seen = _signatures.setdefault(op, set())
        if key in seen:
            return
        seen.add(key)
    from ..core import engine as _engine  # deferred: engine imports kernels

    _engine.DISPATCH_STATS.jit_compiles += 1


def compile_counts() -> dict[str, int]:
    """Distinct launch signatures seen per op since the last reset."""
    with _sig_lock:
        return {op: len(s) for op, s in _signatures.items()}


def reset_compile_counts() -> None:
    with _sig_lock:
        _signatures.clear()


def _sig(*tensors, **statics) -> tuple:
    parts = tuple(None if t is None else (tuple(t.shape), str(t.dtype))
                  for t in tensors)
    return parts + tuple(sorted(statics.items()))


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means the card.

    Raises when the card is asked for (explicitly or by default) and none is
    present: nothing runs on the CPU unless the caller passed ``"cpu"``.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _on_card(xs) -> bool:
    """True for CUDA tensors (the kernels), False for CPU and meta tensors
    (the plain versions); any other device raises."""
    if xs.device.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"no kernel for tensors on {xs.device}")
    return xs.device.type == "cuda"


def snn_count_stacked(q, aq, r, thresh, xs, alphas, half_norms,
                      pq=None, px=None, *, bn: int = 512,
                      mixed: bool = False, with_partials: bool = False):
    """Stacked pass 1: per-(segment, query) counts (S, m_pad) int32 (and the
    per-row-block partials with ``with_partials``)."""
    note_launch_signature("snn_count_stacked",
                          _sig(q, xs, pq, bn=bn, mixed=mixed))
    fn = (_kernels.snn_count_stacked if _on_card(xs)
          else _ref.snn_count_stacked_ref)
    return fn(q, aq, r, thresh, xs, alphas, half_norms, pq, px, bn=bn,
              mixed=mixed, with_partials=with_partials)


def snn_compact_stacked(q, aq, r, thresh, offsets, xs, alphas, half_norms,
                        pq=None, px=None, *, nnz: int, bn: int = 512,
                        partials=None):
    """Stacked pass 2: (idx (nnz,) int32 pack-flat ids, dhalf (nnz,) f32)."""
    note_launch_signature("snn_compact_stacked",
                          _sig(q, xs, pq, bn=bn, nnz=int(nnz)))
    if _on_card(xs):
        return _kernels.snn_compact_stacked(
            q, aq, r, thresh, offsets, xs, alphas, half_norms, pq, px,
            nnz=nnz, bn=bn, partials=partials)
    return _ref.snn_compact_stacked_ref(q, aq, r, thresh, offsets, xs, alphas,
                                        half_norms, pq, px, nnz=nnz,
                                        partials=partials)


def snn_filter(q, aq, r, thresh, xs, alphas, half_norms, pq=None, px=None,
               *, bn: int = 512):
    """Dense masked half distances (m_pad, n_pad) f32 over one segment."""
    note_launch_signature("snn_filter", _sig(q, xs, pq, bn=bn))
    if _on_card(xs):
        return _kernels.snn_filter(q, aq, r, thresh, xs, alphas, half_norms,
                                   pq, px, bn=bn)
    return _ref.snn_filter_ref(q, aq, r, thresh, xs, alphas, half_norms, pq,
                               px)


def snn_count(q, aq, r, thresh, xs, alphas, half_norms, pq=None, px=None, *,
              bn: int = 512, mixed: bool = False,
              with_partials: bool = False):
    """Looped pass 1: per-query counts (m_pad,) int32 over one segment (and
    the (m_pad, n_pad // bn) per-row-block partials with
    ``with_partials``)."""
    note_launch_signature("snn_count", _sig(q, xs, pq, bn=bn, mixed=mixed))
    fn = _kernels.snn_count if _on_card(xs) else _ref.snn_count_ref
    return fn(q, aq, r, thresh, xs, alphas, half_norms, pq, px, bn=bn,
              mixed=mixed, with_partials=with_partials)


def snn_compact(q, aq, r, thresh, offsets, xs, alphas, half_norms, pq=None,
                px=None, *, nnz: int, bn: int = 512, partials=None):
    """Looped pass 2: (idx (nnz,) int32 local rows, dhalf (nnz,) f32)."""
    note_launch_signature("snn_compact", _sig(q, xs, pq, bn=bn,
                                              nnz=int(nnz)))
    if _on_card(xs):
        return _kernels.snn_compact(q, aq, r, thresh, offsets, xs, alphas,
                                    half_norms, pq, px, nnz=nnz, bn=bn,
                                    partials=partials)
    return _ref.snn_compact_ref(q, aq, r, thresh, offsets, xs, alphas,
                                half_norms, pq, px, nnz=nnz,
                                partials=partials)


def snn_filter_stacked(q, aq, r, thresh, xs, alphas, half_norms, pq=None,
                       px=None, *, bn: int = 512):
    """(m_pad, S * n_pad) masked half distances over a (S, n_pad, d_pad)
    stack, columns pack-flat (``s * n_pad + row``).

    The stack flattens into one database and goes through `snn_filter`:
    every segment is padded to a multiple of ``bn``, itself a multiple of
    the kernel's 128-row tile, so no tile straddles two segments and the
    per-tile window skip is as sharp as per segment.
    """
    S, n_pad, d = xs.shape
    px2 = None
    if px is not None:
        px2 = px.permute(1, 0, 2).reshape(px.shape[1], S * n_pad)
    return snn_filter(q, aq, r, thresh, xs.reshape(S * n_pad, d),
                      alphas.reshape(-1), half_norms.reshape(-1), pq,
                      None if px2 is None else px2.contiguous(), bn=bn)


def snn_filter_tiles(qt, aqt, rt, tht, xt, alt, hnt, pqt=None, pxt=None):
    """(T, p, C) masked half distances of ``qt`` (T, p, d) query tiles
    against ``xt`` (T, C, d) gathered candidate rows, on their device."""
    note_launch_signature("snn_filter_tiles", _sig(qt, xt, pqt))
    return _ref.snn_filter_tiles_ref(qt, aqt, rt, tht, xt, alt, hnt, pqt,
                                     pxt)


def snn_count_tiles(qt, aqt, rt, tht, xt, alt, hnt, pqt=None, pxt=None, *,
                    mixed: bool = False):
    """(T, p) int32 survivor counts over gathered candidate tiles."""
    note_launch_signature("snn_count_tiles", _sig(qt, xt, pqt, mixed=mixed))
    return _ref.snn_count_tiles_ref(qt, aqt, rt, tht, xt, alt, hnt, pqt, pxt,
                                    mixed=mixed)


def snn_csr_compacted_stacked(q, aq, r, thresh, xs, alphas, half_norms,
                              pq=None, px=None, *, ptile: int, ccap: int,
                              nnz_cap: int):
    """Candidate-compacted CSR over a segment stack, on its device with no
    host sync: (indptr, idx, dhalf, total, cand_max), speculative in
    ``ccap``/``nnz_cap`` (`ref.snn_csr_compacted_stacked_ref`)."""
    note_launch_signature("snn_csr_compacted_stacked",
                          _sig(q, xs, pq, ptile=ptile, ccap=ccap,
                               nnz_cap=nnz_cap))
    return _ref.snn_csr_compacted_stacked_ref(
        q, aq, r, thresh, xs, alphas, half_norms, pq, px, ptile=ptile,
        ccap=ccap, nnz_cap=nnz_cap)


def embedding_bag(ids, table):
    """(B, D) bag sums of a (V, D) table over (B, F) int32 ids, ids < 0
    padding: the CUDA kernel for a CUDA table, the plain version for a CPU
    one."""
    note_launch_signature("embedding_bag", _sig(ids, table))
    fn = _kernels.embedding_bag if _on_card(table) else _ref.embedding_bag_ref
    return fn(ids, table)
