"""The port's hand-written CUDA kernels, and their wrappers.

Five entry points of the query hot loop on the shared predicate of
``csrc/snn_predicate.cuh``:

* `snn_count_stacked` (``csrc/snn_query.cu``) replaces the Pallas TPU kernel
  ``repro.kernels.snn_query.snn_count_stacked``: per-(segment, query)
  survivor counts over a (S, n_pad, d_pad) stack of segments, with the
  optional bf16 count pass (``mixed=True``) under the margin certificate.
  One block a (128-query x 128-row) tile, or a 32-query tile when the grid
  would otherwise have fewer blocks than the card has SMs.
* `snn_compact_stacked` (``csrc/snn_query.cu``) replaces ``repro.kernels.
  snn_query.snn_compact_stacked``: one block a (query tile, bn-row block)
  cell; it runs the predicate again only for the queries whose count-pass
  partials say they have a survivor there, and writes every survivor as
  (pack-flat id ``s * n_pad + row``, dhalf) into its flat CSR slot.
* `snn_count` and `snn_compact` (``csrc/snn_query.cu``) replace the
  single-segment ``snn_query.snn_count`` / ``snn_compact``: the two stacked
  kernels launched on a stack of one.  Every launch shape computes a pair's
  dot product as the same fmaf chain, so the looped and the packed executor
  agree bit for bit.
* `snn_filter` (``csrc/snn_filter.cu``) replaces ``snn_query.snn_filter``:
  the dense (m_pad, n_pad) masked half distances, +BIG where a pair is
  pruned: the count's tile product over 128-query x 128-row tiles, the
  queries tiled in alpha order, so its finite entries are the compact's
  dhalf bit for bit.

And the recsys models' table lookup:

* `embedding_bag` (``csrc/embedding_bag.cu``) replaces ``repro.kernels.
  embedding_bag.embedding_bag``: ``out[b] = sum_f table[ids[b, f]]`` with
  ids < 0 as padding, summed in slot order in the table's dtype.

The sources are compiled with ``nvcc`` for ``sm_90a`` at first use, one
``nvcc`` per source, all started together, then linked into one shared
library in ``_build/`` beside this file (a directory the repository
ignores), and bound with ctypes through a plain C interface.  Each wrapper
checks its operands, allocates its outputs with torch, launches on the
current stream, raises if the launch fails, and counts its launches in its
``launches`` attribute.  The wrappers take CUDA tensors only;
`kernels.registry` sends CPU tensors to the plain versions in `kernels.ref`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import torch

from .ref import BIG

SOURCE_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("snn_query.cu", "snn_filter.cu", "embedding_bag.cu")
HEADERS = ("snn_launch.cuh", "snn_predicate.cuh")
# no fast math: the sentinels need IEEE inf/NaN, and --fmad=false leaves the
# explicit fmaf of the dot products as the only contracted multiply-adds
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-Xptxas", "-v", "-Xcompiler", "-fPIC")

ROW_TILE = 128    # rows per tile (csrc: kRows); bn must be a multiple

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_build_log = ""


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: nvcc is needed to build "
                           "the kernels")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def build() -> Path:
    """Compile the kernels if this exact source has not been built yet, and
    return the shared library's path.  The file name carries a hash of the
    sources and flags, so an edited source is rebuilt.  Each source compiles
    in its own ``nvcc`` process, all at once; one more links them."""
    global _build_log
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update((SOURCE_DIR / name).read_bytes())
    lib = BUILD_DIR / f"snn_query-{h.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{h.hexdigest()[:16]}.{os.getpid()}"
    objs = [BUILD_DIR / f"{Path(src).stem}-{tag}.o" for src in SOURCES]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                               str(SOURCE_DIR / src)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(SOURCES, objs)]
    logs = [f"{src}:\n{p.communicate()[0]}" for src, p in zip(SOURCES, procs)]
    _build_log = "".join(logs)
    try:
        if any(p.returncode for p in procs):
            raise RuntimeError(f"nvcc failed:\n{_build_log}")
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        proc = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                               *(str(o) for o in objs)],
                              capture_output=True, text=True)
        _build_log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{_build_log}")
        os.replace(tmp, lib)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    return lib


def build_log() -> str:
    """What nvcc printed (registers, shared memory, spills) for the last
    build this process ran; empty when the library was already built."""
    return _build_log


def _library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            operands = [ptr] * 9 + [i32] * 6
            lib.snn_count_stacked.argtypes = operands + [i32, ptr, ptr, ptr]
            lib.snn_count_stacked.restype = i32
            lib.snn_compact_stacked.argtypes = operands + [ptr, ptr, ptr, i32,
                                                           ptr, ptr, ptr]
            lib.snn_compact_stacked.restype = i32
            single = [ptr] * 9 + [i32] * 5
            lib.snn_count.argtypes = single + [i32, ptr, ptr, ptr]
            lib.snn_count.restype = i32
            lib.snn_compact.argtypes = single + [ptr, ptr, i32, ptr, ptr, ptr]
            lib.snn_compact.restype = i32
            lib.snn_launch_geometry.argtypes = [i32] * 6 + [ptr]
            lib.snn_launch_geometry.restype = i32
            lib.snn_filter.argtypes = single + [ptr, ptr, ptr]
            lib.snn_filter.restype = i32
            lib.embedding_bag.argtypes = [ptr, ptr, ptr, i32, i32, i32,
                                          ctypes.c_longlong, i32, i32, ptr]
            lib.embedding_bag.restype = i32
            _lib = lib
    return _lib


def _check_operands(q, aq, r, thresh, xs, alphas, half_norms, pq, px, bn,
                    stacked=True):
    """Validate the kernels' operands, a (S, n_pad, d_pad) stack or, with
    ``stacked=False``, one (n_pad, d_pad) segment (alphas/half_norms
    without the S axis, px (ke, n_pad)); returns (S, m_pad, n_pad, d_pad,
    ke), S = 1 for a segment."""
    if not (isinstance(xs, torch.Tensor) and xs.is_cuda):
        raise ValueError("the CUDA kernels take CUDA tensors; "
                         f"got {getattr(xs, 'device', type(xs))}")
    if (pq is None) != (px is None):
        raise ValueError("pq and px are given together or not at all")
    named = dict(q=q, aq=aq, r=r, thresh=thresh, xs=xs, alphas=alphas,
                 half_norms=half_norms)
    if pq is not None:
        named.update(pq=pq, px=px)
    dev = xs.get_device()
    for name, t in named.items():
        if t.get_device() != dev:
            raise ValueError(f"{name} is on {t.device}, xs on {xs.device}")
        if t.dtype is not torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if xs.dim() != 2 + stacked:
        raise ValueError(f"xs must be {'(S, ' if stacked else '('}n_pad, "
                         f"d_pad), got {tuple(xs.shape)}")
    S = xs.shape[0] if stacked else 1
    n_pad, d_pad = xs.shape[-2:]
    seg = (S,) if stacked else ()
    m_pad = q.shape[0]
    ke = 0 if pq is None else pq.shape[0]
    want = dict(q=(m_pad, d_pad), aq=(m_pad,), r=(m_pad,), thresh=(m_pad,),
                alphas=seg + (n_pad,), half_norms=seg + (n_pad,))
    if pq is not None:
        want.update(pq=(ke, m_pad), px=seg + (ke, n_pad))
    for name, shape in want.items():
        if named[name].shape != shape:
            raise ValueError(f"{name} has shape {tuple(named[name].shape)}, "
                             f"expected {shape}")
    if bn <= 0 or bn % ROW_TILE or n_pad % bn:
        raise ValueError(f"bn={bn} must be a positive multiple of {ROW_TILE} "
                         f"that divides n_pad={n_pad}")
    if d_pad % 32:
        raise ValueError(f"d_pad={d_pad} must be a multiple of 32")
    if q.data_ptr() % 16 or xs.data_ptr() % 16:
        raise ValueError("q and xs must start on a 16-byte boundary (the "
                         "kernels load them in 16-byte chunks)")
    if S * n_pad >= 2 ** 31:
        raise ValueError(f"stack (S={S}, n_pad={n_pad}) exceeds the kernels' "
                         "int32 pack-flat ids")
    return S, m_pad, n_pad, d_pad, ke


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def write_bases(offsets, partials):
    """The compact's write base of every (segment, query, row block): the
    flat slot of its first survivor, ``offsets`` (the row block 0 base, (S,
    m_pad) or (m_pad,)) plus the exclusive prefix of ``partials`` (the count
    pass's per-row-block counts, one more trailing axis) over row blocks.
    With one row block that is ``offsets`` itself: a scan along a trailing
    axis of length 1 over millions of rows is slow on the card."""
    if partials.shape[-1] == 1:
        return offsets[..., None].contiguous()
    return offsets[..., None] + (torch.cumsum(partials, -1, dtype=torch.int32)
                                 - partials)


def launch_geometry(kernel: str, S: int, m_pad: int, n_pad: int, bn: int,
                    ke: int = 0) -> dict:
    """The launch ``kernel`` ("count" or "compact", stacked or single) makes
    for a (S, n_pad) stack and m_pad queries on the current device:
    {"query_tile", "threads", "blocks", "smem_bytes"} (dynamic shared
    memory).  The query tile shrinks when the full one would leave SMs
    without a block."""
    out = (ctypes.c_longlong * 4)()
    _library().snn_launch_geometry(("count", "compact").index(kernel), S,
                                   m_pad, n_pad, bn, ke, ctypes.addressof(out))
    return dict(zip(("query_tile", "threads", "blocks", "smem_bytes"), out))


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def snn_count_stacked(q, aq, r, thresh, xs, alphas, half_norms,
                      pq=None, px=None, *, bn: int = 512,
                      mixed: bool = False, with_partials: bool = False):
    """Per-(segment, query) survivor counts (S, m_pad) int32 in one launch.

    ``xs`` (S, n_pad, d_pad) and ``alphas``/``half_norms`` (S, n_pad) are a
    `core.engine.SegmentPack`'s stacked slabs; ``pq`` (ke, m_pad) / ``px``
    (S, ke, n_pad) the optional extra projections of the box prune.
    ``mixed=True`` counts with bf16 products under the margin certificate
    (the counts equal the float32 counts).  ``with_partials`` also returns
    the (S, m_pad, n_pad // bn) per-row-block counts `snn_compact_stacked`
    takes to place its writes.
    """
    S, m_pad, n_pad, d_pad, ke = _check_operands(
        q, aq, r, thresh, xs, alphas, half_norms, pq, px, bn)
    dev = xs.device
    counts = torch.zeros((S, m_pad), dtype=torch.int32, device=dev)
    partials = None
    if with_partials:
        partials = torch.zeros((S, m_pad, n_pad // bn), dtype=torch.int32,
                               device=dev)
    if S and m_pad and n_pad:
        lib = _library()
        rc = lib.snn_count_stacked(
            _ptr(q), _ptr(aq), _ptr(r), _ptr(thresh), _ptr(xs), _ptr(alphas),
            _ptr(half_norms), _ptr(pq), _ptr(px), S, m_pad, n_pad, d_pad, ke,
            bn, int(bool(mixed)), _ptr(counts), _ptr(partials), _stream(dev))
        if rc != 0:
            raise RuntimeError(f"snn_count_stacked launch failed: CUDA error "
                               f"{rc}")
        snn_count_stacked.launches += 1
    return (counts, partials) if with_partials else counts


snn_count_stacked.launches = 0


def snn_compact_stacked(q, aq, r, thresh, offsets, xs, alphas, half_norms,
                        pq=None, px=None, *, nnz: int, bn: int = 512,
                        partials=None):
    """Scatter the survivors of a segment stack into flat CSR, in one launch.

    ``offsets`` (S, m_pad) int32 is the flat slot of segment s's first
    survivor for query k (`ref.stacked_prefix`); ``nnz`` is the flat
    capacity including one trailing trash slot.  Returns (idx (nnz,) int32
    pack-flat ids, dhalf (nnz,) float32) with -1 / +BIG in unwritten slots
    and in the trash slot; within each CSR row the survivors ascend in
    (segment, row) order.  When ``total + 1 > nnz`` nothing is written, and
    the kernel reads ``total`` on the device, so no host sync is needed
    between the passes.  ``partials`` is the count pass's per-row-block
    output, which gives every row block its write base (`write_bases`) and
    names the queries that have a survivor in it; without it this wrapper
    launches the count kernel to get it.
    """
    S, m_pad, n_pad, d_pad, ke = _check_operands(
        q, aq, r, thresh, xs, alphas, half_norms, pq, px, bn)
    dev = xs.device
    nb = n_pad // bn if bn else 0
    if offsets.device != dev or offsets.dtype != torch.int32 \
            or tuple(offsets.shape) != (S, m_pad):
        raise ValueError(f"offsets must be int32 ({S}, {m_pad}) on {dev}")
    if int(nnz) < 1:
        raise ValueError(f"nnz={nnz} must leave room for the trash slot")
    idx = torch.full((nnz,), -1, dtype=torch.int32, device=dev)
    dh = torch.full((nnz,), BIG, dtype=torch.float32, device=dev)
    if not (S and m_pad and n_pad):
        return idx, dh
    if partials is None:
        _, partials = snn_count_stacked(q, aq, r, thresh, xs, alphas,
                                        half_norms, pq, px, bn=bn,
                                        with_partials=True)
    if partials.device != dev or partials.dtype != torch.int32 \
            or tuple(partials.shape) != (S, m_pad, nb):
        raise ValueError(f"partials must be int32 ({S}, {m_pad}, {nb}) "
                         f"on {dev}")
    bases = write_bases(offsets, partials)
    total = partials.sum(dtype=torch.int32)
    lib = _library()
    rc = lib.snn_compact_stacked(
        _ptr(q), _ptr(aq), _ptr(r), _ptr(thresh), _ptr(xs), _ptr(alphas),
        _ptr(half_norms), _ptr(pq), _ptr(px), S, m_pad, n_pad, d_pad, ke, bn,
        _ptr(bases), _ptr(partials), _ptr(total), int(nnz), _ptr(idx),
        _ptr(dh), _stream(dev))
    if rc != 0:
        raise RuntimeError(f"snn_compact_stacked launch failed: CUDA error "
                           f"{rc}")
    snn_compact_stacked.launches += 1
    return idx, dh


snn_compact_stacked.launches = 0


def snn_count(q, aq, r, thresh, xs, alphas, half_norms, pq=None, px=None, *,
              bn: int = 512, mixed: bool = False,
              with_partials: bool = False):
    """Per-query survivor counts (m_pad,) int32 over one segment.

    ``xs`` (n_pad, d_pad), ``alphas``/``half_norms`` (n_pad,), ``px``
    (ke, n_pad): the count kernel of `snn_count_stacked` at S = 1, the same
    compiled predicate.  ``with_partials`` also returns the (m_pad,
    n_pad // bn) per-row-block counts `snn_compact` takes.
    """
    _, m_pad, n_pad, d_pad, ke = _check_operands(
        q, aq, r, thresh, xs, alphas, half_norms, pq, px, bn, stacked=False)
    dev = xs.device
    counts = torch.zeros((m_pad,), dtype=torch.int32, device=dev)
    partials = None
    if with_partials:
        partials = torch.zeros((m_pad, n_pad // bn), dtype=torch.int32,
                               device=dev)
    if m_pad and n_pad:
        rc = _library().snn_count(
            _ptr(q), _ptr(aq), _ptr(r), _ptr(thresh), _ptr(xs), _ptr(alphas),
            _ptr(half_norms), _ptr(pq), _ptr(px), m_pad, n_pad, d_pad, ke, bn,
            int(bool(mixed)), _ptr(counts), _ptr(partials), _stream(dev))
        if rc != 0:
            raise RuntimeError(f"snn_count launch failed: CUDA error {rc}")
        snn_count.launches += 1
    return (counts, partials) if with_partials else counts


snn_count.launches = 0


def snn_compact(q, aq, r, thresh, offsets, xs, alphas, half_norms, pq=None,
                px=None, *, nnz: int, bn: int = 512, partials=None):
    """Scatter one segment's survivors into flat CSR, in one launch.

    ``offsets`` (m_pad,) int32 is the flat slot of query k's first survivor;
    ``nnz`` the flat capacity including one trailing trash slot.  Returns
    (idx (nnz,) int32 local sorted rows, dhalf (nnz,) float32), ascending in
    row order within each query, with -1 / +BIG in unwritten slots and in
    the trash slot; a slot outside ``[0, nnz - 1)`` is not written.
    ``partials`` is `snn_count`'s per-row-block output, which gives every
    row block its own write base (the blocks run in parallel) and names the
    queries that have a survivor in it; without it this wrapper launches
    `snn_count` to get it.
    """
    _, m_pad, n_pad, d_pad, ke = _check_operands(
        q, aq, r, thresh, xs, alphas, half_norms, pq, px, bn, stacked=False)
    dev = xs.device
    nb = n_pad // bn
    if offsets.device != dev or offsets.dtype != torch.int32 \
            or tuple(offsets.shape) != (m_pad,):
        raise ValueError(f"offsets must be int32 ({m_pad},) on {dev}")
    if int(nnz) < 1:
        raise ValueError(f"nnz={nnz} must leave room for the trash slot")
    idx = torch.full((nnz,), -1, dtype=torch.int32, device=dev)
    dh = torch.full((nnz,), BIG, dtype=torch.float32, device=dev)
    if not (m_pad and n_pad):
        return idx, dh
    if partials is None:
        _, partials = snn_count(q, aq, r, thresh, xs, alphas, half_norms, pq,
                                px, bn=bn, with_partials=True)
    if partials.device != dev or partials.dtype != torch.int32 \
            or tuple(partials.shape) != (m_pad, nb):
        raise ValueError(f"partials must be int32 ({m_pad}, {nb}) on {dev}")
    bases = write_bases(offsets, partials)
    rc = _library().snn_compact(
        _ptr(q), _ptr(aq), _ptr(r), _ptr(thresh), _ptr(xs), _ptr(alphas),
        _ptr(half_norms), _ptr(pq), _ptr(px), m_pad, n_pad, d_pad, ke, bn,
        _ptr(bases), _ptr(partials), int(nnz), _ptr(idx), _ptr(dh),
        _stream(dev))
    if rc != 0:
        raise RuntimeError(f"snn_compact launch failed: CUDA error {rc}")
    snn_compact.launches += 1
    return idx, dh


snn_compact.launches = 0


def snn_filter(q, aq, r, thresh, xs, alphas, half_norms, pq=None, px=None, *,
               bn: int = 512):
    """Masked half distances (m_pad, n_pad) float32 over one segment.

    ``hn - q.x`` where the window, radius and box tests keep the pair, +BIG
    elsewhere.  The kernel tiles the queries 128 at a time in alpha order
    (``torch.argsort(aq, stable=True)``, one small sort on the card) against
    128-row tiles, and writes +BIG without a product over a tile that no
    window of its queries meets.  ``bn`` must be a positive multiple of 128
    that divides n_pad (`_check_operands`), so no 128-row tile straddles two
    row blocks, nor two segments of `registry.snn_filter_stacked`.
    """
    _, m_pad, n_pad, d_pad, ke = _check_operands(
        q, aq, r, thresh, xs, alphas, half_norms, pq, px, bn, stacked=False)
    dev = xs.device
    if not (m_pad and n_pad):
        return torch.full((m_pad, n_pad), BIG, dtype=torch.float32,
                          device=dev)
    order = torch.argsort(aq, stable=True)
    out = torch.empty((m_pad, n_pad), dtype=torch.float32, device=dev)
    rc = _library().snn_filter(
        _ptr(q), _ptr(aq), _ptr(r), _ptr(thresh), _ptr(xs), _ptr(alphas),
        _ptr(half_norms), _ptr(pq), _ptr(px), m_pad, n_pad, d_pad, ke, bn,
        _ptr(order), _ptr(out), _stream(dev))
    if rc != 0:
        raise RuntimeError(f"snn_filter launch failed: CUDA error {rc}")
    snn_filter.launches += 1
    return out


snn_filter.launches = 0

_BAG_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def embedding_bag(ids, table):
    """``out[b] = sum_f w_f * table[max(ids[b, f], 0)]``, ``w_f = ids >= 0``,
    in one launch.

    ``ids`` (B, F) int32 and ``table`` (V, D) float32 or bfloat16, both
    contiguous on one CUDA device; returns (B, D) in the table's dtype,
    summed in slot order with a rounding to that dtype after each add (the
    TPU kernel's arithmetic, bit-identical to `ref.embedding_bag_ref`).
    An id at or above V reads row V - 1, as in the plain version and in
    the Pallas kernel run off the TPU.
    """
    if not (isinstance(table, torch.Tensor) and table.is_cuda):
        raise ValueError("the CUDA kernels take CUDA tensors; "
                         f"got {getattr(table, 'device', type(table))}")
    if ids.device != table.device:
        raise ValueError(f"ids are on {ids.device}, table on {table.device}")
    if ids.dtype != torch.int32:
        raise TypeError(f"ids must be int32, got {ids.dtype}")
    if table.dtype not in _BAG_DTYPES:
        raise TypeError(f"table must be float32 or bfloat16, got "
                        f"{table.dtype}")
    if ids.dim() != 2 or table.dim() != 2:
        raise ValueError(f"ids must be (B, F) and table (V, D); got "
                         f"{tuple(ids.shape)} and {tuple(table.shape)}")
    if not (ids.is_contiguous() and table.is_contiguous()):
        raise ValueError("ids and table must be contiguous")
    (B, F), (V, D) = ids.shape, table.shape
    if V == 0 and F:
        raise ValueError("an empty table has no rows to look up")
    dev = table.device
    out = torch.empty((B, D), dtype=table.dtype, device=dev)
    if not (B and D):
        return out
    vec16 = ((D * table.element_size()) % 16 == 0
             and table.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    threads = B * (D * table.element_size() // 16 if vec16 else D)
    if max(B, F, D) >= 2 ** 31 or threads >= 2 ** 31 * 256:
        raise ValueError(f"bags ({B}, {F}) x {D} exceed the kernel's grid")
    rc = _library().embedding_bag(
        _ptr(ids), _ptr(table), _ptr(out), B, F, D, V,
        _BAG_DTYPES[table.dtype], int(vec16), _stream(dev))
    if rc != 0:
        raise RuntimeError(f"embedding_bag launch failed: CUDA error {rc}")
    embedding_bag.launches += 1
    return out


embedding_bag.launches = 0

KERNELS = (snn_count_stacked, snn_compact_stacked, snn_count, snn_compact,
           snn_filter, embedding_bag)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0
