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
  ids < 0 as padding, summed in slot order in the table's dtype.  Bags of
  one take a 16-byte gather, in bag order or, over a table larger than the
  L2 with more ids than rows (`bag_order`), grouped by ranges of table rows
  a fraction of the L2 wide, by a histogram and a scatter kernel first;
  bags of many over rows narrower than 16 bytes stage their ids in shared
  memory (`bag_path`).

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
            i64 = ctypes.c_longlong
            lib.embedding_bag.argtypes = [ptr] * 4 + [i32] * 3 + [
                i64, i32, ptr]
            lib.embedding_bag.restype = i32
            lib.embedding_bag_path.argtypes = [i64, i32, i32, i32, ptr, i32]
            lib.embedding_bag_path.restype = i32
            lib.embedding_bag_list.argtypes = [ptr, i32, i64, i32, i32, ptr,
                                               ptr, ptr]
            lib.embedding_bag_list.restype = i32
            lib.embedding_bag_l2_bytes.argtypes = [i32, ptr]
            lib.embedding_bag_l2_bytes.restype = i32
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
# ranges of table rows the blocked order may have (csrc: kMaxRanges, the
# histogram's bins in shared memory)
MAX_BAG_RANGES = 1024
# a range's rows fill 1 / BAG_RANGE_L2_SHARE of the L2: of ranges of 1/2
# to 1/64 of the L2, an eighth came within 1% of the best for MIND's
# history gather (1.559 ms on the H100; 1.902 at a half, 1.543 at a
# sixteenth) and for Wide & Deep's deep lookup (0.896 ms; 0.892 at a
# quarter), list included (experiments/embedding_bag/run.py).  The L2 is
# two partitions, each probably keeping its own copy of what its SMs read,
# so a range has to fit well inside one
BAG_RANGE_L2_SHARE = 8
_l2: dict[int, int] = {}


def bag_order(n_bags: int, n_slots: int, n_rows: int, row_bytes: int,
              l2_bytes: int) -> str:
    """The order in which embedding_bag walks bags of one: ``"blocked"``,
    grouped by ranges of table rows a fraction of the L2 wide
    (`bag_ranges`), or ``"direct"``, in bag order.

    Blocked where it saves reads: bags of one over rows a multiple of 16
    bytes, a table whose bytes exceed the L2 and more ids than table rows,
    so that rows are hit again and again and a walk in bag order would read
    most hits from HBM again.  On the H100 the blocked walk, its list
    included, beat the bag order at 2 to 16 ids a row over tables of
    256-byte rows (256 MB) and of 128-byte rows (512 MB) alike
    (experiments/embedding_bag/run.py).  Every other shape walks in bag
    order.  A function of the shapes and the device's L2 alone, so a CPU
    test can pin it.
    """
    blocked = (n_slots == 1 and row_bytes % 16 == 0
               and n_bags > n_rows and n_rows * row_bytes > l2_bytes)
    return "blocked" if blocked else "direct"


def bag_ranges(n_rows: int, row_bytes: int, l2_bytes: int) -> tuple[int,
                                                                    int]:
    """(rows a range, ranges) of the blocked order: ranges of consecutive
    table rows whose bytes fill 1 / `BAG_RANGE_L2_SHARE` of the L2, and no
    more than `MAX_BAG_RANGES` of them (wider ranges where the table would
    need more).  Range r holds rows [r * rows, (r + 1) * rows); a bag reads
    the range of ``ref.bag_range_keys``."""
    rows = max(1, l2_bytes // BAG_RANGE_L2_SHARE // row_bytes,
               -(-n_rows // MAX_BAG_RANGES))
    return rows, -(-n_rows // rows)


def l2_bytes(device) -> int:
    """The L2 size of a CUDA device in bytes (cudaDevAttrL2CacheSize)."""
    dev = torch.device(device).index
    dev = torch.cuda.current_device() if dev is None else dev
    if dev not in _l2:
        out = ctypes.c_longlong()
        rc = _library().embedding_bag_l2_bytes(dev, ctypes.byref(out))
        if rc != 0:
            raise RuntimeError(f"cudaDeviceGetAttribute failed: CUDA error "
                               f"{rc}")
        _l2[dev] = int(out.value)
    return _l2[dev]


def _blocked_ranges(B: int, F: int, V: int, row: int, table) -> tuple[int,
                                                                    int]:
    """(rows a range, ranges) of the blocked order, (0, 0) for bag order:
    `bag_order` on the table's device, with the cheap test first, since a
    serve batch pays for this on every call."""
    if not (F == 1 and B > V and row % 16 == 0
            and table.data_ptr() % 16 == 0):
        return 0, 0
    l2 = l2_bytes(table.device)
    if bag_order(B, F, V, row, l2) != "blocked":
        return 0, 0
    return bag_ranges(V, row, l2)


# csrc/embedding_bag.cu::embedding_bag_path
_BAG_PATHS = ("per element", "per chunk", "bag of one", "staged")


def bag_path(ids, table) -> dict:
    """How embedding_bag computes (B, F) ids over a (V, D) CUDA table:
    {"path", "order", "rows_per_range", "n_ranges"}.  Paths, as the kernel
    chooses them (``embedding_bag_path`` in the C interface): "bag of one",
    the 16-byte gather of bags of one, in the order of `bag_order`
    ("direct" or "blocked", with the ranges of `bag_ranges`), where the
    bags are listed or at least 256 for each SM; "staged",
    bags of many over rows narrower than 16 bytes, a warp of bags a block
    with their ids in shared memory; "per chunk" and "per element", one
    thread a 16-byte or a one-element column chunk of a bag."""
    (B, F), (V, D) = ids.shape, table.shape
    rows, n_ranges = _blocked_ranges(B, F, V, D * table.element_size(),
                                     table)
    code = _library().embedding_bag_path(B, F, D, _BAG_DTYPES[table.dtype],
                                         _ptr(table), int(rows > 0))
    return {"path": _BAG_PATHS[code], "order": "blocked" if rows else
            "direct", "rows_per_range": rows, "n_ranges": n_ranges}


def bag_range_list(ids, n_rows: int, rows_per_range: int, n_ranges: int):
    """The blocked order's list of (B, 1) int32 ``ids`` over ``n_rows``
    table rows: (pairs (B, 2) int32 of (bag, id), grouped by range in
    range order (no set order inside a range), counts (n_ranges,) int32 of
    bags by range), from the histogram and scatter kernels."""
    B = ids.shape[0]
    if not 1 <= n_ranges <= MAX_BAG_RANGES or rows_per_range < 1:
        raise ValueError(f"{n_ranges} ranges of {rows_per_range} rows: "
                         f"1 to {MAX_BAG_RANGES} ranges of 1 row or more")
    scratch = torch.empty(2 * n_ranges, dtype=torch.int32, device=ids.device)
    pairs = torch.empty((B, 2), dtype=torch.int32, device=ids.device)
    rc = _library().embedding_bag_list(
        _ptr(ids), B, int(n_rows), int(rows_per_range), int(n_ranges),
        _ptr(scratch), _ptr(pairs), _stream(ids.device))
    if rc != 0:
        raise RuntimeError(f"embedding_bag list failed: CUDA error {rc}")
    return pairs, scratch[:n_ranges]


def embedding_bag(ids, table):
    """``out[b] = sum_f w_f * table[max(ids[b, f], 0)]``, ``w_f = ids >= 0``,
    as one op call (`bag_path` says which kernels it runs).

    ``ids`` (B, F) int32 and ``table`` (V, D) float32 or bfloat16, both
    contiguous on one CUDA device; returns (B, D) in the table's dtype,
    summed in slot order from +0.0 with a rounding to that dtype after each
    add (the TPU kernel's arithmetic, bit-identical to
    `ref.embedding_bag_ref`).  An id at or above V reads row V - 1, as in
    the plain version and in the Pallas kernel run off the TPU.  The
    blocked order of bags of one (`bag_order`) runs three kernels (the
    range histogram, the scatter into range order, the gather over that
    list) and takes 8 bytes a bag of scratch from the caching allocator.
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
    if max(B, F, D) >= 2 ** 31 or B * D >= 2 ** 39:
        raise ValueError(f"bags ({B}, {F}) x {D} exceed the kernel's grid")
    rows, n_ranges = _blocked_ranges(B, F, V, D * table.element_size(),
                                     table)
    pairs = bag_range_list(ids, V, rows, n_ranges)[0] if rows else None
    rc = _library().embedding_bag(
        _ptr(ids), _ptr(pairs), _ptr(table), _ptr(out), B, F, D, V,
        _BAG_DTYPES[table.dtype], _stream(dev))
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
