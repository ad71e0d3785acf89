"""Kernel dispatch: the tensors' device picks the implementation.

The JAX package chooses one backend lane per process.  Here the choice is
made per call and has one rule: CUDA tensors go to the hand-written kernels
(`kernels.snn_query`), CPU tensors to their plain versions (`kernels.ref`).
No environment variable, lane name or fallback sends a CUDA tensor to a
plain version; a tensor on any other device raises.

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
    """True for CUDA tensors (the kernels), False for CPU tensors (the plain
    versions); any other device raises."""
    if xs.device.type not in ("cuda", "cpu"):
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
