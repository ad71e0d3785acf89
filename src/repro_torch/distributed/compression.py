"""Gradient compression for the data-parallel all-reduce: the counterpart
of ``repro.distributed.compression``.

* ``topk_compress`` — magnitude top-k sparsification with error feedback
  (the Deep Gradient Compression recipe): only a ``k_frac`` of each leaf is
  sent; the residual is fed into the next step.
* ``int8_quantize`` / ``int8_dequantize`` — per-leaf symmetric int8.
* ``compressed_psum`` — the all-reduce over a process group, plain or with
  a shared int8 scale and an exact int32 sum.

Trees are the port's (dicts, lists and tuples of tensors, `utils`).
"""
from __future__ import annotations

import torch

from ..utils import tree_map


def topk_compress(grads, residual, k_frac: float = 0.01):
    """(sent, new residual): ``sent`` has each leaf's dense shape with only
    the entries of ``g + r`` whose magnitude is at least the k-th largest
    (``k = max(int(size * k_frac), 1)``) kept, so ties at the threshold
    send more than k; the residual is what was not sent.  A ``residual``
    of None is zeros."""
    if residual is None:
        residual = tree_map(torch.zeros_like, grads)

    def one(g, r):
        acc = g + r
        flat = acc.reshape(-1)
        k = max(int(flat.numel() * k_frac), 1)
        thresh = torch.topk(flat.abs(), k, sorted=True).values[-1]
        sent = torch.where(acc.abs() >= thresh, acc, torch.zeros_like(acc))
        return sent, acc - sent

    return _split(tree_map(one, grads, residual))


def _split(pairs):
    """A tree whose leaves are (a, b) pairs as two trees."""
    if isinstance(pairs, dict):
        parts = {k: _split(v) for k, v in pairs.items()}
        return ({k: v[0] for k, v in parts.items()},
                {k: v[1] for k, v in parts.items()})
    if isinstance(pairs, list) or (isinstance(pairs, tuple)
                                   and not _is_pair(pairs)):
        parts = [_split(v) for v in pairs]
        return (type(pairs)(p[0] for p in parts),
                type(pairs)(p[1] for p in parts))
    return pairs


def _is_pair(x) -> bool:
    return isinstance(x, tuple) and len(x) == 2 and all(
        isinstance(t, torch.Tensor) for t in x)


def _scale(g: torch.Tensor) -> torch.Tensor:
    """``max(max |g|, 1e-12) / 127`` in float32."""
    return torch.clamp_min(g.abs().max().float(), 1e-12) / 127.0


def _quantize(g: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    """``clip(round(g / scale), -127, 127)``: ``torch.round`` rounds half
    to even, as ``jnp.round``."""
    return torch.clamp(torch.round(g / scale), -127, 127).to(dtype)


def int8_quantize(grads):
    """Per-leaf symmetric int8: (int8 tree, float32 scale tree)."""
    def one(g):
        s = _scale(g)
        return _quantize(g, s, torch.int8), s
    return _split(tree_map(one, grads))


def int8_dequantize(q, s):
    return tree_map(lambda qi, si: qi.to(torch.float32) * si, q, s)


def compressed_psum(grads, group=None, mode: str = "none"):
    """All-reduce every leaf of ``grads`` over ``group`` (default: the
    world), returning new tensors.  ``"none"``: a SUM all-reduce.
    ``"int8"``: the leaf's scale MAX-reduced into one shared scale, the
    leaf quantized with it, an exact int32 SUM of the quantized values,
    and the sum dequantized (float32)."""
    import torch.distributed as dist

    if mode == "none":
        def one(g):
            out = g.clone()
            dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
            return out
        return tree_map(one, grads)
    if mode == "int8":
        def one(g):
            scale = _scale(g).reshape(1)
            dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
            q = _quantize(g, scale[0], torch.int32)
            dist.all_reduce(q, op=dist.ReduceOp.SUM, group=group)
            return q.to(torch.float32) * scale[0]
        return tree_map(one, grads)
    raise ValueError(mode)
