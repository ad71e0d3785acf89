"""Optimizers of the port: the counterpart of ``repro.optim.optimizers``.

An optimizer is a pair (init, update) over a *tree* (nested dicts, lists
and tuples whose leaves are tensors), as in the JAX package:

    state = init(params)
    updates, state = update(grads, state, params)
    apply_updates(params, updates)        # in place

The arithmetic and its casts are the JAX package's, op for op, including
JAX's promotion rules, which PyTorch's differ from in two places that
matter here:

* a Python scalar is *weakly typed* in JAX: it takes the dtype of the
  array it meets, so SGD's ``-lr * g`` on a bfloat16 gradient multiplies by
  ``bfloat16(-lr)``; PyTorch would multiply by the float32 ``-lr``
  (`_mul`);
* two arrays promote by both dtypes in JAX (a 0-d float32 times a bfloat16
  array is float32); PyTorch ignores a 0-d tensor's dtype within a category
  (`_mul`).

A gradient leaf may be a sparse COO tensor: the *row gradient* of an
embedding table (`models.recsys.bag_lookup`), the unique ids touched and
their summed rows.  SGD without momentum gives a sparse update of those
rows alone, and `apply_updates` writes them in place.  JAX computes the
same step on a dense gradient whose untouched rows are 0; their update is
``-lr * 0 = -0.0`` and ``p + (-0.0) = p``, so the two are one function.
SGD with momentum keeps a dense buffer, as JAX does; AdamW keeps dense
moments and takes dense gradients only.

``partition_optimizer`` routes different leaves to different optimizers
(row-wise SGD for the tables, AdamW for the dense weights: the MLPerf DLRM
recipe) by the leaf's path, a tuple of dict keys and list indices.

In place, for a model whose parameters, gradients and two moments fill
one card (a 4B-parameter LM holds 16 bytes a parameter): `adamw`'s
``update_`` and `clip_by_global_norm_` write each leaf's result over the
leaf, one leaf (and a large leaf one piece of `PIECE` elements) at a time,
instead of building new moment, update and clipped-gradient trees.  They
run the functional forms' arithmetic on each element, op for op (the same
per-leaf functions), so their results are bit-equal.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from ..utils import tree_leaves, tree_map, tree_map_with_path


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable  # (grads, state, params) -> (updates, state)
    # (grads, state, params) -> None: the state and params updated in place
    update_: Callable | None = None


# elements of a leaf that an in-place update computes at once: its
# temporaries are a few pieces, not a few copies of the largest leaf
PIECE = 1 << 24


# --------------------------------------------------------------------------- #
# JAX's arithmetic                                                             #
# --------------------------------------------------------------------------- #
def _mul(a, b: torch.Tensor) -> torch.Tensor:
    """``a * b`` under JAX's promotion: a Python scalar ``a`` takes ``b``'s
    dtype first; two tensors meet in ``promote_types`` of both."""
    if not isinstance(a, torch.Tensor):
        return torch.full((), a, dtype=b.dtype, device=b.device) * b
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) * b.to(dt)


def _rows(g: torch.Tensor):
    """(ids, rows) of a row gradient: a sparse COO tensor whose ids are
    unique, as `models.recsys.bag_lookup` returns it.  Autograd sums the
    gradients of two lookups of one table into a tensor that is not
    coalesced; that is refused rather than summed again in another order."""
    if not g.is_coalesced():
        raise ValueError("a row gradient must come from one lookup of its "
                         "table a step (got a sparse gradient that is not "
                         "coalesced)")
    return g.indices()[0], g.values()


def _sparse_like(g: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    return torch.sparse_coo_tensor(g.indices(), values, g.shape,
                                   is_coalesced=True, check_invariants=False)


def _zeros_f32(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


@torch.no_grad()
def apply_updates(params, updates):
    """``p = (p + u).astype(p.dtype)`` for every leaf, in place; a sparse
    update writes its rows alone.  Returns ``params``."""
    def upd(p, u):
        if u.is_sparse:
            ids, rows = _rows(u)
            p.index_put_((ids,), (p.index_select(0, ids) + rows).to(p.dtype))
        else:
            p.copy_((p + u).to(p.dtype))
    tree_map(upd, params, updates)
    return params


def _global_norm(grads) -> torch.Tensor:
    def sq(g):
        v = _rows(g)[1] if g.is_sparse else g
        return torch.sum(torch.square(v.float()))
    return torch.sqrt(sum(sq(g) for g in tree_leaves(grads)))


def _clip_scale(gn: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.minimum(torch.tensor(1.0, device=gn.device),
                         max_norm / torch.clamp_min(gn, 1e-9))


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, the norm)."""
    gn = _global_norm(grads)
    scale = _clip_scale(gn, max_norm)

    def clip(g):
        if g.is_sparse:
            return _sparse_like(g, _mul(scale, _rows(g)[1]))
        return _mul(scale, g)
    return tree_map(clip, grads), gn


@torch.no_grad()
def clip_by_global_norm_(grads, max_norm: float) -> torch.Tensor:
    """`clip_by_global_norm` in place over dense float32 gradients (the
    product with the scale is float32 either way); returns the norm."""
    leaves = tree_leaves(grads)
    if any(g.is_sparse or g.dtype != torch.float32 for g in leaves):
        raise TypeError("clip_by_global_norm_ scales dense float32 "
                        "gradients in place")
    gn = _global_norm(grads)
    scale = _clip_scale(gn, max_norm)
    for g in leaves:
        g.mul_(scale)
    return gn


def _pieces(*leaves):
    """Matching flat pieces of same-shaped contiguous leaves, at most
    `PIECE` elements each (the whole leaf where one is not contiguous)."""
    if not all(t.is_contiguous() for t in leaves):
        yield leaves
        return
    flat = [t.view(-1) for t in leaves]
    for lo in range(0, flat[0].numel(), PIECE):
        yield tuple(f[lo:lo + PIECE] for f in flat)


def warmup_cosine(base_lr: float, warmup: int, total: int,
                  min_frac: float = 0.1):
    """A schedule ``step -> lr``: linear warm-up to ``base_lr``, then a
    cosine decay to ``min_frac * base_lr`` at ``total``; float32."""
    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = base_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = base_lr * (min_frac + (1 - min_frac) * 0.5
                         * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup, warm, cos)
    return lr


def adamw(lr=1e-3, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.0):
    """AdamW with float32 moments; ``lr`` a float or a schedule
    ``fn(step) -> lr``.  ``step`` counts from 1 at the first update.
    ``update_`` is the in-place form."""
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        return {"mu": tree_map(_zeros_f32, params),
                "nu": tree_map(_zeros_f32, params),
                "step": torch.zeros((), dtype=torch.int32)}

    def first(m, g):
        return b1 * m + (1 - b1) * g.float()

    def second(v, g):
        return b2 * v + (1 - b2) * torch.square(g.float())

    def schedule(state):
        step = state["step"] + 1
        return (step, lr_fn(step), 1 - b1 ** step.to(torch.float32),
                1 - b2 ** step.to(torch.float32))

    # every operand is float32 here, where PyTorch's promotion is JAX's
    def delta(m, v, p, lr_t, bc1, bc2):
        u = -(lr_t * (m / bc1) / (torch.sqrt(v / bc2) + eps))
        if weight_decay:
            u = u - lr_t * weight_decay * p.float()
        return u.to(p.dtype)

    def dense_only(grads):
        for g in tree_leaves(grads):
            if g.is_sparse:
                raise TypeError("adamw keeps dense moments and takes dense "
                                "gradients; route row gradients to sgd")

    @torch.no_grad()
    def update(grads, state, params):
        dense_only(grads)
        step, lr_t, bc1, bc2 = schedule(state)
        mu = tree_map(first, state["mu"], grads)
        nu = tree_map(second, state["nu"], grads)
        updates = tree_map(lambda m, v, p: delta(m, v, p, lr_t, bc1, bc2),
                           mu, nu, params)
        return updates, {"mu": mu, "nu": nu, "step": step}

    @torch.no_grad()
    def update_(grads, state, params):
        dense_only(grads)
        step, lr_t, bc1, bc2 = schedule(state)
        def leaf(g, m, v, p):
            for gs, ms, vs, ps in _pieces(g, m, v, p):
                m1, v1 = first(ms, gs), second(vs, gs)
                u = delta(m1, v1, ps, lr_t, bc1, bc2)
                ms.copy_(m1)
                vs.copy_(v1)
                ps.copy_((ps + u).to(ps.dtype))
        # leaf by leaf, matched by path as `update` matches them
        tree_map(leaf, grads, state["mu"], state["nu"], params)
        state["step"].copy_(step)

    return Optimizer(init, update, update_)


def sgd(lr=1e-2, momentum: float = 0.0):
    """SGD, ``lr`` a float or a schedule; with ``momentum`` a dense float32
    buffer a leaf.  Without momentum a row gradient gives a row update."""
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        st = {"step": torch.zeros((), dtype=torch.int32)}
        if momentum:
            st["mom"] = tree_map(_zeros_f32, params)
        return st

    @torch.no_grad()
    def update(grads, state, params):
        step = state["step"] + 1
        lr_t = lr_fn(step)
        neg = -lr_t
        new = {"step": step}
        if momentum:
            def mom_of(m, g):
                m = momentum * m
                if g.is_sparse:
                    ids, rows = _rows(g)
                    return m.index_put_((ids,), m.index_select(0, ids)
                                        + rows.float())
                return m + g.float()
            mom = tree_map(mom_of, state["mom"], grads)
            new["mom"] = mom
            updates = tree_map(lambda m, p: _mul(neg, m).to(p.dtype), mom,
                               params)
        else:
            def upd(g, p):
                if g.is_sparse:
                    return _sparse_like(g, _mul(neg, _rows(g)[1]).to(p.dtype))
                return _mul(neg, g).to(p.dtype)
            updates = tree_map(upd, grads, params)
        return updates, new

    return Optimizer(init, update)


def partition_optimizer(route: Callable[[tuple], str],
                        opts: dict[str, Optimizer]):
    """Route each leaf (by its path) to a named optimizer.

    ``route(path) -> key`` into ``opts``.  The state holds one sub-state a
    key over a masked copy of the tree (the leaves routed elsewhere replaced
    by 0-d zeros, so memory stays that of the routed leaves), as in JAX.
    """
    keys = list(opts)

    def _mask(tree, key):
        return tree_map_with_path(
            lambda path, p: p if route(path) == key else torch.zeros(
                (), dtype=p.dtype, device=p.device), tree)

    def init(params):
        return {k: o.init(_mask(params, k)) for k, o in opts.items()}

    def update(grads, state, params):
        new_state, partials = {}, []
        for k, o in opts.items():
            up_k, new_state[k] = o.update(_mask(grads, k), state[k],
                                          _mask(params, k))
            partials.append(up_k)
        updates = tree_map_with_path(
            lambda path, *leaves: leaves[keys.index(route(path))],
            *partials)
        return updates, new_state

    return Optimizer(init, update)


def make_optimizer(kind: str = "adamw", **kw) -> Optimizer:
    if kind == "adamw":
        return adamw(**kw)
    if kind == "sgd":
        return sgd(**kw)
    raise ValueError(kind)
