"""Helpers the port's layers share: trees of tensors (nested dicts, lists and
tuples, as JAX's pytrees) and a top-k in ``jax.lax.top_k``'s order."""
from __future__ import annotations

import torch


def tree_map_with_path(fn, tree, *rest, path: tuple = ()):
    """``fn(path, leaf, *leaves)`` over the leaves of ``tree`` (and the
    matching leaves of ``rest``), keeping the structure; a path is a tuple
    of dict keys and list indices."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, tree[k], *(r[k] for r in rest),
                                      path=path + (k,)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, t, *(r[i] for r in rest),
                                             path=path + (i,))
                          for i, t in enumerate(tree))
    return fn(path, tree, *rest)


def tree_map(fn, tree, *rest):
    return tree_map_with_path(lambda _, *leaves: fn(*leaves), tree, *rest)


def tree_leaves(tree) -> list:
    out: list = []
    tree_map(out.append, tree)
    return out


def _order_keys(x: torch.Tensor) -> torch.Tensor:
    """int32 keys of a float32 ``x`` in IEEE total order (-NaN < -inf < ...
    < -0.0 < +0.0 < ... < +inf < +NaN), the order ``jax.lax.top_k``
    compares in: equal keys are equal bits."""
    bits = x.contiguous().view(torch.int32)
    return bits ^ ((bits >> 31) & 0x7FFFFFFF)


def top_k(x: torch.Tensor, k: int, *, largest: bool = True, masked=None):
    """(values, columns) of the ``k`` largest entries of each row of a 2-D
    float32 ``x``, descending (``largest=False``: the smallest, ascending),
    in IEEE total order, equal values in ascending column order:
    ``jax.lax.top_k``'s rule (of the negated rows for the smallest).
    `torch.topk` promises no order among equal values, nor which of them it
    keeps at the k-th value, so both are fixed here.  A row whose k-th
    value ties with entries past it is resolved by a stable sort of the
    row's entries at or beyond that value; ``masked`` names a k-th value
    whose ties need no resolving (entries the caller masks)."""
    keys = _order_keys(x)
    kv, idx = torch.topk(keys, k, dim=1, largest=largest, sorted=True)
    if k:
        idx, p = torch.sort(idx, dim=1)
        kv, p2 = torch.sort(kv.gather(1, p), dim=1, descending=largest,
                            stable=True)
        idx = idx.gather(1, p2)

        def beyond(row, kth):
            return row >= kth if largest else row <= kth

        kth = kv[:, -1]
        tied = beyond(keys, kth[:, None]).sum(dim=1) > k
        if masked is not None:
            tied &= kth != _order_keys(torch.tensor(
                [masked], dtype=torch.float32, device=x.device))
        for i in torch.nonzero(tied).flatten().tolist():
            cols = torch.nonzero(beyond(keys[i], kth[i])).flatten()
            _, p = torch.sort(keys[i, cols], descending=largest, stable=True)
            idx[i] = cols[p[:k]]
    return x.gather(1, idx), idx
