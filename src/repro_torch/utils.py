"""Helpers the port's layers share: trees of tensors (nested dicts, lists and
tuples, as JAX's pytrees) and their autograd views, host arrays to and from
tensors, and a top-k in ``jax.lax.top_k``'s order."""
from __future__ import annotations

import numpy as np
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


def grad_view(tree, grads):
    """``tree`` with each leaf replaced by an autograd leaf over the same
    storage (``detach().requires_grad_()``) whose ``.grad`` is the matching
    leaf of ``grads``: a backward then adds each leaf's gradient into
    ``grads`` in place (``grad += g``), and an update of ``tree``'s
    tensors is seen by the view."""
    def leaf(p, g):
        t = p.detach().requires_grad_()
        t.grad = g
        return t
    return tree_map(leaf, tree, grads)


def to_tensor(a, device) -> torch.Tensor:
    """A host array as a tensor on ``device``; a bfloat16 array (numpy's
    ``bfloat16`` extension type) moves its bits, not its values."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:      # torch tensors share writable memory
        a = a.copy()
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a host array of its own; numpy has no bfloat16, so a
    bfloat16 tensor comes back as the float32 array of the same values."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy().copy()


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
    keeps at the k-th value, so both are fixed here.  The rows whose k-th
    value ties with entries past it are resolved together, by one top-k of
    int64 keys (the value's key, then the column) that tie nowhere;
    ``masked`` names a k-th value whose ties need no resolving (entries the
    caller masks)."""
    keys = _order_keys(x)
    kv, idx = torch.topk(keys, k, dim=1, largest=largest, sorted=True)
    if k:
        idx, p = torch.sort(idx, dim=1)
        kv, p2 = torch.sort(kv.gather(1, p), dim=1, descending=largest,
                            stable=True)
        idx = idx.gather(1, p2)
        kth = kv[:, -1:]
        beyond = keys >= kth if largest else keys <= kth
        tied = beyond.sum(dim=1) > k
        if masked is not None:
            tied &= kth[:, 0] != _order_keys(torch.tensor(
                [masked], dtype=torch.float32, device=x.device))
        from torch._subclasses.fake_tensor import is_fake
        if is_fake(tied):
            # a dry-run trace (`launch.hlo_analysis`): shapes without
            # values, so no tie can be seen; the common path's costs
            return x.gather(1, idx), idx
        rows = torch.nonzero(tied).flatten()
        if rows.numel():
            n = keys.shape[1]
            col = torch.arange(n, device=x.device)
            # the value's key in the high 32 bits, the column (reversed for
            # the largest, so that the lower column wins) in the low 32
            low = n - 1 - col if largest else col
            wide = (keys[rows].long() << 32) | low
            idx[rows] = torch.topk(wide, k, dim=1, largest=largest,
                                   sorted=True)[1]
    return x.gather(1, idx), idx
