"""Logical sharding annotations of the port: the counterpart of
``repro.distributed.sharding``.

Model code calls ``constrain(x, "act_btd")`` with a *logical* name; the
sharded step activates a rule set mapping logical names to `Spec`s for its
mesh.  With no active rules the call is the identity, so the models run
unmodified on one device.

A `Spec` is the port's PartitionSpec: one entry per tensor dimension, each
``None`` (replicated), a mesh axis name, or a tuple of names (the first the
slowest, as in JAX).  `to_placements` turns it into DTensor placements
for a `DeviceMesh`.

The rules name layouts; the sharded step (`distributed.parallel`) holds
the local tensors that realise them and registers, in its context, what
``constrain`` does at each name: the layout change a name marks (at
``act_btd`` the partial results reduce-scattered over "model" into the
rank's block of the sequence, or, where a step keeps the residual whole,
summed).

The gnn and recsys names are realised by the local tensors themselves
and by the context's hooks, which the models call at the reference's
``constrain`` sites; ``constrain`` stays the identity at these names:

* ``table_rows`` (a table's rows over "model"): the rank's row block, a
  lookup localized to it and summed over "model"
  (`parallel.ParallelContext.localize_rows`, ``model_sum``,
  ``vocab_rows``);
* ``act_bd``, ``act_bfd``, ``rs_chunk_h`` (the batch over the data axes):
  the rank's rows of the batch, the losses over the global count
  (``batch_mean``), the serving outputs gathered (``gather_data_rows``);
* ``candidates``: the ranking archs' candidates over the data axes, the
  item tables' candidate rows on their model ranks, the top lists merged
  (``merge_top_k``);
* ``edges_e``, ``edges_ed`` (the GAT's edges over the data axes): the
  rank's edges, the segment max and softmax sums reduced over the data
  ranks (``edge_max``, ``edge_sum``, ``edge_whole``);
* ``nodes_nd`` (the GAT's hidden node rows over the data axes): the
  rank's block of the padded rows between layers (``node_rows``), the
  rows gathered for the rank's edges (``to_edges``) and the messages
  reduce-scattered back (``node_scatter``).

``gather_layer_params`` is ZeRO-3's gather at use: under the ``"zero3"``
flag each weight named in `_GATHERED_2D` / `_GATHERED_3D` is gathered over
the data axes to the layout its compute wants (TP-only), by the active
context.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Mapping


class Spec:
    """A PartitionSpec: ``Spec("data", None)``; entries ``None``, an axis
    name or a tuple of axis names.  ``Spec()`` is a scalar's (replicated).
    Not a tuple, so that the port's tree functions take it as a leaf; it
    compares equal to the tuple of its entries."""

    __slots__ = ("entries",)

    def __init__(self, *entries):
        self.entries = tuple(entries)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self):
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __eq__(self, other):
        if isinstance(other, Spec):
            other = other.entries
        return isinstance(other, tuple) and self.entries == other

    def __hash__(self):
        return hash(self.entries)

    def __repr__(self):
        return f"Spec{self.entries!r}"

    def axes(self, dim: int) -> tuple:
        """The mesh axes of tensor dimension ``dim`` (a tuple, maybe
        empty)."""
        e = self.entries[dim] if dim < len(self.entries) else None
        if e is None:
            return ()
        return e if isinstance(e, tuple) else (e,)


def to_placements(spec: Spec, mesh) -> tuple:
    """``spec`` as DTensor placements over ``mesh``'s dimensions: ``Shard(i)``
    for a mesh axis named on tensor dimension ``i``, ``Replicate()`` for an
    axis the spec does not name.  Two axes on one tensor dimension shard it
    in mesh order (the first the slowest), as a tuple entry does in JAX
    when its names are in the mesh's order, which the spec must keep."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for dim in range(len(spec)):
        axes = spec.axes(dim)
        pos = [names.index(a) for a in axes]
        if pos != sorted(pos):
            raise ValueError(f"{spec}: axes {axes} are not in the mesh's "
                             f"order {names}")
        for p in pos:
            out[p] = Shard(dim)
    return tuple(out)


_ACTIVE: contextvars.ContextVar[Mapping[str, Spec] | None] = \
    contextvars.ContextVar("sharding_rules", default=None)
# the sharded step's context (`distributed.parallel.ParallelContext`): what
# ``constrain`` and ``gather_layer_params`` do with the active rules
_CONTEXT: contextvars.ContextVar = contextvars.ContextVar(
    "parallel_context", default=None)


def current_rules() -> Mapping[str, Spec] | None:
    return _ACTIVE.get()


@contextlib.contextmanager
def sharding_rules(rules: Mapping[str, Spec] | None, context=None):
    """Activate ``rules`` (and the sharded step's ``context``, which says
    what the names mean for its tensors) for the block."""
    tok = _ACTIVE.set(rules)
    ctok = _CONTEXT.set(context)
    try:
        yield
    finally:
        _CONTEXT.reset(ctok)
        _ACTIVE.reset(tok)


def scoped(fn):
    """``fn`` run under the rules and context active now, wherever it is
    called: a checkpointed function's recomputation runs in the backward,
    which on the card runs on the autograd engine's own thread, where the
    context variables set around the step are not set."""
    rules, ctx = _ACTIVE.get(), _CONTEXT.get()
    if rules is None:
        return fn

    def run(*args, **kwargs):
        with sharding_rules(rules, ctx):
            return fn(*args, **kwargs)
    return run


def current_context():
    """The sharded step's context while its rules are active, else None."""
    return _CONTEXT.get() if _ACTIVE.get() is not None else None


def constrain(x, name: str):
    """Fix ``x``'s layout to rule ``name``'s, if a rule for it is active:
    the active context's layout change at that name (identity where it
    registers none, and always without a context)."""
    rules = _ACTIVE.get()
    if rules is None or rules.get(name) is None:
        return x
    ctx = _CONTEXT.get()
    return x if ctx is None else ctx.constrain(x, name, rules[name])


# Gathered (ZeRO-3) specs: the weight as used by compute keeps ONLY its
# 'model' (TP) axis; the data axes are gathered right before use.
_GATHERED_2D = {
    "wq": Spec(None, "model"), "wk": Spec(None, "model"),
    "wv": Spec(None, "model"), "w1": Spec(None, "model"),
    "w3": Spec(None, "model"), "router": Spec(None, "model"),
    "wq_b": Spec(None, "model"), "wkv_b": Spec(None, "model"),
    "wo": Spec("model", None), "w2": Spec("model", None),
    "wq_a": Spec(None, None), "wkv_a": Spec(None, None),
}
_GATHERED_3D = {  # stacked expert weights (E, d, f) / (E, f, d)
    "w1": Spec("model", None, None), "w3": Spec("model", None, None),
    "w2": Spec("model", None, None),
}


def gathered_spec(name: str, ndim: int) -> Spec | None:
    """The TP-only spec a weight named ``name`` is gathered to, or None
    for a leaf the gather leaves alone."""
    table = {2: _GATHERED_2D, 3: _GATHERED_3D}.get(ndim, {})
    return table.get(name)


def gather_layer_params(tree, dtype=None):
    """A layer's parameters as its compute uses them: each leaf cast to
    ``dtype`` (when given), and under the ``"zero3"`` flag every 2D/3D
    matmul weight gathered over the data axes to its `gathered_spec`, by
    the active context (the cast before the gather, so the gather moves
    the compute dtype; its backward reduce-scatters a float32 gradient).
    Without active rules or the flag: the cast alone."""
    rules = _ACTIVE.get()
    ctx = _CONTEXT.get()
    if rules is None or not rules.get("zero3") or ctx is None:
        if dtype is None:
            return tree
        return _map_named(lambda name, a: a.to(dtype), tree)
    return _map_named(lambda name, a: ctx.gather_weight(name, a, dtype),
                      tree)


def _map_named(fn, tree, name=None):
    """``fn(key of the leaf, leaf)`` over a dict tree."""
    if isinstance(tree, dict):
        return {k: _map_named(fn, v, k) for k, v in tree.items()}
    return fn(name, tree)


def rules_for_family(family: str, *, multi_pod: bool = False) -> dict:
    """Logical name -> `Spec` for the production meshes: the reference's
    names and axes.  Axes: ('pod',) 'data', 'model'; the data axes are
    ('pod', 'data') with ``multi_pod``."""
    dp = ("pod", "data") if multi_pod else "data"
    if family == "lm":
        return {
            "zero3": True,
            # activations; act_btd is sequence-parallel in the reference
            "act_btd": Spec(dp, "model", None),
            "act_btf": Spec(dp, None, "model"),
            "act_bthd": Spec(dp, None, "model", None),
            "attn_scores": Spec(dp, "model", None, None),
            "logits": Spec(dp, None, "model"),
            "logits_2d": Spec(dp, "model"),
            # MoE grouped-dispatch activations (G, T_local, d)
            "moe_gtd": Spec(dp, None, None),
            # per-group expert buffer (E, C, d)
            "moe_ecd_local": Spec("model", None, None),
            # decode-time KV cache: batch over dp, seq over model
            "kv_cache": Spec(None, dp, "model", None, None),
            "mla_cache": Spec(None, dp, "model", None),
        }
    if family == "gnn":
        return {
            "nodes_nd": Spec(dp, None),
            "edges_e": Spec(dp),
            "edges_ed": Spec(dp, None),
        }
    if family == "recsys":
        return {
            "act_bd": Spec(dp, None),
            "act_bfd": Spec(dp, None, None),
            "table_rows": Spec("model", None),
            "candidates": Spec(dp, None),
            "rs_chunk_h": Spec(None, dp, None, None),
        }
    if family == "snn":
        return {
            "db_rows": Spec(dp, None),
            "db_scalar": Spec(dp),
            "queries": Spec(None, None),
        }
    raise ValueError(f"unknown family {family!r}")
