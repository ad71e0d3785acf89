"""Graph attention network (GAT) and neighbour sampling of the port: the
counterpart of ``repro.models.gnn`` (the assigned arch ``gat-cora``).

Message passing is an edge-index scatter, as in the reference: SDDMM edge
scores, a segment softmax over each node's incoming edges, a scatter sum
of the weighted messages.  The reference's ``jax.ops.segment_max`` is
``scatter_reduce("amax")`` from -inf, whose gradient splits evenly among
the edges tied at a segment's maximum, as JAX's does; ``segment_sum`` is
``index_add``.  Three regimes, as in the reference:

* full graph (cora, ogb_products): one (N, E) graph a step, edges padded
  with a mask;
* minibatch (GraphSAGE-style fixed fanout, ``minibatch_lg``): dense
  (B, f1, f2) gathers sampled on the host by `NeighborSampler`;
* batched small graphs (``molecule``): the reference vmaps the full-graph
  loss over the graphs; here the G graphs run as one graph of G * N nodes
  (graph g's node ids offset by g * N), which is the same function: no
  segment crosses a graph.

The weighted messages ``alpha[:, :, None] * h[src]`` are (E, H, dh): 16.5
GB at ogb_products' 64.3M edges, and autograd would keep the gathered
``h[src]`` of each layer for the backward.  `edge_aggregate` computes the
scatter sum and its gradient edge chunk by chunk instead, keeping only
``alpha`` and ``h``; the arithmetic of each element is the reference's.

Parameters are a dict tree in the JAX layout, ``{"layers": [{"w",
"a_src", "a_dst"}, ...]}`` (`params_from_jax` carries the JAX package's
across).

In the sharded step (`launch.steps.build_step(..., mesh=...)`, under a
`distributed.parallel.ParallelContext`) the parameters are replicated.
The full-graph regime holds the rank's block of the edges (the
reference's ``edges_e``) and, between layers, its block of the padded
node rows (``nodes_nd``; the input features, labels and mask whole): a
layer computes ``x @ w`` and the attention logits on its rows, gathers
them whole for its edges (`ParallelContext.to_edges`), scores its edges,
all-reduces the segment max (MAX) over the data ranks, takes the
exponentials, sums the denominators, and reduce-scatters the aggregated
messages into its rows (`ParallelContext.node_scatter`); the last layer
sums them whole instead, so the loss is whole on every rank (`gat_layer`,
`forward_full`).  The minibatch and batched regimes hold the rank's rows
of the batch, and their losses divide by the global count.  Every
parameter's gradient is then partial over the data ranks and summed
after the backward.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..distributed.sharding import current_context
from ..kernels import registry as _registry
from ..utils import grad_view, to_tensor, tree_map
from .layers import uniform_init

# a scatter sum's edges at once: (EDGE_CHUNK, H, dh) float32 temporaries
EDGE_CHUNK = 1 << 22
# the score of a padded edge, as in the reference
PAD_SCORE = -1e30


@dataclasses.dataclass(frozen=True)
class GATConfig:
    name: str
    d_in: int
    d_hidden: int = 8
    n_heads: int = 8
    n_classes: int = 7
    n_layers: int = 2
    negative_slope: float = 0.2
    graph_pool: bool = False   # molecule regime: mean-pool nodes -> graph logit
    dtype: torch.dtype = torch.float32


def gat_layer_params(d_in: int, n_heads: int, d_head: int, *,
                     dtype=torch.float32, generator=None, device=None):
    kw = dict(dtype=dtype, generator=generator, device=device)
    return {"w": uniform_init((d_in, n_heads * d_head), **kw),
            "a_src": uniform_init((n_heads, d_head), scale=0.1, **kw),
            "a_dst": uniform_init((n_heads, d_head), scale=0.1, **kw)}


def init_params(cfg: GATConfig, *, generator=None, device=None) -> dict:
    """Layers 1 .. n - 1: d -> H * dh (heads concatenated); layer n:
    H * dh -> n_classes, one head.  Uniform in ``1 / sqrt(fan_in)``, the
    attention vectors in 0.1."""
    kw = dict(dtype=cfg.dtype, generator=generator, device=device)
    layers, d = [], cfg.d_in
    for _ in range(cfg.n_layers - 1):
        layers.append(gat_layer_params(d, cfg.n_heads, cfg.d_hidden, **kw))
        d = cfg.n_heads * cfg.d_hidden
    layers.append(gat_layer_params(d, 1, cfg.n_classes, **kw))
    return {"layers": layers}


def params_from_jax(tree, cfg: GATConfig, device=None) -> dict:
    """The JAX package's GAT parameters (numpy leaves) as tensors on
    ``device`` (default: the card), checked against ``cfg``'s shapes."""
    dev = _registry.resolve_device(device)
    want = init_params(cfg, device="meta")
    if len(tree["layers"]) != len(want["layers"]):
        raise ValueError("the tree's layers are not the config's")

    def leaf(a, w):
        t = to_tensor(a, dev)
        if tuple(t.shape) != tuple(w.shape):
            raise ValueError(f"a leaf has shape {tuple(t.shape)}, the config "
                             f"wants {tuple(w.shape)}")
        return t
    return {"layers": [{k: leaf(lp[k], wp[k]) for k in wp}
                       for lp, wp in zip(tree["layers"], want["layers"])]}


# --------------------------------------------------------------------------- #
# Segment operations                                                           #
# --------------------------------------------------------------------------- #
def leaky_relu(x, slope: float):
    """``jax.nn.leaky_relu``: ``where(x >= 0, x, slope * x)`` (its gradient
    at 0 is 1; ``F.leaky_relu``'s is the slope)."""
    return torch.where(x >= 0, x, slope * x)


def elu(x):
    """``jax.nn.elu``: ``where(x > 0, x, expm1(where(x > 0, 0, x)))``."""
    return torch.where(x > 0, x, torch.expm1(torch.where(x > 0, 0.0, x)))


def segment_max(e, seg, n: int):
    """Per-segment max of e (E, H) over seg (E,) int64, -inf where a
    segment is empty; the gradient splits evenly among the entries equal to
    their segment's max (JAX's ``scatter_max`` rule)."""
    init = torch.full((n,) + e.shape[1:], -torch.inf, dtype=e.dtype,
                      device=e.device)
    idx = seg.view((-1,) + (1,) * (e.dim() - 1)).expand_as(e)
    return init.scatter_reduce(0, idx, e, "amax", include_self=True)


def segment_sum(x, seg, n: int):
    return x.new_zeros((n,) + x.shape[1:]).index_add(0, seg, x)


class _EdgeAggregate(torch.autograd.Function):
    """out[n] = sum over the edges e into n of alpha[e, :, None] *
    h[src[e]], edge chunk by chunk; the backward is autograd's of the
    reference's ``segment_sum(alpha[:, :, None] * h[src], dst)``:
    g_alpha[e] = sum_d g[dst[e]] * h[src[e]], g_h = scatter sum over src
    of g[dst[e]] * alpha[e]."""

    @staticmethod
    def forward(ctx, alpha, h, src, dst, n: int):
        out = h.new_zeros((n,) + h.shape[1:])
        for lo in range(0, src.shape[0], EDGE_CHUNK):
            sl = slice(lo, lo + EDGE_CHUNK)
            out.index_add_(0, dst[sl], alpha[sl, :, None] * h[src[sl]])
        ctx.save_for_backward(alpha, h, src, dst)
        return out

    @staticmethod
    def backward(ctx, g):
        alpha, h, src, dst = ctx.saved_tensors
        g_alpha = torch.empty_like(alpha) if ctx.needs_input_grad[0] else None
        g_h = torch.zeros_like(h) if ctx.needs_input_grad[1] else None
        for lo in range(0, src.shape[0], EDGE_CHUNK):
            sl = slice(lo, lo + EDGE_CHUNK)
            gm = g[dst[sl]]
            if g_alpha is not None:
                g_alpha[sl] = (gm * h[src[sl]]).sum(-1)
            if g_h is not None:
                g_h.index_add_(0, src[sl], gm * alpha[sl, :, None])
        return g_alpha, g_h, None, None, None


def edge_aggregate(alpha, h, src, dst, n: int):
    """``segment_sum(alpha[:, :, None] * h[src], dst, n)`` without the
    (E, H, dh) messages: alpha (E, H), h (N, H, dh), src/dst (E,) int64."""
    return _EdgeAggregate.apply(alpha, h, src, dst, n)


# --------------------------------------------------------------------------- #
# Full-graph regime                                                            #
# --------------------------------------------------------------------------- #
def _node_context():
    """The sharded full-graph step's context (``layout="edges"``), or
    None."""
    pc = current_context()
    return pc if pc is not None and pc.layout == "edges" else None


def _whole_ops(pc):
    """(a whole node tensor as the rank's edges read it, the max of the
    ranks' segment maxes, the sum of the ranks' node partials): the data
    ranks' ops where the edges are split over more than one data rank,
    identities otherwise."""
    if pc is None or pc.dp_size == 1:
        return (lambda t: t), (lambda m, e, seg: m), (lambda t: t)
    return pc.edge_whole, pc.edge_max, pc.edge_sum


def gat_layer(p, x, src, dst, n_nodes: int, *, n_heads: int, d_head: int,
              slope: float, concat: bool, edge_mask=None,
              out_rows: bool = False):
    """One GAT layer: SDDMM -> segment softmax -> scatter sum.

    x: (N, d); src/dst: (E,) int64, self-loops included by the caller;
    edge_mask: optional (E,) bool, False on padded edges.  In the sharded
    full-graph step the edges are the rank's block and x the rank's rows
    of the N nodes: ``x @ w`` and the logits are gathered whole for the
    edges (`ParallelContext.to_edges`), and the output is the rank's rows
    (``out_rows``, `ParallelContext.node_scatter`) or whole on every
    rank."""
    pc = _node_context()
    read, max_over, node_sum = _whole_ops(pc)
    h = (x @ p["w"]).reshape(x.shape[0], n_heads, d_head)      # (N, H, dh)
    es = torch.einsum("nhd,hd->nh", h, p["a_src"])
    ed = torch.einsum("nhd,hd->nh", h, p["a_dst"])
    if pc is not None:
        h, es, ed = pc.to_edges(h), pc.to_edges(es), pc.to_edges(ed)
    e = leaky_relu(es[src] + ed[dst], slope)                   # (E, H)
    if edge_mask is not None:
        e = torch.where(edge_mask[:, None], e, PAD_SCORE)
    m = max_over(segment_max(e, dst, n_nodes), e, dst)          # (N, H)
    m = torch.where(torch.isfinite(m), m, 0.0)
    ex = torch.exp(e - read(m)[dst])
    if edge_mask is not None:
        ex = torch.where(edge_mask[:, None], ex, 0.0)
    denom = node_sum(segment_sum(ex, dst, n_nodes))             # (N, H)
    alpha = ex / torch.clamp_min(read(denom)[dst], 1e-9)
    out = edge_aggregate(alpha, h, src, dst, n_nodes)           # (N, H, dh)
    out = pc.node_scatter(out) if pc is not None and out_rows \
        else node_sum(out)
    if concat:
        return out.reshape(out.shape[0], n_heads * d_head)
    return out.mean(dim=1)


def forward_full(params, x, src, dst, cfg: GATConfig, edge_mask=None):
    """Full-graph forward -> (N, n_classes) logits.  In the sharded step
    the hidden state between layers is the rank's rows of the padded
    nodes (the reference's ``nodes_nd``), the logits whole."""
    n = x.shape[0]
    src, dst = src.long(), dst.long()
    pc = _node_context()
    h = x if pc is None else pc.node_rows(x)
    for lp in params["layers"][:-1]:
        h = elu(gat_layer(lp, h, src, dst, n, n_heads=cfg.n_heads,
                          d_head=cfg.d_hidden, slope=cfg.negative_slope,
                          concat=True, edge_mask=edge_mask, out_rows=True))
    return gat_layer(params["layers"][-1], h, src, dst, n, n_heads=1,
                     d_head=cfg.n_classes, slope=cfg.negative_slope,
                     concat=False, edge_mask=edge_mask)


def node_xent(logits, labels, mask):
    """Mean cross-entropy over the masked nodes, in float32."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    ll = lf.gather(1, labels.clamp_min(0).long()[:, None])[:, 0]
    per = torch.where(mask, lse - ll, 0.0)
    count = mask.sum()
    pc = current_context()
    if pc is not None:
        count = pc.batch_count(count)
    return per.sum() / torch.clamp_min(count, 1)


def loss_full(params, batch, cfg: GATConfig):
    logits = forward_full(params, batch["x"], batch["src"], batch["dst"], cfg,
                          edge_mask=batch.get("edge_mask"))
    if cfg.graph_pool:
        logits = logits.mean(dim=0, keepdim=True)
        return node_xent(logits, batch["label"].reshape(1),
                         torch.ones(1, dtype=torch.bool,
                                    device=logits.device))
    return node_xent(logits, batch["labels"], batch["mask"])


def loss_batched_graphs(params, batch, cfg: GATConfig):
    """molecule regime: G graphs of N nodes and E edges each (x (G, N, d),
    src/dst (G, E), labels (G,)), one graph-level cross-entropy a graph
    (the mean of its node logits), averaged.  The graphs run as one graph
    of G * N nodes."""
    g, n, d = batch["x"].shape
    off = (torch.arange(g, device=batch["x"].device) * n)[:, None]
    logits = forward_full(params, batch["x"].reshape(g * n, d),
                          (batch["src"] + off).reshape(-1),
                          (batch["dst"] + off).reshape(-1), cfg)
    logits = logits.reshape(g, n, -1).mean(dim=1)               # (G, C)
    lse = torch.logsumexp(logits.float(), dim=-1)
    ll = logits.gather(1, batch["labels"].long()[:, None])[:, 0]
    pc = current_context()
    return (lse - ll).mean() if pc is None else pc.batch_mean(lse - ll)


# --------------------------------------------------------------------------- #
# Minibatch regime: fixed-fanout sampled forward (GraphSAGE recipe, GAT agg)   #
# --------------------------------------------------------------------------- #
def _attend(p, xc, xn, n_heads: int, d_head: int, concat: bool, slope):
    """Attention of centers xc (..., d) over their sampled neighbours xn
    (..., F, d) plus a self edge."""
    hc = (xc @ p["w"]).reshape(xc.shape[:-1] + (n_heads, d_head))
    hn = (xn @ p["w"]).reshape(xn.shape[:-1] + (n_heads, d_head))
    ec = torch.einsum("...hd,hd->...h", hc, p["a_dst"])          # center term
    en = torch.einsum("...fhd,hd->...fh", hn, p["a_src"])        # neighbours
    e_self = leaky_relu(torch.einsum("...hd,hd->...h", hc, p["a_src"]) + ec,
                        slope)
    e_n = leaky_relu(en + ec[..., None, :], slope)
    scores = torch.cat([e_self[..., None, :], e_n], dim=-2)
    a = torch.softmax(scores.float(), dim=-2).to(xc.dtype)
    vals = torch.cat([hc[..., None, :, :], hn], dim=-3)      # (..., F+1, H, dh)
    out = torch.einsum("...fh,...fhd->...hd", a, vals)
    if concat:
        return out.reshape(out.shape[:-2] + (n_heads * d_head,))
    return out.mean(dim=-2)


def forward_minibatch(params, feats, cfg: GATConfig):
    """feats: 'x0' (B, d), 'x1' (B, f1, d), 'x2' (B, f1, f2, d).  Layer 1
    aggregates hop 2 into hop 1 and hop 1 into the seeds, layer 2 hop 1
    into the seeds -> (B, n_classes)."""
    p1, p2 = params["layers"][0], params["layers"][-1]
    s = cfg.negative_slope
    h1 = elu(_attend(p1, feats["x1"], feats["x2"], cfg.n_heads, cfg.d_hidden,
                     True, s))                                 # (B, f1, H*dh)
    h0 = elu(_attend(p1, feats["x0"], feats["x1"], cfg.n_heads, cfg.d_hidden,
                     True, s))                                 # (B, H*dh)
    return _attend(p2, h0, h1, 1, cfg.n_classes, False, s)     # (B, C)


def loss_minibatch(params, batch, cfg: GATConfig):
    logits = forward_minibatch(params, batch, cfg)
    return node_xent(logits, batch["labels"],
                     torch.ones(logits.shape[0], dtype=torch.bool,
                                device=logits.device))


def value_and_grad(loss_fn, params, batch, cfg: GATConfig):
    """(loss, gradients in ``params``' layout) of ``loss_fn(params, batch,
    cfg)``: ``jax.value_and_grad``."""
    grads = tree_map(torch.zeros_like, params)
    loss = loss_fn(grad_view(params, grads), batch, cfg)
    loss.backward()
    return loss.detach(), grads


class NeighborSampler:
    """Host-side uniform fanout sampler over a CSR adjacency (with
    replacement), the reference's: the same samples for the same seed.
    Isolated nodes sample themselves."""

    def __init__(self, indptr: np.ndarray, indices: np.ndarray, seed: int = 0):
        self.indptr = np.asarray(indptr, np.int64)
        self.indices = np.asarray(indices, np.int64)
        self.rng = np.random.default_rng(seed)

    def sample_hop(self, nodes: np.ndarray, fanout: int) -> np.ndarray:
        deg = self.indptr[nodes + 1] - self.indptr[nodes]
        r = self.rng.integers(0, np.maximum(deg, 1)[:, None],
                              size=(nodes.size, fanout))
        gather = np.clip(self.indptr[nodes][:, None] + r, 0,
                         max(self.indices.size - 1, 0))
        flat = (self.indices[gather] if self.indices.size
                else np.zeros_like(gather))
        # degree-0 fallback: self
        flat = np.where(deg[:, None] > 0, flat, nodes[:, None])
        return flat.astype(np.int64)

    def sample(self, seeds: np.ndarray, fanouts: tuple[int, ...]):
        """Hop node id arrays [seeds (B,), (B, f1), (B, f1, f2), ...]."""
        hops = [np.asarray(seeds, np.int64)]
        cur = hops[0]
        shape = (cur.size,)
        for f in fanouts:
            nxt = self.sample_hop(cur.reshape(-1), f)
            shape = shape + (f,)
            hops.append(nxt.reshape(shape))
            cur = nxt
        return hops
