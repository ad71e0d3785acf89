"""Mixture-of-Experts FFN of the port: the counterpart of
``repro.models.moe``, sort-based capacity dispatch.

The tokens are split into ``gcd(T, dispatch_groups)`` groups, each with
its own capacity (GShard's per-group semantics; the reference vmaps the
group function, here the group is a leading batch axis).  In a group: the
(token, k) assignments are sorted by expert (stably), each gets its rank
within its expert, ranks at or past the capacity are dropped, slot (e, c)
of a dense (E, C, d) buffer takes the token at sorted position
``starts[e] + c``, the experts run as batched gated matmuls, and the
outputs are combined, weighted by the (renormalised) router
probabilities.  The router's top-k is `utils.top_k` (``lax.top_k``'s
order: equal probabilities to the lower expert).

Aux values: the Switch load-balance loss, the router z-loss and the share
of dropped assignments, each the mean over the groups.

In the sharded step (`distributed.parallel`) the group count is the
reference's over the microbatch's global tokens, the data ranks each
holding their share of the groups (an aux value is then the rank's part
of the global mean; where the data ranks do not divide the groups, a
rank's tokens move to the ranks of their groups and back,
`ParallelContext.moe_groups`), and under tensor parallelism a rank holds the
experts of its block: it routes every token (the router whole), fills
and runs its own experts' capacity slots and returns its partial combined
output, which the caller sums over "model" (``act_btd``).  Under sequence
parallelism the input is the rank's block of the sequence, (B, S / tp,
d): the rank computes its block's router logits and gathers them (their
gradient is the same on every model rank), then gathers the sequence
(the reference's ``moe_gtd``: a group's tokens whole over "model"), so
that the groups, capacities, routing and aux losses are the unsharded
ones, and returns its partial output over the whole sequence.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..distributed.parallel import MoEGroups, copy_to_model
from ..distributed.sharding import constrain, current_context
from ..utils import top_k
from .layers import ACTIVATIONS, uniform_init


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_model: int
    d_ff: int
    capacity_factor: float = 1.25
    n_shared_experts: int = 0
    renorm_topk: bool = True     # qwen3 norm_topk_prob
    act: str = "silu"            # experts are gated (SwiGLU) with this act
    dispatch_groups: int = 32    # the groups are gcd(T, dispatch_groups)


def moe_params(cfg: MoEConfig, *, lead: tuple = (), dtype=torch.float32,
               router_dtype=torch.float32, generator=None,
               device=None) -> dict:
    """The reference's tree: a float32 router (``router_dtype``) and the
    expert stacks (E, d, f), (E, f, d) in ``dtype``."""
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    kw = dict(lead=lead, dtype=dtype, generator=generator, device=device)
    p = {
        "router": uniform_init((d, e), **{**kw, "dtype": router_dtype}),
        "w1": uniform_init((e, d, f), **kw),
        "w3": uniform_init((e, d, f), **kw),
        "w2": uniform_init((e, f, d), **kw),
    }
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        p["shared"] = {"w1": uniform_init((d, fs), **kw),
                       "w3": uniform_init((d, fs), **kw),
                       "w2": uniform_init((fs, d), **kw)}
    return p


def capacity(n_tokens: int, cfg: MoEConfig) -> int:
    c = int(n_tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts) + 1
    return max(c, cfg.top_k)


def moe_apply(p, x, cfg: MoEConfig):
    """x: (..., d) -> (y (..., d), aux {load_balance, z_loss,
    dropped_frac}), the tokens in x's order; under sequence parallelism x
    is the rank's block of the sequence, (B, S / tp, d), and y is over the
    whole sequence, (B, S, d)."""
    d = x.shape[-1]
    ctx = current_context()
    logits = None
    if ctx is not None and ctx.seq_parallel:
        # the router in float32 (a bfloat16 router promoted, as in JAX)
        logits = ctx.gather_seq(x.float() @ p["router"].float(), same=True)
        x = ctx.gather_seq(x)
    shape = x.shape
    x = x.reshape(-1, d)
    if ctx is None:
        t = x.shape[0]
        g = math.gcd(t, max(cfg.dispatch_groups, 1))
        grp = MoEGroups(g, t // g, 1.0, g, None)
        experts = (0, cfg.n_experts)
    else:
        grp = ctx.moe_groups(tuple(shape), cfg.dispatch_groups)
        experts = ctx.local_experts(cfg.n_experts)
    if grp.move is not None:
        x = ctx.to_groups(x, grp.move)
        if logits is not None:
            logits = ctx.to_groups(logits.reshape(-1, logits.shape[-1]),
                                   grp.move)
    xg = constrain(x.reshape(grp.count, grp.size, d), "moe_gtd")
    if logits is not None:
        logits = logits.reshape(grp.count, grp.size, logits.shape[-1])
    y, aux = _moe_apply_groups(p, xg, cfg, experts, logits)
    y = constrain(y, "moe_gtd")
    if grp.share is None:
        aux = {k: v.sum() / grp.total for k, v in aux.items()}
    else:
        aux = {k: v.mean() for k, v in aux.items()}
        if grp.share != 1.0:
            aux = {k: v * grp.share for k, v in aux.items()}
    if grp.move is not None:
        y = ctx.from_groups(y.reshape(-1, d), grp.move)
    return y.reshape(shape), aux


def _moe_apply_groups(p, x, cfg: MoEConfig, experts: tuple, logits=None):
    """The reference's ``_moe_apply_group`` on each of the G groups of
    x: (G, t, d) -> (y (G, t, d), aux values (G,)).  ``experts`` = (first,
    count): the experts whose weights ``p`` holds; the output is theirs.
    ``logits``: the router's (G, t, E), given where x is the gathered
    sequence (`moe_apply`), whose backward sums the model ranks' partial
    gradients already; else computed here and x passes `copy_to_model`."""
    g, t, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    lo, el = experts
    n = t * k
    c = capacity(t, cfg)
    act = ACTIVATIONS[cfg.act]
    dev = x.device
    gi = torch.arange(g, device=dev)[:, None]

    if logits is None:
        # the router in float32 (a bfloat16 router promoted, as in JAX)
        logits = x.float() @ p["router"].float()             # (G, t, E)
        x = copy_to_model(x)
    probs = torch.softmax(logits, dim=-1)
    topv, topi = top_k(probs.reshape(g * t, e), k)
    topv, topi = topv.reshape(g, t, k), topi.reshape(g, t, k)
    if cfg.renorm_topk:
        topv = topv / torch.clamp_min(topv.sum(-1, keepdim=True), 1e-9)

    # ---- dispatch bookkeeping (sort by expert, rank within expert) ----
    flat_e = topi.reshape(g, n)
    flat_t = torch.arange(t, device=dev).repeat_interleave(k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = flat_e.gather(1, order)
    st = flat_t[order]                                       # (G, n)
    counts = torch.zeros((g, e), dtype=torch.long, device=dev).scatter_add_(
        1, flat_e, torch.ones_like(flat_e))
    starts = counts.cumsum(1) - counts
    rank = torch.arange(n, device=dev) - starts.gather(1, se)
    kept = rank < c

    # gather dispatch: slot (e, c) takes sorted position starts[e] + c,
    # for this rank's experts [lo, lo + el)
    xb = x
    cgrid = torch.arange(c, device=dev)
    slot_pos = starts[:, lo:lo + el, None] + cgrid           # (G, el, C)
    slot_valid = (cgrid < counts[:, lo:lo + el, None]) & (slot_pos < n)
    slot_tok = st.gather(1, slot_pos.clamp_max(n - 1).reshape(g, el * c))
    buf = xb[gi, slot_tok].reshape(g, el, c, d) * \
        slot_valid[..., None].to(x.dtype)
    buf = constrain(buf, "moe_ecd_local")

    # ---- expert FFN (gated) ----
    h = act(torch.einsum("gecd,edf->gecf", buf, p["w1"])) * \
        torch.einsum("gecd,edf->gecf", buf, p["w3"])
    y_buf = constrain(torch.einsum("gecf,efd->gecd", h, p["w2"]),
                      "moe_ecd_local")

    # ---- combine: a dropped assignment (or another rank's expert) reads
    # nothing (the reference's fill of index E), the rest their slot ----
    mine = kept & (se >= lo) & (se < lo + el)
    y_sorted = y_buf[gi, (se - lo).clamp(0, el - 1),
                     torch.where(mine, rank, 0)]
    y_sorted = torch.where(mine[..., None], y_sorted, 0.0)
    inv = torch.empty_like(order).scatter_(
        1, order, torch.arange(n, device=dev).expand(g, n))
    y_flat = y_sorted[gi, inv]                               # (G, n, d)
    gates = copy_to_model(topv).reshape(g, n, 1).to(x.dtype)
    y = torch.sum((y_flat * gates).reshape(g, t, k, d), dim=2)

    if cfg.n_shared_experts:
        s = p["shared"]
        y = y + (act(xb @ s["w1"]) * (xb @ s["w3"])) @ s["w2"]

    # ---- aux values ----
    frac = torch.zeros((g, e), dtype=torch.float32, device=dev).scatter_add_(
        1, topi[..., 0], torch.ones((g, t), device=dev)) / t
    aux = {
        "load_balance": e * torch.sum(frac * probs.mean(1), dim=-1),
        "z_loss": torch.mean(torch.logsumexp(logits, dim=-1) ** 2, dim=-1),
        "dropped_frac": 1.0 - kept.sum(-1) / n,
    }
    return y, aux
