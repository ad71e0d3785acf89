"""Neural-net building blocks of the port: the counterpart of
``repro.models.layers``.

The JAX package keeps an MLP as a list of ``{"w": (in, out), "b": (out,)}``
dicts applied as ``x @ w + b``; here it is a stack of ``nn.Linear`` layers,
whose weight is (out, in), so a JAX ``w`` is transposed on load.

The normalisations, activations and rotary embedding follow the JAX
functions' dtypes step for step: a norm reduces in float32 and scales in
the input's dtype, RoPE multiplies a bfloat16 input by float32 tables in
float32 and rounds once.
"""
from __future__ import annotations

import contextvars
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..distributed.sharding import current_context


# a function of each new `uniform_init` leaf to what its caller keeps of it
# (`distributed.parallel.init_shards`: the rank's shard, so that a sharded
# init holds one full leaf at a time); None keeps the leaf
LEAF_HOOK: contextvars.ContextVar = contextvars.ContextVar("leaf_hook",
                                                           default=None)


def uniform_init(shape, scale: float | None = None, *, lead: tuple = (),
                 dtype=torch.float32, generator: torch.Generator | None = None,
                 device=None) -> torch.Tensor:
    """LeCun-ish uniform init in ``[-s, s]``; ``s`` defaults to
    ``1 / sqrt(fan_in)`` with ``fan_in = shape[0]`` (the JAX layout's input
    axis).  ``lead`` axes stack copies of ``shape`` (the transformer's
    (groups, period) of layers).  Filled in place on ``device`` from
    ``generator``, so a table of tens of GB needs no second copy."""
    fan_in = shape[0] if len(shape) > 1 else 1
    s = scale if scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
    out = torch.empty(tuple(lead) + tuple(shape), dtype=dtype, device=device)
    out.uniform_(-s, s, generator=generator)
    hook = LEAF_HOOK.get()
    return out if hook is None else hook(out)


class MLP(nn.Module):
    """``mlp_apply``: Linear layers with ReLU between them, and after the
    last one too when ``final_relu``."""

    def __init__(self, sizes, *, final_relu: bool = False,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.layers = nn.ModuleList(
            nn.Linear(a, b, dtype=dtype, device=device)
            for a, b in zip(sizes[:-1], sizes[1:]))
        self.final_relu = final_relu

    def forward(self, x):
        last = len(self.layers) - 1
        for i, lin in enumerate(self.layers):
            x = F.linear(x, _weight(lin), lin.bias)
            if i < last or self.final_relu:
                x = torch.relu(x)
        return x

    def bf16_forward(self, x):
        """``mlp_apply`` with every weight and bias cast to bfloat16, under
        JAX's promotion: ``x @ w`` runs in ``promote_types(x.dtype,
        bfloat16)`` (a float32 ``x`` meets the rounded weights in float32)
        and is rounded to that dtype before ``+ b``, which rounds again, as
        in JAX (an ``nn.Linear`` would add the bias inside the product)."""
        last = len(self.layers) - 1
        bf = torch.bfloat16
        for i, lin in enumerate(self.layers):
            dt = torch.promote_types(x.dtype, bf)
            w, b = _weight(lin).to(bf).to(dt), lin.bias.to(bf).to(dt)
            x = x.to(dt) @ w.T + b
            if i < last or self.final_relu:
                x = torch.relu(x)
        return x

    def tree(self, leaf=lambda p: p.detach()) -> list:
        """The JAX ``mlp_params`` layout, ``[{"w": (in, out), "b": (out,)}]``,
        of ``leaf(parameter)``: the parameters themselves by default (``w``
        a transposed view of the Linear weight), or what ``leaf`` maps them
        to (their gradients)."""
        return [{"w": leaf(lin.weight).T, "b": leaf(lin.bias)}
                for lin in self.layers]

    @classmethod
    def from_tree(cls, params, sizes, *, final_relu: bool = False) -> "MLP":
        """An MLP of the full ``sizes`` over the tensors of a JAX
        ``mlp_params`` list, sharing their storage (each weight the
        transposed view of its ``w``): in the sharded step the leaves are
        the rank's shards, gathered whole at use (`_weight`)."""
        mlp = cls.__new__(cls)
        nn.Module.__init__(mlp)
        layers = []
        for (a, b), p in zip(zip(sizes[:-1], sizes[1:]), params):
            lin = nn.Linear.__new__(nn.Linear)
            nn.Module.__init__(lin)
            lin.in_features, lin.out_features = a, b
            lin.weight = nn.Parameter(p["w"].T)
            lin.bias = nn.Parameter(p["b"])
            layers.append(lin)
        mlp.layers = nn.ModuleList(layers)
        mlp.final_relu = final_relu
        return mlp

    @torch.no_grad()
    def load_jax(self, params) -> "MLP":
        """Copy a JAX ``mlp_params`` list (``w`` (in, out), ``b`` (out,),
        as tensors) into the layers."""
        if len(params) != len(self.layers):
            raise ValueError(f"{len(params)} JAX layers for "
                             f"{len(self.layers)} Linear layers")
        for lin, p in zip(self.layers, params):
            lin.weight.copy_(p["w"].T)
            lin.bias.copy_(p["b"])
        return self


def _weight(lin: nn.Linear) -> torch.Tensor:
    """``lin``'s weight as its product uses it: in the sharded step the
    rank's shard gathered whole (`ParallelContext.gather_linear`)."""
    ctx = current_context()
    if ctx is None:
        return lin.weight
    return ctx.gather_linear(lin.weight, (lin.out_features, lin.in_features))


def mlp_params(sizes, *, final_relu: bool = False, dtype=torch.float32,
               generator: torch.Generator | None = None,
               device=None) -> MLP:
    """An MLP initialised as ``repro.models.layers.mlp_params``: weights
    uniform in ``1 / sqrt(fan_in)``, biases zero."""
    mlp = MLP(sizes, final_relu=final_relu, dtype=dtype, device=device)
    with torch.no_grad():
        for lin in mlp.layers:
            lin.weight.copy_(uniform_init(
                (lin.in_features, lin.out_features), dtype=dtype,
                generator=generator, device=device).T)
            lin.bias.zero_()
    return mlp


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """``x / rms(x) * weight``: the mean square in float32, the product
    ``x * rsqrt`` in float32 rounded to ``x``'s dtype, then scaled by
    ``weight`` in that dtype."""
    var = torch.mean(torch.square(x.float()), dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(x.dtype) * weight


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * weight + bias


def squared_relu(x: torch.Tensor) -> torch.Tensor:
    r = torch.relu(x)
    return r * r


def _const(c: float, x: torch.Tensor) -> torch.Tensor:
    """The constant ``c`` rounded to ``x``'s dtype, as JAX rounds a
    constant of a bfloat16 expression (a 0-d CPU tensor: a scalar to a
    CUDA product, no copy)."""
    return torch.tensor(c, dtype=x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``, ``x * sigmoid(x)`` with the sigmoid as JAX lowers
    it, ``1 / (1 + exp(-x))``, every step rounded to ``x``'s dtype
    (``F.silu`` rounds once: 40% of bfloat16 outputs differ)."""
    return x * (1 / (1 + torch.exp(-x)))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (its default tanh approximation), step for step in
    ``x``'s dtype with its constants rounded to that dtype."""
    inner = _const(math.sqrt(2 / math.pi), x) * (
        x + _const(0.044715, x) * (x * x * x))
    return x * (_const(0.5, x) * (1 + torch.tanh(inner)))


ACTIVATIONS = {
    "relu": torch.relu,
    "gelu": gelu,
    "silu": silu,
    "sq_relu": squared_relu,
}


def rope_freqs(head_dim: int, max_pos: int, theta: float = 10000.0, *,
               device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(max_pos, head_dim // 2) float32 cos/sin tables, computed in float64
    numpy and rounded once, as in JAX (row t depends on t alone, so a
    shorter table is a prefix of a longer one)."""
    inv = 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))
    f = np.outer(np.arange(max_pos), inv)
    return (torch.from_numpy(np.cos(f).astype(np.float32)).to(device),
            torch.from_numpy(np.sin(f).astype(np.float32)).to(device))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S).  A bfloat16
    ``x`` meets the float32 tables in float32 and is rounded once."""
    c = cos[positions][..., None, :]             # (..., S, 1, D/2)
    s = sin[positions][..., None, :]
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s],
                     dim=-1).to(x.dtype)
