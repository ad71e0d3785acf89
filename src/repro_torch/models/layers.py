"""Neural-net building blocks of the port: the counterpart of the parts of
``repro.models.layers`` the recsys models need.

The JAX package keeps an MLP as a list of ``{"w": (in, out), "b": (out,)}``
dicts applied as ``x @ w + b``; here it is a stack of ``nn.Linear`` layers,
whose weight is (out, in), so a JAX ``w`` is transposed on load.
"""
from __future__ import annotations

import math

import torch
from torch import nn


def uniform_init(shape, scale: float | None = None, *,
                 dtype=torch.float32, generator: torch.Generator | None = None,
                 device=None) -> torch.Tensor:
    """LeCun-ish uniform init in ``[-s, s]``; ``s`` defaults to
    ``1 / sqrt(fan_in)`` with ``fan_in = shape[0]`` (the JAX layout's input
    axis).  Filled in place on ``device`` from ``generator``, so a table of
    tens of GB needs no second copy."""
    fan_in = shape[0] if len(shape) > 1 else 1
    s = scale if scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
    out = torch.empty(tuple(shape), dtype=dtype, device=device)
    return out.uniform_(-s, s, generator=generator)


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
            x = lin(x)
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
            w, b = lin.weight.to(bf).to(dt), lin.bias.to(bf).to(dt)
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
