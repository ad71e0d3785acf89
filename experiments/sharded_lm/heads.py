"""The head override of `run.py` and `serve.py`: an LM's published config
with another number of query heads (MLA: MLA heads) and, for GQA, of KV
heads, so that a "model" axis of four cards can show the layout of heads
it does not divide (the published 40 heads divide 4).  Imports no JAX.
"""
from __future__ import annotations

import dataclasses

from repro_torch.launch import steps


def head_override(arch: str, heads: int | None,
                  kv_heads: int | None = None, reduced: bool = False) -> dict:
    """``cfg_override`` fields for ``heads`` query heads over ``kv_heads``
    KV heads (GQA; default: the config's), or {} without ``heads``; of
    the reduced config with ``reduced``."""
    if not heads:
        return {}
    cfg = steps.get_arch(arch).make_config("train_4k", reduced)
    if cfg.mla is not None:
        return {"n_heads": heads, "n_kv_heads": heads,
                "mla": dataclasses.replace(cfg.mla, n_heads=heads)}
    return {"n_heads": heads, "n_kv_heads": kv_heads or cfg.n_kv_heads}


def described(over: dict) -> dict:
    """The override as JSON fields."""
    return {k: v for k, v in over.items() if k in ("n_heads", "n_kv_heads")}
