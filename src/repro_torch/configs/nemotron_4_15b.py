"""nemotron-4-15b [dense]: 32L d_model=6144 48H (GQA kv=8) d_ff=24576
vocab=256000 — GQA, squared-ReLU, ungated FFN.  [arXiv:2402.16819]"""
from __future__ import annotations

import torch

from ..models.transformer import TransformerConfig
from .registry import ArchSpec, register


def make_config(shape_name: str, reduced: bool = False) -> TransformerConfig:
    if reduced:
        return TransformerConfig(
            name="nemotron-4-15b/reduced", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, head_dim=16, d_ff=256, vocab=512,
            act="sq_relu", gated_ffn=False, max_seq=128, remat=False)
    long = shape_name in ("prefill_32k", "decode_32k", "long_500k")
    return TransformerConfig(
        name="nemotron-4-15b", n_layers=32, d_model=6144, n_heads=48,
        n_kv_heads=8, head_dim=128, d_ff=24576, vocab=256000,
        act="sq_relu", gated_ffn=False, rope_theta=10000.0,
        max_seq=32768 if long else 4096,
        chunk_q={"train_4k": 1024, "prefill_32k": 2048}.get(shape_name),
        xent_chunk=16384, dtype=torch.bfloat16, param_dtype=torch.float32)


register(ArchSpec(
    arch_id="nemotron-4-15b", family="lm", make_config=make_config,
    source="arXiv:2402.16819 (unverified)",
    skip_shapes={"long_500k": "pure full-attention arch; long_500k needs "
                 "sub-quadratic attention (DESIGN.md §Skipped cells)"},
))
