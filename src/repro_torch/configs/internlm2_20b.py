"""internlm2-20b [dense]: 48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92544 — GQA, SwiGLU.  [arXiv:2403.17297]"""
from __future__ import annotations

import torch

from ..models.transformer import TransformerConfig
from .registry import ArchSpec, register


def make_config(shape_name: str, reduced: bool = False) -> TransformerConfig:
    if reduced:
        return TransformerConfig(
            name="internlm2-20b/reduced", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, head_dim=16, d_ff=128, vocab=512, max_seq=128,
            remat=False)
    long = shape_name in ("prefill_32k", "decode_32k", "long_500k")
    return TransformerConfig(
        name="internlm2-20b", n_layers=48, d_model=6144, n_heads=48,
        n_kv_heads=8, head_dim=128, d_ff=16384, vocab=92544,
        act="silu", gated_ffn=True, rope_theta=1000000.0,
        max_seq=32768 if long else 4096,
        chunk_q={"train_4k": 1024, "prefill_32k": 2048}.get(shape_name),
        xent_chunk=16384, dtype=torch.bfloat16, param_dtype=torch.float32)


register(ArchSpec(
    arch_id="internlm2-20b", family="lm", make_config=make_config,
    source="arXiv:2403.17297 (hf)",
    skip_shapes={"long_500k": "pure full-attention arch; see DESIGN.md "
                 "§Skipped cells"},
))
