"""qwen3-moe-235b-a22b [moe]: 94L d_model=4096 64H (GQA kv=4) per-expert
d_ff=1536, vocab=151936, MoE 128e top-8 (norm_topk_prob).  [hf:Qwen/Qwen3-*]"""
from __future__ import annotations

import torch

from ..models.moe import MoEConfig
from ..models.transformer import TransformerConfig
from .registry import ArchSpec, register


def make_config(shape_name: str, reduced: bool = False) -> TransformerConfig:
    if reduced:
        return TransformerConfig(
            name="qwen3-moe/reduced", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, head_dim=16, d_ff=128, vocab=512,
            moe=MoEConfig(n_experts=8, top_k=2, d_model=64, d_ff=32),
            max_seq=128, remat=False)
    long = shape_name in ("prefill_32k", "decode_32k", "long_500k")
    return TransformerConfig(
        name="qwen3-moe-235b-a22b", n_layers=94, d_model=4096, n_heads=64,
        n_kv_heads=4, head_dim=128, d_ff=1536, vocab=151936,
        moe=MoEConfig(n_experts=128, top_k=8, d_model=4096, d_ff=1536,
                      renorm_topk=True),
        act="silu", gated_ffn=True, rope_theta=1000000.0,
        max_seq=32768 if long else 4096,
        chunk_q={"train_4k": 1024, "prefill_32k": 2048}.get(shape_name),
        xent_chunk=16384, dtype=torch.bfloat16, param_dtype=torch.float32)


register(ArchSpec(
    arch_id="qwen3-moe-235b-a22b", family="lm", make_config=make_config,
    source="hf:Qwen/Qwen3-235B-A22B (hf)",
    skip_shapes={"long_500k": "pure full-attention arch; see DESIGN.md "
                 "§Skipped cells"},
))
