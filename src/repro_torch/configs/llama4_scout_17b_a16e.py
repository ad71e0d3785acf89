"""llama4-scout-17b-a16e [moe]: 48L d_model=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 16e top-1 + 1 shared expert; iRoPE chunked-local attention
(3 local layers then 1 global NoPE layer, chunk 8192).
[hf:meta-llama/Llama-4-Scout-17B-16E]

Runs long_500k: the published arch is chunked-local (sub-quadratic), so the
long-context decode cell is supported.
"""
from __future__ import annotations

import torch

from ..models.moe import MoEConfig
from ..models.transformer import TransformerConfig
from .registry import ArchSpec, register


def make_config(shape_name: str, reduced: bool = False) -> TransformerConfig:
    if reduced:
        return TransformerConfig(
            name="llama4-scout/reduced", n_layers=4, d_model=64, n_heads=4,
            n_kv_heads=2, head_dim=16, d_ff=128, vocab=512,
            moe=MoEConfig(n_experts=4, top_k=1, d_model=64, d_ff=128,
                          n_shared_experts=1, renorm_topk=False),
            layer_pattern=("local", "local", "local", "global_nope"),
            local_window=16, max_seq=128, remat=False)
    long = shape_name in ("prefill_32k", "decode_32k")
    max_seq = 524288 if shape_name == "long_500k" else (32768 if long else 4096)
    return TransformerConfig(
        name="llama4-scout-17b-a16e", n_layers=48, d_model=5120, n_heads=40,
        n_kv_heads=8, head_dim=128, d_ff=8192, vocab=202048,
        moe=MoEConfig(n_experts=16, top_k=1, d_model=5120, d_ff=8192,
                      n_shared_experts=1, renorm_topk=False),
        act="silu", gated_ffn=True, rope_theta=500000.0,
        layer_pattern=("local", "local", "local", "global_nope"),
        local_window=8192, max_seq=max_seq,
        chunk_q={"train_4k": 1024, "prefill_32k": 2048}.get(shape_name),
        xent_chunk=16384, dtype=torch.bfloat16, param_dtype=torch.float32)


register(ArchSpec(
    arch_id="llama4-scout-17b-a16e", family="lm", make_config=make_config,
    source="hf:meta-llama/Llama-4-Scout-17B-16E (unverified)",
))
