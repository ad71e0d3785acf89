"""minicpm3-4b [dense]: 62L d_model=2560 40H d_ff=6400 vocab=73448 — MLA
(q_lora=768, kv_lora=256, qk_nope=64, qk_rope=32, v_head=64).
[hf:openbmb/MiniCPM3-4B]"""
from __future__ import annotations

import torch

from ..models.attention import MLADims
from ..models.transformer import TransformerConfig
from .registry import ArchSpec, register


def make_config(shape_name: str, reduced: bool = False) -> TransformerConfig:
    if reduced:
        return TransformerConfig(
            name="minicpm3-4b/reduced", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=4, head_dim=16, d_ff=128, vocab=512, attn="mla",
            mla=MLADims(n_heads=4, q_lora=32, kv_lora=16, qk_nope=8,
                        qk_rope=8, v_head=16),
            max_seq=128, remat=False)
    long = shape_name in ("prefill_32k", "decode_32k", "long_500k")
    # vocab 73448 padded to 73472 (/64) for clean TP sharding of embed/lm_head
    # (standard practice; padded ids never occur in data).
    return TransformerConfig(
        name="minicpm3-4b", n_layers=62, d_model=2560, n_heads=40,
        n_kv_heads=40, head_dim=64, d_ff=6400, vocab=73472, attn="mla",
        mla=MLADims(n_heads=40, q_lora=768, kv_lora=256, qk_nope=64,
                    qk_rope=32, v_head=64),
        act="silu", gated_ffn=True, rope_theta=10000.0,
        max_seq=32768 if long else 4096,
        chunk_q={"train_4k": 1024, "prefill_32k": 2048}.get(shape_name),
        xent_chunk=16384, dtype=torch.bfloat16, param_dtype=torch.float32)


register(ArchSpec(
    arch_id="minicpm3-4b", family="lm", make_config=make_config,
    source="hf:openbmb/MiniCPM3-4B",
    skip_shapes={"long_500k": "pure full-attention arch (MLA is full softmax "
                 "attention); see DESIGN.md §Skipped cells"},
))
