"""bert4rec [recsys]: embed_dim=64 n_blocks=2 n_heads=2 seq_len=200
interaction=bidir-seq.  [arXiv:1904.06690]

Item vocab 10^6 (matches the retrieval_cand cell).
"""
from __future__ import annotations

from ..models.recsys import Bert4RecConfig
from .registry import ArchSpec, register


def make_config(shape_name: str, reduced: bool = False) -> Bert4RecConfig:
    if reduced:
        return Bert4RecConfig(name="bert4rec/reduced", n_items=512,
                              embed_dim=16, n_blocks=2, n_heads=2,
                              seq_len=16, n_neg=32)
    return Bert4RecConfig(name="bert4rec", n_items=1_000_000, embed_dim=64,
                          n_blocks=2, n_heads=2, seq_len=200, n_neg=1024)


register(ArchSpec(
    arch_id="bert4rec", family="recsys", make_config=make_config,
    source="arXiv:1904.06690 (paper)",
))
