"""mind [recsys]: embed_dim=64 n_interests=4 capsule_iters=3
interaction=multi-interest.  [arXiv:1904.08030]

Item vocab 10^6 (matches the retrieval_cand cell); history length 50.
"""
from __future__ import annotations

from ..models.recsys import MINDConfig
from .registry import ArchSpec, register


def make_config(shape_name: str, reduced: bool = False) -> MINDConfig:
    if reduced:
        return MINDConfig(name="mind/reduced", n_items=512, embed_dim=16,
                          n_interests=2, capsule_iters=2, hist_len=10, n_neg=32)
    return MINDConfig(name="mind", n_items=1_000_000, embed_dim=64,
                      n_interests=4, capsule_iters=3, hist_len=50, n_neg=1024)


register(ArchSpec(
    arch_id="mind", family="recsys", make_config=make_config,
    source="arXiv:1904.08030 (unverified)",
))
