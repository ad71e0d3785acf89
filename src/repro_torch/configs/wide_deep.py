"""wide-deep [recsys]: n_sparse=40 embed_dim=32 mlp=1024-512-256
interaction=concat.  [arXiv:1606.07792]

Per-field vocab is not fixed by the paper; 10^5 hashed buckets per field
(4M stacked rows), a typical production hashing setup.
"""
from __future__ import annotations

from ..models.recsys import WideDeepConfig
from .registry import ArchSpec, register


def make_config(shape_name: str, reduced: bool = False) -> WideDeepConfig:
    if reduced:
        return WideDeepConfig(name="wide-deep/reduced",
                              vocab_sizes=tuple([64] * 4), n_dense=13,
                              embed_dim=8, deep_mlp=(32, 16))
    return WideDeepConfig(
        name="wide-deep", vocab_sizes=tuple([100_000] * 40), n_dense=13,
        embed_dim=32, deep_mlp=(1024, 512, 256))


register(ArchSpec(
    arch_id="wide-deep", family="recsys", make_config=make_config,
    source="arXiv:1606.07792 (paper)",
))
