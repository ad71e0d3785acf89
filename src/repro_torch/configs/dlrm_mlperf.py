"""dlrm-mlperf [recsys]: n_dense=13 n_sparse=26 embed_dim=128
bot=13-512-256-128 top=1024-1024-512-256-1 interaction=dot — MLPerf DLRM
(Criteo 1TB table cardinalities).  [arXiv:1906.00091]"""
from __future__ import annotations

from ..models.recsys import DLRMConfig
from .registry import ArchSpec, register

# Criteo Terabyte per-table cardinalities (MLPerf DLRM benchmark).
CRITEO_TB_VOCAB = (
    39884406, 39043, 17289, 7420, 20263, 3, 7120, 1543, 63, 38532951,
    2953546, 403346, 10, 2208, 11938, 155, 4, 976, 14, 39979771,
    25641295, 39664984, 585935, 12972, 108, 36,
)


def make_config(shape_name: str, reduced: bool = False) -> DLRMConfig:
    if reduced:
        return DLRMConfig(name="dlrm-mlperf/reduced",
                          vocab_sizes=(64, 32, 128, 16), n_dense=13,
                          embed_dim=16, bot_mlp=(32, 16), top_mlp=(32, 1))
    return DLRMConfig(
        name="dlrm-mlperf", vocab_sizes=CRITEO_TB_VOCAB, n_dense=13,
        embed_dim=128, bot_mlp=(512, 256, 128),
        top_mlp=(1024, 1024, 512, 256, 1))


register(ArchSpec(
    arch_id="dlrm-mlperf", family="recsys", make_config=make_config,
    source="arXiv:1906.00091 (paper; MLPerf config)",
))
