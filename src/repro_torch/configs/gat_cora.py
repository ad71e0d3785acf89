"""gat-cora [gnn]: n_layers=2 d_hidden=8 n_heads=8 aggregator=attn.
[arXiv:1710.10903]

d_in / n_classes are shape-dependent (cora / reddit-minibatch / ogb-products /
molecule) — the GAT block itself is the assigned 2-layer, 8-head config.
"""
from __future__ import annotations

from ..models.gnn import GATConfig
from .registry import GNN_SHAPES, ArchSpec, register


def make_config(shape_name: str, reduced: bool = False) -> GATConfig:
    sh = GNN_SHAPES[shape_name]
    if reduced:
        return GATConfig(name="gat-cora/reduced", d_in=16, d_hidden=4,
                         n_heads=2, n_classes=3,
                         graph_pool=(sh["kind"] == "gnn_batched"))
    return GATConfig(
        name="gat-cora", d_in=sh["d_feat"], d_hidden=8, n_heads=8,
        n_classes=sh["n_classes"], n_layers=2,
        graph_pool=(sh["kind"] == "gnn_batched"))


register(ArchSpec(
    arch_id="gat-cora", family="gnn", make_config=make_config,
    source="arXiv:1710.10903 (paper)",
))
