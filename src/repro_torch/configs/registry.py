"""Architecture registry of the port: the counterpart of
``repro.configs.registry``, its 10 archs and their shape sets (40 cells).

Each arch module registers an ArchSpec; ``get_arch(id)`` resolves through
here: the five LMs (training ``train_4k``, serving ``prefill_32k``,
``decode_32k``, ``long_500k``), the GAT family (``gat-cora``: four graph
regimes, each a training shape) and the recsys models ``dlrm-mlperf``,
``wide-deep``, ``mind`` and ``bert4rec`` (training, serving, candidate
scoring).  Skipped cells carry the reference's reasons.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

LM_SHAPES = {
    "train_4k": {"kind": "train", "seq_len": 4096, "global_batch": 256},
    "prefill_32k": {"kind": "prefill", "seq_len": 32768, "global_batch": 32},
    "decode_32k": {"kind": "decode", "seq_len": 32768, "global_batch": 128},
    "long_500k": {"kind": "decode", "seq_len": 524288, "global_batch": 1},
}

GNN_SHAPES = {
    "full_graph_sm": {"kind": "gnn_full", "n_nodes": 2708, "n_edges": 10556,
                      "d_feat": 1433, "n_classes": 7},
    "minibatch_lg": {"kind": "gnn_minibatch", "n_nodes": 232965,
                     "n_edges": 114615892, "batch_nodes": 1024,
                     "fanout": (15, 10), "d_feat": 602, "n_classes": 41},
    "ogb_products": {"kind": "gnn_full", "n_nodes": 2449029,
                     "n_edges": 61859140, "d_feat": 100, "n_classes": 47},
    "molecule": {"kind": "gnn_batched", "n_nodes": 30, "n_edges": 64,
                 "batch": 128, "d_feat": 64, "n_classes": 10},
}

RECSYS_SHAPES = {
    "train_batch": {"kind": "rs_train", "batch": 65536},
    "serve_p99": {"kind": "rs_serve", "batch": 512},
    "serve_bulk": {"kind": "rs_serve", "batch": 262144},
    "retrieval_cand": {"kind": "rs_retrieval", "batch": 1,
                       "n_candidates": 1_000_000},
}

FAMILY_SHAPES = {"lm": LM_SHAPES, "gnn": GNN_SHAPES, "recsys": RECSYS_SHAPES}


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str                    # 'lm' | 'gnn' | 'recsys'
    make_config: Callable          # (shape_name: str, reduced: bool) -> model cfg
    source: str                    # citation of the published config
    skip_shapes: dict = dataclasses.field(default_factory=dict)

    @property
    def shapes(self) -> dict:
        return FAMILY_SHAPES[self.family]

    def runnable_shapes(self) -> list[str]:
        return [s for s in self.shapes if s not in self.skip_shapes]


_REGISTRY: dict[str, ArchSpec] = {}


def register(spec: ArchSpec) -> ArchSpec:
    _REGISTRY[spec.arch_id] = spec
    return spec


def get_arch(arch_id: str) -> ArchSpec:
    _ensure_loaded()
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[arch_id]


def list_archs() -> list[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


def all_cells(include_skipped: bool = False):
    """Yield (arch_id, shape_name, skip reason or None) for every cell
    (the skipped ones only with ``include_skipped``)."""
    _ensure_loaded()
    for aid in sorted(_REGISTRY):
        spec = _REGISTRY[aid]
        for shape in spec.shapes:
            if shape in spec.skip_shapes:
                if include_skipped:
                    yield aid, shape, spec.skip_shapes[shape]
            else:
                yield aid, shape, None


_LOADED = False


def _ensure_loaded():
    global _LOADED
    if _LOADED:
        return
    _LOADED = True
    from . import (bert4rec, dlrm_mlperf, gat_cora,  # noqa: F401
                   internlm2_20b, llama4_scout_17b_a16e, mind, minicpm3_4b,
                   nemotron_4_15b, qwen3_moe_235b_a22b, wide_deep)
