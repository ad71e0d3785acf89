"""Architecture registry of the port: the counterpart of
``repro.configs.registry`` for the archs ported so far.

Each arch module registers an ArchSpec; ``get_arch(id)`` resolves through
here.  The ported archs are the recsys models ``dlrm-mlperf``,
``wide-deep`` and ``mind``, for serving, training and candidate scoring.
BERT4Rec and the LM and GNN families are not ported; ``ROADMAP.md`` lists
them.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

RECSYS_SHAPES = {
    "train_batch": {"kind": "rs_train", "batch": 65536},
    "serve_p99": {"kind": "rs_serve", "batch": 512},
    "serve_bulk": {"kind": "rs_serve", "batch": 262144},
    "retrieval_cand": {"kind": "rs_retrieval", "batch": 1,
                       "n_candidates": 1_000_000},
}


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    make_config: Callable          # (shape_name: str, reduced: bool) -> model cfg
    source: str                    # citation of the published config

    @property
    def shapes(self) -> dict:
        return RECSYS_SHAPES       # the only family ported


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


_LOADED = False


def _ensure_loaded():
    global _LOADED
    if _LOADED:
        return
    _LOADED = True
    from . import dlrm_mlperf, mind, wide_deep  # noqa: F401
