"""The paper's own configuration: SNN index/query + serving defaults.

SNN has no hyperparameters besides the radius (paper §1); everything here is
tiling for the kernels and service defaults.  The reference's ``backend``
field is gone: the port has one dispatch rule (CUDA tensors to the kernels,
CPU tensors to their plain versions, `kernels.registry`) and no lane to
choose, so nothing here selects one.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SNNConfig:
    metric: str = "euclidean"
    power_iters: int = 64           # v1 power iteration (exactness-independent)
    block_rows: int = 512           # kernels' db-block (bn)
    query_tile: int = 128           # kernels' query tile (tq)
    batch_group: int = 64           # host-path level-3 BLAS query grouping
    max_neighbors: int = 1024       # fixed-shape result cap (serve_exact=False)
    serve_batch: int = 256          # dynamic batching target
    serve_timeout_ms: float = 2.0   # batching window (serve_policy="window")
    serve_policy: str = "deadline"  # admission loop: "deadline" fuses queued
                                    # arrivals until the oldest request's SLO
                                    # budget (minus the measured service-time
                                    # EWMA) forces a flush — light load
                                    # flushes immediately, heavy load fills
                                    # serve_batch; "window" restores the
                                    # fixed serve_timeout_ms batching window
    serve_slo_ms: float = 50.0      # default per-request SLO budget
                                    # (Request.slo_ms overrides per request)
    serve_ewma: float = 0.3         # smoothing factor for the per-batch
                                    # service-time EWMA the deadline policy
                                    # subtracts from the remaining budget
    serve_warm_plans: bool = True   # double-buffered plan epochs: append/
                                    # rebuild builds AND warms the next
                                    # generation's SegmentPack on the mutator
                                    # thread (zero-match priming dispatch)
                                    # before the atomic swap, so the serving
                                    # thread never pays plan construction
    registry_memory_mb: float = 512.0  # device-memory budget for the multi-
                                    # tenant plan cache (IndexRegistry):
                                    # cold tenants' plans are LRU-evicted
                                    # past it (MemoryPlan-accounted bytes)
                                    # and rebuilt bit-identically on
                                    # re-admission
    serve_exact: bool = True        # two-pass CSR engine (exact, untruncated);
                                    # False restores the fixed-shape top-K path
    serve_packed: bool = True       # execute the cached SegmentPack plan (one
                                    # stacked launch per pass, plan reused
                                    # across requests of an index generation);
                                    # False loops one launch per segment
    serve_bucket: bool = True       # pad serving batches onto the geometric
                                    # query ladder (ops.bucket_rows): dynamic
                                    # batch sizes see O(log m) launch shapes
                                    # and memory plans instead of one a size
    serve_count_pass: bool = True   # answer an all-count batch with the
                                    # count-only executor (engine pass 1,
                                    # no compact pass / no CSR staging);
                                    # False folds counts into the CSR
                                    # dispatch like mixed batches do
    # streaming (LSM) index: appends become sorted delta segments on frozen
    # mu/v1; deltas merge into the base past delta_merge_ratio × base rows or
    # max_delta_segments; a full re-index (fresh mu/v1/xi) only happens once
    # the database grows rebuild_ratio × beyond its last full build
    delta_merge_ratio: float = 0.25
    max_delta_segments: int = 4
    rebuild_ratio: float = 4.0


DEFAULT = SNNConfig()
