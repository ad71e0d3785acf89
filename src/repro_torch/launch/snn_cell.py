"""Pod-scale SNN service cell: the paper's own workload, a count batch over
a database sharded across the dp ranks.

The counterpart of ``repro.launch.snn_cell``.  The sorted database is
sharded contiguously over the dp axis (rank k holds sorted rows
``[k n/D, (k+1) n/D)``, `core.sharded.shard_index`); queries are
replicated; each rank counts its own shard, and one ``all_reduce`` per dp
axis sums the counts.

The step is one launch of the stacked count kernel (`kernels.registry.
snn_count_stacked`) over the shard's ``n_chunk``-row slabs, a
(n/n_chunk, n_chunk, d_pad) stack read in place, with the per-slab counts
summed on the device.  The kernel skips every 128 x 128 tile whose rows no
query window of the tile meets, so the step sorts the queries by alpha
first: a tile of alpha-adjacent queries spans a narrow window.  Two
variants share one signature:

* ``prune=False``, brute force 2 of the paper: the distance test over ALL
  rows (the window radius is +inf, which every row and every tile meets);
* ``prune=True``: the same test inside the alpha window.

``measured_window_fraction`` is the fraction of rows the window keeps on
sampled data of the cell's distribution (the paper's Section 5 elongated
Gaussian), the share of the brute-force work the pruned step can skip.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import registry as _registry

SNN_SHAPES = {
    # n rows, d features, m queries, radius; data model = the paper's §5
    # elongated Gaussian (std [1, s, ..., s], s=0.1) where sorted-window
    # pruning is effective.  (Isotropic uniform data at d=128 gives window
    # fraction ~1.0 — the paper's own high-d caveat; measured and recorded.)
    # n is a multiple of 256 devices x 65536-row scan chunks.
    "svc_10m": {"n": 160 * 65536, "d": 128, "m": 1024, "radius": 0.5,
                "aniso_s": 0.1},
    "svc_100m": {"n": 1536 * 65536, "d": 128, "m": 1024, "radius": 0.5,
                 "aniso_s": 0.1},
}

_LANE = 128


def _block(n_chunk: int) -> int:
    """The count kernel's row block for ``n_chunk``-row slabs: 512 where it
    divides them, else the 128-row tile."""
    return 512 if n_chunk % 512 == 0 else 128


def make_service_count_step(mesh, dp, *, q_chunk: int = 128,
                            n_chunk: int = 65536, prune: bool = True):
    """Returns step(xs, alphas, half_norms, q, aq, r, thresh) -> (m,) int32
    counts over the whole database.

    ``xs`` (n, d), ``alphas`` and ``half_norms`` (n,) are this rank's
    contiguous shard (n a multiple of ``n_chunk``); ``q`` (m, d), ``aq``,
    ``r`` and ``thresh`` (m,) the replicated query predicates (m a
    multiple of ``q_chunk``), on the shard's device.  ``dp`` is the mesh
    axis, or tuple of axes, the database is sharded over; the counts are
    summed by one ``all_reduce`` over each of its groups.  ``mesh=None``
    is a database held whole by one process: no collective.
    """
    import torch.distributed as dist

    groups = ([] if mesh is None
              else [mesh.get_group(a) for a in
                    (dp if isinstance(dp, tuple) else (dp,))])

    def step(xs, alphas, half_norms, q, aq, r, thresh):
        n, d = xs.shape                    # LOCAL shard
        m = q.shape[0]
        if n % n_chunk or m % q_chunk:
            raise ValueError(f"shard rows {n} must be a multiple of "
                             f"n_chunk={n_chunk} and queries {m} of "
                             f"q_chunk={q_chunk}")
        dpad = (-d) % _LANE
        if dpad:
            xs, q = F.pad(xs, (0, dpad)), F.pad(q, (0, dpad))
        if not prune:
            r = torch.full_like(r, float("inf"))
        # alpha-adjacent queries share tiles, whose windows then stay narrow
        perm = torch.argsort(aq, stable=True)
        per = _registry.snn_count_stacked(
            q[perm].contiguous(), aq[perm].contiguous(),
            r[perm].contiguous(), thresh[perm].contiguous(),
            xs.reshape(n // n_chunk, n_chunk, d + dpad),
            alphas.reshape(n // n_chunk, n_chunk),
            half_norms.reshape(n // n_chunk, n_chunk), bn=_block(n_chunk))
        local = torch.empty(m, dtype=torch.int32, device=xs.device)
        local[perm] = per.sum(dim=0, dtype=torch.int32)
        for g in groups:
            dist.all_reduce(local, op=dist.ReduceOp.SUM, group=g)
        return local

    return step


def build_service_step(shape_name: str, *, multi_pod: bool = False,
                       prune: bool = True, mesh=None):
    """Returns (fn, arg_specs, model_flops, meta).

    ``arg_specs`` are the (shape, dtype) of each argument of ``fn`` on one
    rank: the local shard of n/D rows (D the dp ranks of ``mesh``, 1
    without one) and the replicated queries.  ``model_flops`` counts the
    useful work of the whole batch: the half-norm GEMM over every row
    (2*m*n*d) and the compares (2*m*n).
    """
    from ..core.sharded import _axis_size

    sh = SNN_SHAPES[shape_name]
    n, d, m = sh["n"], sh["d"], sh["m"]
    dp = ("pod", "data") if multi_pod else "data"
    n_local = n // (1 if mesh is None else _axis_size(mesh, dp))
    f32 = torch.float32
    specs = (
        ((n_local, d), f32),     # xs (sorted), this rank's rows
        ((n_local,), f32),       # alphas
        ((n_local,), f32),       # half norms
        ((m, d), f32),           # queries
        ((m,), f32),             # aq
        ((m,), f32),             # r
        ((m,), f32),             # thresh
    )
    fn = make_service_count_step(mesh, dp, prune=prune)
    model_flops = 2.0 * m * n * d + 2.0 * m * n
    return fn, specs, model_flops, sh


def measured_window_fraction(d: int, radius: float, n_sample: int = 200_000,
                             m: int = 256, seed: int = 0,
                             aniso_s: float | None = None,
                             device=None) -> float:
    """Empirical sorted-window fraction at this (d, R): the mean share of
    the rows inside a query's alpha window, on an index built on
    ``device`` (default: the card).  ``aniso_s`` selects the paper's §5
    elongated-Gaussian model (std [1, s, ..., s]); None = uniform."""
    from ..core import snn as _snn

    rng = np.random.default_rng(seed)
    if aniso_s is None:
        x = rng.random((n_sample, d)).astype(np.float32)
        q = rng.random((m, d)).astype(np.float32)
    else:
        scale = np.array([1.0] + [aniso_s] * (d - 1), np.float32)
        x = (rng.normal(size=(n_sample, d)) * scale).astype(np.float32)
        q = (rng.normal(size=(m, d)) * scale).astype(np.float32)
    index = _snn.build_index(x, device=_registry.resolve_device(device))
    xq, r = index.prepare_queries(q, radius)
    aq = xq @ index.v1
    alphas = index.host_alphas()
    lo = np.searchsorted(alphas, aq - r)
    hi = np.searchsorted(alphas, aq + r)
    return float(np.mean(hi - lo) / n_sample)

