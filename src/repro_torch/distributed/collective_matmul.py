"""Compute/communication overlap: the ring collective matmul, the
counterpart of ``repro.distributed.collective_matmul``.

``ring_allgather_matmul(x_local, w, mesh)`` computes ``all_gather(x) @ w``
over a mesh axis without materialising the gathered x: at each of the n
steps a rank multiplies the chunk it holds while the chunk travels on to
the next rank of the ring (``batch_isend_irecv``, posted before the
product, so the transfer of step i overlaps its product).  The chunk a
rank holds at step i is global shard ``(idx - i) % n``, as in the
reference's ``_ring_body``.  A ring of one rank moves nothing.
"""
from __future__ import annotations

import torch


def ring_allgather_matmul(x_local, w, mesh, axis: str = "model"):
    """``x_local``: this rank's (M / n, K) row shard of x over ``axis`` of
    ``mesh`` (a `DeviceMesh`); ``w``: (K, N), the same on every rank.
    Returns the (M, N) product ``x @ w``, the same on every rank."""
    import torch.distributed as dist

    group = mesh.get_group(axis)
    n = dist.get_world_size(group)
    idx = dist.get_rank(group)
    nxt = dist.get_global_rank(group, (idx + 1) % n)
    prv = dist.get_global_rank(group, (idx - 1) % n)
    rows = x_local.shape[0]
    acc = torch.empty((rows * n, w.shape[-1]), dtype=x_local.dtype,
                      device=x_local.device)
    chunk = x_local.contiguous()
    for i in range(n):
        src = (idx - i) % n
        reqs = []
        if n > 1:
            incoming = torch.empty_like(chunk)
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, chunk, nxt, group=group),
                dist.P2POp(dist.irecv, incoming, prv, group=group)])
        torch.matmul(chunk, w, out=acc[src * rows:(src + 1) * rows])
        for r in reqs:
            r.wait()
        if reqs:
            chunk = incoming
    return acc


def reference_allgather_matmul(x, w):
    return x @ w
