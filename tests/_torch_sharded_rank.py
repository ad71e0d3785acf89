"""One rank of the port's sharded SNN over gloo, for tests/test_torch_sharded.py.

    python tests/_torch_sharded_rank.py RANK WORLD DIR

Joins a process group of WORLD ranks through the file store ``DIR/store``,
takes the index arrays and queries of ``DIR/inputs.npz`` (built by the JAX
package in the test), and runs on its shard: the count, percount and top-k
functions of ``repro_torch.core.sharded`` on a (data, model) host mesh, the
same over the "data" axis of a (pod, data, model) mesh, and the service
step of ``repro_torch.launch.snn_cell`` for both ``prune`` values over
"data" and over ("pod", "data").  Rank 0 writes every result to
``DIR/torch.npz``.  Imports no JAX.
"""
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import sharded, snn  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import snn_cell  # noqa: E402


def _index(z, prefix: str):
    return snn.index_from_arrays(
        z[prefix + "mu"], z[prefix + "v1"], z[prefix + "xs"],
        z[prefix + "alphas"], z[prefix + "half_norms"], z[prefix + "order"],
        "euclidean", 0.0, z[prefix + "vs"], z[prefix + "projs"],
        device="cpu")


def main(rank: int, world: int, d: Path) -> None:
    dist.init_process_group("gloo", init_method=f"file://{d / 'store'}",
                            rank=rank, world_size=world)
    try:
        z = np.load(d / "inputs.npz")
        out = {}
        mesh = tmesh.make_host_mesh(device_type="cpu")
        mesh3 = init_device_mesh("cpu", (2, world // 2, 1),
                                 mesh_dim_names=("pod", "data", "model"))
        out["mesh_shape"] = np.asarray(mesh.shape)
        out["mesh_names"] = np.asarray(mesh.mesh_dim_names)

        index = _index(z, "")
        block, k = int(z["block"]), int(z["k"])
        shard = sharded.shard_index(index, mesh, block=block)
        qa = sharded.prepare_query_arrays(index, z["q"], float(z["radius"]))
        out["count"] = sharded.make_sharded_count_fn(mesh)(*shard[:3], *qa)
        out["percount"] = sharded.make_sharded_percount_fn(mesh)(
            *shard[:3], *qa)
        out["topk_ids"], out["topk_dh"] = sharded.make_sharded_topk_fn(
            mesh, k)(*shard, *qa)
        # the data axis of a (pod, data, model) mesh: the same functions
        # over groups of world / 2 ranks
        shard3 = sharded.shard_index(index, mesh3, axis="data", block=block)
        out["count_pod"] = sharded.make_sharded_count_fn(mesh3)(
            *shard3[:3], *qa)
        # ("pod", "data") as one axis gives this rank the same shard as the
        # host mesh's "data"
        shard_pd = sharded.shard_index(index, mesh3, axis=("pod", "data"),
                                       block=block)
        same = torch.tensor([int(all(torch.equal(a, b)
                                     for a, b in zip(shard, shard_pd)))])
        dist.all_reduce(same, op=dist.ReduceOp.MIN)
        out["same_shard"] = same

        svc = _index(z, "svc_")
        n_chunk, q_chunk = int(z["svc_n_chunk"]), int(z["svc_q_chunk"])
        sx, sal, shn, _ = sharded.shard_index(svc, mesh, block=n_chunk)
        sq = sharded.prepare_query_arrays(svc, z["svc_q"],
                                          float(z["svc_radius"]))
        for prune in (True, False):
            kw = dict(q_chunk=q_chunk, n_chunk=n_chunk, prune=prune)
            step = snn_cell.make_service_count_step(mesh, "data", **kw)
            out[f"svc_{prune}"] = step(sx, sal, shn, *sq)
            step = snn_cell.make_service_count_step(mesh3, ("pod", "data"),
                                                    **kw)
            out[f"svc_pod_{prune}"] = step(sx, sal, shn, *sq)
        if rank == 0:
            np.savez(d / "torch.npz", **{
                key: v.numpy() if isinstance(v, torch.Tensor) else v
                for key, v in out.items()})
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3]))
