"""One rank of the port's sharded recsys and GAT steps over gloo, for
tests/test_torch_parallel_recsys.py.

    python tests/_torch_parallel_recsys_rank.py RANK WORLD DIR

Joins a process group of WORLD ranks through the file store ``DIR/store``
and runs each case of ``DIR/cases.json`` in order over a `DeviceMesh` of
the case's shape: ``build_step(arch, shape, reduced=True, mesh=...)``,
whose ``init_args`` must gather to the unsharded ``init_args`` bit for
bit (the batch: the rank's rows of the unsharded one); then, from the JAX
package's parameters (``DIR/<arch>_<shape>_params.npz``, flat keys
``a/0/b``) carried across by ``params_from_jax`` and cut into this rank's
shards,

* a training cell: three steps on the step's own batch, each step's
  metrics, then the gathered parameters and optimizer state (flattened as
  `ft.checkpoint` flattens a tree: dict keys sorted); a full-graph GAT
  cell first takes the step's gradient of the starting parameters
  (``StepDef.grad_fn``: ``loss0`` and ``gparams_<i>``) and records each
  layer's hidden node rows a rank, in and out (``rows``);
* a serving cell: the whole batch's outputs;
* a retrieval cell: the top-100 values and indices.

On a one-rank mesh the rank also runs the unsharded step on the same
inputs and records whether every output is bit-equal.  A case with
``"wide": true`` runs the DLRM widened by ``WIDE_DLRM`` (`wide_dlrm`),
whose MLP weights ``rs_param_spec`` cuts over "model": its parameters
are JAX's widened DLRM's (``DIR/dlrm-mlperf-wide_<shape>_params.npz``),
and the rank also records which top-MLP weights are stored cut and the
unsharded port's outputs (``plain/...``).  A case with ``"unit":
"lookup"`` runs the row-sharded lookup unit case instead.  Rank 0 writes
``DIR/<case>_torch.npz``.  Imports no JAX.
"""
import contextlib
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import registry  # noqa: E402
from repro_torch.distributed import parallel  # noqa: E402
from repro_torch.distributed.sharding import (rules_for_family,  # noqa: E402
                                              sharding_rules)
from repro_torch.ft.checkpoint import _flatten  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import gnn, recsys  # noqa: E402
from repro_torch.utils import tree_leaves  # noqa: E402

TRAIN_STEPS = 3
# (node rows in, node rows out) of each full-graph GAT layer called
LAYER_ROWS: list = []


def _recording(layer):
    def run(p, x, *args, **kwargs):
        out = layer(p, x, *args, **kwargs)
        LAYER_ROWS.append((x.shape[0], out.shape[0]))
        return out
    return run


gnn.gat_layer = _recording(gnn.gat_layer)
# the widened DLRM: wide enough that rs_param_spec cuts its MLP weights
WIDE_DLRM = {"bot_mlp": (256, 16), "top_mlp": (256, 1)}


def unflatten(flat: dict):
    """A nested tree of the flat ``a/0/b`` keys: dicts, and lists where
    every key of a level is a number."""
    tree: dict = {}
    for key, v in flat.items():
        node, parts = tree, key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v

    def lists(t):
        if not isinstance(t, dict):
            return t
        if t and all(k.isdigit() for k in t):
            return [lists(t[k]) for k in sorted(t, key=int)]
        return {k: lists(v) for k, v in t.items()}
    return lists(tree)


def tree_of(model):
    return model if isinstance(model, dict) else model.tree()


def same(a, b) -> bool:
    a, b = tree_leaves(a), tree_leaves(b)
    return len(a) == len(b) and all(
        torch.equal(x.to_dense() if x.is_sparse else x,
                    y.to_dense() if y.is_sparse else y)
        for x, y in zip(a, b))


def flat_numpy(tree) -> list:
    leaves, _ = _flatten(tree)
    return [np.asarray(t.detach().double().numpy()) if isinstance(
        t, torch.Tensor) else np.asarray(t, np.float64) for t in leaves]


@contextlib.contextmanager
def wide_dlrm(reg):
    """DLRM widened by ``WIDE_DLRM`` in the architecture registry ``reg``
    (the port's, or the JAX package's: the same interface) while the block
    runs."""
    arch = reg.get_arch("dlrm-mlperf")

    def wide(shape_name, reduced=False):
        return dataclasses.replace(arch.make_config(shape_name, reduced),
                                   **WIDE_DLRM)
    reg.register(dataclasses.replace(arch, make_config=wide))
    try:
        yield
    finally:
        reg.register(arch)


def params_file(case: dict) -> str:
    """The name of the case's JAX parameters in the run's directory."""
    wide = "-wide" if case.get("wide") else ""
    return f"{case['arch']}{wide}_{case['shape']}_params.npz"


def from_jax(case: dict, d: Path):
    """The port's unsharded parameters of the JAX package's."""
    tree = unflatten(dict(np.load(d / params_file(case))))
    if case["arch"] == "gat-cora":
        cfg = steps.get_arch("gat-cora").make_config(case["shape"], True)
        return gnn.params_from_jax(tree, cfg, device="cpu")
    return recsys.params_from_jax(case["arch"], tree, device="cpu",
                                  reduced=True)


def shard_model(case: dict, sd, full, mesh):
    local = parallel.shard_tree(tree_of(full), sd.in_shardings[0], mesh)
    if case["arch"] == "gat-cora":
        return local
    cfg = steps.get_arch(case["arch"]).make_config(case["shape"], True)
    return recsys.from_tree(case["arch"], cfg, local)


def run(sd, model, args) -> dict:
    """The step's outputs from ``model`` and the rest of ``args``."""
    out = {}
    if sd.name.endswith(":train"):
        state, batch = args
        for t in range(TRAIN_STEPS):
            for k, v in sd.fn(model, state, batch).items():
                out[f"{k}_{t}"] = v
        out["params"], out["opt"] = tree_of(model), state
    elif sd.name.endswith(":serve"):
        out["out"] = sd.fn(model, *args)
    else:
        out["vals"], out["idx"] = sd.fn(model, *args)
    return out


def gathered(out: dict, sd, mesh) -> dict:
    if "params" in out:
        out = dict(out)
        out["params"] = parallel.gather_tree(out["params"],
                                             sd.in_shardings[0], mesh)
        out["opt"] = parallel.gather_tree(out["opt"], sd.in_shardings[1],
                                          mesh)
    return out


def init_checks(sd, plain, mesh, args, fargs) -> bool:
    """The sharded init_args gather to the unsharded ones; the batch (or
    the ranking archs' candidates) is the rank's rows of it."""
    ok = same(parallel.gather_tree(tree_of(args[0]), sd.in_shardings[0],
                                   mesh), tree_of(fargs[0]))
    if len(args) == 3:
        ok &= same(parallel.gather_tree(args[1], sd.in_shardings[1], mesh),
                   fargs[1])
    bspec = sd.in_shardings[-1]
    for k, v in args[-1].items():
        want = fargs[-1][k]
        axes = bspec[k].axes(0) if len(bspec[k]) else ()
        if axes:
            _, n, pos = parallel._groups_of(mesh, axes)
            blk = want.shape[0] // n
            want = want[pos * blk:(pos + 1) * blk]
        ok &= torch.equal(v, want)
    return bool(ok)


def lookup_case(mesh, rank: int) -> dict:
    """The row-sharded lookup on a (1, 4) table of 64 rows: ids at every
    shard boundary (row0 - 1, row0, row1 - 1), the last rows, ids past the
    table, -1 padding; bags of one and of five; the forward and the row
    gradient against the unsharded ones."""
    gen = torch.Generator().manual_seed(28)
    table = torch.randn(64, 8, generator=gen)
    edge = [r * 16 + o for r in range(4) for o in (-1, 0, 15)]
    ones = torch.tensor(edge[1:] + [62, 63, 64, 70, -1], dtype=torch.int32)
    bags = torch.randint(-1, 66, (9, 5), generator=gen, dtype=torch.int32)
    g1 = torch.randn(ones.shape[0], 8, generator=gen)
    g5 = torch.randn(9, 8, generator=gen)
    pc = parallel.ParallelContext(mesh, layout="rows")
    out = {}
    for name, ids, g in (("one", ones[:, None], g1), ("five", bags, g5)):
        full = table.clone().requires_grad_()
        want = recsys.bag_lookup(ids, full)
        want.backward(g)
        shard = table[rank * 16:(rank + 1) * 16].clone().requires_grad_()
        with sharding_rules(rules_for_family("recsys"), pc):
            got = recsys.bag_lookup(ids, shard)
        got.backward(g)
        grad = parallel.gather_tree({"g": shard.grad.to_dense()},
                                    {"g": steps.Spec("model", None)},
                                    mesh)["g"]
        out[f"{name}_got"] = got.detach().numpy()
        out[f"{name}_want"] = want.detach().numpy()
        out[f"{name}_ref"] = ref.embedding_bag_ref(ids, table).numpy()
        out[f"{name}_grad"] = grad.numpy()
        out[f"{name}_grad_want"] = full.grad.to_dense().numpy()
    return out


def run_case(case: dict, d: Path, rank: int) -> None:
    mp = case["multi_pod"]
    names = ("pod", "data", "model") if mp else ("data", "model")
    mesh = init_device_mesh("cpu", tuple(case["mesh"]), mesh_dim_names=names)
    if case.get("unit") == "lookup":
        out = lookup_case(mesh, rank)
    elif case.get("wide"):
        with wide_dlrm(registry):
            out = main_case(case, d, mesh)
    else:
        out = main_case(case, d, mesh)
    if rank == 0:
        np.savez(d / f"{case['name']}_torch.npz", **out)


def main_case(case: dict, d: Path, mesh) -> dict:
    arch, shape, mp = case["arch"], case["shape"], case["multi_pod"]
    sd = steps.build_step(arch, shape, reduced=True, mesh=mesh, multi_pod=mp)
    plain = steps.build_step(arch, shape, reduced=True)
    args, fargs = sd.init_args(device="cpu"), plain.init_args(device="cpu")
    out = {"same_init": np.asarray(init_checks(sd, plain, mesh, args,
                                               fargs))}
    model = shard_model(case, sd, from_jax(case, d), mesh)
    if case.get("wide"):
        out["cut"] = np.asarray([
            tuple(lin.weight.shape) != (lin.out_features, lin.in_features)
            for lin in model.top.layers])
    if shape == "full_graph_sm":
        LAYER_ROWS.clear()
        loss, grads = sd.grad_fn(model, args[2])
        out["rows"] = np.asarray(sorted(set(LAYER_ROWS)))
        out.update(arrays({"loss0": loss, "gparams": grads}))
    got = gathered(run(sd, model, args[1:]), sd, mesh)
    if mesh.mesh.numel() == 1 or case.get("wide"):
        want = run(plain, from_jax(case, d), fargs[1:])
        if mesh.mesh.numel() == 1:
            out["bit_equal"] = np.asarray(same(
                [got[k] for k in sorted(got)],
                [want[k] for k in sorted(want)]))
        if case.get("wide"):
            out.update(arrays(want, "plain/"))
    out.update(arrays(got))
    return out


def arrays(res: dict, prefix: str = "") -> dict:
    """A step's outputs as float64 arrays: a tree's leaves under
    ``<key>_<i>``."""
    out = {}
    for k, v in res.items():
        if isinstance(v, (dict, list)):
            for i, a in enumerate(flat_numpy(v)):
                out[f"{prefix}{k}_{i}"] = a
        else:
            out[prefix + k] = np.asarray(v.detach().double().numpy())
    return out


def main(rank: int, world: int, d: Path) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{d / 'store'}",
                            rank=rank, world_size=world)
    try:
        for case in json.loads((d / "cases.json").read_text()):
            run_case(case, d, rank)
            dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3]))
