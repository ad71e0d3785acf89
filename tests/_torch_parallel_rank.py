"""One rank of the port's sharded LM training step over gloo, for
tests/test_torch_parallel.py.

    python tests/_torch_parallel_rank.py RANK WORLD DIR

Joins a process group of WORLD ranks through the file store ``DIR/store``
and runs each case of ``DIR/cases.json`` in order: ``build_step(arch,
"train_4k", mesh=...)`` over a `DeviceMesh` of the case's shape, whose
``init_args`` shards must gather to the unsharded ``init_args`` bit for
bit; then the case's starting parameters (``DIR/<case>_params.npz``, the
JAX package's init, written by the test) cut into this rank's shards,
three steps, and the state gathered back.  Rank 0 writes
``DIR/<case>_torch.npz``: each step's loss and gradient norm, the
gathered parameters and AdamW moments (keys: tree paths joined by "/"),
the shapes of the residual stream between layers (every pattern group's
input and output) in the sharded steps, ``residual``, as rows, and, on a
one-rank mesh, whether every step and leaf was bit-equal to the
unsharded step's.  A case with ``"norm_grads"`` also writes the sharded
step's gradient (``StepDef.grad_fn``) of the starting parameters with
respect to the norms (``grad/<path>``: every rank holds them whole).
Imports no JAX.
"""
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
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.utils import tree_leaves, tree_map_with_path  # noqa: E402

STEPS = 3
# the accumulation case: the reduced config's widths at a full config's
# remat, 2 microbatches (dense) of 4 sequences, chunks of 16
FIELDS = ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff",
          "vocab", "mla", "moe", "local_window")
ACCUM_SHAPE = {"seq_len": 32, "global_batch": 8}
# the norms' leaves (MLA's latent norms too), replicated over "model"
NORMS = ("attn_norm", "ffn_norm", "final_norm", "q_norm", "kv_norm")
# the residual stream's shapes at each pattern group's input and output
RESIDUAL: list = []


def _recording(group_apply):
    def run(gp, x, *args):
        out = group_apply(gp, x, *args)
        RESIDUAL.extend([tuple(x.shape), tuple(out[0].shape)])
        return out
    return run


tf._group_apply = _recording(tf._group_apply)


def step_kwargs(case: dict) -> dict:
    if not case.get("accum"):
        return {"reduced": True}
    red = registry.get_arch(case["arch"]).make_config("train_4k", True)
    over = {f: getattr(red, f) for f in FIELDS}
    over.update(dtype=torch.float32, xent_chunk=16, chunk_q=16)
    return {"shape_override": ACCUM_SHAPE, "cfg_override": over}


def key(path) -> str:
    return "/".join(map(str, path))


def load_like(path: Path, like) -> dict:
    """The arrays of ``path`` (keys: tree paths) as a tree of ``like``'s
    structure."""
    flat = dict(np.load(path))
    return tree_map_with_path(
        lambda p, _: torch.from_numpy(np.array(flat[key(p)])), like)


def data_place(mesh, multi_pod: bool) -> tuple:
    """(data ranks, this rank's position among them, row-major)."""
    names = ("pod", "data") if multi_pod else ("data",)
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    size, pos = 1, 0
    for a in names:
        n = mesh.size(mesh.mesh_dim_names.index(a))
        size, pos = size * n, pos * n + coord[a]
    return size, pos


def flatten(tree, prefix: str) -> dict:
    out = {}
    tree_map_with_path(lambda p, t: out.__setitem__(
        prefix + key(p), t.detach().numpy()), tree)
    return out


def run_case(case: dict, d: Path, rank: int) -> None:
    names = ("pod", "data", "model") if case["multi_pod"] else ("data",
                                                                "model")
    mesh = init_device_mesh("cpu", tuple(case["mesh"]), mesh_dim_names=names)
    kw = step_kwargs(case)
    sd = steps.build_step(case["arch"], "train_4k", mesh=mesh,
                          multi_pod=case["multi_pod"], **kw)
    plain = steps.build_step(case["arch"], "train_4k", **kw)
    pspec, ospec = sd.in_shardings[0], sd.in_shardings[1]
    params, state, batch = sd.init_args(device="cpu")
    full0, _, fbatch = plain.init_args(device="cpu")
    back = parallel.gather_tree(params, pspec, mesh)
    same_init = all(torch.equal(a, b) for a, b in
                    zip(tree_leaves(back), tree_leaves(full0)))
    red = registry.get_arch(case["arch"]).make_config("train_4k", True)
    accum = steps.lm_accum(red, not case.get("accum"))
    rows = parallel.data_rows(fbatch["tokens"].shape[0], accum,
                              *data_place(mesh, case["multi_pod"]))
    same_batch = all(torch.equal(batch[k], fbatch[k][rows]) for k in batch)
    out = {"same_init": np.asarray(same_init and same_batch)}

    start_file = d / f"{case['name']}_params.npz"
    shards = parallel.shard_tree(load_like(start_file, full0), pspec, mesh)
    with torch.no_grad():
        for p, s in zip(tree_leaves(params), tree_leaves(shards)):
            p.copy_(s)
    if case.get("norm_grads"):
        _, grads = sd.grad_fn(params, batch)
        tree_map_with_path(lambda p, g: out.__setitem__(
            "grad/" + key(p), g.numpy().copy()) if p[-1] in NORMS else None,
            grads)
    losses, norms = [], []
    RESIDUAL.clear()
    for _ in range(STEPS):
        m = sd.fn(params, state, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    out["residual"] = np.asarray(sorted(set(RESIDUAL)))
    out["loss"], out["grad_norm"] = np.asarray(losses), np.asarray(norms)
    gp = parallel.gather_tree(params, pspec, mesh)
    gmu = parallel.gather_tree(state["mu"], ospec["mu"], mesh)
    gnu = parallel.gather_tree(state["nu"], ospec["nu"], mesh)
    out["step"] = state["step"].numpy()

    if mesh.mesh.numel() == 1:
        # one rank: bit-equal to the unsharded step from the same start
        p1 = load_like(start_file, full0)
        _, s1, b1 = plain.init_args(device="cpu")
        equal = True
        for i in range(STEPS):
            m1 = plain.fn(p1, s1, b1)
            equal &= float(m1["loss"]) == losses[i]
            equal &= float(m1["grad_norm"]) == norms[i]
        for a, b in zip(tree_leaves((gp, gmu, gnu)),
                        tree_leaves((p1, s1["mu"], s1["nu"]))):
            equal &= torch.equal(a, b)
        out["bit_equal"] = np.asarray(bool(equal))
    if rank == 0:
        out.update(flatten(gp, "params/"))
        out.update(flatten(gmu, "mu/"))
        out.update(flatten(gnu, "nu/"))
        np.savez(d / f"{case['name']}_torch.npz", **out)


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
