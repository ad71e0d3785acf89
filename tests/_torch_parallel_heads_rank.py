"""One rank of the port's sharded LM steps at splits that the mesh does
not divide evenly, over gloo, for tests/test_torch_parallel_heads.py.

    python tests/_torch_parallel_heads_rank.py RANK WORLD DIR

Joins a process group of WORLD ranks through the file store ``DIR/store``
and runs each case of ``DIR/cases.json`` in order, every step built with
the case's override (`case_override`: its query or MLA heads, and for a
case with a ``"size"`` the reduced config's widths at that shape):

* ``"train"`` as `_torch_parallel_rank.run_case` (three ``train_4k``
  steps from ``DIR/<case>_params.npz``);
* ``"serve"`` as `_torch_parallel_serve_rank.run_case` in the case's own
  directory ``DIR/<case>`` (the prefill, the decode and the
  prefill-then-decode chain from its ``<arch>_params.npz``);
* ``"prefill"`` (`run_prefill`): the prefill of the step's own tokens
  from ``DIR/<case>_params.npz``, its cache gathered from blocks that may
  be unequal.

Rank 0 writes ``<case>_torch.npz`` as those scripts do.  Imports no JAX.
"""
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import _torch_parallel_rank as train_rank  # noqa: E402
import _torch_parallel_serve_rank as serve_rank  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.distributed import parallel  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402

BUILD_STEP = steps.build_step


def head_override(arch: str, heads: int, kv_heads: int | None) -> dict:
    """The reduced config's fields for ``heads`` query heads (MLA: MLA
    heads) over ``kv_heads`` KV heads (GQA)."""
    red = registry.get_arch(arch).make_config("train_4k", True)
    if red.mla is not None:
        return {"n_heads": heads, "n_kv_heads": heads,
                "mla": dataclasses.replace(red.mla, n_heads=heads)}
    return {"n_heads": heads, "n_kv_heads": kv_heads}


def case_override(case: dict) -> dict:
    """The case's ``cfg_override``: its heads, and with a ``"size"`` the
    reduced config's widths in float32 (a full config's remat, no chunks)
    and its ``"dispatch_groups"``."""
    over = {}
    if case.get("size"):
        red = registry.get_arch(case["arch"]).make_config("train_4k", True)
        over = {f: getattr(red, f) for f in train_rank.FIELDS}
        over.update(dtype=torch.float32, max_seq=64, xent_chunk=None,
                    chunk_q=None)
        if case.get("dispatch_groups"):
            over["moe"] = dataclasses.replace(
                red.moe, dispatch_groups=case["dispatch_groups"])
    if case.get("heads"):
        over.update(head_override(case["arch"], case["heads"],
                                  case.get("kv_heads")))
    return over


def run_prefill(case: dict, d: Path, rank: int) -> None:
    mesh = init_device_mesh("cpu", tuple(case["mesh"]),
                            mesh_dim_names=("data", "model"))
    pre = steps.build_step(case["arch"], "prefill_32k", reduced=True,
                           mesh=mesh)
    plain = steps.build_step(case["arch"], "prefill_32k", reduced=True)
    pspec = pre.in_shardings[0]
    params, tokens = pre.init_args(device="cpu")
    full, ftokens = plain.init_args(device="cpu")
    ok = serve_rank.same(parallel.gather_tree(params, pspec, mesh), full)
    ok &= torch.equal(tokens, ftokens)
    out = {"same_init": np.asarray(bool(ok))}
    start = serve_rank.load_like(d / f"{case['name']}_params.npz", full)
    logits, cache = pre.fn(parallel.shard_tree(start, pspec, mesh), tokens)
    cfg = dataclasses.replace(registry.get_arch(case["arch"]).make_config(
        "prefill_32k", True), **case_override(case))
    whole = tf.init_cache(cfg, *tokens.shape, device="meta")
    got = parallel.gather_tree(
        cache, steps.lm_cache_spec(whole, "prefill_32k"), mesh,
        {k: tuple(v.shape) for k, v in whole.items()})
    if rank == 0:
        out["prefill_logits"] = logits.float().numpy()
        out["blocks"] = np.asarray(sorted({tuple(c.shape)
                                           for c in cache.values()}))
        for k, v in got.items():
            out[f"prefill_cache/{k}"] = v.float().numpy()
        np.savez(d / f"{case['name']}_torch.npz", **out)


def run_case(case: dict, d: Path, rank: int) -> None:
    over = case_override(case)

    def build_step(*args, **kw):
        if case.get("size"):
            kw.pop("reduced", None)
            kw["shape_override"] = case["size"]
            over_all = {**(kw.get("cfg_override") or {}), **over}
        else:
            over_all = over
        return BUILD_STEP(*args, cfg_override=over_all,
                          **{k: v for k, v in kw.items()
                             if k != "cfg_override"})

    steps.build_step = build_step
    try:
        if case["kind"] == "train":
            train_rank.run_case(case, d, rank)
        elif case["kind"] == "serve":
            serve_rank.run_case(case, d / case["name"], rank)
        else:
            run_prefill(case, d, rank)
    finally:
        steps.build_step = BUILD_STEP


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
