"""One rank of the port's sharded LM steps with query heads that "model"
does not divide, over gloo, for tests/test_torch_parallel_heads.py.

    python tests/_torch_parallel_heads_rank.py RANK WORLD DIR

Joins a process group of WORLD ranks through the file store ``DIR/store``
and runs each case of ``DIR/cases.json`` in order: a ``"train"`` case as
`_torch_parallel_rank.run_case` (three ``train_4k`` steps from
``DIR/<case>_params.npz``), a ``"serve"`` case as
`_torch_parallel_serve_rank.run_case` (the prefill, the decode and the
prefill-then-decode chain from ``DIR/<arch>_params.npz``), every step
built with the case's head override (`head_override`).  Rank 0 writes
``DIR/<case>_torch.npz`` as those scripts do.  Imports no JAX.
"""
import dataclasses
import json
import sys
from pathlib import Path

import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import _torch_parallel_rank as train_rank  # noqa: E402
import _torch_parallel_serve_rank as serve_rank  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.launch import steps  # noqa: E402

BUILD_STEP = steps.build_step


def head_override(arch: str, heads: int, kv_heads: int | None) -> dict:
    """The reduced config's fields for ``heads`` query heads (MLA: MLA
    heads) over ``kv_heads`` KV heads (GQA)."""
    red = registry.get_arch(arch).make_config("train_4k", True)
    if red.mla is not None:
        return {"n_heads": heads, "n_kv_heads": heads,
                "mla": dataclasses.replace(red.mla, n_heads=heads)}
    return {"n_heads": heads, "n_kv_heads": kv_heads}


def run_case(case: dict, d: Path, rank: int) -> None:
    over = head_override(case["arch"], case["heads"], case.get("kv_heads"))

    def build_step(*args, **kw):
        return BUILD_STEP(*args, cfg_override=over, **kw)

    steps.build_step = build_step
    try:
        if case["kind"] == "train":
            train_rank.run_case(case, d, rank)
        else:
            serve_rank.run_case(case, d, rank)
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
