"""One rank of the port's sharded LM serving steps over gloo, for
tests/test_torch_parallel_serve.py.

    python tests/_torch_parallel_serve_rank.py RANK WORLD DIR

Joins a process group of WORLD ranks through the file store ``DIR/store``
and runs each case of ``DIR/cases.json`` in order over a `DeviceMesh` of
the case's shape: ``build_step(arch, "prefill_32k", mesh=...)`` and the
case's decode cell, whose ``init_args`` must gather to the unsharded
``init_args`` bit for bit; then, from the JAX package's parameters
(``DIR/<arch>_params.npz``) cut into this rank's shards,

* the prefill of the step's own tokens (the rank's rows): the logits and
  the gathered cache;
* the decode step from the step's own arguments (a zero cache, position
  16): the logits and the gathered cache;
* a chain: a prefill of the first P tokens of ``DIR/chain_tokens.npy``
  (P = 14, or 12 where "model" has 4 ranks), its cache gathered, padded
  to 32 in a float32 cache (the decode steps then write their entries
  unrounded) and cut into the decode layout, then decode steps at
  positions P to 17 (each reading the next token): the padded cache,
  every step's logits and the final gathered cache.

Rank 0 writes ``DIR/<case>_torch.npz``; on a one-rank mesh the rank also
runs the unsharded steps on the same inputs and records whether every
output is bit-equal.  Imports no JAX.
"""
import json
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.distributed import parallel  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.utils import tree_leaves, tree_map_with_path  # noqa: E402

CHAIN_END = 17      # the chain's last decode position
DECODE_LEN = 32     # the reduced decode cells' cache length


def chain_prompt(tp: int) -> int:
    """The chain's prefill length: 14 where the "model" ranks divide it."""
    return 14 if 14 % tp == 0 else 12


def load_like(path: Path, like) -> dict:
    flat = dict(np.load(path))
    return tree_map_with_path(
        lambda p, _: torch.from_numpy(np.array(flat["/".join(map(str, p))])),
        like)


def same(a, b) -> bool:
    a, b = tree_leaves(a), tree_leaves(b)
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def copied(tree: dict) -> dict:
    return {k: t.clone() for k, t in tree.items()}


def padded(cache: dict, length: int) -> dict:
    """A gathered (L, B, P, ...) cache in a float32 zero cache of
    ``length``."""
    out = {}
    for k, c in cache.items():
        out[k] = torch.zeros(c.shape[:2] + (length,) + c.shape[3:])
        out[k][:, :, :c.shape[2]] = c
    return out


def serve(pre, dec, params, pre_tokens, dec_args, chain, p_len: int,
          gather_pre, gather_dec, shard_dec) -> dict:
    """The prefill, the decode and the chain of one set of steps (sharded
    or not); the caches gathered whole.  ``chain``: the chain's tokens as
    (the prefill's rows, the decode's rows)."""
    out = {}
    logits, cache = pre.fn(params, pre_tokens)
    out["prefill_logits"], out["prefill_cache"] = logits, gather_pre(cache)
    cache, toks, pos = dec_args
    logits, cache = dec.fn(params, cache, toks, pos)
    out["decode_logits"], out["decode_cache"] = logits, gather_dec(cache)
    _, cache = pre.fn(params, chain[0][:, :p_len])
    out["chain_start"] = padded(gather_pre(cache), DECODE_LEN)
    cache = shard_dec(copied(out["chain_start"]))
    for i, pos in enumerate(range(p_len, CHAIN_END + 1)):
        logits, cache = dec.fn(params, cache, chain[1][:, pos], pos)
        out[f"chain_logits_{i}"] = logits
    out["chain_cache"] = gather_dec(cache)
    return out


def run_case(case: dict, d: Path, rank: int) -> None:
    mp = case["multi_pod"]
    names = ("pod", "data", "model") if mp else ("data", "model")
    mesh = init_device_mesh("cpu", tuple(case["mesh"]), mesh_dim_names=names)
    arch, shape = case["arch"], case["shape"]
    pre = steps.build_step(arch, "prefill_32k", reduced=True, mesh=mesh,
                           multi_pod=mp)
    dec = steps.build_step(arch, shape, reduced=True, mesh=mesh,
                           multi_pod=mp)
    plain_pre = steps.build_step(arch, "prefill_32k", reduced=True)
    plain_dec = steps.build_step(arch, shape, reduced=True)
    pspec, cspec = dec.in_shardings[0], dec.in_shardings[1]
    pre_spec = steps.lm_cache_spec(dec.arg_specs[1], "prefill_32k", mp)

    # init_args: the shards gather to the unsharded init, the rows and the
    # cache block are the rank's
    params, tokens = pre.init_args(device="cpu")
    full, ftokens = plain_pre.init_args(device="cpu")
    dparams, cache, dtoks, pos = dec.init_args(device="cpu")
    _, fcache, fdtoks, fpos = plain_dec.init_args(device="cpu")
    long = shape == "long_500k"
    dp = mesh.size(0) * (mesh.size(1) if mp else 1)
    coord = dict(zip(names, mesh.get_coordinate()))
    dp_pos = (coord["pod"] * mesh.size(1) if mp else 0) + coord["data"]
    rows = slice(dp_pos * 4 // dp, (dp_pos + 1) * 4 // dp)
    drows = slice(None) if long else rows       # long_500k: every row
    ok = same(parallel.gather_tree(params, pspec, mesh), full)
    ok &= same(parallel.gather_tree(dparams, pspec, mesh), full)
    ok &= torch.equal(tokens, ftokens[rows]) and torch.equal(dtoks,
                                                             fdtoks[drows])
    ok &= same(parallel.gather_tree(cache, cspec, mesh), fcache)
    ok &= pos == fpos == 16
    out = {"same_init": np.asarray(bool(ok))}

    start = load_like(d / f"{arch}_params.npz", full)
    shards = parallel.shard_tree(start, pspec, mesh)
    chain = torch.from_numpy(np.load(d / "chain_tokens.npy"))
    p_len = chain_prompt(mesh.size(len(names) - 1))
    # (on a mesh of one rank gather_tree may return the shard itself)
    got = serve(pre, dec, shards, tokens, (cache, dtoks, pos),
                (chain[rows], chain[drows]), p_len,
                lambda c: copied(parallel.gather_tree(c, pre_spec, mesh)),
                lambda c: copied(parallel.gather_tree(c, cspec, mesh)),
                lambda c: parallel.shard_tree(c, cspec, mesh))
    if mesh.mesh.numel() == 1:
        want = serve(plain_pre, plain_dec, start, ftokens,
                     (fcache, fdtoks, fpos), (chain, chain), p_len,
                     lambda c: c, lambda c: c, lambda c: c)
        out["bit_equal"] = np.asarray(same(got, want))
    if rank == 0:
        for k, v in got.items():
            if isinstance(v, dict):
                for name, t in v.items():
                    out[f"{k}/{name}"] = t.float().numpy()
            else:
                out[k] = v.float().numpy()
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
