"""The port's sharded LM serving steps (``build_step(arch, "prefill_32k" |
"decode_32k" | "long_500k", mesh=...)``: the reference's sequence-sharded
KV cache) against the JAX package's single-device steps, on the CPU.

Each case runs in gloo ranks (`_torch_parallel_serve_rank.py`, one
process group a world size, joined through a file store in a temporary
directory) from the JAX package's reduced ``init_args()`` parameters cut
into shards, while the JAX steps run here:

* nemotron-4-15b, minicpm3-4b (MLA) and qwen3-moe (MoE, groups over the
  data ranks) on (data, model) = (2, 2): batch over data, cache sequence
  over "model";
* internlm2-20b on (1, 4): its 2 KV heads replicated over runs of two
  model ranks;
* llama4-scout ``decode_32k`` on (1, 4) (local windows of 16 tokens over
  cache blocks of 8) and ``long_500k`` on (2, 2) (batch replicated, the
  sequence over data x model);
* qwen3-moe on (pod, data, model) = (2, 2, 2) (``multi_pod``);
* internlm2-20b and llama4-scout (``long_500k``) on (1, 1), which must be
  bit-equal to the unsharded port.

Per case: the sharded ``init_args`` gathers to the unsharded init bit for
bit; the prefill's logits and gathered cache, the decode from JAX's own
``init_args`` (zero cache, position 16), and a chain (a prefill of 14
tokens, 12 where "model" has 4 ranks, its cache gathered, padded to 32
in a float32 cache and re-sharded, then decode steps to position 17, each
block boundary of these meshes crossed at 16) match JAX's ``prefill`` and
``decode_step``.  Tolerances are `test_torch_lm_steps`'s: float32 outputs
(logits, the chain's float32 cache) within 2^-16 of their largest
magnitude (GEMM sums in another order; the partial softmaxes combined
over the sequence group), bfloat16 caches within one
bfloat16 ulp at their largest magnitude (a float32 value a few ulp from a
rounding boundary goes either way).  The mesh check raises ``ValueError``
before any collective where the reference's jit refuses an argument (a
batch or a cache that does not divide, experts that "model" does not);
the splits it pads build.
"""
import dataclasses
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.launch import steps as jsteps
from repro.models import transformer as jt
from repro_torch.launch import steps as tsteps
from test_torch_parallel import _built

from _torch_lm import bf16_ulp, match

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 180
CHAIN_END, DECODE_LEN = 17, 32
CHAIN = np.random.default_rng(27).integers(0, 512, (4, CHAIN_END + 1)
                                           ).astype(np.int32)


def _case(name, arch, shape, mesh, multi_pod=False):
    return dict(name=name, arch=arch, shape=shape, mesh=mesh,
                multi_pod=multi_pod)


# (world size, cases) a launch
LAUNCHES = {
    4: [_case("nemotron_2x2", "nemotron-4-15b", "decode_32k", [2, 2]),
        _case("minicpm3_2x2", "minicpm3-4b", "decode_32k", [2, 2]),
        _case("qwen3_moe_2x2", "qwen3-moe-235b-a22b", "decode_32k", [2, 2]),
        _case("internlm2_kv_1x4", "internlm2-20b", "decode_32k", [1, 4]),
        _case("llama4_1x4", "llama4-scout-17b-a16e", "decode_32k", [1, 4]),
        _case("llama4_long_2x2", "llama4-scout-17b-a16e", "long_500k",
              [2, 2])],
    8: [_case("qwen3_moe_2x2x2", "qwen3-moe-235b-a22b", "decode_32k",
              [2, 2, 2], multi_pod=True)],
    1: [_case("internlm2_1x1", "internlm2-20b", "decode_32k", [1, 1]),
        _case("llama4_long_1x1", "llama4-scout-17b-a16e", "long_500k",
              [1, 1])],
}
CASES = {c["name"]: c for cases in LAUNCHES.values() for c in cases}


def chain_prompt(case) -> int:
    return 14 if 14 % case["mesh"][-1] == 0 else 12


def _key(path) -> str:
    return "/".join(str(k.key) for k in path)


def jax_runs(arch, shape) -> dict:
    """JAX's prefill of its ``init_args`` tokens and its decode from its
    ``init_args``, and its decode step (compiled, the position traced) and
    prefill for the chain."""
    jpre = jsteps.build_step(arch, "prefill_32k", reduced=True)
    jdec = jsteps.build_step(arch, shape, reduced=True)
    params, cache, toks, pos = jdec.init_args()
    cfg = dataclasses.replace(jreg.get_arch(arch).make_config(shape, True),
                              max_seq=64)
    out = {"params": params}
    out["prefill_logits"], out["prefill_cache"] = jax.jit(jpre.fn)(
        params, jpre.init_args()[1])
    dec = jax.jit(lambda p, c, t, i: jt.decode_step(p, c, t, i, cfg))
    out["decode_logits"], out["decode_cache"] = dec(params, cache, toks, pos)
    out["decode"] = dec
    out["prefill"] = jax.jit(lambda p, t: jt.prefill(p, t, cfg))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every launch's gloo ranks, and JAX's runs of each (arch, shape)
    meanwhile: {case name: (the port's sharded results, JAX's)}."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    rank_script = str(ROOT / "tests" / "_torch_parallel_serve_rank.py")
    jax_params = {}
    for case in CASES.values():
        if case["arch"] not in jax_params:
            jdec = jsteps.build_step(case["arch"], "decode_32k", reduced=True)
            jax_params[case["arch"]] = jdec.init_args()[0]
    procs, dirs = [], {}
    for world, cases in LAUNCHES.items():
        d = tmp_path_factory.mktemp(f"serve{world}")
        dirs[world] = d
        for arch in {c["arch"] for c in cases}:
            np.savez(d / f"{arch}_params.npz", **{
                _key(p): np.asarray(a) for p, a in
                jax.tree_util.tree_flatten_with_path(jax_params[arch])[0]})
        np.save(d / "chain_tokens.npy", CHAIN)
        (d / "cases.json").write_text(json.dumps(cases))
        procs.append((world, [subprocess.Popen(
            [sys.executable, rank_script, str(r), str(world), str(d)],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for r in range(world)]))
    ref = {}
    for case in CASES.values():
        key = (case["arch"], case["shape"])
        if key not in ref:
            ref[key] = jax_runs(*key)
    out = {}
    for world, ps in procs:
        for p in ps:
            try:
                _, err = p.communicate(timeout=TIMEOUT_S)
            except subprocess.TimeoutExpired:
                for _, other in procs:
                    for q in other:
                        q.kill()
                pytest.fail(f"the {world} gloo ranks ran over {TIMEOUT_S} s")
            assert p.returncode == 0, f"{world} ranks: {err[-3000:]}"
        for case in LAUNCHES[world]:
            z = dict(np.load(dirs[world] / f"{case['name']}_torch.npz"))
            out[case["name"]] = (z, ref[(case["arch"], case["shape"])])
    return out


def _logits_close(got: np.ndarray, want):
    match(torch.from_numpy(got), want)


def _cache_close(z: dict, prefix: str, want: dict):
    for k, w in want.items():
        got = z[f"{prefix}/{k}" if prefix else k]
        w = np.asarray(jnp.asarray(w).astype(jnp.float32))
        assert got.shape == w.shape, (k, got.shape, w.shape)
        assert np.abs(got - w).max() <= bf16_ulp(np.abs(w).max()), k


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_serving_init_is_the_unsharded_init(runs, name):
    # the shards gather to the unsharded init_args bit for bit, the token
    # rows and the zero cache block are the rank's, the position 16
    assert bool(runs[name][0]["same_init"])


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_prefill_matches_the_jax_step(runs, name):
    z, ref = runs[name]
    assert z["prefill_logits"].shape == (4, 512)
    _logits_close(z["prefill_logits"], ref["prefill_logits"])
    _cache_close(z, "prefill_cache", ref["prefill_cache"])


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_decode_matches_the_jax_step(runs, name):
    z, ref = runs[name]
    _logits_close(z["decode_logits"], ref["decode_logits"])
    _cache_close(z, "decode_cache", ref["decode_cache"])


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_prefill_then_decode_chain_matches_jax(runs, name):
    """The chain's prefill cache against JAX's prefill of the same prompt,
    then JAX's ``decode_step`` chain from the port's own padded cache.  The
    cache is float32 from the padding on (the decode steps take any cache
    dtype, in both packages): each step writes its entry unrounded, so a
    bfloat16 rounding that went the other way in one package cannot move
    a step's logits past float32's tolerance."""
    z, ref = runs[name]
    p_len = chain_prompt(CASES[name])
    _, want = ref["prefill"](ref["params"], jnp.asarray(CHAIN[:, :p_len]))
    start = {k: z[f"chain_start/{k}"] for k in want}
    for k in want:
        assert not start[k][:, :, p_len:].any()          # zeros after P
    _cache_close({k: v[:, :, :p_len] for k, v in start.items()}, "", want)
    cache = {k: jnp.asarray(v) for k, v in start.items()}
    for i, pos in enumerate(range(p_len, CHAIN_END + 1)):
        logits, cache = ref["decode"](ref["params"], cache,
                                      jnp.asarray(CHAIN[:, pos]),
                                      jnp.int32(pos))
        _logits_close(z[f"chain_logits_{i}"], logits)
    for k, v in cache.items():
        _logits_close(z[f"chain_cache/{k}"], v)


@pytest.mark.parametrize("name", ["internlm2_1x1", "llama4_long_1x1"])
def test_one_rank_mesh_is_bit_equal_to_the_unsharded_steps(runs, name):
    # the rank ran the unsharded steps on the same inputs: every logit and
    # cache entry of the prefill, the decode and the chain equal
    assert bool(runs[name][0]["bit_equal"])


def _mesh(*sizes, multi_pod=False):
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return types.SimpleNamespace(mesh_dim_names=names,
                                 size=lambda i: sizes[i])


def test_serving_mesh_checks_raise_before_any_collective():
    # 8 data ranks do not divide a batch of 4 sequences: the reference's
    # jit refuses the cache's batch
    with pytest.raises(ValueError, match=r"cache/k: dimension 1 \(4\) does "
                       r"not divide over data \(8"):
        tsteps.build_step("internlm2-20b", "decode_32k", reduced=True,
                          mesh=_mesh(8, 1))
    # heads over "model": 4 heads over 8 model ranks, four ranks with none
    # (the steps: `test_torch_parallel_heads.py`)
    _built("nemotron-4-15b:prefill_32k:prefill", (1, 8), "nemotron-4-15b",
           "prefill_32k", reduced=True)
    # MLA heads fewer than the model ranks build; experts that "model"
    # does not divide do not (the reference's jit refuses the router)
    _built("minicpm3-4b:decode_32k:decode", (1, 8), "minicpm3-4b",
           "decode_32k", reduced=True,
           cfg_override={"n_heads": 8, "n_kv_heads": 8})
    with pytest.raises(ValueError, match="ffn/router: dimension 3"):
        tsteps.build_step("llama4-scout-17b-a16e", "decode_32k",
                          reduced=True, cfg_override={"n_heads": 8,
                                                      "n_kv_heads": 8},
                          mesh=_mesh(1, 8))
    # a prompt of 6 over 4 model ranks: blocks of 2, 2, 2 and 0 (the full
    # widths, whose heads split; nothing is allocated); long_500k's cache
    # of 4 over data x model does not divide
    _built("internlm2-20b:prefill_32k:prefill", (1, 4), "internlm2-20b",
           "prefill_32k", shape_override={"seq_len": 6, "global_batch": 4})
    with pytest.raises(ValueError, match=r"cache/k: dimension 2 \(4\) does "
                       r"not divide over data x model \(8"):
        tsteps.build_step("llama4-scout-17b-a16e", "long_500k",
                          shape_override={"seq_len": 4}, mesh=_mesh(4, 2))
    # 3 data ranks divide a batch of 6 and would hold its gcd(6, 32) = 2
    # MoE groups as 1, 1 and 0, but not the model's width of 4,096: the
    # reference's jit refuses the embedding's ZeRO split
    with pytest.raises(ValueError, match=r"params/embed: dimension 1 "
                       r"\(4096\) does not divide over data \(3"):
        tsteps.build_step("qwen3-moe-235b-a22b", "decode_32k",
                          shape_override={"global_batch": 6},
                          mesh=_mesh(3, 1))
    # the data axes of a multi-pod mesh are ("pod", "data")
    with pytest.raises(ValueError, match=r"cache/k: dimension 1 \(4\) does "
                       r"not divide over pod x data \(8"):
        tsteps.build_step("internlm2-20b", "decode_32k", reduced=True,
                          multi_pod=True, mesh=_mesh(2, 4, 1,
                                                     multi_pod=True))
