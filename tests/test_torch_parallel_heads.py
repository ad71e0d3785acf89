"""The port's sharded LM steps where "model" does not divide the query
heads (`distributed.parallel.ParallelContext.split_heads`) against the
JAX package's single-device steps, on the CPU.

The reference's GSPMD cuts minicpm3-4b's 40 MLA heads and llama4-scout's
40 query heads over the production "model" axis of 16; the port keeps
the reference's equal column blocks as storage and gives each model rank
whole heads, ``H // tp`` and one more on the first ``H % tp`` ranks.  One
launch of 4 gloo ranks (`_torch_parallel_heads_rank.py`, joined through a
file store in a temporary directory) runs, on (data, model) = (1, 4):

* llama4-scout reduced with 6 query heads over 2 KV heads (heads 2, 2,
  1, 1; rank 1's heads 2 and 3 read KV heads 0 and 1): ``train_4k``
  three steps, and the serving steps (the prefill, the decode from JAX's
  ``init_args`` and the prefill-then-decode chain of
  `test_torch_parallel_serve`);
* minicpm3-4b reduced with 6 MLA heads: the same.

The JAX steps, built with the same head override, run here meanwhile.
Tolerances are `test_torch_parallel`'s (`_torch_train`'s losses, norms,
parameters and moments) and `test_torch_parallel_serve`'s (logits and the
chain's float32 cache within 2^-16 of their largest magnitude, bfloat16
caches within one bfloat16 ulp).  A table test holds the split itself:
the heads, KV heads, columns and KV index of each rank at (40, 16),
(6, 4) and (10, 4).
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
from repro_torch.distributed import parallel
from repro_torch.launch import steps as tsteps
from test_torch_parallel import _flat_jax, _sharded_state, _tree
from test_torch_parallel_serve import CHAIN, _cache_close, _logits_close

from _torch_train import (LOSS_REL, NORM_REL, scalar_close,  # noqa: F401
                          state_close, one_thread)

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 180
STEPS = 3
LR = 3e-4
LLAMA4, MINICPM3 = "llama4-scout-17b-a16e", "minicpm3-4b"
HEADS = {LLAMA4: (6, 2), MINICPM3: (6, None)}


def _case(name, arch, kind, shape="train_4k"):
    heads, kv = HEADS[arch]
    return dict(name=name, arch=arch, kind=kind, shape=shape, mesh=[1, 4],
                multi_pod=False, heads=heads, kv_heads=kv)


CASES = {c["name"]: c for c in (
    _case("llama4_train_1x4", LLAMA4, "train"),
    _case("minicpm3_train_1x4", MINICPM3, "train"),
    _case("llama4_serve_1x4", LLAMA4, "serve", "decode_32k"),
    _case("minicpm3_serve_1x4", MINICPM3, "serve", "decode_32k"))}
TRAIN = sorted(k for k, c in CASES.items() if c["kind"] == "train")
SERVE = sorted(k for k, c in CASES.items() if c["kind"] == "serve")


def jax_over(arch) -> dict:
    """The JAX config's fields for the case's heads."""
    heads, kv = HEADS[arch]
    red = jreg.get_arch(arch).make_config("train_4k", True)
    if red.mla is not None:
        return {"n_heads": heads, "n_kv_heads": heads,
                "mla": dataclasses.replace(red.mla, n_heads=heads)}
    return {"n_heads": heads, "n_kv_heads": kv}


def torch_over(arch) -> dict:
    heads, kv = HEADS[arch]
    red = tsteps.get_arch(arch).make_config("train_4k", True)
    if red.mla is not None:
        return {"n_heads": heads, "n_kv_heads": heads,
                "mla": dataclasses.replace(red.mla, n_heads=heads)}
    return {"n_heads": heads, "n_kv_heads": kv}


def jax_serving(arch, shape) -> dict:
    """`test_torch_parallel_serve.jax_runs` with the head override."""
    over = jax_over(arch)
    jpre = jsteps.build_step(arch, "prefill_32k", reduced=True,
                             cfg_override=over)
    jdec = jsteps.build_step(arch, shape, reduced=True, cfg_override=over)
    params, cache, toks, pos = jdec.init_args()
    cfg = dataclasses.replace(jreg.get_arch(arch).make_config(shape, True),
                              max_seq=64, **over)
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
    """The 4 gloo ranks, and JAX's (and the port's unsharded) steps
    meanwhile: {case: {"sharded": ..., ...}}."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    d = tmp_path_factory.mktemp("heads4")
    starts = {}
    for name in TRAIN:
        arch = CASES[name]["arch"]
        jsd = jsteps.build_step(arch, "train_4k", reduced=True,
                                cfg_override=jax_over(arch))
        starts[name] = (jsd, jsd.init_args())
        np.savez(d / f"{name}_params.npz", **_flat_jax(starts[name][1][0]))
    for name in SERVE:
        arch = CASES[name]["arch"]
        jdec = jsteps.build_step(arch, "decode_32k", reduced=True,
                                 cfg_override=jax_over(arch))
        np.savez(d / f"{arch}_params.npz", **_flat_jax(jdec.init_args()[0]))
    np.save(d / "chain_tokens.npy", CHAIN)
    (d / "cases.json").write_text(json.dumps(list(CASES.values())))
    script = str(ROOT / "tests" / "_torch_parallel_heads_rank.py")
    procs = [subprocess.Popen([sys.executable, script, str(r), "4", str(d)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(4)]
    out = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for name, (jsd, (jparams, jstate, jbatch)) in starts.items():
            fn = jax.jit(jsd.fn)
            jm = []
            for _ in range(STEPS):
                jparams, jstate, m = fn(jparams, jstate, jbatch)
                jm.append((float(m["loss"]), float(m["grad_norm"])))
            tsd = tsteps.build_step(CASES[name]["arch"], "train_4k",
                                    reduced=True,
                                    cfg_override=torch_over(
                                        CASES[name]["arch"]))
            _, tstate, tbatch = tsd.init_args(device="cpu")
            tparams = _tree(_flat_jax(starts[name][1][0]))
            tm = [tsd.fn(tparams, tstate, tbatch) for _ in range(STEPS)]
            out[name] = {"jax": (jm, jparams, jstate),
                         "plain": ([(float(m["loss"]), float(m["grad_norm"]))
                                    for m in tm], tparams, tstate)}
        for name in SERVE:
            out[name] = {"jax": jax_serving(CASES[name]["arch"],
                                            CASES[name]["shape"])}
    finally:
        torch.set_num_threads(threads)
    for p in procs:
        try:
            _, err = p.communicate(timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail(f"the 4 gloo ranks ran over {TIMEOUT_S} s")
        assert p.returncode == 0, f"4 ranks: {err[-3000:]}"
    for name in CASES:
        out[name]["sharded"] = dict(np.load(d / f"{name}_torch.npz"))
    return out


# --------------------------------------------------------------------------- #
# The split                                                                   #
# --------------------------------------------------------------------------- #
def _rank_ctx(tp: int, rank: int):
    """A stand-in `ParallelContext` of model rank ``rank`` of ``tp`` (the
    split needs no process group)."""
    ns = types.SimpleNamespace(tp_size=tp, tp_rank=rank, head_spans=None,
                               kv_spans=None, head_cols={}, kv_index=None,
                               kv_rep=1)
    ns.split_heads = types.MethodType(parallel.ParallelContext.split_heads,
                                      ns)
    ns.replicate_kv = lambda n: None
    return ns


# (config, model ranks): each rank's (query heads, KV heads, KV index)
SPLITS = {
    "40_over_16": (LLAMA4, {}, 16,
                   [(3, 1, (0, 0, 0)), (3, 2, (0, 0, 1)), (3, 1, (0, 0, 0)),
                    (3, 2, (0, 1, 1)), (3, 1, (0, 0, 0)), (3, 1, (0, 0, 0)),
                    (3, 2, (0, 0, 1)), (3, 1, (0, 0, 0)), (2, 2, (0, 1)),
                    (2, 1, (0, 0)), (2, 1, (0, 0)), (2, 1, (0, 0)),
                    (2, 1, (0, 0)), (2, 2, (0, 1)), (2, 1, (0, 0)),
                    (2, 1, (0, 0))]),
    "6_over_4": (LLAMA4, {"n_heads": 6, "n_kv_heads": 2, "head_dim": 16},
                 4, [(2, 1, (0, 0)), (2, 2, (0, 1)), (1, 1, (0,)),
                     (1, 1, (0,))]),
    "10_over_4": (LLAMA4, {"n_heads": 10, "n_kv_heads": 2}, 4,
                  [(3, 1, (0, 0, 0)), (3, 2, (0, 0, 1)), (2, 1, (0, 0)),
                   (2, 1, (0, 0))]),
}


@pytest.mark.parametrize("name", sorted(SPLITS))
def test_head_split_table(name):
    arch, over, tp, want = SPLITS[name]
    cfg = dataclasses.replace(tsteps.get_arch(arch).make_config(
        "train_4k", False), **over)
    assert tsteps._uneven_heads(cfg, tp)
    tsteps._check_heads(cfg, tp)
    spans = parallel.head_split(cfg.n_heads, tp)
    assert [b - a for a, b in spans] == [w[0] for w in want]
    assert spans[0][0] == 0 and spans[-1][1] == cfg.n_heads
    assert all(spans[r][1] == spans[r + 1][0] for r in range(tp - 1))
    d = cfg.head_dim
    cols = {"wq": [], "wk": []}
    for r in range(tp):
        ctx = _rank_ctx(tp, r)
        lcfg = tsteps._local_cfg(cfg, ctx)
        assert (lcfg.n_heads, lcfg.n_kv_heads, ctx.kv_index) == want[r]
        h0, h1 = spans[r]
        assert ctx.head_cols["wq"] == ctx.head_cols["wo"] == (h0 * d, h1 * d)
        k0, k1 = parallel.kv_span(h0, h1, cfg.n_heads // cfg.n_kv_heads)
        assert ctx.head_cols["wk"] == ctx.head_cols["wv"] == (k0 * d, k1 * d)
        # each local query head reads its global KV head
        assert all(k0 + ctx.kv_index[i] == (h0 + i) * cfg.n_kv_heads
                   // cfg.n_heads for i in range(h1 - h0))
        cols["wq"].append(ctx.head_cols["wq"])
        cols["wk"].append(ctx.head_cols["wk"])
    # every query head's columns once; every KV head's by at least one rank
    assert sorted(cols["wq"]) == cols["wq"]
    assert cols["wq"][-1][1] == cfg.n_heads * d
    owned = set()
    for a, b in cols["wk"]:
        owned |= set(range(a, b))
    assert owned == set(range(cfg.n_kv_heads * d))


def test_mla_split_at_40_over_16():
    cfg = tsteps.get_arch(MINICPM3).make_config("train_4k", False)
    m = cfg.mla
    for r in range(16):
        n, lo = (3, 3 * r) if r < 8 else (2, 24 + 2 * (r - 8))
        ctx = _rank_ctx(16, r)
        lcfg = tsteps._local_cfg(cfg, ctx)
        assert lcfg.mla.n_heads == lcfg.n_heads == n and ctx.kv_index is None
        assert ctx.head_cols["wq_b"] == (lo * (m.qk_nope + m.qk_rope),
                                         (lo + n) * (m.qk_nope + m.qk_rope))
        assert ctx.head_cols["wkv_b"] == (lo * (m.qk_nope + m.v_head),
                                          (lo + n) * (m.qk_nope + m.v_head))
        assert ctx.head_cols["wo"] == (lo * m.v_head, (lo + n) * m.v_head)


def test_first_owner_of_each_shared_kv_head():
    # 6 heads over 2 KV heads at "model" 4: KV spans (0, 1), (0, 2),
    # (1, 2), (1, 2) padded to 2 a rank; KV head 0 from rank 0's slot 0,
    # KV head 1 from rank 1's slot 1
    spans = [parallel.kv_span(a, b, 3) for a, b in parallel.head_split(6, 4)]
    assert spans == [(0, 1), (0, 2), (1, 2), (1, 2)]
    idx = parallel.ParallelContext._first_owners(spans, 2)
    assert idx == [0, 3]
    idx = parallel.ParallelContext._first_owners(parallel.head_split(10, 4),
                                                 3)
    assert idx == [0, 1, 2, 3, 4, 5, 6, 7, 9, 10]


# --------------------------------------------------------------------------- #
# The steps against JAX                                                       #
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", sorted(CASES))
def test_uneven_heads_init_is_the_unsharded_init(runs, name):
    # the shards gather to the unsharded init_args bit for bit
    assert bool(runs[name]["sharded"]["same_init"])


@pytest.mark.parametrize("name", TRAIN)
def test_uneven_heads_train_matches_the_jax_step(runs, name):
    z = runs[name]["sharded"]
    jm, jparams, jstate = runs[name]["jax"]
    for i, (loss, gn) in enumerate(jm):
        scalar_close(z["loss"][i], loss, LOSS_REL)
        scalar_close(z["grad_norm"][i], gn, NORM_REL)
    params, state = _sharded_state(z)
    state_close(params, state, jparams, jstate, LR, STEPS)


@pytest.mark.parametrize("name", TRAIN)
def test_uneven_heads_train_matches_the_unsharded_step(runs, name):
    z = runs[name]["sharded"]
    tm, tparams, tstate = runs[name]["plain"]
    for i, (loss, gn) in enumerate(tm):
        scalar_close(z["loss"][i], loss, LOSS_REL)
        scalar_close(z["grad_norm"][i], gn, NORM_REL)
    params, state = _sharded_state(z)
    state_close(params, state, jax.tree.map(lambda t: t.numpy(), tparams),
                jax.tree.map(lambda t: t.numpy(), tstate), LR, STEPS)


@pytest.mark.parametrize("name", SERVE)
def test_uneven_heads_prefill_matches_the_jax_step(runs, name):
    z, ref = runs[name]["sharded"], runs[name]["jax"]
    assert z["prefill_logits"].shape == (4, 512)
    _logits_close(z["prefill_logits"], ref["prefill_logits"])
    _cache_close(z, "prefill_cache", ref["prefill_cache"])


@pytest.mark.parametrize("name", SERVE)
def test_uneven_heads_decode_matches_the_jax_step(runs, name):
    z, ref = runs[name]["sharded"], runs[name]["jax"]
    _logits_close(z["decode_logits"], ref["decode_logits"])
    _cache_close(z, "decode_cache", ref["decode_cache"])


@pytest.mark.parametrize("name", SERVE)
def test_uneven_heads_prefill_then_decode_matches_jax(runs, name):
    """`test_torch_parallel_serve`'s chain: a prefill of 12 tokens, its
    cache padded into a float32 cache of 32, then decode steps to position
    17 against JAX's ``decode_step`` chain from the same cache."""
    z, ref = runs[name]["sharded"], runs[name]["jax"]
    p_len = 12
    _, want = ref["prefill"](ref["params"], jnp.asarray(CHAIN[:, :p_len]))
    start = {k: z[f"chain_start/{k}"] for k in want}
    for k in want:
        assert not start[k][:, :, p_len:].any()
    _cache_close({k: v[:, :, :p_len] for k, v in start.items()}, "", want)
    cache = {k: jnp.asarray(v) for k, v in start.items()}
    for i, pos in enumerate(range(p_len, 18)):
        logits, cache = ref["decode"](ref["params"], cache,
                                      jnp.asarray(CHAIN[:, pos]),
                                      jnp.int32(pos))
        _logits_close(z[f"chain_logits_{i}"], logits)
    for k, v in cache.items():
        _logits_close(z[f"chain_cache/{k}"], v)
