"""The port's sharded LM steps at the splits that the mesh does not divide
evenly, against the JAX package's single-device steps, on the CPU.

The reference's GSPMD cuts minicpm3-4b's 40 MLA heads and llama4-scout's
40 query heads over the production "model" axis of 16; the port keeps
the reference's equal column blocks as storage and gives each model rank
whole heads, ``H // tp`` and one more on the first ``H % tp`` ranks
(`distributed.parallel.ParallelContext.split_heads`), none past the heads
where they are fewer than the ranks.  GSPMD also pads a sequence,
a microbatch or MoE groups that the ranks do not divide; the port cuts
them into its blocks (`distributed.parallel.block`: ``ceil(n / ranks)`` a
rank, the last ranks short or empty).  One launch of 4 gloo ranks
(`_torch_parallel_heads_rank.py`, joined through a file store in a
temporary directory) runs, on (data, model) = (1, 4) unless named:

* llama4-scout reduced with 6 query heads over 2 KV heads (heads 2, 2,
  1, 1; rank 1's heads 2 and 3 read KV heads 0 and 1) and minicpm3-4b
  reduced with 6 MLA heads: ``train_4k`` three steps, and the serving
  steps (the prefill, the decode from JAX's ``init_args`` and the
  prefill-then-decode chain of `test_torch_parallel_serve`);
* nemotron-4-15b reduced with 2 query heads over 1 KV head and
  minicpm3-4b with 2 MLA heads (heads 1, 1, 0, 0: two ranks with no
  head): the same;
* nemotron-4-15b at sequences of 30 (blocks 8, 8, 8, 6) and of 5 (2, 2,
  1, 0): ``train_4k`` and the prefill (its cache in those blocks);
  qwen3-moe at a sequence of 5: ``train_4k`` (the router on the rank's
  block, its logits' gradient taken from an empty last block);
* nemotron-4-15b on (4, 1) at microbatches of 6 (rows 2, 2, 2, 0) and of
  2 sequences (1, 1, 0, 0): ``train_4k``;
* qwen3-moe on (4, 1) with ``dispatch_groups`` 2: a microbatch's 2 MoE
  groups over 4 data ranks (one a rank on ranks 0 and 1, none on 2 and
  3; each rank's tokens moved to the rank of its group).

The cases of a ``"size"`` are the reduced config's widths at a full
config's remat and microbatches, in float32 (the reduced build fixes
the shape).  The JAX steps, built with the same overrides, run here
meanwhile.  Tolerances are `test_torch_parallel`'s (`_torch_train`'s
losses, norms, parameters and moments) and `test_torch_parallel_serve`'s
(logits and the chain's float32 cache within 2^-16 of their largest
magnitude, bfloat16 caches within one bfloat16 ulp).  Table tests hold
the split itself: the heads, KV heads, columns and KV index of each rank
at (40, 16), (6, 4), (10, 4) and (2, 4), and the blocks of sequences,
rows and MoE groups.
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
from repro_torch.models import transformer as tt
from test_torch_parallel import FIELDS, _flat_jax, _sharded_state, _tree
from test_torch_parallel_serve import CHAIN, _cache_close, _logits_close

from _torch_train import (LOSS_REL, NORM_REL, scalar_close,  # noqa: F401
                          state_close, one_thread)

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 240
STEPS = 3
LR = 3e-4
LLAMA4, MINICPM3 = "llama4-scout-17b-a16e", "minicpm3-4b"
NEMOTRON, QWEN3 = "nemotron-4-15b", "qwen3-moe-235b-a22b"


def _case(name, arch, kind, heads, kv=None, shape="decode_32k"):
    """A head case: ``heads`` query (MLA) heads over ``kv`` KV heads."""
    return dict(name=name, arch=arch, kind=kind,
                shape="train_4k" if kind == "train" else shape, mesh=[1, 4],
                multi_pod=False, heads=heads, kv_heads=kv)


def _split(name, kind, mesh, seq=32, batch=4, arch=NEMOTRON, **kw):
    """A case of the reduced widths at ``seq`` tokens and a global batch
    of ``batch`` (the full config's microbatches: 2, or 8 for an MoE)."""
    return dict(name=name, arch=arch, kind=kind, mesh=mesh, multi_pod=False,
                accum=True, size={"seq_len": seq, "global_batch": batch},
                **kw)


CASES = {c["name"]: c for c in (
    _case("llama4_train_1x4", LLAMA4, "train", 6, 2),
    _case("minicpm3_train_1x4", MINICPM3, "train", 6),
    _case("llama4_serve_1x4", LLAMA4, "serve", 6, 2),
    _case("minicpm3_serve_1x4", MINICPM3, "serve", 6),
    _case("nemotron_fewer_train_1x4", NEMOTRON, "train", 2, 1),
    _case("minicpm3_fewer_train_1x4", MINICPM3, "train", 2),
    _case("nemotron_fewer_serve_1x4", NEMOTRON, "serve", 2, 1),
    _case("minicpm3_fewer_serve_1x4", MINICPM3, "serve", 2),
    _split("nemotron_s30_train_1x4", "train", [1, 4], seq=30),
    _split("nemotron_s5_train_1x4", "train", [1, 4], seq=5),
    _split("nemotron_s30_prefill_1x4", "prefill", [1, 4], seq=30),
    _split("nemotron_s5_prefill_1x4", "prefill", [1, 4], seq=5),
    _split("nemotron_mb6_train_4x1", "train", [4, 1], batch=12),
    _split("nemotron_mb2_train_4x1", "train", [4, 1], batch=4),
    _split("qwen3_moe_groups2_train_4x1", "train", [4, 1], seq=8, batch=32,
           arch=QWEN3, dispatch_groups=2),
    _split("qwen3_moe_s5_train_1x4", "train", [1, 4], seq=5, batch=8,
           arch=QWEN3))}
TRAIN = sorted(k for k, c in CASES.items() if c["kind"] == "train")
SERVE = sorted(k for k, c in CASES.items() if c["kind"] == "serve")
PREFILL = sorted(k for k, c in CASES.items() if c["kind"] == "prefill")


def _over(case, reg, f32) -> dict:
    """A case's ``cfg_override`` in one package (``reg`` its registry,
    ``f32`` its float32 dtype): its heads, and at a ``"size"`` the
    reduced widths (`_torch_parallel_heads_rank.case_override`)."""
    red = reg.get_arch(case["arch"]).make_config("train_4k", True)
    over = {}
    if case.get("size"):
        over = {f: getattr(red, f) for f in FIELDS}
        over.update(dtype=f32, max_seq=64, xent_chunk=None, chunk_q=None)
        if case.get("dispatch_groups"):
            over["moe"] = dataclasses.replace(
                red.moe, dispatch_groups=case["dispatch_groups"])
    if case.get("heads"):
        h = case["heads"]
        over.update({"n_heads": h, "n_kv_heads": h,
                     "mla": dataclasses.replace(red.mla, n_heads=h)}
                    if red.mla is not None else
                    {"n_heads": h, "n_kv_heads": case["kv_heads"]})
    return over


def _kw(case, reg, f32) -> dict:
    """``build_step``'s keywords of a case in one package."""
    over = _over(case, reg, f32)
    if case.get("size"):
        return {"shape_override": case["size"], "cfg_override": over}
    return {"reduced": True, "cfg_override": over}


def jax_kw(case) -> dict:
    return _kw(case, jreg, jnp.float32)


def torch_kw(case) -> dict:
    return _kw(case, tsteps, torch.float32)


def jax_serving(case) -> dict:
    """`test_torch_parallel_serve.jax_runs` with the case's override."""
    arch, shape, over = case["arch"], case["shape"], jax_over(case)
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


def jax_over(case) -> dict:
    return _over(case, jreg, jnp.float32)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 4 gloo ranks, and JAX's (and the port's unsharded) steps
    meanwhile: {case: {"sharded": ..., ...}}."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    d = tmp_path_factory.mktemp("heads4")
    starts, prefills = {}, {}
    for name in TRAIN:
        jsd = jsteps.build_step(CASES[name]["arch"], "train_4k",
                                **jax_kw(CASES[name]))
        starts[name] = (jsd, jsd.init_args())
        np.savez(d / f"{name}_params.npz", **_flat_jax(starts[name][1][0]))
    for name in SERVE:
        case = CASES[name]
        jdec = jsteps.build_step(case["arch"], case["shape"], reduced=True,
                                 cfg_override=jax_over(case))
        (d / name).mkdir()
        np.savez(d / name / f"{case['arch']}_params.npz",
                 **_flat_jax(jdec.init_args()[0]))
        np.save(d / name / "chain_tokens.npy", CHAIN)
    for name in PREFILL:
        jpre = jsteps.build_step(CASES[name]["arch"], "prefill_32k",
                                 **jax_kw(CASES[name]))
        prefills[name] = (jpre, jpre.init_args())
        np.savez(d / f"{name}_params.npz",
                 **_flat_jax(prefills[name][1][0]))
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
                                    **torch_kw(CASES[name]))
            _, tstate, tbatch = tsd.init_args(device="cpu")
            tparams = _tree(_flat_jax(starts[name][1][0]))
            tm = [tsd.fn(tparams, tstate, tbatch) for _ in range(STEPS)]
            out[name] = {"jax": (jm, jparams, jstate),
                         "plain": ([(float(m["loss"]), float(m["grad_norm"]))
                                    for m in tm], tparams, tstate)}
        for name in SERVE:
            out[name] = {"jax": jax_serving(CASES[name])}
        for name, (jpre, (params, tokens)) in prefills.items():
            logits, cache = jax.jit(jpre.fn)(params, tokens)
            out[name] = {"jax": {"prefill_logits": logits,
                                 "prefill_cache": cache}}
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
        sub = d / name if name in SERVE else d
        out[name]["sharded"] = dict(np.load(sub / f"{name}_torch.npz"))
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
    # fewer heads than ranks: ranks 2 and 3 hold no head and no KV head
    "2_over_4": (NEMOTRON, {"n_heads": 2, "n_kv_heads": 1}, 4,
                 [(1, 1, (0,)), (1, 1, (0,)), (0, 0, ()), (0, 0, ())]),
}


@pytest.mark.parametrize("name", sorted(SPLITS))
def test_head_split_table(name):
    arch, over, tp, want = SPLITS[name]
    cfg = dataclasses.replace(tsteps.get_arch(arch).make_config(
        "train_4k", False), **over)
    assert tsteps._uneven_heads(cfg, tp)
    # the head columns, the vocabulary and the experts cut into equal
    # storage blocks: the reference's jit takes these parameters
    meta = tt.init_params(cfg, device="meta")
    tsteps.check_args(("params",), (tsteps.arg_specs_of(meta),),
                      (tsteps.tree_specs(meta, lambda p, leaf:
                                         tsteps.lm_param_spec(p, leaf,
                                                              "data")),),
                      {"data": 1, "model": tp})
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


@pytest.mark.parametrize("name", PREFILL)
def test_uneven_sequence_prefill_matches_the_jax_step(runs, name):
    z, ref = runs[name]["sharded"], runs[name]["jax"]
    assert z["prefill_logits"].shape == (4, 512)
    _logits_close(z["prefill_logits"], ref["prefill_logits"])
    _cache_close(z, "prefill_cache", ref["prefill_cache"])


# each case's block on rank 0 (its residual between layers, a microbatch
# of 2 sequences at (1, 4), or its cache block): GSPMD's ceil(n / ranks)
# of the sequence or of the microbatch
BLOCKS = {"nemotron_s30_train_1x4": [[2, 8, 64]],
          "nemotron_s5_train_1x4": [[2, 2, 64]],
          "nemotron_mb6_train_4x1": [[2, 32, 64]],
          "nemotron_mb2_train_4x1": [[1, 32, 64]],
          "qwen3_moe_groups2_train_4x1": [[1, 8, 64]],
          "qwen3_moe_s5_train_1x4": [[1, 2, 64]],
          "nemotron_s30_prefill_1x4": [[2, 4, 8, 2, 16]],
          "nemotron_s5_prefill_1x4": [[2, 4, 2, 2, 16]]}


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_rank_zero_holds_gspmds_block(runs, name):
    z = runs[name]["sharded"]
    got = z["blocks"] if "blocks" in z else z["residual"]
    assert got.tolist() == BLOCKS[name]


@pytest.mark.parametrize("total,parts,want", [
    (30, 4, [(0, 8), (8, 8), (16, 8), (24, 6)]),
    (5, 4, [(0, 2), (2, 2), (4, 1), (5, 0)]),
    (2, 4, [(0, 1), (1, 1), (2, 0), (2, 0)]),
    (32, 4, [(0, 8), (8, 8), (16, 8), (24, 8)])])
def test_block_is_gspmds_padded_split(total, parts, want):
    # ceil(n / parts) a rank, the last ranks short or empty; equal blocks
    # where ``parts`` divides n
    got = [parallel.block(total, parts, r) for r in range(parts)]
    assert [g[1:] for g in got] == want
    assert {g[0] for g in got} == {-(-total // parts)}


def test_data_rows_of_a_microbatch_the_ranks_do_not_divide():
    # a batch of 12 in 2 microbatches of 6 over 4 data ranks: 2, 2, 2, 0
    # rows of each microbatch; the empty rank holds none of either
    rows = [parallel.data_rows(12, 2, 4, r).tolist() for r in range(4)]
    assert rows == [[0, 1, 6, 7], [2, 3, 8, 9], [4, 5, 10, 11], []]
    assert parallel.data_rows(8, 2, 4, 1).tolist() == [1, 5]


def _moe_ctx(dp: int, rank: int, rows: int):
    ns = types.SimpleNamespace(dp_size=dp, dp_rank=rank, batch_rows=rows,
                               tokens_replicated=False)
    ns.moe_groups = types.MethodType(parallel.ParallelContext.moe_groups,
                                     ns)
    return ns


def test_moe_groups_the_data_ranks_do_not_divide():
    # qwen3-moe's case: 4 rows of 8 tokens over 4 data ranks, 2 groups of
    # 16: ranks 0 and 1 one group each (rank 0's from rows 0 and 1), 2 and
    # 3 none; every rank's tokens move, and its part of the aux means is
    # its sum over the 2 groups
    got = [_moe_ctx(4, r, 4).moe_groups((1, 8, 64), 2) for r in range(4)]
    assert [(g.count, g.size, g.share, g.total) for g in got] == \
        [(1, 16, None, 2)] * 2 + [(0, 16, None, 2)] * 2
    assert [g.move for g in got] == [
        (8, 16, 32, (8 * r, 8), (min(16 * r, 32), 16 if r < 2 else 0))
        for r in range(4)]
    # divided evenly: the rank's own tokens, its mean over 1 / dp
    even = _moe_ctx(2, 1, 4).moe_groups((2, 8, 64), 32)
    assert even == parallel.MoEGroups(16, 1, 0.5, 32, None)
    # unequal but aligned (rows 1, 1, 0, 0 of 30 tokens, 2 groups of 30):
    # nothing moves
    aligned = [_moe_ctx(4, r, 2).moe_groups((1 if r < 2 else 0, 30, 64), 2)
               for r in range(4)]
    assert [(g.count, g.move) for g in aligned] == [(1, None), (1, None),
                                                    (0, None), (0, None)]
