"""The port's serving steps of the LMs and of BERT4Rec against the JAX
package's ``repro.launch.steps.build_step``, on the CPU.

Every ported cell of ``all_cells()`` (the five LMs' ``prefill_32k``,
``decode_32k`` and, for llama4, ``long_500k``; BERT4Rec's ``serve_p99``,
``serve_bulk`` and ``retrieval_cand``) runs at its reduced config: the JAX
step's ``init_args()`` gives the parameters (carried across by
``params_from_jax``) and the inputs, which the port's own ``init_args``
must reproduce from the same ``default_rng(0)``.  Tolerances: float32
outputs within ``2^-16`` of their largest magnitude (GEMM sums in another
order); the bfloat16 KV caches within one bfloat16 ulp at their largest
magnitude (a float32 value a few ulp from a rounding boundary goes either
way); the top-100 ids equal, in ``lax.top_k``'s order.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.launch import steps as jsteps
from repro_torch.configs import registry as treg
from repro_torch.launch import steps as tsteps
from repro_torch.models import recsys as trs
from repro_torch.models import transformer as tt
from repro_torch.utils import tree_leaves, tree_map

from _torch_lm import bf16_ulp, match, np_

LM_ARCHS = ("nemotron-4-15b", "internlm2-20b", "minicpm3-4b",
            "llama4-scout-17b-a16e", "qwen3-moe-235b-a22b")
SERVING = ("prefill_32k", "decode_32k", "long_500k", "serve_p99",
           "serve_bulk", "retrieval_cand")
CELLS = [(a, s) for a, s, skip in jreg.all_cells()
         if s in SERVING and (a in LM_ARCHS or a == "bert4rec")]


def _cache_close(got: dict, want: dict):
    assert set(got) == set(want)
    for k in got:
        assert got[k].dtype == torch.bfloat16
        w = np.asarray(jnp.asarray(want[k]).astype(jnp.float32))
        assert np.abs(np_(got[k]) - w).max() <= bf16_ulp(np.abs(w).max())


def test_the_cells_are_the_references():
    assert len(CELLS) == 14
    assert list(treg.all_cells(include_skipped=True)) == list(
        jreg.all_cells(include_skipped=True))
    assert list(treg.all_cells()) == list(jreg.all_cells())
    for arch in treg.list_archs():
        spec, jspec = treg.get_arch(arch), jreg.get_arch(arch)
        assert (spec.family, spec.source, spec.skip_shapes) == \
            (jspec.family, jspec.source, jspec.skip_shapes)
        assert spec.shapes == jspec.shapes
        assert spec.runnable_shapes() == jspec.runnable_shapes()
    assert treg.list_archs() == jreg.list_archs()


@pytest.mark.parametrize("arch,shape", CELLS)
def test_serving_step_matches_reference(arch, shape):
    jsd = jsteps.build_step(arch, shape, reduced=True)
    tsd = tsteps.build_step(arch, shape, reduced=True)
    assert tsd.name == jsd.name
    jargs = jsd.init_args()
    targs = tsd.init_args(device="cpu")
    jfn = jax.jit(jsd.fn)
    if arch == "bert4rec":
        params = trs.params_from_jax(arch, jax.tree.map(np.asarray, jargs[0]),
                                     device="cpu", reduced=True)
        batch = targs[1]
        for k, v in jargs[1].items():
            np.testing.assert_array_equal(batch[k].numpy(), np.asarray(v))
        want, got = jfn(*jargs), tsd.fn(params, batch)
        if shape == "retrieval_cand":
            match(got[0], want[0])
            np.testing.assert_array_equal(got[1].numpy(),
                                          np.asarray(want[1]))
            assert tuple(got[1].shape) == (8, 100)
        else:
            assert tuple(got.shape) == (8, 16)
            match(got, want)
        return
    cfg = dataclasses.replace(treg.get_arch(arch).make_config(shape, True),
                              max_seq=64)
    params = tt.params_from_jax(jax.tree.map(np.asarray, jargs[0]), cfg,
                                device="cpu")
    tok = 1 if shape == "prefill_32k" else 2
    np.testing.assert_array_equal(targs[tok].numpy(), np.asarray(jargs[tok]))
    want_logits, want_cache = jfn(*jargs)
    if shape == "prefill_32k":
        got_logits, got_cache = tsd.fn(params, targs[1])
    else:
        assert targs[3] == int(jargs[3]) == 16
        got_logits, got_cache = tsd.fn(*((params,) + targs[1:]))
        assert got_cache is targs[1]               # written in place
    assert got_logits.shape == (4, 512)
    match(got_logits, want_logits)
    _cache_close(got_cache, want_cache)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_steps_hold_parameters_in_the_compute_dtype(arch):
    """A bfloat16 step computes the same bits from parameters held in
    bfloat16 (`init_args`' and `params_from_jax(dtype=...)`'s) as from the
    reference's float32 tree: every leaf is cast to the compute dtype at
    use."""
    bf = {"dtype": torch.bfloat16}
    tsd = tsteps.build_step(arch, "prefill_32k", reduced=True,
                            cfg_override=bf)
    held, tokens = tsd.init_args(device="cpu")
    assert {t.dtype for t in tree_leaves(held)} == {torch.bfloat16}
    jsd = jsteps.build_step(arch, "prefill_32k", reduced=True,
                            cfg_override={"dtype": jnp.bfloat16})
    tree = jax.tree.map(np.asarray, jsd.init_args()[0])
    cfg = dataclasses.replace(
        treg.get_arch(arch).make_config("prefill_32k", True), max_seq=64,
        **bf)
    f32 = tt.params_from_jax(tree, cfg, device="cpu")
    half = tt.params_from_jax(tree, cfg, device="cpu", dtype=torch.bfloat16)
    assert {t.dtype for t in tree_leaves(f32)} == {torch.float32}
    a_logits, a_cache = tsd.fn(f32, tokens)
    b_logits, b_cache = tsd.fn(half, tokens)
    assert a_logits.dtype == torch.bfloat16
    assert torch.equal(a_logits, b_logits)
    assert all(torch.equal(a_cache[k], b_cache[k]) for k in a_cache)
    # the same for one decode step
    dsd = tsteps.build_step(arch, "decode_32k", reduced=True, cfg_override=bf)
    _, cache, toks, pos = dsd.init_args(device="cpu")
    c2 = tree_map(torch.clone, cache)
    a, _ = dsd.fn(f32, cache, toks, pos)
    b, _ = dsd.fn(half, c2, toks, pos)
    assert torch.equal(a, b)
    assert all(torch.equal(cache[k], c2[k]) for k in cache)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_model_flops_match_reference(arch):
    jspec, tspec = jreg.get_arch(arch), treg.get_arch(arch)
    for shape in jspec.shapes:
        jcfg = jspec.make_config(shape, False)
        tcfg = tspec.make_config(shape, False)
        for sh in (jspec.shapes[shape], {**jspec.shapes[shape],
                                         "global_batch": 8}):
            assert tsteps.lm_model_flops(tcfg, sh) == \
                jsteps.lm_model_flops(jcfg, sh)


def test_bert4rec_model_flops_match_reference():
    for shape in ("serve_p99", "serve_bulk", "train_batch", "retrieval_cand"):
        jcfg = jreg.get_arch("bert4rec").make_config(shape, False)
        tcfg = treg.get_arch("bert4rec").make_config(shape, False)
        sh = treg.get_arch("bert4rec").shapes[shape]
        assert tsteps.rs_model_flops("bert4rec", tcfg, sh) == \
            jsteps.rs_model_flops("bert4rec", jcfg, sh)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_configs_match_reference(arch):
    for shape in treg.get_arch(arch).shapes:
        for reduced in (True, False):
            jcfg = jreg.get_arch(arch).make_config(shape, reduced)
            tcfg = treg.get_arch(arch).make_config(shape, reduced)
            for f in ("n_layers", "d_model", "n_heads", "n_kv_heads",
                      "head_dim", "d_ff", "vocab", "act", "gated_ffn", "attn",
                      "rope_theta", "max_seq", "layer_pattern",
                      "local_window", "chunk_q", "aux_loss_weight",
                      "z_loss_weight"):
                assert getattr(tcfg, f) == getattr(jcfg, f), f
            for sub in ("mla", "moe"):
                j, t = getattr(jcfg, sub), getattr(tcfg, sub)
                assert (j is None) == (t is None)
                if j is not None:
                    assert t.__dict__ == j.__dict__
            assert str(tcfg.dtype).split(".")[-1] == jnp.dtype(
                jcfg.dtype).name


def test_unported_kinds_raise():
    """Every kind of every arch is ported: each runnable cell builds its
    step (training, serving or retrieval, as the reference names it); a
    skipped cell raises with the reference's reason and an unknown arch
    with the registry's list."""
    for arch, shape, _ in treg.all_cells():
        jname = jsteps.build_step(arch, shape, reduced=True).name
        assert tsteps.build_step(arch, shape, reduced=True).name == jname
    with pytest.raises(ValueError, match="skipped: pure full-attention"):
        tsteps.build_step("nemotron-4-15b", "long_500k", reduced=True)
    with pytest.raises(KeyError, match="unknown arch"):
        tsteps.build_step("gpt-2", "train_4k", reduced=True)


def test_overrides_reach_the_step():
    # reduced: 4 layers, and the reduced shape's 4 sequences of 32 (as in
    # JAX, it replaces the shape's batch and length)
    sd = tsteps.build_step("minicpm3-4b", "decode_32k", reduced=True,
                           shape_override={"global_batch": 2},
                           cfg_override={"n_layers": 4})
    params, cache, toks, pos = sd.init_args(device="cpu")
    assert cache["ckv"].shape[:3] == (4, 4, 32) and toks.shape == (4,)
    assert params["layers"]["attn_norm"].shape[:2] == (4, 1)
    full = tsteps.build_step("qwen3-moe-235b-a22b", "decode_32k",
                             shape_override={"global_batch": 32},
                             cfg_override={"n_layers": 4})
    jfull = jsteps.build_step("qwen3-moe-235b-a22b", "decode_32k",
                              shape_override={"global_batch": 32},
                              cfg_override={"n_layers": 4})
    assert full.model_flops == jfull.model_flops
