"""The port's layers, attention and transformer against the JAX reference
(``repro.models``), on the CPU.

The same seeded numpy inputs and the JAX parameters (carried across by
``params_from_jax``) go through both.  Tolerances:

* float32: outputs agree to ``2^-16`` of their largest magnitude: the
  products and the softmax sum in another order than XLA's (the measured
  gaps are 2^-20 to 2^-22), where a bfloat16 or TF32 slip would show at
  2^-8 to 2^-11.
* bfloat16, against JAX run op by op (``unroll_scans=True``, no query
  chunks): bit for bit.  The port rounds where each JAX op rounds (its
  SiLU and GELU step for step, its constants in bfloat16).
* bfloat16, against JAX where XLA compiles the computation (the scanned
  layers, the ``jax.checkpoint`` bodies of the query chunks and of the
  local windows): XLA keeps bfloat16 intermediates of a fusion in float32
  (excess precision), so the reference differs from itself run op by op.
  The port must stay within twice that spread of JAX's, measured on the
  same inputs, plus one bfloat16 ulp of the largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as ja
from repro.models import layers as jl
from repro.models import transformer as jt
from repro.models.attention import MLADims as JMLA
from repro_torch.models import attention as ta
from repro_torch.models import layers as tl
from repro_torch.models import transformer as tt
from repro_torch.models.attention import MLADims as TMLA
from repro_torch.utils import tree_leaves, tree_map

from _torch_lm import (DTYPES, F32_REL, bf16_ulp, bits_equal,
                       check_against_reference, configs, gap, match, np_, pair)


# --------------------------------------------------------------------------- #
# layers                                                                       #
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_layers_match_reference(dt):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(3, 7, 32)) * 3).astype(np.float32)
    w = rng.uniform(0.5, 1.5, size=(32,)).astype(np.float32)
    bias = rng.normal(size=(32,)).astype(np.float32)
    (jx, tx), (jw, tw), (jb, tb) = pair(x, dt), pair(w, dt), pair(bias, dt)
    same = bits_equal if dt == "bf16" else match
    same(tl.rms_norm(tx, tw), jl.rms_norm(jx, jw))
    same(tl.layer_norm(tx, tw, tb), jl.layer_norm(jx, jw, jb))
    for name, jf in jl.ACTIVATIONS.items():
        got = tl.ACTIVATIONS[name](tx)
        assert got.dtype == tx.dtype, name
        same(got, jf(jx))
    # the tables are the same float64 numpy rounded once
    for theta in (10000.0, 1e6):
        jc, js = jl.rope_freqs(16, 40, theta)
        tc, ts = tl.rope_freqs(16, 40, theta)
        bits_equal(tc, jc)
        bits_equal(ts, js)
        short = tl.rope_freqs(16, 9, theta)[0]
        assert torch.equal(short, tc[:9])          # a prefix of the longer
    q = (rng.normal(size=(2, 7, 3, 16))).astype(np.float32)
    pos = np.stack([np.arange(7), np.arange(30, 37)]).astype(np.int32)
    jq, tq = pair(q, dt)
    jc, js = jl.rope_freqs(16, 40)
    tc, ts = tl.rope_freqs(16, 40)
    got = tl.apply_rope(tq, torch.from_numpy(pos).long(), tc, ts)
    assert got.dtype == tq.dtype
    same(got, jl.apply_rope(jq, jnp.asarray(pos), jc, js))


def test_softmax_scale_is_rounded_to_the_compute_dtype():
    for d in (8, 96, 128):
        for jdt, tdt in DTYPES.values():
            want = 1.0 / jnp.sqrt(d).astype(jdt)
            got = ta.softmax_scale(d, tdt)
            assert got.dtype == tdt
            assert float(got) == float(want)
    # sqrt(128) is 11.3125 in bfloat16: the scale is bfloat16(1 / 11.3125),
    # not 1 / sqrt(128)
    got = float(ta.softmax_scale(128, torch.bfloat16))
    assert got == float(jnp.bfloat16(1 / 11.3125)) != 128 ** -0.5


# --------------------------------------------------------------------------- #
# attention                                                                    #
# --------------------------------------------------------------------------- #
def _qkv(rng, b, s, h, hkv, d, dv=None):
    dv = dv or d
    return (rng.normal(size=(b, s, h, d)).astype(np.float32),
            rng.normal(size=(b, s, hkv, d)).astype(np.float32),
            rng.normal(size=(b, s, hkv, dv)).astype(np.float32))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hkv", [4, 2])
def test_full_attention_matches_reference(dt, causal, hkv):
    rng = np.random.default_rng(1)
    q, k, v = _qkv(rng, 2, 16, 4, hkv, 8)
    (jq, tq), (jk, tk), (jv, tv) = pair(q, dt), pair(k, dt), pair(v, dt)
    jscale = 1.0 / jnp.sqrt(8).astype(DTYPES[dt][0])
    tscale = ta.softmax_scale(8, DTYPES[dt][1])
    want = ja.full_attention(jq, jk, jv, causal=causal, scale=jscale)
    got = ta.full_attention(tq, tk, tv, causal=causal, scale=tscale)
    assert got.dtype == tq.dtype
    want_c = ja.full_attention(jq, jk, jv, causal=causal, scale=jscale,
                               chunk_q=4)
    got_c = ta.full_attention(tq, tk, tv, causal=causal, scale=tscale,
                              chunk_q=4)
    if dt == "f32":
        match(got, want)
        match(got_c, want_c)
    else:
        match(got, want)                    # JAX op by op
        match(got_c, want_c, gap(want_c, want))
    # the port's chunks change no row's arithmetic
    assert torch.equal(got_c, got)
    with pytest.raises(ValueError, match="does not divide"):
        ta.full_attention(tq, tk, tv, causal=causal, scale=tscale, chunk_q=5)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_local_chunked_attention_matches_reference(dt):
    rng = np.random.default_rng(2)
    q, k, v = _qkv(rng, 2, 24, 4, 2, 8)
    (jq, tq), (jk, tk), (jv, tv) = pair(q, dt), pair(k, dt), pair(v, dt)
    jscale = 1.0 / jnp.sqrt(8).astype(DTYPES[dt][0])
    tscale = ta.softmax_scale(8, DTYPES[dt][1])
    want = ja.local_chunked_attention(jq, jk, jv, window=8, scale=jscale)
    got = ta.local_chunked_attention(tq, tk, tv, window=8, scale=tscale)
    # the reference's function op by op: each window on its own
    pos = jnp.arange(8)
    mask = (pos[:, None] >= pos[None, :])[None, None]
    eager = jnp.concatenate([ja._sdpa(jq[:, w:w + 8], jk[:, w:w + 8],
                                      jv[:, w:w + 8], mask, jscale)
                             for w in range(0, 24, 8)], axis=1)
    if dt == "f32":
        match(got, want)
    else:
        match(got, eager)
        match(got, want, gap(want, eager))
    # window 8 attends within [8i, 8i + 8) only: the first window is causal
    # attention over 8 keys, the later ones are not over 24
    full = ta.full_attention(tq, tk, tv, causal=True, scale=tscale)
    top = np.abs(np_(full)).max()
    tol = 4 * bf16_ulp(top) if dt == "bf16" else F32_REL * top
    assert gap(got[:, :8], full[:, :8]) <= tol
    assert gap(got[:, 8:], full[:, 8:]) > 0.1


def test_attention_in_pieces_is_bit_equal(monkeypatch):
    """`_attend`'s split (head groups, then query rows) changes no row."""
    rng = np.random.default_rng(3)
    q, k, v = _qkv(rng, 2, 24, 6, 2, 8)
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    scale = ta.softmax_scale(8, torch.bfloat16)
    whole = ta.full_attention(tq, tk, tv, causal=True, scale=scale)
    local = ta.local_chunked_attention(tq, tk, tv, window=8, scale=scale)
    calls = []
    real = ta._sdpa

    def counted(q_, *a):
        calls.append(tuple(q_.shape))
        return real(q_, *a)

    monkeypatch.setattr(ta, "_sdpa", counted)
    row = 2 * 24 * 4                        # one (query, head) row's bytes
    for budget, heads, rows in ((24 * 3 * row, 3, 24), (5 * 3 * row, 3, 5),
                                (row, 3, 1)):
        monkeypatch.setattr(ta, "SCORE_BYTES", budget)
        calls.clear()
        assert torch.equal(ta.full_attention(tq, tk, tv, causal=True,
                                             scale=scale), whole)
        assert {c[1] for c in calls} <= {rows, 24 % rows}
        assert {c[2] for c in calls} == {heads}      # whole KV groups of 3
    monkeypatch.setattr(ta, "SCORE_BYTES", 8 * 3 * 2 * 8 * 4 // 2)
    calls.clear()
    assert torch.equal(ta.local_chunked_attention(tq, tk, tv, window=8,
                                                  scale=scale), local)
    assert len(calls) > 3


def _gqa_params(rng, d=32, h=4, hkv=2, hd=8):
    return {"wq": rng.uniform(-.2, .2, (d, h * hd)),
            "wk": rng.uniform(-.2, .2, (d, hkv * hd)),
            "wv": rng.uniform(-.2, .2, (d, hkv * hd)),
            "wo": rng.uniform(-.2, .2, (h * hd, d))}


def _params(p, dt):
    pj, pt = {}, {}
    for k, v in p.items():
        pj[k], pt[k] = pair(np.asarray(v, np.float32), dt)
    return pj, pt


GQA_CASES = {
    "causal": dict(causal=True),
    "bidirectional": dict(causal=False),
    "chunked": dict(causal=True, chunk_q=8),
    "local": dict(local_window=8),
    "window >= s": dict(local_window=32),
    "nope": dict(use_rope=False),
}


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("case", list(GQA_CASES))
def test_gqa_forward_and_decode_match_reference(dt, case):
    rng = np.random.default_rng(4)
    pj, pt = _params(_gqa_params(rng), dt)
    x = rng.normal(size=(2, 16, 32)).astype(np.float32)
    jx, tx = pair(x, dt)
    jc, js = jl.rope_freqs(8, 64)
    tc, ts = tl.rope_freqs(8, 64)
    dims = dict(n_heads=4, n_kv_heads=2, head_dim=8)
    kw = GQA_CASES[case]
    pos = np.tile(np.arange(16), (2, 1))
    want, (wk, wv) = ja.gqa_forward(pj, jx, jc, js, jnp.asarray(pos),
                                    **dims, **kw)
    got, (gk, gv) = ta.gqa_forward(pt, tx, tc, ts, torch.from_numpy(pos),
                                   **dims, **kw)
    if dt == "f32":
        match(got, want)
    elif "chunk_q" in kw:
        # JAX compiles the chunk bodies; op by op it is the unchunked call
        eager = ja.gqa_forward(pj, jx, jc, js, jnp.asarray(pos), **dims)[0]
        match(got, eager)
        match(got, want, gap(want, eager))
    elif kw.get("local_window") == 8:
        # JAX compiles the window bodies; op by op each window on its own
        scale = 1.0 / jnp.sqrt(8).astype(jnp.bfloat16)
        q = jl.apply_rope((jx @ pj["wq"]).reshape(2, 16, 4, 8),
                          jnp.asarray(pos), jc, js)
        m = (jnp.arange(8)[:, None] >= jnp.arange(8)[None, :])[None, None]
        eager = jnp.concatenate(
            [ja._sdpa(q[:, w:w + 8], wk[:, w:w + 8], wv[:, w:w + 8], m,
                      scale) for w in (0, 8)], 1).reshape(2, 16, 32) @ pj["wo"]
        match(got, eager)
        match(got, want, gap(want, eager))
    else:
        match(got, want)
    for g_, w_ in ((gk, wk), (gv, wv)):
        match(g_, w_)

    # decode at position 16 against the cache of the 16 prefix tokens
    dkw = {k: v for k, v in kw.items() if k in ("local_window", "use_rope")}
    xt1 = rng.normal(size=(2, 32)).astype(np.float32)
    jx1, tx1 = pair(xt1, dt)
    ck = np.zeros((2, 24, 2, 8), np.float32)
    cv = np.zeros((2, 24, 2, 8), np.float32)
    ck[:, :16], cv[:, :16] = np_(gk), np_(gv)
    (jck, tck), (jcv, tcv) = pair(ck, dt), pair(cv, dt)
    wout, wck, wcv = ja.gqa_decode(pj, jx1, jck, jcv, jnp.int32(16), jc, js,
                                   **dims, **dkw)
    gout, gck, gcv = ta.gqa_decode(pt, tx1, tck, tcv, 16, tc, ts, **dims,
                                   **dkw)
    assert gck is tck and gcv is tcv                # written in place
    same = match
    same(gout, wout)
    same(gck, wck)
    same(gcv, wcv)


MLA = dict(n_heads=4, q_lora=16, kv_lora=8, qk_nope=8, qk_rope=4, v_head=8)


def _mla_params(rng, d=32):
    m = MLA
    h = m["n_heads"]
    return {"wq_a": rng.uniform(-.2, .2, (d, m["q_lora"])),
            "q_norm": rng.uniform(.5, 1.5, (m["q_lora"],)),
            "wq_b": rng.uniform(-.2, .2, (m["q_lora"],
                                          h * (m["qk_nope"] + m["qk_rope"]))),
            "wkv_a": rng.uniform(-.2, .2, (d, m["kv_lora"] + m["qk_rope"])),
            "kv_norm": rng.uniform(.5, 1.5, (m["kv_lora"],)),
            "wkv_b": rng.uniform(-.2, .2, (m["kv_lora"],
                                           h * (m["qk_nope"] + m["v_head"]))),
            "wo": rng.uniform(-.2, .2, (h * m["v_head"], d))}


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("chunk_q", [None, 8])
def test_mla_forward_and_absorbed_decode_match_reference(dt, chunk_q):
    rng = np.random.default_rng(5)
    pj, pt = _params(_mla_params(rng), dt)
    jmd, tmd = JMLA(**MLA), TMLA(**MLA)
    x = rng.normal(size=(2, 16, 32)).astype(np.float32)
    jx, tx = pair(x, dt)
    jc, js = jl.rope_freqs(4, 64)
    tc, ts = tl.rope_freqs(4, 64)
    pos = np.tile(np.arange(16), (2, 1))
    want, (wckv, wkpe) = ja.mla_forward(pj, jx, jc, js, jnp.asarray(pos),
                                        jmd, chunk_q=chunk_q)
    got, (gckv, gkpe) = ta.mla_forward(pt, tx, tc, ts, torch.from_numpy(pos),
                                       tmd, chunk_q=chunk_q)
    same = match
    if dt == "bf16" and chunk_q:
        eager = ja.mla_forward(pj, jx, jc, js, jnp.asarray(pos), jmd)[0]
        match(got, want, gap(want, eager))
    else:
        same(got, want)
    same(gckv, wckv)
    same(gkpe, wkpe)
    x1 = rng.normal(size=(2, 32)).astype(np.float32)
    jx1, tx1 = pair(x1, dt)
    ckv = np.zeros((2, 20, MLA["kv_lora"]), np.float32)
    kpe = np.zeros((2, 20, MLA["qk_rope"]), np.float32)
    ckv[:, :16], kpe[:, :16] = np_(gckv), np_(gkpe)
    (jckv, tckv), (jkpe, tkpe) = pair(ckv, dt), pair(kpe, dt)
    wout, w1, w2 = ja.mla_decode(pj, jx1, jckv, jkpe, jnp.int32(16), jc, js,
                                 jmd)
    gout, g1, g2 = ta.mla_decode(pt, tx1, tckv, tkpe, 16, tc, ts, tmd)
    assert g1 is tckv and g2 is tkpe
    same(gout, wout)
    same(g1, w1)
    same(g2, w2)


# --------------------------------------------------------------------------- #
# transformer                                                                  #
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("variant", ["gqa", "mla", "local"])
def test_forward_prefill_decode_match_reference(variant, dt):
    """`_torch_lm.check_against_reference` (the MoE variant is in
    `test_torch_moe`)."""
    check_against_reference(variant, dt)


@pytest.mark.parametrize("variant", ["gqa", "mla", "local"])
def test_decode_matches_teacher_forcing(variant):
    """The port's decode at position t equals its forward's logits at t
    (the JAX package's ``test_decode_matches_teacher_forcing``)."""
    _, cfg = configs(variant, "f32")
    gen = torch.Generator().manual_seed(0)
    params = tt.init_params(cfg, generator=gen)
    toks = torch.randint(0, cfg.vocab, (2, 24), generator=gen)
    hidden, _ = tt.forward(params, toks, cfg)
    want = hidden[:, 16, :] @ params["lm_head"]
    _, cache = tt.prefill(params, toks[:, :16], cfg)
    full = tt.init_cache(cfg, 2, 24, dtype=torch.float32)
    for k in full:
        full[k][:, :, :16] = cache[k]
    got, _ = tt.decode_step(params, full, toks[:, 16], 16, cfg)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-3,
                               atol=2e-3)


def test_params_from_jax_checks_the_tree_and_round_trips():
    jcfg, tcfg = configs("moe", "f32")
    jparams = jax.tree.map(np.asarray, jax.jit(
        lambda k: jt.init_params(k, jcfg))(jax.random.PRNGKey(1)))
    params = tt.params_from_jax(jparams, tcfg, device="cpu")
    assert tt.param_count(params) == jt.param_count(jparams)
    back = tt.params_to_jax(params)
    jax.tree.map(np.testing.assert_array_equal, back, jparams)
    meta = tt.init_params(tcfg, device="meta")
    assert jax.tree.map(np.shape, jparams) == tree_map(
        lambda t: tuple(t.shape), meta)
    assert meta["layers"]["ffn"]["router"].dtype == torch.float32
    held = tt.params_from_jax(jparams, tcfg, device="cpu",
                              dtype=torch.bfloat16)
    assert {t.dtype for t in tree_leaves(held)} == {torch.bfloat16}
    bad = dict(jparams, embed=jparams["embed"][:-1])
    with pytest.raises(ValueError, match="embed has shape"):
        tt.params_from_jax(bad, tcfg, device="cpu")
    with pytest.raises(ValueError, match="structure"):
        tt.params_from_jax({k: v for k, v in jparams.items()
                            if k != "final_norm"}, tcfg, device="cpu")
