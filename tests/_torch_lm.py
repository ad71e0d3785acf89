"""Helpers of the LM tests (`test_torch_transformer`, `test_torch_moe`,
`test_torch_lm_steps`): tolerances, the JAX package's BASE transformer
config and its variants in both packages, and one forward/prefill/decode
run of each held against the reference."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models import transformer as jt
from repro.models.attention import MLADims as JMLA
from repro.models.moe import MoEConfig as JMoE
from repro_torch.models import transformer as tt
from repro_torch.models.attention import MLADims as TMLA
from repro_torch.models.moe import MoEConfig as TMoE
from repro_torch.utils import to_tensor

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
F32_REL = 2.0 ** -16


def bf16_ulp(magnitude: float) -> float:
    """One bfloat16 ulp at ``magnitude`` (8 significant bits): 2^(e - 7)
    for a magnitude in [2^e, 2^(e + 1))."""
    return 2.0 ** (np.floor(np.log2(max(magnitude, 2.0 ** -126))) - 7)

BASE = dict(n_layers=4, d_model=32, n_heads=4, n_kv_heads=2, head_dim=8,
            d_ff=64, vocab=97, max_seq=64)


def np_(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy().astype(np.float64)
    return np.asarray(jnp.asarray(a).astype(jnp.float32), np.float64)


def gap(a, b) -> float:
    return float(np.abs(np_(a) - np_(b)).max())


def match(got, want, spread: float = 0.0):
    """|got - want| <= 2 * spread + 2^-16 of the largest magnitude of
    ``want`` (float32) or one bfloat16 ulp at it; with no spread a
    bfloat16 array (of 100 elements or more) equals ``want`` bit for bit in
    at least 98% of its elements."""
    g, w = np_(got), np_(want)
    assert g.shape == w.shape
    top = max(np.abs(w).max(), 1e-30)
    tol = 2 * spread + (F32_REL * top if got.dtype == torch.float32
                        else bf16_ulp(top))
    assert np.abs(g - w).max() <= tol, (np.abs(g - w).max(), spread, tol)
    if got.dtype == torch.bfloat16 and not spread and g.size >= 100:
        assert np.mean(g == w) >= 0.98, np.mean(g == w)


def bits_equal(got, want):
    np.testing.assert_array_equal(np_(got), np_(want))


def pair(x: np.ndarray, dt):
    return jnp.asarray(x, DTYPES[dt][0]), torch.from_numpy(x).to(DTYPES[dt][1])


def configs(variant: str, dt: str):
    kj, kt = dict(BASE), dict(BASE)
    if variant == "mla":
        kj.update(attn="mla", mla=JMLA(4, 16, 8, 8, 4, 8))
        kt.update(attn="mla", mla=TMLA(4, 16, 8, 8, 4, 8))
    if variant == "moe":
        kj["moe"], kt["moe"] = JMoE(4, 2, 32, 16), TMoE(4, 2, 32, 16)
    if variant == "local":
        for kw in (kj, kt):
            kw.update(layer_pattern=("local", "local", "local",
                                     "global_nope"), local_window=8)
    jcfg = jt.TransformerConfig(name=variant, remat=False,
                                dtype=DTYPES[dt][0], **kj)
    tcfg = tt.TransformerConfig(name=variant, dtype=DTYPES[dt][1], **kt)
    return jcfg, tcfg


# a prompt of P tokens (the forward and the prefill run over it: one set of
# shapes, which JAX run op by op compiles once) and the token decoded at P
P = 24
TOKENS = np.random.default_rng(6).integers(0, 97, (2, P + 1)).astype(np.int32)


def jax_run(params, cfg) -> dict:
    """JAX's forward and prefill over the prompt, and the decode of token
    P against a cache of P + 8 holding the prefill's."""
    toks = jnp.asarray(TOKENS)
    hidden, aux = jt.forward(params, toks[:, :P], cfg)
    logits, cache = jt.prefill(params, toks[:, :P], cfg)
    full = jax.tree.map(
        lambda f, p: jax.lax.dynamic_update_slice_in_dim(
            f, p.astype(f.dtype), 0, 2), jt.init_cache(cfg, 2, P + 8), cache)
    dlogits, dcache = jt.decode_step(params, full, toks[:, P], jnp.int32(P),
                                     cfg)
    return dict(hidden=hidden, aux=aux, logits=logits, cache=cache,
                dlogits=dlogits, dcache=dcache)


def port_run(params, cfg, jax_cache) -> dict:
    """The port's forward, prefill and decode; the decode reads JAX's
    prefill cache (``jax_cache``), so that a bfloat16 rounding of the
    cache that went the other way does not reach the decode's check."""
    t = torch.from_numpy(TOKENS)
    hidden, aux = tt.forward(params, t[:, :P], cfg)
    logits, cache = tt.prefill(params, t[:, :P], cfg)
    full = tt.init_cache(cfg, 2, P + 8)
    for k in full:
        full[k][:, :, :P] = to_tensor(np.asarray(jax_cache[k]), "cpu")
    dlogits, dcache = tt.decode_step(params, full, t[:, P], P, cfg)
    assert dcache is full                            # written in place
    return dict(hidden=hidden, aux=aux, logits=logits, cache=cache,
                dlogits=dlogits, dcache=dcache)


def leaves(run: dict) -> dict:
    out = {}
    for name, v in run.items():
        for k, leaf in (v.items() if isinstance(v, dict) else [(None, v)]):
            out[name if k is None else f"{name}.{k}"] = leaf
    return out


def check_against_reference(variant: str, dt: str) -> None:
    """The port's forward, prefill and decode of ``variant`` at BASE against
    JAX's.  float32: against JAX compiled (``jax.jit``).  bfloat16: against
    JAX op by op (``unroll_scans``), where each op rounds as the port's
    does; the windows of 'local' are ``jax.checkpoint`` bodies, compiled
    either way, so that variant is held to JAX's own compiled-vs-op-by-op
    spread of each output."""
    jcfg, cfg = configs(variant, dt)
    jparams = jax.jit(lambda k: jt.init_params(k, jcfg))(
        jax.random.PRNGKey(0))
    params = tt.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                device="cpu")
    compiled = jax.jit(lambda p: jax_run(p, jcfg))
    if dt == "f32":
        ref = compiled(jparams)
        got = leaves(port_run(params, cfg, ref["cache"]))
        for name, want in leaves(ref).items():
            if "cache" in name:
                # float32 values rounded to the bfloat16 cache: a value a
                # few float32 ulp from a rounding boundary goes either way
                match(got[name].float(), want.astype(jnp.float32),
                      bf16_ulp(np.abs(np_(want)).max()))
            else:
                match(got[name], want)
        return
    eager = jax_run(jparams, dataclasses.replace(jcfg, unroll_scans=True))
    got = leaves(port_run(params, cfg, eager["cache"]))
    assert got["hidden"].dtype == got["logits"].dtype == cfg.dtype
    eager = leaves(eager)
    spread = {}
    if variant == "local":
        spread = {name: gap(want, eager[name])
                  for name, want in leaves(compiled(jparams)).items()}
    for name, want in eager.items():
        match(got[name], want, spread.get(name, 0.0))
