"""The port's MoE FFN (``models.moe``) and the MoE transformer against the
JAX reference, on the CPU.

``moe_apply`` runs the reference's grouped, capacity-limited dispatch:
``gcd(T, 32)`` groups, each with its own capacity, so which assignments are
dropped depends on the groups.  The same numpy inputs and JAX parameters go
through both, with drops (``capacity_factor`` < 1), with tied router
probabilities (a zero router: every token's top-k are the lowest experts,
``lax.top_k``'s rule), and at T giving 1, 2 and 32 groups.  Tolerances:
the outputs in float32 within ``2^-16`` of their largest magnitude (GEMM
sums in another order); in bfloat16 against JAX op by op, at least 98% of
the elements bit for bit and the rest within one bfloat16 ulp at the
largest magnitude; ``dropped_frac`` equal, the load-balance and z-loss
values within ``2^-20`` (float32 means).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jm
from repro_torch import utils
from repro_torch.models import moe as tm

from _torch_lm import DTYPES, check_against_reference, match

CASES = {
    # T = 7: one group (gcd(7, 32) = 1), capacity 3 of 14 assignments
    "one group, drops": (7, dict(capacity_factor=0.5)),
    # T = 6: two groups of 3 tokens
    "two groups": (6, {}),
    # T = 128: 32 groups of 4 tokens, each with its own capacity of 1
    "32 groups, drops": (128, dict(top_k=1, capacity_factor=0.25)),
    "shared expert, top-1": (12, dict(top_k=1, n_shared_experts=1,
                                      renorm_topk=False)),
    # T = 128: 32 groups of 4 tokens, top-2 renormalized, capacity 1
    "32 groups, top-2, drops": (128, dict(capacity_factor=0.25)),
}


def _moe(case: str, router: str, dt: str):
    t, kw = CASES[case]
    base = dict(n_experts=4, top_k=2, d_model=16, d_ff=8)
    base.update(kw)
    jcfg, tcfg = jm.MoEConfig(**base), tm.MoEConfig(**base)
    p = jax.tree.map(np.asarray, jm.moe_params(jax.random.PRNGKey(3), jcfg))
    if router == "zero":
        p["router"] = np.zeros_like(p["router"])
    x = np.random.default_rng(t).normal(size=(t, 16)).astype(np.float32)
    jdt, tdt = DTYPES[dt]
    jp = jax.tree.map(lambda a: jnp.asarray(a, jdt), p)
    tp = utils.tree_map(lambda a: torch.from_numpy(a).to(tdt), p)
    return (jcfg, jp, jnp.asarray(x, jdt)), (tcfg, tp,
                                             torch.from_numpy(x).to(tdt))


@pytest.mark.parametrize("case,router,dt", [
    (case, router, "f32") for case in CASES for router in ("random", "zero")
] + [("one group, drops", "random", "bf16"),
     ("32 groups, drops", "zero", "bf16")])
def test_moe_apply_matches_reference(case, router, dt):
    (jcfg, jp, jx), (tcfg, tp, tx) = _moe(case, router, dt)
    # float32 compiled; bfloat16 op by op, each op rounding as the port's
    apply = jax.jit(lambda p, x: jm.moe_apply(p, x, jcfg)) if dt == "f32" \
        else (lambda p, x: jm.moe_apply(p, x, jcfg))
    jy, jaux = apply(jp, jx)
    ty, taux = tm.moe_apply(tp, tx, tcfg)
    assert ty.dtype == tx.dtype and ty.shape == tx.shape
    match(ty, jy)
    for k in ("dropped_frac", "load_balance", "z_loss"):
        assert abs(float(taux[k]) - float(jaux[k])) <= 2.0 ** -20 * max(
            1.0, abs(float(jaux[k])))
    if "drops" in case or router == "zero":
        assert float(taux["dropped_frac"]) > 0


def test_tied_router_takes_the_lowest_experts():
    (_, _, _), (cfg, p, x) = _moe("two groups", "zero", "f32")
    probs = torch.softmax(x @ p["router"], dim=-1)
    _, top = utils.top_k(probs, 2)
    assert torch.equal(top, torch.tensor([[0, 1]] * 6))
    # a capacity of c = 2 a group: experts 0 and 1 keep the first 2 of a
    # group's 3 tokens each
    c = tm.capacity(3, cfg)
    assert c == 2
    _, aux = tm.moe_apply(p, x, cfg)
    assert float(aux["dropped_frac"]) == np.float32(1.0) - np.float32(2 / 3)


def test_tied_rows_are_resolved_together(monkeypatch):
    """Every tied row of a top-k in one `torch.topk` of int64 keys, not a
    host round trip a row (a zero router ties every token's probabilities:
    32,768 rows at a 32k prefill)."""
    x = torch.full((4096, 16), 1 / 16)
    x[7, 3] = 0.5
    calls = []
    real = torch.topk

    def counted(*a, **k):
        calls.append(a[0].dtype)
        return real(*a, **k)

    monkeypatch.setattr(torch, "topk", counted)
    vals, idx = utils.top_k(x, 4)
    assert calls == [torch.int32, torch.int64]
    assert torch.equal(idx[0], torch.arange(4))
    assert torch.equal(idx[7], torch.tensor([3, 0, 1, 2]))
    jv, ji = jax.lax.top_k(jnp.asarray(x.numpy()), 4)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


def test_capacity_matches_reference():
    for t in (1, 2, 7, 1024, 32768):
        for kw in (dict(n_experts=128, top_k=8), dict(n_experts=16, top_k=1),
                   dict(n_experts=4, top_k=2, capacity_factor=0.25)):
            jc = jm.MoEConfig(d_model=8, d_ff=8, **kw)
            tc = tm.MoEConfig(d_model=8, d_ff=8, **kw)
            assert tm.capacity(t, tc) == jm.capacity(t, jc)


def test_moe_transformer_matches_reference():
    """`_torch_lm.check_against_reference` for the MoE variant of the JAX
    package's BASE config (4 experts, top-2), in float32: the MoE's
    bfloat16 arithmetic is `test_moe_apply_matches_reference`'s, and JAX
    op by op over the four layers takes half a minute of compiling."""
    check_against_reference("moe", "f32")


@pytest.mark.parametrize("case,router", [
    ("one group, drops", "random"), ("32 groups, top-2, drops", "random"),
    ("two groups", "zero"), ("shared expert, top-1", "random")])
def test_moe_gradients_match_reference(case, router):
    """The gradient of a projection of the output plus the weighted aux
    losses (as the transformer adds them) with respect to the parameters
    and the input, against ``jax.value_and_grad``: the router's gradient
    flows through the top-k's gathered probabilities and their
    renormalization, a dropped assignment passes none.  Float32, within
    2^-16 of each leaf's largest magnitude.  (Top-1 renormalized is left
    out: the renormalization's gradient is 0 up to its rounding, which
    the two packages round in another order, and the router's gradient is
    then the aux losses' alone, 1,000 times smaller.)"""
    (jcfg, jp, jx), (tcfg, tp, tx) = _moe(case, router, "f32")
    proj = np.random.default_rng(9).normal(size=tx.shape).astype(np.float32)

    def jloss(p, x):
        y, aux = jm.moe_apply(p, x, jcfg)
        return (jnp.sum(y * proj) + 0.01 * aux["load_balance"]
                + 1e-3 * aux["z_loss"])

    want, (wp, wx) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(
        jp, jx)
    leaves = utils.tree_map(lambda t: t.clone().requires_grad_(), tp)
    x = tx.clone().requires_grad_()
    y, aux = tm.moe_apply(leaves, x, tcfg)
    got = (torch.sum(y * torch.from_numpy(proj))
           + 0.01 * aux["load_balance"] + 1e-3 * aux["z_loss"])
    got.backward()
    assert abs(float(got) - float(want)) <= 2.0 ** -20 * abs(float(want))
    for name, w in list(wp.items()) + [("x", wx)]:
        if isinstance(w, dict):                # the shared expert
            for k in w:
                match(leaves[name][k].grad, w[k])
        else:
            match(x.grad if name == "x" else leaves[name].grad, w)
    if "drops" in case:
        # a token whose every assignment was dropped gets its gradient from
        # the router alone (and the shared expert, none here)
        assert float(aux["dropped_frac"]) > 0
