"""The port's optimizers (``repro_torch.optim``) against ``repro.optim``.

The same parameters and the same gradients (numpy, from a seed) go through
the JAX optimizer and the port's for several steps; after each step every
parameter and state leaf is compared.  Tolerances:

* float32 leaves within 4 float32 ulp of JAX's value (the ops are JAX's,
  op for op; ``b ** step``, ``sqrt`` and ``cos`` may round differently in
  the last place);
* bfloat16 leaves equal, or within 1 bfloat16 ulp (a float32 difference of
  an ulp can round the other way);
* integer step counters equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro.optim.optimizers import apply_updates as japply
from repro_torch import optim as topt
from repro_torch.optim import optimizers as tmod

STEPS = 4


def _to_torch(a):
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _np(t):
    t = t.to_dense() if t.is_sparse else t
    return t.detach().float().numpy() if t.dtype == torch.bfloat16 \
        else t.detach().numpy()


def _close(got, want, what):
    want = np.asarray(want)
    got = np.asarray(got)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.dtype == jnp.bfloat16:
        w = want.astype(np.float32)
        ulp = np.spacing(np.abs(w).astype(jnp.bfloat16)).astype(np.float32)
        bad = np.abs(got.astype(np.float32) - w) > ulp
    elif np.issubdtype(want.dtype, np.integer):
        bad = got != want
    else:
        bad = np.abs(got - want) > 4 * np.spacing(np.abs(want))
    assert not bad.any(), (what, np.abs(got.astype(np.float64) - want.astype(
        np.float64)).max())


def _tree_close(got_tree, want_tree):
    got = jax.tree.leaves(jax.tree.map(
        _np, got_tree, is_leaf=lambda x: isinstance(x, torch.Tensor)))
    want = jax.tree_util.tree_leaves_with_path(want_tree)
    assert len(got) == len(want)
    for g, (path, w) in zip(got, want):
        _close(g, w, jax.tree_util.keystr(path))


def _params(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "emb": {"table": jnp.asarray(rng.uniform(-0.01, 0.01, (40, 8)),
                                     jnp.bfloat16)},
        "mlp": [{"w": jnp.asarray(rng.normal(size=(8, 5)), jnp.float32),
                 "b": jnp.zeros((5,), jnp.float32)},
                {"w": jnp.asarray(rng.normal(size=(5, 1)), jnp.bfloat16),
                 "b": jnp.asarray(rng.normal(size=(1,)), jnp.float32)}],
    }


def _grads(params, step):
    rng = np.random.default_rng(100 + step)
    return jax.tree.map(lambda p: jnp.asarray(
        rng.normal(size=p.shape) * rng.choice([1e-9, 1e-3, 1.0], p.shape),
        p.dtype), params)


def _route(path):
    keys = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
    return "rows" if "table" in keys else "dense"


OPTIMIZERS = {
    "sgd": lambda m: m.sgd(lr=1e-2),
    "sgd-momentum": lambda m: m.sgd(lr=3e-2, momentum=0.9),
    "sgd-schedule": lambda m: m.sgd(lr=m.warmup_cosine(0.1, 2, 10)),
    "adamw": lambda m: m.adamw(lr=1e-3),
    "adamw-schedule-decay": lambda m: m.adamw(
        lr=m.warmup_cosine(1e-2, 2, 6), b2=0.999, weight_decay=0.1),
    "make_optimizer": lambda m: m.make_optimizer("adamw", lr=2e-3),
    "partition": lambda m: m.partition_optimizer(
        _route, {"rows": m.sgd(lr=1e-2), "dense": m.adamw(lr=1e-3)}),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_steps_match_reference(name):
    make = OPTIMIZERS[name]
    jo, to = make(jopt), make(topt)
    jp = _params()
    tp = jax.tree.map(_to_torch, jp)
    js, ts = jo.init(jp), to.init(tp)
    _tree_close(ts, js)
    for step in range(STEPS):
        jg = _grads(jp, step)
        ju, js = jo.update(jg, js, jp)
        jp = japply(jp, ju)
        tu, ts = to.update(jax.tree.map(_to_torch, jg), ts, tp)
        topt.apply_updates(tp, tu)
        _tree_close(tu, ju)
        _tree_close(tp, jp)
        _tree_close(ts, js)


def test_partition_routes_tables_to_sgd_and_the_rest_to_adamw():
    opt = topt.partition_optimizer(
        lambda path: "rows" if "table" in path else "dense",
        {"rows": topt.sgd(lr=1e-2), "dense": topt.adamw(lr=1e-3)})
    tp = jax.tree.map(_to_torch, _params())
    st = opt.init(tp)
    # the state over masked trees: a leaf routed elsewhere is a 0-d zero
    assert st["rows"] == {"step": st["rows"]["step"]}
    assert st["dense"]["mu"]["emb"]["table"].shape == ()
    assert st["dense"]["mu"]["mlp"][0]["w"].shape == (8, 5)
    g = jax.tree.map(lambda p: torch.ones_like(p), tp)
    upd, st = opt.update(g, st, tp)
    # sgd's update of a table is -lr * g; adamw's first step is -lr * sign
    assert torch.equal(upd["emb"]["table"], torch.full(
        (40, 8), -1e-2, dtype=torch.bfloat16))
    np.testing.assert_allclose(upd["mlp"][0]["w"].numpy(), -1e-3, rtol=1e-6)
    assert int(st["rows"]["step"]) == int(st["dense"]["step"]) == 1


def _row_grad(ids, rows, n_rows):
    """A row gradient as `models.recsys.row_grad` returns it."""
    return torch.sparse_coo_tensor(torch.as_tensor(ids)[None], rows,
                                   (n_rows, rows.shape[1]), is_coalesced=True)


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_row_gradient_step_equals_the_dense_reference(momentum):
    # the untouched rows of JAX's dense gradient are 0: a step on the rows
    # alone is the same function, bit for bit
    rng = np.random.default_rng(3)
    table = jnp.asarray(rng.uniform(-0.01, 0.01, (50, 8)), jnp.bfloat16)
    ids = np.array([2, 7, 8, 31, 49])
    jo, to = jopt.sgd(lr=1e-2, momentum=momentum), topt.sgd(
        lr=1e-2, momentum=momentum)
    jp, tp = {"t": table}, {"t": _to_torch(table)}
    js, ts = jo.init(jp), to.init(tp)
    for step in range(STEPS):
        rows = np.zeros((50, 8), np.float32)
        rows[ids] = rng.normal(size=(5, 8))
        dense = jnp.asarray(rows, jnp.bfloat16)
        ju, js = jo.update({"t": dense}, js, jp)
        jp = japply(jp, ju)
        tg = _row_grad(ids, _to_torch(dense)[ids], 50)
        tu, ts = to.update({"t": tg}, ts, tp)
        assert tu["t"].is_sparse == (momentum == 0.0)
        topt.apply_updates(tp, tu)
        np.testing.assert_array_equal(tp["t"].view(torch.int16).numpy(),
                                      np.asarray(jp["t"]).view(np.int16))
        if momentum:
            _close(_np(ts["mom"]["t"]), js["mom"]["t"], "mom")


def test_clip_by_global_norm_matches_reference():
    jp = _params()
    for scale in (1e-3, 1.0, 1e3):
        jg = jax.tree.map(lambda g: (g.astype(jnp.float32) * scale).astype(
            g.dtype), _grads(jp, 0))
        jc, jn = jopt.clip_by_global_norm(jg, 1.0)
        tc, tn = topt.clip_by_global_norm(jax.tree.map(_to_torch, jg), 1.0)
        _close(tn.numpy(), jn, "norm")
        _tree_close(tc, jc)
        # JAX promotes a bfloat16 leaf times the float32 scale to float32
        assert tc["emb"]["table"].dtype == torch.float32
    # a row gradient has the norm of its dense gradient
    rows = torch.arange(12, dtype=torch.float32).view(3, 4)
    sp = _row_grad([1, 4, 6], rows, 9)
    c, n = topt.clip_by_global_norm({"t": sp}, 10.0)
    assert float(n) == pytest.approx(float(rows.norm()), rel=1e-6)
    assert c["t"].is_sparse
    np.testing.assert_allclose(c["t"].to_dense().numpy(),
                               (sp.to_dense() * 10.0 / n).numpy(), rtol=1e-6)


def test_warmup_cosine_matches_reference():
    for args in ((1e-3, 10, 100), (0.5, 0, 7, 0.0), (2e-2, 5, 5)):
        js, ts = jopt.warmup_cosine(*args), topt.warmup_cosine(*args)
        for step in range(0, args[2] + 3):
            _close(ts(torch.tensor(step, dtype=torch.int32)).numpy(),
                   js(jnp.int32(step)), f"{args} step {step}")


def test_row_gradients_must_be_coalesced_and_adamw_takes_dense_only():
    p = {"t": torch.zeros(6, 2)}
    rows = torch.ones(2, 2)
    loose = torch.sparse_coo_tensor(torch.tensor([[1, 1]]), rows, (6, 2))
    with pytest.raises(ValueError, match="one lookup"):
        topt.sgd().update({"t": loose}, topt.sgd().init(p), p)
    adam = topt.adamw()
    with pytest.raises(TypeError, match="dense gradients"):
        adam.update({"t": _row_grad([1, 3], rows, 6)}, adam.init(p), p)
    with pytest.raises(ValueError):
        topt.make_optimizer("lion")


def test_tree_helpers_follow_paths():
    tree = {"a": [torch.zeros(1), {"b": torch.ones(2)}], "c": torch.ones(())}
    paths = []
    tmod.tree_map_with_path(lambda p, x: paths.append(p), tree)
    assert paths == [("a", 0), ("a", 1, "b"), ("c",)]
    assert [t.shape for t in tmod.tree_leaves(tree)] == [
        (1,), (2,), ()]
