"""The port's GAT (`models.gnn`) and its training steps against the JAX
package's ``repro.models.gnn``, on the CPU.

The same numpy graphs and the JAX package's parameters (carried across by
``params_from_jax``) go through both: a full graph with isolated nodes
(no self loop), duplicate edges (equal scores tied at their segment's
max, whose gradient JAX splits evenly among them) and padded edges; a
pooled graph; the minibatch regime's sampled hops; a batch of small
graphs.  Then three steps of each ``gat-cora`` shape at the reduced size
(`launch.steps.build_step`), and the host sampler.  Tolerances
(`_torch_train`): losses within 2^-20, gradients within 2^-16 of each
leaf's largest magnitude, the steps as `steps_match` states them (AdamW at
5e-3); the sampler's samples and the chunked scatter sum bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.launch import steps as jsteps
from repro.models import gnn as jg
from repro_torch.configs import registry as treg
from repro_torch.launch import steps as tsteps
from repro_torch.models import gnn as tg
from repro_torch.utils import tree_map

from _torch_train import leaves_close, scalar_close, steps_match
from _torch_train import one_thread  # noqa: F401  (autouse)

N, E, D = 23, 70, 16


def _cfgs(**over):
    j = jreg.get_arch("gat-cora").make_config("full_graph_sm", True)
    t = treg.get_arch("gat-cora").make_config("full_graph_sm", True)
    return dataclasses.replace(j, **over), dataclasses.replace(t, **over)


def _graph(seed: int) -> dict:
    """N nodes, of which nodes 0-2 have no incoming edge and 3 only a self
    loop; E random edges, each of the first 10 twice; 6 padded edges."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, N, E)
    dst = rng.integers(4, N, E)
    src, dst = np.r_[src, src[:10], 3, np.zeros(6, int)], \
        np.r_[dst, dst[:10], 3, np.zeros(6, int)]
    mask = np.r_[np.ones(E + 11, bool), np.zeros(6, bool)]
    return {"x": rng.normal(size=(N, D)).astype(np.float32),
            "src": src.astype(np.int32), "dst": dst.astype(np.int32),
            "edge_mask": mask,
            "labels": rng.integers(0, 3, N).astype(np.int32),
            "mask": rng.random(N) < 0.7, "label": np.int32(2)}


def _minibatch(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"x0": rng.normal(size=(5, D)).astype(np.float32),
            "x1": rng.normal(size=(5, 3, D)).astype(np.float32),
            "x2": rng.normal(size=(5, 3, 2, D)).astype(np.float32),
            "labels": rng.integers(0, 3, 5).astype(np.int32)}


def _batched(seed: int) -> dict:
    """Graphs of 10 nodes and 12 edges (isolated nodes, no self loops)."""
    rng = np.random.default_rng(seed)
    return {"x": rng.normal(size=(4, 10, D)).astype(np.float32),
            "src": rng.integers(0, 10, (4, 12)).astype(np.int32),
            "dst": rng.integers(0, 10, (4, 12)).astype(np.int32),
            "labels": rng.integers(0, 3, 4).astype(np.int32)}


REGIMES = {
    "full": (jg.loss_full, tg.loss_full, _graph, {}),
    "full, unpadded": (jg.loss_full, tg.loss_full, _graph, {}),
    "pooled": (jg.loss_full, tg.loss_full, _graph, {"graph_pool": True}),
    "minibatch": (jg.loss_minibatch, tg.loss_minibatch, _minibatch, {}),
    "batched graphs": (jg.loss_batched_graphs, tg.loss_batched_graphs,
                       _batched, {"graph_pool": True}),
}


@pytest.mark.parametrize("regime", REGIMES)
def test_gat_losses_and_gradients_match_reference(regime):
    jloss, tloss, make, over = REGIMES[regime]
    jcfg, cfg = _cfgs(**over)
    batch = make(5)
    if regime == "full, unpadded":
        batch = {k: v for k, v in batch.items() if k != "edge_mask"}
        batch["src"], batch["dst"] = batch["src"][:-6], batch["dst"][:-6]
    jparams = jg.init_params(jax.random.PRNGKey(1), jcfg)
    want, wgrads = jax.jit(jax.value_and_grad(
        lambda p: jloss(p, batch, jcfg)))(jparams)
    params = tg.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                device="cpu")
    loss, grads = tg.value_and_grad(
        tloss, params, {k: torch.from_numpy(np.asarray(v))
                        for k, v in batch.items()}, cfg)
    scalar_close(loss, want)
    leaves_close(grads, wgrads)


def test_tied_segment_max_splits_the_gradient_as_jax():
    """segment_max's gradient where entries tie at a segment's max (and an
    empty segment, whose -inf max is set to 0 by the caller)."""
    e = np.array([[1.0, 2.0], [3.0, 2.0], [3.0, -1.0], [0.5, 2.0]],
                 np.float32)
    seg = np.array([1, 1, 1, 3])
    w = np.arange(8, dtype=np.float32).reshape(4, 2)

    def jf(x):
        m = jax.ops.segment_max(x, jnp.asarray(seg), num_segments=4)
        return jnp.sum(jnp.where(jnp.isfinite(m), m, 0.0) * w)

    want = jax.grad(jf)(e)
    x = torch.from_numpy(e).requires_grad_()
    m = tg.segment_max(x, torch.from_numpy(seg), 4)
    assert torch.isinf(m[0]).all() and torch.isinf(m[2]).all()
    torch.sum(torch.where(torch.isfinite(m), m, 0.0)
              * torch.from_numpy(w)).backward()
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(want))
    assert x.grad[1, 0] == x.grad[2, 0] == 1.0          # 2 / 2, split


def test_chunked_scatter_sum_is_bit_equal(monkeypatch):
    """edge_aggregate in chunks of 7 edges equals one chunk, forward and
    backward, bit for bit."""
    rng = np.random.default_rng(2)
    alpha = torch.from_numpy(rng.random((50, 3)).astype(np.float32))
    h = torch.from_numpy(rng.normal(size=(9, 3, 4)).astype(np.float32))
    src = torch.from_numpy(rng.integers(0, 9, 50))
    dst = torch.from_numpy(rng.integers(0, 9, 50))
    g = torch.from_numpy(rng.normal(size=(9, 3, 4)).astype(np.float32))
    out = []
    for chunk in (1 << 22, 7):
        monkeypatch.setattr(tg, "EDGE_CHUNK", chunk)
        a, hh = alpha.clone().requires_grad_(), h.clone().requires_grad_()
        y = tg.edge_aggregate(a, hh, src, dst, 9)
        y.backward(g)
        out.append((y.detach(), a.grad, hh.grad))
    for u, v in zip(*out):
        assert torch.equal(u, v)
    # the reference's formula, with autograd through the (E, H, dh) messages
    a, hh = alpha.clone().requires_grad_(), h.clone().requires_grad_()
    y = tg.segment_sum(a[:, :, None] * hh[src], dst, 9)
    y.backward(g)
    for u, v in zip(out[0], (y.detach(), a.grad, hh.grad)):
        torch.testing.assert_close(u, v, rtol=2.0 ** -20, atol=2.0 ** -20)


@pytest.mark.parametrize("shape", list(treg.GNN_SHAPES))
def test_gnn_steps_match_reference(shape):
    jsd = jsteps.build_step("gat-cora", shape, reduced=True)
    tsd = tsteps.build_step("gat-cora", shape, reduced=True)
    assert tsd.name == jsd.name == f"gat-cora:{shape}:train"
    cfg = treg.get_arch("gat-cora").make_config(shape, True)
    steps_match(jsd, tsd,
                lambda tree: tg.params_from_jax(tree, cfg, device="cpu"),
                lr=5e-3)


def test_gnn_model_flops_and_configs_match_reference():
    for shape, sh in jreg.GNN_SHAPES.items():
        assert treg.GNN_SHAPES[shape] == sh
        for reduced in (True, False):
            jcfg = jreg.get_arch("gat-cora").make_config(shape, reduced)
            tcfg = treg.get_arch("gat-cora").make_config(shape, reduced)
            assert {f.name: getattr(tcfg, f.name) for f in
                    dataclasses.fields(tcfg) if f.name != "dtype"} == \
                {f.name: getattr(jcfg, f.name) for f in
                 dataclasses.fields(jcfg) if f.name != "dtype"}
        assert tsteps.gnn_model_flops(tcfg, sh) == \
            jsteps.gnn_model_flops(jcfg, sh)
    # the full graph's padding: 2,708 nodes and 13,264 edges to 3,072 and
    # 13,312, as the reference pads them
    _, _, batch = tsteps.build_step("gat-cora", "full_graph_sm").init_args(
        device="cpu")
    assert batch["x"].shape == (3072, 1433) and batch["src"].shape == (
        13312,)
    assert int(batch["edge_mask"].sum()) == 13264
    assert int(batch["mask"].sum()) == 2708


def test_neighbor_sampler_draws_the_references_samples():
    rng = np.random.default_rng(3)
    deg = rng.integers(0, 5, 40)
    deg[[0, 7]] = 0                                   # isolated nodes
    indptr = np.r_[0, np.cumsum(deg)]
    indices = rng.integers(0, 40, indptr[-1])
    a, b = jg.NeighborSampler(indptr, indices, 11), \
        tg.NeighborSampler(indptr, indices, 11)
    for seeds in (np.array([0, 3, 7, 9]), rng.integers(0, 40, 16)):
        for x, y in zip(a.sample(seeds, (3, 2)), b.sample(seeds, (3, 2))):
            np.testing.assert_array_equal(x, y)
    hops = b.sample(np.array([0, 7]), (2,))
    np.testing.assert_array_equal(hops[1], [[0, 0], [7, 7]])  # themselves


def test_params_from_jax_checks_shapes():
    jcfg, cfg = _cfgs()
    tree = jax.tree.map(np.asarray, jg.init_params(jax.random.PRNGKey(0),
                                                   jcfg))
    params = tg.params_from_jax(tree, cfg, device="cpu")
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(
            tree_map(lambda t: t.numpy(), params))):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="has shape"):
        tg.params_from_jax(tree, dataclasses.replace(cfg, d_in=8),
                           device="cpu")
