"""The port's LM training half against the JAX package, on the CPU:
``lm_loss``, ``loss_fn`` and their gradients, remat, and the in-place
optimizer.

The five reduced LM configs run in float32 with the JAX package's
parameters carried across (``params_from_jax``) and the same numpy tokens
and labels (some labels -1, outside the loss).  Tolerances (`_torch_train`):
losses within 2^-20 of their magnitude, gradients within 2^-16 of each
leaf's largest magnitude (float32 GEMMs and reductions in another order
than XLA's stay under 2^-17 here); remat, and the in-place optimizer
against the functional one, bit for bit (the same operations on the same
inputs on the CPU).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import transformer as jt
from repro_torch.configs import registry as treg
from repro_torch.models import transformer as tt
from repro_torch.optim import optimizers as topt
from repro_torch.utils import tree_leaves, tree_map

from _torch_train import leaves_close, scalar_close
from _torch_train import one_thread  # noqa: F401  (autouse)

LM_ARCHS = ("nemotron-4-15b", "internlm2-20b", "minicpm3-4b",
            "llama4-scout-17b-a16e", "qwen3-moe-235b-a22b")


def configs(arch: str, **over):
    """The arch's reduced ``train_4k`` config in both packages (max_seq 64,
    as `build_step` reduces it), with ``over`` replaced."""
    jcfg = jreg.get_arch(arch).make_config("train_4k", True)
    tcfg = treg.get_arch(arch).make_config("train_4k", True)
    return (dataclasses.replace(jcfg, max_seq=64, **over),
            dataclasses.replace(tcfg, max_seq=64, **over))


def batch(seed: int = 0, b: int = 4, s: int = 32, vocab: int = 512) -> dict:
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, vocab, (b, s)).astype(np.int32)
    labels[0, :5] = -1
    labels[2, -3:] = -1
    return {"tokens": rng.integers(0, vocab, (b, s)).astype(np.int32),
            "labels": labels}


def port_value_and_grad(params, np_batch, cfg):
    """loss_fn's value and its gradients through `train_view`."""
    grads = tree_map(torch.zeros_like, params)
    view = tt.train_view(params, grads, cfg)
    loss = tt.loss_fn(view, {k: torch.from_numpy(v)
                             for k, v in np_batch.items()}, cfg)
    loss.backward()
    return loss.detach(), grads


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_loss_fn_and_gradients_match_reference(arch):
    """loss_fn (the forward, 4 cross-entropy chunks of 32 tokens and, for
    the MoE models, the load-balance and z-losses) and its gradient with
    respect to every parameter (the router's through the top-k's gathered
    probabilities and their renormalization) against
    ``jax.value_and_grad``."""
    jcfg, tcfg = configs(arch, xent_chunk=32)
    jparams = jax.jit(lambda k: jt.init_params(k, jcfg))(
        jax.random.PRNGKey(0))
    b = batch()
    want_loss, want_grads = jax.jit(jax.value_and_grad(
        lambda p: jt.loss_fn(p, b, jcfg)))(jparams)
    params = tt.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                device="cpu")
    loss, grads = port_value_and_grad(params, b, tcfg)
    scalar_close(loss, want_loss)
    leaves_close(grads, want_grads)
    if tcfg.moe is not None:
        # the aux losses are in the loss: without them it is lm_loss alone
        hidden, aux = tt.forward(params, torch.from_numpy(b["tokens"]), tcfg)
        assert float(aux) > 0
        plain = tt.lm_loss(params, hidden, torch.from_numpy(b["labels"]),
                           tcfg)
        assert float(loss) == float(plain + aux)


@pytest.mark.parametrize("ck", [None, 16, 64])
def test_lm_loss_one_chunk_and_several_match_reference(ck):
    """lm_loss alone (one chunk; 8 and 2 chunks of a 128-token batch) and
    its gradients with respect to the hidden states and the head."""
    kw = dict(name="xent", n_layers=1, d_model=24, n_heads=2, n_kv_heads=2,
              head_dim=12, d_ff=32, vocab=97, xent_chunk=ck)
    jcfg = jt.TransformerConfig(remat=False, **kw)
    tcfg = tt.TransformerConfig(**kw)
    rng = np.random.default_rng(7)
    hidden = rng.normal(size=(4, 32, 24)).astype(np.float32)
    head = rng.normal(size=(24, 97)).astype(np.float32)
    labels = batch(8, vocab=97)["labels"]
    want, (wh, wl) = jax.value_and_grad(
        lambda h, w: jt.lm_loss({"lm_head": w}, h, labels, jcfg),
        argnums=(0, 1))(hidden, head)
    h = torch.from_numpy(hidden).requires_grad_()
    w = torch.from_numpy(head).requires_grad_()
    got = tt.lm_loss({"lm_head": w}, h, torch.from_numpy(labels), tcfg)
    got.backward()
    scalar_close(got, want)
    leaves_close({"h": h.grad, "w": w.grad}, {"h": wh, "w": wl})


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_remat_gradient_is_bit_equal(arch):
    """The gradient with each pattern group under a checkpoint equals the
    gradient without, bit for bit (query chunks of 8 and cross-entropy
    chunks of 32 checkpointed in both)."""
    out = []
    for remat in (False, True):
        _, cfg = configs(arch, remat=remat, chunk_q=8, xent_chunk=32)
        gen = torch.Generator().manual_seed(3)
        params = tt.init_params(cfg, generator=gen, device="cpu")
        out.append(port_value_and_grad(params, batch(1), cfg))
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(g0),
                                                 tree_leaves(g1)))


def test_train_view_writes_each_group_into_the_stacked_gradient():
    _, cfg = configs("llama4-scout-17b-a16e")
    params = tt.init_params(cfg, generator=torch.Generator().manual_seed(1),
                            device="cpu")
    grads = tree_map(torch.zeros_like, params)
    view = tt.train_view(params, grads, cfg)
    assert isinstance(view["layers"], list) and len(view["layers"]) == 1
    wq = view["layers"][0]["attn"]["wq"]
    assert wq.is_leaf and wq.data_ptr() == params["layers"]["attn"][
        "wq"].data_ptr()
    assert wq.grad.data_ptr() == grads["layers"]["attn"]["wq"].data_ptr()
    b = {k: torch.from_numpy(v) for k, v in batch(2).items()}
    tt.loss_fn(view, b, cfg).backward()
    once = tree_map(torch.clone, grads)
    tt.loss_fn(view, b, cfg).backward()       # the second adds in place
    assert all(torch.equal(g, 2 * o) for g, o in zip(tree_leaves(grads),
                                                    tree_leaves(once)))
    assert all(bool(g.abs().sum() > 0) for g in tree_leaves(once))


@pytest.mark.parametrize("piece", [1 << 24, 1000])
def test_in_place_optimizer_is_bit_equal_to_the_functional(piece,
                                                           monkeypatch):
    """clip_by_global_norm_ and adamw's update_ (weight decay on; large
    leaves in pieces of ``piece`` elements) against clip_by_global_norm,
    adamw.update and apply_updates, bit for bit over three steps."""
    monkeypatch.setattr(topt, "PIECE", piece)
    rng = np.random.default_rng(4)

    def tree():
        return {"a": torch.from_numpy(rng.normal(size=(2, 1, 700, 9)).astype(
            np.float32)), "b": [torch.from_numpy(rng.normal(size=(5,)).astype(
                np.float32))]}
    opt = topt.adamw(lr=3e-4, weight_decay=0.1)
    p_fun = tree()
    p_in = tree_map(torch.clone, p_fun)
    s_fun, s_in = opt.init(p_fun), opt.init(p_in)
    for _ in range(3):
        g = tree_map(lambda t: 3 * t, tree())
        clipped, gn = topt.clip_by_global_norm(g, 1.0)
        upd, s_fun = opt.update(clipped, s_fun, p_fun)
        topt.apply_updates(p_fun, upd)
        g_in = tree_map(torch.clone, g)
        assert torch.equal(topt.clip_by_global_norm_(g_in, 1.0), gn)
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(g_in),
                                                     tree_leaves(clipped)))
        opt.update_(g_in, s_in, p_in)
    assert float(gn) > 1.0                  # the clip scaled the gradients
    for a, b in zip(tree_leaves((p_fun, s_fun)), tree_leaves((p_in, s_in))):
        assert a.dtype == b.dtype and torch.equal(a, b)
    with pytest.raises(TypeError, match="dense float32"):
        topt.clip_by_global_norm_({"x": torch.ones(3, dtype=torch.bfloat16)},
                                  1.0)
