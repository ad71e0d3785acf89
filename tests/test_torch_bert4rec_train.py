"""BERT4Rec's training in the port against the JAX package, on the CPU:
``bert4rec_loss`` and its gradient, the chunked backward of
``bert4rec_value_and_grad`` against the whole batch's, and three
``rs_train`` steps of ``build_step("bert4rec", "train_batch",
reduced=True)`` (the MLPerf routing: row-wise SGD(1e-2) on ``embed``,
AdamW(1e-3) on the rest).

The reduced config (512 items, 16 dims, 2 blocks, 16 tokens, 32 sampled
negatives) with the JAX package's parameters carried across
(``params_from_jax``) and the JAX step's batch (20% of the slots masked,
the rest -1).  Tolerances (`_torch_train`): losses within 2^-20, gradients
within 2^-16 of each leaf's largest magnitude.  The chunked backward
differs from the whole batch's only in the order of its sums over the
sequences (each chunk's gradient is added into the tree), so it is held
to the same tolerances; the chunked loss is ``sum_c tot_c / cnt``, summed
as the whole batch's.
"""
import jax
import numpy as np
import pytest
import torch

from repro.launch import steps as jsteps
from repro.models import recsys as jrs
from repro_torch.launch import steps as tsteps
from repro_torch.models import recsys as trs
from repro_torch.utils import tree_map

from _torch_train import (MOMENT_REL, adamw_params_close, leaves_close,
                          scalar_close, steps_match)
from _torch_train import one_thread  # noqa: F401  (autouse)


def _setup():
    jsd = jsteps.build_step("bert4rec", "train_batch", reduced=True)
    jparams, _, jbatch = jsd.init_args()
    cfg = tsteps.get_arch("bert4rec").make_config("train_batch", True)
    jcfg = jsteps.get_arch("bert4rec").make_config("train_batch", True)
    params = trs.params_from_jax("bert4rec", jax.tree.map(np.asarray,
                                                          jparams),
                                 device="cpu", reduced=True)
    batch = {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()}
    return jparams, jbatch, jcfg, params, batch, cfg


def _port_grads(params, batch, cfg, **kw):
    leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss = trs.bert4rec_loss(leaves, batch, cfg, **kw)
    loss.backward()
    return loss.detach(), tree_map(lambda p: p.grad if p.grad is not None
                                   else torch.zeros_like(p), leaves)


@pytest.mark.parametrize("chunk", [4096, 2])
def test_loss_and_gradient_match_reference(chunk):
    """One loss chunk (8 sequences), and 4 checkpointed chunks of 2."""
    jparams, jbatch, jcfg, params, batch, cfg = _setup()
    assert int((np.asarray(jbatch["labels"]) >= 0).sum()) > 0
    want, wgrads = jax.jit(jax.value_and_grad(
        lambda p: jrs.bert4rec_loss(p, jbatch, jcfg, batch_chunk=chunk)))(
            jparams)
    loss, grads = _port_grads(params, batch, cfg, batch_chunk=chunk)
    scalar_close(loss, want)
    leaves_close(grads, wgrads)
    assert float(grads["lm_head"].abs().sum()) == 0.0   # not in the loss


@pytest.mark.parametrize("chunk", [1, 3, 8])
def test_chunked_backward_matches_the_whole_batch(chunk):
    """bert4rec_value_and_grad over chunks of 1, 3 (8 = 3 + 3 + 2) and 8
    sequences against autograd of the whole batch's loss."""
    _, _, _, params, batch, cfg = _setup()
    want, wgrads = _port_grads(params, batch, cfg)
    loss, grads = trs.bert4rec_value_and_grad(params, batch, cfg,
                                              chunk=chunk)
    scalar_close(loss, want)
    leaves_close(grads, wgrads)
    assert grads["embed"].layout == torch.strided       # one dense gradient


def test_rs_train_steps_match_reference():
    jsd = jsteps.build_step("bert4rec", "train_batch", reduced=True)
    tsd = tsteps.build_step("bert4rec", "train_batch", reduced=True)
    assert tsd.name == jsd.name == "bert4rec:train_batch:train"

    def check(params, state, jparams, jstate):
        adamw_params_close(params, jparams, 1e-3, 3)
        leaves_close(state["dense"]["mu"], jstate["dense"]["mu"], MOMENT_REL)
        leaves_close(state["dense"]["nu"], jstate["dense"]["nu"], MOMENT_REL)
        assert int(state["rows"]["step"]) == int(jstate["rows"]["step"]) == 3

    steps_match(jsd, tsd, lambda tree: trs.params_from_jax(
        "bert4rec", tree, device="cpu", reduced=True), check=check)
