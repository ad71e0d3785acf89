"""The port's ``train_4k`` step (`launch.steps.build_step`) of the five
reduced LMs against the JAX package's, three steps, on the CPU.

At the reduced configs a step is one microbatch (``accum`` 1): `loss_fn`
over 4 sequences of 32 tokens, its gradient, the clip at a global norm of
1 and AdamW(3e-4, weight decay 0.1), in place.  The JAX step's
``init_args()`` gives the parameters (carried across by
``params_from_jax``); the port's ``init_args`` must give the same tokens
and labels from ``default_rng(0)`` and the same optimizer state.
Tolerances: `_torch_train` (each step's loss and gradient norm; the
parameters and the moments after the three steps).
"""
import dataclasses

import pytest
import torch

from repro.launch import steps as jsteps
from repro_torch.configs import registry as treg
from repro_torch.launch import steps as tsteps
from repro_torch.models import transformer as tt
from repro_torch.utils import tree_leaves

from _torch_train import steps_match
from _torch_train import one_thread  # noqa: F401  (autouse)

LM_ARCHS = ("nemotron-4-15b", "internlm2-20b", "minicpm3-4b",
            "llama4-scout-17b-a16e", "qwen3-moe-235b-a22b")


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_train_steps_match_reference(arch):
    jsd = jsteps.build_step(arch, "train_4k", reduced=True)
    tsd = tsteps.build_step(arch, "train_4k", reduced=True)
    assert tsd.name == jsd.name == f"{arch}:train_4k:train"
    assert tsd.model_flops == jsd.model_flops == 0.0
    cfg = dataclasses.replace(
        treg.get_arch(arch).make_config("train_4k", True), max_seq=64)
    params, state, batch = steps_match(
        jsd, tsd, lambda tree: tt.params_from_jax(tree, cfg, device="cpu"))
    assert {t.dtype for t in tree_leaves(params)} == {torch.float32}
    assert tuple(batch["tokens"].shape) == (4, 32)


def test_train_step_holds_float32_parameters_and_reports_the_norm():
    sd = tsteps.build_step("minicpm3-4b", "train_4k", reduced=True)
    params, state, batch = sd.init_args(device="cpu")
    assert {t.dtype for t in tree_leaves(params)} == {torch.float32}
    assert set(state) == {"mu", "nu", "step"} and int(state["step"]) == 0
    before = [t.clone() for t in tree_leaves(params)]
    m = sd.fn(params, state, batch)
    assert set(m) == {"loss", "grad_norm"} and int(state["step"]) == 1
    assert all(not torch.equal(a, b) for a, b in zip(before,
                                                     tree_leaves(params)))
    assert tsteps.lm_accum(treg.get_arch("minicpm3-4b").make_config(
        "train_4k", False), False) == 2
    assert tsteps.lm_accum(treg.get_arch("qwen3-moe-235b-a22b").make_config(
        "train_4k", False), False) == 8
