"""A checkpoint that the JAX package's trainer (``repro.launch.train``)
wrote resumes in the port's (``repro_torch.launch.train``), on the CPU: a
reduced LM (minicpm3-4b, ``train_4k``: AdamW) and a reduced recsys arch
(MIND, ``train_batch``: row-wise SGD on its item table, AdamW on the
bilinear map).  (DLRM's bfloat16 table is left out: the JAX trainer
cannot resume its own checkpoint of it, ``jnp.asarray`` refusing the
two-byte records that ``np.save`` wrote for it.)

The JAX trainer runs steps 0-1 and saves step 1; the port restores it into
its own ``(params, opt_state)`` tree, which must equal the saved leaves bit
for bit (the same tree layout, dtypes included); then both trainers resume
and run steps 2-3 on the same data.  Tolerances (`_torch_train`): the two
losses within 2^-20; the saved step-3 states as `state_close` states them
for AdamW after four steps (MIND's table, updated by SGD, within 4
float32 ulp of its largest magnitude).
"""
import json
import shutil

import jax
import numpy as np
import pytest
import torch

from repro.ft.checkpoint import CheckpointManager as JManager
from repro.launch import steps as jsteps
from repro.launch import train as jtrain
from repro_torch.ft.checkpoint import CheckpointManager
from repro_torch.launch import train as ttrain

from _torch_train import (MOMENT_REL, adamw_params_close, leaves_close,
                          scalar_close, state_close)
from _torch_train import one_thread  # noqa: F401  (autouse)

ARCHS = {"minicpm3-4b": 3e-4, "mind": 1e-3}


def _losses(path) -> list:
    return [json.loads(x) for x in path.read_text().splitlines()]


def _port_state(arch, ck, step):
    _, model, opt_state, _ = ttrain.setup(arch, reduced=True, device="cpu")
    tree, s, _ = CheckpointManager(str(ck)).restore(
        (ttrain.params_of(model), opt_state), step=step)
    assert s == step
    return tree


def _jax_state(arch, ck, step):
    params, opt_state, _ = jsteps.build_step(arch, ttrain.default_shape(
        jsteps.get_arch(arch)), reduced=True).init_args()
    tree, s, _ = JManager(str(ck)).restore((params, opt_state), step=step)
    assert s == step
    return tree


@pytest.mark.parametrize("arch", ARCHS)
def test_a_jax_checkpoint_resumes_in_the_port(arch, tmp_path, capsys):
    jck, tck = tmp_path / "jax", tmp_path / "port"
    common = ["--arch", arch, "--reduced", "--ckpt-every", "100"]
    jtrain.main(common + ["--steps", "2", "--ckpt-dir", str(jck)])
    shutil.copytree(jck, tck)

    # leaf for leaf: the port's tree restored from the JAX checkpoint
    saved, _, _ = JManager(str(jck)).restore_flat(1)
    restored = _port_state(arch, tck, 1)
    got = jax.tree.leaves(restored, is_leaf=lambda t: isinstance(
        t, torch.Tensor))
    assert len(got) == len(saved)
    for t, a in zip(got, saved):
        assert t.numpy().dtype == a.dtype
        np.testing.assert_array_equal(t.numpy(), a)

    jtrain.main(common + ["--steps", "4", "--resume", "--ckpt-dir", str(jck),
                          "--log", str(tmp_path / "jax.jsonl")])
    ttrain.main(common + ["--steps", "4", "--resume", "--ckpt-dir", str(tck),
                          "--device", "cpu",
                          "--log", str(tmp_path / "port.jsonl")])
    assert capsys.readouterr().out.count("resumed from step 1") == 2
    want, got = _losses(tmp_path / "jax.jsonl"), _losses(
        tmp_path / "port.jsonl")
    assert [x["step"] for x in got] == [x["step"] for x in want] == [2, 3]
    for g, w in zip(got, want):
        scalar_close(g["loss"], w["loss"])

    (params, state) = _port_state(arch, tck, 3)
    (jparams, jstate) = _jax_state(arch, jck, 3)
    if arch == "minicpm3-4b":
        state_close(params, state, jparams, jstate, ARCHS[arch], 4)
        return
    table = params.pop("items").numpy()
    jtable = np.asarray(jparams.pop("items"))
    top = np.abs(jtable).max()
    assert np.abs(table - jtable).max() <= 4 * np.spacing(top)
    adamw_params_close(params, jparams, ARCHS[arch], 4)
    leaves_close(state["dense"]["mu"], jstate["dense"]["mu"], MOMENT_REL)
    leaves_close(state["dense"]["nu"], jstate["dense"]["nu"], MOMENT_REL)
    assert int(state["dense"]["step"]) == int(jstate["dense"]["step"]) == 4
