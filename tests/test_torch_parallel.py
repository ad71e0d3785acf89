"""The port's sharded LM training step (``build_step(arch, "train_4k",
mesh=...)``: ZeRO-3 over the data axes, tensor parallelism over "model")
against the JAX package's single-device step, on the CPU.

The JAX package's own sharded-training test cannot run here (its mesh
axes are not found on a one-device CPU mesh), so the sharded step is held
against what that test asserts it equals: JAX's single-device
``build_step(...).init_args()`` step.  Each case starts from the JAX
parameters and runs three steps in gloo ranks (`_torch_parallel_rank.py`,
one process group a mesh size, joined through a file store in a temporary
directory), beside the JAX step and the port's unsharded step run here:

* internlm2-20b (reduced, GQA) on the JAX test's (data, model) = (4, 2);
* minicpm3-4b (MLA) and qwen3-moe (MoE, groups over the data ranks) on
  (2, 2);
* qwen3-moe on a (pod, data, model) = (2, 2, 2) mesh (``multi_pod``);
* internlm2-20b on (1, 4): its 2 KV heads over 4 model ranks, each KV
  head replicated over a run of two;
* minicpm3-4b at 2 microbatches of 4 sequences (``reduced=False`` with the
  reduced widths, as `test_torch_lm_accum`) on (2, 2);
* internlm2-20b and qwen3-moe on a (1, 1) mesh of one rank, which must be
  bit-equal to the unsharded step.

Every case runs the reference's sequence parallelism: between layers each
rank holds ``(B / dp, S / tp, d)`` of the residual stream (recorded at
every pattern group's input and output).  On (1, 4) the norms' gradients
(each model rank's part of the sequence, summed over "model") are held
against ``jax.value_and_grad`` within `_torch_train`'s gradient bound.

Losses, gradient norms, parameters and AdamW moments are held within
`_torch_train`'s tolerances; each case's sharded ``init_args`` must gather
to the unsharded init bit for bit, and its batch be the rank's rows of
each microbatch.  The mesh check raises ``ValueError`` before any
collective where the reference's jit refuses an argument (a batch that
the data ranks do not divide, FFN columns that "model" does not); the
splits it pads (query heads fewer than the "model" ranks, MoE groups that
the data ranks do not divide) build (their steps, and sequences that
"model" does not divide: `test_torch_parallel_heads.py`).
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.launch import steps as jsteps
from repro.models import transformer as jt
from repro_torch.launch import dryrun
from repro_torch.launch import steps as tsteps

from _torch_train import (GRAD_REL, LOSS_REL, NORM_REL, scalar_close,
                          state_close)
from _torch_train import one_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 180
STEPS = 3
LR = 3e-4
FIELDS = ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff",
          "vocab", "mla", "moe", "local_window")
ACCUM_SHAPE = {"seq_len": 32, "global_batch": 8}

# (world size, cases) a launch
LAUNCHES = {
    8: [dict(name="internlm2_4x2", arch="internlm2-20b", mesh=[4, 2],
             multi_pod=False),
        dict(name="qwen3_moe_2x2x2", arch="qwen3-moe-235b-a22b",
             mesh=[2, 2, 2], multi_pod=True)],
    4: [dict(name="minicpm3_2x2", arch="minicpm3-4b", mesh=[2, 2],
             multi_pod=False),
        dict(name="qwen3_moe_2x2", arch="qwen3-moe-235b-a22b", mesh=[2, 2],
             multi_pod=False),
        dict(name="minicpm3_accum_2x2", arch="minicpm3-4b", mesh=[2, 2],
             multi_pod=False, accum=True),
        dict(name="internlm2_kv_1x4", arch="internlm2-20b", mesh=[1, 4],
             multi_pod=False, norm_grads=True)],
    1: [dict(name="internlm2_1x1", arch="internlm2-20b", mesh=[1, 1],
             multi_pod=False),
        dict(name="qwen3_moe_1x1", arch="qwen3-moe-235b-a22b", mesh=[1, 1],
             multi_pod=False)],
}
CASES = {c["name"]: c for cases in LAUNCHES.values() for c in cases}


def jax_step(case):
    if not case.get("accum"):
        return jsteps.build_step(case["arch"], "train_4k", reduced=True)
    red = jreg.get_arch(case["arch"]).make_config("train_4k", True)
    over = {f: getattr(red, f) for f in FIELDS}
    over.update(dtype=jnp.float32, xent_chunk=16, chunk_q=16)
    return jsteps.build_step(case["arch"], "train_4k",
                             shape_override=ACCUM_SHAPE, cfg_override=over)


def _key(path) -> str:
    return "/".join(str(k.key) for k in path)


def _flat_jax(tree) -> dict:
    return {_key(p): np.asarray(a)
            for p, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _tree(flat: dict, prefix: str = "") -> dict:
    """Nested dicts of the arrays under ``prefix`` (keys: paths by "/")."""
    tree: dict = {}
    for k, a in flat.items():
        if not k.startswith(prefix):
            continue
        node = tree
        *head, last = k[len(prefix):].split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = torch.from_numpy(np.array(a))
    return tree


def _wait(procs, what):
    for p in procs:
        try:
            _, err = p.communicate(timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for other in procs:
                other.kill()
            pytest.fail(f"{what} ran over {TIMEOUT_S} s")
        assert p.returncode == 0, f"{what}: {err[-3000:]}"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every launch's gloo ranks, then per case: (the port's sharded
    results, JAX's losses, norms and state, the port's unsharded ones)."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    rank_script = str(ROOT / "tests" / "_torch_parallel_rank.py")
    starts, procs, dirs = {}, [], {}
    for world, cases in LAUNCHES.items():
        d = tmp_path_factory.mktemp(f"parallel{world}")
        dirs[world] = d
        for case in cases:
            jsd = jax_step(case)
            starts[case["name"]] = (jsd, jsd.init_args())
            np.savez(d / f"{case['name']}_params.npz",
                     **_flat_jax(starts[case["name"]][1][0]))
        (d / "cases.json").write_text(json.dumps(cases))
        procs.append((world, [subprocess.Popen(
            [sys.executable, rank_script, str(r), str(world), str(d)],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for r in range(world)]))
    # JAX's and the port's single-device steps while the ranks run
    out = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    for name, (jsd, (jparams, jstate, jbatch)) in starts.items():
        case = CASES[name]
        fn = jax.jit(jsd.fn)
        jm = []
        for _ in range(STEPS):
            jparams, jstate, m = fn(jparams, jstate, jbatch)
            jm.append((float(m["loss"]), float(m["grad_norm"])))
        kw = ({"shape_override": ACCUM_SHAPE, "cfg_override": _torch_over(
            case["arch"])} if case.get("accum") else {"reduced": True})
        tsd = tsteps.build_step(case["arch"], "train_4k", **kw)
        _, tstate, tbatch = tsd.init_args(device="cpu")
        tparams = _tree(_flat_jax(starts[name][1][0]))
        tm = [tsd.fn(tparams, tstate, tbatch) for _ in range(STEPS)]
        out[name] = {"jax": (jm, jparams, jstate),
                     "plain": ([(float(m["loss"]), float(m["grad_norm"]))
                                for m in tm], tparams, tstate)}
        if case.get("norm_grads"):
            jcfg = dataclasses.replace(jreg.get_arch(case["arch"]).make_config(
                "train_4k", True), max_seq=64)
            out[name]["jax_grad"] = jax.jit(jax.value_and_grad(
                lambda p: jt.loss_fn(p, jbatch, jcfg)))(starts[name][1][0])
    torch.set_num_threads(threads)
    for world, ps in procs:
        _wait(ps, f"the {world} gloo ranks")
        for case in LAUNCHES[world]:
            z = dict(np.load(dirs[world] / f"{case['name']}_torch.npz"))
            out[case["name"]]["sharded"] = z
    return out


def _torch_over(arch):
    red = tsteps.get_arch(arch).make_config("train_4k", True)
    over = {f: getattr(red, f) for f in FIELDS}
    over.update(dtype=torch.float32, xent_chunk=16, chunk_q=16)
    return over


def _sharded_state(z):
    return (_tree(z, "params/"),
            {"mu": _tree(z, "mu/"), "nu": _tree(z, "nu/"),
             "step": torch.from_numpy(z["step"])})


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_init_is_the_unsharded_init(runs, name):
    # the shards gather to the unsharded init_args bit for bit, and the
    # batch is the rank's rows of each microbatch
    assert bool(runs[name]["sharded"]["same_init"])


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_step_matches_the_jax_step(runs, name):
    z = runs[name]["sharded"]
    jm, jparams, jstate = runs[name]["jax"]
    for i, (loss, gn) in enumerate(jm):
        scalar_close(z["loss"][i], loss, LOSS_REL)
        scalar_close(z["grad_norm"][i], gn, NORM_REL)
    params, state = _sharded_state(z)
    state_close(params, state, jparams, jstate, LR, STEPS)


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_step_matches_the_unsharded_step(runs, name):
    z = runs[name]["sharded"]
    tm, tparams, tstate = runs[name]["plain"]
    for i, (loss, gn) in enumerate(tm):
        scalar_close(z["loss"][i], loss, LOSS_REL)
        scalar_close(z["grad_norm"][i], gn, NORM_REL)
    params, state = _sharded_state(z)
    state_close(params, state, jax.tree.map(lambda t: t.numpy(), tparams),
                jax.tree.map(lambda t: t.numpy(), tstate), LR, STEPS)


@pytest.mark.parametrize("name", ["internlm2_1x1", "qwen3_moe_1x1"])
def test_one_rank_mesh_is_bit_equal_to_the_unsharded_step(runs, name):
    # the rank ran the unsharded step beside the sharded one: every loss,
    # norm, parameter and moment equal
    assert bool(runs[name]["sharded"]["bit_equal"])


@pytest.mark.parametrize("name", sorted(CASES))
def test_residual_stream_is_cut_along_the_sequence(runs, name):
    # the reference's act_btd (dp, "model", None): between layers a rank
    # holds (B / dp, S / tp, d), its microbatch rows and sequence block
    case = CASES[name]
    cfg = tsteps.get_arch(case["arch"]).make_config("train_4k", True)
    b, s = (ACCUM_SHAPE["global_batch"] // 2, ACCUM_SHAPE["seq_len"]) \
        if case.get("accum") else (4, 32)
    *data, tp = case["mesh"]
    want = [[b // int(np.prod(data)), s // tp, cfg.d_model]]
    assert runs[name]["sharded"]["residual"].tolist() == want


def test_norm_gradients_over_model_match_jax(runs):
    # (1, 4): each model rank's norms see its block of the sequence; their
    # gradients, summed over "model", against jax.value_and_grad
    z = runs["internlm2_kv_1x4"]["sharded"]
    want_loss, want = runs["internlm2_kv_1x4"]["jax_grad"]
    flat = {_key(p): np.asarray(a) for p, a in
            jax.tree_util.tree_flatten_with_path(want)[0]}
    keys = sorted(k[len("grad/"):] for k in z if k.startswith("grad/"))
    assert keys == ["final_norm", "layers/attn_norm", "layers/ffn_norm"]
    for k in keys:
        top = np.abs(flat[k]).max()
        assert np.abs(z["grad/" + k] - flat[k]).max() <= GRAD_REL * top, k


def _mesh(*sizes, multi_pod=False):
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return types.SimpleNamespace(mesh_dim_names=names,
                                 size=lambda i: sizes[i])


def _built(name, sizes, arch, shape, **kw):
    """The step built on a `DeviceMesh` of ``sizes`` over a fake process
    group (`dryrun.fake_world`, rank 0): its checks passed and its context
    was made, with nothing moved."""
    with dryrun.fake_world(math.prod(sizes)):
        sd = tsteps.build_step(arch, shape, mesh=dryrun._cpu_mesh(sizes),
                               **kw)
    assert isinstance(sd, tsteps.StepDef) and sd.name == name


def test_mesh_checks_raise_before_any_collective():
    # 8 data ranks do not divide a batch of 4 sequences: the reference's
    # jit refuses the batch argument, and so does the port
    with pytest.raises(ValueError, match=r"batch/labels: dimension 0 \(4\) "
                       r"does not divide over data \(8"):
        tsteps.build_step("internlm2-20b", "train_4k", reduced=True,
                          mesh=_mesh(8, 1))
    # 4 query heads over 8 model ranks: ranks 4-7 hold none, as GSPMD
    # replicates them (the steps: `test_torch_parallel_heads.py`)
    _built("internlm2-20b:train_4k:train", (1, 8), "internlm2-20b",
           "train_4k", reduced=True,
           cfg_override={"n_heads": 4, "n_kv_heads": 2})
    # 4 data ranks divide a microbatch of 4 sequences but not its 2 MoE
    # groups: ranks 0 and 1 hold one group each, 2 and 3 none
    over = _torch_over("qwen3-moe-235b-a22b")
    over["moe"] = dataclasses.replace(over["moe"], dispatch_groups=2)
    _built("qwen3-moe-235b-a22b:train_4k:train", (4, 1),
           "qwen3-moe-235b-a22b", "train_4k",
           shape_override={"seq_len": 8, "global_batch": 32},
           cfg_override=over)
    # 32 tokens a sequence over 3 model ranks would be blocks of 11, 11
    # and 10, and the heads and the vocabulary divide, but the FFN's 128
    # columns do not: the reference's jit refuses ``w1``
    with pytest.raises(ValueError, match=r"params/layers/ffn/w1: dimension "
                       r"3 \(128\) does not divide over model \(3"):
        tsteps.build_step("internlm2-20b", "train_4k", reduced=True,
                          cfg_override={"n_heads": 6, "n_kv_heads": 3,
                                        "vocab": 513},
                          mesh=_mesh(1, 3))
    # the data axes of a multi-pod mesh are ("pod", "data")
    with pytest.raises(ValueError, match=r"batch/labels: dimension 0 \(4\) "
                       r"does not divide over pod x data \(8"):
        tsteps.build_step("internlm2-20b", "train_4k", reduced=True,
                          multi_pod=True, mesh=_mesh(2, 4, 1,
                                                     multi_pod=True))
    with pytest.raises(ValueError, match="axes"):
        tsteps.build_step("internlm2-20b", "train_4k", reduced=True,
                          mesh=_mesh(2, 1, multi_pod=False), multi_pod=True)


@pytest.mark.parametrize("arch,shape", [
    ("dlrm-mlperf", "serve_p99"), ("gat-cora", "molecule"),
    ("mind", "train_batch"), ("gat-cora", "full_graph_sm"),
    ("bert4rec", "train_batch")])
def test_other_steps_on_a_mesh_are_not_ported_yet(arch, shape):
    """The recsys and GAT steps run on a mesh now
    (`test_torch_parallel_recsys.py`); each refuses, before any collective
    (this mesh has no process group), a (3, 3) mesh that does not split
    its tables' rows, its batch or its graph's edges."""
    with pytest.raises(ValueError, match="does not split"):
        tsteps.build_step(arch, shape, reduced=True, mesh=_mesh(3, 3))
