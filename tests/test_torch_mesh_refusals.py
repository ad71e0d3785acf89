"""The port's sharded LM steps build exactly where the reference's compile.

The reference's GSPMD pads what its step cuts unevenly inside (query or
MLA heads fewer than the "model" ranks, a sequence, a microbatch or MoE
groups that the ranks do not divide), and its ``jax.jit`` refuses an
argument that a mesh axis does not divide (a vocabulary, experts, a decode
cache, a serving batch, a ZeRO dimension).  One subprocess (8 host
devices, ``XLA_FLAGS`` set before JAX is imported, Auto mesh axes, as
`test_multidevice.run_sub` spawns one) compiles the reference's step of
each case below; here the port's ``build_step`` builds it on a
`DeviceMesh` over a fake process group (`dryrun.fake_world`: its context
is made, nothing moves), or raises ``ValueError``.  Each case is the
reduced config's widths at a small shape, with only the named count
departing.  (The training steps take
most of the subprocess's 30-40 s; the MLA heads' is left to the gloo
test of `test_torch_parallel_heads.py`.)
"""
import dataclasses
import json
import math
import os
import subprocess
import sys

import pytest

from repro_torch.launch import dryrun
from repro_torch.launch import steps as tsteps

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEMOTRON, MINICPM3 = "nemotron-4-15b", "minicpm3-4b"
QWEN3 = "qwen3-moe-235b-a22b"
SMALL = {"seq_len": 32, "global_batch": 4}
# name: (arch, cell, (data, model), shape override, departing counts,
# whether the reference compiles it)
CASES = {
    # 4 query heads (2 KV heads) over 8 model ranks
    "heads_train": (NEMOTRON, "train_4k", (1, 8), SMALL, {}, True),
    "heads_prefill": (NEMOTRON, "prefill_32k", (1, 8), SMALL, {}, True),
    "heads_decode": (NEMOTRON, "decode_32k", (1, 8), SMALL, {}, True),
    # 4 MLA heads over 8 model ranks
    "mla_heads_prefill": (MINICPM3, "prefill_32k", (1, 8), SMALL, {},
                          True),
    "mla_heads_decode": (MINICPM3, "decode_32k", (1, 8), SMALL, {}, True),
    # a sequence of 36 over 8 model ranks (8 heads)
    "sequence_train": (NEMOTRON, "train_4k", (1, 8),
                       {"seq_len": 36, "global_batch": 4},
                       {"n_heads": 8}, True),
    "sequence_prefill": (NEMOTRON, "prefill_32k", (1, 8),
                         {"seq_len": 36, "global_batch": 4},
                         {"n_heads": 8}, True),
    # 2 microbatches of 4 sequences over 8 data ranks
    "microbatch_train": (NEMOTRON, "train_4k", (8, 1),
                         {"seq_len": 32, "global_batch": 8}, {}, True),
    # 8 microbatches of one sequence of 36: gcd(36, 32) = 4 MoE groups
    # over 8 data ranks
    "moe_groups_train": (QWEN3, "train_4k", (8, 1),
                         {"seq_len": 36, "global_batch": 8}, {}, True),
    # decode at batch 6 over 3 data ranks: 2 MoE groups over 3 (a width
    # that 3 divides: the ZeRO split of d_model)
    "moe_groups_decode": (QWEN3, "decode_32k", (3, 1),
                          {"seq_len": 32, "global_batch": 6},
                          {"d_model": 96}, True),
    # what the reference's jit refuses
    "vocab_over_model": (NEMOTRON, "train_4k", (1, 8), SMALL,
                         {"n_heads": 8, "vocab": 500}, False),
    "experts_over_model": (QWEN3, "train_4k", (1, 8),
                           {"seq_len": 32, "global_batch": 8},
                           {"n_heads": 8, "n_experts": 6}, False),
    "decode_cache_over_model": (NEMOTRON, "decode_32k", (1, 8),
                                {"seq_len": 36, "global_batch": 4},
                                {"n_heads": 8}, False),
    "serving_batch_over_data": (NEMOTRON, "decode_32k", (8, 1), SMALL, {},
                                False),
    "global_batch_over_data": (NEMOTRON, "train_4k", (4, 1),
                               {"seq_len": 32, "global_batch": 6}, {},
                               False),
}
FIELDS = ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff",
          "vocab", "mla", "moe", "local_window")


def cfg_override(reg, arch: str, counts: dict) -> dict:
    """The reduced config's widths (``reg``: either package's registry)
    with ``counts`` replaced: ``n_heads``, ``vocab``, ``n_experts`` or
    ``d_model`` (the MoE's too)."""
    red = reg.get_arch(arch).make_config("train_4k", True)
    over = {f: getattr(red, f) for f in FIELDS}
    over["max_seq"] = 128
    for k, v in counts.items():
        if k == "n_experts":
            over["moe"] = dataclasses.replace(red.moe, n_experts=v)
        elif k == "d_model" and red.moe is not None:
            over["moe"] = dataclasses.replace(red.moe, d_model=v)
            over[k] = v
        else:
            over[k] = v
    return over


SUB = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json, sys
sys.path.insert(0, "src")
sys.path.insert(0, "tests")
import jax, numpy as np
from jax.sharding import AxisType, Mesh
from repro.configs import registry
from repro.launch.dryrun import _compile_cell
from test_torch_mesh_refusals import CASES, cfg_override
out = {}
for name, (arch, cell, shape, size, counts, _) in CASES.items():
    mesh = Mesh(np.array(jax.devices()[:shape[0] * shape[1]]).reshape(shape),
                ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    try:
        _compile_cell(arch, cell, mesh, False, size,
                      cfg_override(registry, arch, counts))
        out[name] = None
    except Exception as e:
        out[name] = str(e).splitlines()[0][:300]
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference():
    """Each case's compile in the reference: None, or its refusal."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", SUB], capture_output=True,
                         text=True, cwd=REPO_ROOT, timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("name", sorted(CASES))
def test_the_port_builds_where_the_reference_compiles(reference, name):
    arch, cell, shape, size, counts, compiles = CASES[name]
    assert (reference[name] is None) == compiles, reference[name]
    try:
        with dryrun.fake_world(math.prod(shape)):
            tsteps.build_step(arch, cell, shape_override=size,
                              cfg_override=cfg_override(tsteps, arch, counts),
                              mesh=dryrun._cpu_mesh(shape))
        refusal = None
    except ValueError as e:
        refusal = str(e)
    assert (refusal is None) == compiles, refusal
    if not compiles:
        # both name the same argument ("params['embed']" against
        # "params/embed: ...")
        path = refusal.split(":")[0].split("/")
        want = path[0] + "".join(f"['{k}']" for k in path[1:])
        assert want in reference[name], (want, reference[name])
