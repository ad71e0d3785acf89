"""The accumulation path of the port's ``train_4k`` step against the JAX
package's, on the CPU: ``reduced=False`` with the widths shrunk through
``cfg_override`` (the reduced config's layers, widths, heads, MLA and MoE,
in float32) and ``shape_override={"seq_len": 32, "global_batch": 8}``, so
that a step is ``accum`` = 2 microbatches of 4 sequences for a dense model
(minicpm3-4b) and 8 of one sequence for an MoE model (llama4-scout,
qwen3-moe), as at full width.  The full
config's remat stays on, and query chunks of 16 and cross-entropy chunks
of 16 tokens run checkpointed.  Three steps; tolerances: `_torch_train`.
"""
import dataclasses

import jax.numpy as jnp
import pytest
import torch

from repro.configs import registry as jreg
from repro.launch import steps as jsteps
from repro_torch.configs import registry as treg
from repro_torch.launch import steps as tsteps
from repro_torch.models import transformer as tt

from _torch_train import steps_match
from _torch_train import one_thread  # noqa: F401  (autouse)

# a dense model (2 microbatches; MLA) and both MoE models (8; top-8
# renormalized, and top-1 with a shared expert and local windows)
LM_ARCHS = ("minicpm3-4b", "llama4-scout-17b-a16e", "qwen3-moe-235b-a22b")
FIELDS = ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff",
          "vocab", "mla", "moe", "local_window")
SHAPE = {"seq_len": 32, "global_batch": 8}


def overrides(arch: str):
    """The reduced config's widths in each package, float32, chunks of 16."""
    out = []
    for reg, f32 in ((jreg, jnp.float32), (treg, torch.float32)):
        red = reg.get_arch(arch).make_config("train_4k", True)
        out.append({**{f: getattr(red, f) for f in FIELDS}, "dtype": f32,
                    "xent_chunk": 16, "chunk_q": 16})
    return out


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_accumulation_matches_reference(arch):
    jover, tover = overrides(arch)
    jsd = jsteps.build_step(arch, "train_4k", shape_override=SHAPE,
                            cfg_override=jover)
    tsd = tsteps.build_step(arch, "train_4k", shape_override=SHAPE,
                            cfg_override=tover)
    cfg = dataclasses.replace(
        treg.get_arch(arch).make_config("train_4k", False), **tover)
    assert cfg.remat and tsteps.lm_accum(cfg, False) == (
        8 if cfg.moe is not None else 2)
    assert tsd.model_flops == jsd.model_flops > 0
    steps_match(jsd, tsd,
                lambda tree: tt.params_from_jax(tree, cfg, device="cpu"))
