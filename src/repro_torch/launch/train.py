"""Training launcher of the port: the counterpart of ``repro.launch.train``
for the recsys family (DLRM, Wide & Deep, MIND), on the card unless
``--device cpu``.

Features: deterministic data (a batch is a pure function of the step),
checkpoint/resume through `ft.checkpoint` in the JAX package's tree layout
(``(params, opt_state)``, an MLP weight (in, out)), a straggler watchdog, and
JSONL metrics.  LM training (an LM's default shape, ``train_4k``),
BERT4Rec's and the GNN family are not ported (``ROADMAP.md``): they raise
``NotImplementedError``, as `launch.steps.build_step` does.

Usage:
  python -m repro_torch.launch.train --arch dlrm-mlperf --reduced --steps 20
  python -m repro_torch.launch.train --arch mind --reduced --device cpu \\
      --steps 50 --ckpt-dir /tmp/ck --resume --log /tmp/mind.jsonl
"""
from __future__ import annotations

import argparse
import json
import math
import time

import torch

from ..configs.registry import get_arch, list_archs
from ..data.pipeline import RecsysSyntheticDataset
from ..ft.checkpoint import CheckpointManager
from ..ft.watchdog import StepTimer, StragglerWatchdog
from .steps import build_step


def make_batch_source(arch_id: str, cfg, fixed: dict, device):
    """Returns ``step -> batch`` (tensors on ``device``) for the arch's
    train shape: DLRM's and Wide & Deep's click model
    (`data.pipeline.RecsysSyntheticDataset`, ids below the smallest
    vocabulary, as in the JAX trainer), else the fixed batch of
    ``init_args``."""
    if arch_id in ("dlrm-mlperf", "wide-deep"):
        b, nf = fixed["sparse"].shape
        ds = RecsysSyntheticDataset(n_dense=cfg.n_dense, n_sparse=nf,
                                    vocab=int(min(cfg.vocab_sizes)), batch=b)
        return lambda i: {k: torch.from_numpy(v).to(device)
                          for k, v in ds.batch_at(i).items()}
    return lambda i: fixed


def default_shape(arch_id: str) -> str:
    """The reference's training shape of the arch's family (an arch the
    port does not have takes the recsys one, and `build_step` says it is
    not ported)."""
    family = get_arch(arch_id).family if arch_id in list_archs() else None
    return "train_4k" if family == "lm" else "train_batch"


def setup(arch_id: str, shape: str | None = None, *, reduced: bool = False,
          device=None):
    """(step_def, model, opt_state, batch_at) of a training run, the model
    and its optimizer state on ``device`` (default: the card)."""
    shape = shape or default_shape(arch_id)
    step_def = build_step(arch_id, shape, reduced=reduced)
    if not step_def.name.endswith(":train"):
        raise ValueError(f"{arch_id}:{shape} is not a training shape")
    model, opt_state, fixed = step_def.init_args(device)
    cfg = get_arch(arch_id).make_config(shape, reduced)
    batch_at = make_batch_source(arch_id, cfg, fixed,
                                 next(model.parameters()).device)
    return step_def, model, opt_state, batch_at


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default=None,
                    help="default: the family's training shape")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU (default: the card)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log", default=None)
    args = ap.parse_args(argv)

    step_def, model, opt_state, batch_at = setup(
        args.arch, args.shape, reduced=args.reduced, device=args.device)
    state = (model.tree(), opt_state)

    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    start = 0
    if ckpt and args.resume:
        restored, s0, _ = ckpt.restore(state)
        if restored is not None:
            start = s0 + 1
            print(f"resumed from step {s0}")

    wd = StragglerWatchdog()
    logf = open(args.log, "a") if args.log else None
    t_start = time.time()
    try:
        for i in range(start, args.steps):
            batch = batch_at(i)
            with StepTimer(wd, "host0"):
                loss = float(step_def.fn(model, opt_state, batch)["loss"])
            if i % 10 == 0 or i == args.steps - 1:
                print(f"step {i:5d} loss {loss:.4f} "
                      f"({(time.time() - t_start):.1f}s)")
            if logf:
                logf.write(json.dumps({"step": i, "loss": loss,
                                       "t": time.time() - t_start}) + "\n")
            if ckpt and ((i + 1) % args.ckpt_every == 0
                         or i == args.steps - 1):
                ckpt.save(i, state)
            if not math.isfinite(loss):
                raise RuntimeError(f"non-finite loss at step {i}")
        if ckpt:
            ckpt.wait()
    finally:
        if logf:
            logf.close()
    print("done")
    return model


if __name__ == "__main__":
    main()
