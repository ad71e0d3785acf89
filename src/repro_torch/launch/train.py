"""Training launcher of the port: the counterpart of ``repro.launch.train``
for every family (the LMs' ``train_4k``, the GAT's graph regimes, the
recsys models' ``train_batch``), on the card unless ``--device cpu``.

Features: deterministic data (a batch is a pure function of the step),
checkpoint/resume through `ft.checkpoint` in the JAX package's tree layout
(``(params, opt_state)``; an MLP weight (in, out), an LM's layers stacked
(G, p, ...)), so a checkpoint that ``repro.launch.train`` wrote resumes
here, a straggler watchdog, and JSONL metrics.  The model is an
``nn.Module`` (DLRM, Wide & Deep, MIND) or a dict tree of tensors (the
LMs, BERT4Rec, the GAT); a step updates it and its optimizer state in
place.

Usage:
  python -m repro_torch.launch.train --arch minicpm3-4b --reduced --device cpu
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

from ..configs.registry import get_arch
from ..data.pipeline import LMSyntheticDataset, RecsysSyntheticDataset
from ..ft.checkpoint import CheckpointManager
from ..ft.watchdog import StepTimer, StragglerWatchdog
from ..utils import tree_leaves
from .steps import build_step


def _on(device, arrays: dict) -> dict:
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}


def make_batch_source(spec, cfg, fixed: dict, device):
    """Returns ``step -> batch`` (tensors on ``device``) for the arch's
    train shape, as the JAX trainer's: the LMs' Markov token stream
    (`data.pipeline.LMSyntheticDataset`) and DLRM's and Wide & Deep's
    click model (`RecsysSyntheticDataset`, ids below the smallest
    vocabulary), each of the shape of ``init_args``' batch; else that fixed
    batch."""
    if spec.family == "lm":
        b, s = fixed["tokens"].shape
        ds = LMSyntheticDataset(vocab=cfg.vocab, seq_len=s, batch=b)
        return lambda i: _on(device, ds.batch_at(i))
    if spec.arch_id in ("dlrm-mlperf", "wide-deep"):
        b, nf = fixed["sparse"].shape
        ds = RecsysSyntheticDataset(n_dense=cfg.n_dense, n_sparse=nf,
                                    vocab=int(min(cfg.vocab_sizes)), batch=b)
        return lambda i: _on(device, ds.batch_at(i))
    return lambda i: fixed


def default_shape(spec) -> str:
    """The reference's training shape of the arch's family."""
    return {"lm": "train_4k", "gnn": "full_graph_sm",
            "recsys": "train_batch"}[spec.family]


def params_of(model):
    """The model's parameters as the JAX package's tree: a dict tree is its
    own, an ``nn.Module``'s is ``model.tree()``."""
    return model if isinstance(model, dict) else model.tree()


def setup(arch_id: str, shape: str | None = None, *, reduced: bool = False,
          device=None):
    """(step_def, model, opt_state, batch_at) of a training run, the model
    and its optimizer state on ``device`` (default: the card)."""
    spec = get_arch(arch_id)
    shape = shape or default_shape(spec)
    step_def = build_step(arch_id, shape, reduced=reduced)
    if not step_def.name.endswith(":train"):
        raise ValueError(f"{arch_id}:{shape} is not a training shape")
    model, opt_state, fixed = step_def.init_args(device)
    cfg = spec.make_config(shape, reduced)
    batch_at = make_batch_source(spec, cfg, fixed,
                                 tree_leaves(params_of(model))[0].device)
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
    state = (params_of(model), opt_state)

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
