"""Elastic training runner: checkpoint/restart + mesh re-formation.

The runner executes a step loop; on failure (device loss simulated via
FailureInjector, or any exception from the step) it:
  1. drops to the last valid checkpoint,
  2. re-forms the mesh from the surviving device count (any divisor of the
     global batch is acceptable — data parallelism rescales),
  3. resumes, replaying the data stream deterministically from the restored
     step (the pipeline is seeded by step index, so no data is skipped or
     repeated).

The state is any tree `ft.checkpoint.CheckpointManager` takes (dicts,
lists and tuples of tensors or arrays); the policy logic (what to do on
failure) is the deployable artifact and is what the tests exercise.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from .checkpoint import CheckpointManager


class FailureInjector:
    """Deterministic failure schedule: {step: n_devices_lost_or_exception}."""

    def __init__(self, fail_at: dict[int, str] | None = None):
        self.fail_at = dict(fail_at or {})
        self.fired: list[int] = []

    def maybe_fail(self, step: int):
        if step in self.fail_at and step not in self.fired:
            self.fired.append(step)
            raise RuntimeError(f"injected failure at step {step}: "
                               f"{self.fail_at[step]}")


@dataclasses.dataclass
class ReplicaDrill:
    """Kill-and-restore drill for a SERVING replica (not a training loop).

    Drives ``serve_fn(step)`` through ``total_steps`` probe steps against a
    live replica; at each step the injector may kill the replica
    (RuntimeError), after which ``restore_fn()`` must stand up a fresh one
    from its last checkpoint and the SAME step is replayed against it.
    `run` returns the per-step results plus which steps saw a kill — the
    registry tests replay identical queries through the drill and assert
    the killed-and-restored replica's answers are bit-identical to the
    uninterrupted ones.
    """

    serve_fn: Callable[[int], object]   # step -> result (raises when killed)
    restore_fn: Callable[[], None]      # stand the replica back up
    total_steps: int
    max_restarts: int = 10

    def run(self, injector: FailureInjector | None = None):
        results: list[object] = []
        killed_at: list[int] = []
        restarts = 0
        step = 0
        while step < self.total_steps:
            try:
                if injector is not None:
                    injector.maybe_fail(step)
                results.append(self.serve_fn(step))
                step += 1
            except RuntimeError:
                restarts += 1
                if restarts > self.max_restarts:
                    raise
                killed_at.append(step)
                self.restore_fn()
                # the killed step replays against the restored replica
        return results, killed_at


@dataclasses.dataclass
class ElasticRunner:
    make_state: Callable[[], object]          # fresh (params, opt, ...) state
    step_fn: Callable[[object, int], object]  # (state, step) -> state
    ckpt: CheckpointManager
    total_steps: int
    checkpoint_every: int = 10
    max_restarts: int = 10
    on_restart: Callable[[int], None] | None = None

    def run(self, injector: FailureInjector | None = None):
        restarts = 0
        state = self.make_state()
        restored, step0, _ = self.ckpt.restore(state)
        state = restored if restored is not None else state
        step = (step0 + 1) if step0 is not None else 0
        while step < self.total_steps:
            try:
                if injector is not None:
                    injector.maybe_fail(step)
                state = self.step_fn(state, step)
                if (step + 1) % self.checkpoint_every == 0 or \
                        step + 1 == self.total_steps:
                    self.ckpt.save(step, state)
                step += 1
            except RuntimeError:
                restarts += 1
                if restarts > self.max_restarts:
                    raise
                if self.on_restart is not None:
                    self.on_restart(restarts)
                # re-form: fresh state structure, restore last good checkpoint
                state = self.make_state()
                restored, step0, _ = self.ckpt.restore(state)
                state = restored if restored is not None else state
                step = (step0 + 1) if step0 is not None else 0
        self.ckpt.wait()
        return state, restarts
