"""Multi-tenant index registry: many named indexes behind one server.

An `IndexRegistry` hosts named `TenantRuntime`s (each a `StreamingSNNIndex`
plus its executors, see `serving.runtime`) and gives the server three
things:

* **Routing** — `get(name)` resolves a request's ``tenant`` to its runtime.
* **Device-memory budget** — every tenant's cached execution plan accounts
  its bytes through the engine's static `MemoryPlan` ledger
  (`SegmentPack.planned_bytes`: the sum of the per-bucket buffer plans the
  plan has materialized).  When the total crosses
  ``SNNConfig.registry_memory_mb``, the LEAST-recently-served tenants'
  plans are evicted (`StreamingSNNIndex.drop_plan`) until the budget holds
  — never the tenant currently being served.  Eviction releases only the
  derived device state; the immutable parts stay, so the next request
  rebuilds the plan and answers **bit-identically** to before eviction
  (the plan is a pure cache of the parts).
* **Snapshots** — `save(name)` / `restore(name)` move a tenant's exact
  streaming state (`StreamingSNNIndex.state_leaves` / `from_state`) through
  `ft.checkpoint.CheckpointManager` (crc32-validated shards, atomic
  commit, corrupt-checkpoint skip).  The snapshot carries the exact
  per-part arrays — not the raw points — so a restored replica answers
  bit-identically to the original at the same generation even when the
  original held base + delta segments (a fresh rebuild from raw would
  legitimately pick a different projection sign / row order).  The leaf
  layout is the JAX package's, so a checkpoint either package wrote
  restores in the other.

Tenants live on the registry's ``device`` (default: the card; raises
without one unless ``"cpu"``).
"""
from __future__ import annotations

import os
import threading

import numpy as np
import torch

from ..configs.snn_default import SNNConfig
from ..core.streaming import StreamingSNNIndex
from ..ft.checkpoint import CheckpointManager
from ..kernels import registry as _kregistry
from .runtime import TenantRuntime


def _concrete(device: torch.device) -> torch.device:
    """``device`` with a CUDA device's missing index made the current one."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


class IndexRegistry:
    """Named `TenantRuntime`s + LRU plan cache + checkpoint plumbing.

    ``checkpoint_root`` (optional) is where `save`/`restore` keep per-tenant
    checkpoint directories (``<root>/<tenant>/step_*``); both also accept an
    explicit ``directory=`` per call.  `create` builds tenants on
    ``device`` (default: the card).
    """

    def __init__(self, cfg: SNNConfig = SNNConfig(), *,
                 checkpoint_root: str | None = None, device=None):
        self.cfg = cfg
        self.device = _kregistry.resolve_device(device)
        self.checkpoint_root = checkpoint_root
        self.budget_bytes = int(cfg.registry_memory_mb * 2**20)
        self._lock = threading.RLock()
        self._entries: dict[str, TenantRuntime] = {}
        # LRU stamps: monotonically increasing serve counter per tenant
        self._stamp: dict[str, int] = {}
        self._tick = 0
        self._evictions = 0  # total plans dropped for budget (observability)

    # -------------------------------------------------------------- hosting
    def create(self, name: str, data: np.ndarray,
               cfg: SNNConfig | None = None) -> TenantRuntime:
        """Build and host a new tenant over ``data`` (errors if it exists)."""
        return self.add(name, TenantRuntime(data, cfg or self.cfg,
                                            name=name, device=self.device))

    def add(self, name: str, runtime_or_index) -> TenantRuntime:
        """Host an existing runtime/index under ``name`` (must be new)."""
        rt = runtime_or_index
        if isinstance(rt, StreamingSNNIndex):
            rt = TenantRuntime(rt, self.cfg, name=name)
        with self._lock:
            if name in self._entries:
                raise ValueError(f"tenant {name!r} already exists")
            self._entries[name] = rt
            self._tick += 1
            self._stamp[name] = self._tick
        return rt

    def get(self, name: str, default=None) -> TenantRuntime | None:
        with self._lock:
            return self._entries.get(name, default)

    def __contains__(self, name: str) -> bool:
        with self._lock:
            return name in self._entries

    def names(self) -> list[str]:
        with self._lock:
            return list(self._entries)

    def drop(self, name: str) -> None:
        """Forget a tenant entirely (its index, plan, and LRU stamp)."""
        with self._lock:
            self._entries.pop(name, None)
            self._stamp.pop(name, None)

    # ---------------------------------------------------- memory accounting
    def touch(self, name: str) -> None:
        """Mark ``name`` most-recently-served (the LRU signal)."""
        with self._lock:
            if name in self._entries:
                self._tick += 1
                self._stamp[name] = self._tick

    def plan_bytes(self, name: str) -> int:
        rt = self.get(name)
        return 0 if rt is None else rt.index.plan_bytes()

    def bytes_planned(self) -> int:
        """Total `MemoryPlan`-accounted bytes across all live tenant plans."""
        with self._lock:
            entries = list(self._entries.values())
        return sum(rt.index.plan_bytes() for rt in entries)

    def enforce_budget(self, active: str | None = None) -> list[str]:
        """Evict cold plans (LRU order) until the byte budget holds.

        ``active`` — the tenant being served right now — is never evicted.
        Returns the tenant names whose plans were dropped.  Dropping a plan
        only releases the derived device state (`drop_plan`); the tenant
        keeps serving, paying one plan rebuild on its next request with
        bit-identical results.
        """
        evicted: list[str] = []
        with self._lock:
            order = sorted(self._entries, key=lambda n: self._stamp[n])
        total = self.bytes_planned()
        for name in order:
            if total <= self.budget_bytes:
                break
            if name == active:
                continue
            rt = self.get(name)
            if rt is None:
                continue
            freed = rt.index.plan_bytes()
            if freed <= 0:
                continue
            rt.index.drop_plan()
            self._evictions += 1
            evicted.append(name)
            total -= freed
        return evicted

    def _own_device(self, device):
        """The registry's device; an explicit ``device`` must name it
        (``"cuda"``, ``"cuda:0"`` and ``torch.device("cuda", 0)`` all name
        the current card)."""
        if device is None:
            return self.device
        device = _kregistry.resolve_device(device)
        if _concrete(device) != _concrete(self.device):
            raise ValueError(f"the registry's tenants live on "
                             f"{self.device}, not {device}")
        return self.device

    # ----------------------------------------------------------- snapshots
    def _ckpt_dir(self, name: str, directory: str | None) -> str:
        if directory is not None:
            return directory
        if self.checkpoint_root is None:
            raise ValueError("no checkpoint_root configured and no "
                             "directory= given")
        return os.path.join(self.checkpoint_root, name)

    def save(self, name: str, directory: str | None = None, *,
             step: int | None = None, keep: int = 3,
             block: bool = True) -> int:
        """Checkpoint tenant ``name``'s exact streaming state; returns step.

        The step defaults to the index generation, so repeated saves of a
        mutating tenant land in distinct, ordered checkpoints and `restore`
        picks the newest valid one.
        """
        rt = self.get(name)
        if rt is None:
            raise KeyError(f"unknown tenant {name!r}")
        leaves, extra = rt.index.state_leaves()
        if step is None:
            step = int(extra["generation"])
        mgr = CheckpointManager(self._ckpt_dir(name, directory), keep=keep)
        mgr.save(step, leaves, extra={"streaming": extra, "tenant": name},
                 block=block)
        mgr.wait()
        return step

    def restore(self, name: str, directory: str | None = None, *,
                step: int | None = None, device=None) -> TenantRuntime:
        """Rebuild tenant ``name`` from its newest valid checkpoint.

        Replaces any currently-hosted runtime of that name.  The restored
        index reconstructs the exact checkpointed parts
        (`StreamingSNNIndex.from_state`) on the registry's device, so every
        query answers bit-identically to the replica that saved it, at the
        same generation.  ``device``, when given, must be that device.
        """
        device = self._own_device(device)
        mgr = CheckpointManager(self._ckpt_dir(name, directory))
        leaves, got_step, extra = mgr.restore_flat(step=step)
        if leaves is None:
            raise FileNotFoundError(
                f"no valid checkpoint for tenant {name!r}")
        index = StreamingSNNIndex.from_state(leaves, extra["streaming"],
                                             device=device)
        with self._lock:
            self._entries.pop(name, None)
            self._stamp.pop(name, None)
        return self.add(name, index)
