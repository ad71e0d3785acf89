"""Sharded checkpointing with atomic commit, checksums and async writes.

Layout (per step), the JAX package's, so either package reads the other's
checkpoints:
    <dir>/step_000123.tmp/          -- written first
        shard_00000.npz             -- flat {index -> array} leaves
        manifest.json               -- treedef, shapes, dtypes, crc32 per shard
    <dir>/step_000123/              -- atomic rename on success

Restore validates checksums and the tree structure; partial/corrupt
checkpoints are skipped (the manager falls back to the previous step), which
is what a restarted replica must do after a mid-write failure.

Trees are nested dicts (keys in sorted order), lists and tuples whose
leaves are tensors, numpy arrays or scalars; ``None`` is an empty subtree.
The treedef string is the one ``jax.tree.flatten`` prints for the same
nesting, so `restore` also takes a tree that the JAX package saved.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import zlib

import numpy as np
import torch


def _flatten(tree):
    """(leaves, treedef string) of ``tree``, depth first, dict keys sorted."""
    leaves: list = []

    def walk(t) -> str:
        if t is None:
            return "None"
        if isinstance(t, dict):
            items = [f"{k!r}: {walk(t[k])}" for k in sorted(t)]
            return "{" + ", ".join(items) + "}"
        if isinstance(t, (list, tuple)):
            inner = ", ".join(walk(v) for v in t)
            if isinstance(t, list):
                return f"[{inner}]"
            return f"({inner},)" if len(t) == 1 else f"({inner})"
        leaves.append(t)
        return "*"

    spec = walk(tree)
    return leaves, f"PyTreeDef({spec})"


def _unflatten(tree_like, leaves: list):
    """``tree_like``'s structure with its leaves replaced, in order."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}   # the caller's key order
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    return build(tree_like)


# numpy has no bfloat16: a bfloat16 leaf is saved as its bits, an array of
# this two-byte void type, which is what `np.save` writes for the JAX
# package's bfloat16 arrays (its manifest names the dtype "bfloat16")
_BF16_BITS = np.dtype("V2")
# the checksum reads a shard in pieces of this size, not whole
_CRC_CHUNK = 64 << 20


def _to_host(leaf) -> np.ndarray:
    """A copy of ``leaf`` on the host, so a tensor updated in place after
    `CheckpointManager.save` returns leaves the snapshot as it was.  The
    copy is made by the transfer itself: nothing new is allocated on the
    leaf's device, and a bfloat16 leaf keeps its two bytes an element."""
    if isinstance(leaf, torch.Tensor):
        host = leaf.detach().to("cpu", copy=True)
        if host.dtype == torch.bfloat16:
            return host.view(torch.int16).numpy().view(_BF16_BITS)
        return host.numpy()
    return np.asarray(leaf)


def _dtype_name(a: np.ndarray) -> str:
    return "bfloat16" if a.dtype == _BF16_BITS else str(a.dtype)


def _like(arr: np.ndarray, leaf):
    """``arr`` copied into ``leaf`` for a tensor leaf, cast to its dtype,
    from the host straight to its device (no second copy of the leaf
    there; a bfloat16 leaf's saved bits taken as bfloat16); else the numpy
    array."""
    if not isinstance(leaf, torch.Tensor):
        return arr
    if not arr.flags.c_contiguous:
        # np.array keeps a 0-d array 0-d (np.ascontiguousarray makes it 1-d)
        arr = np.array(arr, order="C")
    host = (torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            if arr.dtype == _BF16_BITS else torch.from_numpy(arr))
    with torch.no_grad():
        return leaf.copy_(host)


def _crc32(path: str) -> int:
    crc = 0
    with open(path, "rb") as f:
        while chunk := f.read(_CRC_CHUNK):
            crc = zlib.crc32(chunk, crc)
    return crc


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_write: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_write = async_write
        self._thread: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree, extra: dict | None = None, block: bool = False):
        """Snapshot to host memory synchronously, write (a)synchronously.
        The previous write ends first, so the host holds one snapshot."""
        leaves, treedef = _flatten(tree)
        self.wait()
        host = [_to_host(leaf) for leaf in leaves]
        if self.async_write and not block:
            self._thread = threading.Thread(
                target=self._write, args=(step, host, treedef, extra or {}),
                daemon=True)
            self._thread.start()
        else:
            self._write(step, host, treedef, extra or {})

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, host: list, treedef: str, extra: dict):
        name = f"step_{step:09d}"
        tmp = os.path.join(self.dir, name + ".tmp")
        final = os.path.join(self.dir, name)
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp, exist_ok=True)
        shard_file = os.path.join(tmp, "shard_00000.npz")
        np.savez(shard_file, **{str(i): a for i, a in enumerate(host)})
        crc = _crc32(shard_file)
        manifest = {
            "step": step, "treedef": treedef, "n_leaves": len(host),
            "shards": {"shard_00000.npz": crc},
            "shapes": [list(a.shape) for a in host],
            "dtypes": [_dtype_name(a) for a in host],
            "extra": extra,
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(tmp)
        else:
            os.replace(tmp, final)
        self._gc()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:09d}"),
                          ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        out = []
        for n in os.listdir(self.dir):
            if n.startswith("step_") and not n.endswith(".tmp") and \
                    os.path.exists(os.path.join(self.dir, n, "manifest.json")):
                out.append(int(n[5:]))
        return sorted(out)

    def _validate(self, path: str) -> dict | None:
        try:
            with open(os.path.join(path, "manifest.json")) as f:
                manifest = json.load(f)
            for shard, crc in manifest["shards"].items():
                if _crc32(os.path.join(path, shard)) != crc:
                    return None
            return manifest
        except (OSError, json.JSONDecodeError, KeyError):
            return None

    def _candidates(self, step: int | None):
        """(step, manifest) of the valid checkpoints, newest first."""
        self.wait()
        steps = self.all_steps()
        if step is not None:
            steps = [s for s in steps if s == step]
        for s in reversed(steps):
            path = os.path.join(self.dir, f"step_{s:09d}")
            manifest = self._validate(path)
            if manifest is not None:
                yield s, path, manifest

    def restore(self, tree_like, step: int | None = None):
        """Restore into ``tree_like``.

        Returns (tree, step, extra) or (None, None, None) if no valid
        checkpoint exists.  Corrupt checkpoints are skipped, newest-first.
        The tensor leaves of ``tree_like`` receive the saved values in
        place, in their own dtype and on their own device, and are
        returned (a model whose table fills half the card restores without
        a second copy of it there); any other leaf comes back as the saved
        numpy array.  ``tree_like`` is untouched when nothing is restored.
        """
        like, treedef = _flatten(tree_like)
        for s, path, manifest in self._candidates(step):
            if manifest["n_leaves"] != len(like) or manifest["treedef"] != treedef:
                continue
            data = np.load(os.path.join(path, "shard_00000.npz"))
            arrs = [data[str(i)] for i in range(len(like))]
            if any(list(a.shape) != list(np.shape(leaf))
                   for a, leaf in zip(arrs, like)):
                continue
            restored = _unflatten(tree_like, [_like(a, leaf)
                                              for a, leaf in zip(arrs, like)])
            return restored, s, manifest.get("extra", {})
        return None, None, None

    def restore_flat(self, step: int | None = None):
        """Structure-free restore: the flat leaf list exactly as saved.

        `restore` needs a ``tree_like`` with the checkpoint's structure and
        shapes known up front, which a variable-shape state (e.g. a
        streaming index whose part count changes across snapshots) cannot
        provide.  This variant trusts the manifest instead: checksums and
        per-leaf shapes are still validated, corrupt checkpoints are still
        skipped newest-first, but the caller receives plain numpy leaves
        (``(leaves, step, extra)``; ``(None, None, None)`` when nothing
        valid exists) and rebuilds its own structure — e.g.
        `core.streaming.StreamingSNNIndex.from_state`.
        """
        for s, path, manifest in self._candidates(step):
            try:
                data = np.load(os.path.join(path, "shard_00000.npz"))
                leaves = [np.asarray(data[str(i)])
                          for i in range(manifest["n_leaves"])]
            except (OSError, KeyError, ValueError):
                continue
            if [list(a.shape) for a in leaves] != manifest["shapes"]:
                continue
            return leaves, s, manifest.get("extra", {})
        return None, None, None
