"""The port's fault-tolerance substrate (`ft/`), as ``tests/test_ft.py`` and
``tests/test_ft_checkpoint.py`` hold the reference's: the checkpoint
manager's round trip, async writes, ``keep`` GC, crc32 validation,
corrupt-step fallback and the structure-free `restore_flat`; the elastic
runner's replay over a torch state; the straggler watchdog.

Across the packages: the on-disk layout and the treedef string are the JAX
package's, so a tree the port saves restores through the JAX manager and
back, and a tenant the JAX `IndexRegistry` saved restores through the
port's `IndexRegistry.restore(..., device="cpu")` and answers as the JAX
tenant did (indices and counts equal, distances equal: both packages
finish them in float64 on the host from the same rows).
"""
import json
import os
import threading
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.snn_default import SNNConfig as JSNNConfig
from repro.ft.checkpoint import CheckpointManager as JCheckpointManager
from repro.serving import IndexRegistry as JIndexRegistry
from repro_torch.configs.snn_default import SNNConfig
from repro_torch.ft import CheckpointManager, ElasticRunner, FailureInjector
from repro_torch.ft.checkpoint import _flatten
from repro_torch.ft.watchdog import StepTimer, StragglerWatchdog
from repro_torch.serving import IndexRegistry, Request


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": torch.from_numpy(rng.normal(size=(4, 5)).astype(np.float32)),
            "b": [torch.arange(3), {"c": torch.tensor(float(seed))}]}


def _leaves(seed=0, n=3):
    rng = np.random.default_rng(seed)
    # heterogeneous shapes and dtypes, like a streaming snapshot
    return [rng.normal(size=(4 + seed, 3)).astype(np.float32),
            np.arange(5 + seed, dtype=np.int64), np.float64(seed)][:n]


def _step_dir(tmp_path, step):
    return os.path.join(str(tmp_path), f"step_{step:09d}")


def _corrupt(tmp_path, step, at=10):
    with open(os.path.join(_step_dir(tmp_path, step), "shard_00000.npz"),
              "r+b") as f:
        f.seek(at)
        f.write(b"\x00" * 32)


# --------------------------------------------------------- round trip, GC
def test_checkpoint_roundtrip_gives_tensors_like_the_tree(tmp_path):
    cm = CheckpointManager(str(tmp_path), async_write=False)
    t = _tree(1)
    cm.save(7, t, extra={"note": "x"})
    restored, step, extra = cm.restore(_tree(0))
    assert step == 7 and extra == {"note": "x"}
    assert isinstance(restored["a"], torch.Tensor)
    assert restored["a"].device == t["a"].device
    assert restored["b"][0].dtype == torch.int64
    torch.testing.assert_close(restored["a"], t["a"], rtol=0, atol=0)
    assert float(restored["b"][1]["c"]) == 1.0
    # numpy leaves come back as numpy
    cm.save(8, {"x": np.arange(4.0)})
    back, step, _ = cm.restore({"x": np.zeros(4)})
    assert step == 8 and isinstance(back["x"], np.ndarray)
    np.testing.assert_array_equal(back["x"], np.arange(4.0))


def test_treedef_is_the_jax_packages(tmp_path):
    """The same nesting flattens to JAX's treedef string, so each
    package's manager restores the other's trees."""
    trees = [{"a": 1, "b": [2, {"c": 3}]}, (1,), (1, 2), [1], 1, None,
             {"x": None, "y": (1, [])}, {"b": 1, "a": (2, 3)}]
    want = ["PyTreeDef({'a': *, 'b': [*, {'c': *}]})", "PyTreeDef((*,))",
            "PyTreeDef((*, *))", "PyTreeDef([*])", "PyTreeDef(*)",
            "PyTreeDef(None)", "PyTreeDef({'x': None, 'y': (*, [])})",
            "PyTreeDef({'a': (*, *), 'b': *})"]
    assert [_flatten(t)[1] for t in trees] == want
    assert _flatten({"b": 1, "a": (2, 3)})[0] == [2, 3, 1]
    ours = str(tmp_path / "port")
    CheckpointManager(ours, async_write=False).save(3, _tree(2))
    jtree = {"a": jnp.zeros((4, 5), jnp.float32),
             "b": [jnp.zeros(3, jnp.int32), {"c": jnp.float32(0)}]}
    back, step, _ = JCheckpointManager(ours).restore(jtree)
    assert step == 3
    np.testing.assert_array_equal(np.asarray(back["a"]),
                                  _tree(2)["a"].numpy())
    theirs = str(tmp_path / "jax")
    JCheckpointManager(theirs, async_write=False).save(4, jtree)
    back, step, _ = CheckpointManager(theirs).restore(_tree(0))
    assert step == 4 and float(back["b"][1]["c"]) == 0.0


def test_bfloat16_leaves_keep_their_bits_and_restore_in_place(tmp_path):
    """A bfloat16 tensor is saved as its two-byte bits, the bytes and the
    manifest dtype ("bfloat16") the JAX manager writes for a bfloat16
    array; each package's checkpoint restores in the port bit for bit,
    into the tree's own tensors (a float32 one takes the exact values)."""
    rng = np.random.default_rng(5)
    vals = torch.from_numpy(rng.normal(size=(6, 4)).astype(np.float32))
    vals[0, :3] = torch.tensor([-0.0, float("inf"), 1e-40])
    vals = vals.to(torch.bfloat16)
    bits = vals.view(torch.int16)
    ours, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    CheckpointManager(ours, async_write=False).save(
        1, {"t": vals, "w": torch.arange(3.0)})
    jtree = {"t": jnp.asarray(vals.float().numpy()).astype(jnp.bfloat16),
             "w": jnp.arange(3.0, dtype=jnp.float32)}
    JCheckpointManager(theirs, async_write=False).save(1, jtree)
    manifests = [json.load(open(os.path.join(d, "step_000000001",
                                             "manifest.json")))
                 for d in (ours, theirs)]
    assert manifests[0]["dtypes"] == manifests[1]["dtypes"] == [
        "bfloat16", "float32"]
    mine, _, _ = CheckpointManager(ours).restore_flat()
    jax_leaves, _, _ = JCheckpointManager(ours).restore_flat()
    assert mine[0].dtype == jax_leaves[0].dtype == np.dtype("V2")
    assert mine[0].tobytes() == np.asarray(jtree["t"]).tobytes()
    for d in (ours, theirs):
        like = {"t": torch.zeros(6, 4, dtype=torch.bfloat16),
                "w": torch.zeros(3)}
        ptr = like["t"].data_ptr()
        back, step, _ = CheckpointManager(d).restore(like)
        assert step == 1 and back["t"] is like["t"]
        assert like["t"].data_ptr() == ptr
        assert torch.equal(like["t"].view(torch.int16), bits)
        assert torch.equal(like["w"], torch.arange(3.0))
        back, _, _ = CheckpointManager(d).restore(
            {"t": torch.zeros(6, 4), "w": torch.zeros(3)})
        assert back["t"].dtype == torch.float32
        assert torch.equal(back["t"], vals.float())


def test_checkpoint_async_and_gc(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=2, async_write=True)
    for s in range(5):
        cm.save(s, _tree(s))
    cm.wait()
    assert cm.all_steps() == [3, 4]


@pytest.mark.parametrize("use_tree", [True, False])
def test_corrupt_newest_falls_back_to_previous(tmp_path, use_tree):
    cm = CheckpointManager(str(tmp_path), keep=5, async_write=False)
    if use_tree:
        cm.save(1, _tree(1))
        cm.save(2, _tree(2))
        _corrupt(tmp_path, 2)
        restored, step, _ = cm.restore(_tree(0))
        assert step == 1 and float(restored["b"][1]["c"]) == 1.0
    else:
        cm.save(1, _leaves(1))
        cm.save(2, _leaves(2))
        _corrupt(tmp_path, 2)
        leaves, step, _ = cm.restore_flat()
        assert step == 1
        np.testing.assert_array_equal(leaves[0], _leaves(1)[0])


def test_checkpoint_structure_mismatch_skipped(tmp_path):
    cm = CheckpointManager(str(tmp_path), async_write=False)
    cm.save(3, _tree(0))
    restored, step, _ = cm.restore({"different": torch.zeros(2)})
    assert restored is None and step is None
    # same structure, other shapes: skipped too
    other = _tree(0)
    other["a"] = torch.zeros(2, 2)
    assert cm.restore(other) == (None, None, None)


def test_async_save_returns_before_write_and_wait_completes(tmp_path):
    cm = CheckpointManager(str(tmp_path), async_write=True)
    gate = threading.Event()
    real_write = cm._write

    def slow_write(*a, **k):
        gate.wait(10.0)
        real_write(*a, **k)

    cm._write = slow_write
    cm.save(1, _leaves(1))
    assert cm.all_steps() == []
    gate.set()
    cm.wait()
    assert cm.all_steps() == [1]


def test_second_save_waits_for_inflight_write(tmp_path):
    cm = CheckpointManager(str(tmp_path), async_write=True)
    cm.save(1, _leaves(1))
    cm.save(2, _leaves(2))
    cm.wait()
    assert cm.all_steps() == [1, 2]


def test_block_save_is_synchronous(tmp_path):
    cm = CheckpointManager(str(tmp_path), async_write=True)
    cm.save(3, _leaves(3), block=True)
    assert cm.all_steps() == [3]


@pytest.mark.parametrize("keep,steps,want", [
    (3, (2, 5, 9, 11, 20), [9, 11, 20]),
    (0, range(6), list(range(6))),       # keep=0 disables the GC
])
def test_keep_gc(tmp_path, keep, steps, want):
    cm = CheckpointManager(str(tmp_path), keep=keep, async_write=False)
    for s in steps:
        cm.save(s, _leaves(1))
    assert cm.all_steps() == want


@pytest.mark.parametrize("damage", ["crc", "manifest json", "missing shard"])
def test_validate_rejects_damaged_checkpoints(tmp_path, damage):
    cm = CheckpointManager(str(tmp_path), async_write=False)
    cm.save(1, _leaves(1))
    path = _step_dir(tmp_path, 1)
    if damage == "crc":
        _corrupt(tmp_path, 1, at=12)
    elif damage == "manifest json":
        with open(os.path.join(path, "manifest.json"), "w") as f:
            f.write("{not json")
    else:
        os.remove(os.path.join(path, "shard_00000.npz"))
    assert cm._validate(path) is None


def test_validate_accepts_good_checkpoint(tmp_path):
    cm = CheckpointManager(str(tmp_path), async_write=False)
    cm.save(4, _leaves(2), extra={"k": 1})
    path = _step_dir(tmp_path, 4)
    manifest = cm._validate(path)
    assert manifest is not None
    assert manifest["step"] == 4 and manifest["extra"] == {"k": 1}
    with open(os.path.join(path, "shard_00000.npz"), "rb") as f:
        assert manifest["shards"]["shard_00000.npz"] == zlib.crc32(f.read())


def test_partial_tmp_dir_is_not_a_checkpoint(tmp_path):
    cm = CheckpointManager(str(tmp_path), async_write=False)
    cm.save(1, _leaves(1))
    tmp = os.path.join(str(tmp_path), "step_000000009.tmp")
    os.makedirs(tmp)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump({"step": 9}, f)
    assert cm.all_steps() == [1]
    leaves, step, _ = cm.restore_flat()
    assert step == 1 and leaves is not None


def test_restore_picks_latest_step_and_explicit_step(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=0, async_write=False)
    for s in (1, 7, 3):
        cm.save(s, _leaves(1), extra={"s": s})
    like = _leaves(1)
    _, step, extra = cm.restore(like)
    assert step == 7 and extra == {"s": 7}
    _, step, extra = cm.restore(like, step=3)
    assert step == 3 and extra == {"s": 3}
    restored, step, _ = cm.restore(like, step=99)
    assert restored is None and step is None


def test_restore_flat_roundtrips_variable_shapes(tmp_path):
    cm = CheckpointManager(str(tmp_path), async_write=False)
    want = _leaves(5)
    cm.save(11, want, extra={"streaming": {"n_parts": 2}})
    leaves, step, extra = cm.restore_flat()
    assert step == 11 and extra == {"streaming": {"n_parts": 2}}
    assert len(leaves) == len(want)
    for a, b in zip(leaves, want):
        np.testing.assert_array_equal(a, np.asarray(b))
        assert a.dtype == np.asarray(b).dtype


def test_restore_flat_empty_dir(tmp_path):
    assert CheckpointManager(str(tmp_path)).restore_flat() == (None, None,
                                                               None)


def test_restore_flat_rejects_manifest_shape_mismatch(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=0, async_write=False)
    cm.save(1, _leaves(1))
    cm.save(2, _leaves(2))
    path = _step_dir(tmp_path, 2)
    shard = os.path.join(path, "shard_00000.npz")
    np.savez(shard, **{str(i): np.zeros(1, np.float32) for i in range(3)})
    with open(shard, "rb") as f:
        crc = zlib.crc32(f.read())
    mpath = os.path.join(path, "manifest.json")
    with open(mpath) as f:
        manifest = json.load(f)
    manifest["shards"]["shard_00000.npz"] = crc
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    _, step, _ = cm.restore_flat()
    assert step == 1


# --------------------------------------------------------------- elastic
def test_elastic_runner_restarts_and_is_deterministic(tmp_path):
    """A mid-run failure must not change the final torch state (replay)."""
    def make_state():
        return {"x": torch.tensor(0.0), "hist": torch.zeros(50)}

    def step_fn(state, i):
        hist = state["hist"].clone()
        hist[i] = i
        return {"x": state["x"] + i, "hist": hist}

    cm1 = CheckpointManager(str(tmp_path / "clean"), async_write=False)
    clean, r0 = ElasticRunner(make_state, step_fn, cm1, total_steps=30,
                              checkpoint_every=5).run()
    assert r0 == 0
    cm2 = CheckpointManager(str(tmp_path / "fail"), async_write=False)
    seen = []
    inj = FailureInjector({12: "node loss", 23: "node loss"})
    failed, r1 = ElasticRunner(make_state, step_fn, cm2, total_steps=30,
                               checkpoint_every=5,
                               on_restart=seen.append).run(inj)
    assert r1 == 2 and seen == [1, 2] and inj.fired == [12, 23]
    torch.testing.assert_close(clean["hist"], failed["hist"], rtol=0, atol=0)
    assert float(clean["x"]) == float(failed["x"]) == float(sum(range(30)))


def test_elastic_runner_gives_up_past_max_restarts(tmp_path):
    cm = CheckpointManager(str(tmp_path), async_write=False)

    def step_fn(state, i):
        raise RuntimeError("always down")

    with pytest.raises(RuntimeError):
        ElasticRunner(lambda: {"x": torch.zeros(1)}, step_fn, cm,
                      total_steps=3, max_restarts=2).run()


# -------------------------------------------------------------- watchdog
def test_watchdog_flags_slow_host():
    wd = StragglerWatchdog(threshold=1.5)
    for _ in range(5):
        for h in ("h0", "h1", "h2", "h3"):
            wd.report(h, 1.0)
        wd.report("h4", 2.5)
    assert wd.stragglers() == ["h4"]
    assert "h4" not in wd.healthy_hosts()
    with StepTimer(wd, "h5"):
        pass
    assert wd.hosts["h5"].n == 1


def test_watchdog_needs_min_samples():
    wd = StragglerWatchdog(min_samples=3)
    wd.report("h0", 1.0)
    wd.report("h1", 99.0)
    assert wd.stragglers() == []


# ---------------------------------------------------------- across packages
def test_jax_registry_checkpoint_restores_in_the_port(tmp_path):
    rng = np.random.default_rng(21)
    x = rng.normal(size=(1500, 8)).astype(np.float32)
    jreg = JIndexRegistry(JSNNConfig(), checkpoint_root=str(tmp_path))
    jreg.create("t", x)
    jreg.get("t").index.append(rng.normal(size=(90, 8)).astype(np.float32))
    step = jreg.save("t")
    treg = IndexRegistry(SNNConfig(), checkpoint_root=str(tmp_path),
                         device="cpu")
    trt = treg.restore("t", device="cpu")
    jidx, tidx = jreg.get("t").index, trt.index
    assert tidx.device.type == "cpu"
    assert tidx.generation == jidx.generation == step
    assert tidx.n == 1590 and len(tidx.parts) == len(jidx.parts) == 2
    qs = rng.normal(size=(20, 8)).astype(np.float32)
    want = jidx.query_radius_csr(qs, 2.4)
    got = tidx.query_radius_csr(qs, 2.4)
    assert want.nnz > 100
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_array_equal(got.distances, want.distances)
    wi, wd = jidx.query_knn(qs, 7)
    gi, gd = tidx.query_knn(qs, 7)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gd, wd)
    # the tenant serves through the port's runtime; the port saves it back
    out = {}
    trt.run_batch([Request(query=qs[0], radius=2.4, id=0)],
                  lambda r: out.__setitem__(r.id, r))
    np.testing.assert_array_equal(out[0].indices, want.row(0)[0])
    treg.save("t", directory=str(tmp_path / "port"))
    back = JIndexRegistry(JSNNConfig()).restore(
        "t", directory=str(tmp_path / "port")).index
    np.testing.assert_array_equal(back.query_radius_csr(qs, 2.4).indices,
                                  want.indices)
