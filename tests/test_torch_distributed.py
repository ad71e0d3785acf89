"""The port's distribution utilities (``repro_torch.distributed``) against the
JAX package's (``repro.distributed``) and the step builders' layouts
against ``repro.launch.steps``, on the CPU.

* The rule sets of `rules_for_family` (4 families, both ``multi_pod``
  values) equal JAX's entry by entry; ``constrain`` is the identity without
  rules and without a context, and nested rule sets are restored.
* `topk_compress` (ties planted at the threshold, with and without a
  residual) and `int8_quantize` / `int8_dequantize` are bit-equal to JAX.
* One 8-rank gloo run (file store in a temporary directory) of
  `ring_allgather_matmul` over a "model" axis of 8 (within 1e-5 of
  ``x @ w`` and of JAX's ring, the same on every rank) and of
  `compressed_psum` beside JAX's 8-device ``shard_map`` in a subprocess:
  "int8" bit-equal, "none" within 1e-6 relative.
* For every cell of ``all_cells()`` and both ``multi_pod`` values, the
  ``arg_specs`` (shapes and dtypes), ``in_shardings`` and
  ``out_shardings`` trees and ``donate_argnums`` equal JAX's leaf for
  leaf.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import registry as jreg
from repro.distributed import compression as jcomp
from repro.distributed import sharding as jsharding
from repro.launch import steps as jsteps
from repro_torch.distributed import compression as tcomp
from repro_torch.distributed import sharding as tsharding
from repro_torch.launch import steps as tsteps

ROOT = Path(__file__).resolve().parents[1]
WORLD = 8
TIMEOUT_S = 180


# --------------------------------------------------------------------------- #
# Rules and constrain                                                          #
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("family", ["lm", "gnn", "recsys", "snn"])
def test_rules_equal_the_reference(family, multi_pod):
    want = jsharding.rules_for_family(family, multi_pod=multi_pod)
    got = tsharding.rules_for_family(family, multi_pod=multi_pod)
    assert set(got) == set(want)
    for name, w in want.items():
        if isinstance(w, P):
            assert isinstance(got[name], tsharding.Spec)
            assert tuple(got[name]) == tuple(w), name
        else:
            assert got[name] == w, name


def test_unknown_family_raises():
    with pytest.raises(ValueError, match="unknown family"):
        tsharding.rules_for_family("vision")


def test_constrain_is_the_identity_and_contexts_nest():
    x = torch.arange(6.0).reshape(2, 3)
    assert tsharding.constrain(x, "act_btd") is x
    lm = tsharding.rules_for_family("lm")
    gnn = tsharding.rules_for_family("gnn")
    assert tsharding.current_rules() is None
    with tsharding.sharding_rules(lm):
        assert tsharding.current_rules() is lm
        # rules without a step's context: nothing to do
        assert tsharding.constrain(x, "act_btd") is x
        assert tsharding.gather_layer_params({"wq": x}) == {"wq": x}
        with tsharding.sharding_rules(gnn):
            assert tsharding.current_rules() is gnn
            assert tsharding.constrain(x, "act_btd") is x   # no such rule
        assert tsharding.current_rules() is lm
    assert tsharding.current_rules() is None
    assert tsharding.current_context() is None
    # without the zero3 flag the gather is the cast alone
    out = tsharding.gather_layer_params({"attn": {"wq": x}}, torch.bfloat16)
    assert torch.equal(out["attn"]["wq"], x.to(torch.bfloat16))


def test_constrain_asks_the_active_context():
    seen = []

    class Ctx:
        def constrain(self, x, name, spec):
            seen.append((name, tuple(spec)))
            return x + 1

    x = torch.zeros(2)
    with tsharding.sharding_rules(tsharding.rules_for_family("lm"), Ctx()):
        assert torch.equal(tsharding.constrain(x, "act_btd"), x + 1)
        assert tsharding.constrain(x, "no_such_rule") is x
    assert seen == [("act_btd", ("data", "model", None))]


def test_spec_placements():
    from torch.distributed.tensor import Replicate, Shard

    class Mesh:
        mesh_dim_names = ("pod", "data", "model")

    spec = tsharding.Spec(("pod", "data"), None, "model")
    assert spec == (("pod", "data"), None, "model") and len(spec) == 3
    assert spec.axes(0) == ("pod", "data") and spec.axes(1) == ()
    assert tsharding.to_placements(spec, Mesh()) == (Shard(0), Shard(0),
                                                     Shard(2))
    assert tsharding.to_placements(tsharding.Spec(None, "data"), Mesh()) == (
        Replicate(), Shard(1), Replicate())
    with pytest.raises(ValueError, match="order"):
        tsharding.to_placements(tsharding.Spec(("data", "pod")), Mesh())


# --------------------------------------------------------------------------- #
# Compression                                                                  #
# --------------------------------------------------------------------------- #
def _grads(seed: int):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(16, 25)).astype(np.float32)
    # ties at the threshold: the 4 largest magnitudes of a are equal, so
    # the k = 4 top-k mask (k_frac 0.01 of 400) keeps all of them and a
    # fifth planted at -the same value
    a.flat[[3, 77, 150, 321]] = 9.5
    a.flat[200] = -9.5
    b = rng.normal(size=(300,)).astype(np.float32)
    b[[10, 11]] = 5.25
    return {"a": a, "b": b}


def _bits(x):
    return np.asarray(x).view(np.int32 if np.asarray(x).dtype.itemsize == 4
                              else np.int8)


def _t(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


@pytest.mark.parametrize("with_residual", [False, True])
def test_topk_compress_is_bit_equal_to_jax(with_residual):
    g = _grads(0)
    r = _grads(1) if with_residual else None
    jsent, jres = jcomp.topk_compress(
        jax.tree.map(jnp.asarray, g),
        None if r is None else jax.tree.map(jnp.asarray, r), k_frac=0.01)
    tsent, tres = tcomp.topk_compress(_t(g), None if r is None else _t(r),
                                      k_frac=0.01)
    for k in g:
        np.testing.assert_array_equal(_bits(tsent[k].numpy()),
                                      _bits(jsent[k]))
        np.testing.assert_array_equal(_bits(tres[k].numpy()), _bits(jres[k]))
    if not with_residual:
        assert int((tsent["a"] != 0).sum()) == 5    # ties send more than k


def test_int8_quantize_is_bit_equal_to_jax():
    g = _grads(2)
    # a scale of 1 and values half-way between integers: round half to even
    g["b"][0] = 127.0
    g["b"][7:10] = [2.5, 3.5, -0.5]
    jq, js = jcomp.int8_quantize(jax.tree.map(jnp.asarray, g))
    tq, ts = tcomp.int8_quantize(_t(g))
    for k in g:
        assert tq[k].dtype == torch.int8 and ts[k].dtype == torch.float32
        np.testing.assert_array_equal(tq[k].numpy(), np.asarray(jq[k]))
        np.testing.assert_array_equal(_bits(ts[k].numpy()), _bits(js[k]))
    jd = jcomp.int8_dequantize(jq, js)
    td = tcomp.int8_dequantize(tq, ts)
    for k in g:
        np.testing.assert_array_equal(_bits(td[k].numpy()), _bits(jd[k]))
    assert tq["b"][7:10].tolist() == [2, 4, 0]
    half = torch.tensor([0.5, 1.5, 2.5, -0.5])
    assert tcomp._quantize(half, torch.tensor(1.0), torch.int8).tolist() == [
        0, 2, 2, 0]


def test_compressed_psum_refuses_an_unknown_mode():
    with pytest.raises(ValueError):
        tcomp.compressed_psum({"a": torch.zeros(2)}, None, mode="fp8")


# --------------------------------------------------------------------------- #
# The collectives: 8 gloo ranks beside JAX's 8 fake devices                   #
# --------------------------------------------------------------------------- #
JAX_SIDE = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import sys
sys.path.insert(0, "src")
from pathlib import Path
import jax, jax.numpy as jnp, numpy as np
from jax.experimental.shard_map import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.distributed.collective_matmul import ring_allgather_matmul
from repro.distributed.compression import compressed_psum
d = Path(sys.argv[1])
z = np.load(d / "inputs.npz")
mesh = jax.make_mesh((8,), ("model",))
xs = jax.device_put(jnp.asarray(z["x"]), NamedSharding(mesh, P("model", None)))
ring = ring_allgather_matmul(xs, jnp.asarray(z["w"]), mesh)
dmesh = jax.make_mesh((8,), ("data",))
def body(a, b):
    g = {"a": a[0], "b": b[0]}
    none = compressed_psum(g, "data", mode="none")
    q = compressed_psum(g, "data", mode="int8")
    return ({k: v[None] for k, v in none.items()},
            {k: v[None] for k, v in q.items()})
spec = (P("data", None, None), P("data", None))
fn = shard_map(body, mesh=dmesh, in_specs=spec,
               out_specs=({"a": spec[0], "b": spec[1]},) * 2)
none, q = fn(jnp.asarray(z["ga"]), jnp.asarray(z["gb"]))
np.savez(d / "jax.npz", ring=np.asarray(ring), none_a=np.asarray(none["a"]),
         none_b=np.asarray(none["b"]), int8_a=np.asarray(q["a"]),
         int8_b=np.asarray(q["b"]))
"""

RANK_SIDE = """
import sys
sys.path.insert(0, "src")
from pathlib import Path
import numpy as np, torch, torch.distributed as dist
from repro_torch.distributed.collective_matmul import ring_allgather_matmul
from repro_torch.distributed.compression import compressed_psum
from repro_torch.launch.mesh import make_host_mesh
rank, world, d = int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3])
dist.init_process_group("gloo", init_method=f"file://{d / 'store'}",
                        rank=rank, world_size=world)
try:
    z = np.load(d / "inputs.npz")
    mesh = make_host_mesh(data=1, model=world, device_type="cpu")
    x, w = torch.from_numpy(z["x"]), torch.from_numpy(z["w"])
    rows = x.shape[0] // world
    ring = ring_allgather_matmul(x[rank * rows:(rank + 1) * rows], w, mesh)
    first = ring.clone()
    dist.broadcast(first, 0)
    spread = (ring - first).abs().max().reshape(1)
    dist.all_reduce(spread, op=dist.ReduceOp.MAX)
    g = {"a": torch.from_numpy(z["ga"][rank]),
         "b": torch.from_numpy(z["gb"][rank])}
    none = compressed_psum(g, None, mode="none")
    q = compressed_psum(g, None, mode="int8")
    if rank == 0:
        np.savez(d / "torch.npz", ring=ring.numpy(), spread=spread.numpy(),
                 none_a=none["a"].numpy(), none_b=none["b"].numpy(),
                 int8_a=q["a"].numpy(), int8_b=q["b"].numpy())
finally:
    dist.destroy_process_group()
"""


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
def collectives(tmp_path_factory):
    d = tmp_path_factory.mktemp("collectives")
    rng = np.random.default_rng(0)
    inputs = {"x": rng.normal(size=(64, 32)).astype(np.float32),
              "w": rng.normal(size=(32, 48)).astype(np.float32),
              "ga": rng.normal(size=(WORLD, 8, 33)).astype(np.float32),
              "gb": rng.normal(size=(WORLD, 256)).astype(np.float32)}
    np.savez(d / "inputs.npz", **inputs)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    ranks = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(RANK_SIDE), str(r),
         str(WORLD), str(d)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(WORLD)]
    jax_side = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(JAX_SIDE), str(d)], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    _wait(ranks, "the gloo ranks")
    _wait([jax_side], "the JAX subprocess")
    return inputs, dict(np.load(d / "torch.npz")), dict(np.load(d / "jax.npz"))


def test_ring_allgather_matmul_over_8_ranks(collectives):
    inputs, got, want = collectives
    exact = inputs["x"].astype(np.float64) @ inputs["w"].astype(np.float64)
    assert got["ring"].shape == (64, 48)
    assert np.abs(got["ring"] - exact).max() < 1e-5
    assert np.abs(got["ring"] - want["ring"]).max() < 1e-5
    assert float(got["spread"][0]) == 0.0       # the same on every rank


@pytest.mark.parametrize("leaf", ["a", "b"])
def test_compressed_psum_matches_jax_on_8_devices(collectives, leaf):
    inputs, got, want = collectives
    # every device's row of JAX's output holds the same sum
    np.testing.assert_array_equal(_bits(got[f"int8_{leaf}"]),
                                  _bits(want[f"int8_{leaf}"][0]))
    exact = inputs[f"g{leaf}"].astype(np.float64).sum(0)
    top = np.abs(exact).max()
    assert np.abs(got[f"none_{leaf}"] - want[f"none_{leaf}"][0]).max() \
        <= 1e-6 * top
    assert np.abs(got[f"none_{leaf}"] - exact).max() <= 1e-6 * top
    # the int8 sum: within 8 half-steps of the shared scale of the exact sum
    scale = np.abs(inputs[f"g{leaf}"]).max() / 127
    assert np.abs(got[f"int8_{leaf}"] - exact).max() <= 8 * 0.5 * scale * 1.01


# --------------------------------------------------------------------------- #
# The step builders' layouts                                                   #
# --------------------------------------------------------------------------- #
def _jax_leaves(tree, leaf_type):
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, leaf_type))[0]:
        keys = tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)
        out.append((keys, leaf))
    return out


def spec_leaves(tree) -> list:
    """(path, leaf) of the port's tree of `Spec`s or `ArgSpec`s in JAX's
    flattening order (dict keys sorted; None an empty subtree)."""
    out: list = []

    def walk(t, path):
        if t is None:
            return
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], path + (k,))
        elif isinstance(t, (list, tuple)) and not isinstance(
                t, tsteps.ArgSpec):
            for i, v in enumerate(t):
                walk(v, path + (i,))
        else:
            out.append((path, t))
    walk(tree, ())
    return out


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", sorted({a for a, _, _ in jreg.all_cells()}))
def test_step_layouts_equal_the_reference(arch, multi_pod):
    shapes = [s for a, s, _ in jreg.all_cells() if a == arch]
    assert shapes
    for shape in shapes:
        jsd = jsteps.build_step(arch, shape, multi_pod=multi_pod)
        tsd = tsteps.build_step(arch, shape, multi_pod=multi_pod)
        where = f"{arch}:{shape}"
        want = _jax_leaves(jsd.arg_specs, jax.ShapeDtypeStruct)
        got = spec_leaves(tsd.arg_specs)
        assert [p for p, _ in got] == [p for p, _ in want], where
        for (path, g), (_, w) in zip(got, want):
            assert tuple(g.shape) == tuple(w.shape), (where, path)
            assert _dtype_name(g.dtype) == np.dtype(w.dtype).name, (where,
                                                                    path)
        for field in ("in_shardings", "out_shardings"):
            want = _jax_leaves(getattr(jsd, field), P)
            got = spec_leaves(getattr(tsd, field))
            assert [p for p, _ in got] == [p for p, _ in want], (where, field)
            for (path, g), (_, w) in zip(got, want):
                assert tuple(g) == tuple(w), (where, field, path)
        assert tuple(tsd.donate_argnums) == tuple(jsd.donate_argnums), where


# --------------------------------------------------------------------------- #
# Recomputation under the step's rules                                        #
# --------------------------------------------------------------------------- #
class _CountingContext:
    """A one-device context that counts the layer gathers it is asked for
    (what `parallel.ParallelContext` does with them is tested in
    `test_torch_parallel.py`), without sequence parallelism."""
    tp_size = 1
    seq_parallel = False

    def __init__(self):
        self.gathers = 0

    def constrain(self, x, name, spec):
        return x

    def gather_weight(self, name, a, dtype):
        self.gathers += 1
        return a.to(dtype)

    def gather_vocab(self, name, a, dtype=None):
        return a if dtype is None else a.to(dtype)

    def embed(self, table, tokens):
        return torch.nn.functional.embedding(tokens, table)

    def data_sum(self, x):
        return x.detach()


def test_recomputation_runs_under_the_rules_on_another_thread():
    # on the card the backward (and so a checkpoint's recomputation) runs
    # on the autograd engine's thread, where the step's context variables
    # are not set: the recomputed layers must still be gathered
    import dataclasses
    import threading

    from repro_torch.models import transformer as tt

    cfg = dataclasses.replace(
        tsteps.get_arch("internlm2-20b").make_config("train_4k", True),
        remat=True, max_seq=64)
    gen = torch.Generator().manual_seed(0)
    params = tt.init_params(cfg, generator=gen, device="cpu")
    grads = jax.tree.map(torch.zeros_like, params)
    view = tt.train_view(params, grads, cfg)
    tokens = torch.randint(0, cfg.vocab, (2, 16), generator=gen)
    ctx = _CountingContext()
    with tsharding.sharding_rules(tsharding.rules_for_family("lm"), ctx):
        loss = tt.loss_fn(view, {"tokens": tokens, "labels": tokens}, cfg)
    forward = ctx.gathers
    # wq, wk, wv, wo, w1, w3, w2 and the two norms of each layer
    assert forward == cfg.n_layers * 9
    worker = threading.Thread(target=loss.backward)
    worker.start()
    worker.join()
    assert ctx.gathers == 2 * forward
    assert all(float(g.abs().sum()) > 0 for g in jax.tree.leaves(grads))


def test_scoped_carries_the_rules_to_another_thread():
    import threading

    seen = []

    def f(x):
        seen.append(tsharding.current_rules())
        return x * x

    rules = tsharding.rules_for_family("lm")
    x = torch.ones(3, requires_grad=True)
    with tsharding.sharding_rules(rules):
        y = torch.utils.checkpoint.checkpoint(tsharding.scoped(f), x,
                                              use_reentrant=False).sum()
    worker = threading.Thread(target=y.backward)
    worker.start()
    worker.join()
    assert seen == [rules, rules] and torch.equal(x.grad, torch.full((3,), 2.))
    assert tsharding.scoped(f) is f                  # no rules: unchanged
