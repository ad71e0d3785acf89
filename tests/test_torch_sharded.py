"""The port's sharded SNN against the JAX reference (repro.core.sharded,
repro.core.graph.build_neighbor_graph_sharded, repro.launch.snn_cell).

Both packages work on the very same index: the JAX package builds it and
the port takes its arrays (`index_from_arrays(device="cpu")`).  Inputs are
seeded numpy data of a few thousand rows.

* **The decomposition** (an int mesh of 8 shards) must be bit-identical to
  the port's single-device `query_radius_csr` and graph: indptr, indices
  and distances.  Against JAX, indptr and indices must be equal, squared
  Euclidean distances within 4 float32 ulp of their terms,
  4 * 2^-23 * (|x|^2 + |q|^2) (the two packages take their float32
  products in different libraries).
* **The collectives** run once, in 8 gloo ranks (`_torch_sharded_rank.py`,
  joined through a file store in a temporary directory), beside JAX's
  8-fake-device shard_map functions in a subprocess of their own, both on
  the same index arrays: counts, per-shard counts and top-k ids must be
  equal, order included; top-k half distances within 4 float32 ulp of
  |hn| + |q.x|.  The host exact answers (`query_counts`,
  `query_radius_batch`, the CSR row sizes) must equal them too.
* **The service step** of `launch.snn_cell` over the 8 ranks must give
  JAX's step on a 1-device mesh, both ``prune`` values.
"""
import os
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from test_torch_snn import _port_index

from repro.core import graph as jgraph
from repro.core import sharded as jsharded
from repro.core import snn as jsnn
from repro.launch import snn_cell as jcell
from repro_torch.core import graph as tgraph
from repro_torch.core import sharded as tsharded
from repro_torch.core import snn as tsnn
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import snn_cell as tcell

ROOT = Path(__file__).resolve().parents[1]
EPS32 = 2.0 ** -23
WORLD = 8
TIMEOUT_S = 180


def _bits(a):
    return np.asarray(a).view(np.int64)


def _same_csr(got, want):
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.indices, want.indices)
    if want.distances is not None:
        np.testing.assert_array_equal(_bits(got.distances),
                                      _bits(want.distances))


def _sq_close(index, q, want, got_sq):
    """Squared index-space distances within 4 float32 ulp of their terms."""
    xq, _ = index.prepare_queries(q, 1.0)
    qi = np.repeat(np.arange(want.m), np.diff(want.indptr))
    inv = np.empty_like(index.order)
    inv[index.order] = np.arange(index.n)
    xs = np.asarray(index.xs, np.float64)[inv[want.indices]]
    scale = (xs * xs).sum(1) + (xq[qi].astype(np.float64) ** 2).sum(1)
    assert np.all(np.abs(got_sq - want.distances) <= 4 * EPS32 * scale)


def _csr_data():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(4096, 12)).astype(np.float32)
    q = rng.normal(size=(33, 12)).astype(np.float32)
    return x, q


CSR_KW = dict(block=64, query_tile=64)


# --------------------------------------------------------------------------- #
# The decomposition                                                            #
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("mode", ["packed", "looped", "reused pack"])
def test_sharded_csr_is_the_single_device_csr(mode):
    x, q = _csr_data()
    jidx = jsnn.build_index(x)
    tidx = _port_index(jidx)
    kw = dict(CSR_KW, packed=mode != "looped")
    if mode == "reused pack":
        kw["pack"] = tsharded.mesh_pack(tidx, WORLD, block=64)
    runs = [tsharded.query_radius_csr_sharded(tidx, WORLD, q, 3.0, **kw)
            for _ in range(2)]
    single = tsnn.query_radius_csr(tidx, q, 3.0, device="cpu", **CSR_KW)
    assert single.nnz > 10 * q.shape[0]
    for got in runs:
        _same_csr(got, single)
    # JAX's sharded CSR on the same arrays (its decomposition reads only the
    # mesh's axis size)
    mesh = types.SimpleNamespace(shape={"data": WORLD})
    want = jsharded.query_radius_csr_sharded(jidx, mesh, q, 3.0, native=False,
                                             **CSR_KW)
    got = tsharded.query_radius_csr_sharded(tidx, WORLD, q, 3.0, native=False,
                                            packed=mode != "looped", **CSR_KW)
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.indices, want.indices)
    _sq_close(jidx, q, want, got.distances)


def test_sharded_csr_vector_radius_matches_scalar_calls():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2048, 8)).astype(np.float32)
    q = rng.normal(size=(11, 8)).astype(np.float32)
    radii = rng.uniform(0.5, 3.0, 11)
    radii[0] = 0.0
    radii[1] = 50.0   # huge-radius outlier: every shard live for the batch
    tidx = _port_index(jsnn.build_index(x))
    pack = tsharded.mesh_pack(tidx, WORLD, block=64)
    csr = tsharded.query_radius_csr_sharded(tidx, WORLD, q, radii, pack=pack,
                                            **CSR_KW)
    assert csr.m == 11 and csr.row(1)[0].size == x.shape[0]
    for i in range(11):
        single = tsharded.query_radius_csr_sharded(
            tidx, WORLD, q[i:i + 1], float(radii[i]), pack=pack, **CSR_KW)
        np.testing.assert_array_equal(csr.row(i)[0], single.row(0)[0])
        np.testing.assert_array_equal(_bits(csr.row(i)[1]),
                                      _bits(single.row(0)[1]))


def test_shard_padding_is_the_references():
    x, _ = _csr_data()
    jidx = jsnn.build_index(x[:1000])
    tidx = _port_index(jidx)
    for nshards, block in ((8, 64), (3, 128)):
        want = jsharded._pad_for_shards(jidx, nshards, block)
        got = tsharded._pad_for_shards(tidx, nshards, block)
        for g, w in zip(got[:5], want[:5]):
            g = g.numpy() if isinstance(g, torch.Tensor) else g
            np.testing.assert_array_equal(g, w)
        assert got[5] == want[5]
    assert tsharded._axis_size(WORLD, "data") == WORLD


@pytest.mark.parametrize("nshards,block", [(4, 64), (3, 128), (8, 64)])
def test_shard_blocks_are_the_padded_copys_blocks(nshards, block):
    """`shard_block` cuts a shard straight from the index (a host index of
    51.5 GB is never padded whole): every shard equals the block of
    `_pad_for_shards`' padded copy, padding included, on an index of
    1,000 rows that needs it; a shard without padding is a view of the
    index's rows."""
    x, _ = _csr_data()
    tidx = _port_index(jsnn.build_index(x[:1000]))
    xs, al, hn, od, _, per = tsharded._pad_for_shards(tidx, nshards, block)
    assert xs.shape[0] > tidx.n
    for k in range(nshards):
        rows = slice(k * per, (k + 1) * per)
        got = tsharded.shard_block(tidx, nshards, k, block)
        for g, w in zip(got[:3], (xs, al, hn)):
            assert torch.equal(g, w[rows])
        np.testing.assert_array_equal(got[3], od[rows])
    whole = tsharded.shard_block(_port_index(jsnn.build_index(x[:1024])), 2,
                                 0, 64)
    assert whole[0].shape[0] == 512 and whole[0]._base is not None


def test_each_rank_takes_its_own_card(monkeypatch):
    """A mesh on the card first makes the rank's card current: torchrun's
    LOCAL_RANK, else the rank modulo the cards (`core.sharded`'s shards
    and NCCL's operands go to ``torch.cuda.current_device()``)."""
    import torch.distributed as dist

    monkeypatch.setenv("LOCAL_RANK", "3")
    assert tmesh.local_card(4) == 3
    monkeypatch.delenv("LOCAL_RANK")
    monkeypatch.setattr(dist, "get_rank", lambda: 6)
    assert tmesh.local_card(4) == 2


# --------------------------------------------------------------------------- #
# The sharded graph builder                                                    #
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("per_point", [False, True])
@pytest.mark.parametrize("nshards", [1, 3, 8])
def test_graph_sharded_is_the_plain_graph(nshards, per_point):
    rng = np.random.default_rng(11)
    x = rng.normal(size=(700, 6)).astype(np.float32)
    eps = rng.uniform(1.0, 1.5, 700) if per_point else 1.2
    tidx = _port_index(jsnn.build_index(x))
    kw = dict(index=tidx, return_distance=True, query_chunk=96, block=64)
    want = tgraph.build_neighbor_graph(x, eps, device="cpu", **kw)
    got = tgraph.build_neighbor_graph_sharded(x, nshards, eps, **kw)
    assert want.nnz > 4 * x.shape[0]
    _same_csr(got, want)
    looped = tgraph.build_neighbor_graph_sharded(x, nshards, eps,
                                                 packed=False, **kw)
    _same_csr(looped, want)


def test_graph_sharded_matches_the_reference():
    rng = np.random.default_rng(6)
    x = rng.normal(size=(120, 3)).astype(np.float32)
    eps = rng.uniform(0.3, 1.0, 120)
    jidx = jsnn.build_index(x)
    mesh = jax.make_mesh((1,), ("data",))
    want = jgraph.build_neighbor_graph_sharded(x, mesh, eps, index=jidx,
                                               use_pallas=False)
    got = tgraph.build_neighbor_graph_sharded(x, 1, eps,
                                              index=_port_index(jidx))
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.indices, want.indices)
    with pytest.raises(ValueError, match="per-point eps"):
        tgraph.build_neighbor_graph_sharded(x, 1, eps[:5],
                                            index=_port_index(jidx))
    with pytest.raises(ValueError, match="index's"):
        tgraph.build_neighbor_graph_sharded(x[:7], 1, 0.5,
                                            index=_port_index(jidx))
    empty = tgraph.build_neighbor_graph_sharded(
        np.zeros((0, 3), np.float32), 4, 0.5, return_distance=True,
        device="cpu")
    assert empty.m == 0 and empty.distances.size == 0


# --------------------------------------------------------------------------- #
# The collectives: 8 gloo ranks beside JAX's 8 fake devices                    #
# --------------------------------------------------------------------------- #
JAX_SIDE = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import sys
sys.path.insert(0, "src")
from pathlib import Path
import jax
import numpy as np
from repro.core import sharded, snn
assert len(jax.devices()) == 8
d = Path(sys.argv[1])
z = np.load(d / "inputs.npz")
index = snn.SNNIndex(z["mu"], z["v1"], z["xs"], z["alphas"], z["half_norms"],
                     z["order"], "euclidean", 0.0, z["vs"], z["projs"])
mesh = jax.make_mesh((8,), ("data",))
xs, al, hn, od = sharded.shard_index(index, mesh, block=int(z["block"]))
qa = sharded.prepare_query_arrays(index, z["q"], float(z["radius"]))
count = sharded.make_sharded_count_fn(mesh)(xs, al, hn, *qa)
per = sharded.make_sharded_percount_fn(mesh)(xs, al, hn, *qa)
ids, dh = sharded.make_sharded_topk_fn(mesh, int(z["k"]))(xs, al, hn, od, *qa)
np.savez(d / "jax.npz", count=np.asarray(count), percount=np.asarray(per),
         topk_ids=np.asarray(ids), topk_dh=np.asarray(dh))
"""


def _index_arrays(index, prefix=""):
    return {prefix + f: np.asarray(getattr(index, f))
            for f in ("mu", "v1", "xs", "alphas", "half_norms", "order", "vs",
                      "projs")}


def _svc_data():
    """The service cell's distribution (std [1, 0.1, ...]) at d = 16."""
    rng = np.random.default_rng(7)
    scale = np.array([1.0] + [0.1] * 15, np.float32)
    x = (rng.normal(size=(WORLD * 4096, 16)) * scale).astype(np.float32)
    q = (rng.normal(size=(128, 16)) * scale).astype(np.float32)
    return x, q


SVC = dict(radius=0.6, n_chunk=4096, q_chunk=64)


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
def gloo_run(tmp_path_factory):
    """One 8-rank gloo run of the port and one 8-device JAX run, on the same
    inputs; returns (inputs, the port's results, JAX's results, the JAX
    indexes)."""
    d = tmp_path_factory.mktemp("sharded")
    x, q = _csr_data()
    jidx = jsnn.build_index(x)
    k = int(jsnn.query_counts(jidx, q, 3.0).max()) + 1
    sx, sq = _svc_data()
    jsvc = jsnn.build_index(sx)
    inputs = dict(_index_arrays(jidx), **_index_arrays(jsvc, "svc_"), q=q,
                  radius=3.0, block=64, k=k, svc_q=sq,
                  svc_radius=SVC["radius"], svc_n_chunk=SVC["n_chunk"],
                  svc_q_chunk=SVC["q_chunk"])
    np.savez(d / "inputs.npz", **inputs)
    # one thread a rank, and the ranks' sockets on the loopback interface
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    rank_script = str(ROOT / "tests" / "_torch_sharded_rank.py")
    ranks = [subprocess.Popen([sys.executable, rank_script, str(r),
                               str(WORLD), str(d)], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(WORLD)]
    jax_side = subprocess.Popen([sys.executable, "-c",
                                 textwrap.dedent(JAX_SIDE), str(d)],
                                cwd=ROOT, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
    _wait(ranks, "the gloo ranks")
    _wait([jax_side], "the JAX subprocess")
    return (inputs, dict(np.load(d / "torch.npz")),
            dict(np.load(d / "jax.npz")), jidx, jsvc)


def test_gloo_host_mesh(gloo_run):
    _, got, _, _, _ = gloo_run
    assert tuple(got["mesh_shape"]) == (WORLD, 1)
    assert tuple(got["mesh_names"]) == ("data", "model")
    # a (pod, data) pair of axes gives each rank the host mesh's shard
    assert bool(got["same_shard"])


def test_gloo_count_matches_host_exact(gloo_run):
    inputs, got, _, jidx, _ = gloo_run
    exact = jsnn.query_counts(jidx, inputs["q"], inputs["radius"])
    assert got["count"].dtype == np.int32 and got["count"].shape == (33,)
    np.testing.assert_array_equal(got["count"], exact)
    host = tsnn.query_counts(_port_index(jidx), inputs["q"], inputs["radius"])
    np.testing.assert_array_equal(got["count"], host)
    # the data axis of a (pod, data, model) mesh: four shards a pod
    np.testing.assert_array_equal(got["count_pod"], exact)


def test_gloo_topk_sets_match_the_host_batch(gloo_run):
    inputs, got, _, jidx, _ = gloo_run
    want = tsnn.query_radius_batch(_port_index(jidx), inputs["q"],
                                   inputs["radius"], return_distance=False)
    ids = got["topk_ids"]
    assert ids.shape == (33, WORLD * inputs["k"])
    for i in range(33):
        assert set(ids[i][ids[i] >= 0].tolist()) == set(want[i].tolist())


def test_gloo_percount_sums_are_the_csr_rows(gloo_run):
    inputs, got, _, jidx, _ = gloo_run
    csr = tsnn.query_radius_csr(_port_index(jidx), inputs["q"],
                                inputs["radius"], device="cpu", **CSR_KW)
    assert got["percount"].shape == (WORLD, 33)
    np.testing.assert_array_equal(got["percount"].sum(0), np.diff(csr.indptr))


def test_gloo_collectives_equal_jax_on_8_devices(gloo_run):
    inputs, got, want, jidx, _ = gloo_run
    np.testing.assert_array_equal(got["count"], want["count"])
    np.testing.assert_array_equal(got["percount"], want["percount"])
    np.testing.assert_array_equal(got["topk_ids"], want["topk_ids"])
    # half distances: equal where pruned (+BIG), within 4 float32 ulp of
    # |hn| + |q.x| elsewhere
    gd, wd = got["topk_dh"], want["topk_dh"]
    pruned = want["topk_ids"] < 0
    np.testing.assert_array_equal(gd[pruned], wd[pruned])
    xq, _ = jidx.prepare_queries(inputs["q"], inputs["radius"])
    inv = np.empty_like(jidx.order)
    inv[jidx.order] = np.arange(jidx.n)
    qi, col = np.nonzero(~pruned)
    xs = np.asarray(jidx.xs, np.float64)[inv[want["topk_ids"][qi, col]]]
    dot = np.abs(np.einsum("ij,ij->i", xs, xq[qi].astype(np.float64)))
    scale = 0.5 * (xs * xs).sum(1) + dot
    assert np.all(np.abs(gd[qi, col].astype(np.float64) - wd[qi, col])
                  <= 4 * EPS32 * scale)


@pytest.mark.parametrize("prune", [True, False])
def test_service_step_equals_the_jax_step(gloo_run, prune):
    inputs, got, _, _, jsvc = gloo_run
    mesh = jax.make_mesh((1,), ("data",))
    step = jax.jit(jcell.make_service_count_step(
        mesh, "data", q_chunk=SVC["q_chunk"], n_chunk=SVC["n_chunk"],
        prune=prune))
    qa = jsharded.prepare_query_arrays(jsvc, inputs["svc_q"], SVC["radius"])
    want = np.asarray(step(jsvc.xs, jsvc.alphas, jsvc.half_norms, *qa))
    assert want.sum() > 0
    # 8 gloo ranks over "data", and over ("pod", "data")
    np.testing.assert_array_equal(got[f"svc_{prune}"], want)
    np.testing.assert_array_equal(got[f"svc_pod_{prune}"], want)
    # one process holding the whole database
    tsvc = _port_index(jsvc)
    one = tcell.make_service_count_step(
        None, "data", q_chunk=SVC["q_chunk"], n_chunk=SVC["n_chunk"],
        prune=prune)(tsvc.xs, tsvc.alphas, tsvc.half_norms,
                     *tsharded.prepare_query_arrays(tsvc, inputs["svc_q"],
                                                    SVC["radius"]))
    assert one.dtype == torch.int32
    np.testing.assert_array_equal(one.numpy(), want)


def test_service_step_checks_its_shapes():
    step = tcell.make_service_count_step(None, "data", q_chunk=64,
                                         n_chunk=4096)
    xs = torch.zeros((4096 + 512, 16))
    ops = [torch.zeros(64, 16)] + [torch.zeros(64)] * 3
    with pytest.raises(ValueError, match="multiple"):
        step(xs, torch.zeros(4608), torch.zeros(4608), *ops)
    fn, specs, flops, meta = tcell.build_service_step("svc_10m")
    assert meta["n"] == 10_485_760 and specs[0] == ((10_485_760, 128),
                                                    torch.float32)
    assert flops == 2.0 * 1024 * 10_485_760 * 128 + 2.0 * 1024 * 10_485_760
    assert set(tcell.SNN_SHAPES) == set(jcell.SNN_SHAPES)
    assert tcell.SNN_SHAPES == jcell.SNN_SHAPES


def test_measured_window_fraction_matches_the_reference():
    kw = dict(n_sample=20_000, m=256, aniso_s=0.1)
    want = jcell.measured_window_fraction(32, 0.5, **kw)
    got = tcell.measured_window_fraction(32, 0.5, device="cpu", **kw)
    assert 0.05 < want < 0.9
    assert abs(got - want) <= 1e-3


def test_mesh_helpers_shape_the_production_meshes(monkeypatch):
    seen = []

    def fake_init(device_type, shape, *, mesh_dim_names=None):
        seen.append((device_type, shape, mesh_dim_names))
        return seen[-1]

    import torch.distributed.device_mesh as dm

    monkeypatch.setattr(dm, "init_device_mesh", fake_init)
    tmesh.make_production_mesh(device_type="cpu")
    tmesh.make_production_mesh(multi_pod=True, device_type="cpu")
    assert seen == [("cpu", (16, 16), ("data", "model")),
                    ("cpu", (2, 16, 16), ("pod", "data", "model"))]
    assert tmesh.dp_axes(True) == ("pod", "data")
    assert tmesh.dp_axes(False) == ("data",)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_production_mesh()
