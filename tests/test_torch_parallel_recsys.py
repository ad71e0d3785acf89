"""The port's sharded recsys and GAT steps (``build_step(arch, shape,
mesh=...)``: the tables' rows over "model" through the embedding-bag
kernel's wrapper, the batch or the GAT's edges over the data axes)
against the JAX package's single-device steps, on the CPU.

Each case runs in gloo ranks (`_torch_parallel_recsys_rank.py`, one
process group a world size, joined through a file store in a temporary
directory) from the JAX package's reduced ``init_args()`` parameters,
carried across by ``params_from_jax`` and cut into shards, while the JAX
steps run here (the JAX package's own multi-device test does not find its
mesh axes on this host, so the single-device step is the reference):

* DLRM, Wide & Deep, MIND and BERT4Rec: ``train_batch`` (3 steps),
  ``serve_p99`` and ``retrieval_cand`` on (data, model) = (2, 2), (1, 4)
  and (4, 1), and DLRM on (pod, data, model) = (2, 2, 2) (``multi_pod``);
* the GAT: ``full_graph_sm`` (the edges over the data ranks, and
  between layers the padded node rows: ``N / dp`` hidden rows a rank, the
  last layer's output whole), ``minibatch_lg`` and ``molecule`` (the
  batch over them), 3 steps each, on (4, 1) and (2, 2); the full graph's
  loss and gradient of the starting parameters too;
* every case on (1, 1), which must be bit-equal to the unsharded port;
* a lookup on a (1, 4) table with ids at every shard boundary (row0 - 1,
  row0, row1 - 1), the last rows, ids past the table and -1 padding;
* a DLRM widened (``bot_mlp`` (256, 16), ``top_mlp`` (256, 1)) so that
  ``rs_param_spec`` cuts its MLP weights over "model" (the full-size
  DLRM's and Wide & Deep's are cut; the reduced configs' are not), its
  three steps on (2, 2) and (1, 4), against JAX's widened single-device
  step like every other case, and against the port's unsharded step.

Tolerances, and why:

* losses, the GAT's gradient norms, serving outputs and float32 retrieval
  scores within 2^-16 of their largest magnitude (float32 sums in another
  order: the data ranks' partial sums, Wide & Deep's wide bag a rank at a
  time);
* the ranking archs' retrieval scores (bfloat16 parameters, as the JAX
  step casts them) within 2^-6 of the largest score, a few bfloat16
  roundings (`test_torch_train`'s bound);
* top-100 indices equal to JAX's, except at positions where JAX's own
  scores of the two candidates lie within that score tolerance;
* after 3 steps the parameters as `_torch_train.adamw_params_close`
  states them (the tables' row-wise SGD and the dense AdamW leaves
  alike), a bfloat16 table (DLRM's) within one bfloat16 ulp of each
  element (JAX scatter-adds its gradient in bfloat16), and the optimizer
  state's moments within 2^-14 of each leaf's largest magnitude, its
  step counts equal;
* the widened DLRM against JAX as every other case, and against the
  port's unsharded step within 2^-16 of the largest magnitude (losses,
  outputs, the moments; 2^-6 for the bfloat16 retrieval scores) and the
  parameters as above;
* the shard-boundary lookup's bags of one bit-equal to the unsharded
  lookup and to the plain version on the whole table, the bags of five
  within ``F * 2^-24 * sum |w|``, and every row gradient bit-equal to the
  unsharded one (one rank holds every occurrence of a row, gathered in
  the unsharded order).

The mesh checks raise ``ValueError`` before any collective (a mesh
without a process group): a table's rows, the batch's, the candidates,
the GAT's padded edges and padded nodes that do not split.
"""
import contextlib
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import registry as jreg
from repro.launch import steps as jsteps
from repro.models import gnn as jgnn
from repro.models import recsys as jrs
from repro_torch.launch import steps as tsteps

from _torch_parallel_recsys_rank import params_file, wide_dlrm
from _torch_train import MOMENT_REL, one_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 240
RS_ARCHS = ("dlrm-mlperf", "wide-deep", "mind", "bert4rec")
RS_SHAPES = ("train_batch", "serve_p99", "retrieval_cand")
GNN_SHAPES = ("full_graph_sm", "minibatch_lg", "molecule")
REL = 2.0 ** -16
RANK_REL = 2.0 ** -6


def _case(arch, shape, mesh, multi_pod=False, wide=False):
    tag = f"{arch}-wide" if wide else arch
    name = f"{tag}_{shape}_{'x'.join(map(str, mesh))}"
    return dict(name=name, arch=arch, shape=shape, mesh=mesh,
                multi_pod=multi_pod, wide=wide)


# (world size, cases) a launch
LAUNCHES = {
    4: [_case(a, s, m) for m in ([2, 2], [1, 4], [4, 1])
        for a in RS_ARCHS for s in RS_SHAPES]
    + [_case("gat-cora", s, m) for m in ([4, 1], [2, 2]) for s in GNN_SHAPES]
    + [_case("dlrm-mlperf", s, m, wide=True) for m in ([2, 2], [1, 4])
       for s in RS_SHAPES]
    + [dict(name="lookup_1x4", unit="lookup", mesh=[1, 4], multi_pod=False)],
    8: [_case("dlrm-mlperf", s, [2, 2, 2], multi_pod=True)
        for s in RS_SHAPES],
    1: [_case(a, s, [1, 1]) for a in RS_ARCHS for s in RS_SHAPES]
    + [_case("gat-cora", s, [1, 1]) for s in GNN_SHAPES],
}
CASES = {c["name"]: c for cases in LAUNCHES.values() for c in cases
         if "arch" in c}
TRAIN = sorted(n for n, c in CASES.items()
               if c["shape"] == "train_batch" or c["arch"] == "gat-cora")
SERVE = sorted(n for n, c in CASES.items() if c["shape"] == "serve_p99")
RETRIEVAL = sorted(n for n, c in CASES.items()
                   if c["shape"] == "retrieval_cand")
ONE_RANK = sorted(n for n, c in CASES.items() if c["mesh"] == [1, 1])


def _key(path) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


def _np_leaves(tree) -> list:
    return [(jax.tree_util.keystr(p), np.asarray(
        jnp.asarray(a).astype(jnp.float32) if jnp.asarray(a).dtype ==
        jnp.bfloat16 else a), jnp.asarray(a).dtype == jnp.bfloat16)
        for p, a in jax.tree_util.tree_leaves_with_path(tree)]


def _jax_scores(arch, jparams, jq, c):
    """The JAX retrieval step's scores before its top-k."""
    cfg = jsteps.get_arch(arch).make_config("retrieval_cand", True)
    if arch == "mind":
        return np.asarray(jrs.mind_score_candidates(
            jparams, jq["hist"], jparams["items"][:c], cfg))
    if arch == "bert4rec":
        u = jrs.bert4rec_user_repr(jparams, jq["seq"], cfg)
        return np.asarray(u @ jparams["embed"][:c].T)
    nf = jq["sparse"].shape[1]
    p16 = jax.tree.map(lambda a: a.astype(jnp.bfloat16)
                       if a.dtype == jnp.float32 else a, jparams)
    dense = jnp.broadcast_to(jq["dense"], (c, cfg.n_dense)).astype(
        jnp.bfloat16)
    sparse = jnp.broadcast_to(jq["sparse"], (c, nf)).at[:, 0].set(
        jq["cand_ids"])
    fwd = jrs.dlrm_forward if arch == "dlrm-mlperf" else jrs.widedeep_forward
    return np.asarray(fwd(p16, dense, sparse, cfg).astype(jnp.float32))


def _jax_arch(wide: bool):
    """JAX's DLRM widened as the rank widens the port's, or nothing."""
    return wide_dlrm(jreg) if wide else contextlib.nullcontext()


def jax_run(arch, shape, wide=False) -> dict:
    """JAX's single-device step at the reduced size (DLRM ``wide``ned):
    its initial parameters, and its 3 training steps, its serving outputs
    or its top 100 (with the scores before the top-k)."""
    with _jax_arch(wide):
        return _jax_run(arch, shape)


def _jax_run(arch, shape) -> dict:
    jsd = jsteps.build_step(arch, shape, reduced=True)
    args = jsd.init_args()
    out = {"params0": args[0]}
    fn = jax.jit(jsd.fn)
    if shape == "train_batch" or arch == "gat-cora":
        params, state, batch = args
        if shape == "full_graph_sm":
            cfg = jreg.get_arch(arch).make_config(shape, True)
            out["grad_loss"], out["grads"] = jax.jit(jax.value_and_grad(
                lambda p: jgnn.loss_full(p, batch, cfg)))(params)
        out["metrics"] = []
        for _ in range(3):
            params, state, m = fn(params, state, batch)
            out["metrics"].append({k: float(v) for k, v in m.items()})
        out["params"], out["opt"] = params, state
    elif shape == "serve_p99":
        out["out"] = np.asarray(fn(*args))
    else:
        vals, idx = fn(*args)
        out["vals"], out["idx"] = np.asarray(vals), np.asarray(idx)
        out["scores"] = _jax_scores(arch, args[0], args[1], 128)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every launch's gloo ranks, and JAX's runs of each (arch, shape)
    meanwhile: {case name: (the port's sharded results, JAX's)}."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    rank_script = str(ROOT / "tests" / "_torch_parallel_recsys_rank.py")
    keys = sorted({(c["arch"], c["shape"], c["wide"])
                   for c in CASES.values()})
    params = {}
    for arch, shape, wide in keys:
        with _jax_arch(wide):
            jsd = jsteps.build_step(arch, shape, reduced=True)
            params[(arch, shape, wide)] = jsd.init_args()[0]
    procs, dirs = [], {}
    for world, cases in LAUNCHES.items():
        d = tmp_path_factory.mktemp(f"rs{world}")
        dirs[world] = d
        for c in cases:
            if "arch" not in c:
                continue
            np.savez(d / params_file(c), **{
                _key(p): np.asarray(jnp.asarray(a).astype(jnp.float32)
                                    if a.dtype == jnp.bfloat16 else a)
                for p, a in jax.tree_util.tree_flatten_with_path(
                    params[(c["arch"], c["shape"], c["wide"])])[0]})
        (d / "cases.json").write_text(json.dumps(cases))
        procs.append((world, [subprocess.Popen(
            [sys.executable, rank_script, str(r), str(world), str(d)],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for r in range(world)]))
    ref = {key: jax_run(*key) for key in keys}
    out = {}
    for world, ps in procs:
        for p in ps:
            try:
                _, err = p.communicate(timeout=TIMEOUT_S)
            except subprocess.TimeoutExpired:
                for _, other in procs:
                    for q in other:
                        q.kill()
                pytest.fail(f"the {world} gloo ranks ran over {TIMEOUT_S} s")
            assert p.returncode == 0, f"{world} ranks: {err[-3000:]}"
        for case in LAUNCHES[world]:
            z = dict(np.load(dirs[world] / f"{case['name']}_torch.npz"))
            out[case["name"]] = (z, ref.get((case.get("arch"),
                                             case.get("shape"),
                                             case.get("wide"))))
    return out


def _rel_close(got, want, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    top = max(np.abs(want).max(initial=0.0), 1e-30)
    assert np.abs(got - want).max(initial=0.0) <= rel * top, (
        np.abs(got - want).max() / top)


def _params_close(got: list, want: list, lr: float, steps: int = 3):
    """`_torch_train.adamw_params_close`'s bound, a bfloat16 leaf within
    one bfloat16 ulp of each element."""
    far = total = 0
    assert len(got) == len(want)
    for g, (path, w, bf16) in zip(got, want):
        assert g.shape == w.shape, path
        d = np.abs(g - w)
        if bf16:
            ulp = np.spacing(np.abs(w).astype(jnp.bfloat16)).astype(
                np.float64)
            assert np.all(d <= ulp), (path, (d / ulp).max())
            continue
        top = np.float32(np.abs(w).max(initial=0.0))
        assert d.max(initial=0.0) <= 2 * lr * steps, (path, d.max() / lr)
        far += int((d > 4 * np.spacing(top) + 2.0 ** -12 * lr * steps).sum())
        total += d.size
    assert far * 1000 <= total, (far, total)


def _flat(z: dict, prefix: str) -> list:
    n = sum(1 for k in z if k.startswith(prefix + "_"))
    return [z[f"{prefix}_{i}"] for i in range(n)]


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_init_is_the_unsharded_init(runs, name):
    # the shards gather to the unsharded init_args bit for bit (the
    # optimizer state too), the batch is the rank's rows of it
    assert bool(runs[name][0]["same_init"])


@pytest.mark.parametrize("name", TRAIN)
def test_sharded_training_matches_the_jax_step(runs, name):
    z, ref = runs[name]
    for t, m in enumerate(ref["metrics"]):
        for k, v in m.items():
            _rel_close(z[f"{k}_{t}"], v)
    lr = 5e-3 if CASES[name]["arch"] == "gat-cora" else 1e-3
    _params_close(_flat(z, "params"), _np_leaves(ref["params"]), lr)
    got, want = _flat(z, "opt"), _np_leaves(ref["opt"])
    assert len(got) == len(want)
    for g, (path, w, _) in zip(got, want):
        if np.issubdtype(w.dtype, np.floating):
            _rel_close(g, w, MOMENT_REL)
        else:
            np.testing.assert_array_equal(g, w, err_msg=path)


@pytest.mark.parametrize("name", sorted(
    n for n, c in CASES.items() if c["shape"] == "full_graph_sm"))
def test_full_graph_hidden_rows_over_the_data_ranks(runs, name):
    # the reference's nodes_nd (dp, None): each layer but the last takes
    # and gives N / dp of the 512 padded node rows a rank, the last gives
    # the logits whole; the loss and every gradient as JAX's
    z, ref = runs[name]
    dp = CASES[name]["mesh"][0]
    rows = 512 // dp
    assert z["rows"].tolist() == sorted(map(list, {(rows, rows), (rows, 512)}))
    _rel_close(z["loss0"], ref["grad_loss"])
    want = _np_leaves(ref["grads"])
    got = _flat(z, "gparams")
    assert len(got) == len(want) == 6
    for g, (path, w, _) in zip(got, want):
        _rel_close(g, w)


@pytest.mark.parametrize("name", SERVE)
def test_sharded_serving_matches_the_jax_step(runs, name):
    z, ref = runs[name]
    _rel_close(z["out"], ref["out"])


@pytest.mark.parametrize("name", RETRIEVAL)
def test_sharded_retrieval_matches_the_jax_step(runs, name):
    z, ref = runs[name]
    ranking = CASES[name]["arch"] in ("dlrm-mlperf", "wide-deep")
    scores = ref["scores"][None] if ranking else ref["scores"]
    vals, idx = np.atleast_2d(z["vals"]), np.atleast_2d(z["idx"]).astype(
        np.int64)
    jidx = np.atleast_2d(ref["idx"])
    assert idx.shape == jidx.shape == (scores.shape[0], 100)
    tol = (RANK_REL if ranking else REL) * np.abs(scores).max()
    rows = np.arange(scores.shape[0])[:, None]
    # each value is JAX's score of its candidate, within the tolerance
    assert np.abs(vals - scores[rows, idx]).max() <= tol
    differ = idx != jidx
    assert np.all(np.abs(scores[rows, idx] - scores[rows, jidx])[differ]
                  <= tol)
    assert np.all(np.diff(vals, axis=1) <= 0)


@pytest.mark.parametrize("name", ONE_RANK)
def test_one_rank_mesh_is_bit_equal_to_the_unsharded_steps(runs, name):
    # the rank ran the unsharded step on the same inputs: every loss,
    # output, parameter and optimizer leaf equal
    assert bool(runs[name][0]["bit_equal"])


def test_row_sharded_lookup_at_the_shard_boundaries(runs):
    z, _ = runs["lookup_1x4"]
    np.testing.assert_array_equal(z["one_got"], z["one_want"])
    np.testing.assert_array_equal(z["one_got"], z["one_ref"])
    # an id past the table reads its last row on every mesh (not each
    # shard's last row), -1 reads nothing
    np.testing.assert_array_equal(z["one_got"][-3], z["one_ref"][-4])
    assert not z["one_got"][-1].any()
    mag = np.abs(z["five_ref"]).max()
    assert np.abs(z["five_got"] - z["five_want"]).max() <= \
        5 * 2.0 ** -24 * 5 * mag
    for name in ("one", "five"):
        np.testing.assert_array_equal(z[f"{name}_grad"],
                                      z[f"{name}_grad_want"])


@pytest.mark.parametrize("name", ["wide_mlp_2x2", "wide_mlp_1x4"])
def test_wide_mlp_weights_cut_over_model_are_gathered(runs, name):
    # (the widened DLRM's cases are held against JAX by the tests above;
    # here: its weights are cut, and it gives the port's unsharded step)
    mesh = name.rsplit("_", 1)[1]
    for shape in RS_SHAPES:
        z, _ = runs[f"dlrm-mlperf-wide_{shape}_{mesh}"]
        # the top MLP's weights are stored cut over "model": (26, 256) by
        # its columns, (256, 1) by its rows
        assert z["cut"].tolist() == [True, True]
        keys = sorted(k[len("plain/"):] for k in z if k.startswith("plain/"))
        assert keys
        for k in keys:
            got, want = z[k], z["plain/" + k]
            if k.startswith("params_"):
                _params_close([got], [(k, want, False)], 1e-3)
            else:
                _rel_close(got, want, RANK_REL if k == "vals" else REL)


def _mesh(*sizes, multi_pod=False):
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return types.SimpleNamespace(mesh_dim_names=names,
                                 size=lambda i: sizes[i])


@pytest.mark.parametrize("arch,shape,mesh,what", [
    ("mind", "train_batch", (1, 3), "items"),
    ("dlrm-mlperf", "serve_p99", (1, 3), "table"),
    ("wide-deep", "retrieval_cand", (1, 3), "table"),
    ("bert4rec", "serve_p99", (1, 5), "embed"),
    ("mind", "serve_p99", (3, 1), "batch's rows"),
    ("dlrm-mlperf", "retrieval_cand", (3, 1), "candidates"),
    ("gat-cora", "full_graph_sm", (3, 1), "padded edges"),
    ("gat-cora", {"n_nodes": 100, "n_edges": 1000}, (3, 1), "padded nodes"),
    ("gat-cora", "minibatch_lg", (3, 2), "seed nodes"),
    ("gat-cora", "molecule", (3, 1), "graphs")])
def test_mesh_checks_raise_before_any_collective(arch, shape, mesh, what):
    # no table is padded silently: a row count that does not split over
    # "model" (MIND's 512 items, the stacked tables' 256 rows, BERT4Rec's
    # 576-row vocabulary) raises, as do the batch's rows, the ranking
    # candidates and the GAT's edges over the data ranks
    # (a dict: full_graph_sm at full width with these nodes and edges,
    # 1,536 padded edges over 3 data ranks, 512 padded nodes not)
    kw = ({"reduced": True} if isinstance(shape, str) else
          {"reduced": False, "shape_override": shape})
    shape = shape if isinstance(shape, str) else "full_graph_sm"
    with pytest.raises(ValueError, match=what):
        tsteps.build_step(arch, shape, mesh=_mesh(*mesh), **kw)
    # a multi-pod step wants the axes ("pod", "data", "model")
    with pytest.raises(ValueError, match="axes"):
        tsteps.build_step(arch, shape, multi_pod=True, mesh=_mesh(*mesh),
                          **kw)
