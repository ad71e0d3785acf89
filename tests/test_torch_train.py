"""The port's recsys training and ranking retrieval against the JAX package.

At the reduced configs, the JAX package's ``build_step(arch, shape,
reduced=True).init_args()`` gives the parameters and the batch;
``params_from_jax`` carries the parameters across and ``params_to_jax``
brings the port's back for the comparison.  Tolerances:

* losses within 2^-20 of their magnitude (float32 sums in another order);
* gradients within 2^-16 of each leaf's largest magnitude (float32 GEMMs
  and reductions in another order than XLA's stay near 2^-21 here);
* a table's row gradient: JAX scatter-adds a bfloat16 table's gradient in
  bfloat16, rounding after every add; the port sums a row's occurrences in
  float32 and rounds once.  They differ by at most the rounding of JAX's
  adds: ``k * 2^-8 * sum |g|`` for a row touched k times;
* after the training steps: a bfloat16 table (row-wise SGD) equal or
  within 1 bfloat16 ulp; float32 tables within 4 float32 ulp of the leaf's
  largest magnitude (``lr * g``'s rounding differences); the leaves AdamW
  updates within that plus ``2^-12 * lr`` a step
  (AdamW divides by ``sqrt(v) + eps``: where a gradient element is near
  eps = 1e-8, a rounding difference in it moves the update by up to
  ``lr * |dg| / eps``);
* ranking retrieval (DLRM and Wide & Deep over 128 candidates, the
  parameters cast to bfloat16 as in JAX): scores within 2^-6 of the
  largest score (a few bfloat16 roundings); the top-100 ids equal JAX's,
  order and exact ties included, except at positions where JAX's scores
  of the two candidates lie within that tolerance (counted and printed).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import steps as jsteps
from repro.models import recsys as jrs
from repro_torch import utils
from repro_torch.kernels import snn_query as tsq
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import recsys as trs

ARCHS = ("dlrm-mlperf", "wide-deep", "mind")
JAX_LOSSES = {"dlrm-mlperf": jrs.dlrm_loss, "wide-deep": jrs.widedeep_loss,
              "mind": jrs.mind_loss}
ADAM_LR = 1e-3


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _dense(t):
    t = t.to_dense() if t.is_sparse else t
    return t.detach().float().numpy()


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def _train_pair(arch):
    jsd = jsteps.build_step(arch, "train_batch", reduced=True)
    jparams, jopt, jbatch = jsd.init_args()
    model = trs.params_from_jax(arch, _np_tree(jparams), device="cpu",
                                reduced=True)
    tsd = tsteps.build_step(arch, "train_batch", reduced=True)
    _, _, tbatch = tsd.init_args(device="cpu")
    return jsd, jparams, jopt, jbatch, tsd, model, tbatch


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_jax_grad(arch):
    jsd, jparams, _, jbatch, _, model, tbatch = _train_pair(arch)
    for k, v in jbatch.items():
        np.testing.assert_array_equal(tbatch[k].numpy(), np.asarray(v))
    cfg = jsteps.get_arch(arch).make_config("train_batch", True)
    jloss, jgrads = jax.value_and_grad(
        lambda p: JAX_LOSSES[arch](p, jbatch, cfg))(jparams)
    loss, grads = trs.value_and_grad(trs.LOSSES[arch], model, tbatch)
    assert abs(float(loss) - float(jloss)) <= 2.0 ** -20 * abs(float(jloss))
    got = _leaves(grads)
    want = _leaves(jgrads)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        name = jax.tree_util.keystr(path)
        w = np.asarray(w, np.float32)
        table = "table" in name or "items" in name
        assert g.is_sparse == table, name
        d = _dense(g)
        assert d.shape == w.shape, name
        if table:
            ids = g.indices()[0].numpy()
            assert np.all(np.diff(ids) > 0), name        # unique, ascending
            untouched = np.setdiff1d(np.arange(w.shape[0]), ids)
            assert not d[untouched].any() and not w[untouched].any(), name
        tol = 2.0 ** -16 * np.abs(w).max()
        assert np.abs(d - w).max() <= tol, (name, np.abs(d - w).max(), tol)


def _jax_row_grad(ids, table, cot):
    """JAX's table gradient of a masked gather (the VJP of ``jnp.take``, a
    scatter-add in the table's dtype)."""
    def look(t):
        e = jnp.take(t, jnp.clip(ids, 0, t.shape[0] - 1), axis=0)
        return jnp.where((ids >= 0)[..., None], e, 0).sum(1)
    _, vjp = jax.vjp(look, table)
    return np.asarray(vjp(cot)[0], np.float32)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("n_slots", [1, 5])
def test_row_grad_of_duplicate_ids(dtype, n_slots):
    # 600 bags over 13 rows: about 46 occurrences a row in bags of one,
    # 230 in bags of five; -1 padding and ids past the table (which read,
    # and train, its last row)
    rng = np.random.default_rng(11)
    v, d = 13, 6
    ids = rng.integers(-1, v + 2, (600, n_slots)).astype(np.int32)
    cot32 = rng.normal(size=(600, d)).astype(np.float32)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (
        jnp.float32, torch.float32)
    cot = jnp.asarray(cot32, jdt)
    g = trs.row_grad(torch.from_numpy(ids), torch.from_numpy(
        np.array(cot, np.float32)).to(tdt), v)
    assert g.is_sparse and g.is_coalesced() and g.dtype == tdt
    got = _dense(g)
    occ = np.clip(ids, 0, v - 1)
    c64 = np.asarray(cot, np.float64)
    exact = np.zeros((v, d))
    mag = np.zeros((v, d))
    k = np.zeros(v)
    for b, f in zip(*np.nonzero(ids >= 0)):
        exact[occ[b, f]] += c64[b]
        mag[occ[b, f]] += np.abs(c64[b])
        k[occ[b, f]] += 1
    # the port: a float32 sum, rounded once to the table's dtype (unit
    # roundoff u: 2^-8 for bfloat16's 8 bits, 2^-24 for float32)
    u = 2.0 ** -8 if dtype == "bfloat16" else 2.0 ** -24
    bound = u * np.abs(exact) + k[:, None] * 2.0 ** -24 * mag
    assert np.all(np.abs(got - exact) <= bound)
    # JAX: a scatter-add in the table's dtype
    want = _jax_row_grad(jnp.asarray(ids), jnp.zeros((v, d), jdt), cot)
    tol = k[:, None] * u * mag + bound
    assert np.all(np.abs(got - want) <= tol)
    # the same bits on every call, in any occurrence order
    again = trs.row_grad(torch.from_numpy(ids), torch.from_numpy(
        np.array(cot, np.float32)).to(tdt), v)
    assert torch.equal(again.to_dense(), g.to_dense())


def test_row_grad_of_all_padding_is_empty():
    g = trs.row_grad(torch.full((4, 3), -1, dtype=torch.int32),
                     torch.ones(4, 2), 10)
    assert g.is_sparse and g._nnz() == 0 and g.shape == (10, 2)


def _close_after_steps(name, got, want, t):
    want32 = np.asarray(want, np.float32)
    if np.asarray(want).dtype == jnp.bfloat16:
        ulp = np.spacing(np.abs(want32).astype(jnp.bfloat16)).astype(
            np.float32)
        tol = ulp
    else:
        tol = 4 * np.spacing(np.abs(want32).max())
        if not ("table" in name or "items" in name):
            tol += t * 2.0 ** -12 * ADAM_LR
    err = np.abs(got - want32)
    assert np.all(err <= tol), (name, t, err.max())


@pytest.mark.parametrize("arch", ARCHS)
def test_three_train_steps_match_reference(arch):
    jsd, jparams, jopt, jbatch, tsd, model, tbatch = _train_pair(arch)
    assert tsd.name == jsd.name
    opt_state = tsteps.train_optimizer().init(model.tree())
    jfn = jax.jit(jsd.fn)
    tsq.reset_launch_counts()
    for t in range(1, 4):
        jparams, jopt, jm = jfn(jparams, jopt, jbatch)
        out = tsd.fn(model, opt_state, tbatch)
        assert abs(float(out["loss"]) - float(jm["loss"])) <= \
            2.0 ** -20 * abs(float(jm["loss"]))
        got, want = _leaves(trs.params_to_jax(model)), _leaves(jparams)
        assert [p for p, _ in got] == [p for p, _ in want]
        for (path, g), (_, w) in zip(got, want):
            _close_after_steps(jax.tree_util.keystr(path), g, w, t)
        assert int(opt_state["rows"]["step"]) == int(jopt["rows"]["step"]) \
            == int(opt_state["dense"]["step"]) == t
    assert tsq.embedding_bag.launches == 0        # CPU tensors: plain version


def test_optimizer_state_has_the_reference_layout():
    for arch in ARCHS:
        _, _, jopt, _, _, model, _ = _train_pair(arch)
        tstate = tsteps.train_optimizer().init(model.tree())
        got = jax.tree.map(lambda t: tuple(t.shape), tstate,
                           is_leaf=lambda x: isinstance(x, torch.Tensor))
        assert got == jax.tree.map(lambda a: tuple(a.shape), jopt)


def _jax_ranking_scores(arch, jparams, jq, c):
    """The JAX step's scores before its top-k (``steps.py``'s body)."""
    cfg = jsteps.get_arch(arch).make_config("retrieval_cand", True)
    nf = jq["sparse"].shape[1]
    p16 = jax.tree.map(lambda a: a.astype(jnp.bfloat16)
                       if a.dtype == jnp.float32 else a, jparams)
    dense = jnp.broadcast_to(jq["dense"], (c, cfg.n_dense)).astype(
        jnp.bfloat16)
    sparse = jnp.broadcast_to(jq["sparse"], (c, nf)).at[:, 0].set(
        jq["cand_ids"])
    fwd = jrs.dlrm_forward if arch == "dlrm-mlperf" else jrs.widedeep_forward
    return np.asarray(fwd(p16, dense, sparse, cfg).astype(jnp.float32))


@pytest.mark.parametrize("arch", ["dlrm-mlperf", "wide-deep"])
def test_ranking_retrieval_matches_reference(arch):
    jsd = jsteps.build_step(arch, "retrieval_cand", reduced=True)
    jparams, jq = jsd.init_args()
    tsd = tsteps.build_step(arch, "retrieval_cand", reduced=True)
    _, tq = tsd.init_args(device="cpu")
    for k, v in jq.items():
        np.testing.assert_array_equal(tq[k].numpy(), np.asarray(v))
    model = trs.params_from_jax(arch, _np_tree(jparams), device="cpu",
                                reduced=True)
    jvals, jidx = (np.asarray(a) for a in jsd.fn(jparams, jq))
    want = _jax_ranking_scores(arch, jparams, jq, 128)
    np.testing.assert_array_equal(
        np.asarray(jax.lax.top_k(jnp.asarray(want), 100)[1]), jidx)
    tvals, tidx = tsd.fn(model, tq)
    with torch.inference_mode():
        got = trs.rank_candidates(model, tq["dense"], tq["sparse"],
                                  tq["cand_ids"]).numpy()
    tol = 2.0 ** -6 * np.abs(want).max()
    assert np.abs(got - want).max() <= tol
    assert tidx.shape == (100,) and tvals.dtype == torch.float32
    np.testing.assert_array_equal(tvals.numpy(), got[tidx.numpy()])
    tidx = tidx.numpy()
    differ = np.nonzero(tidx != jidx)[0]
    print(f"{arch}: {differ.size} of 100 positions differ from JAX's, each "
          f"between scores within {tol:.3e}")
    assert np.all(np.abs(want[tidx[differ]] - want[jidx[differ]]) <= tol)
    # equal candidate ids score equal bits: ties fall to the lower index
    for cid in np.unique(tq["cand_ids"].numpy()):
        rows = np.nonzero(tq["cand_ids"].numpy() == cid)[0]
        assert np.unique(got[rows]).size == 1
    if arch == "dlrm-mlperf":                       # no bfloat16 boundary hit
        np.testing.assert_array_equal(tidx, jidx)


def test_ranking_chunks_give_the_same_scores(monkeypatch):
    # 128 candidates in three equal chunks of 43 (one padded slot) against
    # one forward: the same scores up to the GEMMs' summation order
    jsd = jsteps.build_step("dlrm-mlperf", "retrieval_cand", reduced=True)
    jparams, _ = jsd.init_args()
    model = trs.params_from_jax("dlrm-mlperf", _np_tree(jparams),
                                device="cpu", reduced=True)
    _, tq = tsteps.build_step("dlrm-mlperf", "retrieval_cand",
                              reduced=True).init_args(device="cpu")
    with torch.inference_mode():
        whole = trs.rank_candidates(model, tq["dense"], tq["sparse"],
                                    tq["cand_ids"])
        monkeypatch.setattr(trs, "RANK_CHUNK", 50)
        parts = trs.rank_candidates(model, tq["dense"], tq["sparse"],
                                    tq["cand_ids"])
    assert parts.shape == whole.shape == (128,)
    tol = 2.0 ** -16 * float(whole.abs().max())
    assert float((parts - whole).abs().max()) <= tol


def test_top_k_ties_follow_lax_top_k():
    rng = np.random.default_rng(4)
    x = rng.integers(0, 5, (6, 200)).astype(np.float32)   # exact ties
    x[2] = 3.0                                            # a row all tied
    x[3, :150] = -0.0
    x[3, 150:] = 0.0
    for k in (1, 7, 100, 200):
        jv, ji = jax.lax.top_k(jnp.asarray(x), k)
        tv, ti = utils.top_k(torch.from_numpy(x), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    # the smallest, as the fixed-shape query takes them
    sv, si = utils.top_k(torch.from_numpy(x), 50, largest=False)
    jv, ji = jax.lax.top_k(jnp.asarray(-x), 50)
    np.testing.assert_array_equal(si.numpy(), np.asarray(ji))


def test_score_candidates_on_duplicated_rows_matches_reference():
    rng = np.random.default_rng(9)
    u = rng.normal(size=(3, 16)).astype(np.float32)
    cand = np.repeat(rng.normal(size=(30, 16)).astype(np.float32), 10, 0)
    jv, ji = jrs.score_candidates(jnp.asarray(u), jnp.asarray(cand), 25)
    tv, ti = trs.score_candidates(torch.from_numpy(u),
                                  torch.from_numpy(cand), 25)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=2.0 ** -16)


def test_mind_retrieval_on_duplicated_items_matches_reference():
    jsd = jsteps.build_step("mind", "retrieval_cand", reduced=True)
    jparams, jq = jsd.init_args()
    items = np.array(jparams["items"])
    items[64:128] = items[:64]                       # every score tied twice
    items[128:160] = items[:32]
    jparams = {**jparams, "items": jnp.asarray(items)}
    model = trs.params_from_jax("mind", _np_tree(jparams), device="cpu",
                                reduced=True)
    tsd = tsteps.build_step("mind", "retrieval_cand", reduced=True)
    _, tq = tsd.init_args(device="cpu")
    jvals, jidx = jsd.fn(jparams, jq)
    tvals, tidx = tsd.fn(model, tq)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    jvals = np.asarray(jvals)
    assert np.abs(tvals.numpy() - jvals).max() <= 2.0 ** -16 * np.abs(
        jvals).max()


def test_params_to_jax_inverts_params_from_jax():
    for arch in ARCHS:
        jparams = jsteps.build_step(arch, "serve_p99",
                                    reduced=True).init_args()[0]
        model = trs.params_from_jax(arch, _np_tree(jparams), device="cpu",
                                    reduced=True)
        back = trs.params_to_jax(model)
        for (path, a), (_, b) in zip(_leaves(back), _leaves(jparams)):
            np.testing.assert_array_equal(a, np.asarray(b, np.float32))
        again = trs.params_from_jax(arch, back, device="cpu", reduced=True)
        for p, q in zip(model.parameters(), again.parameters()):
            assert p.dtype == q.dtype and torch.equal(p, q)


def _run(arch, tmp_path, steps, *extra):
    log = tmp_path / f"{arch}.jsonl"
    model = ttrain.main(["--arch", arch, "--reduced", "--device", "cpu",
                         "--steps", str(steps), "--log", str(log),
                         *extra])
    return trs.params_to_jax(model), log


@pytest.mark.parametrize("arch", ARCHS)
def test_trainer_resume_is_bit_identical(arch, tmp_path, capsys):
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    straight, log = _run(arch, tmp_path / "a", 5)
    ck = str(tmp_path / "ck")
    _run(arch, tmp_path / "b", 2, "--ckpt-dir", ck)
    resumed, log_b = _run(arch, tmp_path / "b", 5, "--ckpt-dir", ck,
                          "--resume")
    assert "resumed from step 1" in capsys.readouterr().out
    for (path, a), (_, b) in zip(_leaves(straight), _leaves(resumed)):
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(path))
    lines = [json.loads(x) for x in log.read_text().splitlines()]
    lines_b = [json.loads(x) for x in log_b.read_text().splitlines()]
    assert [x["step"] for x in lines_b] == [0, 1, 2, 3, 4]
    assert [x["loss"] for x in lines_b] == [x["loss"] for x in lines]
    assert all(np.isfinite(x["loss"]) for x in lines)


def test_trainer_batches_follow_the_reference_sources():
    # DLRM and Wide & Deep: the click model, a pure function of the step;
    # MIND: the fixed batch of init_args
    for arch in ARCHS:
        _, model, _, batch_at = ttrain.setup(arch, reduced=True,
                                             device="cpu")
        a, b = batch_at(3), batch_at(3)
        assert all(torch.equal(a[k], b[k]) for k in a)
        if arch != "mind":
            vmax = min(model.cfg.vocab_sizes)
            assert int(a["sparse"].max()) < vmax
            assert not torch.equal(a["sparse"], batch_at(4)["sparse"])


def test_trainer_refuses_unported_families():
    """The families the trainer once refused (the LMs, the GAT, BERT4Rec)
    train now, a dict tree each; it refuses an arch the registry does not
    know and a shape that is not a training shape."""
    for arch in ("nemotron-4-15b", "gat-cora", "bert4rec"):
        params = ttrain.main(["--arch", arch, "--reduced", "--device", "cpu",
                              "--steps", "1"])
        assert isinstance(params, dict)
    with pytest.raises(KeyError, match="unknown arch"):
        ttrain.main(["--arch", "gpt-2", "--reduced", "--device", "cpu",
                     "--steps", "1"])
    with pytest.raises(ValueError, match="not a training shape"):
        ttrain.setup("mind", "serve_p99", reduced=True, device="cpu")


def test_trainer_runs_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(["--arch", "mind", "--reduced", "--steps", "1"])
    model = ttrain.main(["--arch", "mind", "--reduced", "--steps", "1",
                         "--device", "cpu"])
    assert model.items.device.type == "cpu"
