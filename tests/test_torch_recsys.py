"""The port's recsys serving path against the JAX reference (repro.models).

For each ported arch (DLRM, Wide & Deep, MIND) at its reduced config, the
JAX package's ``build_step(arch, shape, reduced=True).init_args()`` gives
the parameters and the batch; ``params_from_jax`` carries the parameters
across and the port's own ``build_step`` gives its batch.  Tolerances:

* table lookups are bit-equal: a bag of one is ``0 + 1 * row`` in the
  kernel's arithmetic, the row itself in float32 and bfloat16 alike;
* the MLPs, the interaction and the capsule routing are float32 GEMMs whose
  sums run in another order than XLA's: outputs agree to ``2^-16`` of their
  largest magnitude (float32 GEMM-order differences over these depths stay
  near ``2^-21``; a bfloat16 or TF32 product would be ``2^-8``-``2^-11``);
* the wide term's 40-id bag sums in slot order where XLA reduces in its
  own order: within the recursive-summation bound ``F * 2^-24 * sum |w|``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import steps as jsteps
from repro.models import recsys as jrs
from repro_torch.kernels import ops as tops
from repro_torch.kernels import snn_query as tsq
from repro_torch.launch import steps as tsteps
from repro_torch.models import recsys as trs

ARCHS = ("dlrm-mlperf", "wide-deep", "mind")


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _scaled_close(got, want, rel=2.0 ** -16):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    tol = rel * max(np.abs(want).max(), np.finfo(np.float32).tiny)
    assert np.abs(got - want).max() <= tol, (np.abs(got - want).max(), tol)


def _jax_and_port(arch, shape="serve_p99"):
    jsd = jsteps.build_step(arch, shape, reduced=True)
    jparams, jbatch = jsd.init_args()
    model = trs.params_from_jax(arch, _np_tree(jparams), device="cpu",
                                reduced=True)
    tsd = tsteps.build_step(arch, shape, reduced=True)
    _, tbatch = tsd.init_args(device="cpu")
    return jsd, jparams, jbatch, tsd, model, tbatch


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_step_matches_reference(arch):
    jsd, jparams, jbatch, tsd, model, tbatch = _jax_and_port(arch)
    assert tsd.name == jsd.name
    for k, v in jbatch.items():
        np.testing.assert_array_equal(tbatch[k].numpy(), np.asarray(v))
    want = np.asarray(jsd.fn(jparams, jbatch))
    tsq.reset_launch_counts()
    got = tsd.fn(model, tbatch)
    assert tsq.embedding_bag.launches == 0        # CPU tensors: plain version
    assert not got.requires_grad and got.dtype == torch.float32
    _scaled_close(got.numpy(), want)


def test_mind_retrieval_step_matches_reference():
    jsd, jparams, jq, tsd, model, tq = _jax_and_port("mind", "retrieval_cand")
    np.testing.assert_array_equal(tq["hist"].numpy(), np.asarray(jq["hist"]))
    jvals, jidx = jsd.fn(jparams, jq)
    tvals, tidx = tsd.fn(model, tq)
    assert tuple(tidx.shape) == (8, 100)
    _scaled_close(tvals.numpy(), np.asarray(jvals))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kind", ["rs_serve", "rs_train"])
@pytest.mark.parametrize("reduced", [True, False])
def test_rs_batch_equals_reference(arch, kind, reduced):
    jcfg = jsteps.get_arch(arch).make_config("serve_p99", reduced)
    tcfg = tsteps.get_arch(arch).make_config("serve_p99", reduced)
    want = jsteps._rs_batch(arch, jcfg, 16, np.random.default_rng(0), kind)
    got = tsteps._rs_batch(arch, tcfg, 16, np.random.default_rng(0), kind)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("arch", ["dlrm-mlperf", "wide-deep"])
def test_bag_of_one_lookup_is_the_gathered_row(arch):
    # DLRM's table is bfloat16, Wide & Deep's float32
    jsd = jsteps.build_step(arch, "serve_p99", reduced=True)
    jparams, jbatch = jsd.init_args()
    jcfg = jsteps.get_arch(arch).make_config("serve_p99", True)
    want = np.asarray(jrs.stacked_lookup(jparams["emb"], jbatch["sparse"],
                                         jcfg.vocab_sizes))
    model = trs.params_from_jax(arch, _np_tree(jparams), device="cpu",
                                reduced=True)
    table = model.table if arch == "dlrm-mlperf" else model.emb
    got = trs.stacked_lookup(table, torch.from_numpy(
        np.array(jbatch["sparse"])), model.offsets)
    assert got.dtype == (torch.bfloat16 if arch == "dlrm-mlperf"
                         else torch.float32)
    width = np.int16 if arch == "dlrm-mlperf" else np.int32
    np.testing.assert_array_equal(
        got.view(torch.int16 if width is np.int16 else torch.int32).numpy(),
        want.view(width))


def test_mind_history_gather_is_the_masked_take():
    jsd = jsteps.build_step("mind", "serve_p99", reduced=True)
    jparams, jbatch = jsd.init_args()
    hist = np.array(jbatch["hist"])
    hist[0, ::3] = -1                                # -1 padding,
    hist[2, :] = -1                                  # an all-padding history
    e = jnp.take(jparams["items"], jnp.maximum(hist, 0), axis=0)
    want = np.asarray(jnp.where((hist >= 0)[..., None], e, 0.0))
    items = torch.from_numpy(np.array(jparams["items"]))
    got = tops.embedding_bag(torch.from_numpy(hist).reshape(-1, 1), items)
    np.testing.assert_array_equal(
        got.view(*hist.shape, -1).view(torch.int32).numpy(),
        want.view(np.int32))
    # and the whole user tower on the padded histories
    jcfg = jsteps.get_arch("mind").make_config("serve_p99", True)
    model = trs.params_from_jax("mind", _np_tree(jparams), device="cpu",
                                reduced=True)
    with torch.inference_mode():
        caps = model(torch.from_numpy(hist))
    _scaled_close(caps.numpy(), np.asarray(
        jrs.mind_user_tower(jparams, jnp.asarray(hist), jcfg)))


def test_wide_sum_within_recursive_summation_bound():
    """The full-width wide term: 40 fields, a (V, 1) float32 table."""
    rng = np.random.default_rng(5)
    vocab = (97,) * 40
    v = trs.stacked_rows(vocab)
    w = (rng.normal(size=(v, 1)) * rng.choice([1e-3, 1.0, 1e3], (v, 1))
         ).astype(np.float32)
    ids = np.stack([rng.integers(0, n, 64) for n in vocab], 1).astype(np.int32)
    want = np.asarray(jrs.stacked_lookup({"table": jnp.asarray(w)},
                                         jnp.asarray(ids), vocab)[..., 0].sum(1))
    offsets = trs.field_offsets(vocab)
    gid = torch.from_numpy(ids) + offsets[None, :]
    got = tops.embedding_bag(gid, torch.from_numpy(w))[:, 0].numpy()
    rows = np.abs(w[gid.numpy(), 0]).astype(np.float64)
    bound = 40 * 2.0 ** -24 * rows.sum(1)
    diff = np.abs(got.astype(np.float64) - want)
    assert np.all(diff <= bound), (diff.max(), bound.min())
    # the slot-order sum is the float32 recursive sum, term for term
    seq = np.zeros(64, np.float32)
    for f in range(40):
        seq = (seq + w[gid.numpy()[:, f], 0]).astype(np.float32)
    np.testing.assert_array_equal(got, seq)


def test_widedeep_parts_sum_to_the_forward():
    _, _, _, tsd, model, tbatch = _jax_and_port("wide-deep")
    with torch.inference_mode():
        parts = (model.deep_logit(tbatch["dense"], tbatch["sparse"])
                 + model.wide_logit(tbatch["dense"], tbatch["sparse"]))
    assert torch.equal(parts, tsd.fn(model, tbatch))


def test_score_candidates_matches_reference():
    rng = np.random.default_rng(8)
    u = rng.normal(size=(3, 16)).astype(np.float32)
    cand = rng.normal(size=(300, 16)).astype(np.float32)
    jvals, jidx = jrs.score_candidates(jnp.asarray(u), jnp.asarray(cand), 10)
    tvals, tidx = trs.score_candidates(torch.from_numpy(u),
                                       torch.from_numpy(cand), 10)
    _scaled_close(tvals.numpy(), np.asarray(jvals))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))


@pytest.mark.parametrize("per_row", [False, True])
def test_retrieve_above_matches_reference(per_row):
    rng = np.random.default_rng(7)
    cand = rng.normal(size=(600, 16)).astype(np.float32)
    u = rng.normal(size=(4, 16)).astype(np.float32)
    s = np.sort((u.astype(np.float64) @ cand.T.astype(np.float64)), axis=1)
    # thresholds halfway inside each row's widest gap near its 20th score
    k = np.argmax(np.diff(s[:, -40:-10], axis=1), axis=1) + s.shape[1] - 40
    rows = np.arange(4)
    thr = ((s[rows, k] + s[rows, k + 1]) / 2).astype(np.float32)
    thr = thr if per_row else np.float32(thr.min())
    want = jrs.retrieve_above(u, cand, thr)
    got = trs.retrieve_above(torch.from_numpy(u), torch.from_numpy(cand), thr,
                             device="cpu")
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_allclose(got.distances, want.distances, rtol=1e-6,
                               atol=1e-6)
    assert got.nnz > 0


def test_params_from_jax_moves_bfloat16_bits():
    jsd = jsteps.build_step("dlrm-mlperf", "serve_p99", reduced=True)
    jparams, _ = jsd.init_args()
    table = np.asarray(jparams["emb"]["table"])
    assert table.dtype.name == "bfloat16"
    model = trs.params_from_jax("dlrm-mlperf", _np_tree(jparams),
                                device="cpu", reduced=True)
    np.testing.assert_array_equal(model.table.view(torch.int16).numpy(),
                                  table.view(np.int16))
    np.testing.assert_array_equal(
        model.bot.layers[0].weight.detach().numpy(),
        np.asarray(jparams["bot"][0]["w"]).T)
    with pytest.raises(ValueError, match="emb.table has shape"):
        trs.params_from_jax("dlrm-mlperf", _np_tree(jparams), device="cpu")


@pytest.mark.parametrize("arch,shape", [("bert4rec", "train_batch")])
def test_unported_steps_raise(arch, shape):
    """BERT4Rec's training, the last recsys step to be ported, builds its
    step now; an arch the registry does not know raises."""
    sd = tsteps.build_step(arch, shape, reduced=True)
    assert sd.name == f"{arch}:{shape}:train"
    params, state, batch = sd.init_args(device="cpu")
    assert set(state) == {"rows", "dense"} and set(batch) == {
        "seq", "labels", "negatives"}
    with pytest.raises(KeyError, match="unknown arch"):
        tsteps.build_step("bert5rec", shape, reduced=True)


@pytest.mark.parametrize("arch,shape", [
    (a, s) for a in ARCHS for s in ("serve_p99", "serve_bulk", "train_batch",
                                    "retrieval_cand")])
def test_model_flops_match_reference(arch, shape):
    jcfg = jsteps.get_arch(arch).make_config(shape, False)
    tcfg = tsteps.get_arch(arch).make_config(shape, False)
    sh = tsteps.get_arch(arch).shapes[shape]
    assert tsteps.rs_model_flops(arch, tcfg, sh) == jsteps.rs_model_flops(
        arch, jcfg, sh)


def test_registry_lists_the_ported_archs_with_reference_configs():
    assert set(ARCHS) <= set(tsteps.list_archs())
    assert {a for a in tsteps.list_archs()
            if tsteps.get_arch(a).family == "recsys"} == set(ARCHS) | {
                "bert4rec"}
    for arch in ARCHS:
        for reduced in (True, False):
            jcfg = jsteps.get_arch(arch).make_config("serve_p99", reduced)
            tcfg = tsteps.get_arch(arch).make_config("serve_p99", reduced)
            for f in ("vocab_sizes", "embed_dim", "bot_mlp", "top_mlp",
                      "deep_mlp", "n_items", "n_interests", "capsule_iters",
                      "hist_len", "n_dense"):
                assert getattr(tcfg, f, None) == getattr(jcfg, f, None), f
        assert tsteps.get_arch(arch).source == jsteps.get_arch(arch).source
