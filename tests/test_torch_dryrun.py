"""The port's dry-run (`launch.dryrun`) and roofline terms
(`launch.hlo_analysis`) on the CPU.

The dry-run traces a cell's step on fake tensors at rank 0 of a fake
process group, which is process-global: every trace here runs inside
`dryrun.fake_world`, which destroys its group on the way out.  Widths are
the reduced configs' (64-wide, 4 heads), so each trace takes a second.

Tolerances, and why:

* a sharded step's flops over all its ranks equal the unsharded step's to
  1e-6: at these meshes every product is split over the data or the model
  ranks and none is replicated (the KV heads divide "model", no MoE
  router, no MLA), so the sum is the same products cut into pieces; a
  sharded decode step's likewise, plus, for MLA, the latent projections
  that every model rank computes whole (counted exactly);
* the depth fit (`_fit_lm_costs`) is exact in flops, bytes, collectives
  and peak bytes to 1e-6: a step is affine in its layers.
"""
import json

import pytest
import torch
import torch.distributed as dist

from repro_torch.launch import dryrun, hlo_analysis
from repro_torch.launch import steps as tsteps
from repro_torch.launch.hlo_analysis import (HBM_BW, PEAK_FLOPS,
                                             CollectiveRecord, Roofline,
                                             collective_bytes)

FIELDS = ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff",
          "vocab", "mla", "moe", "local_window")
SMALL = {"seq_len": 32, "global_batch": 8}


def _reduced(arch, **over):
    cfg = tsteps.get_arch(arch).make_config("train_4k", True)
    return {**{f: getattr(cfg, f) for f in FIELDS}, **over}


def test_roofline_terms():
    r = Roofline(flops=PEAK_FLOPS, hbm_bytes=HBM_BW, coll_bytes=0.0,
                 coll_breakdown={}, n_devices=2, model_flops=PEAK_FLOPS)
    assert abs(r.t_compute - 1.0) < 1e-9
    assert abs(r.t_memory - 1.0) < 1e-9
    assert r.bottleneck in ("compute", "memory")
    assert abs(r.useful_flops_ratio - 0.5) < 1e-12
    assert abs(r.mfu - 0.5) < 1e-12
    fp32 = Roofline(flops=67e12, hbm_bytes=0.0, coll_bytes=450e9,
                    coll_breakdown={}, n_devices=1, model_flops=0.0,
                    peak_flops=hlo_analysis.PEAK_FLOPS_FP32)
    assert abs(fp32.t_compute - 1.0) < 1e-9
    assert abs(fp32.t_collective - 1.0) < 1e-9
    assert hlo_analysis.ICI_BW == 450e9 and HBM_BW == 3.35e12


def test_collective_bytes_of_a_traced_step():
    # 8 ranks as (2, 4): an all-gather over "model" (4), a reduce-scatter
    # over "data" (2) and an all-reduce over the whole group
    def step(x):
        out = x.new_empty((4 * 64, 32))
        dist.all_gather_into_tensor(out, x, group=mesh.get_group("model"))
        part = x.new_empty((32, 32))
        dist.reduce_scatter_tensor(part, x, group=mesh.get_group("data"))
        dist.all_reduce(part)
        return out @ out.T

    with dryrun.fake_world(8):
        mesh = dryrun._cpu_mesh((2, 4))   # made outside the fake tensors
        tr = hlo_analysis.record_step(
            step, lambda: (torch.empty(64, 32, dtype=torch.bfloat16),))
    assert tr.collectives == [
        CollectiveRecord("all-gather", 256 * 32 * 2, 4),
        CollectiveRecord("reduce-scatter", 32 * 32 * 2, 2),
        CollectiveRecord("all-reduce", 32 * 32 * 2, 8)]
    # the reference's operand bytes: result / G, result x G, result
    assert collective_bytes(tr.collectives) == {
        "all-gather": 64 * 32 * 2, "reduce-scatter": 64 * 32 * 2,
        "all-reduce": 32 * 32 * 2}
    assert tr.flops == 2 * 256 * 32 * 256
    assert tr.peak_bytes >= 64 * 32 * 2 + 256 * 256 * 2
    assert not dist.is_initialized()


def _unsharded_flops(arch, over):
    step = tsteps.build_step(arch, "train_4k", cfg_override=over,
                             shape_override=SMALL)
    return hlo_analysis.record_step(
        step.fn, lambda: step.init_args(device="cpu")).flops


@pytest.mark.parametrize("mesh,multi_pod", [((2, 2), False),
                                            ((2, 2, 2), True)])
def test_sharded_flops_sum_to_the_unsharded_step(mesh, multi_pod):
    over = _reduced("internlm2-20b")
    rec = dryrun.run_cell("internlm2-20b", "train_4k", multi_pod=multi_pod,
                          mesh_shape=mesh, fit_lm=False, cfg_override=over,
                          shape_override=SMALL, verbose=False)
    n = 1
    for s in mesh:
        n *= s
    assert rec["n_devices"] == n and rec["mesh"] == mesh
    want = _unsharded_flops("internlm2-20b", over)
    assert abs(rec["flops_per_device"] * n - want) <= 1e-6 * want
    kinds = rec["collective_breakdown"]
    assert {"all-gather", "reduce-scatter", "all-reduce"} <= set(kinds)
    assert rec["bottleneck"] in ("compute", "memory", "collective")
    assert rec["hardware"]["peak_flops_bf16"] == PEAK_FLOPS
    assert 0 < rec["memory_analysis"]["argument_size_in_bytes"] \
        <= rec["peak_memory_bytes"]


@pytest.mark.parametrize("arch", ["internlm2-20b", "minicpm3-4b"])
def test_sharded_decode_flops_sum_to_the_unsharded_step(arch):
    """A decode step at (2, 2): every rank scores all heads (the queries
    gathered over "model") over its block of the cache, which cuts the
    scores and values into pieces without repeating any, and GQA's KV
    projections are split (2 KV heads over 2 model ranks).  The work done
    on both model ranks is MLA's ``wq_a`` and ``wkv_a`` products, whole on
    every model rank: (tp - 1) 2 B L d (q_lora + kv_lora + qk_rope)
    flops, none for GQA.  Beyond that the sum equals to 1e-6."""
    over = _reduced(arch)
    rec = dryrun.run_cell(arch, "decode_32k", mesh_shape=(2, 2),
                          fit_lm=False, cfg_override=over,
                          shape_override=SMALL, verbose=False)
    step = tsteps.build_step(arch, "decode_32k", cfg_override=over,
                             shape_override=SMALL)
    want = hlo_analysis.record_step(
        step.fn, lambda: step.init_args(device="cpu")).flops
    replicated = 0
    if over["mla"] is not None:
        m = over["mla"]
        replicated = (2 - 1) * 2 * SMALL["global_batch"] * over["n_layers"] \
            * over["d_model"] * (m.q_lora + m.kv_lora + m.qk_rope)
    assert replicated > 0 or arch == "internlm2-20b"
    got = rec["flops_per_device"] * 4
    assert abs(got - (want + replicated)) <= 1e-6 * want
    assert {"all-gather", "all-reduce"} <= set(rec["collective_breakdown"])
    assert rec["step"] == step.name


def test_depth_fit_equals_a_full_depth_trace():
    over = _reduced("internlm2-20b", n_layers=5)
    kw = dict(mesh_shape=(2, 2), cfg_override=over, shape_override=SMALL,
              verbose=False)
    full = dryrun.run_cell("internlm2-20b", "train_4k", fit_lm=False, **kw)
    fit = dryrun.run_cell("internlm2-20b", "train_4k", fit_lm=True, **kw)
    for key in ("flops_per_device", "hbm_bytes_per_device",
                "collective_bytes_per_device"):
        assert abs(fit[key] - full[key]) <= 1e-6 * full[key], key
    assert fit["collective_breakdown"].keys() == \
        full["collective_breakdown"].keys()
    assert abs(fit["peak_memory_bytes"] - full["peak_memory_bytes"]) \
        <= 1e-6 * full["peak_memory_bytes"]


def test_cells_not_run_on_a_mesh_are_skipped_records(tmp_path):
    """The recsys and GAT steps run on a mesh: ``mind:train_batch`` (the
    row gradient's occurrences gathered over the data ranks, its dense
    gradients all-reduced) and ``dlrm-mlperf:serve_p99`` (the lookups
    summed over "model", the outputs gathered) at (2, 2) are records with
    terms, and so is minicpm3-4b's ``train_4k`` at the production (16,
    16), whose 40 MLA heads "model" does not divide (three heads on this
    rank, rank 0; traced at 2 of its 62 layers, the depth fit is
    `test_depth_fit_equals_a_full_depth_trace`'s), and the reduced
    nemotron-4-15b's ``prefill_32k`` at (1, 8), whose 4 query heads are
    fewer than the model ranks (rank 0 holds one; ranks 4-7 none, as
    GSPMD replicates them).  A cell that the reference's jit refuses stays
    a ``skipped`` record: the reduced nemotron-4-15b with a vocabulary of
    500 over a "model" of 8."""
    recs = [dryrun.run_cell("mind", "train_batch", mesh_shape=(2, 2),
                            out_dir=str(tmp_path), verbose=False),
            dryrun.run_cell("dlrm-mlperf", "serve_p99",
                            mesh_shape=(2, 2), verbose=False),
            dryrun.run_cell("minicpm3-4b", "train_4k", fit_lm=False,
                            cfg_override={"n_layers": 2}, verbose=False),
            dryrun.run_cell("nemotron-4-15b", "prefill_32k",
                            mesh_shape=(1, 8), fit_lm=False,
                            cfg_override=_reduced("nemotron-4-15b"),
                            shape_override=SMALL, verbose=False),
            dryrun.run_cell("nemotron-4-15b", "prefill_32k",
                            mesh_shape=(1, 8),
                            cfg_override=_reduced("nemotron-4-15b",
                                                  vocab=500),
                            shape_override=SMALL, verbose=False)]
    for rec, step in zip(recs[:2], ("mind:train_batch:train",
                                    "dlrm-mlperf:serve_p99:serve")):
        assert "skipped" not in rec and rec["step"] == step
        assert rec["mesh"] == (2, 2) and rec["n_devices"] == 4
        assert rec["flops_per_device"] > 0 and rec["hbm_bytes_per_device"] > 0
        assert {"all-gather", "all-reduce"} <= set(rec["collective_breakdown"])
        assert 0 < rec["memory_analysis"]["argument_size_in_bytes"] \
            <= rec["peak_memory_bytes"]
        assert rec["bottleneck"] in ("compute", "memory", "collective")
    mla = recs[2]
    assert "skipped" not in mla and mla["step"] == "minicpm3-4b:train_4k:train"
    assert mla["mesh"] == (16, 16) and mla["n_devices"] == 256
    assert min(mla["t_compute_s"], mla["t_memory_s"],
               mla["t_collective_s"]) > 0
    assert {"all-gather", "reduce-scatter"} <= set(
        mla["collective_breakdown"])
    assert 0 < mla["peak_memory_bytes"] < 80e9
    few = recs[3]
    assert "skipped" not in few
    assert few["step"] == "nemotron-4-15b:prefill_32k:prefill"
    assert few["mesh"] == (1, 8) and few["n_devices"] == 8
    assert few["flops_per_device"] > 0 and few["hbm_bytes_per_device"] > 0
    assert {"all-gather", "reduce-scatter"} <= set(
        few["collective_breakdown"])
    assert set(recs[4]) >= {"arch", "shape", "mesh", "skipped"}
    assert recs[4]["skipped"].startswith(
        "params/embed: dimension 0 (500) does not divide over model (8")
    saved = json.loads((tmp_path / "mind__train_batch__single.json")
                       .read_text())
    assert saved["flops_per_device"] == recs[0]["flops_per_device"]
    assert not dist.is_initialized()


def test_a_meshs_groups_over_several_axes_are_its_own():
    """Two meshes of one shape compare equal, also over two process
    groups: the ("pod", "data") group of the second must be its own, and
    stay made while it lives after the first is freed (a cache keyed by
    the mesh handed the second the first's group, then lost it, and
    made a group inside ``--all``'s trace of llama4-scout's multi-pod
    ``train_4k``)."""
    import gc

    from repro_torch.distributed import parallel

    with dryrun.fake_world(8):
        first = dryrun._cpu_mesh((2, 2, 2))
        g1 = parallel._groups_of(first, ("pod", "data"))[0]
    with dryrun.fake_world(8):
        second = dryrun._cpu_mesh((2, 2, 2))
        assert second == first
        g2 = parallel._groups_of(second, ("pod", "data"))[0]
        assert g2 is not g1
        del first
        gc.collect()
        assert parallel._groups_of(second, ("pod", "data"))[0] is g2
    assert not dist.is_initialized()


@pytest.mark.parametrize("multi_pod", [False, True])
def test_every_cell_builds_at_the_production_mesh(multi_pod):
    """``--all`` writes a ``skipped`` record for a cell whose step does
    not build on the production mesh (a ``ValueError`` or
    ``NotImplementedError`` of `steps.build_step`): none does now, the
    40-head cells of llama4-scout and minicpm3-4b included.  (The
    registry's own skips, the full-attention archs' ``long_500k``, are
    printed and write no record.)"""
    from repro_torch.configs.registry import all_cells

    shape = dryrun.production_shape(multi_pod)
    cells = [(a, s) for a, s, skip in all_cells(include_skipped=True)
             if not skip]
    assert {("llama4-scout-17b-a16e", "train_4k"),
            ("minicpm3-4b", "decode_32k")} <= set(cells)
    with dryrun.fake_world(256 * (2 if multi_pod else 1)):
        mesh = dryrun._cpu_mesh(shape)
        for arch, shape_name in cells:
            step = tsteps.build_step(arch, shape_name, multi_pod=multi_pod,
                                     mesh=mesh)
            assert step.name.startswith(f"{arch}:{shape_name}")
    assert not dist.is_initialized()


def test_snn_service_record_at_the_production_mesh(monkeypatch, tmp_path):
    from repro_torch.launch import snn_cell

    monkeypatch.setattr(snn_cell, "measured_window_fraction",
                        lambda *a, **k: 0.25)
    monkeypatch.setattr(dryrun, "_WINDOW_FRACTIONS", {})
    dryrun.main(["--arch", "snn-service", "--shape", "svc_10m",
                 "--out", str(tmp_path)])
    rec = json.loads((tmp_path / "snn-service__svc_10m__single__snn.json")
                     .read_text())
    n_local = snn_cell.SNN_SHAPES["svc_10m"]["n"] // 16
    assert rec["mesh"] == [16, 16] and rec["window_fraction"] == 0.25
    # the count's product over the rank's shard, at the float32 peak
    assert rec["flops_per_device"] == 2 * 1024 * n_local * 128
    assert rec["collective_breakdown"] == {"all-reduce": 1024 * 4}
    assert abs(rec["t_compute_pruned_s"] - 0.25 * rec["t_compute_s"]) < 1e-12
    assert abs(rec["t_compute_s"] - rec["flops_per_device"] / 67e12) < 1e-12
