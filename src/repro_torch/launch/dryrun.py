"""Multi-pod dry-run: trace every (arch x shape) cell's step at the
production mesh on the CPU, and persist its roofline terms as JSON.

The counterpart of ``repro.launch.dryrun``, which lowers and compiles each
cell for the 16 x 16 (or 2 x 16 x 16) mesh over 512 host devices.  Here
the step is built at rank 0 of a fake process group of the mesh's world
size (``torch.testing._internal.distributed.fake_pg``: every collective
returns at once and moves nothing), over a `DeviceMesh` made with
``device_type="cpu"``, and run once on fake tensors: nothing is computed
and nothing of the model's size is allocated, so it needs no card and
runs in seconds on a laptop.  This is the one entry point of the port
whose mesh is on the CPU by default.  `hlo_analysis.record_step` reads the
flops, the bytes accessed, the collectives and the peak bytes of the
trace; `hlo_analysis.analyze` turns them into the H100's roofline terms.

Usage:
  python -m repro_torch.launch.dryrun --arch internlm2-20b --shape train_4k
  python -m repro_torch.launch.dryrun --arch internlm2-20b --shape train_4k --multi-pod
  python -m repro_torch.launch.dryrun --arch snn-service --shape svc_10m
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--out experiments/dryrun]

Every cell of the registry runs on a mesh: the five LMs' ``train_4k``,
``prefill_32k``, ``decode_32k`` and ``long_500k``, the four recsys archs'
``train_batch``, ``serve_p99``, ``serve_bulk`` and ``retrieval_cand``
(the tables' rows over "model"), the GAT's four shapes (the full graph's
edges, or the batch, over the data axes) and the paper's own
``snn-service``; llama4-scout's and minicpm3-4b's 40 heads, which the
production "model" of 16 does not divide, are traced on rank 0, one of
the ranks that hold three heads (`distributed.parallel.head_split`).  A
cell whose arguments the mesh does not divide (`steps.check_args`: a
vocabulary or experts that "model" does not divide, ...; the reference's
jit refuses the same, and no production cell is one) is written as a
``{"skipped": "<why>"}`` record, not dropped.  On fake
tensors a table's row gradient takes every occurrence as valid and
unique (`models.recsys.row_grad`), and `utils.top_k` skips its tie
repair: the common path's costs, without data-dependent sizes.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback

import torch

from ..configs.registry import all_cells, get_arch
from . import hlo_analysis

MESH_AXES = {2: ("data", "model"), 3: ("pod", "data", "model")}


def production_shape(multi_pod: bool) -> tuple:
    return (2, 16, 16) if multi_pod else (16, 16)


@contextlib.contextmanager
def fake_world(world_size: int):
    """Rank 0 of a fake process group of ``world_size`` ranks for the
    block, destroyed after it (the group is process-global)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is initialized already; the "
                           "dry run makes its own fake one")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _cpu_mesh(shape: tuple):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh("cpu", tuple(shape),
                            mesh_dim_names=MESH_AXES[len(shape)])


def _mesh_record(arch_id, shape_name, shape, multi_pod, tag) -> dict:
    return {"arch": arch_id, "shape": shape_name, "multi_pod": multi_pod,
            "mesh": tuple(int(s) for s in shape),
            "n_devices": int(math.prod(shape)), "tag": tag}


def _hardware() -> dict:
    return {"peak_flops_bf16": hlo_analysis.PEAK_FLOPS,
            "peak_flops_fp32": hlo_analysis.PEAK_FLOPS_FP32,
            "hbm_bw": hlo_analysis.HBM_BW, "ici_bw": hlo_analysis.ICI_BW,
            "source": "NVIDIA H100 SXM data sheet, 700 W"}


_WINDOW_FRACTIONS: dict = {}


def _window_fraction(sh: dict) -> float:
    """`snn_cell.measured_window_fraction` of a service shape on the CPU,
    measured once a process (it builds a 200,000-row index)."""
    from .snn_cell import measured_window_fraction

    key = (sh["d"], sh["radius"], sh.get("aniso_s"))
    if key not in _WINDOW_FRACTIONS:
        _WINDOW_FRACTIONS[key] = measured_window_fraction(
            sh["d"], sh["radius"], aniso_s=sh.get("aniso_s"), device="cpu")
    return _WINDOW_FRACTIONS[key]


def _write(rec: dict, out_dir: str | None, name: str) -> None:
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, name), "w") as f:
            json.dump(rec, f, indent=1)


def _trace_step(arch_id, shape_name, mesh, multi_pod, shape_override,
              cfg_override):
    """(step, `hlo_analysis.Trace`, seconds) of one cell's step."""
    from .steps import build_step

    t0 = time.time()
    step = build_step(arch_id, shape_name, multi_pod=multi_pod, mesh=mesh,
                      shape_override=shape_override,
                      cfg_override=cfg_override)
    trace = hlo_analysis.record_step(
        step.fn, lambda: step.init_args(device="cpu"))
    return step, trace, time.time() - t0


def _fit_lm_costs(arch_id, shape_name, mesh, multi_pod, shape_override,
                  cfg, cfg_override=None):
    """Per-step (flops, bytes, collectives, peak bytes) at the real depth,
    from traces at L = 2p and 3p layers (p the config's pattern period),
    extrapolated linearly: everything in a transformer step is affine in
    L from its second period on (a serving step's peak is not from its
    first: its last layer's transients come on top of the layers before
    it only once there are some).  The reference fits because XLA's cost
    analysis counts a loop body once; here it keeps a trace of a deep
    model's full depth, which takes a second a layer, out of every
    cell."""
    p = cfg.pattern_period
    vals = {}
    for mult in (2, 3):
        over = dict(cfg_override or {}, n_layers=p * mult)
        _, tr, _ = _trace_step(arch_id, shape_name, mesh, multi_pod,
                             shape_override, over)
        vals[mult] = {"flops": tr.flops, "bytes": tr.bytes_accessed,
                      "coll": hlo_analysis.collective_bytes(tr.collectives),
                      "peak": tr.peak_bytes}
    L = cfg.n_layers

    def extrap(a, b):
        per_layer = (b - a) / p
        return max(b + per_layer * (L - 3 * p), 0.0)

    flops = extrap(vals[2]["flops"], vals[3]["flops"])
    bts = extrap(vals[2]["bytes"], vals[3]["bytes"])
    peak = extrap(vals[2]["peak"], vals[3]["peak"])
    kinds = set(vals[2]["coll"]) | set(vals[3]["coll"])
    coll = {k: int(extrap(vals[2]["coll"].get(k, 0),
                          vals[3]["coll"].get(k, 0))) for k in kinds}
    return flops, bts, coll, peak


def run_snn_service(shape_name: str, *, multi_pod: bool = False,
                    out_dir: str | None = None, tag: str = "",
                    prune: bool = True, mesh_shape: tuple | None = None,
                    verbose: bool = True) -> dict:
    """Dry-run the paper's own workload, the sharded SNN count service, at
    the production mesh (`launch.snn_cell`).

    The trace runs the count's plain version on fake tensors (the kernel's
    product work, 2 m n_local d flops, is what it counts).  HBM bytes are
    set analytically, as the reference sets them: the stacked count kernel
    streams the rank's shard once for each 128-query tile and writes only
    counts.  The peak is the step's inputs and counts: the kernel holds no
    (m, n) intermediate, which its plain version would.  The window
    fraction is `snn_cell.measured_window_fraction` on the CPU, once a
    process.
    """
    from .snn_cell import build_service_step

    shape = tuple(mesh_shape or production_shape(multi_pod))
    n_dev = math.prod(shape)
    t0 = time.time()
    with fake_world(n_dev):
        mesh = _cpu_mesh(shape)
        fn, specs, model_flops, sh = build_service_step(
            shape_name, multi_pod=multi_pod, prune=prune, mesh=mesh)
        trace = hlo_analysis.record_step(
            fn, lambda: [torch.empty(s, dtype=dt) for s, dt in specs])
    n_local = specs[0][0][0]
    d_pad = sh["d"] + (-sh["d"]) % 128
    arg_bytes = sum(math.prod(s) * 4 for s, _ in specs)
    n_slabs = max(n_local // 65536, 1)
    trace.bytes_accessed = float((sh["m"] // 128) * n_local * (d_pad + 2) * 4
                                 + n_slabs * sh["m"] * 4)
    trace.peak_bytes = float(arg_bytes + (n_slabs + 1) * sh["m"] * 4)
    roof = hlo_analysis.analyze(trace, model_flops, n_dev,
                                peak_flops=hlo_analysis.PEAK_FLOPS_FP32)
    wf = _window_fraction(sh) if prune else 1.0
    rec = {**_mesh_record("snn-service", shape_name, shape, multi_pod, tag),
           "prune": prune, "window_fraction": wf,
           "trace_s": round(time.time() - t0, 2),
           "memory_analysis": {"argument_size_in_bytes": int(arg_bytes),
                               "temp_size_in_bytes": int(
                                   trace.peak_bytes - arg_bytes),
                               "output_size_in_bytes": int(sh["m"] * 4)},
           "hardware": _hardware(), **roof.to_dict()}
    # the count kernel skips every tile no query window of its tile meets
    rec["t_compute_pruned_s"] = roof.t_compute * wf
    rec["t_memory_pruned_s"] = roof.t_memory * wf
    if verbose:
        print(f"== snn-service:{shape_name} prune={prune} "
              f"mesh={rec['mesh']} ==")
        print(f"  window_fraction={wf:.4f}  t_compute="
              f"{roof.t_compute * 1e3:.2f}ms -> pruned "
              f"{rec['t_compute_pruned_s'] * 1e3:.2f}ms")
        print(f"  t_memory={roof.t_memory * 1e3:.2f}ms -> pruned "
              f"{rec['t_memory_pruned_s'] * 1e3:.2f}ms  t_coll="
              f"{roof.t_collective * 1e3:.3f}ms  bottleneck="
              f"{roof.bottleneck}")
    suffix = "multi" if multi_pod else "single"
    pname = "snn" if prune else "brute"
    _write(rec, out_dir, f"snn-service__{shape_name}__{suffix}__{pname}"
           f"{('__' + tag) if tag else ''}.json")
    return rec


def run_cell(arch_id: str, shape_name: str, *, multi_pod: bool = False,
             out_dir: str | None = None, verbose: bool = True,
             shape_override: dict | None = None, tag: str = "",
             mesh_shape: tuple | None = None, fit_lm: bool = True,
             cfg_override: dict | None = None) -> dict:
    """Dry-run one cell at ``mesh_shape`` (default: the production mesh)
    and return its record: the reference's keys, the H100's roofline
    terms, or ``{"skipped": ...}`` where the port does not run the step on
    a mesh.  ``cfg_override`` replaces fields of an LM's config (as
    `launch.steps.build_step`); LM cells are fitted from L = 2p and 3p
    (`_fit_lm_costs`) unless ``fit_lm=False``, which traces the whole
    depth."""
    if arch_id == "snn-service":
        return run_snn_service(shape_name, multi_pod=multi_pod,
                               out_dir=out_dir, tag=tag,
                               mesh_shape=mesh_shape, verbose=verbose)
    shape = tuple(mesh_shape or production_shape(multi_pod))
    n_dev = math.prod(shape)
    spec = get_arch(arch_id)
    suffix = "multi" if multi_pod else "single"
    name = f"{arch_id}__{shape_name}__{suffix}{('__' + tag) if tag else ''}"
    base = _mesh_record(arch_id, shape_name, shape, multi_pod, tag)
    with fake_world(n_dev):
        mesh = _cpu_mesh(shape)
        try:
            step, trace, t_trace = _trace_step(arch_id, shape_name, mesh,
                                             multi_pod, shape_override,
                                             cfg_override) \
                if not (spec.family == "lm" and fit_lm) else (None, None, 0)
            if step is None:
                from .steps import build_step
                step = build_step(arch_id, shape_name, multi_pod=multi_pod,
                                  mesh=mesh, shape_override=shape_override,
                                  cfg_override=cfg_override)
        except (NotImplementedError, ValueError) as e:
            rec = {**base, "skipped": str(e)}
            if verbose:
                print(f"-- SKIP {arch_id}:{shape_name} mesh={shape}: {e}")
            _write(rec, out_dir, name + ".json")
            return rec
        if trace is None:
            cfg = spec.make_config(shape_name, False)
            if cfg_override:
                cfg = dataclasses.replace(cfg, **cfg_override)
            t0 = time.time()
            flops, bts, coll, peak = _fit_lm_costs(
                arch_id, shape_name, mesh, multi_pod, shape_override, cfg,
                cfg_override)
            t_trace = time.time() - t0
            trace = hlo_analysis.Trace(flops, bts, [], peak)
            roof = hlo_analysis.analyze(trace, step.model_flops, n_dev)
            roof.coll_breakdown = coll
            roof.coll_bytes = float(sum(coll.values()))
        else:
            # the recsys and GAT steps compute in float32 (no TF32)
            roof = hlo_analysis.analyze(
                trace, step.model_flops, n_dev,
                peak_flops=hlo_analysis.PEAK_FLOPS_FP32
                if spec.family in ("recsys", "gnn") else
                hlo_analysis.PEAK_FLOPS)
    arg_bytes = _arg_bytes(step, mesh_shape=shape)
    rec = {**base, "step": step.name, "lower_s": 0.0,
           "compile_s": round(t_trace, 2),
           "memory_analysis": {
               "argument_size_in_bytes": int(arg_bytes),
               "output_size_in_bytes": 0,
               "temp_size_in_bytes": int(max(roof.peak_memory_bytes
                                             - arg_bytes, 0)),
               "alias_size_in_bytes": 0,
               "generated_code_size_in_bytes": 0},
           "hardware": _hardware(), **roof.to_dict()}
    if verbose:
        print(f"== {step.name} mesh={rec['mesh']} ==")
        print(f"  peak bytes a rank: {roof.peak_memory_bytes / 1e9:.3f} GB"
              f"  (fits 80 GB: {roof.peak_memory_bytes < 80e9})")
        print(f"  flops={roof.flops:.3e} bytes={roof.hbm_bytes:.3e}")
        print(f"  collectives: {roof.coll_breakdown}")
        print(f"  roofline: compute={roof.t_compute * 1e3:.2f}ms "
              f"memory={roof.t_memory * 1e3:.2f}ms "
              f"collective={roof.t_collective * 1e3:.2f}ms "
              f"-> bottleneck={roof.bottleneck}")
        print(f"  MODEL_FLOPS={step.model_flops:.3e} "
              f"useful_ratio={roof.useful_flops_ratio:.3f} "
              f"MFU@roofline={roof.mfu:.3f}")
    _write(rec, out_dir, name + ".json")
    return rec


def _arg_bytes(step, mesh_shape) -> int:
    """Bytes of one rank's step arguments: each `steps.ArgSpec` of
    ``arg_specs`` divided by the mesh axes its `Spec` names."""
    sizes = dict(zip(MESH_AXES[len(mesh_shape)], mesh_shape))

    def walk(a, sp):
        if hasattr(a, "shape") and hasattr(a, "dtype"):
            n = math.prod(a.shape) * torch.empty(
                (), dtype=a.dtype).element_size()
            for dim in range(len(a.shape)):
                n //= math.prod(sizes[x] for x in sp.axes(dim))
            return n
        if isinstance(a, dict):
            return sum(walk(a[k], sp[k]) for k in a)
        return sum(walk(x, y) for x, y in zip(a, sp))

    return walk(step.arg_specs, step.in_shardings)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--tag", default="")
    ap.add_argument("--no-fit", action="store_true",
                    help="trace the whole depth instead of L=2p and 3p")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--only-family", default=None)
    args = ap.parse_args(argv)

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    if not args.all:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        for mp in meshes:
            run_cell(args.arch, args.shape, multi_pod=mp, out_dir=args.out,
                     tag=args.tag, fit_lm=not args.no_fit)
        return
    failures = []
    for mp in meshes:
        suffix = "multi" if mp else "single"
        cells = [(a, s, skip) for a, s, skip in all_cells(
            include_skipped=True)] + [("snn-service", "svc_10m", None)]
        for arch_id, shape, skip in cells:
            if skip:
                print(f"-- SKIP {arch_id}:{shape}: {skip}")
                continue
            if args.only_family and (arch_id == "snn-service" or get_arch(
                    arch_id).family != args.only_family):
                continue
            name = f"{arch_id}__{shape}__{suffix}" + \
                (f"__{args.tag}" if args.tag else "") + ".json"
            if args.skip_existing and \
                    os.path.exists(os.path.join(args.out, name)):
                print(f"-- cached {arch_id}:{shape} ({suffix})")
                continue
            try:
                t = time.time()
                run_cell(arch_id, shape, multi_pod=mp, out_dir=args.out,
                         tag=args.tag, fit_lm=not args.no_fit)
                print(f"   [{time.time() - t:.0f}s]", flush=True)
            except Exception as e:  # noqa: BLE001
                traceback.print_exc()
                failures.append((arch_id, shape, mp, str(e)[:200]))
    if failures:
        print("FAILURES:")
        for f in failures:
            print("  ", f)
        raise SystemExit(1)
    print("ALL DRY-RUNS PASSED")


if __name__ == "__main__":
    main()
