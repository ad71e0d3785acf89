#!/usr/bin/env python3
"""Time the embedding bag's paths at the recsys ``serve_bulk`` lookups.

    python3 experiments/embedding_bag/run.py

Needs a CUDA card and the toolkit's nvcc.  Builds variants of the port's
``csrc/embedding_bag.cu``, each a copy with one constant rewritten (the
bag-of-one gather's ``kInFlight``: 1, 2, 4, 8 and 16 row loads in flight a
lane, the shipped source has 2; the staged path's ``kStagedBags``: 256,
128 and 64 bags a block, the shipped source has 32; ``kStagedSmemBytes``
= 0, which sends the wide bag to the one-thread-an-element kernel the
staged path replaced), and ``sector_floor.cu``, one nvcc each, all at
once, into the ignored ``src/repro_torch/kernels/_build``.  Makes each
``serve_bulk`` model on the card through
``launch.steps.build_step(...).init_args`` and takes its
lookups as ``chip_smoke.path_bags`` gives them (DLRM on the batch drawn
from each field's whole vocabulary, as ``chip_smoke.py`` does).  Every
variant's output must equal the shipped wrapper's bit for bit.  Times by
CUDA events, 5 calls a run, the variants timed in turns (each in a forward
and a backward pass over the list, the mean of the two):

- each bag-of-one lookup (DLRM, Wide & Deep's deep lookup, MIND) with each
  in-flight depth, in bag order and in the blocked order (the range list
  built in every call); the list alone (memset, histogram, scatter) and
  its kernels alone by torch.profiler; the gather over a list built once;
  the blocked order with ranges of 1/2 to 1/64 of the L2; the write floor,
  the bag-order gather with every id -1, which reads row 0 from L2 and
  writes the whole output; and three probes of what output rows written in
  random order and rows read from L2 cost;
- the wide bag (262,144 bags of 40 over the (4M, 1) table): the staged
  kernel with 256 to 32 bags a block, on all the bags and on the first 512
  (a ``serve_p99`` batch), the one-thread-an-element kernel it replaced,
  and the L2-sector floor of ``sector_floor.cu`` (the ids and one 4-byte
  read an id, no sums);
- bag order against the blocked order over (1M, 64) and (4M, 32) float32
  tables at 2 to 16 ids a row.

Prints each variant's registers and spills, the times, and the card's name
and power limit.
"""
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import snn_query as K  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import recsys as rs  # noqa: E402

IN_FLIGHT = "constexpr int kInFlight = 2;"
STAGED_BAGS = "constexpr int kStagedBags = 32;"
STAGED_SMEM = "constexpr int kStagedSmemBytes = 48 * 1024;"
# the gather's variants, row loads in flight a lane: {name: (line, new line)}
VARIANTS = {f"{r} in flight": (IN_FLIGHT, f"constexpr int kInFlight = {r};")
            for r in (1, 2, 4, 8, 16)}
SHIPPED = "2 in flight"
# the wide bag's: bags a staged block, and the kernel before the staged path
WIDE_VARIANTS = {
    **{f"staged, {t} bags a block": (STAGED_BAGS,
                                     f"constexpr int kStagedBags = {t};")
       for t in (256, 128, 64)},
    "one thread an element (the earlier kernel)": (
        STAGED_SMEM, "constexpr int kStagedSmemBytes = 0;")}
# ids a table row for the order sweep
RATIOS = (2, 4, 6, 8, 10, 13, 16)
REPS = 5


def build() -> tuple[dict, ctypes.CDLL]:
    """{variant: library} of `VARIANTS` and `WIDE_VARIANTS`, and the
    sector-floor library."""
    out = K.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    source = (K.SOURCE_DIR / "embedding_bag.cu").read_text()
    jobs = {}
    for i, (k, (line, new)) in enumerate({**VARIANTS,
                                          **WIDE_VARIANTS}.items()):
        if source.count(line) != 1:
            raise RuntimeError(f"embedding_bag.cu has no line {line!r}")
        src = out / f"embedding_bag_{i}.cu"
        src.write_text(source.replace(line, new))
        jobs[k] = (out / f"embedding_bag_{i}.so",
                   ["-I", str(K.SOURCE_DIR), str(src)])
    jobs["floor"] = (out / "sector_floor.so",
                     [str(Path(__file__).with_name("sector_floor.cu"))])
    procs = {k: subprocess.Popen([K._nvcc(), *K.NVCC_FLAGS, "-shared", "-o",
                                  str(path), *args], stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
             for k, (path, args) in jobs.items()}
    libs = {}
    for k, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {k}:\n{log}")
        for name, v in cs.ptxas_table(log, K._nvcc()).items():
            print(f"  [{k}] {name}: {v.get('registers')} registers, spills "
                  f"{v.get('spill_stores')} B / {v.get('spill_loads')} B")
        libs[k] = ctypes.CDLL(str(jobs[k][0]))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    floor = libs.pop("floor")
    for lib in libs.values():
        lib.embedding_bag.argtypes = [ptr] * 4 + [i32] * 3 + [i64, i32, ptr]
        lib.embedding_bag.restype = i32
        lib.embedding_bag_list.argtypes = [ptr, i32, i64, i32, i32, ptr, ptr,
                                           ptr]
        lib.embedding_bag_list.restype = i32
    floor.sector_floor.argtypes = [ptr, ptr, i64, i64, ptr, i32, ptr]
    floor.sector_floor.restype = i32
    return libs, floor


def check(rc, what):
    if rc:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def gather(lib, ids, table, out, pairs=None):
    """One call of a library's C embedding_bag, in the order of ``pairs``
    where given."""
    (B, F), (V, D) = ids.shape, table.shape
    check(lib.embedding_bag(
        ids.data_ptr(), None if pairs is None else pairs.data_ptr(),
        table.data_ptr(), out.data_ptr(), B, F, D, V,
        K._BAG_DTYPES[table.dtype], torch.cuda.current_stream().cuda_stream),
        "embedding_bag")


def range_list(lib, ids, V, rows, n_ranges, scratch, pairs):
    check(lib.embedding_bag_list(
        ids.data_ptr(), ids.shape[0], V, rows, n_ranges, scratch.data_ptr(),
        pairs.data_ptr(), torch.cuda.current_stream().cuda_stream),
        "embedding_bag_list")


def in_turns(fns: dict) -> dict:
    """{name: mean ms} over a forward and a backward pass of the list."""
    names = list(fns)
    times = {n: [] for n in names}
    for n in names + names[::-1]:
        times[n].append(cs.timed(torch, fns[n], REPS))
    return {n: sum(t) / len(t) for n, t in times.items()}


def list_kernels(lib, ids, V, rows, n_ranges, scratch, pairs) -> None:
    """The blocked order's list kernels, each alone on the card's clock
    (torch.profiler over 5 calls, after a first activity the profiler may
    drop)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
        for _ in range(5):
            range_list(lib, ids, V, rows, n_ranges, scratch, pairs)
        torch.cuda.synchronize()
    print("  the list's kernels alone: " + ", ".join(
        f"{e.key[:40]} {e.device_time_total / e.count / 1e3:.4f} ms"
        for e in prof.key_averages()
        if "range" in e.key or "Memset" in e.key))


def bag_of_one(libs, name, ids, table) -> None:
    (B, _), (V, D) = ids.shape, table.shape
    row = D * table.element_size()
    path = K.bag_path(ids, table)
    rows, n_ranges = K.bag_ranges(V, row, K.l2_bytes(table.device))
    bits = torch.int16 if table.element_size() == 2 else torch.int32
    want = K.embedding_bag(ids, table).view(bits)
    out = torch.empty((B, D), dtype=table.dtype, device=table.device)
    scratch = torch.empty(2 * n_ranges, dtype=torch.int32, device=ids.device)
    pairs = torch.empty((B, 2), dtype=torch.int32, device=ids.device)
    pad = torch.full_like(ids, -1)
    fns = {}
    for r in VARIANTS:
        lib = libs[r]

        def direct(lib=lib):
            gather(lib, ids, table, out)

        def blocked(lib=lib):
            range_list(lib, ids, V, rows, n_ranges, scratch, pairs)
            gather(lib, ids, table, out, pairs)

        for order, fn in (("bag order", direct), ("blocked", blocked)):
            out.zero_()
            fn()
            torch.cuda.synchronize()
            if not torch.equal(out.view(bits), want):
                raise RuntimeError(f"{name}: {r}, {order}: output "
                                   "differs from the wrapper's")
            fns[f"{order}, {r}"] = fn
    lib = libs[SHIPPED]
    fns["list alone (memset, histogram, scatter)"] = lambda: range_list(
        lib, ids, V, rows, n_ranges, scratch, pairs)
    for div in (2, 4, 8, 16, 32, 64):
        share = K.l2_bytes(table.device) * K.BAG_RANGE_L2_SHARE // div
        r2, n2 = K.bag_ranges(V, row, share)
        sc2 = torch.empty(2 * n2, dtype=torch.int32, device=ids.device)

        def smaller(r2=r2, n2=n2, sc2=sc2):
            range_list(lib, ids, V, r2, n2, sc2, pairs)
            gather(lib, ids, table, out, pairs)

        fns[f"blocked, ranges of 1/{div} of the L2 ({n2} ranges)"] = smaller
    range_list(lib, ids, V, rows, n_ranges, scratch, pairs)
    listed = pairs.clone()
    fns["blocked gather alone (the list built once)"] = lambda: gather(
        lib, ids, table, out, listed)
    fns["write floor (bag order, every id -1)"] = lambda: gather(
        lib, pad, table, out)
    # probes: what the output's scattered rows and reads from L2 cost
    g = torch.Generator(device=ids.device).manual_seed(cs.SEED + 40)
    perm = torch.randperm(B, generator=g, device=ids.device,
                          dtype=torch.int32)
    hot = torch.randint(0, max(1, 16 * 2 ** 20 // row), (B, 1), generator=g,
                        device=ids.device, dtype=torch.int32)
    scattered = torch.stack([perm, pad[:, 0]], 1)
    scattered_hot = torch.stack([perm, hot[:, 0]], 1)
    fns["probe: every id -1, rows written in random order"] = lambda: gather(
        lib, ids, table, out, scattered)
    fns["probe: rows of a 16 MB slice (L2), bag order"] = lambda: gather(
        lib, hot, table, out)
    fns["probe: rows of a 16 MB slice (L2), written in random order"] = (
        lambda: gather(lib, ids, table, out, scattered_hot))
    list_kernels(lib, ids, V, rows, n_ranges, scratch, pairs)
    nbytes = B * row
    print(f"{name}: {B} bags of one over ({V}, {D}) {str(table.dtype)[6:]}, "
          f"the wrapper's order {path['order']}; blocked: {n_ranges} ranges "
          f"of {rows} rows")
    for k, ms in in_turns(fns).items():
        print(f"  {k}: {ms:.4f} ms ({nbytes / ms / 1e9:.3f} TB/s of output)")


def wide_bag(libs, floor, ids, table) -> None:
    (B, F), (V, D) = ids.shape, table.shape
    want = K.embedding_bag(ids, table).view(torch.int32)
    out = torch.empty((B, D), dtype=table.dtype, device=table.device)
    wide = {"staged, 32 bags a block (shipped)": libs[SHIPPED],
            **{k: libs[k] for k in WIDE_VARIANTS}}
    for k, lib in wide.items():
        out.zero_()
        gather(lib, ids, table, out)
        torch.cuda.synchronize()
        if not torch.equal(out.view(torch.int32), want):
            raise RuntimeError(f"wide bag, {k}: output differs")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = 8 * sms
    sink = torch.empty(blocks * 256, dtype=torch.int32, device=ids.device)

    def sectors():
        check(floor.sector_floor(ids.data_ptr(), table.data_ptr(),
                                 ids.numel(), V, sink.data_ptr(), blocks,
                                 torch.cuda.current_stream().cuda_stream),
              "sector_floor")

    fns = {"L2-sector floor (ids + one 4-byte read an id, no sums)": sectors}
    few = ids[:512].contiguous()
    for k, lib in wide.items():
        fns[k] = lambda lib=lib: gather(lib, ids, table, out)
        fns[f"{k}, the first 512 bags"] = (
            lambda lib=lib: gather(lib, few, table, out))
    n = ids.numel()
    print(f"wide bag: {B} bags of {F} over ({V}, {D}) float32: {n} reads, "
          f"{32 * n / 1e9:.3f} GB of 32-byte sectors, {4 * n / 1e9:.3f} GB "
          "of ids")
    for k, ms in in_turns(fns).items():
        print(f"  {k}: {ms:.4f} ms")


def order_sweep(libs, V, D) -> None:
    """Bag order against the blocked order (the list built in every call)
    over a (V, D) float32 table of uniform rows, at RATIOS ids a row."""
    lib = libs[SHIPPED]
    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 41)
    table = torch.randn((V, D), generator=g, device="cuda")
    rows, n_ranges = K.bag_ranges(V, 4 * D, K.l2_bytes("cuda"))
    print(f"order sweep over ({V}, {D}) float32, {n_ranges} ranges of "
          f"{rows} rows:")
    for k in RATIOS:
        ids = torch.randint(0, V, (k * V, 1), generator=g, device="cuda",
                            dtype=torch.int32)
        path = K.bag_path(ids, table)
        out = torch.empty((k * V, D), device="cuda")
        scratch = torch.empty(2 * n_ranges, dtype=torch.int32, device="cuda")
        pairs = torch.empty((k * V, 2), dtype=torch.int32, device="cuda")

        def blocked():
            range_list(lib, ids, V, rows, n_ranges, scratch, pairs)
            gather(lib, ids, table, out, pairs)

        t = in_turns({"bag order": lambda: gather(lib, ids, table, out),
                      "blocked": blocked})
        print(f"  {k} ids a row ({k * V} bags): bag order "
              f"{t['bag order']:.4f} ms, blocked {t['blocked']:.4f} ms "
              f"({t['blocked'] / t['bag order']:.3f}); the rule says "
              f"{path['order']}")
        del ids, out, pairs
    del table
    torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("run.py: no CUDA device", file=sys.stderr)
        return 2
    libs, floor = build()
    print(f"L2: {K.l2_bytes('cuda')} bytes")
    for arch in ("dlrm-mlperf", "wide-deep", "mind"):
        sd = steps.build_step(arch, "serve_bulk")
        model, batch = sd.init_args("cuda")
        if arch == "dlrm-mlperf":
            batch = cs.full_vocab_batch(torch, model.cfg, batch, cs.SEED + 30)
        for name, ids, table in cs.path_bags(rs, arch, model, batch):
            ids = ids.contiguous()
            label = f"{arch} {name}"
            if ids.shape[1] == 1:
                bag_of_one(libs, label, ids, table)
            else:
                wide_bag(libs, floor, ids, table)
        del model, batch, ids, table
        torch.cuda.empty_cache()
    order_sweep(libs, 1_000_000, 64)
    order_sweep(libs, 4_000_000, 32)
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
