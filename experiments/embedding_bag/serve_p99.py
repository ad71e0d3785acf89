#!/usr/bin/env python3
"""Time the recsys ``serve_p99`` lookups through two checkouts' wrappers.

    python3 experiments/embedding_bag/serve_p99.py OTHER_ROOT

``OTHER_ROOT`` is the root of another checkout, such as the parent commit
unpacked with ``git archive`` into an ignored directory.  Its
``src/repro_torch`` is loaded beside this checkout's as the package
``other_repro_torch``, and each builds its own kernels (needs a CUDA card
and the toolkit's nvcc).  The lookups are those of the ``serve_p99`` steps
and of MIND's ``retrieval_cand``, as ``chip_smoke.path_bags`` gives them
from this checkout's models made on the card.  At these sizes (50 to
25,600 bags) a call costs the host's time in the Python wrapper more than
the card's, and the host's pace drifts within a run, so the two wrappers
(``kernels.snn_query.embedding_bag`` of each) are timed in 21 alternating
rounds of 50 calls, by CUDA events, after a warm-up; both outputs must be
bit-equal.  Each round also times the same 50 calls on the host's clock
alone (``time.perf_counter`` around the calls, no synchronize inside: the
host's time in the wrapper until the launch returns), and one
``torch.profiler`` session a wrapper and lookup sums the card's time of
the calls' kernels.  Prints one JSON line ``{lookup: {"this": ms, "other":
ms, "this_quartiles": [ms, ms], "other_quartiles": [ms, ms],
"this_faster_rounds": n, "this_host_us": us, "other_host_us": us,
"this_host_faster_rounds": n, "this_card_us": us, "other_card_us": us}}``
(the median ms a call by CUDA events, the first and third quartiles of the
rounds, the rounds of 21 in which this checkout's wrapper was the faster;
the median host microseconds a call and the rounds in which this
checkout's was the faster on the host; the card's microseconds a call)
and the card's name and power limit.
"""
import importlib
import importlib.util
import json
import statistics
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import snn_query as K  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import recsys as rs  # noqa: E402

ROUNDS, CALLS = 21, 50


def host_us(fn) -> float:
    """Microseconds a call on the host's clock, over CALLS calls launched
    back to back (the card keeps up: each call is a few microseconds of
    kernel)."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(CALLS):
        fn()
    us = 1e6 * (time.perf_counter() - t) / CALLS
    torch.cuda.synchronize()
    return us


def card_us(fn) -> float:
    """Microseconds of card time a call: the device activity of CALLS calls
    in one torch.profiler session, summed (after a first small kernel,
    which the profiler may drop and which is not counted)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
    total = sum(e.device_time_total for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and "FillFunctor" not in e.name)
    return total / CALLS


def load_other(root: Path):
    """The other checkout's ``kernels.snn_query``, its package loaded as
    ``other_repro_torch``."""
    pkg = root / "src" / "repro_torch"
    spec = importlib.util.spec_from_file_location(
        "other_repro_torch", pkg / "__init__.py",
        submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["other_repro_torch"] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module("other_repro_torch.kernels.snn_query")


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("serve_p99.py: no CUDA device", file=sys.stderr)
        return 2
    other = load_other(Path(sys.argv[1]).resolve())
    K.build()
    other.build()
    times = {}
    for arch, shape in (("dlrm-mlperf", "serve_p99"),
                        ("wide-deep", "serve_p99"), ("mind", "serve_p99"),
                        ("mind", "retrieval_cand")):
        sd = steps.build_step(arch, shape)
        model, batch = sd.init_args("cuda")
        for name, ids, table in cs.path_bags(rs, arch, model, batch):
            ids = ids.contiguous()
            fns = {"this": lambda: K.embedding_bag(ids, table),
                   "other": lambda: other.embedding_bag(ids, table)}
            bits = torch.int16 if table.element_size() == 2 else torch.int32
            if not torch.equal(fns["this"]().view(bits),
                               fns["other"]().view(bits)):
                print(f"{sd.name} {name}: the outputs differ",
                      file=sys.stderr)
                return 1
            runs = {k: [] for k in fns}
            host = {k: [] for k in fns}
            for r in range(ROUNDS):
                for k in (("this", "other") if r % 2 else ("other", "this")):
                    runs[k].append(cs.timed(torch, fns[k], CALLS, 5))
                    host[k].append(host_us(fns[k]))
            rec = {k: statistics.median(v) for k, v in runs.items()}
            for k, v in runs.items():
                q = statistics.quantiles(v, n=4)
                rec[f"{k}_quartiles"] = [q[0], q[2]]
            rec["this_faster_rounds"] = sum(
                a < b for a, b in zip(runs["this"], runs["other"]))
            for k, v in host.items():
                rec[f"{k}_host_us"] = statistics.median(v)
            rec["this_host_faster_rounds"] = sum(
                a < b for a, b in zip(host["this"], host["other"]))
            for k, fn in fns.items():
                rec[f"{k}_card_us"] = card_us(fn)
            times[f"{sd.name} {name}"] = rec
        del model, batch, ids, table
        torch.cuda.empty_cache()
    print(json.dumps(times))
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
