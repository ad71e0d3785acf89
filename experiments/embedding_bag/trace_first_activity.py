#!/usr/bin/env python3
"""Count how often torch.profiler loses the first device activity of a trace.

    python3 experiments/embedding_bag/trace_first_activity.py

Needs a CUDA card (and nvcc for the port's kernels).  Profiles one call of
each of three operations in 10 fresh ``torch.profiler`` sessions, the call
first in the session ("alone"), and in 10 more with a small kernel
(``torch.zeros(1)``) and a synchronize before it ("after a kernel"), and
counts the sessions whose trace holds the operation's kernels:

- the port's ``embedding_bag`` on 50,000 bags of one over a (100,000, 64)
  float32 table (a kernel launched through ctypes);
- the same on 50,000 bags of 40 over a (100,000, 1) table (the staged
  kernel);
- a PyTorch elementwise product of a 16 MB tensor;
- MIND's ``serve_bulk`` forward (its first kernel is its history gather),
  as ``chip_smoke.py`` profiles it, the first session right after the
  model is made on the card.

``chip_smoke.py::traced`` (behind ``device_ms`` and ``device_breakdown``)
runs the measured call first in the same trace for this reason.  Prints one line an operation (with the sessions, counted from 0,
whose trace lacked it) and the card's name and power limit.
"""
import sys
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import snn_query as K  # noqa: E402
from repro_torch.launch import steps  # noqa: E402

SESSIONS = 10


def kernels_seen(fn, names, warm: bool) -> bool:
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        if warm:
            torch.zeros(1, device="cuda")
            torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
    return any(e.device_type == torch.autograd.DeviceType.CUDA
               and any(n in e.name for n in names) for e in prof.events())


def report(name, fn, kernels) -> None:
    alone = [kernels_seen(fn, kernels, False) for _ in range(SESSIONS)]
    warm = [kernels_seen(fn, kernels, True) for _ in range(SESSIONS)]
    print(f"{name}: in the trace in {sum(alone)} of {SESSIONS} sessions "
          f"alone (missing in {[i for i, v in enumerate(alone) if not v]}), "
          f"{sum(warm)} of {SESSIONS} after a kernel (missing in "
          f"{[i for i, v in enumerate(warm) if not v]})")


def main() -> int:
    if not torch.cuda.is_available():
        print("trace_first_activity.py: no CUDA device", file=sys.stderr)
        return 2
    g = torch.Generator(device="cuda").manual_seed(cs.SEED)
    table = torch.randn((100_000, 64), generator=g, device="cuda")
    wide = torch.randn((100_000, 1), generator=g, device="cuda")
    ones = torch.randint(0, 100_000, (50_000, 1), generator=g,
                         device="cuda", dtype=torch.int32)
    many = torch.randint(0, 100_000, (50_000, 40), generator=g,
                         device="cuda", dtype=torch.int32)
    x = torch.randn(4 * 2 ** 20, generator=g, device="cuda")
    ops = {"embedding_bag, bags of one": (
               lambda: K.embedding_bag(ones, table), cs.BAG_KERNELS),
           "embedding_bag, the staged wide bag": (
               lambda: K.embedding_bag(many, wide), cs.BAG_KERNELS),
           "x * 2 (PyTorch)": (lambda: x * 2, ("elementwise",))}
    for name, (fn, kernels) in ops.items():
        fn()
        report(name, fn, kernels)
    del table, wide, ones, many, x
    sd = steps.build_step("mind", "serve_bulk")
    model, batch = sd.init_args("cuda")
    torch.cuda.synchronize()
    report("MIND serve_bulk forward, its history gather",
           lambda: sd.fn(model, batch), cs.BAG_KERNELS)
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
