#!/usr/bin/env python3
"""Time the filter kernel's query orders at the point-query shape.

    python3 experiments/filter_variants/run.py

Needs a CUDA card and the toolkit's nvcc.  Builds the port's kernels (the
wrapper's build, into the ignored ``src/repro_torch/kernels/_build``), then
runs the filter at ``chip_smoke.py``'s point-query shape: the SIFT-1M
stand-in (1,000,000 x 128, seed 0) and 1024 queries at a radius of about
1,000 neighbours a query, over the whole index as one segment (m_pad 1024,
n_pad 1,000,448).  The C ``snn_filter`` is called with the queries tiled in
alpha order and in the given order; each must write the same bits as the
wrapper.  Times, by CUDA events over 10 calls, in turns (A, B, B, A):

- the queries tiled in alpha order against the given order;
- the wrapper (its argsort included) against the kernel with every query's
  radius and threshold set to -BIG, so that every tile is skipped and the
  kernel only writes +BIG: the output's write floor.

Prints the filter's registers and spills, the times, and the card's name
and power limit.
"""
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.core import engine, snn  # noqa: E402
from repro_torch.kernels import ops as ops_mod  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import snn_query as K  # noqa: E402


def turns(a, b, reps=10):
    """(ms of a, ms of b), each the mean of two runs of ``reps`` calls timed
    in the order a, b, b, a."""
    times = {a: [], b: []}
    for fn in (a, b, b, a):
        times[fn].append(cs.timed(torch, fn, reps))
    return [sum(times[f]) / 2 for f in (a, b)], times


def main() -> int:
    if not torch.cuda.is_available():
        print("run.py: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    lib = K._library()
    if not K.build_log():
        print("  library built by an earlier process: no ptxas report")
    for name, v in cs.ptxas_table(K.build_log(), K._nvcc()).items():
        if name.startswith("snn_filter"):
            print(f"  {name}: {v.get('registers')} registers, spills "
                  f"{v.get('spill_stores')} B / {v.get('spill_loads')} B")

    x = cs.sift_standin(cs.N_ROWS, cs.DIM, cs.SEED)
    q = cs.sift_standin(cs.N_QUERIES, cs.DIM, cs.SEED + 1)
    index = snn.build_index(x, device="cuda")
    del x
    radius = cs.calibrate_radius(torch, index, q)
    ops = cs.segment_operands(torch, ops_mod, snn, engine, index, q, radius,
                              0, index.n)[0]
    del index
    qd, aq, xs = ops[0], ops[1], ops[4]
    m_pad, n_pad, d_pad = qd.shape[0], xs.shape[0], xs.shape[1]
    ke = ops[7].shape[0]
    alpha = torch.argsort(aq, stable=True)
    given = torch.arange(m_pad, device="cuda")
    out = torch.empty((m_pad, n_pad), dtype=torch.float32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def variant(order, operands=ops):
        def call():
            rc = lib.snn_filter(
                *(t.data_ptr() for t in operands), m_pad, n_pad, d_pad, ke,
                512, order.data_ptr(), out.data_ptr(), stream)
            if rc:
                raise RuntimeError(f"CUDA error {rc}")
        return call

    alpha_order, given_order = variant(alpha), variant(given)
    want = K.snn_filter(*ops).view(torch.int32)
    for name, fn in (("alpha order", alpha_order),
                     ("given order", given_order)):
        fn()
        torch.cuda.synchronize()
        if not torch.equal(out.view(torch.int32), want):
            print(f"{name}: output differs from snn_filter's")
            return 1
    del want
    print(f"m_pad={m_pad} n_pad={n_pad} d_pad={d_pad} ke={ke}: every variant "
          "bit-equal to snn_filter")
    big = torch.full_like(aq, -ref.BIG)
    skipped = variant(alpha, (ops[0], aq, big, big, *ops[4:]))
    skipped()
    torch.cuda.synchronize()
    if not bool((out == ref.BIG).all()):
        print("every tile skipped: output not all +BIG")
        return 1
    (a, b), t = turns(alpha_order, given_order)
    print(f"alpha order {a:.4f} ms, given order {b:.4f} ms "
          f"(runs {t[alpha_order]}, {t[given_order]})")
    wrapper = lambda: K.snn_filter(*ops)  # noqa: E731
    (a, b), t = turns(wrapper, skipped)
    print(f"snn_filter (argsort included) {a:.4f} ms; every tile skipped, "
          f"{4 * m_pad * n_pad / 1e9:.3f} GB of +BIG written, {b:.4f} ms "
          f"({4 * m_pad * n_pad / b / 1e9:.1f} TB/s)")
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
