"""Serving launcher: stand up an SNNServer over a dataset and drive batched
radius queries through the dynamic batcher (the paper's end-to-end setting).

Usage (on the card; ``--device cpu`` runs the plain versions on the CPU):
  python -m repro_torch.launch.serve --n 20000 --d 16 --requests 500 --radius 0.6
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from ..configs.snn_default import SNNConfig
from ..data.pipeline import make_uniform
from ..serving.server import Request, SNNServer


def main(argv=None, device=None):
    """Run the launcher; ``device`` (default: the card) is the default of
    ``--device``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=20000)
    ap.add_argument("--d", type=int, default=16)
    ap.add_argument("--requests", type=int, default=500)
    ap.add_argument("--radius", type=float, default=0.6)
    ap.add_argument("--metric", default="euclidean")
    ap.add_argument("--device", default=device,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    data = make_uniform(args.n, args.d, seed=0)
    cfg = SNNConfig(metric=args.metric)
    t0 = time.time()
    server = SNNServer(data, cfg, device=args.device)
    print(f"indexed {args.n} x {args.d} on {server.device} in "
          f"{time.time()-t0:.3f}s")
    server.start()
    try:
        rng = np.random.default_rng(1)
        queries = rng.random((args.requests, args.d)).astype(np.float32)
        t0 = time.time()
        for i in range(args.requests):
            server.submit(Request(query=queries[i], radius=args.radius, id=i))
        lats, sizes = [], []
        for i in range(args.requests):
            r = server.result(i)
            if r.error is not None:
                raise RuntimeError(f"request {i}: {r.error}")
            lats.append(r.latency_ms)
            sizes.append(len(r.indices))
    finally:
        server.stop()
    wall = time.time() - t0
    lats = np.asarray(lats)
    print(f"{args.requests} requests in {wall:.3f}s "
          f"({args.requests/wall:.0f} qps)")
    print(f"latency ms: p50={np.percentile(lats,50):.2f} "
          f"p99={np.percentile(lats,99):.2f}")
    print(f"mean return size: {np.mean(sizes):.1f}")


if __name__ == "__main__":
    main()
