#!/usr/bin/env python3
"""Time the variants of the count kernel's 128 x 128 float32 tile product.

    python3 experiments/tile_product/run.py

Needs a CUDA card and the toolkit's nvcc.  Builds ``tile_product.cu`` with
the flags of the port's kernels into the ignored
``src/repro_torch/kernels/_build``, then times each variant with CUDA
events on Gaussian data (d = 128) at three grids: 62,528 tiles (the
point-query count's grid, m = 1024 against 1,000,448 rows), 264 tiles (two
blocks an SM) and 132 (one).  Prints each variant's registers and spills
from ptxas, its microseconds and its FP32 rate, and the card's name and
power limit.
"""
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import snn_query as K  # noqa: E402

VARIANTS = (
    "cp.async 4 B, feature-major, 32 features, 2 stages",
    "cp.async 4 B, feature-major, 32 features, 3 stages",
    "cp.async 4 B, feature-major, 16 features, 3 stages",
    "cp.async 16 B, feature-contiguous rows, 32 features, 2 stages",
    "cp.async 16 B, feature-contiguous rows, 32 features, 3 stages",
    "registers, feature-major, 8 features, 2 blocks an SM",
    "registers, feature-major, 16 features, 2 blocks an SM (the kernels')",
    "registers, feature-major, 16 features, 1 block an SM",
    "registers, feature-major, 32 features, 1 block an SM",
)


def main() -> int:
    if not torch.cuda.is_available():
        print("run.py: no CUDA device", file=sys.stderr)
        return 2
    out_dir = K.BUILD_DIR
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / "tile_product_experiment.so"
    proc = subprocess.run(
        [K._nvcc(), *K.NVCC_FLAGS, "-shared", "-o", str(lib_path),
         str(Path(__file__).with_name("tile_product.cu"))],
        capture_output=True, text=True)
    if proc.returncode:
        print(proc.stdout + proc.stderr)
        return 1
    for line in (proc.stdout + proc.stderr).splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(" ", line.strip()[:150])
    lib = ctypes.CDLL(str(lib_path))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.tile_product.argtypes = [i32, ptr, ptr, i32, i32, ptr, i32, ptr]
    lib.tile_product.restype = i32
    d, n = 128, 1_000_448
    g = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn(1024, d, device="cuda", generator=g)
    x = torch.randn(n, d, device="cuda", generator=g)
    out = torch.zeros(1, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for blocks, m, reps in ((62528, 1024, 10), (264, 128, 200),
                            (132, 128, 200)):
        for v, name in enumerate(VARIANTS):
            def call():
                rc = lib.tile_product(v, q.data_ptr(), x.data_ptr(), m, d,
                                      out.data_ptr(), blocks, stream)
                if rc:
                    raise RuntimeError(f"variant {v}: CUDA error {rc}")
            call()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                call()
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end) / reps
            flops = 2.0 * d * 128 * 128 * blocks
            print(f"{blocks:6d} tiles  v{v} {name:68s} {1e3 * ms:10.2f} us "
                  f"{flops / ms / 1e9:6.2f} TFLOP/s", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
