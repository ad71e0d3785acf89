"""The port's kernels for the H100, with their plain versions.

* snn_query — the hand-written CUDA kernels (csrc/: the query hot loop's
              count, compact and filter, and the recsys embedding bag) and
              their ctypes wrappers; built with nvcc at first use
* ref       — plain PyTorch versions of the kernels and the shared formulas
* ops       — the padding contract and the CSR capacity ladder
* registry  — dispatch: CUDA tensors to the kernels, CPU tensors to ref
"""
from . import ops, ref, registry, snn_query  # noqa: F401
