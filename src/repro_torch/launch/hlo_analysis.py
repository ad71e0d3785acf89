"""Roofline terms of a traced step, for the H100.

The counterpart of ``repro.launch.hlo_analysis``.  The reference reads its
terms from a compiled XLA artifact: compute and memory from
``compiled.cost_analysis()``, the collective bytes from the optimized HLO
text.  Torch has no HLO.  Here a step runs once on fake tensors
(``FakeTensorMode``: shapes and dtypes, no storage, no arithmetic) under a
fake process group, and `record_step` reads instead:

* **flops**: ``torch.utils.flop_counter.FlopCounterMode``'s count of the
  matrix products, attention and convolutions (elementwise ops count 0,
  which XLA's cost analysis counts: a few percent of a transformer step);
* **bytes accessed**: the sum over every op that writes a tensor, views
  aside, of its input and output bytes (a sparse row gradient's: its ids
  and rows; each op reads its inputs and writes its outputs once:
  the port's unfused eager step, an upper bound of what a fused program
  moves);
* **collectives**: one `CollectiveRecord` a c10d collective (its kind, the
  bytes of its result, its group's size), which `collective_bytes` turns
  into the reference's operand bytes;
* **peak bytes**: ``torch.distributed._tools.mem_tracker.MemTracker``'s
  peak of the bytes the rank holds over the trace, its inputs included.

Hardware model: an H100 SXM at its 700 W limit, from NVIDIA's H100 data
sheet (dense peaks, without sparsity): 989 TFLOP/s bfloat16 on the tensor
cores, 67 TFLOP/s float32 (no TF32), 3.35 TB/s of HBM3, and NVLink 4 at
900 GB/s both directions together, 450 GB/s each way, in the place of the
reference's ICI link.
"""
from __future__ import annotations

import dataclasses

import torch

PEAK_FLOPS = 989e12          # bfloat16 dense, tensor cores
PEAK_FLOPS_FP32 = 67e12      # float32 (no TF32), for the float32 cells
HBM_BW = 3.35e12
ICI_BW = 450e9               # NVLink 4, one direction


@dataclasses.dataclass(frozen=True)
class CollectiveRecord:
    """One traced collective: its kind (the reference's names:
    "all-gather", "reduce-scatter", "all-reduce", "all-to-all",
    "collective-permute"), the bytes of its result on this rank, and the
    size of its group."""

    kind: str
    result_bytes: int
    group_size: int


def collective_bytes(records) -> dict[str, int]:
    """Per-device *operand* bytes per collective kind.

    The reference's convention, from the op semantics: an all-gather's
    operand is its result / G, a reduce-scatter's its result x G, any other
    kind's operand is its result (G = the group's size).
    """
    out: dict[str, int] = {}
    for rec in records:
        rb, g = int(rec.result_bytes), max(int(rec.group_size), 1)
        if rec.kind == "all-gather":
            b = rb // g
        elif rec.kind == "reduce-scatter":
            b = rb * g
        else:
            b = rb
        out[rec.kind] = out.get(rec.kind, 0) + b
    return out


@dataclasses.dataclass
class Roofline:
    flops: float                # per-device traced flops
    hbm_bytes: float            # per-device bytes accessed
    coll_bytes: float           # per-device collective operand bytes
    coll_breakdown: dict
    n_devices: int
    model_flops: float          # analytic useful flops (GLOBAL)
    peak_memory_bytes: float = 0.0
    peak_flops: float = PEAK_FLOPS   # the compute term's peak rate

    @property
    def t_compute(self) -> float:
        return self.flops / self.peak_flops

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / ICI_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def step_time(self) -> float:
        """Roofline step-time estimate: max of the three overlapping engines."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        total = self.flops * self.n_devices
        return self.model_flops / total if total else 0.0

    @property
    def mfu(self) -> float:
        """Model-flops utilization at the roofline step time."""
        denom = self.step_time * self.n_devices * self.peak_flops
        return self.model_flops / denom if denom else 0.0

    def to_dict(self) -> dict:
        return {
            "flops_per_device": self.flops,
            "hbm_bytes_per_device": self.hbm_bytes,
            "collective_bytes_per_device": self.coll_bytes,
            "collective_breakdown": self.coll_breakdown,
            "n_devices": self.n_devices,
            "model_flops_global": self.model_flops,
            "peak_memory_bytes": self.peak_memory_bytes,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "roofline_step_time_s": self.step_time,
            "useful_flops_ratio": self.useful_flops_ratio,
            "mfu_at_roofline": self.mfu,
        }


@dataclasses.dataclass
class Trace:
    """What `record_step` read from one traced step on one rank."""

    flops: float
    bytes_accessed: float
    collectives: list
    peak_bytes: float


def _parts(t: torch.Tensor) -> tuple:
    """The dense tensors holding ``t``: a sparse COO tensor's (a table's
    row gradient, `models.recsys.row_grad`) ids and rows."""
    if t.layout == torch.sparse_coo:
        return t._indices(), t._values()
    return (t,)


def _tensor_bytes(tree) -> int:
    from torch.utils._pytree import tree_leaves

    return sum(p.numel() * p.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor) for p in _parts(t))


def _mem_tracker():
    """``MemTracker``, which counts a sparse tensor by its ids and rows (it
    reads a tensor's storage, which a sparse one has not)."""
    from torch.distributed._tools.mem_tracker import MemTracker

    class Tracker(MemTracker):
        def _track(self, reftype, t):
            for p in _parts(t):
                super()._track(reftype, p)

        def _update_and_maybe_create_winfos(self, t, reftype,
                                            update_existing=False):
            out = set()
            for p in _parts(t):
                out |= super()._update_and_maybe_create_winfos(
                    p, reftype, update_existing)
            return out

    return Tracker()


def _collective_kinds() -> dict:
    c10d = torch.ops.c10d
    return {
        c10d.allreduce_.default: "all-reduce",
        c10d._allgather_base_.default: "all-gather",
        c10d.allgather_.default: "all-gather",
        c10d._reduce_scatter_base_.default: "reduce-scatter",
        c10d.reduce_scatter_.default: "reduce-scatter",
        c10d.alltoall_.default: "all-to-all",
        c10d.alltoall_base_.default: "all-to-all",
        c10d.send.default: "collective-permute",
    }


def _recorder():
    """A dispatch mode that sums every op's input and output bytes and
    records every collective (made here: the mode's base class is
    imported only when a step is traced)."""
    from torch.distributed._tools.fake_collectives import CollectiveOp
    from torch.utils._python_dispatch import TorchDispatchMode

    kinds = _collective_kinds()
    # the result of these is their first argument (written in place)
    result_arg0 = {torch.ops.c10d.allreduce_.default,
                   torch.ops.c10d._allgather_base_.default,
                   torch.ops.c10d.allgather_.default,
                   torch.ops.c10d._reduce_scatter_base_.default,
                   torch.ops.c10d.reduce_scatter_.default,
                   torch.ops.c10d.alltoall_.default,
                   torch.ops.c10d.alltoall_base_.default,
                   torch.ops.c10d.send.default}

    class Recorder(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.bytes = 0
            self.collectives: list[CollectiveRecord] = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            kind = kinds.get(func)
            if kind is not None:
                pg = CollectiveOp.get_process_group(func, args)
                res = args[0] if func in result_arg0 else out
                self.collectives.append(
                    CollectiveRecord(kind, _tensor_bytes(res), pg.size()))
            elif not func.is_view:    # a view moves no bytes
                written = _tensor_bytes(out)
                if written:           # an op without a tensor out (a
                    # device or size query) moves none either
                    self.bytes += _tensor_bytes(args) + _tensor_bytes(
                        kwargs or {}) + written
            return out

    return Recorder()


def record_step(fn, make_args) -> Trace:
    """Trace ``fn(*make_args())`` once on fake tensors and read its terms.

    ``make_args`` is called under the ``FakeTensorMode`` (so a step's own
    ``init_args(device="cpu")`` makes fake parameters, optimizer state and
    batch, none of them allocated); the collectives go to whatever process
    group is initialized, a fake one for a dry run.
    """
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils._pytree import tree_leaves
    from torch.utils.flop_counter import FlopCounterMode

    with FakeTensorMode(allow_non_fake_inputs=True):
        args = make_args()
        mt = _mem_tracker()
        mt.track_external(*[t for t in tree_leaves(args)
                            if isinstance(t, torch.Tensor)])
        counter = FlopCounterMode(display=False)
        rec = _recorder()
        with mt, counter, rec:
            fn(*args)
        peak = mt.get_tracker_snapshot("peak")
    peak_bytes = max((v.get("Total", 0) for v in peak.values()), default=0)
    return Trace(float(counter.get_total_flops()), float(rec.bytes),
                 list(rec.collectives), float(peak_bytes))


def analyze(trace: Trace, model_flops: float, n_devices: int, *,
            peak_flops: float = PEAK_FLOPS) -> Roofline:
    """The `Roofline` of one rank's `Trace` (``peak_flops``: the compute
    term's rate, `PEAK_FLOPS_FP32` for a float32 step)."""
    coll = collective_bytes(trace.collectives)
    return Roofline(flops=trace.flops, hbm_bytes=trace.bytes_accessed,
                    coll_bytes=float(sum(coll.values())),
                    coll_breakdown=coll, n_devices=n_devices,
                    model_flops=model_flops,
                    peak_memory_bytes=trace.peak_bytes,
                    peak_flops=peak_flops)
