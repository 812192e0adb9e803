"""Per-kernel, per-device cost reports — the "Vivado HLS report" analogue.

The paper feeds its simulator with *cheap, static* reports obtained in
seconds: HLS gives estimated compute cycles + input/output transfer cycles
(+ resource usage) per kernel, the instrumented sequential run gives the SMP
cost.  We provide three providers with the same output type:

* :class:`HLSSynthesisModel` — an analytic Zynq-like model (pipeline-II
  compute cycles, AXI-DMA transfer cycles, DSP/BRAM/LUT usage) calibrated so
  the paper's feasibility statements hold (two 128×128 mxm accelerators do
  NOT fit the fabric; two 64×64 ones do; one "full-resource" Cholesky kernel
  excludes everything else; any two reduced Cholesky kernels fit).
* :class:`TorchCostModel` — runs a PyTorch function on ``meta`` tensors
  (nothing is computed or allocated) and converts its counted FLOPs and
  bytes into seconds with the card's constants (:data:`H100_SXM`).  This
  is the pod-scale "HLS report": static, pre-execution, obtained in
  seconds instead of a full-scale run.
* measured SMP costs come from ``Trace.mean_smp_cost()`` (see trace.py).
"""
from __future__ import annotations

import dataclasses
import math
from collections import Counter
from typing import Any, Callable, Dict, Mapping, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class KernelReport:
    """Static cost/resource report of one kernel on one device kind."""

    kernel: str
    device_kind: str
    compute_s: float
    dma_in_s: float = 0.0
    dma_out_s: float = 0.0
    resources: Mapping[str, float] = dataclasses.field(default_factory=dict)
    clock_hz: float = 0.0
    meta: Mapping[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def folded_cost(self) -> float:
        """Accelerator occupancy when input transfers are folded (Fig. 3)."""
        return self.dma_in_s + self.compute_s


ReportKey = Tuple[str, str]  # (kernel name, device kind)
ReportMap = Dict[ReportKey, KernelReport]


# --------------------------------------------------------------------------
# Zynq-7045-like fabric budget and analytic synthesis model
# --------------------------------------------------------------------------

ZYNQ_7045_BUDGET: Dict[str, float] = {
    "dsp": 900.0,          # DSP48E1 slices
    "bram_kb": 2452.0,     # 545 × 36Kb blocks
    "lut": 218600.0,
}


@dataclasses.dataclass(frozen=True)
class HLSSynthesisModel:
    """Analytic Vivado-HLS-like estimates for dense linear-algebra tiles.

    Model: the inner loop is pipelined at II=1 with ``unroll`` parallel MAC
    lanes → compute cycles ≈ MACs/unroll + ramp.  AXI DMA moves
    ``bus_bytes_per_cycle`` per fabric cycle.  Resource usage grows linearly
    in the MAC lanes (float ≈ 5 DSP/lane, double ≈ 14 DSP/lane) and local
    buffers occupy BRAM.
    """

    clock_hz: float = 100e6
    bus_bytes_per_cycle: float = 8.0
    pipeline_ramp: float = 120.0
    dsp_per_lane: Mapping[str, float] = dataclasses.field(
        default_factory=lambda: {"float32": 5.0, "float64": 14.0})
    lut_per_lane: float = 800.0
    lut_base: float = 4500.0

    def report(self, kernel: str, device_kind: str, *, macs: float,
               in_bytes: float, out_bytes: float, buffer_bytes: float,
               dtype: str = "float32", unroll: int = 16) -> KernelReport:
        cycles = macs / max(unroll, 1) + self.pipeline_ramp
        dsp = self.dsp_per_lane.get(dtype, 5.0) * unroll
        lut = self.lut_base + self.lut_per_lane * unroll
        bram_kb = buffer_bytes / 1024.0
        return KernelReport(
            kernel=kernel, device_kind=device_kind,
            compute_s=cycles / self.clock_hz,
            dma_in_s=(in_bytes / self.bus_bytes_per_cycle) / self.clock_hz,
            dma_out_s=(out_bytes / self.bus_bytes_per_cycle) / self.clock_hz,
            resources={"dsp": dsp, "bram_kb": bram_kb, "lut": lut},
            clock_hz=self.clock_hz,
            meta={"macs": macs, "unroll": unroll, "dtype": dtype})

    # ---------------------------------------------------------------- tiles
    def matmul_block(self, bs: int, dtype: str = "float32",
                     unroll: Optional[int] = None,
                     kind: Optional[str] = None) -> KernelReport:
        """C[bs,bs] += A[bs,bs] @ B[bs,bs] — the paper's ``mxmBlock``."""
        itemsize = 8 if dtype == "float64" else 4
        unroll = unroll if unroll is not None else bs  # j-loop fully unrolled
        return self.report(
            f"mxm_block{bs}", kind_default(kind, f"fpga:mxm{bs}"),
            macs=float(bs) ** 3,
            in_bytes=3 * bs * bs * itemsize,      # A, B and C (inout) stream in
            out_bytes=bs * bs * itemsize,
            buffer_bytes=3 * bs * bs * itemsize,
            dtype=dtype, unroll=unroll)

    def cholesky_tile(self, op: str, bs: int, *, full_resources: bool = False,
                      dtype: str = "float64",
                      kind: Optional[str] = None) -> KernelReport:
        """dgemm / dsyrk / dtrsm tile kernels of the Fig. 4 Cholesky.

        ``full_resources`` doubles the MAC lanes — the paper's "FR" variants
        that maximise fabric usage and therefore exclude other accelerators.
        """
        itemsize = 8 if dtype == "float64" else 4
        macs = {
            "dgemm": float(bs) ** 3,
            "dsyrk": float(bs) ** 3 / 2.0 + bs * bs / 2.0,
            "dtrsm": float(bs) ** 3 / 2.0 + bs * bs / 2.0,
        }[op]
        n_in = {"dgemm": 3, "dsyrk": 2, "dtrsm": 2}[op]
        # FR ("full resources") maximises fabric usage: ~784/900 DSPs at 14
        # DSP per f64 MAC lane, leaving no room for a second accelerator.
        unroll = (56 if full_resources else 16)
        suffix = "FR" if full_resources else f"{bs}"
        return self.report(
            f"{op}", kind_default(kind, f"fpga:{op}{suffix}"),
            macs=macs,
            in_bytes=n_in * bs * bs * itemsize,
            out_bytes=bs * bs * itemsize,
            buffer_bytes=n_in * bs * bs * itemsize,
            dtype=dtype, unroll=unroll)


def kind_default(kind: Optional[str], default: str) -> str:
    return kind if kind is not None else default


def _report_with_kernel_name(report: KernelReport, kernel: str) -> KernelReport:
    return dataclasses.replace(report, kernel=kernel)


def fits(reports_and_counts: Mapping[KernelReport, int] | list,
         budget: Mapping[str, float] = ZYNQ_7045_BUDGET) -> bool:
    """Feasibility check: Σ resource usage ≤ fabric budget.

    Accepts either a mapping report→count or a list of (report, count).
    Reproduces e.g. "two 128×128 mxm accelerators do not fit".
    """
    items = reports_and_counts.items() if hasattr(reports_and_counts, "items") \
        else reports_and_counts
    usage: Dict[str, float] = {}
    for rep, count in items:
        for res, amount in rep.resources.items():
            usage[res] = usage.get(res, 0.0) + amount * count
    return all(usage.get(res, 0.0) <= cap for res, cap in budget.items())


# --------------------------------------------------------------------------
# H100 constants + meta-tensor cost reports (pod-scale "HLS")
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GPUConstants:
    """Per-card peak numbers used by every cost conversion."""

    # NVIDIA H100 Tensor Core GPU datasheet, SXM5 column, dense (without
    # sparsity): bf16 on the tensor cores, f32 on the CUDA cores (a
    # full-precision f32 product cannot use the TF32 tensor cores)
    peak_flops: float = 989e12
    peak_flops_f32: float = 67e12
    hbm_bw: float = 3.35e12             # bytes/s, HBM3 (same datasheet)
    hbm_bytes: float = 80e9             # (same datasheet)
    # NVLink 4 (same datasheet): 900 GB/s per GPU, both directions
    # together; this field holds one direction, 450 GB/s
    link_bw: float = 450e9
    # between nodes: one 400 Gb/s NDR InfiniBand port per GPU (ConnectX-7,
    # NVIDIA DGX H100 user guide, networking), 50 GB/s each way
    internode_bw: float = 50e9
    # sustained fraction of the peak on large matmuls: a bf16 and an f32
    # torch.matmul at 8192^3 (TF32 off), timed by chip_smoke.py's
    # [cost model] phase on an H100 80GB HBM3 at 700 W: 0.7797 and 0.7699
    # (the TPU record's 0.8 was an assumption; these are measured)
    matmul_efficiency: float = 0.78
    matmul_efficiency_f32: float = 0.77
    name: str = "h100_sxm"

    def peak(self, dtype: str) -> float:
        """The peak rate of a product whose operands are ``dtype``: f32 on
        the CUDA cores, any other (half-width) type on the tensor cores at
        the bf16 rate."""
        return self.peak_flops_f32 if dtype == "float32" else self.peak_flops

    def efficiency(self, dtype: str) -> float:
        return (self.matmul_efficiency_f32 if dtype == "float32"
                else self.matmul_efficiency)

    def flops_seconds(self, flops_by_dtype: Mapping[str, float]) -> float:
        """Seconds of the products at each operand type's sustained
        rate."""
        return sum(f / (self.peak(dt) * self.efficiency(dt))
                   for dt, f in flops_by_dtype.items())


H100_SXM = GPUConstants()

#: The aten ops counted as transcendental: one per output element.
TRANSCENDENTAL_OPS = frozenset((
    "exp", "exp2", "expm1", "log", "log2", "log1p", "tanh", "sigmoid",
    "erf", "erfinv", "rsqrt", "sqrt", "sin", "cos", "silu", "gelu",
    "_softmax", "_log_softmax"))

#: Ops that move no data: bare allocations, and views that aten does not
#: mark as views (``_unsafe_view`` ends a copying ``reshape``).
_MOVE_NOTHING = frozenset(("empty", "empty_strided", "empty_like",
                           "new_empty", "new_empty_strided", "_unsafe_view",
                           "lift_fresh"))


def _tensors(tree):
    if isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors(x)
    elif hasattr(tree, "numel") and hasattr(tree, "element_size"):
        yield tree


def _counting_mode():
    """A ``TorchDispatchMode`` (built on first use, so that importing this
    module imports no torch) that adds up, per aten op: the bytes of its
    tensor inputs and outputs (views and bare allocations move none), the
    output elements of :data:`TRANSCENDENTAL_OPS`, and the FLOPs of
    ``torch.utils.flop_counter``'s formulas by the first operand's type.
    Any op whose output is not on ``meta`` raises: the count never
    runs anything."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    class Counting(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.bytes = 0
            self.transcendentals = 0
            self.flops_by_dtype: Counter = Counter()
            self.ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            outs = list(_tensors(out))
            for t in outs:
                if t.device.type != "meta":
                    raise ValueError(f"TorchCostModel counts on meta tensors;"
                                     f" {func} made a tensor on {t.device}")
            self.ops += 1
            name = func.overloadpacket.__name__
            if not func.is_view and name not in _MOVE_NOTHING:
                ins = list(_tensors((args, kwargs)))
                self.bytes += sum(t.numel() * t.element_size()
                                  for t in ins + outs)
            if name in TRANSCENDENTAL_OPS:
                self.transcendentals += sum(t.numel() for t in outs)
            count = flop_registry.get(func.overloadpacket)
            if count is not None:
                first = next(_tensors((args, kwargs)))
                dtype = str(first.dtype).replace("torch.", "")
                self.flops_by_dtype[dtype] += count(*args, **kwargs,
                                                    out_val=out)
            return out

    return Counting()


class TorchCostModel:
    """Static per-function cost reports from a run on ``meta`` tensors.

    The counterpart of the JAX package's ``XLACostModel``, whose
    ``.lower().compile()`` yields FLOPs and bytes without running or
    allocating: here the function runs on ``meta`` tensors (a model built
    with ``device="meta"``, meta inputs), where every op computes its
    output's shape only.  FLOPs come from
    ``torch.utils.flop_counter.FlopCounterMode`` (products only: matmuls,
    convolutions, attention), split by operand type with the same
    formulas; bytes are each aten op's tensor inputs and outputs added
    up, an unfused upper bound like XLA-CPU's ``bytes accessed`` (a fused
    kernel reads and writes its intermediates in registers, not in HBM);
    transcendentals are the output elements of
    :data:`TRANSCENDENTAL_OPS`.  The port's attention and linear-attention
    routes run their plain versions on meta, so attention counts a full
    ``T x S`` rectangle of scores where the flash kernel skips the masked
    tiles.
    """

    def __init__(self, constants: GPUConstants = H100_SXM):
        self.constants = constants

    def analyze(self, fn: Callable[..., Any], *args: Any,
                **kwargs: Any) -> Dict[str, Any]:
        """``{"flops", "bytes", "transcendentals", "flops_by_dtype",
        "ops"}`` of ``fn(*args, **kwargs)`` on meta tensors."""
        from torch.utils.flop_counter import FlopCounterMode
        counting = _counting_mode()
        with FlopCounterMode(display=False) as flops, counting:
            fn(*args, **kwargs)
        return {"flops": float(flops.get_total_flops()),
                "bytes": float(counting.bytes),
                "transcendentals": float(counting.transcendentals),
                "flops_by_dtype": {k: float(v) for k, v
                                   in counting.flops_by_dtype.items()},
                "ops": counting.ops}

    def seconds(self, a: Mapping[str, Any]) -> float:
        """The reference's ``max(flops / (peak · eff), bytes / hbm)``, the
        FLOP term summed over the operand types at each one's rate (the
        card's f32 peak is 1/15 of its bf16 one)."""
        c = self.constants
        return max(c.flops_seconds(a["flops_by_dtype"]),
                   a["bytes"] / c.hbm_bw)

    def report(self, kernel: str, fn: Callable[..., Any], *args: Any,
               device_kind: str = "gpu", in_bytes: float = 0.0,
               out_bytes: float = 0.0, **kwargs: Any) -> KernelReport:
        a = self.analyze(fn, *args, **kwargs)
        c = self.constants
        return KernelReport(
            kernel=kernel, device_kind=device_kind,
            compute_s=self.seconds(a),
            dma_in_s=in_bytes / c.link_bw, dma_out_s=out_bytes / c.link_bw,
            resources={}, clock_hz=0.0,
            meta={"flops": a["flops"], "bytes": a["bytes"],
                  "transcendentals": a["transcendentals"]})


# --------------------------------------------------------------------------
# SMP calibration: this container's CPU → the target board's ARM A9
# --------------------------------------------------------------------------

# Single-core ARM Cortex-A9 @667MHz running -O3 naive tiled sgemm sustains
# ~0.35 GFLOP/s (double: ~0.18).  The instrumented sequential run measures
# *relative* per-kernel costs on the build host; this ratio rescales them to
# the target SMP — the standard cross-compilation timing calibration.
A9_SGEMM_GFLOPS = 0.35
A9_DGEMM_GFLOPS = 0.18

_host_gflops_cache: Dict[Tuple[str, int], float] = {}


def host_gemm_gflops(dtype: str = "float32", n: int = 64, repeats: int = 20) -> float:
    """Measure this host's numpy GEMM throughput at block size ``n`` (cached).

    Calibrating at the *kernel's own* block size matters: a 64×64 ``np.dot``
    runs far below machine peak (call overhead, no blocking), which is
    exactly the regime the traced app kernels execute in.
    """
    key = (dtype, n)
    if key in _host_gflops_cache:
        return _host_gflops_cache[key]
    import numpy as np
    import time
    # Same workload *form* as the traced kernels (C += A @ B over distinct
    # buffers, mean not best-of) so host-measured task times and the
    # calibration constant describe the same regime.
    rng = np.random.default_rng(0)
    sets = [(np.asarray(rng.standard_normal((n, n)), dtype=dtype),
             np.asarray(rng.standard_normal((n, n)), dtype=dtype),
             np.zeros((n, n), dtype=dtype)) for _ in range(8)]
    sets[0][2].__iadd__(sets[0][0] @ sets[0][1])  # warm-up
    t0 = time.perf_counter()
    iters = 0
    while iters < repeats:
        for a, b, c in sets:
            c += a @ b
        iters += 1
    mean = (time.perf_counter() - t0) / (iters * len(sets))
    gflops = (2.0 * n ** 3 / mean) / 1e9
    _host_gflops_cache[key] = gflops
    return gflops


def a9_smp_seconds(dtype: str = "float32"):
    """``TraceEvent -> seconds`` model of the target SMP (single A9 core).

    The paper's instrumented run measures task times *on the target ARM*;
    building on a foreign host we emulate that measurement by mapping each
    task's recorded work (FLOPs, from the @task ``work`` model) to sustained
    A9 throughput.  Tiny-BLAS host timings do not transfer across platforms
    (LAPACK call overhead dominates 64×64 kernels on x86 but not naive -O3
    loops on the A9), so this is the honest calibration.
    """
    gflops = A9_SGEMM_GFLOPS if dtype == "float32" else A9_DGEMM_GFLOPS

    def fn(event) -> float:  # noqa: ANN001 — TraceEvent
        if event.flops <= 0:
            raise ValueError(f"event {event.name} has no recorded work; "
                             f"annotate the @task with a 'work' model")
        return event.flops / (gflops * 1e9)

    return fn


def smp_time_scale(dtype: str = "float32", bs: int = 64) -> float:
    """Factor mapping host-measured kernel seconds → target-A9 seconds.

    The instrumented run measures *relative* per-kernel costs on the build
    host; this single calibration constant rescales them to the target SMP
    (ARM A9) — standard cross-compilation timing practice.
    """
    target = A9_SGEMM_GFLOPS if dtype == "float32" else A9_DGEMM_GFLOPS
    return max(host_gemm_gflops(dtype, bs) / target, 1.0)
