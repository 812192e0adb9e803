# The paper's primary contribution — the coarse-grain heterogeneous
# performance-estimation toolchain: task tracing, HLS-analogue cost reports,
# trace augmentation, the dataflow runtime simulator and co-design
# exploration, with the candidate-axis engine on the card (torchsim).
from .regions import Access, Direction, Region, region_of
from .taskgraph import Task, TaskGraph
from .trace import Trace, TraceEvent, Tracer, task
from .devices import DevicePool, SharedResource, SystemConfig, pod_system, zynq_system
from .hlsreport import (HLSSynthesisModel, KernelReport, ZYNQ_7045_BUDGET,
                        a9_smp_seconds, fits, smp_time_scale)
from .augment import Eligibility, build_graph
from .simulator import (ScheduledTask, SimResult, Simulator, simulate,
                        validate_pools)
from .fastsim import FrozenGraph, freeze_graph, simulate_each, simulate_fast
from .batchsim import BatchStats, simulate_batch
from .replay import (ENGINE_TOLERANCE, TORCH_RTOL, MAX_RESCUE_ROUNDS,
                     ReplayLibrary, order_valid, rankings_equivalent,
                     sims_equivalent)
from .torchsim import simulate_torch, simulate_torch_many
from .diskcache import DiskCache, trace_fingerprint
from .estimator import (PerfEstimate, contention_time_model, estimate,
                        reference_run, same_best, spearman_rank_correlation,
                        speedup_table)
from .explore import (Axis, CacheStats, Candidate, CandidateOutcome,
                      DesignSpace, ENGINE_NAMES, ExplorationResult, Explorer,
                      explore, hillclimb, lower_bound_seconds, parallel_map)

__all__ = [
    "Access", "Direction", "Region", "region_of",
    "Task", "TaskGraph",
    "Trace", "TraceEvent", "Tracer", "task",
    "DevicePool", "SharedResource", "SystemConfig", "pod_system", "zynq_system",
    "HLSSynthesisModel", "KernelReport", "ZYNQ_7045_BUDGET",
    "a9_smp_seconds", "fits", "smp_time_scale",
    "Eligibility", "build_graph",
    "ScheduledTask", "SimResult", "Simulator", "simulate", "validate_pools",
    "FrozenGraph", "freeze_graph", "simulate_each", "simulate_fast",
    "BatchStats", "simulate_batch",
    "ENGINE_TOLERANCE", "TORCH_RTOL", "MAX_RESCUE_ROUNDS", "ReplayLibrary",
    "order_valid", "rankings_equivalent", "sims_equivalent",
    "simulate_torch", "simulate_torch_many",
    "DiskCache", "trace_fingerprint",
    "PerfEstimate", "contention_time_model", "estimate", "reference_run",
    "same_best", "spearman_rank_correlation", "speedup_table",
    "Axis", "CacheStats", "Candidate", "CandidateOutcome", "DesignSpace",
    "ENGINE_NAMES", "ExplorationResult", "Explorer", "explore", "hillclimb",
    "lower_bound_seconds", "parallel_map",
]
