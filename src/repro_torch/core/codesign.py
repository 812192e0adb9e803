"""Co-design space exploration — the programmer loop of §III/§VI.

A :class:`Candidate` bundles what the paper's programmer varies per
configuration: the hardware system (how many accelerator slots of which
kernel/granularity) and the task eligibility map (which kernels may run
where, i.e. the ``target device(...)`` annotations).  ``explore()`` runs the
estimator over every candidate, checks FPGA resource feasibility exactly
like the paper discards "2 × 128×128 mxm" (it does not fit the fabric), and
returns a ranked table plus the best pick.

The engine itself lives in :mod:`repro_torch.core.explore` (candidate generators,
graph/simulation memoization, parallel evaluation, lower-bound pruning);
this module is the stable import surface the apps and older callers use.
"""
from .explore import (Axis, Candidate, CandidateOutcome, CacheStats,
                      DesignSpace, ExplorationResult, Explorer, explore,
                      hillclimb, lower_bound_seconds, parallel_map)

__all__ = [
    "Axis", "Candidate", "CandidateOutcome", "CacheStats", "DesignSpace",
    "ExplorationResult", "Explorer", "explore", "hillclimb",
    "lower_bound_seconds", "parallel_map",
]
