"""Shared by the own-order tests (``test_torch_own_order*.py``): the
blocked matmul's accelerator kinds and graphs, with the port alone, so
that the card's test file imports nothing of the JAX package."""
import itertools

from repro_torch.apps import cholesky as ch
from repro_torch.apps import matmul as mm
from repro_torch.core import devices, fastsim
from repro_torch.core.augment import Eligibility, build_graph
from repro_torch.core.hlsreport import (HLSSynthesisModel, ZYNQ_7045_BUDGET,
                                        a9_smp_seconds)

#: The matmul's accelerator kinds: ``mxm_block`` at bs 64 at each unroll.
MXM = {"fpga:mxm64": 64, "fpga:mxm64r32": 32, "fpga:mxm64r16": 16}


def mxm_reports():
    hls = HLSSynthesisModel()
    return {("mxm_block", k): hls.matmul_block(64, unroll=u, kind=k)
            for k, u in MXM.items()}


def frozen(trace, reports, kinds, elig, smp_fn):
    system = devices.zynq_system("g", {k: 1 for k in kinds})
    return fastsim.FrozenGraph.freeze(build_graph(
        trace, system, reports, Eligibility(elig), smp_seconds_fn=smp_fn))


def matmul512_space():
    """Every multiset of the three kinds that fits the Zynq-7045 (67), ±SMP:
    the benchmark's matmul design space, as ``(graph, systems)``
    families."""
    reports = mxm_reports()
    use = {k: reports[("mxm_block", k)].resources for k in MXM}

    def fits(counts):
        return all(sum(use[k].get(r, 0.0) * n for k, n in counts.items())
                   <= cap for r, cap in ZYNQ_7045_BUDGET.items())

    designs = [c for c in ({k: n for k, n in zip(MXM, combo) if n}
                           for combo in itertools.product(range(12),
                                                          repeat=3))
               if c and fits(c)]
    assert len(designs) == 67
    trace = mm.trace_matmul(512, 64, verify=False)
    fams = {}
    for counts in designs:
        for smp in (True, False):
            kinds = tuple(counts)
            key = (kinds, smp)
            if key not in fams:
                elig = {"mxm_block": kinds + (("smp",) if smp else ())}
                fams[key] = (frozen(trace, reports, kinds, elig,
                                    a9_smp_seconds("float32")), [])
            fams[key][1].append(devices.zynq_system(
                "+".join(f"{k}x{n}" for k, n in counts.items())
                + ("+smp" if smp else ""), counts))
    return list(fams.values())


def cholesky_candidates(most=8):
    """``(slots, candidate)`` pairs for the Cholesky at bs 64: each Fig. 9
    design at 1..``most`` times its slots, with the SMP and FPGA only (the
    SMP kept where a kernel has nothing else)."""
    cands = []
    for base in ch.candidates(bs=64):
        for k in range(1, most + 1):
            counts = {kind: n * k for kind, n
                      in base.system.meta["accelerators"].items()}
            fpga_only = Eligibility({
                op: tuple(d for d in kinds if d != "smp") or kinds
                for op, kinds in base.eligibility.kinds_by_kernel.items()})
            for smp in (True, False):
                name = f"{base.name}x{k}{'' if smp else '-fpga'}"
                elig = base.eligibility if smp else fpga_only
                cands.append((k, type(base)(
                    name=name, system=devices.zynq_system(name, counts),
                    eligibility=elig)))
    return cands
