"""Device / resource model of the heterogeneous system.

The paper's target is a Zynq-7045 APSoC: 2 ARM A9 cores (SMP), a programmable
logic fabric hosting N accelerator slots (each with local BRAM), plus two
*shared, serialising* resources discovered experimentally (Fig. 3):

* ``submit``  — DMA programming is software on the SMP and uses shared
  registers → one transfer can be programmed at a time;
* ``dma_out`` — output transfers back to shared memory do NOT scale with the
  number of accelerators → they serialise on one shared channel.  Input
  transfers DO scale → their latency is *folded into* the accelerator task.

The same abstractions instantiate the TPU-pod model used by
``core/steptask.py`` (chips as accelerator slots, ICI links and the host
dispatch queue as shared resources), per DESIGN.md §2.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class DevicePool:
    """``count`` identical execution slots of one device kind.

    ``kinds`` — the device-kind labels this pool satisfies.  A task may run
    here iff one of its annotated device kinds is in ``kinds``.  For
    accelerators, ``kinds`` is usually specialised per kernel (an ``mxm64``
    accelerator slot only runs 64×64 mxmBlock tasks), mirroring that an FPGA
    bitstream instantiates *specific* IP blocks.
    """

    name: str
    kinds: Tuple[str, ...]
    count: int = 1

    def compatible(self, task_kinds: Sequence[str]) -> Optional[str]:
        for k in task_kinds:
            if k in self.kinds:
                return k
        return None


@dataclasses.dataclass(frozen=True)
class SharedResource:
    """A serialising shared resource (submit queue, output-DMA channel...)."""

    name: str
    count: int = 1


@dataclasses.dataclass
class SystemConfig:
    """A candidate hardware/software configuration to be simulated."""

    name: str
    pools: List[DevicePool]
    shared: List[SharedResource] = dataclasses.field(default_factory=list)
    # Fig. 3 asymmetry: inputs overlap (scale with #accels) → folded into the
    # accelerator latency; outputs don't → explicit serialised transfer tasks.
    overlap_inputs: bool = True
    overlap_outputs: bool = False
    # Cost (seconds) of creating one task instance in the runtime — always
    # paid on the SMP by the creating (master) thread, serialised in program
    # order.  Measured for Nanos++ on the A9 at O(1 µs); configurable.
    task_creation_cost: float = 2e-6
    # Cost of programming one DMA descriptor from software (submit task).
    dma_submit_cost: float = 1.5e-6
    meta: Dict[str, object] = dataclasses.field(default_factory=dict)

    def pool_by_name(self, name: str) -> DevicePool:
        for p in self.pools:
            if p.name == name:
                return p
        raise KeyError(name)

    def all_kinds(self) -> Tuple[str, ...]:
        out: List[str] = []
        for p in self.pools:
            for k in p.kinds:
                if k not in out:
                    out.append(k)
        return tuple(out)

    def total_slots(self) -> int:
        return sum(p.count for p in self.pools)


def zynq_system(name: str,
                accelerators: Dict[str, int],
                smp_cores: int = 2,
                heterogeneous: Dict[str, bool] | None = None,
                task_creation_cost: float = 2e-6,
                dma_submit_cost: float = 1.5e-6) -> SystemConfig:
    """Build a Zynq-like config.

    ``accelerators`` maps accelerator kind (e.g. ``"fpga:mxm64"``) → #slots.
    ``heterogeneous`` is unused here (eligibility lives on the tasks) but kept
    for the co-design table labels.
    """
    pools = [DevicePool("smp", ("smp",), smp_cores)]
    for kind, n in accelerators.items():
        if n > 0:
            pools.append(DevicePool(kind.replace("fpga:", "acc_"), (kind,), n))
    shared = [SharedResource("submit", 1), SharedResource("dma_out", 1)]
    return SystemConfig(name=name, pools=pools, shared=shared,
                        overlap_inputs=True, overlap_outputs=False,
                        task_creation_cost=task_creation_cost,
                        dma_submit_cost=dma_submit_cost,
                        meta={"accelerators": dict(accelerators)})


# --------------------------------------------------------------------------
# TPU-pod instantiation of the same model (used by core/steptask.py)
# --------------------------------------------------------------------------

def pod_system(name: str, n_chips: int, ici_links: int = 1,
               host_queues: int = 1, task_creation_cost: float = 5e-6) -> SystemConfig:
    """A (single-pod slice of a) TPU system as a coarse device model.

    Chips are accelerator slots of kind ``"tpu"``; the ICI fabric is modelled
    as ``ici_links`` serialising channels (collectives of the same step phase
    share them); host dispatch is a shared queue like the paper's ``submit``.
    """
    pools = [DevicePool("host", ("smp", "host"), 1),
             DevicePool("tpu", ("tpu",), n_chips)]
    shared = [SharedResource("ici", ici_links), SharedResource("submit", host_queues)]
    return SystemConfig(name=name, pools=pools, shared=shared,
                        overlap_inputs=True, overlap_outputs=True,
                        task_creation_cost=task_creation_cost,
                        dma_submit_cost=1e-6,
                        meta={"n_chips": n_chips})
