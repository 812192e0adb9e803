"""Three-term roofline model: the JAX package's ``repro/roofline/model.py``
with the card's hardware record.

Definitions (all terms in **seconds per step**):

* ``compute``    = FLOPs / (chips · peak) — per device;
* ``memory``     = bytes / (chips · HBM_bw) — an upper bound where the
  bytes are an unfused count (``TorchCostModel``'s, like XLA-CPU's
  ``bytes accessed``);
* ``collective`` = wire_bytes / link_bw — ring-model wire traffic per
  device over one link direction.

``MODEL_FLOPS`` = 6·N·D for training (N = params, active params for MoE;
D = global tokens), 2·N·D for prefill, 2·N·B for one decode step.  The
ratio MODEL_FLOPS / FLOPs(global) shows how much counted compute is
"useful"; ``roofline_fraction`` = ideal_time / max(term).

A record has the dry-run's keys (``n_layers``, ``cost_analysis.flops``,
``cost_analysis["bytes accessed"]``, ``collectives.wire_bytes``), which
:func:`extrapolate_terms` and :mod:`repro_torch.core.steptask` read.  The
reference's ``analyze_record``/``analyze_all``/``load_artifacts`` read
the dry-run's artifacts and ``roofline/analytic.py``, and wait for the
port's dry-run (ROADMAP 1.7).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from ..core.hlsreport import H100_SXM


@dataclasses.dataclass(frozen=True)
class HW:
    name: str
    peak_flops: float            # per chip, bf16
    hbm_bw: float                # per chip, B/s
    link_bw: float               # per link direction, B/s
    hbm_bytes: float             # per chip
    internode_bw: float = 50e9   # between pods, per chip, B/s
    chips_per_pod: int = 8       # chips that share the fast links


#: One H100 SXM in an HGX node of eight (NVIDIA's datasheet figures of
#: :data:`repro_torch.core.hlsreport.H100_SXM`): bf16 peak, HBM3, one
#: NVLink 4 direction, 80 GB, one 400 Gb/s NDR port between nodes.
H100 = HW(name="h100_sxm", peak_flops=H100_SXM.peak_flops,
          hbm_bw=H100_SXM.hbm_bw, link_bw=H100_SXM.link_bw,
          hbm_bytes=H100_SXM.hbm_bytes, internode_bw=H100_SXM.internode_bw,
          chips_per_pod=8)


@dataclasses.dataclass
class CellRoofline:
    arch: str
    shape: str
    mesh: str
    kind: str
    tag: str
    n_devices: int
    compute_s: float
    memory_s: float              # analytic HBM-traffic floor
    collective_s: float
    memory_hlo_s: float          # counted bytes (diagnostic bound)
    model_flops: float           # 6·N·D / 2·N·D / 2·N·B
    hlo_flops_global: float
    useful_ratio: float          # MODEL_FLOPS / FLOPs(global)
    ideal_s: float
    roofline_fraction: float
    peak_mem_gb: Optional[float]
    fits: Optional[bool]

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=lambda k: terms[k])

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    def row(self) -> Dict[str, object]:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "tag": self.tag,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "memory_hlo_s": self.memory_hlo_s, "dominant": self.dominant,
            "model_flops": self.model_flops,
            "useful_ratio": self.useful_ratio,
            "ideal_s": self.ideal_s,
            "roofline_fraction": self.roofline_fraction,
            "peak_mem_gb": self.peak_mem_gb, "fits": self.fits,
        }


def model_flops(record: Dict) -> float:
    """6·N·D (train) / 2·N·D (prefill) / 2·N·B (decode) with N = active."""
    n = record.get("active_params") or record["params"]
    kind = record["kind"]
    if kind == "train":
        d = record["global_batch"] * record["seq_len"]
        return 6.0 * n * d
    if kind == "prefill":
        d = record["global_batch"] * record["seq_len"]
        return 2.0 * n * d
    return 2.0 * n * record["global_batch"]        # decode: one token/seq


def _terms_of(record: Dict) -> Dict[str, float]:
    return {
        "flops": float(record["cost_analysis"].get("flops", 0.0)),
        "bytes": float(record["cost_analysis"].get("bytes accessed", 0.0)),
        "wire": float(record["collectives"]["wire_bytes"]),
    }


def extrapolate_terms(probe1: Dict, probe2: Dict,
                      full_layers: int) -> Dict[str, float]:
    """Linear fit term(L) = O + B·L over two probes at depths L1 < L2,
    extrapolated to the full depth (exact for homogeneous stacks)."""
    l1, l2 = probe1["n_layers"], probe2["n_layers"]
    t1, t2 = _terms_of(probe1), _terms_of(probe2)
    out = {}
    for k in t1:
        slope = (t2[k] - t1[k]) / max(l2 - l1, 1)
        if slope < 0:
            # a different strategy at the smallest depth: proportional
            # from the larger probe rather than a negative slope
            out[k] = t2[k] * full_layers / l2
        else:
            out[k] = t1[k] + slope * (full_layers - l1)
    return out


def roofline_table(cells: List[CellRoofline], fmt: str = "md") -> str:
    hdr = ("| arch | shape | mesh | compute s | memory s | collective s | "
           "hlo-mem s | dominant | useful | roofline | peak GB | fits |")
    sep = "|" + "---|" * 12
    rows = [hdr, sep]
    for c in cells:
        rows.append(
            f"| {c.arch} | {c.shape} | {c.mesh} | {c.compute_s:.4f} | "
            f"{c.memory_s:.4f} | {c.collective_s:.4f} | "
            f"{c.memory_hlo_s:.3f} | {c.dominant} | "
            f"{c.useful_ratio:.3f} | {c.roofline_fraction:.3f} | "
            f"{'' if c.peak_mem_gb is None else f'{c.peak_mem_gb:.2f}'} | "
            f"{'yes' if c.fits else 'NO' if c.fits is not None else '?'} |")
    return "\n".join(rows)
