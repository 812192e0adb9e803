"""The yardstick's arithmetic: the card's peaks and each kernel's bytes.

``HBM_BYTES_PER_S`` is one NVIDIA H100 SXM's HBM3 bandwidth from NVIDIA's
data sheet (3.35 TB/s, at the full 700 W power limit).  ``commit_bytes``
is a frozen copy of ``chip_smoke.py::commit_bytes`` at commit e803567.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12


def commit_bytes(S: int, B: int, n_live: int) -> int:
    """Bytes one ``step_commit`` launch must move, read once and written
    once: the S clocks of each lane's own pool, each lane's p, rt, base
    and live, the busy entry of each live lane (read and written), ``end``
    for every lane, and one clock and one seen entry per live lane (in
    place).  The other pools' clocks, busy and seen are not touched, so P
    drops out."""
    reads = S * B * 8 + B * (8 + 8 + 8 + 1) + n_live * 8
    writes = B * 8 + n_live * (8 + 8 + 1)
    return reads + writes
