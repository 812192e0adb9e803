"""Data regions and access directions — the OmpSs dependence domain.

OmpSs infers task dependences from the *addresses* of the data each task
declares it reads/writes (``in([BS*BS]A)``, ``inout([BS*BS]C)``...).  We keep
the same model: a :class:`Region` is an opaque address (any hashable key —
for the Python apps we use ``id()`` of the backing numpy buffer, or a stable
string name) plus a byte size used for transfer-cost accounting.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Any, Hashable


class Direction(enum.Enum):
    """Dependence direction of one task argument (OmpSs ``in/out/inout``)."""

    IN = "in"
    OUT = "out"
    INOUT = "inout"

    @property
    def reads(self) -> bool:
        return self in (Direction.IN, Direction.INOUT)

    @property
    def writes(self) -> bool:
        return self in (Direction.OUT, Direction.INOUT)


@dataclasses.dataclass(frozen=True)
class Region:
    """A named/addressed chunk of shared memory a task touches.

    ``key``   — identity used for dependence matching (exact-match, like the
                address-based matching of Nanos++).
    ``nbytes``— size in bytes, used for DMA / ICI transfer cost estimates.
    """

    key: Hashable
    nbytes: int = 0

    def __repr__(self) -> str:  # compact for traces
        return f"Region({self.key!r}, {self.nbytes}B)"


@dataclasses.dataclass(frozen=True)
class Access:
    """One (region, direction) pair of a task instance."""

    region: Region
    direction: Direction

    @property
    def reads(self) -> bool:
        return self.direction.reads

    @property
    def writes(self) -> bool:
        return self.direction.writes


def region_of(obj: Any, nbytes: int | None = None) -> Region:
    """Build a Region from a Python object.

    numpy arrays use the data pointer (stable under in-place mutation, the
    same way OmpSs tracks C pointers); strings are taken as symbolic names;
    anything else falls back to ``id()``.
    """
    if isinstance(obj, Region):
        return obj
    if isinstance(obj, str):
        return Region(obj, nbytes or 0)
    data_ptr = None
    try:  # numpy ndarray
        data_ptr = obj.__array_interface__["data"][0]
        size = int(obj.nbytes)
    except Exception:
        size = int(nbytes or 0)
    if data_ptr is not None:
        return Region(("ptr", data_ptr), nbytes or size)
    return Region(("id", id(obj)), nbytes or size)
