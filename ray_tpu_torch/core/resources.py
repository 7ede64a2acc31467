"""Resource model: fixed-point quantities, resource sets, node resources.

Equivalent of the reference's ``src/ray/common/scheduling/``:
``FixedPoint`` (``fixed_point.h``) avoids float drift in repeated
acquire/release; ``ResourceSet``/``NodeResources``
(``cluster_resource_data.h``) model predefined (CPU/memory/GPU/
object_store_memory) plus custom and label resources. The port's
accelerator resource is ``GPU``, one unit a CUDA card (``gpu.py``).
"""

from __future__ import annotations

from typing import Iterable

RESOURCE_UNIT = 10000  # 1.0 CPU == 10000 units (reference fixed_point.h)

CPU = "CPU"
MEMORY = "memory"
GPU = "GPU"
OBJECT_STORE_MEMORY = "object_store_memory"
PREDEFINED = (CPU, MEMORY, GPU, OBJECT_STORE_MEMORY)


def to_fixed(value: float) -> int:
    return int(round(value * RESOURCE_UNIT))


def from_fixed(units: int) -> float:
    return units / RESOURCE_UNIT


class ResourceSet:
    """A bag of named resource quantities in fixed-point units."""

    __slots__ = ("_units",)

    def __init__(self, amounts: dict[str, float] | None = None, *, _units: dict[str, int] | None = None):
        if _units is not None:
            self._units = {k: v for k, v in _units.items() if v != 0}
        else:
            self._units = {}
            for name, value in (amounts or {}).items():
                units = to_fixed(value)
                if units != 0:
                    self._units[name] = units

    # -- accessors -----------------------------------------------------------
    def get(self, name: str) -> float:
        return from_fixed(self._units.get(name, 0))

    def get_units(self, name: str) -> int:
        return self._units.get(name, 0)

    def names(self) -> Iterable[str]:
        return self._units.keys()

    def is_empty(self) -> bool:
        return not self._units

    def to_dict(self) -> dict[str, float]:
        return {k: from_fixed(v) for k, v in self._units.items()}

    # -- algebra -------------------------------------------------------------
    def subset_of(self, other: "ResourceSet") -> bool:
        return all(other._units.get(k, 0) >= v for k, v in self._units.items())

    def add(self, other: "ResourceSet") -> "ResourceSet":
        units = dict(self._units)
        for k, v in other._units.items():
            units[k] = units.get(k, 0) + v
        return ResourceSet(_units=units)

    def subtract(self, other: "ResourceSet", *, allow_negative: bool = False) -> "ResourceSet":
        units = dict(self._units)
        for k, v in other._units.items():
            nv = units.get(k, 0) - v
            if nv < 0 and not allow_negative:
                raise ValueError(f"Resource {k} would go negative")
            units[k] = nv
        return ResourceSet(_units=units)

    def __eq__(self, other) -> bool:
        return isinstance(other, ResourceSet) and self._units == other._units

    def __repr__(self) -> str:
        return f"ResourceSet({self.to_dict()})"


class NodeResources:
    """Total and available resources plus labels for one node.

    Mirrors ``NodeResources`` in ``cluster_resource_data.h``; labels support
    the node-label scheduling policy and TPU slice/generation affinity.
    """

    def __init__(self, total: dict[str, float], labels: dict[str, str] | None = None):
        self.total = ResourceSet(total)
        self.available = ResourceSet(total)
        self.labels = dict(labels or {})

    def can_fit(self, request: ResourceSet) -> bool:
        return request.subset_of(self.available)

    def could_ever_fit(self, request: ResourceSet) -> bool:
        return request.subset_of(self.total)

    def acquire(self, request: ResourceSet) -> None:
        self.available = self.available.subtract(request)

    def release(self, request: ResourceSet) -> None:
        self.available = self.available.add(request)

    def utilization(self) -> float:
        """Max over resources of used/total — the hybrid policy's node score
        (reference ``hybrid_scheduling_policy.cc``)."""
        score = 0.0
        for name in self.total.names():
            total = self.total.get_units(name)
            if total <= 0:
                continue
            used = total - self.available.get_units(name)
            score = max(score, used / total)
        return score

    def to_dict(self) -> dict:
        return {
            "total": self.total.to_dict(),
            "available": self.available.to_dict(),
            "labels": self.labels,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "NodeResources":
        nr = cls(d["total"], d.get("labels"))
        nr.available = ResourceSet(d["available"])
        return nr
