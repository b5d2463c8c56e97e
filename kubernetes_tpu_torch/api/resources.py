"""Resource quantities and the resource-dimension table.

The reference stores quantities as `resource.Quantity` (apimachinery) and the
scheduler flattens them into int64 MilliCPU/Memory/EphemeralStorage plus a
ScalarResources map (pkg/scheduler/framework/types.go `Resource`). We keep
that flattening but go one step further: every resource name is interned into
a fixed column index of the device-resident (nodes × resources) matrices, so
the whole fit check is one int64 compare-and-reduce on the TPU.

Canonical units: cpu → milli-cores, memory/ephemeral-storage/hugepages →
bytes, pods and extended resources → unit count. All int64.
"""

from __future__ import annotations

import functools
import math
import re
from dataclasses import dataclass, field

# well-known resource names (reference: core/v1 types.go ResourceCPU etc.)
CPU = "cpu"
MEMORY = "memory"
EPHEMERAL_STORAGE = "ephemeral-storage"
PODS = "pods"

# Fixed column order for the first four dims of every resource matrix.
# Extended resources are interned after these.
WELL_KNOWN = (CPU, MEMORY, EPHEMERAL_STORAGE, PODS)
CPU_IDX, MEM_IDX, STORAGE_IDX, PODS_IDX = 0, 1, 2, 3

# Reference: pkg/scheduler/util/pod_resources.go (DefaultMilliCPURequest /
# DefaultMemoryRequest): non-zero defaults used by LeastAllocated /
# BalancedAllocation via NodeInfo.NonZeroRequested.
DEFAULT_MILLI_CPU_REQUEST = 100
DEFAULT_MEMORY_REQUEST = 200 * 1024 * 1024

_SUFFIX = {
    "k": 10**3, "M": 10**6, "G": 10**9, "T": 10**12, "P": 10**15, "E": 10**18,
    "Ki": 2**10, "Mi": 2**20, "Gi": 2**30, "Ti": 2**40, "Pi": 2**50, "Ei": 2**60,
}
_QTY_RE = re.compile(r"^([0-9]*\.?[0-9]+)(m|[kMGTPE]i?)?$")


def _ceil(x: float) -> int:
    """Quantity.Value()/MilliValue() round fractional values up; guard float
    noise (1.5*1000 → 1500.0000000000002) before ceiling."""
    return math.ceil(x - 1e-9)


@functools.lru_cache(maxsize=8192)
def _parse_quantity_str(value: str, resource: str) -> int:
    m = _QTY_RE.match(value.strip())
    if not m:
        raise ValueError(f"unparseable quantity {value!r}")
    num, suffix = float(m.group(1)), m.group(2)
    if suffix == "m":
        if resource == CPU:
            return _ceil(num)
        return _ceil(num / 1000)
    scaled = num * _SUFFIX.get(suffix, 1)
    if resource == CPU:
        return _ceil(scaled * 1000)
    return _ceil(scaled)


def parse_quantity(value: str | int | float, resource: str = "") -> int:
    """Parse a k8s quantity string into canonical int64 units.

    "100m" cpu → 100; "2" cpu → 2000; "1Gi" → 2**30; "500M" → 5e8.
    ints/floats: cpu means cores (→ milli), others pass through.
    Fractional values round UP like Quantity.Value()/MilliValue().
    """
    if isinstance(value, int):
        return value * 1000 if resource == CPU else value
    if isinstance(value, float):
        return _ceil(value * 1000) if resource == CPU else _ceil(value)
    return _parse_quantity_str(value, resource)


def parse_resource_dict(d: dict[str, str | int | float]) -> dict[str, int]:
    return {name: parse_quantity(v, name) for name, v in d.items()}


@dataclass
class ResourceTable:
    """Interns resource names → column indices of the device matrices.

    Static width R: growing past R forces a re-pad + recompile, so R defaults
    comfortably above the usual cpu/memory/storage/pods + a few extended
    resources. The first four columns are always WELL_KNOWN.
    """

    width: int = 16
    names: list[str] = field(default_factory=lambda: list(WELL_KNOWN))
    index: dict[str, int] = field(default_factory=lambda: {n: i for i, n in enumerate(WELL_KNOWN)})

    def intern(self, name: str) -> int:
        idx = self.index.get(name)
        if idx is None:
            idx = len(self.names)
            if idx >= self.width:
                # grow to the next power of two; snapshot will re-pad.
                self.width *= 2
            self.names.append(name)
            self.index[name] = idx
        return idx

    def vector(self, requests: dict[str, int]) -> list[int]:
        """Dense row for a request dict (interning unseen names)."""
        idxs = [(self.intern(name), v) for name, v in requests.items()]
        row = [0] * self.width  # sized after interning: intern() may grow width
        for i, v in idxs:
            row[i] = v
        return row


def max_resource_list(a: dict[str, int], b: dict[str, int]) -> dict[str, int]:
    """Element-wise max, used for init-container folding."""
    out = dict(a)
    for k, v in b.items():
        if v > out.get(k, 0):
            out[k] = v
    return out


def add_resource_list(a: dict[str, int], b: dict[str, int]) -> dict[str, int]:
    out = dict(a)
    for k, v in b.items():
        out[k] = out.get(k, 0) + v
    return out


def pod_requests(pod) -> dict[str, int]:
    """Total scheduling-relevant request of a pod.

    Reference: k8s.io/component-helpers resource.PodRequests as used by
    noderesources computePodResourceRequest (fit.go:305): sum of container
    requests, element-wise max with init containers, plus overhead.

    Memoized on the PodSpec (clones share it): computed once per pod no
    matter how many times the queue/builder/cache ask. Treat the returned
    dict as read-only.
    """
    spec = pod.spec
    cached = getattr(spec, "_requests_cache", None)
    if cached is not None:
        return cached
    total: dict[str, int] = {}
    for c in spec.containers:
        total = add_resource_list(total, c.requests)
    for ic in spec.init_containers:
        total = max_resource_list(total, ic.requests)
    if spec.overhead:
        total = add_resource_list(total, spec.overhead)
    try:
        spec._requests_cache = total
    except AttributeError:
        pass
    return total


def _with_nonmissing_defaults(requests: dict[str, int]) -> dict[str, int]:
    # Go only substitutes when the key is ABSENT: an explicit 0 request stays 0.
    out = dict(requests)
    if CPU not in out:
        out[CPU] = DEFAULT_MILLI_CPU_REQUEST
    if MEMORY not in out:
        out[MEMORY] = DEFAULT_MEMORY_REQUEST
    return out


def pod_requests_nonmissing(pod) -> dict[str, int]:
    """Pod requests where every container missing a cpu/memory request gets
    the default (100m / 200Mi) — per container, as resourcehelper.PodRequests
    with NonMissingContainerRequests does (reference:
    noderesources/resource_allocation.go:234-241, and framework/types.go
    calculateResource feeding NodeInfo.NonZeroRequested).
    """
    total: dict[str, int] = {}
    for c in pod.spec.containers:
        total = add_resource_list(total, _with_nonmissing_defaults(c.requests))
    for ic in pod.spec.init_containers:
        total = max_resource_list(total, _with_nonmissing_defaults(ic.requests))
    if pod.spec.overhead:
        total = add_resource_list(total, pod.spec.overhead)
    return total


def pod_requests_nonzero(pod) -> tuple[int, int]:
    """(milli_cpu, memory) contribution to NodeInfo.NonZeroRequested.
    Memoized on the PodSpec like pod_requests."""
    spec = pod.spec
    cached = getattr(spec, "_nonzero_cache", None)
    if cached is not None:
        return cached
    req = pod_requests_nonmissing(pod)
    out = (req.get(CPU, 0), req.get(MEMORY, 0))
    try:
        spec._nonzero_cache = out
    except AttributeError:
        pass
    return out
