"""Framework data types: NodeInfo, PodInfo, QueuedPodInfo, events, FitError.

Mirrors pkg/scheduler/framework/types.go (NodeInfo :165-208, PodInfo,
QueuedPodInfo) and the staging ClusterEvent/ActionType bitmask
(staging/.../framework/types.go:33-130). NodeInfo here is the host-side row
mirror of the device capacity matrices; `generation` drives the incremental
scatter-update snapshot (reference: backend/cache/snapshot.go).
"""

from __future__ import annotations

import enum
import itertools
from dataclasses import dataclass, field
from typing import Optional

from ..api import resources as res
from ..api.types import Node, Pod

_generation = itertools.count(1)


def next_generation() -> int:
    return next(_generation)


# ---------------------------------------------------------------------------
# cluster events (reference: staging framework/types.go ActionType bitmask)


class ActionType(enum.IntFlag):
    ADD = 1
    DELETE = 2
    UPDATE_NODE_ALLOCATABLE = 4
    UPDATE_NODE_LABEL = 8
    UPDATE_NODE_TAINT = 16
    UPDATE_NODE_CONDITION = 32
    UPDATE_NODE_ANNOTATION = 64
    UPDATE_POD_LABEL = 128
    UPDATE_POD_SCALE_DOWN = 256
    UPDATE_POD_TOLERATION = 512
    UPDATE_POD_SCHEDULING_GATES = 1024
    UPDATE_NODE_DECLARED_FEATURE = 2048
    UPDATE = (UPDATE_NODE_ALLOCATABLE | UPDATE_NODE_LABEL | UPDATE_NODE_TAINT
              | UPDATE_NODE_CONDITION | UPDATE_NODE_ANNOTATION | UPDATE_POD_LABEL
              | UPDATE_POD_SCALE_DOWN | UPDATE_POD_TOLERATION
              | UPDATE_POD_SCHEDULING_GATES | UPDATE_NODE_DECLARED_FEATURE)
    ALL = ADD | DELETE | UPDATE


class EventResource(str, enum.Enum):
    POD = "Pod"
    ASSIGNED_POD = "AssignedPod"
    UNSCHEDULABLE_POD = "UnschedulablePod"
    NODE = "Node"
    PVC = "PersistentVolumeClaim"
    PV = "PersistentVolume"
    CSI_NODE = "CSINode"
    WORKLOAD = "Workload"
    PDB = "PodDisruptionBudget"
    RESOURCE_CLAIM = "ResourceClaim"
    RESOURCE_SLICE = "ResourceSlice"
    WILDCARD = "*"


@dataclass(frozen=True)
class ClusterEvent:
    resource: EventResource
    action_type: ActionType
    label: str = ""

    def match(self, other: "ClusterEvent") -> bool:
        return ((self.resource == other.resource or self.resource == EventResource.WILDCARD)
                and bool(self.action_type & other.action_type))


class QueueingHint(enum.IntEnum):
    """Reference: staging framework/interface.go QueueingHint."""

    SKIP = 0
    QUEUE = 1


EVENT_UNSCHEDULABLE_TIMEOUT = ClusterEvent(EventResource.WILDCARD, ActionType.ALL, "UnschedulableTimeout")
EVENT_FORCE_ACTIVATE = ClusterEvent(EventResource.WILDCARD, ActionType.ALL, "ForceActivate")


# ---------------------------------------------------------------------------
# PodInfo: pod + pre-parsed scheduling terms (reference types.go PodInfo —
# required affinity terms pre-parsed once at ingest)


@dataclass(slots=True)
class PodInfo:
    pod: Pod
    # flattened request vectors, computed once
    requests: dict[str, int] = field(default_factory=dict)
    cpu_nonzero: int = 0
    mem_nonzero: int = 0
    # lazy parse cache (interpodaffinity existing-anti fast path); slots
    # forbid ad-hoc attributes, so the cache slot is declared here
    _parsed_req_anti_affinity: Optional[tuple] = None

    @staticmethod
    def of(pod: Pod) -> "PodInfo":
        cpu_nz, mem_nz = res.pod_requests_nonzero(pod)
        return PodInfo(pod=pod, requests=res.pod_requests(pod),
                       cpu_nonzero=cpu_nz, mem_nonzero=mem_nz)

    @property
    def required_affinity_terms(self):
        aff = self.pod.spec.affinity
        return aff.pod_affinity.required if aff and aff.pod_affinity else ()

    @property
    def required_anti_affinity_terms(self):
        aff = self.pod.spec.affinity
        return aff.pod_anti_affinity.required if aff and aff.pod_anti_affinity else ()


# ---------------------------------------------------------------------------
# QueuedPodInfo (reference types.go QueuedPodInfo)


@dataclass(slots=True)
class QueuedPodInfo:
    pod_info: PodInfo
    timestamp: float = 0.0          # when added to queue (for queue-sort tie)
    initial_attempt_timestamp: Optional[float] = None
    attempts: int = 0
    unschedulable_count: int = 0    # backoff exponent driver
    consecutive_errors_count: int = 0
    # None means "empty": the ingest hot path creates one QueuedPodInfo
    # per pod, and two set() allocations per pod for fields only the
    # failure path populates are a measurable slice of add_bulk. Readers
    # treat None and empty-set alike (truthiness); writers assign real
    # sets.
    unschedulable_plugins: Optional[set[str]] = None
    pending_plugins: Optional[set[str]] = None
    gated: bool = False
    gating_plugin: str = ""
    # `pod` is a REAL slot, not a property: the queue-sort key and every
    # hot loop read it several times per pod, and the attribute load is
    # ~3× cheaper than a property descriptor call. Kept in sync by
    # __post_init__ and the two pod_info-replacement sites in
    # backend/queue.py update().
    pod: Optional[Pod] = None

    def __post_init__(self) -> None:
        if self.pod is None:
            self.pod = self.pod_info.pod


# ---------------------------------------------------------------------------
# NodeInfo (reference types.go:165-208)


@dataclass
class HostPortInfo:
    """used host ports: set of (protocol, port, ip)."""

    ports: set[tuple[str, int, str]] = field(default_factory=set)

    @staticmethod
    def _ip(ip: str) -> str:
        return ip or "0.0.0.0"

    def add(self, protocol: str, port: int, ip: str = "") -> None:
        if port > 0:
            self.ports.add((protocol or "TCP", port, self._ip(ip)))

    def remove(self, protocol: str, port: int, ip: str = "") -> None:
        self.ports.discard((protocol or "TCP", port, self._ip(ip)))

    def conflicts(self, protocol: str, port: int, ip: str = "") -> bool:
        """Reference: framework/types.go HostPortInfo.CheckConflict —
        wildcard IP conflicts with any IP on same proto/port."""
        if port <= 0:
            return False
        protocol, ip = protocol or "TCP", self._ip(ip)
        if ip == "0.0.0.0":
            return any(p == protocol and pt == port for (p, pt, _) in self.ports)
        return ((protocol, port, ip) in self.ports
                or (protocol, port, "0.0.0.0") in self.ports)


@dataclass
class NodeInfo:
    node: Node
    pods: list[PodInfo] = field(default_factory=list)
    pods_with_affinity: list[PodInfo] = field(default_factory=list)
    pods_with_required_anti_affinity: list[PodInfo] = field(default_factory=list)
    requested: dict[str, int] = field(default_factory=dict)
    non_zero_cpu: int = 0
    non_zero_mem: int = 0
    used_ports: HostPortInfo = field(default_factory=HostPortInfo)
    image_sizes: dict[str, int] = field(default_factory=dict)  # image name → size
    generation: int = 0

    def __post_init__(self) -> None:
        if not self.generation:
            self.generation = next_generation()
        if not self.image_sizes:
            self.sync_images()

    def sync_images(self) -> None:
        """node.status.images → name→size map (cache.go updateImageStates:
        every name of an image entry resolves to its size)."""
        sizes: dict[str, int] = {}
        for img in self.node.status.images:
            for name in img.names:
                sizes[name] = img.size_bytes
        self.image_sizes = sizes

    @property
    def name(self) -> str:
        return self.node.name

    @property
    def allocatable(self) -> dict[str, int]:
        return self.node.status.allocatable

    def bump(self) -> None:
        self.generation = next_generation()

    def snapshot_clone(self) -> "NodeInfo":
        """NodeInfo.Snapshot(): structural copy sharing immutable PodInfos
        (types.go Snapshot) — mutation-safe for preemption dry runs."""
        clone = NodeInfo(node=self.node, generation=self.generation,
                         image_sizes=dict(self.image_sizes))
        clone.pods = list(self.pods)
        clone.pods_with_affinity = list(self.pods_with_affinity)
        clone.pods_with_required_anti_affinity = list(
            self.pods_with_required_anti_affinity)
        clone.requested = dict(self.requested)
        clone.non_zero_cpu = self.non_zero_cpu
        clone.non_zero_mem = self.non_zero_mem
        clone.used_ports.ports = set(self.used_ports.ports)
        return clone

    # -- pod add/remove (reference types.go AddPodInfo/RemovePod) ------------

    def add_pod(self, pi: PodInfo) -> None:
        self.pods.append(pi)
        if pi.required_affinity_terms or self._has_preferred_affinity(pi):
            self.pods_with_affinity.append(pi)
        if pi.required_anti_affinity_terms:
            self.pods_with_required_anti_affinity.append(pi)
        for k, v in pi.requests.items():
            self.requested[k] = self.requested.get(k, 0) + v
        self.non_zero_cpu += pi.cpu_nonzero
        self.non_zero_mem += pi.mem_nonzero
        self._update_ports(pi.pod, add=True)
        self.bump()

    def remove_pod(self, pi: PodInfo) -> bool:
        uid = pi.pod.uid
        found = False
        for lst in (self.pods, self.pods_with_affinity, self.pods_with_required_anti_affinity):
            for i, p in enumerate(lst):
                if p.pod.uid == uid:
                    del lst[i]
                    found = lst is self.pods or found
                    break
        if not found:
            return False
        for k, v in pi.requests.items():
            self.requested[k] = self.requested.get(k, 0) - v
        self.non_zero_cpu -= pi.cpu_nonzero
        self.non_zero_mem -= pi.mem_nonzero
        self._update_ports(pi.pod, add=False)
        self.bump()
        return True

    @staticmethod
    def _has_preferred_affinity(pi: PodInfo) -> bool:
        aff = pi.pod.spec.affinity
        if not aff:
            return False
        return bool((aff.pod_affinity and aff.pod_affinity.preferred)
                    or (aff.pod_anti_affinity and aff.pod_anti_affinity.preferred))

    def _update_ports(self, pod: Pod, add: bool) -> None:
        for c in pod.spec.containers:
            for p in c.ports:
                if p.host_port > 0:
                    if add:
                        self.used_ports.add(p.protocol, p.host_port, p.host_ip)
                    else:
                        self.used_ports.remove(p.protocol, p.host_port, p.host_ip)


# ---------------------------------------------------------------------------
# failures / diagnosis (reference types.go FitError/Diagnosis)


@dataclass
class Diagnosis:
    node_to_status: dict[str, Status] = field(default_factory=dict)
    unschedulable_plugins: set[str] = field(default_factory=set)
    pending_plugins: set[str] = field(default_factory=set)
    pre_filter_msg: str = ""
    # memoized aggregations (one Diagnosis is shared by every same-signature
    # pod of a failed drain; a 5k-node histogram must not be recomputed per
    # pod). Invalidation is unnecessary: node_to_status is write-once.
    _reasons_hist: Optional[dict] = None
    _plugin_counts: Optional[dict] = None

    def reasons_histogram(self) -> dict[str, int]:
        """reason string → node count; a node contributes once per reason
        its status carries (reference types.go FitError.Error histogram)."""
        if self._reasons_hist is None:
            hist: dict[str, int] = {}
            for status in self.node_to_status.values():
                for r in status.reasons:
                    hist[r] = hist.get(r, 0) + 1
            self._reasons_hist = hist
        return self._reasons_hist

    def plugin_node_counts(self) -> dict[str, int]:
        """rejecting plugin → node count (each node counts once, under the
        first plugin that rejected it)."""
        if self._plugin_counts is None:
            counts: dict[str, int] = {}
            for status in self.node_to_status.values():
                p = status.plugin or "?"
                counts[p] = counts.get(p, 0) + 1
            self._plugin_counts = counts
        return self._plugin_counts


@dataclass
class FitError(Exception):
    pod: Pod
    num_all_nodes: int
    diagnosis: Diagnosis = field(default_factory=Diagnosis)

    def __str__(self) -> str:
        """Reference types.go FitError.Error(): '0/N nodes are available:
        <count> <reason>, ...' with reasons sorted alphabetically (the
        FailedScheduling event body)."""
        if self.diagnosis.pre_filter_msg:
            return (f"0/{self.num_all_nodes} nodes are available: "
                    f"{self.diagnosis.pre_filter_msg}.")
        hist = self.diagnosis.reasons_histogram()
        if not hist:
            return (f"0/{self.num_all_nodes} nodes are available for pod "
                    f"{self.pod.namespace}/{self.pod.name}")
        body = ", ".join(f"{count} {reason}"
                         for reason, count in sorted(hist.items()))
        return f"0/{self.num_all_nodes} nodes are available: {body}."


from .interface import Status  # noqa: E402  (bottom import to avoid cycle)
