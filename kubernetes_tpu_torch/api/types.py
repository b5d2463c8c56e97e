"""Core API object model — the subset of k8s API types the scheduler reads.

Mirrors the fields consumed by pkg/scheduler in the reference
(staging/src/k8s.io/api/core/v1/types.go); everything irrelevant to
scheduling decisions is omitted. These are plain Python dataclasses: the
"wire format" of this framework is the in-memory object graph fed by the
cluster-state ingestion layer (backend/eventhandlers), exactly as the
reference's scheduler only ever sees decoded informer objects.
"""

from __future__ import annotations

import copy
import dataclasses
import enum


def _shallow(obj):
    """Fast shallow copy for plain (non-slots) dataclass instances."""
    new = object.__new__(type(obj))
    new.__dict__.update(obj.__dict__)
    return new
from dataclasses import dataclass, field
from typing import Optional

# ---------------------------------------------------------------------------
# metadata


@dataclass
class ObjectMeta:
    name: str = ""
    namespace: str = "default"
    uid: str = ""
    labels: dict[str, str] = field(default_factory=dict)
    annotations: dict[str, str] = field(default_factory=dict)
    # creation ordering for queue-sort tie-breaks (reference: queuesort
    # priority_sort.go falls back to QueuedPodInfo timestamp; we also keep
    # object creation order for deterministic tests).
    creation_index: int = 0

    def __post_init__(self) -> None:
        if not self.uid:
            self.uid = f"{self.namespace}/{self.name}"


# ---------------------------------------------------------------------------
# taints & tolerations (reference: staging api core/v1/toleration.go, taint.go)


class TaintEffect(str, enum.Enum):
    NO_SCHEDULE = "NoSchedule"
    PREFER_NO_SCHEDULE = "PreferNoSchedule"
    NO_EXECUTE = "NoExecute"


class TolerationOperator(str, enum.Enum):
    EXISTS = "Exists"
    EQUAL = "Equal"


@dataclass(frozen=True)
class Taint:
    key: str
    value: str = ""
    effect: str = TaintEffect.NO_SCHEDULE.value


@dataclass(frozen=True)
class Toleration:
    key: str = ""
    operator: str = TolerationOperator.EQUAL.value
    value: str = ""
    effect: str = ""  # empty matches all effects
    toleration_seconds: Optional[int] = None

    def tolerates(self, taint: Taint) -> bool:
        """Reference: staging/src/k8s.io/api/core/v1/toleration.go:29-56.

        An empty key with Exists tolerates everything; operator defaults to
        Equal; empty effect matches all effects.
        """
        op = self.operator or TolerationOperator.EQUAL.value
        if self.effect and self.effect != taint.effect:
            return False
        if self.key and self.key != taint.key:
            return False
        if op == TolerationOperator.EXISTS.value:
            return True
        if op == TolerationOperator.EQUAL.value:
            # empty key with Equal: key must match (empty key only valid
            # with Exists), mirror Go behavior of comparing values.
            return self.value == taint.value
        return False


# ---------------------------------------------------------------------------
# label selectors (reference: apimachinery pkg/apis/meta/v1/types.go:1214,
# helpers in pkg/apis/meta/v1/helpers.go LabelSelectorAsSelector)


class SelectorOperator(str, enum.Enum):
    IN = "In"
    NOT_IN = "NotIn"
    EXISTS = "Exists"
    DOES_NOT_EXIST = "DoesNotExist"
    GT = "Gt"  # node-selector only
    LT = "Lt"  # node-selector only


@dataclass(frozen=True)
class LabelSelectorRequirement:
    key: str
    operator: str
    values: tuple[str, ...] = ()


@dataclass(frozen=True)
class LabelSelector:
    """match_labels is ANDed with match_expressions; empty selector matches
    everything, None (absent) matches nothing — callers must distinguish."""

    match_labels: tuple[tuple[str, str], ...] = ()
    match_expressions: tuple[LabelSelectorRequirement, ...] = ()

    @staticmethod
    def of(match_labels: Optional[dict[str, str]] = None,
           match_expressions: tuple[LabelSelectorRequirement, ...] = ()) -> "LabelSelector":
        return LabelSelector(
            match_labels=tuple(sorted((match_labels or {}).items())),
            match_expressions=tuple(match_expressions),
        )

    def matches(self, labels: dict[str, str]) -> bool:
        for k, v in self.match_labels:
            if labels.get(k) != v:
                return False
        for req in self.match_expressions:
            if not _requirement_matches(req, labels):
                return False
        return True


def _requirement_matches(req: LabelSelectorRequirement, labels: dict[str, str]) -> bool:
    op = req.operator
    if op == SelectorOperator.IN.value:
        return req.key in labels and labels[req.key] in req.values
    if op == SelectorOperator.NOT_IN.value:
        # NotIn requires the key to exist per labels.Requirement semantics
        # used by LabelSelectorAsSelector (NotIn -> sel.NotIn which matches
        # when key absent as well).  Reference: apimachinery labels/selector.go
        # Requirement.Matches: NotIn returns true when key is absent.
        return not (req.key in labels and labels[req.key] in req.values)
    if op == SelectorOperator.EXISTS.value:
        return req.key in labels
    if op == SelectorOperator.DOES_NOT_EXIST.value:
        return req.key not in labels
    if op in (SelectorOperator.GT.value, SelectorOperator.LT.value):
        if req.key not in labels or len(req.values) != 1:
            return False
        try:
            lhs = int(labels[req.key])
            rhs = int(req.values[0])
        except ValueError:
            return False
        return lhs > rhs if op == SelectorOperator.GT.value else lhs < rhs
    return False


# ---------------------------------------------------------------------------
# node affinity (reference: core/v1 NodeSelector / NodeAffinity; matching
# helpers in staging/src/k8s.io/component-helpers/scheduling/corev1/nodeaffinity)


@dataclass(frozen=True)
class NodeSelectorTerm:
    # terms are ORed; expressions within a term are ANDed
    match_expressions: tuple[LabelSelectorRequirement, ...] = ()
    match_fields: tuple[LabelSelectorRequirement, ...] = ()  # metadata.name only


@dataclass(frozen=True)
class NodeSelector:
    terms: tuple[NodeSelectorTerm, ...] = ()


@dataclass(frozen=True)
class PreferredSchedulingTerm:
    weight: int
    preference: NodeSelectorTerm


@dataclass(frozen=True)
class NodeAffinity:
    required: Optional[NodeSelector] = None
    preferred: tuple[PreferredSchedulingTerm, ...] = ()


# ---------------------------------------------------------------------------
# pod (anti-)affinity (reference: core/v1 PodAffinity/PodAntiAffinity)


@dataclass(frozen=True)
class PodAffinityTerm:
    topology_key: str
    label_selector: Optional[LabelSelector] = None
    namespaces: tuple[str, ...] = ()  # empty => pod's own namespace
    namespace_selector: Optional[LabelSelector] = None  # None => no ns selection
    match_label_keys: tuple[str, ...] = ()


@dataclass(frozen=True)
class WeightedPodAffinityTerm:
    weight: int
    term: PodAffinityTerm


@dataclass(frozen=True)
class PodAffinity:
    required: tuple[PodAffinityTerm, ...] = ()
    preferred: tuple[WeightedPodAffinityTerm, ...] = ()


@dataclass(frozen=True)
class PodAntiAffinity:
    required: tuple[PodAffinityTerm, ...] = ()
    preferred: tuple[WeightedPodAffinityTerm, ...] = ()


@dataclass(frozen=True)
class Affinity:
    node_affinity: Optional[NodeAffinity] = None
    pod_affinity: Optional[PodAffinity] = None
    pod_anti_affinity: Optional[PodAntiAffinity] = None


# ---------------------------------------------------------------------------
# topology spread (reference: core/v1 TopologySpreadConstraint)


class UnsatisfiableConstraintAction(str, enum.Enum):
    DO_NOT_SCHEDULE = "DoNotSchedule"
    SCHEDULE_ANYWAY = "ScheduleAnyway"


@dataclass(frozen=True)
class TopologySpreadConstraint:
    max_skew: int
    topology_key: str
    when_unsatisfiable: str
    label_selector: Optional[LabelSelector] = None
    min_domains: Optional[int] = None
    match_label_keys: tuple[str, ...] = ()
    # NodeAffinityPolicy / NodeTaintsPolicy: Honor (default) or Ignore
    node_affinity_policy: str = "Honor"
    node_taints_policy: str = "Ignore"


# ---------------------------------------------------------------------------
# containers / ports / resources


@dataclass(frozen=True)
class ContainerPort:
    host_port: int = 0
    container_port: int = 0
    protocol: str = "TCP"
    host_ip: str = ""


@dataclass
class Container:
    name: str = ""
    # resource requests in canonical int64 units (cpu: milli, memory: bytes,
    # anything else: unit count). Parse human strings via api.resources.parse.
    requests: dict[str, int] = field(default_factory=dict)
    limits: dict[str, int] = field(default_factory=dict)
    ports: tuple[ContainerPort, ...] = ()
    image: str = ""


@dataclass(frozen=True)
class PodSchedulingGate:
    name: str


# ---------------------------------------------------------------------------
# pod


DEFAULT_SCHEDULER_NAME = "default-scheduler"  # reference: v1.DefaultSchedulerName


# ---------------------------------------------------------------------------
# storage (reference: core/v1 PersistentVolume[Claim], storage/v1 StorageClass
# — the subset the scheduler's volume plugins consume)


@dataclass
class Volume:
    """core/v1 Volume, reduced to the sources the scheduler inspects."""

    name: str = ""
    # persistentVolumeClaim.claimName ("" = not a PVC-backed volume)
    claim_name: str = ""
    # csi driver for inline CSI volumes (nodevolumelimits counting)
    csi_driver: str = ""


@dataclass
class PersistentVolumeClaim:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    storage_class_name: str = ""
    volume_name: str = ""                  # bound PV ("" = unbound)
    # requested storage bytes (resources.requests["storage"])
    requested_bytes: int = 0
    access_modes: tuple[str, ...] = ("ReadWriteOnce",)
    phase: str = "Pending"                 # Pending | Bound

    @property
    def uid(self) -> str:
        return self.metadata.uid

    @property
    def name(self) -> str:
        return self.metadata.name

    @property
    def namespace(self) -> str:
        return self.metadata.namespace

    def is_bound(self) -> bool:
        return bool(self.volume_name)


@dataclass
class PersistentVolume:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    capacity_bytes: int = 0
    storage_class_name: str = ""
    # claim currently bound to this PV ("" = Available)
    claim_ref: str = ""                    # "<namespace>/<pvc name>"
    access_modes: tuple[str, ...] = ("ReadWriteOnce",)
    # volume.node_affinity.required (PV topology; local volumes / zonal disks)
    node_affinity: Optional[NodeSelector] = None
    csi_driver: str = ""                   # attachable-volume counting

    @property
    def name(self) -> str:
        return self.metadata.name


# storage/v1 VolumeBindingMode
BINDING_IMMEDIATE = "Immediate"
BINDING_WAIT_FOR_FIRST_CONSUMER = "WaitForFirstConsumer"


@dataclass
class StorageClass:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    provisioner: str = ""
    volume_binding_mode: str = BINDING_IMMEDIATE

    @property
    def name(self) -> str:
        return self.metadata.name


@dataclass
class PodSpec:
    containers: list[Container] = field(default_factory=list)
    init_containers: list[Container] = field(default_factory=list)
    node_name: str = ""
    scheduler_name: str = DEFAULT_SCHEDULER_NAME
    priority: int = 0
    node_selector: dict[str, str] = field(default_factory=dict)
    affinity: Optional[Affinity] = None
    tolerations: list[Toleration] = field(default_factory=list)
    topology_spread_constraints: list[TopologySpreadConstraint] = field(default_factory=list)
    scheduling_gates: list[PodSchedulingGate] = field(default_factory=list)
    overhead: dict[str, int] = field(default_factory=dict)
    host_network: bool = False
    # PreemptLowerPriority (default) | Never (core/v1 PreemptionPolicy)
    preemption_policy: str = "PreemptLowerPriority"
    # volumes the scheduler inspects (PVC refs + inline CSI)
    volumes: list[Volume] = field(default_factory=list)
    # node features this pod requires (nodedeclaredfeatures plugin; the
    # reference INFERS these from spec fields via the ndf library — our
    # object model declares them directly)
    required_node_features: tuple[str, ...] = ()
    # gang scheduling: name of the Workload/pod-group this pod belongs to
    # (reference: scheduling/v1alpha1.Workload via pod labels; we model it as
    # a direct field + the label fallback used by workloadmanager).
    workload_ref: str = ""
    # DRA: names of ResourceClaims (same namespace) this pod consumes
    # (core/v1 PodSpec.ResourceClaims → resourceClaimName)
    resource_claims: tuple[str, ...] = ()


@dataclass
class PodStatus:
    phase: str = "Pending"
    nominated_node_name: str = ""
    conditions: list[dict] = field(default_factory=list)


@dataclass
class Pod:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodSpec = field(default_factory=PodSpec)
    status: PodStatus = field(default_factory=PodStatus)

    @property
    def uid(self) -> str:
        return self.metadata.uid

    @property
    def name(self) -> str:
        return self.metadata.name

    @property
    def namespace(self) -> str:
        return self.metadata.namespace

    def with_node_name(self, node_name: str) -> "Pod":
        """Shallow rebind copy for the assume/bind hot path: fresh Pod +
        PodSpec (+ status) shells, node_name set; metadata, containers and
        label dicts are SHARED per the aliasing contract above. The three
        copies are inlined (not _shallow calls): this runs twice per
        scheduled pod and the call overhead is a measurable slice of the
        commit edge."""
        new = object.__new__
        p = new(Pod)
        p.__dict__.update(self.__dict__)
        sp = new(type(self.spec))
        sp.__dict__.update(self.spec.__dict__)
        sp.node_name = node_name
        p.spec = sp
        st = new(type(self.status))
        st.__dict__.update(self.status.__dict__)
        p.status = st
        return p

    def clone(self) -> "Pod":
        # hot path (2 clones per scheduled pod): raw __dict__ copies — both
        # copy.copy (reduce protocol) and dataclasses.replace (re-runs
        # __init__) are several times slower.
        # ALIASING CONTRACT: containers (and their request dicts) are
        # SHARED with the original — treat Container/requests as immutable
        # after creation; any mutation must replace, not update in place.
        p = _shallow(self)
        p.metadata = _shallow(self.metadata)
        p.metadata.labels = dict(self.metadata.labels)
        p.metadata.annotations = dict(self.metadata.annotations)
        p.spec = _shallow(self.spec)
        p.status = _shallow(self.status)
        return p


# ---------------------------------------------------------------------------
# node


@dataclass(frozen=True)
class ContainerImage:
    names: tuple[str, ...]
    size_bytes: int = 0


@dataclass
class NodeSpec:
    unschedulable: bool = False
    taints: list[Taint] = field(default_factory=list)


@dataclass
class NodeStatus:
    # canonical int64 units, keyed by resource name ("cpu", "memory", "pods",
    # "ephemeral-storage", extended resources)
    capacity: dict[str, int] = field(default_factory=dict)
    allocatable: dict[str, int] = field(default_factory=dict)
    images: list[ContainerImage] = field(default_factory=list)
    # features the node runtime declares (node.status.declaredFeatures)
    declared_features: tuple[str, ...] = ()


@dataclass
class Node:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: NodeSpec = field(default_factory=NodeSpec)
    status: NodeStatus = field(default_factory=NodeStatus)

    @property
    def name(self) -> str:
        return self.metadata.name


# ---------------------------------------------------------------------------
# gang scheduling Workload API (reference:
# staging/src/k8s.io/api/scheduling/v1alpha1/types.go:82 `Workload`)


@dataclass
class PodGroup:
    """One gang within a Workload: schedule all-or-nothing once at least
    min_count member pods are available (reference gangscheduling.go:120-158)."""

    name: str
    min_count: int


@dataclass
class Workload:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    pod_groups: list[PodGroup] = field(default_factory=list)


def pod_group_key(pod: Pod) -> str:
    """Identity of the gang a pod belongs to ("" = not gang-scheduled)."""
    return pod.spec.workload_ref or pod.metadata.labels.get("scheduling.k8s.io/workload", "")


# ---------------------------------------------------------------------------
# Dynamic Resource Allocation (reference: staging/src/k8s.io/api/resource/
# v1/types.go — ResourceSlice, ResourceClaim with structured parameters;
# consumed by plugins/dynamicresources/, registry.go:48)


@dataclass(frozen=True)
class Device:
    """resource/v1 Device (basic): a named device with string attributes
    (the structured-parameters selector surface)."""

    name: str
    attributes: tuple[tuple[str, str], ...] = ()

    def attr(self, key: str) -> Optional[str]:
        for k, v in self.attributes:
            if k == key:
                return v
        return None


@dataclass
class ResourceSlice:
    """resource/v1 ResourceSlice: one node's published device pool for one
    driver (types.go ResourceSliceSpec: nodeName + driver + devices)."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    node_name: str = ""
    driver: str = ""
    devices: list[Device] = field(default_factory=list)

    @property
    def name(self) -> str:
        return self.metadata.name


@dataclass
class DeviceRequest:
    """resource/v1 DeviceRequest (exactly-count mode): ask `count` devices
    of `driver` whose attributes match every selector entry."""

    name: str = "req-0"
    driver: str = ""
    count: int = 1
    selectors: dict[str, str] = field(default_factory=dict)

    def matches(self, device: Device) -> bool:
        return all(device.attr(k) == v for k, v in self.selectors.items())


@dataclass
class DeviceAllocation:
    """resource/v1 AllocationResult (reduced): which devices on which node
    satisfied each request."""

    node_name: str = ""
    # request name → (driver, device name) tuples
    results: dict[str, tuple[tuple[str, str], ...]] = field(default_factory=dict)

    def device_ids(self) -> set[tuple[str, str, str]]:
        """(node, driver, device) ids this allocation occupies."""
        return {(self.node_name, drv, dev)
                for devs in self.results.values() for (drv, dev) in devs}


@dataclass
class ResourceClaim:
    """resource/v1 ResourceClaim: device requests + allocation status."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    requests: list[DeviceRequest] = field(default_factory=list)
    allocation: Optional[DeviceAllocation] = None   # status.allocation
    reserved_for: list[str] = field(default_factory=list)  # pod uids

    @property
    def name(self) -> str:
        return self.metadata.name

    @property
    def namespace(self) -> str:
        return self.metadata.namespace

    @property
    def uid(self) -> str:
        return self.metadata.uid


# ---------------------------------------------------------------------------
# PodDisruptionBudget (reference: staging/src/k8s.io/api/policy/v1/types.go
# PodDisruptionBudget; consumed by preemption's PDB-violating victim
# partition, pkg/scheduler/framework/preemption/preemption.go:658)


@dataclass
class PodDisruptionBudget:
    """policy/v1 PDB, the subset preemption reads: a selector over pods in
    the PDB's namespace plus one of min_available / max_unavailable
    (int or "N%" string). `disruptions_allowed` mirrors
    status.disruptionsAllowed and is computed by the API server's mini
    disruption controller at list time (the reference scheduler likewise
    trusts the controller-written status, preemption.go:700)."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    selector: Optional[LabelSelector] = None
    min_available: Optional[int | str] = None
    max_unavailable: Optional[int | str] = None
    disruptions_allowed: int = 0

    @property
    def name(self) -> str:
        return self.metadata.name

    @property
    def namespace(self) -> str:
        return self.metadata.namespace

    @property
    def uid(self) -> str:
        return self.metadata.uid

    def matches(self, pod: Pod) -> bool:
        if pod.metadata.namespace != self.metadata.namespace:
            return False
        if self.selector is None:
            return False  # nil selector matches no pods (policy/v1 semantics)
        return self.selector.matches(pod.metadata.labels)


def _resolve_maybe_percent(value: int | str, total: int,
                           round_up: bool = False) -> int:
    """IntOrString fields (GetScaledValueFromIntOrPercent): the disruption
    controller resolves percentage minAvailable with roundUp=true — a "50%"
    of 3 pods protects 2 — while maxUnavailable keeps the floor. Callers
    pick the direction."""
    if isinstance(value, str) and value.endswith("%"):
        pct = int(value[:-1]) * total
        return (pct + 99) // 100 if round_up else pct // 100
    return int(value)
