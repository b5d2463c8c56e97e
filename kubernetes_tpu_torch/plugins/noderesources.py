"""NodeResourcesFit + NodeResourcesBalancedAllocation (host/oracle path).

Algorithm parity with the reference:
- Filter: fitsRequest — pkg/scheduler/framework/plugins/noderesources/fit.go:649-738
- LeastAllocated: least_allocated.go:30-60 (int64 division, weighted)
- MostAllocated: most_allocated.go (mirror of least)
- RequestedToCapacityRatio: requested_to_capacity_ratio.go (piecewise-linear)
- BalancedAllocation: balanced_allocation.go:195-237 (std-dev of fractions)

The same arithmetic is implemented in tensor form in ops/program.py; these
host implementations are the decision-parity oracle the device program is
tested against.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

from ..api import resources as res
from ..api.types import Pod
from ..framework.interface import (MAX_NODE_SCORE, CycleState, PreFilterResult,
                                   Status)
from ..framework.types import NodeInfo

FIT_NAME = "NodeResourcesFit"
BALANCED_NAME = "NodeResourcesBalancedAllocation"

_PRE_FILTER_KEY = "PreFilter" + FIT_NAME
_PRE_SCORE_KEY = "PreScore" + FIT_NAME
_BALANCED_PRE_SCORE_KEY = "PreScore" + BALANCED_NAME


@dataclass(frozen=True)
class ResourceSpec:
    name: str
    weight: int = 1


DEFAULT_RESOURCES = (ResourceSpec(res.CPU, 1), ResourceSpec(res.MEMORY, 1))

LEAST_ALLOCATED = "LeastAllocated"
MOST_ALLOCATED = "MostAllocated"
REQUESTED_TO_CAPACITY_RATIO = "RequestedToCapacityRatio"


@dataclass(frozen=True)
class UtilizationShapePoint:
    utilization: int  # 0..100
    score: int        # 0..10 (maps onto 0..MaxNodeScore)


@dataclass
class FitArgs:
    scoring_strategy: str = LEAST_ALLOCATED
    resources: tuple[ResourceSpec, ...] = DEFAULT_RESOURCES
    ignored_resources: frozenset[str] = frozenset()
    ignored_resource_groups: frozenset[str] = frozenset()
    shape: tuple[UtilizationShapePoint, ...] = (
        UtilizationShapePoint(0, 0), UtilizationShapePoint(100, 10))


def is_extended_resource(name: str) -> bool:
    """Extended = has a domain prefix and isn't a native resource."""
    return "/" in name and not name.startswith("kubernetes.io/")


# ---------------------------------------------------------------------------
# scorers (exact int64 arithmetic of the reference)


def least_requested_score(requested: int, capacity: int) -> int:
    if capacity == 0 or requested > capacity:
        return 0
    return ((capacity - requested) * MAX_NODE_SCORE) // capacity


def most_requested_score(requested: int, capacity: int) -> int:
    """Reference: most_allocated.go mostRequestedScore."""
    if capacity == 0:
        return 0
    if requested > capacity:
        # `requested` might exceed `capacity` because pods with no requests
        # get non-zero default values.
        return 0
    return (requested * MAX_NODE_SCORE) // capacity


def _weighted(score_fn, requested: list[int], allocatable: list[int],
              resources: tuple[ResourceSpec, ...]) -> int:
    node_score, weight_sum = 0, 0
    for i in range(len(requested)):
        if allocatable[i] == 0:
            continue
        w = resources[i].weight
        node_score += score_fn(requested[i], allocatable[i]) * w
        weight_sum += w
    if weight_sum == 0:
        return 0
    return node_score // weight_sum


def requested_to_capacity_ratio_scorer(shape: tuple[UtilizationShapePoint, ...]):
    """Piecewise linear over utilization percent; scores scaled by
    MaxNodeScore/10 (reference: requested_to_capacity_ratio.go
    buildRequestedToCapacityRatioScorerFunction)."""
    xs = [p.utilization for p in shape]
    ys = [p.score * MAX_NODE_SCORE // 10 for p in shape]

    def curve(utilization: int) -> int:
        if utilization <= xs[0]:
            return ys[0]
        if utilization >= xs[-1]:
            return ys[-1]
        for i in range(1, len(xs)):
            if utilization < xs[i]:
                span = xs[i] - xs[i - 1]
                return ys[i - 1] + (ys[i] - ys[i - 1]) * (utilization - xs[i - 1]) // span
        return ys[-1]

    def scorer(requested: list[int], allocatable: list[int],
               resources: tuple[ResourceSpec, ...]) -> int:
        node_score, weight_sum = 0, 0
        for i in range(len(requested)):
            if allocatable[i] == 0:
                continue
            w = resources[i].weight
            util = min(requested[i] * 100 // allocatable[i], 100) if allocatable[i] else 0
            node_score += curve(util) * w
            weight_sum += w
        if weight_sum == 0:
            return 0
        return node_score // weight_sum

    return scorer


def balanced_resource_scorer(requested: list[int], allocatable: list[int]) -> int:
    """Reference: balanced_allocation.go:195-237."""
    fractions: list[float] = []
    total = 0.0
    for i in range(len(requested)):
        if allocatable[i] == 0:
            continue
        f = min(requested[i] / allocatable[i], 1.0)
        total += f
        fractions.append(f)
    std = 0.0
    if len(fractions) == 2:
        std = abs((fractions[0] - fractions[1]) / 2)
    elif len(fractions) > 2:
        mean = total / len(fractions)
        std = math.sqrt(sum((f - mean) ** 2 for f in fractions) / len(fractions))
    return int((1 - std) * MAX_NODE_SCORE)


# ---------------------------------------------------------------------------
# shared score-side helpers


def pod_resource_request_list(pod: Pod, resources: tuple[ResourceSpec, ...],
                              use_requested: bool) -> list[int]:
    req = res.pod_requests(pod) if use_requested else res.pod_requests_nonmissing(pod)
    return [req.get(spec.name, 0) for spec in resources]


def _allocatable_and_requested(node_info: NodeInfo, name: str, pod_request: int,
                               use_requested: bool) -> tuple[int, int]:
    """Reference: resource_allocation.go calculateResourceAllocatableRequest."""
    if pod_request == 0 and name not in (res.CPU, res.MEMORY, res.EPHEMERAL_STORAGE):
        # scalar resource the pod doesn't request → bypass
        return 0, 0
    alloc = node_info.allocatable.get(name, 0)
    if name == res.CPU and not use_requested:
        req = node_info.non_zero_cpu
    elif name == res.MEMORY and not use_requested:
        req = node_info.non_zero_mem
    else:
        req = node_info.requested.get(name, 0)
    return alloc, req + pod_request


def _score(node_info: NodeInfo, pod_requests: list[int],
           resources: tuple[ResourceSpec, ...], use_requested: bool,
           scorer) -> int:
    requested = [0] * len(resources)
    allocatable = [0] * len(resources)
    for i, spec in enumerate(resources):
        alloc, req = _allocatable_and_requested(node_info, spec.name,
                                                pod_requests[i], use_requested)
        if alloc == 0:
            continue
        allocatable[i] = alloc
        requested[i] = req
    return scorer(requested, allocatable)


# ---------------------------------------------------------------------------
# Fit plugin


class Fit:
    """PF, F, PS, S, EE, Sg — reference fit.go."""

    def __init__(self, args: Optional[FitArgs] = None):
        self.args = args or FitArgs()
        if self.args.scoring_strategy == REQUESTED_TO_CAPACITY_RATIO:
            curve = requested_to_capacity_ratio_scorer(self.args.shape)
            self._scorer = lambda r, a: curve(r, a, self.args.resources)
        elif self.args.scoring_strategy == MOST_ALLOCATED:
            self._scorer = lambda r, a: _weighted(most_requested_score, r, a, self.args.resources)
        else:
            self._scorer = lambda r, a: _weighted(least_requested_score, r, a, self.args.resources)

    def name(self) -> str:
        return FIT_NAME

    # -- PreFilter ----------------------------------------------------------

    def pre_filter(self, state: CycleState, pod: Pod, nodes) -> tuple[Optional[PreFilterResult], Status]:
        state.write(_PRE_FILTER_KEY, res.pod_requests(pod))
        return None, Status.success()

    def filter(self, state: CycleState, pod: Pod, node_info: NodeInfo) -> Status:
        pod_request: dict[str, int] = state.read_or_none(_PRE_FILTER_KEY)
        if pod_request is None:
            pod_request = res.pod_requests(pod)
        insufficient = insufficient_resources(pod_request, node_info,
                                              self.args.ignored_resources,
                                              self.args.ignored_resource_groups)
        if insufficient:
            reasons = tuple(r for r, _ in insufficient)
            if any(unresolvable for _, unresolvable in insufficient):
                return Status.unresolvable(*reasons, plugin=FIT_NAME)
            return Status.unschedulable(*reasons, plugin=FIT_NAME)
        return Status.success()

    # -- Score --------------------------------------------------------------

    def pre_score(self, state: CycleState, pod: Pod, nodes, all_nodes=None) -> Status:
        state.write(_PRE_SCORE_KEY,
                    pod_resource_request_list(pod, self.args.resources, use_requested=False))
        return Status.success()

    def score(self, state: CycleState, pod: Pod, node_info: NodeInfo) -> tuple[int, Status]:
        reqs = state.read_or_none(_PRE_SCORE_KEY)
        if reqs is None:
            reqs = pod_resource_request_list(pod, self.args.resources, use_requested=False)
        return _score(node_info, reqs, self.args.resources, False, self._scorer), Status.success()

    def normalize_scores(self, state, pod, scores, node_names=None) -> Status:
        return Status.success()

    def events_to_register(self):
        """fit.go EventsToRegister + isSchedulableAfterNodeChange /
        isSchedulableAfterPodEvent: node arrivals or allocatable growth
        queue only when the pod's requests could fit the node outright;
        an assigned pod's deletion queues only when it releases a resource
        this pod asks for."""
        from ..backend.queue import ClusterEventWithHint
        from ..framework.types import (ActionType, ClusterEvent,
                                       EventResource, QueueingHint)

        def after_node_change(pod: Pod, old, new):
            if new is None:
                return QueueingHint.QUEUE
            requests = res.pod_requests(pod)
            alloc = new.status.allocatable
            for r, v in requests.items():
                if v > 0 and v > alloc.get(r, 0):
                    return QueueingHint.SKIP
            if alloc.get(res.PODS, 1) < 1:
                return QueueingHint.SKIP
            return QueueingHint.QUEUE

        def after_pod_event(pod: Pod, old, new):
            # DELETE of an assigned pod (old=pod, new=None) frees its whole
            # request; a scale-down frees only the old−new delta. Queue
            # only when a freed resource overlaps one this pod asks for.
            if old is None:
                return QueueingHint.QUEUE
            freed = dict(res.pod_requests(old))
            if new is not None:
                for r, v in res.pod_requests(new).items():
                    freed[r] = freed.get(r, 0) - v
            mine = res.pod_requests(pod)
            for r, v in mine.items():
                if v > 0 and freed.get(r, 0) > 0:
                    return QueueingHint.QUEUE
            # a deletion also frees a pod-count slot; only relevant when
            # the pod requests nothing else
            return (QueueingHint.QUEUE
                    if new is None and not any(mine.values())
                    else QueueingHint.SKIP)

        return [
            ClusterEventWithHint(
                ClusterEvent(EventResource.NODE,
                             ActionType.ADD | ActionType.UPDATE_NODE_ALLOCATABLE),
                after_node_change),
            ClusterEventWithHint(
                ClusterEvent(EventResource.ASSIGNED_POD,
                             ActionType.DELETE | ActionType.UPDATE_POD_SCALE_DOWN),
                after_pod_event),
        ]

def insufficient_resources(pod_request: dict[str, int], node_info: NodeInfo,
                           ignored: frozenset[str] = frozenset(),
                           ignored_groups: frozenset[str] = frozenset(),
                           ) -> list[tuple[str, bool]]:
    """fitsRequest (fit.go:649-738) → [(reason, unresolvable)]."""
    out: list[tuple[str, bool]] = []
    allowed_pods = node_info.allocatable.get(res.PODS, 0)
    if len(node_info.pods) + 1 > allowed_pods:
        out.append(("Too many pods", False))

    interesting = {k: v for k, v in pod_request.items() if k != res.PODS}
    if all(v == 0 for v in interesting.values()):
        return out

    for name in (res.CPU, res.MEMORY, res.EPHEMERAL_STORAGE):
        req = pod_request.get(name, 0)
        if req <= 0:
            continue
        alloc = node_info.allocatable.get(name, 0)
        used = node_info.requested.get(name, 0)
        if req > alloc - used:
            out.append((f"Insufficient {name}", req > alloc))

    for name, req in pod_request.items():
        if name in (res.CPU, res.MEMORY, res.EPHEMERAL_STORAGE, res.PODS) or req == 0:
            continue
        if is_extended_resource(name):
            prefix = name.split("/")[0]
            if name in ignored or prefix in ignored_groups:
                continue
        alloc = node_info.allocatable.get(name, 0)
        used = node_info.requested.get(name, 0)
        if req > alloc - used:
            out.append((f"Insufficient {name}", req > alloc))
    return out


# ---------------------------------------------------------------------------
# BalancedAllocation plugin


@dataclass
class BalancedAllocationArgs:
    resources: tuple[ResourceSpec, ...] = DEFAULT_RESOURCES


class BalancedAllocation:
    """PS, S — reference balanced_allocation.go. useRequested=true."""

    def __init__(self, args: Optional[BalancedAllocationArgs] = None):
        self.args = args or BalancedAllocationArgs()

    def name(self) -> str:
        return BALANCED_NAME

    def pre_score(self, state: CycleState, pod: Pod, nodes, all_nodes=None) -> Status:
        reqs = pod_resource_request_list(pod, self.args.resources, use_requested=True)
        if all(r == 0 for r in reqs):
            # best-effort pod: skip to avoid piling onto one node
            # (reference balanced_allocation.go:84 → issue #129138)
            return Status.skip()
        state.write(_BALANCED_PRE_SCORE_KEY, reqs)
        return Status.success()

    def score(self, state: CycleState, pod: Pod, node_info: NodeInfo) -> tuple[int, Status]:
        reqs = state.read_or_none(_BALANCED_PRE_SCORE_KEY)
        if reqs is None:
            reqs = pod_resource_request_list(pod, self.args.resources, use_requested=True)
            if all(r == 0 for r in reqs):
                return 0, Status.success()
        score = _score(node_info, reqs, self.args.resources, True,
                       lambda r, a: balanced_resource_scorer(r, a))
        return score, Status.success()

    def normalize_scores(self, state, pod, scores, node_names=None) -> Status:
        return Status.success()

