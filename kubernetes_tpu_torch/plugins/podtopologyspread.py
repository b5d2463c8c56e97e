"""PodTopologySpread plugin (host/oracle path).

Algorithm parity with the reference (pkg/scheduler/framework/plugins/
podtopologyspread/):
- PreFilter/Filter: filtering.go — per-constraint match counts per topology
  value, two-entry criticalPaths min tracking (filtering.go:97-136), skew
  judgment `matchNum + selfMatch - minMatchNum > maxSkew` (filtering.go:338-356),
  minDomains treating the global min as 0 when domains < minDomains
  (filtering.go:66-77).
- AddPod/RemovePod PreFilterExtensions for preemption dry-runs
  (filtering.go:156-214).
- PreScore/Score/Normalize: scoring.go — counts over all nodes restricted to
  filtered-node topology values, score = cnt·log(size+2) + (maxSkew−1)
  (scoring.go:297-307), normalize = MaxNodeScore·(max+min−s)/max
  (scoring.go:229-267).

Node inclusion policies (NodeAffinityPolicy default Honor, NodeTaintsPolicy
default Ignore — common.go:108-123) are always enabled, matching the
reference's GA feature-gate state.

The tensor form of this plugin lives in ops/groups.py: the count maps become
a (constraints × topology-values) matrix, criticalPaths a min-reduce, and the
scan-carried state updates the counts after each placement.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Optional

from ..api.types import (LabelSelector, Pod, TopologySpreadConstraint,
                         UnsatisfiableConstraintAction)
from ..framework.interface import (MAX_NODE_SCORE, CycleState, PreFilterResult,
                                   Status)
from ..framework.types import NodeInfo, PodInfo
from .nodeaffinity import required_node_affinity_matches
from .node_basics import find_matching_untolerated_taint

NAME = "PodTopologySpread"
LABEL_HOSTNAME = "kubernetes.io/hostname"
LABEL_ZONE = "topology.kubernetes.io/zone"

ERR_REASON_CONSTRAINTS_NOT_MATCH = "node(s) didn't match pod topology spread constraints"
ERR_REASON_NODE_LABEL_NOT_MATCH = (
    ERR_REASON_CONSTRAINTS_NOT_MATCH + " (missing required label)")

_PRE_FILTER_KEY = "PreFilter" + NAME
_PRE_SCORE_KEY = "PreScore" + NAME

_MAX_INT32 = 2 ** 31 - 1

HONOR = "Honor"
IGNORE = "Ignore"

# System default constraints used when the pod declares none
# (reference: apis/config/v1/defaults.go SetDefaults_KubeSchedulerConfiguration
# → defaultConstraints maxSkew 3 zone / 5 hostname, ScheduleAnyway).
SYSTEM_DEFAULT_CONSTRAINTS = (
    TopologySpreadConstraint(max_skew=3, topology_key=LABEL_ZONE,
                             when_unsatisfiable=UnsatisfiableConstraintAction.SCHEDULE_ANYWAY.value),
    TopologySpreadConstraint(max_skew=5, topology_key=LABEL_HOSTNAME,
                             when_unsatisfiable=UnsatisfiableConstraintAction.SCHEDULE_ANYWAY.value),
)


@dataclass
class _Constraint:
    """Internal parsed constraint (reference common.go:34-41)."""

    max_skew: int
    topology_key: str
    selector: LabelSelector
    min_domains: int = 1
    node_affinity_policy: str = HONOR
    node_taints_policy: str = IGNORE


def _parse_constraints(constraints, pod_labels: dict[str, str], action: str,
                       match_label_keys_enabled: bool = True) -> list[_Constraint]:
    """filterTopologySpreadConstraints (common.go:87-128): keep constraints
    with the requested action; merge matchLabelKeys values into the selector."""
    out: list[_Constraint] = []
    for c in constraints:
        if c.when_unsatisfiable != action:
            continue
        selector = c.label_selector or LabelSelector()
        if match_label_keys_enabled and c.match_label_keys:
            extra = {k: pod_labels[k] for k in c.match_label_keys if k in pod_labels}
            if extra:
                merged = dict(selector.match_labels)
                merged.update(extra)
                selector = LabelSelector(
                    match_labels=tuple(sorted(merged.items())),
                    match_expressions=selector.match_expressions)
        out.append(_Constraint(
            max_skew=c.max_skew,
            topology_key=c.topology_key,
            selector=selector,
            min_domains=c.min_domains if c.min_domains is not None else 1,
            node_affinity_policy=c.node_affinity_policy or HONOR,
            node_taints_policy=c.node_taints_policy or IGNORE,
        ))
    return out


def _selector_empty(sel: LabelSelector) -> bool:
    return not sel.match_labels and not sel.match_expressions


def _count_pods_match_selector(pod_infos: list[PodInfo], selector: LabelSelector,
                               ns: str) -> int:
    """common.go:145-160 — empty selector matches nothing; namespace-scoped."""
    if _selector_empty(selector):
        return 0
    count = 0
    for pi in pod_infos:
        pod = pi.pod
        if pod.namespace != ns:
            continue
        if selector.matches(pod.metadata.labels):
            count += 1
    return count


def _node_has_all_topology_keys(node_labels: dict[str, str],
                                constraints: list[_Constraint]) -> bool:
    return all(c.topology_key in node_labels for c in constraints)


def _match_node_inclusion_policies(c: _Constraint, pod: Pod, node_info: NodeInfo) -> bool:
    """common.go:43-57."""
    node = node_info.node
    if c.node_affinity_policy == HONOR:
        if not required_node_affinity_matches(pod, node.metadata.labels, node.name):
            return False
    if c.node_taints_policy == HONOR:
        if find_matching_untolerated_taint(
                node.spec.taints, pod.spec.tolerations,
                ("NoSchedule", "NoExecute")) is not None:
            return False
    return True


class _CriticalPaths:
    """Two-entry min tracker (filtering.go:97-136). paths[0] holds the true
    minimum; paths[1] is ≥ paths[0] but not necessarily the 2nd minimum."""

    __slots__ = ("v0", "n0", "v1", "n1")

    def __init__(self) -> None:
        self.v0, self.n0 = None, _MAX_INT32
        self.v1, self.n1 = None, _MAX_INT32

    def copy(self) -> "_CriticalPaths":
        cp = _CriticalPaths()
        cp.v0, cp.n0, cp.v1, cp.n1 = self.v0, self.n0, self.v1, self.n1
        return cp

    def update(self, tp_val: str, num: int) -> None:
        if tp_val == self.v0:
            self.n0 = num
            if self.n0 > self.n1:
                self.v0, self.n0, self.v1, self.n1 = self.v1, self.n1, self.v0, self.n0
        elif tp_val == self.v1:
            self.n1 = num
            if self.n0 > self.n1:
                self.v0, self.n0, self.v1, self.n1 = self.v1, self.n1, self.v0, self.n0
        elif num < self.n0:
            self.v1, self.n1 = self.v0, self.n0
            self.v0, self.n0 = tp_val, num
        elif num < self.n1:
            self.v1, self.n1 = tp_val, num

    def min_match(self) -> int:
        return self.n0


@dataclass
class _PreFilterState:
    constraints: list[_Constraint] = field(default_factory=list)
    critical_paths: list[_CriticalPaths] = field(default_factory=list)
    tp_value_to_match_num: list[dict[str, int]] = field(default_factory=list)

    def clone(self) -> "_PreFilterState":
        """filtering.go preFilterState.Clone() — mutable counts copied,
        parsed constraints shared (immutable)."""
        return _PreFilterState(
            constraints=self.constraints,
            critical_paths=[cp.copy() for cp in self.critical_paths],
            tp_value_to_match_num=[dict(d) for d in self.tp_value_to_match_num])

    def min_match_num(self, i: int, min_domains: int) -> int:
        """filtering.go:66-77 — fewer eligible domains than minDomains ⇒
        treat the global minimum as 0."""
        if len(self.tp_value_to_match_num[i]) < min_domains:
            return 0
        return self.critical_paths[i].min_match()


@dataclass
class _PreScoreState:
    constraints: list[_Constraint] = field(default_factory=list)
    ignored_nodes: set[str] = field(default_factory=set)
    topology_value_to_pod_counts: list[dict[str, int]] = field(default_factory=list)
    topology_normalizing_weight: list[float] = field(default_factory=list)


@dataclass
class PodTopologySpreadArgs:
    default_constraints: tuple[TopologySpreadConstraint, ...] = ()
    # "System" defaulting uses cluster-level defaults and relaxed topology
    # requirements in scoring (reference plugin.go systemDefaulted).
    defaulting_type: str = "List"  # "List" | "System"


class PodTopologySpread:
    """PF(+Extensions), F, PS, S, N, EE, Sg — reference podtopologyspread/."""

    def __init__(self, args: Optional[PodTopologySpreadArgs] = None):
        self.args = args or PodTopologySpreadArgs()
        self.system_defaulted = self.args.defaulting_type == "System"
        self.default_constraints = (
            SYSTEM_DEFAULT_CONSTRAINTS if self.system_defaulted
            else self.args.default_constraints)

    def name(self) -> str:
        return NAME

    # -- constraint selection -------------------------------------------------

    def _get_constraints(self, pod: Pod, action: str) -> list[_Constraint]:
        if pod.spec.topology_spread_constraints:
            return _parse_constraints(pod.spec.topology_spread_constraints,
                                      pod.metadata.labels, action)
        constraints = _parse_constraints(self.default_constraints,
                                         pod.metadata.labels, action)
        if not constraints:
            return []
        # buildDefaultConstraints uses the owning workload's selector
        # (common.go:62-75). We have no service/RS listers in the in-memory
        # model; use the pod's own labels as the selector, which is what the
        # workload selector resolves to for homogeneous groups.
        selector = LabelSelector.of(dict(pod.metadata.labels))
        if _selector_empty(selector):
            return []
        return [replace(c, selector=selector) for c in constraints]

    # -- PreFilter ------------------------------------------------------------

    def pre_filter(self, state: CycleState, pod: Pod, nodes: list[NodeInfo]
                   ) -> tuple[Optional[PreFilterResult], Status]:
        constraints = self._get_constraints(
            pod, UnsatisfiableConstraintAction.DO_NOT_SCHEDULE.value)
        if not constraints:
            return None, Status.skip()
        s = _PreFilterState(constraints=constraints)
        s.tp_value_to_match_num = [dict() for _ in constraints]
        for ni in nodes:
            node = ni.node
            if not _node_has_all_topology_keys(node.metadata.labels, constraints):
                continue
            for i, c in enumerate(constraints):
                if not _match_node_inclusion_policies(c, pod, ni):
                    continue
                value = node.metadata.labels[c.topology_key]
                count = _count_pods_match_selector(ni.pods, c.selector, pod.namespace)
                s.tp_value_to_match_num[i][value] = (
                    s.tp_value_to_match_num[i].get(value, 0) + count)
        s.critical_paths = [_CriticalPaths() for _ in constraints]
        for i in range(len(constraints)):
            for value, num in s.tp_value_to_match_num[i].items():
                s.critical_paths[i].update(value, num)
        state.write(_PRE_FILTER_KEY, s)
        return None, Status.success()

    def events_to_register(self):
        """podtopologyspread.go EventsToRegister: assigned-pod churn in the
        pod's namespace matching a spread selector moves its counts; node
        add / label change can alter the topology domains."""
        from ..api.types import UnsatisfiableConstraintAction as UCA
        from ..backend.queue import ClusterEventWithHint
        from ..framework.types import (ActionType, ClusterEvent,
                                       EventResource, QueueingHint)

        def after_pod_change(pod: Pod, old, new):
            other = new if new is not None else old
            if other is None:
                return QueueingHint.QUEUE
            if other.namespace != pod.namespace:
                return QueueingHint.SKIP
            constraints = (self._get_constraints(pod, UCA.DO_NOT_SCHEDULE.value)
                           + self._get_constraints(pod, UCA.SCHEDULE_ANYWAY.value))
            for c in constraints:
                for cand in (old, new):
                    if (cand is not None
                            and c.selector.matches(cand.metadata.labels)):
                        return QueueingHint.QUEUE
            return QueueingHint.SKIP

        return [
            ClusterEventWithHint(
                ClusterEvent(EventResource.ASSIGNED_POD,
                             ActionType.ADD | ActionType.DELETE
                             | ActionType.UPDATE_POD_LABEL),
                after_pod_change),
            ClusterEventWithHint(
                ClusterEvent(EventResource.NODE,
                             ActionType.ADD | ActionType.UPDATE_NODE_LABEL),
                None),
        ]

    # -- PreFilterExtensions (preemption dry-run support) ---------------------

    def add_pod(self, state: CycleState, pod_to_schedule: Pod,
                pod_info_to_add: PodInfo, node_info: NodeInfo) -> Status:
        self._update_with_pod(state, pod_info_to_add.pod, pod_to_schedule,
                              node_info, +1)
        return Status.success()

    def remove_pod(self, state: CycleState, pod_to_schedule: Pod,
                   pod_info_to_remove: PodInfo, node_info: NodeInfo) -> Status:
        self._update_with_pod(state, pod_info_to_remove.pod, pod_to_schedule,
                              node_info, -1)
        return Status.success()

    def _update_with_pod(self, state: CycleState, updated_pod: Pod,
                         preemptor: Pod, node_info: NodeInfo, delta: int) -> None:
        s: Optional[_PreFilterState] = state.read_or_none(_PRE_FILTER_KEY)
        if s is None or updated_pod.namespace != preemptor.namespace:
            return
        node = node_info.node
        if not _node_has_all_topology_keys(node.metadata.labels, s.constraints):
            return
        for i, c in enumerate(s.constraints):
            if not c.selector.matches(updated_pod.metadata.labels):
                continue
            if not _match_node_inclusion_policies(c, preemptor, node_info):
                continue
            v = node.metadata.labels[c.topology_key]
            s.tp_value_to_match_num[i][v] = s.tp_value_to_match_num[i].get(v, 0) + delta
            s.critical_paths[i].update(v, s.tp_value_to_match_num[i][v])

    # -- Filter ---------------------------------------------------------------

    def filter(self, state: CycleState, pod: Pod, node_info: NodeInfo) -> Status:
        s: Optional[_PreFilterState] = state.read_or_none(_PRE_FILTER_KEY)
        if s is None or not s.constraints:
            return Status.success()
        node = node_info.node
        for i, c in enumerate(s.constraints):
            tp_val = node.metadata.labels.get(c.topology_key)
            if tp_val is None:
                return Status.unresolvable(ERR_REASON_NODE_LABEL_NOT_MATCH,
                                           plugin=NAME)
            min_match = s.min_match_num(i, c.min_domains)
            self_match = 1 if c.selector.matches(pod.metadata.labels) else 0
            match_num = s.tp_value_to_match_num[i].get(tp_val, 0)
            if match_num + self_match - min_match > c.max_skew:
                return Status.unschedulable(ERR_REASON_CONSTRAINTS_NOT_MATCH,
                                            plugin=NAME)
        return Status.success()

    # -- PreScore / Score / Normalize ----------------------------------------

    def pre_score(self, state: CycleState, pod: Pod,
                  filtered_nodes: list[NodeInfo],
                  all_nodes: Optional[list[NodeInfo]] = None) -> Status:
        all_nodes = all_nodes if all_nodes is not None else filtered_nodes
        if not all_nodes:
            return Status.skip()
        constraints = self._get_constraints(
            pod, UnsatisfiableConstraintAction.SCHEDULE_ANYWAY.value)
        if not constraints:
            return Status.skip()
        require_all = bool(pod.spec.topology_spread_constraints) or not self.system_defaulted

        s = _PreScoreState(constraints=constraints)
        s.topology_value_to_pod_counts = [dict() for _ in constraints]
        topo_size = [0] * len(constraints)
        for ni in filtered_nodes:
            labels = ni.node.metadata.labels
            if require_all and not _node_has_all_topology_keys(labels, constraints):
                s.ignored_nodes.add(ni.name)
                continue
            for i, c in enumerate(constraints):
                if c.topology_key == LABEL_HOSTNAME:
                    continue
                value = labels.get(c.topology_key, "")
                if value not in s.topology_value_to_pod_counts[i]:
                    s.topology_value_to_pod_counts[i][value] = 0
                    topo_size[i] += 1
        for i, c in enumerate(constraints):
            sz = topo_size[i]
            if c.topology_key == LABEL_HOSTNAME:
                sz = len(filtered_nodes) - len(s.ignored_nodes)
            s.topology_normalizing_weight.append(math.log(sz + 2))

        # accumulate counts over ALL nodes whose topology value is eligible
        # (scoring.go:155-193)
        for ni in all_nodes:
            labels = ni.node.metadata.labels
            if require_all and not _node_has_all_topology_keys(labels, constraints):
                continue
            for i, c in enumerate(constraints):
                if not _match_node_inclusion_policies(c, pod, ni):
                    continue
                value = labels.get(c.topology_key, "")
                if value not in s.topology_value_to_pod_counts[i]:
                    continue
                count = _count_pods_match_selector(ni.pods, c.selector, pod.namespace)
                s.topology_value_to_pod_counts[i][value] += count
        state.write(_PRE_SCORE_KEY, s)
        return Status.success()

    def score(self, state: CycleState, pod: Pod, node_info: NodeInfo
              ) -> tuple[int, Status]:
        s: Optional[_PreScoreState] = state.read_or_none(_PRE_SCORE_KEY)
        if s is None:
            return 0, Status.success()
        if node_info.name in s.ignored_nodes:
            return 0, Status.success()
        labels = node_info.node.metadata.labels
        score = 0.0
        for i, c in enumerate(s.constraints):
            tp_val = labels.get(c.topology_key)
            if tp_val is None:
                continue
            if c.topology_key == LABEL_HOSTNAME:
                cnt = _count_pods_match_selector(node_info.pods, c.selector, pod.namespace)
            else:
                cnt = s.topology_value_to_pod_counts[i].get(tp_val, 0)
            score += cnt * s.topology_normalizing_weight[i] + (c.max_skew - 1)
        return round(score), Status.success()

    def normalize_scores(self, state: CycleState, pod: Pod,
                         scores: list[int],
                         node_names: Optional[list[str]] = None) -> Status:
        """scoring.go:229-267. `scores` is mutated in place; node_names (if
        given) is parallel to scores for the IgnoredNodes lookup."""
        s: Optional[_PreScoreState] = state.read_or_none(_PRE_SCORE_KEY)
        if s is None:
            return Status.success()
        names = node_names or [""] * len(scores)
        INVALID = -1
        min_score, max_score = _MAX_INT32, 0
        for i in range(len(scores)):
            if names[i] in s.ignored_nodes:
                scores[i] = INVALID
                continue
            min_score = min(min_score, scores[i])
            max_score = max(max_score, scores[i])
        for i in range(len(scores)):
            if scores[i] == INVALID:
                scores[i] = 0
                continue
            if max_score == 0:
                scores[i] = MAX_NODE_SCORE
                continue
            scores[i] = MAX_NODE_SCORE * (max_score + min_score - scores[i]) // max_score
        return Status.success()

    # -- signature ------------------------------------------------------------

