"""The small node-predicate plugins: NodeName, NodeUnschedulable,
TaintToleration, NodePorts, SchedulingGates, PrioritySort.

Reference directories under pkg/scheduler/framework/plugins/:
nodename/node_name.go, nodeunschedulable/node_unschedulable.go,
tainttoleration/taint_toleration.go, nodeports/node_ports.go,
schedulinggates/scheduling_gates.go, queuesort/priority_sort.go.
"""

from __future__ import annotations

from typing import Optional

from ..api.types import Pod, Taint, TaintEffect, Toleration
from ..framework.interface import CycleState, PreFilterResult, Status
from ..framework.types import NodeInfo, QueuedPodInfo
from .helper import default_normalize

NODE_NAME = "NodeName"
NODE_UNSCHEDULABLE = "NodeUnschedulable"
TAINT_TOLERATION = "TaintToleration"
NODE_PORTS = "NodePorts"
SCHEDULING_GATES = "SchedulingGates"
PRIORITY_SORT = "PrioritySort"

_PORTS_PRE_FILTER_KEY = "PreFilter" + NODE_PORTS
_TAINT_PRE_SCORE_KEY = "PreScore" + TAINT_TOLERATION


def _hint_events():
    from ..backend.queue import ClusterEventWithHint
    from ..framework.types import ActionType, ClusterEvent, EventResource
    return ClusterEventWithHint, ActionType, ClusterEvent, EventResource


class NodeName:
    """F, Sg — nodename/node_name.go: pod.Spec.NodeName must equal node name."""

    def name(self) -> str:
        return NODE_NAME

    def filter(self, state: CycleState, pod: Pod, node_info: NodeInfo) -> Status:
        if pod.spec.node_name and pod.spec.node_name != node_info.name:
            return Status.unresolvable(
                "node(s) didn't match the requested node name", plugin=NODE_NAME)
        return Status.success()

    def events_to_register(self):
        """node_name.go EventsToRegister: only the arrival of the named
        node can help."""
        CEWH, AT, CE, ER = _hint_events()

        def after_node_add(pod: Pod, old, new):
            from ..framework.types import QueueingHint
            if new is not None and pod.spec.node_name == new.metadata.name:
                return QueueingHint.QUEUE
            return QueueingHint.SKIP

        return [CEWH(CE(ER.NODE, AT.ADD), after_node_add)]



class NodeUnschedulable:
    """F, EE, Sg — node_unschedulable.go: reject unschedulable nodes unless
    the pod tolerates the node.kubernetes.io/unschedulable:NoSchedule taint."""

    TAINT = Taint(key="node.kubernetes.io/unschedulable", value="",
                  effect=TaintEffect.NO_SCHEDULE.value)

    def name(self) -> str:
        return NODE_UNSCHEDULABLE

    def filter(self, state: CycleState, pod: Pod, node_info: NodeInfo) -> Status:
        if not node_info.node.spec.unschedulable:
            return Status.success()
        if any(t.tolerates(self.TAINT) for t in pod.spec.tolerations):
            return Status.success()
        return Status.unresolvable("node(s) were unschedulable", plugin=NODE_UNSCHEDULABLE)

    def events_to_register(self):
        """node_unschedulable.go isSchedulableAfterNodeChange: only a node
        that is (now) schedulable — or whose cordon the pod tolerates —
        can help. Cordon flips arrive as UPDATE_NODE_TAINT (the reference
        maps spec.unschedulable to the taint event)."""
        CEWH, AT, CE, ER = _hint_events()

        def after_node_change(pod: Pod, old, new):
            from ..framework.types import QueueingHint
            if new is None:
                return QueueingHint.QUEUE
            if (not new.spec.unschedulable
                    or any(t.tolerates(self.TAINT)
                           for t in pod.spec.tolerations)):
                return QueueingHint.QUEUE
            return QueueingHint.SKIP

        return [CEWH(CE(ER.NODE, AT.ADD | AT.UPDATE_NODE_TAINT),
                     after_node_change)]

def find_matching_untolerated_taint(taints: list[Taint], tolerations: list[Toleration],
                                    effects: tuple[str, ...]) -> Optional[Taint]:
    """Reference: component-helpers v1helper.FindMatchingUntoleratedTaint."""
    for taint in taints:
        if taint.effect not in effects:
            continue
        if not any(t.tolerates(taint) for t in tolerations):
            return taint
    return None


class TaintToleration:
    """PF?, F, PS, S, N, EE, Sg — taint_toleration.go.

    Filter: untolerated NoSchedule/NoExecute taint ⇒ UnschedulableAndUnresolvable.
    Score: count of untolerated PreferNoSchedule taints, normalized reversed.
    """

    FILTER_EFFECTS = (TaintEffect.NO_SCHEDULE.value, TaintEffect.NO_EXECUTE.value)

    def name(self) -> str:
        return TAINT_TOLERATION

    def filter(self, state: CycleState, pod: Pod, node_info: NodeInfo) -> Status:
        taint = find_matching_untolerated_taint(
            node_info.node.spec.taints, pod.spec.tolerations, self.FILTER_EFFECTS)
        if taint is not None:
            return Status.unresolvable(
                f"node(s) had untolerated taint {{{taint.key}: {taint.value}}}",
                plugin=TAINT_TOLERATION)
        return Status.success()

    def pre_score(self, state: CycleState, pod: Pod, nodes, all_nodes=None) -> Status:
        prefer_tolerations = [t for t in pod.spec.tolerations
                              if not t.effect or t.effect == TaintEffect.PREFER_NO_SCHEDULE.value]
        state.write(_TAINT_PRE_SCORE_KEY, prefer_tolerations)
        return Status.success()

    def score(self, state: CycleState, pod: Pod, node_info: NodeInfo) -> tuple[int, Status]:
        tolerations = state.read_or_none(_TAINT_PRE_SCORE_KEY)
        if tolerations is None:
            tolerations = [t for t in pod.spec.tolerations
                           if not t.effect or t.effect == TaintEffect.PREFER_NO_SCHEDULE.value]
        count = sum(
            1 for taint in node_info.node.spec.taints
            if taint.effect == TaintEffect.PREFER_NO_SCHEDULE.value
            and not any(t.tolerates(taint) for t in tolerations))
        return count, Status.success()

    def normalize_scores(self, state: CycleState, pod: Pod, scores: list[int],
                         node_names=None) -> Status:
        scores[:] = default_normalize(scores, reverse=True)
        return Status.success()

    def events_to_register(self):
        """taint_toleration.go isSchedulableAfterNodeChange: queue only
        when the pod tolerates the (new) node's hard taints — e.g. a
        taint removal."""
        CEWH, AT, CE, ER = _hint_events()

        def after_node_change(pod: Pod, old, new):
            from ..framework.types import QueueingHint
            if new is None:
                return QueueingHint.QUEUE
            taint = find_matching_untolerated_taint(
                new.spec.taints, pod.spec.tolerations, self.FILTER_EFFECTS)
            return (QueueingHint.SKIP if taint is not None
                    else QueueingHint.QUEUE)

        return [CEWH(CE(ER.NODE, AT.ADD | AT.UPDATE_NODE_TAINT),
                     after_node_change)]



class NodePorts:
    """PF, F, EE, Sg — node_ports.go: host-port conflicts."""

    def name(self) -> str:
        return NODE_PORTS

    @staticmethod
    def _container_ports(pod: Pod):
        return [p for c in pod.spec.containers for p in c.ports if p.host_port > 0]

    def pre_filter(self, state: CycleState, pod: Pod, nodes) -> tuple[Optional[PreFilterResult], Status]:
        ports = self._container_ports(pod)
        state.write(_PORTS_PRE_FILTER_KEY, ports)
        if not ports:
            return None, Status.skip()
        return None, Status.success()

    def filter(self, state: CycleState, pod: Pod, node_info: NodeInfo) -> Status:
        ports = state.read_or_none(_PORTS_PRE_FILTER_KEY)
        if ports is None:
            ports = self._container_ports(pod)
        for p in ports:
            if node_info.used_ports.conflicts(p.protocol, p.host_port, p.host_ip):
                return Status.unschedulable("node(s) didn't have free ports for the requested pod ports",
                                            plugin=NODE_PORTS)
        return Status.success()

    def events_to_register(self):
        """node_ports.go: an assigned pod's deletion helps only when it
        held one of the ports this pod wants; new nodes always might."""
        CEWH, AT, CE, ER = _hint_events()

        def after_pod_delete(pod: Pod, old, new):
            from ..framework.types import QueueingHint
            if old is None:
                return QueueingHint.QUEUE
            mine = {(p.protocol or "TCP", p.host_port)
                    for p in self._container_ports(pod)}
            theirs = {(p.protocol or "TCP", p.host_port)
                      for p in self._container_ports(old)}
            return (QueueingHint.QUEUE if mine & theirs
                    else QueueingHint.SKIP)

        return [CEWH(CE(ER.NODE, AT.ADD), None),
                CEWH(CE(ER.ASSIGNED_POD, AT.DELETE), after_pod_delete)]



class SchedulingGates:
    """PE, EE — scheduling_gates.go: gate pods until spec.schedulingGates empty."""

    def name(self) -> str:
        return SCHEDULING_GATES

    def pre_enqueue(self, pod: Pod) -> Status:
        if not pod.spec.scheduling_gates:
            return Status.success()
        gates = ", ".join(g.name for g in pod.spec.scheduling_gates)
        return Status.unresolvable(f"waiting for scheduling gates: {gates}",
                                   plugin=SCHEDULING_GATES)

    # no events_to_register: gated pods never reach the unschedulable
    # pool's hint path (move_all skips gated entries) — gate removal is
    # handled by queue.update re-running PreEnqueue


class NodeDeclaredFeatures:
    """PF, F, EE — nodedeclaredfeatures/nodedeclaredfeatures.go: every
    feature the pod requires must appear in the node's declared feature
    set, else UnschedulableAndUnresolvable. The reference infers the pod's
    requirements from its spec via the ndf library; our object model
    declares them directly in spec.required_node_features."""

    def name(self) -> str:
        return "NodeDeclaredFeatures"

    def pre_filter(self, state: CycleState, pod: Pod, nodes):
        if not pod.spec.required_node_features:
            return None, Status.skip()
        return None, Status.success()

    def filter(self, state: CycleState, pod: Pod,
               node_info: NodeInfo) -> Status:
        declared = set(node_info.node.status.declared_features)
        missing = [f for f in pod.spec.required_node_features
                   if f not in declared]
        if missing:
            return Status.unresolvable(
                "node declared features check failed - unsatisfied "
                f"requirements: {', '.join(missing)}",
                plugin=self.name())
        return Status.success()

    def events_to_register(self):
        CEWH, AT, CE, ER = _hint_events()

        def after_node_change(pod: Pod, old, new):
            from ..framework.types import QueueingHint
            if new is None:
                return QueueingHint.QUEUE
            declared = set(new.status.declared_features)
            if all(f in declared for f in pod.spec.required_node_features):
                return QueueingHint.QUEUE
            return QueueingHint.SKIP

        return [CEWH(CE(ER.NODE,
                        AT.ADD | AT.UPDATE_NODE_DECLARED_FEATURE),
                     after_node_change)]


class PrioritySort:
    """QueueSort — queuesort/priority_sort.go: priority desc, then queue
    timestamp asc."""

    def name(self) -> str:
        return PRIORITY_SORT

    def less(self, a: QueuedPodInfo, b: QueuedPodInfo) -> bool:
        p1 = a.pod.spec.priority
        p2 = b.pod.spec.priority
        if p1 != p2:
            return p1 > p2
        return a.timestamp < b.timestamp
