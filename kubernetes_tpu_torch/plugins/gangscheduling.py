"""GangScheduling: all-or-nothing pod groups.

Counterpart of kubernetes_tpu/plugins/gangscheduling.py, which mirrors
pkg/scheduler/framework/plugins/gangscheduling/gangscheduling.go:
- PreEnqueue (:120-158): a gang pod stays out of the scheduling queue until
  its Workload object exists and the group has ≥ MinCount known pods.
- Reserve / Unreserve (:163-187): mark the pod assumed / forgotten in the
  WorkloadManager — assumed pods hold their node's resources while parked.
- Permit (:201-251): Wait until assumed+assigned ≥ MinCount, then Allow()
  every parked member; quorum-missing pods also re-activate the group's
  unscheduled pods so they get scheduling attempts promptly.
- events_to_register: a Workload add can only make this plugin's rejects
  schedulable (isSchedulableAfterWorkloadAdded, :100).

The `handle` is the Scheduler, which sets it: get_waiting_pod / activate /
now / workload_manager / get_workload, the subset of framework.Handle the
reference plugin consumes. The Permit wait budget is the reference's
default (GangSchedulingArgs are not configurable in the port).
"""

from __future__ import annotations

from ..api.types import Pod
from ..backend.workloadmanager import (DEFAULT_SCHEDULING_TIMEOUT,
                                       parse_workload_ref,
                                       pod_group_min_count)
from ..framework.interface import Code, CycleState, Status

WAIT = Status(Code.WAIT, ("waiting for minCount pods from a gang to be "
                          "waiting on permit",), "GangScheduling")


class GangScheduling:
    def __init__(self, scheduling_timeout_seconds=None):
        self.handle = None
        # the Permit barrier's wait (GangSchedulingArgs
        # schedulingTimeoutSeconds; config pluginArgs set it)
        self.scheduling_timeout_seconds = (
            scheduling_timeout_seconds or DEFAULT_SCHEDULING_TIMEOUT)

    def name(self) -> str:
        return "GangScheduling"

    # -- PreEnqueue (gangscheduling.go:120) -----------------------------------

    def pre_enqueue(self, pod: Pod) -> Status:
        if not pod.spec.workload_ref:
            return Status.success()
        name, group = parse_workload_ref(pod.spec.workload_ref)
        workload = self.handle.get_workload(pod.namespace, name)
        if workload is None:
            return Status.unresolvable(
                f"waiting for pod's workload {name!r} to appear",
                plugin=self.name())
        min_count = pod_group_min_count(workload, group)
        if min_count is None:
            return Status.unresolvable(
                f"pod group {group!r} doesn't exist for workload {name!r}",
                plugin=self.name())
        info = self.handle.workload_manager.pod_group_info(pod)
        if info is None or len(info.all_pods) < min_count:
            return Status.unresolvable(
                "waiting for minCount pods from a gang to appear in "
                "scheduling queue", plugin=self.name())
        return Status.success()

    # -- Reserve / Unreserve (gangscheduling.go:163-187) ----------------------

    def reserve(self, state: CycleState, pod: Pod, node_name: str) -> Status:
        if not pod.spec.workload_ref:
            return Status.success()
        info = self.handle.workload_manager.pod_group_info(pod)
        if info is None:
            return Status.error(
                f"no pod group state for {pod.spec.workload_ref!r}",
                plugin=self.name())
        info.assume_pod(pod.uid)
        return Status.success()

    def unreserve(self, state: CycleState, pod: Pod, node_name: str) -> None:
        if not pod.spec.workload_ref:
            return
        info = self.handle.workload_manager.pod_group_info(pod)
        if info is not None:
            info.forget_pod(pod.uid)

    # -- Permit (gangscheduling.go:201) ---------------------------------------

    def permit(self, state: CycleState, pod: Pod,
               node_name: str) -> tuple[Status, float]:
        if not pod.spec.workload_ref:
            return Status.success(), 0.0
        name, group = parse_workload_ref(pod.spec.workload_ref)
        workload = self.handle.get_workload(pod.namespace, name)
        if workload is None:
            return Status.error(
                f"failed to get workload {pod.namespace}/{name}",
                plugin=self.name()), 0.0
        min_count = pod_group_min_count(workload, group)
        if min_count is None:
            return Status.error(
                f"pod group {group!r} doesn't exist for workload {name!r}",
                plugin=self.name()), 0.0
        info = self.handle.workload_manager.pod_group_info(pod)
        if info is None:
            return Status.error("no pod group state", plugin=self.name()), 0.0
        quorum = info.assumed | info.assigned
        if len(quorum) < min_count:
            timeout = info.scheduling_timeout(
                self.handle.now(), self.scheduling_timeout_seconds)
            if timeout <= 0:
                # the group deadline already expired: reject outright —
                # waking members of a dead gang would ping-pong them
                # between activeQ and unschedulable forever
                return Status.unschedulable(
                    "gang scheduling deadline expired",
                    plugin=self.name()), 0.0
            # wake the group's unscheduled members so they can contribute
            self.handle.activate([info.all_pods[u]
                                  for u in info.unscheduled
                                  if u in info.all_pods])
            return WAIT, timeout
        # quorum met: release every parked member, then permit this pod
        for uid in list(info.assumed):
            if uid == pod.uid:
                continue
            waiting = self.handle.get_waiting_pod(uid)
            if waiting is not None:
                waiting.allow(self.name())
        return Status.success(), 0.0

    # -- queueing hints (gangscheduling.go:100) --------------------------------

    def events_to_register(self):
        from ..backend.queue import ClusterEventWithHint
        from ..framework.types import (ActionType, ClusterEvent,
                                       EventResource, QueueingHint)

        def after_workload_change(pod: Pod, old, new) -> QueueingHint:
            if not pod.spec.workload_ref or new is None:
                return QueueingHint.SKIP
            name, _ = parse_workload_ref(pod.spec.workload_ref)
            meta = getattr(new, "metadata", None)
            if (meta is not None and meta.name == name
                    and meta.namespace == pod.namespace):
                return QueueingHint.QUEUE
            return QueueingHint.SKIP

        return [ClusterEventWithHint(
            ClusterEvent(EventResource.WORKLOAD, ActionType.ADD),
            after_workload_change)]
