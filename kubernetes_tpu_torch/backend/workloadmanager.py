"""WorkloadManager: gang / pod-group runtime state.

Counterpart of kubernetes_tpu/backend/workloadmanager.py, which mirrors
pkg/scheduler/backend/workloadmanager/ (workloadmanager.go:32-129,
podgroupinfo.go):
- `PodGroupInfo` tracks the four pod sets per gang — all / unscheduled /
  assumed (passed Reserve, parked at Permit) / assigned (bound) — plus the
  group scheduling deadline, initialized when the first pod reaches Permit.
- `WorkloadManager` is driven explicitly by the scheduler's pod event
  handlers (single-threaded host model: the reference's mutexes collapse
  into call ordering) and keyed by (namespace, workload, podGroup).

`pod.spec.workload_ref` is the WorkloadReference: `"name"` (the workload's
first/default pod group) or `"name/group"`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ..api.types import Pod, Workload

# gangscheduling pods wait at Permit this long for quorum before rejection
# (podgroupinfo.go DefaultSchedulingTimeoutDuration)
DEFAULT_SCHEDULING_TIMEOUT = 300.0


def parse_workload_ref(ref: str) -> tuple[str, str]:
    """→ (workload name, pod group name; "" = the workload's first group)."""
    if "/" in ref:
        name, group = ref.split("/", 1)
        return name, group
    return ref, ""


@dataclass
class PodGroupInfo:
    """podgroupinfo.go podGroupInfo — the gang's runtime pod sets."""

    all_pods: dict[str, Pod] = field(default_factory=dict)
    unscheduled: set[str] = field(default_factory=set)
    assumed: set[str] = field(default_factory=set)
    assigned: set[str] = field(default_factory=set)
    scheduling_deadline: Optional[float] = None

    def add_pod(self, pod: Pod) -> None:
        self.all_pods[pod.uid] = pod
        if pod.spec.node_name:
            self.assigned.add(pod.uid)
        else:
            self.unscheduled.add(pod.uid)

    def update_pod(self, old: Pod, new: Pod) -> None:
        self.all_pods[new.uid] = new
        if not old.spec.node_name and new.spec.node_name:
            self.assigned.add(new.uid)
            self.unscheduled.discard(new.uid)
            self.assumed.discard(new.uid)

    def delete_pod(self, uid: str) -> None:
        self.all_pods.pop(uid, None)
        self.unscheduled.discard(uid)
        self.assumed.discard(uid)
        self.assigned.discard(uid)

    def assume_pod(self, uid: str) -> None:
        """Reserve stage: the pod holds resources and waits for the gang."""
        self.assumed.add(uid)
        self.unscheduled.discard(uid)

    def forget_pod(self, uid: str) -> None:
        """Unreserve: back to unscheduled, no longer quorum-eligible."""
        if uid in self.assumed:
            self.assumed.discard(uid)
            if uid in self.all_pods:
                self.unscheduled.add(uid)

    def empty(self) -> bool:
        return not self.all_pods

    def scheduling_timeout(self, now: float,
                           duration: float = DEFAULT_SCHEDULING_TIMEOUT
                           ) -> float:
        """Remaining wait budget; the deadline starts with the group's
        first Permit (podgroupinfo.go SchedulingTimeout)."""
        if self.scheduling_deadline is None:
            self.scheduling_deadline = now + duration
        return max(self.scheduling_deadline - now, 0.0)


class WorkloadManager:
    """workloadmanager.go:32 — source of truth for gang pod state."""

    def __init__(self):
        self.pod_group_infos: dict[tuple[str, str, str], PodGroupInfo] = {}

    @staticmethod
    def _key(pod: Pod) -> Optional[tuple[str, str, str]]:
        ref = pod.spec.workload_ref
        if not ref:
            return None
        name, group = parse_workload_ref(ref)
        return (pod.namespace, name, group)

    def add_pod(self, pod: Pod) -> None:
        key = self._key(pod)
        if key is None:
            return
        self.pod_group_infos.setdefault(key, PodGroupInfo()).add_pod(pod)

    def update_pod(self, old: Pod, new: Pod) -> None:
        key = self._key(new)
        if key is None:
            return
        info = self.pod_group_infos.get(key)
        if info is None:
            self.pod_group_infos[key] = info = PodGroupInfo()
            info.add_pod(new)
            return
        info.update_pod(old, new)

    def delete_pod(self, pod: Pod) -> None:
        key = self._key(pod)
        if key is None:
            return
        info = self.pod_group_infos.get(key)
        if info is None:
            return
        info.delete_pod(pod.uid)
        if info.empty():
            del self.pod_group_infos[key]

    def pod_group_info(self, pod: Pod) -> Optional[PodGroupInfo]:
        key = self._key(pod)
        return self.pod_group_infos.get(key) if key else None


def pod_group_min_count(workload: Workload, group_name: str) -> Optional[int]:
    """gangscheduling.go podGroupPolicy: the group's MinCount, or None when
    the named group doesn't exist ("" = first group)."""
    for pg in workload.pod_groups:
        if not group_name or pg.name == group_name:
            return pg.min_count
    return None
