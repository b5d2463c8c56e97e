"""SchedulingQueue: activeQ / backoffQ / unschedulablePods + nominator.

Mirrors pkg/scheduler/backend/queue/:
- PriorityQueue interface & wiring (scheduling_queue.go:94-144, :339).
- activeQ heap ordered by the profile's QueueSort less-fn; Pop falls back to
  an expired backoffQ entry (active_queue.go:272-307) and registers the pod
  in the in-flight list for event tracking (:310-330).
- backoffQ ordered by backoff expiry; per-pod backoff 1s·2^(n−1) capped 10s
  (backoff_queue.go:250, defaults scheduling_queue.go:79-83), with the error
  path keyed on consecutive errors.
- unschedulablePods map with a 5-minute leftover flush every 30s
  (scheduling_queue.go:406-413).
- AddUnschedulableIfNotPresent (:864): consults the in-flight cluster events
  that arrived during the pod's scheduling attempt against the rejector
  plugins' QueueingHintFns; a Queue hint sends the pod to backoffQ,
  otherwise it parks in unschedulablePods.
- MoveAllToActiveOrBackoffQueue (:1188) + isPodWorthRequeuing (:456).
- Nominator (nominator.go): nominated pod UIDs per node.

Host-side by design — the queue *is* the batch boundary on the TPU path:
`drain()` hands the whole activeQ to the device program in one call.
"""

from __future__ import annotations

import heapq
import itertools
import time as _time
from dataclasses import dataclass, field
from typing import Callable, Optional

from ..api.types import Pod
from ..framework.types import (ActionType, ClusterEvent, EventResource,
                               QueuedPodInfo, QueueingHint)

DEFAULT_POD_INITIAL_BACKOFF = 1.0
DEFAULT_POD_MAX_BACKOFF = 10.0
DEFAULT_POD_MAX_IN_UNSCHEDULABLE_PODS_DURATION = 300.0

EVENT_UNSCHEDULABLE_TIMEOUT = ClusterEvent(EventResource.WILDCARD, ActionType.ALL,
                                           "UnschedulableTimeout")
EVENT_FORCE_ACTIVATE = ClusterEvent(EventResource.WILDCARD, ActionType.ALL,
                                    "ForceActivate")


@dataclass
class ClusterEventWithHint:
    """staging framework/types.go ClusterEventWithHint: event the plugin
    subscribes to + optional hint fn (pod, old_obj, new_obj) → QueueingHint."""

    event: ClusterEvent
    hint_fn: Optional[Callable] = None


class _Heap:
    """backend/heap/heap.go — keyed heap with a less-fn."""

    def __init__(self, less: Callable):
        self.less = less
        self._items: dict[str, object] = {}
        self._versions: dict[str, int] = {}  # stale-entry detection
        self._heap: list = []
        # adds land here first (key, version, item) and only reach the
        # real heap when an ordered read (peek/pop) needs them: the TPU
        # drain path consumes the whole queue via pop_sorted, which never
        # orders through the heap — deferring the heappush turns the
        # ingest hot path's per-pod O(log n) wrapper push into a list
        # append that is usually thrown away wholesale
        self._staged: list = []
        self._counter = itertools.count()

    def __len__(self) -> int:
        return len(self._items)

    def __contains__(self, key: str) -> bool:
        return key in self._items

    def _push(self, key: str, item) -> None:
        version = self._versions.get(key, 0) + 1
        self._versions[key] = version
        self._items[key] = item
        self._staged.append((key, version, item))

    def _flush_staged(self) -> None:
        """Move staged adds into the real heap (ordered-read barrier).
        Flush order preserves insertion order, so the tie-break counter
        assigns the same relative order an eager push would have."""
        heap = self._heap
        versions = self._versions
        items = self._items
        for key, version, item in self._staged:
            if versions.get(key) == version and items.get(key) is item:
                heapq.heappush(heap, (_Less(item, self.less),
                                      next(self._counter), key, version))
        self._staged.clear()

    def add(self, key: str, item) -> None:
        self._push(key, item)

    def update(self, key: str, item) -> None:
        # re-push under a new version; the old entry becomes stale even if it
        # wraps the same (mutated) object
        self._push(key, item)

    def delete(self, key: str) -> None:
        if self._items.pop(key, None) is not None:
            # bump (never delete) the version so in-heap entries go stale;
            # deleting it would let a future add restart at version 1 and
            # revalidate an old entry
            self._versions[key] = self._versions.get(key, 0) + 1
        if not self._items:
            self._heap.clear()
            self._versions.clear()
            self._staged.clear()

    def get(self, key: str):
        return self._items.get(key)

    def peek(self):
        if self._staged:
            self._flush_staged()
        while self._heap:
            wrapped, _, key, version = self._heap[0]
            if key not in self._items or self._versions.get(key) != version:
                heapq.heappop(self._heap)  # stale entry
                continue
            return self._items[key]
        return None

    def pop(self):
        if self._staged:
            self._flush_staged()
        while self._heap:
            wrapped, _, key, version = heapq.heappop(self._heap)
            if key not in self._items or self._versions.get(key) != version:
                continue
            item = self._items.pop(key)
            self._versions[key] = version + 1
            if not self._items:
                self._heap.clear()
                self._versions.clear()
                self._staged.clear()
            return item
        return None

    def pop_sorted(self, key_fn: Callable, max_items: int = 0) -> list:
        """Pop the best max_items (0 = all) ordered by key_fn — one
        C-level sort instead of per-item heappops through Python
        comparison wrappers (the TPU batch drain's hot path). Only valid
        when key_fn induces the same order as the heap's less-fn. Any
        remainder stays keyed in the heap: popped entries version-bump so
        their stale heap nodes are skipped on later pops."""
        pairs = sorted(self._items.items(), key=lambda kv: key_fn(kv[1]))
        if max_items and max_items < len(pairs):
            take = pairs[:max_items]
            for key, _ in take:
                del self._items[key]
                self._versions[key] = self._versions.get(key, 0) + 1
        else:
            take = pairs
            self._items.clear()
            self._versions.clear()
            self._heap.clear()
            self._staged.clear()
        return [it for _, it in take]

    def items(self):
        return list(self._items.values())


class _Less:
    __slots__ = ("item", "less")

    def __init__(self, item, less):
        self.item = item
        self.less = less

    def __lt__(self, other: "_Less") -> bool:
        return self.less(self.item, other.item)


@dataclass
class _InFlightEvent:
    seq: int
    event: ClusterEvent
    old_obj: object
    new_obj: object


class Nominator:
    """backend/queue/nominator.go — nominated pods per node."""

    def __init__(self) -> None:
        self.nominated_pods: dict[str, str] = {}       # uid → node name
        self.nominated_per_node: dict[str, list[QueuedPodInfo]] = {}
        # monotonic mutation counter: consumers that bake nominations into
        # cached state (the scheduler's resident SigCache overlay) compare
        # this to detect that their overlay went stale
        self.version = 0

    def add(self, qpi: QueuedPodInfo, node_name: str = "") -> None:
        node = node_name or qpi.pod.status.nominated_node_name
        if not node:
            return
        self.delete(qpi.pod)
        self.nominated_pods[qpi.pod.uid] = node
        self.nominated_per_node.setdefault(node, []).append(qpi)
        self.version += 1

    def delete(self, pod: Pod) -> None:
        node = self.nominated_pods.pop(pod.uid, None)
        if node is None:
            return
        self.version += 1
        lst = self.nominated_per_node.get(node, [])
        self.nominated_per_node[node] = [q for q in lst if q.pod.uid != pod.uid]
        if not self.nominated_per_node[node]:
            del self.nominated_per_node[node]

    def pods_for_node(self, node_name: str) -> list[QueuedPodInfo]:
        return list(self.nominated_per_node.get(node_name, ()))

    def nominated_node_for(self, pod: Pod) -> str:
        return self.nominated_pods.get(pod.uid, "")


class SchedulingQueue:
    """PriorityQueue (scheduling_queue.go:339)."""

    def __init__(self,
                 less: Optional[Callable] = None,
                 pre_enqueue: Optional[Callable] = None,
                 queueing_hints: Optional[dict[str, list[ClusterEventWithHint]]] = None,
                 pod_initial_backoff: float = DEFAULT_POD_INITIAL_BACKOFF,
                 pod_max_backoff: float = DEFAULT_POD_MAX_BACKOFF,
                 pod_max_unschedulable_duration: float = DEFAULT_POD_MAX_IN_UNSCHEDULABLE_PODS_DURATION,
                 clock: Callable[[], float] = _time.monotonic):
        self.less = less or default_queue_sort_less
        # pre_enqueue(pod) → Status; gates pods (SchedulingGates plugin)
        self.pre_enqueue = pre_enqueue
        # plugin name → subscribed events+hints (built from EnqueueExtensions)
        self.queueing_hints = queueing_hints or {}
        self.pod_initial_backoff = pod_initial_backoff
        self.pod_max_backoff = pod_max_backoff
        self.pod_max_unschedulable_duration = pod_max_unschedulable_duration
        self.clock = clock

        self.active_q = _Heap(self.less)
        self.backoff_q = _Heap(self._backoff_less)
        self.unschedulable_pods: dict[str, QueuedPodInfo] = {}
        self.unschedulable_since: dict[str, float] = {}
        # gated gang members indexed by workload ref: a member-pod event
        # re-runs PreEnqueue for THAT gang's gated members only (the
        # retry_gated(ref=...) fast path) instead of sweeping every gated
        # pod in the cluster
        self.gated_by_ref: dict[str, set[str]] = {}
        self.nominator = Nominator()

        self.scheduling_cycle = 0
        self._event_seq = itertools.count()
        self.in_flight_pods: dict[str, int] = {}     # uid → pop event seq
        self.in_flight_events: list[_InFlightEvent] = []
        self.moved_in_cycle: dict[str, int] = {}     # uid → cycle when moved by event

    # -- ordering ------------------------------------------------------------

    def _backoff_less(self, a: QueuedPodInfo, b: QueuedPodInfo) -> bool:
        return self._backoff_expiry(a) < self._backoff_expiry(b)

    def _backoff_duration(self, qpi: QueuedPodInfo) -> float:
        """backoff_queue.go calculateBackoffDuration: exponential per
        unschedulable attempt, capped."""
        n = max(qpi.unschedulable_count, qpi.consecutive_errors_count)
        if n == 0:
            return 0.0
        duration = self.pod_initial_backoff
        for _ in range(n - 1):
            duration *= 2
            if duration >= self.pod_max_backoff:
                return self.pod_max_backoff
        return min(duration, self.pod_max_backoff)

    def _backoff_expiry(self, qpi: QueuedPodInfo) -> float:
        ts = qpi.timestamp
        return ts + self._backoff_duration(qpi)

    def _is_backing_off(self, qpi: QueuedPodInfo) -> bool:
        return self._backoff_expiry(qpi) > self.clock()

    # -- gated-gang index ------------------------------------------------------

    def _index_gated(self, pod: Pod) -> None:
        ref = pod.spec.workload_ref
        if ref:
            self.gated_by_ref.setdefault(ref, set()).add(pod.uid)

    def _unindex_gated(self, pod: Pod) -> None:
        ref = pod.spec.workload_ref
        if not ref:
            return
        uids = self.gated_by_ref.get(ref)
        if uids is not None:
            uids.discard(pod.uid)
            if not uids:
                del self.gated_by_ref[ref]

    def gated_refs(self) -> set:
        """Workload refs that currently have gated members."""
        return set(self.gated_by_ref)

    # -- add paths -----------------------------------------------------------

    def add(self, pod: Pod) -> None:
        from ..framework.types import PodInfo
        now = self.clock()
        qpi = QueuedPodInfo(pod_info=PodInfo.of(pod), timestamp=now,
                            initial_attempt_timestamp=now)
        self._add_qpi(qpi)

    def add_bulk(self, pods: list[Pod]) -> int:
        """Batch add (the ingest hot path): one clock read for the whole
        batch (creation_index still orders queue-sort ties), hoisted
        locals, nominator skipped for pods without a nomination. Returns
        the number that were GATED by PreEnqueue."""
        from ..framework.types import PodInfo
        now = self.clock()
        pre = self.pre_enqueue
        active_add = self.active_q.add
        nominator_add = self.nominator.add
        gated = 0
        for pod in pods:
            qpi = QueuedPodInfo(pod_info=PodInfo.of(pod), timestamp=now,
                                initial_attempt_timestamp=now)
            if pre is not None:
                status = pre(pod)
                if not status.is_success():
                    qpi.gated = True
                    qpi.gating_plugin = status.plugin
                    self.unschedulable_pods[pod.uid] = qpi
                    self.unschedulable_since[pod.uid] = now
                    self._index_gated(pod)
                    gated += 1
                    continue
            active_add(pod.metadata.uid, qpi)
            if pod.status.nominated_node_name:
                nominator_add(qpi)
        return gated

    def _add_qpi(self, qpi: QueuedPodInfo) -> None:
        if self.pre_enqueue is not None:
            status = self.pre_enqueue(qpi.pod)
            if not status.is_success():
                qpi.gated = True
                qpi.gating_plugin = status.plugin
                self.unschedulable_pods[qpi.pod.uid] = qpi
                self.unschedulable_since[qpi.pod.uid] = self.clock()
                self._index_gated(qpi.pod)
                return
        qpi.gated = False
        self.active_q.add(qpi.pod.uid, qpi)
        self.nominator.add(qpi)

    def update(self, old: Pod, new: Pod) -> None:
        from ..framework.types import PodInfo
        uid = new.uid
        for heap_ in (self.active_q, self.backoff_q):
            existing = heap_.get(uid)
            if existing is not None:
                existing.pod_info = PodInfo.of(new)
                existing.pod = new
                heap_.update(uid, existing)
                return
        existing = self.unschedulable_pods.get(uid)
        if existing is not None:
            was_gated = existing.gated
            if was_gated:
                self._unindex_gated(existing.pod)
            existing.pod_info = PodInfo.of(new)
            existing.pod = new
            # updated pods get re-evaluated (scheduling_queue.go Update:
            # spec change may make it schedulable)
            del self.unschedulable_pods[uid]
            self.unschedulable_since.pop(uid, None)
            if was_gated:
                self._add_qpi(existing)
            elif self._is_backing_off(existing):
                self.backoff_q.add(uid, existing)
            else:
                self.active_q.add(uid, existing)
                self.nominator.add(existing)
            return
        if uid not in self.in_flight_pods:
            self.add(new)

    def delete(self, pod: Pod) -> None:
        uid = pod.uid
        self.active_q.delete(uid)
        self.backoff_q.delete(uid)
        gone = self.unschedulable_pods.pop(uid, None)
        if gone is not None and gone.gated:
            self._unindex_gated(gone.pod)
        self.unschedulable_since.pop(uid, None)
        self.nominator.delete(pod)

    # -- pop / drain ---------------------------------------------------------

    def pop(self) -> Optional[QueuedPodInfo]:
        """active_queue.go:272-307: flush due backoff, then pop best."""
        self.flush_backoff_completed()
        qpi = self.active_q.pop()
        if qpi is None:
            return None
        self._mark_in_flight(qpi)
        return qpi

    def drain(self, max_pods: int = 0) -> list[QueuedPodInfo]:
        """TPU batch path: pop the whole activeQ (queue order preserved) in
        one go — the batch the device program schedules at once. With the
        default queue-sort and no size cap binding, the whole heap drains
        via ONE key-sort (C speed) instead of per-pod heappops."""
        self.flush_backoff_completed()
        if self.less is default_queue_sort_less:
            out = self.active_q.pop_sorted(default_queue_sort_key,
                                           max(max_pods, 0))
            for qpi in out:
                self._mark_in_flight(qpi)
        else:
            out = []
            while max_pods <= 0 or len(out) < max_pods:
                qpi = self.active_q.pop()
                if qpi is None:
                    break
                self._mark_in_flight(qpi)
                out.append(qpi)
        return out

    def _mark_in_flight(self, qpi: QueuedPodInfo) -> None:
        self.scheduling_cycle += 1
        qpi.attempts += 1
        if qpi.initial_attempt_timestamp is None:
            qpi.initial_attempt_timestamp = self.clock()
        self.in_flight_pods[qpi.pod.uid] = next(self._event_seq)

    def done(self, uid: str) -> None:
        """schedule_one.go:324 — release the in-flight event log entry."""
        self.in_flight_pods.pop(uid, None)
        if not self.in_flight_pods:
            self.in_flight_events.clear()

    def activate(self, pods: list[Pod]) -> None:
        """PodActivator: force move specific pods to activeQ."""
        for pod in pods:
            qpi = (self.unschedulable_pods.get(pod.uid)
                   or self.backoff_q.get(pod.uid))
            if qpi is None:
                continue
            self.unschedulable_pods.pop(pod.uid, None)
            self.unschedulable_since.pop(pod.uid, None)
            self.backoff_q.delete(pod.uid)
            if qpi.gated:
                self._unindex_gated(qpi.pod)
            qpi.gated = False
            self.active_q.add(pod.uid, qpi)
            self.nominator.add(qpi)

    # -- unschedulable handling ----------------------------------------------

    def add_unschedulable_if_not_present(self, qpi: QueuedPodInfo,
                                         pod_scheduling_cycle: int = 0) -> None:
        """scheduling_queue.go:864. Decides between unschedulablePods and
        backoffQ by replaying cluster events that arrived while this pod was
        being scheduled against the rejector plugins' hints."""
        uid = qpi.pod.uid
        if uid in self.active_q or uid in self.backoff_q or uid in self.unschedulable_pods:
            self.done(uid)
            return
        qpi.timestamp = self.clock()
        # drive the exponential backoff (the reference increments these in
        # the failure handler before calling AddUnschedulableIfNotPresent;
        # we own it here so no caller can forget)
        if qpi.consecutive_errors_count == 0:
            qpi.unschedulable_count += 1
        pop_seq = self.in_flight_pods.get(uid, -1)
        requeue = False
        if qpi.consecutive_errors_count > 0:
            # errors always back off and retry (no event needed)
            requeue = True
        else:
            for ev in self.in_flight_events:
                if ev.seq < pop_seq:
                    continue
                if self._pod_worth_requeuing(qpi, ev.event, ev.old_obj, ev.new_obj):
                    requeue = True
                    break
        self.done(uid)
        if requeue:
            if self._is_backing_off(qpi):
                self.backoff_q.add(uid, qpi)
            else:
                self.active_q.add(uid, qpi)
            self.nominator.add(qpi)
        else:
            self.unschedulable_pods[uid] = qpi
            self.unschedulable_since[uid] = self.clock()
            self.nominator.add(qpi)

    def _pod_worth_requeuing(self, qpi: QueuedPodInfo, event: ClusterEvent,
                             old_obj, new_obj) -> bool:
        """isPodWorthRequeuing (scheduling_queue.go:456): consult only the
        hints of the plugins that rejected the pod; wildcard events requeue
        unconditionally."""
        if event.resource == EventResource.WILDCARD:
            return not qpi.gated
        up, pp = qpi.unschedulable_plugins, qpi.pending_plugins
        rejectors = (up | pp) if (up and pp) else (up or pp)
        if not rejectors:
            return True
        for plugin in rejectors:
            hints = self.queueing_hints.get(plugin)
            if hints is None:
                # plugin registered no hints → conservative requeue on any
                # event (the QueueingHints-disabled behavior)
                return True
            for ewh in hints:
                if not ewh.event.match(event):
                    continue
                if ewh.hint_fn is None:
                    return True
                if ewh.hint_fn(qpi.pod, old_obj, new_obj) == QueueingHint.QUEUE:
                    return True
        return False

    # -- event-driven moves ---------------------------------------------------

    def move_all_to_active_or_backoff_queue(self, event: ClusterEvent,
                                            old_obj=None, new_obj=None,
                                            precheck: Optional[Callable] = None) -> int:
        """scheduling_queue.go:1188. Returns number of pods moved."""
        if self.in_flight_pods:
            self.in_flight_events.append(_InFlightEvent(
                next(self._event_seq), event, old_obj, new_obj))
        moved = 0
        for uid, qpi in list(self.unschedulable_pods.items()):
            if qpi.gated:
                continue
            if precheck is not None and not precheck(qpi.pod):
                continue
            if not self._pod_worth_requeuing(qpi, event, old_obj, new_obj):
                continue
            del self.unschedulable_pods[uid]
            self.unschedulable_since.pop(uid, None)
            if self._is_backing_off(qpi):
                self.backoff_q.add(uid, qpi)
            else:
                self.active_q.add(uid, qpi)
                self.nominator.add(qpi)
            moved += 1
        return moved

    def gated_pods_could_be_ungated(self) -> list[QueuedPodInfo]:
        return [q for q in self.unschedulable_pods.values() if q.gated]

    def retry_gated(self, predicate=None, ref: Optional[str] = None) -> int:
        """Re-runs PreEnqueue for gated pods (the reference re-evaluates on
        pod-update events; we expose an explicit sweep too). `ref` narrows
        the sweep to ONE gang's gated members via the gated_by_ref index
        (O(gang) on a member-pod add, not O(all gated pods)); `predicate`
        is the general filter for everything else."""
        if ref is not None:
            uids = self.gated_by_ref.get(ref)
            if not uids:
                return 0
            candidates = [(uid, self.unschedulable_pods[uid])
                          for uid in list(uids)
                          if uid in self.unschedulable_pods]
        else:
            candidates = list(self.unschedulable_pods.items())
        moved = 0
        for uid, qpi in candidates:
            if not qpi.gated:
                continue
            if predicate is not None and not predicate(qpi.pod):
                continue
            del self.unschedulable_pods[uid]
            self.unschedulable_since.pop(uid, None)
            self._unindex_gated(qpi.pod)
            self._add_qpi(qpi)
            if not qpi.gated:
                moved += 1
        return moved

    # -- periodic flushes (scheduling_queue.go Run :406-413) ------------------

    def flush_backoff_completed(self) -> int:
        moved = 0
        now = self.clock()
        while True:
            qpi = self.backoff_q.peek()
            if qpi is None or self._backoff_expiry(qpi) > now:
                break
            self.backoff_q.pop()
            self.active_q.add(qpi.pod.uid, qpi)
            self.nominator.add(qpi)
            moved += 1
        return moved

    def flush_unschedulable_leftover(self) -> int:
        now = self.clock()
        moved = 0
        for uid, qpi in list(self.unschedulable_pods.items()):
            if qpi.gated:
                continue
            since = self.unschedulable_since.get(uid, now)
            if now - since >= self.pod_max_unschedulable_duration:
                del self.unschedulable_pods[uid]
                self.unschedulable_since.pop(uid, None)
                qpi.timestamp = now
                if self._is_backing_off(qpi):
                    self.backoff_q.add(uid, qpi)
                else:
                    self.active_q.add(uid, qpi)
                moved += 1
        return moved

    # -- introspection --------------------------------------------------------

    def pending_pods(self) -> tuple[list[Pod], str]:
        active = [q.pod for q in self.active_q.items()]
        backoff = [q.pod for q in self.backoff_q.items()]
        unsched = [q.pod for q in self.unschedulable_pods.values()]
        summary = (f"activeQ:{len(active)} backoffQ:{len(backoff)} "
                   f"unschedulablePods:{len(unsched)}")
        return active + backoff + unsched, summary

    def __len__(self) -> int:
        return (len(self.active_q) + len(self.backoff_q)
                + len(self.unschedulable_pods))


def default_queue_sort_less(a: QueuedPodInfo, b: QueuedPodInfo) -> bool:
    """queuesort/priority_sort.go: priority desc, then enqueue time asc."""
    pa, pb = a.pod.spec.priority, b.pod.spec.priority
    if pa != pb:
        return pa > pb
    if a.timestamp != b.timestamp:
        return a.timestamp < b.timestamp
    return a.pod.metadata.creation_index < b.pod.metadata.creation_index


def default_queue_sort_key(q: QueuedPodInfo):
    """The key form of default_queue_sort_less (kept adjacent so the two
    orderings cannot drift apart; test-enforced)."""
    return (-q.pod.spec.priority, q.timestamp, q.pod.metadata.creation_index)
