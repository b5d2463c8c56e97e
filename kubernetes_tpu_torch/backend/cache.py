"""Scheduler cache: assumed pods, node mirror, incremental snapshot.

Mirrors pkg/scheduler/backend/cache/cache.go:
- podStates with an assumed set + TTL deadline (cache.go:61-84); AssumePod
  (:369), FinishBinding (:384), ForgetPod (:412), expiry cleanup (:38-49).
- `nodes` map + generation-ordered doubly-linked list (cache.go:118-167):
  every NodeInfo mutation bumps its generation and moves the entry to the
  list head, so UpdateSnapshot can stop walking at the first entry whose
  generation is already in the snapshot (snapshot.go / cache.go:194-250).
- Snapshot keeps three pre-filtered node lists (all / havePodsWithAffinity /
  haveRequiredAntiAffinity) exactly like snapshot.go:30.

On the TPU path the same generation diff drives scatter-updates of the
device-resident capacity matrices (state/tensorize.py) instead of NodeInfo
copies — the cache emits the list of dirty node indices per snapshot.
"""

from __future__ import annotations

import time as _time
from dataclasses import dataclass, field
from typing import Callable, Optional

from ..api.types import Node, Pod
from ..framework.types import NodeInfo, PodInfo, next_generation


@dataclass
class _PodState:
    pod: Pod
    assumed: bool = False
    deadline: Optional[float] = None  # assumed-pod expiry; None = no expiry
    binding_finished: bool = False


class _NodeItem:
    """Doubly-linked list entry (cache.go nodeInfoListItem)."""

    __slots__ = ("info", "next", "prev")

    def __init__(self, info: NodeInfo):
        self.info = info
        self.next: Optional[_NodeItem] = None
        self.prev: Optional[_NodeItem] = None


@dataclass
class Snapshot:
    """backend/cache/snapshot.go:30."""

    node_infos: dict[str, NodeInfo] = field(default_factory=dict)
    node_info_list: list[NodeInfo] = field(default_factory=list)
    have_pods_with_affinity_list: list[NodeInfo] = field(default_factory=list)
    have_pods_with_required_anti_affinity_list: list[NodeInfo] = field(default_factory=list)
    generation: int = 0
    # node_tree generation at last list rebuild (schedulable-set change marker)
    tree_generation: int = -1
    # node indices whose arrays changed since the previous snapshot — the
    # TPU scatter-update set (not in the reference; our §7.3 addition)
    dirty_nodes: set[str] = field(default_factory=set)

    def get(self, name: str) -> Optional[NodeInfo]:
        return self.node_infos.get(name)


class Cache:
    """cacheImpl (cache.go:61). Single-threaded host model: the reference's
    mutex discipline collapses into call ordering by the scheduler loop."""

    def __init__(self, ttl: float = 0.0, clock: Callable[[], float] = _time.monotonic):
        self.ttl = ttl  # 0 ⇒ assumed pods never expire (scheduler.go:63-67)
        self.clock = clock
        self.pod_states: dict[str, _PodState] = {}
        self.assumed_pods: set[str] = set()
        self.nodes: dict[str, _NodeItem] = {}
        self.head: Optional[_NodeItem] = None
        # nodeTree: zone → node names for zone-round-robin ordering
        # (backend/cache/node_tree.go:32-37)
        self.node_tree: dict[str, list[str]] = {}
        self._tree_generation = 0  # bumped on any node_tree membership change
        self._imputed_nodes: set[str] = set()  # nodes created only by pod adds

    # -- linked-list maintenance (cache.go:118-167) --------------------------

    def _move_to_head(self, item: _NodeItem) -> None:
        if self.head is item:
            return
        if item.prev is not None:
            item.prev.next = item.next
        if item.next is not None:
            item.next.prev = item.prev
        item.prev = None
        item.next = self.head
        if self.head is not None:
            self.head.prev = item
        self.head = item

    def _remove_item(self, item: _NodeItem) -> None:
        if item.prev is not None:
            item.prev.next = item.next
        else:
            self.head = item.next
        if item.next is not None:
            item.next.prev = item.prev
        item.prev = item.next = None

    def _touch(self, item: _NodeItem) -> None:
        item.info.bump()
        self._move_to_head(item)

    def _get_or_create(self, node_name: str) -> _NodeItem:
        item = self.nodes.get(node_name)
        if item is None:
            # pod arrived before its node (cache.go AddPod path): imputed entry
            item = _NodeItem(NodeInfo(node=_placeholder_node(node_name)))
            self.nodes[node_name] = item
            self._imputed_nodes.add(node_name)
            self._move_to_head(item)
        return item

    # -- pods ----------------------------------------------------------------

    def assume_pod(self, pod: Pod) -> None:
        """cache.go:369 — pod must not be known yet."""
        self.assume_pod_info(PodInfo.of(pod))

    def assume_pod_info(self, pi: PodInfo) -> None:
        """assume_pod with a caller-supplied PodInfo — the scheduler's hot
        bind path reuses the queue entry's pre-parsed requests instead of
        re-parsing resource quantities per assume."""
        pod = pi.pod
        uid = pod.uid
        if uid in self.pod_states:
            raise KeyError(f"pod {uid} is in the cache, so can't be assumed")
        self._add_pod_info_to_node(pi)
        ps = _PodState(pod=pod, assumed=True)
        self.pod_states[uid] = ps
        self.assumed_pods.add(uid)

    def finish_binding(self, pod: Pod) -> None:
        """cache.go:384 — start the TTL countdown for the assumed pod."""
        ps = self.pod_states.get(pod.uid)
        if ps is None or not ps.assumed:
            return
        ps.binding_finished = True
        if self.ttl > 0:
            ps.deadline = self.clock() + self.ttl

    def forget_pod(self, pod: Pod) -> None:
        """cache.go:412 — only assumed pods can be forgotten."""
        uid = pod.uid
        ps = self.pod_states.get(uid)
        if ps is None:
            return
        if ps.pod.spec.node_name != pod.spec.node_name:
            raise ValueError(f"pod {uid} was assumed on {ps.pod.spec.node_name} "
                             f"but assigned to {pod.spec.node_name}")
        if not ps.assumed:
            raise KeyError(f"pod {uid} wasn't assumed, so can't be forgotten")
        self._remove_pod_from_node(ps.pod)
        del self.pod_states[uid]
        self.assumed_pods.discard(uid)

    def add_pod(self, pod: Pod) -> None:
        """Informer add of an assigned pod (cache.go AddPod): confirms an
        assumed pod or inserts a new one."""
        uid = pod.uid
        ps = self.pod_states.get(uid)
        if ps is not None and ps.assumed:
            if ps.pod.spec.node_name != pod.spec.node_name:
                # assumed on one node, bound on another: relocate
                self._remove_pod_from_node(ps.pod)
                self._add_pod_to_node(pod)
            self.assumed_pods.discard(uid)
            self.pod_states[uid] = _PodState(pod=pod)
            return
        if ps is not None:
            return  # duplicate add: ignore (cache logs error)
        self._add_pod_to_node(pod)
        self.pod_states[uid] = _PodState(pod=pod)

    def confirm_bound(self, pods: list) -> None:
        """Bulk bind-echo confirm (the columnar commit engine's informer
        path): each pod was assumed on the node it just bound to, so the
        add_pod() assumed-branch reduces to flipping the existing
        _PodState in place — no relocation, no fresh state object. Pods
        that do not match the fast shape (not assumed, or bound
        elsewhere) take the full add_pod path."""
        states = self.pod_states
        assumed = self.assumed_pods
        for pod in pods:
            uid = pod.metadata.uid
            ps = states.get(uid)
            if (ps is None or not ps.assumed
                    or ps.pod.spec.node_name != pod.spec.node_name):
                self.add_pod(pod)
                continue
            assumed.discard(uid)
            ps.pod = pod
            ps.assumed = False
            ps.binding_finished = False
            ps.deadline = None

    def add_pods(self, pods: list) -> None:
        """Bulk informer add of assigned pods (the resync/relist path):
        per-pod `add_pod` semantics with the state probes hoisted."""
        states = self.pod_states
        for pod in pods:
            uid = pod.metadata.uid
            ps = states.get(uid)
            if ps is not None:
                if ps.assumed:
                    self.add_pod(pod)   # assumed-confirm/relocate path
                continue
            self._add_pod_to_node(pod)
            states[uid] = _PodState(pod=pod)

    def update_pod(self, old: Pod, new: Pod) -> None:
        ps = self.pod_states.get(old.uid)
        if ps is None or ps.assumed:
            return
        self._remove_pod_from_node(ps.pod)
        self._add_pod_to_node(new)
        self.pod_states[old.uid] = _PodState(pod=new)

    def remove_pod(self, pod: Pod) -> None:
        ps = self.pod_states.get(pod.uid)
        if ps is None:
            return
        self._remove_pod_from_node(ps.pod)
        del self.pod_states[pod.uid]
        self.assumed_pods.discard(pod.uid)

    def is_assumed_pod(self, pod: Pod) -> bool:
        return pod.uid in self.assumed_pods

    def get_pod(self, uid: str) -> Optional[Pod]:
        ps = self.pod_states.get(uid)
        return ps.pod if ps else None

    def pod_count(self) -> int:
        return len(self.pod_states)

    def _add_pod_to_node(self, pod: Pod) -> None:
        self._add_pod_info_to_node(PodInfo.of(pod))

    def _add_pod_info_to_node(self, pi: PodInfo) -> None:
        pod = pi.pod
        if not pod.spec.node_name:
            raise ValueError(f"pod {pod.uid} has no nodeName")
        item = self._get_or_create(pod.spec.node_name)
        item.info.add_pod(pi)
        self._move_to_head(item)

    def _remove_pod_from_node(self, pod: Pod) -> None:
        item = self.nodes.get(pod.spec.node_name)
        if item is None:
            return
        item.info.remove_pod(PodInfo.of(pod))
        self._move_to_head(item)
        # drop imputed node entries once empty (cache.go removeDeletedNodesFromCache)
        if (pod.spec.node_name in self._imputed_nodes and not item.info.pods):
            self._remove_item(item)
            del self.nodes[pod.spec.node_name]
            self._imputed_nodes.discard(pod.spec.node_name)

    # -- assumed-pod expiry (cache.go cleanupAssumedPods, 1s period) ---------

    def cleanup_expired_assumed_pods(self) -> list[Pod]:
        """Returns the pods that were expired (caller requeues them)."""
        if self.ttl <= 0:
            return []
        now = self.clock()
        expired = []
        for uid in list(self.assumed_pods):
            ps = self.pod_states[uid]
            if ps.binding_finished and ps.deadline is not None and now >= ps.deadline:
                expired.append(ps.pod)
                self._remove_pod_from_node(ps.pod)
                del self.pod_states[uid]
                self.assumed_pods.discard(uid)
        return expired

    # -- nodes ---------------------------------------------------------------

    def add_node(self, node: Node) -> NodeInfo:
        item = self.nodes.get(node.name)
        if item is None:
            item = _NodeItem(NodeInfo(node=node))
            self.nodes[node.name] = item
        else:
            self._imputed_nodes.discard(node.name)
            item.info.node = node
            item.info.sync_images()
        self._touch(item)
        self._node_tree_add(node)
        return item.info

    def update_node(self, old: Node, new: Node) -> NodeInfo:
        item = self.nodes.get(new.name)
        if item is None:
            return self.add_node(new)
        old_zone = _zone_of(item.info.node)
        item.info.node = new
        item.info.sync_images()
        self._touch(item)
        if old_zone != _zone_of(new):
            self._node_tree_remove(new.name, old_zone)
            self._node_tree_add(new)
        return item.info

    def remove_node(self, node: Node) -> None:
        item = self.nodes.get(node.name)
        if item is None:
            return
        # keep the entry if pods are still on it (they'll be removed by
        # their own delete events; cache.go RemoveNode)
        self._node_tree_remove(node.name, _zone_of(node))
        if item.info.pods:
            self._imputed_nodes.add(node.name)
            self._touch(item)
        else:
            self._remove_item(item)
            del self.nodes[node.name]

    def get_node_info(self, name: str) -> Optional[NodeInfo]:
        item = self.nodes.get(name)
        return item.info if item else None

    def node_count(self) -> int:
        return len(self.nodes)

    def _node_tree_add(self, node: Node) -> None:
        zone = _zone_of(node)
        names = self.node_tree.setdefault(zone, [])
        if node.name not in names:
            names.append(node.name)
            self._tree_generation += 1

    def _node_tree_remove(self, name: str, zone: str) -> None:
        names = self.node_tree.get(zone)
        if names and name in names:
            names.remove(name)
            self._tree_generation += 1
            if not names:
                del self.node_tree[zone]

    # -- snapshot (cache.go:194-250) -----------------------------------------

    def update_snapshot(self, snapshot: Snapshot) -> Snapshot:
        """Incremental: walk the generation list head-first, stop at the first
        item whose generation ≤ snapshot.generation; rebuild the flat lists
        only when membership changed."""
        snapshot.dirty_nodes = set()
        update_all = False
        item = self.head
        latest = item.info.generation if item else snapshot.generation
        while item is not None and item.info.generation > snapshot.generation:
            info = item.info
            name = info.name
            existing = snapshot.node_infos.get(name)
            if existing is None:
                update_all = True
            else:
                # membership of the affinity sublists may have changed
                if (bool(existing.pods_with_affinity) != bool(info.pods_with_affinity)
                        or bool(existing.pods_with_required_anti_affinity)
                        != bool(info.pods_with_required_anti_affinity)):
                    update_all = True
            snapshot.node_infos[name] = _snapshot_node_info(info)
            snapshot.dirty_nodes.add(name)
            item = item.next
        # removed nodes
        if len(snapshot.node_infos) > len(self.nodes):
            for name in list(snapshot.node_infos):
                if name not in self.nodes:
                    del snapshot.node_infos[name]
                    snapshot.dirty_nodes.add(name)
                    update_all = True
        if update_all or self._tree_generation != snapshot.tree_generation:
            self._rebuild_lists(snapshot)
            snapshot.tree_generation = self._tree_generation
        elif snapshot.dirty_nodes:
            # refresh references in the flat lists for dirty nodes; the
            # clean case must not walk the lists at all — update_snapshot
            # runs once per scheduling failure, and a 5k-node walk per
            # call was ~3s of a 200-preemptor wave
            for lst in (snapshot.node_info_list,
                        snapshot.have_pods_with_affinity_list,
                        snapshot.have_pods_with_required_anti_affinity_list):
                for i, ni in enumerate(lst):
                    if ni.name in snapshot.dirty_nodes:
                        lst[i] = snapshot.node_infos[ni.name]
        snapshot.generation = latest
        return snapshot

    def _rebuild_lists(self, snapshot: Snapshot) -> None:
        """Zone-round-robin node order (node_tree.go) — matches the
        reference's node iteration order for decision parity."""
        order: list[str] = []
        zone_lists = [list(v) for v in self.node_tree.values()]
        idx = 0
        while any(zone_lists):
            for zl in zone_lists:
                if idx < len(zl):
                    order.append(zl[idx])
            idx += 1
            if all(idx >= len(zl) for zl in zone_lists):
                break
        # the list comes exclusively from the nodeTree (cache.go:229-239):
        # removed-but-still-populated nodes and imputed placeholder entries
        # stay in node_infos for lookups but are not schedulable targets
        snapshot.node_info_list = [snapshot.node_infos[n] for n in order
                                   if n in snapshot.node_infos]
        snapshot.have_pods_with_affinity_list = [
            ni for ni in snapshot.node_info_list if ni.pods_with_affinity]
        snapshot.have_pods_with_required_anti_affinity_list = [
            ni for ni in snapshot.node_info_list
            if ni.pods_with_required_anti_affinity]

    # -- debugger (backend/cache/debugger) -----------------------------------

    def dump(self) -> dict:
        return {
            "nodes": {n: {"pods": [p.pod.uid for p in item.info.pods],
                          "requested": dict(item.info.requested),
                          "generation": item.info.generation}
                      for n, item in self.nodes.items()},
            "assumed_pods": sorted(self.assumed_pods),
            "pod_count": len(self.pod_states),
        }


def _snapshot_node_info(info: NodeInfo) -> NodeInfo:
    """NodeInfo.Snapshot(): structural copy sharing immutable PodInfos."""
    return info.snapshot_clone()


def _zone_of(node: Node) -> str:
    return node.metadata.labels.get("topology.kubernetes.io/zone", "")


def _placeholder_node(name: str) -> Node:
    from ..api.types import NodeSpec, NodeStatus, ObjectMeta
    return Node(metadata=ObjectMeta(name=name), spec=NodeSpec(), status=NodeStatus())
