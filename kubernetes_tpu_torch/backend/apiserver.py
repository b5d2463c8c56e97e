"""In-memory API server + clientset + informer fan-out.

The reference's entire distributed substrate is etcd + watch/list over HTTP/2
(SURVEY §2.7); its scheduler tests talk to an in-process apiserver
(test/integration, apiservertesting.StartTestServer) or a fake clientset with
an object tracker (client-go/kubernetes/fake). This module is both at once:
an object store with Binding/status subresources and synchronous watch
delivery to registered handlers — the process boundary collapses, the
interface shape stays.
"""

from __future__ import annotations

import dataclasses
import zlib as _zlib
from dataclasses import dataclass, field
from typing import Callable, Optional

from ..api.types import (Node, PersistentVolume, PersistentVolumeClaim,
                         Pod, PodDisruptionBudget, ResourceClaim,
                         ResourceSlice, StorageClass, Workload,
                         _resolve_maybe_percent)


class APIError(Exception):
    """Base of the in-memory server's typed errors (apierrors analog)."""


class Conflict(APIError):
    pass


class NotFound(APIError):
    pass


class ServerTimeout(APIError):
    """The server timed out before the call took effect (504-shaped,
    apierrors.IsServerTimeout). Retriable."""


class TooManyRequests(APIError):
    """429: the server sheds load (apierrors.IsTooManyRequests).
    Retriable."""


class ServiceUnavailable(APIError):
    """503: transient unavailability. Retriable."""


class FencedWrite(APIError):
    """A write carried a stale fencing token (lease generation): the
    caller was deposed as leader and a newer holder owns the lease.
    Deliberately TERMINAL — retrying cannot help (the generation only
    moves forward), so the dispatcher routes it through the same
    forget/requeue path as Conflict and the assume unwinds cleanly."""


# the retriable set mirrors client-go's shouldRetry classification
# (util/retry + apierrors.SuggestsClientDelay): the call did NOT take
# effect, so re-issuing it is safe. Conflict/NotFound are terminal — they
# describe state the caller must react to, not a server hiccup.
RETRIABLE_ERRORS = (ServerTimeout, TooManyRequests, ServiceUnavailable)


def is_retriable(err: Exception) -> bool:
    return isinstance(err, RETRIABLE_ERRORS)


# -- coordination.k8s.io/v1 Lease ------------------------------------------

LEASE_NAME = "kube-scheduler"


@dataclass
class Lease:
    """coordination.k8s.io/v1 Lease (consumed subset) + the fencing
    generation: a monotonic counter bumped on every holder CHANGE, handed
    to the new leader as its fencing token. A write stamped with an older
    generation is provably from a deposed leader and is rejected
    (FencedWrite) regardless of how long its flush was paused."""

    name: str = LEASE_NAME
    holder_identity: str = ""
    lease_duration_s: float = 15.0
    renew_time: float = 0.0
    lease_transitions: int = 0
    generation: int = 0


@dataclass
class ShardMap:
    """The control plane's shard topology: which scheduler shard owns
    which profile/namespace slice of the pod stream. Stored as ONE
    versioned API object (optimistic concurrency on `version`, writes
    fenced by the writer's lease generation) so every instance converges
    on the same answer to "whose pod is this?" — the assignment map IS
    the cross-shard routing table. Keys are `scheduler_name/namespace`;
    unknown keys fall back to a stable hash so new tenants land
    deterministically on the same shard from every instance."""

    num_shards: int = 1
    assignments: dict[str, int] = field(default_factory=dict)
    version: int = 0

    def shard_for(self, key: str) -> int:
        sid = self.assignments.get(key)
        if sid is not None and 0 <= sid < self.num_shards:
            return sid
        # process-independent fallback (hash() is salted per process)
        return _zlib.crc32(key.encode("utf-8")) % max(1, self.num_shards)


@dataclass
class WatchHandlers:
    """The informer event-handler triple (client-go ResourceEventHandler).
    `on_add_bulk` is an optional batch form consumed by create_pods —
    semantically equivalent to per-pod on_add calls in order."""

    on_add: Optional[Callable] = None
    on_update: Optional[Callable] = None
    on_delete: Optional[Callable] = None
    on_add_bulk: Optional[Callable] = None
    # optional batch form consumed by bind_all (the bulk Binding echo) —
    # semantically equivalent to per-pod on_update calls in order
    on_update_bulk: Optional[Callable] = None


@dataclass
class APIServer:
    """Object store + watch fan-out."""

    pods: dict[str, Pod] = field(default_factory=dict)
    nodes: dict[str, Node] = field(default_factory=dict)
    workloads: dict[str, Workload] = field(default_factory=dict)
    pvcs: dict[str, PersistentVolumeClaim] = field(default_factory=dict)
    pvs: dict[str, PersistentVolume] = field(default_factory=dict)
    storage_classes: dict[str, StorageClass] = field(default_factory=dict)
    namespaces: dict[str, dict[str, str]] = field(default_factory=dict)
    pdbs: dict[str, PodDisruptionBudget] = field(default_factory=dict)
    resource_slices: dict[str, ResourceSlice] = field(default_factory=dict)
    resource_claims: dict[str, ResourceClaim] = field(default_factory=dict)
    leases: dict[str, Lease] = field(default_factory=dict)
    shard_map: Optional[ShardMap] = None
    # bounded audit trail of accepted shard-map writes (who owned what,
    # when) — captured into incident bundles (obs/incident.py)
    shard_map_history: list[dict] = field(default_factory=list)
    pod_handlers: list[WatchHandlers] = field(default_factory=list)
    node_handlers: list[WatchHandlers] = field(default_factory=list)
    workload_handlers: list[WatchHandlers] = field(default_factory=list)
    pvc_handlers: list[WatchHandlers] = field(default_factory=list)
    pv_handlers: list[WatchHandlers] = field(default_factory=list)
    pdb_handlers: list[WatchHandlers] = field(default_factory=list)
    claim_handlers: list[WatchHandlers] = field(default_factory=list)
    slice_handlers: list[WatchHandlers] = field(default_factory=list)
    binding_count: int = 0
    fenced_rejections: int = 0

    # -- leases (coordination.k8s.io) + fencing -------------------------------

    def get_lease(self, name: str = LEASE_NAME) -> Optional[Lease]:
        return self.leases.get(name)

    def acquire_lease(self, name: str, identity: str, now: float,
                      lease_duration_s: float = 15.0) -> Lease:
        """Take the lease when unheld, expired, or already ours. A holder
        change bumps lease_transitions AND the fencing generation — the
        returned lease carries the token the new leader must stamp on its
        writes. Raises Conflict while another holder's lease is live."""
        lease = self.leases.setdefault(
            name, Lease(name=name, lease_duration_s=lease_duration_s))
        if lease.holder_identity == identity:
            lease.renew_time = now
            return lease
        expired = (not lease.holder_identity
                   or now - lease.renew_time > lease.lease_duration_s)
        if not expired:
            raise Conflict(
                f"lease {name!r} is held by {lease.holder_identity!r}")
        if lease.holder_identity:
            lease.lease_transitions += 1
        lease.holder_identity = identity
        lease.lease_duration_s = lease_duration_s
        lease.renew_time = now
        lease.generation += 1
        return lease

    def renew_lease(self, name: str, identity: str, now: float) -> Lease:
        """Heartbeat an already-held lease. Conflict when the caller no
        longer holds it (stolen / released) — the deposed-leader signal."""
        lease = self.leases.get(name)
        if lease is None:
            raise NotFound(f"lease {name}")
        if lease.holder_identity != identity:
            raise Conflict(
                f"lease {name!r} is held by {lease.holder_identity!r}, "
                f"not {identity!r}")
        lease.renew_time = now
        return lease

    def release_lease(self, name: str, identity: str) -> None:
        """Voluntary handoff: clear the holder so the next acquire wins
        immediately. No-op when the caller isn't the holder."""
        lease = self.leases.get(name)
        if lease is None or lease.holder_identity != identity:
            return
        lease.holder_identity = ""
        lease.renew_time = 0.0

    def check_fence(self, fence_token, name: str = LEASE_NAME) -> None:
        """Reject a write stamped with a stale lease generation. `None`
        passes (unfenced legacy writes); a token only fails once a NEWER
        holder has acquired, so single-leader operation never pays.

        Three token forms (the sharded control plane spans leases):
          * int — legacy, checked against the `name` lease;
          * (lease_name, generation) — one explicit lease;
          * tuple of such pairs — a bulk batch spanning shard leases;
            EVERY pair must be current or the whole write is fenced.
        """
        if fence_token is None:
            return
        if isinstance(fence_token, int):
            pairs = ((name, fence_token),)
        elif fence_token and isinstance(fence_token[0], str):
            pairs = (fence_token,)
        else:
            pairs = tuple(fence_token)
        for lname, gen in pairs:
            lease = self.leases.get(lname)
            if lease is not None and gen != lease.generation:
                self.fenced_rejections += 1
                raise FencedWrite(
                    f"write fenced: token {gen} != lease {lname!r} "
                    f"generation {lease.generation} "
                    f"(holder {lease.holder_identity!r})")

    # -- shard assignment map (sharded control plane) -------------------------

    def get_shard_map(self) -> "ShardMap":
        """Snapshot of the cluster's shard assignment map (a fresh copy —
        callers mutate a draft, then race it back through put_shard_map's
        optimistic-concurrency check). An absent map reads as the trivial
        single-shard map at version 0."""
        cur = self.shard_map
        if cur is None:
            return ShardMap()
        return ShardMap(num_shards=cur.num_shards,
                        assignments=dict(cur.assignments),
                        version=cur.version)

    def put_shard_map(self, new: "ShardMap", expect_version: int,
                      fence_token=None) -> "ShardMap":
        """Compare-and-swap the shard map. The stored version must equal
        expect_version (Conflict otherwise — re-read and retry), and the
        write is fenced like any other: a deposed shard leader cannot
        rewrite the topology. The accepted map is stored at
        expect_version + 1."""
        self.check_fence(fence_token)
        cur_version = 0 if self.shard_map is None else self.shard_map.version
        if cur_version != expect_version:
            raise Conflict(
                f"shard map version {cur_version} != expected "
                f"{expect_version}")
        self.shard_map = ShardMap(num_shards=max(1, new.num_shards),
                                  assignments=dict(new.assignments),
                                  version=expect_version + 1)
        self.shard_map_history.append({
            "version": self.shard_map.version,
            "numShards": self.shard_map.num_shards,
            "assignments": dict(self.shard_map.assignments),
            "fence": str(fence_token) if fence_token is not None else "",
        })
        del self.shard_map_history[:-32]
        return self.get_shard_map()

    # -- watch registration (LIST+WATCH: informer semantics) ------------------
    # client-go informers LIST current state before watching; a handler
    # registered against a live store immediately receives synthetic adds
    # for every existing object. This is what makes scheduler restart
    # recovery work: a fresh Scheduler rebuilds its cache/queue/device
    # state purely from these replays (cache.go's resync story).

    @staticmethod
    def _register(handlers: list, store: dict, h: WatchHandlers) -> None:
        handlers.append(h)
        if h.on_add:
            for obj in list(store.values()):
                h.on_add(obj)

    def watch_pods(self, h: WatchHandlers) -> None:
        self._register(self.pod_handlers, self.pods, h)

    def watch_nodes(self, h: WatchHandlers) -> None:
        self._register(self.node_handlers, self.nodes, h)

    def watch_workloads(self, h: WatchHandlers) -> None:
        self._register(self.workload_handlers, self.workloads, h)

    def watch_pvcs(self, h: WatchHandlers) -> None:
        self._register(self.pvc_handlers, self.pvcs, h)

    def watch_pvs(self, h: WatchHandlers) -> None:
        self._register(self.pv_handlers, self.pvs, h)

    # -- pods -----------------------------------------------------------------

    def create_pod(self, pod: Pod) -> Pod:
        if pod.uid in self.pods:
            raise Conflict(f"pod {pod.uid} exists")
        self.pods[pod.uid] = pod
        for h in self.pod_handlers:
            if h.on_add:
                h.on_add(pod)
        return pod

    def create_pods(self, pods: list[Pod]) -> None:
        """Bulk create: one store pass, then one fan-out pass per handler.
        A handler exposing `on_add_bulk` receives the whole list (the
        scheduler's ingest fast path); others get per-pod on_add."""
        store = self.pods
        for pod in pods:    # validate BEFORE inserting: a mid-batch
            if pod.uid in store:   # Conflict must not strand stored pods
                raise Conflict(f"pod {pod.uid} exists")  # unannounced
        for pod in pods:
            store[pod.uid] = pod
        for h in self.pod_handlers:
            bulk = getattr(h, "on_add_bulk", None)
            if bulk is not None:
                bulk(pods)
            elif h.on_add:
                for pod in pods:
                    h.on_add(pod)

    def update_pod(self, pod: Pod) -> Pod:
        old = self.pods.get(pod.uid)
        if old is None:
            raise NotFound(pod.uid)
        self.pods[pod.uid] = pod
        for h in self.pod_handlers:
            if h.on_update:
                h.on_update(old, pod)
        return pod

    def delete_pod(self, uid: str, fence_token: Optional[int] = None) -> None:
        self.check_fence(fence_token)
        pod = self.pods.pop(uid, None)
        if pod is None:
            raise NotFound(uid)
        for h in self.pod_handlers:
            if h.on_delete:
                h.on_delete(pod)

    def get_pod(self, uid: str) -> Pod:
        pod = self.pods.get(uid)
        if pod is None:
            raise NotFound(uid)
        return pod

    def bind(self, pod: Pod, node_name: str,
             fence_token: Optional[int] = None) -> None:
        """POST pods/<name>/binding (reference default_binder.go:51 →
        registry/core/pod/storage BindingREST: sets spec.nodeName, fails
        on conflict if already bound — EVEN to the same node, so two
        schedulers racing to identical placements still surface the
        race instead of silently double-counting the bind)."""
        self.check_fence(fence_token)
        current = self.pods.get(pod.uid)
        if current is None:
            raise NotFound(pod.uid)
        if current.spec.node_name:
            raise Conflict(
                f"pod {pod.uid} is already assigned to node {current.spec.node_name}")
        if node_name not in self.nodes:
            raise NotFound(f"node {node_name}")
        old = current
        new = current.with_node_name(node_name)
        new.status.phase = "Running"
        self.pods[pod.uid] = new
        self.binding_count += 1
        for h in self.pod_handlers:
            if h.on_update:
                h.on_update(old, new)

    def bind_all(self, pairs: list[tuple[Pod, Pod]],
                 fence_token: Optional[int] = None
                 ) -> list[tuple[Pod, Exception]]:
        """Bulk Binding subresource: (assumed pod with node set, the
        original object it was derived from). When the stored object IS
        that original (identity — the common case), no interleaved client
        update can have landed and the assumed copy becomes the stored
        object directly; otherwise the stored object is derived from
        `current` exactly like bind(), so a post-drain update survives
        with only nodeName/phase changing. Store updates apply first,
        then handlers fan out. Returns per-pod failures. A stale fencing
        token fails the WHOLE batch per-pod (the deposed leader's bulk
        flush must bind nothing, and the per-pod failure list rides the
        caller's existing unwind path)."""
        failures: list[tuple[Pod, Exception]] = []
        if fence_token is not None:
            try:
                self.check_fence(fence_token)
            except FencedWrite as e:
                return [(pod, e) for pod, _original in pairs]
        updates: list[tuple[Pod, Pod]] = []
        store = self.pods
        nodes = self.nodes
        for pod, original in pairs:
            uid = pod.metadata.uid
            current = store.get(uid)
            node_name = pod.spec.node_name
            if current is None:
                failures.append((pod, NotFound(uid)))
                continue
            if current.spec.node_name:
                # already bound — even to the SAME node: a racing
                # scheduler's identical placement is still its loss
                failures.append((pod, Conflict(
                    f"pod {uid} is already assigned to node "
                    f"{current.spec.node_name}")))
                continue
            if node_name not in nodes:
                failures.append((pod, NotFound(f"node {node_name}")))
                continue
            new = pod if current is original else current.with_node_name(node_name)
            new.status.phase = "Running"
            store[uid] = new
            updates.append((current, new))
        self.binding_count += len(updates)
        for h in self.pod_handlers:
            bulk = getattr(h, "on_update_bulk", None)
            if bulk is not None:
                bulk(updates)
                continue
            cb = h.on_update
            if cb:
                for old, new in updates:
                    cb(old, new)
        return failures

    def patch_pod_status(self, pod: Pod, condition: dict,
                         nominated_node_name=None,
                         fence_token: Optional[int] = None) -> None:
        """nominated_node_name: None = leave unchanged, "" = clear (the
        preemption demotion patch), otherwise set."""
        self.check_fence(fence_token)
        current = self.pods.get(pod.uid)
        if current is None:
            raise NotFound(pod.uid)
        if condition:
            conditions = [c for c in current.status.conditions
                          if c.get("type") != condition.get("type")]
            conditions.append(condition)
            current.status.conditions = conditions
        if nominated_node_name is not None:
            current.status.nominated_node_name = nominated_node_name

    # -- nodes ----------------------------------------------------------------

    def create_node(self, node: Node) -> Node:
        if node.name in self.nodes:
            raise Conflict(node.name)
        self.nodes[node.name] = node
        for h in self.node_handlers:
            if h.on_add:
                h.on_add(node)
        return node

    def update_node(self, node: Node) -> Node:
        old = self.nodes.get(node.name)
        if old is None:
            raise NotFound(node.name)
        self.nodes[node.name] = node
        for h in self.node_handlers:
            if h.on_update:
                h.on_update(old, node)
        return node

    def delete_node(self, name: str) -> None:
        node = self.nodes.pop(name, None)
        if node is None:
            raise NotFound(name)
        for h in self.node_handlers:
            if h.on_delete:
                h.on_delete(node)

    # -- workloads (gang API) -------------------------------------------------

    def create_workload(self, w: Workload) -> Workload:
        self.workloads[w.metadata.name] = w
        for h in self.workload_handlers:
            if h.on_add:
                h.on_add(w)
        return w

    def get_workload(self, name: str) -> Optional[Workload]:
        return self.workloads.get(name)

    # -- storage (PVC / PV / StorageClass) ------------------------------------

    def create_pvc(self, pvc: PersistentVolumeClaim) -> PersistentVolumeClaim:
        self.pvcs[pvc.uid] = pvc
        for h in self.pvc_handlers:
            if h.on_add:
                h.on_add(pvc)
        return pvc

    def get_pvc(self, namespace: str, name: str
                ) -> Optional[PersistentVolumeClaim]:
        return self.pvcs.get(f"{namespace}/{name}")

    def bind_pvc(self, pvc: PersistentVolumeClaim,
                 pv: PersistentVolume) -> None:
        """PV controller's bind (the scheduler's PreBind triggers it):
        claimRef + volumeName + phases flip atomically in this in-memory
        model (pv_controller.go bind semantics)."""
        old = dataclasses.replace(pvc)
        pvc.volume_name = pv.name
        pvc.phase = "Bound"
        pv.claim_ref = pvc.uid
        for h in self.pvc_handlers:
            if h.on_update:
                h.on_update(old, pvc)

    def create_pv(self, pv: PersistentVolume) -> PersistentVolume:
        self.pvs[pv.name] = pv
        for h in self.pv_handlers:
            if h.on_add:
                h.on_add(pv)
        return pv

    def get_pv(self, name: str) -> Optional[PersistentVolume]:
        return self.pvs.get(name)

    def list_pvs(self) -> list[PersistentVolume]:
        return list(self.pvs.values())

    def create_storage_class(self, sc: StorageClass) -> StorageClass:
        self.storage_classes[sc.name] = sc
        return sc

    def get_storage_class(self, name: str) -> Optional[StorageClass]:
        return self.storage_classes.get(name)

    # -- DRA: ResourceSlices / ResourceClaims (resource/v1) -------------------

    def watch_resource_claims(self, h: WatchHandlers) -> None:
        self._register(self.claim_handlers, self.resource_claims, h)

    def watch_resource_slices(self, h: WatchHandlers) -> None:
        self._register(self.slice_handlers, self.resource_slices, h)

    def create_resource_slice(self, s: ResourceSlice) -> ResourceSlice:
        self.resource_slices[s.name] = s
        for h in self.slice_handlers:
            if h.on_add:
                h.on_add(s)
        return s

    def list_resource_slices(self) -> list[ResourceSlice]:
        return list(self.resource_slices.values())

    def create_resource_claim(self, c: ResourceClaim) -> ResourceClaim:
        self.resource_claims[c.uid] = c
        for h in self.claim_handlers:
            if h.on_add:
                h.on_add(c)
        return c

    def get_resource_claim(self, namespace: str, name: str
                           ) -> Optional[ResourceClaim]:
        return self.resource_claims.get(f"{namespace}/{name}")

    def list_resource_claims(self) -> list[ResourceClaim]:
        return list(self.resource_claims.values())

    def update_claim_status(self, claim: ResourceClaim) -> ResourceClaim:
        """Write allocation + reservedFor (the PreBind status write,
        dynamicresources.go PreBind → claim status update)."""
        old = self.resource_claims.get(claim.uid)
        if old is None:
            raise NotFound(claim.uid)
        self.resource_claims[claim.uid] = claim
        for h in self.claim_handlers:
            if h.on_update:
                h.on_update(old, claim)
        return claim

    # -- PodDisruptionBudgets (policy/v1) -------------------------------------

    def watch_pdbs(self, h: WatchHandlers) -> None:
        self._register(self.pdb_handlers, self.pdbs, h)

    def create_pdb(self, pdb: PodDisruptionBudget) -> PodDisruptionBudget:
        self.pdbs[pdb.uid] = pdb
        for h in self.pdb_handlers:
            if h.on_add:
                h.on_add(pdb)
        return pdb

    def delete_pdb(self, uid: str) -> None:
        pdb = self.pdbs.pop(uid, None)
        if pdb is None:
            raise NotFound(uid)
        for h in self.pdb_handlers:
            if h.on_delete:
                h.on_delete(pdb)

    def list_pdbs(self) -> list[PodDisruptionBudget]:
        """PDBs with a freshly computed status.disruptionsAllowed — the
        in-memory stand-in for the disruption controller
        (pkg/controller/disruption): expected = pods matching the
        selector, healthy = the bound ones."""
        out = []
        for pdb in self.pdbs.values():
            matched = [p for p in self.pods.values() if pdb.matches(p)]
            expected = len(matched)
            healthy = sum(1 for p in matched if p.spec.node_name)
            if pdb.min_available is not None:
                # percentage minAvailable rounds UP (the reference
                # disruption controller's GetScaledValueFromIntOrPercent
                # roundUp=true), so budgets are never overstated
                want = _resolve_maybe_percent(pdb.min_available, expected,
                                              round_up=True)
                allowed = healthy - want
            elif pdb.max_unavailable is not None:
                cap = _resolve_maybe_percent(pdb.max_unavailable, expected)
                allowed = cap - (expected - healthy)
            else:
                allowed = 0
            pdb.disruptions_allowed = max(allowed, 0)
            out.append(pdb)
        return out
