"""Batched assume/bind: the columnar commit edge of a drain.

The serial commit (`Scheduler._serial_commit`, the `ColumnarIngest`
gate off) classifies pods one by one (`_needs_per_pod_hooks`) and
`_fast_commit` then walks every pod's object graph inside
`NodeInfo.add_pod` (affinity property chains, request-dict walks, a
container walk for ports) — per pod, per drain, on the throughput-
bounding path.

`CommitEngine.commit` replaces both with one pass driven by the
columnar pod store's commit facts (state/batch.py `row_facts`, one
`CommitFacts` per signature row): the cache assume inlines to the
minimum mutation set with every signature-level fact hoisted, and the
bind enqueue is the existing bulk dispatcher extend. Behaviour is the
serial path's, field for field — tests/test_torch_ingest.py holds the
cache, the dispatcher traffic and the end state of both settings to
each other and to the JAX package. The JAX package's engine also feeds
its metrics, pod journey, events and SLI histograms here; the port has
none of those yet.
"""

from __future__ import annotations

from ..backend.cache import _PodState
from ..framework.types import next_generation


class CommitEngine:
    """Owned by one Scheduler; stateless between drains except the
    per-profile hook-fact memo."""

    def __init__(self, sched):
        self.sched = sched
        # profile name → whether the profile runs Reserve / Permit plugins
        self._profile_facts: dict = {}

    def _hooks(self, profile) -> bool:
        """The profile's half of `_needs_per_pod_hooks` (scheduler.py),
        hoisted: a pod takes the Reserve / Permit chain exactly when it is
        a gang member (spec.workload_ref) and this is True. The two must
        stay in lockstep."""
        has_rp = self._profile_facts.get(profile.name)
        if has_rp is None:
            fwk = profile.framework
            has_rp = bool(fwk.reserve_plugins or fwk.permit_plugins)
            self._profile_facts[profile.name] = has_rp
        return has_rp

    def commit(self, pd, out, names, gang_fast: bool) -> tuple:
        """One pass over a resolved drain: hook-free pods take the
        columnar assume + bulk bind enqueue; hook pods route through
        `_assume_and_bind` in drain order (same relative order as the
        serial path: hook binds inline, fast binds batched at the end).
        Returns (bound, failures)."""
        sched = self.sched
        profile = pd.profile
        qpis = pd.qpis
        n = pd.n
        has_rp = self._hooks(profile)
        cache = sched.cache
        pod_states = cache.pod_states
        nodes_get = cache.nodes.get
        get_or_create = cache._get_or_create
        move_to_head = cache._move_to_head
        assumed_set = cache.assumed_pods
        ttl = cache.ttl
        queue = sched.queue
        nominated = queue.nominator.nominated_pods
        nominator_delete = queue.nominator.delete
        in_flight = queue.in_flight_pods
        in_flight_pop = in_flight.pop
        now = sched.clock()
        # every placed pod has a table row, and `pd.facts` is the facts
        # list its batch's rows index (kept across a later table reset)
        facts = pd.facts
        tidx = pd.batch.tidx[:n].tolist()
        out_list = out.tolist()
        bound = 0
        failures: list = []
        bound_pods: list = []
        for i in range(n):
            a = out_list[i]
            qpi = qpis[i]
            if a < 0:
                failures.append(qpi)
                continue
            pod = qpi.pod
            if not gang_fast and has_rp and pod.spec.workload_ref:
                # the Reserve / Permit chain, in drain order
                sched._assume_and_bind(qpi, names[a], profile)
                bound += 1
                continue
            uid = pod.metadata.uid
            if uid in pod_states:
                in_flight_pop(uid, None)
                continue
            node_name = names[a]
            assumed = pod.with_node_name(node_name)
            # the queue entry's PodInfo becomes the cache's: rebinding its
            # pod to the assumed copy saves an allocation per commit, and
            # nothing reads the entry after the drain resolves
            pi = qpi.pod_info
            pi.pod = assumed
            qpi.pod = assumed   # keep the slot in sync with pod_info
            f = facts[tidx[i]]
            # -- columnar cache assume (NodeInfo.add_pod inlined over the
            # signature facts; field-for-field the serial mutation set) --
            item = nodes_get(node_name)
            if item is None:
                item = get_or_create(node_name)
            info = item.info
            info.pods.append(pi)
            if f.has_affinity:
                info.pods_with_affinity.append(pi)
            if f.has_anti_affinity:
                info.pods_with_required_anti_affinity.append(pi)
            req = info.requested
            req_get = req.get
            for k, v in f.req_items:
                req[k] = req_get(k, 0) + v
            info.non_zero_cpu += f.cpu_nz
            info.non_zero_mem += f.mem_nz
            if f.has_ports:
                info._update_ports(assumed, add=True)
            info.generation = next_generation()
            move_to_head(item)
            st = _PodState(pod=assumed, assumed=True, binding_finished=True)
            if ttl > 0:
                st.deadline = now + ttl
            pod_states[uid] = st
            assumed_set.add(uid)
            if nominated:
                nominator_delete(pod)
            in_flight_pop(uid, None)
            bound_pods.append((assumed, pod))
            if qpi.unschedulable_plugins:
                qpi.unschedulable_plugins = set()
            qpi.consecutive_errors_count = 0
        if not in_flight:
            queue.in_flight_events.clear()
        nb = len(bound_pods)
        if nb:
            sched.dispatcher.add_binds(bound_pods)
            sched.scheduled_count += nb
        return bound + nb, failures
