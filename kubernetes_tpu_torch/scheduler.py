"""The Scheduler: host orchestration around the PyTorch device program.

Counterpart of kubernetes_tpu/scheduler.py for the default profile without
the volume and DRA plugins (SchedulingGates, GangScheduling,
NodeUnschedulable, NodeName, TaintToleration, NodeAffinity, NodePorts,
NodeResourcesFit, BalancedAllocation, PodTopologySpread, InterPodAffinity,
ImageLocality, and DefaultPreemption as the PostFilter).
The queue drains in device-sized batches; the drain compiler splits each
batch into same-signature "uniform" runs (closed-form top-L, ops/program.py
run_uniform), same-signature group "wave" spans (ops/program.py run_wave),
mixed-signature "wavescan" spans (the plan program, ops/program.py
run_plan) and "scan" spans (ops/program.py run_batch, with the group
branch when the drain needs groups); the carry, group counts included,
chains on the device from span to span and drain to drain; the commit
assumes the winners in the host cache and bulk-binds them through the
dispatcher. A pod no node fits is diagnosed from the device filter masks
(ops/program.py diagnose_row), as the JAX package does by default, then
runs the PostFilter: DefaultPreemption's Evaluator picks victims through
the batched device dry run (ops/program.py dry_run_select_victims),
deletes them and nominates the node. While nominations are pending, the
drains fold the nominated pods into the fit as a resource overlay of
run_uniform / run_batch, with per-pod self-exclusion for the nominated
pods themselves.

Gangs (pods with a `workloadRef`) take the JAX package's route: the
GangScheduling plugin holds a gang's members out of the queue until its
Workload exists and minCount members are known (PreEnqueue quorum); a
drain that holds a whole gang's remaining quorum dispatches it first, as
ONE all-or-nothing `("gang", needed)` span (ops/gang.py run_gang: the
closed-form tier for a single-signature LeastAllocated gang, else the scan
tier, with the topology-contiguity column when
`gang_contiguity_weight` > 0). An accepted gang commits atomically with
no Reserve / Permit; a rejected gang was unwound on the device and fails
through `_fail_rejected_gang` (PostFilter on its infeasible members —
how a gang preempts a gang). A gang the device program does not take
(host-port members, group constraints, pending nominations, parked
members, fewer members than its quorum in the drain) rides the generic
drains and the reference's Permit barrier at commit (Reserve, Permit,
WaitOnPermit parking, the timeout sweep in `flush_queues`).
`gang_dispatch` counts gang drains by outcome (placed / rejected /
fallback), the labels of the JAX package's metric.

Every device drain opens the JAX package's host spans on `tracer`
(scheduling_cycle → schedule_batch → host_build with host_snapshot /
host_tensorize / host_group_seed / host_cache, device_dispatch,
cluster_probe) and keeps its phase seconds on the pending drain; after
the dispatch it launches `cluster_probe` (ops/program.py) on the
post-drain carry, and the commit resolves that result into
`_last_probe` — the probe copy rides the drain's event, which the commit
has already waited on.

`Scheduler(api, mesh=make_mesh(D))` (parallel/sharding.py) splits the
node axis over D shards with one controller, as the JAX package's mesh
does: every uniform run, scan span, dirty-row upload and drain probe runs
its node-sharded program (run_uniform_sharded, run_batch_sharded,
scatter_rows_sharded, cluster_probe_sharded), with bind maps equal to the
single-device Scheduler's. The mesh takes the lean tiers only; a drain
that needs a program the mesh does not have yet raises
NotImplementedError naming it (group drains and plan spans:
run_plan_sharded; gangs: run_gang_sharded; pending nominations: the host
path; the SanitizerRails gate). FitError diagnosis, the dry run and
explain_pod read single-device blocks of the staging arrays on the
mesh's first device.

Where the JAX package degrades, this one refuses:
- no device-fault circuit breaker and no host scheduling path: a fault in
  a build or a launch raises; group drains the JAX package hands to its
  host greedy run the device scan here, and drains the JAX package hands
  to its host scheduling path (`_schedule_one_host`: nominations the
  overlay cannot represent) raise NotImplementedError;
- a pod that needs a feature this port lacks — volumes or DRA claims,
  extenders, a PreBind plugin, a Reserve / Permit plugin other than
  GangScheduling — raises NotImplementedError naming the missing piece,
  and is never scheduled with a reduced plugin set.

`Scheduler(api, device=None)` runs on "cuda"; without a CUDA device it
raises unless the caller asks for `device="cpu"` (the plain PyTorch
versions of the kernels — what the tests use). `config` (config/,
KubeSchedulerConfiguration) supplies profiles, batch size, backoffs and
the feature gates; with the SanitizerRails gate on, the dispatch runs
under the rails' sync guard, `score_probe` checks each drain's first row
for NaN / inf, and the carries kept for rewind are checked at commit
(analysis/rails.py).
"""

from __future__ import annotations

import time as _time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from .api.types import DEFAULT_SCHEDULER_NAME, Node, Pod
from .backend.apiserver import APIServer, WatchHandlers
from .backend.cache import Cache, Snapshot, _PodState
from .backend.dispatcher import APICall, APIDispatcher, CallType
from .backend.queue import ClusterEventWithHint, SchedulingQueue
from .backend.workloadmanager import (WorkloadManager, parse_workload_ref,
                                      pod_group_min_count)
from .framework.interface import Code, CycleState, Status
from .framework.runtime import Framework
from .framework.types import (ActionType, ClusterEvent, Diagnosis,
                              EventResource, FitError, PodInfo,
                              QueuedPodInfo)
from .ops import program as prog
from .ops.gang import GangXs, run_gang
from .ops.groups import GroupFamilies, scatter_new_rows, to_device
from .ops.program import (PROBE_DOM_STATS, PROBE_STATS, PodXs,
                          ScoreConfig, WaveXs, cluster_probe, diagnose_row,
                          initial_carry, run_batch, run_plan, run_uniform,
                          run_wave, static_norm_ok, table_from_batch,
                          with_cache_sig)
from .parallel.sharding import (Shards, cluster_probe_sharded,
                                initial_carry_sharded, norm_device,
                                run_batch_sharded, run_uniform_sharded,
                                with_cache_sig_sharded)
from .plugins import noderesources as nr
from .plugins.defaultbinder import DefaultBinder
from .plugins.defaultpreemption import DefaultPreemption
from .plugins.gangscheduling import GangScheduling
from .plugins.imagelocality import ImageLocality
from .plugins.node_basics import (NodeName, NodePorts, NodeUnschedulable,
                                  PrioritySort, SchedulingGates,
                                  TaintToleration)
from .plugins.interpodaffinity import InterPodAffinity
from .plugins.nodeaffinity import NodeAffinity
from .plugins.podtopologyspread import PodTopologySpread
from .state.batch import BatchBuilder
from .state.convert import (dom_from_numpy, gang_xs_from_numpy,
                            pod_xs_from_numpy)
from .state.tensorize import (EFFECT_PREFER_NO_SCHEDULE, ClusterState,
                              pow2_at_least)
from .utils.tracing import NOOP_TRACER, PhaseTrack

EVENT_NODE_ADD = ClusterEvent(EventResource.NODE, ActionType.ADD)
EVENT_ASSIGNED_POD_DELETE = ClusterEvent(EventResource.ASSIGNED_POD,
                                         ActionType.DELETE)
EVENT_ASSIGNED_POD_ADD = ClusterEvent(EventResource.ASSIGNED_POD,
                                      ActionType.ADD)

# default plugin weights (apis/config/v1/default_plugins.go:30-93)
DEFAULT_WEIGHTS = {
    "TaintToleration": 3,
    "NodeAffinity": 2,
    "PodTopologySpread": 2,
    "InterPodAffinity": 2,
    "NodeResourcesFit": 1,
    "NodeResourcesBalancedAllocation": 1,
    "ImageLocality": 1,
}


def node_update_action(old: Node, new: Node) -> ActionType:
    """Per-property node update flags (eventhandlers.go:88-99)."""
    flags = ActionType(0)
    if new.status.allocatable != old.status.allocatable:
        flags |= ActionType.UPDATE_NODE_ALLOCATABLE
    if new.metadata.labels != old.metadata.labels:
        flags |= ActionType.UPDATE_NODE_LABEL
    if (new.spec.taints != old.spec.taints
            or new.spec.unschedulable != old.spec.unschedulable):
        flags |= ActionType.UPDATE_NODE_TAINT
    if new.status.declared_features != old.status.declared_features:
        flags |= ActionType.UPDATE_NODE_DECLARED_FEATURE
    return flags


def pod_update_action(old: Pod, new: Pod) -> ActionType:
    """Per-property pod update flags (eventhandlers.go
    podSchedulingPropertiesChange)."""
    from .api import resources as res
    flags = ActionType(0)
    if new.metadata.labels != old.metadata.labels:
        flags |= ActionType.UPDATE_POD_LABEL
    if new.spec.scheduling_gates != old.spec.scheduling_gates:
        flags |= ActionType.UPDATE_POD_SCHEDULING_GATES
    if new.spec.tolerations != old.spec.tolerations:
        flags |= ActionType.UPDATE_POD_TOLERATION
    old_req = res.pod_requests(old)
    new_req = res.pod_requests(new)
    if any(new_req.get(k, 0) < v for k, v in old_req.items()):
        flags |= ActionType.UPDATE_POD_SCALE_DOWN
    return flags


def default_plugin_factories(client=None, ns_lister=None) -> list:
    """Zero-argument factories of the default profile without the volume
    and DRA plugins, in the reference filter order (apis/config/v1/
    default_plugins.go:30); each call builds one fresh plugin."""
    factories = [SchedulingGates, GangScheduling, PrioritySort,
                 NodeUnschedulable, NodeName, TaintToleration, NodeAffinity,
                 NodePorts, nr.Fit, nr.BalancedAllocation, PodTopologySpread,
                 lambda: InterPodAffinity(ns_lister=ns_lister),
                 ImageLocality]
    if client is not None:
        factories.append(lambda: DefaultBinder(client))
    return factories


def default_plugins(client=None, ns_lister=None) -> list:
    """The default profile without the volume and DRA plugins."""
    return [f() for f in default_plugin_factories(client, ns_lister)]


@dataclass
class Profile:
    name: str = DEFAULT_SCHEDULER_NAME
    framework: Optional[Framework] = None
    score_config: ScoreConfig = ScoreConfig()


def _needs_per_pod_hooks(profile: Profile, spec) -> bool:
    """True when a pod must run the Reserve / Permit chain in
    `_assume_and_bind` (kubernetes_tpu/scheduler.py:179-192). The port's
    only Reserve / Permit plugin is GangScheduling (the JAX package's
    `gang_only_hooks` is always on) and it refuses PreBind plugins and
    volume or claim pods, so the chain runs exactly for gang members."""
    fwk = profile.framework
    return bool(spec.workload_ref
                and (fwk.reserve_plugins or fwk.permit_plugins))


@dataclass
class _RunRec:
    """One dispatched device run awaiting readback. `carry_in` is the carry
    the run read — kept for uniform runs and closed-form gang runs, the
    kinds that can rewind and replay (no kernel writes into its input
    carry)."""

    # "uniform" | "scan" | "wave" | "wavescan" | "gang"
    kind: str
    i: int
    j: int
    carry_in: object
    result: object            # device tensor: packed or assignments
    L: int = 0
    J: int = 0
    span: tuple = ("scan",)
    # the sanitizer rails' record of carry_in (analysis/rails.py hold),
    # checked when the run resolves; None with the rails off
    held: object = None


@dataclass
class _WaitingPodRec:
    """A pod parked at Permit (reference runtime/waiting_pods_map.go): its
    resources stay assumed in the cache, and counted by the device carry,
    until allowed or rejected."""

    qpi: QueuedPodInfo
    assumed: Pod
    node_name: str
    cycle_state: CycleState
    deadline: float
    wait_plugin: str = ""


class _WaitingPodHandle:
    """The WaitingPod the Permit plugins see (framework.WaitingPod). With a
    single permit plugin per profile, one Allow releases the pod."""

    def __init__(self, scheduler: "Scheduler", uid: str):
        self._scheduler = scheduler
        self._uid = uid

    def allow(self, plugin_name: str) -> None:
        self._scheduler._allow_waiting(self._uid)

    def reject(self, plugin_name: str, reason: str = "") -> None:
        self._scheduler._reject_waiting(self._uid)


@dataclass
class _PendingDrain:
    """A dispatched-but-uncommitted drain: the device work is queued on
    the stream; the host commit runs when it is resolved."""

    qpis: list
    profile: object
    batch: object             # PodBatch (numpy) — kept for replay
    table: object             # PodTableDev
    na: object                # NodeArrays used at dispatch
    n: int
    groups_needed: bool = False
    records: list = field(default_factory=list)
    done: object = None       # CUDA event recorded after the dispatch
    # nominated-pod resource overlay active at dispatch (None = none) and
    # the drain pods' own nominated rows (i32 [n], -1 = none): a replay
    # reproduces the dispatch-time overlay
    ovl: object = None
    nom: object = None
    # whole-gang drain: (workload ref, remaining quorum, minCount), and
    # its resolved verdict, raw per-member assignments and placed count
    gang: object = None
    gang_accepted: bool = False
    gang_raw: object = None
    gang_placed: int = 0
    # monotonic drain id (the spans' `drain` attribute, the probe
    # snapshot's drainId)
    drain_id: int = 0
    # per-phase wall seconds, accumulated from dispatch through commit
    phases: dict = field(default_factory=dict)
    # in-flight cluster_probe result (device tensors): launched right
    # after the drain over the post-drain carry, resolved to a snapshot
    # dict when this drain commits
    probe: object = None
    # the drain's device_dispatch span: its commit adds `commit_start`
    # (time.perf_counter) and `commit_s`
    span: object = None

    def ready(self) -> bool:
        return self.done is None or self.done.query()


def _resolve_device(device, mesh=None) -> torch.device:
    if mesh is not None:
        first = mesh.devices[0]
        if device is not None and norm_device(device) != first:
            raise ValueError(f"device {device} differs from the mesh's "
                             f"first device {first}")
        device = first
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "kubernetes_tpu_torch.Scheduler runs on a CUDA device by "
            "default and none is available; pass device=\"cpu\" to run the "
            "plain PyTorch versions of the kernels on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


class Scheduler:
    """scheduler.Scheduler (scheduler.go:74)."""

    UNIFORM_RUN_MIN = 16

    def __init__(self, client: APIServer,
                 profiles: Optional[list[Profile]] = None,
                 batch_size: Optional[int] = None,
                 clock: Callable[[], float] = _time.monotonic,
                 device=None, tracer=None, config=None, mesh=None):
        """`tracer` (utils/tracing.py Tracer) records the drain's span
        tree — scheduling_cycle, host_build with its host_* phases,
        device_dispatch, cluster_probe; NOOP_TRACER when None.

        `config` (config.KubeSchedulerConfiguration) supplies the feature
        gates, profiles, batch size, queue backoffs and API retry policy,
        as in the JAX package; explicitly passed arguments win. A field or
        gate the port has no machinery for, set away from its default,
        raises NotImplementedError (config.refuse_unported).

        `mesh` (parallel/sharding.py Mesh, a power of two of shards)
        runs the lean tiers node-sharded; `device` is then the mesh's
        first device (a different one raises ValueError)."""
        if mesh is not None and mesh.size & (mesh.size - 1):
            raise ValueError(
                f"mesh size {mesh.size} must be a power of two: the pow2 "
                "node-bucket padding guarantees shard divisibility only "
                "then (run_batch_sharded precondition)")
        self.mesh = mesh
        self.device = _resolve_device(device, mesh)
        self.client = client
        self.clock = clock
        from .config import build_profiles, refuse_unported
        from .config.features import default_gate
        self.feature_gates = default_gate(
            config.feature_gates if config is not None else None)
        queue_backoffs = {}
        # the JAX package's knob, accepted and treated as 100: the device
        # program filters and scores every node
        self.percentage_of_nodes_to_score = 100
        if config is not None:
            config.validate()
            refuse_unported(config)
            if profiles is None:
                profiles = build_profiles(config, client)
            if batch_size is None:
                batch_size = config.batch_size
            self.percentage_of_nodes_to_score = (
                config.percentage_of_nodes_to_score)
            queue_backoffs = dict(
                pod_initial_backoff=config.pod_initial_backoff_seconds,
                pod_max_backoff=config.pod_max_backoff_seconds)
        self.batch_size = 512 if batch_size is None else batch_size
        if profiles is None:
            fwk = Framework(DEFAULT_SCHEDULER_NAME, default_plugins(client),
                            weights=dict(DEFAULT_WEIGHTS))
            profiles = [Profile(framework=fwk)]
        for prof in profiles:
            fwk = prof.framework
            other = [p.name() for p in fwk.reserve_plugins
                     + fwk.permit_plugins
                     if not isinstance(p, GangScheduling)]
            if fwk.pre_bind_plugins or other:
                names = sorted(set(other) | {p.name() for p in
                                             fwk.pre_bind_plugins})
                raise NotImplementedError(
                    f"profile {prof.name!r}: PreBind plugins and Reserve / "
                    f"Permit plugins other than GangScheduling ({names}: "
                    "volumes, DRA) are not ported to kubernetes_tpu_torch "
                    "yet")
            for p in fwk.plugins:
                if isinstance(p, GangScheduling):
                    p.handle = self
        self.profiles: dict[str, Profile] = {p.name: p for p in profiles}

        self.cache = Cache(clock=clock)
        self.snapshot = Snapshot()
        self.state = ClusterState(device=str(self.device))
        if mesh is not None:
            # the node bucket must never be smaller than the mesh
            self.state.dims.nodes = max(self.state.dims.nodes, mesh.size)
        self.workload_manager = WorkloadManager()
        # pods parked at Permit (WaitOnPermit): uid -> _WaitingPodRec
        self._waiting_pods: dict[str, _WaitingPodRec] = {}
        # weight of the per-domain member-count column in the gang scan
        # (0 = off, the JAX package's default; its harness sets it)
        self.gang_contiguity_weight = 0
        self._gang_dom = None        # device i32 [N] node → domain ids
        self._gang_dom_key = None    # (statics_gen, node bucket)
        self._gang_ndom = 1          # domain count of the cached ids
        # gang drains by outcome (the JAX package's gang_dispatch metric)
        self.gang_dispatch = {"placed": 0, "rejected": 0, "fallback": 0}
        default_list = next(iter(self.profiles.values())).framework.plugins
        self.builder = BatchBuilder(
            self.state,
            spread_plugin=next((p for p in default_list
                                if p.name() == "PodTopologySpread"), None),
            ipa_plugin=next((p for p in default_list
                             if p.name() == "InterPodAffinity"), None))
        self.dispatcher = APIDispatcher(client=client,
                                        on_bind_error=self._on_bind_error)
        if config is not None:
            self.dispatcher.retry_max_attempts = config.api_retry_max_attempts
            self.dispatcher.retry_base_seconds = config.api_retry_base_seconds
        default_fwk = next(iter(self.profiles.values())).framework
        self.queue = SchedulingQueue(
            pre_enqueue=self._make_pre_enqueue(default_fwk),
            queueing_hints=self._build_queueing_hints(default_fwk),
            clock=clock, **queue_backoffs)
        from .compiler.plan import DrainCompiler
        self.compiler = DrainCompiler(builder=self.builder, state=self.state)
        self._wire_preemption(client)
        self._register_event_handlers()

        self.schedule_attempts = 0
        self.scheduled_count = 0
        self.unschedulable_count = 0
        self.error_count = 0
        self.device_batches = 0
        self.preemption_attempts = 0
        # uniform runs whose exactness or depth flag failed (rewound and
        # replayed at commit)
        self.uniform_rewinds = 0
        # closed-form gang runs whose exactness or depth flag failed
        # (replayed on the scan tier at commit)
        self.gang_replays = 0
        # per-pod consecutive bind-error count → escalating error backoff
        self._bind_errors: dict[str, int] = {}
        # device-resident carry, reused across drains while no event
        # outside the device's own placements touches node state
        self._device_carry = None
        self._carry_profile = None   # profile whose cfg filled the sig cache
        # nominator version the resident carry's SigCache was computed
        # under (-1 = no nominations): the cached fit_ok holds the
        # dispatch-time overlay, so any nomination change zeroes the sig
        # exactly like a profile switch
        self._carry_ovl_fp = -1
        self._builder_reset_seen = 0
        # dispatched-but-uncommitted drains (async commit pipeline; the
        # JAX package's default with SchedulerAsyncAPICalls on)
        self._pending: deque[_PendingDrain] = deque()
        self.max_inflight_drains = 8
        # device copy of the PodTable, re-uploaded when rows are added
        self._table_dev = None
        self._table_dev_version = -1
        # resident group state: GroupsDev on the device, the active
        # families, the (device rows, node bucket) capacity it was built
        # for, and the table rows already seeded
        self._gd_dev = None
        self._gd_fam = None
        self._gd_capacity = None
        self._seeded_rows = 0
        # run_wave and run_plan records resolved, and their packed stats
        # summed: merge waves (one per plan span), conflict-cut events (a
        # plan span's conflicting pods), serially placed pods, and the first
        # wave's accepted prefix of the most recent runs
        self.wave_runs = 0
        self.plan_runs = 0
        self.wave_stats = {"waves": 0, "conflicts": 0, "serial_steps": 0,
                           "first_prefix": deque(maxlen=256)}
        self.tracer = tracer or NOOP_TRACER
        # the open phase's name, readable from any thread
        self.phase_track = PhaseTrack()
        self._drain_seq = 0          # monotonic drain id (0: none)
        # every committed drain's phase seconds summed by phase name (the
        # JAX package's drain_phase histogram sums)
        self.drain_phase_seconds: dict[str, float] = {}
        # on-device cluster analytics (ClusterStateProbe, on as in the JAX
        # package): one cluster_probe per device drain, resolved at commit
        # into the latest snapshot dict
        self._last_probe = None
        # runtime sanitizer rails (analysis/rails.py): process-global, like
        # the sync debug mode they drive — the gate of the most recently
        # constructed Scheduler wins
        from .analysis.rails import GLOBAL as _rails
        self.rails = _rails
        rails_on = self.feature_gates.enabled("SanitizerRails")
        if rails_on and mesh is not None:
            raise NotImplementedError(
                "the SanitizerRails gate on a node-sharded mesh (the rails' "
                "sync guard and score probe over the shards) is not ported "
                "to kubernetes_tpu_torch yet")
        self.rails.enable(rails_on)

    # -- wiring ---------------------------------------------------------------

    def _wire_preemption(self, client) -> None:
        """DefaultPreemption as every profile's PostFilter, with the live
        handles the Evaluator needs (dispatcher, nominator, snapshot, PDB
        lister) and the batched device dry run (BatchedPreemptionDryRun
        is fixed at its default, on)."""
        from .framework.preemption import DeviceDryRunContext
        for prof in self.profiles.values():
            fwk = prof.framework
            dp = next((p for p in fwk.plugins
                       if isinstance(p, DefaultPreemption)), None)
            if dp is None:
                dp = DefaultPreemption()
                fwk.plugins.append(dp)
                fwk.post_filter_plugins.append(dp)
            dp.wire(fwk, self.dispatcher, self.queue.nominator,
                    self.snapshot, client.list_pdbs,
                    DeviceDryRunContext(state=self.state,
                                        builder=self.builder,
                                        snapshot=self.snapshot,
                                        mesh=self.mesh))

    @staticmethod
    def _make_pre_enqueue(fwk: Framework):
        """PreEnqueue gate with a constant-time fast path: when the only
        PreEnqueue plugins are SchedulingGates and GangScheduling, a pod
        with neither scheduling gates nor a workloadRef cannot be
        gated."""
        run = fwk.run_pre_enqueue_plugins
        if not all(p.name() in ("SchedulingGates", "GangScheduling")
                   for p in fwk.pre_enqueue_plugins):
            return run
        ok = Status.success()

        def pre_enqueue(pod: Pod) -> Status:
            spec = pod.spec
            if not spec.scheduling_gates and not spec.workload_ref:
                return ok
            return run(pod)
        return pre_enqueue

    @staticmethod
    def _build_queueing_hints(
            fwk: Framework) -> dict[str, list[ClusterEventWithHint]]:
        hints: dict[str, list[ClusterEventWithHint]] = {}
        for p in fwk.plugins:
            if hasattr(p, "events_to_register"):
                hints[p.name()] = list(p.events_to_register())
        return hints

    # -- framework.Handle surface for the Permit plugin -----------------------

    def get_workload(self, namespace: str, name: str):
        return self.client.get_workload(name)

    def activate(self, pods: list[Pod]) -> None:
        self.queue.activate(pods)

    def now(self) -> float:
        return self.clock()

    def get_waiting_pod(self, uid: str):
        if uid in self._waiting_pods:
            return _WaitingPodHandle(self, uid)
        return None

    def _allow_waiting(self, uid: str) -> None:
        """WaitOnPermit resolved positively: complete the parked pod's
        binding (schedule_one.go:302 onward; no PreBind plugin runs)."""
        rec = self._waiting_pods.pop(uid, None)
        if rec is None:
            return
        self.cache.finish_binding(rec.assumed)
        self.dispatcher.add(APICall(CallType.BIND, rec.assumed,
                                    node_name=rec.node_name))
        self.scheduled_count += 1
        rec.qpi.unschedulable_plugins = set()
        rec.qpi.consecutive_errors_count = 0

    def _reject_waiting(self, uid: str) -> None:
        """WaitOnPermit rejection (timeout or plugin): unreserve, release
        the assumed resources (which the device carry counts, so it
        reseeds), requeue as unschedulable."""
        rec = self._waiting_pods.pop(uid, None)
        if rec is None:
            return
        pod = rec.qpi.pod
        profile = self.profiles.get(pod.spec.scheduler_name)
        if profile is not None:
            profile.framework.run_reserve_plugins_unreserve(
                rec.cycle_state, rec.assumed, rec.node_name)
        try:
            self.cache.forget_pod(rec.assumed)
        except (KeyError, ValueError):
            pass
        self._invalidate_device_state()
        err = FitError(pod, 0)
        err.diagnosis.unschedulable_plugins = {rec.wait_plugin or "Permit"}
        self._handle_failure(rec.qpi, err, try_preempt=False)

    def _register_event_handlers(self) -> None:
        """eventhandlers.go:499 addAllEventHandlers: nodes replay before
        pods so bound pods land on real cache entries."""
        self.client.watch_nodes(WatchHandlers(
            on_add=self._on_node_add, on_update=self._on_node_update,
            on_delete=self._on_node_delete))
        self.client.watch_pods(WatchHandlers(
            on_add=self._on_pod_add, on_update=self._on_pod_update,
            on_delete=self._on_pod_delete,
            on_add_bulk=self._on_pod_add_bulk))
        if hasattr(self.client, "watch_workloads"):
            self.client.watch_workloads(WatchHandlers(
                on_add=self._on_workload_add))
        if hasattr(self.client, "watch_pdbs"):
            self.client.watch_pdbs(WatchHandlers(
                on_add=self._on_pdb_change, on_update=self._on_pdb_change,
                on_delete=self._on_pdb_change))

    def _responsible(self, pod: Pod) -> bool:
        return pod.spec.scheduler_name in self.profiles

    # -- event handlers (eventhandlers.go) ------------------------------------

    def _invalidate_device_state(self) -> None:
        self._device_carry = None

    def _on_pod_add(self, pod: Pod) -> None:
        self.workload_manager.add_pod(pod)
        if pod.spec.node_name:
            self.cache.add_pod(pod)
            self._invalidate_device_state()
            self.queue.move_all_to_active_or_backoff_queue(
                EVENT_ASSIGNED_POD_ADD, None, pod)
        elif self._responsible(pod):
            self.queue.add(pod)
            # a new gang member can un-gate ITS group (PreEnqueue quorum),
            # and only once the group can reach quorum
            if (pod.spec.workload_ref
                    and self._gang_quorum_possible(pod)):
                self.queue.retry_gated(ref=pod.spec.workload_ref)

    def _on_pod_add_bulk(self, pods: list[Pod]) -> None:
        """Batch ingest: unbound pods owned by this scheduler take the
        queue's bulk add; bound or foreign pods take the per-pod path.
        Gang members register in the WorkloadManager for the whole chunk
        FIRST, so a gang arriving complete in one chunk passes PreEnqueue
        at its own add, and the quorum retry runs once per gang."""
        plain: list[Pod] = []
        gang_pods: list[Pod] = []
        for pod in pods:
            if pod.spec.node_name or not self._responsible(pod):
                self._on_pod_add(pod)
            elif pod.spec.workload_ref:
                self.workload_manager.add_pod(pod)
                gang_pods.append(pod)
            else:
                self.workload_manager.add_pod(pod)
                plain.append(pod)
        if plain:
            self.queue.add_bulk(plain)
        if gang_pods:
            self.queue.add_bulk(gang_pods)
            for ref in dict.fromkeys(p.spec.workload_ref for p in gang_pods):
                member = next(p for p in gang_pods
                              if p.spec.workload_ref == ref)
                if self._gang_quorum_possible(member):
                    self.queue.retry_gated(ref=ref)

    def _on_workload_add(self, workload) -> None:
        """A Workload's arrival can un-gate its gang's pods (PreEnqueue)
        and requeue unschedulable members (gangscheduling.go:100); only the
        arriving workload's refs are re-evaluated."""
        name = workload.metadata.name
        for ref in self.queue.gated_refs():
            if parse_workload_ref(ref)[0] == name:
                self.queue.retry_gated(ref=ref)
        self.queue.move_all_to_active_or_backoff_queue(
            ClusterEvent(EventResource.WORKLOAD, ActionType.ADD),
            None, workload)

    def _gang_quorum_possible(self, pod: Pod) -> bool:
        """True when the pod's group has reached its minCount in KNOWN
        pods — the only state in which a gated-member retry can move
        anything (PreEnqueue quorum, gangscheduling.go:120-158)."""
        name, group = parse_workload_ref(pod.spec.workload_ref)
        workload = self.client.get_workload(name)
        if workload is None:
            return False
        min_count = pod_group_min_count(workload, group)
        if min_count is None:
            return False
        info = self.workload_manager.pod_group_info(pod)
        return info is not None and len(info.all_pods) >= min_count

    def _on_pod_update(self, old: Pod, new: Pod) -> None:
        self.workload_manager.update_pod(old, new)
        if new.spec.node_name:
            if old.spec.node_name:
                self.cache.update_pod(old, new)
                self._invalidate_device_state()
                flags = pod_update_action(old, new)
                if flags:
                    self.queue.move_all_to_active_or_backoff_queue(
                        ClusterEvent(EventResource.ASSIGNED_POD, flags),
                        old, new)
            else:
                # became bound: our own bind echo confirms a pod the device
                # carry already accounts for; anything else is external
                if not self.cache.is_assumed_pod(new):
                    self._invalidate_device_state()
                self._bind_errors.pop(new.uid, None)
                self.cache.add_pod(new)
                self.queue.delete(new)
                self.queue.move_all_to_active_or_backoff_queue(
                    EVENT_ASSIGNED_POD_ADD, old, new)
        elif self._responsible(new):
            self.queue.update(old, new)
            flags = pod_update_action(old, new)
            if flags:
                self.queue.move_all_to_active_or_backoff_queue(
                    ClusterEvent(EventResource.POD, flags), old, new)

    def _on_pod_delete(self, pod: Pod) -> None:
        self.workload_manager.delete_pod(pod)
        if pod.uid in self._waiting_pods:
            self._reject_waiting(pod.uid)
        self._bind_errors.pop(pod.uid, None)
        if pod.spec.node_name:
            self.cache.remove_pod(pod)
            self._invalidate_device_state()
            self.queue.move_all_to_active_or_backoff_queue(
                EVENT_ASSIGNED_POD_DELETE, pod, None)
        else:
            self.queue.delete(pod)

    def _on_node_add(self, node: Node) -> None:
        self.cache.add_node(node)
        self._invalidate_device_state()
        self.queue.move_all_to_active_or_backoff_queue(EVENT_NODE_ADD, None,
                                                       node)

    def _on_node_update(self, old: Node, new: Node) -> None:
        self.cache.update_node(old, new)
        self._invalidate_device_state()
        flags = node_update_action(old, new)
        if flags:
            self.queue.move_all_to_active_or_backoff_queue(
                ClusterEvent(EventResource.NODE, flags), old, new)

    def _on_node_delete(self, node: Node) -> None:
        self.cache.remove_node(node)
        self._invalidate_device_state()

    def _on_pdb_change(self, *args) -> None:
        """A PDB change can alter preemption viability for pods rejected
        by DefaultPreemption. Their rejectors are the FILTER plugins, whose
        hints do not cover PDB events, so this is the wildcard event (a
        conservative requeue)."""
        old, new = (args[0], args[1]) if len(args) == 2 else (None, args[0])
        self.queue.move_all_to_active_or_backoff_queue(
            ClusterEvent(EventResource.WILDCARD, ActionType.ALL,
                         "PodDisruptionBudgetChange"),
            old, new)

    # -- scheduling: batch path ----------------------------------------------

    def schedule_pending(self, max_batches: int = 0,
                         wait: bool = True) -> int:
        """Drain + schedule everything currently pending. Returns the net
        number of binds committed. With `wait=False` the call returns after
        dispatching; results still in flight commit on a later call."""
        start = self.scheduled_count
        batches = 0
        while True:
            self.commit_ready()
            self.queue.flush_backoff_completed()
            if not len(self.queue.active_q):
                if not wait or not self._pending:
                    break
                self.wait_pending()
                continue    # a commit may have re-activated pods
            qlen = len(self.queue.active_q)
            if not wait and qlen < self.batch_size:
                # adaptive batching: let the queue accumulate; dispatch
                # early only to fill an idle pipeline with half a drain
                if self._pending or qlen < max(self.batch_size // 2, 1):
                    break
            qpis = self.queue.drain(self.batch_size)
            if not qpis:
                break
            with self.tracer.span("scheduling_cycle",
                                  pods=len(qpis)) as cycle:
                before = self.scheduled_count
                with self.tracer.span("schedule_batch"):
                    self._schedule_batch(qpis)
                while len(self._pending) > self.max_inflight_drains:
                    self._commit_next()
                with self.tracer.span("dispatcher_flush"):
                    self.dispatcher.flush()
                cycle.set(bound=self.scheduled_count - before)
            batches += 1
            if max_batches and batches >= max_batches:
                break
        if wait:
            self.wait_pending()
        elif len(self.dispatcher):
            self.dispatcher.flush()
        return self.scheduled_count - start

    def commit_ready(self, limit: int = 0) -> int:
        """Commit in-flight drains whose device work has finished, head
        first (commit order IS dispatch order)."""
        done = 0
        while self._pending and self._pending[0].ready():
            self._commit_next()
            done += 1
            if limit and done >= limit:
                break
        return done

    def wait_pending(self) -> None:
        """Commit every in-flight drain and flush the dispatcher."""
        self._drain_pending()
        self.dispatcher.flush()

    def prime(self) -> None:
        """Pre-build the host snapshot and staging arrays from the current
        cluster state (WaitForCacheSync analog)."""
        self._drain_pending()
        self.cache.update_snapshot(self.snapshot)
        self.state.apply_snapshot(self.snapshot)
        self.state.ensure_arrays()

    def flush_queues(self) -> None:
        """SchedulingQueue.Run periodic work (scheduling_queue.go:406-413)
        and the WaitOnPermit timeout sweep (waiting_pods_map.go timers)."""
        self._drain_pending()
        now = self.clock()
        for uid, rec in list(self._waiting_pods.items()):
            if rec.deadline <= now:
                self._reject_waiting(uid)
        self.queue.flush_backoff_completed()
        self.queue.flush_unschedulable_leftover()

    def _refuse_host_path(self, qpis) -> None:
        """The JAX package schedules a drain whose nominations the overlay
        cannot represent on its host path, one pod at a time; the port has
        no host scheduling path."""
        why = ("pending nominations on the node-sharded mesh, where the "
               "overlay is single-device only" if self.mesh is not None
               else "nominations the device overlay cannot represent (a "
               "lower-priority or host-port nominated pod, or group "
               "constraints)")
        raise NotImplementedError(
            f"drain of {len(qpis)} pods under {why}: the host scheduling "
            "path (_schedule_one_host) is not ported to "
            "kubernetes_tpu_torch yet")

    def _schedule_batch(self, qpis: list[QueuedPodInfo]) -> None:
        if (self.queue.nominator.nominated_pods
                and not self._overlay_eligible(qpis)):
            self._refuse_host_path(qpis)
        # route per profile: each maximal same-profile stretch runs with
        # ITS weights/strategy, in queue order
        i = 0
        while i < len(qpis):
            name = qpis[i].pod.spec.scheduler_name
            j = i + 1
            while j < len(qpis) and qpis[j].pod.spec.scheduler_name == name:
                j += 1
            profile = self.profiles.get(name)
            if profile is None:
                for q in qpis[i:j]:
                    self.queue.done(q.pod.uid)
            else:
                self._schedule_profile_batch(qpis[i:j], profile)
            i = j

    def _schedule_profile_batch(self, qpis: list[QueuedPodInfo],
                                profile: Profile) -> None:
        """One same-profile stretch: each whole gang first, as ONE
        all-or-nothing device dispatch, then the rest."""
        gangs, qpis = self._extract_gangs(qpis)
        for members, ref, needed, min_count in gangs:
            self._dispatch_device_drain(members, profile,
                                        gang=(ref, needed, min_count))
        if qpis:
            self._dispatch_device_drain(qpis, profile)

    def _extract_gangs(self, qpis: list[QueuedPodInfo]):
        """Partition a profile stretch into whole-gang drains and the rest
        (kubernetes_tpu/scheduler.py:1507-1561). A gang is extracted when
        the drain holds at least its remaining quorum of members and the
        group is device-eligible (no parked members, no volumes or
        claims). With nominations pending no gang is extracted. Ineligible
        gangs stay in the generic flow: per-pod placement with the Permit
        barrier at commit."""
        if (self.queue.nominator.nominated_pods
                or not any(q.pod.spec.workload_ref for q in qpis)):
            return [], qpis
        groups: dict[str, list] = {}
        rest: list[QueuedPodInfo] = []
        for q in qpis:
            ref = q.pod.spec.workload_ref
            if ref:
                groups.setdefault(ref, []).append(q)
            else:
                rest.append(q)
        out = []
        for ref, members in groups.items():
            name, group = parse_workload_ref(ref)
            workload = self.client.get_workload(name)
            min_count = (pod_group_min_count(workload, group)
                         if workload is not None else None)
            if min_count is None:
                rest.extend(members)
                continue
            info = self.workload_manager.pod_group_info(members[0].pod)
            assigned = len(info.assigned) if info is not None else 0
            needed = max(min_count - assigned, 0)
            if needed == 0:
                # quorum already met by bound members: the surplus members
                # schedule individually (Permit passes at once)
                rest.extend(members)
                continue
            if (len(members) < needed
                    or any(m.pod.uid in self._waiting_pods
                           for m in members)
                    or any(m.pod.spec.volumes or m.pod.spec.resource_claims
                           for m in members)):
                self.gang_dispatch["fallback"] += 1
                rest.extend(members)
                continue
            out.append((members, ref, needed, min_count))
        return out, rest

    def _refuse_unsupported(self, qpis, batch) -> None:
        for k, q in enumerate(qpis):
            pod = q.pod
            if batch.host_fallback[k]:
                reason = self.builder.fallback_reason(pod)
                raise NotImplementedError(
                    f"pod {pod.uid}: {reason} — kubernetes_tpu_torch has no "
                    "device form for it yet and no host scheduling path")

    def _dispatch_device_drain(self, qpis: list[QueuedPodInfo],
                               profile: Profile, gang=None) -> None:
        """Build + dispatch one drain WITHOUT waiting for the device; the
        commit happens when the drain is resolved. `gang` = (workload
        ref, remaining quorum, minCount) makes the drain one whole-gang
        span, unless the gang turns out ineligible here."""
        t_entry = _time.perf_counter()
        did = self._drain_seq = self._drain_seq + 1
        ph: dict[str, float] = {}
        with self.tracer.span("host_build", pods=len(qpis), drain=did), \
                self.phase_track.scope("host_build"):
            carry = self._device_carry
            nominator = self.queue.nominator
            ovl_fp = nominator.version if nominator.nominated_pods else -1
            if carry is not None and (self._carry_profile != profile.name
                                      or self._carry_ovl_fp != ovl_fp):
                # the signature cache's scores were filled under another
                # profile's ScoreConfig, or its fit_ok under another
                # nominated-pod overlay: invalidate it (sig 0 never
                # matches)
                carry = self._relabel(carry, 0)
                self._device_carry = carry
            self._carry_profile = profile.name
            self._carry_ovl_fp = ovl_fp
            if carry is None:
                # reseed device state from the host snapshot; pending
                # commits mutate the cache the snapshot is built from, so
                # they land first
                with self._phase("host_snapshot", ph):
                    self._drain_pending()
                    self.cache.update_snapshot(self.snapshot)
                    self.state.apply_snapshot(self.snapshot)
            with self._phase("host_tensorize", ph):
                batch = self.builder.build([q.pod for q in qpis],
                                           pad_to=self.batch_size)
            self._refuse_unsupported(qpis, batch)
            na = self._node_arrays(ph)
            # group kernels are needed when any signature row carries
            # spread or inter-pod affinity constraints, or when existing
            # cluster pods do (affinity is symmetric: they veto/score any
            # incoming pod)
            groups_needed = (
                self.builder.groups.any_groups()
                or bool(self.snapshot.have_pods_with_affinity_list)
                or bool(self.snapshot
                        .have_pods_with_required_anti_affinity_list))
            if gang is not None and (
                    groups_needed or (batch.sig[:len(qpis)] == 0).any()
                    or not batch.valid[:len(qpis)].all()):
                # group kernels and host-port signatures are outside the
                # gang program: this gang rides the generic path (per-pod
                # placement, the Permit barrier at commit)
                self.gang_dispatch["fallback"] += 1
                gang = None
            if self.mesh is not None:
                self._refuse_on_mesh(groups_needed, gang)
            table_reset = self.builder.reset_count != self._builder_reset_seen
            self._builder_reset_seen = self.builder.reset_count
            capacity = (self.builder.groups.device_rows(),
                        self._node_rows(na))
            if carry is not None and (
                    table_reset or self._shape(carry) != self._shape(na)
                    or groups_needed != self._has_groups(carry)
                    or (groups_needed and capacity != self._gd_capacity)):
                # structural change (every signature id / group row
                # invalidated, the node bucket or the group-row capacity
                # moved): reseed from the host snapshot
                carry = None
                with self._phase("host_snapshot", ph):
                    self._drain_pending()
                    self.cache.update_snapshot(self.snapshot)
                    self.state.apply_snapshot(self.snapshot)
                na = self._node_arrays(ph)
            with self._phase("host_group_seed", ph, groups=groups_needed):
                if carry is None:
                    gcarry = None
                    self._gd_dev = self._gd_fam = None
                    if groups_needed:
                        gd_np, gc_np = self.builder.groups.build_dev(
                            self.snapshot)
                        self._gd_dev = to_device(gd_np, self.device)
                        gcarry = to_device(gc_np, self.device)
                        self._gd_fam = self.builder.groups.families(
                            self.snapshot)
                    self._gd_capacity = capacity
                    self._seeded_rows = self.builder.table_used
                    carry = (initial_carry_sharded(na) if self.mesh
                             is not None else initial_carry(na, gcarry))
                elif (groups_needed
                      and self.builder.table_used > self._seeded_rows):
                    # new signature rows while the carry is resident: seed
                    # just those rows from the live snapshot (assumes
                    # included) and scatter them in. Pending commits land
                    # first: the seeds count them.
                    self._drain_pending()
                    carry = self._device_carry
                    if carry is None or (
                            (self.builder.groups.device_rows(),
                             na.used.shape[0]) != self._gd_capacity):
                        # a bind error invalidated the carry, or the
                        # commits interned rows past the pow2 capacity of
                        # the resident group tensors: restart against
                        # reseeded state
                        self._invalidate_device_state()
                        return self._dispatch_device_drain(qpis, profile)
                    self.cache.update_snapshot(self.snapshot)
                    self._gd_dev, gcarry = scatter_new_rows(
                        self._gd_dev, carry.groups, self.builder.groups,
                        self.snapshot, self._seeded_rows,
                        self.builder.table_used)
                    self._gd_fam = self.builder.groups.families(
                        self.snapshot)
                    carry = carry._replace(groups=gcarry)
                    self._seeded_rows = self.builder.table_used
            with self._phase("host_cache", ph):
                if (self._table_dev is None
                        or self._table_dev_version != batch.table_version):
                    self._table_dev = table_from_batch(batch, self.device)
                    self._table_dev_version = batch.table_version
                table = self._table_dev
                n = len(qpis)
                ovl = nom = None
                if self.queue.nominator.nominated_pods:
                    # re-validate at the dispatch site: nominations may
                    # have moved since _schedule_batch's entry check;
                    # group counts cannot take a resource-only overlay
                    if groups_needed or not self._overlay_eligible(qpis):
                        self._refuse_host_path(qpis)
                    ovl = self._build_overlay(na)
                    nom = self._nominated_rows(qpis)
                    if gang is not None:
                        # the overlay is outside the gang program
                        self.gang_dispatch["fallback"] += 1
                        gang = None
        t0 = _time.perf_counter()
        ph["host_build"] = t0 - t_entry
        with self.tracer.span("device_dispatch", pods=n,
                              groups=groups_needed, drain=did,
                              batch_bucket=len(batch.valid)) as ds:
            # rails: the dispatch region only enqueues — with the
            # SanitizerRails gate on, a synchronizing call there raises
            # (and propagates: there is no host path to fall back to)
            with self.phase_track.scope("device"), \
                    self.rails.guard_dispatch(self.device):
                carry, records = self._dispatch_runs(
                    profile, na, carry, batch, table, n, groups_needed,
                    ovl=ovl, nom=nom,
                    gang=(gang[1] if gang is not None else None))
            if self.rails.active and n > 0:
                # NaN/inf probe of the drain's first signature row against
                # the post-dispatch carry
                self.rails.check_scores(profile.score_config, na, carry,
                                        table, int(batch.tidx[0]))
            ds.set(runs=",".join(r.kind for r in records))
        ph["device_dispatch"] = _time.perf_counter() - t0
        self._device_carry = carry
        self.device_batches += 1
        # on-device cluster analytics over the post-drain carry: every
        # input is already on the device; the result rides the drain's
        # event and resolves at commit
        with self.tracer.span("cluster_probe", drain=did):
            dom = self._gang_domains(na, need=True)
            if self.mesh is not None:
                probe = cluster_probe_sharded(self.mesh, na, carry, dom,
                                              self._gang_ndom)
            else:
                probe = cluster_probe(na, carry, dom, self._gang_ndom)
        done = None
        if self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record()
        self._pending.append(_PendingDrain(
            qpis=qpis, profile=profile, batch=batch, table=table, na=na,
            n=n, groups_needed=groups_needed, records=records, done=done,
            ovl=ovl, nom=nom, gang=gang, drain_id=did, phases=ph,
            probe=probe, span=ds))

    # -- the node-sharded mesh ------------------------------------------------

    def _node_arrays(self, ph: dict):
        """The resident node arrays: single-device, or the mesh's shards,
        whose upload (rows or the whole matrices) is timed as the JAX
        package times it, in the host_snapshot phase."""
        if self.mesh is None:
            return self.state.device_arrays()
        if not self.state.sharded_upload_due():
            return self.state.device_arrays_sharded(self.mesh)
        with self._phase("host_snapshot", ph):
            return self.state.device_arrays_sharded(self.mesh)

    @staticmethod
    def _node_rows(na) -> int:
        return na.rows if isinstance(na, Shards) else int(na.used.shape[0])

    @staticmethod
    def _shape(tree) -> tuple:
        """(global rows, shard count, resource width) of node arrays or a
        carry, single-device or sharded."""
        if isinstance(tree, Shards):
            return (tree.rows, len(tree), int(tree[0].used.shape[1]))
        return (int(tree.used.shape[0]), 1, int(tree.used.shape[1]))

    @staticmethod
    def _has_groups(carry) -> bool:
        """Whether the carry holds group counts (never on the lean
        mesh)."""
        return not isinstance(carry, Shards) and carry.groups is not None

    def _relabel(self, carry, sig: int):
        if isinstance(carry, Shards):
            return with_cache_sig_sharded(carry, sig)
        return with_cache_sig(carry, sig)

    def _refuse_on_mesh(self, groups_needed: bool, gang) -> None:
        """The mesh runs the lean tiers only; the JAX package's other
        sharded programs are not ported yet, and no drain takes a
        single-device program in their place."""
        if groups_needed:
            raise NotImplementedError(
                "a group drain on the node-sharded mesh needs "
                "run_plan_sharded and run_batch_sharded's group mode, "
                "which are not ported to kubernetes_tpu_torch yet")
        if gang is not None:
            raise NotImplementedError(
                "a gang drain on the node-sharded mesh needs "
                "run_gang_sharded, which is not ported to "
                "kubernetes_tpu_torch yet")

    @contextmanager
    def _phase(self, name: str, ph: dict, **attrs):
        """Time one host-build sub-phase: a tracer child span, an entry in
        `ph` (the drain's phase seconds) and the PhaseTrack mark."""
        t0 = _time.perf_counter()
        self.phase_track.push(name)
        try:
            # rails.declared restores the default sync mode in the phases
            # whose copies are part of the drain contract (a no-op with
            # the SanitizerRails gate off)
            with self.tracer.span(name, **attrs), \
                    self.rails.declared(name, self.device):
                yield
        finally:
            self.phase_track.pop()
            ph[name] = ph.get(name, 0.0) + (_time.perf_counter() - t0)

    def _nominated_rows(self, qpis: list[QueuedPodInfo]):
        """i32 [n] node row of each drain pod's OWN nomination (-1 =
        none), or None when no drain pod is nominated — the self-exclusion
        companion of the overlay (PodXs.nom_idx)."""
        nominated = self.queue.nominator.nominated_pods
        out = None
        for i, q in enumerate(qpis):
            node = nominated.get(q.pod.uid)
            if node is None:
                continue
            idx = self.state.node_index.get(node)
            if idx is None:
                continue
            if out is None:
                out = np.full((len(qpis),), -1, np.int32)
            out[i] = idx
        return out

    def _overlay_eligible(self, qpis: list[QueuedPodInfo]) -> bool:
        """True when the nominated pods' effect on this drain reduces to a
        fit-only resource overlay (the reference adds nominated pods of
        priority >= the incoming pod's to the NodeInfo,
        runtime/framework.go:1183-1200): every nominated pod outranks or
        ties every drain pod and none carries host ports. A drain pod that
        IS nominated takes per-pod self-exclusion (PodXs.nom_idx). Never
        on the mesh: the overlay is single-device only."""
        if self.mesh is not None:
            return False
        nom = self.queue.nominator
        max_prio = max(q.pod.spec.priority for q in qpis)
        for qlist in nom.nominated_per_node.values():
            for q in qlist:
                if q.pod.spec.priority < max_prio:
                    return False
                for c in q.pod.spec.containers:
                    for p in c.ports:
                        if p.host_port > 0:
                            return False
        return True

    def _build_overlay(self, na):
        """(ovl_used i64 [N, R], ovl_npods i32 [N]) on the device from the
        current nominations, fresh per dispatch (nominations are few and
        short-lived)."""
        N, R = na.used.shape
        ovl_used = np.zeros((N, R), np.int64)
        ovl_npods = np.zeros((N,), np.int32)
        for node_name, qlist in self.queue.nominator.nominated_per_node.items():
            idx = self.state.node_index.get(node_name)
            if idx is None or idx >= N:
                continue
            for q in qlist:
                vec = self.state.rtable.vector(q.pod_info.requests)
                ovl_used[idx, :len(vec)] += vec
                ovl_npods[idx] += 1
        return (torch.from_numpy(ovl_used).to(self.device),
                torch.from_numpy(ovl_npods).to(self.device))

    def _cluster_has_prefer_taints(self) -> bool:
        # mask by valid: freed rows of removed nodes keep their taint
        # columns until the slot is rewritten
        a = self.state.arrays
        # torchsan: waive[host-sync] state.arrays is the numpy staging copy
        return a is not None and bool(
            ((a.taint_eff == EFFECT_PREFER_NO_SCHEDULE)
             & a.valid[:, None]).any())

    def _dispatch_runs(self, profile: Profile, na, carry, batch, table,
                       n: int, groups_needed: bool = False, ovl=None,
                       nom=None, gang=None):
        """Dispatch the drain's compiled plan with no host synchronization;
        returns (chain carry, [_RunRec]). `gang` is a whole-gang drain's
        remaining quorum (None otherwise)."""
        cfg = profile.score_config
        plan = self.compiler.compile_drain(
            batch, n, groups_needed=groups_needed, gang_needed=gang,
            overlay=ovl is not None, nominated=nom is not None,
            mesh=self.mesh is not None, strategy=cfg.strategy,
            prefer_taints=self._cluster_has_prefer_taints(),
            uniform_min=self.UNIFORM_RUN_MIN)
        return self._dispatch_spans(cfg, na, batch, table, plan.spans, carry,
                                    ovl=ovl, nom=nom)

    def _uniform_shape(self, na) -> tuple[int, int, int]:
        """(L, K, J) for run_uniform, stable across drains: L is the
        standing batch bucket, J quantizes the node count to its pow2
        bucket."""
        L = pow2_at_least(self.batch_size)
        K = min(L, self._node_rows(na))
        n_q = pow2_at_least(max(self.cache.node_count(), 1))
        J = min(max(pow2_at_least(4 * L // n_q + 4), 8), L + 1)
        return L, K, J

    @staticmethod
    def _xone(batch, i: int) -> PodXs:
        return PodXs(valid=True, sig=int(batch.sig[i]),
                     tidx=int(batch.tidx[i]))

    def _dispatch_spans(self, cfg: ScoreConfig, na, batch, table, spans,
                        carry, ovl=None, nom=None):
        """Dispatch (i, j, kind) spans back to back, chaining the carry on
        the device. Uniform records keep their input carry for rewind.
        Under an overlay only uniform and scan spans occur (the drain
        compiler)."""
        records = []
        for (i, j, kind) in spans:
            if kind[0] == "uniform":
                L, K, J = self._uniform_shape(na)
                held = self.rails.hold(carry)
                c2, packed = self._run_uniform(cfg, na, carry, batch, i, j,
                                               table, L, K, J, ovl)
                records.append(_RunRec("uniform", i, j, carry, packed, L, J,
                                       span=kind, held=held))
            elif kind[0] == "wave":
                c2, packed, bucket = self._wave_dispatch(
                    cfg, na, carry, batch, i, j, table, kind)
                records.append(_RunRec("wave", i, j, None, packed, bucket,
                                       span=kind))
            elif kind[0] == "wavescan":
                if self.mesh is not None:
                    raise NotImplementedError(
                        "a plan span (\"wavescan\") on the node-sharded "
                        "mesh needs run_plan_sharded, which is not ported "
                        "to kubernetes_tpu_torch yet")
                c2, packed, bucket = self._wavescan_dispatch(
                    cfg, na, carry, batch, i, j, table, kind)
                records.append(_RunRec("wavescan", i, j, None, packed,
                                       bucket, span=kind))
            elif kind[0] == "gang":
                held = self.rails.hold(carry)
                c2, packed, width, uni = self._gang_dispatch(
                    cfg, na, carry, batch, i, j, table, kind)
                # the closed-form tier keeps its input carry (a failed
                # exactness flag replays the scan tier from it)
                records.append(_RunRec("gang", i, j, carry if uni else None,
                                       packed, width, span=kind,
                                       held=held if uni else None))
            else:
                c2, assigns = self._scan_dispatch(cfg, na, carry, batch, i,
                                                  j, table, ovl=ovl, nom=nom)
                records.append(_RunRec("scan", i, j, None, assigns,
                                       span=kind))
            carry = c2
        return carry, records

    def _run_uniform(self, cfg: ScoreConfig, na, carry, batch, i: int,
                     j: int, table, L: int, K: int, J: int, ovl):
        """run_uniform over pods [i:j), or its sharded twin on the mesh
        (where no overlay occurs)."""
        if self.mesh is not None:
            return run_uniform_sharded(cfg, self.mesh, na, carry,
                                       self._xone(batch, i), table, j - i,
                                       L, K, J)
        return run_uniform(cfg, na, carry, self._xone(batch, i), table,
                           j - i, L, K, J, overlay=ovl)

    def _wave_norm_static(self, rows: tuple) -> bool:
        pref_w = self.builder.table.pref_weight
        return all(static_norm_ok(self.state.arrays, pref_w[u])
                   for u in rows)

    def _get_wave_statics(self, na, table, rows: tuple) -> list:
        """Hoisted per-signature surfaces ([N] tuples per signature) from
        the compiler's SurfaceCache, recomputed only when a node's static
        columns or the signature table move."""
        return self.compiler.surfaces.get(na, table, rows)

    def _wave_dispatch(self, cfg: ScoreConfig, na, carry, batch, i: int,
                       j: int, table, span):
        """run_wave over the same-signature group pods [i:j), with the JAX
        package's wave shape (Lw, K, J)."""
        _, u, anti_term, merge_on = span
        m = j - i
        bucket = pow2_at_least(m)
        # a wave span's pods are all valid (DrainCompiler._classify_wave):
        # its mask is the length-m prefix, built on the device
        valid = torch.arange(bucket, device=self.device) < m
        statics = self._get_wave_statics(na, table, (u,))[0]
        # the spread replay holds an [Lw, Lw, SC] rank comparison: cap the
        # wave width under it; without it wider waves just cut waves
        Lw = min(512 if self._gd_fam.spr_f else 1024, bucket)
        K = min(Lw, na.cap.shape[0])
        if anti_term >= 0 and not self._gd_fam.spr_f:
            # domain-veto waves accept one entry per node (jcap = 1): the
            # deeper matrix columns would be masked, so none are built
            J = 1
        else:
            _L, _K, J = self._uniform_shape(na)
        # a wave merges at most K·J entries; on a node axis narrower than
        # the wave the JAX package's top_k raises and its drain degrades
        # to the host path, while the port keeps the wave exact and narrow
        Lw = min(Lw, K * J)
        norm_live = not self._wave_norm_static((u,))
        carry2, packed = run_wave(
            cfg, na, carry, valid, table, u, self._gd_dev, statics, K, J,
            self._gd_fam, norm_live,
            anti_term=anti_term, merge_on=merge_on, Lw=Lw)
        return carry2, packed, bucket

    def _wavescan_dispatch(self, cfg: ScoreConfig, na, carry, batch, i: int,
                           j: int, table, span):
        """The plan program (run_plan) over the mixed-signature pods
        [i:j): group rows ride the resident group tensors, a group-free
        drain takes the lean variant, a span holding host-port rows the
        ports variant. The signature set pads to the pow2 lattice by
        repeating its last row."""
        _, uniq, has_ports = span
        uniq = list(uniq)
        m = j - i
        bucket = pow2_at_least(m)
        S = pow2_at_least(len(uniq), 2)
        wt_list = (uniq + [uniq[-1]] * S)[:S]
        slot: dict = {}
        for s, u in enumerate(wt_list):
            slot.setdefault(u, s)
        widx = np.empty((bucket,), np.int32)
        widx[:m] = [slot[int(t)] for t in batch.tidx[i:j]]
        widx[m:] = widx[m - 1]
        widx_t = torch.from_numpy(widx)
        if self.device.type == "cuda":
            widx_t = widx_t.pin_memory().to(self.device, non_blocking=True)
        # a plan span's pods are all valid (DrainCompiler): its mask is the
        # length-m prefix, built on the device
        valid = torch.arange(bucket, device=self.device) < m
        statics = self.compiler.surfaces.stacked(na, table, tuple(wt_list))
        norm_live = not self._wave_norm_static(tuple(wt_list))
        has_groups = self._gd_dev is not None
        fam = (self._gd_fam if has_groups
               else GroupFamilies(False, False, False, False, False))
        carry2, packed = run_plan(
            cfg, na, carry, WaveXs(valid=valid, widx=widx_t), table,
            wt_list, self._gd_dev, statics, fam, norm_live,
            has_groups=has_groups, has_ports=has_ports)
        return carry2, packed, bucket

    # -- gang placement (whole-group all-or-nothing dispatch) ------------------

    def _gang_domains(self, na, need: bool):
        """Device i32 [N] topology-domain id per node row for the gang
        contiguity column and the cluster probe: the node's zone label,
        or a unique per-node domain when unlabeled, interned in
        node_index order. Identity ids when the contiguity weight is off
        (the kernel never reads them). Cached until the static node
        columns or the node bucket move: the key is the JAX package's
        (statics_gen, N), so ids first built without `need` (a gang
        scan at contiguity weight 0) stay identity ids for the probe
        too, as they do there."""
        N = self._node_rows(na)
        key = (self.state.statics_gen, N)
        if self._gang_dom is not None and self._gang_dom_key == key:
            return self._gang_dom
        dom = np.arange(N, dtype=np.int32)
        if need:
            ids: dict[str, int] = {}
            for name, idx in self.state.node_index.items():
                if idx >= N:
                    continue
                ni = self.snapshot.get(name)
                labels = (ni.node.metadata.labels if ni is not None else {})
                zone = (labels.get("topology.kubernetes.io/zone")
                        or f"\x00{idx}")
                dom[idx] = ids.setdefault(zone, len(ids))
        self._gang_dom = dom_from_numpy(dom, self.device)
        self._gang_dom_key = key
        # the probe's domain count: stable per topology (changes only
        # when the id mapping is rebuilt)
        self._gang_ndom = int(dom.max()) + 1 if N else 1
        return self._gang_dom

    def _gang_dispatch(self, cfg: ScoreConfig, na, carry, batch, i: int,
                       j: int, table, span, force_scan: bool = False):
        """run_gang over members [i:j). Returns (carry', packed, pack
        width, closed-form tier?). A single-signature gang under
        LeastAllocated, with no contiguity column, no PreferNoSchedule
        taint in the cluster and no preferred affinity rides the
        closed-form tier (one top-L for the whole gang); anything else
        takes the scan tier with the per-signature surfaces hoisted."""
        _, needed = span
        m = j - i
        w_contig = int(self.gang_contiguity_weight)
        tid = batch.tidx[i:j]
        uniq = list(dict.fromkeys(int(t) for t in tid))
        # a gang-sized matrix, not the batch bucket
        L = pow2_at_least(m, 16)
        K = min(L, na.cap.shape[0])
        n_q = pow2_at_least(max(self.cache.node_count(), 1))
        J = min(max(pow2_at_least(4 * L // n_q + 4), 8), L + 1)
        if (not force_scan and len(uniq) == 1 and w_contig == 0
                and cfg.strategy == "LeastAllocated"
                and not self._cluster_has_prefer_taints()
                and not self.builder.table.pref_weight[uniq[0]].any()):
            c2, packed = run_gang(cfg, na, carry, self._xone(batch, i),
                                  table, needed=needed, uniform=True,
                                  n_actual=m, L=L, K=K, J=J)
            return c2, packed, L, True
        bucket = pow2_at_least(m)
        S = pow2_at_least(len(uniq), 1)
        wt_list = (uniq + [uniq[-1]] * S)[:S]
        slot: dict = {}
        for s, u in enumerate(wt_list):
            slot.setdefault(u, s)
        widx = np.empty((bucket,), np.int32)
        widx[:m] = [slot[int(t)] for t in tid]
        widx[m:] = widx[m - 1]
        tidx = np.full((bucket,), tid[m - 1], np.int32)
        tidx[:m] = tid
        valid = np.zeros((bucket,), bool)
        valid[:m] = batch.valid[i:j]
        xs = gang_xs_from_numpy(GangXs(valid=valid, tidx=tidx, widx=widx),
                                self.device)
        dom = self._gang_domains(na, need=w_contig > 0)
        # the same hoisted surfaces as the plan program
        statics = self.compiler.surfaces.stacked(na, table, tuple(wt_list))
        c2, packed = run_gang(cfg, na, carry, xs, table, wt=wt_list,
                              needed=needed, dom=dom, statics=statics,
                              w_contig=w_contig)
        return c2, packed, bucket, False

    def _scan_dispatch(self, cfg: ScoreConfig, na, carry, batch, i: int,
                       j: int, table, ovl=None, nom=None):
        """run_batch over pods [i:j) padded to a pow2 bucket (with the
        group branch when the carry holds group counts, the overlay and
        the pods' own nominated rows when nominations are pending);
        returns (carry, device assignments) without synchronizing."""
        bucket = pow2_at_least(j - i)
        m = j - i
        valid = np.zeros((bucket,), bool)
        valid[:m] = batch.valid[i:j]
        sig = np.full((bucket,), batch.sig[j - 1], np.int32)
        sig[:m] = batch.sig[i:j]
        tidx = np.full((bucket,), batch.tidx[j - 1], np.int32)
        tidx[:m] = batch.tidx[i:j]
        # self-nominated pods keep their signature: the cached fit_ok is
        # overlay-pure and the self-exclusion is a one-row delta
        nom_idx = None
        if nom is not None:
            nom_idx = np.full((bucket,), -1, np.int32)
            nom_idx[:m] = nom[i:j]
        xs = pod_xs_from_numpy(PodXs(valid=valid, sig=sig, tidx=tidx,
                                     nom_idx=nom_idx), self.device)
        if self.mesh is not None:
            return run_batch_sharded(cfg, self.mesh, na, carry, xs, table,
                                     groups=self._gd_dev, fam=self._gd_fam)
        return run_batch(cfg, na, carry, xs, table, groups=self._gd_dev,
                         fam=self._gd_fam, overlay=ovl)

    def _uniform_escalate(self, cfg: ScoreConfig, na, carry, batch, i: int,
                          j: int, table, out, j_failed: int, ovl=None):
        """Depth-J overflow recovery: retry the run with a deeper matrix,
        falling back to the scan if even J = L+1 reports failure."""
        L, K, _ = self._uniform_shape(na)
        J = j_failed
        while J < L + 1:
            J = min(8 * J, L + 1)
            c2, packed = self._run_uniform(cfg, na, carry, batch, i, j,
                                           table, L, K, J, ovl)
            r = packed.cpu().numpy()
            if r[L] and r[L + 1]:
                out[i:j] = r[:j - i]
                return c2
            if not r[L]:
                break
        carry, a = self._scan_dispatch(cfg, na, carry, batch, i, j, table,
                                       ovl=ovl)
        out[i:j] = a.cpu().numpy()[:j - i]
        return carry

    # -- commit pipeline ------------------------------------------------------

    def _drain_pending(self) -> None:
        while self._pending:
            self._commit_next()

    def _commit_next(self) -> None:
        """Commit the oldest in-flight drain: one readback of its results,
        validation of the uniform runs' exactness flags (an inexact run
        rewinds to its input carry and replays everything downstream),
        then the host commit."""
        pd = self._pending.popleft()
        out = np.full((pd.n,), -1, np.int32)
        t0 = _time.perf_counter()
        with self.phase_track.scope("device"):
            self._resolve_records(pd, out)
        # readback wait (near zero when the drain's event had fired)
        pd.phases["device_wait"] = _time.perf_counter() - t0
        names = self.state.node_names
        assigned = out[out >= 0]
        if ((out < -1).any() or (out >= len(names)).any()
                or any(not names[int(a)] for a in assigned)):
            raise RuntimeError(
                f"device assignments out of range: {out.tolist()}")
        self._commit_assignments(pd, out)

    @staticmethod
    def _readback(records: list) -> list:
        """Host copies of the records' results with ONE synchronizing
        device-to-host copy."""
        if not records:
            return []
        flat = torch.cat([r.result.reshape(-1) for r in records])
        host = flat.cpu().numpy()
        out, k = [], 0
        for r in records:
            size = r.result.numel()
            out.append(host[k:k + size])
            k += size
        return out

    def _resolve_records(self, pd: _PendingDrain, out) -> None:
        host = self._readback(pd.records)
        idx = 0
        while idx < len(pd.records):
            rec = pd.records[idx]
            r = host[idx]
            m = rec.j - rec.i
            if rec.kind in ("scan", "wave", "wavescan"):
                out[rec.i:rec.j] = r[:m]
                if rec.kind != "scan":
                    self._observe_wave(rec, r)
                idx += 1
                continue
            if rec.kind == "gang":
                width = rec.L
                replay = not (r[width + 2] and r[width + 3])
                self.rails.check_held(rec.held,
                                      "gang replay" if replay else "commit")
                if replay:
                    # the closed form's exactness preconditions failed on
                    # the data: replay on the scan tier from the kept
                    # input carry and re-chain everything downstream
                    self.gang_replays += 1
                    carry, packed, width, _ = self._gang_dispatch(
                        pd.profile.score_config, pd.na, rec.carry_in,
                        pd.batch, rec.i, rec.j, pd.table, rec.span,
                        force_scan=True)
                    r = packed.cpu().numpy()
                    self._replay_downstream(pd, idx, carry)
                    host[idx + 1:] = self._readback(pd.records[idx + 1:])
                accepted = bool(r[width])
                raw = np.array(r[:m], np.int32)
                pd.gang_accepted = accepted
                pd.gang_raw = raw
                pd.gang_placed = int(r[width + 1])
                # the all-or-nothing verdict: a rejected gang was unwound
                # on the device; the host only masks its assignments
                out[rec.i:rec.j] = raw if accepted else np.int32(-1)
                idx += 1
                continue
            exact, depth = bool(r[rec.L]), bool(r[rec.L + 1])
            self.rails.check_held(
                rec.held, "commit" if exact and depth else "uniform rewind")
            if exact and depth:
                out[rec.i:rec.j] = r[:m]
                idx += 1
                continue
            # rewind: resolve THIS run synchronously from its input carry
            self.uniform_rewinds += 1
            cfg = pd.profile.score_config
            carry = rec.carry_in
            if exact:
                carry = self._uniform_escalate(cfg, pd.na, carry, pd.batch,
                                               rec.i, rec.j, pd.table, out,
                                               rec.J, ovl=pd.ovl)
            else:
                carry, a = self._scan_dispatch(cfg, pd.na, carry, pd.batch,
                                               rec.i, rec.j, pd.table,
                                               ovl=pd.ovl, nom=pd.nom)
                out[rec.i:rec.j] = a.cpu().numpy()[:m]
            self._replay_downstream(pd, idx, carry)
            host[idx + 1:] = self._readback(pd.records[idx + 1:])
            idx += 1

    def _replay_downstream(self, pd: _PendingDrain, idx: int, carry) -> None:
        """Re-dispatch everything chained after record `idx`: the rest of
        this drain's spans, then every later pending drain, against the
        corrected carry, each under its dispatch-time overlay. A profile
        or overlay change between drains invalidates the sig cache, as at
        the dispatch site."""
        cfg = pd.profile.score_config
        spans = [(q.i, q.j, q.span) for q in pd.records[idx + 1:]]
        carry, new_recs = self._dispatch_spans(cfg, pd.na, pd.batch,
                                               pd.table, spans, carry,
                                               ovl=pd.ovl, nom=pd.nom)
        pd.records[idx + 1:] = new_recs
        prev_profile = pd.profile
        prev_ovl = pd.ovl
        for pd2 in self._pending:
            if pd2.profile is not prev_profile or pd2.ovl is not prev_ovl:
                carry = self._relabel(carry, 0)
                prev_profile = pd2.profile
                prev_ovl = pd2.ovl
            carry, pd2.records = self._dispatch_runs(
                pd2.profile, pd2.na, carry, pd2.batch, pd2.table, pd2.n,
                pd2.groups_needed, ovl=pd2.ovl, nom=pd2.nom,
                gang=(pd2.gang[1] if pd2.gang is not None else None))
        if self._device_carry is not None:
            self._device_carry = carry

    def _observe_wave(self, rec: _RunRec, r) -> None:
        """Sum a resolved record's stats. run_wave (packed [B:B+4]): merge
        waves, conflict-cut events, the first wave's accepted prefix (-1
        when no merge wave ran) and serially placed pods. run_plan (packed
        [B:B+2]): one wave, its conflicting pods and its conflict-free
        prefix."""
        B = rec.L
        if rec.kind == "wave":
            waves, confs, prefix, serial = (int(x) for x in r[B:B + 4])
            self.wave_runs += 1
        else:
            waves, serial = 1, 0
            confs, prefix = int(r[B]), int(r[B + 1])
            self.plan_runs += 1
        st = self.wave_stats
        st["waves"] += waves
        st["conflicts"] += confs
        st["serial_steps"] += serial
        st["first_prefix"].append(prefix)

    def _commit_assignments(self, pd: _PendingDrain, out) -> int:
        """Host commit of a resolved drain under the `commit` phase mark,
        timed into the drain's phases and its device_dispatch span; then
        the drain's cluster probe resolves into `_last_probe`."""
        t0 = _time.perf_counter()
        with self.phase_track.scope("commit"):
            bound = self._commit_assignments_inner(pd, out)
        commit_s = _time.perf_counter() - t0
        pd.phases["commit"] = pd.phases.get("commit", 0.0) + commit_s
        pd.span.set(commit_start=t0, commit_s=commit_s)
        totals = self.drain_phase_seconds
        for name, secs in pd.phases.items():
            totals[name] = totals.get(name, 0.0) + secs
        probe_snap = self._resolve_probe(pd)
        if probe_snap:
            self._last_probe = probe_snap
        return bound

    def _resolve_probe(self, pd: _PendingDrain) -> dict:
        """A drain's cluster_probe result as the snapshot dict the JAX
        package serves at /debug/cluster. The tensors were launched before
        the drain's event, which the commit has waited on, so the copy
        does not stall."""
        if pd.probe is None:
            return {}
        per_res = pd.probe[0].cpu().numpy()
        dom = pd.probe[1].cpu().numpy()
        valid = int(pd.probe[2])
        rnames = self.state.rtable.names
        resources: dict = {}
        for r in range(min(len(rnames), per_res.shape[0])):
            row = per_res[r]
            resources[rnames[r]] = {
                stat: round(float(row[i]), 6)
                for i, stat in enumerate(PROBE_STATS)}
        domains = {stat: round(float(dom[i]), 6)
                   for i, stat in enumerate(PROBE_DOM_STATS)}
        return {"t": round(self.clock(), 6), "drainId": pd.drain_id,
                "validNodes": valid, "resources": resources,
                "domains": domains}

    def _commit_assignments_inner(self, pd: _PendingDrain, out) -> int:
        """Bulk assume + bind enqueue for the hook-free placed pods, the
        Reserve / Permit chain for gang members outside an accepted gang
        drain, failure handling for the rest."""
        qpis = pd.qpis
        profile = pd.profile
        n = pd.n
        self.schedule_attempts += n
        names = self.state.node_names
        # an accepted gang commits atomically: the device verdict already
        # proved the quorum the Permit barrier would enforce per pod
        gang_fast = pd.gang is not None and pd.gang_accepted
        fast: list[tuple[QueuedPodInfo, str]] = []
        failures: list[QueuedPodInfo] = []
        bound = 0
        for i in range(n):
            a = out[i]
            qpi = qpis[i]
            if a < 0:
                failures.append(qpi)
            elif not gang_fast and _needs_per_pod_hooks(profile,
                                                        qpi.pod.spec):
                self._assume_and_bind(qpi, names[int(a)], profile)
                bound += 1
            else:
                fast.append((qpi, names[int(a)]))
        bound += self._fast_commit(fast)
        if pd.gang is not None:
            self.gang_dispatch["placed" if pd.gang_accepted
                               else "rejected"] += 1
        if failures:
            # diagnosis reads the live snapshot (assumes included)
            self.cache.update_snapshot(self.snapshot)
            diag_cache: dict = {}
            if pd.gang is not None and not pd.gang_accepted:
                self._fail_rejected_gang(pd, qpis, diag_cache)
            else:
                for qpi in failures:
                    self._handle_failure(
                        qpi, self._device_fit_error(qpi, profile,
                                                    diag_cache))
        return bound

    def _assume_and_bind(self, qpi: QueuedPodInfo, node_name: str,
                         profile: Profile) -> None:
        """Assume, then Reserve → Permit (kubernetes_tpu/scheduler.py
        :3555-3640): a Permit Wait parks the pod with its resources
        assumed; a rejection or error unreserves, forgets the pod and
        requeues it; success binds. No PreBind plugin runs (the port
        refuses them)."""
        pod = qpi.pod
        assumed = pod.with_node_name(node_name)
        pi = PodInfo(pod=assumed, requests=qpi.pod_info.requests,
                     cpu_nonzero=qpi.pod_info.cpu_nonzero,
                     mem_nonzero=qpi.pod_info.mem_nonzero)
        try:
            self.cache.assume_pod_info(pi)
        except KeyError:
            self.queue.done(pod.uid)
            return
        self.queue.nominator.delete(pod)
        fwk = profile.framework
        cs = CycleState()
        status = fwk.run_reserve_plugins_reserve(cs, assumed, node_name)
        if not status.is_success():
            fwk.run_reserve_plugins_unreserve(cs, assumed, node_name)
            self.cache.forget_pod(assumed)
            self._invalidate_device_state()
            self._handle_failure(qpi, FitError(pod, 0), try_preempt=False)
            return
        status, wait_timeout = fwk.run_permit_plugins(cs, assumed, node_name)
        if status.code == Code.WAIT and wait_timeout <= 0:
            # the group's scheduling deadline already expired: reject
            # instead of parking for another round
            status = Status.unschedulable("gang scheduling deadline expired",
                                          plugin=status.plugin)
        if not status.is_success() and status.code != Code.WAIT:
            # rejection or plugin error: unreserve, release the assumed
            # resources, requeue
            fwk.run_reserve_plugins_unreserve(cs, assumed, node_name)
            self.cache.forget_pod(assumed)
            self._invalidate_device_state()
            if status.code == Code.ERROR:
                self.error_count += 1
            self._handle_failure(qpi, FitError(pod, 0), try_preempt=False)
            return
        if status.code == Code.WAIT:
            # WaitOnPermit (schedule_one.go:302): park with the resources
            # assumed; a later member's Permit or the timeout sweep in
            # flush_queues resolves it
            self.queue.done(pod.uid)
            self._waiting_pods[pod.uid] = _WaitingPodRec(
                qpi=qpi, assumed=assumed, node_name=node_name,
                cycle_state=cs, deadline=self.clock() + wait_timeout,
                wait_plugin=status.plugin)
            return
        self.queue.done(pod.uid)
        self.cache.finish_binding(assumed)
        self.dispatcher.add(APICall(CallType.BIND, assumed,
                                    node_name=node_name))
        self.scheduled_count += 1
        qpi.unschedulable_plugins = set()
        qpi.consecutive_errors_count = 0

    def _fail_rejected_gang(self, pd: _PendingDrain, qpis: list,
                            diag_cache: dict) -> None:
        """All-or-nothing rejection commit (kubernetes_tpu/scheduler.py
        :3038-3111): no member binds and none was ever reserved. Members
        with NO feasible node fail with the device mask diagnosis and run
        the PostFilter (how a higher-priority gang preempts a lower one);
        members the quorum verdict unwound fail with the gang reason and
        no preemption (the analog of a Permit rejection)."""
        ref, _needed, min_count = pd.gang
        # the infeasible members' rejector plugins become the whole gang's
        # requeue triggers
        plugins: set = {"GangScheduling"}
        infeasible: list = []
        unwound: list = []
        names = self.state.node_names
        for qpi, a in zip(qpis, pd.gang_raw):
            if a >= 0:
                unwound.append((qpi, names[int(a)]))
            else:
                infeasible.append(qpi)
        # Diagnose the infeasible members against the state the serial
        # Permit barrier would have seen: the unwound members' placements
        # TEMPORARILY assumed (parked members hold resources there). The
        # assumes are forgotten before any failure handling — preemption
        # must never see the phantom members as victims — and the staging
        # arrays the diagnosis refreshed are restored; the resident
        # device carry never sees them.
        errs: list = []
        if infeasible:
            temp: list = []
            for qpi, node_name in unwound:
                pi = PodInfo(pod=qpi.pod.with_node_name(node_name),
                             requests=qpi.pod_info.requests,
                             cpu_nonzero=qpi.pod_info.cpu_nonzero,
                             mem_nonzero=qpi.pod_info.mem_nonzero)
                try:
                    self.cache.assume_pod_info(pi)
                    temp.append(pi.pod)
                except KeyError:
                    pass
            self.cache.update_snapshot(self.snapshot)
            for qpi in infeasible:
                errs.append(self._device_fit_error(qpi, pd.profile,
                                                   diag_cache))
            for pod in temp:
                self.cache.forget_pod(pod)
            self.cache.update_snapshot(self.snapshot)
            self.state.apply_snapshot(self.snapshot)
        for qpi, err in zip(infeasible, errs):
            plugins |= err.diagnosis.unschedulable_plugins
            self._handle_failure(qpi, err)
        n_nodes = len(self.snapshot.node_info_list)
        msg = (f"gang {ref!r} rejected: {pd.gang_placed} of {min_count} "
               f"required members placeable")
        for qpi, _node in unwound:
            err = FitError(qpi.pod, n_nodes)
            err.diagnosis = Diagnosis(unschedulable_plugins=set(plugins),
                                      pre_filter_msg=msg)
            self._handle_failure(qpi, err, try_preempt=False)

    def _fast_commit(self, pairs: list) -> int:
        """Assume (cache.go:369) + FinishBinding + bulk bind enqueue for the
        hook-free pods: pods outside gangs, and the members of an accepted
        gang drain."""
        if not pairs:
            return 0
        cache = self.cache
        pod_states = cache.pod_states
        assumed_set = cache.assumed_pods
        ttl = cache.ttl
        in_flight = self.queue.in_flight_pods
        now = self.clock()
        bound_pods: list[tuple[Pod, Pod]] = []
        for qpi, node_name in pairs:
            pod = qpi.pod
            uid = pod.uid
            if uid in pod_states:
                in_flight.pop(uid, None)
                continue
            assumed = pod.with_node_name(node_name)
            pi = PodInfo(pod=assumed, requests=qpi.pod_info.requests,
                         cpu_nonzero=qpi.pod_info.cpu_nonzero,
                         mem_nonzero=qpi.pod_info.mem_nonzero)
            cache._add_pod_info_to_node(pi)
            st = _PodState(pod=assumed, assumed=True, binding_finished=True)
            if ttl > 0:
                st.deadline = now + ttl
            pod_states[uid] = st
            assumed_set.add(uid)
            in_flight.pop(uid, None)
            bound_pods.append((assumed, pod))
            if qpi.unschedulable_plugins:
                qpi.unschedulable_plugins = set()
            qpi.consecutive_errors_count = 0
        if not in_flight:
            self.queue.in_flight_events.clear()
        self.dispatcher.add_binds(bound_pods)
        self.scheduled_count += len(bound_pods)
        return len(bound_pods)

    # -- failures -------------------------------------------------------------

    def _device_fit_error(self, qpi: QueuedPodInfo, profile: Profile,
                          diag_cache: dict) -> FitError:
        """The device reports only that no node fits; the diagnosis (the
        rejecting plugins, which drive the queueing hints, and the per-node
        reasons of the FailedScheduling message) comes from the device mask
        reduction (diagnose_row) when the pod has a signature row, else
        from a host filter replay over the live snapshot — the JAX
        package's route. Once per pod signature per drain."""
        # content key: host-port pods share a signature row yet carry sig 0
        sig = BatchBuilder._sig_key(qpi.pod)
        cached = diag_cache.get(sig)
        if cached is None:
            cached = self._mask_diagnosis(qpi, diag_cache)
            if cached is None:
                cached = self._host_replay_diagnosis(qpi, profile)
            if not cached.unschedulable_plugins:
                cached.unschedulable_plugins = {"NodeResourcesFit"}
            diag_cache[sig] = cached
        err = FitError(qpi.pod, len(self.snapshot.node_info_list))
        err.diagnosis = cached
        return err

    def _host_replay_diagnosis(self, qpi: QueuedPodInfo,
                               profile: Profile) -> Diagnosis:
        fwk = profile.framework
        nodes = self.snapshot.node_info_list
        diagnosis = Diagnosis()
        state = CycleState()
        pre_result, status = fwk.run_pre_filter_plugins(state, qpi.pod,
                                                        nodes)
        if not status.is_success():
            diagnosis.pre_filter_msg = "; ".join(status.reasons)
            if status.plugin:
                diagnosis.unschedulable_plugins.add(status.plugin)
        else:
            fwk.find_nodes_that_pass_filters(state, qpi.pod, nodes,
                                             pre_result, diagnosis)
        return diagnosis

    def _mask_diagnosis(self, qpi: QueuedPodInfo,
                        diag_cache: dict) -> Optional[Diagnosis]:
        """Diagnosis from the device filter masks: one diagnose_row
        reduction against the post-commit node state attributes every
        rejected node to its first failing plugin (host filter order) with
        the exact per-reason detail. None for a pod without a signature
        row (the host replay takes it, as in the JAX package)."""
        ent = self.builder._lookup(qpi.pod)
        if ent[0] != "row":
            return None
        tidx = ent[2]
        ctx = diag_cache.get("_device_ctx")
        if ctx is None or ctx[0] != self.builder.table_version:
            ctx = diag_cache["_device_ctx"] = (self.builder.table_version,
                                               self._diagnosis_context())
        na, table, gd, gc, fam = ctx[1]
        slot, pods_fail, cols_fail = diagnose_row(na, table, tidx, gd=gd,
                                                  gc=gc, fam=fam)
        return self._assemble_diagnosis(qpi, tidx, slot.cpu().numpy(),
                                        pods_fail.cpu().numpy(),
                                        cols_fail.cpu().numpy())

    def _diagnosis_context(self):
        """Post-commit device state for diagnose_row, built once per failed
        drain: the node arrays refreshed from the live snapshot, the
        signature table, and — when group constraints are live — fresh
        group tensors."""
        self.state.apply_snapshot(self.snapshot)
        na = self.diagnosis_arrays()
        if (self._table_dev is not None
                and self._table_dev_version == self.builder.table_version):
            table = self._table_dev
        else:
            from .state.convert import pod_table_from_numpy
            table = pod_table_from_numpy(self.builder.table, self.device)
        gd = gc = fam = None
        if (self.builder.groups.any_groups()
                or bool(self.snapshot.have_pods_with_affinity_list)
                or bool(self.snapshot
                        .have_pods_with_required_anti_affinity_list)):
            gd_np, gc_np = self.builder.groups.build_dev(self.snapshot)
            gd = to_device(gd_np, self.device)
            gc = to_device(gc_np, self.device)
            fam = self.builder.groups.families(self.snapshot)
        return na, table, gd, gc, fam

    def diagnosis_arrays(self):
        """Single-device node arrays for the row reductions outside a
        drain (diagnose_row, explain_row): the resident copy, or on the
        mesh a fresh block of the staging arrays on its first device (the
        JAX package's diagnosis reads the staging arrays too), which
        leaves the shards and their dirty-row tracking alone."""
        a = self.state.ensure_arrays()
        if self.mesh is None:
            return self.state.device_arrays()
        from .state.convert import node_arrays_from_numpy
        return node_arrays_from_numpy(a, self.device)

    def _assemble_diagnosis(self, qpi: QueuedPodInfo, tidx: int, slot,
                            pods_fail, cols_fail) -> Diagnosis:
        """slot / fit arrays → Diagnosis with per-node Statuses carrying
        the host plugins' exact reason strings and codes."""
        from .plugins.interpodaffinity import (ERR_AFFINITY,
                                               ERR_ANTI_AFFINITY,
                                               ERR_EXISTING_ANTI_AFFINITY)
        from .plugins.node_basics import find_matching_untolerated_taint
        from .plugins.nodeaffinity import ERR_REASON as NA_ERR
        from .plugins.podtopologyspread import (
            ERR_REASON_CONSTRAINTS_NOT_MATCH, ERR_REASON_NODE_LABEL_NOT_MATCH)
        pod = qpi.pod
        diagnosis = Diagnosis()
        names = self.state.node_names
        # one shared Status per identical (slot, detail): a 5k-node mass
        # rejection allocates a handful of Status objects, not 5k
        shared: dict = {}
        simple = {
            prog.DIAG_NODE_UNSCHEDULABLE: (
                Status.unresolvable, "node(s) were unschedulable",
                "NodeUnschedulable"),
            prog.DIAG_NODE_NAME: (
                Status.unresolvable,
                "node(s) didn't match the requested node name", "NodeName"),
            prog.DIAG_NODE_AFFINITY: (
                Status.unresolvable, NA_ERR, "NodeAffinity"),
            prog.DIAG_PORTS: (
                Status.unschedulable,
                "node(s) didn't have free ports for the requested pod ports",
                "NodePorts"),
            prog.DIAG_SPREAD_LABEL: (
                Status.unresolvable, ERR_REASON_NODE_LABEL_NOT_MATCH,
                "PodTopologySpread"),
            prog.DIAG_SPREAD_SKEW: (
                Status.unschedulable, ERR_REASON_CONSTRAINTS_NOT_MATCH,
                "PodTopologySpread"),
            prog.DIAG_IPA_AFFINITY: (
                Status.unresolvable, ERR_AFFINITY, "InterPodAffinity"),
            prog.DIAG_IPA_ANTI: (
                Status.unschedulable, ERR_ANTI_AFFINITY, "InterPodAffinity"),
            prog.DIAG_IPA_EXISTING_ANTI: (
                Status.unschedulable, ERR_EXISTING_ANTI_AFFINITY,
                "InterPodAffinity"),
        }
        req_row = self.builder.table.req[tidx]
        cap = self.state.arrays.cap
        rnames = self.state.rtable.names
        for i in np.nonzero(slot > 0)[0]:
            i = int(i)
            name = names[i] if i < len(names) else ""
            if not name:
                continue
            s = int(slot[i])
            if s == prog.DIAG_TAINT:
                # the reason carries the taint: resolve it from the node
                # itself, exactly like the host plugin
                ni = self.snapshot.get(name)
                taint = find_matching_untolerated_taint(
                    ni.node.spec.taints, pod.spec.tolerations,
                    TaintToleration.FILTER_EFFECTS) if ni is not None \
                    else None
                key = (s, taint.key if taint else "",
                       taint.value if taint else "")
                status = shared.get(key)
                if status is None:
                    reason = (f"node(s) had untolerated taint "
                              f"{{{taint.key}: {taint.value}}}" if taint
                              else "node(s) had untolerated taint")
                    status = shared[key] = Status.unresolvable(
                        reason, plugin="TaintToleration")
            elif s == prog.DIAG_FIT:
                # fit.go insufficient_resources: Too many pods + per-column
                # Insufficient <resource>; unresolvable when a request
                # exceeds this node's raw allocatable
                cols = tuple(int(c) for c in np.nonzero(cols_fail[i])[0])
                unresolvable = any(int(req_row[c]) > int(cap[i, c])
                                   for c in cols)
                key = (s, bool(pods_fail[i]), cols, unresolvable)
                status = shared.get(key)
                if status is None:
                    reasons = []
                    if pods_fail[i]:
                        reasons.append("Too many pods")
                    reasons.extend(
                        "Insufficient " + (rnames[c] if c < len(rnames)
                                           else f"resource-{c}")
                        for c in cols)
                    mk = (Status.unresolvable if unresolvable
                          else Status.unschedulable)
                    status = shared[key] = mk(*reasons,
                                              plugin="NodeResourcesFit")
            else:
                status = shared.get(s)
                if status is None:
                    mk, reason, plugin = simple[s]
                    status = shared[s] = mk(reason, plugin=plugin)
            diagnosis.node_to_status[name] = status
            if status.plugin:
                diagnosis.unschedulable_plugins.add(status.plugin)
        return diagnosis

    def _handle_failure(self, qpi: QueuedPodInfo, err: FitError,
                        try_preempt: bool = True) -> None:
        """schedule_one.go:1038 handleSchedulingFailure: a scheduling
        FitError runs the PostFilter (preemption) first; a success
        nominates the returned node."""
        self.unschedulable_count += 1
        qpi.unschedulable_plugins = set(err.diagnosis.unschedulable_plugins)
        qpi.pending_plugins = set(err.diagnosis.pending_plugins)
        pod = qpi.pod
        nominated = pod.status.nominated_node_name
        profile = self.profiles.get(pod.spec.scheduler_name)
        if (try_preempt and err.num_all_nodes > 0 and profile is not None
                and profile.framework.post_filter_plugins):
            if self._pending:
                # never compute victims on state that excludes in-flight
                # drains' assignments: a dispatched drain may be about to
                # fill the very nodes the Evaluator would evict from. Each
                # nested commit pops before it handles failures, so the
                # recursion ends.
                self._drain_pending()
            self.cache.update_snapshot(self.snapshot)
            result, status = profile.framework.run_post_filter_plugins(
                CycleState(), pod, err.diagnosis.node_to_status)
            if status.is_success() and result:
                nominated = result
                pod.status.nominated_node_name = nominated
                self.queue.nominator.add(qpi, nominated)
                self.preemption_attempts += 1
        self.queue.add_unschedulable_if_not_present(qpi)
        self.dispatcher.add(APICall(
            CallType.STATUS_PATCH, qpi.pod,
            condition={"type": "PodScheduled", "status": "False",
                       "reason": "Unschedulable", "message": str(err)},
            nominated_node_name=nominated))

    def _on_bind_error(self, pod: Pod, node_name: str,
                       err: Exception) -> None:
        """schedule_one.go:361-393: forget the assumed pod and requeue it
        with error backoff."""
        self.scheduled_count -= 1
        self.error_count += 1
        try:
            self.cache.forget_pod(pod)
        except (KeyError, ValueError):
            pass
        self._invalidate_device_state()
        fresh = pod.with_node_name("")
        errors = self._bind_errors.get(pod.uid, 0) + 1
        self._bind_errors[pod.uid] = errors
        qpi = QueuedPodInfo(pod_info=PodInfo.of(fresh),
                            timestamp=self.clock(),
                            consecutive_errors_count=errors)
        self.queue.add_unschedulable_if_not_present(qpi)
        self.queue.move_all_to_active_or_backoff_queue(
            EVENT_ASSIGNED_POD_DELETE, pod, None)

    # -- debugging ------------------------------------------------------------

    def reconcile(self) -> list:
        """Pull the resident device carry into staging and compare it with
        the host cache; returns divergent node names ([] when the device
        bookkeeping matches)."""
        self._drain_pending()
        self.cache.update_snapshot(self.snapshot)
        if self._device_carry is not None:
            c = self._device_carry
            gens = {ni.name: ni.generation
                    for ni in self.snapshot.node_info_list}
            if isinstance(c, Shards):
                self.state.adopt_carry(*([getattr(s, f) for s in c] for f in
                                         ("used", "nonzero_used", "npods",
                                          "ports")), touched=gens)
            else:
                self.state.adopt_carry(c.used, c.nonzero_used, c.npods,
                                       c.ports, touched=gens)
        return self.state.reconcile(self.snapshot)

