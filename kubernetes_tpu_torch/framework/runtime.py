"""Framework runtime: the plugin runner (host path).

Mirrors pkg/scheduler/framework/runtime/framework.go — RunPreFilterPlugins
(:875-936, Skip set + PreFilterResult merge), RunFilterPlugins (:1046), the
three-phase RunScorePlugins (:1286-1390) — and schedule_one.go's schedulePod
(:426-483) as `schedule_pod`. On the TPU path this code is the *oracle*: the
batched device program must produce bind decisions in `schedule_pod`'s argmax
set; it is also the fallback for pods whose constraints have no tensor form
(the analog of the reference disabling batching when a plugin lacks
SignPlugin, runtime/framework.go:772-816).

One deliberate divergence: the reference breaks score ties with a seeded RNG
(schedule_one.go:940-944). Any tie-break is an acceptable Go outcome, so we
define a deterministic one — smallest node index among the max-score set —
which makes host and device bit-reproducible.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

from ..api.types import Pod
from .interface import Code, CycleState, PreFilterResult, Status
from .types import Diagnosis, FitError, NodeInfo


@dataclass
class Registry:
    """name → factory(args) (reference: runtime/registry.go)."""

    factories: dict[str, Callable] = field(default_factory=dict)

    def register(self, name: str, factory: Callable) -> None:
        if name in self.factories:
            raise ValueError(f"plugin {name} already registered")
        self.factories[name] = factory

    def merge(self, other: "Registry") -> None:
        for name, f in other.factories.items():
            self.register(name, f)


@dataclass
class ScoredNode:
    name: str
    index: int
    score: int


class Framework:
    """One profile's compiled plugin set (reference frameworkImpl)."""

    def __init__(self, profile_name: str, plugins: list, weights: Optional[dict[str, int]] = None):
        self.profile_name = profile_name
        self.plugins = plugins
        self.weights = weights or {}
        self.pre_enqueue_plugins = [p for p in plugins if hasattr(p, "pre_enqueue")]
        self.queue_sort_plugins = [p for p in plugins if hasattr(p, "less")]
        self.pre_filter_plugins = [p for p in plugins if hasattr(p, "pre_filter")]
        self.filter_plugins = [p for p in plugins if hasattr(p, "filter")]
        self.post_filter_plugins = [p for p in plugins if hasattr(p, "post_filter")]
        self.pre_score_plugins = [p for p in plugins if hasattr(p, "pre_score")]
        self.score_plugins = [p for p in plugins if hasattr(p, "score")]
        self.reserve_plugins = [p for p in plugins if hasattr(p, "reserve")]
        self.permit_plugins = [p for p in plugins if hasattr(p, "permit")]
        self.pre_bind_plugins = [p for p in plugins if hasattr(p, "pre_bind")]
        self.bind_plugins = [p for p in plugins if hasattr(p, "bind")]
        self.post_bind_plugins = [p for p in plugins if hasattr(p, "post_bind")]

    def plugin_weight(self, plugin) -> int:
        return self.weights.get(plugin.name(), 1)

    def queue_sort_less(self, a, b) -> bool:
        return self.queue_sort_plugins[0].less(a, b)

    # -- PreEnqueue ----------------------------------------------------------

    def run_pre_enqueue_plugins(self, pod: Pod) -> Status:
        for p in self.pre_enqueue_plugins:
            status = p.pre_enqueue(pod)
            if not status.is_success():
                status.plugin = status.plugin or p.name()
                return status
        return Status.success()

    # -- PreFilter -----------------------------------------------------------

    def run_pre_filter_plugins(self, state: CycleState, pod: Pod, nodes: list[NodeInfo]
                               ) -> tuple[Optional[PreFilterResult], Status]:
        result: Optional[PreFilterResult] = None
        for p in self.pre_filter_plugins:
            r, status = p.pre_filter(state, pod, nodes)
            if status.is_skip():
                state.skip_filter_plugins.add(p.name())
                continue
            if not status.is_success():
                status.plugin = status.plugin or p.name()
                return None, status
            if r is not None and not r.all_nodes():
                result = r if result is None else result.merge(r)
        return result, Status.success()

    # -- Filter --------------------------------------------------------------

    def run_filter_plugins(self, state: CycleState, pod: Pod, node_info: NodeInfo) -> Status:
        for p in self.filter_plugins:
            if p.name() in state.skip_filter_plugins:
                continue
            status = p.filter(state, pod, node_info)
            if not status.is_success():
                status.plugin = status.plugin or p.name()
                return status
        return Status.success()

    def find_nodes_that_pass_filters(self, state: CycleState, pod: Pod,
                                     nodes: list[NodeInfo],
                                     pre_result: Optional[PreFilterResult],
                                     diagnosis: Diagnosis,
                                     nominator=None) -> list[NodeInfo]:
        feasible = []
        allowed = pre_result.node_names if pre_result and not pre_result.all_nodes() else None
        for ni in nodes:
            if allowed is not None and ni.name not in allowed:
                continue
            if nominator is not None:
                status = self.run_filter_plugins_with_nominated_pods(
                    state, pod, ni, nominator)
            else:
                status = self.run_filter_plugins(state, pod, ni)
            if status.is_success():
                feasible.append(ni)
            else:
                diagnosis.node_to_status[ni.name] = status
                if status.plugin:
                    diagnosis.unschedulable_plugins.add(status.plugin)
        return feasible

    def run_filter_plugins_with_nominated_pods(self, state: CycleState,
                                               pod: Pod, node_info: NodeInfo,
                                               nominator=None) -> Status:
        """runtime/framework.go:1158-1231 — two-pass filter: first WITH all
        higher-or-equal-priority pods nominated onto this node (their
        resources assumed occupied via the AddPod extensions on a NodeInfo
        copy), then, only if nominated pods existed, again WITHOUT them.
        Both passes must succeed."""
        nominated = (nominator.pods_for_node(node_info.name)
                     if nominator is not None else [])
        relevant = [q for q in nominated
                    if q.pod.spec.priority >= pod.spec.priority
                    and q.pod.uid != pod.uid]
        if relevant:
            ni = node_info.snapshot_clone()
            state_w = state.clone()
            for q in relevant:
                pi = q.pod_info
                ni.add_pod(pi)
                self.run_pre_filter_extensions_add_pod(state_w, pod, pi, ni)
            status = self.run_filter_plugins(state_w, pod, ni)
            if not status.is_success():
                return status
        return self.run_filter_plugins(state, pod, node_info)

    # -- PreFilterExtensions (preemption dry-run support) ---------------------

    def run_pre_filter_extensions_add_pod(self, state: CycleState, pod: Pod,
                                          pi, node_info: NodeInfo) -> Status:
        for p in self.pre_filter_plugins:
            if p.name() in state.skip_filter_plugins:
                continue
            if hasattr(p, "add_pod"):
                status = p.add_pod(state, pod, pi, node_info)
                if not status.is_success():
                    return status
        return Status.success()

    def run_pre_filter_extensions_remove_pod(self, state: CycleState,
                                             pod: Pod, pi,
                                             node_info: NodeInfo) -> Status:
        for p in self.pre_filter_plugins:
            if p.name() in state.skip_filter_plugins:
                continue
            if hasattr(p, "remove_pod"):
                status = p.remove_pod(state, pod, pi, node_info)
                if not status.is_success():
                    return status
        return Status.success()

    # -- PostFilter (runtime/framework.go:1068) --------------------------------

    def run_post_filter_plugins(self, state: CycleState, pod: Pod,
                                filtered_node_status_map
                                ) -> tuple[Optional[str], Status]:
        """Returns (nominated node name | None, status). First plugin that
        succeeds (or errors) short-circuits; Unschedulable statuses merge."""
        statuses = []
        for p in self.post_filter_plugins:
            result, status = p.post_filter(state, pod,
                                           filtered_node_status_map)
            if status.is_success():
                return result, status
            if status.code == Code.ERROR:
                return None, status
            statuses.append(status)
        reasons = tuple(r for s in statuses for r in s.reasons)
        return None, Status.unschedulable(*reasons)

    # -- Score (three phases, reference runtime:1286-1390) -------------------

    def run_pre_score_plugins(self, state: CycleState, pod: Pod,
                              nodes: list[NodeInfo],
                              all_nodes: Optional[list[NodeInfo]] = None) -> Status:
        """`nodes` is the feasible set; `all_nodes` the full snapshot list —
        several plugins count over all nodes (e.g. interpodaffinity
        scoring.go:148 uses the shared lister, not the filtered list)."""
        for p in self.pre_score_plugins:
            status = p.pre_score(state, pod, nodes, all_nodes=all_nodes)
            if status.is_skip():
                state.skip_score_plugins.add(p.name())
                continue
            if not status.is_success():
                status.plugin = status.plugin or p.name()
                return status
        return Status.success()

    def run_score_plugins(self, state: CycleState, pod: Pod, nodes: list[NodeInfo]
                          ) -> tuple[list[int], Status]:
        """Returns the weighted total per node (parallel to `nodes`)."""
        totals = [0] * len(nodes)
        for p in self.score_plugins:
            if p.name() in state.skip_score_plugins:
                continue
            scores = []
            for ni in nodes:
                s, status = p.score(state, pod, ni)
                if not status.is_success():
                    status.plugin = status.plugin or p.name()
                    return totals, status
                scores.append(s)
            status = p.normalize_scores(state, pod, scores,
                                        node_names=[ni.name for ni in nodes])
            if not status.is_success():
                return totals, status
            w = self.plugin_weight(p)
            for i, s in enumerate(scores):
                totals[i] += s * w
        return totals, Status.success()

    # -- Reserve / Permit / Bind --------------------------------------------

    def run_reserve_plugins_reserve(self, state: CycleState, pod: Pod, node_name: str) -> Status:
        for p in self.reserve_plugins:
            status = p.reserve(state, pod, node_name)
            if not status.is_success():
                status.plugin = status.plugin or p.name()
                return status
        return Status.success()

    def run_reserve_plugins_unreserve(self, state: CycleState, pod: Pod, node_name: str) -> None:
        for p in reversed(self.reserve_plugins):
            p.unreserve(state, pod, node_name)

    def run_permit_plugins(self, state: CycleState, pod: Pod,
                           node_name: str) -> tuple[Status, float]:
        """Returns (Success | Wait | rejection, max wait timeout) —
        runtime/framework.go RunPermitPlugins."""
        wait_status: Optional[Status] = None
        max_timeout = 0.0
        for p in self.permit_plugins:
            status, timeout = p.permit(state, pod, node_name)
            if status.code == Code.WAIT:
                wait_status = status
                max_timeout = max(max_timeout, timeout or 0.0)
                continue
            if not status.is_success():
                status.plugin = status.plugin or p.name()
                return status, 0.0
        return wait_status or Status.success(), max_timeout

    def run_pre_bind_plugins(self, state: CycleState, pod: Pod, node_name: str) -> Status:
        for p in self.pre_bind_plugins:
            status = p.pre_bind(state, pod, node_name)
            if not status.is_success():
                status.plugin = status.plugin or p.name()
                return status
        return Status.success()

    def run_bind_plugins(self, state: CycleState, pod: Pod, node_name: str) -> Status:
        for p in self.bind_plugins:
            status = p.bind(state, pod, node_name)
            if status.is_skip():
                continue
            status.plugin = status.plugin or p.name()
            return status
        return Status.success()

    def run_post_bind_plugins(self, state: CycleState, pod: Pod, node_name: str) -> None:
        for p in self.post_bind_plugins:
            p.post_bind(state, pod, node_name)


# ---------------------------------------------------------------------------
# schedulePod (reference schedule_one.go:426-483) — the oracle


@dataclass
class ScheduleResult:
    suggested_host: str
    evaluated_nodes: int
    feasible_nodes: int
    # every node tied at max score: device decisions must land in this set
    argmax_set: frozenset[str] = frozenset()
    scores: dict[str, int] = field(default_factory=dict)


def schedule_pod(fwk: Framework, state: CycleState, pod: Pod,
                 nodes: list[NodeInfo], nominator=None) -> ScheduleResult:
    if not nodes:
        raise FitError(pod, 0)
    diagnosis = Diagnosis()
    pre_result, status = fwk.run_pre_filter_plugins(state, pod, nodes)
    if not status.is_success():
        if status.is_rejected():
            diagnosis.pre_filter_msg = "; ".join(status.reasons)
            if status.plugin:
                diagnosis.unschedulable_plugins.add(status.plugin)
            raise FitError(pod, len(nodes), diagnosis)
        raise RuntimeError(f"prefilter error: {status.reasons}")

    feasible = fwk.find_nodes_that_pass_filters(state, pod, nodes, pre_result,
                                                diagnosis, nominator=nominator)
    if not feasible:
        raise FitError(pod, len(nodes), diagnosis)
    if len(feasible) == 1:
        return ScheduleResult(feasible[0].name, len(nodes), 1,
                              frozenset([feasible[0].name]),
                              {feasible[0].name: 0})

    status = fwk.run_pre_score_plugins(state, pod, feasible, all_nodes=nodes)
    if not status.is_success():
        raise RuntimeError(f"prescore error: {status.reasons}")
    totals, status = fwk.run_score_plugins(state, pod, feasible)
    if not status.is_success():
        raise RuntimeError(f"score error: {status.reasons}")

    best = max(totals)
    argmax = frozenset(ni.name for ni, s in zip(feasible, totals) if s == best)
    # deterministic tie-break: first feasible node at max score
    chosen = next(ni.name for ni, s in zip(feasible, totals) if s == best)
    return ScheduleResult(chosen, len(nodes), len(feasible), argmax,
                          {ni.name: s for ni, s in zip(feasible, totals)})
