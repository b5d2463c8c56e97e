"""InterPodAffinity plugin (host/oracle path).

Algorithm parity with the reference (pkg/scheduler/framework/plugins/
interpodaffinity/):
- PreFilter (filtering.go:273-312): builds three topologyPair→count maps —
  existing pods' required anti-affinity terms matching the incoming pod
  (over nodes that have such pods), and the incoming pod's required
  affinity / anti-affinity terms matching existing pods (over all nodes).
- Filter (filtering.go:405-432): affinity check (UnschedulableAndUnresolvable,
  with the self-affinity escape hatch filtering.go:381-397), then incoming
  anti-affinity (Unschedulable), then existing-pods anti-affinity
  (Unschedulable).
- AddPod/RemovePod PreFilterExtensions (filtering.go:322-341) for preemption.
- PreScore/Score/Normalize (scoring.go): symmetric weighted topology score —
  incoming preferred terms vs existing pods, existing pods' preferred terms
  (and hard terms × HardPodAffinityWeight) vs incoming pod; normalize to
  0..100 by min/max (scoring.go:263-293).

AffinityTerm namespace semantics (staging framework/types.go:379-392):
a term matches pods in its namespace set (defaulting to the owner pod's
namespace) or namespaces selected by namespaceSelector; the incoming pod's
namespaceSelector is resolved to a concrete namespace set at PreFilter
(plugin.go:144-157 mergeAffinityTermNamespacesIfNotEmpty).

Note: `matchLabelKeys` on affinity terms is merged into the labelSelector by
the API server at pod admission in the reference, so the scheduler never
sees it; our ingestion layer does the same.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

from ..api.types import Affinity, LabelSelector, Pod, PodAffinityTerm
from ..framework.interface import (MAX_NODE_SCORE, CycleState, PreFilterResult,
                                   Status)
from ..framework.types import NodeInfo, PodInfo

NAME = "InterPodAffinity"

ERR_EXISTING_ANTI_AFFINITY = "node(s) didn't satisfy existing pods anti-affinity rules"
ERR_AFFINITY = "node(s) didn't match pod affinity rules"
ERR_ANTI_AFFINITY = "node(s) didn't match pod anti-affinity rules"

_PRE_FILTER_KEY = "PreFilter" + NAME
_PRE_SCORE_KEY = "PreScore" + NAME

DEFAULT_HARD_POD_AFFINITY_WEIGHT = 1  # apis/config/v1/defaults.go


# ---------------------------------------------------------------------------
# parsed affinity terms


@dataclass
class ParsedTerm:
    """staging framework/types.go AffinityTerm."""

    namespaces: frozenset[str]
    selector: Optional[LabelSelector]       # None ⇒ matches nothing
    topology_key: str
    namespace_selector: Optional[LabelSelector]  # None ⇒ selects nothing

    def matches(self, pod: Pod, ns_labels: Optional[dict[str, str]]) -> bool:
        in_ns = pod.namespace in self.namespaces
        if not in_ns and self.namespace_selector is not None and ns_labels is not None:
            in_ns = self.namespace_selector.matches(ns_labels)
        if not in_ns:
            return False
        if self.selector is None:
            return False
        return self.selector.matches(pod.metadata.labels)


@dataclass
class WeightedTerm:
    term: ParsedTerm
    weight: int


def _parse_term(pod: Pod, t: PodAffinityTerm) -> ParsedTerm:
    """newAffinityTerm (staging types.go:419-432): empty namespaces AND nil
    namespaceSelector ⇒ the pod's own namespace."""
    if not t.namespaces and t.namespace_selector is None:
        namespaces = frozenset([pod.namespace])
    else:
        namespaces = frozenset(t.namespaces)
    return ParsedTerm(namespaces=namespaces, selector=t.label_selector,
                      topology_key=t.topology_key,
                      namespace_selector=t.namespace_selector)


def parse_pod_affinity_terms(pod: Pod) -> tuple[list[ParsedTerm], list[ParsedTerm],
                                                list[WeightedTerm], list[WeightedTerm]]:
    """→ (required affinity, required anti-affinity, preferred affinity,
    preferred anti-affinity)."""
    aff: Optional[Affinity] = pod.spec.affinity
    req_a: list[ParsedTerm] = []
    req_aa: list[ParsedTerm] = []
    pref_a: list[WeightedTerm] = []
    pref_aa: list[WeightedTerm] = []
    if aff is None:
        return req_a, req_aa, pref_a, pref_aa
    if aff.pod_affinity:
        req_a = [_parse_term(pod, t) for t in aff.pod_affinity.required]
        pref_a = [WeightedTerm(_parse_term(pod, w.term), w.weight)
                  for w in aff.pod_affinity.preferred]
    if aff.pod_anti_affinity:
        req_aa = [_parse_term(pod, t) for t in aff.pod_anti_affinity.required]
        pref_aa = [WeightedTerm(_parse_term(pod, w.term), w.weight)
                   for w in aff.pod_anti_affinity.preferred]
    return req_a, req_aa, pref_a, pref_aa


def _pod_matches_all_affinity_terms(terms: list[ParsedTerm], pod: Pod) -> bool:
    """filtering.go:186-199 — vacuously false for no terms; nsLabels nil
    because the incoming pod's namespaceSelector was merged into namespaces."""
    if not terms:
        return False
    return all(t.matches(pod, None) for t in terms)


# ---------------------------------------------------------------------------
# state


@dataclass
class _PreFilterState:
    existing_anti_affinity_counts: dict[tuple[str, str], int] = field(default_factory=dict)
    affinity_counts: dict[tuple[str, str], int] = field(default_factory=dict)
    anti_affinity_counts: dict[tuple[str, str], int] = field(default_factory=dict)
    req_affinity_terms: list[ParsedTerm] = field(default_factory=list)
    req_anti_affinity_terms: list[ParsedTerm] = field(default_factory=list)
    pod: Optional[Pod] = None
    namespace_labels: dict[str, str] = field(default_factory=dict)

    def clone(self) -> "_PreFilterState":
        """filtering.go preFilterState.Clone() — count maps copied,
        parsed terms shared (immutable)."""
        return _PreFilterState(
            existing_anti_affinity_counts=dict(self.existing_anti_affinity_counts),
            affinity_counts=dict(self.affinity_counts),
            anti_affinity_counts=dict(self.anti_affinity_counts),
            req_affinity_terms=self.req_affinity_terms,
            req_anti_affinity_terms=self.req_anti_affinity_terms,
            pod=self.pod,
            namespace_labels=self.namespace_labels)


def _update_counts(counts: dict[tuple[str, str], int], node_labels: dict[str, str],
                   tk: str, value: int) -> None:
    tv = node_labels.get(tk)
    if tv is None:
        return
    pair = (tk, tv)
    counts[pair] = counts.get(pair, 0) + value
    if counts[pair] == 0:
        del counts[pair]


def _update_with_affinity_terms(counts, terms: list[ParsedTerm], pod: Pod,
                                node_labels, value: int) -> None:
    if _pod_matches_all_affinity_terms(terms, pod):
        for t in terms:
            _update_counts(counts, node_labels, t.topology_key, value)


def _update_with_anti_affinity_terms(counts, terms: list[ParsedTerm], pod: Pod,
                                     ns_labels, node_labels, value: int) -> None:
    for t in terms:
        if t.matches(pod, ns_labels):
            _update_counts(counts, node_labels, t.topology_key, value)


@dataclass
class _PreScoreState:
    topology_score: dict[str, dict[str, int]] = field(default_factory=dict)
    namespace_labels: dict[str, str] = field(default_factory=dict)
    pref_affinity_terms: list[WeightedTerm] = field(default_factory=list)
    pref_anti_affinity_terms: list[WeightedTerm] = field(default_factory=list)


# ---------------------------------------------------------------------------
# plugin


@dataclass
class InterPodAffinityArgs:
    hard_pod_affinity_weight: int = DEFAULT_HARD_POD_AFFINITY_WEIGHT
    ignore_preferred_terms_of_existing_pods: bool = False


class NamespaceLister:
    """namespace name → labels; resolves namespaceSelectors. The in-memory
    analog of the reference's nsLister (plugin.go:144-169)."""

    def __init__(self, namespaces: Optional[dict[str, dict[str, str]]] = None):
        self.namespaces = namespaces if namespaces is not None else {}

    def labels_of(self, ns: str) -> dict[str, str]:
        return self.namespaces.get(ns, {})

    def select(self, selector: LabelSelector) -> frozenset[str]:
        return frozenset(n for n, lbls in self.namespaces.items()
                         if selector.matches(lbls))


class InterPodAffinity:
    """PF(+Extensions), F, PS, S, N, EE, Sg — reference interpodaffinity/."""

    def __init__(self, args: Optional[InterPodAffinityArgs] = None,
                 ns_lister: Optional[NamespaceLister] = None):
        self.args = args or InterPodAffinityArgs()
        self.ns_lister = ns_lister or NamespaceLister()

    def name(self) -> str:
        return NAME

    def _merge_term_namespaces(self, term: ParsedTerm) -> ParsedTerm:
        """mergeAffinityTermNamespacesIfNotEmpty (plugin.go:144-157): resolve
        the namespaceSelector to concrete namespaces; empty selector selects
        every namespace."""
        if term.namespace_selector is None:
            return term
        selected = self.ns_lister.select(term.namespace_selector)
        return ParsedTerm(namespaces=term.namespaces | selected,
                          selector=term.selector,
                          topology_key=term.topology_key,
                          namespace_selector=None)

    # -- PreFilter ------------------------------------------------------------

    def pre_filter(self, state: CycleState, pod: Pod, nodes: list[NodeInfo]
                   ) -> tuple[Optional[PreFilterResult], Status]:
        req_a, req_aa, _, _ = parse_pod_affinity_terms(pod)
        req_a = [self._merge_term_namespaces(t) for t in req_a]
        req_aa = [self._merge_term_namespaces(t) for t in req_aa]

        s = _PreFilterState(req_affinity_terms=req_a,
                            req_anti_affinity_terms=req_aa, pod=pod,
                            namespace_labels=self.ns_lister.labels_of(pod.namespace))

        # existing pods' required anti-affinity vs the incoming pod
        # (filtering.go:204-228; only nodes that have such pods)
        for ni in nodes:
            if not ni.pods_with_required_anti_affinity:
                continue
            labels = ni.node.metadata.labels
            for existing in ni.pods_with_required_anti_affinity:
                terms = _required_anti_affinity_terms_of(existing)
                _update_with_anti_affinity_terms(
                    s.existing_anti_affinity_counts, terms, pod,
                    s.namespace_labels, labels, 1)

        # incoming pod's required terms vs all existing pods
        # (filtering.go:234-271)
        if req_a or req_aa:
            for ni in nodes:
                labels = ni.node.metadata.labels
                for existing in ni.pods:
                    _update_with_affinity_terms(
                        s.affinity_counts, req_a, existing.pod, labels, 1)
                    _update_with_anti_affinity_terms(
                        s.anti_affinity_counts, req_aa, existing.pod, None,
                        labels, 1)

        if not s.existing_anti_affinity_counts and not req_a and not req_aa:
            return None, Status.skip()
        state.write(_PRE_FILTER_KEY, s)
        return None, Status.success()

    def events_to_register(self):
        """interpodaffinity EventsToRegister (plugin.go): an assigned pod
        helps when it matches one of my terms (affinity satisfied, or an
        anti-affinity blocker removed on delete), or when I match one of
        ITS anti-affinity terms (the symmetric veto disappearing); node
        add / label change can create new matching topologies."""
        from ..backend.queue import ClusterEventWithHint
        from ..framework.types import (ActionType, ClusterEvent,
                                       EventResource, QueueingHint)

        def after_pod_change(pod: Pod, old, new):
            # BOTH sides of an update matter: a label removal can clear an
            # anti-affinity blocker (the old pod matched, the new doesn't)
            candidates = [p for p in (old, new) if p is not None]
            if not candidates:
                return QueueingHint.QUEUE
            req_a, req_aa, pref_a, pref_aa = parse_pod_affinity_terms(pod)
            my_terms = req_a + req_aa + [w.term for w in pref_a + pref_aa]
            my_ns_labels = self.ns_lister.labels_of(pod.namespace)
            for other in candidates:
                ns_labels = self.ns_lister.labels_of(other.namespace)
                for t in my_terms:
                    if t.matches(other, ns_labels):
                        return QueueingHint.QUEUE
                _, o_req_aa, _, _ = parse_pod_affinity_terms(other)
                for t in o_req_aa:
                    if t.matches(pod, my_ns_labels):
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

    # -- PreFilterExtensions --------------------------------------------------

    def add_pod(self, state: CycleState, pod_to_schedule: Pod,
                pod_info_to_add: PodInfo, node_info: NodeInfo) -> Status:
        self._update_with_pod(state, pod_info_to_add, node_info, 1)
        return Status.success()

    def remove_pod(self, state: CycleState, pod_to_schedule: Pod,
                   pod_info_to_remove: PodInfo, node_info: NodeInfo) -> Status:
        self._update_with_pod(state, pod_info_to_remove, node_info, -1)
        return Status.success()

    def _update_with_pod(self, state: CycleState, pi: PodInfo,
                         node_info: NodeInfo, multiplier: int) -> None:
        s: Optional[_PreFilterState] = state.read_or_none(_PRE_FILTER_KEY)
        if s is None:
            return
        labels = node_info.node.metadata.labels
        _update_with_anti_affinity_terms(
            s.existing_anti_affinity_counts,
            _required_anti_affinity_terms_of(pi), s.pod,
            s.namespace_labels, labels, multiplier)
        _update_with_affinity_terms(
            s.affinity_counts, s.req_affinity_terms, pi.pod, labels, multiplier)
        _update_with_anti_affinity_terms(
            s.anti_affinity_counts, s.req_anti_affinity_terms, pi.pod, None,
            labels, multiplier)

    # -- Filter ---------------------------------------------------------------

    def filter(self, state: CycleState, pod: Pod, node_info: NodeInfo) -> Status:
        s: Optional[_PreFilterState] = state.read_or_none(_PRE_FILTER_KEY)
        if s is None:
            return Status.success()
        labels = node_info.node.metadata.labels

        if not self._satisfy_pod_affinity(s, labels):
            return Status.unresolvable(ERR_AFFINITY, plugin=NAME)
        if not self._satisfy_pod_anti_affinity(s, labels):
            return Status.unschedulable(ERR_ANTI_AFFINITY, plugin=NAME)
        if not self._satisfy_existing_pods_anti_affinity(s, labels):
            return Status.unschedulable(ERR_EXISTING_ANTI_AFFINITY, plugin=NAME)
        return Status.success()

    @staticmethod
    def _satisfy_existing_pods_anti_affinity(s: _PreFilterState,
                                             node_labels: dict[str, str]) -> bool:
        if s.existing_anti_affinity_counts:
            for tk, tv in node_labels.items():
                if s.existing_anti_affinity_counts.get((tk, tv), 0) > 0:
                    return False
        return True

    @staticmethod
    def _satisfy_pod_anti_affinity(s: _PreFilterState,
                                   node_labels: dict[str, str]) -> bool:
        if s.anti_affinity_counts:
            for term in s.req_anti_affinity_terms:
                tv = node_labels.get(term.topology_key)
                if tv is not None and s.anti_affinity_counts.get((term.topology_key, tv), 0) > 0:
                    return False
        return True

    @staticmethod
    def _satisfy_pod_affinity(s: _PreFilterState, node_labels: dict[str, str]) -> bool:
        pods_exist = True
        for term in s.req_affinity_terms:
            tv = node_labels.get(term.topology_key)
            if tv is None:
                return False  # all topology labels must exist on the node
            if s.affinity_counts.get((term.topology_key, tv), 0) <= 0:
                pods_exist = False
        if not pods_exist:
            # first-pod-in-series escape hatch (filtering.go:381-397)
            if not s.affinity_counts and _pod_matches_all_affinity_terms(
                    s.req_affinity_terms, s.pod):
                return True
            return False
        return True

    # -- PreScore / Score / Normalize -----------------------------------------

    def pre_score(self, state: CycleState, pod: Pod, nodes: list[NodeInfo],
                  all_nodes: Optional[list[NodeInfo]] = None) -> Status:
        all_nodes = all_nodes if all_nodes is not None else nodes
        _, _, pref_a, pref_aa = parse_pod_affinity_terms(pod)
        has_constraints = bool(pref_a or pref_aa)
        if self.args.ignore_preferred_terms_of_existing_pods and not has_constraints:
            return Status.skip()

        pref_a = [WeightedTerm(self._merge_term_namespaces(w.term), w.weight)
                  for w in pref_a]
        pref_aa = [WeightedTerm(self._merge_term_namespaces(w.term), w.weight)
                   for w in pref_aa]
        s = _PreScoreState(pref_affinity_terms=pref_a,
                           pref_anti_affinity_terms=pref_aa,
                           namespace_labels=self.ns_lister.labels_of(pod.namespace))

        # Unless the incoming pod has preferred terms, only nodes hosting
        # pods with affinity need processing (scoring.go:148-163).
        for ni in all_nodes:
            node_labels = ni.node.metadata.labels
            if not node_labels:
                continue
            pods_to_process = ni.pods if has_constraints else ni.pods_with_affinity
            for existing in pods_to_process:
                self._process_existing_pod(s, existing, node_labels, pod)
        if not s.topology_score:
            return Status.skip()
        state.write(_PRE_SCORE_KEY, s)
        return Status.success()

    def _process_existing_pod(self, s: _PreScoreState, existing: PodInfo,
                              node_labels: dict[str, str], incoming: Pod) -> None:
        """scoring.go:81-124 processExistingPod."""
        ts = s.topology_score

        def process(term: ParsedTerm, weight: int, target: Pod,
                    ns_labels, multiplier: int) -> None:
            if term.matches(target, ns_labels):
                tv = node_labels.get(term.topology_key)
                if tv is not None:
                    ts.setdefault(term.topology_key, {})
                    ts[term.topology_key][tv] = (
                        ts[term.topology_key].get(tv, 0) + weight * multiplier)

        for w in s.pref_affinity_terms:
            process(w.term, w.weight, existing.pod, None, 1)
        for w in s.pref_anti_affinity_terms:
            process(w.term, w.weight, existing.pod, None, -1)

        ex_req_a, _, ex_pref_a, ex_pref_aa = parse_pod_affinity_terms(existing.pod)
        if self.args.hard_pod_affinity_weight > 0:
            for t in ex_req_a:
                process(t, self.args.hard_pod_affinity_weight, incoming,
                        s.namespace_labels, 1)
        for w in ex_pref_a:
            process(w.term, w.weight, incoming, s.namespace_labels, 1)
        for w in ex_pref_aa:
            process(w.term, w.weight, incoming, s.namespace_labels, -1)

    def score(self, state: CycleState, pod: Pod, node_info: NodeInfo
              ) -> tuple[int, Status]:
        s: Optional[_PreScoreState] = state.read_or_none(_PRE_SCORE_KEY)
        if s is None:
            return 0, Status.success()
        labels = node_info.node.metadata.labels
        score = 0
        for tk, tv_scores in s.topology_score.items():
            tv = labels.get(tk)
            if tv is not None:
                score += tv_scores.get(tv, 0)
        return score, Status.success()

    def normalize_scores(self, state: CycleState, pod: Pod, scores: list[int],
                         node_names=None) -> Status:
        s: Optional[_PreScoreState] = state.read_or_none(_PRE_SCORE_KEY)
        if s is None or not s.topology_score:
            return Status.success()
        if not scores:
            return Status.success()
        min_c, max_c = min(scores), max(scores)
        diff = max_c - min_c
        for i in range(len(scores)):
            f = 0.0
            if diff > 0:
                f = MAX_NODE_SCORE * (scores[i] - min_c) / diff
            scores[i] = int(f)
        return Status.success()


def _required_anti_affinity_terms_of(pi: PodInfo) -> list[ParsedTerm]:
    """Parsed required anti-affinity terms of an existing pod, cached on the
    PodInfo (the reference pre-parses terms at PodInfo creation)."""
    cached = getattr(pi, "_parsed_req_anti_affinity", None)
    if cached is None:
        _, cached, _, _ = parse_pod_affinity_terms(pi.pod)
        pi._parsed_req_anti_affinity = cached
    return cached
