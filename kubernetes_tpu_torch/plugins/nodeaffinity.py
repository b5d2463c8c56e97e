"""NodeAffinity plugin — reference plugins/nodeaffinity/node_affinity.go and
the matcher in component-helpers/scheduling/corev1/nodeaffinity.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..api.types import (LabelSelectorRequirement, NodeAffinity as NodeAffinitySpec,
                         NodeSelector, NodeSelectorTerm, Pod,
                         PreferredSchedulingTerm, SelectorOperator,
                         _requirement_matches)
from ..framework.interface import CycleState, PreFilterResult, Status
from ..framework.types import NodeInfo
from .helper import default_normalize

NODE_AFFINITY = "NodeAffinity"
_PRE_SCORE_KEY = "PreScore" + NODE_AFFINITY

ERR_REASON = "node(s) didn't match Pod's node affinity/selector"
OBJECT_NAME_FIELD = "metadata.name"


def _term_matches(term: NodeSelectorTerm, node_labels: dict[str, str], node_name: str) -> bool:
    """A term with no expressions and no fields selects nothing; expressions
    and fields within a term are ANDed."""
    if not term.match_expressions and not term.match_fields:
        return False
    for req in term.match_expressions:
        if not _requirement_matches(req, node_labels):
            return False
    fields = {OBJECT_NAME_FIELD: node_name}
    for req in term.match_fields:
        if not _requirement_matches(req, fields):
            return False
    return True


def node_selector_matches(selector: Optional[NodeSelector], node_labels: dict[str, str],
                          node_name: str) -> bool:
    """Terms are ORed; a present selector with zero terms matches nothing."""
    if selector is None:
        return True
    return any(_term_matches(t, node_labels, node_name) for t in selector.terms)


def required_node_affinity_matches(pod: Pod, node_labels: dict[str, str], node_name: str) -> bool:
    """GetRequiredNodeAffinity semantics: spec.nodeSelector map AND
    affinity.nodeAffinity.required."""
    for k, v in pod.spec.node_selector.items():
        if node_labels.get(k) != v:
            return False
    aff = pod.spec.affinity
    if aff and aff.node_affinity and aff.node_affinity.required is not None:
        if not node_selector_matches(aff.node_affinity.required, node_labels, node_name):
            return False
    return True


@dataclass
class NodeAffinityArgs:
    """Reference: config.NodeAffinityArgs — per-profile added affinity."""

    added_affinity: Optional[NodeAffinitySpec] = None


class NodeAffinity:
    """PF, F, PS, S, EE, Sg."""

    def __init__(self, args: Optional[NodeAffinityArgs] = None):
        self.args = args or NodeAffinityArgs()

    def name(self) -> str:
        return NODE_AFFINITY

    # -- PreFilter: metadata.name field-selector shortcut --------------------

    def pre_filter(self, state: CycleState, pod: Pod, nodes) -> tuple[Optional[PreFilterResult], Status]:
        aff = pod.spec.affinity
        required = (aff.node_affinity.required
                    if aff and aff.node_affinity and aff.node_affinity.required is not None
                    else None)
        if required is None or not required.terms:
            return None, Status.success()
        node_names: set[str] = set()
        for term in required.terms:
            if not term.match_fields:
                return None, Status.success()  # term without field constraints → all nodes
            term_names: Optional[set[str]] = None
            for req in term.match_fields:
                if req.key == OBJECT_NAME_FIELD and req.operator == SelectorOperator.IN.value:
                    vals = set(req.values)
                    term_names = vals if term_names is None else term_names & vals
            if term_names is None:
                return None, Status.success()
            node_names |= term_names
        if not node_names:
            return None, Status.unresolvable(ERR_REASON, plugin=NODE_AFFINITY)
        return PreFilterResult(node_names), Status.success()

    # -- Filter --------------------------------------------------------------

    def filter(self, state: CycleState, pod: Pod, node_info: NodeInfo) -> Status:
        labels = node_info.node.metadata.labels
        name = node_info.name
        if self.args.added_affinity and self.args.added_affinity.required is not None:
            if not node_selector_matches(self.args.added_affinity.required, labels, name):
                return Status.unresolvable(ERR_REASON, plugin=NODE_AFFINITY)
        if not required_node_affinity_matches(pod, labels, name):
            return Status.unresolvable(ERR_REASON, plugin=NODE_AFFINITY)
        return Status.success()

    # -- Score ---------------------------------------------------------------

    def _preferred_terms(self, pod: Pod) -> tuple[PreferredSchedulingTerm, ...]:
        aff = pod.spec.affinity
        terms = tuple(aff.node_affinity.preferred) if aff and aff.node_affinity else ()
        if self.args.added_affinity:
            terms = terms + tuple(self.args.added_affinity.preferred)
        return terms

    def pre_score(self, state: CycleState, pod: Pod, nodes, all_nodes=None) -> Status:
        terms = self._preferred_terms(pod)
        state.write(_PRE_SCORE_KEY, terms)
        if not terms:
            return Status.skip()
        return Status.success()

    def score(self, state: CycleState, pod: Pod, node_info: NodeInfo) -> tuple[int, Status]:
        terms = state.read_or_none(_PRE_SCORE_KEY)
        if terms is None:
            terms = self._preferred_terms(pod)
        labels = node_info.node.metadata.labels
        score = sum(t.weight for t in terms
                    if t.weight and _term_matches(t.preference, labels, node_info.name))
        return score, Status.success()

    def normalize_scores(self, state: CycleState, pod: Pod, scores: list[int],
                         node_names=None) -> Status:
        scores[:] = default_normalize(scores)
        return Status.success()

    def events_to_register(self):
        """node_affinity.go isSchedulableAfterNodeChange: queue only when
        the (new) node satisfies the pod's nodeSelector + required
        affinity."""
        from ..backend.queue import ClusterEventWithHint
        from ..framework.types import (ActionType, ClusterEvent,
                                       EventResource, QueueingHint)

        def after_node_change(pod: Pod, old, new):
            if new is None:
                return QueueingHint.QUEUE
            # the helper covers nodeSelector AND required affinity terms
            if required_node_affinity_matches(pod, new.metadata.labels,
                                              new.metadata.name):
                return QueueingHint.QUEUE
            return QueueingHint.SKIP

        return [ClusterEventWithHint(
            ClusterEvent(EventResource.NODE,
                         ActionType.ADD | ActionType.UPDATE_NODE_LABEL),
            after_node_change)]

