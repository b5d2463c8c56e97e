"""Plugin ABI: Status codes, extension points, CycleState.

Mirrors the public plugin surface of the reference
(staging/src/k8s.io/kube-scheduler/framework/interface.go:46-824) with the
same extension-point taxonomy. TPU-tensorized plugins additionally implement
the `TensorPlugin` protocols in plugins/tensor.py — a Filter plugin can emit
a vmappable mask, a Score plugin a node-score vector; plugins lacking a
tensor form fall back to the host path (the analog of the reference gating
batching on SignPlugin support, runtime/framework.go:772-816).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Optional, Protocol, runtime_checkable


class Code(enum.IntEnum):
    """Reference: interface.go:46-100."""

    SUCCESS = 0
    ERROR = 1
    UNSCHEDULABLE = 2
    UNSCHEDULABLE_AND_UNRESOLVABLE = 3
    WAIT = 4
    SKIP = 5
    PENDING = 6


@dataclass
class Status:
    code: Code = Code.SUCCESS
    reasons: tuple[str, ...] = ()
    plugin: str = ""

    @staticmethod
    def success() -> "Status":
        return Status()

    @staticmethod
    def unschedulable(*reasons: str, plugin: str = "") -> "Status":
        return Status(Code.UNSCHEDULABLE, reasons, plugin)

    @staticmethod
    def unresolvable(*reasons: str, plugin: str = "") -> "Status":
        return Status(Code.UNSCHEDULABLE_AND_UNRESOLVABLE, reasons, plugin)

    @staticmethod
    def error(*reasons: str, plugin: str = "") -> "Status":
        return Status(Code.ERROR, reasons, plugin)

    @staticmethod
    def skip() -> "Status":
        return Status(Code.SKIP)

    def is_success(self) -> bool:
        return self.code == Code.SUCCESS

    def is_skip(self) -> bool:
        return self.code == Code.SKIP

    def is_rejected(self) -> bool:
        return self.code in (Code.UNSCHEDULABLE, Code.UNSCHEDULABLE_AND_UNRESOLVABLE, Code.PENDING)


MAX_NODE_SCORE = 100  # reference: interface.go MaxNodeScore
MIN_NODE_SCORE = 0


class CycleState:
    """Per-scheduling-cycle typed KV store (reference: cycle_state.go).

    On the TPU path one CycleState serves a whole batch; plugin pre-computed
    state is keyed exactly like the reference ("PreFilter<Plugin>" keys).
    """

    def __init__(self) -> None:
        self._data: dict[str, Any] = {}
        self.skip_filter_plugins: set[str] = set()
        self.skip_score_plugins: set[str] = set()
        # plugin_execution_duration sampling flag: set on ~10% of cycles
        # (reference pluginMetricsSamplePercent, schedule_one.go:51)
        self.record_plugin_metrics: bool = False

    def write(self, key: str, value: Any) -> None:
        self._data[key] = value

    def read(self, key: str) -> Any:
        if key not in self._data:
            raise KeyError(key)
        return self._data[key]

    def read_or_none(self, key: str) -> Any:
        return self._data.get(key)

    def clone(self) -> "CycleState":
        """cycle_state.go Clone: plugin state objects that implement
        clone() are deep-copied (StateData.Clone in the reference) so
        AddPod/RemovePod simulations on the clone never leak into the
        original; immutable values are shared."""
        cs = CycleState()
        cs._data = {k: (v.clone() if hasattr(v, "clone") else v)
                    for k, v in self._data.items()}
        cs.skip_filter_plugins = set(self.skip_filter_plugins)
        cs.skip_score_plugins = set(self.skip_score_plugins)
        return cs


@dataclass
class PreFilterResult:
    """Reference: interface.go PreFilterResult — node-name set shortcut."""

    node_names: Optional[set[str]] = None  # None = all nodes

    def merge(self, other: "PreFilterResult") -> "PreFilterResult":
        if self.node_names is None:
            return other
        if other.node_names is None:
            return self
        return PreFilterResult(self.node_names & other.node_names)

    def all_nodes(self) -> bool:
        return self.node_names is None


# ---------------------------------------------------------------------------
# plugin protocols (host path). NodeInfo / PodInfo types come from
# framework.types; `Any` here avoids a circular import.


@runtime_checkable
class Plugin(Protocol):
    def name(self) -> str: ...


class PreEnqueuePlugin(Protocol):
    def pre_enqueue(self, pod) -> Status: ...


class QueueSortPlugin(Protocol):
    def less(self, a, b) -> bool: ...


class PreFilterPlugin(Protocol):
    def pre_filter(self, state: CycleState, pod, nodes) -> tuple[Optional[PreFilterResult], Status]: ...


class FilterPlugin(Protocol):
    def filter(self, state: CycleState, pod, node_info) -> Status: ...


class PostFilterPlugin(Protocol):
    def post_filter(self, state: CycleState, pod, filtered_node_status_map) -> tuple[Optional[str], Status]: ...


class PreScorePlugin(Protocol):
    def pre_score(self, state: CycleState, pod, nodes) -> Status: ...


class ScorePlugin(Protocol):
    def score(self, state: CycleState, pod, node_info) -> tuple[int, Status]: ...

    def normalize_scores(self, state: CycleState, pod, scores: list[int],
                         node_names: Optional[list[str]] = None) -> Status: ...


class ReservePlugin(Protocol):
    def reserve(self, state: CycleState, pod, node_name: str) -> Status: ...

    def unreserve(self, state: CycleState, pod, node_name: str) -> None: ...


class PermitPlugin(Protocol):
    def permit(self, state: CycleState, pod, node_name: str) -> tuple[Status, float]: ...


class PreBindPlugin(Protocol):
    def pre_bind(self, state: CycleState, pod, node_name: str) -> Status: ...


class BindPlugin(Protocol):
    def bind(self, state: CycleState, pod, node_name: str) -> Status: ...


class PostBindPlugin(Protocol):
    def post_bind(self, state: CycleState, pod, node_name: str) -> None: ...


class EnqueueExtensions(Protocol):
    """Reference: interface.go:412 EventsToRegister → queueing hints."""

    def events_to_register(self) -> list: ...


