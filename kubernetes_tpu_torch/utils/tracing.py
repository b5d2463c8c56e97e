"""Tracing: span trees + slow-cycle logging.

The port of kubernetes_tpu/utils/tracing.py. The reference wires
OpenTelemetry through component-base/tracing (spans around the
scheduling cycle, schedule_one.go) and logs slow cycles via klog
verbosity. This is the dependency-free analog:

- `Tracer.span(name)` context manager builds a per-cycle span tree with
  wall-clock durations and optional attributes.
- finished root spans whose duration exceeds `slow_threshold_s` are kept in
  `slow_cycles` (ring buffer) and handed to `on_slow` (default: stdlib
  logging at WARNING) with a per-child breakdown.
- `NOOP_TRACER` keeps the hot path branch-free when tracing is off: span()
  returns a reusable null context.
- finished span trees export as Chrome-trace / Perfetto JSON
  (`to_chrome_trace` / `export_chrome_trace`): monotonic timestamps, one
  complete ("X") event per span, attributes as args. `keep_recent`
  retains the last K root spans regardless of duration so a bench run can
  export its whole drain history.
- `torch_profiler_session(dir)` brackets a workload with a torch.profiler
  trace (the CUDA kernels under the host spans), where the JAX package
  uses a jax.profiler session.
- `PhaseTrack` is a plain-list span-name stack the Scheduler pushes/pops
  in lockstep with its phase spans (host_snapshot/host_tensorize/
  host_group_seed/host_cache/device/commit), readable from ANY thread.
  Kept separate from Tracer so it works even under NOOP_TRACER.

The fleet merge (`fleet_chrome_trace`) waits for the port's shards.
"""

from __future__ import annotations

import json
import logging
import time
from collections import deque
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field
from typing import Callable, Optional

logger = logging.getLogger("kubernetes_tpu_torch.tracing")


@dataclass
class Span:
    name: str
    start: float = 0.0
    duration_s: float = 0.0
    attributes: dict = field(default_factory=dict)
    children: list["Span"] = field(default_factory=list)

    def set(self, **attrs) -> None:
        self.attributes.update(attrs)

    def breakdown(self, indent: int = 0) -> str:
        lines = [f"{'  ' * indent}{self.name}: {self.duration_s * 1e3:.1f}ms"
                 + (f" {self.attributes}" if self.attributes else "")]
        for c in self.children:
            lines.append(c.breakdown(indent + 1))
        return "\n".join(lines)

    def to_dict(self) -> dict:
        """Nested-dict form (the /debug/slowcycles serialization)."""
        return {"name": self.name,
                "duration_ms": round(self.duration_s * 1e3, 3),
                "attributes": dict(self.attributes),
                "children": [c.to_dict() for c in self.children]}

    def find(self, name: str) -> Optional["Span"]:
        if self.name == name:
            return self
        for c in self.children:
            hit = c.find(name)
            if hit is not None:
                return hit
        return None


class PhaseTrack:
    """Cross-thread-readable stack of open phase/span names.

    The owner (single-threaded host loop) pushes and pops; the profiler
    thread only reads the top — CPython list append/pop/index are atomic
    under the GIL, so no lock is needed and a torn read is impossible."""

    __slots__ = ("_stack",)

    def __init__(self) -> None:
        self._stack: list = []

    def push(self, name: str) -> None:
        self._stack.append(name)

    def pop(self) -> None:
        if self._stack:
            self._stack.pop()

    def current(self) -> str:
        s = self._stack
        return s[-1] if s else ""

    @contextmanager
    def scope(self, name: str):
        self._stack.append(name)
        try:
            yield
        finally:
            self.pop()


class _NullSpan:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


_NULL_SPAN = _NullSpan()


class Tracer:
    """Per-component tracer; single-threaded like the host loop it serves."""

    def __init__(self, slow_threshold_s: float = 1.0, keep: int = 32,
                 on_slow: Optional[Callable[[Span], None]] = None,
                 clock: Callable[[], float] = time.perf_counter,
                 keep_recent: int = 0):
        self.slow_threshold_s = slow_threshold_s
        self.clock = clock
        self.slow_cycles: deque[Span] = deque(maxlen=keep)
        # every finished ROOT span, slow or not (trace export); off at 0
        self.recent: deque[Span] = deque(maxlen=max(keep_recent, 1))
        self.keep_recent = keep_recent
        self.on_slow = on_slow or self._log_slow
        self._stack: list[Span] = []

    @contextmanager
    def span(self, name: str, **attributes):
        sp = Span(name=name, start=self.clock(),
                  attributes=dict(attributes))
        parent = self._stack[-1] if self._stack else None
        if parent is not None:
            parent.children.append(sp)
        self._stack.append(sp)
        try:
            yield sp
        finally:
            self._stack.pop()
            sp.duration_s = self.clock() - sp.start
            if parent is None:
                if self.keep_recent:
                    self.recent.append(sp)
                if sp.duration_s >= self.slow_threshold_s:
                    self.slow_cycles.append(sp)
                    self.on_slow(sp)

    def export_chrome_trace(self, path: str) -> int:
        """Write the retained root spans (recent if enabled, else the slow
        ring) as Chrome-trace JSON; returns the event count."""
        spans = list(self.recent if self.keep_recent else self.slow_cycles)
        trace = to_chrome_trace(spans)
        with open(path, "w") as f:
            json.dump(trace, f)
        return len(trace["traceEvents"])

    @staticmethod
    def _log_slow(sp: Span) -> None:
        logger.warning("slow scheduling cycle (%.0fms):\n%s",
                       sp.duration_s * 1e3, sp.breakdown())


class NoopTracer:
    slow_cycles: deque = deque()
    recent: deque = deque()
    keep_recent = 0

    def span(self, name: str, **attributes):
        return _NULL_SPAN


NOOP_TRACER = NoopTracer()


# ---------------------------------------------------------------------------
# Chrome-trace / Perfetto export


# tid of the merged device-kernel lane: spans tagged lane="device" (the
# kernel observatory's per-dispatch events, attached as children of the
# drain's device_dispatch span) render as their own Perfetto track under
# the same process, so the host timeline and its device decomposition
# read as ONE trace. The observatory is not ported yet; the export keeps
# the JAX package's format.
DEVICE_LANE_TID = 2


def _span_events(sp: Span, out: list, pid: int, tid: int) -> None:
    if sp.attributes.get("lane") == "device":
        tid = DEVICE_LANE_TID
    out.append({"ph": "X", "cat": "scheduler", "name": sp.name,
                "ts": sp.start * 1e6,            # µs, monotonic base
                "dur": max(sp.duration_s, 0.0) * 1e6,
                "pid": pid, "tid": tid,
                "args": {k: (v if isinstance(v, (int, float, bool, str))
                             else str(v))
                         for k, v in sp.attributes.items()}})
    for c in sp.children:
        _span_events(c, out, pid, tid)


def to_chrome_trace(spans: list[Span], process_name: str = "kube-scheduler-tpu"
                    ) -> dict:
    """Span trees → Chrome-trace JSON object (trace_event format, loadable
    at chrome://tracing / ui.perfetto.dev). Every span becomes one complete
    ("X") event; timestamps keep the tracer's monotonic base. Device-lane
    spans (kernel observatory dispatches) land on their own thread track
    (DEVICE_LANE_TID) nested timewise inside their drain's device span."""
    events: list[dict] = [
        {"ph": "M", "name": "process_name", "pid": 1, "tid": 1,
         "args": {"name": process_name}},
        {"ph": "M", "name": "thread_name", "pid": 1, "tid": 1,
         "args": {"name": "host-loop"}},
        {"ph": "M", "name": "thread_name", "pid": 1,
         "tid": DEVICE_LANE_TID, "args": {"name": "device-lanes"}},
    ]
    for sp in spans:
        _span_events(sp, events, 1, 1)
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def export_chrome_trace(path: str, spans: list[Span]) -> int:
    trace = to_chrome_trace(spans)
    with open(path, "w") as f:
        json.dump(trace, f)
    return len(trace["traceEvents"])


@contextmanager
def torch_profiler_session(trace_dir: Optional[str]):
    """Bracket a workload with a torch.profiler trace of the host and the
    CUDA device when `trace_dir` is set, written on exit as
    `<trace_dir>/torch_profile.trace.json`; a no-op otherwise. A profiler
    that cannot start (busy session, no CUPTI) degrades to the no-op
    instead of sinking the workload, as the JAX package's session does."""
    if not trace_dir:
        with nullcontext():
            yield
        return
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = None
    try:
        prof = profile(activities=acts)
        prof.__enter__()
    except Exception as e:    # pragma: no cover - backend specific
        logger.warning("torch profiler session unavailable: %s", e)
        prof = None
    try:
        yield
    finally:
        if prof is not None:
            try:
                prof.__exit__(None, None, None)
                os.makedirs(trace_dir, exist_ok=True)
                prof.export_chrome_trace(
                    os.path.join(trace_dir, "torch_profile.trace.json"))
            except Exception as e:  # pragma: no cover - backend specific
                logger.warning("torch profiler stop failed: %s", e)


def span_seconds(spans) -> dict:
    """Summed duration in seconds of every span in the trees `spans`, by
    span name (a host split of the retained drain history)."""
    out: dict = {}
    stack = list(spans)
    while stack:
        sp = stack.pop()
        out[sp.name] = out.get(sp.name, 0.0) + sp.duration_s
        stack.extend(sp.children)
    return out
