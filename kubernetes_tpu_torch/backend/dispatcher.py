"""Async API dispatcher: deferred, deduped API calls off the hot path.

Mirrors pkg/scheduler/backend/api_dispatcher/:
- typed calls with Relevance ordering (framework/api_calls/api_calls.go:33:
  a newer call for the same object either replaces or is suppressed by the
  pending one)
- the scheduler enqueues and keeps going; `flush()` executes the queue
  (the reference uses worker goroutines; at 50k binds/s the batching —
  not the threading — is what decouples device throughput from API latency,
  so the single-threaded deferred model keeps the semantics and the perf
  property while staying GIL-friendly)
- api_cache facade semantics: queue/cache observe call effects immediately
  because the scheduler assumes pods before enqueueing the bind.

Error handling mirrors client-go: retriable errors (ServerTimeout /
TooManyRequests / ServiceUnavailable — the call did not take effect) retry
with exponential backoff + jitter under a per-call attempt budget; terminal
errors (Conflict, NotFound, anything untyped) route to the scheduler's
forget/requeue path exactly like bindingCycle error handling
(schedule_one.go:361-393). DELETE (preemption victim) calls retry too, so
a transient hiccup cannot half-commit a preemptor wave.

`flush()` executes pending DELETEs BEFORE the bulk binds: a preemptor
wave's victims leave the store before their preemptors bind, matching the
reference's relevance ordering end to end (not just within the queue).
"""

from __future__ import annotations

import enum
import random
import threading
import time as _time
from dataclasses import dataclass, field
from typing import Callable, Optional

from ..api.types import Pod
from .apiserver import LEASE_NAME, Conflict, FencedWrite, is_retriable


def _fence_pairs(token) -> tuple:
    """Normalize a fence token (int / (lease, gen) pair / tuple of pairs —
    the three forms APIServer.check_fence accepts) to a tuple of pairs."""
    if isinstance(token, int):
        return ((LEASE_NAME, token),)
    if token and isinstance(token[0], str):
        return (token,)
    return tuple(token)


def _fence_min(a, b):
    """Merge two fence tokens conservatively: per lease, keep the OLDEST
    generation seen (generations are monotonic, so the oldest token is the
    strictest — a batch spanning a depose boundary fails entirely). Two
    ints stay an int (the single-lease legacy form); any other mix
    normalizes to a sorted tuple of (lease, generation) pairs."""
    if a is None:
        return b
    if b is None:
        return a
    if isinstance(a, int) and isinstance(b, int):
        return min(a, b)
    merged: dict = {}
    for name, gen in _fence_pairs(a) + _fence_pairs(b):
        if name not in merged or gen < merged[name]:
            merged[name] = gen
    return tuple(sorted(merged.items()))


def backoff_delay(attempt: int, base: float, cap: float,
                  rng: random.Random) -> float:
    """Exponential backoff with equal jitter (client-go wait.Backoff
    shape): base·2^attempt capped, then scaled into [0.5, 1.0). Shared by
    the dispatcher's retry loop and the leader elector's acquire retry
    (ha/lease.py) so every client-side retry in the system jitters the
    same way."""
    d = min(base * (2.0 ** attempt), cap)
    return d * (0.5 + 0.5 * rng.random())


class CallType(str, enum.Enum):
    BIND = "pod_binding"
    STATUS_PATCH = "pod_status_patch"
    DELETE = "pod_delete"


# relevance ordering (api_calls.go Relevances): a BIND replaces a pending
# STATUS_PATCH for the same pod; a STATUS_PATCH never replaces a BIND; a
# DELETE (preemption victim) supersedes everything for that pod.
_RELEVANCE = {CallType.STATUS_PATCH: 1, CallType.BIND: 2, CallType.DELETE: 3}


@dataclass
class APICall:
    call_type: CallType
    pod: Pod
    node_name: str = ""
    condition: Optional[dict] = None
    # None = leave unchanged; "" = clear (preemption demotion)
    nominated_node_name: Optional[str] = None
    # fencing token stamped at ENQUEUE time: a call enqueued before the
    # leader was deposed keeps its stale token, so the API server rejects
    # it even if the flush happens much later. Any check_fence form: int
    # (single-lease legacy) or (lease, generation) pair(s).
    fence_token: Optional[object] = None


@dataclass
class APIDispatcher:
    client: object  # APIServer-shaped
    on_bind_error: Optional[Callable[[Pod, str, Exception], None]] = None
    # retry policy (config knobs apiRetryMaxAttempts/apiRetryBaseSeconds):
    # attempt budget INCLUDES the first try; base doubles per retry with
    # equal jitter, capped at retry_max_delay_seconds
    retry_max_attempts: int = 5
    retry_base_seconds: float = 0.02
    retry_max_delay_seconds: float = 1.0
    sleep: Callable[[float], None] = _time.sleep
    _rng: random.Random = field(default_factory=lambda: random.Random(0))
    # the scheduler enqueues and flushes single-threaded, but __len__ is
    # read by the metrics HTTP thread (dispatcher_inflight callback
    # gauge): the RLock covers the pending structures; execution happens
    # on snapshots taken under it (so retry backoff sleeps never block a
    # scrape), and reentrant on_bind_error callbacks stay safe
    _lock: threading.RLock = field(default_factory=threading.RLock)
    _queue: dict[str, APICall] = field(default_factory=dict)   # guarded_by: _lock
    # bulk fast path: (bound pod, the original object it was derived from)
    _binds: list[tuple[Pod, Pod]] = field(default_factory=list)  # guarded_by: _lock
    # fencing-token provider (ha/fencing.py wires the elector's current
    # lease generation): consulted at enqueue time, None = unfenced
    fence: Optional[Callable[[], Optional[int]]] = None
    # per-pod fencing provider (sharded control plane): one instance may
    # hold MULTIPLE shard leases, so the right token depends on which pod
    # is being written. Takes precedence over `fence` when set; returns
    # any check_fence token form (usually a (lease, generation) pair).
    fence_for: Optional[Callable[[Pod], Optional[object]]] = None
    # the OLDEST token per lease among bulk binds enqueued since the last
    # flush: generations are monotonic, so fencing the whole bulk batch at
    # the oldest token is conservative — a batch spanning a depose
    # boundary fails entirely and every member requeues via on_bind_error
    _bind_fence: Optional[object] = None   # guarded_by: _lock
    executed: int = 0
    errors: int = 0
    retries: int = 0
    fenced: int = 0

    def _stamp(self, call: APICall) -> APICall:
        if call.fence_token is None:
            if self.fence_for is not None:
                call.fence_token = self.fence_for(call.pod)
            elif self.fence is not None:
                call.fence_token = self.fence()
        return call

    def add(self, call: APICall) -> None:
        self._stamp(call)
        uid = call.pod.uid
        with self._lock:
            pending = self._queue.get(uid)
            if pending is not None:
                if _RELEVANCE[call.call_type] < _RELEVANCE[pending.call_type]:
                    # less relevant than what's queued: suppress. A BIND
                    # suppressed by a pending DELETE carries an assumed pod —
                    # silently dropping it would leak the assume; route it
                    # through the forget/requeue path like a failed bind.
                    if (call.call_type == CallType.BIND
                            and pending.call_type == CallType.DELETE
                            and self.on_bind_error is not None):
                        self.on_bind_error(call.pod, call.node_name, Conflict(
                            f"bind of {uid} superseded by pending delete"))
                    return
                if (call.call_type == CallType.STATUS_PATCH
                        and pending.call_type == CallType.STATUS_PATCH):
                    # merge, don't replace (reference call_queue.go Merge):
                    # the newer condition wins, but an unset
                    # nominated_node_name must not drop the pending call's
                    if call.nominated_node_name is None:
                        call.nominated_node_name = pending.nominated_node_name
                    if call.condition is None:
                        call.condition = pending.condition
            self._queue[uid] = call

    def add_binds(self, pairs: list) -> None:
        """Bulk enqueue of bind calls: (assumed pod with node set, the
        original object it was derived from). The hot path of the batch
        commit: one list extend instead of B dict transactions. The
        original lets bind_all prove by identity that no interleaved
        update landed, and reuse the assumed copy as the stored object."""
        if self.fence_for is not None:
            token = None
            for pair in pairs:
                token = _fence_min(token, self.fence_for(pair[0]))
        else:
            token = self.fence() if self.fence is not None else None
        with self._lock:
            if token is not None:
                self._bind_fence = _fence_min(self._bind_fence, token)
            if self._queue:
                # a bind supersedes a pending patch — but never a DELETE,
                # which outranks it (same relevance ordering as add()). The
                # superseded pod was already assumed: forget/requeue it
                # instead of leaking the assume.
                for pair in pairs:
                    pending = self._queue.get(pair[0].uid)
                    if pending is not None:
                        if pending.call_type == CallType.DELETE:
                            if self.on_bind_error is not None:
                                self.on_bind_error(
                                    pair[0], pair[0].spec.node_name, Conflict(
                                        f"bind of {pair[0].uid} superseded by "
                                        "pending delete"))
                            continue
                        del self._queue[pair[0].uid]
                    self._binds.append(pair)
                return
            self._binds.extend(pairs)

    # -- retry machinery ------------------------------------------------------

    def _backoff(self, attempt: int) -> float:
        """Exponential backoff with equal jitter (client-go wait.Backoff
        shape): base·2^attempt capped, then scaled into [0.5, 1.0)."""
        return backoff_delay(attempt, self.retry_base_seconds,
                             self.retry_max_delay_seconds, self._rng)

    def _count_fenced(self, e: Exception) -> None:
        if isinstance(e, FencedWrite):
            self.fenced += 1

    def _count_retry(self, call_type: CallType) -> None:
        self.retries += 1

    def _execute_with_retry(self, call_type: CallType,
                            fn: Callable[[], None]) -> Optional[Exception]:
        """Run one API call under the retry policy; returns the terminal
        exception (retriable exhausted or non-retriable) or None."""
        attempt = 0
        while True:
            try:
                fn()
                return None
            except Exception as e:
                if not is_retriable(e) or attempt + 1 >= self.retry_max_attempts:
                    return e
                self._count_retry(call_type)
                self.sleep(self._backoff(attempt))
                attempt += 1

    def _execute_binds(self, binds: list,
                       fence_token: Optional[int] = None
                       ) -> list[tuple[Pod, Exception]]:
        """Bulk bind with per-pod retry of the retriable failures; returns
        the terminal failures."""
        kw = {} if fence_token is None else {"fence_token": fence_token}
        terminal: list[tuple[Pod, Exception]] = []
        pending = binds
        attempt = 0
        while pending:
            if hasattr(self.client, "bind_all"):
                failures = self.client.bind_all(pending, **kw)
            else:
                failures = []
                for p, _orig in pending:
                    try:
                        self.client.bind(p, p.spec.node_name, **kw)
                    except Exception as e:
                        failures.append((p, e))
            if not failures:
                return terminal
            by_uid = {pair[0].uid: pair for pair in pending}
            retry = []
            for p, e in failures:
                if is_retriable(e) and attempt + 1 < self.retry_max_attempts:
                    self._count_retry(CallType.BIND)
                    retry.append(by_uid[p.uid])
                else:
                    terminal.append((p, e))
            if retry:
                self.sleep(self._backoff(attempt))
                attempt += 1
            pending = retry
        return terminal

    # -- flush ----------------------------------------------------------------

    def flush(self) -> int:
        """Execute all pending calls; returns count executed. Order:
        queued DELETEs (preemption victims) → bulk binds → everything
        else (single binds, status patches). Calls execute on snapshots
        taken under the lock — never while holding it (retry backoff
        sleeps must not block the metrics thread's __len__)."""
        n = 0
        with self._lock:
            deletes = [c for c in self._queue.values()
                       if c.call_type == CallType.DELETE]
            for c in deletes:
                del self._queue[c.pod.uid]
        if deletes:
            n += self._execute_calls(deletes)
        n += self._flush_bulk_binds()
        with self._lock:
            calls = list(self._queue.values())
            self._queue.clear()
        if calls:
            n += self._execute_calls(calls)
        return n

    def _flush_bulk_binds(self) -> int:
        with self._lock:
            binds = self._binds
            self._binds = []
            bind_fence = self._bind_fence
            self._bind_fence = None
        if not binds:
            return 0
        n_bulk = len(binds)
        failures = self._execute_binds(binds, fence_token=bind_fence)
        n_fail = len(failures)
        self.executed += n_bulk - n_fail
        self.errors += n_fail
        for pod, e in failures:
            self._count_fenced(e)
            if self.on_bind_error is not None:
                self.on_bind_error(pod, pod.spec.node_name, e)
        return n_bulk

    def _execute_calls(self, calls: list[APICall]) -> int:
        for call in calls:
            # fence kwarg only when stamped: stub clients in tests predate
            # the fence_token parameter, and None means unfenced anyway
            kw = ({} if call.fence_token is None
                  else {"fence_token": call.fence_token})
            if call.call_type == CallType.BIND:
                fn = lambda c=call: self.client.bind(c.pod, c.node_name, **kw)
            elif call.call_type == CallType.DELETE:
                fn = lambda c=call: self.client.delete_pod(c.pod.uid, **kw)
            else:
                fn = lambda c=call: self.client.patch_pod_status(
                    c.pod, c.condition or {}, c.nominated_node_name, **kw)
            err = self._execute_with_retry(call.call_type, fn)
            if err is None:
                self.executed += 1
            else:
                self._count_fenced(err)
                self.errors += 1
                if (call.call_type == CallType.BIND
                        and self.on_bind_error is not None):
                    self.on_bind_error(call.pod, call.node_name, err)
        return len(calls)

    def is_delete_pending(self, uid: str) -> bool:
        """A victim whose DELETE is queued but not flushed is the in-memory
        analog of a terminating pod (preemption.go:431 eligibility)."""
        with self._lock:
            pending = self._queue.get(uid)
        return pending is not None and pending.call_type == CallType.DELETE

    def __len__(self) -> int:
        with self._lock:
            return len(self._queue) + len(self._binds)
