"""Runtime tuning for the scheduling hot path: GC scheduled like work.

A copy of kubernetes_tpu/utils/runtime.py (that module imports no JAX;
the port keeps its own copy so that it never imports the JAX package).

The commit edge allocates ~4 small objects per scheduled pod (the
assume-copy triple + cache state). At drain rates in the tens of
thousands of pods per second that allocation rate drives CPython's
generational collector into scanning the scheduler's long-lived object
graph (cache, snapshot, queue, device staging) once per few hundred
drained pods — measured at 30-45% of the commit phase wall on
SchedulingBasic, and it lands wherever the allocation happens to
trip the threshold, inflating every phase's tail.

A scheduler under sustained load has a better collection point than
"whenever gen0 fills": the windows where the device is busy and the
host is idle. `scheduling_gc_pause()` therefore:

  * `gc.freeze()`s the baseline graph (everything allocated before the
    serving window is effectively immortal — nodes, snapshot, compiled
    plans), so young-gen scans stop re-walking it;
  * disables the automatic collector for the window;
  * leaves EXPLICIT collection to the caller: the streaming pipeline
    runs `opportunistic_collect()` from its commit worker whenever the
    drain pipeline goes idle, and every exit path re-enables the
    collector and runs a full collection.

This is the CPython analog of tuning GOGC on the reference scheduler —
a deployment-level knob, applied here at the two serving entry points
(the perf harness's measured window; the streaming pipeline is not
ported yet) rather
than process-wide.
"""

from __future__ import annotations

import contextlib
import gc
import time


@contextlib.contextmanager
def scheduling_gc_pause():
    """Suspend automatic collection for a scheduling window.

    Collects + freezes the pre-window graph on entry; on exit unfreezes,
    re-enables the collector and collects whatever the window minted.
    Re-entrant: nested uses leave the outermost owner in charge.
    """
    was_enabled = gc.isenabled()
    if was_enabled:
        gc.collect()
        gc.freeze()
        gc.disable()
    try:
        yield
    finally:
        if was_enabled:
            gc.enable()
            gc.unfreeze()
            gc.collect()


def opportunistic_collect(max_seconds: float = 0.01) -> bool:
    """One young-generation collection, intended for device-idle windows
    while automatic collection is paused. Returns True when it ran over
    `max_seconds` (callers can back off their idle-GC cadence)."""
    t0 = time.perf_counter()
    gc.collect(0)
    return (time.perf_counter() - t0) > max_seconds
