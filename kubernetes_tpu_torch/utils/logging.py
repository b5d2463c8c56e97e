"""klog-style leveled, structured logging.

Mirrors the reference's klog/v2 conventions (contextual key/value logging;
verbosity levels V(2) production, V(4/5) debug, V(10) per-score dumps —
pkg/scheduler/schedule_one.go:830-838) on top of the stdlib logging module:

    from kubernetes_tpu_torch.utils.logging import klog
    klog.v(2).info("Scheduled pod", pod=uid, node=name)
    klog.error("bind failed", err=e, pod=uid)

`set_verbosity(n)` enables V(m) for m <= n (default 2, like a production
kube-scheduler). V-levels map onto stdlib levels beneath INFO so standard
handlers/formatters keep working; key/values render as k=v suffixes the way
klog's structured output does.

`log_context(drain=N)` scopes ambient key/values onto every line emitted
inside it (klog's WithValues / logr context analog): the scheduler tags
dispatch and commit blocks with the drain id, so one grep of `drain=17`
correlates log lines with the matching span tree, FlightRecorder entry
and Scheduled/FailedScheduling events.
"""

from __future__ import annotations

import logging
import os
from contextlib import contextmanager

_logger = logging.getLogger("kubernetes_tpu_torch")
if not _logger.handlers:  # library default: stderr handler, not propagated
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter(
        "%(levelname).1s%(asctime)s.%(msecs)03d %(name)s] %(message)s",
        datefmt="%H:%M:%S"))
    _logger.addHandler(_h)
    _logger.propagate = False

_verbosity = int(os.environ.get("KTPU_VERBOSITY", "2"))


def set_verbosity(v: int) -> None:
    global _verbosity
    _verbosity = v


def verbosity() -> int:
    return _verbosity


# ambient key/values appended to every line (log_context); a plain dict —
# the host loop is single-threaded and the profiler/server threads only
# ever emit with an empty context of their own
_context: dict = {}


@contextmanager
def log_context(**kv):
    """Scope ambient key/values onto every klog line emitted inside."""
    saved = {k: _context.get(k, _MISSING) for k in kv}
    _context.update(kv)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is _MISSING:
                _context.pop(k, None)
            else:
                _context[k] = v


_MISSING = object()


def _fmt(msg: str, kv: dict) -> str:
    if _context:
        kv = {**kv, **{k: v for k, v in _context.items() if k not in kv}}
    if not kv:
        return msg
    parts = " ".join(f"{k}={v!r}" if isinstance(v, str) else f"{k}={v}"
                     for k, v in kv.items())
    return f"{msg} {parts}"


class _Verbose:
    """klog.Verbose: a level-gated handle; `enabled` lets callers skip
    expensive argument construction (if klog.v(5).enabled: ...)."""

    __slots__ = ("enabled",)

    def __init__(self, enabled: bool):
        self.enabled = enabled

    def info(self, msg: str, **kv) -> None:
        if self.enabled:
            _logger.info(_fmt(msg, kv))


class _Klog:
    def v(self, level: int) -> _Verbose:
        return _Verbose(level <= _verbosity)

    def info(self, msg: str, **kv) -> None:
        _logger.info(_fmt(msg, kv))

    def warning(self, msg: str, **kv) -> None:
        _logger.warning(_fmt(msg, kv))

    def error(self, msg: str, **kv) -> None:
        _logger.error(_fmt(msg, kv))

    def exception(self, msg: str, **kv) -> None:
        """error + traceback of the active exception (klog.ErrorS with an
        err and stack)."""
        _logger.exception(_fmt(msg, kv))


klog = _Klog()
