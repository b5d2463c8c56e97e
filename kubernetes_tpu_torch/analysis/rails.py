"""Runtime sanitizer rails (`SanitizerRails` feature gate).

The port's counterpart of kubernetes_tpu/analysis/rails.py, with the same
names and PyTorch inside. The static linter (torchsan.py) rejects the
dispatch-region hazards it can see; these rails catch the ones only a run
can: a synchronizing call or a blocking pageable copy inside the dispatch
region, a fresh kernel build in a warm process, a write into a carry that
a dispatched run still holds, a NaN in the score surface. All rails are
OFF by default (`SanitizerRails` is an Alpha gate): they exist for tests,
soaks and staging, not the hot path.

The rails:

- **sync guard** — `guard_dispatch(device)` runs the scheduler's
  `_dispatch_runs` under `torch.cuda.set_sync_debug_mode("error")`, so
  any call that makes the host wait for the card there (`.item()`,
  `.cpu()` of a device tensor, a blocking copy from pageable memory)
  raises; `declared(phase, device)` restores the default mode inside
  the declared host phases (the scheduler's `_phase` opens it for every
  host sub-phase). Both are no-ops on the CPU and with the gate off.
  `stage(tree, device)` is the declared way host values reach the card:
  numpy arrays and CPU tensors go through pinned memory without
  blocking, and `staged_bytes` counts them.
- **retrace budget** — `retrace_budget(n)` counts the fresh kernel
  builds and library loads of ops/kernels.py (`BUILDS`) inside the
  block and raises RetraceBudgetExceeded past `n`; a warm process fits
  budget 0.
- **held-carry check** — in place of the JAX package's donation
  poisoning (PyTorch donates nothing): no write may land in a carry that
  a dispatched run still holds for rewind or replay (`_RunRec.carry_in`:
  uniform runs and closed-form gangs). `hold(carry)` records the
  tensors' version counters and, on the card, a checksum of their bytes
  enqueued before the run's launches; `check_held` compares both at
  commit, rewind and gang replay. A kernel writes through a raw pointer
  and moves no version counter, so on the card only the checksum sees
  it.
- **NaN/inf guard** — `check_scores(...)` runs the score_probe kernel
  over a drain's first signature row and `assert_finite` raises
  SanitizerError on any non-finite value; `nan_guard()` scopes an
  `assert_finite` over the float outputs of every ops/program.py entry
  that reports through `observe` (score_probe, cluster_probe) — PyTorch
  has no `debug_nans`.

The instance is process-global (`GLOBAL`), like the sync debug mode it
drives; the most recently constructed Scheduler's gate wins.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch


class SanitizerError(RuntimeError):
    """A sanitizer rail tripped (NaN score, a write into a held carry)."""


class RetraceBudgetExceeded(SanitizerError):
    """More fresh kernel builds or library loads than the declared
    budget."""


# drain phases where host↔device copies and waits are part of the
# contract (the JAX package's list)
DECLARED_PHASES = ("host_snapshot", "host_tensorize", "host_group_seed",
                   "host_cache", "device_readback")


def _on_cuda(device) -> bool:
    if device is None:
        return torch.cuda.is_available()
    return torch.device(device).type == "cuda"


@contextlib.contextmanager
def _sync_mode(mode: str):
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(mode)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def _carry_leaves(carry) -> list:
    """(name, tensor) of every tensor of a Carry, its SigCache and its
    group counts."""
    out = []
    for name, value in zip(carry._fields, carry):
        if isinstance(value, torch.Tensor):
            out.append((name, value))
        elif value is not None and hasattr(value, "_fields"):
            out.extend((f"{name}.{f}", t) for f, t in zip(value._fields, value)
                       if isinstance(t, torch.Tensor))
    return out


def _checksum(tensors: list) -> torch.Tensor:
    """int64 scalar on the tensors' device: the bytes of every tensor, as
    int64 words, each times a distinct odd weight, summed with
    wraparound (exact and order-free, so any single changed word moves
    it). Enqueued without a host synchronization."""
    parts = [t.detach().contiguous().reshape(-1).view(torch.uint8)
             for t in tensors]
    flat = torch.cat(parts) if parts else torch.zeros((0,), dtype=torch.uint8)
    pad = (-flat.numel()) % 8
    if pad:
        flat = torch.cat([flat, flat.new_zeros((pad,))])
    words = flat.view(torch.int64)
    weights = torch.arange(1, 2 * words.numel(), 2, dtype=torch.int64,
                           device=words.device)
    return (words * weights).sum()


@dataclass
class HeldCarry:
    """A carry a dispatched run holds, with what it looked like then."""

    leaves: list          # (name, tensor)
    versions: list        # the tensors' _version counters at hold
    checksum: object      # device int64 scalar (CUDA carries), else None


class SanitizerRails:
    """Feature-gated runtime rails (see module docstring)."""

    def __init__(self, enabled: bool = False):
        self._enabled = bool(enabled)
        self.staged_bytes = 0        # bytes staged by stage()
        self.guarded_dispatches = 0  # dispatch regions run under the guard
        self.held_checks = 0         # held-carry comparisons made
        self._nan_scopes = 0

    # -- gating ---------------------------------------------------------------

    @property
    def active(self) -> bool:
        return self._enabled

    def enable(self, on: bool = True) -> None:
        self._enabled = bool(on)

    @contextlib.contextmanager
    def enabled(self, on: bool = True):
        """Scoped toggle (test helper)."""
        prev = self._enabled
        self._enabled = bool(on)
        try:
            yield self
        finally:
            self._enabled = prev

    # -- sync guard -----------------------------------------------------------

    def declared(self, phase: str, device=None):
        """Context for a phase where copies and waits are part of the
        contract: restores the default sync debug mode iff the phase is
        declared (an enclosing guard stays armed elsewhere)."""
        if (not self._enabled or phase not in DECLARED_PHASES
                or not _on_cuda(device)):
            return contextlib.nullcontext()
        return _sync_mode("default")

    def guard_dispatch(self, device=None):
        """Raise on every synchronizing call in the scope (the dispatch
        region must only enqueue work). Counts the scopes it armed."""
        if not self._enabled or not _on_cuda(device):
            return contextlib.nullcontext()
        self.guarded_dispatches += 1
        return _sync_mode("error")

    def stage(self, tree, device):
        """Move the numpy and CPU-tensor leaves of `tree` (tuples,
        NamedTuples and lists are walked) to `device` through pinned
        memory without blocking. Device tensors and non-array leaves pass
        through; the identity when the gate is off or `device` is not a
        CUDA device."""
        if not self._enabled or not _on_cuda(device):
            return tree
        return self._stage(tree, torch.device(device))

    def _stage(self, x, device):
        if isinstance(x, np.ndarray):
            t = torch.from_numpy(np.ascontiguousarray(x))
        elif isinstance(x, torch.Tensor):
            if x.device.type != "cpu":
                return x
            t = x
        elif isinstance(x, (tuple, list)):
            items = [self._stage(v, device) for v in x]
            if all(a is b for a, b in zip(items, x)):
                return x
            return (type(x)(*items) if hasattr(x, "_fields")
                    else type(x)(items))
        else:
            return x
        self.staged_bytes += t.numel() * t.element_size()
        return t.pin_memory().to(device, non_blocking=True)

    # -- retrace budget -------------------------------------------------------

    @contextlib.contextmanager
    def retrace_budget(self, budget: int = 0,
                       kernels: Optional[tuple] = None):
        """Assert at most `budget` fresh kernel builds or library loads
        happen inside the block (across `kernels`, default every source
        of ops/kernels.py)."""
        from ..ops import kernels as K

        def counts():
            return {k: v for k, v in K.BUILDS.items()
                    if kernels is None or k in kernels}

        before = counts()
        yield
        after = counts()
        deltas = {k: after[k] - before.get(k, 0)
                  for k in after if after[k] - before.get(k, 0) > 0}
        total = sum(deltas.values())
        if total > budget:
            raise RetraceBudgetExceeded(
                f"{total} fresh kernel builds or loads (budget {budget}): "
                + ", ".join(f"{k}+{v}" for k, v in sorted(deltas.items())))

    # -- held-carry check -----------------------------------------------------

    def hold(self, carry) -> Optional[HeldCarry]:
        """Record a carry a dispatched run keeps (before its launches):
        the version counters, and on the card a checksum enqueued on the
        current stream. None when the gate is off."""
        if not self._enabled or carry is None:
            return None
        leaves = _carry_leaves(carry)
        cuda = any(t.is_cuda for _, t in leaves)
        return HeldCarry(
            leaves=leaves, versions=[t._version for _, t in leaves],
            checksum=_checksum([t for _, t in leaves]) if cuda else None)

    def check_held(self, held: Optional[HeldCarry], where: str) -> None:
        """Raise SanitizerError if a held carry was written since
        `hold` (at commit, rewind and gang replay)."""
        if held is None:
            return
        self.held_checks += 1
        moved = [name for (name, t), v in zip(held.leaves, held.versions)
                 if t._version != v]
        if moved:
            raise SanitizerError(
                f"{where}: write into a held carry ({', '.join(moved)} "
                "changed in place since the run was dispatched)")
        if held.checksum is not None and not torch.equal(
                _checksum([t for _, t in held.leaves]), held.checksum):
            raise SanitizerError(
                f"{where}: write into a held carry (its bytes changed on "
                "the device since the run was dispatched)")

    # -- NaN / inf guard ------------------------------------------------------

    def assert_finite(self, name: str, tree) -> None:
        """Raise SanitizerError if any float tensor leaf holds NaN/inf."""
        if not self._enabled:
            return
        stack = [tree]
        while stack:
            leaf = stack.pop()
            if isinstance(leaf, (tuple, list)):
                stack.extend(leaf)
                continue
            if not (isinstance(leaf, torch.Tensor)
                    and leaf.dtype.is_floating_point):
                continue
            if not bool(torch.isfinite(leaf).all()):
                raise SanitizerError(
                    f"non-finite value in {name} "
                    f"(dtype {leaf.dtype}, shape {tuple(leaf.shape)})")

    def check_scores(self, cfg, na, carry, table, tidx) -> None:
        """Probe the score surface of signature row `tidx` against the
        current carry and raise on NaN/inf: one score_probe launch per
        drain."""
        if not self._enabled:
            return
        from ..ops.program import score_probe
        self.assert_finite("score surface",
                           score_probe(cfg, na, carry, table, int(tidx)))

    @contextlib.contextmanager
    def nan_guard(self):
        """Check the float outputs of every ops/program.py entry that
        reports through `observe` inside the scope (a synchronizing
        check per call; debug only)."""
        if not self._enabled:
            yield
            return
        self._nan_scopes += 1
        try:
            yield
        finally:
            self._nan_scopes -= 1

    def observe(self, name: str, outputs):
        """An entry's outputs, checked finite inside `nan_guard`."""
        if self._enabled and self._nan_scopes:
            self.assert_finite(name, outputs)
        return outputs


GLOBAL = SanitizerRails()
