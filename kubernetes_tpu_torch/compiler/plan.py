"""The drain compiler, lean subset: "uniform" and "scan" spans only.

Counterpart of kubernetes_tpu/compiler/plan.py without the group,
wave, plan-program and gang tiers. A drain's pod mix becomes an ordered
list of spans, each mapped to the cheapest EXACT program the port has:

  ("uniform",)   closed-form top-L same-signature run (run_uniform)
  ("scan",)      the per-pod scan (run_batch)

The JAX package upgrades long mixed lean spans to its plan program; the
port keeps them on the scan. Both are exact sequential greedy, so the
bind map is the same. OpportunisticBatching, the JAX package's gate for
the uniform tier, is always on here (its default).
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field

# plan cache bound (structural keys are small; drains repeat heavily)
PLAN_CACHE_LIMIT = 256


@dataclass
class DrainPlan:
    """A compiled drain: spans in queue order."""

    spans: list                  # [(i, j, kind)] — _dispatch_spans layout
    key: tuple = ()


@dataclass
class DrainCompiler:
    builder: object
    _plans: OrderedDict = field(default_factory=OrderedDict)

    def compile_drain(self, batch, n: int, *, strategy: str = "LeastAllocated",
                      prefer_taints: bool = False,
                      uniform_min: int = 16) -> DrainPlan:
        """Compile one drain's pod mix into a DrainPlan. Everything the
        spans depend on is in the cache key or immutable per signature
        row, so a cached plan is always valid."""
        key = (self.builder.reset_count, self.builder.table_used, strategy,
               prefer_taints, uniform_min, n,
               batch.sig[:n].tobytes(), batch.tidx[:n].tobytes())
        plan = self._plans.get(key)
        if plan is not None:
            self._plans.move_to_end(key)
            return plan
        if strategy != "LeastAllocated" or prefer_taints:
            spans = [(0, n, ("scan",))]
        else:
            spans = [(i, j, ("uniform",) if uniform else ("scan",))
                     for (i, j, uniform)
                     in self._classify_runs(batch, n, uniform_min)]
        plan = DrainPlan(spans=spans, key=key)
        self._plans[key] = plan
        if len(self._plans) > PLAN_CACHE_LIMIT:
            self._plans.popitem(last=False)
        return plan

    def _classify_runs(self, batch, n: int, uniform_min: int):
        """Split [0, n) into maximal same-signature runs; mark each
        uniform (closed-form eligible) or not; merge adjacent non-uniform
        stretches so they cost one dispatch instead of many."""
        sig, tidx = batch.sig, batch.tidx
        pref_w = self.builder.table.pref_weight
        runs: list[tuple[int, int, bool]] = []
        i = 0
        while i < n:
            j = i + 1
            while j < n and sig[j] == sig[i]:
                j += 1
            uniform = (sig[i] != 0 and j - i >= uniform_min
                       and not pref_w[tidx[i]].any())
            if runs and not uniform and not runs[-1][2]:
                runs[-1] = (runs[-1][0], j, False)
            else:
                runs.append((i, j, uniform))
            i = j
        return runs
