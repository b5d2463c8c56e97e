"""The drain compiler: "wave", "uniform" and "scan" spans.

Counterpart of kubernetes_tpu/compiler/plan.py without the plan-program
("wavescan") and gang tiers. A drain's pod mix becomes an ordered list of
spans, each mapped to the cheapest EXACT program the port has:

  ("wave", u, anti, merge)  same-signature group wave (run_wave)
  ("uniform",)              closed-form top-L same-signature run
                            (run_uniform)
  ("scan",)                 the per-pod scan (run_batch, with its group
                            branch when the drain needs groups)

Routing differences from the JAX package, all exact sequential greedy
(so the bind map is the same):
- long mixed lean spans: the JAX package upgrades them to its plan
  program; the port keeps them on the scan;
- group drains the JAX package maps to "wavescan" (several signatures,
  or a row `wave_same_mode` sends to the plan program: ScheduleAnyway,
  self-matching required affinity, self score terms) run the scan;
- scan-only group drains (below `WAVE_MIN_SPAN`, or with invalid rows):
  the JAX package tries its host greedy on a same-signature drain of
  16 pods or more; the port has no host scheduling path and runs the
  scan.

OpportunisticBatching and SpeculativeWavePlacement, the JAX package's
gates for the uniform and wave tiers, are fixed at their defaults (on).
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field

from .surfaces import SurfaceCache

# plan cache bound (structural keys are small; drains repeat heavily)
PLAN_CACHE_LIMIT = 256
# shortest same-signature group drain the wave program takes (the JAX
# package's Scheduler.wave_min_span)
WAVE_MIN_SPAN = 24


@dataclass
class DrainPlan:
    """A compiled drain: spans in queue order."""

    spans: list                  # [(i, j, kind)] — _dispatch_spans layout
    key: tuple = ()


@dataclass
class DrainCompiler:
    """Maps a drain's pod mix to a DrainPlan. Holds the per-signature
    SurfaceCache (hoisted wave surfaces) and the keyed plan cache."""

    builder: object
    state: object
    surfaces: SurfaceCache = field(init=False)
    _plans: OrderedDict = field(default_factory=OrderedDict)

    def __post_init__(self):
        self.surfaces = SurfaceCache(self.state, self.builder)

    def compile_drain(self, batch, n: int, *, groups_needed: bool = False,
                      strategy: str = "LeastAllocated",
                      prefer_taints: bool = False,
                      uniform_min: int = 16) -> DrainPlan:
        """Compile one drain's pod mix into a DrainPlan. Everything the
        spans depend on is in the cache key or immutable per signature
        row, so a cached plan is always valid."""
        key = (self.builder.reset_count, self.builder.table_used,
               groups_needed, strategy, prefer_taints, uniform_min, n,
               batch.sig[:n].tobytes(), batch.tidx[:n].tobytes(),
               bool(batch.valid[:n].all()))
        plan = self._plans.get(key)
        if plan is not None:
            self._plans.move_to_end(key)
            return plan
        if groups_needed:
            wave = self._classify_wave(batch, n)
            spans = [(0, n, wave if wave is not None else ("scan",))]
        elif strategy != "LeastAllocated" or prefer_taints:
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

    def _classify_wave(self, batch, n: int):
        """("wave", u, anti_term, merge) for a same-signature port-free
        group drain of at least WAVE_MIN_SPAN valid pods whose row the
        same-signature program covers; None otherwise (the scan)."""
        if n < WAVE_MIN_SPAN or not batch.valid[:n].all():
            return None
        sig = batch.sig[:n]
        if (sig == 0).any():
            return None
        uniq = list(dict.fromkeys(batch.tidx[:n].tolist()))
        if len(uniq) != 1:
            return None
        mode, anti = wave_same_mode(self.builder.groups, int(uniq[0]))
        if mode is None:
            return None
        return ("wave", int(uniq[0]), anti, mode == "merge")


def wave_same_mode(g, u: int):
    """(mode, anti_term) of GroupManager `g`'s row `u` for the
    same-signature program: "merge" runs the closed-form wave loop (with
    `anti_term` the row's single self-matching required-anti term, -1 =
    none), "serial" the exact in-dispatch scan only, None = the row's
    in-wave self-interactions (ScheduleAnyway counts, required affinity,
    score terms) are outside the state the program maintains."""
    if u >= len(g.rows):
        return None, -1
    if g.spr_s_active[u].any():
        return None, -1
    if g.m_ipa_a[u, u] and g.ipa_ra_active[u].any():
        return None, -1
    if g.w_stc[u, u].any() or g.w_stp[u, u].any():
        return None, -1
    terms = [t for t in range(g.m_ipa_aa.shape[2])
             if g.m_ipa_aa[u, u, t] or g.m_ipa_exist[u, u, t]]
    if len(terms) > 1:
        return "serial", -1
    return "merge", (terms[0] if terms else -1)
