"""The drain compiler: "gang", "wave", "wavescan", "uniform" and "scan"
spans.

Counterpart of kubernetes_tpu/compiler/plan.py. A whole-gang drain is one ("gang", needed) span (ops/gang.py run_gang;
its tier, closed form or scan, is chosen at dispatch). Any other drain's
pod mix becomes an ordered list of spans, each mapped to the cheapest
EXACT program the port has:

  ("wave", u, anti, merge)    same-signature group wave (run_wave)
  ("wavescan", rows, ports)   the plan program (ops/program.py run_plan):
                              any mix of group / group-free / host-port
                              rows, the signature set padded to the pow2
                              lattice {2, 4, ..., PLAN_MAX_SIGS}
  ("uniform",)                closed-form top-L same-signature run
                              (run_uniform)
  ("scan",)                   the per-pod scan (run_batch, with its group
                              branch when the drain needs groups)

Routing differences from the JAX package, all exact sequential greedy
(so the bind map is the same):
- scan-only group drains (below `WAVE_MIN_SPAN`, or with invalid rows):
  the JAX package tries its host greedy on a same-signature drain of
  16 pods or more; the port has no host scheduling path and runs the
  scan;
- the wave program's K·J narrowing: a same-signature wave wider than the
  node axis (K·J < Lw) raises in the JAX package's `lax.top_k`, which
  degrades the drain to its host path; the port narrows the wave
  (Scheduler._wave_dispatch).

On the node-sharded mesh (`mesh=True`) the same-signature merge wave,
single-device only, is never emitted: such a group drain compiles to the
plan program ("wavescan", run_plan_sharded on the mesh), as in the JAX
package.

The wave and plan tiers take spans of `WAVE_MIN_SPAN` pods or more;
below it a group drain runs the scan in both packages.
OpportunisticBatching and SpeculativeWavePlacement, the JAX package's
gates for the uniform and wave tiers, are fixed at their defaults (on).
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field

from ..ops.program import PLAN_MAX_SIGS
from ..state.batch import PodBatch
from .surfaces import SurfaceCache

# plan cache bound (structural keys are small; drains repeat heavily)
PLAN_CACHE_LIMIT = 256
# shortest span the wave and plan programs take (the JAX package's
# Scheduler.wave_min_span)
WAVE_MIN_SPAN = 24


@dataclass
class DrainPlan:
    """A compiled drain: spans in queue order."""

    spans: list                  # [(i, j, kind)] — _dispatch_spans layout
    key: tuple = ()


@dataclass
class DrainCompiler:
    """Maps a drain's pod mix to a DrainPlan. Holds the per-signature
    SurfaceCache (hoisted wave and plan surfaces) and the keyed plan
    cache."""

    builder: object
    state: object
    surfaces: SurfaceCache = field(init=False)
    _plans: OrderedDict = field(default_factory=OrderedDict)

    def __post_init__(self):
        self.surfaces = SurfaceCache(self.state, self.builder)

    def compile_drain(self, batch: PodBatch, n: int, *, groups_needed: bool = False,
                      gang_needed=None, overlay: bool = False,
                      nominated: bool = False, mesh: bool = False,
                      strategy: str = "LeastAllocated",
                      prefer_taints: bool = False,
                      uniform_min: int = 16) -> DrainPlan:
        """Compile one drain's pod mix into a DrainPlan. Everything the
        spans depend on is in the cache key or immutable per signature
        row, so a cached plan is always valid. Under a nominated-pod
        `overlay` no wave or plan program runs: a drain holding a
        `nominated` pod is one scan span (the per-pod self-exclusion is
        outside the closed form), an overlay-only drain keeps its
        uniform / scan runs. A whole-gang drain (`gang_needed`, the
        gang's remaining quorum) is a single span by construction.
        `mesh`: the drain runs on the node-sharded mesh."""
        if gang_needed is not None:
            return DrainPlan(spans=[(0, n, ("gang", int(gang_needed)))])
        key = (self.builder.reset_count, self.builder.table_used,
               groups_needed, overlay, nominated, mesh, strategy,
               prefer_taints, uniform_min, n, batch.sig[:n].tobytes(),
               batch.tidx[:n].tobytes(), bool(batch.valid[:n].all()))
        plan = self._plans.get(key)
        if plan is not None:
            self._plans.move_to_end(key)
            return plan
        spans = None
        if groups_needed and not overlay and not nominated:
            wave = self._classify_wave(batch, n, mesh)
            if wave is not None:
                spans = [(0, n, wave)]
        if spans is None:
            # the lean tiers; a group drain no wave program covers is one
            # scan span
            if (nominated or groups_needed or strategy != "LeastAllocated"
                    or prefer_taints):
                spans = [(0, n, ("scan",))]
            else:
                spans = [(i, j, ("uniform",) if uniform else ("scan",))
                         for (i, j, uniform)
                         in self._classify_runs(batch, n, uniform_min)]
            if not groups_needed and not overlay and not nominated:
                # non-interacting signatures in one plan span: the
                # alternating mixed drain that thrashes the scan's
                # one-slot signature cache
                spans = [self._lean_span(batch, s) for s in spans]
        plan = DrainPlan(spans=spans, key=key)
        self._plans[key] = plan
        if len(self._plans) > PLAN_CACHE_LIMIT:
            self._plans.popitem(last=False)
        return plan

    def _classify_runs(self, batch: PodBatch, n: int, uniform_min: int):
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

    def _classify_wave(self, batch: PodBatch, n: int, mesh: bool = False):
        """Whole-drain program for a group drain, or None (the scan):
        ("wave", u, anti_term, merge) for a same-signature port-free drain
        whose row the same-signature program covers; otherwise
        ("wavescan", rows, has_ports) for up to PLAN_MAX_SIGS distinct
        signatures, host-port rows included. Both need at least
        WAVE_MIN_SPAN pods, all valid. On the mesh the same-signature
        wave is never chosen."""
        if n < WAVE_MIN_SPAN or not batch.valid[:n].all():
            return None
        has_ports = bool((batch.sig[:n] == 0).any())
        uniq = list(dict.fromkeys(batch.tidx[:n].tolist()))
        if len(uniq) == 1 and not has_ports and not mesh:
            mode, anti = wave_same_mode(self.builder.groups, int(uniq[0]))
            if mode is not None:
                return ("wave", int(uniq[0]), anti, mode == "merge")
        if len(uniq) <= PLAN_MAX_SIGS:
            return ("wavescan", tuple(int(u) for u in uniq), has_ports)
        return None

    def _lean_span(self, batch: PodBatch, span):
        """Upgrade an eligible scan span of a group-free drain to the lean
        plan program; anything ineligible keeps its kind."""
        i, j, kind = span
        if kind[0] != "scan" or j - i < WAVE_MIN_SPAN:
            return span
        if not batch.valid[i:j].all():
            return span
        has_ports = bool((batch.sig[i:j] == 0).any())
        uniq = list(dict.fromkeys(int(t) for t in batch.tidx[i:j]))
        if len(uniq) > PLAN_MAX_SIGS:
            return span
        return (i, j, ("wavescan", tuple(uniq), has_ports))


def wave_same_mode(g, u: int):
    """(mode, anti_term) of GroupManager `g`'s row `u` for the
    same-signature program: "merge" runs the closed-form wave loop (with
    `anti_term` the row's single self-matching required-anti term, -1 =
    none), "serial" the exact in-dispatch scan only, None = the row needs
    the plan program (its in-wave self-interactions — ScheduleAnyway
    counts, required affinity, score terms — are outside the
    same-signature state the wave program maintains)."""
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
