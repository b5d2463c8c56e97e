"""Per-signature kernel-surface cache with generation-diff retention.

Counterpart of kubernetes_tpu/compiler/surfaces.py. The wave and plan
programs hoist every carry-INDEPENDENT kernel — the static filter mask
(name/unschedulable/taints/selector), the TaintToleration and
preferred-affinity raw counts, the ImageLocality score — out of the
dispatch as per-signature [N] surfaces (ops/program.py wave_statics).
They are pure functions of (signature table row, static node columns), so
they stay valid across every placement: a commit only moves the aggregate
columns (used/npods/ports). The cache keys on `ClusterState.statics_gen`
(bumped only by full row writes, row invalidations and shape growth) and
the builder's `reset_count`, so surfaces are retained across the
steady-state drain cycle.

On the node-sharded mesh (`na` the node shards) each surface is a list
of per-shard [n] slices, computed by parallel/sharding.py
wave_statics_sharded (ImageLocality's counts psum'd over the shards), and
`stacked` returns one ([S, n], ...) tuple per shard — the layout
run_plan_sharded and run_gang_sharded consume.
"""

from __future__ import annotations

import torch


class SurfaceCache:
    """u (table row) → (static_mask, taint_raw, na_raw, s_img), each [N]."""

    def __init__(self, state, builder):
        self.state = state
        self.builder = builder
        self._rows: dict[int, tuple] = {}
        self._key = (-1, -1)      # (statics_gen, reset_count)
        self.hits = 0
        self.misses = 0

    def invalidate(self) -> None:
        self._rows.clear()
        self._key = (-1, -1)

    def get(self, na, table, rows: tuple) -> list:
        """Cached surfaces for signature table rows `rows` (ordered,
        duplicates allowed), computing only the missing ones. `na` /
        `table` must reflect the current statics generation."""
        from ..ops.kernels import MAX_WAVE_ROWS
        from ..ops.program import wave_statics
        from ..parallel.sharding import Mesh, Shards, wave_statics_sharded

        sharded = isinstance(na, Shards)
        key = (self.state.statics_gen, self.builder.reset_count)
        if self._key != key:
            # reset_count remaps every row id; statics_gen means some
            # node's static columns moved, which every [N] surface read
            self._rows.clear()
            self._key = key
        missing = [u for u in dict.fromkeys(rows) if u not in self._rows]
        self.hits += len(dict.fromkeys(rows)) - len(missing)
        self.misses += len(missing)
        if not missing:
            return [self._rows[u] for u in rows]
        t = self.builder.table
        a = self.state.arrays
        has_taints = a is None or bool(
            ((a.taint_key != 0) & a.valid[:, None]).any())
        # one call for every missing row (MAX_WAVE_ROWS a call): each row's
        # surfaces are its own, and a family skipped for rows that cannot
        # exercise it yields the identity, so the rows come out the same
        # whatever rows share a call
        for c0 in range(0, len(missing), MAX_WAVE_ROWS):
            chunk = missing[c0:c0 + MAX_WAVE_ROWS]
            # feature flags trim wave_statics to the kernels the rows can
            # actually exercise
            feats = (has_taints,
                     any(bool(t.ns_sel_val[u].any()) or bool(t.aff_has[u])
                         or bool(t.pref_weight[u].any()) for u in chunk),
                     any(bool(t.img_containers[u]) for u in chunk))
            if sharded:
                mesh = Mesh([s.cap.device for s in na])
                per = wave_statics_sharded(mesh, na, table, chunk, feats)
                for k, u in enumerate(chunk):
                    self._rows[u] = tuple([x[f][k] for x in per]
                                          for f in range(4))
                continue
            m_, tr, nr, si = wave_statics(na, table, chunk, feats)
            for k, u in enumerate(chunk):
                self._rows[u] = (m_[k], tr[k], nr[k], si[k])
        return [self._rows[u] for u in rows]

    def stacked(self, na, table, rows: tuple) -> tuple:
        """Surfaces for `rows` stacked into ([S, N], ...) — the layout
        run_plan consumes."""
        per_row = self.get(na, table, rows)
        if isinstance(per_row[0][0], list):
            return [tuple(torch.stack([r[f][d] for r in per_row])
                          for f in range(4))
                    for d in range(len(per_row[0][0]))]
        return tuple(torch.stack([r[f] for r in per_row]) for f in range(4))
