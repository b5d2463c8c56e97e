"""run_wave's edge inputs (WAVE_EDGE_CASES): the node-axis partitions of
the port's CUDA design (csrc/run_wave.cu: a cluster of C = 16 CTAs, a
contiguous range of ⌈N / C⌉ rows each, radix selections of the top-K and
top-Lw keys, the spread replay in the leader CTA) and the wave's own
corners.

Shared by tests/test_torch_wave_edges.py (the port's plain version
against the JAX package on the CPU) and tests/test_torch_cuda.py (the
kernel against the plain version on the card). This module imports neither
package: `stage` builds a case through the state layer it is handed (the
JAX package's or the port's, which make the same arrays), seeded with
numpy, and edits the numpy arrays the same way for both.

The cases:

- ties_at_cta_splits_and_kth (N = 256, 16 rows a CTA): both rows of every
  CTA boundary boosted alike, so equal masked scores straddle each split,
  and K = 24 of the 30 boosted rows, so the K-th key falls among ties;
- lw_cut_inside_node_entries: one node's entries outscore the rest for
  several matrix columns, and Lw = 12 cuts the merge inside its J = 8
  entries;
- anti_keyless_nodes: a self-matching zone anti term (anti_term >= 0,
  jcap = 1 at J = 4) with a third of the nodes missing the zone label;
- spread_levels_reach_m_cap: one zone, so every merged entry raises the
  spread minimum by a level and a wave reaches M_CAP = 32 levels;
- capacity_exhausted_serial_tail: more pods than capacity, so the merge
  tier stops and the serial tier settles the failing tail at once;
- norm_live_merge_off: PreferNoSchedule taints keep the normalization
  live, the merge tier off, every pod a serial step;
- ts_full_width, aa_full_width (the card only): TopologySpreading's first
  drain (5,000 nodes padded to 8,192, B = 4,096, K = Lw = 512, J = 8) and
  SchedulingPodAntiAffinity's (B = 2,048, K = Lw = 1,024, J = 1).
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np

ZONE = "topology.kubernetes.io/zone"
HOSTNAME = "kubernetes.io/hostname"
# both rows of every boundary of a 16-CTA split of 256 rows
SPLIT_ROWS = [b + o for b in range(16, 256, 16) for o in (-1, 0)]


def _nodes(W, n, zones, cpu=16, pods=40, keyless=(), prefer=()):
    out = []
    for i in range(n):
        w = W.make_node(f"n{i}").capacity({"cpu": cpu, "memory": "64Gi",
                                           "pods": pods})
        if i not in keyless:
            w = w.zone(f"z{i % zones}")
        w = w.label(HOSTNAME, f"n{i}")
        if i in prefer:
            w = w.taint("dedic", "x", effect="PreferNoSchedule")
        out.append(w.obj())
    return out


def _harness_nodes(W, n, zones):
    """perf/harness.py _make_nodes: 32 cpu / 64 Gi / 110 pods."""
    return [W.make_node(f"node-{i}").capacity(
        {"cpu": 32, "memory": "64Gi", "pods": 110}).zone(
        f"zone-{i % zones}").label(HOSTNAME, f"node-{i}").obj()
        for i in range(n)]


def _spread(W, n, skew, cpu="1"):
    return [W.make_pod(f"s{i}").req({"cpu": cpu, "memory": "1Gi"})
            .label("app", "s").spread_constraint(skew, ZONE, "DoNotSchedule",
                                                 {"app": "s"}).obj()
            for i in range(n)]


def _anti(W, n, cpu="1"):
    return [W.make_pod(f"a{i}").req({"cpu": cpu, "memory": "1Gi"})
            .label("anti", "y").pod_affinity(ZONE, {"anti": "y"}, anti=True)
            .obj() for i in range(n)]


def _init(W, n):
    """The harness's init pods where its uniform run puts them: one per
    node, lowest index first."""
    return [W.make_pod(f"init-{i}").req({"cpu": "900m", "memory": "1Gi"})
            .node(f"node-{i}").obj() for i in range(n)]


def _harness_pods(W, n, kind):
    w = [W.make_pod(f"g{i}").req({"cpu": "900m", "memory": "1Gi"})
         for i in range(n)]
    if kind == "spread":
        return [p.label("app", "spread").spread_constraint(
            5, ZONE, "DoNotSchedule", {"app": "spread"}).obj() for p in w]
    return [p.label("anti", "yes").pod_affinity(
        ZONE, {"anti": "yes"}, anti=True).obj() for p in w]


WAVE_EDGE_CASES = {
    # name: nodes(W), bound(W), pods(W), K, J, Lw, B, merge_on, cap boosts
    "ties_at_cta_splits_and_kth": dict(
        nodes=lambda W: _nodes(W, 256, 4), pods=lambda W: _spread(W, 48, 3),
        K=24, J=2, Lw=32, B=64, boost={r: 4 for r in SPLIT_ROWS}),
    "lw_cut_inside_node_entries": dict(
        nodes=lambda W: _nodes(W, 32, 4), pods=lambda W: _spread(W, 40, 8),
        K=8, J=8, Lw=12, B=64, boost={0: 8, 1: 3}),
    "anti_keyless_nodes": dict(
        nodes=lambda W: _nodes(W, 24, 8, keyless=range(16, 24)),
        pods=lambda W: _anti(W, 20), K=16, J=4, Lw=16, B=32),
    "spread_levels_reach_m_cap": dict(
        nodes=lambda W: _nodes(W, 8, 1, cpu=64, pods=110),
        pods=lambda W: _spread(W, 80, 2, cpu="250m"), K=8, J=16, Lw=64,
        B=128),
    "capacity_exhausted_serial_tail": dict(
        nodes=lambda W: _nodes(W, 6, 3, cpu=8),
        pods=lambda W: _spread(W, 40, 2, cpu="3"), K=6, J=8, Lw=40, B=64),
    "norm_live_merge_off": dict(
        nodes=lambda W: _nodes(W, 32, 4, prefer=range(0, 32, 2)),
        pods=lambda W: _spread(W, 24, 2), K=24, J=8, Lw=24, B=32,
        merge_on=False),
    "ts_full_width": dict(
        nodes=lambda W: _harness_nodes(W, 5000, 16),
        bound=lambda W: _init(W, 1000),
        pods=lambda W: _harness_pods(W, 4096, "spread"), K=512, J=8,
        Lw=512, B=4096, card_only=True),
    "aa_full_width": dict(
        nodes=lambda W: _harness_nodes(W, 5000, 10000),
        bound=lambda W: _init(W, 500),
        pods=lambda W: _harness_pods(W, 2000, "anti"), K=1024, J=1,
        Lw=1024, B=2048, card_only=True),
}

CPU_CASES = sorted(k for k, v in WAVE_EDGE_CASES.items()
                   if not v.get("card_only"))


def anti_term_of(groups, u: int) -> tuple:
    """(anti_term, merge_ok) of row u: its one self-matching anti term,
    -1 when it has none or several (several send the row to the serial
    tier)."""
    terms = [t for t in range(groups.m_ipa_aa.shape[2])
             if groups.m_ipa_aa[u, u, t] or groups.m_ipa_exist[u, u, t]]
    return (terms[0] if len(terms) == 1 else -1), len(terms) <= 1


def stage(case: str, pkg) -> SimpleNamespace:
    """One case's numpy inputs through `pkg`'s state layer (`pkg` holds
    the package's Cache, Snapshot, ClusterState, BatchBuilder, its testing
    wrappers as W and its static_norm_ok). Returns arrays (NodeArrays),
    table, gd, gc, fam, the wave row u, anti_term, merge_on, norm_live,
    valid [B] and the wave shape K, J, Lw."""
    spec = WAVE_EDGE_CASES[case]
    W = pkg.W
    cache = pkg.Cache()
    for nd in spec["nodes"](W):
        cache.add_node(nd)
    for p in spec.get("bound", lambda W: [])(W):
        cache.add_pod(p)
    snap = pkg.Snapshot()
    cache.update_snapshot(snap)
    state = pkg.ClusterState()
    state.apply_snapshot(snap, full=True)
    builder = pkg.BatchBuilder(state)
    pods = spec["pods"](W)
    n = len(pods)
    batch = builder.build(pods)
    assert not batch.host_fallback[:n].any()
    u = int(batch.tidx[0])
    assert (batch.tidx[:n] == u).all()
    a = state.ensure_arrays()
    if spec.get("boost"):
        cap = a.cap.copy()
        for row, by in spec["boost"].items():
            cap[row] *= by
        a = a._replace(cap=cap)
    anti, merge_ok = anti_term_of(builder.groups, u)
    gd, gc = builder.groups.build_dev(snap)
    valid = np.zeros((spec["B"],), bool)
    valid[:n] = True
    assert spec["Lw"] <= min(spec["B"], spec["K"] * spec["J"])
    assert spec["K"] <= a.cap.shape[0]
    return SimpleNamespace(
        arrays=a, table=builder.table, gd=gd, gc=gc,
        fam=tuple(builder.groups.families(snap)), u=u, anti=anti,
        merge_on=spec.get("merge_on", True) and merge_ok,
        norm_live=not pkg.static_norm_ok(a, builder.table.pref_weight[u]),
        valid=valid, n=n, K=spec["K"], J=spec["J"], Lw=spec["Lw"])


def check_case(case: str, out, stats) -> None:
    """What each case must show in its assignments `out` (the n real pods)
    and stats (waves, conflicts, first prefix, serial steps)."""
    waves, confs, first, serial = (int(x) for x in stats)
    out = np.asarray(out)
    if case == "ties_at_cta_splits_and_kth":
        # the first wave's candidates are the 24 lowest boosted rows
        assert waves >= 1 and set(out[:first].tolist()) <= set(SPLIT_ROWS)
    elif case == "anti_keyless_nodes":
        assert waves >= 1 and (out >= 0).all()
    elif case == "spread_levels_reach_m_cap":
        # the climb reaches M_CAP = 32 inside a wave and cuts it there
        assert waves >= 2 and 0 < first <= 33
    elif case == "capacity_exhausted_serial_tail":
        assert (out[:12] >= 0).all() and (out[12:] == -1).all()
        assert serial > 0
    elif case == "norm_live_merge_off":
        assert waves == 0 and first == -1 and serial == len(out)
