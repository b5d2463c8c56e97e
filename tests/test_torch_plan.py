"""run_plan (the plan program), SurfaceCache.stacked and the drain
compiler's spans: the port's plain versions ↔ the JAX package, exact
equality.

Each case builds one seeded cluster and pending batch with the JAX
package's state layer; its numpy arrays (NodeArrays, PodTable, GroupsDev,
GroupCarry) go through the JAX `run_plan` on the CPU and, converted,
through the port's plain `run_plan`. The span is laid out as the
scheduler lays it out (`Scheduler._wavescan_dispatch`): the distinct rows
in first-seen order padded to the pow2 lattice by repeating the last one,
each pod's slot its row's first slot, the pod axis padded to a pow2
bucket with invalid steps. Everything compared is integer or boolean, so
the tolerance is exact equality: the packed output (assignments, conflict
count, conflict-free prefix), every carry field, the ports carry and the
whole group carry, dtypes included."""

import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_parity import (lean_cluster, lean_pod,  # noqa: F401
                           private_jax_compiles)
from kubernetes_tpu.backend.cache import Cache, Snapshot
from kubernetes_tpu.compiler.plan import DrainCompiler as JCompiler
from kubernetes_tpu.compiler.surfaces import SurfaceCache as JSurfaces
from kubernetes_tpu.config.features import default_gate
from kubernetes_tpu.ops import groups as jg
from kubernetes_tpu.ops import program as jp
from kubernetes_tpu.state.batch import BatchBuilder, BatchDims
from kubernetes_tpu.state.tensorize import ClusterState, pow2_at_least
from kubernetes_tpu.testing.wrappers import make_node, make_pod
from kubernetes_tpu_torch.compiler.plan import DrainCompiler as TCompiler
from kubernetes_tpu_torch.compiler.surfaces import SurfaceCache as TSurfaces
from kubernetes_tpu_torch.ops import groups as tg
from kubernetes_tpu_torch.ops import program as tp
from kubernetes_tpu_torch.state import convert

ZONE = "topology.kubernetes.io/zone"
HOSTNAME = "kubernetes.io/hostname"

torch.set_num_threads(1)

NO_FAM = (False, False, False, False, False)


def _nodes(n, zones, cpu=16, prefer=False, pods=40):
    out = []
    for i in range(n):
        b = (make_node(f"n{i}").capacity({"cpu": cpu, "memory": "32Gi",
                                          "pods": pods})
             .zone(f"z{i % zones}").label(HOSTNAME, f"n{i}"))
        if prefer and i % 3 == 0:
            b = b.taint("dedic", "x", "PreferNoSchedule")
        out.append(b.obj())
    return out


def _staged(nodes, existing, pods):
    cache = Cache()
    for nd in nodes:
        cache.add_node(nd)
    for pod, node_name in existing:
        pod.spec.node_name = node_name
        cache.add_pod(pod)
    snap = Snapshot()
    cache.update_snapshot(snap)
    state = ClusterState()
    state.apply_snapshot(snap, full=True)
    builder = BatchBuilder(state, BatchDims(table_rows=64))
    batch = builder.build(pods)
    assert not batch.host_fallback.any()
    return state, snap, builder, batch


def _layout(batch, m, S_min=2):
    """(wt_list, widx [bucket], valid [bucket]) as _wavescan_dispatch."""
    uniq = list(dict.fromkeys(int(t) for t in batch.tidx[:m]))
    S = max(pow2_at_least(len(uniq), 2), S_min)
    wt = (uniq + [uniq[-1]] * S)[:S]
    slot = {}
    for s, u in enumerate(wt):
        slot.setdefault(u, s)
    bucket = pow2_at_least(m)
    widx = np.empty((bucket,), np.int32)
    widx[:m] = [slot[int(t)] for t in batch.tidx[:m]]
    widx[m:] = widx[m - 1]
    valid = np.zeros((bucket,), bool)
    valid[:m] = True
    return wt, widx, valid


def plan_parity(nodes, existing, pods, *, lean=False, norm_live=None,
                cfg_kw=None, S_min=2, valid=None):
    """run_plan over the batch, JAX vs the port; returns the port's
    packed output split into (assignments, n_conf, prefix) and S."""
    state, snap, builder, batch = _staged(nodes, existing, pods)
    m = len(pods)
    wt, widx, vmask = _layout(batch, m, S_min)
    if valid is not None:
        vmask = valid
    has_ports = bool((batch.sig[:m] == 0).any())
    a = state.ensure_arrays()
    jna = jp.NodeArrays(*(jnp.asarray(x) for x in a))
    jtab = jp.PodTableDev(*(jnp.asarray(getattr(builder.table, f))
                            for f in jp.PodTableDev._fields))
    tna = convert.node_arrays_from_numpy(a, "cpu")
    ttab = convert.pod_table_from_numpy(builder.table, "cpu")
    if norm_live is None:
        from kubernetes_tpu.ops.hostgreedy import static_norm_ok
        norm_live = not all(static_norm_ok(a, builder.table.pref_weight[u])
                            for u in wt)
    if lean:
        jgd = jgc = tgd = tgc = None
        jfam, tfam = jg.GroupFamilies(*NO_FAM), tg.GroupFamilies(*NO_FAM)
    else:
        gd_np, gc_np = builder.groups.build_dev(snap)
        fam = builder.groups.families(snap)
        jgd, jgc = jg.to_device(gd_np), jg.to_device(gc_np)
        tgd = convert.groups_dev_from_numpy(gd_np, "cpu")
        tgc = convert.group_carry_from_numpy(gc_np, "cpu")
        jfam, tfam = fam, tg.GroupFamilies(*fam)
    jwt = jnp.asarray(np.array(wt, np.int32))
    jst = jp.wave_statics(jna, jtab, jwt)
    tst = tp.wave_statics(tna, ttab, wt)
    for x, y in zip(jst, tst):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())
    jcfg = jp.ScoreConfig(**(cfg_kw or {}))
    tcfg = tp.ScoreConfig(**(cfg_kw or {}))
    jc, jpk = jp.run_plan(
        jcfg, jna, jp.initial_carry(jna, jgc),
        jp.WaveXs(valid=jnp.asarray(vmask), widx=jnp.asarray(widx)), jtab,
        jwt, jgd, jst, jfam, norm_live, has_groups=not lean,
        has_ports=has_ports)
    tcarry = tp.initial_carry(tna, tgc)
    tc, tpk = tp.run_plan(
        tcfg, tna, tcarry,
        tp.WaveXs(valid=torch.from_numpy(vmask), widx=torch.from_numpy(widx)),
        ttab, wt, tgd, tst, tfam, norm_live, has_groups=not lean,
        has_ports=has_ports)
    assert tpk.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(jpk), tpk.numpy())
    for f in ("used", "nonzero_used", "npods", "ports"):
        x, y = np.asarray(getattr(jc, f)), getattr(tc, f).numpy()
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert int(jc.cache.sig) == int(tc.cache.sig) == 0
    if not has_ports:
        assert tc.ports is tcarry.ports
    if lean:
        assert jc.groups is None and tc.groups is None
    else:
        for f in tg.GroupCarry._fields:
            x, y = np.asarray(getattr(jc.groups, f)), getattr(tc.groups,
                                                              f).numpy()
            assert x.dtype == y.dtype, f
            np.testing.assert_array_equal(x, y, err_msg=f)
    W = vmask.shape[0]
    out = tpk.numpy()
    return dict(out=out[:m], n_conf=int(out[W]), prefix=int(out[W + 1]),
                S=len(wt), norm_live=norm_live, has_ports=has_ports)


def _pool_pods(n, kinds, seed, ports=False):
    """`n` pods cycling through `kinds` random lean templates (a template
    is a lean_pod drawn from its own seeded generator)."""
    return [lean_pod(random.Random(seed * 1000 + i % kinds), f"p{i}",
                     ports=ports) for i in range(n)]


def _spread(name, skew, app, action="DoNotSchedule", key=ZONE, cpu="1",
            mem="1Gi", sel=None):
    return (make_pod(name).req({"cpu": cpu, "memory": mem})
            .label("app", app).label("grp", "g")
            .spread_constraint(skew, key, action, sel or {"app": app}).obj())


class TestLean:
    @pytest.mark.parametrize("norm_live", [True, False])
    def test_lean_rotating_signatures(self, norm_live):
        nodes = lean_cluster(random.Random(7), 24)
        pods = _pool_pods(40, 12, 7)
        st = plan_parity(nodes, [], pods, lean=True, norm_live=norm_live)
        assert st["S"] >= 8 and not st["has_ports"]

    @pytest.mark.parametrize("norm_live", [True, False])
    def test_lean_ports_variant(self, norm_live):
        rng = random.Random(11)
        nodes = lean_cluster(rng, 20)
        pods = []
        for i in range(36):
            w = make_pod(f"p{i}").req({"cpu": "200m", "memory": "256Mi"})
            if i % 3 == 0:
                w = w.host_port(8080)
            elif i % 3 == 1:
                w = w.host_port(9090).host_port(9091)
            pods.append(w.obj())
        st = plan_parity(nodes, [], pods, lean=True, norm_live=norm_live)
        assert st["has_ports"]
        # 20 nodes, one 8080 port each: some port pods find no node
        placed = st["out"][::3]
        assert (placed >= 0).sum() <= 20

    def test_lean_32_signatures(self):
        rng = random.Random(3)
        nodes = lean_cluster(rng, 16)
        pods = [make_pod(f"p{i}").req({"cpu": f"{100 + 10 * (i % 32)}m",
                                       "memory": "64Mi"}).obj()
                for i in range(64)]
        st = plan_parity(nodes, [], pods, lean=True)
        assert st["S"] == 32

    def test_conflict_at_the_second_pod(self):
        """Two same-signature pods: the second's exact choice moves off
        the first's node (LeastAllocated), a conflict with its speculative
        choice right after the first step. The first pod of a span always
        matches its speculative choice, so the prefix is 1."""
        nodes = _nodes(8, 2)
        pods = [make_pod(f"p{i}").req({"cpu": "2", "memory": "1Gi"}).obj()
                for i in range(6)]
        st = plan_parity(nodes, [], pods, lean=True)
        assert st["prefix"] == 1 and st["n_conf"] >= 1

    def test_all_steps_padded(self):
        """No valid step: nothing placed, no conflict, prefix 0."""
        nodes = _nodes(8, 2)
        pods = [make_pod(f"p{i}").req({"cpu": "1"}).obj() for i in range(5)]
        st = plan_parity(nodes, [], pods, lean=True,
                         valid=np.zeros((8,), bool))
        assert (st["out"] == -1).all()
        assert st["n_conf"] == 0 and st["prefix"] == 0

    def test_most_allocated_profile(self):
        nodes = lean_cluster(random.Random(5), 16)
        pods = _pool_pods(30, 5, 5)
        plan_parity(nodes, [], pods, lean=True,
                    cfg_kw=dict(strategy="MostAllocated", w_taint=1))


class TestGroups:
    @pytest.mark.parametrize("norm_live", [True, False])
    def test_eight_signatures_shared_zone_spread(self, norm_live):
        """MixedHighSignature's shape: eight rotating signatures sharing
        one DoNotSchedule zone spread (selector on a common label)."""
        pods = [_spread(f"p{i}", 1, f"a{i % 8}", sel={"grp": "g"},
                        cpu=f"{200 + 100 * (i % 8)}m")
                for i in range(48)]
        st = plan_parity(_nodes(24, 4), [], pods, norm_live=norm_live)
        assert st["S"] == 8 and (st["out"] >= 0).all()

    def test_two_signatures_padded_slots(self):
        """Three distinct rows padded to S = 4: the duplicate slot is
        evaluated and refreshed but never consumed."""
        pods = [_spread(f"p{i}", 2, f"a{i % 3}") for i in range(30)]
        st = plan_parity(_nodes(12, 3), [], pods)
        assert st["S"] == 4

    def test_s2_and_padded_steps(self):
        pods = [_spread(f"p{i}", 1, f"a{i % 2}") for i in range(27)]
        st = plan_parity(_nodes(16, 4), [], pods)
        assert st["S"] == 2 and st["out"].shape[0] == 27

    def test_s32(self):
        pods = [_spread(f"p{i}", 3, f"a{i % 32}", sel={"grp": "g"})
                for i in range(64)]
        st = plan_parity(_nodes(32, 4, cpu=32), [], pods)
        assert st["S"] == 32

    @pytest.mark.parametrize("norm_live", [True, False])
    def test_schedule_anyway_rows(self, norm_live):
        pods = [_spread(f"p{i}", 2, "s", action="ScheduleAnyway")
                for i in range(30)]
        pods += [_spread(f"h{i}", 1, "h", action="ScheduleAnyway",
                         key=HOSTNAME) for i in range(10)]
        plan_parity(_nodes(12, 3, prefer=True), [], pods,
                    norm_live=norm_live)

    def test_self_matching_required_affinity(self):
        pods = [make_pod(f"p{i}").req({"cpu": "500m"}).label("team", "x")
                .pod_affinity(ZONE, {"team": "x"}).obj() for i in range(30)]
        st = plan_parity(_nodes(12, 4), [], pods)
        # the first pod takes the escape hatch; the rest follow its zone
        zones = {int(n) % 4 for n in st["out"]}
        assert len(zones) == 1

    def test_required_affinity_to_existing(self):
        ex = [(make_pod("db").req({"cpu": "1"}).label("app", "db").obj(),
               "n5")]
        pods = [make_pod(f"p{i}").req({"cpu": "1"}).label("app", "web")
                .pod_affinity(ZONE, {"app": "db"}).obj() for i in range(20)]
        pods += [_spread(f"s{i}", 1, "s") for i in range(10)]
        plan_parity(_nodes(12, 4), ex, pods)

    def test_score_terms_and_anti(self):
        ex = [(make_pod("anchor").req({"cpu": "1"}).label("app", "db")
               .preferred_pod_affinity(ZONE, {"app": "web"}, 9)
               .pod_affinity(HOSTNAME, {"app": "web"}, anti=True).obj(),
               "n3")]
        pods = []
        for i in range(36):
            if i % 3 == 0:
                pods.append(make_pod(f"w{i}").req({"cpu": "500m"})
                            .label("app", "web")
                            .preferred_pod_affinity(ZONE, {"app": "web"}, 5)
                            .obj())
            elif i % 3 == 1:
                pods.append(make_pod(f"a{i}").req({"cpu": "500m"})
                            .label("anti", "y")
                            .pod_affinity(ZONE, {"anti": "y"}, anti=True)
                            .obj())
            else:
                pods.append(make_pod(f"q{i}").req({"cpu": "250m"}).obj())
        st = plan_parity(_nodes(12, 6), ex, pods)
        anti = st["out"][1::3]
        assert len({int(n) % 6 for n in anti if n >= 0}) == (anti >= 0).sum()

    def test_group_ports_variant(self):
        pods = []
        for i in range(30):
            if i % 2:
                pods.append(make_pod(f"p{i}").req({"cpu": "250m"})
                            .host_port(8080).obj())
            else:
                pods.append(_spread(f"s{i}", 1, "s"))
        st = plan_parity(_nodes(12, 3), [], pods)
        assert st["has_ports"]


def test_surface_cache_stacked_matches_jax():
    nodes = lean_cluster(random.Random(2), 20)
    pods = _pool_pods(30, 5, 2)
    state, _snap, builder, batch = _staged(nodes, [], pods)
    rows = tuple(dict.fromkeys(int(t) for t in batch.tidx[:30]))
    rows = rows + (rows[-1],) * 3
    a = state.ensure_arrays()
    jna = jp.NodeArrays(*(jnp.asarray(x) for x in a))
    jtab = jp.PodTableDev(*(jnp.asarray(getattr(builder.table, f))
                            for f in jp.PodTableDev._fields))
    js = JSurfaces(state, builder).stacked(jna, jtab, rows)
    ts = TSurfaces(state, builder).stacked(
        convert.node_arrays_from_numpy(a, "cpu"),
        convert.pod_table_from_numpy(builder.table, "cpu"), rows)
    for x, y in zip(js, ts):
        assert tuple(y.shape) == (len(rows), a.valid.shape[0])
        np.testing.assert_array_equal(np.asarray(x), y.numpy())


# -- the drain compiler's spans ------------------------------------------------


def _compilers(state, builder):
    j = JCompiler(state=state, builder=builder, gates=default_gate())
    t = TCompiler(builder=builder, state=state)
    return j, t


def _spans_both(nodes, existing, pods, groups_needed, **kw):
    state, _snap, builder, batch = _staged(nodes, existing, pods)
    j, t = _compilers(state, builder)
    n = len(pods)
    js = j.compile_drain(batch, n, groups_needed=groups_needed, **kw).spans
    ts = t.compile_drain(batch, n, groups_needed=groups_needed, **kw).spans
    assert ts == js
    return ts


class TestDrainCompilerSpans:
    def test_multi_signature_group_drain(self):
        pods = [_spread(f"p{i}", 1, f"a{i % 8}", sel={"grp": "g"})
                for i in range(40)]
        spans = _spans_both(_nodes(8, 2), [], pods, True)
        assert spans[0][2][0] == "wavescan" and len(spans[0][2][1]) == 8

    def test_schedule_anyway_drain(self):
        pods = [_spread(f"p{i}", 2, "s", action="ScheduleAnyway")
                for i in range(30)]
        spans = _spans_both(_nodes(8, 2), [], pods, True)
        assert spans == [(0, 30, ("wavescan", spans[0][2][1], False))]

    def test_self_required_affinity_drain(self):
        pods = [make_pod(f"p{i}").req({"cpu": "1"}).label("t", "x")
                .pod_affinity(ZONE, {"t": "x"}).obj() for i in range(30)]
        spans = _spans_both(_nodes(8, 2), [], pods, True)
        assert spans[0][2][0] == "wavescan"

    def test_self_score_term_drain(self):
        pods = [make_pod(f"p{i}").req({"cpu": "1"}).label("t", "x")
                .preferred_pod_affinity(ZONE, {"t": "x"}, 4).obj()
                for i in range(30)]
        spans = _spans_both(_nodes(8, 2), [], pods, True)
        assert spans[0][2][0] == "wavescan"

    def test_same_signature_spread_stays_wave(self):
        pods = [_spread(f"p{i}", 1, "s") for i in range(30)]
        spans = _spans_both(_nodes(8, 2), [], pods, True)
        assert spans[0][2][0] == "wave"

    def test_group_drain_with_ports(self):
        pods = [_spread(f"p{i}", 1, "s") if i % 2 else
                make_pod(f"h{i}").req({"cpu": "1"}).host_port(80).obj()
                for i in range(30)]
        spans = _spans_both(_nodes(8, 2), [], pods, True)
        assert spans[0][2][0] == "wavescan" and spans[0][2][2] is True

    def test_33_signatures_stay_on_the_scan(self):
        pods = [_spread(f"p{i}", 1, f"a{i % 33}", sel={"grp": "g"})
                for i in range(66)]
        spans = _spans_both(_nodes(8, 2), [], pods, True)
        assert spans == [(0, 66, ("scan",))]

    def test_short_group_drain_stays_on_the_scan(self):
        pods = [_spread(f"p{i}", 1, f"a{i % 3}") for i in range(20)]
        assert _spans_both(_nodes(8, 2), [], pods, True) == [(0, 20,
                                                              ("scan",))]

    @pytest.mark.parametrize("prefer", [False, True])
    def test_lean_span_upgrades(self, prefer):
        pods = []
        for r in range(6):
            if r % 2:
                pods += [make_pod(f"u{r}-{k}").req({"cpu": "300m"}).obj()
                         for k in range(20)]
            else:
                pods += [lean_pod(random.Random(k % 6), f"m{r}-{k}")
                         for k in range(30)]
        spans = _spans_both(_nodes(8, 2), [], pods, False,
                            prefer_taints=prefer)
        kinds = {s[2][0] for s in spans}
        assert "wavescan" in kinds
        if prefer:
            # a tainted cluster: the whole drain is one scan span,
            # upgraded to one plan span
            assert len(spans) == 1

    def test_lean_33_signatures_stay_on_the_scan(self):
        pods = [make_pod(f"p{i}").req({"cpu": f"{100 + 7 * (i % 33)}m"})
                .obj() for i in range(66)]
        spans = _spans_both(_nodes(8, 2), [], pods, False)
        assert spans == [(0, 66, ("scan",))]
