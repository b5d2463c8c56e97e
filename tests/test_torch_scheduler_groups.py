"""Group workloads through both schedulers: kubernetes_tpu.Scheduler ↔
kubernetes_tpu_torch.Scheduler(device="cpu"), exact equality.

Small TopologySpreading and SchedulingPodAntiAffinity shapes (the
workloads of kubernetes_tpu/perf/configs/performance-config.yaml:63-129,
cut to 64 nodes and a few hundred pods created in 64-pod chunks) must end
with the same bind map and pending set in both packages; every wave drain
of the JAX package must compile to the same span in the port, and the
port must have run run_wave. MixedHighSignature- and
MixedSchedulingBasePod-shaped workloads (:195-284, cut the same way) hold
the plan program's "wavescan" spans to the JAX package's. Then one case
per routing difference (the port runs the scan where the JAX package
takes its host greedy), each with equal bind maps."""

import pytest
import torch

import kubernetes_tpu  # noqa: F401  (x64 before any jnp array)

from _torch_parity import private_jax_compiles  # noqa: F401
from test_torch_scheduler import JAX, TORCH, _outcome, make_scheduler

ZONE = "topology.kubernetes.io/zone"
HOSTNAME = "kubernetes.io/hostname"

torch.set_num_threads(1)


def _spy_spans(sched):
    """Record the spans of every dispatched drain (both packages route
    each drain's DrainPlan through _dispatch_spans)."""
    seen = []
    orig = sched._dispatch_spans

    def spy(cfg, na, batch, table, spans, carry, *a, **kw):
        seen.append([tuple(s) for s in spans])
        return orig(cfg, na, batch, table, spans, carry, *a, **kw)
    sched._dispatch_spans = spy
    return seen


def _cluster(pkg, n_nodes, zones, batch_size, prefer=False):
    w, Api = pkg[0], pkg[1]
    api = Api()
    sched = make_scheduler(pkg, api, batch_size)
    for i in range(n_nodes):
        b = (w.make_node(f"node-{i}").capacity(
            {"cpu": 32, "memory": "64Gi", "pods": 110})
            .zone(f"zone-{i % zones}").label(HOSTNAME, f"node-{i}"))
        if prefer and i % 5 == 0:
            b = b.taint("spot", "", effect="PreferNoSchedule")
        api.create_node(b.obj())
    sched.prime()
    return api, sched


def _create(api, sched, pods, chunk):
    for k in range(0, len(pods), chunk):
        api.create_pods(pods[k:k + chunk])
        sched.schedule_pending(wait=False)
    sched.schedule_pending()


def _template(w, name, kind):
    p = w.make_pod(name).req({"cpu": "900m", "memory": "1Gi"})
    if kind == "spread":
        return p.label("app", "spread").spread_constraint(
            5, ZONE, "DoNotSchedule", {"app": "spread"}).obj()
    if kind == "anti":
        return p.label("anti", "yes").pod_affinity(
            ZONE, {"anti": "yes"}, anti=True).obj()
    return p.obj()


def _workload(pkg, kind, n_nodes, zones, n_init, n_meas, chunk=64,
              batch_size=64):
    w = pkg[0]
    api, sched = _cluster(pkg, n_nodes, zones, batch_size)
    spans = _spy_spans(sched)
    _create(api, sched, [_template(w, f"pod-{i}", "plain")
                         for i in range(n_init)], chunk)
    _create(api, sched, [_template(w, f"pod-{n_init + i}", kind)
                         for i in range(n_meas)], chunk)
    return api, sched, spans


@pytest.mark.parametrize("kind,zones,n_init,n_meas", [
    ("spread", 16, 64, 300),        # TopologySpreading, maxSkew 5
    ("anti", 10000, 20, 60),        # SchedulingPodAntiAffinity
])
def test_group_workload_bind_and_plan_parity(kind, zones, n_init, n_meas):
    japi, jsched, jspans = _workload(JAX, kind, 64, zones, n_init, n_meas)
    tapi, tsched, tspans = _workload(TORCH, kind, 64, zones, n_init, n_meas)
    jres, tres = _outcome(japi, jsched), _outcome(tapi, tsched)
    assert len(tres[0]) == n_init + n_meas
    assert tres == jres
    # every drain compiled to the same spans, the wave drains included
    assert tspans == jspans
    waves = [s for spans in tspans for s in spans if s[2][0] == "wave"]
    assert waves and tsched.wave_runs == len(waves)
    assert tsched.reconcile() == []


def _routing_case(pkg, builds, prefer=False, batch_size=64):
    """Drains of the given pod lists, each created and drained alone."""
    w = pkg[0]
    api, sched = _cluster(pkg, 48, 6, batch_size, prefer=prefer)
    spans = _spy_spans(sched)
    seq = 0
    for n, build in builds:
        pods = []
        for _ in range(n):
            pods.append(build(w, f"g-{seq}"))
            seq += 1
        api.create_pods(pods)
        sched.schedule_pending()
    return api, sched, spans


def _spread_pod(skew, action="DoNotSchedule", app="s"):
    def build(w, name):
        return (w.make_pod(name).req({"cpu": "500m", "memory": "1Gi"})
                .label("app", app)
                .spread_constraint(skew, ZONE, action, {"app": app}).obj())
    return build


def _check_routing(builds, same_spans: bool = False):
    """Equal bind maps; with `same_spans` every drain compiled to the
    JAX package's spans, else the port ran every drain on its scan."""
    japi, jsched, jspans = _routing_case(JAX, builds)
    tapi, tsched, tspans = _routing_case(TORCH, builds)
    assert _outcome(tapi, tsched) == _outcome(japi, jsched)
    assert tsched.reconcile() == []
    if same_spans:
        assert tspans == jspans
    else:
        assert tspans and all(s[2] == ("scan",) for spans in tspans
                              for s in spans)
    return jsched, jspans


def test_routing_same_signature_drain_16_to_23_pods():
    """The JAX package's host greedy takes a same-signature group drain
    of 16-23 pods; the port's scan binds the same."""
    jsched, _ = _check_routing([(20, _spread_pod(1)), (18, _spread_pod(1))])
    assert jsched.host_greedy_runs == 2


def test_routing_schedule_anyway_drain():
    """ScheduleAnyway rows go to the plan program ("wavescan") in both
    packages: the same spans, the same binds."""
    _jsched, jspans = _check_routing(
        [(40, _spread_pod(2, "ScheduleAnyway"))], same_spans=True)
    assert any(s[2][0] == "wavescan" for spans in jspans for s in spans)


def test_routing_drain_below_16_pods():
    """A drain of fewer than 16 group pods runs the scan in both."""
    _jsched, jspans = _check_routing([(10, _spread_pod(1)),
                                      (7, _spread_pod(1))])
    assert all(s[2] == ("scan",) for spans in jspans for s in spans)


def test_wave_drain_on_tainted_cluster_renormalizes():
    """PreferNoSchedule taints: the wave runs its serial tier only
    (norm_live), in both packages, with equal bind maps."""
    builds = [(40, _spread_pod(2))]
    japi, jsched, jspans = _routing_case(JAX, builds, prefer=True)
    tapi, tsched, tspans = _routing_case(TORCH, builds, prefer=True)
    assert _outcome(tapi, tsched) == _outcome(japi, jsched)
    assert tspans == jspans
    assert tsched.wave_runs == 1
    assert tsched.wave_stats["waves"] == 0
    assert tsched.wave_stats["serial_steps"] == 40
    assert list(tsched.wave_stats["first_prefix"]) == [-1]


def test_bound_pods_with_affinity_score_every_pod():
    """A bound pod's preferred and required terms move every incoming
    pod's scores and filters (symmetric affinity): the lean pods of the
    drain run the group plan program with the web pods, in both
    packages."""
    def plain(w, name):
        return w.make_pod(name).req({"cpu": "500m", "memory": "1Gi"}).obj()

    outs, plans = [], []
    for pkg in (JAX, TORCH):
        w = pkg[0]
        api, sched = _cluster(pkg, 24, 4, 64)
        plans.append(_spy_spans(sched))
        api.create_pod(w.make_pod("anchor").req({"cpu": "1"})
                       .label("app", "db").node("node-3")
                       .preferred_pod_affinity(ZONE, {"app": "web"}, 9)
                       .pod_affinity(HOSTNAME, {"app": "web"}, anti=True)
                       .obj())
        pods = [w.make_pod(f"web-{i}").req({"cpu": "500m"})
                .label("app", "web").obj() for i in range(30)]
        pods += [plain(w, f"plain-{i}") for i in range(10)]
        api.create_pods(pods)
        sched.schedule_pending()
        outs.append(_outcome(api, sched))
    assert outs[0] == outs[1]
    assert plans[0] == plans[1]
    assert plans[1][0][0][2][0] == "wavescan"
    assert "node-3" not in [n for uid, n in outs[1][0].items()
                            if uid.startswith("default/web-")]


def test_anti_wave_wider_than_the_node_axis():
    """30 anti pods on 12 nodes (16 node rows): the wave's top-K cannot
    fill Lw = 32 entries. The JAX package's lax.top_k raises and the
    drain degrades to its host path; the port narrows the wave to
    K·J = 16 and binds the same pods to the same nodes."""
    def anti(w, name):
        return (w.make_pod(name).req({"cpu": "1"}).label("anti", "y")
                .pod_affinity(ZONE, {"anti": "y"}, anti=True).obj())

    outs = []
    for pkg in (JAX, TORCH):
        w = pkg[0]
        api, sched = _cluster(pkg, 12, 12, 64)
        api.create_pods([anti(w, f"a{i}") for i in range(30)])
        sched.schedule_pending()
        outs.append((_outcome(api, sched), sched))
    (jres, jsched), (tres, tsched) = outs
    assert jsched.device_fallbacks == 1
    assert tres == jres and len(tres[0]) == 12
    assert tsched.wave_runs == 1


# -- the plan program's workloads (performance-config.yaml:195-284) --------


def _mix_pod(w, name, cpu, labels, action="DoNotSchedule", mem="1Gi"):
    p = w.make_pod(name).req({"cpu": cpu, "memory": mem})
    for k, v in labels.items():
        p = p.label(k, v)
    return p.spread_constraint(5, ZONE, action, labels).obj()


def _mixed_high_signature(pkg, n_init, n_meas):
    """MixedHighSignature (:239-284) cut to 64 nodes: 900m zone-spread
    init pods, then measured pods whose cpu request rotates over eight
    values (signatureCycle 8, perf/harness.py) under the same
    DoNotSchedule zone spread, maxSkew 5."""
    w = pkg[0]
    api, sched = _cluster(pkg, 64, 16, 64)
    spans = _spy_spans(sched)
    mix = {"app": "mix"}
    _create(api, sched, [_mix_pod(w, f"init-{i}", "900m", mix)
                         for i in range(n_init)], 64)
    _create(api, sched, [_mix_pod(w, f"pod-{i}", f"{250 + 50 * (i % 8)}m",
                                  mix) for i in range(n_meas)], 64)
    return api, sched, spans


def _mixed_base_pod(pkg, n_init, n_aff, n_meas):
    """MixedSchedulingBasePod (:195-237) cut to 64 nodes: ScheduleAnyway
    zone-spread init pods, self-matching required zone affinity pods,
    then plain measured pods."""
    w = pkg[0]
    api, sched = _cluster(pkg, 64, 16, 64)
    spans = _spy_spans(sched)
    base = {"mixed": "base"}
    _create(api, sched, [_mix_pod(w, f"init-{i}", "900m", base,
                                  action="ScheduleAnyway")
                         for i in range(n_init)], 64)
    _create(api, sched, [
        w.make_pod(f"aff-{i}").req({"cpu": "500m", "memory": "512Mi"})
        .label("mixed", "base").pod_affinity(ZONE, base).obj()
        for i in range(n_aff)], 64)
    _create(api, sched, [_template(w, f"pod-{i}", "plain")
                         for i in range(n_meas)], 64)
    return api, sched, spans


def test_mixed_high_signature_bind_and_plan_parity():
    japi, jsched, jspans = _mixed_high_signature(JAX, 64, 320)
    tapi, tsched, tspans = _mixed_high_signature(TORCH, 64, 320)
    tres = _outcome(tapi, tsched)
    assert len(tres[0]) == 384
    assert tres == _outcome(japi, jsched)
    assert tspans == jspans
    plans = [s for spans in tspans for s in spans if s[2][0] == "wavescan"]
    assert plans and len(plans[0][2][1]) == 8
    assert tsched.plan_runs == len(plans)
    assert tsched.reconcile() == []


def test_mixed_scheduling_base_pod_bind_and_plan_parity():
    japi, jsched, jspans = _mixed_base_pod(JAX, 64, 48, 256)
    tapi, tsched, tspans = _mixed_base_pod(TORCH, 64, 48, 256)
    tres = _outcome(tapi, tsched)
    assert len(tres[0]) == 64 + 48 + 256
    assert tres == _outcome(japi, jsched)
    assert tspans == jspans
    plans = [s for spans in tspans for s in spans if s[2][0] == "wavescan"]
    assert len(plans) >= 2 and tsched.plan_runs == len(plans)
    assert tsched.reconcile() == []
