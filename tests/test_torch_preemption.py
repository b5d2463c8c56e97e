"""Preemption end to end: kubernetes_tpu.Scheduler ↔
kubernetes_tpu_torch.Scheduler(device="cpu"), exact equality.

Each case runs one workload — built twice, once from each package's own
testing wrappers — under a controlled clock through both schedulers, and
compares what a user sees: the bind map, the pending pods, the
nominations, the deleted victims and, for the PreemptionChurn-shaped
workload, every drain's compiled spans. The cases are those of
tests/test_preemption.py (evict and land, equal priority, policy Never,
the minimal victim set, PDBs, the pick-one-node order, nominated capacity
under the device overlay), plus the two places where the port differs or
must be ordered: a drain under a lower-priority nomination (the JAX
package's host scheduling path; the port raises NotImplementedError),
and `_handle_failure` committing every in-flight drain before the
Evaluator runs."""

import pytest
import torch

import kubernetes_tpu  # noqa: F401  (x64 before any jnp array)
from _torch_parity import private_jax_compiles  # noqa: F401
from kubernetes_tpu.api import types as jtypes
from kubernetes_tpu.framework import preemption as jpre
from kubernetes_tpu.framework import types as jft
from kubernetes_tpu_torch.api import types as ttypes
from kubernetes_tpu_torch.framework import preemption as tpre
from kubernetes_tpu_torch.framework import types as tft
from test_torch_scheduler import JAX, TORCH

torch.set_num_threads(1)

_MODS = {id(JAX): (jtypes, jft, jpre), id(TORCH): (ttypes, tft, tpre)}


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


def _sched(pkg, api, clock, batch_size=64, run_min=10 ** 9):
    _w, _Api, Sched, kw = pkg
    sched = Sched(api, batch_size=batch_size, clock=clock, **kw)
    if Sched is JAX[2]:
        sched.profiler = None
        sched.audit = None
        sched._probe_enabled = False
    # the tests/test_preemption.py setting: scans unless a case asks for
    # the uniform runs
    sched.UNIFORM_RUN_MIN = run_min
    return sched


def _cluster(pkg, n_nodes=3, cpu=4, run_min=10 ** 9):
    w, Api = pkg[0], pkg[1]
    api = Api()
    clock = FakeClock()
    sched = _sched(pkg, api, clock, run_min=run_min)
    for i in range(n_nodes):
        api.create_node(w.make_node(f"n{i}").capacity(
            {"cpu": cpu, "memory": "16Gi", "pods": 110}).obj())
    return w, api, sched, clock


def _fill(w, api, sched, n_nodes=3, cpu_each="4", prio=0):
    for i in range(n_nodes):
        api.create_pod(w.make_pod(f"low{i}").req(
            {"cpu": cpu_each, "memory": "1Gi"}).priority(prio).obj())
    assert sched.schedule_pending() == n_nodes


def _requeue(sched, clock):
    """Past the requeue backoff, then one more cycle."""
    clock.t += 15.0
    sched.flush_queues()
    return sched.schedule_pending()


def _state(api, sched):
    binds = {uid: p.spec.node_name for uid, p in api.pods.items()
             if p.spec.node_name}
    pending = sorted(p.uid for p in sched.queue.pending_pods()[0])
    noms = {uid: p.status.nominated_node_name
            for uid, p in api.pods.items() if p.status.nominated_node_name}
    return binds, pending, noms, sorted(api.pods)


def _parity(case):
    outs = [case(pkg) for pkg in (JAX, TORCH)]
    assert outs[1] == outs[0]
    return outs[1]


# ---------------------------------------------------------------------------
# tests/test_preemption.py end to end, in both packages


def _evict_and_land(pkg):
    w, api, sched, clock = _cluster(pkg)
    _fill(w, api, sched)
    api.create_pod(w.make_pod("vip").req({"cpu": "4", "memory": "1Gi"})
                   .priority(100).obj())
    first = sched.schedule_pending()
    mid = _state(api, sched)
    bound = _requeue(sched, clock)
    return first, mid, bound, sched.preemption_attempts, _state(api, sched)


def test_high_priority_evicts_and_lands():
    first, mid, bound, attempts, end = _parity(_evict_and_land)
    assert (first, bound, attempts) == (0, 1, 1)
    nominated = mid[2]["default/vip"]
    assert len([u for u in mid[3] if u.startswith("default/low")]) == 2
    assert end[0]["default/vip"] == nominated


def _equal_priority(pkg):
    w, api, sched, _clock = _cluster(pkg)
    _fill(w, api, sched, prio=50)
    api.create_pod(w.make_pod("peer").req({"cpu": "4", "memory": "1Gi"})
                   .priority(50).obj())
    return sched.schedule_pending(), _state(api, sched)


def test_equal_priority_cannot_preempt():
    bound, (_b, pending, noms, pods) = _parity(_equal_priority)
    assert bound == 0 and pending == ["default/peer"] and not noms
    assert len(pods) == 4


def _never(pkg):
    w, api, sched, _clock = _cluster(pkg)
    _fill(w, api, sched)
    pod = w.make_pod("nice").req({"cpu": "4", "memory": "1Gi"}) \
        .priority(100).obj()
    pod.spec.preemption_policy = "Never"
    api.create_pod(pod)
    return sched.schedule_pending(), _state(api, sched)


def test_preemption_policy_never():
    bound, (_b, _p, noms, pods) = _parity(_never)
    assert bound == 0 and not noms and len(pods) == 4


def _minimal_victims(pkg):
    w, api, sched, clock = _cluster(pkg, n_nodes=1, cpu=4)
    for i in range(4):
        api.create_pod(w.make_pod(f"low{i}").req(
            {"cpu": "1", "memory": "1Gi"}).priority(i).obj())
    assert sched.schedule_pending() == 4
    api.create_pod(w.make_pod("vip").req({"cpu": "2", "memory": "1Gi"})
                   .priority(100).obj())
    sched.schedule_pending()
    mid = _state(api, sched)
    return mid, _requeue(sched, clock), _state(api, sched)


def test_minimal_victim_set():
    mid, bound, end = _parity(_minimal_victims)
    assert [u for u in mid[3] if "low" in u] == ["default/low2",
                                                 "default/low3"]
    assert bound == 1 and end[0]["default/vip"] == "n0"


def _pdb(pkg, name, labels, min_available=None):
    types = _MODS[id(pkg)][0]
    return types.PodDisruptionBudget(
        metadata=types.ObjectMeta(name=name),
        selector=types.LabelSelector.of(match_labels=labels),
        min_available=min_available)


def _pdb_changes_pick(pkg):
    w, api, sched, _clock = _cluster(pkg, n_nodes=2, cpu=4)
    api.create_pod(w.make_pod("guarded").req({"cpu": "4", "memory": "1Gi"})
                   .label("app", "guarded").node("n0").obj())
    api.create_pod(w.make_pod("plain").req({"cpu": "4", "memory": "1Gi"})
                   .label("app", "plain").node("n1").obj())
    api.create_pdb(_pdb(pkg, "pdb", {"app": "guarded"}, min_available=1))
    api.create_pod(w.make_pod("vip").req({"cpu": "4", "memory": "1Gi"})
                   .priority(100).obj())
    sched.schedule_pending()
    return _state(api, sched)


def test_pdb_changes_picked_node():
    _b, _p, noms, pods = _parity(_pdb_changes_pick)
    assert noms["default/vip"] == "n1"
    assert "default/plain" not in pods and "default/guarded" in pods


def _pdb_no_alternative(pkg):
    w, api, sched, _clock = _cluster(pkg, n_nodes=1, cpu=4)
    api.create_pod(w.make_pod("guarded").req({"cpu": "4", "memory": "1Gi"})
                   .label("app", "g").node("n0").obj())
    api.create_pdb(_pdb(pkg, "pdb", {"app": "g"}, min_available=1))
    api.create_pod(w.make_pod("vip").req({"cpu": "4", "memory": "1Gi"})
                   .priority(100).obj())
    sched.schedule_pending()
    return _state(api, sched)


def test_pdb_violated_when_no_alternative():
    _b, _p, noms, pods = _parity(_pdb_no_alternative)
    assert noms["default/vip"] == "n0" and "default/guarded" not in pods


def _pick_order(pkg, case):
    _types, ft, pre = _MODS[id(pkg)]
    w = pkg[0]

    def cand(node, prios):
        return pre.Candidate(node_name=node, victims=[
            ft.PodInfo.of(w.make_pod(f"v-{node}-{i}").priority(p).obj())
            for i, p in enumerate(prios)])
    cands = {
        "no_victims": [cand("a", [5]), pre.Candidate(node_name="b"),
                       cand("c", [1])],
        "lowest_max": [cand("a", [9, 1]), cand("b", [5, 4]),
                       cand("c", [8, 2])],
        "smallest_sum": [cand("a", [5, 5]), cand("b", [5, 3])],
        "fewest": [cand("a", [5, 3, 0]), cand("b", [5, 3])],
        # every earlier step ties: the latest-started top victim wins
        "latest_start": [cand("a", [5, 3]), cand("b", [5, 3]),
                         cand("c", [5, 3])],
    }[case]
    if case == "latest_start":
        cands[1].num_pdb_violations = 0
    return pre.Evaluator.pick_one_node(cands).node_name


@pytest.mark.parametrize("case,want", [
    ("no_victims", "b"), ("lowest_max", "b"), ("smallest_sum", "b"),
    ("fewest", "b"), ("latest_start", "c")])
def test_pick_one_node_order(case, want):
    assert _parity(lambda pkg: _pick_order(pkg, case)) == want


def _nominated_blocks(pkg):
    w, api, sched, clock = _cluster(pkg, n_nodes=1, cpu=4)
    _fill(w, api, sched, n_nodes=1)
    api.create_pod(w.make_pod("vip").req({"cpu": "4", "memory": "1Gi"})
                   .priority(100).obj())
    sched.schedule_pending()
    api.create_pod(w.make_pod("sneak").req({"cpu": "4", "memory": "1Gi"})
                   .priority(0).obj())
    _requeue(sched, clock)
    return _state(api, sched)


def test_nominated_resources_block_other_pods():
    binds, pending, _n, _p = _parity(_nominated_blocks)
    assert binds["default/vip"] == "n0" and "default/sneak" not in binds
    assert pending == ["default/sneak"]


def _overlay_flood(pkg):
    w, api, sched, clock = _cluster(pkg, n_nodes=3, cpu=4, run_min=16)
    _fill(w, api, sched, n_nodes=3)
    api.create_pod(w.make_pod("vip").req({"cpu": "4", "memory": "1Gi"})
                   .priority(100).obj())
    sched.schedule_pending()
    nominated = api.pods["default/vip"].status.nominated_node_name
    before = sched.device_batches
    for i in range(4):
        api.create_pod(w.make_pod(f"flood{i}")
                       .req({"cpu": "4", "memory": "1Gi"}).obj())
    sched.schedule_pending()
    flood_on_device = sched.device_batches > before
    mid = _state(api, sched)
    _requeue(sched, clock)
    return nominated, flood_on_device, mid, _state(api, sched)


def test_device_overlay_keeps_the_nominated_capacity():
    nominated, on_device, mid, end = _parity(_overlay_flood)
    assert nominated and on_device
    assert not any(u.startswith("default/flood") for u in mid[0])
    assert end[0]["default/vip"] == nominated


# ---------------------------------------------------------------------------
# where the port differs, and where it must be ordered


def _lower_priority_nomination(pkg):
    w, api, sched, _clock = _cluster(pkg, n_nodes=2, cpu=4)
    _fill(w, api, sched, n_nodes=2, prio=0)
    api.create_pod(w.make_pod("mid").req({"cpu": "4", "memory": "1Gi"})
                   .priority(10).obj())
    sched.schedule_pending()        # nominates at priority 10
    api.create_pod(w.make_pod("hi").req({"cpu": "1", "memory": "1Gi"})
                   .priority(100).obj())
    return w, api, sched


def test_unrepresentable_overlay_raises_where_jax_takes_its_host_path():
    """A nomination of lower priority than a drain pod has no overlay
    form: the JAX package schedules the drain on its host path, the port
    (which has none) refuses it and names that path."""
    _w, japi, jsched = _lower_priority_nomination(JAX)
    _w, tapi, tsched = _lower_priority_nomination(TORCH)
    noms = dict(jsched.queue.nominator.nominated_pods)
    assert dict(tsched.queue.nominator.nominated_pods) == noms
    assert list(noms) == ["default/mid"]
    jsched.schedule_pending()
    assert jsched.host_scheduled >= 1
    with pytest.raises(NotImplementedError, match="_schedule_one_host"):
        tsched.schedule_pending()


def _drains_before_evaluator(pkg):
    """_handle_failure runs with a drain still in flight: the Evaluator
    must see that drain's binds."""
    _types, ft, _pre = _MODS[id(pkg)]
    w, api, sched, _clock = _cluster(pkg, n_nodes=2, cpu=4)
    calls = []
    real = sched._drain_pending

    def spy():
        calls.append(len(sched._pending))
        real()
    sched._drain_pending = spy
    for i in range(2):
        api.create_pod(w.make_pod(f"low{i}").req(
            {"cpu": "4", "memory": "1Gi"}).obj())
    # dispatch one drain and leave it uncommitted
    sched._schedule_batch(sched.queue.drain(64))
    in_flight = len(sched._pending)
    calls.clear()
    qpi = ft.QueuedPodInfo(pod_info=ft.PodInfo.of(
        w.make_pod("vip").req({"cpu": "4", "memory": "1Gi"})
        .priority(100).obj()))
    sched._handle_failure(qpi, ft.FitError(qpi.pod, 2))
    return in_flight, calls[:1], len(sched._pending), \
        qpi.pod.status.nominated_node_name


def test_handle_failure_drains_pending_before_the_evaluator():
    in_flight, first_call, left, nominated = _parity(
        _drains_before_evaluator)
    # the drain was in flight, _handle_failure committed it first, and
    # the Evaluator then found both nodes full of lower-priority pods
    assert in_flight == 1 and first_call == [1] and left == 0
    assert nominated in ("n0", "n1")


# ---------------------------------------------------------------------------
# PreemptionChurn at small width


def _churn(pkg, n_nodes=64, init=64, preemptors=8, measured=128, chunk=32):
    """performance-config.yaml PreemptionChurn at 64 nodes: nodes of 8 cpu
    (the harness's node shape otherwise), init pods of 4 cpu, preemptors
    of 8 cpu at priority 100 that each evict one victim and take a
    nomination, then measured 500m pods created in chunks while the
    nominations are pending. The preemptors' backoff expires halfway
    through the measured op, so the rest of it drains them with the
    measured pods. Each chunk drains to the end before the next: the
    JAX package's asynchronous commit would otherwise let the drain
    boundaries (and with them the spans) follow its dispatch timing."""
    w, Api = pkg[0], pkg[1]
    api = Api()
    clock = FakeClock()
    sched = _sched(pkg, api, clock, batch_size=64, run_min=16)
    spans = []
    real = sched.compiler.compile_drain

    def record(*a, **kw):
        plan = real(*a, **kw)
        spans.append(list(plan.spans))
        return plan
    sched.compiler.compile_drain = record
    for i in range(n_nodes):
        api.create_node(w.make_node(f"node-{i}").capacity(
            {"cpu": 8, "memory": "64Gi", "pods": 110})
            .zone(f"zone-{i % 16}")
            .label("kubernetes.io/hostname", f"node-{i}").obj())
    sched.prime()
    seq = 0

    def create(count, req, prio=0, half=None):
        nonlocal seq
        for k in range(0, count, chunk):
            if half is not None and k == half:
                clock.t += 15.0
            pods = []
            for i in range(k, min(k + chunk, count)):
                p = w.make_pod(f"pod-{seq + i}").req(req)
                if prio:
                    p = p.priority(prio)
                pods.append(p.obj())
            api.create_pods(pods)
            sched.schedule_pending()
        seq += count

    create(init, {"cpu": "4", "memory": "1Gi"})
    init_pods = set(api.pods)
    create(preemptors, {"cpu": "8", "memory": "1Gi"}, prio=100)
    noms = dict(sched.queue.nominator.nominated_pods)
    victims = sorted(init_pods - set(api.pods))
    create(measured, {"cpu": "500m", "memory": "256Mi"},
           half=measured // 2)
    binds = {uid: p.spec.node_name for uid, p in api.pods.items()
             if p.spec.node_name}
    return noms, victims, binds, spans


def test_preemption_churn_parity():
    noms, victims, binds, spans = _parity(_churn)
    assert len(noms) == 8 and len(victims) == 8
    preemptors = [f"default/pod-{64 + i}" for i in range(8)]
    assert sorted(noms) == preemptors
    for uid in preemptors:
        assert binds[uid] == noms[uid]
    assert len(binds) == 64 - 8 + 8 + 128
    # measured drains ran under the overlay as uniform runs, and the
    # drain that took the returning preemptors as one scan span
    flat = [k[0] for drain in spans for (_i, _j, k) in drain]
    assert "uniform" in flat and "scan" in flat
