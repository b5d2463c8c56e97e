"""Scheduler(mesh=…): the port's node-sharded Scheduler ↔ the JAX
package's mesh Scheduler ↔ the port's single-device Scheduler.

The port's mesh runs its shards on the CPU in one process
(`make_mesh(devices=["cpu"] * D)`), the JAX package's on the 8-device
virtual CPU mesh. Bind maps and pending pods must be equal (exact), and
the mesh run must actually go through the sharded programs: spies on
the scheduler's sharded entry points count their calls (above 0), and
the single-device twins are never called. The refusals: a non-pow2 mesh
(ValueError), a device other than the mesh's (ValueError), and
NotImplementedError for group, plan-span, gang, nominated and
SanitizerRails drains on the mesh. The mesh form of the batched
preemption dry run picks the JAX package's victims."""

import pytest
import torch

import kubernetes_tpu  # noqa: F401  (x64 before any jnp array)
from kubernetes_tpu.parallel.sharding import make_mesh as jmake_mesh

from _torch_parity import private_jax_compiles  # noqa: F401
from kubernetes_tpu_torch import scheduler as tsched_mod
from kubernetes_tpu_torch.api.types import ObjectMeta, PodGroup, Workload
from kubernetes_tpu_torch.backend.apiserver import APIServer as TApi
from kubernetes_tpu_torch.config import KubeSchedulerConfiguration
from kubernetes_tpu_torch.parallel import sharding as ts
from kubernetes_tpu_torch.scheduler import Scheduler as TSched
from kubernetes_tpu_torch.testing import wrappers as tw
from test_torch_preemption import FakeClock
from test_torch_scheduler import JAX, TORCH, _create_pods, _outcome

torch.set_num_threads(1)

ZONE = "topology.kubernetes.io/zone"
SHARDED = ("run_uniform_sharded", "run_batch_sharded",
           "cluster_probe_sharded")
SINGLE = ("run_uniform", "run_batch", "cluster_probe")


def _pkg(base, D):
    """(wrappers, APIServer, Scheduler, kwargs) of one package on a mesh
    of D shards (D = 0: the port's single-device Scheduler)."""
    w, Api, Sched, kw = base
    if base is JAX:
        return (w, Api, Sched, {"mesh": jmake_mesh(D)})
    if D == 0:
        return base
    return (w, Api, Sched, {"mesh": ts.make_mesh(devices=["cpu"] * D)})


def _sched(pkg, api, batch_size, clock=None):
    _w, _Api, Sched, kw = pkg
    sched = Sched(api, batch_size=batch_size, clock=clock or (lambda: 1000.0),
                  **kw)
    if Sched is JAX[2]:
        sched.profiler = None
        sched.audit = None
        sched._probe_enabled = False
        sched.shard_profile_auto = False
    return sched


@pytest.fixture
def spies(monkeypatch):
    """Call counts of the scheduler's sharded entry points, of their
    single-device twins, and of the dirty-row upload onto the shards."""
    calls = {k: 0 for k in SHARDED + SINGLE + ("scatter_rows_sharded",)}

    def spy(mod, name):
        fn = getattr(mod, name)

        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)

        monkeypatch.setattr(mod, name, wrapped)

    for name in SHARDED + SINGLE:
        spy(tsched_mod, name)
    spy(ts, "scatter_rows_sharded")
    return calls


def _nodes(w, n, soft_taints=False):
    """Heterogeneous along the node axis: capacities, zones, an ssd band,
    images on every fifth node; a PreferNoSchedule band when asked."""
    out = []
    for i in range(n):
        nd = (w.make_node(f"n{i}")
              .capacity({"cpu": 4 + (i * 7) % 13,
                         "memory": f"{8 + (i * 5) % 24}Gi", "pods": 110})
              .zone(f"z{i % 3}"))
        if i % 4 == 1:
            nd = nd.label("disk", "ssd")
        if i % 5 == 0:
            nd = nd.image("nginx:1", (100 + 50 * (i % 7)) << 20)
        if soft_taints and i >= n // 2:
            nd = nd.taint("soft", "x", "PreferNoSchedule")
        out.append(nd.obj())
    return out


def _basic(pkg, n_nodes=40, n_pods=120, batch=64):
    """SchedulingBasic-like: identical pods in createPods chunks (uniform
    runs, rewinds replayed on the scan), with a node update between two
    waves (a dirty-row upload: every dirty set scatters, however large)."""
    w, Api = pkg[0], pkg[1]
    api = Api()
    sched = _sched(pkg, api, batch)
    sched.state.scatter_shift = 0
    for nd in _nodes(w, n_nodes):
        api.create_node(nd)
    sched.prime()
    pods = [w.make_pod(f"p{i}").req({"cpu": "900m", "memory": "1Gi"})
            .container({"cpu": "100m"}, image="nginx:1").obj()
            for i in range(n_pods)]
    _create_pods(api, sched, pods[:n_pods // 2], chunk=32)
    api.update_node(w.make_node("n3").capacity(
        {"cpu": 2, "memory": "8Gi", "pods": 110}).zone("z0").obj())
    _create_pods(api, sched, pods[n_pods // 2:], chunk=32)
    return api, sched


def _beyond_lattice(pkg, n_nodes=32, n_pods=80, batch=128):
    """More distinct signatures in one drain than the plan program's
    lattice (PLAN_MAX_SIGS = 32): the drain rides the scan."""
    w, Api = pkg[0], pkg[1]
    api = Api()
    sched = _sched(pkg, api, batch)
    for nd in _nodes(w, n_nodes, soft_taints=True):
        api.create_node(nd)
    sched.prime()
    pods = []
    for i in range(n_pods):
        s = i % 40
        pw = w.make_pod(f"b{i}").req({"cpu": f"{100 + 25 * s}m",
                                      "memory": f"{128 + 64 * (s % 7)}Mi"})
        if s % 3 == 0:
            pw = pw.preferred_node_affinity_in("disk", ["ssd"], 5)
        pods.append(pw.obj())
    api.create_pods(pods)
    sched.schedule_pending()
    return api, sched


@pytest.mark.parametrize("D", [2, 4, 8])
def test_basic_drain_on_the_mesh(D, spies):
    want = _outcome(*_basic(_pkg(JAX, D)))
    single = _outcome(*_basic(_pkg(TORCH, 0)))
    for k in spies:
        spies[k] = 0
    api, sched = _basic(_pkg(TORCH, D))
    got = _outcome(api, sched)
    assert len(got[0]) > 100
    assert got == want == single
    assert sched.reconcile() == []
    assert spies["run_uniform_sharded"] > 0
    assert spies["cluster_probe_sharded"] == sched.device_batches
    assert spies["scatter_rows_sharded"] > 0
    assert sched.state.rows_scattered_total > 0
    assert all(spies[k] == 0 for k in SINGLE)


def test_beyond_lattice_drain_on_the_mesh(spies):
    want = _outcome(*_beyond_lattice(_pkg(JAX, 4)))
    single_api, single = _beyond_lattice(_pkg(TORCH, 0))
    for k in spies:
        spies[k] = 0
    api, sched = _beyond_lattice(_pkg(TORCH, 4))
    got = _outcome(api, sched)
    assert got == want == _outcome(single_api, single)
    assert spies["run_batch_sharded"] > 0
    assert all(spies[k] == 0 for k in SINGLE)
    # the probe snapshot of the last drain equals the single-device one
    a, b = dict(sched._last_probe), dict(single._last_probe)
    a.pop("drainId"), b.pop("drainId")
    assert a == b


# ---------------------------------------------------------------------------
# refusals


def _mesh_sched(D=2, batch=32, **kw):
    api = TApi()
    sched = TSched(api, batch_size=batch, clock=lambda: 1000.0,
                   mesh=ts.make_mesh(devices=["cpu"] * D), **kw)
    for nd in _nodes(tw, 8):
        api.create_node(nd)
    return api, sched


def test_mesh_size_and_device_checks():
    with pytest.raises(ValueError, match="power of two"):
        TSched(TApi(), mesh=ts.make_mesh(devices=["cpu"] * 3))
    with pytest.raises(ValueError, match="first device"):
        TSched(TApi(), device="meta",
               mesh=ts.make_mesh(devices=["cpu"] * 2))
    sched = TSched(TApi(), mesh=ts.make_mesh(devices=["cpu"] * 4))
    assert sched.device.type == "cpu"
    assert sched.state.dims.nodes >= 4


def test_mesh_refuses_a_group_drain():
    api, sched = _mesh_sched()
    api.create_pod(tw.make_pod("s").req({"cpu": "100m"}).label("app", "a")
                   .spread_constraint(1, ZONE, "DoNotSchedule",
                                      {"app": "a"}).obj())
    with pytest.raises(NotImplementedError, match="run_plan_sharded"):
        sched.schedule_pending()


def test_mesh_refuses_a_plan_span():
    api, sched = _mesh_sched(batch=64)
    api.create_pods([tw.make_pod(f"m{i}").req(
        {"cpu": f"{100 + 100 * (i % 4)}m"}).obj() for i in range(32)])
    with pytest.raises(NotImplementedError, match="run_plan_sharded"):
        sched.schedule_pending()


def test_mesh_refuses_a_gang_drain():
    api, sched = _mesh_sched()
    api.create_workload(Workload(metadata=ObjectMeta(name="train"),
                                 pod_groups=[PodGroup(name="workers",
                                                      min_count=4)]))
    api.create_pods([tw.make_pod(f"t{i}").req({"cpu": "100m"})
                     .workload("train").obj() for i in range(4)])
    with pytest.raises(NotImplementedError, match="run_gang_sharded"):
        sched.schedule_pending()


def test_mesh_refuses_the_rails_gate():
    with pytest.raises(NotImplementedError, match="SanitizerRails"):
        _mesh_sched(config=KubeSchedulerConfiguration(
            feature_gates={"SanitizerRails": True}))


def _preempt(pkg):
    w, Api = pkg[0], pkg[1]
    api = Api()
    clock = FakeClock()
    sched = _sched(pkg, api, 64, clock=clock)
    sched.UNIFORM_RUN_MIN = 10 ** 9
    for i in range(4):
        api.create_node(w.make_node(f"n{i}").capacity(
            {"cpu": 4, "memory": "16Gi", "pods": 110}).obj())
    api.create_pods([w.make_pod(f"low{i}").req(
        {"cpu": "3", "memory": "1Gi"}).priority(i % 2).obj()
        for i in range(4)])
    sched.schedule_pending()
    api.create_pod(w.make_pod("vip").req({"cpu": "4", "memory": "1Gi"})
                   .priority(100).obj())
    sched.schedule_pending()
    noms = {uid: p.status.nominated_node_name
            for uid, p in api.pods.items() if p.status.nominated_node_name}
    return api, sched, clock, (_outcome(api, sched), noms, sorted(api.pods))


def test_mesh_dry_run_picks_the_jax_victims():
    _api, _jsched, _c, want = _preempt(_pkg(JAX, 2))
    api, sched, clock, got = _preempt(_pkg(TORCH, 2))
    assert got == want
    assert got[1]            # a nomination, and a victim gone
    assert len(got[2]) == 4
    ev = next(p for p in sched.profiles.values()).framework
    dp = next(p for p in ev.plugins if p.name() == "DefaultPreemption")
    assert dp._evaluator.batched_dry_runs > 0
    # with the nomination pending, the next drain needs the host path
    clock.t += 15.0
    sched.flush_queues()
    with pytest.raises(NotImplementedError, match="host scheduling path"):
        sched.schedule_pending()
