"""kubernetes_tpu.Scheduler ↔ kubernetes_tpu_torch.Scheduler(device="cpu").

Both packages run the same workload — built twice, once from each
package's own testing wrappers, from the same seed — under a fixed clock,
and must end with the same bind map and the same set of pending pods
(exact equality). The port also refuses, with NotImplementedError, the
pods whose constraints it has no device form for; topology spread,
inter-pod affinity and preemption, refused before their slices were
ported, now behave as in the JAX package (the four test_refuses_* cases
below that kept their names)."""


import pytest
import torch

import kubernetes_tpu  # noqa: F401  (x64 before any jnp array)
from kubernetes_tpu.backend.apiserver import APIServer as JApi
from kubernetes_tpu.scheduler import Scheduler as JSched
from kubernetes_tpu.testing import wrappers as jw

from _torch_parity import private_jax_compiles  # noqa: F401
from kubernetes_tpu_torch.backend.apiserver import APIServer as TApi
from kubernetes_tpu_torch.scheduler import Scheduler as TSched
from kubernetes_tpu_torch.testing import wrappers as tw

LABEL_HOSTNAME = "kubernetes.io/hostname"

# small tensors: one intra-op thread keeps parallel test workers from
# oversubscribing the cores
torch.set_num_threads(1)


def _clock():
    return 1000.0


def _basic_nodes(w, n):
    """perf/harness.py _make_nodes: 32 cpu / 64 Gi / 110 pods, 16 zones."""
    return [w.make_node(f"node-{i}").capacity(
        {"cpu": 32, "memory": "64Gi", "pods": 110}).zone(
        f"zone-{i % 16}").label(LABEL_HOSTNAME, f"node-{i}").obj()
        for i in range(n)]


def _create_pods(api, sched, pods, chunk=512):
    """The harness's createPods op: chunks, each followed by a
    non-blocking schedule_pending, then a full drain."""
    for k in range(0, len(pods), chunk):
        api.create_pods(pods[k:k + chunk])
        sched.schedule_pending(wait=False)
    sched.schedule_pending()


def make_scheduler(pkg, api, batch_size):
    """A scheduler of either package. The JAX one runs without its
    sampling profiler thread, shadow audit and cluster probe: they never
    change a bind decision, and they load the CPU the parallel test
    workers share."""
    _w, _Api, Sched, kw = pkg
    sched = Sched(api, batch_size=batch_size, clock=_clock, **kw)
    if Sched is JSched:
        sched.profiler = None
        sched.audit = None
        sched._probe_enabled = False
    return sched


def _scheduling_basic(pkg, n_nodes, init_pods, measure_pods, batch_size):
    w, Api = pkg[0], pkg[1]
    api = Api()
    sched = make_scheduler(pkg, api, batch_size)
    for nd in _basic_nodes(w, n_nodes):
        api.create_node(nd)
    sched.prime()
    seq = 0
    for count in (init_pods, measure_pods):
        pods = [w.make_pod(f"pod-{seq + i}").req(
            {"cpu": "900m", "memory": "1Gi"}).obj() for i in range(count)]
        seq += count
        _create_pods(api, sched, pods)
    return api, sched


JAX = (jw, JApi, JSched, {})
TORCH = (tw, TApi, TSched, {"device": "cpu"})


def _outcome(api, sched):
    binds = {uid: p.spec.node_name for uid, p in api.pods.items()
             if p.spec.node_name}
    pending = sorted(p.uid for p in sched.queue.pending_pods()[0])
    return binds, pending


@pytest.mark.parametrize("n_nodes,init_pods,measure_pods",
                         [(50, 50, 100), (500, 500, 1000)])
def test_scheduling_basic_bind_parity(n_nodes, init_pods, measure_pods):
    jres = _outcome(*_scheduling_basic(JAX, n_nodes, init_pods,
                                       measure_pods, 8192))
    tapi, tsched = _scheduling_basic(TORCH, n_nodes, init_pods,
                                     measure_pods, 8192)
    tres = _outcome(tapi, tsched)
    assert len(tres[0]) == init_pods + measure_pods
    assert tres == jres
    assert tsched.reconcile() == []


def _refuses(build_pod, bound=None, match="not ported"):
    api = TApi()
    sched = TSched(api, batch_size=16, clock=_clock, device="cpu")
    for nd in _basic_nodes(tw, 4):
        api.create_node(nd)
    if bound is not None:
        api.create_pod(bound)
    api.create_pod(build_pod())
    with pytest.raises(NotImplementedError, match=match):
        sched.schedule_pending()


def _binds_like_jax(build_pod, bound=None):
    """One pod (and optionally one bound pod) through both schedulers on
    the 4-node cluster of `_refuses`: equal bind maps, the pod bound."""
    outs = []
    for pkg in (JAX, TORCH):
        w, Api = pkg[0], pkg[1]
        api = Api()
        sched = make_scheduler(pkg, api, 16)
        for nd in _basic_nodes(w, 4):
            api.create_node(nd)
        if bound is not None:
            api.create_pod(bound(w))
        api.create_pod(build_pod(w))
        sched.schedule_pending()
        outs.append(_outcome(api, sched))
    assert outs[1] == outs[0]
    assert not outs[1][1]
    return outs[1]


def test_refuses_topology_spread():
    """Now a bind-parity check: the group path is ported, so the pod binds
    exactly as the JAX package binds it. The name is kept on purpose."""
    _binds_like_jax(lambda w: w.make_pod("s").req({"cpu": "1"})
                    .label("app", "x")
                    .spread_constraint(1, "topology.kubernetes.io/zone",
                                       "DoNotSchedule", {"app": "x"}).obj())


def test_refuses_inter_pod_affinity():
    """Now a bind-parity check: the group path is ported, so the pod binds
    exactly as the JAX package binds it. The name is kept on purpose."""
    _binds_like_jax(lambda w: w.make_pod("a").req({"cpu": "1"})
                    .pod_affinity("topology.kubernetes.io/zone",
                                  {"app": "x"}, anti=True).obj())


def test_refuses_bound_pods_with_affinity():
    """Now a bind-parity check: the group path is ported, so the pod binds
    exactly as the JAX package binds it. The name is kept on purpose."""
    binds, _ = _binds_like_jax(
        lambda w: w.make_pod("p").req({"cpu": "1"}).label("app", "x")
        .obj(),
        bound=lambda w: w.make_pod("b").req({"cpu": "1"}).node("node-0")
        .pod_affinity("topology.kubernetes.io/zone", {"app": "x"},
                      anti=True).obj())
    # the bound pod's anti term keeps the new pod out of node-0's zone
    assert binds["default/p"] != "node-0"


def test_refuses_volumes_and_gangs():
    """Volumes are still refused. Gangs are ported, so the gang half is now
    a parity check: a member whose Workload does not exist stays gated at
    PreEnqueue in both packages, nothing binds. The name is kept on
    purpose."""
    _refuses(lambda: tw.make_pod("v").req({"cpu": "1"}).pvc("claim").obj(),
             match="volumes")
    outs = []
    for pkg in (JAX, TORCH):
        w, Api = pkg[0], pkg[1]
        api = Api()
        sched = make_scheduler(pkg, api, 16)
        for nd in _basic_nodes(w, 4):
            api.create_node(nd)
        api.create_pod(w.make_pod("g").req({"cpu": "1"})
                       .workload("train/workers").obj())
        sched.schedule_pending()
        outs.append((_outcome(api, sched), sorted(sched.queue.gated_refs())))
    assert outs[1] == outs[0]
    assert outs[1] == (({}, ["default/g"]), ["train/workers"])


def test_refuses_preemption():
    """Now a parity check: preemption is ported, so the port runs the
    PostFilter exactly as the JAX package does. A 40-cpu preemptor on
    32-cpu nodes finds no candidate in either package: it stays
    unschedulable, un-nominated, and no victim is deleted. The name is
    kept on purpose."""
    outs = []
    for pkg in (JAX, TORCH):
        w, Api = pkg[0], pkg[1]
        api = Api()
        sched = make_scheduler(pkg, api, 16)
        for nd in _basic_nodes(w, 4):
            api.create_node(nd)
        api.create_pod(w.make_pod("low").req({"cpu": "32"}).node("node-0")
                       .obj())
        api.create_pod(w.make_pod("hi").req({"cpu": "40"}).priority(100)
                       .obj())
        sched.schedule_pending()
        outs.append((_outcome(api, sched), sorted(api.pods),
                     api.pods["default/hi"].status.nominated_node_name,
                     sched.preemption_attempts))
    assert outs[1] == outs[0]
    (binds, pending), pods, nominated, attempts = outs[1]
    assert pending == ["default/hi"]
    assert pods == ["default/hi", "default/low"]
    assert nominated == "" and attempts == 0
