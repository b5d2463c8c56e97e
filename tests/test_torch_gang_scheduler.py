"""Gangs end to end: kubernetes_tpu.Scheduler ↔
kubernetes_tpu_torch.Scheduler(device="cpu"), exact equality.

Each case runs one gang workload — built twice, once from each package's
own testing wrappers and API types — under a controlled clock through
both schedulers, and compares what a user sees: the bind map, the pending
pods, the PodScheduled condition each pod was patched with (the
FailedScheduling message), the nominations, the deleted victims, the
pods parked at Permit, and the gang drains by outcome (the port's
`gang_dispatch` counters against the JAX package's `gang_dispatch`
metric). The cases are those of tests/test_gang_device.py and
tests/test_gangscheduling.py: one accepted dispatch with no Permit, a
rejected gang that holds nothing, minCount below the gang size, a
host-port gang that falls back to the Permit barrier, a gang split
across two create chunks, a Workload created after its pods, a Permit
timeout, contiguity packing, a seeded multi-gang fuzz, a gang that
preempts a gang, a closed-form gang replayed on the scan tier, and the
GangWorkloadGenerator's traces; one more case checks that the port still
refuses a profile with PreBind or other Reserve / Permit plugins."""

import random

import pytest
import torch

import kubernetes_tpu  # noqa: F401  (x64 before any jnp array)
from _torch_parity import private_jax_compiles  # noqa: F401
from kubernetes_tpu.api import types as jtypes
from kubernetes_tpu.backend.apiserver import APIServer as JApi
from kubernetes_tpu.scheduler import Scheduler as JSched
from kubernetes_tpu.testing import workloads as jwl
from kubernetes_tpu.testing import wrappers as jw
from kubernetes_tpu_torch.api import types as ttypes
from kubernetes_tpu_torch.backend.apiserver import APIServer as TApi
from kubernetes_tpu_torch.scheduler import Scheduler as TSched
from kubernetes_tpu_torch.testing import workloads as twl
from kubernetes_tpu_torch.testing import wrappers as tw

torch.set_num_threads(1)

JAX = (jw, JApi, JSched, jtypes, {})
TORCH = (tw, TApi, TSched, ttypes, {"device": "cpu"})


class Clock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


class Run:
    """One package's cluster, scheduler and clock."""

    def __init__(self, pkg, batch_size=64, contig=0):
        self.w, Api, Sched, self.types, kw = pkg
        self.api = Api()
        self.clock = Clock()
        self.sched = Sched(self.api, batch_size=batch_size,
                           clock=self.clock, **kw)
        if Sched is JSched:
            # off the decision path: the sampling profiler, the shadow
            # audit and the cluster probe
            self.sched.profiler = None
            self.sched.audit = None
            self.sched._probe_enabled = False
        self.sched.dispatcher.sleep = lambda _s: None
        self.sched.gang_contiguity_weight = contig
        self.jax = Sched is JSched

    def nodes(self, n, cpu, zones=0):
        for i in range(n):
            b = self.w.make_node(f"n{i}").capacity(
                {"cpu": cpu, "memory": "32Gi", "pods": 110})
            if zones:
                b = b.zone(f"z{i % zones}")
            self.api.create_node(b.obj())

    def workload(self, name, min_count):
        t = self.types
        self.api.create_workload(t.Workload(
            metadata=t.ObjectMeta(name=name),
            pod_groups=[t.PodGroup(name="workers", min_count=min_count)]))

    def member(self, name, ref, cpu="1", priority=0, port=0):
        b = (self.w.make_pod(name).req({"cpu": cpu, "memory": "1Gi"})
             .workload(ref).priority(priority))
        if port:
            b = b.host_port(port)
        return b.obj()

    def gang(self, name, size, min_count, cpu="1", priority=0, port=0):
        self.workload(name, min_count)
        for i in range(size):
            self.api.create_pod(self.member(
                f"{name}-{i}", name, cpu, priority,
                port=port and port + i))

    def settle(self, rounds=6, step=400.0):
        """Drive to a fixed point: expired Permit deadlines sweep,
        backoffs and unschedulable leftovers flush, rejected gangs
        retry."""
        self.sched.schedule_pending()
        for _ in range(rounds):
            self.clock.t += step
            self.sched.flush_queues()
            self.sched.schedule_pending()

    def gang_dispatch(self):
        if self.jax:
            m = self.sched.metrics.gang_dispatch
            return {k: int(m.value(k))
                    for k in ("placed", "rejected", "fallback")}
        return dict(self.sched.gang_dispatch)

    def outcome(self):
        pods = self.api.pods
        binds = {u: p.spec.node_name for u, p in pods.items()
                 if p.spec.node_name}
        pending = sorted(p.uid for p in self.sched.queue.pending_pods()[0])
        conditions = {u: [(c.get("reason"), c.get("message"))
                          for c in p.status.conditions]
                      for u, p in pods.items()}
        noms = {u: p.status.nominated_node_name for u, p in pods.items()
                if p.status.nominated_node_name}
        return dict(binds=binds, pending=pending, pods=sorted(pods),
                    conditions=conditions, nominations=noms,
                    waiting=sorted(self.sched._waiting_pods),
                    gang_dispatch=self.gang_dispatch(),
                    preemption_attempts=self.sched.preemption_attempts)


def both(scenario, **kw):
    """Run `scenario(run)` through both packages; assert equal outcomes
    and return the port's run."""
    outs, runs = [], []
    for pkg in (JAX, TORCH):
        r = Run(pkg, **kw)
        scenario(r)
        outs.append(r.outcome())
        runs.append(r)
    for k in outs[0]:
        assert outs[1][k] == outs[0][k], k
    assert runs[1].sched.reconcile() == []
    return runs[1], outs[1]


def test_accept_is_one_dispatch_no_permit():
    def sc(r):
        r.nodes(8, cpu=8)
        r.gang("train", size=12, min_count=12)
        assert r.sched.schedule_pending() == 12
    run, out = both(sc)
    assert out["gang_dispatch"] == {"placed": 1, "rejected": 0,
                                    "fallback": 0}
    assert len(out["binds"]) == 12 and not out["waiting"]
    assert run.sched.device_batches == 1


def test_reject_is_atomic_and_holds_nothing():
    def sc(r):
        r.nodes(2, cpu=1)
        r.gang("train", size=3, min_count=3)
        assert r.sched.schedule_pending() == 0
        assert not r.sched.cache.assumed_pods
        # freed capacity is immediately usable
        r.api.create_pod(r.w.make_pod("plain").req(
            {"cpu": "1", "memory": "1Gi"}).obj())
        assert r.sched.schedule_pending() == 1
    run, out = both(sc)
    assert out["gang_dispatch"]["rejected"] == 1
    msgs = [m for c in out["conditions"].values() for _r, m in c]
    assert any("Insufficient cpu" in m for m in msgs), msgs
    assert any("gang 'train' rejected: 2 of 3" in m for m in msgs), msgs


def test_min_count_partial_accept():
    def sc(r):
        r.nodes(3, cpu=1)
        r.gang("train", size=5, min_count=3)
        assert r.sched.schedule_pending() == 3
    _run, out = both(sc)
    assert out["gang_dispatch"]["placed"] == 1
    assert len(out["pending"]) == 2


def test_host_port_gang_falls_back_and_binds_through_permit():
    def sc(r):
        r.nodes(4, cpu=8)
        r.gang("svc", size=3, min_count=3, port=8000)
        assert r.sched.schedule_pending() == 3
    run, out = both(sc)
    assert out["gang_dispatch"]["fallback"] >= 1
    assert out["gang_dispatch"]["placed"] == 0
    assert len(out["binds"]) == 3 and not out["waiting"]


def test_gang_split_across_create_chunks():
    """The harness's createPods shape: a 12-member gang arrives in chunks
    of 8, each followed by a non-blocking schedule_pending; the first
    chunk stays gated below quorum, the second un-gates it."""
    def sc(r):
        r.nodes(6, cpu=4, zones=3)
        r.workload("train", 12)
        r.workload("other", 4)
        pods = [r.member(f"train-{i}", "train") for i in range(12)]
        pods += [r.member(f"other-{i}", "other", cpu="2") for i in range(4)]
        for k in range(0, len(pods), 8):
            r.api.create_pods(pods[k:k + 8])
            r.sched.schedule_pending(wait=False)
        r.sched.schedule_pending()
    _run, out = both(sc)
    assert len(out["binds"]) == 16
    assert out["gang_dispatch"]["placed"] == 2


def test_workload_created_after_its_pods():
    def sc(r):
        r.nodes(4, cpu=4)
        for i in range(4):
            r.api.create_pod(r.member(f"late-{i}", "late"))
        assert r.sched.schedule_pending() == 0
        assert r.sched.queue.gated_refs() == {"late"}
        r.workload("late", 4)
        assert r.sched.schedule_pending() == 4
    _run, out = both(sc)
    assert out["gang_dispatch"]["placed"] == 1


def test_permit_timeout_rejects_parked_members():
    """A host-port gang (the Permit barrier) of 4 on 3 one-cpu nodes: three
    members park at Permit holding their nodes, the fourth fails; the
    timeout sweep rejects the parked ones and frees their nodes."""
    def sc(r):
        r.nodes(3, cpu=1)
        r.gang("svc", size=4, min_count=4, port=9000)
        r.sched.schedule_pending()
        assert len(r.sched._waiting_pods) == 3
        r.clock.t += 301.0
        r.sched.flush_queues()
        assert not r.sched._waiting_pods
        assert not r.sched.cache.assumed_pods
        # the freed nodes take a plain pod at once
        r.api.create_pod(r.w.make_pod("plain").req(
            {"cpu": "1", "memory": "1Gi"}).obj())
        assert r.sched.schedule_pending() == 1
    _run, out = both(sc)
    assert not out["waiting"] and len(out["binds"]) == 1


def test_contiguity_packs_topology_domains():
    def sc(r):
        r.nodes(16, cpu=2, zones=4)
        r.gang("train", size=8, min_count=8)
        assert r.sched.schedule_pending() == 8
    zones = []
    for contig in (0, 8):
        _run, out = both(sc, contig=contig)
        zones.append({int(n[1:]) % 4 for n in out["binds"].values()})
    assert len(zones[1]) < len(zones[0]) and len(zones[1]) == 1


def _fuzz_scenario(rng):
    n_nodes = rng.randint(3, 16)
    cpu = rng.randint(2, 8)
    bound = [(f"pre-{i}", f"n{rng.randrange(n_nodes)}",
              rng.randint(1, max(cpu // 2, 1)))
             for i in range(rng.randint(0, n_nodes))]
    gangs = []
    for g in range(rng.randint(1, 3)):
        size = rng.randint(2, 8)
        gangs.append((f"gang{g}", size, rng.randint(1, size),
                      rng.randint(1, 3)))
    return n_nodes, cpu, bound, gangs


@pytest.mark.parametrize("seed", range(8))
def test_multi_gang_fuzz(seed):
    rng = random.Random(3000 + seed)
    n_nodes, cpu, bound, gangs = _fuzz_scenario(rng)
    contig = rng.choice([0, 0, 2])

    def sc(r):
        r.nodes(n_nodes, cpu=cpu, zones=rng_zones)
        for name, node, c in bound:
            r.api.create_pod(r.w.make_pod(name).req(
                {"cpu": c, "memory": "1Gi"}).node(node).obj())
        for name, size, min_count, c in gangs:
            r.gang(name, size, min_count, cpu=str(c))
        r.settle()
    rng_zones = rng.choice([0, 2, 3])
    both(sc, contig=contig)


def test_gang_preempts_gang():
    """A priority-100 gang needing whole nodes on a cluster a priority-0
    gang fills: the rejected gang's infeasible members run the PostFilter,
    evict low members and land."""
    def sc(r):
        r.nodes(3, cpu=4)
        r.gang("low", size=6, min_count=6, cpu="2")
        r.settle(rounds=2)
        assert len([p for p in r.api.pods.values() if p.spec.node_name]) == 6
        r.gang("high", size=3, min_count=3, cpu="4", priority=100)
        r.settle(rounds=8)
    _run, out = both(sc)
    high = [u for u in out["binds"] if u.startswith("default/high-")]
    assert len(high) == 3
    assert out["preemption_attempts"] > 0


def test_workload_generator_trace_matches():
    """GangWorkloadGenerator: the same seed gives the same specs, names,
    member specs and arrival order in both packages."""
    def trace(mod):
        gen = mod.GangWorkloadGenerator(seed=7)
        specs = gen.training_gangs(3, size=(8, 64), min_count_frac=0.75,
                                   priority=10)
        pre = gen.training_gangs(1, size=4, cpu="2", priority=200,
                                 prefix="preemptor")
        out = [(s.name, s.size, s.min_count, s.cpu, s.memory, s.priority)
               for s in specs + pre]
        for kind, obj in gen.trace(specs, inference_count=20,
                                   preemptor_gangs=pre, chunk=16):
            if kind == "workload":
                out.append(("workload", obj.metadata.name,
                            [(g.name, g.min_count) for g in obj.pod_groups]))
            else:
                out.append(("pods", [(p.metadata.name, p.uid,
                                      p.spec.workload_ref, p.spec.priority,
                                      dict(p.spec.containers[0].requests))
                                     for p in obj]))
        return out
    got, want = trace(twl), trace(jwl)
    assert got == want
    assert sum(len(x[1]) for x in got if x[0] == "pods") > 20


def test_trace_workload_end_to_end():
    """A small CoLocatedInference-shaped trace (training gangs, inference
    pods, preemptor gangs, contiguity on) through both schedulers in
    512-pod chunks, as the harness's gangTrace op drives it."""
    def sc(r):
        mod = twl if not r.jax else jwl
        r.nodes(40, cpu=32, zones=4)
        gen = mod.GangWorkloadGenerator(seed=0)
        specs = gen.training_gangs(4, size=32, cpu="1", priority=10)
        pre = gen.training_gangs(1, size=8, cpu="2", priority=200,
                                 prefix="preemptor")
        for kind, obj in gen.trace(specs, inference_count=100,
                                   inference_cpu="250m",
                                   inference_priority=100,
                                   preemptor_gangs=pre, chunk=64):
            if kind == "workload":
                r.api.create_workload(obj)
                continue
            r.api.create_pods(obj)
            r.sched.schedule_pending(wait=False)
        r.sched.schedule_pending()
    _run, out = both(sc, batch_size=256, contig=2)
    assert len(out["binds"]) == 4 * 32 + 100 + 8 and not out["pending"]
    assert out["gang_dispatch"] == {"placed": 5, "rejected": 0,
                                    "fallback": 0}


def test_closed_form_replays_on_scan_tier():
    """A closed-form gang run whose depth flag fails (16 members, one
    node: every member lands on the only candidate) is replayed on the
    scan tier from the kept input carry, and the plain pod dispatched
    behind it in the same call is re-chained."""
    def sc(r):
        r.nodes(1, cpu=20)
        r.gang("train", size=16, min_count=16)
        r.api.create_pod(r.w.make_pod("after").req(
            {"cpu": "100m", "memory": "1Gi"}).obj())
        r.sched.schedule_pending()
    run, out = both(sc)
    assert run.sched.gang_replays == 1
    assert out["gang_dispatch"]["placed"] == 1
    assert len(out["binds"]) == 17


def test_profile_refusals_keep_naming_the_missing_piece():
    """GangScheduling is the one Reserve / Permit plugin the port takes: a
    profile with another Reserve plugin or any PreBind plugin still raises
    NotImplementedError naming it."""
    from kubernetes_tpu_torch.framework.runtime import Framework
    from kubernetes_tpu_torch.scheduler import (DEFAULT_WEIGHTS, Profile,
                                                default_plugins)

    class VolumeLike:
        def name(self):
            return "VolumeLike"

        def reserve(self, state, pod, node_name):
            raise AssertionError("never called")

    class Binder:
        def name(self):
            return "BinderLike"

        def pre_bind(self, state, pod, node_name):
            raise AssertionError("never called")

    for extra, named in ((VolumeLike(), "VolumeLike"),
                         (Binder(), "BinderLike")):
        api = TApi()
        fwk = Framework("default-scheduler",
                        default_plugins(api) + [extra],
                        weights=dict(DEFAULT_WEIGHTS))
        with pytest.raises(NotImplementedError, match=named):
            TSched(api, profiles=[Profile(framework=fwk)], device="cpu")
    # the default profile carries GangScheduling and is accepted
    sched = TSched(TApi(), device="cpu")
    fwk = sched.profiles["default-scheduler"].framework
    assert [p.name() for p in fwk.reserve_plugins] == ["GangScheduling"]
