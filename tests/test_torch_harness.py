"""The perf harness: kubernetes_tpu.perf.harness ↔
kubernetes_tpu_torch.perf.harness (device="cpu"), exact equality.

Each of the nine workloads the port runs on the card (SchedulingBasic,
SchedulingNodeAffinity, TopologySpreading, SchedulingPodAntiAffinity,
MixedSchedulingBasePod, MixedHighSignature, PreemptionChurn,
GangTraining, CoLocatedInference) is read from the JAX package's
performance-config.yaml by each package's own loader, cut to a small
width (24 nodes: one node bucket, so the JAX programs compile once per
shape for the whole file) and run through both harnesses' WorkloadRunner
under a fixed clock. Both must end with the same bind map, the same
pending pods and the same cluster-probe snapshot (`_last_probe`, the
probe of the last device drain, resolved at its commit)."""

import os

import pytest
import torch

import kubernetes_tpu  # noqa: F401  (x64 before any jnp array)
from kubernetes_tpu.perf import harness as jh
from kubernetes_tpu.scheduler import Scheduler as JSched

from _torch_parity import private_jax_compiles  # noqa: F401
from kubernetes_tpu_torch.perf import harness as th
from kubernetes_tpu_torch.scheduler import Scheduler as TSched
from kubernetes_tpu_torch.utils.tracing import Tracer, span_seconds

torch.set_num_threads(1)

CONFIG = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "kubernetes_tpu", "perf", "configs",
    "performance-config.yaml")

# (case, small params): 24 nodes each
SMALL = {
    "SchedulingBasic": dict(initNodes=24, initPods=20, measurePods=60),
    "SchedulingNodeAffinity": dict(initNodes=24, measurePods=40),
    "TopologySpreading": dict(initNodes=24, initPods=10, measurePods=40),
    "SchedulingPodAntiAffinity": dict(initNodes=24, initPods=4,
                                      measurePods=12, zones=1000),
    "MixedSchedulingBasePod": dict(initNodes=24, initPods=10,
                                   initAffinityPods=6, measurePods=30),
    "MixedHighSignature": dict(initNodes=24, initPods=10, measurePods=40),
    "PreemptionChurn": dict(nodeCpu=8, initNodes=24, initPods=24,
                            preemptors=3, measurePods=40),
    "GangTraining": dict(initNodes=24, gangs=3, gangSize=16),
    "CoLocatedInference": dict(initNodes=24, gangs=2, gangSize=16,
                               inferencePods=40, preemptorGangs=1),
}
BATCH = 64


def _clock():
    return 1000.0


def _case(mod, name):
    tc = next(c for c in mod.load_test_cases(CONFIG) if c.name == name)
    return tc, mod.Workload(name="small", params=dict(SMALL[name]))


def _outcome(runner):
    sched = runner.last_scheduler
    api = sched.client
    binds = {uid: p.spec.node_name for uid, p in api.pods.items()
             if p.spec.node_name}
    pending = sorted(p.uid for p in sched.queue.pending_pods()[0])
    return binds, pending, sched._last_probe


def _jax_factory(api):
    sched = JSched(api, batch_size=BATCH, clock=_clock)
    # the sampling profiler thread and the shadow audit never change a
    # decision, and load the cores the parallel test workers share
    sched.profiler = None
    sched.audit = None
    return sched


def _port_factory(api):
    return TSched(api, batch_size=BATCH, clock=_clock, device="cpu",
                  tracer=Tracer(slow_threshold_s=float("inf"),
                                keep_recent=4096))


@pytest.mark.parametrize("name", sorted(SMALL))
def test_workload_matches_the_jax_harness(name):
    jtc, jwl = _case(jh, name)
    ttc, twl = _case(th, name)
    assert [op["opcode"] for op in ttc.workload_template] == [
        op["opcode"] for op in jtc.workload_template]
    jr = jh.WorkloadRunner(scheduler_factory=_jax_factory, batch_size=BATCH)
    tr = th.WorkloadRunner(scheduler_factory=_port_factory,
                           batch_size=BATCH)
    jitems = jr.run(jtc, jwl)
    titems = tr.run(ttc, twl)
    jout, tout = _outcome(jr), _outcome(tr)
    assert tout[0] == jout[0], "bind map"
    assert tout[1] == jout[1], "pending pods"
    assert tout[2] is not None and tout[2] == jout[2], "cluster probe"
    assert [i.pods for i in titems] == [i.pods for i in jitems]
    # the measured window's host split: every span the drain opens
    spans = span_seconds(tr.last_scheduler.tracer.recent)
    for k in ("scheduling_cycle", "host_build", "host_tensorize",
              "host_cache", "device_dispatch", "cluster_probe"):
        assert spans.get(k, 0.0) > 0.0, k
    phases = tr.last_scheduler.drain_phase_seconds
    for k in ("host_build", "device_dispatch", "device_wait", "commit"):
        assert phases.get(k, 0.0) > 0.0, k
    assert titems[0].extras["commit_s"] == round(phases["commit"], 3)


def test_stream_opcodes_name_the_pipeline():
    tc = th.TestCase(name="S", workload_template=[
        {"opcode": "createNodes", "count": 4},
        {"opcode": "streamPods", "count": 8}], workloads=[])
    runner = th.WorkloadRunner(scheduler_factory=_port_factory)
    with pytest.raises(NotImplementedError, match="pipeline"):
        runner.run(tc, th.Workload(name="w", params={}))


def test_measured_window_pauses_the_collector():
    import gc
    seen = []

    class Probe:
        def __init__(self, api):
            self.s = _port_factory(api)

        def __getattr__(self, k):
            seen.append(gc.isenabled())
            return getattr(self.s, k)

    tc = th.TestCase(name="G", workload_template=[
        {"opcode": "createNodes", "count": 4},
        {"opcode": "createPods", "count": 8, "collectMetrics": True}],
        workloads=[])
    assert gc.isenabled()
    th.WorkloadRunner(scheduler_factory=Probe).run(
        tc, th.Workload(name="w", params={}))
    assert seen and not any(seen)
    assert gc.isenabled()


def test_chip_smoke_cells_equal_the_config():
    """chip_smoke.py writes its cells out (the card's machine has no
    pyyaml): each must be the parsed test case's template and its
    full-width workload's params and threshold."""
    import importlib.util

    import yaml
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(CONFIG), "..", "..", "..",
                                   "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    with open(CONFIG) as f:
        raw = {tc["name"]: tc for tc in yaml.safe_load(f)}
    assert set(smoke.CELLS) == set(SMALL)
    for name, cell in smoke.CELLS.items():
        tc = raw[name]
        assert cell["template"] == tc["workloadTemplate"], name
        assert tc.get("defaultPodTemplate") is None, name
        wl = next(w for w in tc["workloads"] if w["name"] == cell["workload"])
        assert cell["params"] == wl["params"], name
        assert cell["threshold"] == wl.get("threshold"), name
