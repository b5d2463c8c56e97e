"""utils/tracing.py and utils/runtime.py: the port ↔ the JAX package.

The same span program runs under both packages' Tracer with one injected
clock: the span trees (names, start times, durations, attributes,
children), the slow-cycle ring, the retained history, the breakdown text
and the Chrome-trace export must be equal. PhaseTrack pushes and pops the
same stack. scheduling_gc_pause leaves the collector as it found it.
Through the schedulers, one drain opens the JAX package's host spans in
the same tree."""

import gc
import json

import pytest
import torch

import kubernetes_tpu  # noqa: F401
from kubernetes_tpu.backend.apiserver import APIServer as JApi
from kubernetes_tpu.scheduler import Scheduler as JSched
from kubernetes_tpu.testing import wrappers as jw
from kubernetes_tpu.utils import runtime as jrt
from kubernetes_tpu.utils import tracing as jtr

from _torch_parity import private_jax_compiles  # noqa: F401
from kubernetes_tpu_torch.backend.apiserver import APIServer as TApi
from kubernetes_tpu_torch.scheduler import Scheduler as TSched
from kubernetes_tpu_torch.testing import wrappers as tw
from kubernetes_tpu_torch.utils import runtime as trt
from kubernetes_tpu_torch.utils import tracing as ttr

torch.set_num_threads(1)


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        self.t += 0.125
        return self.t


def _program(mod, keep_recent):
    slow = []
    tracer = mod.Tracer(slow_threshold_s=1.0, keep=2,
                        on_slow=slow.append, clock=_Clock(),
                        keep_recent=keep_recent)
    for i in range(4):
        with tracer.span("scheduling_cycle", pods=i) as cyc:
            with tracer.span("host_build", drain=i):
                with tracer.span("host_tensorize", cached=False):
                    pass
                for _ in range(i):
                    with tracer.span("host_snapshot"):
                        pass
            with tracer.span("device_dispatch", runs="uniform") as ds:
                ds.set(batch_bucket=64)
            cyc.set(bound=i * 2)
    return tracer, slow


def _tree(sp):
    return (sp.name, sp.start, sp.duration_s, sp.attributes,
            [_tree(c) for c in sp.children])


@pytest.mark.parametrize("keep_recent", [0, 3, 16])
def test_tracer_matches_the_jax_tracer(keep_recent, tmp_path):
    jt, jslow = _program(jtr, keep_recent)
    tt, tslow = _program(ttr, keep_recent)
    assert [_tree(s) for s in tt.slow_cycles] == \
        [_tree(s) for s in jt.slow_cycles]
    assert [_tree(s) for s in tslow] == [_tree(s) for s in jslow]
    assert len(tslow) == 3            # the cycles with a host_snapshot
    assert tt.keep_recent == jt.keep_recent
    if keep_recent:
        assert [_tree(s) for s in tt.recent] == \
            [_tree(s) for s in jt.recent]
    spans = list(tt.recent if keep_recent else tt.slow_cycles)
    assert [s.breakdown() for s in spans] == [
        s.breakdown() for s in (jt.recent if keep_recent
                                else jt.slow_cycles)]
    assert [s.to_dict() for s in spans] == [
        s.to_dict() for s in (jt.recent if keep_recent
                              else jt.slow_cycles)]
    assert ttr.to_chrome_trace(spans) == jtr.to_chrome_trace(
        list(jt.recent if keep_recent else jt.slow_cycles))
    pj, pt = tmp_path / "j.json", tmp_path / "t.json"
    assert tt.export_chrome_trace(str(pt)) == jt.export_chrome_trace(str(pj))
    assert json.loads(pt.read_text()) == json.loads(pj.read_text())
    assert spans[-1].find("host_tensorize") is not None
    assert spans[-1].find("nope") is None


def test_span_seconds_sums_the_trees():
    tt, _ = _program(ttr, 16)
    got = ttr.span_seconds(tt.recent)
    assert got["host_tensorize"] == pytest.approx(4 * 0.125)
    assert got["host_snapshot"] == pytest.approx(6 * 0.125)
    assert set(got) == {"scheduling_cycle", "host_build", "host_tensorize",
                        "host_snapshot", "device_dispatch"}


def test_noop_tracer_and_phase_track():
    assert ttr.NOOP_TRACER.keep_recent == jtr.NOOP_TRACER.keep_recent == 0
    with ttr.NOOP_TRACER.span("x", a=1) as sp:
        sp.set(b=2)
    seen = {}
    for mod in (jtr, ttr):
        pt = mod.PhaseTrack()
        out = [pt.current()]
        pt.push("host_build")
        with pt.scope("host_cache"):
            out.append(pt.current())
        out.append(pt.current())
        pt.pop()
        pt.pop()
        out.append(pt.current())
        seen[mod] = out
    assert seen[ttr] == seen[jtr] == ["", "host_cache", "host_build", ""]


@pytest.mark.parametrize("enabled", [True, False])
def test_scheduling_gc_pause_restores_the_collector(enabled):
    was = gc.isenabled()
    try:
        (gc.enable if enabled else gc.disable)()
        for mod in (jrt, trt):
            with mod.scheduling_gc_pause():
                assert not gc.isenabled()
                with mod.scheduling_gc_pause():
                    assert not gc.isenabled()
                assert not gc.isenabled()
            assert gc.isenabled() == enabled
            assert mod.opportunistic_collect(max_seconds=60.0) is False
    finally:
        (gc.enable if was else gc.disable)()


def test_profiler_session_off_is_a_noop(tmp_path):
    with ttr.torch_profiler_session(""):
        pass
    with ttr.torch_profiler_session(str(tmp_path / "prof")):
        torch.ones(4).sum()
    assert (tmp_path / "prof" / "torch_profile.trace.json").exists()


def _names(sp):
    return (sp.name, [_names(c) for c in sp.children])


def _drain(w, Api, Sched, tracer_mod, **kw):
    api = Api()
    tracer = tracer_mod.Tracer(slow_threshold_s=float("inf"),
                               keep_recent=64)
    sched = Sched(api, batch_size=32, clock=lambda: 1000.0, tracer=tracer,
                  **kw)
    if Sched is JSched:
        sched.profiler = None
        sched.audit = None
    for i in range(6):
        api.create_node(w.make_node(f"n{i}").capacity(
            {"cpu": 8, "memory": "16Gi", "pods": 110}).zone(
            f"z{i % 2}").obj())
    sched.prime()
    api.create_pods([w.make_pod(f"p{i}").req({"cpu": "1"}).obj()
                     for i in range(20)])
    sched.schedule_pending()
    return [_names(s) for s in tracer.recent]


def test_drain_spans_match_the_jax_scheduler():
    j = _drain(jw, JApi, JSched, jtr)
    t = _drain(tw, TApi, TSched, ttr, device="cpu")

    def strip(tree):
        # the JAX package's kernel-observatory lane events hang under
        # device_dispatch; the port has no observatory yet
        name, kids = tree
        if name == "device_dispatch":
            kids = []
        return (name, [strip(k) for k in kids])

    assert [strip(x) for x in t] == [strip(x) for x in j]
    assert t[0][0] == "scheduling_cycle"


def test_every_commit_is_timed_onto_its_dispatch_span():
    """Each drain's commit records its start and seconds on the drain's
    device_dispatch span, the same seconds `drain_phase_seconds` sums."""
    api = TApi()
    tracer = ttr.Tracer(slow_threshold_s=float("inf"), keep_recent=64)
    sched = TSched(api, batch_size=8, clock=lambda: 1000.0, tracer=tracer,
                   device="cpu")
    for i in range(4):
        api.create_node(tw.make_node(f"n{i}").capacity(
            {"cpu": 8, "memory": "16Gi", "pods": 110}).obj())
    sched.prime()
    api.create_pods([tw.make_pod(f"p{i}").req({"cpu": "1"}).obj()
                     for i in range(20)])
    sched.schedule_pending()
    spans, stack = [], list(tracer.recent)
    while stack:
        sp = stack.pop()
        if sp.name == "device_dispatch":
            spans.append(sp)
        stack.extend(sp.children)
    assert len(spans) == sched.device_batches >= 2
    for sp in spans:
        assert sp.attributes["commit_start"] >= sp.start
        assert sp.attributes["commit_s"] >= 0.0
    assert sum(sp.attributes["commit_s"] for sp in spans) == pytest.approx(
        sched.drain_phase_seconds["commit"], rel=1e-9)
