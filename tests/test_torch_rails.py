"""The port's runtime sanitizer rails (kubernetes_tpu_torch/analysis/
rails.py, `SanitizerRails` gate), on the CPU.

The counterpart of tests/test_sanitizer_rails.py for every rail with a
PyTorch meaning: the gate off keeps the scheduler's behaviour; the rails
observe and never steer (rails on = rails off = the JAX package's
rails-on bind map); a warm re-run fits a zero retrace budget; the NaN/inf
guard and the per-drain score probe; the held-carry check (the port's
stand-in for donation poisoning) raises on a write into a carry a
dispatched run still holds; the gate wiring. The sync guard and the
held-carry checksum act only on a CUDA device: their card halves are in
tests/test_torch_cuda.py, and here they must stay no-ops. Every test
leaves the process-global rails of both packages off."""

import contextlib

import numpy as np
import pytest
import torch

from _torch_parity import private_jax_compiles  # noqa: F401
from kubernetes_tpu.analysis.rails import GLOBAL as JRAILS
from kubernetes_tpu.backend.apiserver import APIServer as JApi
from kubernetes_tpu.config import KubeSchedulerConfiguration as JConfig
from kubernetes_tpu.scheduler import Scheduler as JSched
from kubernetes_tpu.testing import wrappers as jw
from kubernetes_tpu_torch.analysis import rails as rails_mod
from kubernetes_tpu_torch.analysis.rails import (GLOBAL as RAILS,
                                                 RetraceBudgetExceeded,
                                                 SanitizerError,
                                                 SanitizerRails)
from kubernetes_tpu_torch.backend.apiserver import APIServer
from kubernetes_tpu_torch.config import KubeSchedulerConfiguration
from kubernetes_tpu_torch.ops import kernels as K
from kubernetes_tpu_torch.ops import program as tp
from kubernetes_tpu_torch.scheduler import Scheduler
from kubernetes_tpu_torch.testing import wrappers as tw

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def rails_off_after():
    """Every test leaves both packages' process-global rails disabled."""
    yield
    RAILS.enable(False)
    JRAILS.enable(False)


def _nodes(w, n):
    return [w.make_node(f"n{i}").capacity(
        {"cpu": "16", "memory": "32Gi", "pods": 110}).zone(f"z{i % 2}")
        .label("kubernetes.io/hostname", f"n{i}").obj() for i in range(n)]


def _cluster(nodes=8, rails=True, batch_size=None):
    api = APIServer()
    sched = Scheduler(api, device="cpu", batch_size=batch_size,
                      clock=lambda: 1000.0,
                      config=KubeSchedulerConfiguration(
                          feature_gates={"SanitizerRails": rails}))
    for nd in _nodes(tw, nodes):
        api.create_node(nd)
    return api, sched


def _pods(w, n, prefix="p", cpu="100m"):
    return [w.make_pod(f"{prefix}{i}").req({"cpu": cpu, "memory": "64Mi"})
            .obj() for i in range(n)]


def _spread(w, n, prefix="s"):
    return [w.make_pod(f"{prefix}{i}").req({"cpu": "100m", "memory": "64Mi"})
            .label("app", "web")
            .spread_constraint(1, "topology.kubernetes.io/zone",
                               "ScheduleAnyway", {"app": "web"}).obj()
            for i in range(n)]


def _binds(api):
    return sorted((p.metadata.name, p.spec.node_name)
                  for p in api.pods.values())


class TestGate:
    def test_gate_off_keeps_behavior(self):
        api, sched = _cluster(nodes=4, rails=False)
        assert not RAILS.active
        for p in _pods(tw, 32):
            api.create_pod(p)
        assert sched.schedule_pending() == 32
        # staging is the identity when the gate is off, and so is holding
        x = np.arange(4)
        assert RAILS.stage((x,), "cuda")[0] is x
        assert RAILS.hold(sched._device_carry) is None

    def test_rails_on_matches_off_and_the_jax_package(self):
        """The rails observe and never steer: a uniform run, scan spans
        and a group (spread) drain bind the same with the rails on and
        off, and as the JAX Scheduler binds with its rails on."""
        def run_port(rails):
            api, sched = _cluster(nodes=6, rails=rails)
            for batch in (_pods(tw, 40), _pods(tw, 5, "q", "3"),
                          _spread(tw, 30)):
                for p in batch:
                    api.create_pod(p)
                sched.schedule_pending()
            assert sched.reconcile() == []
            return _binds(api), sched

        def run_jax():
            api = JApi()
            sched = JSched(api, clock=lambda: 1000.0, config=JConfig(
                feature_gates={"SanitizerRails": True}))
            sched.profiler = None
            sched.audit = None
            for nd in _nodes(jw, 6):
                api.create_node(nd)
            for batch in (_pods(jw, 40), _pods(jw, 5, "q", "3"),
                          _spread(jw, 30)):
                for p in batch:
                    api.create_pod(p)
                sched.schedule_pending()
            return _binds(api)

        on, sched = run_port(True)
        assert sched.uniform_rewinds == 0 and RAILS.held_checks > 0
        off, _ = run_port(False)
        assert on == off
        assert len(on) == 75 and all(node for _, node in on)
        assert on == run_jax()

    def test_scheduler_gate_toggles_global(self):
        _cluster(rails=True)
        assert RAILS.active
        _cluster(rails=False)
        assert not RAILS.active

    def test_unknown_gate_name_rejected(self):
        with pytest.raises(ValueError, match="unknown feature gate"):
            KubeSchedulerConfiguration(
                feature_gates={"SanitizerRailz": True}).validate()
        with pytest.raises(ValueError, match="unknown feature gate"):
            Scheduler(APIServer(), device="cpu",
                      config=KubeSchedulerConfiguration(
                          feature_gates={"SanitizerRailz": True}))

    def test_scoped_enable_restores(self):
        local = SanitizerRails()
        assert not local.active
        with local.enabled(True):
            assert local.active
        assert not local.active

    def test_declared_phases_match_the_jax_package(self):
        from kubernetes_tpu.analysis.rails import DECLARED_PHASES
        assert rails_mod.DECLARED_PHASES == DECLARED_PHASES


class TestSyncGuardOnCpu:
    def test_guard_and_declared_are_noops_off_cuda(self):
        """On the CPU (and with the gate off anywhere) neither context
        touches torch.cuda: a CPU-only build has no sync debug mode."""
        rails = SanitizerRails(enabled=True)
        for ctx in (rails.guard_dispatch("cpu"),
                    rails.declared("host_cache", "cpu"),
                    SanitizerRails().guard_dispatch("cuda"),
                    SanitizerRails().declared("host_cache", "cuda")):
            assert isinstance(ctx, contextlib.nullcontext)
        assert rails.guarded_dispatches == 0
        # an undeclared phase never opens a window
        assert isinstance(rails.declared("commit", "cuda"),
                          contextlib.nullcontext)

    def test_stage_is_identity_off_cuda(self):
        rails = SanitizerRails(enabled=True)
        tree = (np.arange(3), torch.ones(2), None, 7)
        assert rails.stage(tree, "cpu") is tree
        assert rails.staged_bytes == 0


class TestRetraceBudget:
    def test_warm_rerun_fits_zero_budget(self):
        api, sched = _cluster(nodes=4)
        for p in _pods(tw, 24, "warm"):
            api.create_pod(p)
        sched.schedule_pending()
        for p in _pods(tw, 24, "steady"):
            api.create_pod(p)
        with RAILS.retrace_budget(0):
            assert sched.schedule_pending() == 24

    def test_fresh_build_beyond_budget_raises(self, monkeypatch):
        monkeypatch.setitem(K.BUILDS, "run_batch", K.BUILDS["run_batch"])
        with pytest.raises(RetraceBudgetExceeded, match="run_batch"):
            with RAILS.retrace_budget(0):
                K.BUILDS["run_batch"] += 1     # as build() counts a load

    def test_budget_scopes_to_named_kernels(self, monkeypatch):
        monkeypatch.setitem(K.BUILDS, "run_batch", K.BUILDS["run_batch"])
        with RAILS.retrace_budget(0, kernels=("score_probe",)):
            K.BUILDS["run_batch"] += 1
        with RAILS.retrace_budget(1):
            K.BUILDS["run_batch"] += 1


class TestHeldCarry:
    def _pending_uniform(self, rails=True):
        """A dispatched, uncommitted drain of 32 same-signature pods: one
        uniform run holding its input carry."""
        api, sched = _cluster(nodes=8, rails=rails, batch_size=32)
        for p in _pods(tw, 32):
            api.create_pod(p)
        sched.schedule_pending(max_batches=1, wait=False)
        (pd,) = sched._pending
        (rec,) = pd.records
        assert rec.kind == "uniform" and rec.carry_in is not None
        return api, sched, rec

    def test_write_into_held_uniform_carry_raises(self):
        api, sched, rec = self._pending_uniform()
        assert rec.held is not None and rec.held.checksum is None  # CPU
        rec.carry_in.used.add_(1)
        with pytest.raises(SanitizerError, match="write into a held carry"):
            sched.wait_pending()

    def test_subscript_write_into_held_cache_raises(self):
        _api, sched, rec = self._pending_uniform()
        rec.carry_in.cache.s_fit[0] = 7
        with pytest.raises(SanitizerError, match="cache.s_fit"):
            sched.wait_pending()

    def test_clean_commit_passes(self):
        api, sched, rec = self._pending_uniform()
        before = RAILS.held_checks
        sched.wait_pending()
        assert RAILS.held_checks == before + 1
        assert sched.scheduled_count == 32

    def test_gate_off_holds_nothing(self):
        _api, sched, rec = self._pending_uniform(rails=False)
        assert rec.held is None
        rec.carry_in.used.add_(1)      # unseen: the rails are off
        sched.wait_pending()


class TestNanGuard:
    def test_assert_finite_raises_on_nan_and_inf(self):
        RAILS.enable(True)
        with pytest.raises(SanitizerError, match="non-finite"):
            RAILS.assert_finite("probe", (torch.tensor([1.0, float("nan")]),))
        with pytest.raises(SanitizerError, match="non-finite"):
            RAILS.assert_finite("probe", (torch.tensor([float("inf")]),))
        RAILS.assert_finite("probe", (torch.tensor([1.0, 2.0]),
                                      torch.arange(3)))   # ints skipped

    def test_check_scores_runs_once_per_drain(self, monkeypatch):
        calls = []
        real = tp.score_probe

        def counting(*a, **kw):
            calls.append(a[4])
            return real(*a, **kw)

        monkeypatch.setattr(tp, "score_probe", counting)
        api, sched = _cluster(nodes=6)
        for p in _pods(tw, 40) + _pods(tw, 10, "q", "2"):
            api.create_pod(p)
        sched.schedule_pending()
        assert len(calls) == sched.device_batches > 0

    def test_non_finite_score_propagates(self, monkeypatch):
        """A rail trip is a finding: it leaves schedule_pending (no host
        path masks it)."""
        def bad(cfg, na, carry, table, tidx):
            n = carry.used.shape[0]
            return (torch.full((n,), float("nan")), torch.zeros(n))

        monkeypatch.setattr(tp, "score_probe", bad)
        api, sched = _cluster(nodes=4)
        for p in _pods(tw, 8):
            api.create_pod(p)
        with pytest.raises(SanitizerError, match="score surface"):
            sched.schedule_pending()

    def test_nan_guard_scope(self, monkeypatch):
        real = tp._probe_plain

        def nan_probe(*a):
            per_res, dom, valid = real(*a)
            return per_res * float("nan"), dom, valid

        monkeypatch.setattr(tp, "_probe_plain", nan_probe)
        api, sched = _cluster(nodes=4)
        for p in _pods(tw, 8):
            api.create_pod(p)
        sched.schedule_pending()        # outside the scope: unchecked
        for p in _pods(tw, 8, "g"):
            api.create_pod(p)
        with pytest.raises(SanitizerError, match="cluster_probe"):
            with RAILS.nan_guard():
                sched.schedule_pending()
