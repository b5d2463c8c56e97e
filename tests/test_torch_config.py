"""The port's feature gates and ComponentConfig (kubernetes_tpu_torch/
config/) against the JAX package's, and the Scheduler's reading of them.

Parity: the same gate registry (names, defaults, stages, locks) and gate
semantics; the same configuration defaults, dict round trip, validation
errors (message for message), plugin-args decoding and profiles built
from a config (the port's plugins are the JAX package's less the volume,
DRA and declared-feature plugins). The Scheduler takes its batch size,
backoffs, retry policy and profiles from a config, and binds a small
cluster under a non-default profile as the JAX Scheduler does. The
north star's rule: a field, gate or plugin the port has no machinery for,
set away from its default, raises NotImplementedError."""

import dataclasses

import pytest
import torch

from _torch_parity import private_jax_compiles  # noqa: F401
from kubernetes_tpu import config as jc
from kubernetes_tpu.analysis.rails import GLOBAL as JRAILS
from kubernetes_tpu.backend.apiserver import APIServer as JApi
from kubernetes_tpu.config import features as jf
from kubernetes_tpu.scheduler import Scheduler as JSched
from kubernetes_tpu.testing import wrappers as jw
from kubernetes_tpu_torch import config as tc
from kubernetes_tpu_torch.analysis.rails import GLOBAL as RAILS
from kubernetes_tpu_torch.backend.apiserver import APIServer as TApi
from kubernetes_tpu_torch.config import features as tf
from kubernetes_tpu_torch.scheduler import Scheduler as TSched
from kubernetes_tpu_torch.testing import wrappers as tw

torch.set_num_threads(1)

SAMPLE = {
    "apiVersion": "kubescheduler.config.k8s.io/v1",
    "kind": "KubeSchedulerConfiguration",
    "profiles": [
        {"schedulerName": "default-scheduler",
         "pluginWeights": {"NodeResourcesFit": 3, "ImageLocality": 2},
         "scoringStrategy": "MostAllocated"},
        {"schedulerName": "lean",
         "plugins": {"disabled": ["ImageLocality", "VolumeBinding"]},
         "pluginArgs": {
             "NodeResourcesFit": {"resources": [
                 {"name": "cpu", "weight": 2}, {"name": "memory"}]},
             "PodTopologySpread": {"defaultingType": "List",
                                   "defaultConstraints": [{
                                       "maxSkew": 2,
                                       "topologyKey": "topology.kubernetes"
                                                      ".io/zone"}]},
             "InterPodAffinity": {"hardPodAffinityWeight": 3},
             "GangScheduling": {"schedulingTimeoutSeconds": 30}}},
    ],
    "batchSize": 64,
    "podInitialBackoffSeconds": 2.0,
    "podMaxBackoffSeconds": 20.0,
    "apiRetryMaxAttempts": 3,
    "apiRetryBaseSeconds": 0.05,
    "percentageOfNodesToScore": 50,
    "featureGates": {"SanitizerRails": True},
}


@pytest.fixture(autouse=True)
def rails_off_after():
    yield
    RAILS.enable(False)
    JRAILS.enable(False)


class TestFeatures:
    def test_same_registry(self):
        assert list(tf.DEFAULT_FEATURES) == list(jf.DEFAULT_FEATURES)
        for name, spec in jf.DEFAULT_FEATURES.items():
            assert dataclasses.asdict(tf.DEFAULT_FEATURES[name]) == \
                dataclasses.asdict(spec), name
        assert (tf.ALPHA, tf.BETA, tf.GA) == (jf.ALPHA, jf.BETA, jf.GA)

    def test_same_gate_semantics(self):
        for mod in (tf, jf):
            gate = mod.default_gate({"SanitizerRails": True,
                                     "ColumnarIngest": False})
            assert gate.enabled("SanitizerRails")
            assert not gate.enabled("ColumnarIngest")
            assert gate.enabled("OpportunisticBatching")
            with pytest.raises(ValueError, match="unknown feature gate"):
                gate.set("NoSuchGate", True)
            with pytest.raises(KeyError):
                gate.enabled("NoSuchGate")
            gate.add("Extra", mod.FeatureSpec(False, mod.GA, True))
            with pytest.raises(ValueError, match="locked"):
                gate.set("Extra", True)
            assert sorted(gate.known()) == sorted(
                list(mod.DEFAULT_FEATURES) + ["Extra"])


def _both(d):
    return (tc.KubeSchedulerConfiguration.from_dict(d),
            jc.KubeSchedulerConfiguration.from_dict(d))


class TestConfiguration:
    def test_defaults_and_round_trip(self):
        t, j = tc.KubeSchedulerConfiguration(), jc.KubeSchedulerConfiguration()
        assert t.to_dict() == j.to_dict()
        t, j = _both(SAMPLE)
        assert t.to_dict() == j.to_dict()
        again = tc.KubeSchedulerConfiguration.from_dict(t.to_dict())
        assert again.to_dict() == t.to_dict()
        t.validate()
        j.validate()

    def test_no_profile_is_refused_alike(self):
        for mod in (tc, jc):
            with pytest.raises(ValueError, match="at least one profile"):
                mod.KubeSchedulerConfiguration(profiles=[]).validate()

    @pytest.mark.parametrize("patch", [
        {"profiles": [{"schedulerName": "a"}, {"schedulerName": "a"}]},
        {"podInitialBackoffSeconds": 0},
        {"podMaxBackoffSeconds": 0.5},
        {"percentageOfNodesToScore": 0},
        {"batchSize": 0},
        {"apiRetryMaxAttempts": 0},
        {"apiRetryBaseSeconds": 0},
        {"hostProfilerHz": -1},
        {"shadowAuditSampleRate": 2},
        {"shadowAuditMaxReplayPods": -1},
        {"timelineHorizonSeconds": 0},
        {"profiles": [{"plugins": {"enabled": ["NoSuchPlugin"]}}]},
        {"profiles": [{"scoringStrategy": "Balanced"}]},
        {"profiles": [{"pluginArgs": {"NoSuchPlugin": {}}}]},
        {"profiles": [{"pluginArgs": {"NodeResourcesFit": {"typo": 1}}}]},
        {"profiles": [{"pluginArgs": {"NodeResourcesFit": {
            "scoringStrategy": "Balanced"}}}]},
        {"profiles": [{"pluginArgs": {"PodTopologySpread": {
            "defaultingType": "Sometimes"}}}]},
        {"profiles": [{"pluginArgs": {"GangScheduling": {
            "schedulingTimeoutSeconds": 0}}}]},
        {"profiles": [{"pluginArgs": {"TaintToleration": {"x": 1}}}]},
        {"featureGates": {"SanitizerRailz": True}},
    ])
    def test_validation_errors_match(self, patch):
        t, j = _both(patch)
        with pytest.raises(ValueError) as je:
            j.validate()
        with pytest.raises(ValueError) as te:
            t.validate()
        assert str(te.value).split(" (known")[0] == \
            str(je.value).split(" (known")[0]

    def test_envelope_errors_match(self):
        for bad in ({"apiVersion": "v0"}, {"kind": "Other"}):
            with pytest.raises(ValueError) as je:
                jc.KubeSchedulerConfiguration.from_dict(bad)
            with pytest.raises(ValueError) as te:
                tc.KubeSchedulerConfiguration.from_dict(bad)
            assert str(te.value) == str(je.value)

    @pytest.mark.parametrize("name,args", [
        ("NodeResourcesFit", {"scoringStrategy": "MostAllocated",
                              "resources": [{"name": "cpu", "weight": 3}],
                              "ignoredResources": ["example.com/foo"]}),
        ("NodeResourcesBalancedAllocation",
         {"resources": [{"name": "memory"}]}),
        ("PodTopologySpread", {"defaultingType": "System"}),
        ("PodTopologySpread", {"defaultConstraints": [
            {"maxSkew": 3, "topologyKey": "zone",
             "whenUnsatisfiable": "ScheduleAnyway"}]}),
        ("InterPodAffinity", {"hardPodAffinityWeight": 7,
                              "ignorePreferredTermsOfExistingPods": True}),
        ("GangScheduling", {"schedulingTimeoutSeconds": 12}),
    ])
    def test_plugin_args_decode_alike(self, name, args):
        t = tc._decode_plugin_args(name, args)
        j = jc._decode_plugin_args(name, args)
        if isinstance(j, dict):
            assert t == j
            return
        assert type(t).__name__ == type(j).__name__
        for f in dataclasses.fields(j):
            a, b = getattr(t, f.name), getattr(j, f.name)
            if isinstance(b, tuple) and b and dataclasses.is_dataclass(b[0]):
                a = [dataclasses.asdict(x) for x in a]
                b = [{k: v for k, v in dataclasses.asdict(x).items()
                      if k in dataclasses.asdict(a_x)}
                     for x, a_x in zip(b, getattr(t, f.name))]
            assert a == b, f.name


def _profile_view(p):
    return (p.name, [pl.name() for pl in p.framework.plugins
                     if pl.name() not in tc.UNPORTED_PLUGINS],
            p.framework.weights if hasattr(p.framework, "weights") else None,
            tuple(p.score_config))


class TestProfiles:
    def test_build_profiles_match(self):
        t, j = _both(SAMPLE)
        tp_ = tc.build_profiles(t, TApi())
        jp_ = jc.build_profiles(j, JApi())
        assert [_profile_view(p) for p in tp_] == \
            [_profile_view(p) for p in jp_]
        lean = next(p for p in tp_ if p.name == "lean")
        gang = next(pl for pl in lean.framework.plugins
                    if pl.name() == "GangScheduling")
        assert gang.scheduling_timeout_seconds == 30

    def test_scheduler_reads_the_config(self):
        t, _ = _both(SAMPLE)
        sched = TSched(TApi(), device="cpu", config=t)
        assert sched.batch_size == 64
        assert sched.queue.pod_initial_backoff == 2.0
        assert sched.queue.pod_max_backoff == 20.0
        assert sched.dispatcher.retry_max_attempts == 3
        assert sched.dispatcher.retry_base_seconds == 0.05
        assert sched.percentage_of_nodes_to_score == 50
        assert sorted(sched.profiles) == ["default-scheduler", "lean"]
        assert sched.profiles["default-scheduler"].score_config == \
            tc.build_profiles(t)[0].score_config
        assert RAILS.active
        # explicit arguments win over the config
        assert TSched(TApi(), device="cpu", batch_size=8,
                      config=t).batch_size == 8

    def test_bind_map_under_a_configured_profile(self):
        """MostAllocated with reweighted plugins, on both schedulers."""
        cfg = {"profiles": [{"scoringStrategy": "MostAllocated",
                             "pluginWeights": {"NodeResourcesFit": 4}}],
               "batchSize": 16}

        def run(w, Api, Sched, kw):
            api = Api()
            sched = Sched(api, clock=lambda: 1000.0, config=(
                tc if Sched is TSched else jc)
                .KubeSchedulerConfiguration.from_dict(cfg), **kw)
            if Sched is JSched:
                sched.profiler = None
                sched.audit = None
            for i in range(8):
                api.create_node(w.make_node(f"n{i}").capacity(
                    {"cpu": str(4 + 2 * (i % 3)), "memory": "16Gi",
                     "pods": 110}).obj())
            for i in range(40):
                api.create_pod(w.make_pod(f"p{i}").req(
                    {"cpu": ["250m", "500m", "1"][i % 3],
                     "memory": "512Mi"}).obj())
            sched.schedule_pending()
            return sorted((p.metadata.name, p.spec.node_name)
                          for p in api.pods.values())

        assert run(tw, TApi, TSched, {"device": "cpu"}) == \
            run(jw, JApi, JSched, {})


UNPORTED_FIELDS = [
    ("compilation_cache_dir", ""), ("profiler_trace_dir", "/tmp/x"),
    ("host_profiler_hz", 50.0), ("shadow_audit_sample_rate", 1.0),
    ("shadow_audit_max_replay_pods", 8), ("shadow_audit_dir", "/tmp/a"),
    ("incident_dir", "/tmp/i"), ("timeline_horizon_seconds", 60),
    ("timeline_export_path", "/tmp/t.jsonl"),
    ("slo_objectives", {"schedule_latency": {"objective": 0.99}}),
    ("extra_plugins", ("MyPlugin",)),
]


class TestRefusals:
    @pytest.mark.parametrize("field,value", UNPORTED_FIELDS,
                             ids=[f for f, _ in UNPORTED_FIELDS])
    def test_unported_field_away_from_default_raises(self, field, value):
        cfg = tc.KubeSchedulerConfiguration(**{field: value})
        with pytest.raises(NotImplementedError, match=field):
            tc.refuse_unported(cfg)
        with pytest.raises(NotImplementedError, match="not ported"):
            TSched(TApi(), device="cpu", config=cfg)

    @pytest.mark.parametrize("gate", [g for g in tf.DEFAULT_FEATURES
                                      if g not in tc.PORTED_GATES])
    def test_other_gates_stay_at_their_defaults(self, gate):
        default = tf.DEFAULT_FEATURES[gate].default
        tc.refuse_unported(tc.KubeSchedulerConfiguration(
            feature_gates={gate: default}))
        cfg = tc.KubeSchedulerConfiguration(feature_gates={gate: not default})
        with pytest.raises(NotImplementedError, match=gate):
            tc.refuse_unported(cfg)

    @pytest.mark.parametrize("plugin", tc.UNPORTED_PLUGINS)
    def test_enabling_an_unported_plugin_raises(self, plugin):
        cfg = tc.KubeSchedulerConfiguration(profiles=[
            tc.KubeSchedulerProfile(plugins=tc.PluginSet(enabled=[plugin]))])
        cfg.validate()
        with pytest.raises(NotImplementedError, match=plugin):
            TSched(TApi(), device="cpu", config=cfg)
        # disabling one the port does not have is accepted (a no-op)
        TSched(TApi(), device="cpu", config=tc.KubeSchedulerConfiguration(
            profiles=[tc.KubeSchedulerProfile(
                plugins=tc.PluginSet(disabled=[plugin]))]))

    def test_columnar_ingest_off_is_accepted(self):
        cfg = tc.KubeSchedulerConfiguration(
            feature_gates={"ColumnarIngest": False})
        tc.refuse_unported(cfg)
        api = TApi()
        off = TSched(api, device="cpu", config=cfg)
        assert not off.columnar_ingest and off.commit_engine is None
        assert not off.builder.columnar and not off.state.columnar
        assert all(h.on_update_bulk is None for h in api.pod_handlers)
        # on is the default, with or without a config
        for kw in ({}, {"config": tc.KubeSchedulerConfiguration()}):
            api = TApi()
            on = TSched(api, device="cpu", **kw)
            assert on.columnar_ingest and on.commit_engine is not None
            assert on.builder.columnar and on.state.columnar
            assert [h.on_update_bulk for h in api.pod_handlers] == [
                on._on_pod_update_bulk]

    def test_defaults_and_the_rails_gate_are_accepted(self):
        tc.refuse_unported(tc.KubeSchedulerConfiguration())
        tc.refuse_unported(tc.KubeSchedulerConfiguration(
            feature_gates={"SanitizerRails": True}, extra_plugins=[]))
