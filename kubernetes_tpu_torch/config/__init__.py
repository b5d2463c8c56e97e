"""Scheduler ComponentConfig: KubeSchedulerConfiguration-shaped setup.

The port's copy of kubernetes_tpu/config/__init__.py (pkg/scheduler/apis/
config/types.go:37-138 and the defaulting of apis/config/v1/
default_plugins.go:30): the same dataclasses, field names, defaults,
validation, dict round trip, YAML `load`, plugin-args decoding and
`build_profiles`. The XLA compilation cache (`apply_compilation_cache`)
is the JAX package's alone and is not part of the port.

The port's Scheduler reads what the JAX Scheduler reads from a config:
feature gates, batch size, profiles, queue backoffs, the API retry policy
and percentageOfNodesToScore (treated as 100, as there). Fields and
gates whose machinery the port does not have are refused when set away
from their defaults (`refuse_unported`): the north star's rule that a
missing piece raises NotImplementedError, never runs reduced.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..api.types import DEFAULT_SCHEDULER_NAME

# plugins of the JAX package's default profile that the port does not
# have (volumes, DRA, declared node features): accepted by validation
# like every in-tree name, refused when a profile enables them
UNPORTED_PLUGINS = ("NodeDeclaredFeatures", "VolumeRestrictions",
                    "NodeVolumeLimitsCSI", "VolumeBinding", "VolumeZone",
                    "DynamicResources")

# the gates the port's Scheduler honours; the rest stay at their defaults
# (features.py DEFAULT_FEATURES)
PORTED_GATES = ("SanitizerRails", "ColumnarIngest")


@dataclass
class PluginSet:
    """types.go:176 Plugins — enabled adds to defaults, disabled removes
    ('*' disables all defaults first)."""

    enabled: list[str] = field(default_factory=list)
    disabled: list[str] = field(default_factory=list)


@dataclass
class KubeSchedulerProfile:
    """types.go:100 KubeSchedulerProfile."""

    scheduler_name: str = DEFAULT_SCHEDULER_NAME
    plugins: PluginSet = field(default_factory=PluginSet)
    # plugin name → weight (MultiPoint weight, default_plugins.go:93)
    plugin_weights: dict[str, int] = field(default_factory=dict)
    # NodeResourcesFit scoring strategy: LeastAllocated | MostAllocated
    # (shorthand for pluginArgs.NodeResourcesFit.scoringStrategy)
    scoring_strategy: str = "LeastAllocated"
    # typed per-plugin args (types_pluginargs.go analog): plugin name →
    # camelCase arg dict, decoded by _decode_plugin_args into the plugin's
    # own Args dataclass and handed to its factory
    plugin_args: dict[str, dict] = field(default_factory=dict)


@dataclass
class KubeSchedulerConfiguration:
    """types.go:37 KubeSchedulerConfiguration (consumed subset)."""

    profiles: list[KubeSchedulerProfile] = field(
        default_factory=lambda: [KubeSchedulerProfile()])
    percentage_of_nodes_to_score: int = 100          # types.go:62
    pod_initial_backoff_seconds: float = 1.0         # types.go:80
    pod_max_backoff_seconds: float = 10.0            # types.go:84
    # device batch shape (replaces Parallelism, types.go:58)
    batch_size: int = 512
    # API-call retry policy: attempt budget per call INCLUDING the first
    # try, and the base backoff that doubles per retry in the dispatcher
    api_retry_max_attempts: int = 5
    api_retry_base_seconds: float = 0.02
    # the JAX package's persistent XLA compilation cache (not ported)
    compilation_cache_dir: str = "~/.cache/ktpu-xla"
    # the JAX package's profiler trace directory (not ported)
    profiler_trace_dir: str = ""
    # the JAX package's continuous host profiler rate (not ported)
    host_profiler_hz: float = 200.0
    # the JAX package's shadow-oracle audit (not ported)
    shadow_audit_sample_rate: float = 1.0 / 64.0
    shadow_audit_max_replay_pods: int = 64
    shadow_audit_dir: str = ""
    # the JAX package's incident bundles (not ported)
    incident_dir: str = ""
    # the JAX package's telemetry timeline (not ported)
    timeline_horizon_seconds: int = 900
    timeline_export_path: str = ""
    # the JAX package's SLO burn-rate objectives (not ported)
    slo_objectives: dict = field(default_factory=dict)
    # names of out-of-tree plugins registered in the caller's Registry
    extra_plugins: tuple = ()
    # feature gate overrides (--feature-gates flag / featureGates field)
    feature_gates: dict[str, bool] = field(default_factory=dict)

    # -- validation (apis/config/validation/validation.go) -------------------

    def validate(self) -> None:
        """The JAX package's checks, less the SLO objective names (the
        port has no SLO engine: `refuse_unported` refuses any
        objective)."""
        if not self.profiles:
            raise ValueError("at least one profile is required")
        names = [p.scheduler_name for p in self.profiles]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate profile schedulerName in {names}")
        if self.pod_initial_backoff_seconds <= 0:
            raise ValueError("podInitialBackoffSeconds must be > 0")
        if self.pod_max_backoff_seconds < self.pod_initial_backoff_seconds:
            raise ValueError(
                "podMaxBackoffSeconds must be >= podInitialBackoffSeconds")
        if not 0 < self.percentage_of_nodes_to_score <= 100:
            raise ValueError("percentageOfNodesToScore must be in (0, 100]")
        if self.batch_size <= 0:
            raise ValueError("batchSize must be > 0")
        if self.api_retry_max_attempts < 1:
            raise ValueError("apiRetryMaxAttempts must be >= 1")
        if self.api_retry_base_seconds <= 0:
            raise ValueError("apiRetryBaseSeconds must be > 0")
        if self.host_profiler_hz < 0 or self.host_profiler_hz > 10000:
            raise ValueError("hostProfilerHz must be in [0, 10000]")
        if not 0.0 <= self.shadow_audit_sample_rate <= 1.0:
            raise ValueError("shadowAuditSampleRate must be in [0, 1]")
        if self.shadow_audit_max_replay_pods < 0:
            raise ValueError("shadowAuditMaxReplayPods must be >= 0")
        if self.timeline_horizon_seconds < 1:
            raise ValueError("timelineHorizonSeconds must be >= 1")
        known = set(_default_plugin_names()) | set(self.extra_plugins)
        for p in self.profiles:
            for n in p.plugins.enabled + p.plugins.disabled:
                if n not in known and n != "*":
                    raise ValueError(f"unknown plugin {n!r} in profile "
                                     f"{p.scheduler_name!r} (known: "
                                     f"{sorted(known)})")
            if p.scoring_strategy not in ("LeastAllocated", "MostAllocated"):
                raise ValueError(
                    f"unknown scoringStrategy {p.scoring_strategy!r}")
            for name in p.plugin_args:
                if name not in known:
                    raise ValueError(
                        f"pluginArgs for unknown plugin {name!r} in "
                        f"profile {p.scheduler_name!r}")
                _decode_plugin_args(name, p.plugin_args[name])  # validates
        from .features import default_gate
        default_gate(self.feature_gates)  # raises on unknown gate names

    # -- round trip ----------------------------------------------------------

    API_VERSION = "kubescheduler.config.k8s.io/v1"
    KIND = "KubeSchedulerConfiguration"

    def to_dict(self) -> dict:
        return {
            "apiVersion": self.API_VERSION,
            "kind": self.KIND,
            "profiles": [{
                "schedulerName": p.scheduler_name,
                "plugins": {"enabled": list(p.plugins.enabled),
                            "disabled": list(p.plugins.disabled)},
                "pluginWeights": dict(p.plugin_weights),
                "scoringStrategy": p.scoring_strategy,
            } for p in self.profiles],
            "percentageOfNodesToScore": self.percentage_of_nodes_to_score,
            "podInitialBackoffSeconds": self.pod_initial_backoff_seconds,
            "podMaxBackoffSeconds": self.pod_max_backoff_seconds,
            "batchSize": self.batch_size,
            "apiRetryMaxAttempts": self.api_retry_max_attempts,
            "apiRetryBaseSeconds": self.api_retry_base_seconds,
            "compilationCacheDir": self.compilation_cache_dir,
            "profilerTraceDir": self.profiler_trace_dir,
            "hostProfilerHz": self.host_profiler_hz,
            "shadowAuditSampleRate": self.shadow_audit_sample_rate,
            "shadowAuditMaxReplayPods": self.shadow_audit_max_replay_pods,
            "shadowAuditDir": self.shadow_audit_dir,
            "incidentDir": self.incident_dir,
            "timelineHorizonSeconds": self.timeline_horizon_seconds,
            "timelineExportPath": self.timeline_export_path,
            "sloObjectives": dict(self.slo_objectives),
            "extraPlugins": list(self.extra_plugins),
            "featureGates": dict(self.feature_gates),
        }

    @staticmethod
    def from_dict(d: dict) -> "KubeSchedulerConfiguration":
        # versioned-scheme envelope (apis/config/scheme): tolerate its
        # absence (internal form), reject a WRONG group/version
        api_version = d.get("apiVersion")
        if api_version is not None and api_version != \
                KubeSchedulerConfiguration.API_VERSION:
            raise ValueError(
                f"unsupported apiVersion {api_version!r} (want "
                f"{KubeSchedulerConfiguration.API_VERSION!r})")
        kind = d.get("kind")
        if kind is not None and kind != KubeSchedulerConfiguration.KIND:
            raise ValueError(f"unsupported kind {kind!r}")
        profiles = [
            KubeSchedulerProfile(
                scheduler_name=pd.get("schedulerName",
                                      DEFAULT_SCHEDULER_NAME),
                plugins=PluginSet(
                    enabled=list(pd.get("plugins", {}).get("enabled", [])),
                    disabled=list(pd.get("plugins", {}).get("disabled", []))),
                plugin_weights=dict(pd.get("pluginWeights", {})),
                scoring_strategy=pd.get("scoringStrategy", "LeastAllocated"),
                plugin_args={k: dict(v) for k, v in
                             pd.get("pluginArgs", {}).items()})
            for pd in d.get("profiles", [{}])
        ] or [KubeSchedulerProfile()]
        return KubeSchedulerConfiguration(
            profiles=profiles,
            percentage_of_nodes_to_score=d.get("percentageOfNodesToScore",
                                               100),
            pod_initial_backoff_seconds=d.get("podInitialBackoffSeconds",
                                              1.0),
            pod_max_backoff_seconds=d.get("podMaxBackoffSeconds", 10.0),
            batch_size=d.get("batchSize", 512),
            api_retry_max_attempts=d.get("apiRetryMaxAttempts", 5),
            api_retry_base_seconds=d.get("apiRetryBaseSeconds", 0.02),
            compilation_cache_dir=d.get("compilationCacheDir",
                                        "~/.cache/ktpu-xla"),
            profiler_trace_dir=d.get("profilerTraceDir", ""),
            host_profiler_hz=d.get("hostProfilerHz", 200.0),
            shadow_audit_sample_rate=d.get("shadowAuditSampleRate",
                                           1.0 / 64.0),
            shadow_audit_max_replay_pods=d.get("shadowAuditMaxReplayPods",
                                               64),
            shadow_audit_dir=d.get("shadowAuditDir", ""),
            incident_dir=d.get("incidentDir", ""),
            timeline_horizon_seconds=d.get("timelineHorizonSeconds", 900),
            timeline_export_path=d.get("timelineExportPath", ""),
            slo_objectives=dict(d.get("sloObjectives", {})),
            extra_plugins=tuple(d.get("extraPlugins", ())),
            feature_gates=dict(d.get("featureGates", {})))


# field → the JAX package's machinery behind it, which the port lacks
_UNPORTED_FIELDS = {
    "compilation_cache_dir": "the XLA compilation cache",
    "profiler_trace_dir": "the XLA profiler trace",
    "host_profiler_hz": "the continuous host profiler (perf/profiler.py)",
    "shadow_audit_sample_rate": "the shadow-oracle audit (obs/audit.py)",
    "shadow_audit_max_replay_pods": "the shadow-oracle audit (obs/audit.py)",
    "shadow_audit_dir": "the shadow-oracle audit (obs/audit.py)",
    "incident_dir": "incident forensics (obs/incident.py)",
    "timeline_horizon_seconds": "the telemetry timeline (obs/timeline.py)",
    "timeline_export_path": "the telemetry timeline (obs/timeline.py)",
    "slo_objectives": "the SLO burn-rate engine (obs/slo.py)",
    "extra_plugins": "out-of-tree plugins (the host scheduling path)",
}


def refuse_unported(cfg: KubeSchedulerConfiguration) -> None:
    """Raise NotImplementedError naming the missing piece when `cfg` sets
    a field, a gate or a plugin the port has no machinery for away from
    its default."""
    from .features import DEFAULT_FEATURES
    default = KubeSchedulerConfiguration()
    for name, what in _UNPORTED_FIELDS.items():
        got, want = getattr(cfg, name), getattr(default, name)
        if isinstance(got, (list, tuple)):
            got, want = tuple(got), tuple(want)
        if got != want:
            raise NotImplementedError(
                f"config field {name} = {getattr(cfg, name)!r}: {what} is "
                "not ported to kubernetes_tpu_torch yet")
    for gate, value in cfg.feature_gates.items():
        spec = DEFAULT_FEATURES.get(gate)
        if (gate not in PORTED_GATES and spec is not None
                and bool(value) != spec.default):
            raise NotImplementedError(
                f"feature gate {gate}={bool(value)}: kubernetes_tpu_torch "
                f"runs with every gate but {', '.join(PORTED_GATES)} at its "
                "default")
    for p in cfg.profiles:
        for name in list(p.plugins.enabled) + list(p.plugin_args):
            if name in UNPORTED_PLUGINS:
                raise NotImplementedError(
                    f"plugin {name} (profile {p.scheduler_name!r}) is not "
                    "ported to kubernetes_tpu_torch yet")


def load(path: str) -> KubeSchedulerConfiguration:
    """Load + validate a YAML KubeSchedulerConfiguration."""
    import yaml
    with open(path) as f:
        cfg = KubeSchedulerConfiguration.from_dict(yaml.safe_load(f) or {})
    cfg.validate()
    return cfg


def _default_plugin_names() -> list[str]:
    from ..scheduler import default_plugins
    return ([p.name() for p in default_plugins()] + ["DefaultPreemption"]
            + list(UNPORTED_PLUGINS))


def _decode_plugin_args(name: str, d: dict):
    """camelCase arg dict → the plugin's typed Args dataclass
    (apis/config/types_pluginargs.go + scheme decoding analog). Raises on
    unknown plugin-arg keys, as the reference's strict decoding does."""
    def pick(allowed: dict):
        unknown = set(d) - set(allowed)
        if unknown:
            raise ValueError(f"unknown {name}Args fields {sorted(unknown)}")
        return {py: d[yaml] for yaml, py in allowed.items() if yaml in d}

    if name == "NodeResourcesFit":
        from ..plugins.noderesources import FitArgs, ResourceSpec
        kw = pick({"scoringStrategy": "scoring_strategy",
                   "resources": "resources",
                   "ignoredResources": "ignored_resources"})
        if "scoring_strategy" in kw and kw["scoring_strategy"] not in (
                "LeastAllocated", "MostAllocated"):
            raise ValueError(
                f"unknown scoringStrategy {kw['scoring_strategy']!r}")
        if "resources" in kw:
            kw["resources"] = tuple(
                ResourceSpec(r["name"], r.get("weight", 1))
                for r in kw["resources"])
        if "ignored_resources" in kw:
            kw["ignored_resources"] = frozenset(kw["ignored_resources"])
        return FitArgs(**kw)
    if name == "NodeResourcesBalancedAllocation":
        from ..plugins.noderesources import (BalancedAllocationArgs,
                                             ResourceSpec)
        kw = pick({"resources": "resources"})
        if "resources" in kw:
            kw["resources"] = tuple(
                ResourceSpec(r["name"], r.get("weight", 1))
                for r in kw["resources"])
        return BalancedAllocationArgs(**kw)
    if name == "PodTopologySpread":
        from ..api.types import TopologySpreadConstraint
        from ..plugins.podtopologyspread import PodTopologySpreadArgs
        kw = pick({"defaultingType": "defaulting_type",
                   "defaultConstraints": "default_constraints"})
        if kw.get("defaulting_type") not in (None, "List", "System"):
            raise ValueError(
                f"unknown defaultingType {kw['defaulting_type']!r}")
        if "default_constraints" in kw:
            kw["default_constraints"] = tuple(
                TopologySpreadConstraint(
                    max_skew=c.get("maxSkew", 1),
                    topology_key=c["topologyKey"],
                    when_unsatisfiable=c.get("whenUnsatisfiable",
                                             "DoNotSchedule"))
                for c in kw["default_constraints"])
        return PodTopologySpreadArgs(**kw)
    if name == "InterPodAffinity":
        from ..plugins.interpodaffinity import InterPodAffinityArgs
        kw = pick({"hardPodAffinityWeight": "hard_pod_affinity_weight",
                   "ignorePreferredTermsOfExistingPods":
                       "ignore_preferred_terms_of_existing_pods"})
        return InterPodAffinityArgs(**kw)
    if name == "GangScheduling":
        kw = pick({"schedulingTimeoutSeconds": "scheduling_timeout_seconds"})
        if kw.get("scheduling_timeout_seconds", 1) <= 0:
            raise ValueError("schedulingTimeoutSeconds must be > 0")
        return kw
    raise ValueError(f"plugin {name!r} does not accept args")


def default_registry(client=None):
    """Registry of plugin factories (runtime/registry.go NewInTreeRegistry
    analog): every in-tree plugin of the port by name, each factory
    building one fresh instance per call."""
    from ..framework.runtime import Registry
    from ..scheduler import default_plugin_factories
    reg = Registry()
    for factory in default_plugin_factories(client):
        reg.register(factory().name(), factory)
    return reg


def build_profiles(cfg: KubeSchedulerConfiguration, client=None,
                   registry=None):
    """Config → the Scheduler's Profile list (profile.NewMap analog,
    profile/profile.go:46): defaults ± enable/disable through the plugin
    registry, weights applied, ScoreConfig strategy set per profile. The
    gates that add or remove a default plugin (GenericWorkload,
    NodeDeclaredFeatures, DynamicResourceAllocation) stay at their
    defaults in the port, which keep GangScheduling and leave the two
    unported plugins out of its default set anyway."""
    from ..framework.runtime import Framework
    from ..ops.program import ScoreConfig
    from ..scheduler import DEFAULT_WEIGHTS, Profile, default_plugins

    registry = registry or default_registry(client)
    out = []
    for p in cfg.profiles:
        plugins = default_plugins(client)
        if "*" in p.plugins.disabled:
            plugins = []
        else:
            plugins = [pl for pl in plugins
                       if pl.name() not in p.plugins.disabled]
        have = {pl.name() for pl in plugins}
        for name in p.plugins.enabled:
            if name in have:
                continue
            factory = registry.factories.get(name)
            if factory is None:
                raise ValueError(
                    f"plugin {name!r} enabled by profile "
                    f"{p.scheduler_name!r} has no registered factory")
            plugins.append(factory())
        # typed per-plugin args: rebuild the named plugin with its Args
        strategy = p.scoring_strategy
        for pname, argdict in p.plugin_args.items():
            decoded = _decode_plugin_args(pname, argdict)
            for idx, pl in enumerate(plugins):
                if pl.name() != pname:
                    continue
                if pname == "NodeResourcesFit":
                    from ..plugins.noderesources import Fit, FitArgs
                    if "scoringStrategy" not in argdict:
                        # args without a strategy key must not silently
                        # reset the profile-level scoringStrategy
                        decoded = FitArgs(
                            scoring_strategy=strategy,
                            resources=decoded.resources,
                            ignored_resources=decoded.ignored_resources)
                    plugins[idx] = Fit(decoded)
                    strategy = decoded.scoring_strategy
                elif pname == "NodeResourcesBalancedAllocation":
                    from ..plugins.noderesources import BalancedAllocation
                    plugins[idx] = BalancedAllocation(decoded)
                elif pname == "PodTopologySpread":
                    from ..plugins.podtopologyspread import PodTopologySpread
                    plugins[idx] = PodTopologySpread(decoded)
                elif pname == "InterPodAffinity":
                    from ..plugins.interpodaffinity import InterPodAffinity
                    old = plugins[idx]
                    plugins[idx] = InterPodAffinity(
                        decoded, ns_lister=getattr(old, "ns_lister", None))
                elif pname == "GangScheduling":
                    for k, v in decoded.items():
                        setattr(pl, k, v)
                break
        weights = dict(DEFAULT_WEIGHTS)
        weights.update(p.plugin_weights)
        fwk = Framework(p.scheduler_name, plugins, weights=weights)
        score_cfg = ScoreConfig(
            strategy=strategy,
            w_taint=weights.get("TaintToleration", 3),
            w_node_affinity=weights.get("NodeAffinity", 2),
            w_spread=weights.get("PodTopologySpread", 2),
            w_ipa=weights.get("InterPodAffinity", 2),
            w_fit=weights.get("NodeResourcesFit", 1),
            w_balanced=weights.get("NodeResourcesBalancedAllocation", 1),
            w_image=weights.get("ImageLocality", 1))
        out.append(Profile(name=p.scheduler_name, framework=fwk,
                           score_config=score_cfg))
    return out
