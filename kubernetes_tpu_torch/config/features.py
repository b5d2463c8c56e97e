"""Feature gates: component-base/featuregate + pkg/features/kube_features.go.

A FeatureGate is a registry of known features with per-feature defaults and
maturity stages; a config (or test) overrides specific gates by name, and
unknown names are rejected exactly like featuregate.Set. The scheduler
consults the gate at wiring time — the same pattern the reference uses to
introduce OpportunisticBatching (kube_features.go:686), the async API
dispatcher (SchedulerAsyncAPICalls, :891) and the Workload API
(GenericWorkload, :338).

GA features cannot be disabled (featuregate.go's locked-to-default
behavior for GA+locked gates) — mirrored here for the gates whose off
state no longer exists in this architecture.

The port's own copy of kubernetes_tpu/config/features.py: the same gate
names, defaults and stages. The port's Scheduler honours only
`SanitizerRails` (analysis/rails.py); every other gate is fixed at its
default there, and a config that sets one away from it is refused
(config/__init__.py `refuse_unported`).
"""

from __future__ import annotations

from dataclasses import dataclass


ALPHA = "Alpha"
BETA = "Beta"
GA = "GA"


@dataclass(frozen=True)
class FeatureSpec:
    """featuregate.FeatureSpec: default + prerelease stage + lock."""

    default: bool
    stage: str = BETA
    lock_to_default: bool = False


# the known gate set (kube_features.go analogs + TPU-backend gates)
DEFAULT_FEATURES: dict[str, FeatureSpec] = {
    # KEP-5598 signature batching → here: the closed-form uniform fast
    # path over same-signature runs (kube_features.go:686)
    "OpportunisticBatching": FeatureSpec(True, BETA),
    # async API call pipeline (kube_features.go:891); off = every drain
    # commits synchronously before the next dispatch
    "SchedulerAsyncAPICalls": FeatureSpec(True, BETA),
    # Workload / gang scheduling API (kube_features.go:338)
    "GenericWorkload": FeatureSpec(True, ALPHA),
    # whole-gang all-or-nothing assignment as one device dispatch
    # (ops/gang.py run_gang): once PreEnqueue quorum is met, the gang is
    # solved atomically — accept commits without Reserve/Permit churn,
    # reject unwinds on device. Off = gangs ride the per-pod path with
    # the reference's Permit-barrier dance (members park holding assumed
    # resources until quorum or timeout).
    "GangDevicePlacement": FeatureSpec(True, BETA),
    # queueing hints consulted on requeue (SchedulerQueueingHint)
    "SchedulerQueueingHints": FeatureSpec(True, BETA),
    # nodedeclaredfeatures plugin
    "NodeDeclaredFeatures": FeatureSpec(True, ALPHA),
    # dynamicresources plugin (structured parameters)
    "DynamicResourceAllocation": FeatureSpec(True, BETA),
    # batched device preemption dry-run (SURVEY §7 step 8): the Evaluator's
    # per-candidate-node host sweep becomes one gathered kernel; off =
    # the host loop (still PreFilter-hoisted) for every preemption
    "BatchedPreemptionDryRun": FeatureSpec(True, BETA),
    # speculative wave placement for group (spread / inter-pod affinity)
    # drains: conflict-checked parallel placement on device with exact
    # serial-order parity (ops/program.py run_wave); off = the host
    # greedy / per-pod scan paths for every group drain
    "SpeculativeWavePlacement": FeatureSpec(True, BETA),
    # mask-derived FailedScheduling diagnosis (ops/program.py diagnose_row):
    # per-plugin rejected-node counts reduced from the device filter masks;
    # off = the host-oracle filter replay per failed signature
    "DeviceMaskDiagnosis": FeatureSpec(True, BETA),
    # always-on sampling host profiler (perf/profiler.py): a background
    # thread samples the host-loop stack at hostProfilerHz, attributing
    # cost per drain phase + signature-cardinality bucket; served at
    # /debug/hostprofile. Off = no sampler thread, no attribution.
    "ContinuousHostProfiling": FeatureSpec(True, BETA),
    # runtime sanitizer rails (analysis/rails.py): transfer guard on the
    # drain path (implicit host↔device transfers raise), per-kernel
    # retrace budgets, donation-after-use poisoning on non-donating
    # backends, NaN/inf score probes. For tests, soaks and staging —
    # not the production hot path.
    "SanitizerRails": FeatureSpec(False, ALPHA),
    # columnar ingest & commit engine (ingest/): the chunked build, the
    # columnar node-row writers, the batched assume/bind path
    # (CommitEngine) + the bulk bind-echo confirm. Off = the serial
    # per-pod paths — the parity oracle tests/test_torch_ingest.py
    # compares against.
    "ColumnarIngest": FeatureSpec(True, BETA),
    # shadow-oracle audit (kubernetes_tpu/obs/audit.py): a background
    # sampler captures a deterministic replay record per sampled drain
    # into a hash-chained ledger, re-executes it through the host oracle
    # off the hot path, and diffs assignments + FailedScheduling reason
    # histograms (oracle_divergence_total). The production-time half of
    # the bind-parity contract the fuzz suites verify offline — the
    # precondition for learned score columns (ROADMAP item 5) whose
    # correctness cannot be fuzzed ahead of time.
    "ShadowOracleAudit": FeatureSpec(True, BETA),
    # active/standby HA (kubernetes_tpu/ha/): lease-based leader election
    # with generation fencing tokens on every dispatched write, plus the
    # ledger-warmed hot spare (StandbyScheduler tails the drain ledger +
    # watch stream and takes over via a warm resync). Off = the
    # single-instance fallback matrix documented in the README: electors
    # still work (server.py back-compat) but writes go unfenced and a
    # standby runs cold — takeover degrades to a full LIST + tensorize +
    # JIT warm-up.
    "ActiveStandbyHA": FeatureSpec(True, ALPHA),
    # pod-journey tracing (obs/journey.py): the columnar lifecycle ring
    # behind /debug/pod and the scheduler_e2e_segment_seconds families.
    # Off = no transition recording; the first-enqueue SLI clock is NOT
    # gated (the e2e bugfix holds regardless).
    "PodJourneyTracing": FeatureSpec(True, BETA),
    # on-device cluster analytics (ops/program.py cluster_probe): one
    # reduction over the resident carry per drain → utilization
    # percentiles, fragmentation/stranded indices, topology-domain
    # imbalance (/debug/cluster, scheduler_cluster_* gauges, flight
    # recorder, timeline).
    "ClusterStateProbe": FeatureSpec(True, BETA),
    # per-second telemetry timeline ring (obs/timeline.py):
    # /debug/timeline + the config-gated JSON-lines exporter
    # (timeline_export_path) + bench --timeline-dir.
    "TelemetryTimeline": FeatureSpec(True, BETA),
    # streaming drain pipeline (kubernetes_tpu/pipeline.py): the 3-stage
    # ingest / device / commit overlap engine — a background ingest stage
    # builds + dispatches the next drain while the device executes the
    # current one and a commit worker drains the _PendingDrain queue off
    # the critical path, with depth-capped backpressure between stages.
    # Off = StreamingPipeline refuses to start; callers fall back to the
    # lock-step schedule_pending() loop (same assignments, no overlap).
    "StreamingDrainPipeline": FeatureSpec(True, ALPHA),
    # kernel observatory (perf/observatory.py): per-dispatch device-time
    # attribution — run-wall histograms keyed (kernel, plan/shape,
    # backend), the per-drain device lane in the flight recorder and
    # Chrome trace, the sharded-lane profile, /debug/kernels and the
    # scheduler_kernel_*/scheduler_shard_* metric families. Process-
    # global like the compile ledger it extends.
    "KernelObservatory": FeatureSpec(True, BETA),
    # fleet observatory (obs/federation.py + obs/stitch.py): telemetry
    # federation over N sharded instances — shard/role-labeled fleet
    # exposition, ONE federated SLO burn per SLI (standbys excluded),
    # capacity-weighted fleet cluster probe (/debug/fleet) — and the
    # cross-shard journey stitcher behind the manager's /debug/pod.
    "FleetObservatory": FeatureSpec(True, ALPHA),
    # incident forensics (obs/incident.py): the watchdog over federated
    # SLO / divergence / fenced-write / pipeline-stall signals that
    # captures bounded evidence bundles to incidentDir, offline
    # verifiable by tools/incident_dump.py.
    "IncidentForensics": FeatureSpec(True, ALPHA),
    # critical-path observatory (perf/critical_path.py + costmodel.py):
    # per-drain bottleneck verdicts over {host_build, device_compute,
    # device_comms, commit, backpressure, idle} stamped on the flight
    # record and aggregated as scheduler_critical_path_seconds /
    # scheduler_bottleneck_drains_total; the device cost model
    # (cost_analysis flops/bytes, achieved-vs-modeled fraction per
    # kernel variant); /debug/criticalpath and the bench headroom block.
    "CriticalPathObservatory": FeatureSpec(True, BETA),
}


class FeatureGate:
    """featuregate.MutableFeatureGate (reduced): known map + overrides."""

    def __init__(self, known: dict[str, FeatureSpec] | None = None):
        self._known = dict(known if known is not None else DEFAULT_FEATURES)
        self._overrides: dict[str, bool] = {}

    def add(self, name: str, spec: FeatureSpec) -> None:
        """Register an out-of-tree feature (featuregate.Add)."""
        self._known[name] = spec

    def enabled(self, name: str) -> bool:
        if name in self._overrides:
            return self._overrides[name]
        spec = self._known.get(name)
        if spec is None:
            raise KeyError(f"unknown feature gate {name!r}")
        return spec.default

    def set(self, name: str, value: bool) -> None:
        spec = self._known.get(name)
        if spec is None:
            raise ValueError(
                f"unknown feature gate {name!r} (known: "
                f"{sorted(self._known)})")
        if spec.lock_to_default and value != spec.default:
            raise ValueError(
                f"feature gate {name!r} is {spec.stage} and locked to "
                f"{spec.default}")
        self._overrides[name] = value

    def set_from_map(self, overrides: dict[str, bool]) -> None:
        for name, value in overrides.items():
            self.set(name, bool(value))

    def known(self) -> dict[str, FeatureSpec]:
        return dict(self._known)


def default_gate(overrides: dict[str, bool] | None = None) -> FeatureGate:
    gate = FeatureGate()
    if overrides:
        gate.set_from_map(overrides)
    return gate
