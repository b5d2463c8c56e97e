"""scheduler_perf harness: YAML-driven workloads + throughput collection.

The port of kubernetes_tpu/perf/harness.py, which ports the reference
benchmark contract (test/integration/scheduler_perf/scheduler_perf.go):
- testCases loaded from YAML (`:1217` RunBenchmarkPerfScheduling): each has a
  `workloadTemplate` of ops and parameterized `workloads` with an optional
  `threshold` (minimum average pods/s, the failure gate, `:375-430`).
- op registry (`:518-552`): createNodes, createPods (collectMetrics),
  createWorkloads, gangTrace, churn, barrier, sleep. streamPods and
  streamTrace need the streaming pipeline, which is not ported yet.
- throughputCollector (util.go:457-660): average scheduled-pods/s over the
  measured phase, plus percentile summaries of per-batch scheduling rates.

The measured window covers creation + ingestion + scheduling + binds, like
the reference's wall-clock sampler: pods stream in `createBatch`-sized
chunks (default 512), each chunk is dispatched without waiting
(`schedule_pending(wait=False)`, the async commit pipeline), and the
collector samples cumulative scheduled counts per chunk. The window runs
with the cyclic garbage collector paused (utils/runtime.py).

The scheduler factory builds each run's Scheduler on `device` ("cuda"
unless the caller asks for "cpu").
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from ..api.types import PodStatus
from ..backend.apiserver import APIServer
from ..scheduler import Scheduler
from ..testing.wrappers import _counter
from ..testing.wrappers import make_node, make_pod

LABEL_ZONE = "topology.kubernetes.io/zone"
LABEL_HOSTNAME = "kubernetes.io/hostname"


@dataclass
class Workload:
    name: str
    params: dict
    labels: list[str] = field(default_factory=list)
    threshold: float = 0.0


@dataclass
class TestCase:
    name: str
    workload_template: list[dict]
    workloads: list[Workload]
    default_pod_template: Optional[dict] = None


def load_test_cases(path: str) -> list[TestCase]:
    import yaml
    with open(path) as f:
        raw = yaml.safe_load(f)
    cases = []
    for tc in raw:
        workloads = [Workload(name=w["name"], params=w.get("params", {}),
                              labels=w.get("labels", []),
                              threshold=w.get("threshold", 0.0))
                     for w in tc.get("workloads", [])]
        cases.append(TestCase(name=tc["name"],
                              workload_template=tc["workloadTemplate"],
                              workloads=workloads,
                              default_pod_template=tc.get("defaultPodTemplate")))
    return cases


def _resolve(op: dict, key: str, params: dict, default=None):
    """countParam: $foo indirection (scheduler_perf.go op params)."""
    pkey = op.get(key + "Param")
    if pkey is not None:
        return params[pkey.lstrip("$")]
    return op.get(key, default)


@dataclass
class DataItem:
    """One measured phase (util.go DataItem)."""

    name: str
    average: float          # pods/s over the measured phase
    perc50: float = 0.0     # per-window rate percentiles
    perc95: float = 0.0
    perc99: float = 0.0
    pods: int = 0
    duration_s: float = 0.0
    samples: int = 0        # rate windows behind the percentiles
    start: float = 0.0      # the window's start, time.perf_counter()
    # per-op wall times for the WHOLE workload run, as ("opcode[i]", s)
    # pairs — lets a caller report phases OUTSIDE the measured window
    # (e.g. PreemptionChurn's preemptor wave) without widening it
    op_seconds: list = field(default_factory=list)
    # scheduler-side breakdown (drain phase seconds, wave count) of the
    # run
    extras: dict = field(default_factory=dict)


class ThroughputCollector:
    """Samples cumulative scheduled-pod counts over the measured phase
    (reference throughputCollector, scheduler_perf/util.go:457-660: a
    free-running sampler of scheduled pods/interval). The op loop calls
    `sample()` after every ingest+dispatch step — the measured window
    INCLUDES pod creation and event-handler ingestion, exactly like the
    reference's wall-clock sampling — and percentiles come from the
    per-window rates (one window ≈ one create batch)."""

    def __init__(self) -> None:
        self.samples_: list[tuple[float, int]] = []
        self.start = 0.0
        self.elapsed = 0.0
        self.base = 0
        self.pods = 0

    def begin(self, scheduled_total: int = 0) -> None:
        self.base = scheduled_total
        self.start = time.perf_counter()
        self.samples_ = [(self.start, scheduled_total)]

    def sample(self, scheduled_total: int) -> None:
        self.samples_.append((time.perf_counter(), scheduled_total))

    def end(self, scheduled_total: int) -> None:
        self.sample(scheduled_total)
        self.elapsed = time.perf_counter() - self.start
        self.pods = scheduled_total - self.base

    def item(self, name: str) -> DataItem:
        # rate per commit span: zero-progress windows (the async pipeline
        # holds results in flight for several chunks) are MERGED into the
        # span that finally commits, so a lumpy commit cadence cannot
        # inflate the percentiles — each rate is Δpods/Δt between
        # consecutive points where the scheduled count actually advanced
        rates = []
        t0, c0 = self.samples_[0] if self.samples_ else (0.0, 0)
        for t1, c1 in self.samples_[1:]:
            if c1 > c0 and t1 > t0:
                rates.append((c1 - c0) / (t1 - t0))
                t0, c0 = t1, c1
        rates.sort()

        def perc(p: float) -> float:
            if not rates:
                return 0.0
            return rates[min(len(rates) - 1, int(p * len(rates)))]

        avg = self.pods / self.elapsed if self.elapsed > 0 else 0.0
        return DataItem(name=name, average=avg, perc50=perc(0.50),
                        perc95=perc(0.95), perc99=perc(0.99),
                        pods=self.pods, duration_s=self.elapsed,
                        samples=len(rates), start=self.start)


def _make_nodes(api: APIServer, count: int, start: int, params: dict) -> None:
    cpu = params.get("nodeCpu", 32)
    mem = params.get("nodeMemoryGi", 64)
    zones = params.get("zones", 16)
    for i in range(start, start + count):
        api.create_node(
            make_node(f"node-{i}")
            .capacity({"cpu": cpu, "memory": f"{mem}Gi", "pods": 110})
            .zone(f"zone-{i % zones}")
            .label(LABEL_HOSTNAME, f"node-{i}")
            .obj())


def _pod_from_template(name: str, template: Optional[dict], seq: int = 0,
                       zones: int = 16, gang_size: int = 1):
    w = make_pod(name)
    t = template or {}
    cpu = t.get("cpu", "900m")
    cyc = int(t.get("signatureCycle", 0))
    if cyc:
        # rotate the cpu request over `cyc` distinct values: consecutive
        # pods then interleave `cyc` distinct signatures (every other
        # template field — labels, spread, affinity — identical), the
        # high-signature mixed-drain shape the drain compiler maps to one
        # plan program (MixedHighSignature workload)
        cpu = f"{250 + 50 * (seq % cyc)}m"
    w = w.req({"cpu": cpu, "memory": t.get("memory", "1Gi")})
    if t.get("priority"):
        w = w.priority(int(t["priority"]))
    for k, v in t.get("labels", {}).items():
        w = w.label(k, v)
    if t.get("nodeSelectorZone"):
        w = w.node_selector({LABEL_ZONE: f"zone-{seq % zones}"})
    if "spreadZone" in t:
        w = w.spread_constraint(t.get("maxSkew", 1), LABEL_ZONE,
                                t.get("whenUnsatisfiable", "DoNotSchedule"),
                                t["spreadZone"])
    if "podAntiAffinity" in t:
        w = w.pod_affinity(t.get("topologyKey", LABEL_ZONE),
                           t["podAntiAffinity"], anti=True)
    if "podAffinity" in t:
        w = w.pod_affinity(t.get("topologyKey", LABEL_ZONE), t["podAffinity"])
    if "workloadRef" in t:
        ref = t["workloadRef"].replace("$gang", str(seq // max(gang_size, 1)))
        w = w.workload(ref.replace("$seq", str(seq)))
    return w.obj()


class PodFactory:
    """Stamps pods from shared prototypes: metadata (and status) are fresh
    per pod; the spec and label-dict OBJECTS are shared, per the object
    model's aliasing contract (api/types.py) — which is also what makes
    the builder's identity signature cache hit (state/batch.py). Template
    fields that genuinely vary per pod fall back to full construction."""

    def __init__(self, template: Optional[dict], zones: int = 16,
                 gang_size: int = 1):
        self.template = template or {}
        self.zones = zones
        self.gang_size = max(gang_size, 1)
        t = self.template
        self.per_seq = "workloadRef" in t
        self.zone_protos = None
        if t.get("nodeSelectorZone") and not self.per_seq:
            self.zone_protos = [
                _pod_from_template(f"proto-z{z}", t, seq=z, zones=zones)
                for z in range(zones)]
        self.cycle_protos = None
        cyc = int(t.get("signatureCycle", 0))
        if cyc and not self.per_seq and self.zone_protos is None:
            # one shared prototype per signature in the cycle: pods
            # sharing a prototype share spec identity, so the builder's
            # signature cache hits while the drain still interleaves
            # `cyc` distinct signatures
            self.cycle_protos = [
                _pod_from_template(f"proto-c{c}", t, seq=c, zones=zones)
                for c in range(cyc)]
        self.proto = _pod_from_template("proto", t, seq=0, zones=zones,
                                        gang_size=self.gang_size)

    # every pod stamped from a proto shares this empty status shape; the
    # copies below are safe because status mutations in the object model
    # REPLACE fields (apiserver patch semantics), never mutate the
    # shared conditions list in place
    _STATUS_PROTO = PodStatus()

    def make(self, name: str, seq: int):
        # inlined shallow copies + hoisted imports: this runs once per
        # created pod inside the measured window — the client-side cost
        # the reference benchmark's QPS-bound createPods pays too
        if self.per_seq:
            return _pod_from_template(name, self.template, seq=seq,
                                      zones=self.zones,
                                      gang_size=self.gang_size)
        if self.cycle_protos is not None:
            proto = self.cycle_protos[seq % len(self.cycle_protos)]
        elif self.zone_protos is not None:
            proto = self.zone_protos[seq % self.zones]
        else:
            proto = self.proto
        new = object.__new__
        p = new(type(proto))
        p.__dict__.update(proto.__dict__)
        meta = proto.metadata
        m = new(type(meta))
        m.__dict__.update(meta.__dict__)
        m.name = name
        m.uid = f"{m.namespace}/{name}"
        m.creation_index = next(_counter)
        p.metadata = m
        st = new(PodStatus)
        st.__dict__.update(self._STATUS_PROTO.__dict__)
        p.status = st
        return p


class WorkloadRunner:
    """Executes one workload's op list against a fresh Scheduler."""

    def __init__(self, scheduler_factory: Optional[Callable[[APIServer], Scheduler]] = None,
                 batch_size: int = 8192, create_batch: int = 512,
                 trace: bool = False, device=None):
        # `create_batch` streams pods in realistic chunks (the reference
        # benchmark's createPods ingestion rate is bounded by client
        # QPS/Burst 5000, util.go:123-124); the async commit pipeline
        # overlaps each chunk's device readback with the next chunk's
        # ingestion, so small chunks do not serialize on the device
        # round trip. `batch_size` only caps a single drain.
        self.batch_size = batch_size
        self.create_batch = create_batch
        self.trace = trace
        self.device = device
        self.last_tracer = None
        self.last_scheduler: Optional[Scheduler] = None
        self.last_op_seconds: list = []
        self.factory = scheduler_factory or self._default_factory

    def _default_factory(self, api: APIServer) -> Scheduler:
        return Scheduler(api, batch_size=self.batch_size, device=self.device)

    def run(self, tc: TestCase, wl: Workload, verbose: bool = False) -> list[DataItem]:
        # serve the measured window with the cyclic collector paused
        # (utils/runtime.py): drain-chunk allocation churn otherwise
        # triggers gen-2 collections inside the commit tail (the JAX
        # package measured them as its dominant commit_s cost). Restored
        # (with a full collect) on exit, so the surrounding process sees
        # normal GC.
        from ..utils.runtime import scheduling_gc_pause
        with scheduling_gc_pause():
            return self._run_ops(tc, wl, verbose)

    def _run_ops(self, tc: TestCase, wl: Workload,
                 verbose: bool = False) -> list[DataItem]:
        api = APIServer()
        sched = self.last_scheduler = self.factory(api)
        if self.trace:
            # capture EVERY cycle's span tree (host split, Chrome-trace
            # export): slow-threshold inf keeps the slow ring
            # quiet, keep_recent retains the full drain history
            from ..utils.tracing import Tracer
            self.last_tracer = sched.tracer = Tracer(
                slow_threshold_s=float("inf"), keep_recent=65536)
        params = wl.params
        items: list[DataItem] = []
        node_seq = 0
        pod_seq = 0
        op_times: list[tuple[str, float]] = []
        for op_i, op in enumerate(tc.workload_template):
            code = op["opcode"]
            t_op = time.perf_counter()
            if code == "createNodes":
                count = int(_resolve(op, "count", params))
                _make_nodes(api, count, node_seq, params)
                node_seq += count
                # informer-sync analog (reference WaitForCacheSync runs
                # before the measured phase): build snapshot + device
                # staging now, not inside the first scheduling cycle
                sched.prime()
            elif code == "createPods":
                count = int(_resolve(op, "count", params))
                template = op.get("podTemplate", tc.default_pod_template)
                collect = op.get("collectMetrics", False)
                factory = PodFactory(template,
                                     zones=params.get("zones", 16),
                                     gang_size=int(params.get("gangSize", 1)))
                col = ThroughputCollector() if collect else None
                if col:
                    col.begin(sched.scheduled_count)
                created = 0
                create_batch = int(op.get("createBatch", self.create_batch))
                make = factory.make
                while created < count:
                    n = min(create_batch, count - created)
                    base = pod_seq + created
                    api.create_pods([make(f"pod-{base + i}", base + i)
                                     for i in range(n)])
                    created += n
                    # dispatch without waiting: the device results of this
                    # chunk commit while the next chunk is being created
                    sched.schedule_pending(wait=False)
                    if col:
                        col.sample(sched.scheduled_count)
                    if verbose:
                        print(f"  createPods: {created}/{count} "
                              f"scheduled={sched.scheduled_count}")
                # final full drain: dispatch whatever accumulated under the
                # adaptive batcher, then barrier the commit pipeline
                sched.schedule_pending()
                pod_seq += count
                if col:
                    col.end(sched.scheduled_count)
                    items.append(col.item(f"{tc.name}/{wl.name}"))
            elif code in ("streamPods", "streamTrace"):
                raise NotImplementedError(
                    f"opcode {code}: the open-loop arrival driver needs the "
                    "streaming drain pipeline (pipeline.py), which is not "
                    "ported to kubernetes_tpu_torch yet")
            elif code == "gangTrace":
                # trace-driven gang traffic (testing/workloads.py): LLM
                # training gangs + co-located inference + gangs-preempt-
                # gangs, streamed in arrival chunks like createPods
                from ..testing.workloads import GangWorkloadGenerator
                gen = GangWorkloadGenerator(
                    seed=int(op.get("seed", params.get("seed", 0))))
                gangs = int(_resolve(op, "gangs", params, 0))
                gang_size = _resolve(op, "gangSize", params, None)
                size = (int(gang_size) if gang_size is not None
                        else (int(op.get("gangSizeMin", 8)),
                              int(op.get("gangSizeMax", 512))))
                specs = gen.training_gangs(
                    gangs, size=size,
                    min_count_frac=float(op.get("minCountFrac", 1.0)),
                    cpu=op.get("gangCpu", "900m"),
                    memory=op.get("gangMemory", "1Gi"),
                    priority=int(op.get("gangPriority", 0)))
                pre_specs = gen.training_gangs(
                    int(_resolve(op, "preemptorGangs", params, 0)),
                    size=int(op.get("preemptorSize", 8)),
                    cpu=op.get("preemptorCpu", "900m"),
                    memory=op.get("gangMemory", "1Gi"),
                    priority=int(op.get("preemptorPriority", 200)),
                    prefix="preemptor")
                contig = op.get("contiguityWeight",
                                params.get("contiguityWeight"))
                if contig is not None:
                    sched.gang_contiguity_weight = int(contig)
                collect = op.get("collectMetrics", False)
                col = ThroughputCollector() if collect else None
                if col:
                    col.begin(sched.scheduled_count)
                create_batch = int(op.get("createBatch", self.create_batch))
                for kind, obj in gen.trace(
                        specs,
                        inference_count=int(
                            _resolve(op, "inferencePods", params, 0)),
                        inference_cpu=op.get("inferenceCpu", "250m"),
                        inference_priority=int(
                            op.get("inferencePriority", 100)),
                        preemptor_gangs=pre_specs,
                        chunk=create_batch):
                    if kind == "workload":
                        api.create_workload(obj)
                        continue
                    api.create_pods(obj)
                    sched.schedule_pending(wait=False)
                    if col:
                        col.sample(sched.scheduled_count)
                    if verbose:
                        print(f"  gangTrace: scheduled="
                              f"{sched.scheduled_count}")
                sched.schedule_pending()
                if col:
                    col.end(sched.scheduled_count)
                    items.append(col.item(f"{tc.name}/{wl.name}"))
            elif code == "createWorkloads":
                from ..api.types import ObjectMeta, PodGroup, Workload
                count = int(_resolve(op, "count", params, 1))
                min_count = int(_resolve(op, "minCount", params, 1))
                prefix = op.get("namePrefix", "wl")
                for i in range(count):
                    api.create_workload(Workload(
                        metadata=ObjectMeta(name=f"{prefix}-{i}"),
                        pod_groups=[PodGroup(name="workers",
                                             min_count=min_count)]))
            elif code == "barrier":
                deadline = time.time() + float(op.get("timeoutSeconds", 60))
                while len(sched.queue) and time.time() < deadline:
                    sched.flush_queues()
                    if sched.schedule_pending() == 0:
                        # nothing schedulable right now: wait for backoffs
                        # instead of spinning the drain loop
                        time.sleep(0.05)
            elif code == "churn":
                # churn mode "recreate" (scheduler_perf.go:870): create and
                # delete pods/nodes repeatedly to exercise event handling
                number = int(_resolve(op, "number", params, 100))
                for i in range(number):
                    name = f"churn-{i}"
                    api.create_pod(_pod_from_template(name, tc.default_pod_template))
                    sched.schedule_pending()
                    api.delete_pod(f"default/{name}")
            elif code == "sleep":
                time.sleep(float(op.get("duration", op.get("seconds", 0.1))))
            else:
                raise ValueError(f"unknown opcode {code}")
            op_times.append((f"{code}[{op_i}]", time.perf_counter() - t_op))
        self.last_op_seconds = op_times
        # the drain phases summed over the run's committed drains (the
        # JAX package reads the same sums from its drain_phase histogram)
        ph = sched.drain_phase_seconds
        extras = {
            "host_build_s": round(ph.get("host_build", 0.0), 3),
            "device_s": round(ph.get("device_dispatch", 0.0)
                              + ph.get("device_wait", 0.0), 3),
            "commit_s": round(ph.get("commit", 0.0), 3),
            "host_snapshot_s": round(ph.get("host_snapshot", 0.0), 3),
            "host_tensorize_s": round(ph.get("host_tensorize", 0.0), 3),
            "host_group_seed_s": round(ph.get("host_group_seed", 0.0), 3),
            "host_cache_s": round(ph.get("host_cache", 0.0), 3),
        }
        waves = sched.wave_stats["waves"]
        if waves:
            extras["waves"] = int(waves)
        for item in items:
            item.op_seconds = list(op_times)
            item.extras = dict(extras)
        return items
