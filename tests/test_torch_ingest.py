"""The columnar ingest & commit engine: kubernetes_tpu_torch/ingest/ ↔
kubernetes_tpu/ingest/, and the port's two ColumnarIngest settings
against each other, exact equality throughout.

- the chunked `BatchBuilder.build` (ingest/columns.py fill_rows) over
  fuzzed pod mixes against the JAX package's build and the port's own
  per-pod `_lookup` build (the gate off): every PodTable field bit for
  bit, the valid / fallback / sig / tidx vectors, the table's version
  and capacity and the `row_facts` column;
- the columnar node-row writers (ingest/noderows.py) inside
  `ClusterState.apply_snapshot` against the serial writers (the gate
  off) and the JAX package's ClusterState: NodeArrays, the dirty rows and
  `statics_gen` after a prime, a relabel, assume churn, a removal and
  capacity edges that fall back to the serial writers;
- `gather_ids` and `NodeLabelColumns` (ingest/groupcols.py, moved out of
  ops/groups.py) against the JAX package's;
- end-state parity of whole workloads (tests/test_ingest.py's 24 nodes,
  120 pods in chunks of 40, with and without infeasible pods; a gang
  drain; a Permit-hook gang member outside a gang drain; a preemption
  with its nomination): the port with the gate on, the port with it off
  and the JAX Scheduler (gate on) reach the same bind map, cache,
  assumed pods, dispatcher counts, queue and counters;
- the bulk bind echo's off-shape cases, each against the per-pod
  informer path on a twin scheduler;
- the readers of a QueuedPodInfo's pod after the engine rebinds it to
  the assumed copy: the sanitizer rails' held-carry check, nominations,
  the gang paths, explain_pod and the bind-error requeue."""

import random

import numpy as np
import pytest
import torch

import kubernetes_tpu  # noqa: F401  (x64 before any jnp array)
from _torch_parity import private_jax_compiles  # noqa: F401
from kubernetes_tpu.api import types as jtypes
from kubernetes_tpu.backend import apiserver as japiserver
from kubernetes_tpu.backend.apiserver import APIServer as JApi
from kubernetes_tpu.backend.cache import Cache as JCache
from kubernetes_tpu.backend.cache import Snapshot as JSnapshot
from kubernetes_tpu.ingest import groupcols as jgroupcols
from kubernetes_tpu.scheduler import Scheduler as JSched
from kubernetes_tpu.state.batch import BatchBuilder as JBuilder
from kubernetes_tpu.state.tensorize import ClusterState as JState
from kubernetes_tpu.testing import wrappers as jw
from kubernetes_tpu_torch.api import types as ttypes
from kubernetes_tpu_torch.backend import apiserver as tapiserver
from kubernetes_tpu_torch.backend.apiserver import APIServer as TApi
from kubernetes_tpu_torch.backend.cache import Cache as TCache
from kubernetes_tpu_torch.backend.cache import Snapshot as TSnapshot
from kubernetes_tpu_torch.config import KubeSchedulerConfiguration
from kubernetes_tpu_torch.ingest import groupcols as tgroupcols
from kubernetes_tpu_torch.ingest import noderows as tnoderows
from kubernetes_tpu_torch.scheduler import Scheduler as TSched
from kubernetes_tpu_torch.state.batch import BatchBuilder as TBuilder
from kubernetes_tpu_torch.state.batch import PodTable
from kubernetes_tpu_torch.state.tensorize import ClusterState as TState
from kubernetes_tpu_torch.testing import wrappers as tw

torch.set_num_threads(1)

ZONE = "topology.kubernetes.io/zone"
HOSTNAME = "kubernetes.io/hostname"


# ---------------------------------------------------------------------------
# the chunked build


def _fuzz_pod(w, rng: random.Random, i: int):
    """tests/test_ingest.py's fuzz pod, from either package's wrappers."""
    b = w.make_pod(f"pod-{i}").req(
        {"cpu": f"{rng.choice([100, 250, 500, 900])}m",
         "memory": f"{rng.choice([256, 512, 1024])}Mi"})
    if rng.random() < 0.3:
        b = b.label("app", rng.choice(["web", "db", "cache"]))
    if rng.random() < 0.25:
        b = b.node_selector({ZONE: f"zone-{rng.randrange(4)}"})
    if rng.random() < 0.2:
        b = b.toleration(key="dedicated", operator="Equal",
                         value=rng.choice(["gpu", "infra"]),
                         effect="NoSchedule")
    if rng.random() < 0.2:
        b = b.node_affinity_in(
            ZONE, [f"zone-{z}" for z in range(rng.randrange(1, 4))])
    if rng.random() < 0.15:
        b = b.preferred_node_affinity_in(ZONE, ["zone-0", "zone-1"],
                                         weight=rng.randrange(1, 50))
    if rng.random() < 0.15:
        b = b.spread_constraint(rng.randrange(1, 3), ZONE, "DoNotSchedule",
                                {"app": "web"})
    if rng.random() < 0.1:
        b = b.pod_affinity(ZONE, {"app": "db"}, anti=True)
    if rng.random() < 0.1:
        b = b.host_port(8000 + rng.randrange(16))
    if rng.random() < 0.1:
        b = b.container({"cpu": "50m"}, image=f"img-{rng.randrange(4)}:v1")
    if rng.random() < 0.08:
        b = b.pvc(f"claim-{i}")        # a fallback: one key a claim
    if rng.random() < 0.06:
        for t in range(9):             # tolerations past their padding
            b = b.toleration(key=f"k{t}", operator="Exists")
    return b.obj()


def _fuzz_chunks(w, seed: int) -> list:
    """Four chunks: three fuzzed, then the first again (identity hits)
    with fresh pods mixed in."""
    rng = random.Random(seed)
    chunks, off = [], 0
    for _ in range(3):
        n = rng.randrange(20, 48)
        chunks.append([_fuzz_pod(w, rng, off + i) for i in range(n)])
        off += n
    chunks.append(chunks[0] + [_fuzz_pod(w, rng, off + i)
                               for i in range(12)])
    return chunks


def _edge_chunks(w) -> list:
    """One chunk with 20 new signatures (the table of 16 grows in mid
    chunk, right after fallbacks), pvc pods whose distinct content keys
    share one fallback entry, a padding overflow, host-port rows
    (signature 0) and repeats; then a chunk of repeats and new rows."""
    pods = []
    for i in range(20):
        pods.append(w.make_pod(f"a{i}").req({"cpu": "100m"})
                    .label("app", f"a{i}").obj())
        if i % 4 == 3:
            pods.append(w.make_pod(f"v{i}").req({"cpu": "100m"})
                        .pvc(f"claim-{i}").obj())
        if i == 14:
            b = w.make_pod("tol").req({"cpu": "1"})
            for t in range(9):
                b = b.toleration(key=f"k{t}", operator="Exists")
            pods.append(b.obj())
        if i % 5 == 0:
            pods.append(w.make_pod(f"hp{i}").req({"cpu": "100m"})
                        .host_port(9000 + i).obj())
    pods += [w.make_pod(f"r{i}").req({"cpu": "100m"})
             .label("app", f"a{i}").obj() for i in range(6)]
    second = [w.make_pod(f"b{i}").req({"cpu": "200m"})
              .label("app", f"b{i}").obj() for i in range(10)]
    second += [w.make_pod(f"v2-{i}").req({"cpu": "100m"})
               .pvc(f"c2-{i}").obj() for i in range(3)]
    return [pods, second + pods[:7]]


def _facts(builder) -> list:
    return [tuple(f) for f in builder.row_facts]


def _assert_builds_equal(got, got_b, want, want_b, where: str):
    for f in ("valid", "host_fallback", "sig", "tidx"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f"{where}: {f}")
    assert got.table_version == want.table_version, where
    for name in PodTable._fields:
        a, b = getattr(got_b.table, name), getattr(want_b.table, name)
        assert a.dtype == b.dtype, f"{where}: PodTable.{name}"
        np.testing.assert_array_equal(a, b, err_msg=f"{where}: "
                                      f"PodTable.{name}")
    assert (got_b.table_used, got_b.dims.table_rows, got_b.reset_count,
            got_b._next_sig) == (want_b.table_used, want_b.dims.table_rows,
                                 want_b.reset_count, want_b._next_sig), where
    assert len(got_b.row_facts) == got_b.table_used, where
    assert _facts(got_b) == _facts(want_b), where


def _build_all(jchunks, tchunks, tchunks_serial, pad_to=16):
    jb = JBuilder(JState())
    tb = TBuilder(TState(device="cpu"))
    sb = TBuilder(TState(device="cpu"), columnar=False)
    assert tb.columnar and not sb.columnar
    for c, (jp, tp, sp) in enumerate(zip(jchunks, tchunks, tchunks_serial)):
        want = jb.build(jp, pad_to=pad_to)
        got = tb.build(tp, pad_to=pad_to)
        serial = sb.build(sp, pad_to=pad_to)
        _assert_builds_equal(got, tb, want, jb, f"chunk {c} vs JAX")
        _assert_builds_equal(got, tb, serial, sb, f"chunk {c} vs _lookup")
    return tb


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chunked_build_equals_jax_and_the_per_pod_build(seed):
    tb = _build_all(_fuzz_chunks(jw, seed), _fuzz_chunks(tw, seed),
                    _fuzz_chunks(tw, seed))
    assert tb.dims.table_rows > 16     # the table grew


def test_chunked_build_edges(monkeypatch):
    from kubernetes_tpu_torch.ingest import columns
    calls = []
    real = columns.fill_rows

    def spy(builder, pods):
        out = real(builder, pods)
        calls.append([e[0] for e in out])
        return out
    monkeypatch.setattr(columns, "fill_rows", spy)
    tb = _build_all(_edge_chunks(jw), _edge_chunks(tw), _edge_chunks(tw))
    # the gate-on builder interned through fill_rows, one call a chunk,
    # with fallbacks among the new signatures
    assert len(calls) == 2 and "fallback" in calls[0]
    assert tb.table_used == 34 and tb.dims.table_rows == 64
    fb = {e for e in tb._sig_cache.values() if e[0] == "fallback"}
    assert ("fallback", "pod has volumes") in fb
    assert ("fallback", "too many tolerations") in fb


def test_chunked_build_keys_a_template_once(monkeypatch):
    """Pods stamped from one template (the harness's PodFactory: shared
    spec and label objects) compute the content key once a chunk, new
    signature or not, as the per-pod build does."""
    from kubernetes_tpu_torch.perf.harness import PodFactory
    calls = []
    real = TBuilder._sig_key
    monkeypatch.setattr(TBuilder, "_sig_key", staticmethod(
        lambda pod: calls.append(pod.uid) or real(pod)))
    factory = PodFactory({"cpu": "900m", "memory": "1Gi",
                          "signatureCycle": 4})
    for columnar in (True, False):
        calls.clear()
        b = TBuilder(TState(device="cpu"), columnar=columnar)
        batch = b.build([factory.make(f"p{i}", i) for i in range(64)])
        assert len(calls) == 4 and b.table_used == 4
        assert batch.valid[:64].all()


def test_row_facts_replaced_on_reset():
    tb = TBuilder(TState(device="cpu"))
    tb.build([tw.make_pod("p").req({"cpu": "1"}).obj()])
    held = tb.row_facts
    tb._reset_table()
    assert tb.row_facts is not held and tb.row_facts == [] and len(held) == 1


# ---------------------------------------------------------------------------
# the node-row writers


def _node(w, name: str, rng: random.Random, images: int = 0, extra=None):
    cap = {"cpu": 8 + rng.randrange(8), "memory": "16Gi", "pods": 110}
    if extra:
        cap.update(extra)
    b = (w.make_node(name).capacity(cap).zone(f"z{rng.randrange(3)}")
         .label(HOSTNAME, name).label("idx", str(rng.randrange(100))))
    if rng.random() < 0.3:
        b = b.taint("t", f"v{rng.randrange(3)}",
                    rng.choice(["NoSchedule", "PreferNoSchedule"]))
    if rng.random() < 0.2:
        b = b.unschedulable()
    for k in range(images or (2 if rng.random() < 0.3 else 0)):
        b = b.image(f"img-{k}:v1", (k + 1) * 1024 * 1024)
    return b.obj()


class _Side:
    """One package's cache, snapshot and ClusterState, driven in step."""

    def __init__(self, kind: str):
        self.kind = kind
        if kind == "jax":
            self.w, self.types = jw, jtypes
            self.cache, self.snap, self.state = JCache(), JSnapshot(), JState()
        else:
            self.w, self.types = tw, ttypes
            self.cache, self.snap = TCache(), TSnapshot()
            self.state = TState(device="cpu", columnar=(kind == "on"))
        self.nodes: dict = {}
        self.rng = random.Random(11)

    def add(self, name: str, **kw):
        self.nodes[name] = _node(self.w, name, self.rng, **kw)
        self.cache.add_node(self.nodes[name])

    def relabel(self, name: str):
        import dataclasses
        old = self.nodes[name]
        meta = dataclasses.replace(old.metadata, labels={
            **old.metadata.labels, "idx": "relabeled"})
        new = dataclasses.replace(old, metadata=meta)
        self.cache.update_node(old, new)
        self.nodes[name] = new

    def assume(self, pod_name: str, node: str, port: int = 0):
        b = self.w.make_pod(pod_name).req({"cpu": "300m", "memory": "1Gi"})
        if port:
            b = b.host_port(port)
        self.cache.assume_pod(b.obj().with_node_name(node))

    def remove(self, name: str):
        self.cache.remove_node(self.nodes.pop(name))

    def apply(self):
        self.cache.update_snapshot(self.snap)
        self.state.apply_snapshot(self.snap)
        st = self.state
        seen = (st.arrays, None if st._dirty_rows is None
                else sorted(st._dirty_rows), st.statics_gen)
        if st._dirty_rows is not None:
            st._dirty_rows = set()    # as an upload would
        return seen


def test_node_row_writers_equal_serial_and_jax(monkeypatch):
    results = []
    for fn in ("write_rows", "write_aggregate_rows"):
        real = getattr(tnoderows, fn)

        def spy(state, items, _real=real, _fn=fn):
            ok = _real(state, items)
            results.append((_fn, len(items), ok))
            return ok
        monkeypatch.setattr(tnoderows, fn, spy)
    sides = [_Side("jax"), _Side("on"), _Side("off")]

    def step(what, fn):
        for s in sides:
            fn(s)
        seen = [s.apply() for s in sides]
        ref = seen[0]
        for s, (arrays, dirty, gen) in zip(sides[1:], seen[1:]):
            for name in type(ref[0])._fields:
                a, b = getattr(ref[0], name), getattr(arrays, name)
                assert a.dtype == b.dtype, f"{what}: {name}"
                np.testing.assert_array_equal(
                    b, a, err_msg=f"{what}: NodeArrays.{name} ({s.kind})")
            assert dirty == ref[1], f"{what}: dirty rows ({s.kind})"
            assert gen == ref[2], f"{what}: statics_gen ({s.kind})"

    step("prime", lambda s: [s.add(f"n{i}") for i in range(20)])
    step("relabel", lambda s: [s.relabel(f"n{i}") for i in range(17)])
    step("assume churn", lambda s: [s.assume(f"p{i}", f"n{i}")
                                    for i in range(18)])
    step("ports (serial aggregates)", lambda s: (
        s.assume("hp", "n0", port=8080),
        [s.assume(f"q{i}", f"n{i}") for i in range(1, 18)]))
    step("removal", lambda s: (s.remove("n3"), s.remove("n7")))
    step("small update", lambda s: [s.relabel(f"n{i}") for i in (1, 2)])
    step("resource growth", lambda s: [
        s.add(f"g{i}", extra={"example.com/gpu": 4}) for i in range(16)])
    step("image growth", lambda s: [s.add(f"m{i}", images=40)
                                    for i in range(16)])
    step("after growth", lambda s: [s.assume(f"r{i}", f"g{i}")
                                    for i in range(16)])
    # the gate-off side never called the columnar writers; the gate-on
    # side took them and fell back at each capacity edge
    assert ("write_rows", 20, True) in results
    assert ("write_rows", 17, True) in results
    assert ("write_aggregate_rows", 18, True) in results
    assert ("write_aggregate_rows", 18, False) in results    # the port
    assert ("write_rows", 16, False) in results              # growth
    assert len(results) == sum(1 for r in results) and all(
        n >= 16 for _fn, n, _ok in results)


# ---------------------------------------------------------------------------
# the group label columns


def test_groupcols_moved_and_equal_to_jax():
    from kubernetes_tpu_torch.ops import groups
    assert groups.gather_ids is tgroupcols.gather_ids
    assert groups.NodeLabelColumns is tgroupcols.NodeLabelColumns
    rng = random.Random(3)
    for _ in range(50):
        n = rng.randrange(1, 200)
        tv = np.array([rng.randrange(0, 12) for _ in range(n)], np.int32)
        table = {k: rng.randrange(1, 100)
                 for k in rng.sample(range(1, 12), rng.randrange(0, 8))}
        want = jgroupcols.gather_ids(tv, table)
        got = tgroupcols.gather_ids(tv, table)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    jside, tside = _Side("jax"), _Side("on")
    cols = []
    for side, mod in ((jside, jgroupcols), (tside, tgroupcols)):
        for i in range(12):
            side.add(f"n{i}")
        side.apply()
        cols.append(mod.NodeLabelColumns(side.state))

    def views(side, c):
        nis = [(side.state.node_index[ni.name], ni)
               for ni in side.snap.node_info_list]
        c.sync(nis)
        return (c.order_idx.tolist(), c.tv(ZONE).tolist(),
                c.dom(ZONE).tolist(), c.keys_ok((ZONE, HOSTNAME)).tolist(),
                c.tv("idx").tolist(),
                c.value_ids(ZONE, {"z0": 3, "z2": 5}))
    assert views(tside, cols[1]) == views(jside, cols[0])
    before = views(tside, cols[1])
    for side in (jside, tside):
        side.relabel("n4")
        side.apply()
    after = views(tside, cols[1])
    assert after == views(jside, cols[0]) and after[4] != before[4]


# ---------------------------------------------------------------------------
# end-state parity: the port gate on / off, the JAX package gate on


class _Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def _sched(kind: str, batch_size: int = 256):
    """(wrappers, types, api, scheduler, clock) of `kind`: "jax" (the JAX
    Scheduler, gate on), "on" / "off" (the port with the ColumnarIngest
    gate on / off)."""
    clock = _Clock()
    if kind == "jax":
        api = JApi()
        sched = JSched(api, batch_size=batch_size, clock=clock)
        sched.profiler = None
        sched.audit = None
        sched._probe_enabled = False
        w, types = jw, jtypes
    else:
        api = TApi()
        sched = TSched(api, batch_size=batch_size, clock=clock,
                       device="cpu", config=KubeSchedulerConfiguration(
                           feature_gates={"ColumnarIngest": kind == "on"}))
        assert (sched.commit_engine is not None) == (kind == "on")
        w, types = tw, ttypes
    sched.dispatcher.sleep = lambda _s: None
    return w, types, api, sched, clock


def _node_facts(sched) -> dict:
    """What the commit writes into each cached NodeInfo beyond the dump:
    the nonzero requests, the host ports and the affinity lists."""
    return {n: (item.info.non_zero_cpu, item.info.non_zero_mem,
                sorted(item.info.used_ports.ports),
                [p.pod.uid for p in item.info.pods_with_affinity],
                [p.pod.uid for p in
                 item.info.pods_with_required_anti_affinity])
            for n, item in sched.cache.nodes.items()}


def _end_state(api, sched) -> dict:
    dump = sched.cache.dump()
    return {
        "assignments": {uid: p.spec.node_name for uid, p in api.pods.items()},
        "scheduled": sched.scheduled_count,
        "unschedulable": sched.unschedulable_count,
        # NodeInfo generations are a process-global counter
        "cache_nodes": {n: {k: v for k, v in d.items() if k != "generation"}
                        for n, d in dump["nodes"].items()},
        "node_facts": _node_facts(sched),
        "assumed": dump["assumed_pods"],
        "pod_count": dump["pod_count"],
        "dispatcher": (sched.dispatcher.executed, sched.dispatcher.errors),
        "queue_len": len(sched.queue),
        "pending": sorted(p.uid for p in sched.queue.pending_pods()[0]),
        "nominated": dict(sched.queue.nominator.nominated_pods),
    }


def _workload(kind: str, seed: int, infeasible: bool = False):
    """tests/test_ingest.py:506-553: 24 nodes, 120 pods (every seventh a
    ScheduleAnyway zone spread), created in chunks of 40, each followed
    by a non-blocking schedule_pending, then a full drain."""
    w, _t, api, sched, _clock = _sched(kind)
    rng = random.Random(seed)
    for i in range(24):
        api.create_node(w.make_node(f"node-{i}").capacity(
            {"cpu": 8, "memory": "16Gi", "pods": 110}).zone(
            f"zone-{i % 4}").label(HOSTNAME, f"node-{i}").obj())
    sched.prime()
    pods = []
    for i in range(120):
        b = w.make_pod(f"pod-{i}")
        if infeasible and i % 9 == 0:
            b = b.req({"cpu": "100"})
        else:
            b = b.req({"cpu": f"{rng.choice([250, 500])}m",
                       "memory": "512Mi"})
        if i % 7 == 0:
            b = b.label("app", "web").spread_constraint(
                5, ZONE, "ScheduleAnyway", {"app": "web"})
        pods.append(b.obj())
    for start in range(0, len(pods), 40):
        api.create_pods(pods[start:start + 40])
        sched.schedule_pending(wait=False)
    sched.schedule_pending()
    return _end_state(api, sched), sched


def _three(case, *args):
    outs = {kind: case(kind, *args) for kind in ("jax", "on", "off")}
    states = {k: (v[0] if isinstance(v, tuple) else v)
              for k, v in outs.items()}
    assert states["on"] == states["jax"]
    assert states["off"] == states["jax"]
    return outs


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_end_state_parity(seed):
    outs = _three(_workload, seed)
    state = outs["on"][0]
    assert state["scheduled"] == 120 and not state["assumed"]


def test_end_state_parity_with_failures():
    outs = _three(_workload, 5, True)
    state = outs["on"][0]
    assert state["unschedulable"] > 0 and len(state["pending"]) == 14


def _facts_workload(kind: str):
    """Every CommitFacts field on the engine's path: host ports (signature
    0 rows), required anti-affinity, preferred and required affinity,
    zero requests, init containers and images, over two drains."""
    w, _t, api, sched, _clock = _sched(kind, batch_size=32)
    for i in range(8):
        api.create_node(w.make_node(f"n{i}").capacity(
            {"cpu": 8, "memory": "16Gi", "pods": 110}).zone(f"z{i % 4}")
            .label(HOSTNAME, f"n{i}").obj())
    sched.prime()
    pods = []
    for i in range(24):
        b = w.make_pod(f"f{i}")
        b = b.req({} if i % 6 == 5 else {"cpu": f"{100 * (1 + i % 3)}m",
                                          "memory": "256Mi"})
        if i % 4 == 0:
            b = b.host_port(8000 + i % 8)
        if i % 5 == 1:
            b = b.label("app", "db").pod_affinity(HOSTNAME, {"app": "db"},
                                                 anti=True)
        if i % 7 == 2:
            b = b.label("app", "web").preferred_pod_affinity(
                ZONE, {"app": "web"}, weight=10)
        if i % 6 == 3:
            b = b.container({"cpu": "50m"}, image="nginx:1").init_req(
                {"cpu": "200m"})
        pods.append(b.obj())
    api.create_pods(pods[:12])
    sched.schedule_pending()
    api.create_pods(pods[12:])
    sched.schedule_pending()
    return _end_state(api, sched)


def test_commit_facts_end_state_parity():
    outs = _three(_facts_workload)
    facts = outs["on"]["node_facts"].values()
    assert any(f[2] for f in facts) and any(f[3] for f in facts)
    assert any(f[4] for f in facts)
    assert outs["on"]["scheduled"] == 24


def _workload_obj(types, name, min_count):
    return types.Workload(metadata=types.ObjectMeta(name=name),
                          pod_groups=[types.PodGroup(name="workers",
                                                     min_count=min_count)])


def _gangs(kind: str):
    """A gang of 8 solved as one gang drain, and a host-port gang of 4
    that leaves the gang program: its members take the Reserve / Permit
    chain one by one, the first three parked at Permit until the fourth
    binds; plain pods around them."""
    w, t, api, sched, _clock = _sched(kind, batch_size=64)
    for i in range(8):
        api.create_node(w.make_node(f"n{i}").capacity(
            {"cpu": 8, "memory": "32Gi", "pods": 110}).obj())
    sched.prime()
    api.create_workload(_workload_obj(t, "train", 8))
    api.create_workload(_workload_obj(t, "ports", 4))
    pods = [w.make_pod(f"train-{i}").req({"cpu": "1", "memory": "1Gi"})
            .workload("train").obj() for i in range(8)]
    pods += [w.make_pod(f"plain-{i}").req({"cpu": "500m"}).obj()
             for i in range(6)]
    pods += [w.make_pod(f"ports-{i}").req({"cpu": "1", "memory": "1Gi"})
             .workload("ports").host_port(7000 + i).obj() for i in range(4)]
    api.create_pods(pods)
    sched.schedule_pending()
    waiting = sorted(sched._waiting_pods)
    if kind == "jax":
        m = sched.metrics.gang_dispatch
        dispatch = {k: int(m.value(k))
                    for k in ("placed", "rejected", "fallback")}
    else:
        dispatch = dict(sched.gang_dispatch)
    wm = sched.workload_manager
    assigned = sorted(u for info in wm.pod_group_infos.values()
                      for u in info.assigned)
    return (_end_state(api, sched), waiting, dispatch, assigned)


def test_gang_drain_and_permit_member_parity():
    outs = _three(_gangs)
    state, waiting, dispatch, assigned = outs["on"]
    assert dispatch["placed"] == 1 and dispatch["fallback"] >= 1
    assert not waiting and len(assigned) == 12
    assert all(state["assignments"][f"default/ports-{i}"] for i in range(4))
    for kind in ("jax", "off"):
        assert outs[kind][1:] == outs["on"][1:]


def _preemption(kind: str):
    """tests/test_preemption.py's evict-and-land: three nodes of 4 cpu
    full of priority-0 pods; a priority-100 pod of 4 cpu evicts one and is
    nominated; after its backoff it binds on its nominated node while
    plain pods keep arriving."""
    w, _t, api, sched, clock = _sched(kind, batch_size=16)
    for i in range(3):
        api.create_node(w.make_node(f"n{i}").capacity(
            {"cpu": "4", "memory": "16Gi", "pods": 110}).obj())
    for i in range(3):
        api.create_pod(w.make_pod(f"low{i}").req(
            {"cpu": "4", "memory": "1Gi"}).obj())
    sched.schedule_pending()
    api.create_pod(w.make_pod("vip").req({"cpu": "4", "memory": "1Gi"})
                   .priority(100).obj())
    sched.schedule_pending()
    mid = _end_state(api, sched)
    clock.t += 15.0
    sched.flush_queues()
    sched.schedule_pending()
    return _end_state(api, sched), mid, sched.preemption_attempts


def test_preemption_and_nomination_parity():
    outs = _three(_preemption)
    end, mid, attempts = outs["on"]
    assert attempts == 1 and mid["nominated"]
    # the nominated preemptor bound on its nominated node, and its
    # commit dropped the nomination in every run
    assert end["assignments"]["default/vip"] == mid["nominated"][
        "default/vip"]
    assert not end["nominated"]
    for kind in ("jax", "off"):
        assert outs[kind][1:] == outs["on"][1:]


# ---------------------------------------------------------------------------
# the bulk bind echo's off-shape cases against the per-pod path


def _fingerprint(sched) -> dict:
    q = sched.queue
    wm = sched.workload_manager
    return {
        "cache": _end_state(sched.client, sched),
        "states": {u: (st.pod.spec.node_name, st.assumed,
                       st.binding_finished, st.deadline)
                   for u, st in sched.cache.pod_states.items()},
        "active": sorted(q.active_q._items),
        "backoff": sorted(q.backoff_q._items),
        "unschedulable": sorted(q.unschedulable_pods),
        "in_flight_events": len(q.in_flight_events),
        "bind_errors": dict(sched._bind_errors),
        "carry": sched._device_carry is None,
        "waiting": sorted(sched._waiting_pods),
        "wm": {k: (sorted(v.all_pods), sorted(v.assigned))
               for k, v in wm.pod_group_infos.items()},
    }


def _held(setup):
    """Twin gate-on schedulers brought to the same state by `setup(w, t,
    api, sched)` with their binds held in the dispatcher; each echo batch
    `setup` returns (a list of (old, new) pairs, or a list of them) is
    then fed to one through `_on_pod_update_bulk` and to the other
    through `_on_pod_update` one pair at a time."""
    twins = []
    for _ in range(2):
        w, t, api, sched, clock = _sched("on", batch_size=16)
        for i in range(4):
            api.create_node(w.make_node(f"n{i}").capacity(
                {"cpu": "4", "memory": "16Gi", "pods": 110}).obj())
        sched.prime()
        flush = sched.dispatcher.flush
        sched.dispatcher.flush = lambda *a, **k: 0
        pairs = setup(w, t, api, sched)
        sched.dispatcher.flush = flush
        twins.append((api, sched, pairs))
    (api_b, bulk, batches_b), (api_p, per_pod, batches_p) = twins
    if batches_b and isinstance(batches_b[0], tuple):
        batches_b, batches_p = [batches_b], [batches_p]
    assert _fingerprint(bulk) == _fingerprint(per_pod)
    for pairs_b, pairs_p in zip(batches_b, batches_p):
        bulk._on_pod_update_bulk(pairs_b)
        for old, new in pairs_p:
            per_pod._on_pod_update(old, new)
        assert _fingerprint(bulk) == _fingerprint(per_pod)
    return bulk


def _assumed_pairs(api, sched) -> list:
    """The echo a bind of every held pair would send: (the stored pod,
    the assumed copy)."""
    return [(api.pods[a.uid], a) for a, _orig in sched.dispatcher._binds]


def _plain(w, api, sched, n=4, cpu="1"):
    api.create_pods([w.make_pod(f"p{i}").req({"cpu": cpu}).obj()
                     for i in range(n)])
    sched.schedule_pending()


def test_bulk_echo_common_shape():
    def setup(w, t, api, sched):
        _plain(w, api, sched, 6)
        return _assumed_pairs(api, sched)
    sched = _held(setup)
    assert not sched.cache.assumed_pods and sched._device_carry is not None


def test_bulk_echo_with_unschedulable_pods():
    def setup(w, t, api, sched):
        _plain(w, api, sched, 3)
        api.create_pod(w.make_pod("big").req({"cpu": "64"}).obj())
        sched.schedule_pending()
        return _assumed_pairs(api, sched)
    assert _held(setup).queue.unschedulable_pods


def test_bulk_echo_with_pods_in_flight():
    def setup(w, t, api, sched):
        _plain(w, api, sched, 3)
        api.create_pods([w.make_pod(f"f{i}").req({"cpu": "1"}).obj()
                         for i in range(3)])
        # a drain dispatched and not committed: its pods are in flight
        sched._schedule_batch(sched.queue.drain(16))
        assert sched.queue.in_flight_pods and sched._pending
        return _assumed_pairs(api, sched)
    _held(setup)


def test_bulk_echo_with_a_bind_error_pending():
    def setup(w, t, api, sched):
        _plain(w, api, sched, 3)
        sched._bind_errors["default/elsewhere"] = 1
        return _assumed_pairs(api, sched)
    _held(setup)


def test_bulk_echo_with_a_pod_waiting_at_permit():
    def setup(w, t, api, sched):
        api.create_workload(_workload_obj(t, "g", 2))
        api.create_pod(w.make_pod("g-0").req({"cpu": "1"}).workload("g")
                       .host_port(7000).obj())
        api.create_pod(w.make_pod("g-1").req({"cpu": "1"}).workload("g")
                       .host_port(7001).obj())
        # one member parked at Permit: quorum is not met until both pass
        sched.schedule_pending()
        _plain(w, api, sched, 2)
        return _assumed_pairs(api, sched)
    _held(setup)


def test_bulk_echo_off_shape_pods():
    """Among common-shape confirms, an assumed pod bound to another node
    than assumed (relocated) and an update of a pod bound earlier; then a
    batch of another scheduler's binds (pods never assumed here)."""
    def setup(w, t, api, sched):
        held = sched.dispatcher.flush
        del sched.dispatcher.flush         # the real flush, for one batch
        _plain(w, api, sched, 2)           # bound and confirmed
        sched.dispatcher.flush = held
        earlier = api.pods["default/p0"]
        assert earlier.spec.node_name
        api.create_pods([w.make_pod(f"q{i}").req({"cpu": "1"}).obj()
                         for i in range(4)])
        sched.schedule_pending()
        pairs = _assumed_pairs(api, sched)
        old, new = pairs[1]
        other = "n3" if new.spec.node_name != "n3" else "n2"
        pairs[1] = (old, new.with_node_name(other))
        pairs.insert(2, (earlier, earlier.with_node_name(
            earlier.spec.node_name)))
        foreign = [w.make_pod(f"foreign{i}").req({"cpu": "1"})
                   .scheduler_name("other-scheduler").obj()
                   for i in range(2)]
        api.create_pods(foreign)
        return [pairs, [(api.pods[p.uid], p.with_node_name(f"n{i}"))
                        for i, p in enumerate(foreign)]]
    sched = _held(setup)
    assert sched._device_carry is None     # the foreign binds invalidate


# ---------------------------------------------------------------------------
# readers of the rebound QueuedPodInfo pod


def test_rails_held_carry_check_under_both_settings():
    from kubernetes_tpu_torch.analysis.rails import GLOBAL as RAILS
    binds, checks = [], []
    try:
        for columnar in (True, False):
            api = TApi()
            sched = TSched(api, batch_size=64, clock=_Clock(), device="cpu",
                           config=KubeSchedulerConfiguration(feature_gates={
                               "SanitizerRails": True,
                               "ColumnarIngest": columnar}))
            for i in range(6):
                api.create_node(tw.make_node(f"n{i}").capacity(
                    {"cpu": 8, "memory": "16Gi", "pods": 110})
                    .zone(f"z{i % 3}").obj())
            before = RAILS.held_checks
            # uniform runs (whose carries the rails hold), then a spread
            # drain, then uniform runs again
            for chunk, spread in enumerate((False, True, False)):
                api.create_pods([
                    tw.make_pod(f"c{chunk}-{i}").req({"cpu": "500m"})
                    .label("app", "web").spread_constraint(
                        1, ZONE, "ScheduleAnyway", {"app": "web"}).obj()
                    if spread else
                    tw.make_pod(f"c{chunk}-{i}").req({"cpu": "250m"}).obj()
                    for i in range(24)])
                sched.schedule_pending()
            assert sched.reconcile() == []
            checks.append(RAILS.held_checks - before)
            binds.append({u: p.spec.node_name for u, p in api.pods.items()})
    finally:
        RAILS.enable(False)
    assert binds[0] == binds[1] and all(binds[0].values())
    assert checks[0] > 0 and checks[0] == checks[1]


def test_explain_pod_after_the_engine_commit():
    from kubernetes_tpu_torch.obs.explain import explain_pod
    answers = []
    for kind in ("on", "off"):
        w, _t, api, sched, _clock = _sched(kind, batch_size=16)
        for i in range(4):
            api.create_node(w.make_node(f"n{i}").capacity(
                {"cpu": "4", "memory": "16Gi", "pods": 110}).obj())
        _plain(w, api, sched, 5)
        # one drain committed but not yet echoed: the explained pod is the
        # engine's assumed copy
        sched.dispatcher.flush = lambda *a, **k: 0
        api.create_pod(w.make_pod("late").req({"cpu": "1"}).obj())
        sched.schedule_pending()
        answers.append([explain_pod(sched, uid, k=4)
                        for uid in ("default/p0", "default/late")])
    assert answers[0] == answers[1]
    assert answers[0][1]["winner"] is not None


def test_bind_error_after_an_engine_commit():
    outs = []
    for kind in ("jax", "on", "off"):
        w, _t, api, sched, clock = _sched(kind, batch_size=16)
        Conflict = (japiserver if kind == "jax" else tapiserver).Conflict
        for i in range(4):
            api.create_node(w.make_node(f"n{i}").capacity(
                {"cpu": "4", "memory": "16Gi", "pods": 110}).obj())
        real = api.bind_all
        failed = []

        def bind_all(pairs, _real=real, _failed=failed, _c=Conflict, **kw):
            if not _failed and pairs:
                _failed.append(pairs[0][0].uid)
                return ([(pairs[0][0], _c("injected"))]
                        + _real(pairs[1:], **kw))
            return _real(pairs, **kw)
        api.bind_all = bind_all
        _plain(w, api, sched, 6)
        mid = _end_state(api, sched)
        clock.t += 30.0
        sched.flush_queues()
        sched.schedule_pending()
        outs.append((mid, _end_state(api, sched), list(failed)))
    assert outs[1] == outs[0] and outs[2] == outs[0]
    mid, end, failed = outs[1]
    assert mid["dispatcher"][1] == 1 and not mid["assignments"][failed[0]]
    assert all(end["assignments"].values())
