"""diagnose_row (the device mask diagnosis) and the scheduler's FitError
diagnosis: the port ↔ the JAX package, exact equality.

`diagnose_row` cases build one seeded cluster and pending batch with the
JAX package's state layer; its numpy arrays go through the JAX
`diagnose_row` on the CPU and, converted, through the port's plain
version, for every signature row of the batch: the per-node first
failing filter slot, the "Too many pods" flags and the per-column
Insufficient flags must be equal. The lean variant reads no group
tensors; the group variant layers the spread (missing label, skew) and
inter-pod (affinity, anti-affinity, existing anti-affinity) reasons
under the lean filters.

The scheduler cases run one failing workload through both schedulers and
hold the port's assembled Diagnosis of every failed pod (its
unschedulable plugins and each node's Status: code, reasons, plugin) to
three things: the port's own host filter replay on the same snapshot,
the JAX package's diagnosis of the same pod, and the FailedScheduling
status message the port's dispatcher sends."""

import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import kubernetes_tpu  # noqa: F401  (x64 before any jnp array)
from _torch_parity import (lean_cluster, lean_pod,  # noqa: F401
                           private_jax_compiles)
from kubernetes_tpu.backend.cache import Cache, Snapshot
from kubernetes_tpu.ops import groups as jg
from kubernetes_tpu.ops import program as jp
from kubernetes_tpu.state.batch import BatchBuilder, BatchDims
from kubernetes_tpu.state.tensorize import ClusterState
from kubernetes_tpu.testing.wrappers import make_node, make_pod
from kubernetes_tpu_torch.backend.dispatcher import CallType
from kubernetes_tpu_torch.ops import groups as tg
from kubernetes_tpu_torch.ops import program as tp
from kubernetes_tpu_torch.state import convert
from test_torch_scheduler import JAX, TORCH, make_scheduler

ZONE = "topology.kubernetes.io/zone"
HOSTNAME = "kubernetes.io/hostname"

torch.set_num_threads(1)


def _staged(nodes, bound, pods):
    cache = Cache()
    for nd in nodes:
        cache.add_node(nd)
    for pod in bound:
        cache.add_pod(pod)
    snap = Snapshot()
    cache.update_snapshot(snap)
    state = ClusterState()
    state.apply_snapshot(snap, full=True)
    builder = BatchBuilder(state, BatchDims(table_rows=64))
    batch = builder.build(pods)
    assert not batch.host_fallback.any()
    return state, snap, builder, batch


def diagnose_parity(nodes, bound, pods, groups: bool):
    """diagnose_row of every distinct row of the batch, JAX vs the port;
    returns the port's slots stacked [rows, N] and the node row names."""
    state, snap, builder, batch = _staged(nodes, bound, pods)
    a = state.ensure_arrays()
    jna = jp.NodeArrays(*(jnp.asarray(x) for x in a))
    jtab = jp.PodTableDev(*(jnp.asarray(getattr(builder.table, f))
                            for f in jp.PodTableDev._fields))
    tna = convert.node_arrays_from_numpy(a, "cpu")
    ttab = convert.pod_table_from_numpy(builder.table, "cpu")
    kw_j = kw_t = {}
    if groups:
        gd_np, gc_np = builder.groups.build_dev(snap)
        fam = builder.groups.families(snap)
        kw_j = dict(gd=jg.to_device(gd_np), gc=jg.to_device(gc_np), fam=fam)
        kw_t = dict(gd=convert.groups_dev_from_numpy(gd_np, "cpu"),
                    gc=convert.group_carry_from_numpy(gc_np, "cpu"),
                    fam=tg.GroupFamilies(*fam))
    slots = []
    for u in dict.fromkeys(int(t) for t in batch.tidx[:len(pods)]):
        js, jpf, jcf = jp.diagnose_row(jna, jtab, u, **kw_j)
        ts, tpf, tcf = tp.diagnose_row(tna, ttab, u, **kw_t)
        assert ts.dtype == torch.int32 and tpf.dtype == torch.bool
        assert tcf.dtype == torch.bool
        np.testing.assert_array_equal(np.asarray(js), ts.numpy())
        np.testing.assert_array_equal(np.asarray(jpf), tpf.numpy())
        np.testing.assert_array_equal(np.asarray(jcf), tcf.numpy())
        slots.append(ts.numpy())
    return np.stack(slots), list(state.node_names)


def _bound(name, node, cpu="1", labels=None, anti=None):
    w = make_pod(name).req({"cpu": cpu, "memory": "1Gi"}).node(node)
    for k, v in (labels or {}).items():
        w = w.label(k, v)
    if anti:
        w = w.pod_affinity(anti[0], anti[1], anti=True)
    return w.obj()


class TestDiagnoseRowLean:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_random_lean_cluster(self, seed):
        rng = random.Random(seed)
        nodes = lean_cluster(rng, 24)
        bound = [_bound(f"b{i}", f"n{rng.randint(0, 23)}",
                        cpu=rng.choice(["500m", "2", "6"]))
                 for i in range(30)]
        pods = [lean_pod(rng, f"p{i}") for i in range(20)]
        pods.append(make_pod("huge").req({"cpu": "64"}).obj())
        slots, _ = diagnose_parity(nodes, bound, pods, groups=False)
        assert (slots == tp.DIAG_FIT).any()
        assert (slots == tp.DIAG_TAINT).any()

    def test_every_lean_reason(self):
        nodes = [make_node("n0").capacity({"cpu": 4, "pods": 2})
                 .label("disk", "ssd").obj(),
                 make_node("n1").capacity({"cpu": 4}).unschedulable().obj(),
                 make_node("n2").capacity({"cpu": 4})
                 .taint("t", "v", "NoSchedule").obj(),
                 make_node("n3").capacity({"cpu": 4}).label("disk", "hdd")
                 .obj(),
                 make_node("n4").capacity({"cpu": 4}).label("disk", "ssd")
                 .obj(),
                 make_node("n5").capacity({"cpu": 1}).label("disk", "ssd")
                 .obj()]
        bound = [_bound("b0", "n0", cpu="1"), _bound("b1", "n0", cpu="1"),
                 make_pod("b2").req({"cpu": "100m"}).host_port(80)
                 .node("n4").obj()]
        pod = (make_pod("p").req({"cpu": "2"}).host_port(80)
               .node_selector({"disk": "ssd"}).obj())
        slots, names = diagnose_parity(nodes, bound, [pod], groups=False)
        by_name = {nm: int(x) for nm, x in zip(names, slots[0]) if nm}
        assert by_name == {
            "n0": tp.DIAG_FIT, "n1": tp.DIAG_NODE_UNSCHEDULABLE,
            "n2": tp.DIAG_TAINT, "n3": tp.DIAG_NODE_AFFINITY,
            "n4": tp.DIAG_PORTS, "n5": tp.DIAG_FIT}
        # the padded rows of the node bucket
        pad = slots[0][len(names):]
        assert pad.size and (pad == tp.DIAG_INVALID).all()


class TestDiagnoseRowGroups:
    def test_spread_label_and_skew(self):
        nodes = [make_node(f"n{i}").capacity({"cpu": 8})
                 .zone(f"z{i % 2}").label(HOSTNAME, f"n{i}").obj()
                 for i in range(6)]
        nodes.append(make_node("nolabel").capacity({"cpu": 8}).obj())
        bound = [_bound(f"b{i}", "n0", labels={"app": "s"})
                 for i in range(3)]
        pods = [make_pod("p").req({"cpu": "1"}).label("app", "s")
                .spread_constraint(1, ZONE, "DoNotSchedule", {"app": "s"})
                .spread_constraint(1, HOSTNAME, "DoNotSchedule",
                                   {"app": "s"}).obj()]
        slots, _ = diagnose_parity(nodes, bound, pods, groups=True)
        assert (slots == tp.DIAG_SPREAD_SKEW).any()
        assert (slots == tp.DIAG_SPREAD_LABEL).any()

    def test_affinity_anti_existing_anti(self):
        nodes = [make_node(f"n{i}").capacity({"cpu": 8}).zone(f"z{i % 3}")
                 .label(HOSTNAME, f"n{i}").obj() for i in range(9)]
        nodes.append(make_node("keyless").capacity({"cpu": 8}).obj())
        bound = [_bound("db", "n0", labels={"app": "db"}),
                 _bound("guard", "n1", labels={"role": "g"},
                        anti=(ZONE, {"app": "web"})),
                 _bound("cache", "n2", labels={"app": "cache"})]
        pods = [make_pod("aff").req({"cpu": "1"}).label("app", "x")
                .pod_affinity(ZONE, {"app": "db"}).obj(),
                make_pod("anti").req({"cpu": "1"}).label("app", "y")
                .pod_affinity(ZONE, {"app": "cache"}, anti=True).obj(),
                make_pod("web").req({"cpu": "1"}).label("app", "web").obj()]
        slots, _ = diagnose_parity(nodes, bound, pods, groups=True)
        assert (slots[0] == tp.DIAG_IPA_AFFINITY).any()
        assert (slots[1] == tp.DIAG_IPA_ANTI).any()
        assert (slots[2] == tp.DIAG_IPA_EXISTING_ANTI).any()

    @pytest.mark.parametrize("seed", [3, 4])
    def test_random_mixed_groups(self, seed):
        rng = random.Random(seed)
        nodes = lean_cluster(rng, 20)
        bound = [_bound(f"b{i}", f"n{rng.randint(0, 19)}",
                        labels={"app": rng.choice(["a", "b"])})
                 for i in range(12)]
        pods = []
        for i in range(16):
            w = make_pod(f"p{i}").req({"cpu": rng.choice(["1", "4"])}) \
                .label("app", rng.choice(["a", "b"]))
            k = i % 4
            if k == 0:
                w = w.spread_constraint(1, ZONE, "DoNotSchedule",
                                        {"app": "a"})
            elif k == 1:
                w = w.pod_affinity(ZONE, {"app": "b"})
            elif k == 2:
                w = w.pod_affinity(ZONE, {"app": "a"}, anti=True)
            else:
                w = w.node_selector({"disk": "ssd"})
            pods.append(w.obj())
        diagnose_parity(nodes, bound, pods, groups=True)


# -- the scheduler's diagnosis -------------------------------------------------


def _failing_workload(pkg):
    w, Api = pkg[0], pkg[1]
    api = Api()
    sched = make_scheduler(pkg, api, 64)
    for i in range(12):
        b = (w.make_node(f"node-{i}").capacity(
            {"cpu": 4, "memory": "8Gi", "pods": 6})
            .zone(f"zone-{i % 3}").label(HOSTNAME, f"node-{i}"))
        if i % 4 == 1:
            b = b.taint("dedicated", "db", effect="NoSchedule")
        if i == 7:
            b = b.unschedulable()
        if i % 3 == 0:
            b = b.label("disk", "ssd")
        api.create_node(b.obj())
    sched.prime()
    pods = [w.make_pod("guard").req({"cpu": "500m"}).label("role", "g")
            .pod_affinity(ZONE, {"app": "web"}, anti=True).obj()]
    pods += [w.make_pod(f"fill-{i}").req({"cpu": "1", "memory": "1Gi"})
             .label("app", "fill").obj() for i in range(20)]
    pods += [w.make_pod(f"big-{i}").req({"cpu": "3500m"}).obj()
             for i in range(3)]
    pods += [w.make_pod(f"ssd-{i}").req({"cpu": "2"})
             .node_selector({"disk": "nvme"}).obj() for i in range(2)]
    pods += [w.make_pod(f"port-{i}").req({"cpu": "100m"}).host_port(8080)
             .obj() for i in range(14)]
    pods += [w.make_pod(f"web-{i}").req({"cpu": "100m"}).label("app", "web")
             .obj() for i in range(3)]
    pods += [w.make_pod(f"aff-{i}").req({"cpu": "100m"})
             .pod_affinity(ZONE, {"app": "nowhere"}).obj() for i in range(2)]
    pods += [w.make_pod(f"spr-{i}").req({"cpu": "100m"}).label("app", "s")
             .spread_constraint(1, "rack", "DoNotSchedule", {"app": "s"})
             .obj() for i in range(2)]
    pods += [w.make_pod(f"huge-{i}").req({"cpu": "40"}).obj()
             for i in range(2)]
    api.create_pods(pods)
    return api, sched


def _status_key(st):
    return (int(st.code), tuple(st.reasons), st.plugin)


def _diag_key(diag):
    return (sorted(diag.unschedulable_plugins),
            {n: _status_key(s) for n, s in diag.node_to_status.items()},
            diag.pre_filter_msg)


def _record_failures(sched, replay: bool):
    seen = {}
    orig = sched._device_fit_error

    def spy(qpi, profile, diag_cache):
        err = orig(qpi, profile, diag_cache)
        host = (sched._host_replay_diagnosis(qpi, profile) if replay
                else None)
        seen[qpi.pod.uid] = (err, host)
        return err
    sched._device_fit_error = spy
    return seen


def test_scheduler_diagnosis_parity():
    japi, jsched = _failing_workload(JAX)
    jseen = _record_failures(jsched, replay=False)
    jsched.schedule_pending()
    tapi, tsched = _failing_workload(TORCH)
    tseen = _record_failures(tsched, replay=True)
    patches = {}
    orig_add = tsched.dispatcher.add

    def add(call):
        if call.call_type == CallType.STATUS_PATCH:
            patches[call.pod.uid] = call.condition["message"]
        return orig_add(call)
    tsched.dispatcher.add = add
    calls = []
    orig_row = tsched._mask_diagnosis.__func__

    def mask(self, qpi, cache):
        d = orig_row(self, qpi, cache)
        calls.append(d is not None)
        return d
    tsched._mask_diagnosis = mask.__get__(tsched)
    tsched.schedule_pending()

    assert set(tseen) == set(jseen) and len(tseen) >= 10
    assert any(calls), "no failure took the device diagnosis"
    plugins = set()
    for uid, (terr, host) in tseen.items():
        jerr = jseen[uid][0]
        tk = _diag_key(terr.diagnosis)
        if host.unschedulable_plugins or host.node_to_status:
            hk = _diag_key(host)
            if not hk[0]:
                hk = (["NodeResourcesFit"],) + hk[1:]
            assert tk == hk, uid
        assert tk == _diag_key(jerr.diagnosis), uid
        assert str(terr) == str(jerr), uid
        assert patches[uid] == str(terr), uid
        plugins |= set(tk[0])
    assert {"NodeResourcesFit", "TaintToleration", "NodeAffinity",
            "NodePorts", "InterPodAffinity", "NodeUnschedulable"} <= plugins


# -- a drain's rows in one call ----------------------------------------------


@pytest.mark.parametrize("groups", [False, True])
@pytest.mark.parametrize("seed", [5, 6])
def test_diagnose_rows_plain_matches_jax_row_by_row(seed, groups):
    """diagnose_rows of every distinct row of a batch at once (the port's
    plain version): row s of its packed output equals the JAX
    diagnose_row of rows[s]."""
    rng = random.Random(seed)
    nodes = lean_cluster(rng, 20)
    bound = [_bound(f"b{i}", f"n{rng.randint(0, 19)}",
                    labels={"app": rng.choice(["a", "b"])})
             for i in range(12)]
    pods = [lean_pod(rng, f"p{i}") for i in range(8)]
    pods += [make_pod(f"s{i}").req({"cpu": "1"}).label("app", "a")
             .spread_constraint(1, ZONE, "DoNotSchedule", {"app": "a"})
             .obj() for i in range(2)]
    pods.append(make_pod("huge").req({"cpu": "64"}).obj())
    state, snap, builder, batch = _staged(nodes, bound, pods)
    a = state.ensure_arrays()
    jna = jp.NodeArrays(*(jnp.asarray(x) for x in a))
    jtab = jp.PodTableDev(*(jnp.asarray(getattr(builder.table, f))
                            for f in jp.PodTableDev._fields))
    tna = convert.node_arrays_from_numpy(a, "cpu")
    ttab = convert.pod_table_from_numpy(builder.table, "cpu")
    kw_j = kw_t = {}
    if groups:
        gd_np, gc_np = builder.groups.build_dev(snap)
        fam = builder.groups.families(snap)
        kw_j = dict(gd=jg.to_device(gd_np), gc=jg.to_device(gc_np), fam=fam)
        kw_t = dict(gd=convert.groups_dev_from_numpy(gd_np, "cpu"),
                    gc=convert.group_carry_from_numpy(gc_np, "cpu"),
                    fam=tg.GroupFamilies(*fam))
    rows = list(dict.fromkeys(int(t) for t in batch.tidx[:len(pods)]))
    rows = rows[::-1] + rows[:1]          # any order, a row twice
    N, R = a.cap.shape
    packed = tp.diagnose_rows(tna, ttab, rows, **kw_t)
    assert packed.dtype == torch.uint8
    assert packed.numel() == len(rows) * N * (5 + R)
    got = tp.diagnosis_read_back(packed, len(rows), N, R)
    for s, u in enumerate(rows):
        want = jp.diagnose_row(jna, jtab, u, **kw_j)
        for x, y in zip(got, want):
            np.testing.assert_array_equal(x[s], np.asarray(y))


def _spy_rows(sched):
    """The rows of every diagnose_rows call the scheduler makes."""
    import kubernetes_tpu_torch.scheduler as ts
    calls = []
    real = ts.diagnose_rows

    def spy(na, table, rows, *a, **kw):
        calls.append(list(rows))
        return real(na, table, rows, *a, **kw)
    ts.diagnose_rows = spy
    return calls, lambda: setattr(ts, "diagnose_rows", real)


@pytest.mark.parametrize("move", [False, True])
def test_scheduler_diagnoses_a_drain_in_one_call(move):
    """A failed drain whose failures span several signatures: the first
    mask diagnosis diagnoses every row of the drain's failures in one
    diagnose_rows call. With `move`, the table gains a row after the
    first failure (table_version moves): the context is rebuilt, its rows
    dropped, and the next row-bearing failure makes a call of its own
    against the new context. Either way every Diagnosis equals the JAX
    package's, reason strings and all."""
    japi, jsched = _failing_workload(JAX)
    jseen = _record_failures(jsched, replay=False)
    jsched.schedule_pending()
    tapi, tsched = _failing_workload(TORCH)
    tseen = _record_failures(tsched, replay=False)
    calls, undo = _spy_rows(tsched)
    if move:
        handle = tsched._handle_failure
        extra = iter(range(10 ** 6))

        def handle_and_add_a_row(qpi, err, *a, **kw):
            before = tsched.builder.table_version
            tsched.builder._lookup(TORCH[0].make_pod(
                f"fresh-{next(extra)}").req({"cpu": "7"}).label(
                    "fresh", str(before)).obj())
            assert tsched.builder.table_version > before
            return handle(qpi, err, *a, **kw)
        tsched._handle_failure = handle_and_add_a_row
    try:
        tsched.schedule_pending()
    finally:
        undo()
    assert set(tseen) == set(jseen) and len(tseen) >= 10
    for uid, (terr, _host) in tseen.items():
        jerr = jseen[uid][0]
        assert _diag_key(terr.diagnosis) == _diag_key(jerr.diagnosis), uid
        assert str(terr) == str(jerr), uid
    assert calls and len(calls[0]) >= 4, calls
    if move:
        # every later call is a rebuilt context's first row and the
        # failures it has not yet diagnosed
        assert len(calls) >= 2
    else:
        assert len(calls) == 1
