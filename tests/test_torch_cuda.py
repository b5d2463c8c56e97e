"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: these tests need an NVIDIA GPU with nvcc and skip
elsewhere (the CPU tests hold the plain versions to the JAX package; these
hold the kernels to the plain versions). On a machine with the card:

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

Tolerance: exact equality of assignments, packed flags, every carry field
and the whole SigCache; the cluster probe's and the score probe's float32
outputs bit for bit against the plain version on the CPU. The sanitizer
rails' card halves: the sync guard raises on `.item()`, and the held-carry
checksum sees a device write no version counter records."""

import random
from types import SimpleNamespace

import pytest
import torch

from kubernetes_tpu_torch.backend.cache import Cache, Snapshot
from kubernetes_tpu_torch.ops import program as P
from kubernetes_tpu_torch.state import convert
from kubernetes_tpu_torch.state.batch import BatchBuilder
from kubernetes_tpu_torch.state.tensorize import ClusterState
from kubernetes_tpu_torch.testing.wrappers import make_node, make_pod

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    return "cuda"


def _staged(rng, n_nodes, pods, device):
    cache = Cache()
    for i in range(n_nodes):
        w = make_node(f"n{i}").capacity({
            "cpu": rng.choice([2, 4, 8, 16]),
            "memory": f"{rng.choice([4, 8, 16])}Gi",
            "pods": rng.choice([4, 8, 110])}).zone(f"z{i % 3}")
        if rng.random() < 0.3:
            w = w.taint("dedicated", "x", effect=rng.choice(
                ["NoSchedule", "PreferNoSchedule", "NoExecute"]))
        if rng.random() < 0.3:
            w = w.label("disk", rng.choice(["ssd", "hdd"]))
        if rng.random() < 0.4:
            w = w.image("nginx:1", rng.choice([30, 300]) << 20)
        cache.add_node(w.obj())
    snap = Snapshot()
    cache.update_snapshot(snap)
    state = ClusterState(device=device)
    state.apply_snapshot(snap)
    builder = BatchBuilder(state)
    batch = builder.build(pods)
    return state.device_arrays(), batch, P.table_from_batch(batch, device)


def _pod(rng, i):
    w = make_pod(f"p{i}").req({"cpu": rng.choice(["0", "250m", "1"]),
                               "memory": rng.choice(["0", "512Mi", "1Gi"])})
    if rng.random() < 0.3:
        w = w.node_selector({"disk": "ssd"})
    if rng.random() < 0.3:
        w = w.toleration(key="dedicated", operator="Exists")
    if rng.random() < 0.2:
        w = w.preferred_node_affinity_in("topology.kubernetes.io/zone",
                                         ["z1"], 3)
    if rng.random() < 0.15:
        w = w.host_port(8080)
    if rng.random() < 0.3:
        w = w.container({"cpu": "50m"}, image="nginx:1")
    return w.obj()


def _equal(a, b):
    if a is None or b is None:
        assert a is None and b is None
        return
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.cpu(), b.cpu())
        return
    for x, y in zip(a, b):
        _equal(x, y)


@pytest.mark.parametrize("strategy", ["LeastAllocated", "MostAllocated"])
@pytest.mark.parametrize("seed", range(6))
def test_run_batch_kernel_equals_plain(cuda, seed, strategy):
    rng = random.Random(seed)
    pods = [_pod(rng, i) for i in range(rng.randint(10, 60))]
    na, batch, table = _staged(rng, rng.randint(5, 200), pods, cuda)
    xs = convert.pod_xs_from_numpy(P.PodXs(batch.valid, batch.sig,
                                           batch.tidx), cuda)
    carry = P.initial_carry(na)
    cfg = P.ScoreConfig(strategy=strategy)
    _equal(P.run_batch(cfg, na, carry, xs, table),
           P._run_batch_plain(cfg, na, carry, xs, table))


@pytest.mark.parametrize("seed", range(8))
def test_run_uniform_kernel_equals_plain(cuda, seed):
    rng = random.Random(seed)
    proto = _pod(rng, 0)
    if any(p.host_port for c in proto.spec.containers for p in c.ports):
        proto = make_pod("plain").req({"cpu": "1", "memory": "1Gi"}).obj()
    n_nodes = rng.randint(3, 300)
    na, batch, table = _staged(rng, n_nodes, [proto], cuda)
    N = na.cap.shape[0]
    L = rng.choice([16, 64, 256])
    K = min(L, N)
    J = rng.choice([2, 8, L + 1])
    if K * J < L:
        J = L + 1
    x = P.PodXs(True, int(batch.sig[0]), int(batch.tidx[0]))
    carry = P.initial_carry(na)
    cfg = P.ScoreConfig()
    n_actual = rng.randint(1, L)
    kc, kp = P.run_uniform(cfg, na, carry, x, table, n_actual, L, K, J)
    pc, pp = P._run_uniform_plain(cfg, na, carry, x, table, n_actual, L, K,
                                  J)
    _equal((kp, kc), (pp, pc))
    # a second run on the output carry takes the SigCache fast path
    _equal(P.run_uniform(cfg, na, kc, x, table, n_actual, L, K, J),
           P._run_uniform_plain(cfg, na, pc, x, table, n_actual, L, K, J))


# ---------------------------------------------------------------------------
# the group path: scatter_rows, wave_statics, run_wave, run_batch + groups

ZONE = "topology.kubernetes.io/zone"
HOSTNAME = "kubernetes.io/hostname"


def _group_setup(nodes, existing, pods, device):
    """(na, batch, table, gd, gc, fam, builder, state) through the port's
    own state layer, the group tensors on `device`."""
    from kubernetes_tpu_torch.ops.groups import to_device
    cache = Cache()
    for nd in nodes:
        cache.add_node(nd)
    for p in existing:
        cache.add_pod(p)
    snap = Snapshot()
    cache.update_snapshot(snap)
    state = ClusterState(device=device)
    state.apply_snapshot(snap, full=True)
    builder = BatchBuilder(state)
    batch = builder.build(pods)
    gd_np, gc_np = builder.groups.build_dev(snap)
    return (state.device_arrays(), batch,
            P.table_from_batch(batch, device), to_device(gd_np, device),
            to_device(gc_np, device), builder.groups.families(snap),
            builder, state)


def _zone_nodes(n, zones, cpu=16, prefer=False):
    out = []
    for i in range(n):
        w = (make_node(f"n{i}").capacity({"cpu": cpu, "memory": "32Gi",
                                          "pods": 40})
             .zone(f"z{i % zones}").label(HOSTNAME, f"n{i}"))
        if prefer and i % 2 == 0:
            w = w.taint("dedic", "x", effect="PreferNoSchedule")
        out.append(w.obj())
    return out


def _spread_pods(n, skew, cpu="1", action="DoNotSchedule", key=ZONE):
    return [make_pod(f"s{i}").req({"cpu": cpu, "memory": "1Gi"})
            .label("app", "s").spread_constraint(skew, key, action,
                                                 {"app": "s"}).obj()
            for i in range(n)]


def _anti_pods(n, terms=1):
    out = []
    for i in range(n):
        w = (make_pod(f"a{i}").req({"cpu": "1", "memory": "1Gi"})
             .label("anti", "y").label("other", "y")
             .pod_affinity(ZONE, {"anti": "y"}, anti=True))
        if terms == 2:
            w = w.pod_affinity(HOSTNAME, {"other": "y"}, anti=True)
        out.append(w.obj())
    return out


WAVE_CASES = {
    # name: (nodes, existing, pods, J)
    "merge_spread_skew1": (lambda: _zone_nodes(24, 3), (),
                           lambda: _spread_pods(40, 1), 8),
    "merge_spread_skew5": (lambda: _zone_nodes(48, 6, cpu=64), (),
                           lambda: _spread_pods(100, 5, cpu="500m"), 8),
    "merge_anti_unique": (lambda: _zone_nodes(40, 40), (),
                          lambda: _anti_pods(30), 1),
    "merge_anti_shared": (lambda: _zone_nodes(40, 8), (),
                          lambda: _anti_pods(30), 1),
    "serial_two_anti_terms": (lambda: _zone_nodes(40, 10), (),
                              lambda: _anti_pods(30, terms=2), 8),
    "norm_live_prefer_taints": (lambda: _zone_nodes(32, 4, prefer=True),
                                (), lambda: _spread_pods(40, 2), 8),
    "capacity_tail": (lambda: _zone_nodes(6, 3, cpu=8), (),
                      lambda: _spread_pods(40, 2, cpu="7"), 8),
}


@pytest.mark.parametrize("case", sorted(WAVE_CASES))
def test_run_wave_kernel_equals_plain(cuda, case):
    from kubernetes_tpu_torch.compiler.plan import wave_same_mode
    mk_nodes, existing, mk_pods, J = WAVE_CASES[case]
    pods = mk_pods()
    na, batch, table, gd, gc, fam, builder, state = _group_setup(
        mk_nodes(), list(existing), pods, cuda)
    n = len(pods)
    u = int(batch.tidx[0])
    mode, anti = wave_same_mode(builder.groups, u)
    assert mode is not None
    B = max(8, 1 << (n - 1).bit_length())
    valid = torch.zeros((B,), dtype=torch.bool, device=cuda)
    valid[:n] = True
    statics = tuple(x[0] for x in P.wave_statics(na, table, [u]))
    norm_live = not P.static_norm_ok(state.ensure_arrays(),
                                     builder.table.pref_weight[u])
    K = min(B, na.cap.shape[0])
    Lw = min(512, B, K * J)
    carry = P.initial_carry(na, gc)
    cfg = P.ScoreConfig()
    merge = mode == "merge"
    kc, kp = P.run_wave(cfg, na, carry, valid, table, u, gd, statics, K, J,
                        fam, norm_live, anti_term=anti, merge_on=merge,
                        Lw=Lw)
    pc, pp = P._run_wave_plain(cfg, na, carry, valid, table, u, gd, statics,
                               K, J, Lw, fam, norm_live, anti, merge)
    _equal((kp, kc), (pp, pc))


@pytest.mark.parametrize("seed", range(4))
def test_run_batch_groups_kernel_equals_plain(cuda, seed):
    rng = random.Random(seed)
    nodes = _zone_nodes(rng.randint(10, 60), rng.randint(2, 6))
    existing = [make_pod(f"e{k}").req({"cpu": "1", "memory": "1Gi"})
                .label("app", "s").node(f"n{k}").obj() for k in range(3)]
    pods = []
    for i in range(rng.randint(20, 50)):
        kind = rng.randint(0, 4)
        w = make_pod(f"p{i}").req({"cpu": rng.choice(["250m", "1"]),
                                   "memory": "512Mi"})
        if kind == 0:
            w = w.label("app", "s").spread_constraint(
                rng.choice([1, 2]), ZONE, "DoNotSchedule", {"app": "s"})
        elif kind == 1:
            w = w.label("app", "s").spread_constraint(
                2, HOSTNAME, "ScheduleAnyway", {"app": "s"})
        elif kind == 2:
            w = w.label("anti", "y").pod_affinity(ZONE, {"anti": "y"},
                                                  anti=True)
        elif kind == 3:
            w = w.label("app", "s").pod_affinity(ZONE, {"app": "s"})
        else:
            w = w.preferred_pod_affinity(ZONE, {"app": "s"}, 5)
        pods.append(w.obj())
    na, batch, table, gd, gc, fam, _b, _s = _group_setup(
        nodes, existing, pods, cuda)
    xs = convert.pod_xs_from_numpy(P.PodXs(batch.valid, batch.sig,
                                           batch.tidx), cuda)
    carry = P.initial_carry(na, gc)
    cfg = P.ScoreConfig()
    _equal(P.run_batch(cfg, na, carry, xs, table, groups=gd, fam=fam),
           P._run_batch_plain(cfg, na, carry, xs, table, gd, fam))


def test_wave_statics_kernel_equals_plain(cuda):
    rng = random.Random(3)
    pods = [_pod(rng, i) for i in range(24)]
    na, batch, table = _staged(rng, 150, pods, cuda)
    rows = sorted(set(int(t) for t in batch.tidx[:24]))
    for feats in ((True, True, True), (False, True, False),
                  (True, False, True)):
        _equal(P.wave_statics(na, table, rows, feats),
               P._wave_statics_plain(na, table, rows, feats))


def test_scatter_rows_kernel_equals_plain(cuda):
    rng = random.Random(5)
    na, _, _ = _staged(rng, 100, [_pod(rng, 0)], cuda)
    na2, _, _ = _staged(random.Random(6), 100, [_pod(rng, 1)], cuda)
    idx = torch.tensor([3, 17, 17, 64, 99, 0], dtype=torch.int64)
    rows = type(na)(*(x[idx.to(cuda)].contiguous() for x in na2))
    before = type(na)(*(x.clone() for x in na))
    got = P.scatter_rows(na, idx, rows)
    _equal(got, P._scatter_rows_plain(na, idx, rows))
    # non-writing: the input arrays are untouched
    _equal(na, before)


# ---------------------------------------------------------------------------
# the plan program (run_plan) and the mask diagnosis (diagnose_row)


def _plan_span(batch, m, device):
    """(wt, WaveXs) for the batch's first m pods, laid out as
    Scheduler._wavescan_dispatch lays a span out."""
    from kubernetes_tpu_torch.state.tensorize import pow2_at_least
    uniq = list(dict.fromkeys(int(t) for t in batch.tidx[:m]))
    S = pow2_at_least(len(uniq), 2)
    wt = (uniq + [uniq[-1]] * S)[:S]
    slot = {}
    for s, u in enumerate(wt):
        slot.setdefault(u, s)
    bucket = pow2_at_least(m)
    widx = [slot[int(t)] for t in batch.tidx[:m]]
    widx += [widx[-1]] * (bucket - m)
    valid = torch.arange(bucket, device=device) < m
    return wt, P.WaveXs(valid=valid, widx=torch.tensor(
        widx, dtype=torch.int32, device=device))


def _mixed_pods(n, sigs, ports=False, kinds=("spread",)):
    out = []
    for i in range(n):
        k = i % sigs
        kind = kinds[i % len(kinds)]
        w = make_pod(f"m{i}").req({"cpu": f"{250 + 50 * k}m",
                                   "memory": "1Gi"}).label("app", "mix")
        if kind == "spread":
            w = w.spread_constraint(5, ZONE, "DoNotSchedule", {"app": "mix"})
        elif kind == "anyway":
            w = w.spread_constraint(2, ZONE, "ScheduleAnyway",
                                    {"app": "mix"})
        elif kind == "affinity":
            w = w.pod_affinity(ZONE, {"app": "mix"})
        elif kind == "anti":
            w = w.label("anti", "y").pod_affinity(HOSTNAME, {"anti": "y"},
                                                  anti=True)
        elif kind == "score":
            w = w.preferred_pod_affinity(ZONE, {"app": "mix"}, 7)
        if ports and i % 4 == 1:
            w = w.host_port(8080 + k % 2)
        out.append(w.obj())
    return out


PLAN_CASES = {
    # name: (nodes, pods, lean)
    "lean_8sigs": (lambda: _zone_nodes(48, 4), lambda: _mixed_pods(
        64, 8, kinds=("plain",)), True),
    "lean_ports": (lambda: _zone_nodes(24, 3), lambda: _mixed_pods(
        48, 4, ports=True, kinds=("plain",)), True),
    "lean_prefer_taints": (lambda: _zone_nodes(40, 4, prefer=True),
                           lambda: _mixed_pods(40, 4, kinds=("plain",)),
                           True),
    "spread_8sigs": (lambda: _zone_nodes(64, 16), lambda: _mixed_pods(
        100, 8), False),
    "spread_32sigs": (lambda: _zone_nodes(64, 8, cpu=64),
                      lambda: _mixed_pods(96, 32), False),
    "schedule_anyway": (lambda: _zone_nodes(40, 4, prefer=True),
                        lambda: _mixed_pods(50, 2, kinds=("anyway",)),
                        False),
    "self_affinity": (lambda: _zone_nodes(40, 5), lambda: _mixed_pods(
        40, 1, kinds=("affinity",)), False),
    "mixed_terms_ports": (lambda: _zone_nodes(40, 5), lambda: _mixed_pods(
        60, 5, ports=True,
        kinds=("spread", "anyway", "affinity", "anti", "score")), False),
    "capacity_tail": (lambda: _zone_nodes(6, 3, cpu=4), lambda: _mixed_pods(
        40, 3), False),
}


def _run_plan_case(nodes, pods, lean, device, norm_live=None):
    na, batch, table, gd, gc, fam, builder, state = _group_setup(
        nodes, [], pods, device)
    m = len(pods)
    wt, xs = _plan_span(batch, m, device)
    has_ports = bool((batch.sig[:m] == 0).any())
    statics = P.wave_statics(na, table, wt)
    if norm_live is None:
        norm_live = not all(P.static_norm_ok(state.ensure_arrays(),
                                             builder.table.pref_weight[u])
                            for u in wt)
    if lean:
        from kubernetes_tpu_torch.ops.groups import GroupFamilies
        gd = gc = None
        fam = GroupFamilies(False, False, False, False, False)
    carry = P.initial_carry(na, gc)
    cfg = P.ScoreConfig()
    got = P.run_plan(cfg, na, carry, xs, table, wt, gd, statics, fam,
                     norm_live, has_groups=not lean, has_ports=has_ports)
    want = P._run_plan_plain(cfg, na, carry, xs, table, wt, gd, statics,
                             fam, norm_live, not lean, has_ports)
    _equal(got, want)
    return got


@pytest.mark.parametrize("norm_live", [None, True])
@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_run_plan_kernel_equals_plain(cuda, case, norm_live):
    mk_nodes, mk_pods, lean = PLAN_CASES[case]
    _run_plan_case(mk_nodes(), mk_pods(), lean, cuda, norm_live)


def test_run_plan_kernel_full_width(cuda):
    """MixedHighSignature's shape at full width: 5,000 nodes (8,192 rows),
    16 zones, eight signatures under one zone spread."""
    (kc, kp) = _run_plan_case(_zone_nodes(5000, 16, cpu=32),
                              _mixed_pods(300, 8), False, cuda)
    assert kc.used.shape[0] == 8192 and (kp[:300] >= 0).all()


def test_run_plan_refuses_bad_arguments(cuda):
    nodes, pods = _zone_nodes(16, 4), _mixed_pods(40, 4)
    na, batch, table, gd, gc, fam, _b, _s = _group_setup(nodes, [], pods,
                                                         cuda)
    wt, xs = _plan_span(batch, 40, cuda)
    statics = P.wave_statics(na, table, wt)
    carry = P.initial_carry(na, gc)
    cfg = P.ScoreConfig()
    with pytest.raises(ValueError):
        P.run_plan(cfg, na, carry, xs, table, wt * 9, gd,
                   tuple(torch.cat([s] * 9) for s in statics), fam, False)
    with pytest.raises(ValueError):
        P.run_plan(cfg, na, carry, P.WaveXs(valid=xs.valid.cpu(),
                                            widx=xs.widx), table, wt, gd,
                   statics, fam, False)


def _diag_cases():
    nodes = _zone_nodes(30, 3, cpu=4)
    nodes.append(make_node("keyless").capacity({"cpu": 8}).obj())
    nodes.append(make_node("tainted").capacity({"cpu": 8})
                 .taint("t", "v").zone("z0").label(HOSTNAME, "tainted")
                 .obj())
    existing = [make_pod(f"e{k}").req({"cpu": "3"}).label("app", "mix")
                .node(f"n{k}").obj() for k in range(6)]
    existing.append(make_pod("guard").req({"cpu": "1"}).node("n7")
                    .pod_affinity(ZONE, {"app": "web"}, anti=True).obj())
    pods = _mixed_pods(6, 3, ports=True,
                       kinds=("spread", "affinity", "anti"))
    pods.append(make_pod("web").req({"cpu": "1"}).label("app", "web").obj())
    pods.append(make_pod("big").req({"cpu": "6"}).node_selector(
        {"disk": "ssd"}).obj())
    return nodes, existing, pods


@pytest.mark.parametrize("groups", [False, True])
def test_diagnose_row_kernel_equals_plain(cuda, groups):
    nodes, existing, pods = _diag_cases()
    na, batch, table, gd, gc, fam, _b, _s = _group_setup(
        nodes, existing, pods, cuda)
    kw = dict(gd=gd, gc=gc, fam=fam) if groups else {}
    for u in sorted(set(int(t) for t in batch.tidx[:len(pods)])):
        _equal(P.diagnose_row(na, table, u, **kw),
               P._diagnose_plain(na, table, u, **kw))


def test_diagnose_row_kernel_full_width(cuda):
    nodes = _zone_nodes(5000, 16, cpu=32)
    existing = [make_pod(f"e{k}").req({"cpu": "30"}).label("app", "mix")
                .node(f"n{k}").obj() for k in range(0, 5000, 7)]
    pods = _mixed_pods(8, 8)
    na, batch, table, gd, gc, fam, _b, _s = _group_setup(
        nodes, existing, pods, cuda)
    for u in sorted(set(int(t) for t in batch.tidx[:8])):
        _equal(P.diagnose_row(na, table, u, gd=gd, gc=gc, fam=fam),
               P._diagnose_plain(na, table, u, gd, gc, fam))
        _equal(P.diagnose_row(na, table, u), P._diagnose_plain(na, table, u))


# ---------------------------------------------------------------------------
# preemption: the nominated-pod overlay variants and the dry run


def _overlay(rng, batch, n_nodes, N, R, device, nominate=True):
    """(ovl_used, ovl_npods) on `device` and nom_idx (numpy, -1 = none):
    some pods nominated on random nodes (their own request at that row),
    plus a few other nominations."""
    import numpy as np
    ovl_used = np.zeros((N, R), np.int64)
    ovl_npods = np.zeros((N,), np.int32)
    B = len(batch.valid)
    nom_idx = np.full((B,), -1, np.int32)
    for i in range(B):
        if nominate and rng.random() < 0.3:
            row = rng.randrange(n_nodes)
            nom_idx[i] = row
            ovl_used[row] += batch.table.req[batch.tidx[i]]
            ovl_npods[row] += 1
    for _ in range(rng.randint(1, 6)):
        row = rng.randrange(n_nodes)
        ovl_used[row] += batch.table.req[batch.tidx[rng.randrange(B)]]
        ovl_npods[row] += 1
    return (torch.from_numpy(ovl_used).to(device),
            torch.from_numpy(ovl_npods).to(device)), nom_idx


@pytest.mark.parametrize("seed", range(6))
def test_run_batch_overlay_kernel_equals_plain(cuda, seed):
    rng = random.Random(100 + seed)
    pods = [_pod(rng, i) for i in range(rng.randint(10, 60))]
    n_nodes = rng.randint(5, 200)
    na, batch, table = _staged(rng, n_nodes, pods, cuda)
    N, R = na.cap.shape
    ovl, nom_idx = _overlay(rng, batch, n_nodes, N, R, cuda)
    xs = convert.pod_xs_from_numpy(P.PodXs(batch.valid, batch.sig,
                                           batch.tidx, nom_idx), cuda)
    carry = P.initial_carry(na)
    cfg = P.ScoreConfig()
    before = [t.clone() for t in ovl]
    _equal(P.run_batch(cfg, na, carry, xs, table, overlay=ovl),
           P._run_batch_plain(cfg, na, carry, xs, table, overlay=ovl))
    # the caller's overlay is never written (the kernel consumes a copy)
    _equal(tuple(ovl), tuple(before))
    # overlay without nominated pods
    xs0 = convert.pod_xs_from_numpy(P.PodXs(batch.valid, batch.sig,
                                            batch.tidx), cuda)
    _equal(P.run_batch(cfg, na, carry, xs0, table, overlay=ovl),
           P._run_batch_plain(cfg, na, carry, xs0, table, overlay=ovl))


@pytest.mark.parametrize("seed", range(6))
def test_run_uniform_overlay_kernel_equals_plain(cuda, seed):
    rng = random.Random(200 + seed)
    proto = make_pod("plain").req({"cpu": rng.choice(["250m", "1"]),
                                   "memory": "512Mi"}).obj()
    n_nodes = rng.randint(3, 300)
    na, batch, table = _staged(rng, n_nodes, [proto], cuda)
    N, R = na.cap.shape
    ovl, _nom = _overlay(rng, batch, n_nodes, N, R, cuda, nominate=False)
    L = rng.choice([16, 64, 256])
    K = min(L, N)
    J = L + 1
    x = P.PodXs(True, int(batch.sig[0]), int(batch.tidx[0]))
    carry = P.initial_carry(na)
    cfg = P.ScoreConfig()
    n_actual = rng.randint(1, L)
    kc, kp = P.run_uniform(cfg, na, carry, x, table, n_actual, L, K, J,
                           overlay=ovl)
    pc, pp = P._run_uniform_plain(cfg, na, carry, x, table, n_actual, L, K,
                                  J, overlay=ovl)
    _equal((kp, kc), (pp, pc))
    # the no-overlay launch still equals its plain version on the same
    # inputs
    _equal(P.run_uniform(cfg, na, carry, x, table, n_actual, L, K, J),
           P._run_uniform_plain(cfg, na, carry, x, table, n_actual, L, K,
                                J))


def _dry_inputs(rng, C, V, n_nodes, device, spread):
    """Seeded dry-run inputs: staged nodes, a preemptor row, C candidate
    rows (padded by repeating row 0), V victim slots with holes, an
    overlay and, with `spread`, DryRunSpread tensors (SC = 2)."""
    import numpy as np
    from kubernetes_tpu_torch.ops.groups import DryRunSpread
    rs = np.random.RandomState(rng.randrange(1 << 30))
    proto = make_pod("vip").req({"cpu": "2", "memory": "1Gi"}).obj()
    na, batch, _table = _staged(rng, n_nodes, [proto], device)
    N, R = na.cap.shape
    row = P.pod_row_from_table(batch.table, int(batch.tidx[0]), device)
    real = min(C, n_nodes)
    cand = np.zeros((C,), np.int32)
    cand[:real] = rs.choice(n_nodes, real, replace=False)
    vreq = np.zeros((C, V, R), np.int64)
    vreq[:, :, 0] = rs.choice([0, 500, 1000, 2000], (C, V))
    vreq[:, :, 1] = rs.choice([0, 1 << 29, 1 << 30], (C, V))
    vvalid = rs.rand(C, V) < 0.7
    vvalid[real:] = False
    ovl_used = np.zeros((C, R), np.int64)
    ovl_used[:, 0] = rs.choice([0, 0, 1000], C)
    ovl_npods = (ovl_used[:, 0] > 0).astype(np.int32)
    sp = None
    if spread:
        SC = 2
        other = rs.randint(0, 6, (C, SC)).astype(np.int32)
        other[rs.rand(C, SC) < 0.2] = np.iinfo(np.int32).max
        sp = DryRunSpread(
            max_skew=np.array([1, 2], np.int32),
            self_match=np.array([1, 0], np.int32),
            min_zero=np.array([False, True]), tv_ok=rs.rand(C, SC) < 0.9,
            cnt0=rs.randint(0, 6, (C, SC)).astype(np.int32),
            other_min=other, vic_match=rs.rand(C, V, SC) < 0.5)
        sp = DryRunSpread(*(torch.from_numpy(np.asarray(x)).to(device)
                            for x in sp))

    def t(x):
        return torch.from_numpy(x).to(device)
    return (na, row, t(cand), t(vreq), t(vvalid), t(ovl_used),
            t(ovl_npods), sp)


@pytest.mark.parametrize("spread", [False, True])
@pytest.mark.parametrize("seed", range(4))
def test_dry_run_kernel_equals_plain(cuda, seed, spread):
    rng = random.Random(300 + seed)
    args = _dry_inputs(rng, 64, 8, rng.randint(20, 200), cuda, spread)
    k = P.dry_run_select_victims(*args)
    p = P._dry_run_select_victims_plain(*args)
    _equal(k, p)
    assert k.dtype == torch.bool and k.shape == (64, 9)


@pytest.mark.parametrize("spread", [False, True])
def test_dry_run_kernel_full_width(cuda, spread):
    """C = 8,192 candidates (the PreemptionChurn shape: V = 1) and V = 8."""
    rng = random.Random(7)
    for V in (1, 8):
        args = _dry_inputs(rng, 8192, V, 5000, cuda, spread)
        _equal(P.dry_run_select_victims(*args),
               P._dry_run_select_victims_plain(*args))


def test_preemption_kernels_refuse_bad_arguments(cuda):
    rng = random.Random(9)
    args = list(_dry_inputs(rng, 16, 4, 20, cuda, False))
    # more victim slots than the kernel takes
    too_many = list(args)
    too_many[3] = torch.zeros((16, 129, args[3].shape[2]),
                              dtype=torch.int64, device=cuda)
    too_many[4] = torch.zeros((16, 129), dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="victim slots"):
        P.dry_run_select_victims(*too_many)
    # an overlay on the wrong device
    pods = [make_pod("p").req({"cpu": "1"}).obj()]
    na, batch, table = _staged(rng, 8, pods, cuda)
    N, R = na.cap.shape
    xs = convert.pod_xs_from_numpy(P.PodXs(batch.valid, batch.sig,
                                           batch.tidx), cuda)
    bad = (torch.zeros((N, R), dtype=torch.int64),
           torch.zeros((N,), dtype=torch.int32))
    with pytest.raises(ValueError, match="overlay"):
        P.run_batch(P.ScoreConfig(), na, P.initial_carry(na), xs, table,
                    overlay=bad)
    x = P.PodXs(True, int(batch.sig[0]), int(batch.tidx[0]))
    with pytest.raises(ValueError, match="overlay"):
        P.run_uniform(P.ScoreConfig(), na, P.initial_carry(na), x, table,
                      4, 16, min(16, N), 17, overlay=bad)


# ---------------------------------------------------------------------------
# gangs: run_gang's scan tier (run_gang.cu) and closed-form tier (the gang
# epilogue of run_uniform.cu)


def _gang_layout(batch, m, bucket, device):
    """The scheduler's gang layout (Scheduler._gang_dispatch): (GangXs,
    signature rows)."""
    from kubernetes_tpu_torch.ops.gang import GangXs
    from kubernetes_tpu_torch.state.tensorize import pow2_at_least
    import numpy as np
    tid = batch.tidx[:m]
    uniq = list(dict.fromkeys(int(t) for t in tid))
    S = pow2_at_least(len(uniq), 1)
    wt = (uniq + [uniq[-1]] * S)[:S]
    slot = {}
    for s, u in enumerate(wt):
        slot.setdefault(u, s)
    widx = np.empty((bucket,), np.int32)
    widx[:m] = [slot[int(t)] for t in tid]
    widx[m:] = widx[m - 1]
    tidx = np.full((bucket,), tid[m - 1], np.int32)
    tidx[:m] = tid
    valid = np.zeros((bucket,), bool)
    valid[:m] = True
    return convert.gang_xs_from_numpy(GangXs(valid, tidx, widx), device), wt


def _gang_scan_check(na, batch, table, m, bucket, needed, w_contig, zones,
                     device):
    from kubernetes_tpu_torch.ops import gang as G
    xs, wt = _gang_layout(batch, m, bucket, device)
    N = na.cap.shape[0]
    dom = torch.tensor([i % zones for i in range(N)], dtype=torch.int32,
                       device=device)
    statics = P.wave_statics(na, table, wt)
    carry = P.initial_carry(na)
    before = [t.clone() for t in list(carry[:4]) + list(carry.cache)]
    got = G.run_gang(P.ScoreConfig(), na, carry, xs, table, wt=wt,
                     needed=needed, dom=dom, statics=statics,
                     w_contig=w_contig)
    want = G._run_gang_scan_plain(P.ScoreConfig(), na, carry, xs, table, wt,
                                  needed, dom, statics, w_contig)
    torch.cuda.synchronize()
    _equal(got, want)
    # the kernel never writes its input carry
    _equal(before, list(carry[:4]) + list(carry.cache))
    return got[1].cpu()


@pytest.mark.parametrize("w_contig", [0, 2])
@pytest.mark.parametrize("seed", range(6))
def test_run_gang_scan_kernel_equals_plain(cuda, seed, w_contig):
    rng = random.Random(100 + seed)
    protos = [_pod(rng, k) for k in range(rng.choice([1, 2, 3]))]
    protos = [p if not any(q.host_port for c in p.spec.containers
                           for q in c.ports)
              else make_pod(f"np{k}").req({"cpu": "1"}).obj()
              for k, p in enumerate(protos)]
    m = rng.randint(2, 40)
    pods = [protos[rng.randrange(len(protos))] for _ in range(m)]
    na, batch, table = _staged(rng, rng.randint(3, 200), pods, cuda)
    bucket = rng.choice([1, 2]) * max(16, 1 << (m - 1).bit_length())
    pk = _gang_scan_check(na, batch, table, m, bucket,
                          rng.randint(0, m + 2), w_contig, 3, cuda)
    assert int(pk[bucket + 1]) == int((pk[:m] >= 0).sum())


@pytest.mark.parametrize("seed", range(8))
def test_run_gang_uniform_kernel_equals_plain(cuda, seed):
    from kubernetes_tpu_torch.ops import gang as G
    rng = random.Random(200 + seed)
    proto = _pod(rng, 0)
    if any(p.host_port for c in proto.spec.containers for p in c.ports):
        proto = make_pod("plain").req({"cpu": "1", "memory": "1Gi"}).obj()
    na, batch, table = _staged(rng, rng.randint(3, 300), [proto], cuda)
    N = na.cap.shape[0]
    L = rng.choice([16, 64, 256])
    K = min(L, N)
    J = rng.choice([2, 8, L + 1])
    if K * J < L:
        J = L + 1
    x = P.PodXs(True, int(batch.sig[0]), int(batch.tidx[0]))
    carry = P.initial_carry(na)
    before = [t.clone() for t in list(carry[:4]) + list(carry.cache)]
    n_actual = rng.randint(1, L)
    needed = rng.randint(0, n_actual + 2)
    got = G.run_gang(P.ScoreConfig(), na, carry, x, table, needed=needed,
                     uniform=True, n_actual=n_actual, L=L, K=K, J=J)
    want = G._run_gang_uniform_plain(P.ScoreConfig(), na, carry, x, table,
                                     n_actual, needed, L, K, J)
    torch.cuda.synchronize()
    _equal(got, want)
    _equal(before, list(carry[:4]) + list(carry.cache))


def test_run_gang_kernels_full_width(cuda):
    """8,192 node rows: the closed form at GangTraining's shape (L = K =
    256, J = 8) accepted and rejected; the scan tier at CoLocatedInference's
    (B = 128, S = 1, w_contig = 2, 16 zones) and an S = 4 gang padded from
    60 members."""
    rng = random.Random(5)
    cache = Cache()
    for i in range(5000):
        cache.add_node(make_node(f"node-{i}").capacity(
            {"cpu": 32, "memory": "64Gi", "pods": 110}).zone(
            f"zone-{i % 16}").obj())
    snap = Snapshot()
    cache.update_snapshot(snap)
    state = ClusterState(device=cuda)
    state.apply_snapshot(snap)
    protos = [make_pod(f"g{k}").req({"cpu": c, "memory": "1Gi"}).obj()
              for k, c in enumerate(["900m", "1", "2", "3"])]
    builder = BatchBuilder(state)
    batch = builder.build([protos[0]])
    na = state.device_arrays()
    table = P.table_from_batch(batch, cuda)
    from kubernetes_tpu_torch.ops import gang as G
    x = P.PodXs(True, int(batch.sig[0]), int(batch.tidx[0]))
    carry = P.initial_carry(na)
    for needed in (256, 10 ** 6):
        _equal(G.run_gang(P.ScoreConfig(), na, carry, x, table,
                          needed=needed, uniform=True, n_actual=256, L=256,
                          K=256, J=8),
               G._run_gang_uniform_plain(P.ScoreConfig(), na, carry, x,
                                         table, 256, needed, 256, 256, 8))
    pk = _gang_scan_check(na, batch, table, 1, 128, 1, 2, 16, cuda)
    del pk
    batch = builder.build([protos[0]] * 128)
    table = P.table_from_batch(batch, cuda)
    _gang_scan_check(na, batch, table, 128, 128, 128, 2, 16, cuda)
    _gang_scan_check(na, batch, table, 128, 128, 10 ** 6, 2, 16, cuda)
    mixed = [protos[rng.randrange(4)] for _ in range(60)]
    batch = builder.build(mixed)
    table = P.table_from_batch(batch, cuda)
    _gang_scan_check(na, batch, table, 60, 64, 60, 2, 16, cuda)


# ---------------------------------------------------------------------------
# observability: the cluster probe and the score decomposition


def _cpu(tree):
    if tree is None or isinstance(tree, (bool, int)):
        return tree
    if isinstance(tree, torch.Tensor):
        return tree.cpu()
    return type(tree)(*(_cpu(x) for x in tree))


def _probe_inputs(rng, N, R, ndom, device):
    import numpy as np
    cap = (rng.randint(0, 6, (N, R)) * rng.choice([1, 1000, 2 ** 33 + 5])
           ).astype(np.int64)
    used = (cap * rng.rand(N, R)).astype(np.int64)
    used[::5] = cap[::5]                      # some saturated nodes
    valid = rng.rand(N) < 0.9
    npods = rng.randint(0, 110, N).astype(np.int32)
    dom = rng.randint(-1, ndom + 1, N).astype(np.int32)
    return [torch.from_numpy(x).to(device)
            for x in (cap, valid, used, npods, dom)]


@pytest.mark.parametrize("shape", [(1, 1, 1), (37, 3, 5), (8192, 4, 16),
                                   (8192, 4, 5000), (65536, 2, 65536)])
def test_cluster_probe_kernel_equals_plain(cuda, shape):
    import numpy as np
    N, R, ndom = shape
    cap, valid, used, npods, dom = _probe_inputs(
        np.random.RandomState(N + R), N, R, ndom, cuda)
    got = P.cluster_probe(SimpleNamespace(cap=cap, valid=valid),
                          SimpleNamespace(used=used, npods=npods), dom,
                          ndom)
    want = P._probe_plain(cap.cpu(), valid.cpu(), used.cpu(), npods.cpu(),
                          dom.cpu(), ndom)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.cpu().view(torch.int32) if a.dtype ==
                           torch.float32 else a.cpu(),
                           b.view(torch.int32) if b.dtype == torch.float32
                           else b)


@pytest.mark.parametrize("groups", [False, True])
@pytest.mark.parametrize("k", [1, 5, 16])
def test_explain_row_kernel_equals_plain(cuda, groups, k):
    nodes, existing, pods = _diag_cases()
    na, batch, table, gd, gc, fam, _b, _s = _group_setup(
        nodes, existing, pods, cuda)
    carry = P.initial_carry(na, gc if groups else None)
    kw = dict(gd=gd, fam=fam) if groups else {}
    cfg = P.ScoreConfig()
    for u in sorted(set(int(t) for t in batch.tidx[:len(pods)])):
        got = P.explain_row(cfg, na, carry, table, u, k=k, **kw)
        want = P._explain_plain(cfg, _cpu(na), _cpu(carry), _cpu(table), u,
                                k, _cpu(gd) if groups else None,
                                fam if groups else None)
        _equal(got, want)


# ---------------------------------------------------------------------------
# the sanitizer rails: the score probe, the sync guard, the held carry


def _bits(t):
    t = t.cpu()
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.parametrize("seed", range(6))
def test_score_probe_kernel_equals_plain(cuda, seed):
    """Random clusters (zero-capacity columns, saturated and padded rows)
    and pods (zero requests, skip_balanced rows), every table row, after a
    scan has filled the carry."""
    rng = random.Random(seed)
    pods = [_pod(rng, i) for i in range(rng.randint(10, 60))]
    na, batch, table = _staged(rng, rng.randint(5, 300), pods, cuda)
    xs = convert.pod_xs_from_numpy(P.PodXs(batch.valid, batch.sig,
                                           batch.tidx), cuda)
    cfg = P.ScoreConfig(strategy=rng.choice(["LeastAllocated",
                                             "MostAllocated"]))
    carry, _ = P.run_batch(cfg, na, P.initial_carry(na), xs, table)
    for u in sorted(set(int(t) for t in batch.tidx[:len(pods)])):
        got = P.score_probe(cfg, na, carry, table, u)
        want = P._score_probe_plain(cfg, _cpu(na), _cpu(carry),
                                    _cpu(table), u)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype == torch.float32
            assert a.shape == b.shape
            assert torch.equal(_bits(a), _bits(b))


def test_sync_guard_trips_on_item(cuda):
    from kubernetes_tpu_torch.analysis.rails import SanitizerRails
    rails = SanitizerRails(enabled=True)
    x = torch.ones(8, device=cuda)
    with pytest.raises(RuntimeError):
        with rails.guard_dispatch(cuda):
            x.sum().item()
    assert torch.cuda.get_sync_debug_mode() == 0
    assert rails.guarded_dispatches == 1
    # a declared phase inside the guard allows it
    with rails.guard_dispatch(cuda), rails.declared("host_cache", cuda):
        assert x.sum().item() == 8.0
    # the enqueue-only work of a dispatch passes
    with rails.guard_dispatch(cuda):
        y = convert.upload(torch.arange(4), cuda) + x[:4].long()
    assert y.tolist() == [1, 2, 3, 4]


def test_span_converters_do_not_synchronize(cuda):
    """The converters a span calls between a drain's launches copy
    through pinned memory without blocking (state/convert.py upload): the
    armed guard lets them pass, while the pageable copy they replaced
    trips it."""
    import numpy as np
    from kubernetes_tpu_torch.analysis.rails import SanitizerRails
    from kubernetes_tpu_torch.ops.gang import GangXs
    rails = SanitizerRails(enabled=True)
    torch.ones(1, device=cuda)              # the context exists
    valid, idx = np.ones(64, bool), np.arange(64, dtype=np.int32)
    with rails.guard_dispatch(cuda):
        xs = convert.pod_xs_from_numpy(
            P.PodXs(valid, idx, idx, nom_idx=idx), cuda)
        gx = convert.gang_xs_from_numpy(GangXs(valid, idx, idx), cuda)
        dom = convert.dom_from_numpy(idx, cuda)
    assert xs.tidx.is_cuda and gx.widx.is_cuda and dom.is_cuda
    assert torch.equal(xs.nom_idx.cpu(), torch.from_numpy(idx))
    with pytest.raises(RuntimeError):
        with rails.guard_dispatch(cuda):
            torch.from_numpy(idx).to(cuda)


def test_held_carry_checksum_sees_device_write(cuda):
    from kubernetes_tpu_torch.analysis.rails import (SanitizerError,
                                                     SanitizerRails)
    rng = random.Random(3)
    na, _batch, _table = _staged(rng, 40, [_pod(rng, 0)], cuda)
    carry = P.initial_carry(na)
    rails = SanitizerRails(enabled=True)
    held = rails.hold(carry)
    rails.check_held(held, "clean")
    version = carry.npods._version
    carry.npods.data.add_(1)       # moves no version counter
    assert carry.npods._version == version
    with pytest.raises(SanitizerError, match="on the device"):
        rails.check_held(held, "commit")


# ---------------------------------------------------------------------------
# the node-sharded mesh: D shards of cuda:0 ("one"), or shard d on cuda:d
# ("cards", on a machine with D cards), against the plain versions over D
# CPU shards (kubernetes_tpu_torch/parallel/sharding.py)

MESHES = [(1, "one"), (2, "one"), (4, "one"), (2, "cards"), (4, "cards")]


def _mesh_pair(D, place):
    from kubernetes_tpu_torch.parallel import sharding as S
    if place == "one":
        devices = ["cuda:0"] * D
    else:
        if torch.cuda.device_count() < D:
            pytest.skip(f"needs {D} cards (one shard on each)")
        devices = [f"cuda:{d}" for d in range(D)]
    return (S, S.make_mesh(devices=devices),
            S.make_mesh(devices=["cpu"] * D))


@pytest.mark.parametrize("D,place", MESHES)
@pytest.mark.parametrize("seed", range(3))
def test_run_batch_sharded_kernel_equals_plain(cuda, seed, D, place):
    S, gm, cm = _mesh_pair(D, place)
    rng = random.Random(seed)
    pods = [_pod(rng, i) for i in range(rng.randint(10, 40))]
    na, batch, table = _staged(rng, rng.randint(5, 120), pods, cuda)
    xs = convert.pod_xs_from_numpy(P.PodXs(batch.valid, batch.sig,
                                           batch.tidx), cuda)
    gna = S.shard_node_arrays(gm, na)
    cna = S.shard_node_arrays(cm, na)
    gc, ga = S.run_batch_sharded(P.ScoreConfig(), gm, gna,
                                 S.initial_carry_sharded(gna), xs, table)
    cc, ca = S.run_batch_sharded(P.ScoreConfig(), cm, cna,
                                 S.initial_carry_sharded(cna),
                                 convert.pod_xs_from_numpy(
                                     P.PodXs(batch.valid, batch.sig,
                                             batch.tidx), "cpu"),
                                 P.table_from_batch(batch, "cpu"))
    _equal((ga, S.unshard(gc)), (ca, S.unshard(cc)))
    # the single-device kernel's assignments
    _, sa = P.run_batch(P.ScoreConfig(), na, P.initial_carry(na), xs, table)
    _equal(ga, sa)
    # the lane probe: row 1's kernel on every shard's slice, on its card
    prof = S.profile_shard_lanes(P.ScoreConfig(), gm, gna,
                                 S.initial_carry_sharded(gna), xs, table)
    assert len(prof["laneSeconds"]) == D


@pytest.mark.parametrize("D,place", MESHES)
@pytest.mark.parametrize("seed", range(3))
def test_run_uniform_sharded_kernel_equals_plain(cuda, seed, D, place):
    S, gm, cm = _mesh_pair(D, place)
    rng = random.Random(seed)
    proto = make_pod("plain").req({"cpu": rng.choice(["250m", "1"]),
                                   "memory": "1Gi"}).obj()
    na, batch, table = _staged(rng, rng.randint(8, 200), [proto], cuda)
    N = na.cap.shape[0]
    L = rng.choice([16, 64, 256])
    K = min(L, N)
    J = rng.choice([2, 8, L + 1])
    x = P.PodXs(True, int(batch.sig[0]), int(batch.tidx[0]))
    n_actual = rng.randint(1, L)
    gna = S.shard_node_arrays(gm, na)
    cna = S.shard_node_arrays(cm, na)
    ctab = P.table_from_batch(batch, "cpu")
    gc0, cc0 = S.initial_carry_sharded(gna), S.initial_carry_sharded(cna)
    gc, gp = S.run_uniform_sharded(P.ScoreConfig(), gm, gna, gc0, x, table,
                                   n_actual, L, K, J)
    cc, cp = S.run_uniform_sharded(P.ScoreConfig(), cm, cna, cc0, x, ctab,
                                   n_actual, L, K, J)
    _equal((gp, S.unshard(gc)), (cp, S.unshard(cc)))
    # the fast path on the output carry
    _equal(S.run_uniform_sharded(P.ScoreConfig(), gm, gna, gc, x, table,
                                 n_actual, L, K, J)[1],
           S.run_uniform_sharded(P.ScoreConfig(), cm, cna, cc, x, ctab,
                                 n_actual, L, K, J)[1])


@pytest.mark.parametrize("D,place", MESHES)
def test_scatter_rows_sharded_kernel_equals_plain(cuda, D, place):
    import numpy as np
    S, gm, cm = _mesh_pair(D, place)
    rng = random.Random(5)
    na, _, _ = _staged(rng, 100, [_pod(rng, 0)], cuda)
    na2, _, _ = _staged(random.Random(6), 100, [_pod(rng, 1)], cuda)
    N = na.cap.shape[0]
    idx = np.array([0, N // 4 - 1, N // 4, N // 2 - 1, N // 2, N - 1, 0, 0])
    rows = type(na)(*(x.cpu()[torch.from_numpy(idx)].numpy() for x in na2))
    gdev = S.shard_node_arrays(gm, na)
    got = S.scatter_rows_sharded(gm, gdev, idx, rows)
    want = S.scatter_rows_sharded(cm, S.shard_node_arrays(cm, na), idx, rows)
    _equal(S.unshard(got), S.unshard(want))
    _equal(S.unshard(gdev), na)


@pytest.mark.parametrize("D,place", MESHES)
def test_cluster_probe_sharded_kernel_bit_equal(cuda, D, place):
    import numpy as np
    S, gm, _cm = _mesh_pair(D, place)
    cap, valid, used, npods, dom = _probe_inputs(
        np.random.RandomState(9), 8192, 4, 16, cuda)
    na = SimpleNamespace(cap=cap, valid=valid, used=used)
    carry = SimpleNamespace(used=used, npods=npods)
    n = 8192 // D

    def shards(tree, fields):
        return S.Shards(SimpleNamespace(**{
            f: getattr(tree, f)[d * n:(d + 1) * n].to(gm.devices[d])
            for f in fields}) for d in range(D))

    got = S.cluster_probe_sharded(gm, shards(na, ("cap", "valid", "used")),
                                  shards(carry, ("used", "npods")), dom, 16)
    want = P._probe_plain(cap.cpu(), valid.cpu(), used.cpu(), npods.cpu(),
                          dom.cpu(), 16)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu().view(torch.int32) if a.dtype ==
                           torch.float32 else a.cpu(),
                           b.view(torch.int32) if b.dtype == torch.float32
                           else b)


def _mesh_drain(mesh, n_nodes=40, n_pods=160):
    """A SchedulingBasic-like drain (uniform runs, a node update between
    two waves), then pods over 40 request shapes (beyond the plan
    lattice: the scan), on the port's Scheduler; returns its bind map and
    pending pods."""
    from kubernetes_tpu_torch.backend.apiserver import APIServer
    from kubernetes_tpu_torch.scheduler import Scheduler
    api = APIServer()
    sched = Scheduler(api, batch_size=64, clock=lambda: 1000.0, mesh=mesh)
    sched.state.scatter_shift = 0

    def node(i, cpu):
        w = make_node(f"n{i}").capacity({
            "cpu": cpu, "memory": f"{8 + (i * 5) % 24}Gi",
            "pods": 110}).zone(f"z{i % 3}")
        if i % 4 == 1:
            w = w.label("disk", "ssd")
        if i % 5 == 0:
            w = w.image("nginx:1", (100 + 50 * (i % 7)) << 20)
        return w.obj()

    for i in range(n_nodes):
        api.create_node(node(i, 4 + (i * 7) % 13))
    sched.prime()
    pods = [make_pod(f"p{i}").req({"cpu": "900m", "memory": "1Gi"})
            .container({"cpu": "100m"}, image="nginx:1").obj()
            for i in range(n_pods // 2)]
    for k in range(0, len(pods), 32):
        api.create_pods(pods[k:k + 32])
        sched.schedule_pending(wait=False)
    sched.schedule_pending()
    api.update_node(node(3, 2))
    api.create_pods([make_pod(f"b{i}").req({
        "cpu": f"{100 + 25 * (i % 40)}m",
        "memory": f"{128 + 64 * (i % 7)}Mi"}).obj()
        for i in range(n_pods // 2)])
    sched.schedule_pending()
    assert sched.reconcile() == []
    binds = {uid: p.spec.node_name for uid, p in api.pods.items()
             if p.spec.node_name}
    return binds, sorted(p.uid for p in sched.queue.pending_pods()[0])


@pytest.mark.parametrize("D", [2, 4])
def test_mesh_scheduler_binds_as_single_device(cuda, D):
    """Scheduler(mesh=make_mesh(D)) on its default placement (shard d on
    cuda:d where D cards are visible, else every shard on cuda:0): the
    single-device Scheduler's bind map, through the sharded kernels
    only."""
    from kubernetes_tpu_torch.ops import kernels as K
    from kubernetes_tpu_torch.parallel import sharding as S
    want = _mesh_drain(None)
    for k in K.LAUNCHES:
        K.LAUNCHES[k] = 0
    got = _mesh_drain(S.make_mesh(D))
    assert got == want and len(got[0]) > 100
    for k in ("run_uniform_sharded", "run_batch_sharded",
              "scatter_rows_sharded", "cluster_probe_sharded"):
        assert K.LAUNCHES[k] > 0, k
    for k in ("run_uniform", "run_batch", "scatter_rows", "cluster_probe"):
        assert K.LAUNCHES[k] == 0, k
