"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: these tests need an NVIDIA GPU with nvcc and skip
elsewhere (the CPU tests hold the plain versions to the JAX package; these
hold the kernels to the plain versions). On a machine with the card:

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

Tolerance: exact equality of assignments, packed flags, every carry field
and the whole SigCache."""

import random

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
