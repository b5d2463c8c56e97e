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

from _gang_edges import GANG_EDGE_CASES, check_placements
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


# ---------------------------------------------------------------------------
# run_wave (csrc/run_wave.cu: one thread-block cluster a call) on the edge
# inputs of tests/_wave_edges.py, whose plain version
# tests/test_torch_wave_edges.py holds to the JAX package, and at the
# full-width TopologySpreading / SchedulingPodAntiAffinity drains


def _wave_edge_inputs(case, device):
    """One WAVE_EDGE_CASES case through the port's state layer: (e, args
    for program.run_wave's plain version) on `device`."""
    from _wave_edges import stage
    from kubernetes_tpu_torch.ops.groups import GroupFamilies
    from kubernetes_tpu_torch.testing import wrappers
    e = stage(case, SimpleNamespace(
        Cache=Cache, Snapshot=Snapshot, ClusterState=ClusterState,
        BatchBuilder=BatchBuilder, W=wrappers,
        static_norm_ok=P.static_norm_ok))
    na = convert.node_arrays_from_numpy(e.arrays, device)
    table = convert.pod_table_from_numpy(e.table, device)
    gd = convert.groups_dev_from_numpy(e.gd, device)
    gc = convert.group_carry_from_numpy(e.gc, device)
    statics = tuple(x[0] for x in P.wave_statics(na, table, [e.u]))
    valid = torch.from_numpy(e.valid.copy()).to(device)
    return e, (P.ScoreConfig(), na, P.initial_carry(na, gc), valid, table,
               e.u, gd, statics, e.K, e.J, e.Lw, GroupFamilies(*e.fam),
               e.norm_live, e.anti, e.merge_on)


def _run_wave_kernel(args):
    cfg, na, carry, valid, table, u, gd, statics, K, J, Lw, fam, \
        norm_live, anti, merge = args
    return P.run_wave(cfg, na, carry, valid, table, u, gd, statics, K, J,
                      fam, norm_live, anti_term=anti, merge_on=merge, Lw=Lw)


@pytest.mark.parametrize("case", [
    "aa_full_width", "anti_keyless_nodes", "capacity_exhausted_serial_tail",
    "lw_cut_inside_node_entries", "norm_live_merge_off",
    "spread_levels_reach_m_cap", "ties_at_cta_splits_and_kth",
    "ts_full_width"])
def test_run_wave_edges_equal_plain(cuda, case):
    """The kernel against the plain version on the CPU: the assignments
    and wave stats, every carry field, the whole group carry; the caller's
    carry unwritten."""
    from _wave_edges import check_case
    e, args = _wave_edge_inputs(case, cuda)
    carry = args[2]
    before = _cpu(carry)
    kc, kp = _run_wave_kernel(args)
    _e, cpu_args = _wave_edge_inputs(case, "cpu")
    pc, pp = P._run_wave_plain(*cpu_args)
    torch.cuda.synchronize()
    _equal((kp, kc), (pp, pc))
    _equal(carry, before)
    B = e.valid.shape[0]
    check_case(case, kp[:e.n].cpu().numpy(), kp[B:].cpu().numpy())


def test_run_wave_launches_once_a_call(cuda):
    """One wrapper call is one CUDA launch of run_wave_kernel (the copies
    of the carry it writes are the only other device work)."""
    from torch.profiler import ProfilerActivity, profile
    from kubernetes_tpu_torch.ops import kernels as K
    _e, args = _wave_edge_inputs("capacity_exhausted_serial_tail", cuda)
    _run_wave_kernel(args)
    torch.cuda.synchronize()
    K.reset_launches()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _run_wave_kernel(args)
        torch.cuda.synchronize()
    assert K.LAUNCHES["run_wave"] == 1
    names = [ev.name for ev in prof.events()
             if ev.device_type == torch.autograd.DeviceType.CUDA]
    assert sum("run_wave_kernel" in n for n in names) == 1, names


# ---------------------------------------------------------------------------
# run_batch (csrc/run_batch.cu: one thread-block cluster a span) on the
# edge inputs of tests/_batch_edges.py, whose plain version
# tests/test_torch_batch_edges.py holds to the JAX package


def _edge_inputs(case, device):
    """One RUN_BATCH_EDGE_CASES case through the port's state layer:
    (e, na, table, groups, fam, overlay) on `device`."""
    from _batch_edges import stage
    from kubernetes_tpu_torch.ops.groups import GroupFamilies
    from kubernetes_tpu_torch.state.batch import BatchDims
    from kubernetes_tpu_torch.testing import wrappers
    e = stage(case, SimpleNamespace(
        Cache=Cache, Snapshot=Snapshot, ClusterState=ClusterState,
        BatchBuilder=BatchBuilder, BatchDims=BatchDims, W=wrappers))
    na = convert.node_arrays_from_numpy(e.arrays, device)
    table = convert.pod_table_from_numpy(e.table, device)
    groups = fam = overlay = None
    if e.mode == "groups":
        groups = (convert.groups_dev_from_numpy(e.gd, device),
                  convert.group_carry_from_numpy(e.gc, device))
        fam = GroupFamilies(*e.fam)
    if e.mode == "ovl":
        overlay = (torch.from_numpy(e.ovl_used).to(device),
                   torch.from_numpy(e.ovl_npods).to(device))
    return e, na, table, groups, fam, overlay


def _edge_xs(e, device, keep=None):
    sl = slice(None) if keep is None else keep
    return convert.pod_xs_from_numpy(P.PodXs(
        valid=e.valid[sl], sig=e.sig[sl], tidx=e.tidx[sl],
        nom_idx=None if e.nom_idx is None else e.nom_idx[sl]), device)


@pytest.mark.parametrize("case", [
    "groups_beyond_lattice", "groups_every_family", "overlay_nominations",
    "ragged_outside_invalid", "sig_change_every_other_pod",
    "sig_change_every_pod", "ties_at_cta_boundaries"])
def test_run_batch_edges_equal_plain(cuda, case):
    """The kernel over the whole span (a row outside the table reports -2
    and changes nothing) against the plain version on the CPU over the
    span without it: assignments, every carry field, the SigCache and the
    group carry; the caller's carry and overlay unwritten."""
    from _batch_edges import check_span, full_span, kept
    e, na, table, groups, fam, overlay = _edge_inputs(case, cuda)
    gd, gc = groups if groups is not None else (None, None)
    carry = P.initial_carry(na, gc)
    before = _cpu(carry)
    cfg = P.ScoreConfig()
    kc, ka = P.run_batch(cfg, na, carry, _edge_xs(e, cuda), table, gd, fam,
                         overlay=overlay)
    keep = kept(e)
    pc, pa = P._run_batch_plain(
        cfg, _cpu(na), _cpu(carry), _edge_xs(e, "cpu", keep), _cpu(table),
        _cpu(gd), fam,
        overlay=None if overlay is None else tuple(t.cpu() for t in overlay))
    torch.cuda.synchronize()
    got = ka.cpu().tolist()
    assert got == full_span(e, pa.numpy())
    _equal(kc, pc)
    _equal(carry, before)
    if overlay is not None:
        assert torch.equal(overlay[0].cpu(), torch.from_numpy(e.ovl_used))
        assert torch.equal(overlay[1].cpu(), torch.from_numpy(e.ovl_npods))
    check_span(case, got)


@pytest.mark.parametrize("mode", ["lean", "ovl", "groups"])
def test_run_batch_launches_once_a_span(cuda, mode):
    """One wrapper call is one CUDA launch of run_batch_kernel, in every
    mode (the copies of the carry it writes are the only other device
    work)."""
    from torch.profiler import ProfilerActivity, profile
    from kubernetes_tpu_torch.ops import kernels as K
    case = {"lean": "sig_change_every_pod", "ovl": "overlay_nominations",
            "groups": "groups_every_family"}[mode]
    e, na, table, groups, fam, overlay = _edge_inputs(case, cuda)
    gd, gc = groups if groups is not None else (None, None)
    carry = P.initial_carry(na, gc)
    xs = _edge_xs(e, cuda)
    cfg = P.ScoreConfig()
    P.run_batch(cfg, na, carry, xs, table, gd, fam, overlay=overlay)
    torch.cuda.synchronize()
    K.reset_launches()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        P.run_batch(cfg, na, carry, xs, table, gd, fam, overlay=overlay)
        torch.cuda.synchronize()
    key = {"lean": "run_batch", "ovl": "run_batch_ovl",
           "groups": "run_batch_groups"}[mode]
    assert K.LAUNCHES[key] == 1
    names = [ev.name for ev in prof.events()
             if ev.device_type == torch.autograd.DeviceType.CUDA]
    assert sum("run_batch_kernel" in n for n in names) == 1, names


def test_run_batch_refuses_bad_arguments(cuda):
    """Checked before any launch: a pod stream of mismatched lengths, a
    tensor on another device, an overlay with groups."""
    e, na, table, groups, fam, overlay = _edge_inputs("groups_every_family",
                                                      cuda)
    gd, gc = groups
    carry = P.initial_carry(na, gc)
    xs = _edge_xs(e, cuda)
    cfg = P.ScoreConfig()
    with pytest.raises(ValueError):
        P.run_batch(cfg, na, carry, xs._replace(sig=xs.sig[:-1]), table, gd,
                    fam)
    with pytest.raises(ValueError):
        P.run_batch(cfg, na, carry, xs._replace(valid=xs.valid.cpu()),
                    table, gd, fam)
    with pytest.raises(ValueError):
        P.run_batch(cfg, na, carry, xs, table, gd, fam,
                    overlay=(carry.used.clone(), carry.npods.clone()))


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


def _mixed_pods(n, sigs, ports=False, kinds=("spread",), prefix="m"):
    out = []
    for i in range(n):
        k = i % sigs
        kind = kinds[i % len(kinds)]
        w = make_pod(f"{prefix}{i}").req({"cpu": f"{250 + 50 * k}m",
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


# the cluster design's edges (csrc/run_plan.cu: C CTAs, a contiguous
# range of N / C rows each; csrc/run_plan_sharded.cu on one card: D·T
# blocks), run by run_plan and by run_plan_sharded on make_mesh(2) of one
# card, each against the single-device plain version. N = 2,048 puts a
# CTA boundary at every multiple of 128 for C = 16 (256 for C = 8).


def _rack_nodes(n, per_rack, cpu=16):
    """n nodes, racks of `per_rack` consecutive nodes (label "rack"):
    a rack's domain id, its first row, falls inside one CTA's range while
    its nodes straddle the next boundary."""
    return [make_node(f"n{i}").capacity({"cpu": cpu, "memory": "32Gi",
                                         "pods": 40})
            .zone(f"z{i % 4}").label(HOSTNAME, f"n{i}")
            .label("rack", f"r{i // per_rack}").obj() for i in range(n)]


def _rack_pods(n):
    return [make_pod(f"k{i}").req({"cpu": "1", "memory": "1Gi"})
            .label("app", "mix").spread_constraint(
                1, "rack", "ScheduleAnyway", {"app": "mix"}).obj()
            for i in range(n)]


def _boosted(rows, by):
    def boost(na):
        cap = na.cap.clone()
        cap[rows] = cap[rows] * by
        return na._replace(cap=cap)
    return boost


PLAN_EDGE_CASES = {
    # name: (nodes, pods, lean, node-array edit, every step padded)
    # equal maxima on both sides of every CTA boundary: the lowest wins
    "ties_across_boundaries": (
        lambda: _zone_nodes(2048, 16), lambda: _mixed_pods(
            64, 2, kinds=("plain",)), True,
        _boosted([b + o for b in range(128, 2048, 128) for o in (-1, 0)],
                 4), False),
    # the chosen row the first, then the last row of a CTA's range
    "best_first_and_last_rows": (
        lambda: _zone_nodes(2048, 16), lambda: _mixed_pods(
            48, 3, kinds=("plain",)), True,
        lambda na: _boosted([1024], 8)(_boosted([255, 1151], 6)(na)),
        False),
    # full width with S = 32: the slots' surfaces over 8,192 rows
    "full_width_32sigs": (
        lambda: _zone_nodes(5000, 16, cpu=32), lambda: _mixed_pods(
            96, 32), False, None, False),
    "one_pod": (lambda: _zone_nodes(64, 4), lambda: _mixed_pods(1, 1),
                False, None, False),
    "every_step_padded": (lambda: _zone_nodes(64, 4), lambda: _mixed_pods(
        20, 4), False, None, True),
    # ScheduleAnyway domains (racks of 7) whose ids and rows cross CTAs
    "anyway_domains_cross_ctas": (lambda: _rack_nodes(2048, 7),
                                  lambda: _rack_pods(40), False, None,
                                  False),
}


@pytest.mark.parametrize("case", sorted(PLAN_EDGE_CASES))
def test_run_plan_cluster_edges_equal_plain(cuda, case):
    from kubernetes_tpu_torch.ops.groups import GroupFamilies
    from kubernetes_tpu_torch.parallel import sharding as S
    mk_nodes, mk_pods, lean, edit, padded = PLAN_EDGE_CASES[case]
    pods = mk_pods()
    na, batch, table, gd, gc, fam, builder, state = _group_setup(
        mk_nodes(), [], pods, cuda)
    if edit is not None:
        na = edit(na)
    m = len(pods)
    wt, xs = _plan_span(batch, m, cuda)
    if padded:
        xs = xs._replace(valid=torch.zeros_like(xs.valid))
    has_ports = bool((batch.sig[:m] == 0).any())
    statics = P.wave_statics(na, table, wt)
    if lean:
        gd = gc = None
        fam = GroupFamilies(False, False, False, False, False)
    carry = P.initial_carry(na, gc)
    cfg = P.ScoreConfig()
    args = (cfg, na, carry, xs, table, wt, gd, statics, fam, True,
            not lean, has_ports)
    want = P._run_plan_plain(*args)
    _equal(P.run_plan(*args), want)
    placed = int((want[1][:xs.valid.shape[0]] >= 0).sum())
    assert placed == (0 if padded else m)
    # the same span on two shards of the card: one cooperative launch
    mesh = S.make_mesh(devices=["cuda:0"] * 2)
    gna = S.shard_node_arrays(mesh, na)
    gcarry = S.initial_carry_sharded(
        gna, None if lean else S.shard_group_carry(mesh, gc))
    got = S.run_plan_sharded(cfg, mesh, gna, gcarry, xs, table, wt,
                             None if lean else S.shard_groups(mesh, gd),
                             S.wave_statics_sharded(mesh, gna, table, wt),
                             fam, True, has_groups=not lean,
                             has_ports=has_ports)
    torch.cuda.synchronize()
    _equal((got[1], S.unshard(got[0])), (want[1], want[0]))


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


def _dry_wave(args):
    na, row, cand, vreq, vvalid, _ou, _on, sp = args
    return P.DryRunWave(na, row, cand, vreq, vvalid, sp)


@pytest.mark.parametrize("spread", [False, True])
@pytest.mark.parametrize("V", [1, 8])
def test_dry_run_subset_kernel_equals_plain(cuda, V, spread):
    """The subset entry reads the wave's tensors through `sub` in place
    (the Evaluator's per-preemptor launch): against its plain version
    (the gather, then the plain dry run) at s = 1, 3 (padded with its first
    position) and 256 (with repeats), the rows in the order of `sub`; and
    without `sub`, against the full dry run."""
    import numpy as np
    from kubernetes_tpu_torch.ops import kernels as K
    rng = random.Random(40 + V)
    args = _dry_inputs(rng, 512, V, 300, cuda, spread)
    wave = _dry_wave(args)
    block = P.dry_run_args(wave)
    R = args[0].cap.shape[1]
    rs = np.random.RandomState(V)
    for s in (1, 3, 256):
        sub = rs.choice(512, s, replace=False).astype(np.int32)
        s_pad = 1 << max(s - 1, 0).bit_length()
        sub = np.concatenate([sub, np.full((s_pad - s,), sub[0], np.int32)])
        ou = np.zeros((s_pad, R), np.int64)
        ou[:, 0] = rs.choice([0, 0, 1000, 4000], s_pad)
        on = rs.randint(0, 3, (s_pad,)).astype(np.int32)
        ins = P.dry_run_subset_inputs(sub, ou, on, cuda)
        K.reset_launches()
        got = P.dry_run_select_victims_subset(wave, *ins, block)
        assert K.LAUNCHES["dry_run"] == 1
        want = P._dry_run_subset_plain(*wave[:5], *ins, wave.spread)
        torch.cuda.synchronize()
        _equal(got, want)
        assert got.shape == (s_pad, V + 1)
    full = P.dry_run_select_victims_subset(wave, None, args[5], args[6],
                                           block)
    _equal(full, P._dry_run_select_victims_plain(*args))


def test_dry_run_subset_after_a_node_swap(cuda):
    """Two preemptors of one wave with a scatter between them: the node
    rows the Evaluator reads become fresh tensors, its plan's argument
    block is packed again over them, the second launch reads the new
    rows (equal to the plain version on them), and the old block handed
    the new wave raises."""
    import numpy as np
    from kubernetes_tpu_torch.framework.preemption import (Evaluator,
                                                           _DryRunPlan)
    rng = random.Random(77)
    args = _dry_inputs(rng, 256, 4, 120, cuda, False)
    na, row, cand, vreq, vvalid = args[:5]
    plan = _DryRunPlan(key=(), cands=[], cand_idx=cand, cand_pos={},
                       victim_req=vreq, victim_valid=vvalid, spread=None,
                       constraints=[], prow=row)
    rows = [na]
    ctx = SimpleNamespace(state=SimpleNamespace(
        device_arrays=lambda: rows[0]))
    ev = Evaluator.__new__(Evaluator)
    R = na.cap.shape[1]
    sub = np.arange(0, 256, 2, dtype=np.int32)
    ou = np.zeros((128, R), np.int64)
    on = np.zeros((128,), np.int32)
    outs = []
    for swap in (False, True):
        if swap:
            # a scatter: fresh rows, every node's cpu far past what
            # removing its victims could free
            used = na.used.clone()
            used[:, 0] += 1 << 40
            rows[0] = type(na)(*(used if f == "used" else t.clone()
                                 for f, t in zip(type(na)._fields, na)))
        wave, block = ev._dry_run_wave(plan, ctx)
        assert wave.na is rows[0]
        ins = P.dry_run_subset_inputs(sub, ou, on, cuda)
        got = P.dry_run_select_victims_subset(wave, *ins, block)
        want = P._dry_run_subset_plain(*wave[:5], *ins, None)
        torch.cuda.synchronize()
        _equal(got, want)
        outs.append((wave, block, got.cpu()))
    (w1, b1, g1), (w2, b2, g2) = outs
    assert b2 is not b1 and g1[:, 0].any() and not g2.any()
    with pytest.raises(ValueError, match="stale"):
        P.dry_run_select_victims_subset(
            w2, *P.dry_run_subset_inputs(sub, ou, on, cuda), b1)


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
# gangs: run_gang's scan tier (run_gang.cu) and closed-form tier
# (run_uniform.cu with the gang verdict)


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
    from kubernetes_tpu_torch.ops import kernels as K
    K.reset_launches()
    got = G.run_gang(P.ScoreConfig(), na, carry, xs, table, wt=wt,
                     needed=needed, dom=dom, statics=statics,
                     w_contig=w_contig)
    # one cluster launch a gang
    assert K.RAW_LAUNCHES["run_gang"] == K.LAUNCHES["run_gang"] == 1
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


# run_uniform.cu's branches: name → (nodes, identical nodes, pod cpu, K,
# L, J, n_actual), K cut to the padded rows N; which branch each takes
# (every row a candidate or the top K selected by the grid, the counted
# entries likewise, one shared-memory tile or the tiled ordering, its
# rank search in shared memory or in place) is held by
# tests/test_torch_kernels_host.py
UNI_CASES = {
    "all_rows_one_tile": (150, False, "1", 256, 256, 8, 200),
    "all_rows_grid_tiled": (5000, False, "900m", 8192, 8192, 8, 8192),
    "all_rows_few_pods": (4000, False, "1", 4096, 4096, 8, 100),
    "small_rows": (300, False, "1", 64, 128, 4, 128),
    "grid_rows": (5000, False, "900m", 256, 256, 8, 256),
    "grid_rows_grid_keys": (5000, False, "250m", 1024, 8192, 16, 8192),
    "rank_in_place": (5000, False, "250m", 4096, 16384, 8, 16384),
    "every_entry": (20, False, "1", 32, 256, 8, 256),
    "no_pods": (300, False, "1", 64, 128, 4, 0),
    "fewer_feasible": (100, False, "12", 64, 64, 8, 64),
    "ties": (300, True, "1", 64, 128, 4, 128),
    "j2_depth": (200, False, "250m", 128, 256, 2, 256),
}
UNI_TIERS = ["plain", "most_allocated", "overlay", "gang_accept",
             "gang_reject", "gang_inexact"]


@pytest.mark.parametrize("tier", UNI_TIERS)
@pytest.mark.parametrize("case", sorted(UNI_CASES))
def test_run_uniform_branch_shapes(cuda, case, tier):
    """The closed form's one launch equals its plain version bit for bit
    in every branch: run_uniform lean (both strategies) and with the
    overlay, and the gang tier accepted, rejected and inexact, each also
    from its output carry (the SigCache fast path); the input carry is
    never written, and a rejected or inexact gang's output is its input."""
    from kubernetes_tpu_torch.ops import gang as G
    from kubernetes_tpu_torch.ops import kernels as Kr
    n_nodes, identical, cpu, K, L, J, n_actual = UNI_CASES[case]
    rng = random.Random(11)
    proto = make_pod("u").req({"cpu": cpu, "memory": "1Gi"}).obj()
    na, batch, table = _ush_setup(rng, n_nodes, proto, cuda, identical)
    N, R = na.cap.shape
    K = min(K, N)
    x = P.PodXs(True, int(batch.sig[0]), int(batch.tidx[0]))
    cfg = P.ScoreConfig(strategy="MostAllocated"
                        if tier in ("most_allocated", "gang_inexact")
                        else "LeastAllocated")
    ovl = None
    if tier == "overlay":
        ovl, _nom = _overlay(rng, batch, n_nodes, N, R, cuda,
                             nominate=False)
    carry = P.initial_carry(na)
    before = [t.clone() for t in list(carry[:4]) + list(carry.cache)]
    if tier.startswith("gang"):
        needed = 10 ** 6 if tier == "gang_reject" else 1

        def kern(c):
            return G.run_gang(cfg, na, c, x, table, needed=needed,
                              uniform=True, n_actual=n_actual, L=L, K=K,
                              J=J)

        def plain(c):
            return G._run_gang_uniform_plain(cfg, na, c, x, table, n_actual,
                                             needed, L, K, J)
    else:
        def kern(c):
            return P.run_uniform(cfg, na, c, x, table, n_actual, L, K, J,
                                 overlay=ovl)

        def plain(c):
            return P._run_uniform_plain(cfg, na, c, x, table, n_actual, L,
                                        K, J, overlay=ovl)
    Kr.reset_launches()
    kc, kp = kern(carry)
    assert sum(Kr.LAUNCHES.values()) == 1
    pc, pp = plain(carry)
    _equal((kp, kc), (pp, pc))
    _equal(before, list(carry[:4]) + list(carry.cache))
    if tier.startswith("gang"):
        accept, _placed, exact, depth = kp[L:].tolist()
        assert accept == 0 or tier != "gang_reject"
        if not (accept and exact and depth):
            _equal(before, list(kc[:4]) + list(kc.cache))
    _equal(kern(kc), plain(pc))


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


def _probe_inputs(rng, N, R, ndom, device, edit=None):
    """Seeded probe columns; `edit`: "few" (column r has at most 3 - r
    participants, so the four ranks coincide), "equal" (every util
    equal), "zero_column" (column 1 has no participant, m = 0)."""
    import numpy as np
    cap = (rng.randint(0, 6, (N, R)) * rng.choice([1, 1000, 2 ** 33 + 5])
           ).astype(np.int64)
    used = (cap * rng.rand(N, R)).astype(np.int64)
    used[::5] = cap[::5]                      # some saturated nodes
    valid = rng.rand(N) < 0.9
    npods = rng.randint(0, 110, N).astype(np.int32)
    dom = rng.randint(-1, ndom + 1, N).astype(np.int32)
    if edit == "few":
        valid[:] = True
        for r in range(R):
            cap[3 - r:, r] = 0
            cap[:3 - r, r] = 1000 + r
    elif edit == "equal":
        valid[:] = True
        cap[:] = 1000
        used[:] = 250
    elif edit == "zero_column":
        cap[:, 1] = 0
    return [torch.from_numpy(x).to(device)
            for x in (cap, valid, used, npods, dom)]


@pytest.mark.parametrize("shape", [(1, 1, 1), (37, 3, 5), (8192, 4, 16),
                                   (8192, 4, 5000), (65536, 2, 65536),
                                   (32769, 3, 7), (3, 4, 2, "few"),
                                   (64, 3, 4, "equal"),
                                   (100, 4, 8, "zero_column")])
def test_cluster_probe_kernel_equals_plain(cuda, shape):
    """Bit for bit against the plain version: the shared-memory keys and
    the walk past KT_PROBE_SMEM_KEYS (N = 32,769), ranks shared by two or
    more targets (m <= 3), equal utils, a column with m = 0; one launch a
    call."""
    import numpy as np
    from kubernetes_tpu_torch.ops import kernels as K
    N, R, ndom = shape[:3]
    cap, valid, used, npods, dom = _probe_inputs(
        np.random.RandomState(N + R), N, R, ndom, cuda, *shape[3:])
    K.reset_launches()
    got = P.cluster_probe(SimpleNamespace(cap=cap, valid=valid),
                          SimpleNamespace(used=used, npods=npods), dom,
                          ndom)
    want = P._probe_plain(cap.cpu(), valid.cpu(), used.cpu(), npods.cpu(),
                          dom.cpu(), ndom)
    assert K.LAUNCHES["cluster_probe"] == 1
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.cpu().view(torch.int32) if a.dtype ==
                           torch.float32 else a.cpu(),
                           b.view(torch.int32) if b.dtype == torch.float32
                           else b)


def test_cluster_probe_launches_once_a_call(cuda, monkeypatch):
    """One wrapper call is one call of the kernel's C entry, whose one
    launch is the cluster (tests/test_torch_kernels_host.py holds the
    source to one launch statement): on one device and on a mesh's shards
    of one card."""
    import numpy as np
    from kubernetes_tpu_torch.ops import kernels as K
    from kubernetes_tpu_torch.parallel import sharding as S
    lib = K.build()["cluster_probe"]
    real, calls = lib.ktpu_cluster_probe, []
    monkeypatch.setattr(lib, "ktpu_cluster_probe",
                        lambda *a: calls.append(1) or real(*a))
    cap, valid, used, npods, dom = _probe_inputs(
        np.random.RandomState(3), 8192, 4, 16, cuda)
    P.cluster_probe(SimpleNamespace(cap=cap, valid=valid),
                    SimpleNamespace(used=used, npods=npods), dom, 16)
    mesh = S.make_mesh(devices=[cuda] * 2)
    n = 4096

    def shards(fields):
        return S.Shards(SimpleNamespace(**{
            f: t[d * n:(d + 1) * n].clone() for f, t in fields.items()})
            for d in range(2))

    S.cluster_probe_sharded(
        mesh, shards({"cap": cap, "valid": valid, "used": used}),
        shards({"used": used, "npods": npods}), dom, 16)
    torch.cuda.synchronize()
    assert calls == [1, 1]


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
MESHES_PLAN_COUNT = [(2, "one"), (4, "one"), (2, "cards")]


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


PROBE_SHARD_CASES = {
    # name: (D, rows a shard, ndom, shard with no valid node or None)
    "one_shard": (1, 1500, 16, None),
    "two_shards": (2, 1500, 16, None),
    "four_shards": (4, 1500, 16, None),
    "two_shards_one_domain": (2, 1500, 1, None),
    "four_shards_one_domain": (4, 1500, 1, None),
    "two_shards_one_empty": (2, 1500, 16, 1),
    "four_shards_one_empty": (4, 1500, 16, 0),
    "one_shard_empty": (1, 1500, 16, 0),
    "four_shards_full_width": (4, 2048, 5000, None),
}


@pytest.mark.parametrize("case", sorted(PROBE_SHARD_CASES))
def test_cluster_probe_sharded_in_place(cuda, case):
    """On one card the mesh's probe reads its D shards where they lie (no
    gather; n_local not a multiple of any block, one domain, a shard with
    no valid node): bit-equal to row 11 on the whole axis and to the plain
    version, one launch set a call."""
    import numpy as np
    from kubernetes_tpu_torch.ops import kernels as K
    from kubernetes_tpu_torch.parallel import sharding as S
    D, n, ndom, empty = PROBE_SHARD_CASES[case]
    cap, valid, used, npods, dom = _probe_inputs(
        np.random.RandomState(D * 7 + ndom), D * n, 4, ndom, cuda)
    if empty is not None:
        valid[empty * n:(empty + 1) * n] = False
    mesh = S.make_mesh(devices=[cuda] * D)
    assert K.probe_in_place(mesh)

    def shards(fields):
        return S.Shards(SimpleNamespace(**{
            f: t[d * n:(d + 1) * n].clone() for f, t in fields.items()})
            for d in range(D))

    gathered = []
    real = S.gather_rows
    S.gather_rows = lambda *a: gathered.append(1) or real(*a)
    try:
        K.reset_launches()
        got = S.cluster_probe_sharded(
            mesh, shards({"cap": cap, "valid": valid, "used": used}),
            shards({"used": used, "npods": npods}), dom, ndom)
    finally:
        S.gather_rows = real
    assert gathered == [] and K.LAUNCHES["cluster_probe_sharded"] == 1
    one = P.cluster_probe(SimpleNamespace(cap=cap, valid=valid),
                          SimpleNamespace(used=used, npods=npods), dom, ndom)
    want = P._probe_plain(cap.cpu(), valid.cpu(), used.cpu(), npods.cpu(),
                          dom.cpu(), ndom)
    for a, b, c in zip(got, one, want):
        assert a.dtype == b.dtype == c.dtype and a.shape == c.shape
        assert torch.equal(_bits(a.cpu()), _bits(b.cpu()))
        assert torch.equal(_bits(a.cpu()), _bits(c))


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


# ---------------------------------------------------------------------------
# the mesh's group and gang programs: run_batch_sharded's group mode,
# run_plan_sharded, run_gang_sharded (both tiers) and the sharded statics,
# on D shards of cuda:0 or shard d on cuda:d, against the plain versions
# over D CPU shards and against the single-device kernels


GROUP_SCAN_KINDS = [("spread", "anti", "score"),
                    ("anyway", "affinity", "anti")]


@pytest.mark.parametrize("D,place", MESHES)
@pytest.mark.parametrize("kinds", range(len(GROUP_SCAN_KINDS)))
def test_run_batch_sharded_groups_kernel_equals_plain(cuda, kinds, D,
                                                      place):
    S, gm, cm = _mesh_pair(D, place)
    pods = _mixed_pods(40, 3, kinds=GROUP_SCAN_KINDS[kinds])
    na, batch, table, gd, gc, fam, _b, _s = _group_setup(
        _zone_nodes(40, 5), [], pods, cuda)
    xs = convert.pod_xs_from_numpy(P.PodXs(batch.valid, batch.sig,
                                           batch.tidx), cuda)
    gna, cna = S.shard_node_arrays(gm, na), S.shard_node_arrays(cm, na)
    ggd, cgd = S.shard_groups(gm, gd), S.shard_groups(cm, gd)
    gc0 = S.initial_carry_sharded(gna, S.shard_group_carry(gm, gc))
    cc0 = S.initial_carry_sharded(cna, S.shard_group_carry(cm, gc))
    before = S.unshard(gc0)
    got = S.run_batch_sharded(P.ScoreConfig(), gm, gna, gc0, xs, table,
                              groups=ggd, fam=fam)
    want = S.run_batch_sharded(
        P.ScoreConfig(), cm, cna, cc0,
        convert.pod_xs_from_numpy(P.PodXs(batch.valid, batch.sig,
                                          batch.tidx), "cpu"),
        P.table_from_batch(batch, "cpu"), groups=cgd, fam=fam)
    torch.cuda.synchronize()
    _equal((got[1], S.unshard(got[0])), (want[1], S.unshard(want[0])))
    _equal(before, S.unshard(gc0))        # the input carry is untouched
    # the single-device kernel at the same state
    sc, sa = P.run_batch(P.ScoreConfig(), na, P.initial_carry(na, gc), xs,
                         table, groups=gd, fam=fam)
    _equal((got[1], S.unshard(got[0])), (sa, sc))


SHARDED_PLAN_CASES = ("lean_8sigs", "lean_ports", "lean_prefer_taints",
                      "spread_8sigs", "schedule_anyway", "mixed_terms_ports",
                      "capacity_tail")


@pytest.mark.parametrize("D,place", MESHES)
@pytest.mark.parametrize("case", SHARDED_PLAN_CASES)
def test_run_plan_sharded_kernel_equals_plain(cuda, case, D, place):
    S, gm, cm = _mesh_pair(D, place)
    mk_nodes, mk_pods, lean = PLAN_CASES[case]
    pods = mk_pods()
    na, batch, table, gd, gc, fam, builder, state = _group_setup(
        mk_nodes(), [], pods, cuda)
    m = len(pods)
    wt, xs = _plan_span(batch, m, cuda)
    has_ports = bool((batch.sig[:m] == 0).any())
    norm_live = not all(P.static_norm_ok(state.ensure_arrays(),
                                         builder.table.pref_weight[u])
                        for u in wt)
    if lean:
        from kubernetes_tpu_torch.ops.groups import GroupFamilies
        gd = gc = None
        fam = GroupFamilies(False, False, False, False, False)
    gna, cna = S.shard_node_arrays(gm, na), S.shard_node_arrays(cm, na)
    ctab = P.table_from_batch(batch, "cpu")
    gst = S.wave_statics_sharded(gm, gna, table, wt)
    cst = S.wave_statics_sharded(cm, cna, ctab, wt)
    _equal(gst, cst)
    gargs = [None, S.initial_carry_sharded(gna)]
    cargs = [None, S.initial_carry_sharded(cna)]
    if not lean:
        gargs = [S.shard_groups(gm, gd), S.initial_carry_sharded(
            gna, S.shard_group_carry(gm, gc))]
        cargs = [S.shard_groups(cm, gd), S.initial_carry_sharded(
            cna, S.shard_group_carry(cm, gc))]
    cfg = P.ScoreConfig()
    got = S.run_plan_sharded(cfg, gm, gna, gargs[1], xs, table, wt,
                             gargs[0], gst, fam, norm_live,
                             has_groups=not lean, has_ports=has_ports)
    want = S.run_plan_sharded(
        cfg, cm, cna, cargs[1], P.WaveXs(xs.valid.cpu(), xs.widx.cpu()),
        ctab, wt, cargs[0], cst, fam, norm_live, has_groups=not lean,
        has_ports=has_ports)
    torch.cuda.synchronize()
    _equal((got[1], S.unshard(got[0])), (want[1], S.unshard(want[0])))
    # the single-device kernel at the same state
    sgot = P.run_plan(cfg, na, P.initial_carry(na, gc), xs, table, wt, gd,
                      P.wave_statics(na, table, wt), fam, norm_live,
                      has_groups=not lean, has_ports=has_ports)
    _equal((got[1], S.unshard(got[0])), (sgot[1], sgot[0]))


@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("case", SHARDED_PLAN_CASES)
def test_plan_sharded_chain_on_one_card(cuda, case, D):
    """The host-driven chain of shards on several cards (placement
    "cards"), called on D shards of one card: the same bits as the plain
    version over CPU shards and as the one-launch grid."""
    from kubernetes_tpu_torch.ops import kernels as K
    S, gm, cm = _mesh_pair(D, "one")
    mk_nodes, mk_pods, lean = PLAN_CASES[case]
    pods = mk_pods()
    na, batch, table, gd, gc, fam, builder, state = _group_setup(
        mk_nodes(), [], pods, cuda)
    m = len(pods)
    wt, xs = _plan_span(batch, m, cuda)
    has_ports = bool((batch.sig[:m] == 0).any())
    if lean:
        from kubernetes_tpu_torch.ops.groups import GroupFamilies
        gd = gc = None
        fam = GroupFamilies(False, False, False, False, False)
    gna, cna = S.shard_node_arrays(gm, na), S.shard_node_arrays(cm, na)
    ctab = P.table_from_batch(batch, "cpu")
    ggd = cgd = None
    gcarry, ccarry = S.initial_carry_sharded(gna), S.initial_carry_sharded(
        cna)
    if not lean:
        ggd, cgd = S.shard_groups(gm, gd), S.shard_groups(cm, gd)
        gcarry = S.initial_carry_sharded(gna, S.shard_group_carry(gm, gc))
        ccarry = S.initial_carry_sharded(cna, S.shard_group_carry(cm, gc))
    gst = S.wave_statics_sharded(gm, gna, table, wt)
    cfg = P.ScoreConfig()
    K.reset_launches()
    got = K._plan_sharded_chain(cfg, gm, gna, gcarry, xs, table, wt, ggd,
                                gst, fam, True, not lean, has_ports)
    torch.cuda.synchronize()
    assert K.RAW_LAUNCHES["run_plan_sharded"] >= D * (
        1 + 3 * (len(wt) + xs.valid.shape[0]))
    want = S.run_plan_sharded(
        cfg, cm, cna, ccarry, P.WaveXs(xs.valid.cpu(), xs.widx.cpu()), ctab,
        wt, cgd, S.wave_statics_sharded(cm, cna, ctab, wt), fam, True,
        has_groups=not lean, has_ports=has_ports)
    _equal((got[1], S.unshard(got[0])), (want[1], S.unshard(want[0])))
    one = S.run_plan_sharded(cfg, gm, gna, gcarry, xs, table, wt, ggd, gst,
                             fam, True, has_groups=not lean,
                             has_ports=has_ports)
    torch.cuda.synchronize()
    _equal((got[1], S.unshard(got[0])), (one[1], S.unshard(one[0])))


@pytest.mark.parametrize("D,place", MESHES_PLAN_COUNT)
def test_run_plan_launches_once_a_card_a_span(cuda, D, place):
    """run_plan is one launch a span; run_plan_sharded one launch a span
    when the shards share a card ("one"), its chain of launches a shard
    when they do not ("cards")."""
    from kubernetes_tpu_torch.ops import kernels as K
    S, gm, _cm = _mesh_pair(D, place)
    pods = _mixed_pods(40, 4)
    na, batch, table, gd, gc, fam, _b, _s = _group_setup(
        _zone_nodes(40, 5), [], pods, cuda)
    wt, xs = _plan_span(batch, len(pods), cuda)
    cfg = P.ScoreConfig()
    K.reset_launches()
    P.run_plan(cfg, na, P.initial_carry(na, gc), xs, table, wt, gd,
               P.wave_statics(na, table, wt), fam, False)
    assert K.RAW_LAUNCHES["run_plan"] == 1 == K.LAUNCHES["run_plan"]
    gna = S.shard_node_arrays(gm, na)
    gst = S.wave_statics_sharded(gm, gna, table, wt)
    gcarry = S.initial_carry_sharded(gna, S.shard_group_carry(gm, gc))
    ggd = S.shard_groups(gm, gd)
    K.reset_launches()
    S.run_plan_sharded(cfg, gm, gna, gcarry, xs, table, wt, ggd, gst, fam,
                       False)
    torch.cuda.synchronize()
    assert K.LAUNCHES["run_plan_sharded"] == 1
    assert K.plan_sharded_placement(gm) == place
    if place == "one":
        assert K.RAW_LAUNCHES["run_plan_sharded"] == 1
    else:
        # init, then per evaluation at least eval, select and apply
        assert K.RAW_LAUNCHES["run_plan_sharded"] >= D * (
            1 + 3 * (len(wt) + xs.valid.shape[0]))


@pytest.mark.parametrize("D,place", MESHES)
@pytest.mark.parametrize("verdict", ["accept", "reject"])
@pytest.mark.parametrize("w_contig", [0, 2])
def test_run_gang_sharded_scan_kernel_equals_plain(cuda, w_contig, verdict,
                                                   D, place):
    from kubernetes_tpu_torch.ops import gang as G
    S, gm, cm = _mesh_pair(D, place)
    rng = random.Random(7)
    protos = [make_pod(f"g{k}").req({"cpu": c, "memory": "1Gi"}).obj()
              for k, c in enumerate(["1", "2", "3"])]
    m = 40
    pods = [protos[rng.randrange(3)] for _ in range(m)]
    na, batch, table = _staged(rng, 60, pods, cuda)
    xs, wt = _gang_layout(batch, m, 64, cuda)
    N = na.cap.shape[0]
    n = N // D
    dom = torch.tensor([i % 3 for i in range(N)], dtype=torch.int32)
    needed = m if verdict == "accept" else 10 ** 6
    gna, cna = S.shard_node_arrays(gm, na), S.shard_node_arrays(cm, na)
    ctab = P.table_from_batch(batch, "cpu")
    gc0 = S.with_cache_sig_sharded(S.initial_carry_sharded(gna), 99)
    cc0 = S.with_cache_sig_sharded(S.initial_carry_sharded(cna), 99)
    before = S.unshard(gc0)
    got = S.run_gang_sharded(
        P.ScoreConfig(), gm, gna, gc0, xs, table, wt=wt, needed=needed,
        dom=[dom[d * n:(d + 1) * n].to(gm.devices[d]) for d in range(D)],
        statics=S.wave_statics_sharded(gm, gna, table, wt),
        w_contig=w_contig)
    want = S.run_gang_sharded(
        P.ScoreConfig(), cm, cna, cc0, _cpu(xs), ctab, wt=wt, needed=needed,
        dom=[dom[d * n:(d + 1) * n] for d in range(D)],
        statics=S.wave_statics_sharded(cm, cna, ctab, wt),
        w_contig=w_contig)
    torch.cuda.synchronize()
    _equal((got[1], S.unshard(got[0])), (want[1], S.unshard(want[0])))
    _equal(before, S.unshard(gc0))
    assert bool(got[1][64].cpu()) == (verdict == "accept")
    if verdict == "reject":
        _equal(S.unshard(got[0]), before)
    # the single-device kernel at the same state
    sc, sp = G.run_gang(P.ScoreConfig(), na,
                        P.with_cache_sig(P.initial_carry(na), 99), xs,
                        table, wt=wt, needed=needed, dom=dom.to(cuda),
                        statics=P.wave_statics(na, table, wt),
                        w_contig=w_contig)
    _equal((got[1], S.unshard(got[0])), (sp, sc))


@pytest.mark.parametrize("D,place", MESHES)
@pytest.mark.parametrize("verdict", ["accept", "reject", "inexact"])
def test_run_gang_uniform_sharded_kernel_equals_plain(cuda, verdict, D,
                                                      place):
    from kubernetes_tpu_torch.ops import gang as G
    S, gm, cm = _mesh_pair(D, place)
    rng = random.Random(3)
    proto = make_pod("plain").req({"cpu": "1", "memory": "1Gi"}).obj()
    na, batch, table = _staged(rng, 150, [proto], cuda)
    L, K = 64, 64
    J = 2 if verdict == "inexact" else 8
    needed = 64 if verdict != "reject" else 10 ** 6
    x = P.PodXs(True, int(batch.sig[0]), int(batch.tidx[0]))
    gna, cna = S.shard_node_arrays(gm, na), S.shard_node_arrays(cm, na)
    gc0, cc0 = S.initial_carry_sharded(gna), S.initial_carry_sharded(cna)
    before = S.unshard(gc0)
    got = S.run_gang_sharded(P.ScoreConfig(), gm, gna, gc0, x, table,
                             needed=needed, uniform=True, n_actual=64, L=L,
                             K=K, J=J)
    want = S.run_gang_sharded(P.ScoreConfig(), cm, cna, cc0, x,
                              P.table_from_batch(batch, "cpu"),
                              needed=needed, uniform=True, n_actual=64, L=L,
                              K=K, J=J)
    torch.cuda.synchronize()
    _equal((got[1], S.unshard(got[0])), (want[1], S.unshard(want[0])))
    _equal(before, S.unshard(gc0))
    # where both report exact, the single-device kernel agrees
    sc, sp = G.run_gang(P.ScoreConfig(), na, P.initial_carry(na), x, table,
                        needed=needed, uniform=True, n_actual=64, L=L, K=K,
                        J=J)
    if bool(sp[L + 2].cpu()) and bool(got[1][L + 2].cpu()):
        _equal((got[1], S.unshard(got[0])), (sp, sc))


@pytest.mark.parametrize("D", [2, 4])
def test_mesh_scheduler_group_and_gang_drains(cuda, D):
    """Scheduler(mesh=make_mesh(D)) binds two gangs (the closed form, and
    the scan tier with contiguity), a zone-spread drain (plan spans) and a
    ScheduleAnyway + anti-affinity scan as the single-device Scheduler,
    through the sharded kernels only."""
    from kubernetes_tpu_torch.api.types import ObjectMeta, PodGroup, Workload
    from kubernetes_tpu_torch.backend.apiserver import APIServer
    from kubernetes_tpu_torch.ops import kernels as K
    from kubernetes_tpu_torch.parallel import sharding as S
    from kubernetes_tpu_torch.scheduler import Scheduler

    def drain(mesh):
        api = APIServer()
        sched = Scheduler(api, batch_size=64, clock=lambda: 1000.0,
                          mesh=mesh)
        for nd in _zone_nodes(48, 6, cpu=32):
            api.create_node(nd)
        sched.prime()
        # the gangs first: once group rows exist, a gang rides the generic
        # path (the gang program has no group terms)
        for g, contig in (("a", 0), ("b", 2)):
            sched.gang_contiguity_weight = contig
            api.create_workload(Workload(metadata=ObjectMeta(name=g),
                                         pod_groups=[PodGroup(
                                             name="w", min_count=16)]))
            api.create_pods([make_pod(f"{g}{i}").req({"cpu": "1"})
                             .workload(g).obj() for i in range(16)])
            sched.schedule_pending()
        api.create_pods(_mixed_pods(96, 4))
        sched.schedule_pending()
        api.create_pods(_mixed_pods(12, 2, kinds=("anyway", "anti"),
                                    prefix="x"))
        sched.schedule_pending()
        assert sched.reconcile() == []
        assert sched.gang_dispatch["placed"] == 2
        return {u: p.spec.node_name for u, p in api.pods.items()}

    want = drain(None)
    for k in K.LAUNCHES:
        K.LAUNCHES[k] = 0
    got = drain(S.make_mesh(D))
    assert got == want and all(got.values())
    for k in ("run_plan_sharded", "run_batch_sharded_groups",
              "run_gang_sharded", "run_gang_uniform_sharded",
              "wave_statics_sharded", "cluster_probe_sharded"):
        assert K.LAUNCHES[k] > 0, k
    for k in ("run_batch", "run_batch_groups", "run_uniform", "run_plan",
              "run_wave", "run_gang", "run_gang_uniform", "wave_statics",
              "scatter_rows", "cluster_probe"):
        assert K.LAUNCHES[k] == 0, k


# ---------------------------------------------------------------------------
# the grid kernels: explain_row over the node axis in one cooperative
# launch, and the mesh's closed form with set selection (both branches of
# its selection launch, the top-L in shared or global memory)


def _take_rows(tree, idx):
    """Every node-first tensor of a NamedTuple tree at rows `idx` (a
    0-dim tensor, the SigCache's sig, stays)."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return tree if tree.dim() == 0 else tree[idx.to(tree.device)]
    return type(tree)(*(_take_rows(x, idx) for x in tree))


EXPLAIN_GRID_CASES = {
    # name: (nodes, rows: None = the staged bucket, else an int taken
    #        cyclically from it, pod)
    "rows_777": (300, 777, "plain"),
    "ties_65536": (40, 65536, "plain"),
    "none_feasible": (300, None, "huge"),
    "pinned_one": (300, 1000, "pinned"),
}


@pytest.mark.parametrize("case", sorted(EXPLAIN_GRID_CASES))
@pytest.mark.parametrize("k", [1, 16])
def test_explain_row_grid_shapes(cuda, case, k):
    n_nodes, rows, kind = EXPLAIN_GRID_CASES[case]
    rng = random.Random(11)
    pod = {"plain": make_pod("p").req({"cpu": "250m", "memory": "512Mi"}),
           "huge": make_pod("p").req({"cpu": "100"}),
           "pinned": make_pod("p").req({"cpu": "250m"}).node_selector(
               {HOSTNAME: "n3"})}[kind].obj()
    na, batch, table = _staged(rng, n_nodes, [pod], cuda)
    carry = P.initial_carry(na)
    if rows is not None:
        idx = torch.arange(rows) % na.cap.shape[0]
        na, carry = _take_rows(na, idx), _take_rows(carry, idx)
    u = int(batch.tidx[0])
    cfg = P.ScoreConfig()
    got = P.explain_row(cfg, na, carry, table, u, k=k)
    want = P._explain_plain(cfg, _cpu(na), _cpu(carry), _cpu(table), u, k)
    _equal(got, want)
    if kind == "huge":
        assert int(got[3]) == 0


@pytest.mark.parametrize("k", [5, 16])
def test_explain_row_grid_every_family(cuda, k):
    nodes = _zone_nodes(600, 6)
    existing = [make_pod(f"e{i}").req({"cpu": "1"}).label("app", "mix")
                .node(f"n{7 * i % 600}").obj() for i in range(90)]
    pods = _mixed_pods(10, 5, kinds=("spread", "anyway", "affinity", "anti",
                                     "score"))
    na, batch, table, gd, gc, fam, _b, _s = _group_setup(
        nodes, existing, pods, cuda)
    assert all(fam)
    carry = P.initial_carry(na, gc)
    cfg = P.ScoreConfig()
    for u in sorted(set(int(t) for t in batch.tidx[:len(pods)])):
        got = P.explain_row(cfg, na, carry, table, u, k=k, gd=gd, fam=fam)
        want = P._explain_plain(cfg, _cpu(na), _cpu(carry), _cpu(table), u,
                                k, _cpu(gd), fam)
        _equal(got, want)


# name: (nodes, identical nodes, pod cpu, K, L, J, n_actual); which
# branch each takes at D shards is held by tests/test_torch_kernels_host.py
USH_CASES = {
    "fused_select": (150, False, "1", 64, 64, 8, 64),
    "fused_all_rows": (150, False, "1", 256, 64, 8, 40),
    "multi_select": (200, False, "250m", 64, 512, 400, 512),
    "multi_all_rows": (200, False, "250m", 256, 1024, 200, 700),
    "top_global": (4000, False, "250m", 4096, 32768, 8, 32768),
    "fewer_feasible": (100, False, "12", 64, 64, 8, 64),
    "ties": (300, True, "1", 64, 128, 4, 128),
}


def _ush_setup(rng, n_nodes, proto, cuda, identical=False):
    if not identical:
        return _staged(rng, n_nodes, [proto], cuda)
    cache = Cache()
    for i in range(n_nodes):
        cache.add_node(make_node(f"n{i}").capacity(
            {"cpu": 8, "memory": "16Gi", "pods": 110}).obj())
    snap = Snapshot()
    cache.update_snapshot(snap)
    state = ClusterState(device=cuda)
    state.apply_snapshot(snap)
    batch = BatchBuilder(state).build([proto])
    return state.device_arrays(), batch, P.table_from_batch(batch, cuda)


@pytest.mark.parametrize("D", [1, 2, 4, 8])
@pytest.mark.parametrize("case", sorted(USH_CASES))
def test_run_uniform_sharded_selection_shapes(cuda, case, D):
    # D = 8 shards of one card take two launches a step (four a launch)
    from kubernetes_tpu_torch.ops import kernels as Kr
    S, gm, cm = _mesh_pair(D, "one")
    n_nodes, identical, cpu, K, L, J, n_actual = USH_CASES[case]
    rng = random.Random(5)
    proto = make_pod("u").req({"cpu": cpu, "memory": "1Gi"}).obj()
    na, batch, table = _ush_setup(rng, n_nodes, proto, cuda, identical)
    N = na.cap.shape[0]
    K = min(K, N)
    x = P.PodXs(True, int(batch.sig[0]), int(batch.tidx[0]))
    gna, cna = S.shard_node_arrays(gm, na), S.shard_node_arrays(cm, na)
    ctab = P.table_from_batch(batch, "cpu")
    gc0, cc0 = S.initial_carry_sharded(gna), S.initial_carry_sharded(cna)
    Kr.reset_launches()
    gc, gp = S.run_uniform_sharded(P.ScoreConfig(), gm, gna, gc0, x, table,
                                   n_actual, L, K, J)
    assert Kr.LAUNCHES["run_uniform_sharded"] == 1
    cc, cp = S.run_uniform_sharded(P.ScoreConfig(), cm, cna, cc0, x, ctab,
                                   n_actual, L, K, J)
    _equal((gp, S.unshard(gc)), (cp, S.unshard(cc)))
    _equal(S.run_uniform_sharded(P.ScoreConfig(), gm, gna, gc, x, table,
                                 n_actual, L, K, J)[1],
           S.run_uniform_sharded(P.ScoreConfig(), cm, cna, cc, x, ctab,
                                 n_actual, L, K, J)[1])
    sc, sp = P.run_uniform(P.ScoreConfig(), na, P.initial_carry(na), x,
                           table, n_actual, L, K, J)
    # a tie across the K-th candidate: each shard's top-K_loc holds tied
    # rows the single device's top-K leaves out (the JAX package's mesh
    # semantics), so only one shard matches the single device there
    comparable = case != "ties" or D == 1
    if comparable and all(gp[L:].cpu().tolist()) and all(
            sp[L:].cpu().tolist()):
        _equal((gp, S.unshard(gc)), (sp, sc))


@pytest.mark.parametrize("D", [1, 2, 4])
@pytest.mark.parametrize("verdict", ["accept", "reject", "inexact",
                                     "reject_sig"])
@pytest.mark.parametrize("case", ["fused_select", "multi_select"])
def test_run_gang_uniform_sharded_verdicts(cuda, case, verdict, D):
    from kubernetes_tpu_torch.ops import gang as G
    S, gm, cm = _mesh_pair(D, "one")
    n_nodes, identical, cpu, K, L, J, n_actual = USH_CASES[case]
    # MostAllocated raises the score with each placement: not monotone
    cfg = P.ScoreConfig(strategy="MostAllocated" if verdict == "inexact"
                        else "LeastAllocated")
    rng = random.Random(7)
    proto = make_pod("g").req({"cpu": cpu, "memory": "1Gi"}).obj()
    na, batch, table = _ush_setup(rng, n_nodes, proto, cuda, identical)
    K = min(K, na.cap.shape[0])
    needed = 10 ** 6 if verdict.startswith("reject") else 1
    x = P.PodXs(True, int(batch.sig[0]), int(batch.tidx[0]))
    gna, cna = S.shard_node_arrays(gm, na), S.shard_node_arrays(cm, na)
    gc0, cc0 = S.initial_carry_sharded(gna), S.initial_carry_sharded(cna)
    if verdict == "reject_sig":
        gc0 = S.with_cache_sig_sharded(gc0, 7)
        cc0 = S.with_cache_sig_sharded(cc0, 7)
    before = S.unshard(gc0)
    got = S.run_gang_sharded(cfg, gm, gna, gc0, x, table,
                             needed=needed, uniform=True, n_actual=n_actual,
                             L=L, K=K, J=J)
    want = S.run_gang_sharded(cfg, cm, cna, cc0, x,
                              P.table_from_batch(batch, "cpu"),
                              needed=needed, uniform=True,
                              n_actual=n_actual, L=L, K=K, J=J)
    _equal((got[1], S.unshard(got[0])), (want[1], S.unshard(want[0])))
    _equal(before, S.unshard(gc0))
    verdict_bits = got[1][L:].cpu().tolist()
    if verdict.startswith("reject"):
        assert verdict_bits[0] == 0
        _equal(S.unshard(got[0]), before)
    if verdict == "inexact":
        assert verdict_bits[2] == 0
        _equal(S.unshard(got[0]), before)
    sc, sp = G.run_gang(cfg, na, P.initial_carry(na) if
                        verdict != "reject_sig" else P.with_cache_sig(
                            P.initial_carry(na), 7), x, table,
                        needed=needed, uniform=True, n_actual=n_actual, L=L,
                        K=K, J=J)
    if bool(sp[L + 2].cpu()) and verdict_bits[2]:
        _equal((got[1], S.unshard(got[0])), (sp, sc))


# ---------------------------------------------------------------------------
# the mesh's two scans on one card: run_batch_sharded (lean and group mode)
# one cooperative launch a span, run_gang_sharded's scan tier one a gang
# (csrc/run_batch_sharded.cu, csrc/run_gang_sharded.cu); the host-driven
# chains of shards on several cards, called on D shards of one card


SHARD_EDGE_CASES = ("ties_at_cta_boundaries", "ragged_outside_invalid",
                    "sig_change_every_pod", "groups_every_family",
                    "groups_beyond_lattice")


def _sharded_edge(case, D, place="one"):
    """One RUN_BATCH_EDGE_CASES case on D shards: (S, the card mesh, the
    CPU mesh, e, na, table, gd, gc, fam)."""
    S, gm, cm = _mesh_pair(D, place)
    e, na, table, groups, fam, _ovl = _edge_inputs(case, "cuda")
    gd, gc = groups if groups is not None else (None, None)
    return S, gm, cm, e, na, table, gd, gc, fam


def _sharded_carry(S, mesh, na, gc):
    gna = S.shard_node_arrays(mesh, na)
    gcs = S.shard_group_carry(mesh, gc) if gc is not None else None
    return gna, S.initial_carry_sharded(gna, gcs)


@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("case", SHARD_EDGE_CASES)
def test_run_batch_sharded_edges_equal_plain(cuda, case, D):
    """One launch a span over D shards of one card on the scan's edge
    inputs — ties at block and shard boundaries (N = 2,048: a block
    boundary at 512 inside each shard of D = 2, the shard boundary at
    1,024), n_local not a multiple of 512 (5,000 rows: 2,500 / 1,250 a
    shard), a row outside the table (-2), invalid pods, full port slots,
    image counts across shards, group mode with ScheduleAnyway rack and
    hostname spreads and anti-affinity — against the plain version over D
    CPU shards (the span without the rows outside the table), the
    single-device kernel, and the input carry untouched."""
    from _batch_edges import check_span, full_span, kept
    from kubernetes_tpu_torch.ops import kernels as K
    S, gm, cm, e, na, table, gd, gc, fam = _sharded_edge(case, D)
    gna, gcarry = _sharded_carry(S, gm, na, gc)
    before = _cpu(S.unshard(gcarry))
    ggd = S.shard_groups(gm, gd) if gd is not None else None
    cfg = P.ScoreConfig()
    K.reset_launches()
    kc, ka = S.run_batch_sharded(cfg, gm, gna, gcarry, _edge_xs(e, cuda),
                                 table, ggd, fam)
    torch.cuda.synchronize()
    assert K.RAW_LAUNCHES["run_batch_sharded"] == 1
    keep = kept(e)
    cna, ccarry = _sharded_carry(S, cm, _cpu(na), _cpu(gc))
    cgd = S.shard_groups(cm, _cpu(gd)) if gd is not None else None
    pc, pa = S.run_batch_sharded(cfg, cm, cna, ccarry,
                                 _edge_xs(e, "cpu", keep), _cpu(table), cgd,
                                 fam)
    got = ka.cpu().tolist()
    assert got == full_span(e, pa.numpy())
    _equal(S.unshard(kc), S.unshard(pc))
    _equal(S.unshard(gcarry), before)
    check_span(case, got)
    sc, sa = P.run_batch(cfg, na, P.initial_carry(na, gc), _edge_xs(e, cuda),
                         table, gd, fam)
    _equal((ka, S.unshard(kc)), (sa, sc))


def _gang_edge(case, device):
    """One GANG_EDGE_CASES case (tests/_gang_edges.py) through the port's
    state layer, on `device`: (na, table, xs, wt, needed, dom, w_contig,
    m)."""
    from _gang_edges import stage
    from kubernetes_tpu_torch.ops.gang import GangXs
    from kubernetes_tpu_torch.testing import wrappers
    e = stage(case, SimpleNamespace(
        Cache=Cache, Snapshot=Snapshot, ClusterState=ClusterState,
        BatchBuilder=BatchBuilder, W=wrappers))
    na = convert.node_arrays_from_numpy(e.arrays, device)
    table = convert.pod_table_from_numpy(e.table, device)
    xs = convert.gang_xs_from_numpy(GangXs(e.valid, e.tidx, e.widx), device)
    dom = torch.from_numpy(e.dom).to(device)
    return na, table, xs, e.wt, e.needed, dom, e.w_contig, e.m


@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("case", sorted(GANG_EDGE_CASES))
def test_run_gang_sharded_edges_equal_plain(cuda, case, D):
    """One launch a gang over D shards of one card: members that straddle
    a shard boundary, contiguity domains that span shards, n_local not a
    multiple of 512, ties at block and shard boundaries, a rejected gang
    whose carry equals its input — against the plain version over D CPU
    shards and the single-device kernel."""
    from kubernetes_tpu_torch.ops import gang as G
    from kubernetes_tpu_torch.ops import kernels as K
    S, gm, cm = _mesh_pair(D, "one")
    na, table, xs, wt, needed, dom, w_contig, m = _gang_edge(case, cuda)
    N = na.cap.shape[0]
    n = N // D
    gna, cna = S.shard_node_arrays(gm, na), S.shard_node_arrays(cm, _cpu(na))
    gc0 = S.with_cache_sig_sharded(S.initial_carry_sharded(gna), 7)
    cc0 = S.with_cache_sig_sharded(S.initial_carry_sharded(cna), 7)
    before = _cpu(S.unshard(gc0))
    ctab = _cpu(table)
    K.reset_launches()
    got = S.run_gang_sharded(
        P.ScoreConfig(), gm, gna, gc0, xs, table, wt=wt, needed=needed,
        dom=[dom[d * n:(d + 1) * n] for d in range(D)],
        statics=S.wave_statics_sharded(gm, gna, table, wt),
        w_contig=w_contig)
    torch.cuda.synchronize()
    assert K.RAW_LAUNCHES["run_gang_sharded"] == 1
    want = S.run_gang_sharded(
        P.ScoreConfig(), cm, cna, cc0, _cpu(xs), ctab, wt=wt, needed=needed,
        dom=[dom[d * n:(d + 1) * n].cpu() for d in range(D)],
        statics=S.wave_statics_sharded(cm, cna, ctab, wt),
        w_contig=w_contig)
    _equal((got[1], S.unshard(got[0])), (want[1], S.unshard(want[0])))
    _equal(S.unshard(gc0), before)
    check_placements(case, got[1].cpu().tolist())
    if not GANG_EDGE_CASES[case]["accept"]:
        _equal(S.unshard(got[0]), before)
    sc, sp = G.run_gang(P.ScoreConfig(), na,
                        P.with_cache_sig(P.initial_carry(na), 7), xs, table,
                        wt=wt, needed=needed, dom=dom,
                        statics=P.wave_statics(na, table, wt),
                        w_contig=w_contig)
    _equal((got[1], S.unshard(got[0])), (sp, sc))


@pytest.mark.parametrize("case", sorted(GANG_EDGE_CASES))
def test_run_gang_cluster_edges_equal_plain(cuda, case):
    """run_gang's scan tier, one cluster launch a gang (16 CTAs of ⌈N /
    16⌉ rows, the one-shard case of the gang body): the straddle band
    across CTA boundaries, N = 1,536 ragged, ties beside the CTA
    boundaries to the lowest row, a rejected gang whose carry equals its
    input — against the plain version and against the gang grid at D = 1
    (make_mesh of one shard, the same body on GridTeam)."""
    from kubernetes_tpu_torch.ops import gang as G
    from kubernetes_tpu_torch.ops import kernels as K
    S, gm, _cm = _mesh_pair(1, "one")
    na, table, xs, wt, needed, dom, w_contig, m = _gang_edge(case, cuda)
    c0 = P.with_cache_sig(P.initial_carry(na), 7)
    before = [t.clone() for t in list(c0[:4]) + list(c0.cache)]
    statics = P.wave_statics(na, table, wt)
    K.reset_launches()
    got = G.run_gang(P.ScoreConfig(), na, c0, xs, table, wt=wt,
                     needed=needed, dom=dom, statics=statics,
                     w_contig=w_contig)
    torch.cuda.synchronize()
    assert K.RAW_LAUNCHES["run_gang"] == 1
    want = G._run_gang_scan_plain(P.ScoreConfig(), _cpu(na), _cpu(c0),
                                  _cpu(xs), _cpu(table), wt, needed,
                                  dom.cpu(), tuple(t.cpu() for t in statics),
                                  w_contig)
    _equal(got, want)
    _equal(before, list(c0[:4]) + list(c0.cache))
    check_placements(case, got[1].cpu().tolist())
    if not GANG_EDGE_CASES[case]["accept"]:
        _equal(list(got[0][:3]), before[:3])
    gna = S.shard_node_arrays(gm, na)
    gc0 = S.with_cache_sig_sharded(S.initial_carry_sharded(gna), 7)
    grid = S.run_gang_sharded(
        P.ScoreConfig(), gm, gna, gc0, xs, table, wt=wt, needed=needed,
        dom=[dom], statics=S.wave_statics_sharded(gm, gna, table, wt),
        w_contig=w_contig)
    torch.cuda.synchronize()
    assert K.RAW_LAUNCHES["run_gang_sharded"] == 1
    _equal((grid[1], S.unshard(grid[0])), (got[1], got[0]))


SCAN_LAUNCH_MESHES = [(1, "one"), (2, "one"), (4, "one"), (2, "cards"),
                      (4, "cards")]


@pytest.mark.parametrize("D,place", SCAN_LAUNCH_MESHES)
def test_sharded_scans_launch_once_a_card(cuda, D, place):
    """run_batch_sharded (lean and group mode) is one CUDA launch a span
    and run_gang_sharded's scan tier one a gang when the shards share a
    card ("one"); across cards ("cards") each keeps its chain: 3 launches
    a shard a pod lean, 5 or 6 in group mode; init, verdict and 3 or 4 a
    shard a member for the gang."""
    from kubernetes_tpu_torch.ops import kernels as K
    S, gm, _cm = _mesh_pair(D, place)
    assert K.plan_sharded_placement(gm) == place
    cfg = P.ScoreConfig()
    e, na, table, groups, fam, _ovl = _edge_inputs("groups_every_family",
                                                   cuda)
    gd, gc = groups
    xs = _edge_xs(e, cuda)
    B = xs.valid.shape[0]
    for grp in (False, True):
        gna, gcarry = _sharded_carry(S, gm, na, gc if grp else None)
        K.reset_launches()
        S.run_batch_sharded(cfg, gm, gna, gcarry, xs, table,
                            S.shard_groups(gm, gd) if grp else None,
                            fam if grp else None)
        torch.cuda.synchronize()
        key = "run_batch_sharded_groups" if grp else "run_batch_sharded"
        assert K.LAUNCHES[key] == 1
        per_pod = (6 if fam.spr_s else 5) if grp else 3
        assert K.RAW_LAUNCHES["run_batch_sharded"] == (
            1 if place == "one" else per_pod * D * B)
    na, table, xs, wt, needed, dom, w_contig, m = _gang_edge("straddle",
                                                             cuda)
    n = na.cap.shape[0] // D
    gna = S.shard_node_arrays(gm, na)
    K.reset_launches()
    S.run_gang_sharded(cfg, gm, gna, S.initial_carry_sharded(gna), xs,
                       table, wt=wt, needed=needed,
                       dom=[dom[d * n:(d + 1) * n].to(gm.devices[d])
                            for d in range(D)],
                       statics=S.wave_statics_sharded(gm, gna, table, wt),
                       w_contig=w_contig)
    torch.cuda.synchronize()
    assert K.LAUNCHES["run_gang_sharded"] == 1
    assert K.RAW_LAUNCHES["run_gang_sharded"] == (
        1 if place == "one" else D * (2 + 4 * xs.valid.shape[0]))


@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("case", ["ties_at_cta_boundaries",
                                  "ragged_outside_invalid",
                                  "groups_every_family"])
def test_batch_sharded_chain_on_one_card(cuda, case, D):
    """The host-driven chain of shards on several cards (placement
    "cards"), called on D shards of one card: the same bits as the plain
    version over CPU shards and as the one-launch grid."""
    from _batch_edges import full_span, kept
    from kubernetes_tpu_torch.ops import kernels as K
    S, gm, cm, e, na, table, gd, gc, fam = _sharded_edge(case, D)
    gna, gcarry = _sharded_carry(S, gm, na, gc)
    ggd = S.shard_groups(gm, gd) if gd is not None else None
    cfg = P.ScoreConfig()
    keep = kept(e)
    # the chain takes only rows inside the table (the grid reports -2)
    xs = _edge_xs(e, cuda, keep)
    K.reset_launches()
    hc, ha = K._batch_sharded_chain(cfg, gm, gna, gcarry, xs, table, ggd,
                                    fam)
    torch.cuda.synchronize()
    per_pod = (6 if fam.spr_s else 5) if gd is not None else 3
    assert K.RAW_LAUNCHES["run_batch_sharded"] == (
        per_pod * D * xs.valid.shape[0])
    cna, ccarry = _sharded_carry(S, cm, _cpu(na), _cpu(gc))
    cgd = S.shard_groups(cm, _cpu(gd)) if gd is not None else None
    pc, pa = S.run_batch_sharded(cfg, cm, cna, ccarry,
                                 _edge_xs(e, "cpu", keep), _cpu(table), cgd,
                                 fam)
    _equal((ha, S.unshard(hc)), (pa, S.unshard(pc)))
    kc, ka = S.run_batch_sharded(cfg, gm, gna, gcarry, _edge_xs(e, cuda),
                                 table, ggd, fam)
    torch.cuda.synchronize()
    assert ka.cpu().tolist() == full_span(e, ha.cpu().numpy())
    _equal(S.unshard(kc), S.unshard(hc))


@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("case", ["straddle", "straddle_rejected", "ties"])
def test_gang_sharded_chain_on_one_card(cuda, case, D):
    """run_gang_sharded's chain of shards on several cards, called on D
    shards of one card: the same bits as the plain version over CPU
    shards and as the one-launch grid."""
    from kubernetes_tpu_torch.ops import kernels as K
    S, gm, cm = _mesh_pair(D, "one")
    na, table, xs, wt, needed, dom, w_contig, m = _gang_edge(case, cuda)
    n = na.cap.shape[0] // D
    gna, cna = S.shard_node_arrays(gm, na), S.shard_node_arrays(cm, _cpu(na))
    gc0 = S.with_cache_sig_sharded(S.initial_carry_sharded(gna), 3)
    cc0 = S.with_cache_sig_sharded(S.initial_carry_sharded(cna), 3)
    gdom = [dom[d * n:(d + 1) * n] for d in range(D)]
    gst = S.wave_statics_sharded(gm, gna, table, wt)
    cfg = P.ScoreConfig()
    K.reset_launches()
    hc, hp = K._gang_sharded_chain(cfg, gm, gna, gc0, xs, table, list(wt),
                                   needed, gdom, gst, w_contig)
    torch.cuda.synchronize()
    B = xs.valid.shape[0]
    assert K.RAW_LAUNCHES["run_gang_sharded"] == D * (
        2 + (4 if w_contig else 3) * B)
    ctab = _cpu(table)
    want = S.run_gang_sharded(
        cfg, cm, cna, cc0, _cpu(xs), ctab, wt=wt, needed=needed,
        dom=[x.cpu() for x in gdom],
        statics=S.wave_statics_sharded(cm, cna, ctab, wt),
        w_contig=w_contig)
    _equal((hp, S.unshard(hc)), (want[1], S.unshard(want[0])))
    one = S.run_gang_sharded(cfg, gm, gna, gc0, xs, table, wt=wt,
                             needed=needed, dom=gdom, statics=gst,
                             w_contig=w_contig)
    torch.cuda.synchronize()
    _equal((hp, S.unshard(hc)), (one[1], S.unshard(one[0])))


# ---------------------------------------------------------------------------
# wave_statics (one launch a call, a shard table on one card) and
# diagnose_row (one launch for a drain's rows, one packed output)

STATICS_FEATS = [(t, s, i) for t in (False, True) for s in (False, True)
                 for i in (False, True)]


def _statics_inputs(N, device, D=1):
    """(na with N rows, table, 64 rows): a seeded 150-node cluster tiled to
    N rows; its images cleared but on the rows each side of every CTA
    split of the 16-CTA cluster and of every boundary of D shards, so the
    image counts cross both, each image of a size at which one count more
    or less changes its ImageLocality score."""
    from kubernetes_tpu_torch.ops import kernels as K
    rng = random.Random(8)
    pods = [_pod(rng, i) for i in range(96)]
    na, batch, table = _staged(rng, 150, pods, "cpu")
    reps = -(-N // 150)
    na = type(na)(*(torch.cat([x[:150]] * reps)[:N].contiguous()
                    for x in na))
    ids = table.img_ids[table.img_ids != 0]
    span = -(-N // K.WS_CLUSTER)
    edge = sorted({b + o for b in list(range(span, N, span))
                   + [N * d // D for d in range(1, D)] for o in (-1, 0)})
    image_id = torch.zeros_like(na.image_id)
    image_size = torch.zeros_like(na.image_size)
    image_id[edge, 0] = int(ids[0])
    # a size at which one count more or less moves the score
    image_size[edge, 0] = N * (12 << 20)
    na = na._replace(image_id=image_id, image_size=image_size)
    rows = list(dict.fromkeys(int(t) for t in batch.tidx[:96]))
    rows = (rows * 64)[:64]
    return (type(na)(*(x.to(device) for x in na)),
            type(table)(*(x.to(device) for x in table)), rows)


@pytest.mark.parametrize("N", [8192, 32769])
@pytest.mark.parametrize("S", [1, 4, 8, 64])
def test_wave_statics_rows_and_families_equal_plain(cuda, S, N):
    """Every family flag at S = 1, 4, 8 and 64 rows, N = 8,192 and 32,769
    rows, images on the rows each side of every CTA split: the kernel's
    four surfaces bit for bit against the plain version."""
    na, table, rows = _statics_inputs(N, cuda)
    for feats in STATICS_FEATS:
        _equal(P.wave_statics(na, table, rows[:S], feats),
               P._wave_statics_plain(na, table, rows[:S], feats))


def test_wave_statics_launches_once_a_call(cuda, monkeypatch):
    """One wrapper call is one call of the kernel's C entry (one launch,
    tests/test_torch_kernels_host.py): on one device, at 64 rows, and on
    a mesh's shards of one card, images or none."""
    from kubernetes_tpu_torch.ops import kernels as K
    from kubernetes_tpu_torch.parallel import sharding as S
    lib = K.build()["wave_statics"]
    real, calls = lib.ktpu_wave_statics, []
    monkeypatch.setattr(lib, "ktpu_wave_statics",
                        lambda *a: calls.append(1) or real(*a))
    na, table, rows = _statics_inputs(8192, cuda, D=4)
    K.reset_launches()
    P.wave_statics(na, table, rows, (True, True, True))
    mesh = S.make_mesh(devices=[cuda] * 4)
    gna = S.shard_node_arrays(mesh, na)
    for feats in ((True, True, True), (False, False, False)):
        S.wave_statics_sharded(mesh, gna, table, rows[:8], feats)
    torch.cuda.synchronize()
    assert calls == [1, 1, 1]
    assert K.LAUNCHES["wave_statics"] == 1
    assert K.LAUNCHES["wave_statics_sharded"] == 2
    assert K.RAW_LAUNCHES["wave_statics_sharded"] == 2


@pytest.mark.parametrize("D,place", MESHES)
@pytest.mark.parametrize("S", [1, 8])
def test_wave_statics_sharded_equal_plain(cuda, S, D, place):
    """The per-shard surfaces on D shards (one card: one launch over the
    shard table; several cards: the launches a card, the counts psum'd),
    images on both sides of every shard boundary: bit for bit against the
    plain version over CPU shards and against the single-device kernel
    cut by shard."""
    Sh, gm, cm = _mesh_pair(D, place)
    na, table, rows = _statics_inputs(8192, cuda, D=D)
    gna = Sh.shard_node_arrays(gm, na)
    cna = Sh.shard_node_arrays(cm, _cpu(na))
    for feats in STATICS_FEATS:
        got = Sh.wave_statics_sharded(gm, gna, table, rows[:S], feats)
        _equal(got, Sh.wave_statics_sharded(cm, cna, _cpu(table), rows[:S],
                                            feats))
        single = P.wave_statics(na, table, rows[:S], feats)
        _equal([torch.cat([g[f].cpu() for g in got], dim=1)
                for f in range(4)], list(single))


@pytest.mark.parametrize("D", [2, 4])
def test_statics_sharded_chain_on_one_card(cuda, D):
    """The launches a card of shards on several cards (each card's image
    counts, their psum, each card's surfaces), called on D shards of one
    card: the same bits as the one launch and the plain version, two
    launches a shard with images and one without."""
    from kubernetes_tpu_torch.ops import kernels as K
    Sh, gm, cm = _mesh_pair(D, "one")
    na, table, rows = _statics_inputs(8192, cuda, D=D)
    gna = Sh.shard_node_arrays(gm, na)
    cna = Sh.shard_node_arrays(cm, _cpu(na))
    for feats in ((True, True, True), (True, True, False)):
        K.reset_launches()
        got = K._statics_sharded_chain(gm, gna, table, rows[:8], feats)
        torch.cuda.synchronize()
        assert K.RAW_LAUNCHES["wave_statics_sharded"] == D * (
            2 if feats[2] else 1)
        _equal(got, Sh.wave_statics_sharded(gm, gna, table, rows[:8],
                                            feats))
        _equal(got, Sh.wave_statics_sharded(cm, cna, _cpu(table), rows[:8],
                                            feats))


def _extended_nodes(n, zones=3):
    """Zone nodes with twelve extended resources: R = 16 columns."""
    out = []
    for i in range(n):
        cap = {"cpu": 4 + i % 5, "memory": "8Gi", "pods": 6}
        cap.update({f"example.com/r{k}": (i + k) % 4 for k in range(12)})
        out.append(make_node(f"n{i}").capacity(cap).zone(f"z{i % zones}")
                   .label(HOSTNAME, f"n{i}").obj())
    return out


def _diag_rows_cases(kind):
    """(nodes, existing, pods) of a diagnosis case: "mixed" the group and
    lean reasons of _diag_cases; "columns" requests over all sixteen
    resource columns; "split" a hostname spread whose minimum (0) only
    node 4 holds, the first row of the cluster's second CTA at N = 64."""
    if kind == "mixed":
        return _diag_cases()
    if kind == "columns":
        pods = [make_pod(f"x{j}").req({"cpu": f"{1 + j}", **{
            f"example.com/r{k}": (j + k) % 3 for k in range(12)}}).obj()
            for j in range(6)]
        existing = [make_pod(f"e{i}").req({"cpu": "2", "example.com/r0": 1})
                    .node(f"n{i}").obj() for i in range(0, 40, 3)]
        return _extended_nodes(40), existing, pods
    nodes = _zone_nodes(64, 4)
    existing = [make_pod(f"e{i}").req({"cpu": "1"}).label("app", "h")
                .node(f"n{i}").obj() for i in range(64) if i != 4]
    pods = [make_pod(f"h{j}").req({"cpu": "1"}).label("app", "h")
            .spread_constraint(1, HOSTNAME, "DoNotSchedule", {"app": "h"})
            .obj() for j in range(2)]
    return nodes, existing, pods


@pytest.mark.parametrize("groups", [False, True])
@pytest.mark.parametrize("kind", ["mixed", "columns", "split"])
def test_diagnose_rows_one_launch_equal_single_rows(cuda, kind, groups):
    """S rows in one diagnose_rows launch: row s equal to the one-row call
    of rows[s] and to the plain version, lean and group; one launch."""
    from kubernetes_tpu_torch.ops import kernels as K
    nodes, existing, pods = _diag_rows_cases(kind)
    na, batch, table, gd, gc, fam, _b, _s = _group_setup(
        nodes, existing, pods, cuda)
    kw = dict(gd=gd, gc=gc, fam=fam) if groups else {}
    rows = sorted(set(int(t) for t in batch.tidx[:len(pods)]))
    N, R = na.cap.shape
    assert R == 16
    K.reset_launches()
    packed = P.diagnose_rows(na, table, rows, **kw)
    torch.cuda.synchronize()
    assert K.LAUNCHES["diagnose_row"] == 1
    got = P.diagnosis_views(packed, len(rows), N, R)
    _equal(packed, P._diagnose_rows_plain(na, table, rows, **kw))
    for s, u in enumerate(rows):
        _equal(tuple(x[s] for x in got), P.diagnose_row(na, table, u, **kw))
    if kind == "columns":
        assert bool(got[2][:, :, 4:].any())
    if kind == "split" and groups:
        # only node 4 (no pod, the minimum) passes the skew
        assert got[0][0].cpu().tolist().count(P.DIAG_FEASIBLE) == 1
        assert int(got[0][0][4]) == P.DIAG_FEASIBLE


def test_diagnose_rows_at_64_rows_full_width(cuda):
    """64 rows (the launch's limit) at N = 8,192 against the plain
    version, lean and group, and the packed block reused across calls."""
    nodes = _zone_nodes(5000, 16, cpu=32)
    existing = [make_pod(f"e{k}").req({"cpu": "30"}).label("app", "mix")
                .node(f"n{k}").obj() for k in range(0, 5000, 7)]
    pods = _mixed_pods(64, 32, kinds=("spread", "affinity", "anti"))
    na, batch, table, gd, gc, fam, _b, _s = _group_setup(
        nodes, existing, pods, cuda)
    rows = list(dict.fromkeys(int(t) for t in batch.tidx[:64]))
    rows = (rows * 64)[:64]
    args = P.diagnose_args(na, table, gd, gc, fam)
    for kw, a in ((dict(gd=gd, gc=gc, fam=fam), args), ({}, None)):
        _equal(P.diagnose_rows(na, table, rows, args=a, **kw),
               P._diagnose_rows_plain(na, table, rows, **kw))
    with pytest.raises(ValueError, match="stale"):
        P.diagnose_rows(na, table, rows, args=args)
    with pytest.raises(ValueError, match="rows"):
        P.diagnose_rows(na, table, rows + rows[:1], gd=gd, gc=gc, fam=fam,
                        args=args)


# ---------------------------------------------------------------------------
# the ColumnarIngest gate on the card


def _ingest_workload(device, columnar, infeasible):
    """tests/test_torch_ingest.py's end-state workload (24 nodes, 120 pods
    in chunks of 40, every seventh a ScheduleAnyway zone spread) through
    the port's Scheduler on `device` with the gate on or off."""
    from kubernetes_tpu_torch.backend.apiserver import APIServer
    from kubernetes_tpu_torch.config import KubeSchedulerConfiguration
    from kubernetes_tpu_torch.scheduler import Scheduler
    api = APIServer()
    sched = Scheduler(api, batch_size=256, clock=lambda: 1000.0,
                      device=device, config=KubeSchedulerConfiguration(
                          feature_gates={"ColumnarIngest": columnar}))
    rng = random.Random(5)
    for i in range(24):
        api.create_node(make_node(f"node-{i}").capacity(
            {"cpu": 8, "memory": "16Gi", "pods": 110}).zone(
            f"zone-{i % 4}").label("kubernetes.io/hostname",
                                   f"node-{i}").obj())
    sched.prime()
    pods = []
    for i in range(120):
        w = make_pod(f"pod-{i}")
        if infeasible and i % 9 == 0:
            w = w.req({"cpu": "100"})
        else:
            w = w.req({"cpu": f"{rng.choice([250, 500])}m",
                       "memory": "512Mi"})
        if i % 7 == 0:
            w = w.label("app", "web").spread_constraint(
                5, "topology.kubernetes.io/zone", "ScheduleAnyway",
                {"app": "web"})
        pods.append(w.obj())
    for start in range(0, len(pods), 40):
        api.create_pods(pods[start:start + 40])
        sched.schedule_pending(wait=False)
    sched.schedule_pending()
    assert sched.reconcile() == []
    dump = sched.cache.dump()
    return {
        "assignments": {uid: p.spec.node_name for uid, p in api.pods.items()},
        "counts": (sched.scheduled_count, sched.unschedulable_count),
        "cache_nodes": {n: {k: v for k, v in d.items() if k != "generation"}
                        for n, d in dump["nodes"].items()},
        "assumed": dump["assumed_pods"], "pod_count": dump["pod_count"],
        "dispatcher": (sched.dispatcher.executed, sched.dispatcher.errors),
        "queue_len": len(sched.queue),
    }


@pytest.mark.parametrize("infeasible", [False, True])
def test_columnar_ingest_gate_on_equals_off(cuda, infeasible):
    on = _ingest_workload(cuda, True, infeasible)
    assert on == _ingest_workload(cuda, False, infeasible)
    assert on == _ingest_workload("cpu", True, infeasible)
    assert on["counts"][0] == (106 if infeasible else 120)
