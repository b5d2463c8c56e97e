"""The port's node-sharded group and gang programs (kubernetes_tpu_torch/
parallel/sharding.py) ↔ the JAX package's, and ↔ the port's
single-device ones.

For D ∈ {1, 2, 4, 8}: one seeded cluster and pending batch, built with
the JAX package's state layer, goes as numpy through the JAX sharded
program on the 8-device virtual CPU mesh (tests/conftest.py) and through
the port's plain version over D CPU shards; the port's single-device
plain program runs on the same inputs. Covered: run_batch_sharded's
group mode (the spread / anti-affinity / preferred-affinity mix of
tests/test_sharding.py:117 and a ScheduleAnyway + anti-affinity mix),
run_plan_sharded (group, lean and ports variants, norm_live on and off),
and the helpers: shard_groups / shard_group_carry, own, the sharded
scatter_new_rows and the sharded wave statics (run_gang_sharded's tiers
are in tests/test_torch_sharding.py).
Tolerance: exact. Assignments, packed vectors, every carry field, every
group counter (through unshard) and the SigCache `sig` are int64 /
int32 / bool equal, dtypes included."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_parity import private_jax_compiles  # noqa: F401
from kubernetes_tpu.backend.cache import Cache, Snapshot
from kubernetes_tpu.ops import groups as jg
from kubernetes_tpu.ops import program as jp
from kubernetes_tpu.parallel import sharding as js
from kubernetes_tpu.state.batch import BatchBuilder, BatchDims
from kubernetes_tpu.state.tensorize import ClusterState, pow2_at_least
from kubernetes_tpu.testing.wrappers import make_node, make_pod
from kubernetes_tpu_torch.ops import groups as tg
from kubernetes_tpu_torch.ops import program as tp
from kubernetes_tpu_torch.parallel import sharding as ts
from kubernetes_tpu_torch.state import convert

DS = (1, 2, 4, 8)
N_BUCKET = 32
ZONE = "topology.kubernetes.io/zone"
HOSTNAME = "kubernetes.io/hostname"

torch.set_num_threads(1)


def _nodes(n=24, zones=3, cpu=None, prefer=False, blocked=False):
    """Heterogeneous capacities; zones interleave, so every zone's first
    node (its dense domain id) lies on shard 0 and its other nodes on
    every shard, or (`blocked`) come in contiguous blocks, so a shard
    sees only some zones: its own distinct-domain count is not the
    cluster's."""
    rng = np.random.RandomState(3)
    out = []
    for i in range(n):
        zone = i * zones // n if blocked else i % zones
        w = (make_node(f"n{i}")
             .capacity({"cpu": cpu or int(rng.randint(4, 16)),
                        "memory": "32Gi", "pods": 40})
             .zone(f"z{zone}").label(HOSTNAME, f"n{i}"))
        if prefer and i % 3 == 0:
            w = w.taint("dedic", "x", "PreferNoSchedule")
        out.append(w.obj())
    return out


def _staged(nodes, existing, pods):
    cache = Cache()
    for nd in nodes:
        cache.add_node(nd)
    for pod, node_name in existing:
        pod.spec.node_name = node_name
        cache.add_pod(pod)
    snap = Snapshot()
    cache.update_snapshot(snap)
    state = ClusterState()
    state.dims.nodes = max(N_BUCKET, state.dims.nodes)
    state.apply_snapshot(snap, full=True)
    builder = BatchBuilder(state, BatchDims(table_rows=64))
    batch = builder.build(pods)
    assert not batch.host_fallback.any()
    return state, snap, builder, batch


def mixed_pods(n):
    """tests/test_sharding.py:117: spread, required anti-affinity and
    preferred affinity pods (the global minimum, the distinct count, the
    topology-value broadcast)."""
    pods = []
    for i in range(n):
        w = make_pod(f"g{i}").req({"cpu": "250m", "memory": "256Mi"})
        if i % 3 == 0:
            w = (w.label("app", "spread")
                 .spread_constraint(1, ZONE, "DoNotSchedule",
                                    {"app": "spread"}))
        elif i % 3 == 1:
            w = (w.label("app", "anti")
                 .pod_affinity(ZONE, {"app": "anti"}, anti=True))
        else:
            w = (w.label("app", "soft")
                 .preferred_pod_affinity(ZONE, {"app": "spread"},
                                         weight=40))
        pods.append(w.obj())
    return pods


def anyway_pods(n):
    """ScheduleAnyway spread over zones and hostnames (one row holds both:
    their weights, from the cluster-wide distinct zones and scored nodes,
    set their balance), required anti-affinity per hostname, required
    affinity to a seeded app."""
    pods = []
    for i in range(n):
        w = make_pod(f"a{i}").req({"cpu": "500m", "memory": "512Mi"})
        k = i % 4
        if k == 0:
            w = (w.label("app", "s")
                 .spread_constraint(2, ZONE, "ScheduleAnyway", {"app": "s"})
                 .spread_constraint(1, HOSTNAME, "ScheduleAnyway",
                                    {"app": "s"}))
        elif k == 1:
            w = w.label("app", "s").spread_constraint(1, HOSTNAME,
                                                      "ScheduleAnyway",
                                                      {"app": "s"})
        elif k == 2:
            w = w.label("anti", "y").pod_affinity(HOSTNAME, {"anti": "y"},
                                                  anti=True)
        else:
            w = w.label("app", "s").pod_affinity(ZONE, {"app": "s"})
        pods.append(w.obj())
    return pods


def _seeded():
    return [(make_pod(f"e{k}").req({"cpu": "1", "memory": "1Gi"})
             .label("app", "s").obj(), f"n{k}") for k in range(2)]


SCENARIOS = {"mixed": lambda: (_nodes(), [], mixed_pods(24)),
             "anyway": lambda: (_nodes(), _seeded(), anyway_pods(24)),
             "anyway_blocked": lambda: (_nodes(zones=6, blocked=True),
                                        _seeded(), anyway_pods(24))}


class Case:
    """One staged scenario in both packages' forms (numpy shared)."""

    def __init__(self, nodes, existing, pods, groups=True):
        (self.state, self.snap, self.builder,
         self.batch) = _staged(nodes, existing, pods)
        self.arrays = self.state.ensure_arrays()
        self.n = len(pods)
        self.table = self.builder.table
        self.jna = jp.NodeArrays(*(jnp.asarray(x) for x in self.arrays))
        self.jtab = jp.PodTableDev(*(jnp.asarray(getattr(self.table, f))
                                     for f in jp.PodTableDev._fields))
        self.tna = convert.node_arrays_from_numpy(self.arrays, "cpu")
        self.ttab = convert.pod_table_from_numpy(self.table, "cpu")
        self.gd_np = self.gc_np = None
        self.fam = tg.GroupFamilies(False, False, False, False, False)
        if groups:
            self.gd_np, self.gc_np = self.builder.groups.build_dev(self.snap)
            self.fam = tg.GroupFamilies(*self.builder.groups.families(
                self.snap))

    def jax_mesh(self, jmesh):
        na = js.shard_node_arrays(jmesh, self.jna)
        gd = gc = None
        if self.gd_np is not None:
            gd = js.shard_groups(jmesh, jg.to_device(self.gd_np))
            gc = js.shard_group_carry(jmesh, jg.to_device(self.gc_np))
        return na, jp.initial_carry(na, gc), gd

    def port_mesh(self, tmesh):
        na = convert.node_arrays_to_shards(self.arrays, tmesh)
        gd = gc = None
        if self.gd_np is not None:
            gd = ts.shard_groups(tmesh, self.gd_np)
            gc = ts.shard_group_carry(tmesh, self.gc_np)
        return na, ts.initial_carry_sharded(na, gc), gd

    def port_single(self):
        gd = gc = None
        if self.gd_np is not None:
            gd = convert.groups_dev_from_numpy(self.gd_np, "cpu")
            gc = convert.group_carry_from_numpy(self.gc_np, "cpu")
        return self.tna, tp.initial_carry(self.tna, gc), gd


def meshes(D):
    return js.make_mesh(D), ts.make_mesh(devices=["cpu"] * D)


def _eq(a, b, what=""):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b, err_msg=what)


def assert_carry(want, got, cache=True):
    """`want`: a JAX (mesh) carry or a port single-device carry; `got`:
    the port's carry shards. Every field, the group counts included."""
    whole = ts.unshard(got)
    for f in ("used", "nonzero_used", "npods", "ports"):
        _eq(getattr(want, f), getattr(whole, f), f)
    _eq(want.cache.sig, whole.cache.sig, "cache.sig")
    if cache and int(np.asarray(want.cache.sig)) != 0:
        for f in tp.SigCache._fields[1:]:
            _eq(getattr(want.cache, f), getattr(whole.cache, f), f)
    if want.groups is None:
        assert whole.groups is None
        return
    for f in tg.GroupCarry._fields:
        _eq(getattr(want.groups, f), getattr(whole.groups, f), f)


# ---------------------------------------------------------------------------
# run_batch_sharded's group mode


def _xs(batch, n):
    return (jp.PodXs(valid=batch.valid[:n], sig=batch.sig[:n],
                     tidx=batch.tidx[:n]),
            tp.PodXs(valid=torch.from_numpy(batch.valid[:n]),
                     sig=torch.from_numpy(batch.sig[:n]),
                     tidx=torch.from_numpy(batch.tidx[:n])))


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
@pytest.mark.parametrize("D", DS)
def test_run_batch_sharded_groups(D, scenario):
    c = Case(*SCENARIOS[scenario]())
    jx, tx = _xs(c.batch, c.n)
    jmesh, tmesh = meshes(D)
    jna, jc0, jgd = c.jax_mesh(jmesh)
    tna, tc0, tgd = c.port_mesh(tmesh)
    cfg = tp.ScoreConfig()
    jc, ja = js.run_batch_sharded(jp.ScoreConfig(), jmesh, jna, jc0, jx,
                                  c.jtab, groups=jgd,
                                  fam=jg.GroupFamilies(*c.fam))
    tc, ta = ts.run_batch_sharded(cfg, tmesh, tna, tc0, tx, c.ttab,
                                  groups=tgd, fam=c.fam)
    _eq(ja, ta, "assignments")
    assert_carry(jc, tc)
    assert (ta.numpy() >= 0).sum() > c.n // 2
    sna, sc0, sgd = c.port_single()
    sc, sa = tp.run_batch(cfg, sna, sc0, tx, c.ttab, groups=sgd, fam=c.fam)
    assert torch.equal(sa, ta)
    assert_carry(sc, tc)


# ---------------------------------------------------------------------------
# run_plan_sharded


def _layout(batch, m, S_min=2):
    """(wt_list, widx [bucket], valid [bucket]) as the scheduler's
    _wavescan_dispatch lays a span out."""
    uniq = list(dict.fromkeys(int(t) for t in batch.tidx[:m]))
    S = max(pow2_at_least(len(uniq), 2), S_min)
    wt = (uniq + [uniq[-1]] * S)[:S]
    slot = {}
    for s, u in enumerate(wt):
        slot.setdefault(u, s)
    bucket = pow2_at_least(m)
    widx = np.empty((bucket,), np.int32)
    widx[:m] = [slot[int(t)] for t in batch.tidx[:m]]
    widx[m:] = widx[m - 1]
    valid = np.zeros((bucket,), bool)
    valid[:m] = True
    return wt, widx, valid


def lean_pods(n, ports=False):
    rng = np.random.RandomState(5)
    pods = []
    for i in range(n):
        k = i % 5
        w = make_pod(f"l{i}").req({"cpu": f"{250 * (k + 1)}m",
                                   "memory": f"{256 * (k + 1)}Mi"})
        if k == 2:
            w = w.preferred_node_affinity_in(ZONE, ["z1"], weight=7)
        if ports and k == 4:
            w = w.host_port(8000 + int(rng.randint(0, 3)))
        pods.append(w.obj())
    return pods


PLANS = {
    "groups": lambda prefer: (_nodes(prefer=prefer), _seeded(),
                              mixed_pods(15) + anyway_pods(15), True),
    "lean": lambda prefer: (_nodes(prefer=prefer), [], lean_pods(30),
                            False),
    "ports": lambda prefer: (_nodes(prefer=prefer), [],
                             lean_pods(30, ports=True), False),
}


@pytest.mark.parametrize("norm_live", [False, True])
@pytest.mark.parametrize("variant", sorted(PLANS))
@pytest.mark.parametrize("D", DS)
def test_run_plan_sharded(D, variant, norm_live):
    nodes, existing, pods, groups = PLANS[variant](norm_live)
    c = Case(nodes, existing, pods, groups=groups)
    m = c.n
    wt, widx, valid = _layout(c.batch, m)
    has_ports = bool((c.batch.sig[:m] == 0).any())
    assert has_ports == (variant == "ports")
    jmesh, tmesh = meshes(D)
    jna, jc0, jgd = c.jax_mesh(jmesh)
    tna, tc0, tgd = c.port_mesh(tmesh)
    jwt = jnp.asarray(np.array(wt, np.int32))
    jst = jp.wave_statics(c.jna, c.jtab, jwt)
    tst = ts.wave_statics_sharded(tmesh, tna, c.ttab, wt)
    sst = tp.wave_statics(c.tna, c.ttab, wt)
    for k in range(4):
        _eq(np.asarray(jst[k]), torch.cat([x[k] for x in tst], dim=1))
    jst = tuple(js.jax.device_put(x, js.NamedSharding(
        jmesh, js.P(None, js.NODE_AXIS))) for x in jst)
    jfam = jg.GroupFamilies(*c.fam)
    jc, jpk = js.run_plan_sharded(
        jp.ScoreConfig(), jmesh, jna, jc0,
        jp.WaveXs(valid=jnp.asarray(valid), widx=jnp.asarray(widx)), c.jtab,
        jwt, jgd, jst, jfam, norm_live, has_groups=groups,
        has_ports=has_ports)
    xs = tp.WaveXs(valid=torch.from_numpy(valid), widx=torch.from_numpy(widx))
    cfg = tp.ScoreConfig()
    tc, tpk = ts.run_plan_sharded(cfg, tmesh, tna, tc0, xs, c.ttab, wt, tgd,
                                  tst, c.fam, norm_live, has_groups=groups,
                                  has_ports=has_ports)
    _eq(jpk, tpk, "packed")
    assert_carry(jc, tc)
    assert (tpk[:m].numpy() >= 0).sum() > m // 2
    sna, sc0, sgd = c.port_single()
    sc, spk = tp.run_plan(cfg, sna, sc0, xs, c.ttab, wt, sgd, sst, c.fam,
                          norm_live, has_groups=groups, has_ports=has_ports)
    assert torch.equal(spk, tpk)
    assert_carry(sc, tc)


# ---------------------------------------------------------------------------
# the helpers: unshard, then the single-device tensors


@pytest.mark.parametrize("D", DS)
def test_shard_groups_round_trip(D):
    """shard_groups / shard_group_carry cut the node-last fields along
    their last axis and replicate the rest; the domain ids stay global."""
    c = Case(*SCENARIOS["anyway"]())
    tmesh = ts.make_mesh(devices=["cpu"] * D)
    gd, gc = ts.shard_groups(tmesh, c.gd_np), ts.shard_group_carry(
        tmesh, c.gc_np)
    assert len(gd) == len(gc) == D
    n_local = N_BUCKET // D
    for d in range(D):
        assert gd[d].spr_f_tv.shape[-1] == n_local
        assert gd[d].m_spr_f.shape == c.gd_np.m_spr_f.shape
        assert gc[d].ipa_a_total.shape == c.gc_np.ipa_a_total.shape
    whole = ts.unshard(gd)
    for f in tg.GroupsDev._fields:
        _eq(getattr(c.gd_np, f), getattr(whole, f), f)
    whole = ts.unshard(gc)
    for f in tg.GroupCarry._fields:
        _eq(getattr(c.gc_np, f), getattr(whole, f), f)
    if D > 1:
        # a zone's dense id is its first node's GLOBAL index (zones
        # interleave: nodes 0-2): the shard holding node 23 keeps those
        # ids, outside its own rows
        d = 23 // n_local
        tv, dom = gd[d].spr_s_tv, gd[d].spr_s_dom
        assert (tv != 0).any()
        assert (dom[tv != 0] < 3).any()
    # a carry holding group counts shards them the same way
    carry = ts.shard_carry(tmesh, tp.initial_carry(
        c.tna, convert.group_carry_from_numpy(c.gc_np, "cpu")))
    whole = ts.unshard(carry)
    for f in tg.GroupCarry._fields:
        _eq(getattr(c.gc_np, f), getattr(whole.groups, f), f)


@pytest.mark.parametrize("D", DS)
def test_own_broadcasts_the_owners_values(D):
    """own: the owner's values on every shard, bools through int32."""
    mesh = ts.make_mesh(devices=["cpu"] * D)
    owner = D - 1
    vals = [torch.tensor([d + 1, -(d + 1)], dtype=torch.int64)
            for d in range(D)]
    flags = [torch.tensor([d % 2 == 0, True]) for d in range(D)]
    mine = [torch.tensor(d == owner) for d in range(D)]
    for d, got in enumerate(ts.own(mesh, vals, mine)):
        assert got.dtype == torch.int64
        assert got.tolist() == [owner + 1, -(owner + 1)]
    for got in ts.own(mesh, flags, mine):
        assert got.dtype == torch.bool
        assert got.tolist() == [owner % 2 == 0, True]
    # int32 stays int32 through the psum (XLA's)
    i32 = [torch.tensor([7], dtype=torch.int32) for _ in range(D)]
    assert ts.psum(mesh, i32)[0].dtype == torch.int32


@pytest.mark.parametrize("D", DS)
def test_scatter_new_rows_on_shards(D):
    """Rows interned while the group tensors are resident, written into
    each shard's slice of the row (node-last fields) and replicated
    (per-row scalars, pairwise matrices): unshard equals the
    single-device scatter."""
    from test_torch_groups import TORCH, _build
    builder, snap, _cache, later = _build(
        TORCH, "mixed", 7, ["anti_shared", "anyway", "affinity",
                            "preferred"] * 2, n_pods=3)
    gd_np, gc_np = builder.groups.build_dev(snap)
    lo = builder.table_used
    builder.build(later)
    hi = min(builder.table_used, builder.groups.device_rows(),
             gd_np.spr_f_active.shape[0])
    assert hi > lo
    gd1, gc1 = tg.scatter_new_rows(tg.to_device(gd_np, "cpu"),
                                   tg.to_device(gc_np, "cpu"),
                                   builder.groups, snap, lo, hi)
    mesh = ts.make_mesh(devices=["cpu"] * D)
    gdm, gcm = tg.scatter_new_rows(ts.shard_groups(mesh, gd_np),
                                   ts.shard_group_carry(mesh, gc_np),
                                   builder.groups, snap, lo, hi, mesh=mesh)
    assert len(gdm) == len(gcm) == D
    for want, got, fields in ((gd1, ts.unshard(gdm), tg.GroupsDev._fields),
                              (gc1, ts.unshard(gcm), tg.GroupCarry._fields)):
        for f in fields:
            assert torch.equal(getattr(want, f), getattr(got, f)), f


@pytest.mark.parametrize("feats", [(True, True, True), (False, False, False),
                                   (True, False, True)])
@pytest.mark.parametrize("D", (2, 8))
def test_wave_statics_sharded(D, feats):
    """The per-shard surfaces with the cluster-wide image counts (images
    on nodes of every shard; ImageLocality's spread is a psum): the
    concatenated shards equal the single-device surfaces."""
    from _torch_parity import lean_cluster, lean_pod, staged
    import random
    rng = random.Random(4)
    nodes = lean_cluster(rng, 24)
    pods = [lean_pod(rng, f"w{i}", ports=False) for i in range(8)]
    arrays, batch = staged(nodes, (), pods, n_bucket=N_BUCKET)
    rows = sorted(set(int(t) for t in batch.tidx[:8]))[:4]
    tna = convert.node_arrays_from_numpy(arrays, "cpu")
    ttab = convert.pod_table_from_numpy(batch.table, "cpu")
    mesh = ts.make_mesh(devices=["cpu"] * D)
    got = ts.wave_statics_sharded(mesh, ts.shard_node_arrays(mesh, arrays),
                                  ttab, rows, feats)
    want = tp.wave_statics(tna, ttab, rows, feats)
    assert len(got) == D
    for k in range(4):
        assert torch.equal(torch.cat([g[k] for g in got], dim=1), want[k])


@pytest.mark.parametrize("D", DS)
def test_group_mask_and_scores_on_shards(D):
    """The group collectives alone, on counts where the spread weights
    decide the scores: zones in contiguous blocks (a shard sees only some
    of them), seeded random counts. Every row's mask and weighted group
    scores over the shards (the pmin of the spread minima, the psum'd
    scored count and [SC, n_global] domain flags, the score ranges),
    concatenated, equal the single-device ones."""
    c = Case(*SCENARIOS["anyway_blocked"]())
    rng = np.random.RandomState(D)
    gc_np = c.gc_np._replace(
        spr_s_cnt=rng.randint(0, 6, c.gc_np.spr_s_cnt.shape).astype(np.int32),
        spr_f_cnt=rng.randint(0, 6, c.gc_np.spr_f_cnt.shape).astype(np.int32),
        ipa_score=rng.randint(-50, 50, c.gc_np.ipa_score.shape).astype(
            np.int64))
    gd1 = convert.groups_dev_from_numpy(c.gd_np, "cpu")
    gc1 = convert.group_carry_from_numpy(gc_np, "cpu")
    mesh = ts.make_mesh(devices=["cpu"] * D)
    gds, gcs = ts.shard_groups(mesh, c.gd_np), ts.shard_group_carry(mesh,
                                                                     gc_np)
    fam = tg.GroupFamilies(True, True, True, True, True)
    n_local = N_BUCKET // D
    base = torch.from_numpy(rng.rand(N_BUCKET) < 0.8)
    for u in range(len(c.builder.groups.rows)):
        v1 = tg.view_of(gd1, gc1, u)
        want_feas = base & tg.group_mask_view(v1, fam)
        want = tg.group_scores_view(3, 5, v1, want_feas, fam)
        views = [tg.view_of(gds[d], gcs[d], u) for d in range(D)]
        feas = ts.group_feasible(mesh, views, fam, [
            base[d * n_local:(d + 1) * n_local] for d in range(D)])
        assert torch.equal(torch.cat(feas), want_feas)
        glob = ts.score_globals(mesh, views, feas, fam, N_BUCKET)
        got = torch.cat([tg.group_scores_view(3, 5, views[d], feas[d], fam,
                                              glob[d]) for d in range(D)])
        assert torch.equal(got, want), u
