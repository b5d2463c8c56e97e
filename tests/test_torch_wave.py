"""wave_statics, run_wave and run_batch with groups: the port's plain
versions ↔ the JAX programs, exact equality.

Each case builds one seeded cluster and pending batch with the JAX
package's state layer; its numpy arrays (NodeArrays, PodTable, GroupsDev,
GroupCarry) go through the JAX program on the CPU and, converted, through
the port's plain PyTorch version. Everything compared is integer or a
float64 value rounded the same way, so the tolerance is exact equality:
the assignments, the four wave stats (merge waves, conflict cuts, first
prefix, serial steps), every carry field and the whole group carry,
dtypes included. The scenario families are those of
tests/test_wave_parity.py."""

import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_parity import private_jax_compiles  # noqa: F401
from kubernetes_tpu.backend.cache import Cache, Snapshot
from kubernetes_tpu.ops import program as jp
from kubernetes_tpu.ops.groups import to_device
from kubernetes_tpu.ops.hostgreedy import static_norm_ok
from kubernetes_tpu.state.batch import BatchBuilder
from kubernetes_tpu.state.tensorize import ClusterState, pow2_at_least
from kubernetes_tpu.testing.wrappers import make_node, make_pod
from kubernetes_tpu_torch.ops import groups as tg
from kubernetes_tpu_torch.ops import program as tp
from kubernetes_tpu_torch.state import convert

ZONE = "topology.kubernetes.io/zone"
HOSTNAME = "kubernetes.io/hostname"

torch.set_num_threads(1)


def _nodes(n, zones, cpu=16, unique_zone=False, prefer=False):
    out = []
    for i in range(n):
        b = (make_node(f"n{i}").capacity({"cpu": cpu, "memory": "32Gi",
                                          "pods": 40})
             .zone(f"z{i if unique_zone else i % zones}")
             .label(HOSTNAME, f"n{i}"))
        if prefer and i < n // 2:
            b = b.taint("dedic", "x", "PreferNoSchedule")
        out.append(b.obj())
    return out


def _spread(i, skew, cpu="1", key=ZONE, app="a", mem="1Gi"):
    return (make_pod(f"p{app}{i}").req({"cpu": cpu, "memory": mem})
            .label("app", app)
            .spread_constraint(skew, key, "DoNotSchedule", {"app": app})
            .obj())


def _anti(i, key=ZONE, second=None):
    w = (make_pod(f"q{i}").req({"cpu": "1", "memory": "1Gi"})
         .label("anti", "y").label("side", "y")
         .pod_affinity(key, {"anti": "y"}, anti=True))
    if second:
        w = w.pod_affinity(second, {"side": "y"}, anti=True)
    return w.obj()


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
    state.apply_snapshot(snap, full=True)
    builder = BatchBuilder(state)
    batch = builder.build(pods)
    assert not batch.host_fallback.any()
    return state, snap, builder, batch


def _anti_term_of(mgr, u):
    terms = [t for t in range(mgr.m_ipa_aa.shape[2])
             if mgr.m_ipa_aa[u, u, t] or mgr.m_ipa_exist[u, u, t]]
    return (terms[0] if len(terms) == 1 else -1), len(terms) <= 1


def _both_tables(state, builder, snap):
    a = state.ensure_arrays()
    gd_np, gc_np = builder.groups.build_dev(snap)
    fam = builder.groups.families(snap)
    jna = jp.NodeArrays(*(jnp.asarray(x) for x in a))
    jtab = jp.PodTableDev(*(jnp.asarray(getattr(builder.table, f))
                            for f in jp.PodTableDev._fields))
    tna = convert.node_arrays_from_numpy(a, "cpu")
    ttab = convert.pod_table_from_numpy(builder.table, "cpu")
    return (jna, jtab, to_device(gd_np), to_device(gc_np), fam, tna, ttab,
            convert.groups_dev_from_numpy(gd_np, "cpu"),
            convert.group_carry_from_numpy(gc_np, "cpu"),
            tg.GroupFamilies(*fam))


def _assert_groups(jgc, tgc):
    for f in tg.GroupCarry._fields:
        a, b = np.asarray(getattr(jgc, f)), getattr(tgc, f).numpy()
        assert a.dtype == b.dtype, (f, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f)


def wave_parity(nodes, existing, pods, n_wave=None, cfg_kw=None, J=8,
                merge_on=True):
    """run_wave of the batch's first signature over its first `n_wave`
    pods (all by default), JAX vs the port; returns the four stats."""
    state, snap, builder, batch = _staged(nodes, existing, pods)
    (jna, jtab, jgd, jgc, fam, tna, ttab, tgd, tgc,
     tfam) = _both_tables(state, builder, snap)
    n = n_wave or len(pods)
    u = int(batch.tidx[0])
    assert (batch.tidx[:n] == u).all()
    anti, merge_ok = _anti_term_of(builder.groups, u)
    merge = merge_on and merge_ok
    B = pow2_at_least(n)
    valid = np.zeros((B,), bool)
    valid[:n] = True
    K = min(B, jna.cap.shape[0])
    Lw = min(512, B, K * J)
    norm_live = not static_norm_ok(state.ensure_arrays(),
                                   builder.table.pref_weight[u])
    jcfg = jp.ScoreConfig(**(cfg_kw or {}))
    tcfg = tp.ScoreConfig(**(cfg_kw or {}))
    jst = jp.wave_statics(jna, jtab, jnp.asarray(np.array([u], np.int32)))
    jst = tuple(x[0] for x in jst)
    tst = tuple(x[0] for x in tp.wave_statics(tna, ttab, [u]))
    for a, b in zip(jst, tst):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    jc, jpk = jp.run_wave(jcfg, jna, jp.initial_carry(jna, jgc),
                          jnp.asarray(valid), jtab, jnp.int32(u), jgd, jst,
                          K, J, fam, norm_live, anti_term=anti,
                          merge_on=merge, Lw=Lw)
    tcarry = tp.initial_carry(tna, tgc)
    tc, tpk = tp.run_wave(tcfg, tna, tcarry, torch.from_numpy(valid), ttab,
                          u, tgd, tst, K, J, tfam, norm_live,
                          anti_term=anti, merge_on=merge, Lw=Lw)
    np.testing.assert_array_equal(np.asarray(jpk), tpk.numpy())
    assert tpk.dtype == torch.int32
    for f in ("used", "nonzero_used", "npods", "ports"):
        np.testing.assert_array_equal(np.asarray(getattr(jc, f)),
                                      getattr(tc, f).numpy(), err_msg=f)
    # the cache label resets to 0 after a wave; ports are never written
    assert int(jc.cache.sig) == int(tc.cache.sig) == 0
    assert tc.ports is tcarry.ports
    _assert_groups(jc.groups, tc.groups)
    assert tc.groups.ipa_a_total.dtype == torch.int64
    assert tc.groups.ipa_score.dtype == torch.int64
    waves, confs, prefix, serial = (int(x) for x in tpk[B:])
    return dict(waves=waves, confs=confs, prefix=prefix, serial=serial,
                norm_live=norm_live, out=tpk[:n].numpy())


class TestRunWaveFamilies:
    def test_merge_spread_tight_skew(self):
        st = wave_parity(_nodes(9, 3), [], [_spread(i, 1)
                                            for i in range(14)])
        assert (st["out"] >= 0).all()
        assert st["serial"] > 0 or st["confs"] > 0

    def test_merge_spread_slack_skew(self):
        st = wave_parity(_nodes(12, 4, cpu=64), [],
                         [_spread(i, 5, cpu="500m", mem="512Mi")
                          for i in range(24)])
        assert st["confs"] == 0 and st["serial"] == 0
        assert st["prefix"] == 24

    def test_spread_hostname_key(self):
        wave_parity(_nodes(8, 4), [], [_spread(i, 2, key=HOSTNAME)
                                       for i in range(16)])

    def test_merge_anti_unique_domains(self):
        st = wave_parity(_nodes(12, 12, unique_zone=True), [],
                         [_anti(i) for i in range(10)], J=1)
        assert (st["out"] >= 0).all()
        assert st["confs"] == 0 and st["serial"] == 0

    def test_merge_anti_shared_domains_with_existing(self):
        ex = [(_anti(100 + i), f"n{i}") for i in range(2)]
        st = wave_parity(_nodes(12, 6), ex, [_anti(i) for i in range(10)])
        # 6 zones, 2 taken: four pods place, the rest fail
        assert (st["out"] >= 0).sum() == 4

    def test_two_self_anti_terms_serial(self):
        st = wave_parity(_nodes(12, 6), [],
                         [_anti(i, second=HOSTNAME) for i in range(10)])
        # two self-matching anti terms: no merge wave at all
        assert st["waves"] == 0 and st["prefix"] == -1
        assert st["serial"] == 10

    def test_prefer_no_schedule_norm_live(self):
        st = wave_parity(_nodes(8, 4, prefer=True), [],
                         [_spread(i, 2) for i in range(12)])
        # PreferNoSchedule taints renormalize every step: merge_on and not
        # norm_live gates the merge tier, first_prefix stays -1
        assert st["norm_live"]
        assert st["waves"] == 0 and st["prefix"] == -1
        assert st["serial"] == 12

    def test_merge_off(self):
        st = wave_parity(_nodes(9, 3), [], [_spread(i, 2)
                                            for i in range(12)],
                         merge_on=False)
        assert st["waves"] == 0 and st["prefix"] == -1

    def test_capacity_exhausted_tail(self):
        st = wave_parity(_nodes(3, 3, cpu=8), [],
                         [_spread(i, 2, cpu="7") for i in range(12)])
        assert (st["out"][-4:] == -1).all()

    def test_all_conflict_wave(self):
        st = wave_parity(_nodes(4, 2, cpu=6), [],
                         [_spread(i, 1, cpu="2") for i in range(10)])
        assert st["serial"] + st["prefix"] + st["confs"] > 0

    @pytest.mark.parametrize("w_image", [1, 3_000_000])
    def test_key_width(self, w_image):
        """The JAX program narrows the merge keys to int32 when
        (score_max + 2)·N·J < 2³¹ (w_image = 1 here) and keeps int64
        otherwise (w_image = 3e6); the port's int64 keys give the same
        order in both."""
        score_max = 100 * (1 + 1 + 3 + 2 + w_image)
        N, J = 16, 8
        assert ((score_max + 2) * N * J < 2 ** 31) == (w_image == 1)
        pods = [make_pod(f"k{i}").req({"cpu": "1", "memory": "1Gi"})
                .label("app", "a").container({"cpu": "100m"},
                                             image="nginx:1")
                .spread_constraint(3, ZONE, "DoNotSchedule", {"app": "a"})
                .obj() for i in range(20)]
        nodes = []
        for i in range(12):
            w = (make_node(f"n{i}").capacity({"cpu": 16, "memory": "32Gi",
                                              "pods": 40})
                 .zone(f"z{i % 4}").label(HOSTNAME, f"n{i}"))
            if i % 3 == 0:
                w = w.image("nginx:1", 300 << 20)
            nodes.append(w.obj())
        wave_parity(nodes, [], pods, cfg_kw={"w_image": w_image}, J=J)

    def test_cross_row_counts_move_through_wave_fold(self):
        """Another pending signature counts the wave row's pods (its
        selector matches them): only wave_fold moves its counts."""
        pods = [_spread(i, 2) for i in range(16)]
        pods += [_spread(100 + i, 5, cpu="250m") for i in range(4)]
        wave_parity(_nodes(10, 5), [], pods, n_wave=16)


@pytest.mark.parametrize("feats", [(True, True, True), (False, True, False),
                                   (True, False, True), (False, False,
                                                         False)])
def test_wave_statics_equal(feats):
    rng = random.Random(11)
    nodes = []
    for i in range(20):
        w = make_node(f"n{i}").capacity({"cpu": 8, "pods": 20}).zone(
            f"z{i % 3}")
        if rng.random() < 0.3:
            w = w.taint("dedicated", "x", effect=rng.choice(
                ["NoSchedule", "PreferNoSchedule"]))
        if rng.random() < 0.4:
            w = w.label("disk", "ssd")
        if rng.random() < 0.5:
            w = w.image("nginx:1", 300 << 20)
        if rng.random() < 0.1:
            w = w.unschedulable()
        nodes.append(w.obj())
    pods = [
        make_pod("a").req({"cpu": "1"}).node_selector({"disk": "ssd"}).obj(),
        make_pod("b").req({"cpu": "1"}).toleration(
            key="dedicated", operator="Exists").obj(),
        make_pod("c").req({"cpu": "1"}).preferred_node_affinity_in(
            ZONE, ["z1"], 4).container({"cpu": "1"}, image="nginx:1").obj(),
        make_pod("d").req({"cpu": "1"}).node("n3").obj(),
    ]
    state, snap, builder, batch = _staged(nodes, [], pods)
    (jna, jtab, *_rest) = _both_tables(state, builder, snap)
    tna, ttab = _rest[3], _rest[4]
    rows = [int(t) for t in batch.tidx[:4]]
    jout = jp.wave_statics(jna, jtab, jnp.asarray(np.array(rows, np.int32)),
                           feats)
    tout = tp.wave_statics(tna, ttab, rows, feats)
    for a, b in zip(jout, tout):
        assert np.asarray(a).dtype == b.numpy().dtype
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def _fuzz_pods(rng, n):
    out = []
    for i in range(n):
        kind = rng.randint(0, 5)
        w = make_pod(f"f{i}").req({"cpu": rng.choice(["250m", "1", "2"]),
                                   "memory": "512Mi"})
        if kind == 0:
            w = w.label("app", "s").spread_constraint(
                rng.choice([1, 2]), ZONE, "DoNotSchedule", {"app": "s"})
        elif kind == 1:
            w = w.label("app", "s").spread_constraint(
                2, rng.choice([ZONE, HOSTNAME]), "ScheduleAnyway",
                {"app": "s"})
        elif kind == 2:
            w = w.label("anti", "y").pod_affinity(ZONE, {"anti": "y"},
                                                  anti=True)
        elif kind == 3:
            w = w.label("app", "s").pod_affinity(ZONE, {"app": "s"})
        elif kind == 4:
            w = w.preferred_pod_affinity(ZONE, {"app": "s"},
                                         rng.randint(1, 9))
        out.append(w.obj())
    return out


@pytest.mark.parametrize("seed", range(4))
def test_run_batch_with_groups_equal(seed):
    rng = random.Random(seed)
    nodes = _nodes(rng.randint(6, 14), rng.randint(2, 4),
                   cpu=rng.choice([4, 8]), prefer=seed % 2 == 1)
    existing = [(make_pod(f"e{k}").req({"cpu": "1", "memory": "1Gi"})
                 .label("app", "s").obj(), f"n{k}") for k in range(2)]
    pods = _fuzz_pods(rng, 24)
    state, snap, builder, batch = _staged(nodes, existing, pods)
    (jna, jtab, jgd, jgc, fam, tna, ttab, tgd, tgc,
     tfam) = _both_tables(state, builder, snap)
    xs = jp.PodXs(valid=jnp.asarray(batch.valid), sig=jnp.asarray(batch.sig),
                  tidx=jnp.asarray(batch.tidx))
    jc, ja = jp.run_batch(jp.ScoreConfig(), jna, jp.initial_carry(jna, jgc),
                          xs, jtab, groups=jgd, fam=fam)
    txs = convert.pod_xs_from_numpy(tp.PodXs(batch.valid, batch.sig,
                                             batch.tidx), "cpu")
    tc, ta = tp.run_batch(tp.ScoreConfig(), tna, tp.initial_carry(tna, tgc),
                          txs, ttab, groups=tgd, fam=tfam)
    np.testing.assert_array_equal(np.asarray(ja), ta.numpy())
    for f in ("used", "nonzero_used", "npods", "ports"):
        np.testing.assert_array_equal(np.asarray(getattr(jc, f)),
                                      getattr(tc, f).numpy(), err_msg=f)
    _assert_groups(jc.groups, tc.groups)


def test_run_batch_refuses_a_half_group_call():
    state, snap, builder, batch = _staged(_nodes(4, 2), [],
                                          [_spread(0, 1)])
    (_jna, _jtab, _jgd, _jgc, _fam, tna, ttab, tgd, tgc,
     tfam) = _both_tables(state, builder, snap)
    txs = convert.pod_xs_from_numpy(tp.PodXs(batch.valid, batch.sig,
                                             batch.tidx), "cpu")
    with pytest.raises(ValueError, match="go together"):
        tp.run_batch(tp.ScoreConfig(), tna, tp.initial_carry(tna), txs,
                     ttab, groups=tgd, fam=tfam)


@pytest.mark.parametrize("seed", range(3))
def test_top_k_ties_go_to_the_lowest_index(seed):
    """run_wave's candidates: lax.top_k over masked totals cast to int32
    (many ties, -1 for infeasible nodes) — the port's key sort must pick
    the same indices in the same order."""
    from jax import lax
    rs = np.random.RandomState(seed)
    vals = rs.choice([-1, 3, 7, 7, 7, 12], size=64).astype(np.int64)
    for k in (1, 5, 17, 64):
        _, want = lax.top_k(jnp.asarray(vals.astype(np.int32)), k)
        got = tp._topk_lowest_index(torch.from_numpy(vals), k)
        np.testing.assert_array_equal(np.asarray(want), got.numpy())
