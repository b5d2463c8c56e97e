"""explain_row (decision provenance) and explain_pod: the port ↔ the JAX
package, exact equality.

`explain_row` cases build one seeded cluster and pending batch with the
JAX package's state layer; its numpy arrays go through the JAX
`explain_row` (jitted on the CPU) and, converted, through the port's
plain version, for every signature row of the batch and several k: the
top-k node indices, their masked totals (−1 = infeasible), the six
per-plugin columns and the feasible count must be equal, including k
above the feasible count (the lowest-index infeasible nodes follow) and
ties (the lowest index first). The lean variant reads no group tensors;
the group variant folds the spread and inter-pod mask and scores in.

The `explain_pod` cases run one workload through both schedulers and
hold the port's answer for bound and pending pods to the JAX package's
`obs.explain._explain_current` dict, `rendered` text included."""

import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import kubernetes_tpu  # noqa: F401  (x64 before any jnp array)
from _torch_parity import (lean_cluster, lean_pod,  # noqa: F401
                           private_jax_compiles)
from kubernetes_tpu.backend.cache import Cache, Snapshot
from kubernetes_tpu.obs import explain as jexplain
from kubernetes_tpu.ops import groups as jg
from kubernetes_tpu.ops import program as jp
from kubernetes_tpu.state.batch import BatchBuilder, BatchDims
from kubernetes_tpu.state.tensorize import ClusterState
from kubernetes_tpu.testing.wrappers import make_node, make_pod
from kubernetes_tpu_torch.obs import explain as texplain
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
    state.dims.nodes = max(32, state.dims.nodes)
    state.apply_snapshot(snap, full=True)
    builder = BatchBuilder(state, BatchDims(table_rows=64))
    batch = builder.build(pods)
    assert not batch.host_fallback.any()
    return state, snap, builder, batch


def explain_parity(nodes, bound, pods, groups: bool, ks=(1, 5, 16)):
    """explain_row of every distinct row of the batch at the staged carry,
    JAX vs the port, for each k; returns the port's outputs by (row, k)."""
    state, snap, builder, batch = _staged(nodes, bound, pods)
    a = state.ensure_arrays()
    jna = jp.NodeArrays(*(jnp.asarray(x) for x in a))
    jtab = jp.PodTableDev(*(jnp.asarray(getattr(builder.table, f))
                            for f in jp.PodTableDev._fields))
    tna = convert.node_arrays_from_numpy(a, "cpu")
    ttab = convert.pod_table_from_numpy(builder.table, "cpu")
    jgc = tgc = None
    kw_j = kw_t = {}
    if groups:
        gd_np, gc_np = builder.groups.build_dev(snap)
        fam = builder.groups.families(snap)
        jgc = jg.to_device(gc_np)
        tgc = convert.group_carry_from_numpy(gc_np, "cpu")
        kw_j = dict(gd=jg.to_device(gd_np), fam=fam)
        kw_t = dict(gd=convert.groups_dev_from_numpy(gd_np, "cpu"),
                    fam=tg.GroupFamilies(*fam))
    jcarry = jp.initial_carry(jna, jgc)
    tcarry = tp.initial_carry(tna, tgc)
    cfg_j, cfg_t = jp.ScoreConfig(), tp.ScoreConfig()
    out = {}
    for u in dict.fromkeys(int(t) for t in batch.tidx[:len(pods)]):
        for k in ks:
            j = jp.explain_row(cfg_j, jna, jcarry, jtab, u, k=k, **kw_j)
            t = tp.explain_row(cfg_t, tna, tcarry, ttab, u, k=k, **kw_t)
            for what, x, y, dt in zip(("idx", "totals", "cols", "count"),
                                      j, t, (torch.int32, torch.int64,
                                             torch.int64, torch.int32)):
                assert y.dtype == dt, what
                np.testing.assert_array_equal(np.asarray(x), y.numpy(),
                                              err_msg=f"row {u} k {k} {what}")
            out[(u, k)] = t
    return out


def _bound(name, node, cpu="1", labels=None, anti=None):
    w = make_pod(name).req({"cpu": cpu, "memory": "1Gi"}).node(node)
    for k, v in (labels or {}).items():
        w = w.label(k, v)
    if anti:
        w = w.pod_affinity(anti[0], anti[1], anti=True)
    return w.obj()


class TestExplainRowLean:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_random_lean_cluster(self, seed):
        rng = random.Random(seed)
        nodes = lean_cluster(rng, 24)
        bound = [_bound(f"b{i}", f"n{rng.randint(0, 23)}",
                        cpu=rng.choice(["500m", "2", "6"]))
                 for i in range(30)]
        pods = [lean_pod(rng, f"p{i}") for i in range(20)]
        pods.append(make_pod("huge").req({"cpu": "64"}).obj())
        out = explain_parity(nodes, bound, pods, groups=False)
        # some row has fewer feasible nodes than k = 16: its tail is the
        # lowest-index infeasible nodes at total −1
        short = [t for (u, k), t in out.items() if k == 16
                 and int(t[3]) < 16]
        assert short and all((t[1][int(t[3]):] == -1).all() for t in short)

    def test_ties_go_to_the_lowest_index(self):
        nodes = [make_node(f"n{i}").capacity({"cpu": 8, "memory": "16Gi"})
                 .obj() for i in range(10)]
        pods = [make_pod("p").req({"cpu": "1", "memory": "1Gi"}).obj()]
        out = explain_parity(nodes, [], pods, groups=False)
        idx, totals, _cols, count = out[(next(iter(out))[0], 16)]
        assert int(count) == 10
        assert idx[:10].tolist() == list(range(10))
        assert len(set(totals[:10].tolist())) == 1
        # past the feasible nodes: the padded rows, lowest index first
        assert idx[10:].tolist() == list(range(10, 16))
        assert (totals[10:] == -1).all()

    def test_no_feasible_node(self):
        nodes = [make_node(f"n{i}").capacity({"cpu": 2}).obj()
                 for i in range(4)]
        pods = [make_pod("big").req({"cpu": "8"}).obj()]
        out = explain_parity(nodes, [], pods, groups=False, ks=(1, 4))
        for t in out.values():
            assert int(t[3]) == 0 and (t[1] == -1).all()


class TestExplainRowGroups:
    def test_spread_and_affinity_columns(self):
        nodes = [make_node(f"n{i}").capacity({"cpu": 8}).zone(f"z{i % 3}")
                 .label(HOSTNAME, f"n{i}").obj() for i in range(9)]
        nodes.append(make_node("keyless").capacity({"cpu": 8}).obj())
        bound = [_bound("db", "n0", labels={"app": "db"}),
                 _bound("s0", "n1", labels={"app": "s"}),
                 _bound("s1", "n4", labels={"app": "s"}),
                 _bound("guard", "n2", labels={"role": "g"},
                        anti=(ZONE, {"app": "web"}))]
        pods = [make_pod("spread").req({"cpu": "1"}).label("app", "s")
                .spread_constraint(1, ZONE, "ScheduleAnyway", {"app": "s"})
                .obj(),
                make_pod("aff").req({"cpu": "1"}).label("app", "x")
                .pod_affinity(ZONE, {"app": "db"}).obj(),
                make_pod("web").req({"cpu": "1"}).label("app", "web")
                .obj()]
        out = explain_parity(nodes, bound, pods, groups=True)
        assert any((t[2][:, 5] != 0).any() for t in out.values())

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
                w = w.spread_constraint(2, ZONE, "ScheduleAnyway",
                                        {"app": "b"})
            elif k == 2:
                w = w.pod_affinity(ZONE, {"app": "a"}, anti=True)
            pods.append(w.obj())
        explain_parity(nodes, bound, pods, groups=True)


# ---------------------------------------------------------------------------
# explain_pod through the schedulers


def _explain_run(pkg, spread: bool):
    w, Api = pkg[0], pkg[1]
    api = Api()
    sched = make_scheduler(pkg, api, 32)
    for i in range(10):
        nd = w.make_node(f"n{i}").capacity(
            {"cpu": 4 + 4 * (i % 3), "memory": "16Gi", "pods": 110}).zone(
            f"z{i % 3}").label(HOSTNAME, f"n{i}")
        if i % 4 == 1:
            nd = nd.taint("spot", "", effect="PreferNoSchedule")
        api.create_node(nd.obj())
    sched.prime()
    pods = []
    for i in range(24):
        p = w.make_pod(f"p{i}").req({"cpu": ["500m", "1", "2"][i % 3],
                                     "memory": "1Gi"})
        if spread:
            p = p.label("app", "s").spread_constraint(
                1, ZONE, "ScheduleAnyway", {"app": "s"})
        if i % 5 == 0:
            p = p.preferred_node_affinity_in(ZONE, ["z1"], weight=5)
        pods.append(p.obj())
    pods.append(w.make_pod("huge").req({"cpu": "64"}).obj())
    api.create_pods(pods)
    sched.schedule_pending()
    return sched


@pytest.mark.parametrize("spread", [False, True], ids=["lean", "groups"])
def test_explain_pod_matches_the_jax_package(spread):
    js = _explain_run(JAX, spread)
    ts = _explain_run(TORCH, spread)
    uids = ["default/p0", "default/p7", "default/p23", "default/huge",
            "default/missing"]
    for uid in uids:
        for k in (1, 5, 16):
            want = jexplain.explain_pod(js, uid, k=k)
            got = texplain.explain_pod(ts, uid, k=k)
            assert got == want, (uid, k)
    got = texplain.explain_pod(ts, "default/p7", k=3)
    assert got["mode"] == "current_state" and got["boundNode"]
    assert got["selfExcluded"]["resources"]
    # a bound pod's own nodeName pins its row to the bound node (the JAX
    # package answers the same)
    assert got["winner"]["node"] == got["boundNode"]
    assert got["feasibleNodes"] == 1 and got["runnersUp"] == []
    assert got["rendered"].startswith("pod default/p7: bound to ")
    assert texplain.explain_pod(ts, "default/huge")["winner"] is None
