"""kubernetes_tpu_torch/ops/groups.py ↔ kubernetes_tpu/ops/groups.py, exact.

The host half (GroupManager) runs in both packages on clusters built from
the same seed with each package's own testing wrappers: the GroupsDev and
GroupCarry tensors of `build_dev`, the `families` flags and the rows
`scatter_new_rows` seeds must be equal. The device half (group_mask,
group_scores, group_update, wave_fold) runs on the JAX package's numpy
tensors, handed to both: the JAX functions on the CPU, the port's plain
PyTorch versions. Counts are integers and the spread score's float64 terms
round the same way, so the tolerance is exact equality, dtypes included.
"""

import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_parity import private_jax_compiles  # noqa: F401
from kubernetes_tpu.backend.cache import Cache as JCache, Snapshot as JSnap
from kubernetes_tpu.ops import groups as jg
from kubernetes_tpu.state.batch import BatchBuilder as JBuilder
from kubernetes_tpu.state.tensorize import ClusterState as JState
from kubernetes_tpu.testing import wrappers as jw
from kubernetes_tpu_torch.backend.cache import Cache as TCache
from kubernetes_tpu_torch.backend.cache import Snapshot as TSnap
from kubernetes_tpu_torch.ops import groups as tg
from kubernetes_tpu_torch.state import convert
from kubernetes_tpu_torch.state.batch import BatchBuilder as TBuilder
from kubernetes_tpu_torch.state.tensorize import ClusterState as TState
from kubernetes_tpu_torch.testing import wrappers as tw

ZONE = "topology.kubernetes.io/zone"
HOSTNAME = "kubernetes.io/hostname"
JAX = (jw, JCache, JSnap, JState, JBuilder, jg)
TORCH = (tw, TCache, TSnap, TState, TBuilder, tg)


def _nodes(w, rng, n, zones):
    out = []
    for i in range(n):
        b = (w.make_node(f"n{i}").capacity(
            {"cpu": rng.choice([8, 16]), "memory": "32Gi", "pods": 40})
            .label(HOSTNAME, f"n{i}"))
        if rng.random() < 0.9:          # some nodes miss the zone key
            b = b.zone(f"z{rng.randint(0, zones - 1)}")
        if rng.random() < 0.15:
            b = b.taint("dedicated", "x", effect="NoSchedule")
        out.append(b.obj())
    return out


def _pod(w, rng, name, kind):
    p = w.make_pod(name).req({"cpu": rng.choice(["250m", "1"]),
                              "memory": "512Mi"})
    if kind == "spread":
        return p.label("app", "s").spread_constraint(
            rng.choice([1, 2, 5]), ZONE, "DoNotSchedule", {"app": "s"}).obj()
    if kind == "anyway":
        return p.label("app", "s").spread_constraint(
            2, ZONE, "ScheduleAnyway", {"app": "s"}).obj()
    if kind == "hostname":
        return p.label("app", "h").spread_constraint(
            1, HOSTNAME, rng.choice(["DoNotSchedule", "ScheduleAnyway"]),
            {"app": "h"}).obj()
    if kind == "affinity":
        return p.label("app", "s").pod_affinity(ZONE, {"app": "s"}).obj()
    if kind == "anti_unique":
        return p.label("anti", "u").pod_affinity(
            HOSTNAME, {"anti": "u"}, anti=True).obj()
    if kind == "anti_shared":
        return p.label("anti", "z").pod_affinity(
            ZONE, {"anti": "z"}, anti=True).obj()
    if kind == "preferred":
        return p.preferred_pod_affinity(ZONE, {"app": "s"},
                                        rng.randint(1, 9)).obj()
    return p.obj()


SCENARIOS = {
    # name: (kinds of the pending pods, kinds of the bound pods)
    "spread": (["spread", "plain"], ["plain"]),
    "schedule_anyway": (["anyway", "spread"], ["spread"]),
    "hostname": (["hostname", "plain"], ["hostname"]),
    "affinity": (["affinity", "spread"], ["plain", "affinity"]),
    "anti_unique": (["anti_unique", "plain"], []),
    "anti_shared": (["anti_shared", "spread"], ["anti_shared"]),
    "preferred": (["preferred", "anyway"], ["plain"]),
    "existing_anti": (["plain", "spread"], ["anti_shared", "anti_unique"]),
    "mixed": (["spread", "anyway", "affinity", "anti_shared", "preferred",
               "hostname"], ["spread", "anti_unique", "affinity"]),
}


def _build(pkg, scenario, seed, extra=(), n_pods=12):
    """One package's cluster, builder and snapshot for `scenario`; `extra`
    pod kinds are returned unbuilt (for the scatter_new_rows test)."""
    w, Cache, Snapshot, State, Builder, _g = pkg
    rng = random.Random(seed)
    kinds, bound_kinds = SCENARIOS[scenario]
    nodes = _nodes(w, rng, rng.randint(6, 14), rng.randint(2, 4))
    cache = Cache()
    for nd in nodes:
        cache.add_node(nd)
    for k, kind in enumerate(bound_kinds * 2):
        p = _pod(w, rng, f"b{k}", kind)
        p.spec.node_name = nodes[rng.randint(0, len(nodes) - 1)].name
        cache.add_pod(p)
    snap = Snapshot()
    cache.update_snapshot(snap)
    state = State()
    state.dims.nodes = 16
    state.apply_snapshot(snap, full=True)
    builder = Builder(state)
    pods = [_pod(w, rng, f"p{i}", rng.choice(kinds)) for i in range(n_pods)]
    builder.build(pods)
    later = [_pod(w, rng, f"q{i}", kind) for i, kind in enumerate(extra)]
    return builder, snap, cache, later


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_tree(a, b, fields):
    for f in fields:
        x, y = _np(getattr(a, f)), _np(getattr(b, f))
        assert x.dtype == y.dtype, (f, x.dtype, y.dtype)
        assert x.shape == y.shape, (f, x.shape, y.shape)
        np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_build_dev_and_families_equal(scenario, seed):
    jb, jsnap, _, _ = _build(JAX, scenario, seed)
    tb, tsnap, _, _ = _build(TORCH, scenario, seed)
    jgd, jgc = jb.groups.build_dev(jsnap)
    tgd, tgc = tb.groups.build_dev(tsnap)
    _assert_tree(jgd, tgd, tg.GroupsDev._fields)
    _assert_tree(jgc, tgc, tg.GroupCarry._fields)
    assert tuple(jb.groups.families(jsnap)) == tuple(
        tb.groups.families(tsnap))
    np.testing.assert_array_equal(jb.groups.interacts, tb.groups.interacts)
    assert jb.groups.device_rows() == tb.groups.device_rows()


def test_dense_domain_id_is_first_node_of_the_value():
    """dom[n] is the row index of the first node (snapshot order) sharing
    n's topology value — the segment slot wave_fold scatters into."""
    tb, tsnap, _, _ = _build(TORCH, "spread", 0)
    gd, _gc = tb.groups.build_dev(tsnap)
    u = next(u for u, r in enumerate(tb.groups.rows)
             if r is not None and r.f_constraints)
    tv, dom = gd.spr_f_tv[u, 0], gd.spr_f_dom[u, 0]
    order = [tb.state.node_index[ni.name]
             for ni in tsnap.node_info_list]
    first = {}
    for idx in order:
        first.setdefault(int(tv[idx]), idx)
    for idx in order:
        assert dom[idx] == first[int(tv[idx])]


def _both(scenario, seed):
    """The JAX package's numpy group tensors, as jnp and as torch."""
    jb, jsnap, _, _ = _build(JAX, scenario, seed)
    gd_np, gc_np = jb.groups.build_dev(jsnap)
    fam = jb.groups.families(jsnap)
    return (jg.to_device(gd_np), jg.to_device(gc_np),
            convert.groups_dev_from_numpy(gd_np, "cpu"),
            convert.group_carry_from_numpy(gc_np, "cpu"),
            fam, tg.GroupFamilies(*fam), jb)


def _bump(gc_np, rs):
    """Counts moved off their seeds, so the functions see nonzero minima,
    vetoes and score surfaces."""
    out = {}
    for f in tg.GroupCarry._fields:
        x = np.asarray(gc_np[f] if isinstance(gc_np, dict)
                       else getattr(gc_np, f)).copy()
        if x.dtype == np.int32 and f != "ipa_veto":
            x += rs.randint(0, 3, x.shape).astype(np.int32)
        elif f == "ipa_score":
            x += rs.randint(-20, 40, x.shape).astype(np.int64)
        out[f] = x
    return out


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("scenario", ["spread", "schedule_anyway",
                                      "affinity", "anti_shared",
                                      "preferred", "mixed"])
def test_mask_scores_update_equal(scenario, seed):
    jgd, jgc, tgd, tgc, jfam, tfam, jb = _both(scenario, seed)
    rs = np.random.RandomState(seed)
    bumped = _bump(jgc, rs)
    jgc = jg.GroupCarry(**{k: jnp.asarray(v) for k, v in bumped.items()})
    tgc = convert.group_carry_from_numpy(jg.GroupCarry(**bumped), "cpu")
    U, N = tgd.spr_f_active.shape[0], tgd.spr_f_tv.shape[2]
    for u in range(min(U, jb.table_used)):
        jm = np.asarray(jg.group_mask(jgd, jgc, u, fam=jfam))
        tm = tg.group_mask(tgd, tgc, u, fam=tfam)
        np.testing.assert_array_equal(jm, tm.numpy())
        feas = rs.rand(N) < 0.7
        js = np.asarray(jg.group_scores(2, 2, jgd, jgc, u,
                                        jnp.asarray(feas), fam=jfam))
        ts = tg.group_scores(2, 2, tgd, tgc, u, torch.from_numpy(feas),
                             fam=tfam)
        assert js.dtype == ts.numpy().dtype
        np.testing.assert_array_equal(js, ts.numpy())
        best = int(rs.randint(0, N))
        gate = bool(rs.rand() < 0.8)
        ju = jg.group_update(
            jgd, jgc, u, pick=lambda arr: arr[..., best],
            is_chosen=jnp.arange(N) == best, gate=jnp.bool_(gate),
            fam=jfam)
        tu = tg.group_update(tgd, tgc, u, torch.tensor(best),
                             torch.tensor(gate), fam=tfam)
        _assert_tree(ju, tu, tg.GroupCarry._fields)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("scenario", ["spread", "schedule_anyway",
                                      "affinity", "anti_shared", "mixed"])
def test_wave_fold_equal(scenario, seed):
    jgd, jgc, tgd, tgc, jfam, tfam, jb = _both(scenario, seed)
    rs = np.random.RandomState(100 + seed)
    U, N = tgd.spr_f_active.shape[0], tgd.spr_f_tv.shape[2]
    rows = min(U, jb.table_used)
    for S in (1, 2):
        wt = [int(x) for x in rs.randint(0, rows, S)]
        cnt = rs.randint(0, 3, (S, N)).astype(np.int32)
        jf = jg.wave_fold(jgd, jgc, jnp.asarray(np.array(wt, np.int32)),
                          jnp.asarray(cnt), fam=jfam)
        tf = tg.wave_fold(tgd, tgc, wt, torch.from_numpy(cnt), fam=tfam)
        _assert_tree(jf, tf, tg.GroupCarry._fields)


@pytest.mark.parametrize("scenario,n_pods", [("spread", 1), ("mixed", 3),
                                             ("existing_anti", 5)])
def test_scatter_new_rows_equal(scenario, n_pods):
    """Rows interned while the group tensors are resident: seeded into the
    free rows of the device row capacity (the scheduler reseeds instead
    when the pow2 capacity is crossed)."""
    extra = ["anti_shared", "anyway", "affinity", "preferred"] * 2
    outs = []
    for pkg in (JAX, TORCH):
        builder, snap, cache, later = _build(pkg, scenario, 7, extra,
                                             n_pods=n_pods)
        gd_np, gc_np = builder.groups.build_dev(snap)
        lo = builder.table_used
        builder.build(later)
        hi = min(builder.table_used, builder.groups.device_rows(),
                 gd_np.spr_f_active.shape[0])
        assert hi > lo
        g = pkg[5]
        if pkg is JAX:
            gd, gc = g.to_device(gd_np), g.to_device(gc_np)
            gd, gc = g.scatter_new_rows(gd, gc, builder.groups, snap, lo, hi)
        else:
            gd, gc = g.to_device(gd_np, "cpu"), g.to_device(gc_np, "cpu")
            gd, gc = g.scatter_new_rows(gd, gc, builder.groups, snap, lo,
                                        hi)
        outs.append((gd, gc))
    (jgd, jgc), (tgd, tgc) = outs
    _assert_tree(jgd, tgd, tg.GroupsDev._fields)
    _assert_tree(jgc, tgc, tg.GroupCarry._fields)


def test_to_device_keeps_dtypes():
    tb, tsnap, _, _ = _build(TORCH, "mixed", 1)
    gd_np, gc_np = tb.groups.build_dev(tsnap)
    gd = tg.to_device(gd_np, "cpu")
    assert gd.w_stc.dtype == torch.int64
    assert gd.spr_f_tv.dtype == torch.int32
    assert gd.m_spr_f.dtype == torch.bool
    gc = tg.to_device(gc_np, "cpu")
    assert gc.ipa_a_total.dtype == torch.int64
    assert gc.ipa_score.dtype == torch.int64
    _assert_tree(gd, convert.groups_dev_from_numpy(gd_np, "cpu"),
                 tg.GroupsDev._fields)
