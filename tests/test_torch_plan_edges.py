"""The plan program's edge inputs — the node-axis partitions of the port's
CUDA design (csrc/run_plan.cu: a cluster of CTAs, a contiguous range of
rows each; csrc/run_plan_sharded.cu on one card: D teams of blocks) —
through the port's plain versions and the JAX package on the CPU.

The card holds the kernels against the port's plain versions on these
same inputs (tests/test_torch_cuda.py PLAN_EDGE_CASES); here the plain
versions are held against the JAX package. Each case builds its cluster
and pending batch with the JAX package's state layer; the numpy arrays
(NodeArrays, edited where a case boosts some rows' capacity, PodTable,
GroupsDev, GroupCarry) go through the JAX `run_plan` and, converted,
through the port's `run_plan` on CPU tensors (its plain version); then
through the JAX `run_plan_sharded` on two devices of the virtual CPU mesh
and the port's `run_plan_sharded` on two CPU shards. The cases:

- ties_across_boundaries: the rows on both sides of every multiple of
  128 (a CTA boundary at C = 16, N = 2,048) boosted alike, so the maxima
  tie across ranges and the lowest index must win;
- best_first_and_last_rows: the chosen row the first (1,024) or the last
  (255, 1,151) row of a range;
- full_width_32sigs: 5,000 nodes (8,192 rows) with S = 32 slots under one
  zone spread;
- one_pod and every_step_padded: W = 1, and a span whose steps are all
  invalid;
- anyway_domains_cross_ctas: ScheduleAnyway over racks of 7 nodes, so a
  rack's domain id (its first row) and its rows straddle boundaries.

Tolerance: exact. The packed output (assignments, conflict count,
conflict-free prefix), every carry field and the whole group carry,
dtypes included."""

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

ZONE = "topology.kubernetes.io/zone"
HOSTNAME = "kubernetes.io/hostname"

torch.set_num_threads(1)


def _zone_nodes(n, zones, cpu=16):
    return [make_node(f"n{i}").capacity({"cpu": cpu, "memory": "32Gi",
                                         "pods": 40})
            .zone(f"z{i % zones}").label(HOSTNAME, f"n{i}").obj()
            for i in range(n)]


def _rack_nodes(n, per_rack):
    return [make_node(f"n{i}").capacity({"cpu": 16, "memory": "32Gi",
                                         "pods": 40})
            .zone(f"z{i % 4}").label(HOSTNAME, f"n{i}")
            .label("rack", f"r{i // per_rack}").obj() for i in range(n)]


def _mixed_pods(n, sigs, spread=True):
    out = []
    for i in range(n):
        w = make_pod(f"m{i}").req({"cpu": f"{250 + 50 * (i % sigs)}m",
                                   "memory": "1Gi"}).label("app", "mix")
        if spread:
            w = w.spread_constraint(5, ZONE, "DoNotSchedule", {"app": "mix"})
        out.append(w.obj())
    return out


def _rack_pods(n):
    return [make_pod(f"k{i}").req({"cpu": "1", "memory": "1Gi"})
            .label("app", "mix").spread_constraint(
                1, "rack", "ScheduleAnyway", {"app": "mix"}).obj()
            for i in range(n)]


TIES = [b + o for b in range(128, 2048, 128) for o in (-1, 0)]

EDGE_CASES = {
    # name: (nodes, pods, lean, {row: capacity factor}, every step padded)
    "ties_across_boundaries": (lambda: _zone_nodes(2048, 16),
                               lambda: _mixed_pods(64, 2, spread=False),
                               True, {r: 4 for r in TIES}, False),
    "best_first_and_last_rows": (lambda: _zone_nodes(2048, 16),
                                 lambda: _mixed_pods(48, 3, spread=False),
                                 True, {255: 6, 1151: 6, 1024: 8}, False),
    "full_width_32sigs": (lambda: _zone_nodes(5000, 16, cpu=32),
                          lambda: _mixed_pods(96, 32), False, {}, False),
    "one_pod": (lambda: _zone_nodes(64, 4), lambda: _mixed_pods(1, 1),
                False, {}, False),
    "every_step_padded": (lambda: _zone_nodes(64, 4),
                          lambda: _mixed_pods(20, 4), False, {}, True),
    "anyway_domains_cross_ctas": (lambda: _rack_nodes(2048, 7),
                                  lambda: _rack_pods(40), False, {}, False),
}


def _eq(a, b, what):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b, err_msg=what)


def _eq_carry(jc, tc):
    for f in ("used", "nonzero_used", "npods", "ports"):
        _eq(getattr(jc, f), getattr(tc, f), f)
    _eq(jc.cache.sig, tc.cache.sig, "cache.sig")
    if jc.groups is None:
        assert tc.groups is None
        return
    for f in tg.GroupCarry._fields:
        _eq(getattr(jc.groups, f), getattr(tc.groups, f), f)


class Edge:
    """One case staged once, in both packages' forms (numpy shared)."""

    def __init__(self, case):
        self.case = case
        mk_nodes, mk_pods, self.lean, boost, padded = EDGE_CASES[case]
        pods = mk_pods()
        cache = Cache()
        for nd in mk_nodes():
            cache.add_node(nd)
        snap = Snapshot()
        cache.update_snapshot(snap)
        state = ClusterState()
        state.apply_snapshot(snap, full=True)
        builder = BatchBuilder(state, BatchDims(table_rows=64))
        batch = builder.build(pods)
        assert not batch.host_fallback.any()
        a = state.ensure_arrays()
        if boost:
            cap = a.cap.copy()
            for row, by in boost.items():
                cap[row] *= by
            a = a._replace(cap=cap)
        self.arrays, self.m = a, len(pods)
        m = self.m
        # the span as the scheduler lays it out (_wavescan_dispatch)
        uniq = list(dict.fromkeys(int(t) for t in batch.tidx[:m]))
        S = pow2_at_least(len(uniq), 2)
        self.wt = (uniq + [uniq[-1]] * S)[:S]
        slot = {}
        for s, u in enumerate(self.wt):
            slot.setdefault(u, s)
        bucket = pow2_at_least(m)
        widx = np.empty((bucket,), np.int32)
        widx[:m] = [slot[int(t)] for t in batch.tidx[:m]]
        widx[m:] = widx[m - 1]
        valid = np.zeros((bucket,), bool)
        valid[:m] = not padded
        self.widx, self.valid = widx, valid
        self.has_ports = bool((batch.sig[:m] == 0).any())
        self.table = builder.table
        self.gd_np = self.gc_np = None
        self.fam = tg.GroupFamilies(False, False, False, False, False)
        if not self.lean:
            self.gd_np, self.gc_np = builder.groups.build_dev(snap)
            self.fam = tg.GroupFamilies(*builder.groups.families(snap))
        self.jna = jp.NodeArrays(*(jnp.asarray(x) for x in a))
        self.jtab = jp.PodTableDev(*(jnp.asarray(getattr(self.table, f))
                                     for f in jp.PodTableDev._fields))
        self.jwt = jnp.asarray(np.array(self.wt, np.int32))
        self.jxs = jp.WaveXs(valid=jnp.asarray(valid),
                             widx=jnp.asarray(widx))
        self.tna = convert.node_arrays_from_numpy(a, "cpu")
        self.ttab = convert.pod_table_from_numpy(self.table, "cpu")
        self.txs = tp.WaveXs(valid=torch.from_numpy(valid),
                             widx=torch.from_numpy(widx))

    def flags(self):
        # has_groups and has_ports, keywords of both packages
        return dict(has_groups=not self.lean, has_ports=self.has_ports)


def _check_span(e, tpk):
    out = tpk[:e.m].tolist()
    assert sum(x >= 0 for x in out) == (e.m if e.valid.any() else 0)
    if e.case == "ties_across_boundaries":
        # each tie goes to its lower row first, boundary by boundary
        assert out[:len(TIES)] == TIES
    elif e.case == "best_first_and_last_rows":
        assert {255, 1024, 1151} <= set(out)


@pytest.mark.parametrize("case", sorted(EDGE_CASES))
def test_run_plan_edges_match_jax(case):
    e = Edge(case)
    jgd = jgc = tgd = tgc = None
    if not e.lean:
        jgd, jgc = jg.to_device(e.gd_np), jg.to_device(e.gc_np)
        tgd = convert.groups_dev_from_numpy(e.gd_np, "cpu")
        tgc = convert.group_carry_from_numpy(e.gc_np, "cpu")
    jst = jp.wave_statics(e.jna, e.jtab, e.jwt)
    tst = tp.wave_statics(e.tna, e.ttab, e.wt)
    for k, (x, y) in enumerate(zip(jst, tst)):
        _eq(x, y, f"statics[{k}]")
    jc, jpk = jp.run_plan(jp.ScoreConfig(), e.jna,
                          jp.initial_carry(e.jna, jgc), e.jxs, e.jtab, e.jwt,
                          jgd, jst, jg.GroupFamilies(*e.fam), True,
                          **e.flags())
    tc, tpk = tp.run_plan(tp.ScoreConfig(), e.tna,
                          tp.initial_carry(e.tna, tgc), e.txs, e.ttab, e.wt,
                          tgd, tst, e.fam, True, **e.flags())
    _eq(jpk, tpk, "packed")
    _eq_carry(jc, tc)
    _check_span(e, tpk)


@pytest.mark.parametrize("case", sorted(EDGE_CASES))
def test_run_plan_sharded_edges_match_jax(case):
    e = Edge(case)
    jmesh, tmesh = js.make_mesh(2), ts.make_mesh(devices=["cpu"] * 2)
    jna = js.shard_node_arrays(jmesh, e.jna)
    tna = convert.node_arrays_to_shards(e.arrays, tmesh)
    jgd = jgc = tgd = tgc = None
    if not e.lean:
        jgd = js.shard_groups(jmesh, jg.to_device(e.gd_np))
        jgc = js.shard_group_carry(jmesh, jg.to_device(e.gc_np))
        tgd = ts.shard_groups(tmesh, e.gd_np)
        tgc = ts.shard_group_carry(tmesh, e.gc_np)
    jst = tuple(js.jax.device_put(x, js.NamedSharding(
        jmesh, js.P(None, js.NODE_AXIS))) for x in jp.wave_statics(
            e.jna, e.jtab, e.jwt))
    tst = ts.wave_statics_sharded(tmesh, tna, e.ttab, e.wt)
    jc, jpk = js.run_plan_sharded(
        jp.ScoreConfig(), jmesh, jna, jp.initial_carry(jna, jgc), e.jxs,
        e.jtab, e.jwt, jgd, jst, jg.GroupFamilies(*e.fam), True,
        **e.flags())
    tc, tpk = ts.run_plan_sharded(
        tp.ScoreConfig(), tmesh, tna, ts.initial_carry_sharded(tna, tgc),
        e.txs, e.ttab, e.wt, tgd, tst, e.fam, True, **e.flags())
    _eq(jpk, tpk, "packed")
    _eq_carry(jc, ts.unshard(tc))
    _check_span(e, tpk)
