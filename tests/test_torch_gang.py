"""run_gang (both tiers): the port's plain versions ↔ the JAX package,
exact equality.

Each case builds one seeded cluster and gang with the JAX package's state
layer; its numpy arrays (NodeArrays, PodTable, a carry whose SigCache is
seeded noise under a signature no row carries) go through the JAX
`run_gang` on the CPU and, converted, through the port's plain
`run_gang`. The gang is laid out as the scheduler lays it out
(`Scheduler._gang_dispatch`): the distinct rows in first-seen order
padded to a power of two by repeating the last one, each member's slot
its row's first slot, the member axis padded to a pow2 bucket with
invalid members; the domain ids are the zone label's, else one per node,
in node-row order. Everything compared is integer or boolean, so the
tolerance is exact equality: the packed output (raw assignments, accept,
placed, the exactness flags) and every carry field, the whole SigCache
included, dtypes included."""

import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_parity import private_jax_compiles  # noqa: F401
from kubernetes_tpu.backend.cache import Cache, Snapshot
from kubernetes_tpu.ops import gang as jgang
from kubernetes_tpu.ops import program as jp
from kubernetes_tpu.state.batch import BatchBuilder, BatchDims
from kubernetes_tpu.state.tensorize import ClusterState, pow2_at_least
from kubernetes_tpu.testing.wrappers import make_node, make_pod
from kubernetes_tpu_torch.ops import gang as tgang
from kubernetes_tpu_torch.ops import program as tp
from kubernetes_tpu_torch.state import convert

ZONE = "topology.kubernetes.io/zone"

torch.set_num_threads(1)

# one node bucket, one pod pad: each JAX program compiles once per file
N_BUCKET = 32
PAD = 64


def _nodes(n, zones=4, cpu=4, prefer=False, pods=110, zoned=True):
    out = []
    for i in range(n):
        b = make_node(f"n{i}").capacity({"cpu": cpu, "memory": "32Gi",
                                         "pods": pods})
        if zoned and i % 5 != 4:          # every fifth node has no zone
            b = b.zone(f"z{i % zones}")
        if prefer and i % 3 == 0:
            b = b.taint("dedic", "x", "PreferNoSchedule")
        out.append(b.obj())
    return out


def _members(name, size, cpu="1", mem="1Gi", extra=None):
    proto = make_pod(f"{name}-proto").req({"cpu": cpu, "memory": mem})
    if extra is not None:
        proto = extra(proto)
    proto = proto.workload(name).obj()
    return [proto] * size


def _staged(nodes, bound, pods):
    cache = Cache()
    for nd in nodes:
        cache.add_node(nd)
    for pod, node_name in bound:
        pod.spec.node_name = node_name
        cache.add_pod(pod)
    snap = Snapshot()
    cache.update_snapshot(snap)
    state = ClusterState()
    state.dims.nodes = max(N_BUCKET, state.dims.nodes)
    state.apply_snapshot(snap, full=True)
    builder = BatchBuilder(state, BatchDims(table_rows=64))
    batch = builder.build(pods, pad_to=PAD)
    assert not batch.host_fallback.any()
    return state, snap, builder, batch


def _dom(state, snap, n):
    """Scheduler._gang_domains: the zone label's id, else one per node."""
    dom = np.arange(n, dtype=np.int32)
    ids: dict = {}
    for name, idx in state.node_index.items():
        if idx >= n:
            continue
        ni = snap.get(name)
        labels = ni.node.metadata.labels if ni is not None else {}
        zone = labels.get(ZONE) or f"\x00{idx}"
        dom[idx] = ids.setdefault(zone, len(ids))
    return dom


def _carry_np(a, rng):
    """The staged node state as a carry, with seeded noise in the SigCache
    under signature 12345 (no row carries it, so it is never hit)."""
    n = a.used.shape[0]
    cache = dict(
        sig=np.int32(12345), static_mask=rng.rand(n) < 0.5,
        taint_raw=rng.randint(0, 5, n).astype(np.int64),
        na_raw=rng.randint(0, 9, n).astype(np.int64),
        s_img=rng.randint(0, 50, n).astype(np.int64),
        fit_ok=rng.rand(n) < 0.5,
        s_fit=rng.randint(0, 100, n).astype(np.int64),
        s_bal=rng.randint(0, 100, n).astype(np.int64))

    class C:
        pass
    c = C()
    c.used, c.nonzero_used = a.used.copy(), a.nonzero_used.copy()
    c.npods, c.ports = a.npods.copy(), a.ports.copy()
    c.cache = type("Cache", (), cache)
    return c


def _jax_carry(c):
    return jp.Carry(
        used=jnp.asarray(c.used), nonzero_used=jnp.asarray(c.nonzero_used),
        npods=jnp.asarray(c.npods), ports=jnp.asarray(c.ports),
        cache=jp.SigCache(*(jnp.asarray(getattr(c.cache, f))
                            for f in jp.SigCache._fields)))


def _assert_carry(jc, tc, want_sig=None):
    for f in ("used", "nonzero_used", "npods", "ports"):
        a, b = np.asarray(getattr(jc, f)), getattr(tc, f).numpy()
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    for f in tp.SigCache._fields:
        a, b = np.asarray(getattr(jc.cache, f)), getattr(tc.cache, f).numpy()
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f"cache.{f}")
    if want_sig is not None:
        assert int(tc.cache.sig) == want_sig
    assert tc.groups is None


def _clone_carry(c):
    return tp.Carry(*(t.clone() for t in c[:4]),
                    cache=tp.SigCache(*(t.clone() for t in c.cache)),
                    groups=None)


def _assert_same_values(a, b):
    for x, y in zip(list(a[:4]) + list(a.cache), list(b[:4]) + list(b.cache)):
        assert torch.equal(x, y)


def gang_parity(nodes, bound, pods, *, needed, w_contig=0, uniform=False,
                cfg_kw=None, bucket=None, J=None, seed=0):
    """run_gang over the gang `pods` (the whole batch), JAX vs the port;
    returns (port packed as numpy, m, L or bucket, port carry, the input
    port carry)."""
    state, snap, builder, batch = _staged(nodes, bound, pods)
    m = len(pods)
    a = state.ensure_arrays()
    n = a.used.shape[0]
    c_np = _carry_np(a, np.random.RandomState(seed))
    jna = jp.NodeArrays(*(jnp.asarray(x) for x in a))
    jtab = jp.PodTableDev(*(jnp.asarray(getattr(builder.table, f))
                            for f in jp.PodTableDev._fields))
    tna = convert.node_arrays_from_numpy(a, "cpu")
    ttab = convert.pod_table_from_numpy(builder.table, "cpu")
    jcfg = jp.ScoreConfig(**(cfg_kw or {}))
    tcfg = tp.ScoreConfig(**(cfg_kw or {}))
    jcarry = _jax_carry(c_np)
    tcarry = convert.carry_from_numpy(c_np, "cpu")
    tin = _clone_carry(tcarry)
    if uniform:
        L = pow2_at_least(m, 16)
        K = min(L, n)
        if J is None:
            n_q = pow2_at_least(max(len(nodes), 1))
            J = min(max(pow2_at_least(4 * L // n_q + 4), 8), L + 1)
        jx = jp.PodXs(valid=jnp.bool_(True), sig=jnp.int32(batch.sig[0]),
                      tidx=jnp.int32(batch.tidx[0]))
        tx = tp.PodXs(True, int(batch.sig[0]), int(batch.tidx[0]))
        jc, jpk = jgang.run_gang(jcfg, jna, jcarry, jx, jtab,
                                 needed=np.int32(needed), uniform=True,
                                 n_actual=np.int32(m), L=L, K=K, J=J)
        tc, tpk = tgang.run_gang(tcfg, tna, tcarry, tx, ttab, needed=needed,
                                 uniform=True, n_actual=m, L=L, K=K, J=J)
        width = L
    else:
        tid = batch.tidx[:m]
        uniq = list(dict.fromkeys(int(t) for t in tid))
        S = pow2_at_least(len(uniq), 1)
        wt = (uniq + [uniq[-1]] * S)[:S]
        slot = {}
        for s, u in enumerate(wt):
            slot.setdefault(u, s)
        width = bucket or pow2_at_least(m)
        widx = np.zeros((width,), np.int32)
        widx[:m] = [slot[int(t)] for t in tid]
        widx[m:] = widx[m - 1]
        tidx = np.full((width,), tid[m - 1], np.int32)
        tidx[:m] = tid
        valid = np.zeros((width,), bool)
        valid[:m] = batch.valid[:m]
        dom = _dom(state, snap, n)
        xs_np = tgang.GangXs(valid=valid, tidx=tidx, widx=widx)
        jwt = jnp.asarray(np.array(wt, np.int32))
        jst = jp.wave_statics(jna, jtab, jwt)
        tst = tp.wave_statics(tna, ttab, wt)
        jc, jpk = jgang.run_gang(
            jcfg, jna, jcarry,
            jgang.GangXs(*(jnp.asarray(x) for x in xs_np)), jtab, wt=jwt,
            needed=np.int32(needed), dom=jnp.asarray(dom), statics=jst,
            w_contig=w_contig)
        tc, tpk = tgang.run_gang(
            tcfg, tna, tcarry, convert.gang_xs_from_numpy(xs_np, "cpu"),
            ttab, wt=wt, needed=needed, dom=convert.dom_from_numpy(dom, "cpu"),
            statics=tst, w_contig=w_contig)
    jpk = np.asarray(jpk)
    tpk = tpk.numpy()
    assert jpk.dtype == tpk.dtype == np.int32
    np.testing.assert_array_equal(jpk, tpk)
    _assert_carry(jc, tc)
    # the plain version never writes its input
    _assert_same_values(tcarry, tin)
    return tpk, m, width, tc, tin


def _verdict(pk, width):
    return bool(pk[width]), int(pk[width + 1]), bool(pk[width + 2]), \
        bool(pk[width + 3])


# ---------------------------------------------------------------------------
# scan tier


@pytest.mark.parametrize("w_contig", [0, 2])
def test_scan_accept(w_contig):
    nodes = _nodes(16, zones=4, cpu=2)
    pk, m, B, tc, tin = gang_parity(nodes, [], _members("g", 8),
                                    needed=8, w_contig=w_contig)
    accept, placed, exact, depth = _verdict(pk, B)
    assert accept and placed == 8 and exact and depth
    # an accepted scan tier zeroes the resident signature
    assert int(tc.cache.sig) == 0
    assert int(tc.npods.sum()) == int(tin.npods.sum()) + 8


def test_contiguity_packs_domains():
    """w_contig concentrates the gang into fewer zones (the JAX package's
    test_contiguity_packs_topology_domains, at the program level)."""
    nodes = _nodes(16, zones=4, cpu=2, zoned=True)
    zones = []
    for w in (0, 8):
        pk, m, B, tc, tin = gang_parity(nodes, [], _members("g", 8),
                                        needed=8, w_contig=w)
        zones.append({int(pk[k]) % 4 for k in range(m)})
    assert len(zones[1]) < len(zones[0])


@pytest.mark.parametrize("w_contig", [0, 2])
def test_scan_reject_returns_input(w_contig):
    nodes = _nodes(4, cpu=1)
    pk, m, B, tc, tin = gang_parity(nodes, [], _members("g", 6),
                                    needed=6, w_contig=w_contig)
    accept, placed, _e, _d = _verdict(pk, B)
    assert not accept and placed == 4
    # the raw assignments still report the members that would fit
    assert (pk[:m] >= 0).sum() == 4
    _assert_same_values(tc, tin)
    assert int(tc.cache.sig) == 12345


def test_scan_partial_min_count():
    """size 5, minCount 3, room for 3: accepted, two members infeasible."""
    nodes = _nodes(3, cpu=1)
    pk, m, B, tc, _tin = gang_parity(nodes, [], _members("g", 5),
                                     needed=3)
    accept, placed, _e, _d = _verdict(pk, B)
    assert accept and placed == 3
    assert list(pk[3:5]) == [-1, -1]


def test_scan_needed_zero_accepts_nothing_placed():
    nodes = _nodes(2, cpu=1)
    pk, _m, B, tc, _tin = gang_parity(nodes, [], _members("g", 3, cpu="2"),
                                      needed=0)
    accept, placed, _e, _d = _verdict(pk, B)
    assert accept and placed == 0
    assert int(tc.cache.sig) == 0


@pytest.mark.parametrize("w_contig", [0, 2])
def test_scan_two_signatures(w_contig):
    """S = 2: worker and launcher roles interleaved, with bound pods."""
    rng = random.Random(5)
    nodes = _nodes(12, zones=3, cpu=4, prefer=True)
    bound = [(make_pod(f"b{i}").req({"cpu": "1", "memory": "2Gi"}).obj(),
              f"n{rng.randrange(12)}") for i in range(6)]
    work = _members("g", 1, cpu="1")[0]
    launch = make_pod("g-l").req({"cpu": "500m", "memory": "4Gi"}).toleration(
        key="dedic", operator="Exists").workload("g").obj()
    pods = [work if k % 3 else launch for k in range(10)]
    pk, m, B, tc, _tin = gang_parity(nodes, bound, pods, needed=10,
                                     w_contig=w_contig)
    assert _verdict(pk, B)[0]


def test_scan_three_signatures_pad_to_four():
    """S = 3 → 4: the last row repeats; the duplicate slot is refreshed
    every step and never consumed."""
    nodes = _nodes(10, zones=2, cpu=4)
    a = make_pod("g-a").req({"cpu": "1", "memory": "1Gi"}).workload("g").obj()
    b = make_pod("g-b").req({"cpu": "2", "memory": "1Gi"}).workload("g").obj()
    c = (make_pod("g-c").req({"cpu": "500m", "memory": "8Gi"})
         .node_affinity_in(ZONE, ["z0"]).workload("g").obj())
    pods = [a, b, c, a, c, b, c, c, a]
    pk, m, B, tc, _tin = gang_parity(nodes, [], pods, needed=9, w_contig=2)
    assert _verdict(pk, B)[0]


def test_scan_padding_members():
    """A 16-slot bucket for 5 members: padding members assign nothing
    and count nothing."""
    nodes = _nodes(6, cpu=2)
    pk, m, B, tc, tin = gang_parity(nodes, [], _members("g", 5), needed=5,
                                    bucket=16, w_contig=2)
    assert B == 16 and list(pk[m:B]) == [-1] * (B - m)
    assert _verdict(pk, B)[1] == 5
    assert int(tc.npods.sum()) == int(tin.npods.sum()) + 5


def test_scan_preferences_and_most_allocated():
    """Preferred affinity and PreferNoSchedule taints renormalize every
    step; MostAllocated packs."""
    nodes = _nodes(12, zones=3, cpu=8, prefer=True)
    pods = _members("g", 9, extra=lambda w: w.preferred_node_affinity_in(
        ZONE, ["z1"], weight=5))
    for strategy in ("LeastAllocated", "MostAllocated"):
        pk, _m, B, _tc, _tin = gang_parity(
            nodes, [], pods, needed=9, w_contig=2,
            cfg_kw={"strategy": strategy})
        assert _verdict(pk, B)[0]


def test_scan_fuzz():
    for seed in range(6):
        rng = random.Random(70 + seed)
        nodes = _nodes(rng.randint(3, 20), zones=rng.randint(1, 4),
                       cpu=rng.randint(2, 8), prefer=rng.random() < 0.5)
        bound = [(make_pod(f"b{i}").req(
            {"cpu": str(rng.randint(1, 2)), "memory": "1Gi"}).obj(),
            f"n{rng.randrange(len(nodes))}")
            for i in range(rng.randint(0, len(nodes)))]
        size = rng.randint(2, 12)
        pods = _members("g", size, cpu=rng.choice(["500m", "1", "2", "3"]))
        gang_parity(nodes, bound, pods, needed=rng.randint(1, size),
                    w_contig=rng.choice([0, 2, 8]), seed=seed)


# ---------------------------------------------------------------------------
# closed-form tier


def test_uniform_accept():
    nodes = _nodes(16, cpu=4, zoned=False)
    pk, m, L, tc, _tin = gang_parity(nodes, [], _members("g", 12),
                                     needed=12, uniform=True)
    accept, placed, exact, depth = _verdict(pk, L)
    assert accept and placed == 12 and exact and depth
    assert L == 16 and list(pk[m:L]) == [-1] * (L - m)
    # an accepted closed form refreshes the cache as run_uniform does
    assert int(tc.cache.sig) != 0


def test_uniform_reject_returns_input():
    nodes = _nodes(2, cpu=1, zoned=False)
    pk, m, L, tc, tin = gang_parity(nodes, [], _members("g", 3),
                                    needed=3, uniform=True)
    accept, placed, exact, depth = _verdict(pk, L)
    assert not accept and placed == 2 and exact and depth
    _assert_same_values(tc, tin)


def test_uniform_partial_min_count():
    nodes = _nodes(3, cpu=1, zoned=False)
    pk, m, L, _tc, _tin = gang_parity(nodes, [], _members("g", 5),
                                      needed=3, uniform=True)
    assert _verdict(pk, L)[:2] == (True, 3)


def test_uniform_failed_exactness_counts_placed():
    """PreferNoSchedule taints the gang does not tolerate make the
    normalization non-constant: exact is False, placed still counts the
    selections, and the carry is the input's."""
    nodes = _nodes(9, cpu=4, prefer=True, zoned=False)
    pk, m, L, tc, tin = gang_parity(nodes, [], _members("g", 10),
                                    needed=10, uniform=True)
    accept, placed, exact, depth = _verdict(pk, L)
    assert accept and placed == 10 and not exact
    _assert_same_values(tc, tin)


def test_uniform_depth_overflow():
    """J = 2 on two nodes: a candidate uses all its entries; the depth flag
    fails and the carry is the input's."""
    nodes = _nodes(2, cpu=8, zoned=False)
    pk, m, L, tc, tin = gang_parity(nodes, [], _members("g", 4), needed=4,
                                    uniform=True, J=2)
    accept, placed, exact, depth = _verdict(pk, L)
    assert not depth
    _assert_same_values(tc, tin)


def test_uniform_fuzz():
    for seed in range(6):
        rng = random.Random(90 + seed)
        nodes = _nodes(rng.randint(3, 20), cpu=rng.randint(2, 8),
                       zoned=False, prefer=rng.random() < 0.3)
        bound = [(make_pod(f"b{i}").req(
            {"cpu": str(rng.randint(1, 2)), "memory": "1Gi"}).obj(),
            f"n{rng.randrange(len(nodes))}")
            for i in range(rng.randint(0, len(nodes)))]
        size = rng.randint(2, 16)
        pods = _members("g", size, cpu=rng.choice(["500m", "1", "2"]))
        gang_parity(nodes, bound, pods, needed=rng.randint(1, size),
                    uniform=True, seed=seed)


@pytest.mark.parametrize("verdict", ["accept", "reject", "inexact"])
@pytest.mark.parametrize("rows", ["select", "all"])
def test_uniform_verdict_branch_shapes(rows, verdict):
    """csrc/run_uniform.cu's gang branches at 32 node rows: a gang of 12
    (L = K = 16: the top 16 rows selected) or of 24 (L = K = 32: every row
    a candidate), accepted, rejected (needed above the gang) and inexact
    (PreferNoSchedule taints: the normalization is not constant); a gang
    that does not apply returns its input carry."""
    size = 12 if rows == "select" else 24
    nodes = _nodes(20, cpu=4, zoned=False, prefer=verdict == "inexact")
    pk, m, L, tc, tin = gang_parity(
        nodes, [], _members("g", size), uniform=True,
        needed=size + 1 if verdict == "reject" else size)
    assert (L < N_BUCKET) == (rows == "select")
    accept, placed, exact, depth = _verdict(pk, L)
    assert placed == size and depth
    assert accept == (verdict != "reject")
    assert exact == (verdict != "inexact")
    if verdict == "accept":
        assert int(tc.cache.sig) != int(tin.cache.sig)
    else:
        _assert_same_values(tc, tin)


def test_run_gang_refuses_other_devices():
    from kubernetes_tpu_torch.state.tensorize import Dims, _zero_arrays
    na = convert.node_arrays_from_numpy(_zero_arrays(Dims()), "meta")
    carry = tp.initial_carry(na)
    with pytest.raises(RuntimeError, match="unsupported device"):
        tgang.run_gang(tp.ScoreConfig(), na, carry, None, None)
