"""The port's node-sharded programs (kubernetes_tpu_torch/parallel/
sharding.py) ↔ the JAX package's, and ↔ the port's single-device ones.

For D ∈ {1, 2, 4, 8}: the same numpy state goes through the JAX sharded
program on the 8-device virtual CPU mesh (tests/conftest.py) and through
the port's plain version over D CPU shards. The cluster is heterogeneous
along the node axis, as tests/test_sharding.py builds it: a band of
PreferNoSchedule taints, an ssd label band, images on nodes of every
shard, a band of identical nodes whose score tie straddles the middle
shard boundary, and padding rows (with D = 8 whole shards are padding);
the scan also runs on a cluster of identical nodes, where every step's
best score is tied on every shard. run_gang_sharded runs both tiers,
accepted and rejected (the scan with w_contig 0 and 2; a rejected gang
leaves every shard's carry as it came, its SigCache sig included), also
against the port's single-device run_gang.
Tolerance: exact. Assignments, the packed uniform output with its flags,
the unsharded carry (SigCache included) and the scattered arrays are
int64 / int32 / bool equal; the probe's float32 outputs are compared
through their int32 view."""

import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_parity import (private_jax_compiles,  # noqa: F401
                           assert_carry_equal, assert_sharded_carry_equal,
                           jax_mesh_state, jax_na, jax_table,
                           shards_from_jax,
                           staged, torch_mesh_state, torch_na, torch_table)
from kubernetes_tpu.ops import program as jp
from kubernetes_tpu.parallel import sharding as js
from kubernetes_tpu.state.tensorize import pow2_at_least
from kubernetes_tpu.testing.wrappers import make_node, make_pod
from kubernetes_tpu_torch.ops import program as tp
from kubernetes_tpu_torch.parallel import sharding as ts
from kubernetes_tpu_torch.state import convert

DS = (1, 2, 4, 8)
N_BUCKET = 32
ZONE = "topology.kubernetes.io/zone"

def mesh_nodes(n=24, soft_taints=True):
    """Nodes 12-19 are identical (their tie straddles row 16, the middle
    shard boundary for every D > 1); the rest vary by index."""
    rng = np.random.RandomState(7)
    nodes = []
    for i in range(n):
        band = 12 <= i < 20
        w = (make_node(f"n{i}")
             .capacity({"cpu": 8 if band else int(rng.randint(2, 16)),
                        "memory": "16Gi" if band
                        else f"{rng.randint(4, 32)}Gi", "pods": 110})
             .zone("z0" if band else f"z{i % 3}"))
        if soft_taints:
            for t in range(1 if band else i * 3 // n):
                w = w.taint(f"soft{t}", "x", "PreferNoSchedule")
        if i % 4 == 1 and not band:
            w = w.label("disk", "ssd")
        if i % 5 in (0, 3) and not band:
            w = w.image("nginx:1", int(rng.randint(30, 600)) << 20)
        nodes.append(w.obj())
    return nodes


def mesh_pods(n=24):
    """Runs of three identical pods (the SigCache fast path) over mixed
    rows: selectors, preferred affinity, tolerations, images."""
    rng = np.random.RandomState(11)
    pods = []
    for k in range(n // 3):
        cpu, mem = rng.randint(1, 8) * 250, rng.randint(1, 8) * 256
        for r in range(3):
            w = make_pod(f"p{k}-{r}").req({"cpu": f"{cpu}m",
                                           "memory": f"{mem}Mi"})
            if k % 5 == 0:
                w = w.node_selector({ZONE: f"z{k % 3}"})
            if k % 3 == 0:
                w = w.preferred_node_affinity_in("disk", ["ssd"], weight=7)
            if k % 4 == 2:
                w = w.toleration(key="soft0", operator="Equal", value="x",
                                 effect="PreferNoSchedule")
            if k % 2 == 1:
                w = w.container({"cpu": "50m"}, image="nginx:1")
            pods.append(w.obj())
    return pods


def meshes(D):
    return js.make_mesh(D), ts.make_mesh(devices=["cpu"] * D)


def _eq(a, b):
    a, b = np.asarray(a), b.numpy()
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


def _xs(batch, n):
    return (jp.PodXs(valid=batch.valid[:n], sig=batch.sig[:n],
                     tidx=batch.tidx[:n]),
            tp.PodXs(valid=torch.from_numpy(batch.valid[:n]),
                     sig=torch.from_numpy(batch.sig[:n]),
                     tidx=torch.from_numpy(batch.tidx[:n])))


# ---------------------------------------------------------------------------
# run_batch_sharded (lean mode)


def tie_nodes(n=24):
    """Identical nodes: every step's best score is tied on every shard,
    so the winner is the lowest global index of the tie."""
    return [make_node(f"n{i}").capacity({"cpu": 8, "memory": "16Gi",
                                         "pods": 110}).obj()
            for i in range(n)]


@pytest.mark.parametrize("cluster", ["mixed", "ties"])
@pytest.mark.parametrize("D", DS)
def test_run_batch_sharded_equals_jax(D, cluster):
    pods = mesh_pods()
    nodes = mesh_nodes() if cluster == "mixed" else tie_nodes()
    arrays, batch = staged(nodes, (), pods, n_bucket=N_BUCKET)
    n = len(pods)
    jx, tx = _xs(batch, n)
    jmesh, tmesh = meshes(D)
    jna, jc0 = jax_mesh_state(jmesh, arrays)
    tna, tc0 = torch_mesh_state(tmesh, arrays)
    cfg = tp.ScoreConfig()
    jc, ja = js.run_batch_sharded(jp.ScoreConfig(), jmesh, jna, jc0, jx,
                                  jax_table(batch.table))
    tc, ta = ts.run_batch_sharded(cfg, tmesh, tna, tc0, tx,
                                  torch_table(batch.table))
    _eq(ja, ta)
    assert_sharded_carry_equal(jc, tc)
    assert (ta.numpy() >= 0).sum() > n // 2
    # the port's single-device scan
    sna = torch_na(arrays)
    sc, sa = tp.run_batch(cfg, sna, tp.initial_carry(sna), tx,
                          torch_table(batch.table))
    assert torch.equal(sa, ta)
    for f in ("used", "nonzero_used", "npods", "ports"):
        assert torch.equal(getattr(sc, f), getattr(ts.unshard(tc), f)), f


def test_run_batch_sharded_never_writes_its_input():
    pods = mesh_pods(12)
    arrays, batch = staged(mesh_nodes(), (), pods, n_bucket=N_BUCKET)
    _, tx = _xs(batch, len(pods))
    tmesh = ts.make_mesh(devices=["cpu"] * 4)
    tna, tc0 = torch_mesh_state(tmesh, arrays)
    before = convert.shards_to_numpy(tc0)
    ts.run_batch_sharded(tp.ScoreConfig(), tmesh, tna, tc0, tx,
                         torch_table(batch.table))
    after = convert.shards_to_numpy(tc0)
    for f in ("used", "npods", "ports"):
        np.testing.assert_array_equal(getattr(before, f), getattr(after, f))


def test_lane_probe_equals_jax():
    """profile_shard_lanes' lane probe, one shard's scan with the exchange
    left out (the port's run_batch on the shard's slice), against the
    JAX package's _lane_probe_jit on that slice."""
    pods = mesh_pods(12)
    arrays, batch = staged(mesh_nodes(), (), pods, n_bucket=N_BUCKET)
    jx, tx = _xs(batch, len(pods))
    sl = slice(16, 32)
    part = type(arrays)(*(x[sl] for x in arrays))
    jna = jax_na(part)
    jc, ja = js._lane_probe_jit(jp.ScoreConfig(), jna, jp.initial_carry(jna),
                                jx, jax_table(batch.table))
    tna = torch_na(part)
    tc, ta = tp.run_batch(tp.ScoreConfig(), tna, tp.initial_carry(tna), tx,
                          torch_table(batch.table))
    _eq(ja, ta)
    assert_carry_equal(jc, tc)
    tmesh = ts.make_mesh(devices=["cpu"] * 2)
    tna_s, tc_s = torch_mesh_state(tmesh, arrays)
    prof = ts.profile_shard_lanes(tp.ScoreConfig(), tmesh, tna_s, tc_s, tx,
                                  torch_table(batch.table))
    assert prof["nDevices"] == 2 and len(prof["laneSeconds"]) == 2
    assert prof["nodesPerLane"] == 16 and len(prof["laneShares"]) == 2
    assert prof["imbalanceRatio"] >= 1.0 and 0.0 <= prof["commsShare"] <= 1.0


# ---------------------------------------------------------------------------
# run_uniform_sharded


UNIFORM_CASES = {
    # name: (soft taints, pods, L, K, J, expected (exact, depth))
    "exact": (False, 40, 64, 32, 8, (1, 1)),
    "depth_overflow": (False, 40, 64, 32, 2, (1, 0)),
    "norm_false": (True, 40, 64, 32, 8, (0, None)),
}


def _uniform_pods(n):
    return [make_pod(f"u{i}").req({"cpu": "250m", "memory": "512Mi"})
            .container({"cpu": "50m"}, image="nginx:1").obj()
            for i in range(n)]


@pytest.mark.parametrize("case", sorted(UNIFORM_CASES))
@pytest.mark.parametrize("D", DS)
def test_run_uniform_sharded_equals_jax(D, case):
    soft, n, L, K, J, want = UNIFORM_CASES[case]
    arrays, batch = staged(mesh_nodes(soft_taints=soft), (),
                           _uniform_pods(n), n_bucket=N_BUCKET)
    sig, tidx = int(batch.sig[0]), int(batch.tidx[0])
    jmesh, tmesh = meshes(D)
    jna, jc0 = jax_mesh_state(jmesh, arrays)
    tna, tc0 = torch_mesh_state(tmesh, arrays)
    jc, jpk = js.run_uniform_sharded(
        jp.ScoreConfig(), jmesh, jna, jc0,
        jp.PodXs(valid=np.bool_(True), sig=np.int32(sig),
                 tidx=np.int32(tidx)),
        jax_table(batch.table), np.int32(n), L, K, J)
    tc, tpk = ts.run_uniform_sharded(
        tp.ScoreConfig(), tmesh, tna, tc0, tp.PodXs(True, sig, tidx),
        torch_table(batch.table), n, L, K, J)
    _eq(jpk, tpk)
    assert_carry_equal(jc, ts.unshard(tc))
    got = tpk.numpy()
    assert got[L] == want[0]
    if want[1] is not None:
        assert got[L + 1] == want[1]
    # the single-device closed form: equal assignments wherever both
    # report exact
    sna = torch_na(arrays)
    _, spk = tp.run_uniform(tp.ScoreConfig(), sna, tp.initial_carry(sna),
                            tp.PodXs(True, sig, tidx),
                            torch_table(batch.table), n, L, K, J)
    s = spk.numpy()
    if got[L] and got[L + 1] and s[L] and s[L + 1]:
        np.testing.assert_array_equal(s[:L], got[:L])


def identical_nodes(n=24):
    """Nodes of one shape: every row key ties but for its index, so the
    selections' top digits all tie."""
    return [make_node(f"n{i}").capacity({"cpu": 8, "memory": "16Gi",
                                         "pods": 110}).zone(f"z{i % 3}")
            .obj() for i in range(n)]


UNIFORM_EDGE_CASES = {
    # name: (identical nodes, pod cpu, pods, n_actual, L, K, J)
    "k_below_rows": (False, "250m", 16, 16, 16, 4, 8),
    "fewer_feasible_than_k": (False, "9", 20, 20, 32, 32, 8),
    "ties_in_top_digits": (True, "1", 24, 24, 32, 8, 4),
    "n_actual_below_l": (False, "250m", 10, 10, 32, 32, 8),
}


@pytest.mark.parametrize("case", sorted(UNIFORM_EDGE_CASES))
@pytest.mark.parametrize("D", DS)
def test_run_uniform_sharded_edges_equal_jax(D, case):
    """The selection's edge cases (the kernel selects where the plain
    version sorts; both are held to the JAX program): fewer candidates
    than rows, fewer feasible nodes than K, rows whose keys tie in every
    top digit, fewer pods than L."""
    ident, cpu, n, n_actual, L, K, J = UNIFORM_EDGE_CASES[case]
    pods = [make_pod(f"u{i}").req({"cpu": cpu, "memory": "512Mi"}).obj()
            for i in range(n)]
    nodes = identical_nodes() if ident else mesh_nodes(soft_taints=False)
    arrays, batch = staged(nodes, (), pods, n_bucket=N_BUCKET)
    sig, tidx = int(batch.sig[0]), int(batch.tidx[0])
    jmesh, tmesh = meshes(D)
    jna, jc0 = jax_mesh_state(jmesh, arrays)
    tna, tc0 = torch_mesh_state(tmesh, arrays)
    jc, jpk = js.run_uniform_sharded(
        jp.ScoreConfig(), jmesh, jna, jc0,
        jp.PodXs(valid=np.bool_(True), sig=np.int32(sig),
                 tidx=np.int32(tidx)),
        jax_table(batch.table), np.int32(n_actual), L, K, J)
    tc, tpk = ts.run_uniform_sharded(
        tp.ScoreConfig(), tmesh, tna, tc0, tp.PodXs(True, sig, tidx),
        torch_table(batch.table), n_actual, L, K, J)
    _eq(jpk, tpk)
    assert_carry_equal(jc, ts.unshard(tc))
    assert (tpk.numpy()[n_actual:L] == -1).all()


GANG_EDGE_CASES = {
    # name: (soft taints, member cpu, input SigCache sig)
    "inexact_rejected": (True, "1", 0),
    "rejected_with_a_cached_sig": (False, "12", 777),
}


@pytest.mark.parametrize("case", sorted(GANG_EDGE_CASES))
@pytest.mark.parametrize("D", DS)
def test_run_gang_sharded_uniform_edges(D, case):
    """A closed-form gang the verdict refuses — inexact (the
    normalization is not constant), or short of its minimum with a
    SigCache labelled for another signature — leaves every shard's carry
    as it came, the sig included, as the JAX program does."""
    soft, cpu, sig0 = GANG_EDGE_CASES[case]
    pods = [make_pod(f"t{i}").req({"cpu": cpu, "memory": "1Gi"})
            .workload("train").obj() for i in range(20)]
    arrays, batch = staged(mesh_nodes(soft_taints=soft), (), pods,
                           n_bucket=N_BUCKET)
    m, L, K, J = len(pods), 32, 32, 8
    sig, tidx = int(batch.sig[0]), int(batch.tidx[0])
    jmesh, tmesh = meshes(D)
    jna, jc0 = jax_mesh_state(jmesh, arrays)
    tna, tc0 = torch_mesh_state(tmesh, arrays)
    jc0 = _sig_carry(jc0, js.jax.device_put(np.int32(sig0)))
    tc0 = ts.with_cache_sig_sharded(tc0, sig0)
    before = convert.shards_to_numpy(tc0)
    jc, jpk = js.run_gang_sharded(
        jp.ScoreConfig(), jmesh, jna, jc0,
        jp.PodXs(valid=np.bool_(True), sig=np.int32(sig),
                 tidx=np.int32(tidx)), jax_table(batch.table),
        needed=np.int32(m), uniform=True, n_actual=np.int32(m), L=L, K=K,
        J=J)
    tc, tpk = ts.run_gang_sharded(
        tp.ScoreConfig(), tmesh, tna, tc0, tp.PodXs(True, sig, tidx),
        torch_table(batch.table), needed=m, uniform=True, n_actual=m, L=L,
        K=K, J=J)
    _eq(jpk, tpk)
    assert_sharded_carry_equal(jc, tc)
    accept, exact = bool(tpk[L]), bool(tpk[L + 2])
    assert not (accept and exact)
    after = convert.shards_to_numpy(tc)
    for f in ("used", "nonzero_used", "npods"):
        np.testing.assert_array_equal(getattr(before, f), getattr(after, f))
    assert int(after.cache.sig) == sig0


def test_run_uniform_sharded_fast_path_after_a_scan():
    """A uniform run after a scan of the same signature reuses the
    replicated SigCache (the fast path) on every shard."""
    pods = _uniform_pods(8)
    arrays, batch = staged(mesh_nodes(soft_taints=False), (), pods,
                           n_bucket=N_BUCKET)
    jx, tx = _xs(batch, 4)
    sig, tidx = int(batch.sig[0]), int(batch.tidx[0])
    jmesh, tmesh = meshes(4)
    jna, jc0 = jax_mesh_state(jmesh, arrays)
    tna, tc0 = torch_mesh_state(tmesh, arrays)
    jt, tt = jax_table(batch.table), torch_table(batch.table)
    jc1, _ = js.run_batch_sharded(jp.ScoreConfig(), jmesh, jna, jc0, jx, jt)
    tc1, _ = ts.run_batch_sharded(tp.ScoreConfig(), tmesh, tna, tc0, tx, tt)
    L, K = 16, 16
    J = min(max(pow2_at_least(4 * L // 32 + 4), 8), L + 1)
    jc, jpk = js.run_uniform_sharded(
        jp.ScoreConfig(), jmesh, jna, jc1,
        jp.PodXs(valid=np.bool_(True), sig=np.int32(sig),
                 tidx=np.int32(tidx)), jt, np.int32(4), L, K, J)
    tc, tpk = ts.run_uniform_sharded(tp.ScoreConfig(), tmesh, tna, tc1,
                                     tp.PodXs(True, sig, tidx), tt, 4, L, K,
                                     J)
    _eq(jpk, tpk)
    assert_carry_equal(jc, ts.unshard(tc))


# ---------------------------------------------------------------------------
# scatter_rows_sharded


@pytest.mark.parametrize("D", DS)
def test_scatter_rows_sharded_equals_jax(D):
    arrays, _ = staged(mesh_nodes(), (), [make_pod("p").obj()],
                       n_bucket=N_BUCKET)
    other, _ = staged(mesh_nodes(20, soft_taints=False), (),
                      [make_pod("p").obj()], n_bucket=N_BUCKET)
    n_local = N_BUCKET // D
    # shard boundary rows on both sides, the first and last rows, and the
    # pow2 pad of the JAX package's upload (repeats of the first index)
    real = sorted({0, 3, n_local - 1, n_local % N_BUCKET, N_BUCKET - 1,
                   16, 15, 17})
    idx = np.full((pow2_at_least(len(real)),), real[0], np.int64)
    idx[:len(real)] = real
    rows = type(other)(*(x[idx] for x in other))
    jmesh, tmesh = meshes(D)
    jdev = js.shard_node_arrays(jmesh, jax_na(arrays))
    jout = js.scatter_rows_sharded(jmesh, jdev, idx.astype(np.int32), rows)
    tdev = convert.node_arrays_to_shards(arrays, tmesh)
    before = convert.shards_to_numpy(tdev)
    tout = ts.scatter_rows_sharded(tmesh, tdev, idx, rows)
    got = convert.shards_to_numpy(tout)
    single = tp.scatter_rows(torch_na(arrays), idx,
                             convert.node_arrays_from_numpy(rows, "cpu"))
    for f in arrays._fields:
        want = np.asarray(getattr(jout, f))
        assert want.dtype == getattr(got, f).dtype, f
        np.testing.assert_array_equal(want, getattr(got, f), err_msg=f)
        np.testing.assert_array_equal(getattr(single, f).numpy(),
                                      getattr(got, f), err_msg=f)
        np.testing.assert_array_equal(getattr(before, f),
                                      getattr(arrays, f), err_msg=f)


def test_scatter_rows_sharded_keeps_untouched_shards():
    arrays, _ = staged(mesh_nodes(), (), [make_pod("p").obj()],
                       n_bucket=N_BUCKET)
    tmesh = ts.make_mesh(devices=["cpu"] * 4)
    tdev = convert.node_arrays_to_shards(arrays, tmesh)
    idx = np.array([9, 10], np.int64)
    rows = type(arrays)(*(x[idx] for x in arrays))
    out = ts.scatter_rows_sharded(tmesh, tdev, idx, rows)
    assert out[0] is tdev[0] and out[2] is tdev[2] and out[3] is tdev[3]
    assert out[1] is not tdev[1]
    with pytest.raises(ValueError, match="outside the node axis"):
        ts.scatter_rows_sharded(tmesh, tdev, np.array([32]), rows)


# ---------------------------------------------------------------------------
# cluster_probe_sharded


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


@pytest.mark.parametrize("D", DS)
def test_cluster_probe_sharded_bit_equal(D):
    pods = mesh_pods(18)
    arrays, batch = staged(mesh_nodes(), (), pods, n_bucket=N_BUCKET)
    jx, tx = _xs(batch, len(pods))
    jmesh, tmesh = meshes(D)
    jna, jc0 = jax_mesh_state(jmesh, arrays)
    tna, tc0 = torch_mesh_state(tmesh, arrays)
    jc, _ = js.run_batch_sharded(jp.ScoreConfig(), jmesh, jna, jc0, jx,
                                 jax_table(batch.table))
    tc, _ = ts.run_batch_sharded(tp.ScoreConfig(), tmesh, tna, tc0, tx,
                                 torch_table(batch.table))
    zone = np.array([i % 3 for i in range(N_BUCKET)], np.int32)
    for dom, ndom in ((zone, 3), (np.arange(N_BUCKET, dtype=np.int32), 20)):
        want = js.cluster_probe_sharded(jmesh, jna, jc, dom, ndom)
        got = ts.cluster_probe_sharded(tmesh, tna, tc, torch.from_numpy(dom),
                                       ndom)
        single = tp.cluster_probe(ts.unshard(tna), ts.unshard(tc),
                                  torch.from_numpy(dom), ndom)
        for a, b, c in zip(want, got, single):
            np.testing.assert_array_equal(_bits(a), _bits(b.numpy()))
            np.testing.assert_array_equal(_bits(c.numpy()),
                                          _bits(b.numpy()))


# ---------------------------------------------------------------------------
# the mesh itself


def test_make_mesh_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="devices="):
        ts.make_mesh(2)
    assert ts.make_mesh(devices=["cpu"] * 2).size == 2


def test_exchange_functions():
    mesh = ts.make_mesh(devices=["cpu"] * 4)
    xs = [torch.tensor([d, -d], dtype=torch.int64) for d in range(4)]
    assert ts.psum(mesh, xs)[3].tolist() == [6, -6]
    assert ts.pmax(mesh, xs)[0].tolist() == [3, 0]
    assert ts.pmin(mesh, xs)[1].tolist() == [0, -3]
    assert ts.all_gather(mesh, xs)[2].tolist() == [[0, 0], [1, -1], [2, -2],
                                                  [3, -3]]
    locs = [torch.tensor([1, 2, 5, 7]), torch.tensor([3, 4, 6, 1])]
    m2 = ts.make_mesh(devices=["cpu"] * 2)
    assert ts.lean_exchange(m2, locs)[1].tolist() == [4, 6, 6, 7]


def test_shard_and_unshard_round_trip():
    rng = random.Random(3)
    arrays, _ = staged(mesh_nodes(), (), [make_pod("p").obj()],
                       n_bucket=N_BUCKET)
    for D in DS:
        mesh = ts.make_mesh(devices=["cpu"] * D)
        sh = convert.node_arrays_to_shards(arrays, mesh)
        assert len(sh) == D and sh.rows == N_BUCKET
        back = convert.shards_to_numpy(sh)
        for f in arrays._fields:
            np.testing.assert_array_equal(getattr(arrays, f),
                                          getattr(back, f))
    with pytest.raises(ValueError, match="do not split"):
        convert.node_arrays_to_shards(
            arrays, ts.make_mesh(devices=["cpu"] * rng.choice([3, 5])))


@pytest.mark.parametrize("D", (2, 8))
def test_state_carried_over_from_jax(D):
    """The JAX package's mesh state after a scan, carried into the port's
    shards through numpy: the next closed-form run from it agrees."""
    pods = mesh_pods(12) + _uniform_pods(20)
    arrays, batch = staged(mesh_nodes(soft_taints=False), (), pods,
                           n_bucket=N_BUCKET)
    jx, _tx = _xs(batch, 12)
    jmesh, tmesh = meshes(D)
    jna, jc0 = jax_mesh_state(jmesh, arrays)
    jt, tt = jax_table(batch.table), torch_table(batch.table)
    jc1, _ = js.run_batch_sharded(jp.ScoreConfig(), jmesh, jna, jc0, jx, jt)
    tna, tc1 = shards_from_jax(jna, tmesh), shards_from_jax(jc1, tmesh,
                                                            carry=True)
    assert_sharded_carry_equal(jc1, tc1)
    sig, tidx = int(batch.sig[12]), int(batch.tidx[12])
    jc, jpk = js.run_uniform_sharded(
        jp.ScoreConfig(), jmesh, jna, jc1,
        jp.PodXs(valid=np.bool_(True), sig=np.int32(sig),
                 tidx=np.int32(tidx)), jt, np.int32(20), 32, 32, 8)
    tc, tpk = ts.run_uniform_sharded(tp.ScoreConfig(), tmesh, tna, tc1,
                                     tp.PodXs(True, sig, tidx), tt, 20, 32,
                                     32, 8)
    _eq(jpk, tpk)
    assert_sharded_carry_equal(jc, tc)


# ---------------------------------------------------------------------------
# run_gang_sharded: both tiers, accepted and rejected


def _gang_dom(arrays):
    """Topology domain ids in the scheduler's form: dense GLOBAL ids (the
    three zones of mesh_nodes, interleaved over every shard)."""
    return np.arange(arrays.used.shape[0], dtype=np.int32) % 3


def _gang_case(big: bool, two_sigs: bool):
    """Members of a gang over mesh_nodes: 1 cpu each (accepted), or 12
    cpu each, which only a few nodes hold (rejected, some placed)."""
    cpu = "12" if big else "1"
    pods = []
    for i in range(20):
        w = make_pod(f"t{i}").req({"cpu": cpu, "memory": "1Gi"})
        if two_sigs and i % 2:
            w = w.req({"cpu": cpu, "memory": "2Gi"})
        pods.append(w.workload("train").obj())
    return pods


def _sig_carry(carry, sig):
    return carry._replace(cache=carry.cache._replace(sig=sig))


@pytest.mark.parametrize("verdict", ["accept", "reject"])
@pytest.mark.parametrize("w_contig", [0, 2])
@pytest.mark.parametrize("D", DS)
def test_run_gang_sharded_scan(D, w_contig, verdict):
    from kubernetes_tpu.ops.gang import GangXs as JGangXs
    from kubernetes_tpu_torch.ops import gang as tgang
    pods = _gang_case(verdict == "reject", two_sigs=True)
    arrays, batch = staged(mesh_nodes(), (), pods, n_bucket=N_BUCKET)
    m = len(pods)
    tid = batch.tidx[:m]
    uniq = list(dict.fromkeys(int(t) for t in tid))
    S = pow2_at_least(len(uniq), 1)
    wt = (uniq + [uniq[-1]] * S)[:S]
    slot = {u: s for s, u in reversed(list(enumerate(wt)))}
    width = pow2_at_least(m)
    widx = np.full((width,), slot[int(tid[-1])], np.int32)
    widx[:m] = [slot[int(t)] for t in tid]
    tidx = np.full((width,), tid[-1], np.int32)
    tidx[:m] = tid
    valid = np.zeros((width,), bool)
    valid[:m] = True
    dom = _gang_dom(arrays)
    jmesh, tmesh = meshes(D)
    jna, jc0 = jax_mesh_state(jmesh, arrays)
    tna, tc0 = torch_mesh_state(tmesh, arrays)
    jc0 = _sig_carry(jc0, js.jax.device_put(np.int32(777)))
    tc0 = ts.with_cache_sig_sharded(tc0, 777)
    jt, tt = jax_table(batch.table), torch_table(batch.table)
    jwt = jnp.asarray(np.array(wt, np.int32))
    jst = tuple(js.jax.device_put(x, js.NamedSharding(
        jmesh, js.P(None, js.NODE_AXIS)))
        for x in jp.wave_statics(jax_na(arrays), jt, jwt))
    jdom = js.jax.device_put(dom, js.NamedSharding(jmesh, js.P(js.NODE_AXIS)))
    needed = m
    jc, jpk = js.run_gang_sharded(
        jp.ScoreConfig(), jmesh, jna, jc0,
        JGangXs(*(jnp.asarray(x) for x in (valid, tidx, widx))), jt,
        wt=jwt, needed=np.int32(needed), dom=jdom, statics=jst,
        w_contig=w_contig)
    n_local = N_BUCKET // D
    tdom = [torch.from_numpy(dom[d * n_local:(d + 1) * n_local].copy())
            for d in range(D)]
    tst = ts.wave_statics_sharded(tmesh, tna, tt, wt)
    txs = convert.gang_xs_from_numpy(tgang.GangXs(valid, tidx, widx), "cpu")
    before = convert.shards_to_numpy(tc0)
    tc, tpk = ts.run_gang_sharded(tp.ScoreConfig(), tmesh, tna, tc0, txs,
                                  tt, wt=wt, needed=needed, dom=tdom,
                                  statics=tst, w_contig=w_contig)
    _eq(jpk, tpk)
    assert_sharded_carry_equal(jc, tc)
    accept, placed = bool(tpk[width]), int(tpk[width + 1])
    assert accept == (verdict == "accept")
    assert 0 < placed and (accept or placed < needed)
    after = convert.shards_to_numpy(tc)
    if not accept:
        # a rejected gang leaves every shard's carry as it came
        for f in ("used", "nonzero_used", "npods"):
            np.testing.assert_array_equal(getattr(before, f),
                                          getattr(after, f))
        assert int(after.cache.sig) == 777
    else:
        assert int(after.cache.sig) == 0
    # the port's single-device scan tier
    sna = torch_na(arrays)
    sc, spk = tgang.run_gang(
        tp.ScoreConfig(), sna, tp.with_cache_sig(tp.initial_carry(sna), 777),
        txs, tt, wt=wt, needed=needed,
        dom=convert.dom_from_numpy(dom, "cpu"),
        statics=tp.wave_statics(sna, tt, wt), w_contig=w_contig)
    assert torch.equal(spk, tpk)
    assert_carry_equal(sc, convert.carry_from_numpy(after, "cpu"),
                       cache=False)


@pytest.mark.parametrize("verdict", ["accept", "reject"])
@pytest.mark.parametrize("D", DS)
def test_run_gang_sharded_uniform(D, verdict):
    from kubernetes_tpu_torch.ops import gang as tgang
    pods = _gang_case(verdict == "reject", two_sigs=False)
    arrays, batch = staged(mesh_nodes(soft_taints=False), (), pods,
                           n_bucket=N_BUCKET)
    m = len(pods)
    L, K, J = 32, 32, 8
    sig, tidx = int(batch.sig[0]), int(batch.tidx[0])
    jmesh, tmesh = meshes(D)
    jna, jc0 = jax_mesh_state(jmesh, arrays)
    tna, tc0 = torch_mesh_state(tmesh, arrays)
    jt, tt = jax_table(batch.table), torch_table(batch.table)
    jc, jpk = js.run_gang_sharded(
        jp.ScoreConfig(), jmesh, jna, jc0,
        jp.PodXs(valid=np.bool_(True), sig=np.int32(sig),
                 tidx=np.int32(tidx)), jt, needed=np.int32(m),
        uniform=True, n_actual=np.int32(m), L=L, K=K, J=J)
    x = tp.PodXs(True, sig, tidx)
    tc, tpk = ts.run_gang_sharded(tp.ScoreConfig(), tmesh, tna, tc0, x, tt,
                                  needed=m, uniform=True, n_actual=m, L=L,
                                  K=K, J=J)
    _eq(jpk, tpk)
    assert_sharded_carry_equal(jc, tc)
    assert bool(tpk[L]) == (verdict == "accept")
    sna = torch_na(arrays)
    sc, spk = tgang.run_gang(tp.ScoreConfig(), sna, tp.initial_carry(sna),
                             x, tt, needed=m, uniform=True, n_actual=m, L=L,
                             K=K, J=J)
    if bool(spk[L + 2]):
        # where both report exact, the single-device closed form agrees
        assert torch.equal(spk[:L + 2], tpk[:L + 2])
        assert_carry_equal(sc, convert.carry_from_numpy(
            convert.shards_to_numpy(tc), "cpu"))
