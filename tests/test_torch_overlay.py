"""The nominated-pod overlay of run_batch / run_uniform: the port ↔ the
JAX program, exact equality.

Same seeded inputs (numpy) through the JAX programs on the CPU and the
port's plain versions: a nominated-pod overlay (ovl_used / ovl_npods) over
the node rows, and per-pod `nom_idx` rows (-1 = not nominated) for the
scan's self-exclusion and consumption. Assignments, every carry field and
the SigCache must be equal, including the cases a naive port gets wrong:
a nominated pod bound on another node than its nomination (consumed at
the nominated row, not at the chosen one), two same-signature pods with
different nominations (the cached fit_ok stays signature-pure), and
rows without a nomination. The scheduler cases hold the overlay
fingerprint: a nomination change between two drains zeroes the resident
SigCache, in both packages."""

import random

import numpy as np
import pytest

import jax.numpy as jnp

from _torch_parity import (private_jax_compiles,  # noqa: F401
                           CPU, assert_carry_equal, jax_na, jax_table,
                           lean_cluster, lean_pod, staged, torch_na,
                           torch_table)
from kubernetes_tpu.framework.types import PodInfo as JPodInfo
from kubernetes_tpu.framework.types import QueuedPodInfo as JQueuedPodInfo
from kubernetes_tpu.ops import program as jp
from kubernetes_tpu.state.tensorize import pow2_at_least
from kubernetes_tpu.testing.wrappers import make_node, make_pod
from kubernetes_tpu_torch.framework.types import PodInfo as TPodInfo
from kubernetes_tpu_torch.framework.types import (QueuedPodInfo as
                                                  TQueuedPodInfo)
from kubernetes_tpu_torch.ops import program as tp
from kubernetes_tpu_torch.state import convert
from test_torch_scheduler import JAX, TORCH, make_scheduler

import torch

torch.set_num_threads(1)


def _eq(a, b):
    a = np.asarray(a)
    b = b.numpy()
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


def _overlay(batch, n_nodes, N, R, nominated, extra, rng):
    """numpy (ovl_used [N, R], ovl_npods [N], nom_idx [B]): every
    nominated pod's own request at its row (as the scheduler builds it),
    plus `extra` nominations of other pods on random nodes."""
    ovl_used = np.zeros((N, R), np.int64)
    ovl_npods = np.zeros((N,), np.int32)
    nom_idx = np.full((len(batch.valid),), -1, np.int32)
    for i, row in nominated.items():
        nom_idx[i] = row
        ovl_used[row] += batch.table.req[batch.tidx[i]]
        ovl_npods[row] += 1
    for _ in range(extra):
        row = rng.randrange(n_nodes)
        ovl_used[row] += batch.table.req[batch.tidx[rng.randrange(
            len(batch.valid))]]
        ovl_npods[row] += 1
    return ovl_used, ovl_npods, nom_idx


def scan_both(nodes, bound, pods, nominated, extra=0, seed=0,
              cfg=jp.ScoreConfig(), use_nom=True):
    """run_batch under an overlay in both packages; returns the port's
    assignments (numpy)."""
    rng = random.Random(seed)
    arrays, batch = staged(nodes, bound, pods)
    N, R = arrays.used.shape
    ovl_used, ovl_npods, nom_idx = _overlay(batch, len(nodes), N, R,
                                            nominated, extra, rng)
    B = len(batch.valid)
    xs = jp.PodXs(valid=batch.valid[:B], sig=batch.sig[:B],
                  tidx=batch.tidx[:B],
                  nom_idx=nom_idx[:B] if use_nom else None)
    jna, tna = jax_na(arrays), torch_na(arrays)
    jc, ja = jp.run_batch(
        cfg, jna, jp.initial_carry(jna),
        jp.PodXs(valid=jnp.asarray(xs.valid), sig=jnp.asarray(xs.sig),
                 tidx=jnp.asarray(xs.tidx),
                 nom_idx=None if xs.nom_idx is None
                 else jnp.asarray(xs.nom_idx)),
        jax_table(batch.table),
        overlay=(jnp.asarray(ovl_used), jnp.asarray(ovl_npods)))
    t_ovl = (torch.from_numpy(ovl_used), torch.from_numpy(ovl_npods))
    tc, ta = tp.run_batch(tp.ScoreConfig(*cfg), tna, tp.initial_carry(tna),
                          convert.pod_xs_from_numpy(xs, CPU),
                          torch_table(batch.table), overlay=t_ovl)
    _eq(ja, ta)
    assert_carry_equal(jc, tc)
    # the caller's overlay is never written
    np.testing.assert_array_equal(t_ovl[0].numpy(), ovl_used)
    np.testing.assert_array_equal(t_ovl[1].numpy(), ovl_npods)
    return ta.numpy()


@pytest.mark.parametrize("seed", range(16))
def test_run_batch_overlay_fuzz(seed):
    rng = random.Random(seed)
    nodes = lean_cluster(rng, rng.randint(3, 24))
    bound = [make_pod(f"pre{i}").req({"cpu": "500m", "memory": "1Gi"})
             .node(nodes[rng.randrange(len(nodes))].metadata.name).obj()
             for i in range(rng.randint(0, 10))]
    pods = [lean_pod(rng, f"p{i}") for i in range(rng.randint(8, 48))]
    nominated = {i: rng.randrange(len(nodes))
                 for i in rng.sample(range(len(pods)),
                                     rng.randint(0, len(pods) // 3))}
    a = scan_both(nodes, bound, pods, nominated, extra=rng.randint(0, 6),
                  seed=seed)
    assert (a >= 0).any()


@pytest.mark.parametrize("seed", range(4))
def test_run_batch_overlay_without_nominated_pods(seed):
    """An overlay-only scan (nom_idx None): nothing is consumed."""
    rng = random.Random(100 + seed)
    nodes = lean_cluster(rng, 12)
    pods = [lean_pod(rng, f"p{i}") for i in range(24)]
    scan_both(nodes, (), pods, {}, extra=8, seed=seed, use_nom=False)


def _two_nodes(cpu0=4, cpu1=8):
    return [make_node("n0").capacity({"cpu": cpu0, "memory": "16Gi",
                                      "pods": 110}).obj(),
            make_node("n1").capacity({"cpu": cpu1, "memory": "16Gi",
                                      "pods": 110}).obj()]


def test_nominated_pod_bound_elsewhere_consumes_its_nominated_row():
    """p0 is nominated on n0 but n1 (empty, larger) scores higher: it
    binds n1, and its nomination is consumed at n0 — so the three 4-cpu
    pods (three signatures: each takes the slow path) fill the 12 cpu
    exactly. Consuming at the chosen node would over-commit n1; not
    consuming would leave n0 reserved and p2 unplaced."""
    nodes = _two_nodes()
    pods = [make_pod(f"p{i}").req({"cpu": "4", "memory": f"{i + 1}Gi"})
            .obj() for i in range(3)]
    a = scan_both(nodes, (), pods, {0: 0})
    assert a[0] == 1
    assert sorted(a[:3].tolist()) == [0, 1, 1]


def test_consumed_row_stays_stale_in_the_signature_cache():
    """The same pods with ONE signature: the consumption at n0 is not
    seen by the SigCache, which is refreshed only at the chosen row (n1)
    — the cached fit_ok at n0 stays stale until the next slow path, as in
    the JAX scan, so p2 finds no node."""
    nodes = _two_nodes()
    pods = [make_pod(f"p{i}").req({"cpu": "4", "memory": "1Gi"}).obj()
            for i in range(3)]
    a = scan_both(nodes, (), pods, {0: 0})
    assert list(a[:3]) == [1, 1, -1]


def test_same_signature_pods_with_different_nominations():
    """Two same-signature pods nominated on different nodes share the
    SigCache fast path: the self-exclusion is applied to the effective
    mask only, never written into the cached fit_ok."""
    nodes = _two_nodes(cpu0=4, cpu1=4)
    bound = [make_pod("hog0").req({"cpu": "2", "memory": "1Gi"})
             .node("n0").obj(),
             make_pod("hog1").req({"cpu": "2", "memory": "1Gi"})
             .node("n1").obj()]
    pods = [make_pod(f"p{i}").req({"cpu": "2", "memory": "1Gi"}).obj()
            for i in range(3)]
    a = scan_both(nodes, bound, pods, {0: 1, 1: 0})
    # each nominated pod lands on its own reserved row; the third pod,
    # not nominated, finds no room
    assert list(a[:3]) == [1, 0, -1]


def test_rows_without_nomination_see_the_full_overlay():
    nodes = _two_nodes(cpu0=4, cpu1=4)
    pods = [make_pod(f"p{i}").req({"cpu": "4", "memory": "1Gi"}).obj()
            for i in range(2)]
    # p1 is nominated on n1; p0 (nom_idx -1) must not take n1
    a = scan_both(nodes, (), pods, {1: 1})
    assert list(a[:2]) == [0, 1]


# ---------------------------------------------------------------------------
# run_uniform


def uniform_both(nodes, bound, n_pods, L, K, J, ovl_rows, req):
    pods = [make_pod(f"p{i}").req(req).obj() for i in range(n_pods)]
    arrays, batch = staged(nodes, bound, pods)
    N, R = arrays.used.shape
    ovl_used = np.zeros((N, R), np.int64)
    ovl_npods = np.zeros((N,), np.int32)
    for row, vec, cnt in ovl_rows:
        ovl_used[row, :len(vec)] += vec
        ovl_npods[row] += cnt
    jna, tna = jax_na(arrays), torch_na(arrays)
    cfg = jp.ScoreConfig()
    sig, tidx = int(batch.sig[0]), int(batch.tidx[0])
    jc, jpk = jp.run_uniform(
        cfg, jna, jp.initial_carry(jna),
        jp.PodXs(valid=np.bool_(True), sig=np.int32(sig),
                 tidx=np.int32(tidx)),
        jax_table(batch.table), np.int32(n_pods), L, K, J,
        overlay=(jnp.asarray(ovl_used), jnp.asarray(ovl_npods)))
    tc, tpk = tp.run_uniform(
        tp.ScoreConfig(), tna, tp.initial_carry(tna),
        tp.PodXs(True, sig, tidx), torch_table(batch.table), n_pods, L, K,
        J, overlay=(torch.from_numpy(ovl_used),
                    torch.from_numpy(ovl_npods)))
    _eq(jpk, tpk)
    assert_carry_equal(jc, tc)
    return tpk.numpy()


@pytest.mark.parametrize("seed", range(8))
def test_run_uniform_overlay_fuzz(seed):
    rng = random.Random(seed)
    n = rng.randint(2, 30)
    nodes = [make_node(f"n{i}").capacity(
        {"cpu": rng.randint(2, 32), "memory": f"{rng.randint(4, 64)}Gi",
         "pods": rng.randint(3, 20)}).obj() for i in range(n)]
    bound = [make_pod(f"pre{i}").req(
        {"cpu": str(rng.randint(0, 3)), "memory": f"{rng.randint(0, 4)}Gi"})
        .node(f"n{rng.randrange(n)}").obj()
        for i in range(rng.randint(0, 3 * n))]
    ovl_rows = [(rng.randrange(n),
                 [rng.randint(0, 8) * 1000, rng.randint(0, 8) << 30],
                 rng.randint(1, 3)) for _ in range(rng.randint(1, n))]
    L, K = 64, 32
    J = min(max(pow2_at_least(4 * L // pow2_at_least(n) + 4), 8), L + 1)
    uniform_both(nodes, bound, rng.randint(16, 64), L, K, J, ovl_rows,
                 {"cpu": str(rng.randint(1, 4)),
                  "memory": f"{rng.randint(0, 4)}Gi"})


# csrc/run_uniform.cu's branches under the overlay at 32 node rows:
# name → (nodes, L, K, J, pods, pod cpu)
OVERLAY_SHAPES = {
    "select_rows": (20, 32, 8, 8, 24, "1"),
    "all_rows": (20, 64, 32, 8, 50, "1"),
    "fewer_feasible": (20, 64, 32, 4, 60, "3"),
}


@pytest.mark.parametrize("shape", sorted(OVERLAY_SHAPES))
def test_run_uniform_overlay_branch_shapes(shape):
    n, L, K, J, n_pods, cpu = OVERLAY_SHAPES[shape]
    rng = random.Random(7)
    nodes = [make_node(f"n{i}").capacity(
        {"cpu": rng.randint(2, 8), "memory": "32Gi", "pods": 110}).obj()
        for i in range(n)]
    # a third of the nodes hold nominations of 1-4 cpu
    ovl_rows = [(r, [rng.randint(1, 4) * 1000, 1 << 30], 1)
                for r in range(0, n, 3)]
    packed = uniform_both(nodes, (), n_pods, L, K, J, ovl_rows,
                          {"cpu": cpu, "memory": "1Gi"})
    if shape == "fewer_feasible":
        assert (packed[:n_pods] == -1).any()


def test_run_uniform_overlay_reserves_the_nominated_node():
    """n1 is empty and the best score, but an 8-cpu nomination reserves
    it whole: the run goes to n0 only."""
    nodes = _two_nodes(cpu0=8, cpu1=8)
    bound = [make_pod("b").req({"cpu": "4", "memory": "1Gi"}).node("n0")
             .obj()]
    packed = uniform_both(nodes, bound, 16, 16, 2, 17,
                          [(1, [8000, 1 << 30], 1)],
                          {"cpu": "250m", "memory": "256Mi"})
    assert set(packed[:16].tolist()) == {0}
    assert packed[16] == 1 and packed[17] == 1


# ---------------------------------------------------------------------------
# the overlay fingerprint (the scheduler's resident SigCache)


def _fingerprint_case(pkg, QPI, PI):
    """tests/test_preemption_batched.py TestOverlayCarryInvalidation:
    a nomination arriving between two same-signature drains must zero
    the resident SigCache, or the second drain reuses a fit_ok computed
    without the overlay and binds onto the nominated node."""
    w, Api = pkg[0], pkg[1]
    api = Api()
    sched = make_scheduler(pkg, api, 64)
    for i in range(2):
        api.create_node(w.make_node(f"n{i}").capacity(
            {"cpu": 4, "memory": "16Gi", "pods": 110}).obj())
    api.create_pod(w.make_pod("a1").req({"cpu": "4", "memory": "1Gi"})
                   .obj())
    assert sched.schedule_pending() == 1
    sig_before = int(sched._device_carry.cache.sig)
    nom = w.make_pod("vip").req({"cpu": "4", "memory": "1Gi"}) \
        .priority(100).obj()
    free_node = ("n1" if api.pods["default/a1"].spec.node_name == "n0"
                 else "n0")
    # through the nominator only: the device carry stays resident
    sched.queue.nominator.add(QPI(pod_info=PI.of(nom)), free_node)
    api.create_pod(w.make_pod("a2").req({"cpu": "4", "memory": "1Gi"})
                   .obj())
    sched.schedule_pending()
    return (sig_before, sched._carry_ovl_fp,
            api.pods["default/a2"].spec.node_name,
            sorted(sched.queue.nominator.nominated_pods.items()))


def test_nomination_change_invalidates_sig_cache():
    j = _fingerprint_case(JAX, JQueuedPodInfo, JPodInfo)
    t = _fingerprint_case(TORCH, TQueuedPodInfo, TPodInfo)
    assert t == j
    sig_before, fp, a2_node, _noms = t
    assert sig_before != 0 and fp >= 0
    assert a2_node == ""


def test_fingerprint_zeroes_the_carry_sig():
    """Directly: the resident carry keeps its signature while the
    nominations stay as they are, and loses it when they change."""
    api = TORCH[1]()
    sched = make_scheduler(TORCH, api, 64)
    w = TORCH[0]
    for i in range(3):
        api.create_node(w.make_node(f"n{i}").capacity(
            {"cpu": 8, "memory": "16Gi", "pods": 110}).obj())
    api.create_pod(w.make_pod("a1").req({"cpu": "1"}).obj())
    sched.schedule_pending()
    carry = sched._device_carry
    assert int(carry.cache.sig) != 0
    nom = w.make_pod("vip").req({"cpu": "1"}).priority(100).obj()
    sched.queue.nominator.add(TQueuedPodInfo(pod_info=TPodInfo.of(nom)),
                              "n2")
    calls = []
    real = sched._dispatch_runs

    def spy(profile, na, carry, *a, **kw):
        calls.append((int(carry.cache.sig), kw.get("ovl") is not None))
        return real(profile, na, carry, *a, **kw)
    sched._dispatch_runs = spy
    api.create_pod(w.make_pod("a2").req({"cpu": "1"}).obj())
    sched.schedule_pending()
    api.create_pod(w.make_pod("a3").req({"cpu": "1"}).obj())
    sched.schedule_pending()
    # first drain after the nomination: sig zeroed, overlay on; second
    # drain, same nominations: the cache carries over
    assert calls[0] == (0, True)
    assert calls[1][0] != 0 and calls[1][1]
