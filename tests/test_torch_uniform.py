"""The port's plain run_uniform and initial_carry ↔ the JAX program.

Same seeded inputs (numpy) through the JAX functions on the CPU and the
plain PyTorch versions of kubernetes_tpu_torch/ops/program.py. Tolerance:
exact equality of the packed output (assignments, exactness flag, depth
flag), every carry field and the SigCache — including the cases where a
flag drops (monotonicity, normalization, depth overflow)."""

import random

import numpy as np
import pytest
import torch

from _torch_parity import (private_jax_compiles,  # noqa: F401
                           assert_carry_equal, jax_na, jax_table,
                           lean_cluster, staged, torch_na, torch_table)
from kubernetes_tpu.ops import program as jp
from kubernetes_tpu.state.tensorize import pow2_at_least
from kubernetes_tpu.testing.wrappers import make_node, make_pod
from kubernetes_tpu_torch.ops import program as tp


def _eq(a, b):
    a = np.asarray(a)
    b = b.numpy()
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


def _both_uniform(nodes, bound, n_pods, L, K, J, req=None, pod=None,
                  strategy="LeastAllocated"):
    pods = [pod or make_pod(f"p{i}").req(req or {"cpu": "1",
                                                 "memory": "1Gi"}).obj()
            for i in range(max(n_pods, 1))]
    arrays, batch = staged(nodes, bound, pods)
    jna, tna = jax_na(arrays), torch_na(arrays)
    jtab, ttab = jax_table(batch.table), torch_table(batch.table)
    sig, tidx = int(batch.sig[0]), int(batch.tidx[0])
    jc, jpk = jp.run_uniform(
        jp.ScoreConfig(strategy=strategy), jna, jp.initial_carry(jna),
        jp.PodXs(valid=np.bool_(True), sig=np.int32(sig),
                 tidx=np.int32(tidx)),
        jtab, np.int32(n_pods), L, K, J)
    tna_in = tp.initial_carry(tna)
    before = [t.clone() for t in list(tna_in[:4]) + list(tna_in.cache)]
    tc, tpk = tp.run_uniform(tp.ScoreConfig(strategy=strategy), tna, tna_in,
                             tp.PodXs(True, sig, tidx), ttab, n_pods, L, K,
                             J)
    _eq(jpk, tpk)
    assert_carry_equal(jc, tc)
    # the input carry is never written
    for a, b in zip(before, list(tna_in[:4]) + list(tna_in.cache)):
        assert torch.equal(a, b)
    return tpk.numpy()


@pytest.mark.parametrize("seed", range(10))
def test_run_uniform_fuzz(seed):
    rng = random.Random(seed)
    n = rng.randint(2, 30)
    nodes = [make_node(f"n{i}").capacity(
        {"cpu": rng.randint(2, 32), "memory": f"{rng.randint(4, 64)}Gi",
         "pods": rng.randint(3, 20)}).obj() for i in range(n)]
    bound = [make_pod(f"pre{i}").req(
        {"cpu": str(rng.randint(0, 3)), "memory": f"{rng.randint(0, 4)}Gi"})
        .node(f"n{rng.randrange(n)}").obj() for i in range(rng.randint(0, 3 * n))]
    n_pods = rng.randint(16, 64)
    # the scheduler's _uniform_shape at batch 64 over the 32-row bucket
    L, K = 64, 32
    J = min(max(pow2_at_least(4 * L // pow2_at_least(n) + 4), 8), L + 1)
    _both_uniform(nodes, bound, n_pods, L, K, J,
                  req={"cpu": str(rng.randint(0, 4)),
                       "memory": f"{rng.randint(0, 4)}Gi"})


def test_run_uniform_depth_overflow():
    nodes = [make_node(f"n{i}").capacity(
        {"cpu": 64, "memory": "128Gi", "pods": 110}).obj() for i in range(2)]
    packed = _both_uniform(nodes, (), 32, 32, 8, 8)
    assert packed[32] == 1 and packed[33] == 0
    packed = _both_uniform(nodes, (), 32, 32, 8, 33)
    assert packed[32] == 1 and packed[33] == 1


def test_run_uniform_monotonicity_failure():
    """A cpu-saturated node whose memory is idle: memory-heavy run pods make
    BalancedAllocation climb faster than LeastAllocated falls, so the
    candidate's score sequence increases — the exactness flag drops."""
    nodes = [make_node("n0").capacity(
        {"cpu": "4", "memory": "64Gi", "pods": 110}).obj(),
             make_node("n1").capacity(
        {"cpu": "4", "memory": "64Gi", "pods": 110}).obj()]
    bound = [make_pod("hog").req({"cpu": "3900m", "memory": "0"})
             .node("n0").obj()]
    packed = _both_uniform(nodes, bound, 16, 16, 8, 17,
                           req={"cpu": "0", "memory": "6Gi"})
    assert packed[16] == 0


def test_run_uniform_norm_failure():
    nodes = [make_node(f"n{i}").capacity(
        {"cpu": "8", "memory": "16Gi", "pods": 110}).label(
        "tier", "gold" if i % 2 else "silver").obj() for i in range(4)]
    pod = (make_pod("p").req({"cpu": "1", "memory": "1Gi"})
           .preferred_node_affinity_in("tier", ["gold"], 5).obj())
    packed = _both_uniform(nodes, (), 8, 8, 4, 9, pod=pod)
    assert packed[8] == 0


def test_initial_carry():
    rng = random.Random(3)
    nodes = lean_cluster(rng, 12)
    bound = [make_pod(f"pre{i}").req({"cpu": "1", "memory": "1Gi"})
             .host_port(80 + i).node(f"n{i}").obj() for i in range(5)]
    arrays, _ = staged(nodes, bound)
    jc = jp.initial_carry(jax_na(arrays))
    tna = torch_na(arrays)
    tc = tp.initial_carry(tna)
    assert_carry_equal(jc, tc, cache=False)
    for f in tp.SigCache._fields:
        _eq(getattr(jc.cache, f), getattr(tc.cache, f))
    # copies, never views of the resident node arrays
    assert tc.used.data_ptr() != tna.used.data_ptr()


def _nodes(n, rng, cpu=(2, 32), identical=False):
    if identical:
        return [make_node(f"n{i}").capacity(
            {"cpu": 8, "memory": "16Gi", "pods": 110}).obj()
            for i in range(n)]
    return [make_node(f"n{i}").capacity(
        {"cpu": rng.randint(*cpu), "memory": f"{rng.randint(4, 64)}Gi",
         "pods": rng.randint(3, 20)}).obj() for i in range(n)]


# csrc/run_uniform.cu's branches at the parity tests' 32 node rows:
# name → (nodes, identical, pod cpu, L, K, J, n_pods, strategy). K < 32
# selects the candidate rows, K = 32 takes every row; n_pods below L
# counts only the first n_pods entries
UNIFORM_SHAPES = {
    "select_rows": (20, False, "1", 32, 8, 8, 20, "LeastAllocated"),
    "all_rows": (20, False, "1", 64, 32, 8, 50, "LeastAllocated"),
    "fewer_feasible": (20, False, "6", 64, 32, 4, 60, "LeastAllocated"),
    "ties": (12, True, "1", 32, 8, 4, 32, "LeastAllocated"),
    "j2": (6, False, "1", 32, 32, 2, 30, "LeastAllocated"),
    "most_allocated": (10, False, "1", 32, 16, 8, 20, "MostAllocated"),
}


@pytest.mark.parametrize("shape", sorted(UNIFORM_SHAPES))
def test_run_uniform_branch_shapes(shape):
    n, identical, cpu, L, K, J, n_pods, strategy = UNIFORM_SHAPES[shape]
    rng = random.Random(len(shape))
    nodes = _nodes(n, rng, cpu=(4, 8) if shape == "fewer_feasible"
                   else (2, 32), identical=identical)
    packed = _both_uniform(nodes, (), n_pods, L, K, J,
                           req={"cpu": cpu, "memory": "1Gi"},
                           strategy=strategy)
    assigned = packed[:L]
    if shape == "fewer_feasible":
        assert (assigned[:n_pods] == -1).any()
    if shape == "ties":
        # identical rows: the lowest rows first, each a candidate
        assert set(assigned[:n_pods].tolist()) <= set(range(K))
    if shape == "j2":
        assert packed[L + 1] == 0
    if shape == "most_allocated":
        assert packed[L] == 0
