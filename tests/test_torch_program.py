"""The port's plain device program ↔ the JAX program, exact equality.

Same seeded inputs (numpy) go through the JAX functions on the CPU and
through the plain PyTorch versions of kubernetes_tpu_torch/ops/program.py
(CPU tensors select the plain versions). The programs are integer
arithmetic plus one float64 floor, so the tolerance everywhere is exact
equality: assignments, every carry field, and the SigCache wherever its
signature is nonzero. run_uniform and initial_carry are held to the JAX
program in tests/test_torch_uniform.py."""

import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_parity import (private_jax_compiles,  # noqa: F401
                           CPU, assert_carry_equal, jax_na, jax_table,
                           lean_cluster, lean_pod, staged, torch_na,
                           torch_table)
from kubernetes_tpu.ops import program as jp
from kubernetes_tpu.testing.wrappers import make_node, make_pod
from kubernetes_tpu_torch.ops import program as tp
from kubernetes_tpu_torch.state import convert

I64_MIN = np.iinfo(np.int64).min


# ---------------------------------------------------------------------------
# random raw arrays for the per-node functions


def _raw_nodes(rs: np.random.RandomState, N=48, R=4, T=4, L=6, P=4, I=4):
    cap = rs.randint(0, 12, (N, R)).astype(np.int64)
    cap[rs.rand(N, R) < 0.2] = 0
    used = (cap * rs.rand(N, R) * 1.3).astype(np.int64)
    label_num = rs.randint(-3, 8, (N, L)).astype(np.int64)
    label_num[rs.rand(N, L) < 0.4] = I64_MIN
    ports = rs.randint(0, 5, (N, P)).astype(np.int32)
    return jp.NodeArrays(
        cap=cap, used=used,
        nonzero_used=rs.randint(0, 12, (N, 2)).astype(np.int64),
        npods=rs.randint(0, 6, (N,)).astype(np.int32),
        allowed_pods=rs.randint(0, 6, (N,)).astype(np.int32),
        valid=rs.rand(N) < 0.9, unschedulable=rs.rand(N) < 0.2,
        name_id=rs.randint(0, 6, (N,)).astype(np.int32),
        taint_key=rs.randint(0, 4, (N, T)).astype(np.int32),
        taint_val=rs.randint(0, 4, (N, T)).astype(np.int32),
        taint_eff=rs.randint(0, 4, (N, T)).astype(np.int32),
        label_key=rs.randint(0, 5, (N, L)).astype(np.int32),
        label_kv=rs.randint(0, 9, (N, L)).astype(np.int32),
        label_num=label_num, ports=ports,
        image_id=rs.randint(0, 6, (N, I)).astype(np.int32),
        image_size=(rs.randint(0, 900, (N, I)) * 1024 * 1024
                    ).astype(np.int64))


def _raw_table(rs: np.random.RandomState, U=6, R=4, TT=4, Q=3, Tm=2, V=3,
               PT=2, PP=3, IC=3):
    return jp.PodTableDev(
        req=rs.randint(0, 4, (U, R)).astype(np.int64),
        nonzero_req=rs.randint(0, 4, (U, 2)).astype(np.int64),
        node_name_id=rs.randint(0, 3, (U,)).astype(np.int32),
        tol_key=rs.randint(0, 4, (U, TT)).astype(np.int32),
        tol_val=rs.randint(0, 4, (U, TT)).astype(np.int32),
        tol_eff=rs.randint(0, 4, (U, TT)).astype(np.int32),
        tol_op=rs.randint(0, 3, (U, TT)).astype(np.int32),
        tolerates_unsched=rs.rand(U) < 0.3,
        ns_sel_val=(rs.randint(0, 9, (U, Q)) * (rs.rand(U, Q) < 0.4)
                    ).astype(np.int32),
        aff_has=rs.rand(U) < 0.5, aff_term_valid=rs.rand(U, Tm) < 0.7,
        aff_key=rs.randint(0, 5, (U, Tm, Q)).astype(np.int32),
        aff_op=rs.randint(0, 8, (U, Tm, Q)).astype(np.int32),
        aff_num=rs.randint(-2, 8, (U, Tm, Q)).astype(np.int64),
        aff_val=rs.randint(0, 9, (U, Tm, Q, V)).astype(np.int32),
        pref_weight=rs.randint(0, 10, (U, PT)).astype(np.int64),
        pref_key=rs.randint(0, 5, (U, PT, Q)).astype(np.int32),
        pref_op=rs.randint(0, 7, (U, PT, Q)).astype(np.int32),
        pref_num=rs.randint(-2, 8, (U, PT, Q)).astype(np.int64),
        pref_val=rs.randint(0, 9, (U, PT, Q, V)).astype(np.int32),
        port_ids=(rs.randint(0, 5, (U, PP)) * (rs.rand(U, PP) < 0.5)
                  ).astype(np.int32),
        skip_balanced=rs.rand(U) < 0.2,
        img_ids=rs.randint(0, 6, (U, IC)).astype(np.int32),
        img_containers=rs.randint(0, 3, (U,)).astype(np.int32))


def _rows(rs, u):
    """(JAX PodRow, port PodRow) for table row u of a random table."""
    nt = _raw_table(rs)
    jrow = jp._gather_row(jax_table(nt), jp.PodXs(
        valid=jnp.bool_(True), sig=jnp.int32(0), tidx=jnp.int32(u)))
    trow = tp._gather_row(torch_table(nt), u, True, 0)
    return jrow, trow


def _eq(a, b):
    a = np.asarray(a)
    b = b.numpy()
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", range(4))
def test_filter_functions(seed):
    rs = np.random.RandomState(seed)
    nn = _raw_nodes(rs)
    jna, tna = jax_na(nn), torch_na(nn)
    for u in range(6):
        rs_u = np.random.RandomState(seed * 100 + u)
        jrow, trow = _rows(rs_u, u)
        _eq(jp.fit_mask(jna.cap, jna.used, jna.npods, jna.allowed_pods,
                        jrow.req),
            tp.fit_mask(tna.cap, tna.used, tna.npods, tna.allowed_pods,
                        trow.req))
        _eq(jp.taint_filter_mask(jna, jrow), tp.taint_filter_mask(tna, trow))
        _eq(jp.taint_prefer_count(jna, jrow),
            tp.taint_prefer_count(tna, trow))
        _eq(jp.selector_mask(jna, jrow), tp.selector_mask(tna, trow))
        _eq(jp.preferred_affinity_score(jna, jrow),
            tp.preferred_affinity_score(tna, trow))
        _eq(jp.ports_mask(jna.ports, jrow.port_ids),
            tp.ports_mask(tna.ports, trow.port_ids))
        _eq(jp.image_locality_score(jna, jrow),
            tp.image_locality_score(tna, trow))


@pytest.mark.parametrize("strategy", ["LeastAllocated", "MostAllocated"])
@pytest.mark.parametrize("seed", range(3))
def test_least_allocated(strategy, seed):
    rs = np.random.RandomState(seed)
    cap = rs.randint(0, 50, (200, 3)).astype(np.int64)
    used = rs.randint(0, 60, (200, 3)).astype(np.int64)
    jcfg = jp.ScoreConfig(score_cols=(0, 1, 2), col_weights=(1, 2, 3),
                          col_nonzero=(True, True, False),
                          nonzero_slot=(0, 1, 0), strategy=strategy)
    tcfg = tp.ScoreConfig(*jcfg)
    _eq(jp.least_allocated(jcfg, jnp.asarray(cap), jnp.asarray(used)),
        tp.least_allocated(tcfg, torch.from_numpy(cap),
                           torch.from_numpy(used)))


def _boundary_cases(rs, C, n=4000):
    """Caps and usages biased to exact fractions, where (1 − std)·100 lands
    on or next to an integer and the floor is decided by the last ulp."""
    cap = rs.choice([1, 2, 3, 4, 5, 8, 10, 16, 20, 25, 100, 1000, 1 << 30],
                    (n, C)).astype(np.int64)
    used = (cap * rs.choice([0, 1, 2, 3, 4, 5, 8, 10], (n, C))
            // rs.choice([1, 2, 4, 5, 8, 10], (n, C))).astype(np.int64)
    cap[rs.rand(n, C) < 0.05] = 0
    return cap, used


@pytest.mark.parametrize("C", [2, 3])
def test_balanced_allocation(C):
    rs = np.random.RandomState(C)
    cap, used = _boundary_cases(rs, C)
    _eq(jp.balanced_allocation(jnp.asarray(cap), jnp.asarray(used)),
        tp.balanced_allocation(torch.from_numpy(cap), torch.from_numpy(used)))
    rand_cap = rs.randint(1, 1 << 20, (4000, C)).astype(np.int64)
    rand_used = rs.randint(0, 1 << 20, (4000, C)).astype(np.int64)
    _eq(jp.balanced_allocation(jnp.asarray(rand_cap),
                               jnp.asarray(rand_used)),
        tp.balanced_allocation(torch.from_numpy(rand_cap),
                               torch.from_numpy(rand_used)))


@pytest.mark.parametrize("reverse", [False, True])
def test_default_normalize(reverse):
    rs = np.random.RandomState(7)
    for _ in range(20):
        scores = rs.randint(0, 9, (64,)).astype(np.int64)
        feasible = rs.rand(64) < rs.rand()
        _eq(jp.default_normalize(jnp.asarray(scores), jnp.asarray(feasible),
                                 reverse),
            tp.default_normalize(torch.from_numpy(scores),
                                 torch.from_numpy(feasible), reverse))


# ---------------------------------------------------------------------------
# run_batch


def _both_batch(nodes, bound, pods, cfg=jp.ScoreConfig(), prefix=None):
    arrays, batch = staged(nodes, bound, pods)
    jna, tna = jax_na(arrays), torch_na(arrays)
    jtab, ttab = jax_table(batch.table), torch_table(batch.table)
    jc0 = jp.initial_carry(jna)
    tc0 = tp.initial_carry(tna)
    B = len(batch.valid) if prefix is None else prefix
    xs = jp.PodXs(valid=batch.valid[:B], sig=batch.sig[:B],
                  tidx=batch.tidx[:B])
    jc, ja = jp.run_batch(cfg, jna, jc0, jp.PodXs(
        valid=jnp.asarray(xs.valid), sig=jnp.asarray(xs.sig),
        tidx=jnp.asarray(xs.tidx)), jtab)
    tc, ta = tp.run_batch(tp.ScoreConfig(*cfg), tna, tc0,
                          convert.pod_xs_from_numpy(xs, CPU), ttab)
    _eq(ja, ta)
    assert_carry_equal(jc, tc)
    return np.asarray(ja)


@pytest.mark.parametrize("seed", range(24))
def test_run_batch_fuzz(seed):
    rng = random.Random(seed)
    nodes = lean_cluster(rng, rng.randint(3, 30))
    bound = [make_pod(f"pre{i}").req({"cpu": "500m", "memory": "1Gi"})
             .node(nodes[rng.randrange(len(nodes))].metadata.name).obj()
             for i in range(rng.randint(0, 10))]
    pods = [lean_pod(rng, f"p{i}") for i in range(rng.randint(5, 60))]
    strategy = "MostAllocated" if seed % 5 == 4 else "LeastAllocated"
    a = _both_batch(nodes, bound, pods, jp.ScoreConfig(strategy=strategy))
    assert (a >= 0).any()


def test_run_batch_same_signature_runs_use_the_cache():
    """Long same-signature runs exercise the SigCache fast path and its
    one-row refresh; the final cache must equal the JAX scan's."""
    nodes = [make_node(f"n{i}").capacity(
        {"cpu": str(4 + i % 3), "memory": f"{8 + 4 * (i % 2)}Gi",
         "pods": 6}).obj() for i in range(10)]
    pods = ([make_pod(f"a{i}").req({"cpu": "500m", "memory": "1Gi"}).obj()
             for i in range(30)]
            + [make_pod(f"b{i}").req({"cpu": "1", "memory": "256Mi"}).obj()
               for i in range(30)])
    a = _both_batch(nodes, (), pods)
    assert (a[:60] >= 0).sum() >= 50
