"""Shared builders for the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs are made once, as numpy, and handed to both packages: the JAX
package through `jnp.asarray`, the port through its state/convert.py. The
cluster objects are the JAX package's (its testing wrappers); the port
never sees them here, only the arrays."""

from __future__ import annotations

import random

import numpy as np
import pytest
import torch

import kubernetes_tpu  # noqa: F401  (enables x64 before any jnp array)
import jax.numpy as jnp

from kubernetes_tpu.backend.cache import Cache, Snapshot
from kubernetes_tpu.ops import program as jp
from kubernetes_tpu.state.batch import BatchBuilder, BatchDims
from kubernetes_tpu.state.tensorize import ClusterState
from kubernetes_tpu.testing.wrappers import make_node, make_pod

from kubernetes_tpu_torch.ops import program as tp
from kubernetes_tpu_torch.state import convert

CPU = "cpu"

# the parity inputs are small: one intra-op thread per test process keeps
# parallel test workers from oversubscribing the cores
torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def private_jax_compiles():
    """Keep the port's parity tests out of the persistent JAX compilation
    cache the suite shares: they neither seed nor consume the entries the
    reference package's own timing tests compile."""
    import jax
    before = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    yield
    jax.config.update("jax_enable_compilation_cache", before)


def staged(nodes, bound=(), pods=(), n_bucket=32, pad_to=64):
    """(numpy NodeArrays, PodBatch) for a cluster of `nodes` holding the
    already-bound pods `bound`, and a batch of `pods`. The node axis pads
    to `n_bucket` rows and the batch to `pad_to` pods, so the JAX programs
    compile once per test file, not once per case."""
    cache = Cache()
    for n in nodes:
        cache.add_node(n)
    for p in bound:
        cache.add_pod(p)
    snap = Snapshot()
    cache.update_snapshot(snap)
    state = ClusterState()
    state.dims.nodes = max(n_bucket, state.dims.nodes)
    state.apply_snapshot(snap, full=True)
    builder = BatchBuilder(state, BatchDims(table_rows=64))
    batch = builder.build(list(pods), pad_to=pad_to) if pods else None
    return state.ensure_arrays(), batch


def jax_na(arrays):
    return jp.NodeArrays(*(jnp.asarray(x) for x in arrays))


def jax_table(table):
    return jp.PodTableDev(*(jnp.asarray(getattr(table, f))
                            for f in jp.PodTableDev._fields))


def torch_na(arrays):
    return convert.node_arrays_from_numpy(arrays, CPU)


def torch_table(table):
    return convert.pod_table_from_numpy(table, CPU)


def assert_carry_equal(jc, tc, cache: bool = True):
    for f in ("used", "nonzero_used", "npods", "ports"):
        a, b = np.asarray(getattr(jc, f)), getattr(tc, f).numpy()
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    if not cache:
        return
    assert int(jc.cache.sig) == int(tc.cache.sig)
    if int(jc.cache.sig) == 0:
        return
    for f in tp.SigCache._fields[1:]:
        a, b = np.asarray(getattr(jc.cache, f)), getattr(tc.cache, f).numpy()
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f"cache.{f}")


def lean_cluster(rng: random.Random, n_nodes: int, images: bool = True):
    """Random lean cluster: mixed capacities, taints of every effect,
    labels (incl. numeric), images, an unschedulable node or two."""
    nodes = []
    for i in range(n_nodes):
        w = make_node(f"n{i}").capacity({
            "cpu": str(rng.choice([2, 4, 8, 16, 32])),
            "memory": f"{rng.choice([4, 8, 16, 32, 64])}Gi",
            "pods": rng.choice([4, 8, 110])})
        if rng.random() < 0.4:
            w = w.label("disk", rng.choice(["ssd", "hdd"]))
        if rng.random() < 0.5:
            w = w.zone(f"z{rng.randint(0, 2)}")
        if rng.random() < 0.3:
            w = w.label("gen", str(rng.randint(1, 5)))
        if rng.random() < 0.25:
            w = w.taint("dedicated", rng.choice(["batch", "web"]),
                        effect=rng.choice(["NoSchedule", "PreferNoSchedule",
                                           "NoExecute"]))
        if rng.random() < 0.15:
            w = w.taint("spot", "", effect="PreferNoSchedule")
        if rng.random() < 0.05:
            w = w.unschedulable()
        if images and rng.random() < 0.5:
            for img in rng.sample(["nginx:1", "redis:7", "busybox:1"],
                                  rng.randint(1, 2)):
                w = w.image(img, rng.choice([30, 200, 600]) * 1024 * 1024)
        nodes.append(w.obj())
    return nodes


def lean_pod(rng: random.Random, name: str, ports: bool = True):
    w = make_pod(name).req({
        "cpu": rng.choice(["0", "100m", "500m", "1", "2"]),
        "memory": rng.choice(["0", "128Mi", "1Gi", "2Gi"])})
    if rng.random() < 0.3:
        w = w.node_selector({"disk": rng.choice(["ssd", "hdd"])})
    if rng.random() < 0.3:
        w = w.toleration(key="dedicated", operator="Exists")
    if rng.random() < 0.15:
        w = w.toleration(key="spot", operator="Exists",
                         effect="PreferNoSchedule")
    if rng.random() < 0.2:
        w = w.node_affinity_in("topology.kubernetes.io/zone",
                               [f"z{rng.randint(0, 2)}",
                                f"z{rng.randint(0, 2)}"])
    if rng.random() < 0.2:
        w = w.preferred_node_affinity_in(
            "topology.kubernetes.io/zone", [f"z{rng.randint(0, 2)}"],
            weight=rng.randint(1, 10))
    if ports and rng.random() < 0.15:
        w = w.host_port(rng.choice([80, 443, 8080]))
    if rng.random() < 0.3:
        w = w.container({"cpu": "100m"},
                        image=rng.choice(["nginx:1", "redis:7", "busybox:1"]))
    return w.obj()
