"""The port's tensorized state ↔ the JAX package's, field by field.

One cluster and one pod batch, built from the same seed by each package's
own wrappers, cache and state layer: the staging arrays, the device
arrays (17 NodeArrays fields, dtypes included), the signature table and
the per-pod batch vectors must be equal — also after a generation-diff
upload that scatters a few dirty rows."""

import random

import numpy as np
import pytest

import kubernetes_tpu  # noqa: F401
from kubernetes_tpu.backend.cache import Cache as JCache, Snapshot as JSnap
from kubernetes_tpu.state.batch import BatchBuilder as JBuilder
from kubernetes_tpu.state.tensorize import ClusterState as JState
from kubernetes_tpu.testing import wrappers as jw

from _torch_parity import private_jax_compiles  # noqa: F401
from kubernetes_tpu_torch.backend.cache import Cache as TCache
from kubernetes_tpu_torch.backend.cache import Snapshot as TSnap
from kubernetes_tpu_torch.ops.program import table_from_batch
from kubernetes_tpu_torch.state.batch import BatchBuilder as TBuilder
from kubernetes_tpu_torch.state.tensorize import ClusterState as TState
from kubernetes_tpu_torch.state.tensorize import NodeArrays
from kubernetes_tpu_torch.testing import wrappers as tw


def _nodes(w, seed, n=40):
    rng = random.Random(seed)
    out = []
    for i in range(n):
        wr = w.make_node(f"n{i}").capacity({
            "cpu": str(rng.choice([4, 8, 16])),
            "memory": f"{rng.choice([8, 16, 32])}Gi", "pods": 110})
        wr = wr.zone(f"z{i % 3}").label("gen", str(rng.randint(1, 4)))
        if rng.random() < 0.3:
            wr = wr.taint("dedicated", "x", effect=rng.choice(
                ["NoSchedule", "PreferNoSchedule", "NoExecute"]))
        if rng.random() < 0.4:
            wr = wr.image("nginx:1", 200 << 20)
        if rng.random() < 0.1:
            wr = wr.unschedulable()
        out.append(wr.obj())
    return out


def _bound(w, seed):
    rng = random.Random(seed + 1)
    return [w.make_pod(f"b{i}").req({"cpu": "500m", "memory": "1Gi"})
            .host_port(8000 + i).node(f"n{rng.randrange(40)}").obj()
            for i in range(12)]


def _pods(w, seed):
    rng = random.Random(seed + 2)
    pods = []
    for i in range(30):
        wr = w.make_pod(f"p{i}").req({"cpu": rng.choice(["100m", "1"]),
                                      "memory": "256Mi"})
        if i % 3 == 0:
            wr = wr.node_selector({"topology.kubernetes.io/zone": "z1"})
        if i % 4 == 0:
            wr = wr.toleration(key="dedicated", operator="Exists")
        if i % 5 == 0:
            wr = wr.node_affinity_in("gen", ["1", "2"])
        if i % 7 == 0:
            wr = wr.preferred_node_affinity_in("gen", ["3"], 4)
        if i % 6 == 0:
            wr = wr.host_port(9090)
        if i % 8 == 0:
            wr = wr.container({"cpu": "50m"}, image="nginx:1")
        pods.append(wr.obj())
    return pods


def _build(pkg, seed):
    w, Cache, Snap, State, Builder, kw = pkg
    cache = Cache()
    for nd in _nodes(w, seed):
        cache.add_node(nd)
    for p in _bound(w, seed):
        cache.add_pod(p)
    snap = Snap()
    cache.update_snapshot(snap)
    state = State(**kw)
    state.apply_snapshot(snap)
    builder = Builder(state)
    batch = builder.build(_pods(w, seed), pad_to=64)
    return cache, snap, state, builder, batch


JAX = (jw, JCache, JSnap, JState, JBuilder, {})
TORCH = (tw, TCache, TSnap, TState, TBuilder, {"device": "cpu"})


def _assert_arrays(j, t, fields):
    for f in fields:
        a = np.asarray(getattr(j, f))
        b = getattr(t, f)
        b = b.numpy() if hasattr(b, "numpy") else np.asarray(b)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_state_and_batch_equal(seed):
    jc, js, jst, jb, jbatch = _build(JAX, seed)
    tc, ts, tst, tb, tbatch = _build(TORCH, seed)
    assert len(NodeArrays._fields) == 17
    _assert_arrays(jst.arrays, tst.arrays, NodeArrays._fields)
    _assert_arrays(jst.device_arrays(), tst.device_arrays(),
                   NodeArrays._fields)
    assert jst.node_names == tst.node_names
    # signature table and per-pod vectors
    for f in ("valid", "host_fallback", "sig", "tidx"):
        np.testing.assert_array_equal(getattr(jbatch, f),
                                      getattr(tbatch, f), err_msg=f)
    _assert_arrays(jbatch.table, tbatch.table, type(tbatch.table)._fields)
    tdev = table_from_batch(tbatch, "cpu")
    _assert_arrays(jbatch.table, tdev, type(tdev)._fields)


@pytest.mark.parametrize("seed", [0, 3])
def test_scatter_rows_upload_equal(seed):
    built = []
    for pkg in (JAX, TORCH):
        cache, snap, state, _b, _batch = _build(pkg, seed)
        state.device_arrays()                   # first upload: full
        w = pkg[0]
        # a few dirty rows: pods with host ports land on three nodes
        for i, node in enumerate(("n3", "n17", "n29")):
            cache.add_pod(w.make_pod(f"late{i}").req(
                {"cpu": "1", "memory": "2Gi"}).host_port(7000 + i)
                .node(node).obj())
        cache.update_snapshot(snap)
        state.apply_snapshot(snap)
        built.append(state)
    jst, tst = built
    full_before = tst.full_uploads_total
    tdev = tst.device_arrays()
    assert tst.full_uploads_total == full_before, "expected a row scatter"
    assert tst.rows_scattered_total == 3
    _assert_arrays(jst.device_arrays(), tdev, NodeArrays._fields)
    _assert_arrays(jst.arrays, tst.arrays, NodeArrays._fields)
