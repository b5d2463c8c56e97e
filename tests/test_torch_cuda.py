"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: these tests need an NVIDIA GPU with nvcc and skip
elsewhere (the CPU tests hold the plain versions to the JAX package; these
hold the kernels to the plain versions). On a machine with the card:

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

Tolerance: exact equality of assignments, packed flags, every carry field
and the whole SigCache."""

import random

import pytest
import torch

from kubernetes_tpu_torch.backend.cache import Cache, Snapshot
from kubernetes_tpu_torch.ops import program as P
from kubernetes_tpu_torch.state import convert
from kubernetes_tpu_torch.state.batch import BatchBuilder
from kubernetes_tpu_torch.state.tensorize import ClusterState
from kubernetes_tpu_torch.testing.wrappers import make_node, make_pod

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    return "cuda"


def _staged(rng, n_nodes, pods, device):
    cache = Cache()
    for i in range(n_nodes):
        w = make_node(f"n{i}").capacity({
            "cpu": rng.choice([2, 4, 8, 16]),
            "memory": f"{rng.choice([4, 8, 16])}Gi",
            "pods": rng.choice([4, 8, 110])}).zone(f"z{i % 3}")
        if rng.random() < 0.3:
            w = w.taint("dedicated", "x", effect=rng.choice(
                ["NoSchedule", "PreferNoSchedule", "NoExecute"]))
        if rng.random() < 0.3:
            w = w.label("disk", rng.choice(["ssd", "hdd"]))
        if rng.random() < 0.4:
            w = w.image("nginx:1", rng.choice([30, 300]) << 20)
        cache.add_node(w.obj())
    snap = Snapshot()
    cache.update_snapshot(snap)
    state = ClusterState(device=device)
    state.apply_snapshot(snap)
    builder = BatchBuilder(state)
    batch = builder.build(pods)
    return state.device_arrays(), batch, P.table_from_batch(batch, device)


def _pod(rng, i):
    w = make_pod(f"p{i}").req({"cpu": rng.choice(["0", "250m", "1"]),
                               "memory": rng.choice(["0", "512Mi", "1Gi"])})
    if rng.random() < 0.3:
        w = w.node_selector({"disk": "ssd"})
    if rng.random() < 0.3:
        w = w.toleration(key="dedicated", operator="Exists")
    if rng.random() < 0.2:
        w = w.preferred_node_affinity_in("topology.kubernetes.io/zone",
                                         ["z1"], 3)
    if rng.random() < 0.15:
        w = w.host_port(8080)
    if rng.random() < 0.3:
        w = w.container({"cpu": "50m"}, image="nginx:1")
    return w.obj()


def _equal(a, b):
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.cpu(), b.cpu())
        return
    for x, y in zip(a, b):
        _equal(x, y)


@pytest.mark.parametrize("strategy", ["LeastAllocated", "MostAllocated"])
@pytest.mark.parametrize("seed", range(6))
def test_run_batch_kernel_equals_plain(cuda, seed, strategy):
    rng = random.Random(seed)
    pods = [_pod(rng, i) for i in range(rng.randint(10, 60))]
    na, batch, table = _staged(rng, rng.randint(5, 200), pods, cuda)
    xs = convert.pod_xs_from_numpy(P.PodXs(batch.valid, batch.sig,
                                           batch.tidx), cuda)
    carry = P.initial_carry(na)
    cfg = P.ScoreConfig(strategy=strategy)
    _equal(P.run_batch(cfg, na, carry, xs, table),
           P._run_batch_plain(cfg, na, carry, xs, table))


@pytest.mark.parametrize("seed", range(8))
def test_run_uniform_kernel_equals_plain(cuda, seed):
    rng = random.Random(seed)
    proto = _pod(rng, 0)
    if any(p.host_port for c in proto.spec.containers for p in c.ports):
        proto = make_pod("plain").req({"cpu": "1", "memory": "1Gi"}).obj()
    n_nodes = rng.randint(3, 300)
    na, batch, table = _staged(rng, n_nodes, [proto], cuda)
    N = na.cap.shape[0]
    L = rng.choice([16, 64, 256])
    K = min(L, N)
    J = rng.choice([2, 8, L + 1])
    if K * J < L:
        J = L + 1
    x = P.PodXs(True, int(batch.sig[0]), int(batch.tidx[0]))
    carry = P.initial_carry(na)
    cfg = P.ScoreConfig()
    n_actual = rng.randint(1, L)
    kc, kp = P.run_uniform(cfg, na, carry, x, table, n_actual, L, K, J)
    pc, pp = P._run_uniform_plain(cfg, na, carry, x, table, n_actual, L, K,
                                  J)
    _equal((kp, kc), (pp, pc))
    # a second run on the output carry takes the SigCache fast path
    _equal(P.run_uniform(cfg, na, kc, x, table, n_actual, L, K, J),
           P._run_uniform_plain(cfg, na, pc, x, table, n_actual, L, K, J))
