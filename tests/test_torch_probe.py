"""cluster_probe (the per-drain cluster-state reduction): the port ↔ the
JAX package, bit for bit.

The probe inputs (cap, valid, used, npods, dom) are made with numpy from
a seed and go through the JAX package's probe math, jitted on the CPU,
and through the port's plain version; every output is compared through
its raw bytes (the float32 columns viewed as int32), so a rounding
difference anywhere fails. Cases: an empty cluster, a saturated one
(stranded = the whole free pool), utilizations exactly at and just below
the 0.95f tight threshold, memory values past 2^24 and 2^32 (int64 →
float32 must round to nearest), clipped and out-of-range domain ids, and
a fuzz of small shapes.

Through the schedulers: every device drain of the port launches the
probe inside a `cluster_probe` span and resolves it at commit into
`_last_probe`, and a gang-first run at contiguity weight 0 reports the
JAX package's domain statistics (the domain-id cache is keyed as the JAX
package keys it, so the identity ids the gang scan cached stay the
probe's ids)."""

import functools

import jax
import numpy as np
import pytest
import torch

import kubernetes_tpu  # noqa: F401  (x64 before any jnp array)
import jax.numpy as jnp
from kubernetes_tpu.api.types import ObjectMeta as JMeta
from kubernetes_tpu.api.types import PodGroup as JGroup
from kubernetes_tpu.api.types import Workload as JWorkload
from kubernetes_tpu.backend.apiserver import APIServer as JApi
from kubernetes_tpu.ops import program as jp
from kubernetes_tpu.scheduler import Scheduler as JSched
from kubernetes_tpu.testing import wrappers as jw

from _torch_parity import private_jax_compiles  # noqa: F401
from kubernetes_tpu_torch.api.types import ObjectMeta as TMeta
from kubernetes_tpu_torch.api.types import PodGroup as TGroup
from kubernetes_tpu_torch.api.types import Workload as TWorkload
from kubernetes_tpu_torch.backend.apiserver import APIServer as TApi
from kubernetes_tpu_torch.ops import program as tp
from kubernetes_tpu_torch.scheduler import Scheduler as TSched
from kubernetes_tpu_torch.testing import wrappers as tw
from kubernetes_tpu_torch.utils.tracing import Tracer

torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _jax_probe(ndom: int):
    return jax.jit(functools.partial(jp._probe_math, ndom=ndom))


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def probe_parity(cap, valid, used, npods, dom, ndom):
    j = _jax_probe(ndom)(jnp.asarray(cap), jnp.asarray(valid),
                         jnp.asarray(used), jnp.asarray(npods),
                         jnp.asarray(dom))
    t = tp.cluster_probe(
        _NA(torch.from_numpy(cap), torch.from_numpy(valid)),
        tp.Carry(used=torch.from_numpy(used), nonzero_used=None,
                 npods=torch.from_numpy(npods), ports=None, cache=None),
        torch.from_numpy(dom), ndom)
    for what, a, b, dt in zip(("per_res", "dom_stats", "valid_count"), j, t,
                              (torch.float32, torch.float32, torch.int32)):
        assert b.dtype == dt, what
        assert tuple(b.shape) == tuple(np.asarray(a).shape), what
        np.testing.assert_array_equal(_bits(a), _bits(b.numpy()),
                                      err_msg=what)
    return t


class _NA:
    """The two node columns the probe reads."""

    def __init__(self, cap, valid):
        self.cap, self.valid = cap, valid


def _inputs(rng, N, R, scale=1, ndom=None):
    cap = (rng.randint(0, 6, (N, R)) * scale).astype(np.int64)
    used = (cap * rng.rand(N, R)).astype(np.int64)
    valid = rng.rand(N) < 0.85
    npods = rng.randint(0, 40, N).astype(np.int32)
    ndom = ndom or max(1, N // 3)
    dom = rng.randint(-2, ndom + 2, N).astype(np.int32)
    return cap, valid, used, npods, dom, ndom


@pytest.mark.parametrize("seed", range(12))
def test_fuzz_small_shapes(seed):
    rng = np.random.RandomState(seed)
    N = int(rng.choice([1, 2, 5, 8, 33, 64]))
    R = int(rng.choice([1, 2, 4, 7]))
    scale = int(rng.choice([1, 1000, 2 ** 30 + 7]))
    probe_parity(*_inputs(rng, N, R, scale))


def test_empty_cluster():
    N, R = 16, 4
    cap = np.zeros((N, R), np.int64)
    out = probe_parity(cap, np.zeros(N, bool), cap.copy(),
                       np.zeros(N, np.int32), np.arange(N, dtype=np.int32),
                       N)
    assert (out[0] == 0).all() and (out[1] == 0).all()
    assert int(out[2]) == 0


def test_saturated_cluster_strands_everything():
    rng = np.random.RandomState(7)
    N, R = 32, 3
    cap = rng.randint(1, 9, (N, R)).astype(np.int64) * 1000
    used = cap.copy()
    used[:, 1] = cap[:, 1] // 4          # cpu full, the rest free
    used[:, 2] = 0
    out = probe_parity(cap, np.ones(N, bool), used,
                       np.full(N, 3, np.int32),
                       (np.arange(N) % 4).astype(np.int32), 4)
    # every node is tight (column 0 at 1.0): stranded = the free pool
    assert out[0][1:, 6].tolist() == [1.0, 1.0]
    assert out[0][0, 3] == 1.0


def test_tight_threshold_is_float32():
    # 19/20 rounds to float32(0.95), which is tight; 0.94999994 is not
    N = 4
    cap = np.array([[20], [20000000], [100000000], [40]], np.int64)
    used = np.array([[19], [18999999], [94999994], [38]], np.int64)
    free_other = np.array([[7], [7], [7], [7]], np.int64)
    cap2 = np.concatenate([cap, free_other * 2], axis=1)
    used2 = np.concatenate([used, free_other], axis=1)
    out = probe_parity(cap2, np.ones(N, bool), used2,
                       np.ones(N, np.int32), np.zeros(N, np.int32), 1)
    f = np.float32
    tight = [f(19) / f(20) >= f(0.95), f(18999999) / f(20000000) >= f(0.95),
             f(94999994) / f(100000000) >= f(0.95), True]
    assert float(out[0][1, 6]) == pytest.approx(sum(tight) / 4, rel=1e-6)


def test_large_memory_values():
    rng = np.random.RandomState(3)
    N, R = 40, 2
    cap = np.stack([rng.randint(1, 64, N) * 1000,
                    rng.randint(1, 2 ** 12, N).astype(np.int64) * 2 ** 28
                    + rng.randint(0, 2 ** 20, N)], axis=1).astype(np.int64)
    used = (cap * rng.rand(N, R)).astype(np.int64) + 1
    probe_parity(cap, rng.rand(N) < 0.9, np.minimum(used, cap),
                 rng.randint(0, 110, N).astype(np.int32),
                 rng.randint(0, 5, N).astype(np.int32), 5)


def test_probe_never_writes_its_inputs():
    rng = np.random.RandomState(11)
    cap, valid, used, npods, dom, ndom = _inputs(rng, 24, 3)
    before = [x.copy() for x in (cap, valid, used, npods, dom)]
    probe_parity(cap, valid, used, npods, dom, ndom)
    for a, b in zip(before, (cap, valid, used, npods, dom)):
        np.testing.assert_array_equal(a, b)


def test_probe_argument_checks():
    with pytest.raises(ValueError, match="ndom"):
        tp.cluster_probe(None, None, None, 0)


# ---------------------------------------------------------------------------
# through the schedulers


def _clock():
    return 1000.0


def _nodes(w, n):
    return [w.make_node(f"node-{i}").capacity(
        {"cpu": 32, "memory": "64Gi", "pods": 110}).zone(
        f"zone-{i % 4}").obj() for i in range(n)]


def _gang_first_run(w, Api, Sched, Meta, Group, Workload, **kw):
    """A two-role gang (two member signatures: the scan tier) as the
    first drain, contiguity weight 0, then plain pods."""
    api = Api()
    sched = Sched(api, batch_size=64, clock=_clock, **kw)
    if Sched is JSched:
        sched.profiler = None
        sched.audit = None
    for nd in _nodes(w, 12):
        api.create_node(nd)
    sched.prime()
    api.create_workload(Workload(metadata=Meta(name="train"),
                                 pod_groups=[Group(name="workers",
                                                   min_count=8)]))
    api.create_pods([w.make_pod(f"train-{i}").req(
        {"cpu": "2" if i % 2 else "1", "memory": "1Gi"}).workload(
        "train").obj() for i in range(8)])
    sched.schedule_pending()
    api.create_pods([w.make_pod(f"p-{i}").req(
        {"cpu": "1", "memory": "1Gi"}).obj() for i in range(10)])
    sched.schedule_pending()
    return sched


def test_gang_first_run_probe_domains_match():
    js = _gang_first_run(jw, JApi, JSched, JMeta, JGroup, JWorkload)
    ts = _gang_first_run(tw, TApi, TSched, TMeta, TGroup, TWorkload,
                         device="cpu")
    assert ts.gang_dispatch["placed"] == 1
    assert ts._last_probe == js._last_probe
    # the gang scan cached identity ids first: one domain per node
    assert ts._last_probe["domains"]["domains"] == 12.0


def test_every_drain_probes_inside_its_span():
    api = TApi()
    tracer = Tracer(slow_threshold_s=float("inf"), keep_recent=256)
    sched = TSched(api, batch_size=16, clock=_clock, device="cpu",
                   tracer=tracer)
    for nd in _nodes(tw, 8):
        api.create_node(nd)
    sched.prime()
    calls = []
    real = tp.cluster_probe

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    import kubernetes_tpu_torch.scheduler as smod
    smod.cluster_probe, saved = spy, smod.cluster_probe
    try:
        api.create_pods([tw.make_pod(f"p-{i}").req({"cpu": "1"}).obj()
                         for i in range(40)])
        sched.schedule_pending()
    finally:
        smod.cluster_probe = saved
    assert len(calls) == sched.device_batches >= 3
    names = []
    stack = list(tracer.recent)
    while stack:
        sp = stack.pop()
        names.append(sp.name)
        stack.extend(sp.children)
    assert names.count("cluster_probe") == sched.device_batches
    assert sched._last_probe["drainId"] == sched.device_batches
    assert sched._last_probe["validNodes"] == 8
    assert sched._last_probe["resources"]["cpu"]["mean"] == \
        pytest.approx(40 / 256, rel=1e-6)
