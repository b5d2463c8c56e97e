"""Mixed lean workload: kubernetes_tpu.Scheduler ↔
kubernetes_tpu_torch.Scheduler(device="cpu").

NoSchedule and (later) PreferNoSchedule taints, nodeSelector, hostPort,
images, four rotating signatures (scan spans), same-signature runs
(uniform spans), memory-heavy runs on cpu-saturated nodes (uniform runs
whose monotonicity fails: rewound and replayed) and pods no node can
hold. Both packages, same seed, fixed clock: the bind map and the set of
pending pods must be equal (exact), and every drain must compile to the
same spans — the long mixed stretches to the lean plan program
("wavescan"), with its ports variant where hostPort pods ride along."""

import random

import pytest
import torch

from _torch_parity import private_jax_compiles  # noqa: F401
from test_torch_scheduler import (JAX, TORCH, _create_pods, _outcome,
                                  make_scheduler)

# small tensors: one intra-op thread keeps parallel test workers from
# oversubscribing the cores
torch.set_num_threads(1)


def _mixed_nodes(w, rng, n, prefer, prefix="m"):
    nodes = []
    for i in range(n):
        big = i % 17 == 3
        hog = i in (0, 2, 4)
        cpu = 400 if big else 4 if hog else rng.choice([4, 8, 16])
        mem = ("800Gi" if big else "64Gi" if hog
               else f"{rng.choice([8, 16, 32])}Gi")
        wr = w.make_node(f"{prefix}{i}").capacity({
            "cpu": cpu, "memory": mem,
            "pods": 300 if big else 40}).zone(f"z{i % 4}")
        if rng.random() < 0.3:
            wr = wr.label("disk", rng.choice(["ssd", "hdd"]))
        if i % 9 == 5:
            wr = wr.taint("dedicated", "batch", effect="NoSchedule")
        if prefer and i % 7 == 1:
            wr = wr.taint("spot", "", effect="PreferNoSchedule")
        if i % 5 == 0:
            wr = wr.image("nginx:1.25", 300 << 20)
        if i == 11:
            wr = wr.unschedulable()
        nodes.append(wr.obj())
    return nodes


def _mixed_pods(w, rng, prefix, n_runs):
    """Rotating four-signature stretches (scan spans), long same-signature
    runs (uniform spans), memory-heavy runs that break monotonicity on
    the cpu-saturated nodes, and pods no node can hold."""
    shapes = [
        lambda k: w.make_pod(k).req({"cpu": "500m", "memory": "1Gi"}),
        lambda k: w.make_pod(k).req({"cpu": "1", "memory": "512Mi"})
        .node_selector({"disk": "ssd"}),
        lambda k: w.make_pod(k).req({"cpu": "250m", "memory": "2Gi"})
        .toleration(key="dedicated", operator="Exists")
        .container({"cpu": "100m"}, image="nginx:1.25"),
        lambda k: w.make_pod(k).req({"cpu": "200m", "memory": "256Mi"})
        .host_port(8080),
    ]
    pods = []
    seq = 0

    def name():
        nonlocal seq
        seq += 1
        return f"{prefix}-{seq}"

    for r in range(n_runs):
        kind = r % 4
        if kind == 0:
            for k in range(rng.randint(8, 40)):
                pods.append(shapes[k % 4](name()).obj())
        elif kind == 1:
            cpu = rng.choice(["100m", "300m", "1"])
            for _ in range(rng.randint(20, 120)):
                pods.append(w.make_pod(name()).req(
                    {"cpu": cpu, "memory": "128Mi"}).obj())
        elif kind == 2:
            for _ in range(rng.randint(16, 48)):
                pods.append(w.make_pod(name()).req(
                    {"cpu": "0", "memory": "3Gi"}).obj())
        else:
            pods.append(w.make_pod(name()).req({"cpu": "900"}).obj())
            pods.append(w.make_pod(name()).req({"cpu": "1"})
                        .node_selector({"disk": "nvme"}).obj())
    return pods


def _spy_plans(sched):
    """The compiled spans of every drain, once per drain in dispatch
    order. A rewound uniform run re-dispatches the drains chained after
    it, and when that happens depends on how far each package's commit
    pipeline had run; the plan of each drain does not."""
    seen, batches = [], []
    orig = sched.compiler.compile_drain

    def spy(batch, n, **kw):
        plan = orig(batch, n, **kw)
        if not any(b is batch for b in batches):
            batches.append(batch)
            seen.append([tuple(s) for s in plan.spans])
        return plan
    sched.compiler.compile_drain = spy
    return seen


def _mixed(pkg, seed):
    w, Api = pkg[0], pkg[1]
    rng = random.Random(seed)
    api = Api()
    sched = make_scheduler(pkg, api, 256)
    spans = _spy_plans(sched)
    for nd in _mixed_nodes(w, rng, 40, prefer=False):
        api.create_node(nd)
    sched.prime()
    # cpu-saturated hogs: memory-heavy run pods raise BalancedAllocation
    # on these nodes faster than LeastAllocated falls
    hogs = [w.make_pod(f"hog-{i}").req({"cpu": "3500m", "memory": "0"})
            .node(f"m{i}").obj() for i in (0, 2, 4)]
    api.create_pods(hogs)
    _create_pods(api, sched, _mixed_pods(w, rng, "a", 8), chunk=128)
    # PreferNoSchedule taints arrive: every later drain takes the scan
    for nd in _mixed_nodes(w, rng, 12, prefer=True, prefix="late"):
        api.create_node(nd)
    _create_pods(api, sched, _mixed_pods(w, rng, "b", 4), chunk=128)
    return api, sched, spans


@pytest.mark.parametrize("seed", [0])
def test_mixed_lean_workload_bind_parity(seed):
    japi, jsched, jspans = _mixed(JAX, seed)
    jres = _outcome(japi, jsched)
    tapi, tsched, tspans = _mixed(TORCH, seed)
    tres = _outcome(tapi, tsched)
    assert tres[1], "the workload must leave unschedulable pods pending"
    assert tsched.uniform_rewinds > 0, "no uniform run was rewound"
    assert tres == jres
    assert tspans == jspans
    plans = [s[2] for spans in tspans for s in spans if s[2][0] == "wavescan"]
    assert plans and any(k[2] for k in plans), "no ports plan span"
    assert tsched.plan_runs >= len(plans)
    assert tsched.reconcile() == []
