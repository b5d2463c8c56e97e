"""run_batch's edge inputs (RUN_BATCH_EDGE_CASES): the node-axis
partitions of the port's CUDA design (csrc/run_batch.cu: a cluster of C
CTAs, a contiguous range of ⌈N / C⌉ rows each, one row a thread at
N = C · 512 = 8,192) and the scan's own corners.

Shared by tests/test_torch_batch_edges.py (the port's plain version
against the JAX package on the CPU) and tests/test_torch_cuda.py (the
kernel against the plain version on the card). This module imports neither
package: `stage` builds a case through the state layer it is handed (the
JAX package's or the port's, which make the same arrays), seeded with
numpy, and edits the numpy arrays the same way for both.

The cases (each one mode of the scan):

- ties_at_cta_boundaries (lean, N = 2,048: not a multiple of C · 512, a
  CTA boundary every 128 rows): rows 0, N − 1 and both sides of every
  boundary boosted alike, one signature all span long (never a change);
  each tie goes to its lower row first, two pods a row;
- sig_change_every_pod (lean, N = C · 512 exactly, images on the nodes):
  four request shapes in turn, so every pod takes the slow path and
  ImageLocality's counts;
- sig_change_every_other_pod (lean, N = 16,384 > C · 512: two rows a
  thread): shapes in pairs;
- ragged_outside_invalid (lean, 5,000 rows, cut from the padded 8,192, so
  the last CTA's range is short): a pod row outside the table (-2),
  invalid pods, host-port pods against rows whose port slots are full or
  have one free slot in the middle;
- overlay_nominations (overlay, N = 8,192): nominated rows on both sides
  of a CTA boundary (511, 512), rows 0 and 8,191 (an invalid padding
  row), 6,000 (invalid), plus whole-node reservations;
- groups_every_family (groups, N = 2,048): zone DoNotSchedule spread, rack
  and hostname ScheduleAnyway spread (a rack's domain id, its first row,
  in one CTA while its rows cross the next boundary), required
  affinity, anti-affinity, preferred affinity;
- groups_beyond_lattice (groups, N = 16,384): zone and rack spread, two
  rows a thread.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np

ZONE = "topology.kubernetes.io/zone"
HOSTNAME = "kubernetes.io/hostname"
TIE_ROWS = [0] + [b + o for b in range(128, 2048, 128) for o in (-1, 0)] \
    + [2047]
FULL_PORT_ROWS = range(0, 64)          # every port slot taken
ONE_FREE_PORT_ROWS = range(64, 128)    # slot 3 free, the others taken
NOMINATED = {0: 511, 4: 512, 8: 6000, 12: 0, 16: 8191}


def _nodes(W, n, zones=16, cpu=16, images=False, rack=0, rng=None):
    out = []
    for i in range(n):
        w = (W.make_node(f"n{i}").capacity({"cpu": cpu, "memory": "32Gi",
                                            "pods": 40})
             .zone(f"z{i % zones}").label(HOSTNAME, f"n{i}"))
        if rack:
            w = w.label("rack", f"r{i // rack}")
        if images and rng.rand() < 0.4:
            w = w.image("nginx:1", int(rng.choice([30, 300])) << 20)
        if images and rng.rand() < 0.2:
            w = w.image("redis:7", 200 << 20)
        out.append(w.obj())
    return out


def _lean_pods(W, n, shapes, run, images=False, ports=False, prefix="p"):
    """n pods over `shapes` request shapes, each shape `run` pods in a
    row; with `images` every other shape names a container image, with
    `ports` every third pod asks for host port 8080."""
    out = []
    for i in range(n):
        k = (i // run) % shapes
        w = W.make_pod(f"{prefix}{i}").req({"cpu": f"{250 + 125 * k}m",
                                            "memory": f"{512 * (1 + k)}Mi"})
        if images and k % 2:
            w = w.container({"cpu": "50m"},
                            image="nginx:1" if k % 4 == 1 else "redis:7")
        if ports and i % 3 == 2:
            w = w.host_port(8080)
        out.append(w.obj())
    return out


def _group_pods(W, n, kinds):
    out = []
    for i in range(n):
        kind = kinds[i % len(kinds)]
        w = W.make_pod(f"g{i}").req({"cpu": "500m", "memory": "1Gi"}) \
            .label("app", "s")
        if kind == "spread":
            w = w.spread_constraint(1, ZONE, "DoNotSchedule", {"app": "s"})
        elif kind == "rack":
            w = w.spread_constraint(2, "rack", "ScheduleAnyway",
                                    {"app": "s"})
        elif kind == "host":
            w = w.spread_constraint(1, HOSTNAME, "ScheduleAnyway",
                                    {"app": "s"})
        elif kind == "affinity":
            w = w.pod_affinity(ZONE, {"app": "s"})
        elif kind == "anti":
            w = w.label("anti", "y").pod_affinity(HOSTNAME, {"anti": "y"},
                                                  anti=True)
        elif kind == "prefer":
            w = w.preferred_pod_affinity(ZONE, {"app": "s"}, 5)
        out.append(w.obj())
    return out


def _bound(W, rows):
    return [W.make_pod(f"b{r}").req({"cpu": "1", "memory": "1Gi"})
            .label("app", "s").node(f"n{r}").obj() for r in rows]


RUN_BATCH_EDGE_CASES = {
    # name: mode, seed, nodes(W, rng), bound(W), pods(W), edits
    "ties_at_cta_boundaries": dict(
        mode="lean", seed=1, nodes=lambda W, r: _nodes(W, 2048),
        pods=lambda W: _lean_pods(W, 40, 1, 40),
        boost={row: 4 for row in TIE_ROWS}),
    "sig_change_every_pod": dict(
        mode="lean", seed=2,
        nodes=lambda W, r: _nodes(W, 5000, images=True, rng=r),
        pods=lambda W: _lean_pods(W, 12, 4, 1, images=True)),
    "sig_change_every_other_pod": dict(
        mode="lean", seed=3, nodes=lambda W, r: _nodes(W, 8200),
        pods=lambda W: _lean_pods(W, 8, 3, 2)),
    "ragged_outside_invalid": dict(
        mode="lean", seed=4, nodes=lambda W, r: _nodes(W, 5000),
        pods=lambda W: _lean_pods(W, 24, 3, 8, ports=True), rows=5000,
        boost={row: 4 for row in range(128)}, ports=True, outside=[5],
        invalid=[3, 11]),
    "overlay_nominations": dict(
        mode="ovl", seed=5, nodes=lambda W, r: _nodes(W, 5000),
        pods=lambda W: _lean_pods(W, 24, 4, 4), nominated=NOMINATED,
        reserve=100),
    "groups_every_family": dict(
        mode="groups", seed=6, nodes=lambda W, r: _nodes(W, 2048, rack=7),
        bound=lambda W: _bound(W, (5, 700, 1500)),
        pods=lambda W: _group_pods(W, 48, ("spread", "rack", "host",
                                           "affinity", "anti", "prefer"))),
    "groups_beyond_lattice": dict(
        mode="groups", seed=7, nodes=lambda W, r: _nodes(W, 8200, rack=7),
        pods=lambda W: _group_pods(W, 8, ("spread", "rack"))),
}


def stage(case: str, pkg) -> SimpleNamespace:
    """One case's numpy inputs through `pkg`'s state layer (`pkg` holds
    the package's Cache, Snapshot, ClusterState, BatchBuilder, BatchDims
    and its testing wrappers as W). Returns arrays (NodeArrays), table,
    valid / sig / tidx [m], the group tensors (gd, gc, fam; None lean),
    the overlay (ovl_used, ovl_npods, nom_idx; None unless the overlay
    mode) and `outside`, the positions whose table row is out of range."""
    spec = RUN_BATCH_EDGE_CASES[case]
    rng = np.random.RandomState(spec["seed"])
    W = pkg.W
    cache = pkg.Cache()
    for nd in spec["nodes"](W, rng):
        cache.add_node(nd)
    for p in spec.get("bound", lambda W: [])(W):
        cache.add_pod(p)
    snap = pkg.Snapshot()
    cache.update_snapshot(snap)
    state = pkg.ClusterState()
    state.apply_snapshot(snap, full=True)
    builder = pkg.BatchBuilder(state, pkg.BatchDims(table_rows=64))
    pods = spec["pods"](W)
    m = len(pods)
    batch = builder.build(pods)
    assert not batch.host_fallback[:m].any()
    a = state.ensure_arrays()
    if spec.get("boost"):
        cap = a.cap.copy()
        for row, by in spec["boost"].items():
            cap[row] *= by
        a = a._replace(cap=cap)
    if spec.get("ports"):
        ports = a.ports.copy()
        P = ports.shape[1]
        for row in FULL_PORT_ROWS:
            ports[row] = 10_000 + np.arange(P)
        for row in ONE_FREE_PORT_ROWS:
            ports[row] = 20_000 + np.arange(P)
            ports[row, 3] = 0
        a = a._replace(ports=ports)
    if spec.get("rows"):
        a = type(a)(*(x[:spec["rows"]] for x in a))
    valid = batch.valid[:m].copy()
    valid[spec.get("invalid", [])] = False
    tidx = batch.tidx[:m].copy()
    tidx[spec.get("outside", [])] = batch.table.req.shape[0]
    out = SimpleNamespace(
        arrays=a, table=batch.table, valid=valid, sig=batch.sig[:m].copy(),
        tidx=tidx, outside=list(spec.get("outside", [])), gd=None, gc=None,
        fam=None, ovl_used=None, ovl_npods=None, nom_idx=None,
        mode=spec["mode"])
    if spec["mode"] == "groups":
        out.gd, out.gc = builder.groups.build_dev(snap)
        out.fam = tuple(builder.groups.families(snap))
    if spec["mode"] == "ovl":
        N, R = a.cap.shape
        ovl_used = np.zeros((N, R), np.int64)
        ovl_npods = np.zeros((N,), np.int32)
        nom_idx = np.full((m,), -1, np.int32)
        for k, row in spec["nominated"].items():
            nom_idx[k] = row
            ovl_used[row] += batch.table.req[tidx[k]]
            ovl_npods[row] += 1
        for row in rng.choice(5000, spec["reserve"], replace=False):
            ovl_used[row, 0] += 64_000
            ovl_npods[row] += 1
        out.ovl_used, out.ovl_npods, out.nom_idx = ovl_used, ovl_npods, \
            nom_idx
    return out


def kept(e) -> np.ndarray:
    """The positions of the span whose table row is in range (the plain
    versions take only those; the kernel reports -2 at the others)."""
    keep = np.ones(len(e.valid), bool)
    keep[e.outside] = False
    return keep


def full_span(e, out_kept) -> list:
    """The assignments of the kept positions with -2 put back at the
    positions outside the table: what the kernel returns for the span."""
    it = iter(np.asarray(out_kept).tolist())
    return [-2 if i in e.outside else next(it) for i in range(len(e.valid))]


def check_span(case: str, out: list) -> None:
    """What each case must show in its whole span's assignments."""
    if case == "ties_at_cta_boundaries":
        # a boosted row scores alike after its first pod (the request
        # rounds away), so each takes two; every tie, across a CTA
        # boundary included, goes to its lower row first
        assert out == [r for r in TIE_ROWS for _ in (0, 1)][:len(out)]
    elif case == "ragged_outside_invalid":
        spec = RUN_BATCH_EDGE_CASES[case]
        assert [out[i] for i in spec["outside"]] == [-2]
        assert [out[i] for i in spec["invalid"]] == [-1, -1]
        # a port pod never lands on a row whose slots are all taken
        assert not {out[i] for i in range(2, len(out), 3)} & set(
            FULL_PORT_ROWS)
    elif case == "overlay_nominations":
        assert all(x >= 0 for x in out)
