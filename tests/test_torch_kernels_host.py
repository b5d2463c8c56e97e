"""The host halves of the grid kernels (kubernetes_tpu_torch/ops/kernels.py)
on the CPU: the scratch carving, the argument checks that run before any
build, the exchange that folds per-block partials with the shards, and
the branch each shape of tests/test_torch_cuda.py's closed-form and mesh
cases takes.

The kernels themselves run only on the card (tests/test_torch_cuda.py,
marker `cuda`); here no nvcc exists, so a wrapper that got past its checks
would fail on the build: every refusal below comes first. Tolerance:
exact."""

import random
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from kubernetes_tpu_torch.backend.cache import Cache, Snapshot
from kubernetes_tpu_torch.ops import kernels as Kr
from kubernetes_tpu_torch.ops import program as P
from kubernetes_tpu_torch.parallel import sharding as S
from kubernetes_tpu_torch.state.batch import BatchBuilder
from kubernetes_tpu_torch.state.tensorize import ClusterState, pow2_at_least
from kubernetes_tpu_torch.testing.wrappers import make_node, make_pod

from test_torch_cuda import UNI_CASES, USH_CASES


def _branches(n_nodes: int, K: int, L: int, J: int, D: int) -> set:
    N = pow2_at_least(n_nodes)
    mesh = S.make_mesh(devices=["cpu"] * D)
    n_local = N // D
    K_loc, L_loc, _M = S.uniform_shape(mesh, n_local, L, min(K, N), J)
    out = {("fused" if Kr.uniform_sharded_fused(n_local, K_loc, J)
            else "multi") + ("_select" if K_loc < n_local else "_all_rows")}
    if D * L_loc > Kr.USH_SORT_ALL and \
            Kr._pow2(min(D * L_loc, L)) * 8 > Kr.USH_TOP_SMEM:
        out.add("top_global")
    return out


@pytest.mark.parametrize("branch", ["fused_select", "fused_all_rows",
                                    "multi_select", "multi_all_rows",
                                    "top_global"])
def test_mesh_cases_reach_every_branch(branch):
    """Some case of the card tests, at D = 1, 2 or 4, takes each branch
    of run_uniform_sharded.cu: launch 3 as one block or as the multi-block
    chain, with or without the top-K_loc selection, and the merged top-L
    in global memory."""
    hit = [(name, D) for name, (n, _i, _c, K, L, J, _a) in USH_CASES.items()
           for D in (1, 2, 4) if branch in _branches(n, K, L, J, D)]
    assert hit, branch


def test_fused_threshold_is_the_shared_memory_budget():
    # max(rows, K_loc·J) int64 keys + K_loc int32 candidates, and a matrix
    # small enough for one block
    budget, entries = Kr.USH_FUSED_SMEM, Kr.USH_FUSED_ENTRIES
    assert Kr.uniform_sharded_fused(budget // 8 - 64, 128, 1)
    assert not Kr.uniform_sharded_fused(budget // 8 - 63, 128, 1)
    assert Kr.uniform_sharded_fused(64, 64, entries // 64)
    assert not Kr.uniform_sharded_fused(64, 64, entries // 64 + 1)
    # the gang shape at D = 1, 2, 4 (8,192 rows, K = 256, J = 8)
    assert all(Kr.uniform_sharded_fused(8192 // D, 256, 8)
               for D in (1, 2, 4))


@pytest.mark.parametrize("layout", [
    [("a", 3, torch.uint8), ("b", 5, torch.int64), ("c", 7, torch.int32)],
    [("a", 0, torch.int64), ("b", 1, torch.uint8), ("c", 0, torch.int32),
     ("d", 9, torch.int64)],
    [("a", 1, torch.int32)],
])
def test_carve_pieces_are_aligned_and_disjoint(layout):
    buf, ptrs, offs = Kr._carve("cpu", layout)
    base, end = buf.data_ptr(), buf.data_ptr() + 8 * buf.numel()
    spans = []
    for name, n, dt in layout:
        if n == 0:
            assert ptrs[name] is None
            continue
        p = ptrs[name]
        assert p % 8 == 0 and p == base + 8 * offs[name]
        assert base <= p and p + n * dt.itemsize <= end
        spans.append((p, p + n * dt.itemsize))
    spans.sort()
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))


@pytest.mark.parametrize("SC", [0, 3])
def test_explain_scratch_holds_every_piece(SC):
    N, k, grid, parts = 777, 16, 4, 41
    pieces = Kr.explain_row_args(N, k, SC, grid, parts)
    names = [p[0] for p in pieces]
    # the scratch SigCache, and every scratch pointer of ExplainArgsC
    assert set(Kr._CACHE_FIELDS) <= set(names)
    scratch = {f for f, _t in Kr.ExplainArgsC._fields_
               if f in ("part", "cand", "masked", "gsc", "feas", "flags")}
    assert scratch <= set(names) and len(names) == len(set(names))
    size = dict((p[0], p[1]) for p in pieces)
    assert size["part"] == grid * parts and size["cand"] == grid * k
    assert size["flags"] == max(SC, 1) * N
    _buf, ptrs, _offs = Kr._carve("cpu", pieces)
    assert len(set(ptrs.values())) == len(pieces)


@pytest.mark.parametrize("D", [1, 2, 4])
def test_lean_exchange_folds_block_partials_with_the_shards(D):
    """A grid kernel's [blocks, LOC] partials reduce with the shards in
    the one exchange: the sums of the counts, the maxima of the last two,
    as if each shard had sent one reduced row."""
    rng = np.random.RandomState(D)
    mesh = S.make_mesh(devices=["cpu"] * D)
    LOC = Kr.MAX_IC + 3
    locs = [torch.from_numpy(rng.randint(-50, 2 ** 40, (5, LOC)))
            for _ in range(D)]
    got = S.lean_exchange(mesh, locs)
    rows = torch.cat(locs)
    want = torch.cat([rows[:, :LOC - 2].sum(0), rows[:, LOC - 2:].amax(0)])
    flat = S.lean_exchange(mesh, [torch.cat([x[:, :LOC - 2].sum(0),
                                             x[:, LOC - 2:].amax(0)])
                                  for x in locs])
    for g, f in zip(got, flat):
        assert torch.equal(g, want) and torch.equal(f, want)


def _cpu_state(n_nodes=20):
    rng = random.Random(3)
    cache = Cache()
    for i in range(n_nodes):
        cache.add_node(make_node(f"n{i}").capacity(
            {"cpu": rng.choice([2, 4, 8]), "memory": "8Gi"}).obj())
    snap = Snapshot()
    cache.update_snapshot(snap)
    state = ClusterState(device="cpu")
    state.apply_snapshot(snap)
    batch = BatchBuilder(state).build(
        [make_pod("p").req({"cpu": "1", "memory": "1Gi"}).obj()])
    return state.device_arrays(), batch, P.table_from_batch(batch, "cpu")


@pytest.mark.parametrize("bad", ["tidx", "k_zero", "k_over_16", "k_over_n"])
def test_explain_row_cuda_checks_before_building(bad):
    na, batch, table = _cpu_state(6)           # N = 8 rows
    carry = P.initial_carry(na)
    u, k = int(batch.tidx[0]), 4
    if bad == "tidx":
        u = table.req.shape[0]
    else:
        k = {"k_zero": 0, "k_over_16": 17, "k_over_n": 9}[bad]
    with pytest.raises(ValueError, match="explain_row"):
        Kr.explain_row_cuda(P.ScoreConfig(), na, carry, table, u, k)


@pytest.mark.parametrize("bad", ["K", "J", "L", "tidx", "unequal"])
@pytest.mark.parametrize("gang", [False, True])
def test_uniform_sharded_cuda_checks_before_building(bad, gang):
    na, batch, table = _cpu_state(20)          # N = 32 rows
    mesh = S.make_mesh(devices=["cpu"] * 2)
    gna = S.shard_node_arrays(mesh, na)
    gc = S.initial_carry_sharded(gna)
    L, K, J = 16, 16, 4
    x = P.PodXs(True, int(batch.sig[0]), int(batch.tidx[0]))
    if bad in ("K", "J", "L"):
        L, K, J = (0 if bad == "L" else L, 0 if bad == "K" else K,
                   0 if bad == "J" else J)
    elif bad == "tidx":
        x = P.PodXs(True, int(batch.sig[0]), table.req.shape[0])
    else:
        cut = type(gna[1])(*(t[:8] if t.dim() else t for t in gna[1]))
        gna = S.Shards([gna[0], cut])
    what = "run_gang_sharded" if gang else "run_uniform_sharded"
    with pytest.raises(ValueError, match=what):
        if gang:
            Kr.run_gang_uniform_sharded_cuda(P.ScoreConfig(), mesh, gna, gc,
                                             x, table, 8, 8, L, K, J)
        else:
            Kr.run_uniform_sharded_cuda(P.ScoreConfig(), mesh, gna, gc, x,
                                        table, 8, L, K, J)


def _uniform_branches(n_nodes: int, K: int, L: int, J: int,
                      n_actual: int) -> set:
    N = pow2_at_least(n_nodes)
    lay = Kr.uniform_layout(N, min(K, N), J, n_actual)
    return {f"rows_{lay.rows}", f"keys_{lay.keys}", f"rank_{lay.rank}"}


@pytest.mark.parametrize("branch", ["rows_all", "rows_grid", "keys_none",
                                    "keys_all", "keys_grid", "rank_one_tile",
                                    "rank_smem", "rank_global"])
def test_uniform_cases_reach_every_branch(branch):
    """Some case of the card tests takes each branch of run_uniform.cu:
    every row a candidate, or the top K rows selected by the grid; no
    entry counted, every entry, or the top n_actual selected by the grid;
    the order in one shared-memory tile, or tiled with the rank search
    over tiles staged in shared memory or in place."""
    hit = [name for name, (n, _i, _c, K, L, J, a) in UNI_CASES.items()
           if branch in _uniform_branches(n, K, L, J, a)]
    assert hit, branch


def test_uniform_layout_at_the_main_path_shapes():
    # SchedulingBasic (L = K = N = 8,192, J = 8): every row, the grid's
    # selection, 16 tiles ranked in shared memory; GangTraining (L = K =
    # 256): the grid over the rows and over the 2,048 entries, one tile
    sb = Kr.uniform_layout(8192, 8192, 8, 8192)
    assert (sb.rows, sb.keys, sb.tiles, sb.rank, sb.blocks) == (
        "all", "grid", 16, "smem", 256)
    gt = Kr.uniform_layout(8192, 256, 8, 256)
    assert (gt.rows, gt.keys, gt.tiles, gt.tile, gt.rank) == (
        "grid", "grid", 1, 256, "one_tile")


@pytest.mark.parametrize("shape", [(32, 16, 4, 8), (512, 64, 4, 128),
                                   (512, 256, 8, 300), (8192, 1024, 16, 8192)])
def test_uniform_layout_selects_by_the_grid_at_every_size(shape):
    # one select path at any count of keys: the grid's digit passes, on a
    # one-block grid too
    N, K, J, n_actual = shape
    lay = Kr.uniform_layout(N, K, J, n_actual)
    assert (lay.rows, lay.keys) == ("grid", "grid")
    assert lay.blocks == max(-(-N // Kr.UNI_BLOCK), -(-K * J // Kr.UNI_BLOCK))


@pytest.mark.parametrize("shape", [(64, 64, 8, 40, 3), (512, 64, 4, 128, 8),
                                   (8192, 8192, 8, 0, 132)])
def test_uniform_scratch_holds_every_piece(shape):
    N, K, J, n_actual, grid = shape
    pieces = Kr.uniform_scratch(N, K, J, n_actual, grid)
    names = [p[0] for p in pieces]
    ptrs = {f for f, t in Kr.UniformArgsC._fields_ if t is Kr._P}
    # every scratch pointer of UniformArgsC, the outputs and the overlay
    # apart
    assert set(names) == ptrs - {"ovl_used", "ovl_npods", "packed"}
    assert len(names) == len(set(names))
    size = {p[0]: p[1] for p in pieces}
    assert size["part"] == grid * (Kr.MAX_IC + 3)
    assert size["keys1"] == size["fit_kj"] == K * J
    assert size["keys0"] == (N if K < N else 0)
    assert size["sel"] == n_actual
    buf, ptr, offs = Kr._carve("cpu", pieces)
    base, end = buf.data_ptr(), buf.data_ptr() + 8 * buf.numel()
    spans = sorted((ptr[n], ptr[n] + c * dt.itemsize)
                   for n, c, dt in pieces if c)
    assert all(p % 8 == 0 and base <= p and q <= end for p, q in spans)
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))


# the gang tier has no overlay
@pytest.mark.parametrize("bad,gang", [
    (b, g) for b in ("L", "K", "J", "L_over_KJ", "tidx", "sig", "n_actual",
                     "overlay") for g in (False, True)
    if not (g and b == "overlay")])
def test_uniform_cuda_checks_before_building(bad, gang):
    na, batch, table = _cpu_state(20)          # N = 32 rows
    carry = P.initial_carry(na)
    N, R = na.cap.shape
    L, K, J, n_actual = 16, 16, 4, 8
    sig, tidx = int(batch.sig[0]), int(batch.tidx[0])
    overlay = None
    if bad in ("L", "K", "J"):
        L, K, J = (0 if bad == "L" else L, 0 if bad == "K" else K,
                   0 if bad == "J" else J)
    elif bad == "L_over_KJ":
        L, K, J = 65, 16, 4
    elif bad == "tidx":
        tidx = table.req.shape[0]
    elif bad == "sig":
        sig = 0
    elif bad == "n_actual":
        n_actual = L + 1
    else:
        overlay = (torch.zeros((N, R + 1), dtype=torch.int64),
                   torch.zeros((N,), dtype=torch.int32))
    x = P.PodXs(True, sig, tidx)
    what = "run_gang" if gang else "run_uniform"
    with pytest.raises(ValueError, match=bad if bad == "overlay" else what):
        if gang:
            Kr.run_gang_uniform_cuda(P.ScoreConfig(), na, carry, x, table,
                                     n_actual, 4, L, K, J)
        else:
            Kr.run_uniform_cuda(P.ScoreConfig(), na, carry, x, table,
                                n_actual, L, K, J, overlay=overlay)


# ---------------------------------------------------------------------------
# the plan program (csrc/run_plan.cu, csrc/run_plan_sharded.cu): the
# checks before the build, the scratch carve, the route by placement


def _plan_cpu(n_nodes=20):
    na, batch, table = _cpu_state(n_nodes)
    u = int(batch.tidx[0])
    wt = [u, u]
    xs = P.WaveXs(valid=torch.ones((4,), dtype=torch.bool),
                  widx=torch.zeros((4,), dtype=torch.int32))
    return na, table, wt, xs


def _no_build(monkeypatch):
    def build():
        raise AssertionError("built before the checks")
    monkeypatch.setattr(Kr, "build", build)


@pytest.mark.parametrize("bad", ["slots_zero", "slots_over", "row_outside",
                                 "statics_shape", "widx_length"])
def test_run_plan_cuda_checks_before_building(monkeypatch, bad):
    _no_build(monkeypatch)
    na, table, wt, xs = _plan_cpu()
    carry = P.initial_carry(na)
    statics = P.wave_statics(na, table, wt)
    if bad == "slots_zero":
        wt = []
    elif bad == "slots_over":
        wt = wt * 17                                 # 34 slots
        statics = tuple(torch.cat([s] * 17) for s in statics)
    elif bad == "row_outside":
        wt = [wt[0], table.req.shape[0]]
    elif bad == "statics_shape":
        statics = tuple(s[:1] for s in statics)
    else:
        xs = xs._replace(widx=xs.widx[:3])
    with pytest.raises(ValueError, match="run_plan"):
        Kr.run_plan_cuda(P.ScoreConfig(), na, carry, xs, table, wt, None,
                         statics, None, False, False, False)


@pytest.mark.parametrize("bad,place", [
    ("slots_over", "one"), ("slots_over", "cards"), ("ragged", "one"),
    ("ragged", "cards"), ("row_outside", "one"), ("widx_length", "cards")])
def test_run_plan_sharded_cuda_checks_before_building(monkeypatch, bad,
                                                      place):
    _no_build(monkeypatch)
    na, table, wt, xs = _plan_cpu()                 # N = 32 rows
    cpu = S.make_mesh(devices=["cpu"] * 2)
    gna = S.shard_node_arrays(cpu, na)
    statics = S.wave_statics_sharded(cpu, gna, table, wt)
    mesh = cpu if place == "one" else S.Mesh(["cuda:0", "cuda:1"])
    if bad == "slots_over":
        wt = wt * 17
    elif bad == "ragged":
        cut = type(gna[1])(*(t[:8] if t.dim() else t for t in gna[1]))
        gna = S.Shards([gna[0], cut])
    elif bad == "row_outside":
        wt = [wt[0], table.req.shape[0]]
    else:
        xs = xs._replace(widx=xs.widx[:3])
    carry = S.initial_carry_sharded(gna)
    with pytest.raises(ValueError, match="run_plan_sharded"):
        Kr.run_plan_sharded_cuda(P.ScoreConfig(), mesh, gna, carry, xs,
                                 table, wt, None, statics, None, False,
                                 False, False)


@pytest.mark.parametrize("shape", [(8, 8192, 1, 1, False, 0),
                                   (32, 8192, 1, 8, True, 0),
                                   (8, 4096, 2, 1, True, 8),
                                   (4, 2048, 4, 3, True, 8),
                                   (3, 37, 3, 2, True, 3)])
def test_plan_span_scratch_is_aligned_and_disjoint(shape):
    S_, n_local, D, SC, spread_s, blocks = shape
    pieces = Kr.plan_span_parts(S_, n_local, D, SC, spread_s, blocks)
    size = {name: n for name, n, _dt in pieces}
    assert len(size) == len(pieces)
    # the partial slots: two halves of one slot a block; the flags span
    # every shard's rows
    assert size["part"] == 2 * blocks * Kr.PLAN_RED_K
    assert size["flags"] == (SC * D * n_local if spread_s else 0)
    buf, ptrs, offs = Kr._carve("cpu", pieces)
    base, end = buf.data_ptr(), buf.data_ptr() + 8 * buf.numel()
    spans = []
    for name, n, dt in pieces:
        if n == 0:
            assert ptrs[name] is None
            continue
        assert ptrs[name] % 8 == 0 and ptrs[name] == base + 8 * offs[name]
        assert ptrs[name] + n * dt.itemsize <= end
        spans.append((ptrs[name], ptrs[name] + n * dt.itemsize))
    spans.sort()
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    # every shard's scratch pointers of PlanNodesC come from the carve
    for d in range(D):
        nodes = Kr.PlanNodesC()
        Kr._set_scratch(nodes, ptrs, d)
        for f in ("s_fit", "s_bal", "fit_ok"):
            assert getattr(nodes, f) == ptrs[f"{f}{d}"] is not None


def test_plan_sharded_routes_one_card_to_one_launch(monkeypatch):
    M = S.Mesh
    assert Kr.plan_sharded_placement(M(["cuda:0"] * 4)) == "one"
    assert Kr.plan_sharded_placement(M(["cpu"] * 2)) == "one"
    assert Kr.plan_sharded_placement(M(["cuda:0", "cuda:1"])) == "cards"
    assert Kr.plan_sharded_placement(
        M(["cuda:0", "cuda:0", "cuda:1", "cuda:1"])) == "cards"
    seen = []
    monkeypatch.setattr(Kr, "_plan_sharded_one",
                        lambda *a: seen.append("one") or ("out", "packed"))
    monkeypatch.setattr(Kr, "_plan_sharded_chain",
                        lambda *a: seen.append("chain") or ("out", "packed"))
    na, table, wt, xs = _plan_cpu()
    cpu = S.make_mesh(devices=["cpu"] * 2)
    gna = S.shard_node_arrays(cpu, na)
    carry = S.initial_carry_sharded(gna)
    before = Kr.LAUNCHES["run_plan_sharded"]
    for mesh in (cpu, M(["cuda:0", "cuda:1"])):
        assert Kr.run_plan_sharded_cuda(
            P.ScoreConfig(), mesh, gna, carry, xs, table, wt, None, None,
            None, False, False, False) == ("out", "packed")
    assert seen == ["one", "chain"]
    assert Kr.LAUNCHES["run_plan_sharded"] == before + 2


@pytest.mark.parametrize("const,source,define", [
    ("MAX_PLAN_SLOTS", "plan_span.cuh", "KT_PLAN_MAX_S"),
    ("PLAN_RED_K", "plan_span.cuh", "KT_RED_K"),
    ("PLAN_BLOCK", "plan_span.cuh", "KT_PLAN_BLOCK"),
    ("PLAN_CLUSTER", "run_plan.cu", "KT_PLAN_CLUSTER")])
def test_plan_constants_mirror_the_sources(const, source, define):
    import re
    text = (Kr.CSRC / source).read_text()
    found = re.findall(rf"^#define {define} (\d+)\b", text, re.M)
    assert found == [str(getattr(Kr, const))]


# ---------------------------------------------------------------------------
# run_batch (csrc/run_batch.cu, one cluster a span) and the probe
# (csrc/cluster_probe.cu, a shard table): the checks before the build, the
# mirrored constants and structs, the probe's route by placement


def _struct_body(source: str, struct: str):
    """The body of `struct` as a csrc/ source compiles it: in the source
    or in a csrc/ header it includes (depth first), else None."""
    import re
    text = (Kr.CSRC / source).read_text()
    found = re.search(rf"^struct {struct} {{\n(.*?)^}};", text, re.M | re.S)
    if found:
        return found.group(1)
    for header in re.findall(r'^#include "([^"]+)"', text, re.M):
        body = _struct_body(header, struct)
        if body is not None:
            return body
    return None


def _c_fields(source: str, struct: str) -> list:
    """The field names of `struct` in a csrc/ source (or a header it
    includes), in order."""
    import re
    body = _struct_body(source, struct)
    names = []
    for line in body.splitlines():
        decl = line.split("//")[0].strip()
        if not decl:
            continue
        assert decl.endswith(";"), decl
        # the type is every word before the first name
        head, _, rest = decl[:-1].partition(",")
        words = head.replace("*", " ").split()
        names.append(re.sub(r"\[.*\]", "", words[-1]))
        names += [re.sub(r"\[.*\]", "", n.replace("*", "").strip())
                  for n in rest.split(",") if n.strip()]
    return names


@pytest.mark.parametrize("cls,source,struct", [
    ("BatchArgsC", "run_batch.cu", "BatchArgs"),
    ("BatchSpanC", "batch_span.cuh", "BatchSpanC"),
    ("BatchNodesC", "batch_span.cuh", "BatchNodesC"),
    ("GangSpanC", "run_gang_sharded.cu", "GangSpanC"),
    ("GangNodesC", "run_gang_sharded.cu", "GangNodesC"),
    ("GangSpanC", "gang_span.cuh", "GangSpanC"),
    ("GangNodesC", "gang_span.cuh", "GangNodesC"),
    ("GangSpanC", "run_gang.cu", "GangSpanC"),
    ("GangNodesC", "run_gang.cu", "GangNodesC"),
    ("DryPlanC", "dry_run.cu", "DryPlanC"),
    ("ProbeShardC", "cluster_probe.cu", "ProbeShard"),
    ("ProbeArgsC", "cluster_probe.cu", "ProbeArgs"),
    ("WaveArgsC", "run_wave.cu", "WaveArgs"),
    ("StaticsShardC", "wave_statics.cu", "StaticsShard"),
    ("StaticsArgsC", "wave_statics.cu", "StaticsArgs"),
    ("DiagArgsC", "diagnose_row.cu", "DiagArgs")])
def test_kernel_arg_structs_mirror_the_sources(cls, source, struct):
    fields = [f for f, _t in getattr(Kr, cls)._fields_]
    assert fields == _c_fields(source, struct)


def test_probe_shard_table_layout():
    """The shard table the probe kernels take by value: PROBE_MAX_SHARDS
    entries of four pointers and a row count, then the shard count, the
    domain column and the sizes."""
    import ctypes
    s = dict(Kr.ProbeArgsC._fields_)["s"]
    assert s._length_ == Kr.PROBE_MAX_SHARDS == Kr.USH_MAX_SHARDS
    assert s._type_ is Kr.ProbeShardC
    assert ctypes.sizeof(Kr.ProbeShardC) == 5 * 8      # 4 pointers, i32, pad
    assert Kr.ProbeArgsC.D.offset == Kr.PROBE_MAX_SHARDS * 40
    assert Kr.ProbeArgsC.dom.offset == Kr.ProbeArgsC.D.offset + 8
    args = Kr.ProbeArgsC((Kr.ProbeShardC(rows=3), Kr.ProbeShardC(rows=5)),
                         D=2)
    assert [args.s[d].rows for d in range(4)] == [3, 5, 0, 0]


@pytest.mark.parametrize("const,source,define", [
    ("BATCH_CLUSTER", "run_batch.cu", "KT_BATCH_CLUSTER"),
    ("GANG_CLUSTER", "run_gang.cu", "KT_GANG_CLUSTER"),
    ("MAX_DRY_R", "dry_run.cu", "KT_DRY_MAX_R"),
    ("PROBE_MAX_SHARDS", "cluster_probe.cu", "KT_PROBE_MAX_SHARDS"),
    ("PROBE_CLUSTER", "cluster_probe.cu", "KT_PROBE_CLUSTER"),
    ("PROBE_SMEM_KEYS", "cluster_probe.cu", "KT_PROBE_SMEM_KEYS"),
    ("WAVE_CLUSTER", "run_wave.cu", "KT_WAVE_CLUSTER"),
    ("MAX_WAVE_L", "run_wave.cu", "KT_WAVE_MAX_L"),
    ("WAVE_HASH", "run_wave.cu", "KT_WAVE_HASH"),
    ("MAX_WAVE_ROWS", "wave_statics.cu", "KT_WS_MAX_S"),
    ("WS_MAX_SHARDS", "wave_statics.cu", "KT_WS_MAX_SHARDS"),
    ("WS_CLUSTER", "wave_statics.cu", "KT_WS_CLUSTER"),
    ("MAX_DIAG_ROWS", "diagnose_row.cu", "KT_DIAG_MAX_S"),
    ("DIAG_CLUSTER", "diagnose_row.cu", "KT_DIAG_CLUSTER")])
def test_batch_and_probe_constants_mirror_the_sources(const, source, define):
    import re
    text = (Kr.CSRC / source).read_text()
    found = re.findall(rf"^#define {define} (\d+)\b", text, re.M)
    assert found == [str(getattr(Kr, const))]


def test_batch_shared_memory_layout():
    """A CTA's dynamic shared memory: the raw spread scores and the
    feasible set of its ⌈N / C⌉ rows, 16-byte aligned, then ipa_a_total
    of the group rows; the largest table (4,096 rows) fits at N = 65,536."""
    span = 8192 // Kr.BATCH_CLUSTER
    assert Kr.batch_dyn_bytes(8192, 0) == (9 * span + 15) // 16 * 16
    assert Kr.batch_dyn_bytes(8192, 64) == Kr.batch_dyn_bytes(8192, 0) + 512
    assert Kr.batch_dyn_bytes(65536, 4096) <= Kr.MAX_DYN_SMEM


def _batch_cpu(groups=False):
    from kubernetes_tpu_torch.ops.groups import GroupFamilies, to_device
    cache = Cache()
    for i in range(12):
        cache.add_node(make_node(f"n{i}").capacity(
            {"cpu": 8, "memory": "8Gi"}).zone(f"z{i % 3}").obj())
    snap = Snapshot()
    cache.update_snapshot(snap)
    state = ClusterState(device="cpu")
    state.apply_snapshot(snap)
    builder = BatchBuilder(state)
    w = make_pod("p").req({"cpu": "1", "memory": "1Gi"}).label("app", "s")
    if groups:
        w = w.spread_constraint(1, "topology.kubernetes.io/zone",
                                "DoNotSchedule", {"app": "s"})
    batch = builder.build([w.obj()] * 4)
    na = state.device_arrays()
    table = P.table_from_batch(batch, "cpu")
    xs = P.PodXs(valid=torch.from_numpy(batch.valid),
                 sig=torch.from_numpy(batch.sig),
                 tidx=torch.from_numpy(batch.tidx))
    gd = gc = fam = None
    if groups:
        gd_np, gc_np = builder.groups.build_dev(snap)
        gd, gc = to_device(gd_np, "cpu"), to_device(gc_np, "cpu")
        fam = GroupFamilies(*builder.groups.families(snap))
    return na, P.initial_carry(na, gc), xs, table, gd, fam


@pytest.mark.parametrize("bad", ["lengths", "dtype", "overlay_groups",
                                 "overlay_shape", "nom_length",
                                 "table_width", "group_rows"])
def test_run_batch_cuda_checks_before_building(monkeypatch, bad):
    _no_build(monkeypatch)
    groups = bad in ("overlay_groups", "group_rows")
    na, carry, xs, table, gd, fam = _batch_cpu(groups)
    N, R = na.cap.shape
    overlay = None
    if bad == "lengths":
        xs = xs._replace(sig=xs.sig[:-1])
    elif bad == "dtype":
        xs = xs._replace(tidx=xs.tidx.to(torch.int64))
    elif bad == "overlay_groups":
        overlay = (torch.zeros((N, R), dtype=torch.int64),
                   torch.zeros((N,), dtype=torch.int32))
    elif bad == "overlay_shape":
        overlay = (torch.zeros((N, R + 1), dtype=torch.int64),
                   torch.zeros((N,), dtype=torch.int32))
    elif bad == "nom_length":
        overlay = (torch.zeros((N, R), dtype=torch.int64),
                   torch.zeros((N,), dtype=torch.int32))
        xs = xs._replace(nom_idx=torch.full((1,), -1, dtype=torch.int32))
    elif bad == "table_width":
        table = table._replace(req=table.req[:, :-1].contiguous())
    else:
        # more group rows than the table has
        table = type(table)(*(t[:1] for t in table))
    with pytest.raises((ValueError, TypeError)):
        Kr.run_batch_cuda(P.ScoreConfig(), na, carry, xs, table, gd, fam,
                          overlay=overlay)


def test_cluster_probe_sharded_gathers_only_across_cards(monkeypatch):
    """On one card the mesh's probe hands the kernels its D shards
    (D <= PROBE_MAX_SHARDS) and gathers nothing; shards on several cards,
    or more shards than the table holds, are gathered onto the first
    device first."""
    na, _batch, _table = _cpu_state(20)              # N = 32 rows
    carry = P.initial_carry(na)
    dom = torch.zeros((na.cap.shape[0],), dtype=torch.int32)
    launched, gathered = [], []
    real = S.gather_rows
    monkeypatch.setattr(S, "mesh_kind", lambda *a: "cuda")
    monkeypatch.setattr(S, "gather_rows",
                        lambda *a: gathered.append(1) or real(*a))
    monkeypatch.setattr(Kr, "_cluster_probe_launch", lambda *a: launched
                        .append([len(c) for c in a[:4]]) or ("probe",))
    placement = Kr.plan_sharded_placement
    for D, place, shards in [(1, "one", 1), (2, "one", 2), (4, "one", 4),
                             (8, "one", 1), (2, "cards", 1),
                             (4, "cards", 1)]:
        monkeypatch.setattr(Kr, "plan_sharded_placement",
                            placement if place == "one"
                            else (lambda mesh: "cards"))
        mesh = S.make_mesh(devices=["cpu"] * D)
        launched.clear()
        gathered.clear()
        before = Kr.LAUNCHES["cluster_probe_sharded"]
        assert S.cluster_probe_sharded(mesh, S.shard_node_arrays(mesh, na),
                                       S.shard_carry(mesh, carry), dom,
                                       4) == ("probe",)
        assert launched == [[shards] * 4]
        assert len(gathered) == (0 if shards > 1 or D == 1 else 4)
        assert Kr.LAUNCHES["cluster_probe_sharded"] == before + 1


# ---------------------------------------------------------------------------
# the mesh's two scans (csrc/run_batch_sharded.cu, csrc/run_gang_sharded.cu):
# shards on one card are one cooperative launch a span or gang, shards on
# several cards keep the chain; every argument is checked before the build


def _sharded_batch_cpu(D=2, groups=False):
    na, carry, xs, table, gd, fam = _batch_cpu(groups)
    mesh = S.make_mesh(devices=["cpu"] * D)
    gna = S.shard_node_arrays(mesh, na)
    gc = S.shard_group_carry(mesh, carry.groups) if groups else None
    ggd = S.shard_groups(mesh, gd) if groups else None
    return mesh, gna, S.initial_carry_sharded(gna, gc), xs, table, ggd, fam


def _sharded_gang_cpu(D=2):
    na, batch, table = _cpu_state(20)                # N = 32 rows
    mesh = S.make_mesh(devices=["cpu"] * D)
    gna = S.shard_node_arrays(mesh, na)
    u = int(batch.tidx[0])
    wt = [u]
    from kubernetes_tpu_torch.ops.gang import GangXs
    xs = GangXs(valid=torch.ones((4,), dtype=torch.bool),
                tidx=torch.full((4,), u, dtype=torch.int32),
                widx=torch.zeros((4,), dtype=torch.int32))
    n = na.cap.shape[0] // D
    dom = [torch.zeros((n,), dtype=torch.int32) for _ in range(D)]
    statics = S.wave_statics_sharded(mesh, gna, table, wt)
    return mesh, gna, S.initial_carry_sharded(gna), xs, table, wt, dom, \
        statics


def _cards(monkeypatch, place):
    if place == "cards":
        monkeypatch.setattr(Kr, "plan_sharded_placement",
                            lambda mesh: "cards")


def test_sharded_scans_route_one_card_to_one_launch(monkeypatch):
    """Both mesh scans take one cooperative launch when the shards share a
    card and the chain when they do not; LAUNCHES counts one a call
    either way."""
    seen = []
    for name in ("_batch_sharded_one", "_batch_sharded_chain",
                 "_gang_sharded_one", "_gang_sharded_chain"):
        monkeypatch.setattr(Kr, name, lambda *a, _n=name: seen.append(_n)
                            or ("out", "packed"))
    mesh, gna, carry, xs, table, _g, _f = _sharded_batch_cpu()
    gmesh, ggna, gcarry, gxs, gtable, wt, dom, statics = _sharded_gang_cpu()
    before = dict(Kr.LAUNCHES)
    for m in (mesh, S.Mesh(["cuda:0", "cuda:1"])):
        assert Kr.run_batch_sharded_cuda(P.ScoreConfig(), m, gna, carry, xs,
                                         table) == ("out", "packed")
        assert Kr.run_gang_sharded_cuda(
            P.ScoreConfig(), m, ggna, gcarry, gxs, gtable, wt, 4, dom,
            statics, 2) == ("out", "packed")
    assert seen == ["_batch_sharded_one", "_gang_sharded_one",
                    "_batch_sharded_chain", "_gang_sharded_chain"]
    for k in ("run_batch_sharded", "run_gang_sharded"):
        assert Kr.LAUNCHES[k] == before[k] + 2


@pytest.mark.parametrize("raw", ["run_batch_sharded", "run_plan_sharded",
                                 "run_gang_sharded"])
def test_chain_launches_are_counted_where_they_launch(monkeypatch, raw):
    """The chains' launch helper adds one to RAW_LAUNCHES[raw] at each
    shard's launch, in order, and ORs the return codes; a launch that
    raises is not counted."""
    import contextlib
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    calls = []

    def fn(a, k, stream):
        calls.append((a, k, stream, Kr.RAW_LAUNCHES[raw]))
        if a == "boom":
            raise RuntimeError("launch")
        return {"s1": 4, "s2": 1}.get(a, 0)

    shards = [(f"s{d}", f"st{d}", None) for d in range(3)]
    start = Kr.RAW_LAUNCHES[raw]
    assert Kr._each(shards, raw, fn, [7, 8, 9]) == 5
    assert calls == [("s0", 7, "st0", start), ("s1", 8, "st1", start + 1),
                     ("s2", 9, "st2", start + 2)]
    assert Kr.RAW_LAUNCHES[raw] == start + 3
    with pytest.raises(RuntimeError):
        Kr._each(shards[:1] + [("boom", "st", None)], raw, fn, [1, 2])
    assert Kr.RAW_LAUNCHES[raw] == start + 4


@pytest.mark.parametrize("place", ["one", "cards"])
@pytest.mark.parametrize("bad", ["lengths", "dtype", "table_width",
                                 "group_rows", "ragged"])
def test_run_batch_sharded_cuda_checks_before_building(monkeypatch, bad,
                                                       place):
    _no_build(monkeypatch)
    _cards(monkeypatch, place)
    groups = bad == "group_rows"
    mesh, gna, carry, xs, table, ggd, fam = _sharded_batch_cpu(2, groups)
    if bad == "lengths":
        xs = xs._replace(sig=xs.sig[:-1])
    elif bad == "dtype":
        xs = xs._replace(tidx=xs.tidx.to(torch.int64))
    elif bad == "table_width":
        table = table._replace(req=table.req[:, :-1].contiguous())
    elif bad == "group_rows":
        # more group rows than the table has
        table = type(table)(*(t[:1] for t in table))
    else:
        cut = type(gna[1])(*(t[:4] if t.dim() else t for t in gna[1]))
        gna = S.Shards([gna[0], cut])
    with pytest.raises((ValueError, TypeError)):
        Kr.run_batch_sharded_cuda(P.ScoreConfig(), mesh, gna, carry, xs,
                                  table, ggd, fam)


@pytest.mark.parametrize("place", ["one", "cards"])
@pytest.mark.parametrize("bad", ["empty", "row_outside", "xs_lengths",
                                 "dom_length", "statics_shape", "ragged"])
def test_run_gang_sharded_cuda_checks_before_building(monkeypatch, bad,
                                                      place):
    _no_build(monkeypatch)
    _cards(monkeypatch, place)
    mesh, gna, carry, xs, table, wt, dom, statics = _sharded_gang_cpu()
    if bad == "empty":
        wt = []
    elif bad == "row_outside":
        wt = [table.req.shape[0]]
    elif bad == "xs_lengths":
        xs = xs._replace(widx=xs.widx[:3])
    elif bad == "dom_length":
        dom = [d[:-1] for d in dom]
    elif bad == "statics_shape":
        statics = [tuple(s[:, :-1].contiguous() for s in st)
                   for st in statics]
    else:
        cut = type(gna[1])(*(t[:8] if t.dim() else t for t in gna[1]))
        gna = S.Shards([gna[0], cut])
    with pytest.raises(ValueError, match="run_gang_sharded"):
        Kr.run_gang_sharded_cuda(P.ScoreConfig(), mesh, gna, carry, xs,
                                 table, wt, 4, dom, statics, 2)


@pytest.mark.parametrize("shape", [(1, 4096, 2, 8, 3, True),
                                   (4, 512, 4, 1, 0, False),
                                   (8, 2500, 1, 5, 1, True)])
def test_sharded_scan_scratch_is_aligned_and_disjoint(shape):
    """The one-launch scans' scratch: the grid team's partial slots and
    the flags (the batch span), the slots and each shard's fit surfaces
    (the gang), each piece 8-byte aligned, none overlapping; each shard's
    GangNodesC surfaces come from the carve."""
    S_, n_local, D, T, SC, spread_s = shape
    batch = Kr.batch_span_parts(SC, D * n_local, spread_s, D * T)
    gang = Kr.gang_span_parts(S_, n_local, D, D * T)
    sizes = {name: n for name, n, _dt in batch + gang}
    assert sizes["part"] == 2 * D * T * Kr.PLAN_RED_K
    assert sizes["flags"] == (SC * D * n_local if spread_s else 0)
    for pieces in (batch, gang):
        buf, ptrs, offs = Kr._carve("cpu", pieces)
        end = buf.data_ptr() + 8 * buf.numel()
        spans = sorted((ptrs[nm], ptrs[nm] + n * dt.itemsize)
                       for nm, n, dt in pieces if n)
        assert all(p % 8 == 0 for p, _e in spans)
        assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
        assert spans[-1][1] <= end
    _buf, ptrs, _offs = Kr._carve("cpu", gang)
    for d in range(D):
        nodes = Kr.GangNodesC()
        Kr._set_scratch(nodes, ptrs, d)
        for f in ("s_fit", "s_bal", "fit_ok"):
            assert getattr(nodes, f) == ptrs[f"{f}{d}"] is not None


def test_scan_grid_shared_memory_layout():
    """A grid block's dynamic shared memory: run_batch's layout for its
    ⌈n_local / T⌉ rows (the cluster's at T = BATCH_CLUSTER); the largest
    table (4,096 group rows) fits a block at n_local = 65,536 over the
    card's 132 SMs."""
    assert Kr.batch_dyn_bytes(8192, 64, Kr.BATCH_CLUSTER) == \
        Kr.batch_dyn_bytes(8192, 64)
    assert Kr.batch_dyn_bytes(4096, 0, 8) == (9 * 512 + 15) // 16 * 16
    assert Kr.batch_dyn_bytes(65536, 4096, 132) <= Kr.MAX_DYN_SMEM


# ---------------------------------------------------------------------------
# run_gang's scan tier (csrc/run_gang.cu: gang_span.cuh's body as a
# thread-block cluster) and the dry run's subset entry (csrc/dry_run.cu,
# the plan's argument block packed once): the checks before the build,
# the one-shard carve, the body written once, the block's rebuild


def _gang_cpu():
    na, batch, table = _cpu_state(20)                # N = 32 rows
    u = int(batch.tidx[0])
    from kubernetes_tpu_torch.ops.gang import GangXs
    xs = GangXs(valid=torch.ones((4,), dtype=torch.bool),
                tidx=torch.full((4,), u, dtype=torch.int32),
                widx=torch.zeros((4,), dtype=torch.int32))
    N = na.cap.shape[0]
    dom = torch.zeros((N,), dtype=torch.int32)
    return na, P.initial_carry(na), xs, table, [u], dom, \
        P.wave_statics(na, table, [u])


@pytest.mark.parametrize("bad", ["empty", "row_outside", "xs_lengths",
                                 "xs_dtype", "dom_length", "statics_shape"])
def test_run_gang_cuda_checks_before_building(monkeypatch, bad):
    _no_build(monkeypatch)
    na, carry, xs, table, wt, dom, statics = _gang_cpu()
    if bad == "empty":
        wt = []
    elif bad == "row_outside":
        wt = [table.req.shape[0]]
    elif bad == "xs_lengths":
        xs = xs._replace(widx=xs.widx[:3])
    elif bad == "xs_dtype":
        xs = xs._replace(tidx=xs.tidx.to(torch.int64))
    elif bad == "dom_length":
        dom = dom[:-1]
    else:
        statics = tuple(s[:, :-1].contiguous() for s in statics)
    with pytest.raises((ValueError, TypeError)):
        Kr.run_gang_cuda(P.ScoreConfig(), na, carry, xs, table, wt, 4, dom,
                         statics, 2)


@pytest.mark.parametrize("shape", [(1, 8192), (4, 8192), (2, 1536), (3, 37)])
def test_gang_one_shard_scratch_is_aligned_and_disjoint(shape):
    """run_gang's scratch: gang_span_parts at D = 1 with no grid slots (the
    cluster reduces through shared memory), the S slots' three fit
    surfaces 8-byte aligned and disjoint, GangNodesC's surfaces from the
    carve, and a CTA's contiguity counts within its shared memory."""
    S_, N = shape
    pieces = Kr.gang_span_parts(S_, N, 1, 0)
    buf, ptrs, _offs = Kr._carve("cpu", pieces)
    assert ptrs["part"] is None
    end = buf.data_ptr() + 8 * buf.numel()
    spans = sorted((ptrs[nm], ptrs[nm] + n * dt.itemsize)
                   for nm, n, dt in pieces if n)
    assert [n for nm, n, _dt in pieces if nm != "part"] == [S_ * N] * 3
    assert all(p % 8 == 0 for p, _e in spans)
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert spans[-1][1] <= end
    nodes = Kr.GangNodesC()
    Kr._set_scratch(nodes, ptrs, 0)
    for f in ("s_fit", "s_bal", "fit_ok"):
        assert getattr(nodes, f) == ptrs[f"{f}0"] is not None
    span = -(-N // Kr.GANG_CLUSTER)
    assert Kr.gang_dyn_bytes(span) >= 4 * span
    assert Kr.gang_dyn_bytes(span) % 16 == 0


def test_gang_scan_body_is_written_once():
    """The gang scan's body lives in gang_span.cuh alone: run_gang.cu
    launches it as a cluster (its only kernel), run_gang_sharded.cu's grid
    kernel calls the same template, and no source keeps a hoist or scan
    kernel of its own."""
    import re
    one = (Kr.CSRC / "run_gang.cu").read_text()
    grid = (Kr.CSRC / "run_gang_sharded.cu").read_text()
    assert '#include "gang_span.cuh"' in one
    assert '#include "gang_span.cuh"' in grid
    assert len(re.findall(r"__global__", one)) == 1
    assert "gang_span<BLOCK>(" in one and "ClusterTeam<BLOCK>" in one
    assert "gang_span<GBLOCK>(" in grid and "GridTeam<GBLOCK>" in grid
    for f in Kr.CSRC.glob("*.cu*"):
        text = f.read_text()
        assert "gang_hoist_kernel" not in text, f.name
        assert "gang_scan_kernel" not in text, f.name


def _dry_cpu(V=2):
    na, batch, table = _cpu_state(20)
    R = na.cap.shape[1]
    pod = P.pod_row_from_table(batch.table, int(batch.tidx[0]), "cpu")
    Cp = 4
    wave = P.DryRunWave(
        na, pod, torch.arange(Cp, dtype=torch.int32),
        torch.ones((Cp, V, R), dtype=torch.int64),
        torch.ones((Cp, V), dtype=torch.bool))
    sub = torch.tensor([2, 0], dtype=torch.int32)
    ovl = (torch.zeros((2, R), dtype=torch.int64),
           torch.zeros((2,), dtype=torch.int32))
    return wave, sub, ovl


@pytest.mark.parametrize("bad", ["no_block", "stale", "sub_dtype",
                                 "overlay_rows", "victim_slots",
                                 "victim_shape"])
def test_dry_run_subset_cuda_checks_before_building(monkeypatch, bad):
    _no_build(monkeypatch)
    wave, sub, (ou, on) = _dry_cpu()
    if bad == "victim_slots":
        R = wave.na.cap.shape[1]
        wave = wave._replace(
            victim_req=torch.zeros((4, 129, R), dtype=torch.int64),
            victim_valid=torch.zeros((4, 129), dtype=torch.bool))
        with pytest.raises(ValueError, match="victim slots"):
            Kr.DryRunArgs(wave)
        return
    if bad == "victim_shape":
        wave = wave._replace(victim_valid=wave.victim_valid[:3])
        with pytest.raises(ValueError, match="victim tensors"):
            Kr.DryRunArgs(wave)
        return
    args = Kr.DryRunArgs(wave)
    if bad == "no_block":
        args = None
    elif bad == "stale":
        wave = wave._replace(victim_req=wave.victim_req.clone())
    elif bad == "sub_dtype":
        sub = sub.to(torch.int64)
    else:
        ou = ou[:1]
    with pytest.raises((ValueError, TypeError)):
        Kr.dry_run_subset_cuda(args, wave, sub, ou, on)


def test_dry_run_block_rebuilt_when_node_rows_change(monkeypatch):
    """The Evaluator packs a plan's argument block once and again whenever
    the node rows it reads are other tensors (a scatter or reseed between
    two preemptors of one wave): the new block points into the new rows,
    and the old one, handed the new wave, is refused before any build."""
    from kubernetes_tpu_torch.framework.preemption import (Evaluator,
                                                           _DryRunPlan)
    _no_build(monkeypatch)
    packed = []

    def args(wave):
        packed.append(Kr.DryRunArgs(wave))
        return packed[-1]
    monkeypatch.setattr(P, "dry_run_args", args)
    wave, sub, (ou, on) = _dry_cpu()
    plan = _DryRunPlan(key=(), cands=[], cand_idx=wave.cand, cand_pos={},
                       victim_req=wave.victim_req,
                       victim_valid=wave.victim_valid, spread=None,
                       constraints=[], prow=wave.pod)
    rows = [wave.na]
    ctx = SimpleNamespace(state=SimpleNamespace(
        device_arrays=lambda: rows[0]))
    ev = Evaluator.__new__(Evaluator)
    w1, a1 = ev._dry_run_wave(plan, ctx)
    assert a1.c.na.cap == wave.na.cap.data_ptr()
    # the same rows (a fresh tuple of the same tensors): the same block
    rows[0] = type(wave.na)(*wave.na)
    assert ev._dry_run_wave(plan, ctx) == (w1, a1) and len(packed) == 1
    # fresh rows: a new block over them
    rows[0] = type(wave.na)(*(t.clone() for t in wave.na))
    w2, a2 = ev._dry_run_wave(plan, ctx)
    assert len(packed) == 2 and a2 is not a1 and w2.na is rows[0]
    for f in ("cap", "valid", "name_id", "taint_eff", "label_kv"):
        assert getattr(a2.c.na, f) == getattr(rows[0], f).data_ptr()
    assert a2.c.used == rows[0].used.data_ptr()
    assert a2.c.npods == rows[0].npods.data_ptr()
    assert a2.over(w2) and not a1.over(w2)
    with pytest.raises(ValueError, match="stale"):
        Kr.dry_run_subset_cuda(a1, w2, sub, ou, on)


# ---------------------------------------------------------------------------
# run_wave (csrc/run_wave.cu, one cluster a call): the shared-memory layout,
# the scratch carve, the checks before the build


def test_wave_shared_memory_layout():
    """A CTA's dynamic shared memory: its ⌈N / C⌉ rows' raw spread scores
    and feasible set, 16-byte aligned, then the leader's KT_WAVE_MAX_L
    keys (int64), six int32 and two byte arrays (the top-K rows and the
    entries) and the replay's domain table (two int32 a slot); the formula
    is the source's, and 65,536 rows fit."""
    import re
    span = 8192 // Kr.WAVE_CLUSTER
    leader = Kr.MAX_WAVE_L * (8 + 4 * 6 + 2) + Kr.WAVE_HASH * 8
    assert Kr.wave_dyn_bytes(8192) == (9 * span + 15) // 16 * 16 + leader
    assert Kr.wave_dyn_bytes(8193) == (9 * (span + 1) + 15) // 16 * 16 \
        + leader
    assert Kr.wave_dyn_bytes(65536) <= Kr.MAX_DYN_SMEM
    text = (Kr.CSRC / "run_wave.cu").read_text()
    assert re.search(r"\(9 \* span \+ 15\) / 16 \* 16\s+\+ KT_WAVE_MAX_L "
                     r"\* \(8 \+ 4 \* 6 \+ 2\) \+ KT_WAVE_HASH \* 8;",
                     text)
    assert Kr.WAVE_HASH == 2 * Kr.MAX_WAVE_L


def test_wave_scratch_is_one_carve():
    """The wrapper's scratch is one int64 allocation carved into every
    WaveArgs scratch field (each 8-byte aligned; a zero-width field null),
    the int64 pieces first."""
    parts = Kr.wave_parts(100, 8, 2, 0)
    assert [p[0] for p in parts] == ["masked", "champ", "fseg", "keys1",
                                     "f_cnt", "veto", "aa_cnt", "cnt_n",
                                     "cnt_add", "dshare", "elig_dom",
                                     "flags", "gmask"]
    assert sorted(p[0] for p in parts) == sorted(Kr._WAVE_SCRATCH)
    sizes = dict((p[0], p[1]) for p in parts)
    assert sizes["keys1"] == 800 and sizes["fseg"] == 300
    assert sizes["dshare"] == 200 and sizes["aa_cnt"] == 0
    buf, ptr, offs = Kr._carve("cpu", parts)
    assert ptr["aa_cnt"] is None
    assert all(v % 8 == 0 for v in ptr.values() if v is not None)
    assert buf.dtype == torch.int64
    assert buf.numel() * 8 >= sum(-(-n * dt.itemsize // 8) * 8
                                  for _n, n, dt in parts)


def _wave_cpu(n_nodes=12):
    na, carry, _xs, table, gd, fam = _batch_cpu(groups=True)
    u = int(torch.unique(_xs.tidx)[0])
    statics = tuple(x[0] for x in P.wave_statics(na, table, [u]))
    valid = torch.ones((4,), dtype=torch.bool)
    return na, carry, valid, table, u, gd, statics, fam


@pytest.mark.parametrize("bad", ["row_outside", "statics_shape", "k_over_n",
                                 "lw_over_kj", "k_over_cap", "anti_term"])
def test_run_wave_cuda_checks_before_building(monkeypatch, bad):
    _no_build(monkeypatch)
    na, carry, valid, table, u, gd, statics, fam = _wave_cpu()
    N = na.cap.shape[0]
    K, J, Lw, anti = 4, 2, 4, -1
    if bad == "row_outside":
        u = table.req.shape[0]
    elif bad == "statics_shape":
        statics = tuple(s[:1] for s in statics)
    elif bad == "k_over_n":
        K = N + 1
    elif bad == "lw_over_kj":
        K, J = 1, 2
    elif bad == "k_over_cap":
        # the leader holds at most MAX_WAVE_L keys (checked as if the
        # node axis were wide enough)
        monkeypatch.setattr(Kr, "MAX_WAVE_L", 2)
    else:
        anti = gd.ipa_raa_active.shape[1]
    with pytest.raises(ValueError, match="run_wave"):
        Kr.run_wave_cuda(P.ScoreConfig(), na, carry, valid, table, u, gd,
                         statics, K, J, Lw, fam, False, anti, True)


@pytest.mark.parametrize("source", ["run_wave.cu", "cluster_probe.cu",
                                    "wave_statics.cu", "diagnose_row.cu"])
def test_one_launch_a_call(source):
    """The wave, the probe, the surfaces and the diagnosis are one launch
    a call: their C entry makes one cudaLaunchKernelEx (a thread-block
    cluster) and no <<< >>> launch."""
    text = (Kr.CSRC / source).read_text()
    assert text.count("cudaLaunchKernelEx(") == 1
    assert "<<<" not in text


# ---------------------------------------------------------------------------
# the argument memo (ops/kernels.py _Memo), wave_statics (csrc/wave_statics.cu:
# one launch a call over a shard table) and diagnose_row (csrc/diagnose_row.cu:
# one launch for a drain's rows, one packed output)


def test_argument_memo_repacks_when_a_tensor_moves():
    """The node block of a tree is packed once and taken again for the
    same tree; a fresh tuple of the same tensors is another tree, and a
    tensor of the tree whose data_ptr moves (set_ to another storage)
    makes the same tree pack again, pointing at the new storage."""
    cpu = torch.device("cpu")
    na, _batch, table = _cpu_state(6)
    memo = Kr._node_c
    a = memo(na, cpu)
    assert memo(na, cpu) is a
    b = memo(type(na)(*na), cpu)
    assert b is not a and memo(na, cpu) is a
    old = na.cap.data_ptr()
    na.cap.set_(na.cap.clone())
    c = memo(na, cpu)
    assert c is not a and c.cap == na.cap.data_ptr() != old
    assert memo(na, cpu) is c
    t = Kr._table_c(table, na.cap.shape[1], cpu)
    assert Kr._table_c(table, na.cap.shape[1], cpu) is t


def test_argument_memo_holds_what_it_points_into():
    """An entry holds its tree, so every tensor its struct points into
    lives as long as the entry; the memo keeps at most `size` entries,
    and a dropped entry lets its tensors go."""
    import gc
    import weakref
    cpu = torch.device("cpu")
    na, _batch, _table = _cpu_state(6)
    memo = Kr._Memo(Kr._pack_node, 2)
    fresh = type(na)(*(t.clone() for t in na))
    ref = weakref.ref(fresh.cap)
    ptr = memo(fresh, cpu).cap
    assert ptr == fresh.cap.data_ptr()
    del fresh
    gc.collect()
    assert ref() is not None and ref().data_ptr() == ptr
    for _ in range(3):
        memo(type(na)(*(t.clone() for t in na)), cpu)
    assert len(memo.entries) == 2
    gc.collect()
    assert ref() is None


def test_argument_memo_keeps_the_checks():
    """A tree the checks refuse raises with the checks' own message, on
    its first call and on every later one (nothing refused is kept)."""
    cpu = torch.device("cpu")
    na, _batch, _table = _cpu_state(6)
    bad = na._replace(cap=na.cap.to(torch.int32))
    for _ in range(2):
        with pytest.raises(TypeError, match="na.cap: dtype"):
            Kr._node_c(bad, cpu)


def _fake_launches(monkeypatch):
    """Kernel entries that record the struct each launch was handed (a
    copy of it) and return 0; the stream and device contexts of the CPU."""
    import contextlib
    import ctypes
    seen = []

    def entry(cls):
        return lambda addr, _stream: seen.append(
            cls.from_buffer_copy((ctypes.c_char * ctypes.sizeof(cls))
                                 .from_address(addr))) or 0
    libs = {"wave_statics": SimpleNamespace(
                ktpu_wave_statics=entry(Kr.StaticsArgsC)),
            "diagnose_row": SimpleNamespace(
                ktpu_diagnose_row=entry(Kr.DiagArgsC))}
    monkeypatch.setattr(Kr, "build", lambda: libs)
    monkeypatch.setattr(Kr, "_stream", lambda device: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    return seen


def test_wave_statics_fills_its_shard_table(monkeypatch):
    """One device: one launch over a table of one shard, every output a
    view of one allocation at the pointer the launch got; the rows, their
    count and the family flags by value."""
    seen = _fake_launches(monkeypatch)
    na, batch, table = _cpu_state(20)
    u = int(batch.tidx[0])
    before = Kr.LAUNCHES["wave_statics"]
    outs = Kr.wave_statics_cuda(na, table, [u, u, u], (True, False, True))
    assert Kr.LAUNCHES["wave_statics"] == before + 1 and len(seen) == 1
    a = seen[0]
    assert (a.D, a.N, a.S) == (1, 32, 3) and list(a.wt[:3]) == [u] * 3
    assert (a.has_taints, a.has_sel, a.has_img) == (1, 0, 1)
    assert not a.cnt_in and not a.cnt_out
    assert a.s[0].na.cap == na.cap.data_ptr()
    assert [getattr(a.s[0], f) for f in ("mask", "taint_raw", "na_raw",
                                         "s_img")] == [
        t.data_ptr() for t in outs]
    assert [t.dtype for t in outs] == [torch.bool] + [torch.int64] * 3
    assert all(tuple(t.shape) == (3, 32) and t.is_contiguous()
               for t in outs)
    assert len({t.untyped_storage().data_ptr() for t in outs}) == 1


@pytest.mark.parametrize("place", ["one", "cards"])
@pytest.mark.parametrize("images", [False, True])
def test_wave_statics_sharded_launches_by_placement(monkeypatch, place,
                                                    images):
    """On one card ONE launch over the table of D shards, each shard's rows
    read where they lie and its outputs its own; on several cards, with
    images, each card's counts (cnt_out), then each card's surfaces from
    the psum'd counts (cnt_in); without images one launch a card. One
    LAUNCHES a call, every launch in RAW_LAUNCHES."""
    seen = _fake_launches(monkeypatch)
    _cards(monkeypatch, place)
    D = 4
    na, batch, table = _cpu_state(20)
    mesh = S.make_mesh(devices=["cpu"] * D)
    gna = S.shard_node_arrays(mesh, na)
    u = int(batch.tidx[0])
    Kr.reset_launches()
    outs = Kr.wave_statics_sharded_cuda(mesh, gna, table, [u],
                                        (False, False, images))
    assert Kr.LAUNCHES["wave_statics_sharded"] == 1
    n = 32 // D
    if place == "one":
        assert len(seen) == 1 == Kr.RAW_LAUNCHES["wave_statics_sharded"]
        a = seen[0]
        assert (a.D, a.N, a.S) == (D, 32, 1)
        for d in range(D):
            assert a.s[d].na.N == n
            assert a.s[d].na.valid == gna[d].valid.data_ptr()
            assert a.s[d].s_img == outs[d][3].data_ptr()
        return
    launches = D * (2 if images else 1)
    assert len(seen) == launches == Kr.RAW_LAUNCHES["wave_statics_sharded"]
    assert all(a.D == 1 and a.N == n for a in seen)
    if images:
        assert all(a.cnt_out and not a.cnt_in for a in seen[:D])
        assert all(a.cnt_in and not a.cnt_out for a in seen[D:])
    assert [a.s[0].mask for a in seen[-D:]] == [
        o[0].data_ptr() for o in outs]


def test_statics_route_by_placement():
    """One launch over the shard table when every shard lies on one card
    and the table holds them (up to WS_MAX_SHARDS); otherwise the launches
    a card."""
    for devices, one in ((["cpu"], True), (["cpu"] * 4, True),
                         (["cpu"] * 8, False),
                         (["cuda:0", "cuda:1"], False)):
        assert Kr.statics_in_place(S.Mesh(devices)) is one


def test_statics_outputs_are_one_allocation():
    """A shard's three int64 surfaces, then its mask, each shard's piece
    8-byte aligned, then the chain's image counts: every output a view of
    one allocation at the pointer the launch gets, none overlapping."""
    layout, end = Kr.statics_layout(3, [5, 8])
    assert layout == [(0, 360), (376, 952)] and end == 976
    na, _batch, table = _cpu_state(20)
    cpu = torch.device("cpu")
    node, tab = Kr._node_c(na, cpu), Kr._table_c(table, 16, cpu)
    args, outs, cnt = Kr._statics_args([node, node], tab, [0, 0, 0],
                                       (True,) * 3, cpu, counts=6)
    views = [t for o in outs for t in o] + [cnt]
    assert len({t.untyped_storage().data_ptr() for t in views}) == 1
    spans = sorted((t.data_ptr(), t.data_ptr() + t.numel() * t.itemsize)
                   for t in views)
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert all(t.data_ptr() % 8 == 0 for t in views)
    for d in range(2):
        assert [getattr(args.s[d], f) for f in ("mask", "taint_raw",
                                                "na_raw", "s_img")] == [
            t.data_ptr() for t in outs[d]]
        assert [tuple(t.shape) for t in outs[d]] == [(3, 32)] * 4
    assert cnt.dtype == torch.int64 and cnt.numel() == 6


@pytest.mark.parametrize("bad", ["empty", "row_outside", "too_many",
                                 "table_width", "dtype"])
@pytest.mark.parametrize("mesh", [None, "one", "cards"])
def test_wave_statics_cuda_checks_before_building(monkeypatch, bad, mesh):
    _no_build(monkeypatch)
    na, batch, table = _cpu_state(20)
    u = int(batch.tidx[0])
    wt = [u]
    if bad == "empty":
        wt = []
    elif bad == "row_outside":
        wt = [u, table.req.shape[0]]
    elif bad == "too_many":
        wt = [u] * (Kr.MAX_WAVE_ROWS + 1)
    elif bad == "table_width":
        table = table._replace(req=table.req[:, :-1].contiguous())
    else:
        na = na._replace(image_size=na.image_size.to(torch.int32))
    with pytest.raises((ValueError, TypeError)):
        if mesh is None:
            Kr.wave_statics_cuda(na, table, wt)
        else:
            _cards(monkeypatch, mesh)
            m = S.make_mesh(devices=["cpu"] * 2)
            Kr.wave_statics_sharded_cuda(m, S.shard_node_arrays(m, na),
                                         table, wt)


def _diag_cpu(groups):
    na, carry, _xs, table, gd, fam = _batch_cpu(groups)
    return na, table, gd, carry.groups if groups else None, fam


@pytest.mark.parametrize("groups", [False, True])
def test_diagnose_rows_packs_the_context_once(monkeypatch, groups):
    """A context's block is packed once (it holds every tensor it points
    into) and serves any number of launches: each launch gets the rows and
    their count by value and one output of S·N·(5 + R) bytes."""
    seen = _fake_launches(monkeypatch)
    na, table, gd, gc, fam = _diag_cpu(groups)
    args = Kr.DiagArgs(na, table, gd, gc, fam)
    assert args.c.na.cap == na.cap.data_ptr()
    assert args.c.used == na.used.data_ptr()
    assert args.c.has_groups == int(groups)
    assert args.ctx == (na, table, gd, gc)
    U = min(table.req.shape[0], gd.spr_f_active.shape[0] if groups else 64)
    before = Kr.LAUNCHES["diagnose_row"]
    N, R = na.cap.shape
    for rows in ([0], list(range(U)) * 2):
        out = Kr.diagnose_rows_cuda(args, (na, table, gd, gc), rows)
        a = seen[-1]
        assert a.S == len(rows) and list(a.rows[:a.S]) == rows
        assert a.out == out.data_ptr()
        assert out.dtype == torch.uint8
        assert out.numel() == len(rows) * N * (5 + R)
    assert Kr.LAUNCHES["diagnose_row"] == before + 2 and len(seen) == 2


@pytest.mark.parametrize("bad", ["no_block", "stale", "no_rows", "too_many",
                                 "row_outside", "group_rows", "state"])
def test_diagnose_rows_cuda_checks_before_building(monkeypatch, bad):
    _no_build(monkeypatch)
    groups = bad == "group_rows"
    na, table, gd, gc, fam = _diag_cpu(groups)
    ctx = (na, table, gd, gc)
    rows = [0]
    if bad == "state":
        with pytest.raises(ValueError, match="node state"):
            Kr.DiagArgs(na._replace(npods=na.npods[:-1]), table)
        return
    args = Kr.DiagArgs(na, table, gd, gc, fam)
    if bad == "no_block":
        args = None
    elif bad == "stale":
        ctx = (type(na)(*na), table, gd, gc)
    elif bad == "no_rows":
        rows = []
    elif bad == "too_many":
        rows = [0] * (Kr.MAX_DIAG_ROWS + 1)
    elif bad == "row_outside":
        rows = [table.req.shape[0]]
    else:
        args.group_U = 0
    with pytest.raises(ValueError, match="diagnose_row"):
        Kr.diagnose_rows_cuda(args, ctx, rows)
