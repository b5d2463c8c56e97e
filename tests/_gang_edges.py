"""run_gang_sharded's edge inputs (GANG_EDGE_CASES): the node-axis
partitions of the port's one-card design (csrc/run_gang_sharded.cu
ktpu_gang_span_grid: D shards of T blocks, a contiguous range of up to 512
rows a block; csrc/run_gang.cu, the same body at D = 1: a cluster of 16
CTAs of ⌈N / 16⌉ rows) and the gang scan's own corners.

Shared by tests/test_torch_gang_edges.py (the port's plain version against
the JAX package on the CPU) and tests/test_torch_cuda.py (the kernel
against the plain version on the card). This module imports neither
package: `stage` builds a case through the state layer it is handed (the
JAX package's or the port's, which make the same arrays) and edits the
numpy arrays the same way for both.

Every node has 4 cpu; `band` rows hold 16, so the members land there, and
the band crosses the shard boundary (1,024 at D = 2 and 4); the topology
domains are contiguous ranges of `width` rows that cross shard and block
boundaries. The cases:

- straddle: 96 members in the band (1,000..1,048), domains of 100 rows;
- straddle_rejected: the same gang one member short, so every shard's
  carry returns as it came and the signature is kept;
- ragged: n_local not a multiple of 512 (1,536 rows: 768 a shard at
  D = 2, 384 at D = 4), the band across 768, domains of 64 rows;
- ties: only rows beside the block and shard boundaries fit, alike, so
  every tie goes to the lowest global row.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np

GANG_EDGE_CASES = {
    "straddle": dict(nodes=2048, members=96, bucket=128, band=(1000, 1048),
                     width=100, w_contig=2, accept=True),
    "straddle_rejected": dict(nodes=2048, members=96, bucket=128,
                              band=(1000, 1048), width=100, w_contig=2,
                              accept=False),
    "ragged": dict(nodes=2048, rows=1536, members=60, bucket=64,
                   band=(740, 800), width=64, w_contig=2, accept=True),
    "ties": dict(nodes=2048, members=24, bucket=32,
                 pick=(511, 512, 1023, 1024, 1535, 1536), width=512,
                 w_contig=0, accept=True),
}
TIE_ROWS = [511, 512, 1023, 1024, 1535, 1536]


def stage(case: str, pkg) -> SimpleNamespace:
    """One case's numpy inputs through `pkg`'s state layer (`pkg` holds
    the package's Cache, Snapshot, ClusterState, BatchBuilder and its
    testing wrappers as W). Returns arrays (NodeArrays), table, the
    scheduler's gang layout (valid / tidx / widx [bucket], wt, the
    signature rows), dom [N], needed, w_contig and m, the members."""
    spec = GANG_EDGE_CASES[case]
    W = pkg.W
    cache = pkg.Cache()
    for i in range(spec["nodes"]):
        w = W.make_node(f"n{i}").capacity({"cpu": 4, "memory": "16Gi",
                                           "pods": 110})
        if i in spec.get("pick", ()):
            w = w.label("pick", "yes")
        cache.add_node(w.obj())
    snap = pkg.Snapshot()
    cache.update_snapshot(snap)
    state = pkg.ClusterState()
    state.apply_snapshot(snap, full=True)
    m = spec["members"]
    proto = W.make_pod("g").req({"cpu": "1", "memory": "1Gi"})
    if spec.get("pick"):
        proto = proto.node_selector({"pick": "yes"})
    batch = pkg.BatchBuilder(state).build([proto.obj()] * m)
    a = state.ensure_arrays()
    assert a.cap.shape[0] == spec["nodes"]
    if spec.get("rows"):
        a = type(a)(*(x[:spec["rows"]] for x in a))
    band = spec.get("band")
    if band:
        cap = a.cap.copy()
        cap[band[0]:band[1]] *= 4
        a = a._replace(cap=cap)
    # the scheduler's gang layout (Scheduler._gang_dispatch)
    bucket = spec["bucket"]
    tid = batch.tidx[:m]
    uniq = list(dict.fromkeys(int(t) for t in tid))
    S = 1
    while S < len(uniq):
        S *= 2
    wt = (uniq + [uniq[-1]] * S)[:S]
    slot = {}
    for s, u in enumerate(wt):
        slot.setdefault(u, s)
    widx = np.empty((bucket,), np.int32)
    widx[:m] = [slot[int(t)] for t in tid]
    widx[m:] = widx[m - 1]
    tidx = np.full((bucket,), tid[m - 1], np.int32)
    tidx[:m] = tid
    valid = np.zeros((bucket,), bool)
    valid[:m] = True
    N = a.cap.shape[0]
    return SimpleNamespace(
        arrays=a, table=batch.table, valid=valid, tidx=tidx, widx=widx,
        wt=wt, dom=(np.arange(N) // spec["width"]).astype(np.int32),
        needed=m if spec["accept"] else m + 1, w_contig=spec["w_contig"],
        m=m, accept=spec["accept"])


def check_placements(case: str, packed) -> None:
    """The case's own claims on the packed [B + 4] output (a list): the
    verdict, the members on both sides of the shard boundary, the ties
    in order of their global rows."""
    spec = GANG_EDGE_CASES[case]
    B = spec["bucket"]
    placed = [x for x in packed[:spec["members"]] if x >= 0]
    assert packed[B] == int(spec["accept"])
    if case.startswith("straddle"):
        assert min(placed) < 1024 <= max(placed)
    if case == "ties":
        assert placed[:len(TIE_ROWS)] == TIE_ROWS
