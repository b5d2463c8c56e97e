"""Node-axis sharding: the scheduler's node axis split over a mesh.

Counterpart of kubernetes_tpu/parallel/sharding.py for the lean tiers:
`run_batch_sharded` (lean mode, with `profile_shard_lanes` and its lane
probe), `run_uniform_sharded`, `scatter_rows_sharded` and
`cluster_probe_sharded`. Every filter and score of the lean step is
row-independent over nodes, so each shard evaluates its own rows; only
the cluster-wide quantities cross shards: ImageLocality's image counts
(a sum), the DefaultNormalize maxima (a max), the winner of a scan step
(the JAX package's pmax of the best score, then pmin of the global index
among the shards holding it: the single-device first-max tie-break), and
the closed form's candidate merge (an all-gather).

One controller, as in the JAX package: one process and one Scheduler
drive a `Mesh`, a list of torch devices with shard d on `devices[d]`
holding node rows [d·n, (d+1)·n). On one GPU every shard lives on
cuda:0; in the CPU tests every shard lives on the cpu, in one process.
The exchange functions (`all_gather`, `psum`, `pmax`, `pmin`, the
counterparts of `lax.all_gather` / `psum` / `pmax` / `pmin`) gather the
shards' small tensors onto every shard's device and reduce them there:
device-side copies (none when shards share a device) and reductions,
never a read back to the host.

Sharded state is a `Shards` tuple of per-shard NamedTuples (NodeArrays,
Carry): every node-axis leaf is cut into D contiguous slices; the
signature cache's `sig` is replicated, one copy per shard. `unshard`
puts a tree back together on the first shard's device.

Each program picks by the devices of its shards: CPU shards take the
plain PyTorch version (`_*_sharded_plain`, a line-for-line translation of
the JAX package's SPMD body over the shard list), CUDA shards the
hand-written kernels (ops/kernels.py `*_sharded_cuda`: csrc/
run_batch_sharded.cu, csrc/run_uniform_sharded.cu, and the scatter_rows
and cluster_probe kernels per shard), anything else raises. There is no
fallback between the two, nor to the single-device programs.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from ..ops.program import (NodeArrays, _apply_assignment, _gather_row,
                           _probe_plain, _row_refresh, _scatter_rows_plain,
                           _slow_parts, _uniform_matrix, default_normalize,
                           feasible_max, image_counts, initial_carry,
                           run_batch, with_cache_sig)
from ..state import convert

NODE_AXIS = "nodes"

_I64, _I32 = torch.int64, torch.int32
_INT_MAX = 2 ** 31 - 1


def norm_device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", 0)
    return d


class Mesh:
    """A 1-D mesh over the node axis: shard d on `devices[d]`. Devices
    may repeat (several shards on one card)."""

    def __init__(self, devices):
        self.devices = tuple(norm_device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        # each distinct device once, in shard order: a replicated value
        # is computed once per device
        self.distinct = tuple(dict.fromkeys(self.devices))

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]})"


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D mesh over the node axis (NODE_AXIS), over `devices` when
    given. Without them: `n_devices` shards (default: one per visible
    GPU), each on its own GPU when that many are visible, else all on
    cuda:0. With no CUDA device, pass `devices` (e.g. ["cpu"] * n, the
    plain PyTorch versions)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh places its shards on CUDA devices by default "
                "and none is available; pass devices=[\"cpu\"] * n to "
                "shard over the CPU (the plain PyTorch versions)")
        visible = torch.cuda.device_count()
        n = n_devices or visible
        devices = ([f"cuda:{d}" for d in range(n)] if visible >= n
                   else ["cuda:0"] * n)
    return Mesh(devices)


class Shards(tuple):
    """One NamedTuple per shard (NodeArrays or Carry), in node order."""

    @property
    def rows(self) -> int:
        """The global node count."""
        return sum(int(s.used.shape[0]) for s in self)


# ---------------------------------------------------------------------------
# placement


def _n_local(mesh: Mesh, n: int) -> int:
    if n % mesh.size:
        raise ValueError(f"{n} node rows do not split into {mesh.size} "
                         "shards: the node bucket is a power of two at "
                         "least the mesh size")
    return n // mesh.size


def _slice_tree(tree, sl):
    """Rows `sl` of every node-axis leaf; scalars (cache.sig) and None
    stay as they are."""
    if tree is None:
        return None
    if hasattr(tree, "_fields"):
        return type(tree)(*(_slice_tree(x, sl) for x in tree))
    return tree if np.ndim(tree) == 0 else tree[sl]


def _to(tree, device, copy: bool = False):
    """`tree` on `device` (torch leaves; the same tensors when they are
    there already, unless `copy`)."""
    if tree is None:
        return None
    if hasattr(tree, "_fields"):
        return type(tree)(*(_to(x, device, copy) for x in tree))
    if not isinstance(tree, torch.Tensor):
        return tree
    # torchsan: waive[pageable-h2d] a copy between the shards' devices (or none), never from the host
    return tree.to(device, non_blocking=True, copy=copy)


def _shard(mesh: Mesh, tree, from_numpy):
    n_local = _n_local(mesh, int(tree.used.shape[0]))
    out = []
    for d, dev in enumerate(mesh.devices):
        part = _slice_tree(tree, slice(d * n_local, (d + 1) * n_local))
        if isinstance(tree.used, torch.Tensor):
            out.append(_to(part, dev, copy=True))
        else:
            out.append(from_numpy(part, dev))
    return Shards(out)


def shard_node_arrays(mesh: Mesh, na) -> Shards:
    """NodeArrays (numpy staging arrays, or torch tensors on any device)
    placed onto the mesh, node axis split."""
    return _shard(mesh, na, convert.node_arrays_from_numpy)


def shard_carry(mesh: Mesh, carry) -> Shards:
    """A lean Carry (numpy or torch) placed onto the mesh: every node-axis
    leaf split, `cache.sig` replicated (the JAX package's _carry_spec)."""
    if getattr(carry, "groups", None) is not None:
        raise NotImplementedError(
            "group counts on the mesh (the JAX package's shard_group_carry "
            "and run_batch_sharded's group mode) are not ported to "
            "kubernetes_tpu_torch yet")
    return _shard(mesh, carry, convert.carry_from_numpy)


def initial_carry_sharded(na: Shards) -> Shards:
    """ops/program.py initial_carry on every shard (lean: no group
    counts)."""
    return Shards(initial_carry(s) for s in na)


def with_cache_sig_sharded(carry: Shards, sig: int) -> Shards:
    return Shards(with_cache_sig(c, sig) for c in carry)


def replicate(mesh: Mesh, tree) -> list:
    """A replicated input on every shard's device (the same object where
    a shard shares the tree's device)."""
    per = {dev: _to(tree, dev) for dev in mesh.distinct}
    return [per[d] for d in mesh.devices]


def unshard(shards):
    """The whole tree on the first shard's device: node-axis leaves
    concatenated in shard order, replicated scalars from shard 0."""
    dev = shards[0].used.device

    def cat(xs):
        x0 = xs[0]
        if x0 is None:
            return None
        if hasattr(x0, "_fields"):
            return type(x0)(*(cat([x[k] for x in xs])
                              for k in range(len(x0))))
        if x0.dim() == 0:
            return x0
        return torch.cat([_to(x, dev) for x in xs])

    return cat(list(shards))


def mesh_kind(mesh: Mesh, *shards) -> str:
    """"cpu" or "cuda" for shards that lie on the mesh's devices; raises
    for a mesh mixing device types or an unsupported device."""
    for tree in shards:
        if len(tree) != mesh.size:
            raise ValueError(f"{len(tree)} shards for a mesh of "
                             f"{mesh.size}")
        for s, dev in zip(tree, mesh.devices):
            if s.used.device != dev:
                raise ValueError(f"a shard on {s.used.device}, its mesh "
                                 f"device is {dev}")
    kinds = {d.type for d in mesh.devices}
    if kinds == {"cpu"}:
        return "cpu"
    if kinds == {"cuda"}:
        return "cuda"
    raise RuntimeError(f"unsupported mesh devices {mesh}")


# ---------------------------------------------------------------------------
# the exchange (lax.all_gather / psum / pmax / pmin over the shard list)


def _reduced(mesh: Mesh, xs: list, op) -> list:
    per = {dev: op(torch.stack([_to(x, dev) for x in xs]))
           for dev in mesh.distinct}
    return [per[d] for d in mesh.devices]


def all_gather(mesh: Mesh, xs: list) -> list:
    """[D, ...]: every shard's `xs[d]`, on each shard's device."""
    return _reduced(mesh, xs, lambda t: t)


def psum(mesh: Mesh, xs: list) -> list:
    return _reduced(mesh, xs, lambda t: t.sum(0))


def pmax(mesh: Mesh, xs: list) -> list:
    return _reduced(mesh, xs, lambda t: t.amax(0))


def pmin(mesh: Mesh, xs: list) -> list:
    return _reduced(mesh, xs, lambda t: t.amin(0))


def lean_exchange(mesh: Mesh, locs: list) -> list:
    """The lean step's one exchange of per-shard parts, as the kernels
    write them: [image counts..., valid nodes | max taint_raw, max
    na_raw] i64, summed before the bar and maxed after it."""
    n = locs[0].shape[0] - 2
    return _reduced(mesh, locs, lambda t: torch.cat([t[:, :n].sum(0),
                                                     t[:, n:].amax(0)]))


def gather_rows(mesh: Mesh, xs: list, device) -> torch.Tensor:
    """lax.all_gather(tiled=True) onto one device: the shards' node-axis
    leaves concatenated in shard order."""
    return torch.cat([_to(x, device) for x in xs])


# ---------------------------------------------------------------------------
# the sharded lean step (the JAX package's _sharded_step, lean mode)


def _shard_parts(cfg, mesh: Mesh, na: Shards, cs: list, rows: list, sig: int):
    """Every shard's SigCache parts for one pod: the fast path when the
    replicated sig matches, else the slow path with the cluster-wide
    image counts (psum)."""
    if sig != 0 and sig == int(cs[0].cache.sig):
        return [c.cache for c in cs]
    cnt = [image_counts(s, r) for s, r in zip(na, rows)]
    g = psum(mesh, [torch.cat([nw, tot[None]]) for nw, tot in cnt])
    return [_slow_parts(cfg, na[d], cs[d], rows[d],
                        img_counts=(g[d][:-1], g[d][-1]))
            for d in range(mesh.size)]


def _lean_maxima(mesh: Mesh, parts: list) -> tuple:
    """(feasible masks, the cluster-wide normalization maxima per shard:
    i64 [2] = max taint_raw, max na_raw over the feasible set)."""
    feas = [p.static_mask & p.fit_ok for p in parts]
    gm = pmax(mesh, [torch.stack([feasible_max(p.taint_raw, f),
                                  feasible_max(p.na_raw, f)])
                     for p, f in zip(parts, feas)])
    return feas, gm


def _lean_static(cfg, parts, feasible, gm):
    """TaintToleration + NodeAffinity (normalized with the cluster-wide
    maxima) + ImageLocality of every row of one shard."""
    s_taint = default_normalize(parts.taint_raw, feasible, True, maxc=gm[0])
    s_na = default_normalize(parts.na_raw, feasible, False, maxc=gm[1])
    return (cfg.w_taint * s_taint + cfg.w_node_affinity * s_na
            + cfg.w_image * parts.s_img)


def _run_batch_sharded_plain(cfg, mesh: Mesh, na: Shards, carry: Shards,
                             pods, table):
    """The sequential scan over node shards (plain version of the JAX
    package's _run_batch_sharded_jit in lean mode): per pod, the shards'
    parts, the exchange of the image counts and normalization maxima,
    each shard's first max, the pmax of the best score and the pmin of
    the global index among the shards holding it, and the placement on
    the owning shard."""
    D = mesh.size
    n_local = int(na[0].cap.shape[0])
    tables = replicate(mesh, table)
    cs = list(carry)
    out = []
    for v, s, t in zip(pods.valid.tolist(), pods.sig.tolist(),
                       pods.tidx.tolist()):
        rows = [_gather_row(tb, t, v, s) for tb in tables]
        parts = _shard_parts(cfg, mesh, na, cs, rows, s)
        feas, gm = _lean_maxima(mesh, parts)
        lbest, lscore = [], []
        for d in range(D):
            p = parts[d]
            total = (cfg.w_fit * p.s_fit + cfg.w_balanced * p.s_bal
                     + _lean_static(cfg, p, feas[d], gm[d]))
            masked = torch.where(feas[d], total, torch.full_like(total, -1))
            best = torch.argmax(masked)
            lbest.append(best)
            lscore.append(masked[best])
        gscore = pmax(mesh, lscore)
        gbest = pmin(mesh, [torch.where(lscore[d] == gscore[d],
                                        d * n_local + lbest[d],
                                        torch.full_like(lbest[d], _INT_MAX))
                            for d in range(D)])
        new = []
        for d in range(D):
            assigned = (gscore[d] >= 0) & bool(v)
            lidx = gbest[d] - d * n_local
            gate = assigned & (lidx >= 0) & (lidx < n_local)
            safe = lidx.clamp(0, n_local - 1)
            c2 = _apply_assignment(cs[d], rows[d], safe, gate)
            new.append(c2._replace(cache=_row_refresh(
                cfg, na[d], c2, rows[d], safe, gate, parts[d])))
        cs = new
        assigned0 = (gscore[0] >= 0) & bool(v)
        out.append(torch.where(assigned0, gbest[0],
                               torch.full_like(gbest[0], -1)))
    if not out:
        return Shards(cs), torch.zeros((0,), dtype=_I32,
                                       device=mesh.devices[0])
    return Shards(cs), torch.stack(out).to(_I32)


def _lean_only(carry: Shards, groups, pods) -> None:
    if groups is not None or any(c.groups is not None for c in carry):
        raise NotImplementedError(
            "run_batch_sharded's group mode (the JAX package's psum'd "
            "`pick` and group collectives) is not ported to "
            "kubernetes_tpu_torch yet")
    if getattr(pods, "nom_idx", None) is not None:
        raise ValueError("run_batch_sharded: the nominated-pod overlay is "
                         "single-device only")


def run_batch_sharded(cfg, mesh: Mesh, na: Shards, carry: Shards, pods,
                      table, groups=None, fam=None):
    """`ops/program.py run_batch` with the node axis sharded over `mesh`
    (lean mode). `pods` (PodXs) and `table` lie on the mesh's first
    device. Returns (the sharded carry, assignments i32 [B] on the first
    device), equal to the single-device program's. Never writes into
    `carry`."""
    _lean_only(carry, groups, pods)
    if mesh_kind(mesh, na, carry) == "cuda":
        from ..ops.kernels import run_batch_sharded_cuda
        return run_batch_sharded_cuda(cfg, mesh, na, carry, pods, table)
    return _run_batch_sharded_plain(cfg, mesh, na, carry, pods, table)


def _sync(mesh: Mesh) -> None:
    for dev in mesh.distinct:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def on_device(dev: torch.device):
    """`dev` current for a launch on its stream (a CUDA device; the CPU
    needs nothing)."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def profile_shard_lanes(cfg, mesh: Mesh, na: Shards, carry: Shards, pods,
                        table, groups=None, fam=None) -> dict:
    """Per-lane local-compute seconds, their imbalance and the share of
    the sharded scan's wall the slowest lane does not explain (exchange
    plus dispatch), for `run_batch_sharded` on these inputs. A
    measurement harness, not the hot path: it re-runs the (non-writing)
    sharded scan, then times each lane's slice through the lane probe:
    the scan with the exchange left out, which is the single-device
    run_batch on the lane's slice (the JAX package's _lane_probe_jit).
    The JAX package's comms / imbalance verdict over these figures is
    left to its consumer, Scheduler.profile_shard_lanes (not ported)."""
    n_dev = mesh.size
    _lean_only(carry, groups, pods)

    def run_full():
        run_batch_sharded(cfg, mesh, na, carry, pods, table)
        _sync(mesh)

    run_full()
    t0 = time.perf_counter()
    run_full()
    total = time.perf_counter() - t0
    prof = {"nDevices": n_dev, "totalSeconds": round(total, 6),
            "laneSeconds": [], "imbalanceRatio": 0.0, "commsShare": 0.0,
            "pods": int(pods.valid.shape[0]),
            "nodesPerLane": int(na[0].cap.shape[0])}
    lanes = []
    for d, dev in enumerate(mesh.devices):
        pods_d, table_d = _to(pods, dev), _to(table, dev)
        with on_device(dev):
            run_batch(cfg, na[d], carry[d], pods_d, table_d)  # warm
            _sync(mesh)
            t0 = time.perf_counter()
            run_batch(cfg, na[d], carry[d], pods_d, table_d)
            _sync(mesh)
        lanes.append(time.perf_counter() - t0)
    mean = sum(lanes) / len(lanes)
    peak = max(lanes)
    prof["laneSeconds"] = [round(s, 6) for s in lanes]
    prof["imbalanceRatio"] = round(peak / mean, 4) if mean > 0 else 0.0
    prof["commsShare"] = (round(max(0.0, 1.0 - peak / total), 4)
                          if total > 0 else 0.0)
    prof["laneShares"] = ([round(s / total, 4) for s in lanes]
                          if total > 0 else [0.0] * len(lanes))
    return prof


# ---------------------------------------------------------------------------
# the closed-form uniform run on the mesh (the JAX package's
# _uniform_local_core). Each shard takes its local top-K_loc candidates
# (every member of the global top-K ranks inside its shard's top-K_loc),
# keys its [K_loc, J] matrix with GLOBAL entry ids (node · J + j), takes
# its local top-L_loc, and the all-gathered keys merge into the top-L.
# Keys are globally unique, so the merge equals the single-device top-L
# whenever the exactness preconditions hold; the flags are checked over a
# superset of the single-device candidates and may only be more
# conservative (a False flag replays on the scan).


def uniform_shape(mesh: Mesh, n_local: int, L: int, K: int, J: int):
    """(K_loc, L_loc, M) of one sharded closed-form run."""
    K_loc = min(K, n_local)
    return K_loc, min(L, K_loc * J), n_local * mesh.size * J


def _run_uniform_sharded_plain(cfg, mesh: Mesh, na: Shards, carry: Shards,
                               x, table, n_actual: int, L: int, K: int,
                               J: int):
    D = mesh.size
    n_local = int(na[0].cap.shape[0])
    K_loc, L_loc, M = uniform_shape(mesh, n_local, L, K, J)
    sig, tidx = int(x.sig), int(x.tidx)
    rows = [_gather_row(tb, tidx, True, sig) for tb in replicate(mesh, table)]
    parts = _shard_parts(cfg, mesh, na, list(carry), rows, sig)
    feas, gm = _lean_maxima(mesh, parts)
    local, lvals, lnode, mono = [], [], [], []
    for d in range(D):
        p, c, pod = parts[d], carry[d], rows[d]
        dev = p.s_fit.device
        static_all = _lean_static(cfg, p, feas[d], gm[d])
        total0 = cfg.w_fit * p.s_fit + cfg.w_balanced * p.s_bal + static_all
        masked0 = torch.where(feas[d], total0, torch.full_like(total0, -1))
        ar = torch.arange(n_local, dtype=_I64, device=dev)
        # top-K_loc with ties to the lowest index: the index rides in
        # the key
        key0 = (masked0 + 1) * n_local + (n_local - 1 - ar)
        cand = n_local - 1 - torch.sort(key0, descending=True).values[
            :K_loc] % n_local
        fit_kj, s_fit_kj, s_bal_kj = _uniform_matrix(
            cfg, na[d], c.used, c.npods, c.used, c.nonzero_used, cand, pod,
            J)
        score_kj = (cfg.w_fit * s_fit_kj + cfg.w_balanced * s_bal_kj
                    + static_all[cand][:, None])
        masked_kj = torch.where(p.static_mask[cand][:, None] & fit_kj,
                                score_kj, torch.full_like(score_kj, -1))
        mono.append((masked_kj[:, 1:] <= masked_kj[:, :-1]).all())
        gcand = d * n_local + cand
        ent_id = (gcand[:, None] * J
                  + torch.arange(J, dtype=_I64, device=dev)[None, :])
        srt = torch.sort((masked_kj * M - ent_id).reshape(K_loc * J),
                         descending=True)
        lvals.append(srt.values[:L_loc])
        lnode.append(gcand[srt.indices[:L_loc] // J])
        local.append((cand, fit_kj, s_fit_kj, s_bal_kj))
    g_vals = [g.reshape(D * L_loc) for g in all_gather(mesh, lvals)]
    g_node = [g.reshape(D * L_loc) for g in all_gather(mesh, lnode)]
    norm_ok = [(g[0] == 0) & (g[1] == 0) for g in gm]
    out, depth, assign = [], [], []
    for d in range(D):
        vals, nodes = g_vals[d], g_node[d]
        dev = vals.device
        if vals.shape[0] < L:
            # a lattice thinner than L pads with strictly infeasible keys
            pad = L - vals.shape[0]
            vals = torch.cat([vals, torch.full((pad,), -M - 1, dtype=_I64,
                                               device=dev)])
            nodes = torch.cat([nodes, torch.full((pad,), -1, dtype=_I64,
                                                 device=dev)])
        srt = torch.sort(vals, descending=True)
        top_vals, node_of = srt.values[:L], nodes[srt.indices[:L]]
        sel_ok = (top_vals > -M) & (torch.arange(L, device=dev) < n_actual)
        assignments = torch.where(sel_ok, node_of,
                                  torch.full_like(node_of, -1))
        cand, fit_kj, s_fit_kj, s_bal_kj = local[d]
        c, p, pod = carry[d], parts[d], rows[d]
        lid = assignments - d * n_local
        in_shard = sel_ok & (lid >= 0) & (lid < n_local)
        counts_local = torch.zeros((n_local,), dtype=_I64,
                                   device=dev).index_add_(
            0, lid.clamp(0, n_local - 1), in_shard.to(_I64))
        counts = counts_local[cand]
        depth.append((counts < J).all())
        used = c.used.index_add(0, cand, counts[:, None] * pod.req[None, :])
        nonzero = c.nonzero_used.index_add(
            0, cand, counts[:, None] * pod.nonzero_req[None, :])
        npods = c.npods.index_add(0, cand, counts.to(c.npods.dtype))
        # the cache refresh at the local candidates: entry j = counts IS
        # the next pod's evaluation; untouched candidates rewrite their
        # count-0 entry, which equals the parts
        ar = torch.arange(K_loc, device=dev)
        cnt_i = counts.clamp(max=J - 1)

        def put(vec, mat):
            o = vec.clone()
            o[cand] = mat[ar, cnt_i]
            return o

        cache = p._replace(fit_ok=put(p.fit_ok, fit_kj),
                           s_fit=put(p.s_fit, s_fit_kj),
                           s_bal=put(p.s_bal, s_bal_kj))
        out.append(c._replace(used=used, nonzero_used=nonzero, npods=npods,
                              cache=cache))
        assign.append(assignments.to(_I32))
    exact = pmin(mesh, [(m & n).to(_I32) for m, n in zip(mono, norm_ok)])
    deep = pmin(mesh, [x.to(_I32) for x in depth])
    packed = torch.cat([assign[0], torch.stack([exact[0], deep[0]])])
    return Shards(out), packed


def run_uniform_sharded(cfg, mesh: Mesh, na: Shards, carry: Shards, x,
                        table, n_actual: int, L: int, K: int, J: int):
    """`ops/program.py run_uniform` on the mesh: one same-signature run
    of `n_actual` pods (row `x.tidx`, signature `x.sig != 0`). Returns
    (the sharded carry', packed i32 [L + 2] on the first device:
    assignments, then the exactness and depth flags, each the min over
    the shards). Never writes into `carry`: the scheduler keeps it to
    replay failed preconditions on the sharded scan."""
    if int(x.sig) == 0:
        raise ValueError("run_uniform_sharded needs a signature (sig != 0)")
    if not 0 <= int(n_actual) <= L:
        raise ValueError(f"run_uniform_sharded: n_actual {n_actual} "
                         f"outside [0, {L}]")
    _lean_only(carry, None, x)
    if mesh_kind(mesh, na, carry) == "cuda":
        from ..ops.kernels import run_uniform_sharded_cuda
        return run_uniform_sharded_cuda(cfg, mesh, na, carry, x, table,
                                        int(n_actual), L, K, J)
    return _run_uniform_sharded_plain(cfg, mesh, na, carry, x, table,
                                      int(n_actual), L, K, J)


# ---------------------------------------------------------------------------
# the dirty-row upload onto the resident shards


def stage_rows(mesh: Mesh, dev: Shards, idx, rows) -> list:
    """Per shard: None when no row of `idx` is its own, else (local row
    ids i64, the shard's rows on its device). The rows are partitioned on
    the host: out-of-shard rows drop, never clip (the JAX package's
    _scatter_rows_sharded_jit); pad duplicates carry equal values."""
    n_local = int(dev[0].used.shape[0])
    index = np.asarray(idx, dtype=np.int64)
    if index.ndim != 1:
        raise ValueError("scatter_rows_sharded: idx must be 1-D")
    if index.size and (index.min() < 0 or index.max() >= n_local * mesh.size):
        raise ValueError("scatter_rows_sharded: row index outside the node "
                         "axis")
    host = [np.asarray(r.cpu() if isinstance(r, torch.Tensor) else r)
            for r in rows]
    out = []
    for d, device in enumerate(mesh.devices):
        lid = index - d * n_local
        sel = np.nonzero((lid >= 0) & (lid < n_local))[0]
        if not sel.size:
            out.append(None)
            continue
        part = NodeArrays(*(r[sel] for r in host))
        out.append((lid[sel], convert.node_rows_from_numpy(part, device)))
    return out


def _scatter_rows_sharded_plain(dev: Shards, staged: list) -> Shards:
    return Shards(s if p is None else _scatter_rows_plain(s, p[0], p[1])
                  for s, p in zip(dev, staged))


def scatter_rows_sharded(mesh: Mesh, dev: Shards, idx, rows) -> Shards:
    """Scatter `rows` (host arrays, [B, ...] per leaf) into the resident
    node shards at global row ids `idx` (host ints [B]): each shard
    receives and scatters only its own rows (the H2D bytes are the rows,
    not the matrices), and a shard with none keeps its arrays.
    Non-writing, like ops/program.py scatter_rows."""
    kind = mesh_kind(mesh, dev)
    staged = stage_rows(mesh, dev, idx, rows)
    if kind == "cuda":
        from ..ops.kernels import scatter_rows_sharded_cuda
        return scatter_rows_sharded_cuda(mesh, dev, staged)
    return _scatter_rows_sharded_plain(dev, staged)


# ---------------------------------------------------------------------------
# the cluster probe on the mesh


def cluster_probe_sharded(mesh: Mesh, na: Shards, carry: Shards, dom,
                          ndom: int):
    """`ops/program.py cluster_probe`'s mesh twin: the node shards'
    cap / valid / used / npods gathered onto the first shard's device and
    the single-device probe run there only (the JAX package's lane-0
    `lax.cond`), so every output is bit-equal to the single-device
    probe's. `dom` (i32 [N]) is replicated; the result lies on the first
    device, the controller's, which reads it."""
    kind = mesh_kind(mesh, na, carry)
    dev0 = mesh.devices[0]
    cols = [gather_rows(mesh, [getattr(t, f) for t in tree], dev0)
            for tree, f in ((na, "cap"), (na, "valid"), (carry, "used"),
                            (carry, "npods"))]
    dom0 = _to(dom, dev0)
    if kind == "cuda":
        from ..ops.kernels import cluster_probe_sharded_cuda
        return cluster_probe_sharded_cuda(*cols, dom0, ndom)
    return _probe_plain(*cols, dom0, ndom)
