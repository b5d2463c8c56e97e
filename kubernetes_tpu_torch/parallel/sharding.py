"""Node-axis sharding: the scheduler's node axis split over a mesh.

Counterpart of kubernetes_tpu/parallel/sharding.py: `run_batch_sharded`
(lean and group mode, with `profile_shard_lanes` and its lane probe),
`run_uniform_sharded`, `run_plan_sharded`, `run_gang_sharded` (the
closed form and the scan tier), `scatter_rows_sharded`,
`cluster_probe_sharded`, the per-shard surfaces `wave_statics_sharded`
and the group placement `shard_groups` / `shard_group_carry`. Every
filter and score is row-independent over nodes, so each shard evaluates
its own rows; only the cluster-wide quantities cross shards:
ImageLocality's image counts (a sum), the DefaultNormalize maxima (a
max), the winner of a step (the JAX package's pmax of the best score,
then pmin of the global index among the shards holding it: the
single-device first-max tie-break), the closed form's candidate merge
(an all-gather), and for the group kernels the DoNotSchedule minimum (a
min), the ScheduleAnyway count of scored nodes and its [SC, n_global]
domain flags (sums), the spread and inter-pod score ranges (a min and a
max), the chosen node's topology values (`own`: a sum of the owner's
values and everyone else's zeros) and the epilogue fold's domain
segments (sums). The `*_dom` ids are GLOBAL dense ids (the global index
of the first node holding a value); the cut never renumbers them.

One controller, as in the JAX package: one process and one Scheduler
drive a `Mesh`, a list of torch devices with shard d on `devices[d]`
holding node rows [d·n, (d+1)·n). On one GPU every shard lives on
cuda:0; in the CPU tests every shard lives on the cpu, in one process.
The exchange functions (`all_gather`, `psum`, `pmax`, `pmin`, `own`,
`exchange`, the counterparts of `lax.all_gather` / `psum` / `pmax` /
`pmin`) gather the shards' small tensors onto every shard's device and
reduce them there: device-side copies (none when shards share a device)
and reductions, never a read back to the host.

Sharded state is a `Shards` tuple of per-shard NamedTuples (NodeArrays,
Carry, GroupsDev): every node-axis leaf is cut into D contiguous slices
(the group tensors along their last axis); the signature cache's `sig`,
the per-row group scalars and the pairwise match matrices are
replicated, one copy per shard. `unshard` puts a tree back together on
the first shard's device.

Each program picks by the devices of its shards: CPU shards take the
plain PyTorch version (`_*_sharded_plain`, a line-for-line translation of
the JAX package's SPMD body over the shard list, each collective an
exchange over the shards), CUDA shards the hand-written kernels
(ops/kernels.py `*_sharded_cuda`: csrc/run_batch_sharded.cu,
run_uniform_sharded.cu, run_plan_sharded.cu, run_gang_sharded.cu, and the
scatter_rows, cluster_probe and wave_statics kernels per shard), anything
else raises. There is no fallback between the two, nor to the
single-device programs.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from ..ops.groups import (ALL_FAMILIES, GroupCarry, GroupsDev, GroupView,
                          ScoreGlobals, group_mask_view, group_scores_view,
                          group_update, ipa_range, spread_flags,
                          spread_min_local, spread_range, spread_raw,
                          to_device, view_of, wave_fold)
from ..ops.program import (MAX_SCORE, Carry, NodeArrays, PodRow, _WaveState,
                           _apply_assignment, _fit_scores, _gather_row,
                           _probe_plain, _row_refresh, _scatter_rows_plain,
                           _slow_parts, _uniform_matrix, _wave_statics_plain,
                           balanced_allocation, default_normalize,
                           feasible_max, fit_mask, image_counts,
                           initial_carry, least_allocated, ports_mask,
                           run_batch, with_cache_sig)
from ..state import convert

NODE_AXIS = "nodes"

_I64, _I32 = torch.int64, torch.int32
_INT_MAX = 2 ** 31 - 1

# group tensors: the node axis is the LAST dim of these fields; the
# per-row scalars and the pairwise match matrices are replicated
# (kubernetes_tpu/parallel/sharding.py:74-80)
_GD_NODE_FIELDS = ("spr_f_tv", "spr_f_elig", "spr_f_dom", "spr_s_tv",
                   "spr_s_elig", "spr_s_keys_ok", "spr_s_dom", "ipa_ra_tv",
                   "ipa_ra_dom", "ipa_raa_tv", "ipa_raa_dom", "ipa_stc_tv",
                   "ipa_stc_dom", "ipa_stp_tv", "ipa_stp_dom")
_GC_NODE_FIELDS = ("spr_f_cnt", "spr_s_cnt", "ipa_veto", "ipa_a_cnt",
                   "ipa_aa_cnt", "ipa_score")


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
        items = [_to(x, device, copy) for x in tree]
        if all(a is b for a, b in zip(items, tree)):
            return tree
        return type(tree)(*items)
    if not isinstance(tree, torch.Tensor):
        return tree
    if not copy and tree.device == device:
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


def _group_kind(tree):
    """(port NamedTuple class, its node-last fields) of a GroupsDev or a
    GroupCarry from either package (told apart by field names)."""
    if "spr_f_cnt" in tree._fields:
        return GroupCarry, _GC_NODE_FIELDS
    return GroupsDev, _GD_NODE_FIELDS


def _split_groups(mesh: Mesh, tree) -> Shards:
    """A GroupsDev / GroupCarry (numpy or torch) on the mesh: the
    node-last fields cut into D slices of their last axis, the rest
    replicated. The `*_dom` ids stay GLOBAL: the cut never renumbers a
    domain (the first node holding a value may lie on another shard)."""
    cls, fields = _group_kind(tree)
    n_local = _n_local(mesh, int(getattr(tree, fields[0]).shape[-1]))
    out = []
    for d, dev in enumerate(mesh.devices):
        sl = slice(d * n_local, (d + 1) * n_local)
        leaves = cls(**{f: getattr(tree, f)[..., sl] if f in fields
                        else getattr(tree, f) for f in cls._fields})
        if isinstance(leaves[0], torch.Tensor):
            out.append(cls(*(_to(x, dev, copy=True).contiguous()
                             for x in leaves)))
        else:
            out.append(to_device(cls(*(np.asarray(x) for x in leaves)),
                                 dev))
    return Shards(out)


def shard_groups(mesh: Mesh, gd) -> Shards:
    """GroupsDev (numpy or torch) placed onto the mesh: node-indexed
    fields split along their last axis, the rest replicated (the JAX
    package's shard_groups)."""
    return _split_groups(mesh, gd)


def shard_group_carry(mesh: Mesh, gc) -> Shards:
    """GroupCarry (numpy or torch) placed onto the mesh, as shard_groups
    (the JAX package's shard_group_carry)."""
    return _split_groups(mesh, gc)


def shard_carry(mesh: Mesh, carry) -> Shards:
    """A Carry (numpy or torch) placed onto the mesh: every node-axis
    leaf split, `cache.sig` replicated, the group counts (when present)
    split along their last axis (the JAX package's _carry_spec)."""
    groups = getattr(carry, "groups", None)
    lean = _shard(mesh, carry._replace(groups=None), convert.carry_from_numpy)
    if groups is None:
        return lean
    return Shards(c._replace(groups=g)
                  for c, g in zip(lean, shard_group_carry(mesh, groups)))


def initial_carry_sharded(na: Shards, groups=None) -> Shards:
    """ops/program.py initial_carry on every shard, with the shards of the
    seeded group counts (shard_group_carry) when given."""
    if groups is None:
        return Shards(initial_carry(s) for s in na)
    return Shards(initial_carry(s, g) for s, g in zip(na, groups))


def with_cache_sig_sharded(carry: Shards, sig: int) -> Shards:
    return Shards(with_cache_sig(c, sig) for c in carry)


def replicate(mesh: Mesh, tree) -> list:
    """A replicated input on every shard's device (the same object where
    a shard shares the tree's device)."""
    per = {dev: _to(tree, dev) for dev in mesh.distinct}
    return [per[d] for d in mesh.devices]


def unshard(shards):
    """The whole tree on the first shard's device: node-axis leaves
    concatenated in shard order (the group tensors' node fields along
    their last axis), replicated leaves from shard 0."""
    dev = _first_device(shards[0])

    def cat(xs, axis=0):
        x0 = xs[0]
        if x0 is None:
            return None
        if isinstance(x0, (GroupCarry, GroupsDev)):
            fields = _group_kind(x0)[1]
            return type(x0)(*(cat([getattr(x, f) for x in xs], -1)
                              if f in fields else _to(getattr(x0, f), dev)
                              for f in x0._fields))
        if hasattr(x0, "_fields"):
            return type(x0)(*(cat([x[k] for x in xs])
                              for k in range(len(x0))))
        if x0.dim() == 0:
            return x0
        return torch.cat([_to(x, dev) for x in xs], dim=axis)

    return cat(list(shards))


def _first_device(tree):
    """The device a shard's tree lives on: its `used` (NodeArrays, Carry,
    or any object carrying one), else its first tensor leaf."""
    if hasattr(tree, "used"):
        return tree.used.device
    for x in tree:
        if isinstance(x, torch.Tensor):
            return x.device
        if hasattr(x, "_fields"):
            return _first_device(x)
    raise ValueError("no tensor in the tree")


def mesh_kind(mesh: Mesh, *shards) -> str:
    """"cpu" or "cuda" for shards that lie on the mesh's devices; raises
    for a mesh mixing device types or an unsupported device."""
    for tree in shards:
        if len(tree) != mesh.size:
            raise ValueError(f"{len(tree)} shards for a mesh of "
                             f"{mesh.size}")
        for s, dev in zip(tree, mesh.devices):
            at = _first_device(s)
            if at != dev:
                raise ValueError(f"a shard on {at}, its mesh device is "
                                 f"{dev}")
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
    """The sum over the shards, in the inputs' dtype (int32 stays int32,
    as XLA's psum)."""
    return _reduced(mesh, xs, lambda t: t.sum(0, dtype=t.dtype))


def pmax(mesh: Mesh, xs: list) -> list:
    return _reduced(mesh, xs, lambda t: t.amax(0))


def pmin(mesh: Mesh, xs: list) -> list:
    return _reduced(mesh, xs, lambda t: t.amin(0))


def lean_exchange(mesh: Mesh, locs: list) -> list:
    """The lean step's one exchange of per-shard parts, as the kernels
    write them: [image counts..., valid nodes | max taint_raw, max
    na_raw] i64, summed before the bar and maxed after it. A shard's
    parts may be [blocks, ·] rows, a grid kernel's per-block partials:
    the blocks reduce with the shards, in the same exchange."""
    n = locs[0].shape[-1] - 2

    def fold(t):
        t = t.reshape(-1, t.shape[-1])
        return torch.cat([t[:, :n].sum(0), t[:, n:].amax(0)])

    return _reduced(mesh, locs, fold)


def exchange(mesh: Mesh, locs: list, n_sum: int) -> list:
    """The kernels' one exchange of a step: every shard's int64 vector,
    summed before `n_sum` and maxed after it (a minimum rides negated)."""
    return _reduced(mesh, locs, lambda t: torch.cat([
        t[:, :n_sum].sum(0), t[:, n_sum:].amax(0)]))


def own(mesh: Mesh, vals: list, in_shard: list) -> list:
    """The chosen node's values, broadcast from the shard that holds it
    (the JAX package's own(), kubernetes_tpu/parallel/sharding.py:638-643
    and :919-923): each shard contributes its values where `in_shard`,
    zeros elsewhere, and the psum hands every shard the owner's. A bool
    rides as int32 and is compared back, never OR'd through a float."""
    is_bool = vals[0].dtype == torch.bool
    zs = []
    for v, o in zip(vals, in_shard):
        z = torch.where(o, v, torch.zeros_like(v))
        zs.append(z.to(_I32) if is_bool else z)
    out = psum(mesh, zs)
    return [x != 0 for x in out] if is_bool else out


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


def _lean_maxima(mesh: Mesh, parts: list, feas=None) -> tuple:
    """(feasible masks, the cluster-wide normalization maxima per shard:
    i64 [2] = max taint_raw, max na_raw over the feasible set). `feas`
    defaults to static_mask & fit_ok."""
    if feas is None:
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


# ---------------------------------------------------------------------------
# the group collectives (the JAX package's group_mask_view /
# group_scores_view under `axis`, kubernetes_tpu/ops/groups.py:287-444)


def group_feasible(mesh: Mesh, views: list, fam, base: list) -> list:
    """`base` & the group mask of every shard, with the pmin of the
    shards' spread minima."""
    gmin = [None] * mesh.size
    if fam.spr_f:
        gmin = pmin(mesh, [spread_min_local(v) for v in views])
    return [b & group_mask_view(v, fam, gmin=g)
            for v, b, g in zip(views, base, gmin)]


def score_globals(mesh: Mesh, views: list, feas: list, fam,
                  n_global: int) -> list:
    """Every shard's ScoreGlobals: the psum of the scored rows and of the
    [SC, n_global] domain flags, then the pmin / pmax of the raw spread
    scores (weighted with those sums), and the pmin / pmax of the
    symmetric score surface over the feasible rows."""
    D = mesh.size
    npart = flags = srng = irng = [None] * D
    if fam.ipa_score:
        r = [ipa_range(v.iscore, f) for v, f in zip(views, feas)]
        irng = list(zip(pmin(mesh, [x[0] for x in r]),
                        pmax(mesh, [x[1] for x in r])))
    if fam.spr_s:
        scored = [f & v.s_keys_ok for v, f in zip(views, feas)]
        npart = psum(mesh, [x.sum() for x in scored])
        flags = psum(mesh, [spread_flags(v, x, n_global)
                            for v, x in zip(views, scored)])
        r = [spread_range(spread_raw(v, npart[d], flags[d]), scored[d])
             for d, v in enumerate(views)]
        srng = list(zip(pmin(mesh, [x[0] for x in r]),
                        pmax(mesh, [x[1] for x in r])))
    return [ScoreGlobals(npart[d], flags[d], srng[d], irng[d])
            for d in range(D)]


def picker(mesh: Mesh, trees: list, lidx: list, in_shard: list):
    """pick(d) → group_update's `pick` for shard d: the chosen node's
    values of a field of `trees` (per-shard GroupsDev-like NamedTuples
    or dicts), broadcast from its owner by `own`; each field's exchange
    runs once, on first use."""
    memo = {}

    def field(t, name):
        return t[name] if isinstance(t, dict) else getattr(t, name)

    def for_shard(d):
        def pick(name):
            if name not in memo:
                memo[name] = own(mesh, [field(t, name)[..., li]
                                        for t, li in zip(trees, lidx)],
                                 in_shard)
            return memo[name][d]
        return pick

    return for_shard


def _argmax_global(mesh: Mesh, feas: list, totals: list):
    """(global first-max index, global best score) replicated per shard:
    the pmax of the shards' best scores, then the pmin of the global
    index among the shards holding it."""
    n_local = int(feas[0].shape[0])
    lbest, lscore = [], []
    for f, t in zip(feas, totals):
        masked = torch.where(f, t, torch.full_like(t, -1))
        b = torch.argmax(masked)
        lbest.append(b)
        lscore.append(masked[b])
    gscore = pmax(mesh, lscore)
    gbest = pmin(mesh, [torch.where(lscore[d] == gscore[d],
                                    d * n_local + lbest[d],
                                    torch.full_like(lbest[d], _INT_MAX))
                        for d in range(mesh.size)])
    return gbest, gscore


def _run_batch_sharded_plain(cfg, mesh: Mesh, na: Shards, carry: Shards,
                             pods, table, groups=None, fam=None):
    """The sequential scan over node shards (plain version of the JAX
    package's _run_batch_sharded_jit): per pod, the shards' parts, the
    exchange of the image counts, with `groups` the group mask with the
    global spread minimum, the normalization maxima, the group score
    globals, each shard's first max, the pmax of the best score and the
    pmin of the global index among the shards holding it, the placement
    on the owning shard and, with `groups`, the counts on every shard
    from the chosen node's topology values (`own`)."""
    D = mesh.size
    n_local = int(na[0].cap.shape[0])
    n_global = n_local * D
    tables = replicate(mesh, table)
    cs = list(carry)
    out = []
    for v, s, t in zip(pods.valid.tolist(), pods.sig.tolist(),
                       pods.tidx.tolist()):
        rows = [_gather_row(tb, t, v, s) for tb in tables]
        parts = _shard_parts(cfg, mesh, na, cs, rows, s)
        feas = [p.static_mask & p.fit_ok for p in parts]
        if groups is not None:
            views = [view_of(groups[d], cs[d].groups, t) for d in range(D)]
            feas = group_feasible(mesh, views, fam, feas)
        feas, gm = _lean_maxima(mesh, parts, feas)
        totals = [cfg.w_fit * p.s_fit + cfg.w_balanced * p.s_bal
                  + _lean_static(cfg, p, feas[d], gm[d])
                  for d, p in enumerate(parts)]
        if groups is not None:
            glob = score_globals(mesh, views, feas, fam, n_global)
            totals = [t_ + group_scores_view(cfg.w_spread, cfg.w_ipa,
                                             views[d], feas[d], fam, glob[d])
                      for d, t_ in enumerate(totals)]
        gbest, gscore = _argmax_global(mesh, feas, totals)
        lidx = [gbest[d] - d * n_local for d in range(D)]
        in_shard = [(x >= 0) & (x < n_local) for x in lidx]
        safe = [x.clamp(0, n_local - 1) for x in lidx]
        pick = (picker(mesh, list(groups), safe, in_shard)
                if groups is not None else None)
        new = []
        for d in range(D):
            assigned = (gscore[d] >= 0) & bool(v)
            gate = assigned & in_shard[d]
            c2 = _apply_assignment(cs[d], rows[d], safe[d], gate)
            c2 = c2._replace(cache=_row_refresh(
                cfg, na[d], c2, rows[d], safe[d], gate, parts[d]))
            if groups is not None:
                # gate: the GLOBAL placement (every shard's slice moves
                # with the chosen node's topology values)
                is_chosen = in_shard[d] & (torch.arange(
                    n_local, device=safe[d].device) == safe[d])
                c2 = c2._replace(groups=group_update(
                    groups[d], c2.groups, t, None, assigned, fam=fam,
                    pick=pick(d), is_chosen=is_chosen))
            new.append(c2)
        cs = new
        assigned0 = (gscore[0] >= 0) & bool(v)
        out.append(torch.where(assigned0, gbest[0],
                               torch.full_like(gbest[0], -1)))
    if not out:
        return Shards(cs), torch.zeros((0,), dtype=_I32,
                                       device=mesh.devices[0])
    return Shards(cs), torch.stack(out).to(_I32)


def _check_groups(carry: Shards, groups, pods=None) -> None:
    if (groups is None) != (carry[0].groups is None):
        raise ValueError("run_batch_sharded: groups and carry.groups go "
                         "together")
    if getattr(pods, "nom_idx", None) is not None:
        raise ValueError("run_batch_sharded: the nominated-pod overlay is "
                         "single-device only")


def run_batch_sharded(cfg, mesh: Mesh, na: Shards, carry: Shards, pods,
                      table, groups=None, fam=None):
    """`ops/program.py run_batch` with the node axis sharded over `mesh`.
    `pods` (PodXs) and `table` lie on the mesh's first device; `groups`
    (the shard_groups of the GroupsDev, with the group counts in every
    carry shard) turns on the group mode, `fam` skips the inactive
    families. Returns (the sharded carry, assignments i32 [B] on the
    first device), equal to the single-device program's. Never writes
    into `carry`."""
    _check_groups(carry, groups, pods)
    if groups is not None and fam is None:
        fam = ALL_FAMILIES
    if mesh_kind(mesh, na, carry) == "cuda":
        from ..ops.kernels import run_batch_sharded_cuda
        return run_batch_sharded_cuda(cfg, mesh, na, carry, pods, table,
                                      groups, fam)
    return _run_batch_sharded_plain(cfg, mesh, na, carry, pods, table,
                                    groups, fam)


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
    if groups is not None or carry[0].groups is not None:
        raise ValueError("profile_shard_lanes: the lane probe is group-free "
                         "(the JAX package skips it with group kernels)")
    _check_groups(carry, groups, pods)

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
    if carry[0].groups is not None:
        raise ValueError("run_uniform_sharded: a lean run (no group "
                         "counts)")
    _check_groups(carry, None, x)
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
    """`ops/program.py cluster_probe`'s mesh twin, every output bit-equal
    to the single-device probe's: the plain version on the node shards'
    cap / valid / used / npods gathered onto the first shard's device (the
    JAX package's lane-0 `lax.cond`); the kernels read shards that share
    a card in place and gather the others (ops/kernels.py
    cluster_probe_sharded_cuda). `dom` (i32 [N]) is replicated; the
    result lies on the first device, the controller's, which reads it."""
    kind = mesh_kind(mesh, na, carry)
    dev0 = mesh.devices[0]
    dom0 = _to(dom, dev0)
    if kind == "cuda":
        from ..ops.kernels import cluster_probe_sharded_cuda
        return cluster_probe_sharded_cuda(mesh, na, carry, dom0, ndom)
    cols = [gather_rows(mesh, [getattr(t, f) for t in tree], dev0)
            for tree, f in ((na, "cap"), (na, "valid"), (carry, "used"),
                            (carry, "npods"))]
    return _probe_plain(*cols, dom0, ndom)


# ---------------------------------------------------------------------------
# the per-signature surfaces on the mesh (the JAX package gets them from
# XLA's partitioning of _wave_statics_jit: ImageLocality's counts are
# cluster-wide, a psum over the shards)


def _wave_statics_sharded_plain(mesh: Mesh, na: Shards, table, wt, feats):
    tables = replicate(mesh, table)
    counts = [None] * mesh.size
    if feats[2]:
        per = [[image_counts(na[d], _gather_row(tables[d], int(u), True, 1))
                for u in wt] for d in range(mesh.size)]
        g = psum(mesh, [torch.stack([torch.cat([nw, tot[None]])
                                     for nw, tot in rows]) for rows in per])
        counts = [[(x[:-1], x[-1]) for x in gd] for gd in g]
    return [_wave_statics_plain(na[d], tables[d], wt, feats,
                                img_counts=counts[d])
            for d in range(mesh.size)]


def wave_statics_sharded(mesh: Mesh, na: Shards, table, wt,
                         feats: tuple = (True, True, True)) -> list:
    """ops/program.py wave_statics on the node shards: per shard the
    ([S, n], [S, n], [S, n], [S, n]) surfaces of its rows, ImageLocality
    scored with the cluster-wide image counts (each shard's counts, then
    the psum). CPU shards take the plain version, CUDA shards the
    wave_statics kernels per shard (the counts launch, the exchange, the
    statics launch)."""
    wt = [int(u) for u in wt]
    if mesh_kind(mesh, na) == "cuda":
        from ..ops.kernels import wave_statics_sharded_cuda
        return wave_statics_sharded_cuda(mesh, na, table, wt, feats)
    return _wave_statics_sharded_plain(mesh, na, table, wt, feats)


# ---------------------------------------------------------------------------
# the drain compiler's plan program on the mesh (the JAX package's
# _plan_local, kubernetes_tpu/parallel/sharding.py:563-837)

_PLAN_GD = ("spr_f_active", "spr_f_max_skew", "spr_f_self", "spr_f_tv",
            "spr_f_elig", "spr_s_active", "spr_s_max_skew", "spr_s_is_host",
            "spr_s_tv", "spr_s_elig", "spr_s_keys_ok", "spr_s_dom",
            "ipa_ra_active", "ipa_ra_tv", "ipa_raa_active", "ipa_raa_tv",
            "ipa_self_all", "ipa_stc_tv", "ipa_stp_tv")


def _fold_sharded(mesh: Mesh, gds: list, gcs: list, wt, cnts: list, fam,
                  n_global: int) -> list:
    """wave_fold on every shard with its segment sums psum'd: a first pass
    records each shard's partial sums in call order (no partial depends
    on an earlier sum), the psums run, a second pass folds with them."""
    rec = [[] for _ in gds]
    for d in range(mesh.size):
        wave_fold(gds[d], gcs[d], wt, cnts[d], fam=fam, n_seg=n_global,
                  seg_sum=lambda x, r=rec[d]: r.append(x) or x)
    glob = [psum(mesh, list(parts)) for parts in zip(*rec)]
    out = []
    for d in range(mesh.size):
        it = iter([g[d] for g in glob])
        out.append(wave_fold(gds[d], gcs[d], wt, cnts[d], fam=fam,
                             n_seg=n_global,
                             seg_sum=lambda x, it=it: next(it)))
    return out


def _run_plan_sharded_plain(cfg, mesh: Mesh, na: Shards, carry: Shards, xs,
                            table, wt, gd, statics, fam, norm_live: bool,
                            has_groups: bool, has_ports: bool):
    D = mesh.size
    n_local = int(na[0].cap.shape[0])
    n_global = n_local * D
    wt = [int(u) for u in wt]
    S = len(wt)
    tables = replicate(mesh, table)
    cols, slots = list(cfg.score_cols), list(cfg.nonzero_slot)
    rows, sts, spans, m_pair = [], [], [], None
    for d in range(D):
        dev = na[d].cap.device
        wt_t = torch.tensor(wt, dtype=_I64, device=dev)
        rows.append(PodRow(valid=True, sig=1, **{
            f: getattr(tables[d], f)[wt_t] for f in tables[d]._fields}))
        c = carry[d]
        fits = [(fit_mask(na[d].cap, c.used, c.npods, na[d].allowed_pods,
                          rows[d].req[s]),)
                + _fit_scores(cfg, na[d], c, _gather_row(tables[d], u, True,
                                                         1))
                for s, u in enumerate(wt)]
        gc = c.groups
        st = _WaveState(
            used=c.used, nonzero_used=c.nonzero_used, npods=c.npods,
            fit_ok=torch.stack([f[0] for f in fits]),
            s_fit=torch.stack([f[1] for f in fits]),
            s_bal=torch.stack([f[2] for f in fits]),
            f_cnt=gc.spr_f_cnt[wt_t] if has_groups else None,
            s_cnt=gc.spr_s_cnt[wt_t] if has_groups else None,
            veto=gc.ipa_veto[wt_t] if has_groups else None,
            a_cnt=gc.ipa_a_cnt[wt_t] if has_groups else None,
            a_total=gc.ipa_a_total[wt_t] if has_groups else None,
            aa_cnt=gc.ipa_aa_cnt[wt_t] if has_groups else None,
            iscore=gc.ipa_score[wt_t] if has_groups else None,
            cnt_sn=(torch.zeros((S, n_local), dtype=_I32, device=dev)
                    if has_groups else None),
            ports=c.ports if has_ports else None)
        sts.append(st)
        if has_groups:
            # span-local group statics ([S, ...]) of this shard
            sp = {f: getattr(gd[d], f)[wt_t] for f in _PLAN_GD}
            sp["f_minz"] = gc.spr_f_min_zero[wt_t]
            spans.append(sp)
            if m_pair is None:
                m_pair = {f: getattr(gd[d], f)[wt_t][:, wt_t].cpu()
                          for f in ("m_spr_f", "m_spr_s", "m_ipa_a",
                                    "m_ipa_aa", "m_ipa_exist", "w_stc",
                                    "w_stp")}

    def views(stl, w):
        return [GroupView(
            f_act=sp["spr_f_active"][w], f_skew=sp["spr_f_max_skew"][w],
            f_self=sp["spr_f_self"][w], f_minz=sp["f_minz"][w],
            f_tv=sp["spr_f_tv"][w], f_elig=sp["spr_f_elig"][w],
            f_cnt=x.f_cnt[w], s_act=sp["spr_s_active"][w],
            s_skew=sp["spr_s_max_skew"][w], s_is_host=sp["spr_s_is_host"][w],
            s_tv=sp["spr_s_tv"][w], s_keys_ok=sp["spr_s_keys_ok"][w],
            s_dom=sp["spr_s_dom"][w], s_cnt=x.s_cnt[w],
            ra_act=sp["ipa_ra_active"][w], ra_tv=sp["ipa_ra_tv"][w],
            raa_act=sp["ipa_raa_active"][w], raa_tv=sp["ipa_raa_tv"][w],
            self_all=sp["ipa_self_all"][w], veto=x.veto[w],
            a_cnt=x.a_cnt[w], a_total=x.a_total[w], aa_cnt=x.aa_cnt[w],
            iscore=x.iscore[w]) for sp, x in zip(spans, stl)]

    def evaluate(stl, w):
        feas = []
        for d in range(D):
            f = statics[d][0][w] & stl[d].fit_ok[w]
            if has_ports:
                f = f & ports_mask(stl[d].ports, rows[d].port_ids[w])
            feas.append(f)
        if has_groups:
            vs = views(stl, w)
            feas = group_feasible(mesh, vs, fam, feas)
        if norm_live:
            gm = pmax(mesh, [torch.stack([
                feasible_max(statics[d][1][w], feas[d]),
                feasible_max(statics[d][2][w], feas[d])]) for d in range(D)])
        totals = []
        for d in range(D):
            if norm_live:
                tn = (cfg.w_taint * default_normalize(
                    statics[d][1][w], feas[d], True, maxc=gm[d][0])
                    + cfg.w_node_affinity * default_normalize(
                        statics[d][2][w], feas[d], False, maxc=gm[d][1]))
            else:
                tn = cfg.w_taint * MAX_SCORE
            totals.append(cfg.w_fit * stl[d].s_fit[w]
                          + cfg.w_balanced * stl[d].s_bal[w] + tn
                          + cfg.w_image * statics[d][3][w])
        if has_groups:
            glob = score_globals(mesh, vs, feas, fam, n_global)
            totals = [t + group_scores_view(cfg.w_spread, cfg.w_ipa, vs[d],
                                            feas[d], fam, glob[d])
                      for d, t in enumerate(totals)]
        return feas, totals

    # Phase A: each slot's speculative choice at the pre-span carry, with
    # the global key
    spec_y = []
    for s in range(S):
        best, gscore = _argmax_global(mesh, *evaluate(sts, s))
        spec_y.append(int(best[0]) if int(gscore[0]) >= 0 else -1)

    def same_tv(tv, tvb):
        return (tv == tvb[..., None]) & (tvb[..., None] != 0)

    ys = []
    clean, n_conf, prefix = True, 0, 0
    for v, w in zip(xs.valid.tolist(), xs.widx.tolist()):
        v, w = bool(v), int(w)
        best, gscore = _argmax_global(mesh, *evaluate(sts, w))
        b = int(best[0])
        assigned = int(gscore[0]) >= 0 and v
        if assigned:
            # a placement that does not happen adds zeros everywhere, so
            # the unassigned step is the identity
            o, lb = b // n_local, b % n_local
            in_shard = [torch.tensor(d == o, device=dev)
                        for d, dev in enumerate(mesh.devices)]
            lid = [torch.tensor(lb if d == o else 0, device=dev)
                   for d, dev in enumerate(mesh.devices)]
            pick = picker(mesh, spans, lid, in_shard) if has_groups else None
            new = []
            for d in range(D):
                st = sts[d]
                upd = {}
                if d == o:
                    upd = _plan_place(cfg, na[d], st, rows[d], w, lb, cols,
                                      slots, has_ports)
                if has_groups:
                    upd.update(_plan_counts(
                        st, spans[d], m_pair, w, pick(d), lb if d == o
                        else -1, n_local, fam, same_tv))
                new.append(st._replace(**upd))
            sts = new
        y = b if assigned else -1
        conflict = v and y != spec_y[w]
        prefix += int(clean and v and not conflict)
        clean = clean and not conflict
        n_conf += int(conflict)
        ys.append(y)

    gcs = [c.groups for c in carry]
    if has_groups:
        gcs = _fold_sharded(mesh, list(gd), gcs, wt,
                            [x.cnt_sn for x in sts], fam, n_global)
    out = []
    for d in range(D):
        c, st = carry[d], sts[d]
        out.append(Carry(
            used=st.used, nonzero_used=st.nonzero_used, npods=st.npods,
            ports=st.ports if has_ports else c.ports,
            cache=c.cache._replace(sig=torch.zeros(
                (), dtype=_I32, device=c.used.device)),
            groups=gcs[d]))
    packed = torch.tensor(ys + [n_conf, prefix], dtype=_I32,
                          device=mesh.devices[0])
    return Shards(out), packed


def _plan_place(cfg, na, st, rows, w: int, b: int, cols, slots,
                has_ports: bool) -> dict:
    """The owning shard's part of a plan step's placement on its row `b`:
    the carry rows, the fit surfaces of every slot at the row, and the
    ports row (_row_refresh semantics, batched over the slots)."""
    nzm = torch.tensor(cfg.col_nonzero, device=st.used.device)
    used = st.used.clone()
    used[b] += rows.req[w]
    nzu = st.nonzero_used.clone()
    nzu[b] += rows.nonzero_req[w]
    npods = st.npods.clone()
    npods[b] += 1
    cap_row, used_row, nz_row = na.cap[b], used[b], nzu[b]
    fit_b = ((npods[b] + 1 <= na.allowed_pods[b])
             & ((rows.req == 0) | (used_row[None] + rows.req <= cap_row[None]))
             .all(dim=1))
    cap_r = cap_row[cols][None, :]
    used_pl_r = used_row[cols][None, :] + rows.req[:, cols]
    used_cols_r = torch.where(nzm[None, :], nz_row[slots][None, :]
                              + rows.nonzero_req[:, slots], used_pl_r)
    sfit_b = least_allocated(cfg, cap_r, used_cols_r)
    bal_b = balanced_allocation(cap_r, used_pl_r)
    sbal_b = torch.where(rows.skip_balanced, torch.zeros_like(bal_b), bal_b)

    def put_col(arr, new):
        out = arr.clone()
        out[:, b] = new
        return out

    upd = dict(used=used, nonzero_used=nzu, npods=npods,
               fit_ok=put_col(st.fit_ok, fit_b),
               s_fit=put_col(st.s_fit, sfit_b),
               s_bal=put_col(st.s_bal, sbal_b))
    pp = rows.port_ids[w]
    if has_ports and bool((pp != 0).any()):
        # the pod's port ids into the first free slots of the row
        prow = st.ports[b]
        free = prow == 0
        rank = torch.cumsum(free.to(_I64), dim=0) - 1
        nport = pp.shape[0]
        incoming = torch.where((rank >= 0) & (rank < nport) & free,
                               pp[rank.clamp(0, nport - 1)],
                               torch.zeros_like(prow))
        ports = st.ports.clone()
        ports[b] = torch.where(free, incoming, prow)
        upd["ports"] = ports
    return upd


def _plan_counts(st, sp: dict, mp: dict, w: int, pick, lb: int,
                 n_local: int, fam, same_tv) -> dict:
    """A plan step's group counter increments on one shard (consumer axis
    U → S), from the chosen node's values `pick` (owner-broadcast) and
    `lb`, the chosen row on this shard (-1 when another shard owns it)."""
    dev = st.used.device
    m = {k: v.to(dev) for k, v in mp.items()}
    upd = {}
    if fam.spr_f:
        inc = ((m["m_spr_f"][w] & pick("spr_f_elig"))[:, :, None]
               & same_tv(sp["spr_f_tv"], pick("spr_f_tv")))
        upd["f_cnt"] = st.f_cnt + inc.to(_I32)
    if fam.spr_s:
        is_b = (torch.arange(n_local, device=dev) == lb)[None, None, :]
        share = torch.where(sp["spr_s_is_host"][:, :, None], is_b,
                            same_tv(sp["spr_s_tv"], pick("spr_s_tv")))
        gate_c = torch.where(sp["spr_s_is_host"], m["m_spr_s"][w],
                             m["m_spr_s"][w] & pick("spr_s_elig"))
        upd["s_cnt"] = st.s_cnt + (gate_c[:, :, None] & share).to(_I32)
    if fam.ipa_anti:
        raa = sp["ipa_raa_tv"]
        share_anti = same_tv(raa[w], pick("ipa_raa_tv")[w])
        upd["veto"] = st.veto + (m["m_ipa_exist"][w][:, :, None]
                                 & share_anti[None]).sum(dim=1).to(_I32)
        inc_aa = m["m_ipa_aa"][w][:, :, None] & same_tv(
            raa, pick("ipa_raa_tv"))
        upd["aa_cnt"] = st.aa_cnt + inc_aa.to(_I32)
    if fam.ipa_req:
        tvb_a = pick("ipa_ra_tv")
        ra_act = sp["ipa_ra_active"]
        inc_a = ((m["m_ipa_a"][w][:, None] & ra_act)[:, :, None]
                 & same_tv(sp["ipa_ra_tv"], tvb_a))
        upd["a_cnt"] = st.a_cnt + inc_a.to(_I32)
        upd["a_total"] = st.a_total + (
            m["m_ipa_a"][w].to(_I64) * (ra_act & (tvb_a != 0)).sum(dim=1))
    if fam.ipa_score:
        d_cons = (m["w_stc"][w][:, :, None]
                  * same_tv(sp["ipa_stc_tv"], pick("ipa_stc_tv"))).sum(dim=1)
        share_p = same_tv(sp["ipa_stp_tv"][w], pick("ipa_stp_tv")[w])
        d_plcd = (m["w_stp"][w][:, :, None] * share_p[None]).sum(dim=1)
        upd["iscore"] = st.iscore + d_cons + d_plcd
    if lb >= 0:
        cnt_sn = st.cnt_sn.clone()
        cnt_sn[w, lb] += 1
        upd["cnt_sn"] = cnt_sn
    return upd


def run_plan_sharded(cfg, mesh: Mesh, na: Shards, carry: Shards, xs, table,
                     wt, gd, statics, fam, norm_live: bool,
                     has_groups: bool = True, has_ports: bool = False):
    """`ops/program.py run_plan` on the mesh: one mixed-signature span with
    the fit surfaces and group counters per shard, the per-step argmax the
    global first-max key, every read of the chosen node's row an owner
    broadcast, and the epilogue's wave_fold with its segments psum'd.
    `gd` is the shard_groups of the GroupsDev (None for the lean
    variant), `statics` the per-shard stacked surfaces
    (wave_statics_sharded). Returns (the sharded carry', packed i32
    [W + 2] on the first device), equal to run_plan's. Never writes into
    `carry`."""
    from ..ops.program import PLAN_MAX_SIGS
    if len(wt) > PLAN_MAX_SIGS:
        raise ValueError(f"run_plan_sharded: {len(wt)} signature slots > "
                         f"{PLAN_MAX_SIGS}")
    if has_groups and (gd is None or carry[0].groups is None):
        raise ValueError("run_plan_sharded: has_groups needs gd and "
                         "carry.groups")
    if mesh_kind(mesh, na, carry) == "cuda":
        from ..ops.kernels import run_plan_sharded_cuda
        return run_plan_sharded_cuda(cfg, mesh, na, carry, xs, table, wt, gd,
                                     statics, fam, norm_live, has_groups,
                                     has_ports)
    return _run_plan_sharded_plain(cfg, mesh, na, carry, xs, table, wt, gd,
                                   statics, fam, norm_live, has_groups,
                                   has_ports)


# ---------------------------------------------------------------------------
# gang placement on the mesh (the JAX package's _gang_scan_local,
# kubernetes_tpu/parallel/sharding.py:890-1016, and
# _run_gang_uniform_sharded_jit, :1042-1071)


def _run_gang_scan_sharded_plain(cfg, mesh: Mesh, na: Shards, carry: Shards,
                                 xs, table, wt, needed: int, dom: list,
                                 statics, w_contig: int):
    D = mesh.size
    n_local = int(na[0].cap.shape[0])
    n_global = n_local * D
    tables = replicate(mesh, table)
    cols, slots = list(cfg.score_cols), list(cfg.nonzero_slot)
    rows = [int(u) for u in wt]
    pods_s = [[_gather_row(tables[d], u, True, 0) for u in rows]
              for d in range(D)]
    fit_ok, s_fit, s_bal, used, nz, npods, domcnt = ([] for _ in range(7))
    for d in range(D):
        c = carry[d]
        fit_ok.append(torch.stack([fit_mask(na[d].cap, c.used, c.npods,
                                            na[d].allowed_pods, p.req)
                                   for p in pods_s[d]]))
        fs = [_fit_scores(cfg, na[d], c, p) for p in pods_s[d]]
        s_fit.append(torch.stack([f for f, _ in fs]))
        s_bal.append(torch.stack([b for _, b in fs]))
        used.append(c.used)
        nz.append(c.nonzero_used)
        npods.append(c.npods)
        # the contiguity counts: replicated, one per global domain id
        domcnt.append(torch.zeros((n_global,), dtype=_I32,
                                  device=c.used.device))
    placed = 0
    raw = []
    for v, t, s in zip(xs.valid.tolist(), xs.tidx.tolist(),
                       xs.widx.tolist()):
        feas = [statics[d][0][s] & fit_ok[d][s] for d in range(D)]
        parts = [(statics[d][1][s], statics[d][2][s],
                  domcnt[d][dom[d].long()].to(_I64)) for d in range(D)]
        gm = pmax(mesh, [torch.stack([feasible_max(x, feas[d])
                                      for x in parts[d]])
                         for d in range(D)])
        totals = []
        for d in range(D):
            traw, nraw, dc = parts[d]
            total = (cfg.w_fit * s_fit[d][s] + cfg.w_balanced * s_bal[d][s]
                     + cfg.w_taint * default_normalize(traw, feas[d], True,
                                                       maxc=gm[d][0])
                     + cfg.w_node_affinity * default_normalize(
                         nraw, feas[d], False, maxc=gm[d][1])
                     + cfg.w_image * statics[d][3][s])
            if w_contig:
                total = total + w_contig * default_normalize(
                    dc, feas[d], False, maxc=gm[d][2])
            totals.append(total)
        best, gscore = _argmax_global(mesh, feas, totals)
        b = int(best[0])
        if not (int(gscore[0]) >= 0 and bool(v)):
            raw.append(-1)
            continue
        o, lb = b // n_local, b % n_local
        pod = _gather_row(tables[o], t, v, 0)
        used[o] = used[o].clone()
        nz[o] = nz[o].clone()
        npods[o] = npods[o].clone()
        used[o][lb] += pod.req
        nz[o][lb] += pod.nonzero_req
        npods[o][lb] += 1
        # the owner refreshes its touched row for every signature slot
        cap_row, used_row = na[o].cap[lb], used[o][lb]
        nzm = torch.tensor(cfg.col_nonzero, device=cap_row.device)
        fit_ok[o], s_fit[o], s_bal[o] = (x.clone() for x in
                                         (fit_ok[o], s_fit[o], s_bal[o]))
        for k, p in enumerate(pods_s[o]):
            fit_ok[o][k, lb] = ((npods[o][lb] + 1 <= na[o].allowed_pods[lb])
                                & ((p.req == 0)
                                   | (used_row + p.req <= cap_row)).all())
            cap_r = cap_row[cols][None, :]
            used_nz_r = nz[o][lb][slots] + p.nonzero_req[slots]
            used_pl_r = used_row[cols] + p.req[cols]
            used_cols_r = torch.where(nzm, used_nz_r, used_pl_r)[None, :]
            s_fit[o][k, lb] = least_allocated(cfg, cap_r, used_cols_r)[0]
            bal = balanced_allocation(cap_r, used_pl_r[None, :])[0]
            s_bal[o][k, lb] = torch.where(p.skip_balanced,
                                          torch.zeros_like(bal), bal)
        if w_contig:
            dom_b = own(mesh, [dom[d][lb if d == o else 0] for d in range(D)],
                        [torch.tensor(d == o, device=dev)
                         for d, dev in enumerate(mesh.devices)])
            for d in range(D):
                domcnt[d] = domcnt[d].clone()
                domcnt[d][dom_b[d].long()] += 1
        placed += 1
        raw.append(b)
    accept = placed >= int(needed)
    out = []
    for d in range(D):
        c = carry[d]
        if accept:
            out.append(c._replace(used=used[d], nonzero_used=nz[d],
                                  npods=npods[d],
                                  cache=c.cache._replace(sig=torch.zeros_like(
                                      c.cache.sig))))
        else:
            out.append(c)
    packed = torch.tensor(raw + [int(accept), placed, 1, 1], dtype=_I32,
                          device=mesh.devices[0])
    return Shards(out), packed


def _run_gang_uniform_sharded_plain(cfg, mesh: Mesh, na: Shards,
                                    carry: Shards, x, table, n_actual: int,
                                    needed: int, L: int, K: int, J: int):
    new, pu = _run_uniform_sharded_plain(cfg, mesh, na, carry, x, table,
                                         n_actual, L, K, J)
    assignments = pu[:L]
    ok, depth_ok = pu[L] != 0, pu[L + 1] != 0
    placed = (assignments >= 0).sum().to(_I32)
    accept = placed >= int(needed)
    apply = bool(accept & ok & depth_ok)
    out = Shards(new) if apply else carry
    packed = torch.cat([assignments, torch.stack(
        [accept, placed, ok, depth_ok]).to(_I32)])
    return out, packed


def run_gang_sharded(cfg, mesh: Mesh, na: Shards, carry: Shards, xs, table,
                     wt=None, needed: int = 0, dom=None, statics=None,
                     w_contig: int = 0, uniform: bool = False,
                     n_actual: int = 0, L: int = 0, K: int = 0, J: int = 0):
    """`ops/gang.py run_gang` on the mesh, both tiers behind one entry with
    run_gang's packed layouts. The closed form (`uniform=True`) is
    run_uniform_sharded with the gang verdict, the carry applied on every
    shard only when the gang is accepted and both exactness flags held.
    The scan tier takes the per-shard stacked surfaces (`statics`, as
    run_plan_sharded's) and `dom`, the per-shard slices of the i32 [N]
    GLOBAL topology domain ids; its contiguity counts are replicated,
    one per global id. A rejected gang leaves every shard's carry as it
    came, SigCache included. Never writes into `carry`: the scheduler
    keeps it to replay a failed closed form on the scan tier."""
    if carry[0].groups is not None:
        raise ValueError("run_gang_sharded: gangs take a lean carry")
    kind = mesh_kind(mesh, na, carry)
    if uniform:
        if int(xs.sig) == 0:
            raise ValueError("run_gang_sharded needs a signature (sig != 0)")
        if not 0 <= int(n_actual) <= L:
            raise ValueError(f"run_gang_sharded: n_actual {n_actual} "
                             f"outside [0, {L}]")
        if kind == "cuda":
            from ..ops.kernels import run_gang_uniform_sharded_cuda
            return run_gang_uniform_sharded_cuda(cfg, mesh, na, carry, xs,
                                                 table, int(n_actual),
                                                 int(needed), L, K, J)
        return _run_gang_uniform_sharded_plain(cfg, mesh, na, carry, xs,
                                               table, int(n_actual),
                                               int(needed), L, K, J)
    if kind == "cuda":
        from ..ops.kernels import run_gang_sharded_cuda
        return run_gang_sharded_cuda(cfg, mesh, na, carry, xs, table, wt,
                                     int(needed), dom, statics, w_contig)
    return _run_gang_scan_sharded_plain(cfg, mesh, na, carry, xs, table, wt,
                                        int(needed), dom, statics, w_contig)
