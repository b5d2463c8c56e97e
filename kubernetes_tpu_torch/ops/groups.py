"""Group state: PodTopologySpread + InterPodAffinity on the device.

PyTorch counterpart of kubernetes_tpu/ops/groups.py. The reference
evaluates these plugins per pod with topologyPair→count maps rebuilt every
cycle (podtopologyspread/filtering.go:237-312,
interpodaffinity/filtering.go:204-273); here each map is a per-NODE count
vector shared across nodes with equal topology value: for a map keyed
(topologyKey, value), `cnt[n] = map[(key, tv(n))]`. Counts ride the carry
and move after every placement with one "same-topology-value" broadcast.

Three layers, as in the JAX package:

- `GroupsDev` — static per-(signature, node) tensors: interned topology
  values per constraint/term, count-eligibility masks, and the pairwise
  signature match matrices.
- `GroupCarry` — the dynamic counts (spread match counts per DoNotSchedule
  / ScheduleAnyway constraint, the three inter-pod affinity maps, the
  symmetric preferred-affinity score surface).
- the mask / score / update functions below, plain PyTorch, called from
  ops/program.py. They are the CPU path and the yardstick the CUDA kernels
  (csrc/group_eval.cuh and the kernels that include it) are held to.

`GroupManager` (host, numpy) parses signature rows, fills the match
matrices and seeds the counts by running the host plugins' own
PreFilter/PreScore, exactly as the JAX package does; `to_device` moves
the numpy tensors to the port's device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ingest.groupcols import NodeLabelColumns, gather_ids

INT32_MAX = np.int32(2**31 - 1)
I64_MAX = 2**63 - 1
I64_MIN = -(2**63)

MAX_NODE_SCORE = 100

LABEL_HOSTNAME = "kubernetes.io/hostname"

_I32, _I64 = torch.int32, torch.int64


# ---------------------------------------------------------------------------
# dims



@dataclass
class GroupDims:
    spread_constraints: int = 2   # SC — per action (DoNotSchedule / ScheduleAnyway)
    ipa_req_terms: int = 2        # TA — required affinity terms
    ipa_anti_terms: int = 2       # TAA — required anti-affinity terms
    ipa_cons_terms: int = 4       # CT — consumer-side preferred (score) terms
    ipa_plcd_terms: int = 6       # PT — placed-side score terms (req_a + preferred)


# ---------------------------------------------------------------------------
# device structures


class GroupsDev(NamedTuple):
    """Static per-table tensors ([U] = signature rows, [N] = node axis)."""

    # spread DoNotSchedule constraints (filtering.go)
    spr_f_active: object      # bool [U, SC]
    spr_f_max_skew: object    # i32 [U, SC]
    spr_f_self: object        # i32 [U, SC] — selfMatchNum (filtering.go:338)
    spr_f_tv: object          # i32 [U, SC, N] — node's interned topo value (0 = absent)
    spr_f_elig: object        # bool [U, SC, N] — counted node (keys + inclusion)
    spr_f_dom: object         # i32 [U, SC, N] — dense domain id (wave fold)
    # spread ScheduleAnyway constraints (scoring.go)
    spr_s_active: object      # bool [U, SC]
    spr_s_max_skew: object    # i32 [U, SC]
    spr_s_is_host: object     # bool [U, SC] — hostname key: per-node counts
    spr_s_tv: object          # i32 [U, SC, N]
    spr_s_elig: object        # bool [U, SC, N]
    spr_s_keys_ok: object     # bool [U, N] — all score topo keys present
    spr_s_dom: object         # i32 [U, SC, N] — dense domain id (first node idx w/ tv)
    # inter-pod affinity required terms (filtering.go)
    ipa_ra_active: object     # bool [U, TA]
    ipa_ra_tv: object         # i32 [U, TA, N]
    ipa_ra_dom: object        # i32 [U, TA, N] — dense domain id (wave fold)
    ipa_raa_active: object    # bool [U, TAA]
    ipa_raa_tv: object        # i32 [U, TAA, N]
    ipa_raa_dom: object       # i32 [U, TAA, N]
    ipa_self_all: object      # bool [U] — pod matches all own affinity terms
    # inter-pod affinity score terms (scoring.go)
    ipa_stc_tv: object        # i32 [U, CT, N] — consumer (incoming) pref terms
    ipa_stc_dom: object       # i32 [U, CT, N]
    ipa_stp_tv: object        # i32 [U, PT, N] — placed (existing) side terms
    ipa_stp_dom: object       # i32 [U, PT, N]
    # pairwise signature match matrices [placed-row, consumer-row, ...]
    m_spr_f: object           # bool [U, U, SC]
    m_spr_s: object           # bool [U, U, SC]
    m_ipa_a: object           # bool [U, U] — placed matches ALL consumer req terms
    m_ipa_aa: object          # bool [U, U, TAA] — per consumer anti term
    m_ipa_exist: object       # bool [U, U, TAA] — placed's anti term matches consumer
    w_stc: object             # i64 [U, U, CT] — signed weight (0 = no match)
    w_stp: object             # i64 [U, U, PT]


class GroupCarry(NamedTuple):
    """Dynamic counts riding the scan carry."""

    spr_f_cnt: object         # i32 [U, SC, N]
    spr_f_min_zero: object    # bool [U, SC] — eligible domains < minDomains
    spr_s_cnt: object         # i32 [U, SC, N]
    ipa_veto: object          # i32 [U, N] — existingAntiAffinityCounts per node
    ipa_a_cnt: object         # i32 [U, TA, N]
    ipa_a_total: object       # i64 [U] — affinityCounts map emptiness tracker
    ipa_aa_cnt: object        # i32 [U, TAA, N]
    ipa_score: object         # i64 [U, N] — symmetric topology score surface


class GroupFamilies(NamedTuple):
    """Activation mask per constraint family (host-derived flags).

    When a family is provably inactive — no signature row carries it and its
    seeded counts are zero — every one of its carry updates is identically
    zero and every one of its mask/score contributions is the identity, so
    the plain functions and the kernels skip it (the kernels take the flags
    as runtime ints): a spread-only span does no inter-pod-affinity work.

    Pass-through of an inactive family's counts stays exact across later
    activation: a newly added signature row re-seeds its own counts from the
    live snapshot (scatter_new_rows), and existing rows' counts could only
    have received zero increments while the family was inactive."""

    spr_f: bool = True
    spr_s: bool = True
    ipa_req: bool = True
    ipa_anti: bool = True
    ipa_score: bool = True


ALL_FAMILIES = GroupFamilies()


# ---------------------------------------------------------------------------
# preemption dry run: victim count tensors (spread deltas)


class DryRunSpread(NamedTuple):
    """PodTopologySpread victim-delta tensors for the batched preemption
    dry run (ops/program.py dry_run_select_victims). [C] = candidate
    nodes, [V] = padded victim slots, [SC] = the preemptor's DoNotSchedule
    constraints. Built host-side by `spread_dry_run_tensors` from the SAME
    plugin PreFilter state the host loop seeds."""

    max_skew: object      # i32 [SC]
    self_match: object    # i32 [SC] — selfMatchNum (filtering.go:338)
    min_zero: object      # bool [SC] — eligible domains < minDomains
    tv_ok: object         # bool [C, SC] — candidate has the topology key
    cnt0: object          # i32 [C, SC] — seeded match count in the
    #                       candidate's own topology domain
    other_min: object     # i32 [C, SC] — criticalPaths companion minimum
    vic_match: object     # bool [C, V, SC] — victim moves constraint count


def spread_dry_run_tensors(s, pod, cand_infos, victims, c_pad: int,
                           v_pad: int) -> DryRunSpread:
    """Victim count tensors (numpy) for the spread deltas of one
    preemption dry run. `s` is the preemptor's seeded podtopologyspread
    _PreFilterState (the plugin's own PreFilter over ALL nodes),
    `cand_infos` the candidate NodeInfos and `victims[c]` each candidate's
    potential victims in reprieve order.

    criticalPaths closed form: a dry run only ever moves ONE topology
    value per candidate (all its victims live on that node), so the
    two-entry min tracker (filtering.go:97-136) reduces to min(x, other),
    with x the candidate domain's live count and `other` = n1 when that
    domain IS the tracked minimum (v0), else n0 — for every update
    sequence, the untracked → tracked transition included."""
    from ..plugins.podtopologyspread import (_match_node_inclusion_policies,
                                             _node_has_all_topology_keys)

    cons = s.constraints
    SC = len(cons)
    max_skew = np.array([c.max_skew for c in cons], np.int32)
    self_match = np.array(
        [1 if c.selector.matches(pod.metadata.labels) else 0 for c in cons],
        np.int32)
    min_zero = np.array(
        [len(s.tp_value_to_match_num[j]) < c.min_domains
         for j, c in enumerate(cons)], bool)
    tv_ok = np.zeros((c_pad, SC), bool)
    cnt0 = np.zeros((c_pad, SC), np.int32)
    other_min = np.full((c_pad, SC), INT32_MAX, np.int32)
    vic_match = np.zeros((c_pad, v_pad, SC), bool)
    for ci, ni in enumerate(cand_infos):
        labels = ni.node.metadata.labels
        for j, c in enumerate(cons):
            tv = labels.get(c.topology_key)
            if tv is None:
                continue
            tv_ok[ci, j] = True
            cnt0[ci, j] = s.tp_value_to_match_num[j].get(tv, 0)
            cp = s.critical_paths[j]
            other_min[ci, j] = min(cp.n1 if tv == cp.v0 else cp.n0,
                                   int(INT32_MAX))
        # the plugin gates EVERY constraint update on the node having all
        # topology keys (podtopologyspread.py _update_with_pod)
        if not _node_has_all_topology_keys(labels, cons):
            continue
        for j, c in enumerate(cons):
            if not _match_node_inclusion_policies(c, pod, ni):
                continue
            for vi, pi in enumerate(victims[ci]):
                vp = pi.pod
                if (vp.namespace == pod.namespace
                        and c.selector.matches(vp.metadata.labels)):
                    vic_match[ci, vi, j] = True
    return DryRunSpread(max_skew=max_skew, self_match=self_match,
                        min_zero=min_zero, tv_ok=tv_ok, cnt0=cnt0,
                        other_min=other_min, vic_match=vic_match)


# ---------------------------------------------------------------------------
# device functions (plain PyTorch)


class GroupView(NamedTuple):
    """One signature row's gathered group tensors — the shared input of
    `group_mask_view` / `group_scores_view`. Built by `view_of` on the scan
    path, and from the wave program's maintained counters (ops/program.py
    run_wave) — both evaluate the same formula code."""

    f_act: object       # bool [SC]
    f_skew: object      # i32 [SC]
    f_self: object      # i32 [SC]
    f_minz: object      # bool [SC]
    f_tv: object        # i32 [SC, N]
    f_elig: object      # bool [SC, N]
    f_cnt: object       # i32 [SC, N]
    s_act: object       # bool [SC]
    s_skew: object      # i32 [SC]
    s_is_host: object   # bool [SC]
    s_tv: object        # i32 [SC, N]
    s_keys_ok: object   # bool [N]
    s_dom: object       # i32 [SC, N]
    s_cnt: object       # i32 [SC, N]
    ra_act: object      # bool [TA]
    ra_tv: object       # i32 [TA, N]
    raa_act: object     # bool [TAA]
    raa_tv: object      # i32 [TAA, N]
    self_all: object    # bool
    veto: object        # i32 [N]
    a_cnt: object       # i32 [TA, N]
    a_total: object     # i64
    aa_cnt: object      # i32 [TAA, N]
    iscore: object      # i64 [N]


def view_of(gd: GroupsDev, gc: GroupCarry, tidx) -> GroupView:
    return GroupView(
        f_act=gd.spr_f_active[tidx], f_skew=gd.spr_f_max_skew[tidx],
        f_self=gd.spr_f_self[tidx], f_minz=gc.spr_f_min_zero[tidx],
        f_tv=gd.spr_f_tv[tidx], f_elig=gd.spr_f_elig[tidx],
        f_cnt=gc.spr_f_cnt[tidx],
        s_act=gd.spr_s_active[tidx], s_skew=gd.spr_s_max_skew[tidx],
        s_is_host=gd.spr_s_is_host[tidx], s_tv=gd.spr_s_tv[tidx],
        s_keys_ok=gd.spr_s_keys_ok[tidx], s_dom=gd.spr_s_dom[tidx],
        s_cnt=gc.spr_s_cnt[tidx],
        ra_act=gd.ipa_ra_active[tidx], ra_tv=gd.ipa_ra_tv[tidx],
        raa_act=gd.ipa_raa_active[tidx], raa_tv=gd.ipa_raa_tv[tidx],
        self_all=gd.ipa_self_all[tidx],
        veto=gc.ipa_veto[tidx], a_cnt=gc.ipa_a_cnt[tidx],
        a_total=gc.ipa_a_total[tidx], aa_cnt=gc.ipa_aa_cnt[tidx],
        iscore=gc.ipa_score[tidx])


def spread_min_local(v: GroupView):
    """Per-constraint minimum of the DoNotSchedule counts over these
    count-eligible rows (INT32_MAX where none) → i32 [SC]. On a node
    shard it is the shard's part of the minimum the JAX package pmins
    (kubernetes_tpu/ops/groups.py:298-299)."""
    return torch.where(v.f_elig, v.f_cnt,
                       torch.full_like(v.f_cnt, int(INT32_MAX))).amin(dim=-1)


def spread_min(v: GroupView, gmin=None):
    """Per-constraint global minimum of the DoNotSchedule counts over the
    count-eligible nodes, 0 when fewer eligible domains than minDomains
    (filtering.go:66-77) → i32 [SC]. `gmin`: the cluster-wide
    `spread_min_local` when the rows are one node shard."""
    minv = spread_min_local(v) if gmin is None else gmin
    return torch.where(v.f_minz, torch.zeros_like(minv), minv)


def group_mask_view(v: GroupView, fam: GroupFamilies, gmin=None):
    """`gmin`: see spread_min."""
    n = v.veto.shape[-1]
    mask = torch.ones((n,), dtype=torch.bool, device=v.veto.device)

    if fam.spr_f:
        # spread skew (DoNotSchedule)
        minv = spread_min(v, gmin)
        ok = (v.f_cnt + v.f_self[:, None] - minv[:, None]
              <= v.f_skew[:, None])
        # node missing the topology key ⇒ UnschedulableAndUnresolvable
        mask &= (~v.f_act[:, None] | ((v.f_tv != 0) & ok)).all(dim=0)

    if fam.ipa_anti:
        # existing pods' required anti-affinity (filtering.go:204-228)
        mask &= v.veto == 0
        # incoming required anti-affinity
        mask &= ~(v.raa_act[:, None] & (v.raa_tv != 0)
                  & (v.aa_cnt > 0)).any(dim=0)

    if fam.ipa_req:
        # incoming required affinity (incl. the first-pod-in-series escape
        # hatch, filtering.go:381-397); sum == 0 ⇔ the affinityCounts map
        # is empty: seeds count (strictly positive) and the device only
        # ever increments
        tv_all = (~v.ra_act[:, None] | (v.ra_tv != 0)).all(dim=0)
        pods_exist = (~v.ra_act[:, None] | (v.a_cnt > 0)).all(dim=0)
        escape = (v.a_total == 0) & v.self_all
        ok = tv_all & (pods_exist | escape)
        mask &= torch.where(v.ra_act.any(), ok, torch.ones_like(ok))

    return mask


def group_mask(gd: GroupsDev, gc: GroupCarry, tidx,
               fam: Optional[GroupFamilies] = None):
    """Feasibility over the node axis for the pod signature `tidx`: spread
    skew check (filtering.go:314-360) AND the three inter-pod affinity
    checks (filtering.go:405-432). `fam` skips families whose contribution
    is provably the identity (see GroupFamilies)."""
    return group_mask_view(view_of(gd, gc, tidx), fam or ALL_FAMILIES)


def group_reason_masks(gd: GroupsDev, gc: GroupCarry, tidx,
                       fam: Optional[GroupFamilies] = None):
    """Diagnosis companion of `group_mask`: the same formulas, split into
    the five per-node failure masks the host filters report —
    (spr_missing, spr_skew, aff_fail, anti_fail, exist_fail), each bool
    [N]. Spread attributes each node to its FIRST failing constraint (the
    host filter returns on the first violation); the caller layers these
    under the host's plugin order (spread before inter-pod affinity)."""
    fam = fam or ALL_FAMILIES
    v = view_of(gd, gc, tidx)
    n = v.veto.shape[-1]
    false = torch.zeros((n,), dtype=torch.bool, device=v.veto.device)
    spr_missing = spr_skew = aff_fail = anti_fail = exist_fail = false

    if fam.spr_f:
        minv = spread_min(v)
        ok = (v.f_cnt + v.f_self[:, None] - minv[:, None]
              <= v.f_skew[:, None])
        missing_c = v.f_act[:, None] & (v.f_tv == 0)        # [SC, N]
        fail_c = v.f_act[:, None] & ((v.f_tv == 0) | ~ok)
        any_fail = fail_c.any(dim=0)
        first_c = torch.argmax(fail_c.to(_I32), dim=0)      # first max
        first_missing = torch.gather(missing_c, 0, first_c[None, :])[0]
        spr_missing = any_fail & first_missing
        spr_skew = any_fail & ~first_missing

    if fam.ipa_req:
        tv_all = (~v.ra_act[:, None] | (v.ra_tv != 0)).all(dim=0)
        pods_exist = (~v.ra_act[:, None] | (v.a_cnt > 0)).all(dim=0)
        escape = (v.a_total == 0) & v.self_all
        aff_fail = v.ra_act.any() & ~(tv_all & (pods_exist | escape))

    if fam.ipa_anti:
        anti_fail = (v.raa_act[:, None] & (v.raa_tv != 0)
                     & (v.aa_cnt > 0)).any(dim=0)
        exist_fail = v.veto != 0

    return spr_missing, spr_skew, aff_fail, anti_fail, exist_fail


def spread_flags(v: GroupView, scored, n_seg=None):
    """i32 [SC, n_seg]: 1 at the dense domain id of every scored row, per
    ScheduleAnyway constraint (n_seg defaults to the row count). On a
    node shard the ids are global and n_seg the global node count: the
    shard's part of the flags the JAX package psums (:414-422)."""
    dom = v.s_dom.long()                                # [SC, N]
    flags = torch.zeros((dom.shape[0], n_seg or dom.shape[1]), dtype=_I32,
                        device=dom.device)
    flags.scatter_reduce_(1, dom, scored.to(_I32).expand_as(dom).contiguous(),
                          reduce="amax")
    return flags


def spread_raw(v: GroupView, npart, flags):
    """The raw PodTopologySpread score of every row (scoring.go:199-250),
    from the (cluster-wide) count of scored nodes and the domain flags."""
    distinct = (flags > 0).sum(dim=1)                   # [SC]
    size = torch.where(v.s_is_host, npart, distinct)
    weight = torch.log(size.to(torch.float64) + 2.0)    # [SC]
    contrib = torch.where(
        v.s_act[:, None] & (v.s_tv != 0),
        v.s_cnt.to(torch.float64) * weight[:, None]
        + (v.s_skew[:, None] - 1).to(torch.float64),
        torch.zeros((), dtype=torch.float64, device=flags.device))
    return torch.round(contrib.sum(dim=0)).to(_I64)     # [N]


def spread_range(raw, scored):
    """(min, max) of the raw spread scores over the scored rows (INT32_MAX
    and 0 when none): on a node shard the shard's part of the pmin and
    pmax."""
    return (torch.where(scored, raw, torch.full_like(raw, int(INT32_MAX))).min(),
            torch.where(scored, raw, torch.zeros_like(raw)).max())


def _spread_scores(v: GroupView, feasible, npart=None, flags=None,
                   rng=None):
    """PodTopologySpread score (scoring.go:199-271), normalized
    (MAX·(max+min−s)//max); 0 on missing-keys and infeasible nodes. On a
    node shard `npart` (the psum of the scored rows), `flags` (the psum'd
    spread_flags) and `rng` (the pmin / pmax of spread_range) are the
    cluster-wide values; None takes them over these rows."""
    has_s = v.s_act.any()
    scored = feasible & v.s_keys_ok
    if npart is None:
        npart = scored.sum()
    if flags is None:
        flags = spread_flags(v, scored)
    raw = spread_raw(v, npart, flags)
    minv, maxv = spread_range(raw, scored) if rng is None else rng
    norm = torch.where(maxv == 0, torch.full_like(raw, MAX_NODE_SCORE),
                       MAX_NODE_SCORE * (maxv + minv - raw)
                       // maxv.clamp(min=1))
    return torch.where(has_s & scored, norm, torch.zeros_like(norm))


def ipa_range(s, feasible):
    """(min, max) of the symmetric score surface over the feasible rows
    (I64_MAX and -I64_MAX when none): on a node shard the shard's part of
    the pmin and pmax."""
    return (torch.where(feasible, s, torch.full_like(s, I64_MAX)).min(),
            torch.where(feasible, s, torch.full_like(s, -I64_MAX)).max())


def _ipa_norm_scores(s, feasible, rng=None):
    """InterPodAffinity normalized score surface (scoring.go:263-293).
    `s`: the gathered i64 [N] symmetric topology score surface; `rng` the
    cluster-wide ipa_range on a node shard. The feasible-set range is
    taken in wrapping int64 arithmetic, as XLA's."""
    minv2, maxv2 = ipa_range(s, feasible) if rng is None else rng
    diff = maxv2 - minv2
    val = (MAX_NODE_SCORE * (s - minv2).to(torch.float64)
           / diff.clamp(min=1).to(torch.float64))
    return torch.where(diff > 0, val,
                       torch.zeros_like(val)).to(_I64)


class ScoreGlobals(NamedTuple):
    """The cluster-wide values group_scores_view takes on a node shard
    (the JAX package's _gsum / _gmin / _gmax points, :398-422)."""

    npart: object        # i64: scored nodes
    flags: object        # i32 [SC, n_global]: spread domain flags
    spread: object       # (min, max) of the raw spread scores
    ipa: object          # (min, max) of the symmetric score surface


def group_scores_view(w_spread: int, w_ipa: int, v: GroupView, feasible,
                      fam: GroupFamilies, glob: Optional[ScoreGlobals] = None):
    """`glob`: the cluster-wide values when the rows are one node shard
    (None: over these rows)."""
    N = feasible.shape[0]
    g = glob or ScoreGlobals(None, None, None, None)
    if not fam.spr_s and not fam.ipa_score:
        return torch.zeros((N,), dtype=_I64, device=feasible.device)
    if not fam.spr_s:
        return w_ipa * _ipa_norm_scores(v.iscore, feasible, g.ipa)
    out = w_spread * _spread_scores(v, feasible, g.npart, g.flags, g.spread)
    if fam.ipa_score:
        out = out + w_ipa * _ipa_norm_scores(v.iscore, feasible, g.ipa)
    return out


def group_scores(w_spread: int, w_ipa: int, gd: GroupsDev, gc: GroupCarry,
                 tidx, feasible, fam: Optional[GroupFamilies] = None):
    """Weighted PodTopologySpread + InterPodAffinity score over the node
    axis, normalized per the host plugins' Normalize formulas. `feasible`
    is the FULL filtered set (all plugins), matching the host runtime's
    normalize-over-filtered-list semantics."""
    return group_scores_view(w_spread, w_ipa, view_of(gd, gc, tidx),
                             feasible, fam or ALL_FAMILIES)


def group_update(gd: GroupsDev, gc: GroupCarry, tidx: int, best, gate,
                 fam: Optional[GroupFamilies] = None, *, pick=None,
                 is_chosen=None) -> GroupCarry:
    """Carry update after placing a pod of signature `tidx` on node `best`
    (gated by the bool scalar `gate`). On a node shard `best` is None and
    the JAX package's `pick` / `is_chosen` (:475) come in: `pick(name)` is
    the chosen node's values of the GroupsDev field `name`, broadcast
    from the owning shard, and `is_chosen` bool [N] marks the chosen row
    among these rows (all False on the other shards). Counts are additive
    over pods and node labels static, so the incremental broadcast equals
    the reference's per-cycle rebuild. Returns fresh tensors."""
    if pick is None:
        best = torch.as_tensor(best).long()
        is_chosen = torch.arange(gd.spr_f_tv.shape[-1],
                                 device=gd.spr_f_tv.device) == best

        def pick(name):
            return getattr(gd, name)[..., best]
    fam = fam or ALL_FAMILIES
    u = int(tidx)
    gate_i = gate.to(_I32)
    spr_f_cnt, spr_s_cnt = gc.spr_f_cnt, gc.spr_s_cnt
    ipa_veto, ipa_a_cnt = gc.ipa_veto, gc.ipa_a_cnt
    ipa_a_total, ipa_aa_cnt = gc.ipa_a_total, gc.ipa_aa_cnt
    ipa_score = gc.ipa_score

    def same_tv(tv, tvb):
        return (tv == tvb[..., None]) & (tvb[..., None] != 0)

    if fam.spr_f:
        # +1 at every node sharing the chosen node's topology value, per
        # consumer constraint the placed pod matches, iff the chosen node
        # is count-eligible for that constraint
        tvb = pick("spr_f_tv")                          # [U, SC]
        eligb = pick("spr_f_elig")
        inc = (gd.m_spr_f[u] & eligb)[:, :, None] & same_tv(gd.spr_f_tv, tvb)
        spr_f_cnt = gc.spr_f_cnt + gate_i * inc.to(_I32)

    if fam.spr_s:
        # hostname constraints count the node's own pods; other keys share
        # by topology value
        tvb = pick("spr_s_tv")
        eligb = pick("spr_s_elig")
        share = torch.where(gd.spr_s_is_host[:, :, None],
                            is_chosen[None, None, :],
                            same_tv(gd.spr_s_tv, tvb))
        gate_c = torch.where(gd.spr_s_is_host, gd.m_spr_s[u],
                             gd.m_spr_s[u] & eligb)
        spr_s_cnt = gc.spr_s_cnt + gate_i * (gate_c[:, :, None]
                                             & share).to(_I32)

    if fam.ipa_anti:
        # existing-anti veto: the placed pod's own required anti terms add
        # a (term.key, tv(b)) pair for every consumer signature they match
        tvb_p = pick("ipa_raa_tv")[u]                   # [TAA]
        share_p = same_tv(gd.ipa_raa_tv[u], tvb_p)      # [TAA, N]
        delta = (gd.m_ipa_exist[u][:, :, None]
                 & share_p[None]).sum(dim=1).to(_I32)   # [U, N]
        ipa_veto = gc.ipa_veto + gate_i * delta
        # incoming-anti counts (per consumer term)
        tvb = pick("ipa_raa_tv")                        # [U, TAA]
        inc = gd.m_ipa_aa[u][:, :, None] & same_tv(gd.ipa_raa_tv, tvb)
        ipa_aa_cnt = gc.ipa_aa_cnt + gate_i * inc.to(_I32)

    if fam.ipa_req:
        # a placed pod matching ALL of a consumer's required terms bumps
        # each term's (key, tv(b)) pair
        tvb = pick("ipa_ra_tv")                         # [U, TA]
        inc = ((gd.m_ipa_a[u][:, None] & gd.ipa_ra_active)[:, :, None]
               & same_tv(gd.ipa_ra_tv, tvb))
        ipa_a_cnt = gc.ipa_a_cnt + gate_i * inc.to(_I32)
        ipa_a_total = gc.ipa_a_total + (
            gate_i * gd.m_ipa_a[u].to(_I32)
            * (gd.ipa_ra_active & (tvb != 0)).sum(dim=1)).to(_I64)

    if fam.ipa_score:
        # consumer-side preferred terms matching the placed pod, plus
        # placed-side (req×hardWeight + preferred) terms matching the
        # consumer (scoring.go:81-124)
        tvb_c = pick("ipa_stc_tv")                      # [U, CT]
        d_cons = (gd.w_stc[u][:, :, None]
                  * same_tv(gd.ipa_stc_tv, tvb_c)).sum(dim=1)     # [U, N]
        tvb_p = pick("ipa_stp_tv")[u]                   # [PT]
        share_p = same_tv(gd.ipa_stp_tv[u], tvb_p)      # [PT, N]
        d_plcd = (gd.w_stp[u][:, :, None] * share_p[None]).sum(dim=1)
        ipa_score = gc.ipa_score + gate.to(_I64) * (d_cons + d_plcd)

    return GroupCarry(spr_f_cnt=spr_f_cnt, spr_f_min_zero=gc.spr_f_min_zero,
                      spr_s_cnt=spr_s_cnt, ipa_veto=ipa_veto,
                      ipa_a_cnt=ipa_a_cnt, ipa_a_total=ipa_a_total,
                      ipa_aa_cnt=ipa_aa_cnt, ipa_score=ipa_score)


# host side: row parsing, match matrices, node data, seeding


@dataclass
class GroupRowInfo:
    """Host-parsed group constraints for one signature row."""

    pod: object                    # representative pod (signature-identical)
    f_constraints: list            # spread _Constraint, DoNotSchedule
    s_constraints: list            # spread _Constraint, ScheduleAnyway
    req_a: list                    # merged-ns ParsedTerm (incoming affinity)
    req_aa: list                   # merged-ns ParsedTerm (incoming anti)
    req_aa_raw: list               # raw ParsedTerm (existing-pod side)
    stc_terms: list                # [(ParsedTerm, ±weight)] consumer score terms
    stp_terms: list                # [(ParsedTerm, ±weight)] placed score terms
    self_all: bool

    @property
    def has_groups(self) -> bool:
        return bool(self.f_constraints or self.s_constraints or self.req_a
                    or self.req_aa or self.stc_terms or self.stp_terms)


class GroupManager:
    """Owns per-signature-row group data + pairwise match matrices (numpy).

    Parsing and matching REUSE the host plugins' code paths
    (podtopologyspread._parse_constraints / _count_pods_match_selector,
    interpodaffinity.parse_pod_affinity_terms / ParsedTerm.matches), so the
    device program's inputs are by construction the same quantities the host
    oracle computes."""

    def __init__(self, state, spread_plugin=None, ipa_plugin=None,
                 dims: Optional[GroupDims] = None, table_rows: int = 16):
        from ..plugins.interpodaffinity import InterPodAffinity
        from ..plugins.podtopologyspread import PodTopologySpread

        self.state = state
        self.pts = spread_plugin or PodTopologySpread()
        self.ipa = ipa_plugin or InterPodAffinity()
        self.dims = dims or GroupDims()
        self.rows: list[Optional[GroupRowInfo]] = []
        self._alloc(table_rows)
        self.group_row_count = 0   # rows with any group constraints
        # per-statics-generation columnar label views shared by node_data
        # and seed_counts (NodeLabelColumns below): the O(N) tv / dom /
        # presence walks run once per node-state change
        self.cols = NodeLabelColumns(state)

    # -- storage --------------------------------------------------------------

    def _alloc(self, U: int) -> None:
        d = self.dims
        self.U = U
        self.spr_f_active = np.zeros((U, d.spread_constraints), bool)
        self.spr_f_max_skew = np.zeros((U, d.spread_constraints), np.int32)
        self.spr_f_self = np.zeros((U, d.spread_constraints), np.int32)
        self.spr_s_active = np.zeros((U, d.spread_constraints), bool)
        self.spr_s_max_skew = np.zeros((U, d.spread_constraints), np.int32)
        self.spr_s_is_host = np.zeros((U, d.spread_constraints), bool)
        self.ipa_ra_active = np.zeros((U, d.ipa_req_terms), bool)
        self.ipa_raa_active = np.zeros((U, d.ipa_anti_terms), bool)
        self.ipa_self_all = np.zeros((U,), bool)
        self.m_spr_f = np.zeros((U, U, d.spread_constraints), bool)
        self.m_spr_s = np.zeros((U, U, d.spread_constraints), bool)
        self.m_ipa_a = np.zeros((U, U), bool)
        self.m_ipa_aa = np.zeros((U, U, d.ipa_anti_terms), bool)
        self.m_ipa_exist = np.zeros((U, U, d.ipa_anti_terms), bool)
        self.w_stc = np.zeros((U, U, d.ipa_cons_terms), np.int64)
        self.w_stp = np.zeros((U, U, d.ipa_plcd_terms), np.int64)
        # interaction graph: interacts[p, c] — placing a pod of row p can
        # move row c's group counts/scores (the build-time signature the
        # wave scheduler consults; state/batch.py BatchBuilder.wave_info)
        self.interacts = np.zeros((U, U), bool)

    # pairwise [U, U, ...] matrices vs per-row [U, ...] arrays: classified
    # by NAME, never by shape — a table_rows value that coincides with a
    # term dimension must not flip a per-row array into the pairwise path
    _PAIRWISE_FIELDS = frozenset(
        {"m_spr_f", "m_spr_s", "m_ipa_a", "m_ipa_aa", "m_ipa_exist",
         "w_stc", "w_stp"})
    _ROW_FIELDS = ("spr_f_active", "spr_f_max_skew", "spr_f_self",
                   "spr_s_active", "spr_s_max_skew", "spr_s_is_host",
                   "ipa_ra_active", "ipa_raa_active", "ipa_self_all")

    def grow(self, U: int) -> None:
        names = (self._ROW_FIELDS + tuple(self._PAIRWISE_FIELDS)
                 + ("interacts",))
        old = {name: getattr(self, name) for name in names}
        u0 = len(self.rows)
        self._alloc(U)
        for name, arr in old.items():
            new = getattr(self, name)
            if name in self._PAIRWISE_FIELDS or name == "interacts":
                new[:u0, :u0] = arr[:u0, :u0]
            else:
                new[:u0] = arr[:u0]

    def reset(self) -> None:
        self.rows.clear()
        self._alloc(self.U)
        self.group_row_count = 0

    # -- row addition ---------------------------------------------------------

    def add_row(self, u: int, pod) -> None:
        """Parse + store row u; raises BatchCapacityError when the pod's
        constraints exceed the padded dims (the row then has no device
        form)."""
        from ..api.types import UnsatisfiableConstraintAction as UCA
        from ..plugins.interpodaffinity import (
            WeightedTerm, _pod_matches_all_affinity_terms,
            parse_pod_affinity_terms)
        from ..state.batch import BatchCapacityError

        d = self.dims
        f_cons = self.pts._get_constraints(pod, UCA.DO_NOT_SCHEDULE.value)
        s_cons = self.pts._get_constraints(pod, UCA.SCHEDULE_ANYWAY.value)
        if (self.pts.system_defaulted
                and not pod.spec.topology_spread_constraints
                and (f_cons or s_cons)):
            # relaxed require_all semantics of system defaulting have no
            # tensor form (scoring.go requireAllTopologies=false)
            raise BatchCapacityError("system-defaulted spread: host path")
        if len(f_cons) > d.spread_constraints or len(s_cons) > d.spread_constraints:
            raise BatchCapacityError("too many spread constraints")

        req_a, req_aa_raw, pref_a, pref_aa = parse_pod_affinity_terms(pod)
        if self.ipa.args.ignore_preferred_terms_of_existing_pods and (
                req_a or req_aa_raw or pref_a or pref_aa):
            raise BatchCapacityError("ignorePreferredTermsOfExistingPods: host path")
        req_a_m = [self.ipa._merge_term_namespaces(t) for t in req_a]
        req_aa_m = [self.ipa._merge_term_namespaces(t) for t in req_aa_raw]
        if len(req_a_m) > d.ipa_req_terms or len(req_aa_m) > d.ipa_anti_terms:
            raise BatchCapacityError("too many inter-pod affinity terms")
        # consumer-side score terms: incoming pod's MERGED preferred terms
        stc = ([(WeightedTerm(self.ipa._merge_term_namespaces(w.term), w.weight).term,
                 w.weight) for w in pref_a]
               + [(self.ipa._merge_term_namespaces(w.term), -w.weight)
                  for w in pref_aa])
        # placed-side score terms: RAW required (× hard weight) + preferred
        hw = self.ipa.args.hard_pod_affinity_weight
        stp = ([(t, hw) for t in req_a] if hw > 0 else [])
        stp += [(w.term, w.weight) for w in pref_a]
        stp += [(w.term, -w.weight) for w in pref_aa]
        if len(stc) > d.ipa_cons_terms or len(stp) > d.ipa_plcd_terms:
            raise BatchCapacityError("too many preferred affinity terms")

        info = GroupRowInfo(
            pod=pod, f_constraints=f_cons, s_constraints=s_cons,
            req_a=req_a_m, req_aa=req_aa_m, req_aa_raw=req_aa_raw,
            stc_terms=stc, stp_terms=stp,
            self_all=_pod_matches_all_affinity_terms(req_a_m, pod))
        while len(self.rows) <= u:
            self.rows.append(None)
        self.rows[u] = info
        if info.has_groups:
            self.group_row_count += 1

        # per-row scalars
        for j, c in enumerate(f_cons):
            self.spr_f_active[u, j] = True
            self.spr_f_max_skew[u, j] = c.max_skew
            self.spr_f_self[u, j] = 1 if c.selector.matches(pod.metadata.labels) else 0
        for j, c in enumerate(s_cons):
            self.spr_s_active[u, j] = True
            self.spr_s_max_skew[u, j] = c.max_skew
            self.spr_s_is_host[u, j] = c.topology_key == LABEL_HOSTNAME
        for t in range(len(req_a_m)):
            self.ipa_ra_active[u, t] = True
        for t in range(len(req_aa_m)):
            self.ipa_raa_active[u, t] = True
        self.ipa_self_all[u] = info.self_all

        # pairwise match matrices vs every existing row (both directions)
        for v, other in enumerate(self.rows):
            if other is None:
                continue
            self._fill_pair(u, info, v, other)
            if v != u:
                self._fill_pair(v, other, u, info)

    def _fill_pair(self, pu: int, placed: GroupRowInfo,
                   cu: int, cons: GroupRowInfo) -> None:
        """[placed → consumer] match entries."""
        from ..plugins.interpodaffinity import _pod_matches_all_affinity_terms
        from ..plugins.podtopologyspread import (_count_pods_match_selector,
                                                 _selector_empty)

        ppod, cpod = placed.pod, cons.pod
        same_ns = ppod.namespace == cpod.namespace
        for j, c in enumerate(cons.f_constraints):
            self.m_spr_f[pu, cu, j] = (same_ns and not _selector_empty(c.selector)
                                       and c.selector.matches(ppod.metadata.labels))
        for j, c in enumerate(cons.s_constraints):
            self.m_spr_s[pu, cu, j] = (same_ns and not _selector_empty(c.selector)
                                       and c.selector.matches(ppod.metadata.labels))
        self.m_ipa_a[pu, cu] = _pod_matches_all_affinity_terms(cons.req_a, ppod)
        for t, term in enumerate(cons.req_aa):
            self.m_ipa_aa[pu, cu, t] = term.matches(ppod, None)
        ns_labels = self.ipa.ns_lister.labels_of(cpod.namespace)
        for t, term in enumerate(placed.req_aa_raw):
            self.m_ipa_exist[pu, cu, t] = term.matches(cpod, ns_labels)
        for t, (term, w) in enumerate(cons.stc_terms):
            self.w_stc[pu, cu, t] = w if term.matches(ppod, None) else 0
        for t, (term, w) in enumerate(placed.stp_terms):
            self.w_stp[pu, cu, t] = w if term.matches(cpod, ns_labels) else 0
        self.interacts[pu, cu] = bool(
            self.m_spr_f[pu, cu].any() or self.m_spr_s[pu, cu].any()
            or self.m_ipa_a[pu, cu] or self.m_ipa_aa[pu, cu].any()
            or self.m_ipa_exist[pu, cu].any()
            or self.w_stc[pu, cu].any() or self.w_stp[pu, cu].any())

    def any_groups(self) -> bool:
        return self.group_row_count > 0

    # -- node-dependent statics ----------------------------------------------

    def _node_rows(self, snapshot) -> list:
        """[(row index, NodeInfo)] for the snapshot's nodes — built once
        per build/scatter and shared between node_data and seed_counts
        (the 2×O(N) name-lookup walks used to run per call)."""
        st = self.state
        N = st.dims.nodes
        nis = [(st.node_index.get(ni.name), ni)
               for ni in snapshot.node_info_list]
        return [(idx, ni) for idx, ni in nis if idx is not None and idx < N]

    def node_data(self, snapshot, rows: range, nis=None):
        """tv / eligibility / domain arrays for the given row slice against
        the CURRENT node set, laid out in ClusterState row order. Returns a
        dict of numpy arrays shaped like the matching GroupsDev fields but
        with a leading axis of len(rows)."""
        from ..plugins.node_basics import find_matching_untolerated_taint
        from ..plugins.nodeaffinity import required_node_affinity_matches
        from ..plugins.podtopologyspread import HONOR

        d = self.dims
        st = self.state
        N = st.dims.nodes
        SC, TA, TAA = d.spread_constraints, d.ipa_req_terms, d.ipa_anti_terms
        CT, PT = d.ipa_cons_terms, d.ipa_plcd_terms
        R = len(rows)
        out = dict(
            spr_f_tv=np.zeros((R, SC, N), np.int32),
            spr_f_elig=np.zeros((R, SC, N), bool),
            spr_f_dom=np.zeros((R, SC, N), np.int32),
            spr_s_tv=np.zeros((R, SC, N), np.int32),
            spr_s_elig=np.zeros((R, SC, N), bool),
            spr_s_keys_ok=np.zeros((R, N), bool),
            spr_s_dom=np.zeros((R, SC, N), np.int32),
            ipa_ra_tv=np.zeros((R, TA, N), np.int32),
            ipa_ra_dom=np.zeros((R, TA, N), np.int32),
            ipa_raa_tv=np.zeros((R, TAA, N), np.int32),
            ipa_raa_dom=np.zeros((R, TAA, N), np.int32),
            ipa_stc_tv=np.zeros((R, CT, N), np.int32),
            ipa_stc_dom=np.zeros((R, CT, N), np.int32),
            ipa_stp_tv=np.zeros((R, PT, N), np.int32),
            ipa_stp_dom=np.zeros((R, PT, N), np.int32),
        )
        if nis is None:
            nis = self._node_rows(snapshot)
        # persistent per-statics-generation columns: a topology key's
        # interned tv vector is a property of the node set, not of the row
        # or the call — the O(N) label walk runs once per node-state
        # change, and every row/constraint/term shares it
        cols = self.cols.sync(nis)
        tv_vec = cols.tv
        dom_of_key = cols.dom

        def keys_ok_vec(keys: list[str]) -> np.ndarray:
            return cols.keys_ok(tuple(keys))

        def elig_vec(c, pod, keys: list[str]) -> np.ndarray:
            """Count-eligibility per node (common.go:43-57). The common
            case — no required node affinity on the pod, taints policy
            Ignore — is pure vector math; only HONOR policies walk nodes."""
            ok = keys_ok_vec(keys)
            trivial_affinity = (
                c.node_affinity_policy != HONOR
                or (not pod.spec.node_selector
                    and not (pod.spec.affinity
                             and pod.spec.affinity.node_affinity
                             and pod.spec.affinity.node_affinity.required)))
            if trivial_affinity and c.node_taints_policy != HONOR:
                return ok
            ok = ok.copy()   # keys_ok vectors are cached: never mutate
            for idx, ni in nis:
                if not ok[idx]:
                    continue
                labels = ni.node.metadata.labels
                good = True
                if c.node_affinity_policy == HONOR and not trivial_affinity:
                    good = required_node_affinity_matches(pod, labels,
                                                          ni.name)
                if good and c.node_taints_policy == HONOR:
                    good = find_matching_untolerated_taint(
                        ni.node.spec.taints, pod.spec.tolerations,
                        ("NoSchedule", "NoExecute")) is None
                ok[idx] = good
            return ok

        for r, u in enumerate(rows):
            info = self.rows[u] if u < len(self.rows) else None
            if info is None:
                continue
            pod = info.pod
            # spread filter
            if info.f_constraints:
                keys = [c.topology_key for c in info.f_constraints]
                for j, c in enumerate(info.f_constraints):
                    out["spr_f_tv"][r, j] = tv_vec(c.topology_key)
                    out["spr_f_dom"][r, j] = dom_of_key(c.topology_key)
                    out["spr_f_elig"][r, j] = elig_vec(c, pod, keys)
            # spread score
            if info.s_constraints:
                keys = [c.topology_key for c in info.s_constraints]
                out["spr_s_keys_ok"][r] = keys_ok_vec(keys)
                for j, c in enumerate(info.s_constraints):
                    out["spr_s_tv"][r, j] = tv_vec(c.topology_key)
                    out["spr_s_dom"][r, j] = dom_of_key(c.topology_key)
                    out["spr_s_elig"][r, j] = elig_vec(c, pod, keys)
            # inter-pod affinity term topology values
            for t, term in enumerate(info.req_a):
                out["ipa_ra_tv"][r, t] = tv_vec(term.topology_key)
                out["ipa_ra_dom"][r, t] = dom_of_key(term.topology_key)
            for t, term in enumerate(info.req_aa):
                out["ipa_raa_tv"][r, t] = tv_vec(term.topology_key)
                out["ipa_raa_dom"][r, t] = dom_of_key(term.topology_key)
            for t, (term, _w) in enumerate(info.stc_terms):
                out["ipa_stc_tv"][r, t] = tv_vec(term.topology_key)
                out["ipa_stc_dom"][r, t] = dom_of_key(term.topology_key)
            for t, (term, _w) in enumerate(info.stp_terms):
                out["ipa_stp_tv"][r, t] = tv_vec(term.topology_key)
                out["ipa_stp_dom"][r, t] = dom_of_key(term.topology_key)
        return out

    # -- count seeding --------------------------------------------------------

    def seed_counts(self, snapshot, rows: range, nis=None):
        """Count arrays for the given rows from the LIVE snapshot, computed
        by running the host plugins' PreFilter/PreScore on the representative
        pod — the device then carries these forward incrementally."""
        from ..framework.interface import CycleState
        from ..plugins import interpodaffinity as ipa_mod
        from ..plugins import podtopologyspread as pts_mod

        d = self.dims
        st = self.state
        N = st.dims.nodes
        SC, TA, TAA = d.spread_constraints, d.ipa_req_terms, d.ipa_anti_terms
        R = len(rows)
        out = dict(
            spr_f_cnt=np.zeros((R, SC, N), np.int32),
            spr_f_min_zero=np.zeros((R, SC), bool),
            spr_s_cnt=np.zeros((R, SC, N), np.int32),
            ipa_veto=np.zeros((R, N), np.int32),
            ipa_a_cnt=np.zeros((R, TA, N), np.int32),
            ipa_a_total=np.zeros((R,), np.int64),
            ipa_aa_cnt=np.zeros((R, TAA, N), np.int32),
            ipa_score=np.zeros((R, N), np.int64),
        )
        node_list = snapshot.node_info_list
        if nis is None:
            nis = self._node_rows(snapshot)
        # the count surfaces are still computed by the host plugins' own
        # PreFilter/PreScore (shared-code parity contract, class doc) —
        # but the per-NODE scatter of every count map now rides the
        # columnar label store: one sorted-search gather over interned
        # topology-value ids per (row, constraint/term) instead of an
        # O(nodes) Python dict-probe walk per signature
        cols = self.cols.sync(nis)

        for r, u in enumerate(rows):
            info = self.rows[u] if u < len(self.rows) else None
            if info is None:
                continue
            pod = info.pod
            # spread DoNotSchedule counts via the plugin's own PreFilter
            if info.f_constraints:
                cs = CycleState()
                self.pts.pre_filter(cs, pod, node_list)
                s = cs.read_or_none(pts_mod._PRE_FILTER_KEY)
                if s is not None:
                    for j, c in enumerate(s.constraints):
                        cnts = s.tp_value_to_match_num[j]
                        out["spr_f_min_zero"][r, j] = len(cnts) < c.min_domains
                        if not any(cnts.values()):
                            continue    # all-zero seed: the array is zeros
                        out["spr_f_cnt"][r, j] = gather_ids(
                            cols.tv(c.topology_key),
                            cols.value_ids(c.topology_key, cnts), np.int32)
            # spread ScheduleAnyway counts: hostname keys per node, others
            # accumulated per topology value over count-eligible nodes
            for j, c in enumerate(info.s_constraints):
                if c.topology_key == LABEL_HOSTNAME:
                    for idx, ni in nis:
                        out["spr_s_cnt"][r, j, idx] = \
                            pts_mod._count_pods_match_selector(
                                ni.pods, c.selector, pod.namespace)
                    continue
                keys = [cc.topology_key for cc in info.s_constraints]
                by_tv: dict[str, int] = {}
                for idx, ni in nis:
                    labels = ni.node.metadata.labels
                    if not all(k in labels for k in keys):
                        continue
                    if not pts_mod._match_node_inclusion_policies(c, pod, ni):
                        continue
                    v = labels[c.topology_key]
                    by_tv[v] = by_tv.get(v, 0) + \
                        pts_mod._count_pods_match_selector(
                            ni.pods, c.selector, pod.namespace)
                if not any(by_tv.values()):
                    continue
                out["spr_s_cnt"][r, j] = gather_ids(
                    cols.tv(c.topology_key),
                    cols.value_ids(c.topology_key, by_tv), np.int32)
            # inter-pod affinity maps via the plugin's PreFilter. Empty
            # count maps (the common fresh-workload case) skip their
            # gathers outright — the arrays are zeros.
            cs = CycleState()
            self.ipa.pre_filter(cs, pod, node_list)
            s = cs.read_or_none(ipa_mod._PRE_FILTER_KEY)
            if s is not None:
                out["ipa_a_total"][r] = sum(s.affinity_counts.values())
                if s.existing_anti_affinity_counts:
                    # counts keyed (label key, value): a node contributes
                    # each (k, v) it carries — per distinct k, one gather
                    by_key: dict = {}
                    for (lk, lv), c0 in \
                            s.existing_anti_affinity_counts.items():
                        by_key.setdefault(lk, {})[lv] = c0
                    veto = out["ipa_veto"][r]
                    for lk, vals in by_key.items():
                        veto += gather_ids(cols.tv(lk),
                                           cols.value_ids(lk, vals),
                                           np.int32)
                if s.affinity_counts:
                    by_key = {}
                    for (tk, tv), c0 in s.affinity_counts.items():
                        by_key.setdefault(tk, {})[tv] = c0
                    for t, term in enumerate(info.req_a):
                        vals = by_key.get(term.topology_key)
                        if vals:
                            out["ipa_a_cnt"][r, t] = gather_ids(
                                cols.tv(term.topology_key),
                                cols.value_ids(term.topology_key, vals),
                                np.int32)
                if s.anti_affinity_counts:
                    by_key = {}
                    for (tk, tv), c0 in s.anti_affinity_counts.items():
                        by_key.setdefault(tk, {})[tv] = c0
                    for t, term in enumerate(info.req_aa):
                        vals = by_key.get(term.topology_key)
                        if vals:
                            out["ipa_aa_cnt"][r, t] = gather_ids(
                                cols.tv(term.topology_key),
                                cols.value_ids(term.topology_key, vals),
                                np.int32)
            # symmetric score surface via the plugin's PreScore
            cs = CycleState()
            self.ipa.pre_score(cs, pod, node_list, all_nodes=node_list)
            ps = cs.read_or_none(ipa_mod._PRE_SCORE_KEY)
            if ps is not None and ps.topology_score:
                score = out["ipa_score"][r]
                for tk, tv_scores in ps.topology_score.items():
                    score += gather_ids(cols.tv(tk),
                                        cols.value_ids(tk, tv_scores),
                                        np.int64)
        return out

    # -- assembly -------------------------------------------------------------

    def families(self, snapshot) -> GroupFamilies:
        """Host-side activation analysis (no device readbacks): a family is
        active when some signature row carries it, or — for the symmetric
        inter-pod families — when existing cluster pods seed its counts."""
        return GroupFamilies(
            spr_f=bool(self.spr_f_active.any()),
            spr_s=bool(self.spr_s_active.any()),
            ipa_req=bool(self.ipa_ra_active.any()),
            ipa_anti=bool(
                self.ipa_raa_active.any() or self.m_ipa_exist.any()
                or snapshot.have_pods_with_required_anti_affinity_list),
            ipa_score=bool(
                self.w_stc.any() or self.w_stp.any()
                or snapshot.have_pods_with_affinity_list
                or snapshot.have_pods_with_required_anti_affinity_list),
        )

    def device_rows(self) -> int:
        """Row-axis size of the DEVICE group tensors: the padded count of
        rows that actually exist, not the table's full padded capacity —
        a one-signature spread workload ships [2, SC, N] tensors instead
        of [16, SC, N], cutting every per-step group op by the same
        factor. Crossing a pow2 boundary changes the capacity key, which
        triggers a full reseed (the scheduler's _gd_capacity check)."""
        from ..state.tensorize import pow2_at_least
        return min(pow2_at_least(max(len(self.rows), 1), 2), self.U)

    def build_dev(self, snapshot) -> "tuple[GroupsDev, GroupCarry]":
        """Full (GroupsDev, GroupCarry) numpy build for all rows."""
        rows = range(len(self.rows))
        nis = self._node_rows(snapshot)
        nd = self.node_data(snapshot, rows, nis=nis)
        seeds = self.seed_counts(snapshot, rows, nis=nis)
        U, N = self.device_rows(), self.state.dims.nodes
        d = self.dims

        def full(name, shape, dtype):
            arr = np.zeros(shape, dtype)
            src = nd.get(name) if name in nd else seeds.get(name)
            arr[:src.shape[0]] = src
            return arr

        # host-owned per-row / pairwise fields slice via the SAME field
        # lists grow() and scatter_new_rows use — one classification source
        sliced = {name: getattr(self, name)[:U].copy()
                  for name in self._ROW_FIELDS}
        sliced.update({name: getattr(self, name)[:U, :U].copy()
                       for name in self._PAIRWISE_FIELDS})
        gd = GroupsDev(
            spr_f_tv=full("spr_f_tv", (U, d.spread_constraints, N), np.int32),
            spr_f_elig=full("spr_f_elig", (U, d.spread_constraints, N), bool),
            spr_f_dom=full("spr_f_dom", (U, d.spread_constraints, N), np.int32),
            spr_s_tv=full("spr_s_tv", (U, d.spread_constraints, N), np.int32),
            spr_s_elig=full("spr_s_elig", (U, d.spread_constraints, N), bool),
            spr_s_keys_ok=full("spr_s_keys_ok", (U, N), bool),
            spr_s_dom=full("spr_s_dom", (U, d.spread_constraints, N), np.int32),
            ipa_ra_tv=full("ipa_ra_tv", (U, d.ipa_req_terms, N), np.int32),
            ipa_ra_dom=full("ipa_ra_dom", (U, d.ipa_req_terms, N), np.int32),
            ipa_raa_tv=full("ipa_raa_tv", (U, d.ipa_anti_terms, N), np.int32),
            ipa_raa_dom=full("ipa_raa_dom", (U, d.ipa_anti_terms, N), np.int32),
            ipa_stc_tv=full("ipa_stc_tv", (U, d.ipa_cons_terms, N), np.int32),
            ipa_stc_dom=full("ipa_stc_dom", (U, d.ipa_cons_terms, N), np.int32),
            ipa_stp_tv=full("ipa_stp_tv", (U, d.ipa_plcd_terms, N), np.int32),
            ipa_stp_dom=full("ipa_stp_dom", (U, d.ipa_plcd_terms, N), np.int32),
            **sliced,
        )
        gc = GroupCarry(
            spr_f_cnt=full("spr_f_cnt", (U, d.spread_constraints, N), np.int32),
            spr_f_min_zero=full("spr_f_min_zero", (U, d.spread_constraints), bool),
            spr_s_cnt=full("spr_s_cnt", (U, d.spread_constraints, N), np.int32),
            ipa_veto=full("ipa_veto", (U, N), np.int32),
            ipa_a_cnt=full("ipa_a_cnt", (U, d.ipa_req_terms, N), np.int32),
            ipa_a_total=full("ipa_a_total", (U,), np.int64),
            ipa_aa_cnt=full("ipa_aa_cnt", (U, d.ipa_anti_terms, N), np.int32),
            ipa_score=full("ipa_score", (U, N), np.int64),
        )
        return gd, gc


_GD_DTYPES = {np.dtype(bool): torch.bool, np.dtype(np.int32): _I32,
              np.dtype(np.int64): _I64}


def to_device(tree, device):
    """numpy → torch leaves of a GroupsDev / GroupCarry on `device`, each
    keeping its numpy dtype (bool, i32, i64)."""
    return type(tree)(*(
        torch.from_numpy(np.ascontiguousarray(x)).to(
            device=device, dtype=_GD_DTYPES[np.asarray(x).dtype])
        for x in tree))


def scatter_new_rows(gd_dev: GroupsDev, gc_dev: GroupCarry,
                     mgr: GroupManager, snapshot, lo: int, hi: int,
                     mesh=None):
    """Seed rows [lo, hi) into resident device group state: node-dependent
    tensors and counts go into the row slice; the small per-row scalars and
    pairwise matrices (which gained entries against OLD rows too) are
    re-uploaded whole. Returns fresh tensors: in-flight drains may still
    hold the previous ones. With `mesh`, `gd_dev` / `gc_dev` are the
    shards of shard_groups / shard_group_carry: each shard receives its
    slice of the new rows' node-last fields, written in place of the row
    slice, and the replicated fields whole (the JAX package's
    scatter_new_rows(mesh=…), kubernetes_tpu/ops/groups.py:1137-1182).
    Returns the shards then."""
    rows = range(lo, hi)
    first = gd_dev[0] if mesh is not None else gd_dev
    U = first.spr_f_active.shape[0]   # device row axis (compact, pow2)
    nis = mgr._node_rows(snapshot)
    nd = mgr.node_data(snapshot, rows, nis=nis)
    seeds = mgr.seed_counts(snapshot, rows, nis=nis)
    if mesh is None:
        return _scatter_rows_into(gd_dev, gc_dev, mgr, nd, seeds, lo, hi, U,
                                  slice(None))
    from ..parallel.sharding import Shards
    n_local = first.spr_f_tv.shape[-1]
    out = [_scatter_rows_into(g, c, mgr, nd, seeds, lo, hi, U,
                              slice(d * n_local, (d + 1) * n_local))
           for d, (g, c) in enumerate(zip(gd_dev, gc_dev))]
    return Shards(g for g, _ in out), Shards(c for _, c in out)


def _scatter_rows_into(gd_dev, gc_dev, mgr, nd: dict, seeds: dict, lo: int,
                       hi: int, U: int, nodes: slice):
    """One device's (or shard's) part of scatter_new_rows: `nodes` is the
    node slice of the node-last fields it holds."""
    device = gd_dev.spr_f_active.device

    def put_rows(old, new, name):
        out = old.clone()
        part = new if name in _ROW_SEEDS else new[..., nodes]
        out[lo:hi] = torch.from_numpy(np.ascontiguousarray(part)).to(
            device=device, dtype=old.dtype)
        return out

    def whole(arr, like):
        return torch.from_numpy(np.ascontiguousarray(arr)).to(
            device=device, dtype=like.dtype)

    gd_kw = {name: put_rows(getattr(gd_dev, name), nd[name], name)
             for name in nd}
    for name in GroupManager._ROW_FIELDS:
        gd_kw[name] = whole(getattr(mgr, name)[:U], getattr(gd_dev, name))
    for name in GroupManager._PAIRWISE_FIELDS:
        gd_kw[name] = whole(getattr(mgr, name)[:U, :U],
                            getattr(gd_dev, name))
    gc_kw = {name: put_rows(getattr(gc_dev, name), seeds[name], name)
             for name in seeds}
    return gd_dev._replace(**gd_kw), gc_dev._replace(**gc_kw)


# the seeded count fields without a node axis (replicated on the mesh)
_ROW_SEEDS = frozenset({"spr_f_min_zero", "ipa_a_total"})


# ---------------------------------------------------------------------------
# wave fold: batch-apply a wave's accepted placements to the FULL carry
# (ops/program.py run_wave). Every group_update increment is a pure gated
# ADD, so the per-placement updates commute — the whole wave folds into
# the carry with one scatter/gather pass per family.


def _dom_seg(tv, dom, w, n_seg=None):
    """The domain segment sums of _dom_share: seg[..., d] = Σ w[m] over
    the rows m with tv ≠ 0 and dense domain id d → w's dtype [..., n_seg]
    (n_seg defaults to the row count). On a node shard the ids are global
    and n_seg the global node count: the shard's part of the segments the
    JAX package psums (:1185-1213)."""
    w = w.expand(tv.shape) if w.shape != tv.shape else w
    lead = tv.shape[:-1]
    n = tv.shape[-1]
    w2 = w.reshape(-1, n)
    has = tv.reshape(-1, n) != 0
    seg = torch.zeros((w2.shape[0], n_seg or n), dtype=w2.dtype,
                      device=w2.device)
    seg.scatter_add_(1, dom.reshape(-1, n).long(),
                     torch.where(has, w2, torch.zeros_like(w2)))
    return seg.reshape(*lead, n_seg or n)


def _dom_share(tv, dom, w, n_seg=None, seg_sum=None):
    """Σ_m w[m] over nodes m sharing n's topology value (tv ≠ 0 both
    sides), via the dense domain ids. tv/dom: int [..., N]; w: int
    [..., N] (broadcastable); returns w's dtype [..., N]. On a node shard,
    `seg_sum` maps the shard's _dom_seg (width `n_seg`) to the summed
    segments of all shards."""
    lead = tv.shape[:-1]
    n = tv.shape[-1]
    seg = _dom_seg(tv, dom, w, n_seg)
    if seg_sum is not None:
        seg = seg_sum(seg)
    seg2 = seg.reshape(-1, seg.shape[-1])
    tv2 = tv.reshape(-1, n)
    got = torch.gather(seg2, 1, dom.reshape(-1, n).long())
    out = torch.where(tv2 != 0, got, torch.zeros_like(got))
    return out.reshape(*lead, n)


def wave_fold(gd: GroupsDev, gc: GroupCarry, wt, cnt_sn,
              fam: Optional[GroupFamilies] = None, n_seg=None,
              seg_sum=None) -> GroupCarry:
    """GroupCarry after a wave: `wt` (sequence of int) are the wave's table
    rows and `cnt_sn` i32 [S, N] the accepted placement counts of each
    wave row per node. Exactly equals folding the placements through
    group_update one by one, in any order (additivity; node labels
    static). The JAX einsums are written as broadcast products summed over
    the wave axis (integer einsum has no CUDA matmul). On a node shard
    (the JAX package's `axis`, :1215-1311) `n_seg` is the global node
    count and `seg_sum` maps each of the shard's partial sums, in call
    order — every _dom_seg and the a_total add — to the sum over all
    shards."""
    def share(tv, dom, w):
        return _dom_share(tv, dom, w, n_seg, seg_sum)

    fam = fam or ALL_FAMILIES
    wt = torch.as_tensor(list(wt), dtype=torch.long, device=cnt_sn.device)
    spr_f_cnt, spr_s_cnt = gc.spr_f_cnt, gc.spr_s_cnt
    ipa_veto, ipa_a_cnt = gc.ipa_veto, gc.ipa_a_cnt
    ipa_a_total, ipa_aa_cnt = gc.ipa_a_total, gc.ipa_aa_cnt
    ipa_score = gc.ipa_score
    cnt32 = cnt_sn.to(_I32)
    cnt64 = cnt_sn.to(_I64)

    def per_consumer(m, cnt):
        # Σ_s m[s, u, t] · cnt[s, n] → [U, T, N]
        return (m.to(cnt.dtype)[:, :, :, None]
                * cnt[:, None, None, :]).sum(dim=0).to(cnt.dtype)

    if fam.spr_f:
        w_ucn = per_consumer(gd.m_spr_f[wt], cnt32)
        spr_f_cnt = gc.spr_f_cnt + share(
            gd.spr_f_tv, gd.spr_f_dom, w_ucn * gd.spr_f_elig)

    if fam.spr_s:
        w_ucn = per_consumer(gd.m_spr_s[wt], cnt32)
        topo = share(gd.spr_s_tv, gd.spr_s_dom, w_ucn * gd.spr_s_elig)
        # hostname constraints count the chosen node's own pods, no
        # eligibility gate (group_update's is_host branch)
        spr_s_cnt = gc.spr_s_cnt + torch.where(
            gd.spr_s_is_host[:, :, None], w_ucn, topo)

    if fam.ipa_anti:
        # existing-anti veto: shared along the PLACED row's term topology
        raa_tv_w = gd.ipa_raa_tv[wt]                    # [S, TAA, N]
        shared_st = share(raa_tv_w, gd.ipa_raa_dom[wt], cnt32[:, None, :])
        ipa_veto = gc.ipa_veto + (
            gd.m_ipa_exist[wt].to(_I32)[:, :, :, None]
            * shared_st[:, None, :, :]).sum(dim=(0, 2)).to(_I32)
        # incoming-anti counts: shared along the CONSUMER's term topology
        w_utn = per_consumer(gd.m_ipa_aa[wt], cnt32)
        ipa_aa_cnt = gc.ipa_aa_cnt + share(
            gd.ipa_raa_tv, gd.ipa_raa_dom, w_utn)

    if fam.ipa_req:
        w_un = (gd.m_ipa_a[wt].to(_I32)[:, :, None]
                * cnt32[:, None, :]).sum(dim=0).to(_I32)          # [U, N]
        ipa_a_cnt = gc.ipa_a_cnt + share(
            gd.ipa_ra_tv, gd.ipa_ra_dom,
            w_un[:, None, :] * gd.ipa_ra_active[:, :, None])
        # a_total: each placement adds (# active consumer terms whose
        # topology key exists on the placed node) when it matches all of
        # the consumer's terms (group_update's tvb_a != 0 gate)
        k_un = (gd.ipa_ra_active[:, :, None]
                & (gd.ipa_ra_tv != 0)).sum(dim=1)                 # [U, N]
        a_add = (w_un.to(_I64) * k_un).sum(dim=1)
        if seg_sum is not None:
            a_add = seg_sum(a_add)
        ipa_a_total = gc.ipa_a_total + a_add

    if fam.ipa_score:
        # consumer-side preferred terms matching the placed pod
        wc_utn = per_consumer(gd.w_stc[wt], cnt64)
        cons_add = share(gd.ipa_stc_tv, gd.ipa_stc_dom,
                         wc_utn).sum(dim=1)                       # [U, N]
        # placed-side terms: share counts along the placed row's term
        # topology, then weight per consumer
        stp_tv_w = gd.ipa_stp_tv[wt]                    # [S, PT, N]
        shared_p = share(stp_tv_w, gd.ipa_stp_dom[wt], cnt64[:, None, :])
        plcd_add = (gd.w_stp[wt][:, :, :, None]
                    * shared_p[:, None, :, :]).sum(dim=(0, 2))
        ipa_score = gc.ipa_score + cons_add + plcd_add

    return GroupCarry(spr_f_cnt=spr_f_cnt, spr_f_min_zero=gc.spr_f_min_zero,
                      spr_s_cnt=spr_s_cnt, ipa_veto=ipa_veto,
                      ipa_a_cnt=ipa_a_cnt, ipa_a_total=ipa_a_total,
                      ipa_aa_cnt=ipa_aa_cnt, ipa_score=ipa_score)
