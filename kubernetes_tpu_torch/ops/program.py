"""The device program: per-pod scan, closed-form uniform run, group waves,
the multi-signature plan program and the mask diagnosis.

PyTorch counterpart of kubernetes_tpu/ops/program.py. Every device
program here has two implementations:

- a plain PyTorch version (`_run_batch_plain`, `_run_uniform_plain`,
  `_wave_statics_plain`, `_run_wave_plain`, `_run_plan_plain`,
  `_diagnose_plain`, `_dry_run_select_victims_plain`,
  `_dry_run_subset_plain`,
  `_scatter_rows_plain`, `_score_probe_plain` and the filter/score
  functions below), a line-for-line translation of the JAX
  functions with the same dtypes and the same integer and float
  arithmetic — the CPU path and the reference the CUDA kernels are held
  to;
- a hand-written CUDA kernel (ops/kernels.py, csrc/), launched when the
  inputs lie on a CUDA device.

`run_batch`, `run_uniform`, `wave_statics`, `run_wave`, `run_plan`,
`diagnose_row`, `dry_run_select_victims` (and its subset entry
`dry_run_select_victims_subset`), `scatter_rows`,
`explain_row`, `cluster_probe` and `score_probe` pick by the device of
their inputs: CPU
tensors take the plain version, CUDA tensors launch the kernel, and
anything else raises. There is no fallback between the two.

Translation notes (where a naive port diverges from the JAX program):
- int64 / int64 in torch is float32; every ratio casts to float64 first
  (JAX x64 true division is float64);
- `//` on torch integers floors, like jnp's;
- the BalancedAllocation sums run left to right over the score columns
  (the order XLA and numpy use for these short rows), and the squares are
  written `d * d`;
- top-k: keys fold the node index in, so ties resolve to the lowest
  index exactly like `lax.top_k`;
- count scatters with duplicate indices use `index_add`;
- int64 arithmetic wraps like XLA's (the inter-pod score range over an
  empty feasible set), and only masked-out nodes ever see a wrapped value.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .groups import group_mask, group_scores, group_update
# sanitizer rails (analysis/rails.py, `SanitizerRails` gate): with the
# rails on, every entry stages the host arrays among its inputs (pinned,
# non-blocking copies, the declared way host values reach the card), and
# score_probe / cluster_probe report their float outputs to nan_guard
from ..analysis.rails import GLOBAL as RAILS
from ..plugins.imagelocality import (MAX_CONTAINER_THRESHOLD as
                                     IMG_MAX_CONTAINER_THRESHOLD,
                                     MIN_THRESHOLD as IMG_MIN_THRESHOLD)
from ..state.batch import (OP_DOES_NOT_EXIST, OP_EXISTS, OP_GT, OP_IN,
                           OP_LT, OP_NOT_IN, TOL_EXISTS)
from ..state.tensorize import (EFFECT_NO_EXECUTE, EFFECT_NO_SCHEDULE,
                               EFFECT_PREFER_NO_SCHEDULE, NodeArrays)

MAX_SCORE = 100
I64_MIN = -(2 ** 63)

_I64, _I32 = torch.int64, torch.int32


class ScoreConfig(NamedTuple):
    """Static per-profile scoring configuration."""

    score_cols: tuple[int, ...] = (0, 1)        # resource columns to score
    col_weights: tuple[int, ...] = (1, 1)       # per-column weights
    col_nonzero: tuple[bool, ...] = (True, True)  # use NonZeroRequested path
    nonzero_slot: tuple[int, ...] = (0, 1)      # index into nonzero arrays
    w_fit: int = 1
    w_balanced: int = 1
    w_taint: int = 3
    w_node_affinity: int = 2
    w_spread: int = 2                           # PodTopologySpread weight
    w_ipa: int = 2                              # InterPodAffinity weight
    w_image: int = 1                            # ImageLocality weight
    strategy: str = "LeastAllocated"            # or MostAllocated


class SigCache(NamedTuple):
    """Per-signature cached evaluation: consecutive pods with an identical
    device row reuse the carry-independent kernels; only the row touched by
    the previous placement is recomputed. sig 0 never matches."""

    sig: torch.Tensor          # i32 scalar
    static_mask: torch.Tensor  # bool [N]
    taint_raw: torch.Tensor    # i64 [N]
    na_raw: torch.Tensor       # i64 [N]
    s_img: torch.Tensor        # i64 [N]
    fit_ok: torch.Tensor       # bool [N]
    s_fit: torch.Tensor        # i64 [N]
    s_bal: torch.Tensor        # i64 [N]


class Carry(NamedTuple):
    used: torch.Tensor          # i64 [N, R]
    nonzero_used: torch.Tensor  # i64 [N, 2]
    npods: torch.Tensor         # i32 [N]
    ports: torch.Tensor         # i32 [N, P]
    cache: SigCache
    # PodTopologySpread / InterPodAffinity counts (ops/groups.py
    # GroupCarry), None when neither the batch nor the cluster carries
    # group constraints
    groups: object = None


class PodTableDev(NamedTuple):
    """Device copy of state.batch.PodTable ([U, ...], U = distinct sigs)."""

    req: torch.Tensor
    nonzero_req: torch.Tensor
    node_name_id: torch.Tensor
    tol_key: torch.Tensor
    tol_val: torch.Tensor
    tol_eff: torch.Tensor
    tol_op: torch.Tensor
    tolerates_unsched: torch.Tensor
    ns_sel_val: torch.Tensor
    aff_has: torch.Tensor
    aff_term_valid: torch.Tensor
    aff_key: torch.Tensor
    aff_op: torch.Tensor
    aff_num: torch.Tensor
    aff_val: torch.Tensor
    pref_weight: torch.Tensor
    pref_key: torch.Tensor
    pref_op: torch.Tensor
    pref_num: torch.Tensor
    pref_val: torch.Tensor
    port_ids: torch.Tensor
    skip_balanced: torch.Tensor
    img_ids: torch.Tensor
    img_containers: torch.Tensor


class PodXs(NamedTuple):
    """Per-pod scan inputs: bool/i32 [B] tensors for `run_batch`; Python
    scalars (the run's one row) for `run_uniform`. `nom_idx` (i32 [B],
    -1 = none; None when no pod of the span is nominated) is the node row
    of each pod's OWN nomination: under a nominated-pod overlay the scan
    subtracts the pod's own contribution there (self-exclusion) and
    consumes it when the pod binds."""

    valid: object
    sig: object
    tidx: object
    nom_idx: object = None


class PodRow(NamedTuple):
    """One pod's view inside a step: table row + per-pod scalars."""

    valid: bool
    sig: int
    req: torch.Tensor
    nonzero_req: torch.Tensor
    node_name_id: torch.Tensor
    tol_key: torch.Tensor
    tol_val: torch.Tensor
    tol_eff: torch.Tensor
    tol_op: torch.Tensor
    tolerates_unsched: torch.Tensor
    ns_sel_val: torch.Tensor
    aff_has: torch.Tensor
    aff_term_valid: torch.Tensor
    aff_key: torch.Tensor
    aff_op: torch.Tensor
    aff_num: torch.Tensor
    aff_val: torch.Tensor
    pref_weight: torch.Tensor
    pref_key: torch.Tensor
    pref_op: torch.Tensor
    pref_num: torch.Tensor
    pref_val: torch.Tensor
    port_ids: torch.Tensor
    skip_balanced: torch.Tensor
    img_ids: torch.Tensor
    img_containers: torch.Tensor
    nom_idx: object = None     # int, the pod's own nominated row (-1 none)


def _gather_row(table: PodTableDev, tidx: int, valid: bool,
                sig: int, nom_idx=None) -> PodRow:
    fields = {name: getattr(table, name)[tidx]
              for name in PodTableDev._fields}
    return PodRow(valid=bool(valid), sig=int(sig), nom_idx=nom_idx,
                  **fields)


def table_from_batch(batch, device) -> PodTableDev:
    """PodBatch → device signature table."""
    from ..state.convert import pod_table_from_numpy
    return pod_table_from_numpy(batch.table, device)


# ---------------------------------------------------------------------------
# filter functions (full node axis)


def fit_mask(cap, used, npods, allowed_pods, req):
    pods_ok = npods + 1 <= allowed_pods
    cols_ok = ((req[None, :] == 0) | (used + req[None, :] <= cap)).all(dim=1)
    return pods_ok & cols_ok


def tolerates(tol_key, tol_val, tol_eff, tol_op, taint_key, taint_val,
              taint_eff):
    """[N, T] taints × [TT] tolerations → bool [N, T, TT]: does toleration
    tt cover taint t. Empty toleration key (0) matches all keys; empty
    effect (0) matches all effects; Exists ignores the value."""
    tk, tv, te = taint_key[..., None], taint_val[..., None], taint_eff[..., None]
    key_ok = (tol_key == 0) | (tol_key == tk)
    eff_ok = (tol_eff == 0) | (tol_eff == te)
    val_ok = (tol_op == TOL_EXISTS) | (tol_val == tv)
    return (tol_op != 0) & key_ok & eff_ok & val_ok


def taint_filter_mask(na: NodeArrays, pod):
    """No untolerated NoSchedule/NoExecute taint."""
    tol = tolerates(pod.tol_key, pod.tol_val, pod.tol_eff, pod.tol_op,
                    na.taint_key, na.taint_val, na.taint_eff)
    tolerated = tol.any(dim=2)
    hard = ((na.taint_eff == EFFECT_NO_SCHEDULE)
            | (na.taint_eff == EFFECT_NO_EXECUTE))
    return ~(hard & ~tolerated).any(dim=1)


def taint_prefer_count(na: NodeArrays, pod):
    """Untolerated PreferNoSchedule taints; only tolerations with empty or
    PreferNoSchedule effect participate."""
    prefer_tol_op = torch.where(
        (pod.tol_eff == 0) | (pod.tol_eff == EFFECT_PREFER_NO_SCHEDULE),
        pod.tol_op, torch.zeros_like(pod.tol_op))
    tol = tolerates(pod.tol_key, pod.tol_val, pod.tol_eff, prefer_tol_op,
                    na.taint_key, na.taint_val, na.taint_eff)
    tolerated = tol.any(dim=2)
    prefer = na.taint_eff == EFFECT_PREFER_NO_SCHEDULE
    return (prefer & ~tolerated).sum(dim=1).to(_I64)


def _terms_ok(na: NodeArrays, keys, ops, nums, vals):
    """Selector terms against every node: keys/ops/nums [T, Q], vals
    [T, Q, V] → bool [N, T], each term the AND of its requirements."""
    lk = na.label_key[:, None, None, :]                       # [N,1,1,L]
    key_hit = (lk == keys[None, :, :, None]) & (keys != 0)[None, :, :, None]
    key_present = key_hit.any(dim=-1)                         # [N,T,Q]
    kv = na.label_kv[:, None, None, :, None]                  # [N,1,1,L,1]
    v = vals[None, :, :, None, :]                             # [1,T,Q,1,V]
    kv_match = ((kv == v) & (v != 0)).any(dim=-1).any(dim=-1)  # [N,T,Q]
    num = na.label_num[:, None, None, :]
    numeric = torch.where(key_hit, num,
                          torch.full_like(num, I64_MIN)).amax(dim=-1)
    has_numeric = key_present & (numeric != I64_MIN)
    res = torch.ones_like(key_present)
    res = torch.where(ops == OP_IN, kv_match, res)
    res = torch.where(ops == OP_NOT_IN, ~kv_match, res)
    res = torch.where(ops == OP_EXISTS, key_present, res)
    res = torch.where(ops == OP_DOES_NOT_EXIST, ~key_present, res)
    res = torch.where(ops == OP_GT, has_numeric & (numeric > nums), res)
    res = torch.where(ops == OP_LT, has_numeric & (numeric < nums), res)
    return res.all(dim=-1)


def selector_mask(na: NodeArrays, pod):
    """spec.nodeSelector conjuncts AND required nodeAffinity terms (ORed)."""
    present = (pod.ns_sel_val[None, :, None]
               == na.label_kv[:, None, :]).any(dim=-1)        # [N, Q]
    sel_ok = ((pod.ns_sel_val == 0)[None, :] | present).all(dim=-1)
    terms = _terms_ok(na, pod.aff_key, pod.aff_op, pod.aff_num, pod.aff_val)
    aff_ok = (terms & pod.aff_term_valid[None, :]).any(dim=-1)
    return sel_ok & (aff_ok | ~pod.aff_has)


def preferred_affinity_score(na: NodeArrays, pod):
    """Σ weight over matching preferred terms."""
    match = _terms_ok(na, pod.pref_key, pod.pref_op, pod.pref_num,
                      pod.pref_val)                           # [N, PT]
    w = pod.pref_weight[None, :]
    return torch.where(match, w, torch.zeros_like(w)).sum(dim=-1)


def ports_mask(ports, pod_port_ids):
    """No interned (proto, port) id collision, and enough free row slots to
    record the pod's ports."""
    pid = pod_port_ids[None, None, :]
    collide = ((ports[:, :, None] == pid) & (pid != 0)).any(dim=2).any(dim=1)
    free = (ports == 0).sum(dim=1)
    needed = (pod_port_ids != 0).sum()
    return ~collide & (free >= needed)


# ---------------------------------------------------------------------------
# score functions


def _image_match(na: NodeArrays, pod):
    ids = pod.img_ids[None, None, :]
    return (na.image_id[:, :, None] == ids) & (ids != 0)     # [N, I, IC]


def image_counts(na: NodeArrays, pod):
    """ImageLocality's cluster-wide counts over these rows: (nodes holding
    each container image i64 [IC], valid nodes i64). On a node shard they
    are the shard's part of the sum the JAX package psums
    (kubernetes_tpu/ops/program.py:244-248)."""
    present_c = _image_match(na, pod).any(dim=1)              # [N, IC]
    return (present_c & na.valid[:, None]).sum(dim=0), na.valid.sum()


def image_locality_score(na: NodeArrays, pod, counts=None):
    """image_locality.go:95-131: per container image, the node's stored
    size scaled by the image's cluster spread (float64, truncated), summed,
    clamped, mapped to [0, 100]. `counts` = the cluster-wide
    (num_with, total) of `image_counts` when `na` is one node shard;
    None counts over `na` itself."""
    match = _image_match(na, pod)
    size = na.image_size[:, :, None]
    size_c = torch.where(match, size, torch.zeros_like(size)).sum(dim=1)
    num_with, total = counts if counts is not None else image_counts(na,
                                                                     pod)
    total = total.clamp(min=1)
    spread = num_with.to(torch.float64) / total.to(torch.float64)
    scaled = (size_c.to(torch.float64) * spread[None, :]).to(_I64)
    sum_scores = scaled.sum(dim=1)
    nc = pod.img_containers.clamp(min=1).to(_I64)
    max_thr = IMG_MAX_CONTAINER_THRESHOLD * nc
    clamped = torch.minimum(sum_scores.clamp(min=IMG_MIN_THRESHOLD), max_thr)
    score = (MAX_SCORE * (clamped - IMG_MIN_THRESHOLD)
             // (max_thr - IMG_MIN_THRESHOLD).clamp(min=1))
    return torch.where(pod.img_containers > 0, score, torch.zeros_like(score))


def least_allocated(cfg: ScoreConfig, cap, used_cols):
    """least_allocated.go:30-60 exact int64 arithmetic. cap/used_cols:
    [..., C] for the configured score columns."""
    w = torch.tensor(cfg.col_weights, dtype=_I64, device=cap.device)
    col_ok = cap > 0
    capm = cap.clamp(min=1)
    if cfg.strategy == "MostAllocated":
        val = used_cols * MAX_SCORE // capm
    else:
        val = (cap - used_cols) * MAX_SCORE // capm
    zero = torch.zeros_like(val)
    raw = torch.where((cap == 0) | (used_cols > cap), zero, val)
    score_sum = torch.where(col_ok, raw * w, zero).sum(dim=-1)
    w_sum = torch.where(col_ok, w.expand_as(raw), zero).sum(dim=-1)
    return torch.where(w_sum > 0, score_sum // w_sum.clamp(min=1),
                       torch.zeros_like(score_sum))


def _balanced_std(fracs: list, oks: list):
    """Population std (float64) of the utilization fractions, the sums
    taken left to right over the columns; the float surface of
    BalancedAllocation before its int floor (score_probe reads it)."""
    cnt = oks[0].to(_I64)
    total = fracs[0]
    for ok, f in zip(oks[1:], fracs[1:]):
        cnt = cnt + ok.to(_I64)
        total = total + f
    cntf = cnt.clamp(min=1).to(torch.float64)
    mean = total / cntf
    var = None
    for ok, f in zip(oks, fracs):
        d = f - mean
        sq = torch.where(ok, d * d, torch.zeros_like(d))
        var = sq if var is None else var + sq
    return torch.sqrt(var / cntf)


def _balanced_from_fracs(fracs: list, oks: list):
    """100·(1 − population std of the utilization fractions); shared by the
    scan and the closed form so both compute the same bits."""
    std = _balanced_std(fracs, oks)
    return torch.floor((1.0 - std) * MAX_SCORE + 1e-9).to(_I64)


def _frac(cap, used):
    ok = cap > 0
    f = torch.minimum(used.to(torch.float64)
                      / cap.clamp(min=1).to(torch.float64),
                      torch.ones((), dtype=torch.float64, device=cap.device))
    return ok, torch.where(ok, f, torch.zeros_like(f))


def _fracs(cap, used_cols):
    oks, fracs = [], []
    for c in range(cap.shape[-1]):
        ok, f = _frac(cap[..., c], used_cols[..., c])
        oks.append(ok)
        fracs.append(f)
    return fracs, oks


def balanced_allocation(cap, used_cols):
    """balanced_allocation.go:195-237 over [N, C] columns."""
    return _balanced_from_fracs(*_fracs(cap, used_cols))


def feasible_max(scores, feasible):
    """The DefaultNormalizeScore denominator over these rows: on a node
    shard, the shard's part of the max the JAX package pmaxes
    (kubernetes_tpu/ops/program.py:293-301)."""
    return torch.where(feasible, scores, torch.zeros_like(scores)).max()


def default_normalize(scores, feasible, reverse: bool, maxc=None):
    """DefaultNormalizeScore over the feasible set; `maxc` = the
    cluster-wide `feasible_max` when the rows are one node shard."""
    if maxc is None:
        maxc = feasible_max(scores, feasible)
    scaled = torch.where(maxc > 0, scores * MAX_SCORE // maxc.clamp(min=1),
                         torch.full_like(scores, MAX_SCORE) if reverse
                         else scores)
    if reverse:
        scaled = torch.where(maxc > 0, MAX_SCORE - scaled, scaled)
    return scaled


# ---------------------------------------------------------------------------
# the scan


def _cols(cfg: ScoreConfig):
    return list(cfg.score_cols), list(cfg.nonzero_slot)


def _fit_scores(cfg: ScoreConfig, na: NodeArrays, carry: Carry, pod: PodRow):
    """LeastAllocated + BalancedAllocation over all nodes → ([N], [N])."""
    cols, slots = _cols(cfg)
    cap_cols = na.cap[:, cols]
    nz = torch.tensor(cfg.col_nonzero, device=cap_cols.device)
    used_nonzero = carry.nonzero_used[:, slots] + pod.nonzero_req[slots][None]
    used_plain = carry.used[:, cols] + pod.req[cols][None, :]
    used_cols = torch.where(nz[None, :], used_nonzero, used_plain)
    s_fit = least_allocated(cfg, cap_cols, used_cols)
    bal = balanced_allocation(cap_cols, used_plain)
    s_bal = torch.where(pod.skip_balanced, torch.zeros_like(bal), bal)
    return s_fit, s_bal


def _slow_parts(cfg: ScoreConfig, na: NodeArrays, carry: Carry,
                pod: PodRow, overlay=None, img_counts=None) -> SigCache:
    """Everything SigCache caches, freshly computed. `overlay` =
    (ovl_used [N, R], ovl_npods [N]) or None: nominated pods' resources
    folded into the FIT check only (the with-nominated pass of
    RunFilterPluginsWithNominatedPods); scoring stays overlay-free. No
    per-pod self-exclusion here — the cached fit_ok stays
    signature-pure, so same-signature pods with different nominations
    share it; _eval_pod applies the one-row delta on top. `img_counts`:
    see image_locality_score."""
    m = na.valid.clone()
    m &= (pod.node_name_id == 0) | (na.name_id == pod.node_name_id)
    m &= ~na.unschedulable | pod.tolerates_unsched
    m &= taint_filter_mask(na, pod)
    m &= selector_mask(na, pod)
    m &= ports_mask(carry.ports, pod.port_ids)
    if overlay is None:
        fit_used, fit_npods = carry.used, carry.npods
    else:
        fit_used = carry.used + overlay[0]
        fit_npods = carry.npods + overlay[1]
    fit_ok = fit_mask(na.cap, fit_used, fit_npods, na.allowed_pods, pod.req)
    s_fit, s_bal = _fit_scores(cfg, na, carry, pod)
    return SigCache(
        sig=torch.tensor(pod.sig, dtype=_I32, device=m.device),
        static_mask=m, taint_raw=taint_prefer_count(na, pod),
        na_raw=preferred_affinity_score(na, pod),
        s_img=image_locality_score(na, pod, img_counts), fit_ok=fit_ok,
        s_fit=s_fit,
        s_bal=s_bal)


def _own_nomination_fit(na: NodeArrays, carry: Carry, pod: PodRow,
                        overlay, safe: int):
    """Fit at the pod's own nominated row `safe` with its own nomination
    taken back out of the overlay (framework.go:1183 skips the pod's own
    nomination). The overlay holds the pod's own request and count there,
    so removing them and adding the pod back leaves `used + ovl_used ≤
    cap` on the pod's columns and `npods + ovl_npods ≤ allowed`."""
    used = carry.used[safe] + overlay[0][safe]
    npods = carry.npods[safe] + overlay[1][safe]
    return ((npods <= na.allowed_pods[safe])
            & ((pod.req == 0) | (used <= na.cap[safe])).all())


def _eval_pod(cfg: ScoreConfig, na: NodeArrays, carry: Carry, pod: PodRow,
              groups=None, tidx: int = 0, fam=None, overlay=None):
    """Feasibility + total score for one pod over all nodes → (feasible,
    total, parts), consulting the signature cache. With `groups` (the
    GroupsDev of the table, and `carry.groups`), the group mask folds into
    the feasible set BEFORE normalization and the group scores add to the
    total; they are carry-coupled, so never cached. With an `overlay` and
    a nominated pod (`pod.nom_idx >= 0`), the fit at the pod's own
    nominated row is recomputed without its own nomination — in the
    EFFECTIVE mask only; the returned parts keep the signature-pure
    fit_ok."""
    cache = carry.cache
    if pod.sig != 0 and pod.sig == int(cache.sig):
        parts = cache._replace(
            sig=torch.tensor(pod.sig, dtype=_I32, device=cache.sig.device))
    else:
        parts = _slow_parts(cfg, na, carry, pod, overlay=overlay)
    fit_ok_eff = parts.fit_ok
    if overlay is not None and pod.nom_idx is not None:
        nom = int(pod.nom_idx)
        if nom >= 0:
            fit_ok_eff = fit_ok_eff.clone()
            fit_ok_eff[nom] = _own_nomination_fit(na, carry, pod, overlay,
                                                  nom)
    feasible = parts.static_mask & fit_ok_eff
    if groups is not None:
        feasible = feasible & group_mask(groups, carry.groups, tidx, fam=fam)
    s_taint = default_normalize(parts.taint_raw, feasible, reverse=True)
    s_na = default_normalize(parts.na_raw, feasible, reverse=False)
    total = (cfg.w_fit * parts.s_fit + cfg.w_balanced * parts.s_bal
             + cfg.w_taint * s_taint + cfg.w_node_affinity * s_na
             + cfg.w_image * parts.s_img)
    if groups is not None:
        total = total + group_scores(cfg.w_spread, cfg.w_ipa, groups,
                                     carry.groups, tidx, feasible, fam=fam)
    return feasible, total, parts


def _row_refresh(cfg: ScoreConfig, na: NodeArrays, c2: Carry, pod: PodRow,
                 best, gate, cache: SigCache, overlay=None) -> SigCache:
    """Recompute fit_ok/s_fit/s_bal for the single row the placement
    touched (everything else in the cache is carry-independent); the fit
    sees the overlay, the scores do not."""
    cols, slots = _cols(cfg)
    cap_row = na.cap[best]
    used_row = c2.used[best]
    if overlay is None:
        fit_used_row, fit_npods = used_row, c2.npods[best]
    else:
        fit_used_row = used_row + overlay[0][best]
        fit_npods = c2.npods[best] + overlay[1][best]
    fit_ok_b = ((fit_npods + 1 <= na.allowed_pods[best])
                & ((pod.req == 0) | (fit_used_row + pod.req <= cap_row))
                .all())
    nz = torch.tensor(cfg.col_nonzero, device=cap_row.device)
    cap_r = cap_row[cols][None, :]
    used_nz_r = c2.nonzero_used[best][slots] + pod.nonzero_req[slots]
    used_pl_r = used_row[cols] + pod.req[cols]
    used_cols_r = torch.where(nz, used_nz_r, used_pl_r)[None, :]
    s_fit_b = least_allocated(cfg, cap_r, used_cols_r)[0]
    bal_b = balanced_allocation(cap_r, used_pl_r[None, :])[0]
    s_bal_b = torch.where(pod.skip_balanced, torch.zeros_like(bal_b), bal_b)

    def put(vec, val):
        out = vec.clone()
        out[best] = torch.where(gate, val, vec[best])
        return out

    return cache._replace(fit_ok=put(cache.fit_ok, fit_ok_b),
                          s_fit=put(cache.s_fit, s_fit_b),
                          s_bal=put(cache.s_bal, s_bal_b))


def _apply_assignment(carry: Carry, pod: PodRow, best, assigned) -> Carry:
    n = carry.npods.shape[0]
    onehot = (torch.arange(n, device=best.device) == best) & assigned
    oh = onehot[:, None]
    used = carry.used + torch.where(oh, pod.req[None, :],
                                    torch.zeros_like(carry.used))
    nonzero = carry.nonzero_used + torch.where(
        oh, pod.nonzero_req[None, :], torch.zeros_like(carry.nonzero_used))
    npods = carry.npods + onehot.to(carry.npods.dtype)
    # place pod port ids into the first free slots of the chosen node's row
    row = carry.ports[best]
    free = row == 0
    rank = torch.cumsum(free.to(_I64), dim=0) - 1
    pod_ports = pod.port_ids
    nport = pod_ports.shape[0]
    incoming = torch.where((rank >= 0) & (rank < nport) & free,
                           pod_ports[rank.clamp(0, nport - 1)],
                           torch.zeros_like(row))
    new_row = torch.where(free, incoming, row)
    ports = torch.where(oh & (pod_ports != 0).any(),
                        new_row[None, :].expand_as(carry.ports), carry.ports)
    return carry._replace(used=used, nonzero_used=nonzero, npods=npods,
                          ports=ports)


def _run_batch_plain(cfg: ScoreConfig, na: NodeArrays, carry: Carry,
                     pods: PodXs, table: PodTableDev, groups=None, fam=None,
                     overlay=None):
    """The sequential scan, one pod per step (plain version). Under an
    `overlay` with `pods.nom_idx`, a bound nominated pod's nomination is
    consumed at its NOMINATED row (the commit deletes it), so later pods
    see the overlay the host sequential path would; the scan carries the
    overlay forward and never writes the caller's."""
    out = []
    c = carry
    ovl = overlay
    consume_nom = overlay is not None and pods.nom_idx is not None
    noms = (pods.nom_idx.tolist() if consume_nom
            else [None] * len(pods.valid))
    for v, s, t, nom in zip(pods.valid.tolist(), pods.sig.tolist(),
                            pods.tidx.tolist(), noms):
        pod = _gather_row(table, t, v, s, nom_idx=nom)
        mask, score, parts = _eval_pod(cfg, na, c, pod, groups=groups,
                                       tidx=t, fam=fam, overlay=ovl)
        masked = torch.where(mask, score, torch.full_like(score, -1))
        best = torch.argmax(masked)          # first max
        assigned = (masked[best] >= 0) & bool(v)
        c2 = _apply_assignment(c, pod, best, assigned)
        if consume_nom and bool(assigned) and nom >= 0:
            ovl_used, ovl_npods = ovl[0].clone(), ovl[1].clone()
            ovl_used[nom] -= pod.req
            ovl_npods[nom] -= 1
            ovl = (ovl_used, ovl_npods)
        c = c2._replace(cache=_row_refresh(cfg, na, c2, pod, best, assigned,
                                           parts, overlay=ovl))
        if groups is not None:
            c = c._replace(groups=group_update(groups, c.groups, t, best,
                                               assigned, fam=fam))
        out.append(torch.where(assigned, best, torch.full_like(best, -1)))
    if not out:
        return c, torch.zeros((0,), dtype=_I32, device=carry.used.device)
    return c, torch.stack(out).to(_I32)


def run_batch(cfg: ScoreConfig, na: NodeArrays, carry: Carry, pods: PodXs,
              table: PodTableDev, groups=None, fam=None, overlay=None):
    """Scan the batch; returns (final carry, assignments i32 [B] (-1 =
    none)). `groups` (GroupsDev, with `carry.groups`) turns on the
    PodTopologySpread / InterPodAffinity mask, scores and per-placement
    count update; `fam` (GroupFamilies) skips the inactive families.
    `overlay` = (ovl_used i64 [N, R], ovl_npods i32 [N]) folds the
    nominated pods into the fit (lean scan only), with `pods.nom_idx`
    the per-pod self-exclusion and consumption. Never writes into
    `carry` or `overlay`: the output carry is fresh."""
    dev = carry.used.device
    if (groups is None) != (carry.groups is None):
        raise ValueError("run_batch: groups and carry.groups go together")
    if overlay is not None and groups is not None:
        raise ValueError("run_batch: the overlay is a lean-scan input")
    na, carry, pods, table, groups, overlay = RAILS.stage(
        (na, carry, pods, table, groups, overlay), dev)
    if dev.type == "cuda":
        from .kernels import run_batch_cuda
        return run_batch_cuda(cfg, na, carry, pods, table, groups, fam,
                              overlay=overlay)
    if dev.type != "cpu":
        raise RuntimeError(f"run_batch: unsupported device {dev}")
    return _run_batch_plain(cfg, na, carry, pods, table, groups, fam,
                            overlay=overlay)


# ---------------------------------------------------------------------------
# the closed-form uniform run


def _uniform_matrix(cfg: ScoreConfig, na: NodeArrays, fit_used, fit_npods,
                    score_used, score_nz, cand, pod: PodRow, J: int):
    """The closed-form [K, J] matrices: entry j = fit + post-placement
    scores of the (j+1)-th run-pod on candidate k → (fit_kj, s_fit_kj,
    s_bal_kj)."""
    dev = cand.device
    j1 = torch.arange(1, J + 1, dtype=_I64, device=dev)[None, :]   # [1, J]
    npods_kj = fit_npods[cand][:, None].to(_I64) + j1
    fit_kj = npods_kj <= na.allowed_pods[cand][:, None].to(_I64)
    used_kjr = fit_used[cand][:, None, :] + j1[:, :, None] * pod.req
    cap_kr = na.cap[cand][:, None, :]
    fit_kj &= ((pod.req == 0) | (used_kjr <= cap_kr)).all(dim=-1)

    w = cfg.col_weights
    K = cand.shape[0]
    zero = torch.zeros((K, J), dtype=_I64, device=dev)
    score_sum = zero
    w_sum = zero
    fracs, oks = [], []
    for ci, col in enumerate(cfg.score_cols):
        cap_c = na.cap[cand, col][:, None]                       # [K, 1]
        used_pl = score_used[cand, col][:, None] + j1 * pod.req[col]
        if cfg.col_nonzero[ci]:
            slot = cfg.nonzero_slot[ci]
            used_c = score_nz[cand, slot][:, None] + j1 * pod.nonzero_req[slot]
        else:
            used_c = used_pl
        col_ok = (cap_c > 0).expand(K, J)
        capm = cap_c.clamp(min=1)
        if cfg.strategy == "MostAllocated":
            val = used_c * MAX_SCORE // capm
        else:
            val = (cap_c - used_c) * MAX_SCORE // capm
        raw = torch.where((cap_c == 0) | (used_c > cap_c), zero, val)
        score_sum = score_sum + torch.where(col_ok, raw * w[ci], zero)
        w_sum = w_sum + torch.where(col_ok, torch.full_like(zero, w[ci]),
                                    zero)
        ok, f = _frac(cap_c.expand(K, J), used_pl)
        oks.append(ok)
        fracs.append(f)
    s_fit_kj = torch.where(w_sum > 0, score_sum // w_sum.clamp(min=1), zero)
    bal = _balanced_from_fracs(fracs, oks)
    s_bal_kj = torch.where(pod.skip_balanced, zero, bal)
    return fit_kj, s_fit_kj, s_bal_kj


def _run_uniform_plain(cfg: ScoreConfig, na: NodeArrays, carry: Carry,
                       x: PodXs, table: PodTableDev, n_actual: int, L: int,
                       K: int, J: int, overlay=None):
    pod = _gather_row(table, int(x.tidx), True, int(x.sig))
    feasible0, total0, parts = _eval_pod(cfg, na, carry, pod,
                                         overlay=overlay)
    masked0 = torch.where(feasible0, total0, torch.full_like(total0, -1))
    N = masked0.shape[0]
    dev = masked0.device
    ar_n = torch.arange(N, dtype=_I64, device=dev)
    # top-K with ties to the lowest index: the index rides in the key
    key0 = (masked0 + 1) * N + (N - 1 - ar_n)
    cand = (N - 1 - torch.sort(key0, descending=True).values[:K] % N)

    s_taint = default_normalize(parts.taint_raw, feasible0, reverse=True)
    s_na = default_normalize(parts.na_raw, feasible0, reverse=False)
    static_add = (cfg.w_taint * s_taint + cfg.w_node_affinity * s_na
                  + cfg.w_image * parts.s_img)[cand]
    static_m = parts.static_mask[cand]
    zero_n = torch.zeros_like(parts.taint_raw)
    norm_ok = ((torch.where(feasible0, parts.taint_raw, zero_n).max() == 0)
               & (torch.where(feasible0, parts.na_raw, zero_n).max() == 0))

    if overlay is None:
        fit_used, fit_npods = carry.used, carry.npods
    else:
        fit_used = carry.used + overlay[0]
        fit_npods = carry.npods + overlay[1]
    fit_kj, s_fit_kj, s_bal_kj = _uniform_matrix(
        cfg, na, fit_used, fit_npods, carry.used, carry.nonzero_used,
        cand, pod, J)
    score_kj = (cfg.w_fit * s_fit_kj + cfg.w_balanced * s_bal_kj
                + static_add[:, None])
    masked_kj = torch.where(static_m[:, None] & fit_kj, score_kj,
                            torch.full_like(score_kj, -1))
    mono_ok = (masked_kj[:, 1:] <= masked_kj[:, :-1]).all()

    # key = (score desc, node idx asc, j asc), unique per entry
    M = N * J
    if K * J < L:
        raise ValueError(f"run_uniform: K*J = {K * J} < L = {L}")
    ent_id = (cand[:, None] * J
              + torch.arange(J, dtype=_I64, device=dev)[None, :])
    flat_key = (masked_kj * M - ent_id).reshape(K * J)
    srt = torch.sort(flat_key, descending=True)
    top_vals, flat_i = srt.values[:L], srt.indices[:L]
    krank = flat_i // J
    node_of = cand[krank]
    sel_ok = (top_vals > -M) & (torch.arange(L, device=dev) < n_actual)
    assignments = torch.where(sel_ok, node_of,
                              torch.full_like(node_of, -1)).to(_I32)

    counts = torch.zeros((K,), dtype=_I64, device=dev).index_add_(
        0, krank, sel_ok.to(_I64))
    depth_ok = (counts < J).all()
    used = carry.used.index_add(0, cand, counts[:, None] * pod.req[None, :])
    nonzero = carry.nonzero_used.index_add(
        0, cand, counts[:, None] * pod.nonzero_req[None, :])
    npods = carry.npods.index_add(0, cand, counts.to(carry.npods.dtype))

    # cache refresh: entry j=counts IS the next-pod evaluation for this sig
    ar = torch.arange(K, device=dev)
    cnt_i = counts.clamp(max=J - 1)

    def put(vec, mat):
        out = vec.clone()
        out[cand] = mat[ar, cnt_i]
        return out

    new_cache = parts._replace(fit_ok=put(parts.fit_ok, fit_kj),
                               s_fit=put(parts.s_fit, s_fit_kj),
                               s_bal=put(parts.s_bal, s_bal_kj))
    new_carry = carry._replace(used=used, nonzero_used=nonzero, npods=npods,
                               cache=new_cache)
    packed = torch.cat([assignments,
                        torch.stack([mono_ok & norm_ok, depth_ok]).to(_I32)])
    return new_carry, packed


def run_uniform(cfg: ScoreConfig, na: NodeArrays, carry: Carry, x: PodXs,
                table: PodTableDev, n_actual: int, L: int, K: int, J: int,
                overlay=None):
    """Closed-form assignment of a run of `n_actual` same-signature pods
    (row `x.tidx`, signature `x.sig != 0`; see the JAX package's
    `_uniform_core` for the exactness argument). Returns (carry', packed
    i32 [L+2]): assignments, then the exactness flag (monotonicity and
    normalization constancy held) and the depth flag (no candidate used
    all J entries). `overlay` = (ovl_used [N, R], ovl_npods [N]) folds
    the nominated pods into the fit of the matrix and of the candidate
    selection; none of the run's pods is nominated. Never writes into
    `carry`: the scheduler keeps it for rewind and replay."""
    dev = carry.used.device
    na, carry, table, overlay = RAILS.stage((na, carry, table, overlay), dev)
    if dev.type == "cuda":
        from .kernels import run_uniform_cuda
        return run_uniform_cuda(cfg, na, carry, x, table, n_actual, L, K, J,
                                overlay=overlay)
    if dev.type != "cpu":
        raise RuntimeError(f"run_uniform: unsupported device {dev}")
    return _run_uniform_plain(cfg, na, carry, x, table, n_actual, L, K, J,
                              overlay=overlay)


# ---------------------------------------------------------------------------
# state helpers


def _scatter_rows_plain(dev: NodeArrays, idx, rows: NodeArrays) -> NodeArrays:
    index = torch.as_tensor(idx, dtype=_I64).to(dev.used.device)
    return NodeArrays(*(d.index_copy(0, index, r) for d, r in zip(dev, rows)))


def scatter_rows(dev: NodeArrays, idx, rows: NodeArrays) -> NodeArrays:
    """Scatter `rows` ([D, ...], one staging row per dirty node; duplicate
    indices carry identical rows) into the resident NodeArrays at `idx`
    (int [D]). Non-writing: returns fresh tensors, because in-flight drains
    still hold the previous copy."""
    device = dev.used.device
    # the wrapper reads `idx` on the host: only the rows are staged
    dev, rows = RAILS.stage((dev, rows), device)
    if device.type == "cuda":
        from .kernels import scatter_rows_cuda
        return scatter_rows_cuda(dev, idx, rows)
    if device.type != "cpu":
        raise RuntimeError(f"scatter_rows: unsupported device {device}")
    return _scatter_rows_plain(dev, idx, rows)


def empty_cache(n: int, device) -> SigCache:
    def z(dtype):
        return torch.zeros((n,), dtype=dtype, device=device)
    return SigCache(sig=torch.zeros((), dtype=_I32, device=device),
                    static_mask=z(torch.bool), taint_raw=z(_I64),
                    na_raw=z(_I64), s_img=z(_I64), fit_ok=z(torch.bool),
                    s_fit=z(_I64), s_bal=z(_I64))


def initial_carry(na: NodeArrays, groups=None) -> Carry:
    """Carry seeded from the node arrays (copies: the programs return fresh
    carries and never alias the resident NodeArrays), an empty SigCache
    and the seeded group counts (GroupCarry or None). Eager clones, like
    the JAX package's (not a device program there either)."""
    return Carry(used=na.used.clone(), nonzero_used=na.nonzero_used.clone(),
                 npods=na.npods.clone(), ports=na.ports.clone(),
                 cache=empty_cache(na.npods.shape[0], na.used.device),
                 groups=groups)


def with_cache_sig(carry: Carry, sig: int) -> Carry:
    """The carry with its signature cache relabelled (sig 0 = invalid): a
    fill on the device, not a copy from the host, which would wait for
    the drains still on the stream."""
    return carry._replace(cache=carry.cache._replace(sig=torch.full(
        (), sig, dtype=_I32, device=carry.cache.sig.device)))



# ---------------------------------------------------------------------------
# speculative wave placement (same-signature group spans)


def static_norm_ok(arrays, pref_weight) -> bool:
    """True when the TaintToleration / preferred-NodeAffinity
    DefaultNormalize constants cannot shift during a same-signature run:
    no valid node carries a PreferNoSchedule taint and the row has no
    preferred-affinity weight (numpy inputs: the staging arrays and the
    row's PodTable weights). run_wave keys `norm_live` on it: False keeps
    the constant normalization and allows the merge tier, True
    renormalizes every step and sends the whole span to the serial tier
    (the JAX package's ops/hostgreedy.py static_norm_ok)."""
    prefer = ((arrays.taint_eff == EFFECT_PREFER_NO_SCHEDULE)
              & arrays.valid[:, None]).any()
    return (not prefer) and (not pref_weight.any())


def _wave_statics_plain(na: NodeArrays, table: PodTableDev, wt,
                        feats: tuple = (True, True, True), img_counts=None):
    """`img_counts`: per row of `wt`, the cluster-wide image_counts when
    `na` is one node shard (None: over these rows)."""
    has_taints, has_sel, has_img = feats
    n = na.valid.shape[0]
    dev = na.valid.device
    out = ([], [], [], [])
    for k, u in enumerate(int(x) for x in wt):
        row = _gather_row(table, u, True, 1)
        m = na.valid.clone()
        m &= (row.node_name_id == 0) | (na.name_id == row.node_name_id)
        m &= ~na.unschedulable | row.tolerates_unsched
        zero = torch.zeros((n,), dtype=_I64, device=dev)
        traw = naraw = simg = zero
        if has_taints:
            m &= taint_filter_mask(na, row)
            traw = taint_prefer_count(na, row)
        if has_sel:
            m &= selector_mask(na, row)
            naraw = preferred_affinity_score(na, row)
        if has_img:
            simg = image_locality_score(
                na, row, None if img_counts is None else img_counts[k])
        for lst, x in zip(out, (m, traw, naraw, simg)):
            lst.append(x)
    return tuple(torch.stack(lst) for lst in out)


def wave_statics(na: NodeArrays, table: PodTableDev, wt,
                 feats: tuple = (True, True, True)):
    """Carry-independent per-signature surfaces for the wave program —
    static filter mask (name/unschedulable/taints/selector; ports vacuous
    for sig != 0 rows), TaintToleration / preferred-affinity raw counts,
    ImageLocality score — for the table rows `wt` (sequence of int) →
    ([S, N] bool, [S, N] i64, [S, N] i64, [S, N] i64). `feats` = (taints,
    selectors, images): a False skips that family (its outputs are the
    identity: mask bits set, counts zero)."""
    dev = na.valid.device
    na, table = RAILS.stage((na, table), dev)
    if dev.type == "cuda":
        from .kernels import wave_statics_cuda
        return wave_statics_cuda(na, table, wt, feats)
    if dev.type != "cpu":
        raise RuntimeError(f"wave_statics: unsupported device {dev}")
    return _wave_statics_plain(na, table, wt, feats)


# spread-replay level cap of the merge tier (JAX run_wave M_CAP)
WAVE_M_CAP = 32


def _topk_lowest_index(vals, k: int):
    """Indices of the k largest int64 `vals`, ties to the lowest index
    (lax.top_k's order): the index rides in a unique key."""
    n = vals.shape[0]
    ar = torch.arange(n, dtype=_I64, device=vals.device)
    key = (vals + 1) * n + (n - 1 - ar)
    return n - 1 - torch.sort(key, descending=True).values[:k] % n


def _run_wave_plain(cfg: ScoreConfig, na: NodeArrays, carry: Carry, valid,
                    table: PodTableDev, wt: int, gd, statics, K: int,
                    J: int, Lw: int, fam, norm_live: bool, anti_term: int,
                    merge_on: bool):
    from .groups import (INT32_MAX, GroupView, _dom_share, group_mask_view,
                         group_scores_view, wave_fold)

    gc = carry.groups
    dev = carry.used.device
    B = valid.shape[0]
    n = na.cap.shape[0]
    W = int(valid.sum())
    wt = int(wt)
    row = _gather_row(table, wt, True, 1)
    m0, taint_raw, na_raw, s_img = statics
    ar_n = torch.arange(n, dtype=_I64, device=dev)
    zero_i32 = torch.zeros((), dtype=_I32, device=dev)

    # own-row group statics (JAX :1760-1790)
    f_act, f_skew = gd.spr_f_active[wt], gd.spr_f_max_skew[wt]
    f_self, f_minz = gd.spr_f_self[wt], gc.spr_f_min_zero[wt]
    f_tv, f_elig, f_dom = gd.spr_f_tv[wt], gd.spr_f_elig[wt], gd.spr_f_dom[wt]
    raa_tv, raa_dom = gd.ipa_raa_tv[wt], gd.ipa_raa_dom[wt]
    iscore0 = gc.ipa_score[wt]
    mf_self = gd.m_spr_f[wt, wt]       # [SC]
    mex_self = gd.m_ipa_exist[wt, wt]  # [TAA]
    maa_self = gd.m_ipa_aa[wt, wt]
    if anti_term >= 0:
        anti_tv = raa_tv[anti_term]
        anti_dom = raa_dom[anti_term].long()

    def view(f_cnt, veto, aa_cnt):
        return GroupView(
            f_act=f_act, f_skew=f_skew, f_self=f_self, f_minz=f_minz,
            f_tv=f_tv, f_elig=f_elig, f_cnt=f_cnt,
            s_act=gd.spr_s_active[wt], s_skew=gd.spr_s_max_skew[wt],
            s_is_host=gd.spr_s_is_host[wt], s_tv=gd.spr_s_tv[wt],
            s_keys_ok=gd.spr_s_keys_ok[wt], s_dom=gd.spr_s_dom[wt],
            s_cnt=gc.spr_s_cnt[wt], ra_act=gd.ipa_ra_active[wt],
            ra_tv=gd.ipa_ra_tv[wt], raa_act=gd.ipa_raa_active[wt],
            raa_tv=raa_tv, self_all=gd.ipa_self_all[wt], veto=veto,
            a_cnt=gc.ipa_a_cnt[wt], a_total=gc.ipa_a_total[wt],
            aa_cnt=aa_cnt, iscore=iscore0)

    def eval_row(used, nz, npods, f_cnt, veto, aa_cnt):
        fit_ok = fit_mask(na.cap, used, npods, na.allowed_pods, row.req)
        s_fit, s_bal = _fit_scores(
            cfg, na, carry._replace(used=used, nonzero_used=nz), row)
        v = view(f_cnt, veto, aa_cnt)
        gmask = m0 & group_mask_view(v, fam)
        feasible = gmask & fit_ok
        if norm_live:
            s_taint = default_normalize(taint_raw, feasible, reverse=True)
            s_na = default_normalize(na_raw, feasible, reverse=False)
            tn = cfg.w_taint * s_taint + cfg.w_node_affinity * s_na
        else:
            tn = cfg.w_taint * MAX_SCORE
        total = (cfg.w_fit * s_fit + cfg.w_balanced * s_bal + tn
                 + cfg.w_image * s_img)
        total = total + group_scores_view(cfg.w_spread, cfg.w_ipa, v,
                                          feasible, fam)
        return gmask, feasible, total

    used, nz, npods = carry.used, carry.nonzero_used, carry.npods
    f_cnt, veto, aa_cnt = gc.spr_f_cnt[wt], gc.ipa_veto[wt], gc.ipa_aa_cnt[wt]
    cnt_n = torch.zeros((n,), dtype=_I32, device=dev)
    out = torch.full((B,), -1, dtype=_I32, device=dev)
    done, prog, ok = 0, True, True
    waves, confs, first_prefix = 0, 0, -1

    # ---- merge tier (JAX merge_body :1828-2000)
    while merge_on and not norm_live and ok and prog and done < W:
        gmask, feasible0, total0 = eval_row(used, nz, npods, f_cnt, veto,
                                            aa_cnt)
        masked0 = torch.where(feasible0, total0, torch.full_like(total0, -1))
        # inter-pod score surface must be FLAT over the feasible set
        isc_min = torch.where(feasible0, iscore0,
                              torch.full_like(iscore0, 2**63 - 1)).min()
        isc_max = torch.where(feasible0, iscore0,
                              torch.full_like(iscore0, -(2**63 - 1))).max()
        flat = bool(isc_max <= isc_min)
        # the skew check must not mask any keyed node at wave start
        if fam.spr_f:
            minv = torch.where(f_elig, f_cnt, torch.full_like(
                f_cnt, int(INT32_MAX))).amin(dim=-1)
            minv = torch.where(f_minz, torch.zeros_like(minv), minv)
            ok_cn = (f_cnt + f_self[:, None] - minv[:, None]
                     <= f_skew[:, None])
            start_inert = bool((~f_act[:, None] | (f_tv == 0)
                                | ok_cn).all())
        else:
            minv = torch.zeros(f_skew.shape, dtype=_I32, device=dev)
            start_inert = True

        # lax.top_k(masked0.astype(int32), K): ties to the lowest index
        cand = _topk_lowest_index(masked0.to(_I32).to(_I64), K)
        if anti_term >= 0:
            # champion per anti-topology domain (score desc, idx asc);
            # keyless nodes are unconstrained
            keyN = masked0 * n - ar_n
            has = anti_tv != 0
            seg = torch.full((n,), I64_MIN, dtype=_I64, device=dev)
            seg.scatter_reduce_(0, anti_dom, torch.where(
                has, keyN, torch.full_like(keyN, I64_MIN)), reduce="amax")
            champ = ~has | (has & (keyN == seg[anti_dom]))
            champ_cand = champ[cand][:, None]
            jcap = 1
        else:
            champ_cand = torch.ones((K, 1), dtype=torch.bool, device=dev)
            jcap = J
        fit_kj, s_fit_kj, s_bal_kj = _uniform_matrix(
            cfg, na, used, npods, used, nz, cand, row, J)
        static_add = (cfg.w_taint * MAX_SCORE + cfg.w_image * s_img)[cand]
        score_kj = (cfg.w_fit * s_fit_kj + cfg.w_balanced * s_bal_kj
                    + static_add[:, None])
        jmask = torch.arange(J, device=dev)[None, :] < jcap
        masked_kj = torch.where(gmask[cand][:, None] & champ_cand & fit_kj
                                & jmask, score_kj,
                                torch.full_like(score_kj, -1))
        mono_ok = bool((masked_kj[:, 1:] <= masked_kj[:, :-1]).all())

        # key = (score desc, node idx asc, j asc); the JAX program narrows
        # it to int32 when (score_max + 2)·M < 2³¹ — same values, same order
        M = n * J
        ent_id = cand[:, None] * J + torch.arange(J, dtype=_I64,
                                                  device=dev)[None, :]
        flat_key = (masked_kj * M - ent_id).reshape(K * J)
        if Lw > K * J:
            raise ValueError(f"run_wave: Lw = {Lw} > K*J = {K * J}")
        srt = torch.sort(flat_key, descending=True)
        top_vals, flat_i = srt.values[:Lw], srt.indices[:Lw]
        node_i = cand[flat_i // J]
        j_i = flat_i % J
        avail = W - done
        sel_ok = (top_vals > -M) & (torch.arange(Lw, device=dev) < avail)

        # conflict detection over the speculated sequence
        if fam.spr_f:
            # the skew bound replayed at domain level against the exact
            # evolving minimum, level by level (JAX :1905-1946)
            gate = mf_self[None, :] & f_elig[:, node_i].T & sel_ok[:, None]
            dom_ic = f_dom[:, node_i].T                       # [Lw, SC]
            eq = dom_ic[None, :, :] == dom_ic[:, None, :]     # [i, j, SC]
            lower = torch.ones((Lw, Lw), dtype=torch.bool,
                               device=dev).tril(-1)
            r_ic = (eq & gate[None, :, :] & lower[:, :, None]).sum(
                dim=1).to(_I32)
            newcnt = f_cnt[:, node_i].T + r_ic + 1
            lvlv = minv[:, None] + torch.arange(
                1, WAVE_M_CAP + 1, dtype=_I32, device=dev)[None, :]
            # a domain id IS the index of one of its nodes: mark the
            # domains with an eligible member, read their counts there
            elig_dom = torch.zeros(f_dom.shape, dtype=_I32, device=dev)
            elig_dom.scatter_reduce_(1, f_dom.long(), f_elig.to(_I32),
                                     reduce="amax")
            d_need = ((elig_dom[:, None, :] > 0)
                      & (f_cnt[:, None, :] < lvlv[:, :, None])).sum(
                dim=2).to(_I32)                               # [SC, M]
            comp = gate[:, :, None] & (newcnt[:, :, None]
                                       == lvlv[None, :, :])   # [Lw,SC,M]
            cum_excl = comp.to(_I64).cumsum(dim=0) - comp.to(_I64)
            reached = cum_excl >= d_need[None, :, :]
            lvl_up = reached.sum(dim=2).to(_I32)              # [Lw, SC]
            min_i = torch.where(f_minz[None, :], zero_i32,
                                minv[None, :] + lvl_up)
            viol = (f_act[None, :] & gate
                    & ((newcnt + f_self[None, :] - min_i > f_skew[None, :])
                       | (lvl_up >= WAVE_M_CAP))).any(dim=1)
        else:
            viol = torch.zeros((Lw,), dtype=torch.bool, device=dev)
        if anti_term >= 0:
            # a keyless node hides its deeper entries from the jcap=1
            # merge: cut after it so the next wave re-offers it
            viol |= anti_tv[node_i] == 0
        else:
            # depth cut: a candidate consuming its last matrix entry
            viol |= j_i == J - 1
        viol &= sel_ok
        excl = viol.to(_I64).cumsum(0) - viol.to(_I64)
        accept = sel_ok & (excl == 0)
        iter_ok = mono_ok and flat and start_inert
        accept &= iter_ok
        a = int(accept.sum())

        cnt_add = torch.zeros((n,), dtype=_I32, device=dev).index_add_(
            0, node_i, accept.to(_I32))
        used = used + cnt_add[:, None].to(_I64) * row.req[None, :]
        nz = nz + cnt_add[:, None].to(_I64) * row.nonzero_req[None, :]
        npods = npods + cnt_add.to(npods.dtype)
        if fam.spr_f:
            inc = _dom_share(f_tv, f_dom, f_elig.to(_I32) * cnt_add[None, :])
            f_cnt = f_cnt + torch.where(mf_self[:, None], inc,
                                        torch.zeros_like(inc))
        if fam.ipa_anti:
            sh = _dom_share(raa_tv, raa_dom, cnt_add[None, :])
            zero = torch.zeros_like(sh)
            veto = veto + torch.where(mex_self[:, None], sh, zero).sum(
                dim=0).to(_I32)
            aa_cnt = aa_cnt + torch.where(maa_self[:, None], sh, zero)
        rank = accept.to(_I64).cumsum(0) - accept.to(_I64)
        out = out.clone()
        out[(done + rank)[accept]] = node_i[accept].to(_I32)
        cnt_n = cnt_n + cnt_add
        confs += int(a < avail and iter_ok)
        first_prefix = a if waves == 0 else first_prefix
        waves += 1
        done += a
        prog = a > 0
        ok = ok and iter_ok

    # ---- serial tier: the exact per-pod rule for the remainder. A pod
    # that fits nowhere leaves the state unchanged, so every later pod of
    # the span fails identically: the rest is -1 at one step each.
    steps = 0
    while done < W:
        _, feasible, total = eval_row(used, nz, npods, f_cnt, veto, aa_cnt)
        masked = torch.where(feasible, total, torch.full_like(total, -1))
        best = int(torch.argmax(masked))
        if int(masked[best]) < 0:
            steps += W - done
            done = W
            break
        used = used.clone()
        used[best] += row.req
        nz = nz.clone()
        nz[best] += row.nonzero_req
        npods = npods.clone()
        npods[best] += 1
        if fam.spr_f:
            tvb = f_tv[:, best]
            inc = ((mf_self & f_elig[:, best])[:, None]
                   & (f_tv == tvb[:, None]) & (tvb[:, None] != 0))
            f_cnt = f_cnt + inc.to(_I32)
        if fam.ipa_anti:
            tvb_a = raa_tv[:, best]
            share = (raa_tv == tvb_a[:, None]) & (tvb_a[:, None] != 0)
            veto = veto + (mex_self[:, None] & share).sum(dim=0).to(_I32)
            aa_cnt = aa_cnt + (maa_self[:, None] & share).to(_I32)
        out = out.clone()
        out[done] = best
        cnt_n = cnt_n.clone()
        cnt_n[best] += 1
        done += 1
        steps += 1

    new_gc = wave_fold(gd, gc, [wt], cnt_n[None, :], fam=fam)
    new_carry = Carry(used=used, nonzero_used=nz, npods=npods,
                      ports=carry.ports,
                      cache=carry.cache._replace(sig=torch.zeros(
                          (), dtype=_I32, device=dev)),
                      groups=new_gc)
    stats = torch.tensor([waves, confs, first_prefix, steps], dtype=_I32,
                         device=dev)
    return new_carry, torch.cat([out, stats])


def run_wave(cfg: ScoreConfig, na: NodeArrays, carry: Carry, valid,
             table: PodTableDev, wt: int, gd, statics, K: int, J: int,
             fam, norm_live: bool, anti_term: int = -1,
             merge_on: bool = True, Lw: int = 512):
    """Speculative wave placement for a same-signature run of group pods
    (row `wt`; `valid` bool [B] is a prefix mask), one call for the whole
    span — see the JAX package's `_run_wave_same_impl` for the exactness
    argument. Merge tier: closed-form waves over the [K, J] post-placement
    matrix, champion-per-domain selection for the row's self-matching
    anti term `anti_term`, the spread skew replayed at domain level; the
    longest conflict-free prefix is accepted per wave. Serial tier: the
    exact per-pod rule for the rest. `statics` is the row's wave_statics
    ([N] each); `Lw` caps the speculated entries per wave. Returns
    (carry', packed i32 [B + 4]): assignments, then [waves, conflicts,
    first_prefix, serial_steps]. Never writes into `carry`."""
    Lw = min(Lw, valid.shape[0])
    dev = carry.used.device
    if carry.groups is None:
        raise ValueError("run_wave needs the group carry")
    na, carry, valid, table, gd, statics = RAILS.stage(
        (na, carry, valid, table, gd, statics), dev)
    if dev.type == "cuda":
        from .kernels import run_wave_cuda
        return run_wave_cuda(cfg, na, carry, valid, table, wt, gd, statics,
                             K, J, Lw, fam, norm_live, anti_term, merge_on)
    if dev.type != "cpu":
        raise RuntimeError(f"run_wave: unsupported device {dev}")
    return _run_wave_plain(cfg, na, carry, valid, table, wt, gd, statics, K,
                           J, Lw, fam, norm_live, anti_term, merge_on)


# ---------------------------------------------------------------------------
# the plan program: mixed-signature spans over hoisted surfaces

# signature-lattice ceiling of one plan span (compiler/plan.py)
PLAN_MAX_SIGS = 32


class WaveXs(NamedTuple):
    """Per-pod plan inputs ([W] = span bucket, serial priority order)."""

    valid: object    # bool [W]
    widx: object     # i32 [W] — slot into the span's row set wt [S]


class _WaveState(NamedTuple):
    """The plan program's loop state: node bookkeeping, the S rows' fit
    surfaces and group counters, and the conflict stats."""

    used: torch.Tensor          # i64 [N, R]
    nonzero_used: torch.Tensor  # i64 [N, 2]
    npods: torch.Tensor         # i32 [N]
    fit_ok: torch.Tensor        # bool [S, N]
    s_fit: torch.Tensor         # i64 [S, N]
    s_bal: torch.Tensor         # i64 [S, N]
    f_cnt: object               # i32 [S, SC, N]
    s_cnt: object               # i32 [S, SC, N]
    veto: object                # i32 [S, N]
    a_cnt: object               # i32 [S, TA, N]
    a_total: object             # i64 [S]
    aa_cnt: object              # i32 [S, TAA, N]
    iscore: object              # i64 [S, N]
    cnt_sn: object              # i32 [S, N] — accepted placements (fold)
    ports: object = None        # i32 [N, P] (has_ports only)


def _run_plan_plain(cfg: ScoreConfig, na: NodeArrays, carry: Carry,
                    xs: WaveXs, table: PodTableDev, wt, gd, statics, fam,
                    norm_live: bool, has_groups: bool, has_ports: bool):
    from .groups import GroupView, group_mask_view, group_scores_view, \
        wave_fold

    gc = carry.groups
    dev = carry.used.device
    wt = [int(u) for u in wt]
    S = len(wt)
    wt_t = torch.tensor(wt, dtype=_I64, device=dev)
    rows = PodRow(valid=True, sig=1, **{
        name: getattr(table, name)[wt_t] for name in PodTableDev._fields})
    static_mask, taint_raw, na_raw, s_img = statics

    # Phase A: the fit surfaces of every row at the pre-span carry
    fits = [(fit_mask(na.cap, carry.used, carry.npods, na.allowed_pods,
                      rows.req[s]),)
            + _fit_scores(cfg, na, carry, _gather_row(table, u, True, 1))
            for s, u in enumerate(wt)]
    fit0, sfit0, sbal0 = (torch.stack([f[k] for f in fits])
                          for k in range(3))

    if has_groups:
        # span-local group statics ([S, ...]) and the pairwise
        # [placed slot, consumer slot] match slices
        f_act, f_skew = gd.spr_f_active[wt_t], gd.spr_f_max_skew[wt_t]
        f_self, f_minz = gd.spr_f_self[wt_t], gc.spr_f_min_zero[wt_t]
        f_tv, f_elig = gd.spr_f_tv[wt_t], gd.spr_f_elig[wt_t]
        s_act, s_skew = gd.spr_s_active[wt_t], gd.spr_s_max_skew[wt_t]
        s_ishost, s_tv = gd.spr_s_is_host[wt_t], gd.spr_s_tv[wt_t]
        s_elig, s_keys = gd.spr_s_elig[wt_t], gd.spr_s_keys_ok[wt_t]
        s_dom = gd.spr_s_dom[wt_t]
        ra_act, ra_tv = gd.ipa_ra_active[wt_t], gd.ipa_ra_tv[wt_t]
        raa_act, raa_tv = gd.ipa_raa_active[wt_t], gd.ipa_raa_tv[wt_t]
        self_all = gd.ipa_self_all[wt_t]
        stc_tv, stp_tv = gd.ipa_stc_tv[wt_t], gd.ipa_stp_tv[wt_t]
        m_f = gd.m_spr_f[wt_t][:, wt_t]
        m_s = gd.m_spr_s[wt_t][:, wt_t]
        m_a = gd.m_ipa_a[wt_t][:, wt_t]
        m_aa = gd.m_ipa_aa[wt_t][:, wt_t]
        m_ex = gd.m_ipa_exist[wt_t][:, wt_t]
        w_c = gd.w_stc[wt_t][:, wt_t]
        w_p = gd.w_stp[wt_t][:, wt_t]

    def grp(name):
        return getattr(gc, name)[wt_t] if has_groups else None

    st = _WaveState(
        used=carry.used, nonzero_used=carry.nonzero_used, npods=carry.npods,
        fit_ok=fit0, s_fit=sfit0, s_bal=sbal0, f_cnt=grp("spr_f_cnt"),
        s_cnt=grp("spr_s_cnt"), veto=grp("ipa_veto"),
        a_cnt=grp("ipa_a_cnt"), a_total=grp("ipa_a_total"),
        aa_cnt=grp("ipa_aa_cnt"), iscore=grp("ipa_score"),
        cnt_sn=(torch.zeros((S, na.cap.shape[0]), dtype=_I32, device=dev)
                if has_groups else None),
        ports=carry.ports if has_ports else None)

    def _eval(stx: _WaveState, w: int):
        """Feasibility + total score of slot `w` at the state (the scan's
        _eval_pod formulas over the maintained surfaces and counters)."""
        feasible = static_mask[w] & stx.fit_ok[w]
        if has_ports:
            feasible = feasible & ports_mask(stx.ports, rows.port_ids[w])
        if has_groups:
            view = GroupView(
                f_act=f_act[w], f_skew=f_skew[w], f_self=f_self[w],
                f_minz=f_minz[w], f_tv=f_tv[w], f_elig=f_elig[w],
                f_cnt=stx.f_cnt[w], s_act=s_act[w], s_skew=s_skew[w],
                s_is_host=s_ishost[w], s_tv=s_tv[w], s_keys_ok=s_keys[w],
                s_dom=s_dom[w], s_cnt=stx.s_cnt[w], ra_act=ra_act[w],
                ra_tv=ra_tv[w], raa_act=raa_act[w], raa_tv=raa_tv[w],
                self_all=self_all[w], veto=stx.veto[w], a_cnt=stx.a_cnt[w],
                a_total=stx.a_total[w], aa_cnt=stx.aa_cnt[w],
                iscore=stx.iscore[w])
            feasible = feasible & group_mask_view(view, fam)
        if norm_live:
            s_taint = default_normalize(taint_raw[w], feasible, reverse=True)
            s_na = default_normalize(na_raw[w], feasible, reverse=False)
            tn = cfg.w_taint * s_taint + cfg.w_node_affinity * s_na
        else:
            # static_norm_ok: every raw count is zero, so DefaultNormalize
            # degenerates to the constants 100 / 0
            tn = cfg.w_taint * MAX_SCORE
        total = (cfg.w_fit * stx.s_fit[w] + cfg.w_balanced * stx.s_bal[w]
                 + tn + cfg.w_image * s_img[w])
        if has_groups:
            total = total + group_scores_view(cfg.w_spread, cfg.w_ipa, view,
                                              feasible, fam)
        return feasible, total

    def _argmax(feasible, total):
        masked = torch.where(feasible, total, torch.full_like(total, -1))
        best = int(torch.argmax(masked))
        return best, int(masked[best]) >= 0

    # the speculative choice of every slot at the pre-span state
    spec_y = []
    for s in range(S):
        b, ok = _argmax(*_eval(st, s))
        spec_y.append(b if ok else -1)

    cols, slots = _cols(cfg)
    nz = torch.tensor(cfg.col_nonzero, device=dev)

    def same_tv(tv, tvb):
        return (tv == tvb[..., None]) & (tvb[..., None] != 0)

    valid = [bool(v) for v in xs.valid.tolist()]
    widx = [int(w) for w in xs.widx.tolist()]
    ys = []
    clean, n_conf, prefix = True, 0, 0
    for v, w in zip(valid, widx):
        best, ok = _argmax(*_eval(st, w))
        assigned = ok and v
        if assigned:
            # a placement that does not happen adds zeros everywhere, so
            # the unassigned step is the identity
            used = st.used.clone()
            used[best] += rows.req[w]
            nzu = st.nonzero_used.clone()
            nzu[best] += rows.nonzero_req[w]
            npods = st.npods.clone()
            npods[best] += 1
            # refresh the fit surfaces of EVERY slot at the touched node
            # (_row_refresh semantics, batched over the slots)
            cap_row, used_row, nz_row = na.cap[best], used[best], nzu[best]
            fit_b = ((npods[best] + 1 <= na.allowed_pods[best])
                     & ((rows.req == 0)
                        | (used_row[None] + rows.req <= cap_row[None]))
                     .all(dim=1))
            cap_r = cap_row[cols][None, :]
            used_pl_r = used_row[cols][None, :] + rows.req[:, cols]
            used_cols_r = torch.where(
                nz[None, :], nz_row[slots][None, :]
                + rows.nonzero_req[:, slots], used_pl_r)
            sfit_b = least_allocated(cfg, cap_r, used_cols_r)
            bal_b = balanced_allocation(cap_r, used_pl_r)
            sbal_b = torch.where(rows.skip_balanced, torch.zeros_like(bal_b),
                                 bal_b)

            def put_col(arr, new):
                out = arr.clone()
                out[:, best] = new
                return out

            upd = dict(used=used, nonzero_used=nzu, npods=npods,
                       fit_ok=put_col(st.fit_ok, fit_b),
                       s_fit=put_col(st.s_fit, sfit_b),
                       s_bal=put_col(st.s_bal, sbal_b))
            # the group_update increments with consumer axis U → S
            if has_groups and fam.spr_f:
                inc = ((m_f[w] & f_elig[:, :, best])[:, :, None]
                       & same_tv(f_tv, f_tv[:, :, best]))
                upd["f_cnt"] = st.f_cnt + inc.to(_I32)
            if has_groups and fam.spr_s:
                tvb = s_tv[:, :, best]
                is_b = (torch.arange(s_tv.shape[-1], device=dev)
                        == best)[None, None, :]
                share = torch.where(s_ishost[:, :, None], is_b,
                                    same_tv(s_tv, tvb))
                gate_c = torch.where(s_ishost, m_s[w],
                                     m_s[w] & s_elig[:, :, best])
                upd["s_cnt"] = st.s_cnt + (gate_c[:, :, None]
                                           & share).to(_I32)
            if has_groups and fam.ipa_anti:
                share_anti = same_tv(raa_tv[w], raa_tv[w][:, best])
                upd["veto"] = st.veto + (m_ex[w][:, :, None]
                                         & share_anti[None]).sum(
                    dim=1).to(_I32)
                inc_aa = m_aa[w][:, :, None] & same_tv(raa_tv,
                                                       raa_tv[:, :, best])
                upd["aa_cnt"] = st.aa_cnt + inc_aa.to(_I32)
            if has_groups and fam.ipa_req:
                tvb_a = ra_tv[:, :, best]
                inc_a = ((m_a[w][:, None] & ra_act)[:, :, None]
                         & same_tv(ra_tv, tvb_a))
                upd["a_cnt"] = st.a_cnt + inc_a.to(_I32)
                upd["a_total"] = st.a_total + (
                    m_a[w].to(_I64) * (ra_act & (tvb_a != 0)).sum(dim=1))
            if has_groups and fam.ipa_score:
                d_cons = (w_c[w][:, :, None]
                          * same_tv(stc_tv, stc_tv[:, :, best])).sum(dim=1)
                share_p = same_tv(stp_tv[w], stp_tv[w][:, best])
                d_plcd = (w_p[w][:, :, None] * share_p[None]).sum(dim=1)
                upd["iscore"] = st.iscore + d_cons + d_plcd
            if has_groups:
                cnt_sn = st.cnt_sn.clone()
                cnt_sn[w, best] += 1
                upd["cnt_sn"] = cnt_sn
            pp = rows.port_ids[w]
            if has_ports and bool((pp != 0).any()):
                # the pod's port ids into the first free slots of the
                # chosen node's row (_apply_assignment's port logic)
                prow = st.ports[best]
                free = prow == 0
                rank = torch.cumsum(free.to(_I64), dim=0) - 1
                nport = pp.shape[0]
                incoming = torch.where(
                    (rank >= 0) & (rank < nport) & free,
                    pp[rank.clamp(0, nport - 1)], torch.zeros_like(prow))
                ports = st.ports.clone()
                ports[best] = torch.where(free, incoming, prow)
                upd["ports"] = ports
            st = st._replace(**upd)
        y = best if assigned else -1
        conflict = v and y != spec_y[w]
        prefix += int(clean and v and not conflict)
        clean = clean and not conflict
        n_conf += int(conflict)
        ys.append(y)

    new_gc = (wave_fold(gd, gc, wt, st.cnt_sn, fam=fam) if has_groups
              else carry.groups)
    new_carry = Carry(used=st.used, nonzero_used=st.nonzero_used,
                      npods=st.npods,
                      ports=st.ports if has_ports else carry.ports,
                      cache=carry.cache._replace(sig=torch.zeros(
                          (), dtype=_I32, device=dev)),
                      groups=new_gc)
    packed = torch.tensor(ys + [n_conf, prefix], dtype=_I32, device=dev)
    return new_carry, packed


def run_plan(cfg: ScoreConfig, na: NodeArrays, carry: Carry, xs: WaveXs,
             table: PodTableDev, wt, gd, statics, fam, norm_live: bool,
             has_groups: bool = True, has_ports: bool = False):
    """The drain compiler's plan program for one mixed-signature span (see
    the JAX package's `_run_wave_scan_impl` for the exactness argument).
    `wt` (sequence of int, S ≤ PLAN_MAX_SIGS, padded by repeating the
    last row) are the span's table rows, `xs.widx` maps each pod to its
    slot, `statics` are the rows' wave_statics stacked ([S, N] each).
    Phase A evaluates every slot at the pre-span carry and records its
    speculative argmax; Phase B replays the span exactly in serial order
    over the maintained fit surfaces and group counters (and, with
    `has_ports`, the ports carry); the epilogue folds the placements into
    the full group carry. `has_groups=False` is the lean variant (no group
    state; `gd` may be None). Returns (carry', packed i32 [W+2]):
    assignments (-1 = none), then the conflict count and the conflict-free
    prefix length. Never writes into `carry`."""
    dev = carry.used.device
    if len(wt) > PLAN_MAX_SIGS:
        raise ValueError(f"run_plan: {len(wt)} signature slots > "
                         f"{PLAN_MAX_SIGS}")
    if has_groups and (gd is None or carry.groups is None):
        raise ValueError("run_plan: has_groups needs gd and carry.groups")
    na, carry, xs, table, gd, statics = RAILS.stage(
        (na, carry, xs, table, gd, statics), dev)
    if dev.type == "cuda":
        from .kernels import run_plan_cuda
        return run_plan_cuda(cfg, na, carry, xs, table, wt, gd, statics, fam,
                             norm_live, has_groups, has_ports)
    if dev.type != "cpu":
        raise RuntimeError(f"run_plan: unsupported device {dev}")
    return _run_plan_plain(cfg, na, carry, xs, table, wt, gd, statics, fam,
                           norm_live, has_groups, has_ports)


# ---------------------------------------------------------------------------
# mask diagnosis: each node's first failing filter, in the host plugin
# order (a node's status comes from the first plugin that rejects it),
# plus the per-resource fit detail the NodeResourcesFit reasons need

DIAG_FEASIBLE = 0
DIAG_INVALID = -1                 # padding / freed node row
DIAG_NODE_UNSCHEDULABLE = 1
DIAG_NODE_NAME = 2
DIAG_TAINT = 3
DIAG_NODE_AFFINITY = 4
DIAG_PORTS = 5
DIAG_FIT = 6
DIAG_SPREAD_LABEL = 7             # missing topology key (unresolvable)
DIAG_SPREAD_SKEW = 8
DIAG_IPA_AFFINITY = 9
DIAG_IPA_ANTI = 10
DIAG_IPA_EXISTING_ANTI = 11


def _diagnose_plain(na: NodeArrays, table: PodTableDev, tidx: int, gd=None,
                    gc=None, fam=None):
    """The JAX package's _diagnose_masks for table row `tidx`."""
    from .groups import group_reason_masks

    pod = _gather_row(table, int(tidx), True, 0)
    unsched_ok = ~na.unschedulable | pod.tolerates_unsched
    name_ok = (pod.node_name_id == 0) | (na.name_id == pod.node_name_id)
    taint_ok = taint_filter_mask(na, pod)
    sel_ok = selector_mask(na, pod)
    ports_ok = ports_mask(na.ports, pod.port_ids)
    pods_fail = na.npods + 1 > na.allowed_pods
    cols_fail = (pod.req[None, :] != 0) & (na.used + pod.req[None, :]
                                           > na.cap)           # [N, R]
    fit_ok = ~pods_fail & ~cols_fail.any(dim=1)
    false = torch.zeros_like(na.valid)
    if gd is not None:
        group = group_reason_masks(gd, gc, int(tidx), fam)
    else:
        group = (false,) * 5
    # jnp.select: the first true condition wins, so apply them last first
    conds = [~na.valid, ~unsched_ok, ~name_ok, ~taint_ok, ~sel_ok,
             ~ports_ok, ~fit_ok, *group]
    vals = [DIAG_INVALID, DIAG_NODE_UNSCHEDULABLE, DIAG_NODE_NAME,
            DIAG_TAINT, DIAG_NODE_AFFINITY, DIAG_PORTS, DIAG_FIT,
            DIAG_SPREAD_LABEL, DIAG_SPREAD_SKEW, DIAG_IPA_AFFINITY,
            DIAG_IPA_ANTI, DIAG_IPA_EXISTING_ANTI]
    slot = torch.full(na.valid.shape, DIAG_FEASIBLE, dtype=_I32,
                      device=na.valid.device)
    for c, v in zip(reversed(conds), reversed(vals)):
        slot = torch.where(c, torch.full_like(slot, v), slot)
    return slot, pods_fail, cols_fail


def diagnose_row(na: NodeArrays, table: PodTableDev, tidx: int, gd=None,
                 gc=None, fam=None):
    """Reduce the filter masks of signature row `tidx` against node state
    `na` (used/npods/ports = the post-commit truth) into (slot i32 [N],
    pods_fail bool [N], cols_fail bool [N, R]): `slot` holds each node's
    first failing filter (DIAG_*), the fit arrays the detail of DIAG_FIT
    nodes ("Too many pods" / per-column Insufficient). With `gd` (and the
    group carry `gc`, families `fam`) the spread and inter-pod filters
    take part; without, the lean filters only. The one-row case of
    `diagnose_rows`."""
    N, R = na.cap.shape
    slot, pods_fail, cols_fail = diagnosis_views(
        diagnose_rows(na, table, [tidx], gd, gc, fam), 1, N, R)
    return slot[0], pods_fail[0], cols_fail[0]


def diagnosis_views(packed, S: int, N: int, R: int):
    """(slot i32 [S, N], pods_fail bool [S, N], cols_fail bool [S, N, R]):
    views of `diagnose_rows`' packed bytes (a tensor on any device)."""
    k = S * N
    return (packed[:4 * k].view(_I32).view(S, N),
            packed[4 * k:5 * k].view(torch.bool).view(S, N),
            packed[5 * k:].view(torch.bool).view(S, N, R))


def _diagnose_rows_plain(na: NodeArrays, table: PodTableDev, rows, gd=None,
                         gc=None, fam=None):
    outs = [_diagnose_plain(na, table, u, gd, gc, fam) for u in rows]
    return torch.cat([torch.stack(xs).view(torch.uint8).reshape(-1)
                      for xs in zip(*outs)])


def diagnose_args(na: NodeArrays, table: PodTableDev, gd=None, gc=None,
                  fam=None):
    """A diagnosis context's packed argument block for the CUDA kernel
    (ops/kernels.py DiagArgs: checked once, holding every tensor it
    points into); None on the CPU, where the plain version reads the
    tensors."""
    dev = na.valid.device
    if dev.type == "cuda":
        from .kernels import DiagArgs
        return DiagArgs(na, table, gd, gc, fam)
    if dev.type != "cpu":
        raise RuntimeError(f"diagnose_args: unsupported device {dev}")
    return None


def diagnose_rows(na: NodeArrays, table: PodTableDev, rows, gd=None,
                  gc=None, fam=None, args=None):
    """`diagnose_row` of every table row in `rows` (at most
    kernels.MAX_DIAG_ROWS on the card) → its outputs packed in one uint8
    tensor: slot i32 [S, N], then pods_fail [S, N], then cols_fail
    [S, N, R] (`diagnosis_views`). Row s's outputs are those of
    `diagnose_row(..., rows[s], ...)`. On the card ONE launch, against
    `args` when given (`diagnose_args` of the same tensors)."""
    dev = na.valid.device
    if (gd is None) != (gc is None):
        raise ValueError("diagnose_row: gd and gc go together")
    na, table, gd, gc = RAILS.stage((na, table, gd, gc), dev)
    if dev.type == "cuda":
        from .kernels import DiagArgs, diagnose_rows_cuda
        if args is None:
            args = DiagArgs(na, table, gd, gc, fam)
        return diagnose_rows_cuda(args, (na, table, gd, gc), rows)
    if dev.type != "cpu":
        raise RuntimeError(f"diagnose_row: unsupported device {dev}")
    return _diagnose_rows_plain(na, table, [int(u) for u in rows], gd, gc,
                                fam)


def diagnosis_read_back(packed, S: int, N: int, R: int):
    """`diagnose_rows`' packed output as numpy (slot, pods_fail,
    cols_fail): from the card through one pinned buffer, after the stream
    reaches it."""
    host = torch.from_numpy(read_back(packed))
    return tuple(x.numpy() for x in diagnosis_views(host, S, N, R))


# ---------------------------------------------------------------------------
# preemption dry run (preemption.go:775 DryRunPreemption): the
# per-candidate-node host loop of select_victims_on_node as one program
# over the candidate axis

def pod_row_from_table(table, u: int, device, sig: int = 0) -> PodRow:
    """One signature row of a (numpy) PodTable as the kernels' PodRow, on
    `device`."""
    import numpy as np
    from ..state.convert import POD_TABLE_DTYPES
    fields = {name: torch.as_tensor(np.array(getattr(table, name)[u]),
                                    dtype=POD_TABLE_DTYPES[name],
                                    device=device)
              for name in PodTableDev._fields}
    return PodRow(valid=True, sig=int(sig), **fields)


def _dry_run_spread_ok(sp, removed):
    """Spread feasibility of the preemptor on every candidate, given
    `removed` i32 [C, SC] matching victims currently removed: missing key
    → infeasible; matchNum + selfMatch − min > maxSkew → infeasible, with
    the criticalPaths closed form min(x, other) and the minDomains zero
    floor (ops/groups.py spread_dry_run_tensors)."""
    x = sp.cnt0 - removed
    min_eff = torch.where(sp.min_zero[None, :], torch.zeros_like(x),
                          torch.minimum(x, sp.other_min))
    ok = x + sp.self_match[None, :] - min_eff <= sp.max_skew[None, :]
    return (sp.tv_ok & ok).all(dim=1)


def _dry_run_select_victims_plain(na: NodeArrays, pod: PodRow, cand,
                                  victim_req, victim_valid, ovl_used,
                                  ovl_npods, spread=None):
    """The JAX package's _dry_run_select_victims_jit, the victim scan a
    Python loop over V (plain version)."""
    idx = cand.to(_I64)
    na_c = NodeArrays(*(x[idx] for x in na))
    m = na_c.valid.clone()
    m &= (pod.node_name_id == 0) | (na_c.name_id == pod.node_name_id)
    m &= ~na_c.unschedulable | pod.tolerates_unsched
    m &= taint_filter_mask(na_c, pod)
    m &= selector_mask(na_c, pod)
    nv = victim_valid.sum(dim=1).to(na_c.npods.dtype)
    total_req = torch.where(victim_valid[:, :, None], victim_req,
                            torch.zeros_like(victim_req)).sum(dim=1)
    base_used = na_c.used + ovl_used - total_req
    base_npods = na_c.npods + ovl_npods - nv
    fits = m & fit_mask(na_c.cap, base_used, base_npods, na_c.allowed_pods,
                        pod.req)
    C, V = victim_valid.shape
    if spread is not None:
        vm = spread.vic_match.to(_I32)                          # [C, V, SC]
        removed = torch.where(victim_valid[:, :, None], vm,
                              torch.zeros_like(vm)).sum(dim=1).to(_I32)
        fits &= _dry_run_spread_ok(spread, removed)
    else:
        vm = torch.zeros((C, V, 0), dtype=_I32, device=victim_req.device)
        removed = torch.zeros((C, 0), dtype=_I32, device=victim_req.device)
    used, npods = base_used, base_npods
    reprieved = []
    for v in range(V):
        t_used = used + victim_req[:, v]
        t_npods = npods + 1
        ok = victim_valid[:, v] & (t_npods + 1 <= na_c.allowed_pods)
        ok &= ((pod.req[None, :] == 0)
               | (t_used + pod.req[None, :] <= na_c.cap)).all(dim=1)
        t_removed = removed - vm[:, v]
        if spread is not None:
            ok &= _dry_run_spread_ok(spread, t_removed)
        used = torch.where(ok[:, None], t_used, used)
        npods = torch.where(ok, t_npods, npods)
        removed = torch.where(ok[:, None], t_removed, removed)
        reprieved.append(ok)
    return torch.cat([fits[:, None], torch.stack(reprieved, dim=1)], dim=1)


def dry_run_select_victims(na: NodeArrays, pod: PodRow, cand, victim_req,
                           victim_valid, ovl_used, ovl_npods, spread=None):
    """Batched select_victims_on_node (default_preemption.go:583) over the
    candidate-node axis; see the JAX package's
    `_dry_run_select_victims_jit` for the exactness argument.

    cand         i32 [C]      node-row indices into `na` (padding repeats
                              a real row; the caller ignores its outputs)
    victim_req   i64 [C,V,R]  potential victims' requests in REPRIEVE
                              order (PDB-violating first, then priority
                              desc / creation asc)
    victim_valid bool [C,V]
    ovl_used     i64 [C,R]    ≥-priority nominated pods (self excluded)
    ovl_npods    i32 [C]      folded into the fit
    spread       ops/groups.py DryRunSpread when the preemptor carries
                 DoNotSchedule spread constraints

    Returns bool [C, V+1]: column 0 = the preemptor fits with every victim
    removed; column 1+v = victim v is reprieved (added back, most
    important first, while the preemptor still fits). Never writes its
    inputs."""
    dev = victim_req.device
    (na, pod, cand, victim_req, victim_valid, ovl_used, ovl_npods,
     spread) = RAILS.stage((na, pod, cand, victim_req, victim_valid,
                            ovl_used, ovl_npods, spread), dev)
    if dev.type == "cuda":
        from .kernels import dry_run_select_victims_cuda
        return dry_run_select_victims_cuda(na, pod, cand, victim_req,
                                           victim_valid, ovl_used, ovl_npods,
                                           spread)
    if dev.type != "cpu":
        raise RuntimeError(f"dry_run_select_victims: unsupported device {dev}")
    return _dry_run_select_victims_plain(na, pod, cand, victim_req,
                                         victim_valid, ovl_used, ovl_npods,
                                         spread)


class DryRunWave(NamedTuple):
    """The dry run's wave-constant inputs: one preemptor signature against
    one cluster state (framework/preemption.py _DryRunPlan). `cand`,
    `victim_req`, `victim_valid` and the spread tensors share the plan's
    candidate axis."""
    na: NodeArrays
    pod: PodRow
    cand: torch.Tensor
    victim_req: torch.Tensor
    victim_valid: torch.Tensor
    spread: object = None


def dry_run_args(wave: DryRunWave):
    """The wave's packed argument block for the CUDA kernel
    (ops/kernels.py DryRunArgs: checked once, holding every tensor it
    points into); None on the CPU, where the plain version reads the
    tensors."""
    dev = wave.victim_req.device
    if dev.type == "cuda":
        from .kernels import DryRunArgs
        return DryRunArgs(wave)
    if dev.type != "cpu":
        raise RuntimeError(f"dry_run_args: unsupported device {dev}")
    return None


def _dry_run_subset_plain(na: NodeArrays, pod: PodRow, cand, victim_req,
                          victim_valid, sub, ovl_used, ovl_npods,
                          spread=None):
    """The subset entry's plain version: the candidate positions `sub`
    gathered out of the wave's tensors (the JAX package's
    _dry_run_overrides), then the plain dry run."""
    if sub is not None:
        idx = sub.to(_I64)
        cand, victim_req, victim_valid = (cand[idx], victim_req[idx],
                                          victim_valid[idx])
        if spread is not None:
            spread = spread._replace(
                tv_ok=spread.tv_ok[idx], cnt0=spread.cnt0[idx],
                other_min=spread.other_min[idx],
                vic_match=spread.vic_match[idx])
    return _dry_run_select_victims_plain(na, pod, cand, victim_req,
                                         victim_valid, ovl_used, ovl_npods,
                                         spread)


def dry_run_select_victims_subset(wave: DryRunWave, sub, ovl_used,
                                  ovl_npods, args=None):
    """`dry_run_select_victims` over the candidate positions `sub` (i32
    [s], positions into the wave's candidate axis; None: every candidate)
    of a preemptor wave: the Evaluator's per-preemptor launch over the
    candidates its nominations touch. `ovl_used` [s, R] / `ovl_npods` [s]
    and the returned bool [s, V+1] are in the order of `sub`. On the card
    the kernel reads the wave's tensors through `sub` in place, with the
    wave's packed argument block `args` (`dry_run_args(wave)`); on the
    CPU the plain version gathers them. Never writes its inputs."""
    dev = wave.victim_req.device
    sub, ovl_used, ovl_npods = RAILS.stage((sub, ovl_used, ovl_npods), dev)
    if dev.type == "cuda":
        from .kernels import dry_run_subset_cuda
        return dry_run_subset_cuda(args, wave, sub, ovl_used, ovl_npods)
    if dev.type != "cpu":
        raise RuntimeError(f"dry_run_select_victims_subset: unsupported "
                           f"device {dev}")
    return _dry_run_subset_plain(*wave[:5], sub, ovl_used, ovl_npods,
                                 wave.spread)


def dry_run_subset_inputs(sub, ovl_used, ovl_npods, device):
    """(sub i32 [s], ovl_used i64 [s, R], ovl_npods i32 [s]) on `device`
    from their numpy values; on a CUDA device through ONE pinned buffer and
    one non-blocking copy, the three tensors views of that copy."""
    import numpy as np
    s, R = ovl_used.shape
    h = (s + 1) // 2                # int32 values in int64 words
    cuda = torch.device(device).type == "cuda"
    buf = torch.empty((2 * h + s * R,), dtype=_I64, pin_memory=cuda)
    b = buf.numpy()
    b[:h].view(np.int32)[:s] = sub
    b[h:h + s * R] = np.asarray(ovl_used, np.int64).reshape(-1)
    b[h + s * R:].view(np.int32)[:s] = ovl_npods
    if cuda:
        buf = buf.to(device, non_blocking=True)
    return (buf[:h].view(_I32)[:s], buf[h:h + s * R].view(s, R),
            buf[h + s * R:].view(_I32)[:s])


def read_back(packed):
    """A packed output (the dry run's, the diagnosis's) as a numpy array:
    from the card through one pinned buffer, after the stream reaches
    it."""
    if packed.device.type != "cuda":
        return packed.numpy()
    host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
    host.copy_(packed, non_blocking=True)
    torch.cuda.current_stream(packed.device).synchronize()
    return host.numpy()


# ---------------------------------------------------------------------------
# decision provenance: per-plugin score decomposition of one row
#
# diagnose_row answers "why did every node reject this pod"; explain_row
# answers the complement, "why did the winning node win": the per-plugin
# score columns of the top-k nodes, evaluated through the scan's own
# formula (_eval_pod), so the reported winner is the argmax the scan
# takes for this row at this carry.

# explain column order: weighted Fit, BalancedAllocation,
# TaintToleration, NodeAffinity, ImageLocality, and the combined group
# contribution (PodTopologySpread + InterPodAffinity: group_scores
# returns their sum)
EXPLAIN_COLUMNS = ("NodeResourcesFit", "NodeResourcesBalancedAllocation",
                   "TaintToleration", "NodeAffinity", "ImageLocality",
                   "PodTopologySpread+InterPodAffinity")
EXPLAIN_MAX_K = 16


def _explain_plain(cfg: ScoreConfig, na: NodeArrays, carry: Carry,
                   table: PodTableDev, tidx: int, k: int, gd=None,
                   fam=None):
    """The JAX package's _explain_masks (plain version): sig 0, so the
    SigCache is never consulted; no overlay."""
    pod = _gather_row(table, int(tidx), True, 0)
    feasible, total, parts = _eval_pod(cfg, na, carry, pod, groups=gd,
                                       tidx=int(tidx), fam=fam)
    masked = torch.where(feasible, total, torch.full_like(total, -1))
    s_taint = default_normalize(parts.taint_raw, feasible, reverse=True)
    s_na = default_normalize(parts.na_raw, feasible, reverse=False)
    base = (cfg.w_fit * parts.s_fit + cfg.w_balanced * parts.s_bal
            + cfg.w_taint * s_taint + cfg.w_node_affinity * s_na
            + cfg.w_image * parts.s_img)
    cols = torch.stack([cfg.w_fit * parts.s_fit,
                        cfg.w_balanced * parts.s_bal,
                        cfg.w_taint * s_taint,
                        cfg.w_node_affinity * s_na,
                        cfg.w_image * parts.s_img,
                        total - base], dim=1)                  # [N, 6]
    # scores are bounded by 100·Σweights: the int32 top-k (ties to the
    # lowest index) reproduces the scan's first-max argmax tie-break
    idx = _topk_lowest_index(masked.to(_I32).to(_I64), k).to(_I32)
    return (idx, masked[idx.to(_I64)], cols[idx.to(_I64)],
            feasible.sum().to(_I32))


def explain_row(cfg: ScoreConfig, na: NodeArrays, carry: Carry,
                table: PodTableDev, tidx: int, k: int = 8, gd=None,
                fam=None):
    """Score decomposition of signature row `tidx` against `carry`:
    (topk_idx i32 [k], topk_total i64 [k] (-1 = infeasible slot),
    topk_cols i64 [k, 6] per-plugin weighted contributions in
    EXPLAIN_COLUMNS order, feasible_count i32). topk_idx[0] is the argmax
    the scan takes for this row at this carry (same _eval_pod formula,
    same tie-break); the win margin is topk_total[0] - topk_total[1].
    With `gd` (and `carry.groups`, families `fam`) the group mask and
    scores take part. k ≤ 16 and k ≤ N. Never writes its inputs."""
    k = int(k)
    if not 1 <= k <= min(EXPLAIN_MAX_K, na.valid.shape[0]):
        raise ValueError(f"explain_row: k = {k} outside 1..min(16, N)")
    if (gd is None) != (carry.groups is None):
        raise ValueError("explain_row: gd and carry.groups go together")
    dev = carry.used.device
    na, carry, table, gd = RAILS.stage((na, carry, table, gd), dev)
    if dev.type == "cuda":
        from .kernels import explain_row_cuda
        return explain_row_cuda(cfg, na, carry, table, tidx, k, gd, fam)
    if dev.type != "cpu":
        raise RuntimeError(f"explain_row: unsupported device {dev}")
    return _explain_plain(cfg, na, carry, table, tidx, k, gd, fam)


# ---------------------------------------------------------------------------
# cluster analytics: the state probe over the resident carry
#
# The carry resident on the device after every drain IS the cluster
# state: one reduction over it yields utilization, fragmentation and
# domain-imbalance signals at no extra host-to-device copy. Every
# cross-node reduction is exact int64 arithmetic; floats appear only in
# elementwise division and compare, the order statistics and gathers, so
# the probe is bit-reproducible between the plain version, the kernel
# and the JAX package.

# per-resource stat columns of the probe's first output, in order
PROBE_STATS = ("p50", "p90", "p99", "max", "mean", "frag", "stranded")
# nearest-rank percentile ranks (idx = floor(q·(m-1) + 0.5) over the m
# nodes advertising the resource)
_PROBE_QS = (0.5, 0.9, 0.99)
# a node whose bottleneck-resource utilization reaches this is "tight":
# its remaining free capacity in OTHER resources counts as stranded
PROBE_TIGHT = 0.95
# the domain stat columns of the probe's second output
PROBE_DOM_STATS = ("domains", "max", "min", "spread")

_F32 = torch.float32


def _f32_ratio(num, den):
    """num / max(den, 1), both int64 cast to float32 first (the JAX
    package's `a.astype(f32) / jnp.maximum(b, 1).astype(f32)`)."""
    return num.to(_F32) / den.clamp(min=1).to(_F32)


def _probe_plain(cap_in, valid, used_in, npods, dom, ndom: int):
    """The JAX package's _probe_math (plain version) on cap i64 [N, R],
    valid bool [N], used i64 [N, R], npods i32 [N], dom i32 [N]."""
    zero_f = torch.zeros((), dtype=_F32, device=cap_in.device)
    # a (node, resource) cell participates when the node is valid and
    # advertises capacity for the resource
    part = valid[:, None] & (cap_in > 0)                        # [N, R]
    used = torch.where(part, used_in, torch.zeros_like(used_in))
    cap = torch.where(part, cap_in, torch.zeros_like(cap_in))
    util = torch.where(part, _f32_ratio(used, cap),
                       torch.full(cap.shape, -1.0, dtype=_F32,
                                  device=cap.device))           # f32 [N, R]
    m = part.sum(dim=0).to(_I32)                                # [R]
    n_total = util.shape[0]
    # percentiles: non-participants sort to the front as -1, so the m
    # participants occupy [N-m, N) of each sorted column; nearest rank at
    # N-m+idx, the index math in float64
    srt = torch.sort(util, dim=0).values
    mf = m.to(torch.float64)
    qcols = []
    for q in _PROBE_QS + (1.0,):
        idx = torch.floor(q * (mf - 1.0) + 0.5).to(_I32)
        at = (n_total - m + idx).clamp(0, n_total - 1).to(_I64)
        got = torch.gather(srt, 0, at[None, :])[0]
        qcols.append(torch.where(m > 0, got, zero_f))
    # aggregate mean utilization: exact int64 sums, one float division
    sum_used = used.sum(dim=0)
    sum_cap = cap.sum(dim=0)
    mean = torch.where(sum_cap > 0, _f32_ratio(sum_used, sum_cap), zero_f)
    # fragmentation: 1 - (largest single free block / total free)
    free = cap - used
    tot_free = free.sum(dim=0)
    max_free = free.max(dim=0).values
    frag = torch.where(tot_free > 0, 1.0 - _f32_ratio(max_free, tot_free),
                       zero_f)
    # stranded capacity: free units on nodes whose bottleneck resource is
    # already >= PROBE_TIGHT utilized (compared in float32)
    bottleneck = torch.where(part, util, zero_f).max(dim=1).values  # [N]
    tight = valid & (bottleneck >= torch.tensor(PROBE_TIGHT, dtype=_F32,
                                                 device=cap_in.device))
    stranded_free = torch.where(tight[:, None], free,
                                torch.zeros_like(free)).sum(dim=0)
    stranded = torch.where(tot_free > 0, _f32_ratio(stranded_free, tot_free),
                           zero_f)
    per_res = torch.stack(qcols + [mean, frag, stranded], dim=1)  # [R, 7]
    # per-domain pod density over the gang engine's dom-id column: exact
    # int64 scatter-adds; spread = max - min over populated domains
    dclip = dom.to(_I64).clamp(0, ndom - 1)
    dom_pods = torch.zeros((ndom,), dtype=_I64, device=dom.device)
    dom_pods.index_add_(0, dclip, torch.where(
        valid, npods, torch.zeros_like(npods)).to(_I64))
    dom_nodes = torch.zeros((ndom,), dtype=_I64, device=dom.device)
    dom_nodes.index_add_(0, dclip, valid.to(_I64))
    has = dom_nodes > 0
    load = torch.where(has, _f32_ratio(dom_pods, dom_nodes), zero_f)
    any_dom = has.any()
    inf = torch.tensor(float("inf"), dtype=_F32, device=dom.device)
    dmax = torch.where(has, load, -inf).max()
    dmin = torch.where(has, load, inf).min()
    dom_stats = torch.stack([
        has.sum().to(_F32),
        torch.where(any_dom, dmax, zero_f),
        torch.where(any_dom, dmin, zero_f),
        torch.where(any_dom, dmax - dmin, zero_f)])             # f32 [4]
    return per_res, dom_stats, valid.sum().to(_I32)


def cluster_probe(na: NodeArrays, carry: Carry, dom, ndom: int):
    """Cluster-state reduction over the resident carry: (per_res f32
    [R, 7] — PROBE_STATS columns per resource, dom_stats f32 [4] —
    (populated domains, max, min, spread) of per-domain pod density,
    valid_count i32). `dom` is the gang engine's topology dom-id column
    (i32 [N]), `ndom` its domain count. Reads the carry, never writes
    it."""
    ndom = int(ndom)
    if ndom < 1:
        raise ValueError(f"cluster_probe: ndom = {ndom} < 1")
    dev = carry.used.device
    na, carry, dom = RAILS.stage((na, carry, dom), dev)
    if dev.type == "cuda":
        from .kernels import cluster_probe_cuda
        out = cluster_probe_cuda(na.cap, na.valid, carry.used, carry.npods,
                                 dom, ndom)
    elif dev.type != "cpu":
        raise RuntimeError(f"cluster_probe: unsupported device {dev}")
    else:
        out = _probe_plain(na.cap, na.valid, carry.used, carry.npods, dom,
                           ndom)
    return RAILS.observe("cluster_probe", out)


# ---------------------------------------------------------------------------
# the sanitizer rails' score probe: the float score surface of one row
#
# The int64 scores cannot hold a NaN, and BalancedAllocation's int floor
# would bury one as garbage, so the probe re-derives the float std before
# the floor. One launch per device drain with the SanitizerRails gate on
# (analysis/rails.py check_scores), never otherwise.


def _score_probe_plain(cfg: ScoreConfig, na: NodeArrays, carry: Carry,
                       table: PodTableDev, tidx: int):
    pod = _gather_row(table, tidx, True, 0)
    s_fit, s_bal = _fit_scores(cfg, na, carry, pod)
    cols, _ = _cols(cfg)
    used_bal = carry.used[:, cols] + pod.req[cols][None, :]
    std = _balanced_std(*_fracs(na.cap[:, cols], used_bal))
    total = (cfg.w_fit * s_fit + cfg.w_balanced * s_bal).to(torch.float32)
    return total, std.to(torch.float32)


def score_probe(cfg: ScoreConfig, na: NodeArrays, carry: Carry,
                table: PodTableDev, tidx: int):
    """Score surface of signature row `tidx` against `carry`, in float:
    (the combined fit + balanced score f32 [N], the BalancedAllocation
    std f32 [N]), padded rows included, as the JAX package's score_probe
    computes them. Reads its inputs only."""
    tidx = int(tidx)
    dev = carry.used.device
    na, carry, table = RAILS.stage((na, carry, table), dev)
    if dev.type == "cuda":
        from .kernels import score_probe_cuda
        out = score_probe_cuda(cfg, na, carry, table, tidx)
    elif dev.type != "cpu":
        raise RuntimeError(f"score_probe: unsupported device {dev}")
    else:
        out = _score_probe_plain(cfg, na, carry, table, tidx)
    return RAILS.observe("score_probe", out)
