"""Gang placement: a whole pod group solved as ONE device dispatch.

Counterpart of kubernetes_tpu/ops/gang.py. Once PreEnqueue quorum is met
on the host, the gang's members are one batched assignment problem — per
signature filter surfaces over the node axis, a sequential-greedy
placement replay, and a single feasibility reduction (`placed >= needed`)
that accepts or rejects the ENTIRE gang atomically. The accepted gang
commits with no Reserve/Permit/Unreserve churn; the rejected gang unwinds
on the device (the returned carry holds the input carry's values, cache
included), so no member ever holds partial resources.

Two tiers behind the one `run_gang` entry:

- **closed-form tier** (`uniform=True`): a single-signature gang under
  LeastAllocated rides the closed-form top-L matrix of run_uniform with
  the accept reduction on top. The carry applies only when the gang is
  accepted AND run_uniform's exactness and depth flags held; otherwise
  the scheduler replays the gang on the scan tier from the kept input
  carry.
- **scan tier** (`uniform=False`): the per-signature carry-independent
  surfaces arrive hoisted (the drain compiler's SurfaceCache rows, [S, N]
  each, like run_plan's); the fit surfaces are computed once at the
  gang's entry carry; the member scan then pays normalization, argmax and
  a touched-row refresh per step. With `w_contig > 0` one more
  DefaultNormalized column counts the members already placed in each
  node's topology domain (`dom`), so a gang prefers the domains it
  already occupies.

Each tier has a plain PyTorch version (`_run_gang_scan_plain`,
`_run_gang_uniform_plain`), a line-for-line translation of the JAX
program, and a hand-written CUDA kernel (csrc/run_gang.cu; for the closed
form csrc/run_uniform.cu with the gang verdict). `run_gang` takes the
plain version for CPU tensors, launches the kernel for CUDA tensors and
raises on any other device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .program import (RAILS, Carry, _fit_scores, _gather_row,
                      _run_uniform_plain, balanced_allocation,
                      default_normalize, fit_mask, least_allocated)

_I64, _I32 = torch.int64, torch.int32


class GangXs(NamedTuple):
    """Per-member scan inputs for one gang ([B] = pow2-padded member
    count; padding members are `valid=False`)."""

    valid: object    # bool [B]
    tidx: object     # i32 [B] — row into the PodTableDev
    widx: object     # i32 [B] — slot into the gang's signature set [S]


def _run_gang_scan_plain(cfg, na, carry: Carry, xs: GangXs, table, wt,
                         needed: int, dom, statics, w_contig: int):
    """Scan tier (ops/gang.py:65-188); returns (carry', packed i32 [B+4]):
    each member's RAW greedy assignment (-1 = no feasible node) whatever
    the verdict, then accept, placed and two always-true exactness flags
    (the closed-form tier's layout)."""
    n = na.npods.shape[0]
    dev = carry.used.device
    cols, slots = list(cfg.score_cols), list(cfg.nonzero_slot)
    nzmask = torch.tensor(cfg.col_nonzero, device=dev)
    static_m, taint_raw, na_raw, s_img = statics
    rows = [int(u) for u in wt]
    pods_s = [_gather_row(table, u, True, 0) for u in rows]
    fit_ok = torch.stack([fit_mask(na.cap, carry.used, carry.npods,
                                   na.allowed_pods, p.req) for p in pods_s])
    fs = [_fit_scores(cfg, na, carry, p) for p in pods_s]
    s_fit = torch.stack([f for f, _ in fs])
    s_bal = torch.stack([b for _, b in fs])
    used, nz, npods = carry.used, carry.nonzero_used, carry.npods
    domcnt = torch.zeros((n,), dtype=_I32, device=dev)
    placed = 0
    raw = []
    for v, t, s in zip(xs.valid.tolist(), xs.tidx.tolist(),
                       xs.widx.tolist()):
        pod = _gather_row(table, t, v, 0)
        feasible = static_m[s] & fit_ok[s]
        s_taint = default_normalize(taint_raw[s], feasible, reverse=True)
        s_na = default_normalize(na_raw[s], feasible, reverse=False)
        total = (cfg.w_fit * s_fit[s] + cfg.w_balanced * s_bal[s]
                 + cfg.w_taint * s_taint + cfg.w_node_affinity * s_na
                 + cfg.w_image * s_img[s])
        if w_contig:
            total = total + w_contig * default_normalize(
                domcnt[dom].to(_I64), feasible, reverse=False)
        masked = torch.where(feasible, total, torch.full_like(total, -1))
        best = int(torch.argmax(masked))         # first max
        assigned = bool(masked[best] >= 0) and bool(v)
        if not assigned:
            raw.append(-1)
            continue
        used = used.clone()
        nz = nz.clone()
        npods = npods.clone()
        used[best] += pod.req
        nz[best] += pod.nonzero_req
        npods[best] += 1
        # refresh the ONE touched row for every signature slot, duplicates
        # included (the _row_refresh arithmetic)
        cap_row, used_row = na.cap[best], used[best]
        for k, p in enumerate(pods_s):
            fit_ok[k, best] = ((npods[best] + 1 <= na.allowed_pods[best])
                               & ((p.req == 0)
                                  | (used_row + p.req <= cap_row)).all())
            cap_r = cap_row[cols][None, :]
            used_nz_r = nz[best][slots] + p.nonzero_req[slots]
            used_pl_r = used_row[cols] + p.req[cols]
            used_cols_r = torch.where(nzmask, used_nz_r, used_pl_r)[None, :]
            s_fit[k, best] = least_allocated(cfg, cap_r, used_cols_r)[0]
            bal = balanced_allocation(cap_r, used_pl_r[None, :])[0]
            s_bal[k, best] = torch.where(p.skip_balanced,
                                         torch.zeros_like(bal), bal)
        if w_contig:
            domcnt[dom[best]] += 1
        placed += 1
        raw.append(best)
    accept = torch.tensor(placed >= int(needed), device=dev)
    cache = carry.cache._replace(sig=torch.where(
        accept, torch.zeros_like(carry.cache.sig), carry.cache.sig))
    carry_out = carry._replace(used=torch.where(accept, used, carry.used),
                               nonzero_used=torch.where(accept, nz,
                                                        carry.nonzero_used),
                               npods=torch.where(accept, npods, carry.npods),
                               cache=cache)
    packed = torch.tensor(raw + [int(placed >= int(needed)), placed, 1, 1],
                          dtype=_I32, device=dev)
    return carry_out, packed


def _run_gang_uniform_plain(cfg, na, carry: Carry, x, table, n_actual: int,
                            needed: int, L: int, K: int, J: int):
    """Closed-form tier (ops/gang.py:198-218): run_uniform's top-L matrix
    with the gang verdict. The carry applies only when the gang is
    accepted and the exactness and depth flags held. packed i32 [L+4] =
    [assignments; accept; placed; exact; depth]."""
    new_carry, pu = _run_uniform_plain(cfg, na, carry, x, table, n_actual,
                                       L, K, J)
    assignments = pu[:L]
    ok, depth_ok = pu[L] != 0, pu[L + 1] != 0
    placed = (assignments >= 0).sum().to(_I32)
    accept = placed >= int(needed)
    apply = accept & ok & depth_ok

    def sel(a, b):
        if a is None:
            return None
        if isinstance(a, tuple):
            return type(a)(*(sel(u, v) for u, v in zip(a, b)))
        return torch.where(apply, a, b)

    carry_out = Carry(*(sel(a, b) for a, b in zip(new_carry, carry)))
    packed = torch.cat([assignments, torch.stack(
        [accept, placed, ok, depth_ok]).to(_I32)])
    return carry_out, packed


def run_gang(cfg, na, carry: Carry, xs, table, wt=None, needed: int = 0,
             dom=None, statics=None, w_contig: int = 0,
             uniform: bool = False, n_actual: int = 0, L: int = 0,
             K: int = 0, J: int = 0):
    """Whole-gang all-or-nothing assignment.

    `uniform=True` routes a single-signature gang to the closed-form tier
    (`xs` is then a one-row PodXs like run_uniform's, `n_actual` the true
    member count, L/K/J the matrix shape). `uniform=False` runs the scan
    tier (`xs` a GangXs, `wt` the signature rows [S], `dom` the i32 [N]
    topology domain ids of the contiguity column, `statics` the rows'
    hoisted surfaces, [S, N] each, like run_plan's). `needed` is the
    gang's remaining quorum (minCount minus already-assigned members).
    Returns (carry', packed): [B+4] on the scan tier, [L+4] on the
    closed form. Never writes into `carry`: the scheduler keeps it to
    replay a failed closed form on the scan tier."""
    dev = carry.used.device
    # the rails' declared staging of host inputs (ops/program.py)
    na, carry, xs, table, dom, statics = RAILS.stage(
        (na, carry, xs, table, dom, statics), dev)
    if dev.type == "cuda":
        from .kernels import run_gang_cuda, run_gang_uniform_cuda
        if uniform:
            return run_gang_uniform_cuda(cfg, na, carry, xs, table,
                                         n_actual, needed, L, K, J)
        return run_gang_cuda(cfg, na, carry, xs, table, wt, needed, dom,
                             statics, w_contig)
    if dev.type != "cpu":
        raise RuntimeError(f"run_gang: unsupported device {dev}")
    if uniform:
        return _run_gang_uniform_plain(cfg, na, carry, xs, table, n_actual,
                                       needed, L, K, J)
    return _run_gang_scan_plain(cfg, na, carry, xs, table, wt, needed, dom,
                                statics, w_contig)
