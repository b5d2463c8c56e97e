// run_batch: the sequential scan over a span of pods.
//
// Replaces kubernetes_tpu/ops/program.py run_batch (:984; _run_batch_impl
// :929 with _eval_pod :495, _apply_assignment :906, _row_refresh :458 and
// the group steps: group_mask / group_scores inside _eval_pod :544-555,
// group_update per placement :961-966), and its nominated-pod overlay
// variant (lean scan only): the overlay folds into the slow path's fit
// and the row refresh, each nominated pod's own nomination is taken back
// out of its EFFECTIVE mask at its nominated row (:515-528; the cached
// fit_ok stays signature-pure), and a bound nominated pod consumes its
// nomination at that row, not at the chosen one (:942-966). The overlay
// the kernel consumes is a scratch copy the wrapper makes; the caller's
// is never written.
//
// What bounds it on an H100: the scan is sequential in pods — pod i+1
// reads the carry pod i wrote — so the span is a chain of B dependent
// steps, each an O(N) pass over the node axis plus a handful of
// block-wide reductions (ImageLocality counts, the normalization maxima,
// the first-max argmax; with groups also the spread minima, the score
// ranges and the domain flags). At N = 8192 nodes one step moves well
// under a megabyte, so the bound is latency (barriers and the dependent
// chain), not bytes or operations.
//
// Design: ONE persistent launch per span and a single block that loops
// over the pods, so the chain never leaves the SM: the carry, the
// signature cache and the group counts stay in global memory (L2-resident
// at these sizes), each step is parallel in nodes across the block's
// threads, the reductions are warp shuffles plus shared memory, one
// thread applies the lean placement (port ids into the first free slots)
// and refreshes the touched cache row, and all threads apply the group
// count update. Same-signature pods take the SigCache fast path: only the
// feasibility maxima, the group terms and the argmax are recomputed. The
// block writes the carry it was given in place; the wrapper hands it
// fresh copies.

#include "group_eval.cuh"

namespace {

constexpr int BLOCK = 512;

struct OvlArgs {          // the overlay variant (used == nullptr: none)
  int64_t* used;          // [N, R] scratch copy of ovl_used, consumed
  int32_t* npods;         // [N] scratch copy of ovl_npods, consumed
  const int32_t* nom_idx; // [B] each pod's own nominated row (-1 none),
                          // nullptr when no pod of the span is nominated
};

struct GroupArgs {        // the group branch (has_groups = 0: lean scan)
  GroupsC g;
  GCarryC c;
  FamC fam;
  int32_t has_groups;
  int64_t w_spread, w_ipa;
  uint8_t* gmask;         // [N] scratch: group mask, then feasibility
  int32_t* flags;         // [SC * N] scratch: spread domain flags
  int64_t* gsc;           // [N] scratch: weighted group scores
};

__global__ void __launch_bounds__(BLOCK)
run_batch_kernel(NodeC na, TableC tb, CarryC c, CfgC cfg, GroupArgs ga,
                 OvlArgs oa, const uint8_t* __restrict__ valid,
                 const int32_t* __restrict__ sig,
                 const int32_t* __restrict__ tidx, int B,
                 int32_t* __restrict__ out) {
  __shared__ BlockScratch<BLOCK> sh;
  __shared__ int64_t num_with[KT_MAX_IC];
  __shared__ int32_t minv[KT_MAX_SC];
  const bool groups = ga.has_groups != 0;
  const bool gscores = groups && (ga.fam.spr_s || ga.fam.ipa_score);
  const OvlD ovl{oa.used, oa.npods};
  for (int i = 0; i < B; ++i) {
    const int32_t s = sig[i];
    const int u = tidx[i];
    if (u < 0 || u >= tb.U || (groups && u >= ga.g.U)) {
      // a row outside the tables: report it (the commit rejects any
      // assignment below -1) instead of reading past them
      if (threadIdx.x == 0) out[i] = -2;
      continue;
    }
    const PodRowD p = pod_row(tb, u);
    const bool use_fast = s != 0 && s == *c.cache.sig;
    GViewD v;
    if (groups) {
      // group_mask (:544): spread minima, then the per-node mask
      v = view_of(ga.g, ga.c, u);
      if (ga.fam.spr_f) block_spread_min<BLOCK>(v, minv, sh);
      for (int n = threadIdx.x; n < na.N; n += BLOCK)
        ga.gmask[n] = kt_group_mask(v, ga.fam, n, minv);
    }
    // the pod's own nominated row and its effective fit there: every
    // thread computes the same value from the carry and overlay rows
    // (both final since the previous step's barrier)
    const int nom = (oa.used != nullptr && oa.nom_idx != nullptr)
                        ? oa.nom_idx[i] : -1;
    const bool nom_fit =
        nom >= 0 && kt_own_nomination_fit(na, nom, c.used + (int64_t)nom * na.R,
                                          c.npods[nom], p, ovl);
    int64_t tmax, namax;
    block_eval_parts<BLOCK>(cfg, na, tb, c, p, use_fast, c.cache, c.cache,
                            sh, num_with, &tmax, &namax,
                            groups ? ga.gmask : nullptr, ovl, nom, nom_fit);
    if (gscores) {
      // group_scores (:551) over the full filtered set
      for (int n = threadIdx.x; n < na.N; n += BLOCK)
        ga.gmask[n] = ga.gmask[n] && c.cache.static_mask[n]
                      && c.cache.fit_ok[n];
      block_group_scores<BLOCK>(v, ga.fam, ga.w_spread, ga.w_ipa, ga.gmask,
                                ga.flags, ga.gsc, sh);
    }
    // masked total + first-max argmax (:949-951)
    int64_t bv = KT_I64_MIN;
    int32_t bi = 0x7fffffff;
    for (int n = threadIdx.x; n < na.N; n += BLOCK) {
      const bool fit = n == nom ? nom_fit : c.cache.fit_ok[n] != 0;
      const bool feas = c.cache.static_mask[n] && fit
                        && (!groups || ga.gmask[n]);
      int64_t val = -1;
      if (feas) {
        val = kt_total(cfg, c.cache, n, tmax, namax);
        if (gscores) val += ga.gsc[n];
      }
      argmax_merge(bv, bi, val, n);
    }
    block_argmax<BLOCK>(bv, bi, sh);
    const int best = bi;
    const bool assigned = bv >= 0 && valid[i];
    if (threadIdx.x == 0) {
      if (assigned) {
        // _apply_assignment (:906)
        int64_t* used_row = c.used + (int64_t)best * na.R;
        for (int r = 0; r < na.R; ++r) used_row[r] += p.req[r];
        int64_t* nz_row = c.nonzero_used + (int64_t)best * 2;
        nz_row[0] += p.nonzero_req[0];
        nz_row[1] += p.nonzero_req[1];
        c.npods[best] += 1;
        bool any_port = false;
        for (int q = 0; q < tb.PP; ++q) any_port = any_port || p.port_ids[q];
        if (any_port) {
          int32_t* row = c.ports + (int64_t)best * c.P;
          int rank = 0;
          for (int slot = 0; slot < c.P; ++slot) {
            if (row[slot] != 0) continue;
            row[slot] = rank < tb.PP ? p.port_ids[rank] : 0;
            ++rank;
          }
        }
        if (nom >= 0) {
          // the commit deletes a bound pod's nomination: consume it at
          // its NOMINATED row (:955-960)
          int64_t* orow = oa.used + (int64_t)nom * na.R;
          for (int r = 0; r < na.R; ++r) orow[r] -= p.req[r];
          oa.npods[nom] -= 1;
        }
        // _row_refresh (:458) at the post-placement carry and overlay
        int64_t s_fit, s_bal;
        kt_fit_scores(cfg, na, best, used_row, nz_row, p, &s_fit, &s_bal);
        c.cache.fit_ok[best] =
            kt_fit_ovl(na, best, used_row, c.npods[best], p, ovl);
        c.cache.s_fit[best] = s_fit;
        c.cache.s_bal[best] = s_bal;
      }
      *c.cache.sig = s;
      out[i] = assigned ? best : -1;
    }
    if (groups && assigned)
      block_group_update<BLOCK>(ga.g, ga.c, ga.fam, u, best);
    __syncthreads();
  }
}

}  // namespace

extern "C" int ktpu_run_batch(const NodeC* na, const TableC* tb,
                              const CarryC* carry, const CfgC* cfg,
                              const GroupsC* g, const GCarryC* gc,
                              const FamC* fam, int has_groups,
                              long long w_spread, long long w_ipa,
                              uint8_t* gmask, int32_t* flags, int64_t* gsc,
                              int64_t* ovl_used, int32_t* ovl_npods,
                              const int32_t* nom_idx,
                              const uint8_t* valid, const int32_t* sig,
                              const int32_t* tidx, int B, int32_t* out,
                              void* stream) {
  if (B > 0) {
    GroupArgs ga;
    ga.g = *g;
    ga.c = *gc;
    ga.fam = *fam;
    ga.has_groups = has_groups;
    ga.w_spread = w_spread;
    ga.w_ipa = w_ipa;
    ga.gmask = gmask;
    ga.flags = flags;
    ga.gsc = gsc;
    OvlArgs oa;
    oa.used = ovl_used;
    oa.npods = ovl_npods;
    oa.nom_idx = nom_idx;
    run_batch_kernel<<<1, BLOCK, 0, (cudaStream_t)stream>>>(
        *na, *tb, *carry, *cfg, ga, oa, valid, sig, tidx, B, out);
  }
  return (int)cudaGetLastError();
}
