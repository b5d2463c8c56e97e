// explain_row: the per-plugin score decomposition of one signature row
// at one carry, and its top-k nodes.
//
// Replaces kubernetes_tpu/ops/program.py explain_row (:700; the jits
// _explain_lean :695 and _explain_groups :689 over _explain_masks :663).
// The row is evaluated exactly as one scan step evaluates it (_eval_pod
// with sig = 0, so the SigCache is never read; no overlay): the lean
// filters and scores of lean_eval.cuh, and with groups the group mask
// folded into the feasible set before the TaintToleration / NodeAffinity
// normalization and the group scores of group_eval.cuh. Then for every
// node, feasible or not, the columns
//   w_fit·s_fit, w_balanced·s_bal, w_taint·norm(taint, reversed),
//   w_node_affinity·norm(affinity), w_image·s_img, total − base,
// and the key = int32(total) where feasible, −1 elsewhere. The top k keys
// in descending order, ties to the lowest index (lax.top_k's order), give
// idx; totals is the int64 masked total at idx, cols the columns at idx,
// and the fourth output the feasible count.
//
// What bounds it on an H100: one row over N nodes, a few hundred bytes
// per node (the node columns, the carry rows, with groups the row's
// [SC / TA / TAA, N] tensors): at N = 8,192 a few MB, launch-latency
// bound, like one step of run_batch.
//
// Design: one block over the node axis, as one step of run_batch.cu: the
// parts go to scratch arrays the wrapper allocates (the kernel never
// writes the caller's carry), the maxima and the group ranges are block
// reductions, and the top-k is k ≤ 16 rounds of the block's first-max
// argmax, each round skipping the indices already taken.

#include "group_eval.cuh"

#define KT_EXPLAIN_MAX_K 16

// the kernel's arguments, mirrored field for field by ctypes
// (ops/kernels.py ExplainArgsC)
struct ExplainArgs {
  NodeC na;
  TableC tb;
  CarryC c;               // c.cache: scratch the kernel fills (sig unused)
  CfgC cfg;
  GroupsC g;
  GCarryC gc;
  FamC fam;
  int32_t has_groups, tidx, k;
  int64_t w_spread, w_ipa;
  uint8_t* gmask;         // [N] scratch: group mask, then feasibility
  int32_t* flags;         // [SC * N] scratch: spread domain flags
  int64_t* gsc;           // [N] scratch: weighted group scores
  int64_t* masked;        // [N] scratch: total where feasible, else −1
  int32_t* idx;           // [k]
  int64_t* totals;        // [k]
  int64_t* cols;          // [k, 6]
  int32_t* feasible;      // []
};

namespace {

constexpr int BLOCK = 512;

__global__ void __launch_bounds__(BLOCK) explain_kernel(ExplainArgs a) {
  __shared__ BlockScratch<BLOCK> sh;
  __shared__ int64_t num_with[KT_MAX_IC];
  __shared__ int32_t minv[KT_MAX_SC];
  __shared__ int32_t taken[KT_EXPLAIN_MAX_K];
  const int N = a.na.N;
  const bool groups = a.has_groups != 0;
  const bool gscores = groups && (a.fam.spr_s || a.fam.ipa_score);
  const PodRowD p = pod_row(a.tb, a.tidx);
  const CacheC& pc = a.c.cache;
  GViewD v;
  if (groups) {
    v = view_of(a.g, a.gc, a.tidx);
    if (a.fam.spr_f) block_spread_min<BLOCK>(v, minv, sh);
    for (int n = threadIdx.x; n < N; n += BLOCK)
      a.gmask[n] = kt_group_mask(v, a.fam, n, minv);
  }
  int64_t tmax, namax;
  block_eval_parts<BLOCK>(a.cfg, a.na, a.tb, a.c, p, false, pc, pc, sh,
                          num_with, &tmax, &namax,
                          groups ? a.gmask : nullptr);
  if (groups) {
    // the feasible set, then group_scores over it for every node
    for (int n = threadIdx.x; n < N; n += BLOCK)
      a.gmask[n] = a.gmask[n] && pc.static_mask[n] && pc.fit_ok[n];
    if (gscores)
      block_group_scores<BLOCK>(v, a.fam, a.w_spread, a.w_ipa, a.gmask,
                                a.flags, a.gsc, sh);
  }
  __syncthreads();
  int64_t nfeas = 0;
  for (int n = threadIdx.x; n < N; n += BLOCK) {
    const bool feas = groups ? a.gmask[n] != 0
                             : (pc.static_mask[n] && pc.fit_ok[n]);
    int64_t total = kt_total(a.cfg, pc, n, tmax, namax);
    if (gscores) total += a.gsc[n];
    a.masked[n] = feas ? total : -1;
    nfeas += feas;
  }
  nfeas = block_sum<BLOCK>(nfeas, sh);   // also orders the masked writes
  for (int r = 0; r < a.k; ++r) {
    int64_t bv = KT_I64_MIN;
    int32_t bi = 0x7fffffff;
    for (int n = threadIdx.x; n < N; n += BLOCK) {
      bool skip = false;
      for (int q = 0; q < r; ++q) skip = skip || taken[q] == n;
      if (skip) continue;
      // the int32 key of the JAX package's top_k
      argmax_merge(bv, bi, (int64_t)(int32_t)a.masked[n], n);
    }
    block_argmax<BLOCK>(bv, bi, sh);
    if (threadIdx.x == 0) {
      taken[r] = bi;
      const int64_t c0 = a.cfg.w_fit * pc.s_fit[bi];
      const int64_t c1 = a.cfg.w_balanced * pc.s_bal[bi];
      const int64_t c2 = a.cfg.w_taint * kt_normalize(pc.taint_raw[bi], tmax, true);
      const int64_t c3 =
          a.cfg.w_node_affinity * kt_normalize(pc.na_raw[bi], namax, false);
      const int64_t c4 = a.cfg.w_image * pc.s_img[bi];
      int64_t* row = a.cols + (int64_t)r * 6;
      row[0] = c0;
      row[1] = c1;
      row[2] = c2;
      row[3] = c3;
      row[4] = c4;
      row[5] = gscores ? a.gsc[bi] : 0;
      a.idx[r] = bi;
      a.totals[r] = a.masked[bi];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) *a.feasible = (int32_t)nfeas;
}

}  // namespace

extern "C" int ktpu_explain_row(const ExplainArgs* args, void* stream) {
  if (args->na.N > 0 && args->k > 0)
    explain_kernel<<<1, BLOCK, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}
