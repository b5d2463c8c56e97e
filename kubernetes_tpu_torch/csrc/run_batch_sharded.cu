// run_batch_sharded: the sequential scan over the node-sharded mesh, lean
// and group mode.
//
// Replaces kubernetes_tpu/parallel/sharding.py _run_batch_sharded_jit
// (:158): its _sharded_step (:113-155), one pod placement on a node shard
// with _eval_pod under `axis` (kubernetes_tpu/ops/program.py :495, the
// group branch :544-555), the pmax of the best score and the pmin of the
// global index among the shards holding it, then _apply_assignment (:906)
// and _row_refresh (:458) on the owning shard and, in group mode,
// group_update with the chosen node's values psum'd (`pick`, :142-155).
//
// Two placements, two implementations:
//
// Every shard on one card (ops/kernels.py plan_sharded_placement "one"):
// ONE cooperative launch a span (ktpu_batch_span_grid), the body of
// batch_span.cuh over D shards, lean and group mode alike. The grid is D
// teams of T blocks of KT_PLAN_BLOCK (512) threads, T = ceil(n_local /
// 512) capped by the card's SMs / D, block b in shard b / T; each block
// owns a contiguous range of its shard's rows. Each exchange of the chain
// below becomes one grid-wide reduction (plan_span.cuh's GridTeam: every
// block's part into its slot of a [2, D·T, KT_RED_K] buffer, grid.sync,
// each block's warp 0 folding the slots). The packed key uses the global
// row, so a tie across a shard or block boundary goes to the lowest global
// row; the spread domain flags are [SC, n_global] with global domain ids,
// epoch-tagged and never zeroed between steps; the chosen node's topology
// values are read from the owning shard's static arrays on the same card
// (no `own` exchange); each shard's SigCache rows, its replicated
// signature and its ipa_a_total are written only by that shard's blocks
// (the first block of each shard writes the scalars at the end). The
// overlay is single-device only (the mesh refuses pending nominations):
// the grid takes none.
//
// Shards on several cards ("cards"): a launch cannot wait on another
// card's launch, so each pod step is a short chain of launches per shard,
// with the exchange (kubernetes_tpu_torch/parallel/sharding.py) between
// them; the wrapper (ops/kernels.py _batch_sharded_chain) drives the pods
// from the host without reading anything back. Lean mode:
//   1. shard_eval (one block a shard): the mask, the raw scores and the
//      SigCache fast or slow path into the shard's cache, and the
//      exchanged vector of shard_eval.cuh — image counts on a miss, the
//      feasible maxima of taint_raw and na_raw;
//   2. exchange: the sums and the maxima (lean_exchange);
//   3. shard_select (one block a shard): on a miss ImageLocality from the
//      cluster-wide counts, the totals with the cluster-wide maxima, the
//      shard's first max, packed into ONE int64 key
//      ((score + 1) << 32) | (INT32_MAX - global index), so the JAX
//      program's pmax of the score then pmin of the index is one max;
//   4. exchange: the max of the keys (pmax);
//   5. shard_apply (one thread a shard): the placement on the owning
//      shard and the refresh of the placed row; every shard stores the
//      pod's signature; shard 0 writes the assignment.
// Group mode (group_eval.cuh's phases, with the cluster-wide values as
// arguments):
//   1. shard_eval, which also sends the shard's DoNotSchedule minima
//      (negated, maxed);
//   2. exchange: the sums, the maxima and the minima;
//   3. shard_geval: ImageLocality on a miss, the group mask with the
//      global minima, the feasible set, its normalization maxima, and the
//      score partials — the scored-node count and the [SC, n_global]
//      domain flags (summed; the domain ids are global), the symmetric
//      score surface's range (maxed, the minimum negated);
//   4. exchange; 5. shard_graw (ScheduleAnyway rows only): the weights
//      from the summed count and flags, the raw spread scores, their
//      range; 6. exchange (max);
//   7. shard_gselect: the totals with the group scores, the packed key;
//   8. exchange (max);
//   9. shard_gapply: shard_apply's placement, and the chosen node's
//      topology values into the `own` vector (zeros off the owner);
//  10. exchange: the sum of the own vectors;
//  11. shard_gupdate: every shard's slice of the group counts.
// `sig` is replicated, so every shard takes the same branch.
//
// What bounds it on an H100: as run_batch.cu, the dependent chain of B
// steps — latency, not bytes or operations. On one card a step is one to
// five grid barriers (the reductions of the active families only); on
// several cards each step is 3·D launches (lean) or 6·D (group) plus the
// exchange's small copies and reductions, so launch latency.

#include "batch_span.cuh"
#include "shard_eval.cuh"

struct ShardStepC {       // one shard's arguments, fixed for a span
  NodeC na;
  TableC tb;
  CarryC c;               // the output carry, written in place
  CfgC cfg;
  const uint8_t* valid;   // [B]
  const int32_t* sig;     // [B]
  const int32_t* tidx;    // [B]
  int32_t offset;         // global index of the shard's row 0
  int64_t* loc;           // [KT_SHARD_LOC] the shard's exchanged parts
  int64_t* key;           // [1] the shard's packed first max
  int32_t* out;           // [B] assignments (shard 0), else nullptr
  // group mode (has_groups = 0: lean; loc then holds KT_SHARD_LOC + SC)
  int32_t has_groups;
  GroupsC g;              // the shard's GroupsDev (node-last fields cut)
  GCarryC gc;             // the output group counts, written in place
  FamC fam;
  int64_t w_spread, w_ipa;
  int32_t n_global;       // rows over all shards (the flags' width)
  uint8_t* feas;          // [N] the feasible set of the step
  int64_t* gsc;           // [N] the raw spread scores of the step
  int64_t* loc2;          // [1 + SC·n_global + 4] score partials
  int64_t* loc3;          // [2] the raw spread range (min negated)
  int64_t* own;           // [_own_len] the chosen node's values
};

namespace {

constexpr int BLOCK = 512;

__device__ __forceinline__ bool row_ok(const ShardStepC& a, int u) {
  return u >= 0 && u < a.tb.U && (!a.has_groups || u < a.g.U);
}

__global__ void __launch_bounds__(BLOCK)
shard_eval_kernel(ShardStepC a, int i) {
  __shared__ BlockScratch<BLOCK> sh;
  const int u = a.tidx[i];
  if (!row_ok(a, u)) {
    // a row outside the table: shard_apply reports it
    if (threadIdx.x == 0)
      for (int k = 0; k < KT_SHARD_LOC + (a.has_groups ? a.g.SC : 0); ++k)
        a.loc[k] = 0;
    return;
  }
  const PodRowD p = pod_row(a.tb, u);
  const bool use_fast = a.sig[i] != 0 && a.sig[i] == *a.c.cache.sig;
  shard_parts<BLOCK>(a.cfg, a.na, a.tb, a.c, p, use_fast, a.c.cache,
                     a.c.cache, sh, a.loc);
  if (a.has_groups && a.fam.spr_f)
    block_spread_min_local<BLOCK>(view_of(a.g, a.gc, u),
                                  a.loc + KT_SHARD_LOC, true, sh);
}

__global__ void __launch_bounds__(BLOCK)
shard_select_kernel(ShardStepC a, int i, const int64_t* glob) {
  __shared__ BlockScratch<BLOCK> sh;
  const int u = a.tidx[i];
  if (!row_ok(a, u)) {
    if (threadIdx.x == 0) *a.key = 0;
    return;
  }
  const PodRowD p = pod_row(a.tb, u);
  const bool use_fast = a.sig[i] != 0 && a.sig[i] == *a.c.cache.sig;
  const CacheC& cc = a.c.cache;
  const int64_t tmax = glob[KT_MAX_IC + 1], namax = glob[KT_MAX_IC + 2];
  int64_t bv = KT_I64_MIN;
  int32_t bi = 0x7fffffff;
  for (int n = threadIdx.x; n < a.na.N; n += BLOCK) {
    if (!use_fast) shard_s_img(a.na, a.tb, p, n, glob, cc);
    const bool feas = cc.static_mask[n] && cc.fit_ok[n];
    const int64_t val = feas ? kt_total(a.cfg, cc, n, tmax, namax) : -1;
    argmax_merge(bv, bi, val, n);
  }
  block_argmax<BLOCK>(bv, bi, sh);
  if (threadIdx.x == 0)
    *a.key = ((bv + 1) << 32) | (int64_t)(0x7fffffff - (a.offset + bi));
}

// _apply_assignment + _row_refresh of the lean scan at local row `best`
__device__ void place_lean(const ShardStepC& a, const PodRowD& p, int best) {
  const NodeC& na = a.na;
  const CarryC& c = a.c;
  int64_t* used_row = c.used + (int64_t)best * na.R;
  for (int r = 0; r < na.R; ++r) used_row[r] += p.req[r];
  int64_t* nz_row = c.nonzero_used + (int64_t)best * 2;
  nz_row[0] += p.nonzero_req[0];
  nz_row[1] += p.nonzero_req[1];
  c.npods[best] += 1;
  bool any_port = false;
  for (int q = 0; q < a.tb.PP; ++q) any_port = any_port || p.port_ids[q];
  if (any_port) {
    int32_t* row = c.ports + (int64_t)best * c.P;
    int rank = 0;
    for (int slot = 0; slot < c.P; ++slot) {
      if (row[slot] != 0) continue;
      row[slot] = rank < a.tb.PP ? p.port_ids[rank] : 0;
      ++rank;
    }
  }
  int64_t s_fit, s_bal;
  kt_fit_scores(a.cfg, na, best, used_row, nz_row, p, &s_fit, &s_bal);
  c.cache.fit_ok[best] = kt_fit(na, best, used_row, c.npods[best], p);
  c.cache.s_fit[best] = s_fit;
  c.cache.s_bal[best] = s_bal;
}

__global__ void shard_apply_kernel(ShardStepC a, int i, const int64_t* gkey) {
  const int u = a.tidx[i];
  if (!row_ok(a, u)) {
    // the commit rejects any assignment below -1
    if (a.out) a.out[i] = -2;
    return;
  }
  const int64_t k = *gkey;
  const int64_t gscore = (k >> 32) - 1;
  const int32_t gbest = 0x7fffffff - (int32_t)(k & 0xffffffffLL);
  const bool assigned = gscore >= 0 && a.valid[i];
  const int lidx = gbest - a.offset;
  if (assigned && lidx >= 0 && lidx < a.na.N)
    place_lean(a, pod_row(a.tb, u), lidx);
  *a.c.cache.sig = a.sig[i];
  if (a.out) a.out[i] = assigned ? gbest : -1;
}

// ---- group mode

// 3. ImageLocality on a miss; the feasible set (the cached static mask and
// fit, the group mask with the global minima glob1[KT_SHARD_LOC + c],
// negated); its normalization maxima; the score partials. loc2 =
// [npart, flags (SC · n_global) | tmax, namax, -lo, hi].
__global__ void __launch_bounds__(BLOCK)
shard_geval_kernel(ShardStepC a, int i, const int64_t* glob1) {
  __shared__ BlockScratch<BLOCK> sh;
  __shared__ int32_t minv[KT_MAX_SC];
  const int u = a.tidx[i];
  const int64_t W = 1 + (int64_t)a.g.SC * a.n_global;
  if (!row_ok(a, u)) {
    for (int64_t e = threadIdx.x; e < W + 4; e += BLOCK) a.loc2[e] = 0;
    return;
  }
  const PodRowD p = pod_row(a.tb, u);
  const bool use_fast = a.sig[i] != 0 && a.sig[i] == *a.c.cache.sig;
  const CacheC& cc = a.c.cache;
  const GViewD v = view_of(a.g, a.gc, u);
  if (threadIdx.x < v.SC) {
    const int c = threadIdx.x;
    minv[c] = v.f_minz[c] ? 0 : (int32_t)(-glob1[KT_SHARD_LOC + c]);
  }
  __syncthreads();
  int64_t tm = 0, nm = 0;
  for (int n = threadIdx.x; n < a.na.N; n += BLOCK) {
    if (!use_fast) shard_s_img(a.na, a.tb, p, n, glob1, cc);
    const bool f = cc.static_mask[n] && cc.fit_ok[n]
                   && kt_group_mask(v, a.fam, n, minv);
    a.feas[n] = f;
    if (f) {
      tm = cc.taint_raw[n] > tm ? cc.taint_raw[n] : tm;
      nm = cc.na_raw[n] > nm ? cc.na_raw[n] : nm;
    }
  }
  const int64_t tmax = block_max<BLOCK>(tm, sh);
  const int64_t namax = block_max<BLOCK>(nm, sh);
  int64_t npart = 0, lo = KT_I64_MAX, hi = -KT_I64_MAX;
  block_score_partials<BLOCK>(v, a.fam, a.feas, a.loc2 + 1, a.n_global,
                              &npart, &lo, &hi, sh);
  if (threadIdx.x == 0) {
    a.loc2[0] = npart;
    a.loc2[W] = tmax;
    a.loc2[W + 1] = namax;
    a.loc2[W + 2] = -lo;
    a.loc2[W + 3] = hi;
  }
}

// 5. the raw spread scores from the summed count and flags (glob2), and
// their range over the scored rows: loc3 = [-rmin, rmax]
__global__ void __launch_bounds__(BLOCK)
shard_graw_kernel(ShardStepC a, int i, const int64_t* glob2) {
  __shared__ BlockScratch<BLOCK> sh;
  const int u = a.tidx[i];
  if (!row_ok(a, u)) {
    if (threadIdx.x == 0) a.loc3[0] = a.loc3[1] = 0;
    return;
  }
  const GViewD v = view_of(a.g, a.gc, u);
  double weight[KT_MAX_SC];
  block_spread_weights<BLOCK>(v, glob2[0], glob2 + 1, a.n_global, weight,
                              sh);
  int64_t rmin, rmax;
  block_spread_raw<BLOCK>(v, a.feas, weight, a.gsc, &rmin, &rmax, sh);
  if (threadIdx.x == 0) {
    a.loc3[0] = -rmin;
    a.loc3[1] = rmax;
  }
}

// 7. the totals over the feasible set with the cluster-wide maxima and
// group score ranges (glob2, glob3), the packed key
__global__ void __launch_bounds__(BLOCK)
shard_gselect_kernel(ShardStepC a, int i, const int64_t* glob2,
                     const int64_t* glob3) {
  __shared__ BlockScratch<BLOCK> sh;
  const int u = a.tidx[i];
  if (!row_ok(a, u)) {
    if (threadIdx.x == 0) *a.key = 0;
    return;
  }
  const int64_t W = 1 + (int64_t)a.g.SC * a.n_global;
  const int64_t tmax = glob2[W], namax = glob2[W + 1];
  const int64_t lo = -glob2[W + 2], hi = glob2[W + 3];
  const bool spr = a.fam.spr_s != 0;
  const int64_t rmin = spr ? -glob3[0] : 0, rmax = spr ? glob3[1] : 0;
  const GViewD v = view_of(a.g, a.gc, u);
  const bool has_s = spr && kt_has_s(v);
  const bool gs = a.fam.spr_s || a.fam.ipa_score;
  const CacheC& cc = a.c.cache;
  int64_t bv = KT_I64_MIN;
  int32_t bi = 0x7fffffff;
  for (int n = threadIdx.x; n < a.na.N; n += BLOCK) {
    int64_t val = -1;
    if (a.feas[n]) {
      val = kt_total(a.cfg, cc, n, tmax, namax);
      if (gs)
        val += kt_group_score(v, a.fam, n, true, a.gsc[n], a.w_spread,
                              a.w_ipa, has_s, rmin, rmax, lo, hi);
    }
    argmax_merge(bv, bi, val, n);
  }
  block_argmax<BLOCK>(bv, bi, sh);
  if (threadIdx.x == 0)
    *a.key = ((bv + 1) << 32) | (int64_t)(0x7fffffff - (a.offset + bi));
}

// 9. the placement on the owning shard and the own vector (one block)
__global__ void __launch_bounds__(BLOCK)
shard_gapply_kernel(ShardStepC a, int i, const int64_t* gkey) {
  const int u = a.tidx[i];
  if (!row_ok(a, u)) {
    if (a.out && threadIdx.x == 0) a.out[i] = -2;
    block_own_write<BLOCK>(a.g, -1, a.own);
    return;
  }
  const int64_t k = *gkey;
  const int64_t gscore = (k >> 32) - 1;
  const int32_t gbest = 0x7fffffff - (int32_t)(k & 0xffffffffLL);
  const bool assigned = gscore >= 0 && a.valid[i];
  const int lidx = gbest - a.offset;
  const bool mine = assigned && lidx >= 0 && lidx < a.na.N;
  if (threadIdx.x == 0) {
    if (mine) place_lean(a, pod_row(a.tb, u), lidx);
    *a.c.cache.sig = a.sig[i];
    if (a.out) a.out[i] = assigned ? gbest : -1;
  }
  block_own_write<BLOCK>(a.g, mine ? lidx : -1, a.own);
}

// 11. every shard's slice of the group counts, from the summed own vector
__global__ void __launch_bounds__(BLOCK)
shard_gupdate_kernel(ShardStepC a, int i, const int64_t* gkey,
                     const int64_t* gown) {
  const int u = a.tidx[i];
  if (!row_ok(a, u)) return;
  const int64_t k = *gkey;
  const int32_t gbest = 0x7fffffff - (int32_t)(k & 0xffffffffLL);
  if (!((k >> 32) - 1 >= 0 && a.valid[i])) return;
  const int lidx = gbest - a.offset;
  block_group_update_own<BLOCK>(a.g, a.gc, a.fam, u, gown,
                                lidx >= 0 && lidx < a.na.N ? lidx : -1);
}

}  // namespace

extern "C" int ktpu_shard_geval(const ShardStepC* a, int i,
                                const int64_t* glob1, void* stream) {
  shard_geval_kernel<<<1, BLOCK, 0, (cudaStream_t)stream>>>(*a, i, glob1);
  return (int)cudaGetLastError();
}

extern "C" int ktpu_shard_graw(const ShardStepC* a, int i,
                               const int64_t* glob2, void* stream) {
  shard_graw_kernel<<<1, BLOCK, 0, (cudaStream_t)stream>>>(*a, i, glob2);
  return (int)cudaGetLastError();
}

extern "C" int ktpu_shard_gselect(const ShardStepC* a, int i,
                                  const int64_t* glob2, const int64_t* glob3,
                                  void* stream) {
  shard_gselect_kernel<<<1, BLOCK, 0, (cudaStream_t)stream>>>(*a, i, glob2,
                                                               glob3);
  return (int)cudaGetLastError();
}

extern "C" int ktpu_shard_gapply(const ShardStepC* a, int i,
                                 const int64_t* gkey, void* stream) {
  shard_gapply_kernel<<<1, BLOCK, 0, (cudaStream_t)stream>>>(*a, i, gkey);
  return (int)cudaGetLastError();
}

extern "C" int ktpu_shard_gupdate(const ShardStepC* a, int i,
                                  const int64_t* gkey, const int64_t* gown,
                                  void* stream) {
  shard_gupdate_kernel<<<1, BLOCK, 0, (cudaStream_t)stream>>>(*a, i, gkey,
                                                               gown);
  return (int)cudaGetLastError();
}

extern "C" int ktpu_shard_eval(const ShardStepC* a, int i, void* stream) {
  shard_eval_kernel<<<1, BLOCK, 0, (cudaStream_t)stream>>>(*a, i);
  return (int)cudaGetLastError();
}

extern "C" int ktpu_shard_select(const ShardStepC* a, int i,
                                 const int64_t* glob, void* stream) {
  shard_select_kernel<<<1, BLOCK, 0, (cudaStream_t)stream>>>(*a, i, glob);
  return (int)cudaGetLastError();
}

extern "C" int ktpu_shard_apply(const ShardStepC* a, int i,
                                const int64_t* gkey, void* stream) {
  shard_apply_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(*a, i, gkey);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// every shard on one card: the whole span in one cooperative launch

namespace {

constexpr int GBLOCK = KT_PLAN_BLOCK;

__global__ void __launch_bounds__(GBLOCK, 1)
batch_span_grid_kernel(const __grid_constant__ BatchSpanC cm,
                       const BatchNodesC* all, int T) {
  __shared__ PlanShared<GBLOCK> sh;
  __shared__ int64_t img[KT_MAX_IC + 1];   // ImageLocality's counts
  const int d = blockIdx.x / T, r = blockIdx.x % T;
  const int n = cm.n_local, span = (n + T - 1) / T;
  const int lo = min(n, r * span), hi = min(n, lo + span);
  GridTeam<GBLOCK> tm{cm.part};
  batch_span<GBLOCK>(cm, all, d, lo, hi, span, r == 0, blockIdx.x == 0, tm,
                     sh, img);
}

}  // namespace

// all: the D shards' BatchNodesC in device memory; T blocks a shard (the
// wrapper's T: its partial slots are sized by D·T); U: the group rows (0
// lean), whose ipa_a_total each block keeps in shared memory
extern "C" int ktpu_batch_span_grid(const BatchSpanC* cm, const void* all,
                                    int D, int T, int U, void* stream) {
  if (cm->B <= 0) return 0;
  const BatchNodesC* nodes = (const BatchNodesC*)all;
  void* kargs[] = {(void*)cm, (void*)&nodes, (void*)&T};
  const int smem = batch_dyn_bytes((cm->n_local + T - 1) / T, U);
  cudaError_t e = cudaFuncSetAttribute(
      batch_span_grid_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e == cudaSuccess)
    e = cudaLaunchCooperativeKernel((const void*)batch_span_grid_kernel,
                                    dim3(D * T), dim3(GBLOCK), kargs, smem,
                                    (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
