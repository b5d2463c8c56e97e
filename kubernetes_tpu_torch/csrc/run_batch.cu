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
// steps, each a pass or two over the node axis and a few reductions over
// it (ImageLocality's counts on a signature change, the normalization
// maxima, the first-max argmax; with groups also the spread minima, the
// domain flags and the score ranges). At N = 8,192 nodes one step moves
// well under a megabyte, so the bound is latency (the dependent loads of
// a row and the barriers), not bytes or operations.
//
// Design: ONE launch a span of a thread-block cluster of KT_BATCH_CLUSTER
// CTAs of KT_PLAN_BLOCK threads (cudaLaunchKernelEx with the cluster
// dimension), as run_plan.cu. Each CTA owns a contiguous range of ⌈N / C⌉
// rows, one row a thread at N = 8,192 (a thread loops past C · 512
// rows), and reuses plan_span.cuh's team: each cross-row value is one
// team reduction (warp shuffles, the block's part, one cluster barrier,
// warp 0 folding the C partial slots through distributed shared memory),
// and the argmax is the packed key ((score + 1) << 32) | (INT32_MAX − n),
// whose largest value is the lowest index among the maxima, so every CTA
// decodes the same first max. A step, in the reference's order:
//   1. the signature test, decided alike in every CTA from the pod stream
//      (a row outside the tables reports -2 and leaves the signature);
//   2. with groups, the spread minima (one reduction);
//   3. one pass over the CTA's rows: on a signature change the slow path
//      (kt_row_parts) and the row's share of ImageLocality's counts; the
//      feasible set into shared memory (the cached static mask and fit,
//      the nominated row's effective fit computed by its owner and only
//      there, the group mask); the normalization maxima, the group score
//      partials, the epoch-tagged spread domain flags (no pass zeroes
//      them); and, where no group score and no image count is pending,
//      the packed key under the last step's maxima. ONE reduction carries
//      all of it (IC + 1 image sums included);
//   4. when the maxima equal the last step's, that key is the key (a run
//      of same-signature lean pods: one reduction a pod); otherwise the
//      distinct spread domains and the raw spread range (one reduction
//      each), ImageLocality written, and the key (one reduction);
//   5. on a placement only the owner CTA of the chosen row writes: one
//      warp its used / nonzero / pods row, one its ports, the owner of the
//      nominated row consumes the overlay there, then three threads in
//      three warps refresh fit_ok, s_fit and s_bal side by side (Balanced's
//      float64 chain as lean_eval.cuh keeps it; the refresh is the step's
//      critical path, which one warp running the three in turn tripled);
//      the group increments are decided
//      once from the chosen node's topology values and listed (plan_gate),
//      then each CTA sweeps its own rows over the list (plan_sweep), so
//      each counter element keeps one writer.
// Every row's carry, SigCache and counter fields are written only by the
// thread that owns the row; ipa_a_total, the one per-row-of-the-table
// counter, lives in each CTA's shared memory and CTA 0 writes it, the
// SigCache signature and the assignments. A pod that is not valid stops
// after the slow path: nothing else it computes is observable. The
// wrapper hands the kernel fresh copies of every carry field it writes.

#include "plan_span.cuh"

#define KT_BATCH_CLUSTER 16

// the kernel's arguments, mirrored field for field by ctypes
// (ops/kernels.py BatchArgsC)
struct BatchArgs {
  NodeC na;
  TableC tb;
  CarryC c;               // the output carry (fresh copies), in place
  CfgC cfg;
  GroupsC g;              // the group branch (has_groups = 0: lean scan)
  GCarryC gc;             // the output group carry, in place
  FamC fam;
  int32_t has_groups;
  int64_t w_spread, w_ipa;
  int32_t* flags;         // [SC, N] epoch-tagged spread domain flags
  int64_t* ovl_used;      // [N, R] scratch copy of the overlay, consumed
                          // (nullptr: no overlay)
  int32_t* ovl_npods;     // [N]
  const int32_t* nom_idx; // [B] each pod's own nominated row (-1 none),
                          // nullptr when no pod of the span is nominated
  const uint8_t* valid;   // [B]
  const int32_t* sig;     // [B]
  const int32_t* tidx;    // [B]
  int32_t B;
  int32_t* out;           // [B] assignments
};

// a CTA's dynamic shared memory for `span` rows: plan_span's layout (the
// raw spread scores, the feasible set), then ipa_a_total [U] in group mode
__host__ __device__ inline int batch_dyn_bytes(int span, int U) {
  return plan_dyn_bytes(span) + 8 * U;
}

namespace {

constexpr int BLOCK = KT_PLAN_BLOCK;

// the values of a step's one fused reduction: r[0..V_VALID), each
// thread's own (the maxima — the normalization denominators, the
// speculated key, the inter-pod score range with its low end negated —
// then the scored spread rows' sum), and the image counts, the CTA's in
// shared memory (img: the valid rows, then the rows holding each of the
// pod's images), summed
enum : int {
  V_TMAX, V_NAMAX, V_KEY, V_LO, V_HI, V_NPART, V_VALID, V_CNT,
  NV = V_CNT + KT_MAX_IC
};
constexpr uint32_t V_SUMS = ~((1u << V_NPART) - 1u);

// the team reduction of the step's first n values, in chunks of KT_RED_K
// (one cluster barrier each): r gets the team's values and, when n takes
// in the image counts (thread 0 contributes the CTA's), img the cluster's
__device__ __forceinline__ void batch_reduce(ClusterTeam<BLOCK>& tm,
                                             int64_t (&r)[V_VALID], int n,
                                             int64_t* img,
                                             PlanShared<BLOCK>& sh) {
  const bool images = n > V_VALID;
  const bool t0 = threadIdx.x == 0;
  if (images) __syncthreads();   // every row's counts in img
#pragma unroll
  for (int j = 0; j < NV; j += KT_RED_K) {
    if (j >= n) break;
    int64_t x[KT_RED_K];
#pragma unroll
    for (int k = 0; k < KT_RED_K; ++k) {
      const int e = j + k;
      x[k] = e < V_VALID ? r[e]
           : (e < NV && e < n && t0) ? img[e - V_VALID] : 0;
    }
    tm.reduce(x, min(KT_RED_K, n - j), V_SUMS >> j, sh);
#pragma unroll
    for (int k = 0; k < KT_RED_K; ++k) {
      const int e = j + k;
      if (e < V_VALID)
        r[e] = x[k];
      else if (e < NV && e < n && t0)
        img[e - V_VALID] = x[k];
    }
  }
  if (images) __syncthreads();   // the cluster's counts before any read
}

// _slow_parts (:424) of row n: every SigCache part but ImageLocality's
// (0 for a pod that names no image), and, when `images`, the row's share
// of the image counts added to the CTA's (one add a warp and count)
__device__ __forceinline__ void batch_parts(const BatchArgs& a,
                                            const PodRowD& p, int n,
                                            bool images, int64_t* img) {
  const uint32_t bits = kt_row_parts(a.cfg, a.na, a.tb, a.c, p, n,
                                     a.c.cache,
                                     OvlD{a.ovl_used, a.ovl_npods});
  if (!images) {
    a.c.cache.s_img[n] = 0;
    return;
  }
  const unsigned am = __activemask();
  const bool leader = (int)(threadIdx.x & 31) == __ffs(am) - 1;
  for (int k = 0; k <= a.tb.IC; ++k) {
    const bool hit = k == 0 ? a.na.valid[n] != 0 : (bits >> (k - 1)) & 1u;
    const unsigned m = __ballot_sync(am, hit);
    if (leader && m)
      atomicAdd((unsigned long long*)&img[k], (unsigned long long)__popc(m));
  }
}

// _row_refresh (:458) at the touched row n from its updated carry row:
// part 0 the fit (the overlay folded in), 1 LeastAllocated, 2 Balanced
__device__ __forceinline__ void batch_refresh(const BatchArgs& a,
                                              const PodRowD& p, int n,
                                              int part) {
  const NodeC& na = a.na;
  const CarryC& c = a.c;
  const CfgC& cfg = a.cfg;
  const int64_t* used_row = c.used + (int64_t)n * na.R;
  if (part == 0) {
    c.cache.fit_ok[n] = kt_fit_ovl(na, n, used_row, c.npods[n], p,
                                   OvlD{a.ovl_used, a.ovl_npods});
    return;
  }
  if (part == 2 && p.skip_balanced) {
    c.cache.s_bal[n] = 0;
    return;
  }
  const int64_t* cap = na.cap + (int64_t)n * na.R;
  const int64_t* nz = c.nonzero_used + (int64_t)n * 2;
  int64_t capc[KT_MAX_C], usedc[KT_MAX_C], plain[KT_MAX_C];
#pragma unroll
  for (int k = 0; k < KT_MAX_C; ++k) {
    if (k >= cfg.C) break;
    const int col = cfg.score_cols[k];
    capc[k] = cap[col];
    plain[k] = used_row[col] + p.req[col];
    const int sl = cfg.nonzero_slot[k];
    usedc[k] = cfg.col_nonzero[k] ? nz[sl] + p.nonzero_req[sl] : plain[k];
  }
  if (part == 1)
    c.cache.s_fit[n] = kt_least_allocated(cfg, capc, usedc);
  else
    c.cache.s_bal[n] = kt_balanced(cfg.C, capc, plain);
}

__global__ void __launch_bounds__(BLOCK, 1)
run_batch_kernel(const __grid_constant__ BatchArgs a) {
  __shared__ PlanShared<BLOCK> sh;
  __shared__ int64_t img[KT_MAX_IC + 1];   // ImageLocality's counts
  cg::cluster_group cl = cg::this_cluster();
  const int C = (int)cl.num_blocks(), rank = (int)cl.block_rank();
  const NodeC& na = a.na;
  const CarryC& c = a.c;
  const CacheC& cache = c.cache;
  const FamC& fam = a.fam;
  const int N = na.N, R = na.R, span = (N + C - 1) / C;
  const int lo = min(N, rank * span), hi = min(N, lo + span);
  const int t = threadIdx.x, wp = t >> 5, lane = t & 31;
  const bool lead = rank == 0;
  const bool groups = a.has_groups != 0;
  const bool gs = groups && (fam.spr_s || fam.ipa_score);
  const bool spread_s = groups && fam.spr_s;
  const OvlD ovl{a.ovl_used, a.ovl_npods};
  const int64_t NN = N;
  int64_t* gsc = (int64_t*)kt_plan_dyn;
  uint8_t* feas = kt_plan_dyn + 8 * (int64_t)span;
  int64_t* a_tot = (int64_t*)(kt_plan_dyn + plan_dyn_bytes(span));
  ClusterTeam<BLOCK> tm;

  if (groups) {
    for (int v = t; v < a.g.U; v += BLOCK) a_tot[v] = a.gc.ipa_a_total[v];
    if (spread_s)
      for (int k = 0; k < a.g.SC; ++k)
        for (int n = lo + t; n < hi; n += BLOCK) a.flags[k * NN + n] = 0;
  }
  int32_t cur = *cache.sig;   // the SigCache signature, alike in every CTA
  int32_t epoch = 0;
  int64_t tmax_prev = 0, namax_prev = 0;   // the last step's maxima
  tm.sync();                  // every flag zeroed before any is set

  for (int i = 0; i < a.B; ++i) {
    const int32_t s = a.sig[i];
    const int u = a.tidx[i];
    if (u < 0 || u >= a.tb.U || (groups && u >= a.g.U)) {
      // a row outside the tables: report it (the commit rejects any
      // assignment below -1) instead of reading past them
      if (lead && t == 0) a.out[i] = -2;
      continue;
    }
    const PodRowD p = pod_row(a.tb, u);
    const bool use_fast = s != 0 && s == cur;
    const bool vld = a.valid[i] != 0;
    // ImageLocality's cluster-wide counts (:244-249) are needed on a
    // signature change of a pod that names images
    const bool images = !use_fast && p.img_containers > 0;
    const int n_img = images ? V_CNT + a.tb.IC : 0;
    cur = s;
    // the last step's row writes (other threads of this CTA) before any
    // read of this one
    __syncthreads();
    if (t == 0) sh.n_inc = 0;   // this step's increments
    if (images) {
      if (t <= KT_MAX_IC) img[t] = 0;
      __syncthreads();
    }
    int64_t r[V_VALID] = {0, 0, KT_I64_MIN, 0, 0, 0};
    if (!vld) {
      // nothing past the parts is observable for a pod that is not valid
      if (!use_fast)
        for (int n = lo + t; n < hi; n += BLOCK)
          batch_parts(a, p, n, images, img);
      if (images) {
        batch_reduce(tm, r, n_img, img, sh);
        for (int n = lo + t; n < hi; n += BLOCK)
          cache.s_img[n] = kt_row_s_img(na, a.tb, p, n, img + 1, img[0]);
      }
      if (lead && t == 0) a.out[i] = -1;
      continue;
    }

    // ---- the feasible set, the maxima, the group terms, the first max
    const int nom = (a.ovl_used != nullptr && a.nom_idx != nullptr)
                        ? a.nom_idx[i] : -1;
    GViewD v;
    int32_t minv[KT_MAX_SC];
    if (groups) {
      v = view_of(a.g, a.gc, u);
      v.a_total = a_tot[u];
      if (fam.spr_f) {
        // group_mask (:544): the DoNotSchedule minima, negated for the max
        int64_t m[KT_MAX_SC];
#pragma unroll
        for (int k = 0; k < KT_MAX_SC; ++k) {
          int64_t x = KT_INT32_MAX;
          if (k < v.SC)
            for (int n = lo + t; n < hi; n += BLOCK) {
              const int64_t e = (int64_t)k * NN + n;
              if (v.f_elig[e] && v.f_cnt[e] < x) x = v.f_cnt[e];
            }
          m[k] = -x;
        }
        tm.reduce(m, v.SC, 0u, sh);
        for (int k = 0; k < v.SC; ++k)
          minv[k] = v.f_minz[k] ? 0 : (int32_t)(-m[k]);
      }
    }
    // the key under the last step's maxima, when every part it reads is
    // known before the maxima's reduction (no group score, no image
    // counts): when the maxima come out the same, that key is the key
    const bool spec = !gs && !images;
    if (spread_s) ++epoch;
    int64_t l = KT_I64_MAX, h = -KT_I64_MAX;
    for (int n = lo + t; n < hi; n += BLOCK) {
      if (!use_fast) batch_parts(a, p, n, images, img);
      const bool fit = n == nom
          ? kt_own_nomination_fit(na, n, c.used + (int64_t)n * R,
                                  c.npods[n], p, ovl)
          : cache.fit_ok[n] != 0;
      bool f = cache.static_mask[n] && fit;
      if (f && groups) f = kt_group_mask(v, fam, n, minv);
      feas[n - lo] = f;
      if (spec) {
        // (under maxima that do not hold, a score may fall below -1: the
        // shift is unsigned, and that key is thrown away)
        const int64_t val = f ? kt_total(a.cfg, cache, n, tmax_prev,
                                         namax_prev) : -1;
        const int64_t k = (int64_t)((uint64_t)(val + 1) << 32)
                          | (int64_t)(0x7fffffff - n);
        r[V_KEY] = k > r[V_KEY] ? k : r[V_KEY];
      }
      if (!f) continue;
      r[V_TMAX] = cache.taint_raw[n] > r[V_TMAX] ? cache.taint_raw[n]
                                                 : r[V_TMAX];
      r[V_NAMAX] = cache.na_raw[n] > r[V_NAMAX] ? cache.na_raw[n]
                                                : r[V_NAMAX];
      if (groups && fam.ipa_score) {
        const int64_t x = v.iscore[n];
        l = x < l ? x : l;
        h = x > h ? x : h;
      }
      if (spread_s && v.s_keys_ok[n]) {
        ++r[V_NPART];
        for (int k = 0; k < v.SC; ++k)
          a.flags[k * NN + v.s_dom[(int64_t)k * NN + n]] = epoch;
      }
    }
    // the normalization maxima (:539), the speculated key, the group
    // score partials and the image counts: one reduction
    r[V_LO] = -l;
    r[V_HI] = h;
    batch_reduce(tm, r, images ? n_img : gs ? V_NPART + 1 : V_KEY + 1, img,
                 sh);
    const int64_t tmax = r[V_TMAX], namax = r[V_NAMAX];
    const bool key_ok = spec && tmax == tmax_prev && namax == namax_prev;
    tmax_prev = tmax;
    namax_prev = namax;
    int64_t key = r[V_KEY];
    if (!key_ok) {
      const int64_t lo_s = -r[V_LO], hi_s = r[V_HI], npart = r[V_NPART];
      int64_t rmin = 0, rmax = 0;
      bool has_s = false;
      if (spread_s) {
        has_s = kt_has_s(v);
        // distinct scored domains: this epoch's flags on the CTA's rows
        int64_t dct[KT_MAX_SC];
#pragma unroll
        for (int k = 0; k < KT_MAX_SC; ++k) {
          int64_t x = 0;
          if (k < v.SC)
            for (int n = lo + t; n < hi; n += BLOCK)
              x += __ldcg(a.flags + k * NN + n) == epoch;
          dct[k] = x;
        }
        tm.reduce(dct, v.SC, 0xffu, sh);
        double weight[KT_MAX_SC];
        for (int k = 0; k < v.SC; ++k) {
          const int64_t size = v.s_is_host[k] ? npart : dct[k];
          weight[k] = log(__dadd_rn((double)size, 2.0));
        }
        // the raw spread scores (block_spread_raw) and their range
        int64_t rl = KT_INT32_MAX, rh = 0;
        for (int n = lo + t; n < hi; n += BLOCK) {
          double tot = 0.0;
          for (int k = 0; k < v.SC; ++k) {
            const int64_t e = (int64_t)k * NN + n;
            const double x = (v.s_act[k] && v.s_tv[e] != 0)
                ? __dadd_rn(__dmul_rn((double)v.s_cnt[e], weight[k]),
                            (double)(v.s_skew[k] - 1))
                : 0.0;
            tot = k == 0 ? x : __dadd_rn(tot, x);
          }
          const int64_t r = (int64_t)rint(tot);
          gsc[n - lo] = r;
          if (feas[n - lo] && v.s_keys_ok[n]) {
            rl = r < rl ? r : rl;
            rh = r > rh ? r : rh;
          }
        }
        int64_t q[2] = {-rl, rh};
        tm.reduce(q, 2, 0u, sh);
        rmin = -q[0];
        rmax = q[1];
      }
      // masked total + first-max argmax (:949-951) as one packed key; a
      // signature change with images writes ImageLocality here
      key = KT_I64_MIN;
      for (int n = lo + t; n < hi; n += BLOCK) {
        if (images)
          cache.s_img[n] = kt_row_s_img(na, a.tb, p, n, img + 1, img[0]);
        int64_t val = -1;
        if (feas[n - lo]) {
          val = kt_total(a.cfg, cache, n, tmax, namax);
          if (gs)
            val += kt_group_score(v, fam, n, true,
                                  spread_s ? gsc[n - lo] : 0, a.w_spread,
                                  a.w_ipa, has_s, rmin, rmax, lo_s, hi_s);
        }
        const int64_t k = ((val + 1) << 32) | (int64_t)(0x7fffffff - n);
        key = k > key ? k : key;
      }
      int64_t kk[1] = {key};
      tm.reduce(kk, 1, 0u, sh);
      key = kk[0];
    }
    int64_t score;
    int32_t best;
    kt_plan_unkey(key, &score, &best);
    const bool assigned = score >= 0;
    if (lead && t == 0) a.out[i] = assigned ? best : -1;
    if (!assigned) continue;

    // ---- the placement: _apply_assignment (:906), the overlay's
    // consumption (:955-960), _row_refresh (:458), group_update (:961)
    const bool owner = best >= lo && best < hi;
    const bool nom_owner = nom >= lo && nom < hi;   // nom < 0: never
    const int ncand = groups ? plan_candidates(a.g, fam) : 0;
    for (int base = 0;; base += KT_INC_CAP) {
      if (t < KT_INC_CAP && base + t < ncand)
        plan_gate<BLOCK>(fam, a.g, a.gc, a.g, owner, best, u, base + t, sh,
                         [&](int64_t cv) {
          atomicAdd((unsigned long long*)&a_tot[cv], 1ull);
        });
      if (base == 0 && owner && wp == KT_INC_CAP / 32) {
        for (int r = lane; r < R + 3; r += 32) {
          if (r < R)
            c.used[(int64_t)best * R + r] += p.req[r];
          else if (r < R + 2)
            c.nonzero_used[(int64_t)best * 2 + r - R] += p.nonzero_req[r - R];
          else
            c.npods[best] += 1;
        }
      }
      if (base == 0 && owner && wp == KT_INC_CAP / 32 + 1)
        kt_warp_place_ports(c.ports + (int64_t)best * c.P, c.P, p, a.tb.PP,
                            lane);
      if (base == 0 && nom_owner && wp == KT_INC_CAP / 32 + 2) {
        // the commit deletes a bound pod's nomination: consume it at its
        // NOMINATED row
        for (int r = lane; r <= R; r += 32) {
          if (r < R)
            a.ovl_used[(int64_t)nom * R + r] -= p.req[r];
          else
            a.ovl_npods[nom] -= 1;
        }
      }
      __syncthreads();
      // the refresh's three parts side by side, a warp each (the last
      // three warps' last lanes)
      if (base == 0 && owner && t % 32 == 31 && wp >= BLOCK / 32 - 3)
        batch_refresh(a, p, best, BLOCK / 32 - 1 - wp);
      plan_sweep<BLOCK>(lo, hi, sh.n_inc, sh);
      if (base + KT_INC_CAP >= ncand) break;
      __syncthreads();
      if (t == 0) sh.n_inc = 0;
      __syncthreads();
    }
  }
  tm.finish();   // every CTA read the input signature and ipa_a_total
  if (lead) {
    if (t == 0) *cache.sig = cur;
    if (groups)
      for (int v = t; v < a.g.U; v += BLOCK) a.gc.ipa_a_total[v] = a_tot[v];
  }
}

}  // namespace

extern "C" int ktpu_run_batch(const BatchArgs* args, void* stream) {
  if (args->B <= 0) return 0;
  const int C = KT_BATCH_CLUSTER, N = args->na.N;
  const int smem = batch_dyn_bytes((N + C - 1) / C,
                                   args->has_groups ? args->g.U : 0);
  cudaError_t e = cudaFuncSetAttribute(
      run_batch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(run_batch_kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C);
  cfg.blockDim = dim3(BLOCK);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = C;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, run_batch_kernel, *args);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
