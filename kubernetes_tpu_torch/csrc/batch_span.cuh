// The scan's span — kubernetes_tpu/ops/program.py _run_batch_impl (:929)
// with _eval_pod (:495), _apply_assignment (:906), _row_refresh (:458) and
// the group steps — written once for a team of CTAs that splits the node
// axis, shared by run_batch.cu (one device: a thread-block cluster,
// ClusterTeam, the overlay variant included) and run_batch_sharded.cu (a
// mesh's shards on one card: one cooperative grid, GridTeam), as
// plan_span.cuh is for the plan program. The node axis may be cut into D
// equal shards, each with its own arrays (BatchNodesC); every CTA owns a
// contiguous range of one shard's rows.
//
// A step, in the reference's order:
//   1. the signature test, decided alike in every CTA from the pod stream
//      (the SigCache signature is replicated, so every shard takes the
//      same branch; a row outside the tables reports -2 and leaves the
//      signature);
//   2. with groups, the spread minima (one reduction);
//   3. one pass over the CTA's rows: on a signature change the slow path
//      (kt_row_parts) and the row's share of ImageLocality's counts; the
//      feasible set into shared memory (the cached static mask and fit,
//      the nominated row's effective fit computed by its owner and only
//      there, the group mask); the normalization maxima, the group score
//      partials, the epoch-tagged spread domain flags (no pass zeroes
//      them); and, where no group score and no image count is pending,
//      the packed key under the last step's maxima. ONE reduction carries
//      all of it (IC + 1 image sums included): every cross-row value is an
//      integer max or sum, so the team's values are the cluster's, the
//      JAX program's psum / pmax over the shards;
//   4. when the maxima equal the last step's, that key is the key (a run
//      of same-signature lean pods: one reduction a pod); otherwise the
//      distinct spread domains and the raw spread range (one reduction
//      each), ImageLocality written, and the key (one reduction). The key
//      is ((score + 1) << 32) | (INT32_MAX − global row), global = the
//      shard's offset + the local row, so a tie across a CTA or shard
//      boundary goes to the lowest global row, as the JAX program's pmax
//      of the score and then pmin of the index;
//   5. on a placement only the owner CTA of the chosen row writes: one
//      warp its used / nonzero / pods row, one its ports, the owner of the
//      nominated row consumes the overlay there, then three threads in
//      three warps refresh fit_ok, s_fit and s_bal side by side (the
//      refresh is the step's critical path, which one warp running the
//      three in turn tripled, PERF.md §6); the group increments are
//      decided once from the chosen node's topology values, read from the
//      owning shard's static arrays (every shard lies on one card: no
//      `own` exchange), and listed (plan_gate), then each CTA sweeps its
//      own rows over the list (plan_sweep), so each counter element keeps
//      one writer.
// Every row's carry, SigCache and counter fields are written only by the
// thread that owns the row. The spread domain flags ([SC, n_global], a
// domain's id the first global row with its value) are the one array a
// CTA writes outside its rows. ipa_a_total, the one per-row-of-the-table
// counter, lives in each CTA's shared memory; the first CTA of each shard
// writes that shard's copy, and its SigCache signature, at the end. A pod
// that is not valid stops after the slow path: nothing else it computes
// is observable. The wrappers hand the kernels fresh copies of every carry
// field they write.
#pragma once

#include "plan_span.cuh"

// what every shard of the span shares, mirrored field for field by ctypes
// (ops/kernels.py BatchSpanC)
struct BatchSpanC {
  TableC tb;
  CfgC cfg;
  FamC fam;
  int32_t has_groups;     // 0: the lean scan
  int64_t w_spread, w_ipa;
  int32_t* flags;         // [SC, n_global] epoch-tagged spread domain flags
  int64_t* ovl_used;      // [N, R] scratch copy of the overlay, consumed
                          // (nullptr: no overlay; one device only)
  int32_t* ovl_npods;     // [N]
  const int32_t* nom_idx; // [B] each pod's own nominated row (-1 none),
                          // nullptr when no pod of the span is nominated
  const uint8_t* valid;   // [B]
  const int32_t* sig;     // [B]
  const int32_t* tidx;    // [B]
  int32_t B;
  int32_t n_global, n_local, D;
  int64_t* part;          // [2, blocks, KT_RED_K] a grid team's slots
  int32_t* out;           // [B] assignments
};

// one node shard's arrays (ops/kernels.py BatchNodesC); on one device the
// shard is the whole axis
struct BatchNodesC {
  NodeC na;
  CarryC c;               // the output carry (fresh copies), in place
  GroupsC g;              // the shard's GroupsDev (has_groups only)
  GCarryC gc;             // the output group carry, in place
  int32_t offset;         // global index of the shard's row 0
};

// a CTA's dynamic shared memory for `span` rows: plan_span's layout (the
// raw spread scores, the feasible set), then ipa_a_total [U] in group mode
__host__ __device__ inline int batch_dyn_bytes(int span, int U) {
  return plan_dyn_bytes(span) + 8 * U;
}

// the values of a step's one fused reduction: r[0..V_VALID), each
// thread's own (the maxima — the normalization denominators, the
// speculated key, the inter-pod score range with its low end negated —
// then the scored spread rows' sum), and the image counts, the CTA's in
// shared memory (img: the valid rows, then the rows holding each of the
// pod's images), summed
enum : int {
  KT_BV_TMAX, KT_BV_NAMAX, KT_BV_KEY, KT_BV_LO, KT_BV_HI, KT_BV_NPART,
  KT_BV_VALID, KT_BV_CNT, KT_BV_N = KT_BV_CNT + KT_MAX_IC
};
constexpr uint32_t KT_BV_SUMS = ~((1u << KT_BV_NPART) - 1u);

// the team reduction of the step's first n values, in chunks of KT_RED_K
// (one team barrier each): r gets the team's values and, when n takes in
// the image counts (thread 0 contributes the CTA's), img the team's
template <int BLOCK, class Team>
__device__ __forceinline__ void batch_reduce(Team& tm,
                                             int64_t (&r)[KT_BV_VALID],
                                             int n, int64_t* img,
                                             PlanShared<BLOCK>& sh) {
  const bool images = n > KT_BV_VALID;
  const bool t0 = threadIdx.x == 0;
  if (images) __syncthreads();   // every row's counts in img
#pragma unroll
  for (int j = 0; j < KT_BV_N; j += KT_RED_K) {
    if (j >= n) break;
    int64_t x[KT_RED_K];
#pragma unroll
    for (int k = 0; k < KT_RED_K; ++k) {
      const int e = j + k;
      x[k] = e < KT_BV_VALID ? r[e]
           : (e < KT_BV_N && e < n && t0) ? img[e - KT_BV_VALID] : 0;
    }
    tm.reduce(x, min(KT_RED_K, n - j), KT_BV_SUMS >> j, sh);
#pragma unroll
    for (int k = 0; k < KT_RED_K; ++k) {
      const int e = j + k;
      if (e < KT_BV_VALID)
        r[e] = x[k];
      else if (e < KT_BV_N && e < n && t0)
        img[e - KT_BV_VALID] = x[k];
    }
  }
  if (images) __syncthreads();   // the team's counts before any read
}

// _slow_parts (:424) of row n: every SigCache part but ImageLocality's
// (0 for a pod that names no image), and, when `images`, the row's share
// of the image counts added to the CTA's (one add a warp and count)
__device__ __forceinline__ void batch_parts(const BatchSpanC& a,
                                            const BatchNodesC& s,
                                            const PodRowD& p, int n,
                                            bool images, int64_t* img) {
  const uint32_t bits = kt_row_parts(a.cfg, s.na, a.tb, s.c, p, n,
                                     s.c.cache,
                                     OvlD{a.ovl_used, a.ovl_npods});
  if (!images) {
    s.c.cache.s_img[n] = 0;
    return;
  }
  const unsigned am = __activemask();
  const bool leader = (int)(threadIdx.x & 31) == __ffs(am) - 1;
  for (int k = 0; k <= a.tb.IC; ++k) {
    const bool hit = k == 0 ? s.na.valid[n] != 0 : (bits >> (k - 1)) & 1u;
    const unsigned m = __ballot_sync(am, hit);
    if (leader && m)
      atomicAdd((unsigned long long*)&img[k], (unsigned long long)__popc(m));
  }
}

// the whole span on the team's rows [lo, hi) of shard d of `all` (at most
// `span` rows a CTA). `shard_lead`: this CTA writes the shard's replicated
// scalars (the SigCache signature, ipa_a_total); `lead`: this CTA writes
// the assignments. `img`: the CTA's image counts in shared memory.
template <int BLOCK, class Team>
__device__ void batch_span(const BatchSpanC& a, const BatchNodesC* all,
                           int d, int lo, int hi, int span, bool shard_lead,
                           bool lead, Team& tm, PlanShared<BLOCK>& sh,
                           int64_t* img) {
  const BatchNodesC& s = all[d];
  const NodeC& na = s.na;
  const CarryC& c = s.c;
  const CacheC& cache = c.cache;
  const FamC& fam = a.fam;
  const int N = na.N, R = na.R, off = s.offset;
  const int t = threadIdx.x, wp = t >> 5, lane = t & 31;
  const bool groups = a.has_groups != 0;
  const bool gs = groups && (fam.spr_s || fam.ipa_score);
  const bool spread_s = groups && fam.spr_s;
  const OvlD ovl{a.ovl_used, a.ovl_npods};
  const int64_t NN = N, NG = a.n_global;
  int64_t* gsc = (int64_t*)kt_plan_dyn;
  uint8_t* feas = kt_plan_dyn + 8 * (int64_t)span;
  int64_t* a_tot = (int64_t*)(kt_plan_dyn + plan_dyn_bytes(span));

  if (groups) {
    for (int v = t; v < s.g.U; v += BLOCK) a_tot[v] = s.gc.ipa_a_total[v];
    if (spread_s)
      for (int k = 0; k < s.g.SC; ++k)
        for (int n = lo + t; n < hi; n += BLOCK) a.flags[k * NG + off + n] = 0;
  }
  int32_t cur = *cache.sig;   // the SigCache signature, alike in every CTA
  int32_t epoch = 0;
  int64_t tmax_prev = 0, namax_prev = 0;   // the last step's maxima
  tm.sync();                  // every flag zeroed before any is set

  for (int i = 0; i < a.B; ++i) {
    const int32_t sg = a.sig[i];
    const int u = a.tidx[i];
    if (u < 0 || u >= a.tb.U || (groups && u >= s.g.U)) {
      // a row outside the tables: report it (the commit rejects any
      // assignment below -1) instead of reading past them
      if (lead && t == 0) a.out[i] = -2;
      continue;
    }
    const PodRowD p = pod_row(a.tb, u);
    const bool use_fast = sg != 0 && sg == cur;
    const bool vld = a.valid[i] != 0;
    // ImageLocality's cluster-wide counts (:244-249) are needed on a
    // signature change of a pod that names images
    const bool images = !use_fast && p.img_containers > 0;
    const int n_img = images ? KT_BV_CNT + a.tb.IC : 0;
    cur = sg;
    // the last step's row writes (other threads of this CTA) before any
    // read of this one
    __syncthreads();
    if (t == 0) sh.n_inc = 0;   // this step's increments
    if (images) {
      if (t <= KT_MAX_IC) img[t] = 0;
      __syncthreads();
    }
    int64_t r[KT_BV_VALID] = {0, 0, KT_I64_MIN, 0, 0, 0};
    if (!vld) {
      // nothing past the parts is observable for a pod that is not valid
      if (!use_fast)
        for (int n = lo + t; n < hi; n += BLOCK)
          batch_parts(a, s, p, n, images, img);
      if (images) {
        batch_reduce<BLOCK>(tm, r, n_img, img, sh);
        for (int n = lo + t; n < hi; n += BLOCK)
          cache.s_img[n] = kt_row_s_img(na, a.tb, p, n, img + 1, img[0]);
      }
      if (lead && t == 0) a.out[i] = -1;
      continue;
    }

    // ---- the feasible set, the maxima, the group terms, the first max
    // (the nominated row: a global index, on its owning shard's rows)
    const int nom = (a.ovl_used != nullptr && a.nom_idx != nullptr)
                        ? a.nom_idx[i] - off : -1;
    GViewD v;
    int32_t minv[KT_MAX_SC];
    if (groups) {
      v = view_of(s.g, s.gc, u);
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
      if (!use_fast) batch_parts(a, s, p, n, images, img);
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
                          | (int64_t)(0x7fffffff - (off + n));
        r[KT_BV_KEY] = k > r[KT_BV_KEY] ? k : r[KT_BV_KEY];
      }
      if (!f) continue;
      r[KT_BV_TMAX] = cache.taint_raw[n] > r[KT_BV_TMAX] ? cache.taint_raw[n]
                                                         : r[KT_BV_TMAX];
      r[KT_BV_NAMAX] = cache.na_raw[n] > r[KT_BV_NAMAX] ? cache.na_raw[n]
                                                        : r[KT_BV_NAMAX];
      if (groups && fam.ipa_score) {
        const int64_t x = v.iscore[n];
        l = x < l ? x : l;
        h = x > h ? x : h;
      }
      if (spread_s && v.s_keys_ok[n]) {
        ++r[KT_BV_NPART];
        for (int k = 0; k < v.SC; ++k)
          a.flags[k * NG + v.s_dom[(int64_t)k * NN + n]] = epoch;
      }
    }
    // the normalization maxima (:539), the speculated key, the group
    // score partials and the image counts: one reduction
    r[KT_BV_LO] = -l;
    r[KT_BV_HI] = h;
    batch_reduce<BLOCK>(tm, r, images ? n_img
                                      : gs ? KT_BV_NPART + 1 : KT_BV_KEY + 1,
                        img, sh);
    const int64_t tmax = r[KT_BV_TMAX], namax = r[KT_BV_NAMAX];
    const bool key_ok = spec && tmax == tmax_prev && namax == namax_prev;
    tmax_prev = tmax;
    namax_prev = namax;
    int64_t key = r[KT_BV_KEY];
    if (!key_ok) {
      const int64_t lo_s = -r[KT_BV_LO], hi_s = r[KT_BV_HI];
      const int64_t npart = r[KT_BV_NPART];
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
              x += __ldcg(a.flags + k * NG + off + n) == epoch;
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
          const int64_t rr = (int64_t)rint(tot);
          gsc[n - lo] = rr;
          if (feas[n - lo] && v.s_keys_ok[n]) {
            rl = rr < rl ? rr : rl;
            rh = rr > rh ? rr : rh;
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
        const int64_t k = ((val + 1) << 32)
                          | (int64_t)(0x7fffffff - (off + n));
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
    const int d_own = best / a.n_local, lb = best - d_own * a.n_local;
    const bool owner = d_own == d && lb >= lo && lb < hi;
    const bool nom_owner = nom >= lo && nom < hi;   // nom < 0: never
    const int ncand = groups ? plan_candidates(s.g, fam) : 0;
    for (int base = 0;; base += KT_INC_CAP) {
      if (t < KT_INC_CAP && base + t < ncand)
        plan_gate<BLOCK>(fam, s.g, s.gc, all[d_own].g, owner, lb, u,
                         base + t, sh, [&](int64_t cv) {
          atomicAdd((unsigned long long*)&a_tot[cv], 1ull);
        });
      if (base == 0 && owner && wp == KT_INC_CAP / 32) {
        for (int rr = lane; rr < R + 3; rr += 32) {
          if (rr < R)
            c.used[(int64_t)lb * R + rr] += p.req[rr];
          else if (rr < R + 2)
            c.nonzero_used[(int64_t)lb * 2 + rr - R] += p.nonzero_req[rr - R];
          else
            c.npods[lb] += 1;
        }
      }
      if (base == 0 && owner && wp == KT_INC_CAP / 32 + 1)
        kt_warp_place_ports(c.ports + (int64_t)lb * c.P, c.P, p, a.tb.PP,
                            lane);
      if (base == 0 && nom_owner && wp == KT_INC_CAP / 32 + 2) {
        // the commit deletes a bound pod's nomination: consume it at its
        // NOMINATED row
        for (int rr = lane; rr <= R; rr += 32) {
          if (rr < R)
            a.ovl_used[(int64_t)nom * R + rr] -= p.req[rr];
          else
            a.ovl_npods[nom] -= 1;
        }
      }
      __syncthreads();
      // the refresh's three parts side by side, a warp each (the last
      // three warps' last lanes)
      if (base == 0 && owner && t % 32 == 31 && wp >= BLOCK / 32 - 3) {
        const int64_t* used_row = s.c.used + (int64_t)lb * R;
        if (wp == BLOCK / 32 - 1)
          s.c.cache.fit_ok[lb] = kt_fit_ovl(s.na, lb, used_row,
                                            s.c.npods[lb], p,
                                            OvlD{a.ovl_used, a.ovl_npods});
        else
          kt_refresh_score(a.cfg, s.na, lb, used_row,
                           s.c.nonzero_used + (int64_t)lb * 2, p,
                           BLOCK / 32 - 1 - wp, s.c.cache.s_fit + lb,
                           s.c.cache.s_bal + lb);
      }
      plan_sweep<BLOCK>(lo, hi, sh.n_inc, sh);
      if (base + KT_INC_CAP >= ncand) break;
      __syncthreads();
      if (t == 0) sh.n_inc = 0;
      __syncthreads();
    }
  }
  tm.finish();   // every CTA read the input signature and ipa_a_total
  if (shard_lead) {
    if (t == 0) *cache.sig = cur;
    if (groups)
      for (int v = t; v < s.g.U; v += BLOCK) s.gc.ipa_a_total[v] = a_tot[v];
  }
}
