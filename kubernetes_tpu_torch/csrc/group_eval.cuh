// Per-node group math (PodTopologySpread + InterPodAffinity) shared by the
// wave kernel (run_wave.cu), the plan span (plan_span.cuh) and the scan
// kernel (run_batch.cu) through their per-row helpers, and the node-sharded
// forms (run_batch_sharded.cu, run_plan_sharded.cu). Each
// function is the CUDA form of the matching plain function in
// kubernetes_tpu_torch/ops/groups.py and of kubernetes_tpu/ops/groups.py
// (line numbers below):
//   block_spread_min / kt_group_mask   group_mask_view   (:287-329)
//     (block_spread_min_local: a node shard's part of the minimum)
//   kt_group_score and its phases      group_scores_view (:389-444),
//     block_score_partials,            _ipa_norm_scores  (:459-472),
//     block_spread_weights,            for a node shard
//     block_spread_raw
//   block_own_write /                  group_update on a node shard, its
//     block_group_update_own           `pick` psum'd (parallel/sharding.py
//                                      :142-155)
// (_dom_share and wave_fold for a team of CTAs are run_wave.cu's
// team_dom_share / team_wave_fold.)
//
// The block_* functions run inside ONE block that owns its rows (node n
// belongs to thread n % BLOCK), so the reductions are block reductions
// and the scatters are plain stores or shared/global atomics followed by
// a barrier (group_update itself, for a team of CTAs, is plan_span.cuh's
// plan_gate / plan_sweep). The family flags (FamC) are runtime ints: a
// spread-only span skips every inter-pod-affinity loop, as the JAX
// program skips them at trace time.
//
// Arithmetic rules: counts are int32 and the score surface int64, as in
// the JAX package; the spread score's float64 terms use the rounded
// intrinsics (no FMA) and rint (round half to even, jnp.round); the
// inter-pod normalization takes its range in wrapping int64 arithmetic,
// as XLA does (only masked-out nodes can see a wrapped value).
#pragma once

#include "lean_eval.cuh"

#define KT_MAX_SC 8          // spread constraints per row
#define KT_INT32_MAX 2147483647LL
#define KT_I64_MAX 9223372036854775807LL
#define KT_M_CAP 32          // run_wave's spread-replay level cap

struct GroupsC {          // GroupsDev, field for field ([U] rows, [N] nodes)
  const uint8_t* spr_f_active;    // [U, SC]
  const int32_t* spr_f_max_skew;  // [U, SC]
  const int32_t* spr_f_self;      // [U, SC]
  const int32_t* spr_f_tv;        // [U, SC, N]
  const uint8_t* spr_f_elig;      // [U, SC, N]
  const int32_t* spr_f_dom;       // [U, SC, N]
  const uint8_t* spr_s_active;    // [U, SC]
  const int32_t* spr_s_max_skew;  // [U, SC]
  const uint8_t* spr_s_is_host;   // [U, SC]
  const int32_t* spr_s_tv;        // [U, SC, N]
  const uint8_t* spr_s_elig;      // [U, SC, N]
  const uint8_t* spr_s_keys_ok;   // [U, N]
  const int32_t* spr_s_dom;       // [U, SC, N]
  const uint8_t* ipa_ra_active;   // [U, TA]
  const int32_t* ipa_ra_tv;       // [U, TA, N]
  const int32_t* ipa_ra_dom;      // [U, TA, N]
  const uint8_t* ipa_raa_active;  // [U, TAA]
  const int32_t* ipa_raa_tv;      // [U, TAA, N]
  const int32_t* ipa_raa_dom;     // [U, TAA, N]
  const uint8_t* ipa_self_all;    // [U]
  const int32_t* ipa_stc_tv;      // [U, CT, N]
  const int32_t* ipa_stc_dom;     // [U, CT, N]
  const int32_t* ipa_stp_tv;      // [U, PT, N]
  const int32_t* ipa_stp_dom;     // [U, PT, N]
  const uint8_t* m_spr_f;         // [U, U, SC]
  const uint8_t* m_spr_s;         // [U, U, SC]
  const uint8_t* m_ipa_a;         // [U, U]
  const uint8_t* m_ipa_aa;        // [U, U, TAA]
  const uint8_t* m_ipa_exist;     // [U, U, TAA]
  const int64_t* w_stc;           // [U, U, CT]
  const int64_t* w_stp;           // [U, U, PT]
  int32_t U, SC, TA, TAA, CT, PT, N;
};

struct GCarryC {          // GroupCarry
  int32_t* spr_f_cnt;       // [U, SC, N]
  uint8_t* spr_f_min_zero;  // [U, SC]
  int32_t* spr_s_cnt;       // [U, SC, N]
  int32_t* ipa_veto;        // [U, N]
  int32_t* ipa_a_cnt;       // [U, TA, N]
  int64_t* ipa_a_total;     // [U]
  int32_t* ipa_aa_cnt;      // [U, TAA, N]
  int64_t* ipa_score;       // [U, N]
};

struct FamC {             // GroupFamilies
  int32_t spr_f, spr_s, ipa_req, ipa_anti, ipa_score;
};

// one signature row's group tensors (GroupView); the wave kernel points
// f_cnt / veto / aa_cnt at its maintained in-run counters
struct GViewD {
  const uint8_t* f_act;
  const int32_t* f_skew;
  const int32_t* f_self;
  const uint8_t* f_minz;
  const int32_t* f_tv;      // [SC, N]
  const uint8_t* f_elig;    // [SC, N]
  const int32_t* f_cnt;     // [SC, N]
  const int32_t* f_dom;     // [SC, N] dense domain ids
  const uint8_t* s_act;
  const int32_t* s_skew;
  const uint8_t* s_is_host;
  const int32_t* s_tv;      // [SC, N]
  const uint8_t* s_keys_ok; // [N]
  const int32_t* s_dom;     // [SC, N]
  const int32_t* s_cnt;     // [SC, N]
  const uint8_t* ra_act;
  const int32_t* ra_tv;     // [TA, N]
  const uint8_t* raa_act;
  const int32_t* raa_tv;    // [TAA, N]
  bool self_all;
  const int32_t* veto;      // [N]
  const int32_t* a_cnt;     // [TA, N]
  int64_t a_total;
  const int32_t* aa_cnt;    // [TAA, N]
  const int64_t* iscore;    // [N]
  int32_t SC, TA, TAA, N;
};

__device__ __forceinline__ GViewD view_of(const GroupsC& g,
                                          const GCarryC& c, int u) {
  GViewD v;
  const int64_t N = g.N, SC = g.SC, TA = g.TA, TAA = g.TAA;
  v.f_act = g.spr_f_active + u * SC;
  v.f_skew = g.spr_f_max_skew + u * SC;
  v.f_self = g.spr_f_self + u * SC;
  v.f_minz = c.spr_f_min_zero + u * SC;
  v.f_tv = g.spr_f_tv + u * SC * N;
  v.f_elig = g.spr_f_elig + u * SC * N;
  v.f_cnt = c.spr_f_cnt + u * SC * N;
  v.f_dom = g.spr_f_dom + u * SC * N;
  v.s_act = g.spr_s_active + u * SC;
  v.s_skew = g.spr_s_max_skew + u * SC;
  v.s_is_host = g.spr_s_is_host + u * SC;
  v.s_tv = g.spr_s_tv + u * SC * N;
  v.s_keys_ok = g.spr_s_keys_ok + u * N;
  v.s_dom = g.spr_s_dom + u * SC * N;
  v.s_cnt = c.spr_s_cnt + u * SC * N;
  v.ra_act = g.ipa_ra_active + u * TA;
  v.ra_tv = g.ipa_ra_tv + u * TA * N;
  v.raa_act = g.ipa_raa_active + u * TAA;
  v.raa_tv = g.ipa_raa_tv + u * TAA * N;
  v.self_all = g.ipa_self_all[u] != 0;
  v.veto = c.ipa_veto + u * N;
  v.a_cnt = c.ipa_a_cnt + u * TA * N;
  v.a_total = c.ipa_a_total[u];
  v.aa_cnt = c.ipa_aa_cnt + u * TAA * N;
  v.iscore = c.ipa_score + u * N;
  v.SC = g.SC;
  v.TA = g.TA;
  v.TAA = g.TAA;
  v.N = g.N;
  return v;
}

template <int BLOCK>
__device__ __forceinline__ int64_t block_min(int64_t x,
                                             BlockScratch<BLOCK>& sh) {
  // no caller passes KT_I64_MIN, so the negation cannot overflow
  return -block_max<BLOCK>(-x, sh);
}

// the DoNotSchedule minimum per constraint over this block's
// count-eligible rows, INT32_MAX where none (on a node shard the shard's
// part of the pmin, kubernetes_tpu/ops/groups.py:298-299): thread 0
// writes out[c] (a negated minimum, for an exchange that maxes, when
// `negate`). Ends with a barrier.
template <int BLOCK, class T>
__device__ void block_spread_min_local(const GViewD& v, T* out, bool negate,
                                       BlockScratch<BLOCK>& sh) {
  const int N = v.N;
  for (int c = 0; c < v.SC; ++c) {
    int64_t m = KT_INT32_MAX;
    for (int n = threadIdx.x; n < N; n += BLOCK) {
      const int64_t k = (int64_t)c * N + n;
      if (v.f_elig[k] && v.f_cnt[k] < m) m = v.f_cnt[k];
    }
    m = block_min<BLOCK>(m, sh);
    if (threadIdx.x == 0) out[c] = (T)(negate ? -m : m);
  }
  __syncthreads();
}

// the DoNotSchedule minimum per constraint over the count-eligible nodes,
// 0 when fewer eligible domains than minDomains (filtering.go:66-77);
// INT32_MAX when no node is eligible. Ends with a barrier.
template <int BLOCK>
__device__ void block_spread_min(const GViewD& v, int32_t* minv_sh,
                                 BlockScratch<BLOCK>& sh) {
  block_spread_min_local<BLOCK>(v, minv_sh, false, sh);
  if (threadIdx.x == 0)
    for (int c = 0; c < v.SC; ++c)
      if (v.f_minz[c]) minv_sh[c] = 0;
  __syncthreads();
}

// group_mask_view for node n, given the spread minima
__device__ __forceinline__ bool kt_group_mask(const GViewD& v,
                                              const FamC& fam, int n,
                                              const int32_t* minv) {
  const int64_t N = v.N;
  if (fam.spr_f) {
    for (int c = 0; c < v.SC; ++c) {
      if (!v.f_act[c]) continue;
      const int64_t k = c * N + n;
      // a node missing the key is UnschedulableAndUnresolvable
      if (v.f_tv[k] == 0) return false;
      if ((int64_t)v.f_cnt[k] + v.f_self[c] - minv[c] > v.f_skew[c])
        return false;
    }
  }
  if (fam.ipa_anti) {
    if (v.veto[n] != 0) return false;
    for (int t = 0; t < v.TAA; ++t) {
      const int64_t k = t * N + n;
      if (v.raa_act[t] && v.raa_tv[k] != 0 && v.aa_cnt[k] > 0) return false;
    }
  }
  if (fam.ipa_req) {
    bool any = false, tv_all = true, pods_exist = true;
    for (int t = 0; t < v.TA; ++t) {
      if (!v.ra_act[t]) continue;
      const int64_t k = t * N + n;
      any = true;
      tv_all = tv_all && v.ra_tv[k] != 0;
      pods_exist = pods_exist && v.a_cnt[k] > 0;
    }
    const bool escape = v.a_total == 0 && v.self_all;
    if (any && !(tv_all && (pods_exist || escape))) return false;
  }
  return true;
}

// _ipa_norm_scores for one node, given the feasible-set range
__device__ __forceinline__ int64_t kt_ipa_norm(int64_t s, int64_t lo,
                                               int64_t hi) {
  const int64_t diff =
      (int64_t)((unsigned long long)hi - (unsigned long long)lo);
  if (diff <= 0) return 0;
  const int64_t d = (int64_t)((unsigned long long)s - (unsigned long long)lo);
  const double val = __ddiv_rn(__dmul_rn(100.0, (double)d), (double)diff);
  return (int64_t)val;
}

// The phases of group_scores_view for a node shard: the sharded kernels
// run each phase in its own launch, with the exchange of the partial sums,
// minima and maxima (the JAX package's _gsum / _gmin / _gmax points,
// kubernetes_tpu/ops/groups.py:398-422) between them; the cluster and grid
// bodies (plan_span.cuh, batch_span.cuh, run_wave.cu) run them as team
// reductions.

// phase 1, over this block's rows: *npart = scored rows (feasible & all
// keys), flags[c * n_seg + id] = 1 at the dense domain id of every
// scored row (zeroed first; the ids are global on a node shard, n_seg the
// global node count), and the symmetric score surface's range over the
// feasible rows (*lo, *hi; I64_MAX and -I64_MAX when none). Each part is
// computed only for its family. Starts and ends with a barrier.
template <int BLOCK, class F>
__device__ void block_score_partials(const GViewD& v, const FamC& fam,
                                     const uint8_t* feas, F* flags, int n_seg,
                                     int64_t* npart, int64_t* lo, int64_t* hi,
                                     BlockScratch<BLOCK>& sh) {
  const int N = v.N;
  __syncthreads();
  if (fam.ipa_score) {
    int64_t l = KT_I64_MAX, h = -KT_I64_MAX;
    for (int n = threadIdx.x; n < N; n += BLOCK) {
      if (!feas[n]) continue;
      const int64_t s = v.iscore[n];
      l = s < l ? s : l;
      h = s > h ? s : h;
    }
    *lo = block_min<BLOCK>(l, sh);
    *hi = block_max<BLOCK>(h, sh);
  }
  if (fam.spr_s) {
    int64_t np = 0;
    for (int n = threadIdx.x; n < N; n += BLOCK)
      np += feas[n] && v.s_keys_ok[n];
    *npart = block_sum<BLOCK>(np, sh);
    for (int64_t e = threadIdx.x; e < (int64_t)v.SC * n_seg; e += BLOCK)
      flags[e] = 0;
    __syncthreads();
    for (int c = 0; c < v.SC; ++c)
      for (int n = threadIdx.x; n < N; n += BLOCK)
        if (feas[n] && v.s_keys_ok[n])
          flags[(int64_t)c * n_seg + v.s_dom[(int64_t)c * N + n]] = 1;
    __syncthreads();
  }
}

// phase 2a: the topologyNormalizingWeight of every constraint, from the
// (summed) scored-row count and domain flags: size = npart for hostname
// keys, else the distinct domains (flags > 0), weight = log(size + 2)
// with libdevice's log. Every thread gets the weights.
template <int BLOCK, class F>
__device__ void block_spread_weights(const GViewD& v, int64_t npart,
                                     const F* flags, int n_seg,
                                     double* weight, BlockScratch<BLOCK>& sh) {
  for (int c = 0; c < v.SC; ++c) {
    int64_t d = 0;
    for (int n = threadIdx.x; n < n_seg; n += BLOCK)
      d += flags[(int64_t)c * n_seg + n] > 0;
    const int64_t distinct = block_sum<BLOCK>(d, sh);
    const int64_t size = v.s_is_host[c] ? npart : distinct;
    weight[c] = log(__dadd_rn((double)size, 2.0));
  }
}

// phase 2b: the raw spread score of every row into raw[n] (f64 terms with
// the rounded intrinsics, summed from constraint 0, rint = jnp.round),
// and the range over the scored rows (*rmin, *rmax; INT32_MAX and 0 when
// none). Ends with a barrier.
template <int BLOCK>
__device__ void block_spread_raw(const GViewD& v, const uint8_t* feas,
                                 const double* weight, int64_t* raw,
                                 int64_t* rmin, int64_t* rmax,
                                 BlockScratch<BLOCK>& sh) {
  const int N = v.N;
  int64_t l = KT_INT32_MAX, h = 0;
  for (int n = threadIdx.x; n < N; n += BLOCK) {
    double tot = 0.0;
    for (int c = 0; c < v.SC; ++c) {
      const int64_t k = (int64_t)c * N + n;
      const double x = (v.s_act[c] && v.s_tv[k] != 0)
          ? __dadd_rn(__dmul_rn((double)v.s_cnt[k], weight[c]),
                      (double)(v.s_skew[c] - 1))
          : 0.0;
      tot = c == 0 ? x : __dadd_rn(tot, x);
    }
    const int64_t r = (int64_t)rint(tot);
    raw[n] = r;
    if (feas[n] && v.s_keys_ok[n]) {
      l = r < l ? r : l;
      h = r > h ? r : h;
    }
  }
  *rmin = block_min<BLOCK>(l, sh);
  *rmax = block_max<BLOCK>(h, sh);
}

// phase 3, for node n: the weighted group score from the raw spread score
// `raw` and the (cluster-wide) ranges
__device__ __forceinline__ int64_t kt_group_score(
    const GViewD& v, const FamC& fam, int n, bool feas, int64_t raw,
    int64_t w_spread, int64_t w_ipa, bool has_s, int64_t rmin, int64_t rmax,
    int64_t lo, int64_t hi) {
  int64_t out = 0;
  if (fam.spr_s) {
    const bool scored = feas && v.s_keys_ok[n];
    int64_t norm = KT_MAX_SCORE;
    if (rmax != 0)
      norm = floordiv(KT_MAX_SCORE * (rmax + rmin - raw),
                      rmax > 1 ? rmax : 1);
    out = w_spread * ((has_s && scored) ? norm : 0);
  }
  if (fam.ipa_score) out += w_ipa * kt_ipa_norm(v.iscore[n], lo, hi);
  return out;
}

__device__ __forceinline__ bool kt_has_s(const GViewD& v) {
  bool has_s = false;
  for (int c = 0; c < v.SC; ++c) has_s = has_s || v.s_act[c];
  return has_s;
}

// ---------------------------------------------------------------------------
// group_update on a node shard. The counter updates read the chosen node's
// topology values; on the mesh the node lives on one shard, so the owner
// writes them into the `own` vector (every other shard writes zeros), the
// exchange sums the vectors (the JAX package's psum'd `pick`,
// kubernetes_tpu/parallel/sharding.py:142-155), and every shard applies
// the increments to its slice. The vector, int64, per row v of the U rows
// (the wanted entries are topology values and eligibility bits):
//   [v · 4·SC + 4·c + {0, 1, 2, 3}]  spr_f_tv, spr_f_elig, spr_s_tv,
//                                    spr_s_elig at the node (c < SC)
//   then [U · TAA] ipa_raa_tv, [U · TA] ipa_ra_tv, [U · CT] ipa_stc_tv,
//   [U · PT] ipa_stp_tv at the node: U · (4·SC + TAA + TA + CT + PT)
//   entries (ops/kernels.py _own_len).

// the owner's half: the values at local row b (b < 0: zeros, a shard
// that does not hold the chosen node). Ends with a barrier.
template <int BLOCK>
__device__ void block_own_write(const GroupsC& g, int b, int64_t* own) {
  const int64_t N = g.N, U = g.U, SC = g.SC, TA = g.TA, TAA = g.TAA;
  const int64_t CT = g.CT, PT = g.PT;
  const int64_t oaa = U * 4 * SC, oa = oaa + U * TAA, oc = oa + U * TA;
  const int64_t op = oc + U * CT, len = op + U * PT;
  for (int64_t e = threadIdx.x; e < len; e += BLOCK) {
    int64_t x = 0;
    if (b >= 0) {
      if (e < oaa) {
        const int64_t v = e / (4 * SC), c = (e % (4 * SC)) / 4,
                      k = e % 4, at = (v * SC + c) * N + b;
        x = k == 0 ? g.spr_f_tv[at] : k == 1 ? g.spr_f_elig[at]
            : k == 2 ? g.spr_s_tv[at] : g.spr_s_elig[at];
      } else if (e < oa) {
        x = g.ipa_raa_tv[(e - oaa) * N + b];
      } else if (e < oc) {
        x = g.ipa_ra_tv[(e - oa) * N + b];
      } else if (e < op) {
        x = g.ipa_stc_tv[(e - oc) * N + b];
      } else {
        x = g.ipa_stp_tv[(e - op) * N + b];
      }
    }
    own[e] = x;
  }
  __syncthreads();
}

// every shard's half: group_update of placing a pod of row u on the node
// whose values are `own` (the summed vector); `b` is the node's local row
// on this shard, -1 elsewhere (the hostname ScheduleAnyway counts are the
// node's own). The gates of each (row, term) pair read only the chosen
// node, so they are the same in every thread and the node loops run only
// where an increment can land; thread n % BLOCK owns node n, so each
// counter element is written by one thread. Ends with a barrier.
template <int BLOCK>
__device__ void block_group_update_own(const GroupsC& g, const GCarryC& c,
                                       const FamC& fam, int64_t u,
                                       const int64_t* own, int b) {
  const int N = g.N;
  const int64_t NN = N, U = g.U, SC = g.SC, TA = g.TA, TAA = g.TAA;
  const int64_t CT = g.CT, PT = g.PT;
  const int64_t oaa = U * 4 * SC, oa = oaa + U * TAA, oc = oa + U * TA;
  const int64_t op = oc + U * CT;
  for (int64_t v = 0; v < U; ++v) {
    if (fam.spr_f) {
      for (int64_t cc = 0; cc < SC; ++cc) {
        const int32_t tvb = (int32_t)own[v * 4 * SC + 4 * cc];
        if (!g.m_spr_f[(u * U + v) * SC + cc]
            || !own[v * 4 * SC + 4 * cc + 1] || tvb == 0)
          continue;
        const int32_t* tv = g.spr_f_tv + (v * SC + cc) * NN;
        int32_t* dst = c.spr_f_cnt + (v * SC + cc) * NN;
        for (int n = threadIdx.x; n < N; n += BLOCK)
          if (tv[n] == tvb) dst[n] += 1;
      }
    }
    if (fam.spr_s) {
      for (int64_t cc = 0; cc < SC; ++cc) {
        if (!g.m_spr_s[(u * U + v) * SC + cc]) continue;
        int32_t* dst = c.spr_s_cnt + (v * SC + cc) * NN;
        if (g.spr_s_is_host[v * SC + cc]) {
          // hostname constraints count the chosen node's own pods
          if (b >= 0 && (int)threadIdx.x == b % BLOCK) dst[b] += 1;
          continue;
        }
        const int32_t tvb = (int32_t)own[v * 4 * SC + 4 * cc + 2];
        if (!own[v * 4 * SC + 4 * cc + 3] || tvb == 0) continue;
        const int32_t* tv = g.spr_s_tv + (v * SC + cc) * NN;
        for (int n = threadIdx.x; n < N; n += BLOCK)
          if (tv[n] == tvb) dst[n] += 1;
      }
    }
    if (fam.ipa_anti) {
      // existing-anti veto: the placed row's own anti terms
      for (int64_t t = 0; t < TAA; ++t) {
        const int32_t tvb = (int32_t)own[oaa + u * TAA + t];
        if (!g.m_ipa_exist[(u * U + v) * TAA + t] || tvb == 0) continue;
        const int32_t* tv = g.ipa_raa_tv + (u * TAA + t) * NN;
        int32_t* dst = c.ipa_veto + v * NN;
        for (int n = threadIdx.x; n < N; n += BLOCK)
          if (tv[n] == tvb) dst[n] += 1;
      }
      // incoming-anti counts, along the consumer's term topology
      for (int64_t t = 0; t < TAA; ++t) {
        const int32_t tvb = (int32_t)own[oaa + v * TAA + t];
        if (!g.m_ipa_aa[(u * U + v) * TAA + t] || tvb == 0) continue;
        const int32_t* tv = g.ipa_raa_tv + (v * TAA + t) * NN;
        int32_t* dst = c.ipa_aa_cnt + (v * TAA + t) * NN;
        for (int n = threadIdx.x; n < N; n += BLOCK)
          if (tv[n] == tvb) dst[n] += 1;
      }
    }
    if (fam.ipa_req && g.m_ipa_a[u * U + v]) {
      int64_t k = 0;
      for (int64_t t = 0; t < TA; ++t) {
        const int32_t tvb = (int32_t)own[oa + v * TA + t];
        if (!g.ipa_ra_active[v * TA + t] || tvb == 0) continue;
        ++k;
        const int32_t* tv = g.ipa_ra_tv + (v * TA + t) * NN;
        int32_t* dst = c.ipa_a_cnt + (v * TA + t) * NN;
        for (int n = threadIdx.x; n < N; n += BLOCK)
          if (tv[n] == tvb) dst[n] += 1;
      }
      if (threadIdx.x == 0) c.ipa_a_total[v] += k;   // int64, replicated
    }
    if (fam.ipa_score) {
      int64_t* dst = c.ipa_score + v * NN;
      // consumer-side preferred terms matching the placed pod
      for (int64_t t = 0; t < CT; ++t) {
        const int64_t w = g.w_stc[(u * U + v) * CT + t];
        const int32_t tvb = (int32_t)own[oc + v * CT + t];
        if (w == 0 || tvb == 0) continue;
        const int32_t* tv = g.ipa_stc_tv + (v * CT + t) * NN;
        for (int n = threadIdx.x; n < N; n += BLOCK)
          if (tv[n] == tvb) dst[n] += w;
      }
      // placed-side terms matching the consumer
      for (int64_t t = 0; t < PT; ++t) {
        const int64_t w = g.w_stp[(u * U + v) * PT + t];
        const int32_t tvb = (int32_t)own[op + u * PT + t];
        if (w == 0 || tvb == 0) continue;
        const int32_t* tv = g.ipa_stp_tv + (u * PT + t) * NN;
        for (int n = threadIdx.x; n < N; n += BLOCK)
          if (tv[n] == tvb) dst[n] += w;
      }
    }
  }
  __syncthreads();
}
