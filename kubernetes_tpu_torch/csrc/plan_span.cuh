// The plan program's span — Phase A and the exact serial replay of
// kubernetes_tpu/ops/program.py _run_wave_scan_impl (:1259-1560) — written
// once for a team of CTAs that splits the node axis, shared by
// run_plan.cu (one device: a thread-block cluster, ClusterTeam) and
// run_plan_sharded.cu (a mesh's shards on one card: one cooperative grid,
// GridTeam). run_batch.cu's cluster reuses the team, its reductions, the
// packed key, the listed group increments (plan_gate, plan_sweep) and the
// ports placement. The node axis may be cut into D equal shards, each with its
// own arrays (PlanNodesC); every CTA owns a contiguous range of one
// shard's rows, one row a thread where the team is wide enough.
//
// Every cross-row value of an evaluation is an integer max, min or sum,
// so any partition of the rows gives the same bits: the spread minima, the
// normalization maxima with the score partials (npart, the inter-pod
// range), the distinct spread domains, the raw spread range, and the
// first max as one packed key ((score + 1) << 32) | (INT32_MAX − global
// index), whose largest value is the lowest index among the maxima. The
// float64 Balanced term and the spread weights' log stay per row or per
// constraint, computed from the same integers in every CTA.
//
// A team reduction: warp shuffles, the block's part in warp 0, the part
// written to the CTA's slot (shared memory for a cluster, a global
// [2, blocks, KT_RED_K] buffer for a grid), one team barrier, then warp 0
// folds every slot into shared memory for its block (every warp reading
// every slot was slower: PERF.md §6, row 7). The slots alternate between
// two halves by reduction, so a CTA that runs ahead writes the other half
// while a slow CTA still reads this one: it cannot reach the half again
// without passing the next barrier, which the slow CTA joins only after
// reading.
//
// The spread domain flags ([SC, n_global] int32, a domain's id is the
// first global row with its value) are the one array a CTA writes outside
// its rows. Each evaluation tags them with its own epoch (1, 2, ...), so
// no pass zeroes them: a CTA sets flags[c, dom] = epoch for its scored
// rows before the partials' barrier, and after it counts the entries of
// its own rows equal to the epoch. A CTA sets the next epoch only after
// the barrier that follows every count.
//
// The group counters live in the output carry (a fresh copy), updated in
// place at every placement as the JAX package's group_update — the same
// integer adds as run_plan's slot counters folded by wave_fold, so the
// same counts. Which (row, term) pairs increment is decided once, a
// thread a pair, from the chosen node's topology values, which every CTA
// reads from the owning shard's static arrays (all shards lie on one
// card); then each CTA sweeps its own rows once over the listed pairs, so
// each counter element keeps one writer: the thread that owns its row.
// The per-slot a_total every CTA keeps in shared memory. On the CTA that
// owns the chosen row one warp writes its used / nonzero / pods row,
// another its ports, and three threads a slot refresh the slots' fit
// surfaces there (the fit, LeastAllocated and Balanced side by side).
//
// Between two evaluations the critical path is that refresh and the first
// reduction's barrier; the loop state stays in global memory (L2), one
// row a thread, and the evaluation's feasible set and raw spread scores
// in each CTA's shared memory.
#pragma once

#include <cooperative_groups.h>

#include "group_eval.cuh"

namespace cg = cooperative_groups;

// a CTA's rows' evaluation scratch, `span` rows: the raw spread scores
// (int64), then the feasible set (uint8) — plan_dyn_bytes(span)
extern __shared__ __align__(16) unsigned char kt_plan_dyn[];

#define KT_PLAN_MAX_S 32
#define KT_PLAN_BLOCK 512    // threads a CTA of the plan span's team
#define KT_RED_K 16          // values one team reduction carries
#define KT_INC_CAP 128       // group increments decided a round

// one listed group increment (plan_gate)
struct PlanInc {
  const int32_t* tv;      // the term's topology values on this shard
  void* dst;              // the counter row: int32, or int64 when wide
  int64_t add;
  int32_t tvb;            // the chosen node's value (never 0)
  int32_t wide;
};

// what every node shard of the span shares, mirrored field for field by
// ctypes (ops/kernels.py PlanSpanC)
struct PlanSpanC {
  TableC tb;
  CfgC cfg;
  FamC fam;
  const uint8_t* valid;   // [W]
  const int32_t* widx;    // [W] slot of each pod
  int32_t wt[KT_PLAN_MAX_S];
  int32_t S, W, P, norm_live, has_groups, has_ports;
  int64_t w_spread, w_ipa;
  int32_t n_global, n_local, D;
  int32_t* flags;         // [SC, n_global] epoch-tagged domain flags
  int64_t* part;          // [2, blocks, KT_RED_K] a grid team's slots
  int32_t* packed;        // [W + 2]: assignments, n_conf, prefix
};

// one node shard's arrays (ops/kernels.py PlanNodesC); on one device the
// shard is the whole axis
struct PlanNodesC {
  NodeC na;
  GroupsC g;
  GCarryC gc;             // the output group carry, updated in place
  int64_t* used;          // [N, R] fresh copies: the loop state
  int64_t* nonzero_used;  // [N, 2]
  int32_t* npods;         // [N]
  int32_t* ports;         // [N, P] fresh copy (has_ports only)
  const uint8_t* m0;      // the stacked wave_statics, [S, N] each
  const int64_t* taint_raw;
  const int64_t* na_raw;
  const int64_t* s_img;
  uint8_t* fit_ok;        // [S, N] the slots' fit surfaces
  int64_t* s_fit;         // [S, N]
  int64_t* s_bal;         // [S, N]
  int32_t offset;         // global index of the shard's row 0
};

template <int BLOCK>
struct PlanShared {
  static_assert(BLOCK >= KT_INC_CAP + 64 + 3 * KT_PLAN_MAX_S,
                "the gate, carry-row, ports and refresh threads overlap");
  int64_t w[BLOCK / 32][KT_RED_K];    // the warps' parts of a reduction
  int64_t slot[2][KT_RED_K];          // a cluster team's partial slots
  int64_t res[KT_RED_K];              // a reduction's folded values
  int64_t a_total[KT_PLAN_MAX_S];     // each slot's ipa_a_total
  int32_t spec[KT_PLAN_MAX_S];        // the speculative choices (lead)
  int32_t clean, n_conf, prefix;      // the conflict stats (lead)
  int32_t n_inc;                      // listed increments of a placement
  PlanInc inc[KT_INC_CAP];
};

// a grid slot's values, each read past L1 (another block wrote them)
struct GlobalSlot {
  const int64_t* p;
  __device__ int64_t operator[](int k) const {
    return __ldcg((const long long*)(p + k));
  }
};

// bit k of `sums`: value k sums, else it maxes (a minimum rides negated)
__device__ __forceinline__ int64_t kt_red(int64_t a, int64_t b, bool sum) {
  return sum ? a + b : (b > a ? b : a);
}

__device__ __forceinline__ int64_t kt_red_id(bool sum) {
  return sum ? 0 : KT_I64_MIN;
}

__device__ __forceinline__ int64_t kt_warp_red(int64_t x, bool sum) {
  for (int o = 16; o > 0; o >>= 1)
    x = kt_red(x, __shfl_xor_sync(0xffffffffu, x, o), sum);
  return x;
}

// the block's part of a team reduction of v[0..n): warp 0 writes the n
// folded values to out
template <int BLOCK, int K>
__device__ void kt_block_part(const int64_t (&v)[K], int n, uint32_t sums,
                              PlanShared<BLOCK>& sh, int64_t* out) {
  const int lane = threadIdx.x & 31, wp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (k >= n) break;
    const int64_t x = kt_warp_red(v[k], (sums >> k) & 1);
    if (lane == 0) sh.w[wp][k] = x;
  }
  __syncthreads();
  if (wp == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (k >= n) break;
      const bool s = (sums >> k) & 1;
      const int64_t x = kt_warp_red(
          lane < BLOCK / 32 ? sh.w[lane][k] : kt_red_id(s), s);
      if (lane == 0) out[k] = x;
    }
  }
}

// the team's fold: warp 0 folds the n values of `parts` slots (part(b)
// returns slot b's values) into sh.res, one barrier, every thread reads
template <int BLOCK, int K, class Part>
__device__ void kt_team_fold(int64_t (&v)[K], int n, uint32_t sums,
                             int parts, Part part, PlanShared<BLOCK>& sh) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (k >= n) break;
      const bool s = (sums >> k) & 1;
      int64_t x = kt_red_id(s);
      for (int b = lane; b < parts; b += 32) x = kt_red(x, part(b)[k], s);
      x = kt_warp_red(x, s);
      if (lane == 0) sh.res[k] = x;
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (k < n) v[k] = sh.res[k];
}

// one device: the C CTAs of a thread-block cluster, their partial slots in
// shared memory read through distributed shared memory
template <int BLOCK>
struct ClusterTeam {
  int par = 0;
  __device__ void sync() { cg::this_cluster().sync(); }
  // a CTA may not exit while another can still read its slots
  __device__ void finish() { sync(); }
  template <int K>
  __device__ void reduce(int64_t (&v)[K], int n, uint32_t sums,
                         PlanShared<BLOCK>& sh) {
    cg::cluster_group cl = cg::this_cluster();
    int64_t* mine = sh.slot[par];
    kt_block_part<BLOCK, K>(v, n, sums, sh, mine);
    cl.sync();
    kt_team_fold<BLOCK, K>(v, n, sums, (int)cl.num_blocks(),
                           [&](int b) { return cl.map_shared_rank(mine, b); },
                           sh);
    par ^= 1;
  }
};

// a mesh's shards on one card: every block of one cooperative grid, their
// partial slots in global memory (read past L1)
template <int BLOCK>
struct GridTeam {
  int64_t* part;
  int par = 0;
  __device__ void sync() { cg::this_grid().sync(); }
  __device__ void finish() {}
  template <int K>
  __device__ void reduce(int64_t (&v)[K], int n, uint32_t sums,
                         PlanShared<BLOCK>& sh) {
    int64_t* half = part + (int64_t)par * gridDim.x * KT_RED_K;
    kt_block_part<BLOCK, K>(v, n, sums, sh, half + blockIdx.x * KT_RED_K);
    cg::this_grid().sync();
    kt_team_fold<BLOCK, K>(v, n, sums, (int)gridDim.x, [&](int b) {
      return GlobalSlot{half + b * KT_RED_K};
    }, sh);
    par ^= 1;
  }
};

// _apply_assignment's ports (:906): the pod's port ids into the first
// free slots of the chosen row, by one warp (`lane` its lane); a pod
// without ports leaves the row as it is
__device__ __forceinline__ void kt_warp_place_ports(int32_t* row, int P,
                                                    const PodRowD& p, int PP,
                                                    int lane) {
  bool any_port = false;
  for (int q = 0; q < PP; ++q) any_port = any_port || p.port_ids[q];
  if (!any_port) return;
  int rank0 = 0;
  for (int s0 = 0; s0 < P; s0 += 32) {
    const int slot = s0 + lane;
    const bool free = slot < P && row[slot] == 0;
    const unsigned m = __ballot_sync(0xffffffffu, free);
    const int rank = rank0 + __popc(m & ((1u << lane) - 1u));
    if (free && rank < PP) row[slot] = p.port_ids[rank];
    rank0 += __popc(m);
  }
}

// decode a packed key: (score, global index)
__device__ __forceinline__ void kt_plan_unkey(int64_t k, int64_t* score,
                                              int32_t* best) {
  *score = (k >> 32) - 1;
  *best = 0x7fffffff - (int32_t)(k & 0xffffffffLL);
}

// _eval (:1384-1430) of slot w over the team's rows [lo, hi) of shard a:
// the packed key of the first max of where(feasible, total, -1) over
// every shard. `epoch` tags this evaluation's domain flags.
template <int BLOCK, class Team>
__device__ int64_t plan_eval(const PlanSpanC& cm, const PlanNodesC& a, int w,
                             int lo, int hi, int32_t epoch, Team& tm,
                             PlanShared<BLOCK>& sh, uint8_t* feas,
                             int64_t* gsc) {
  __syncthreads();
  const int N = a.na.N;
  const int64_t NN = N, NG = cm.n_global;
  const PodRowD p = pod_row(cm.tb, cm.wt[w]);
  const FamC& fam = cm.fam;
  const bool groups = cm.has_groups != 0;
  const bool gs = groups && (fam.spr_s || fam.ipa_score);
  const bool spread_s = groups && fam.spr_s;
  if (threadIdx.x == 0) sh.n_inc = 0;   // the next placement's list
  GViewD v;
  int32_t minv[KT_MAX_SC];
  if (groups) {
    v = view_of(a.g, a.gc, cm.wt[w]);
    v.a_total = sh.a_total[w];
    if (fam.spr_f) {
      // the DoNotSchedule minima, negated for the max
      int64_t m[KT_MAX_SC];
#pragma unroll
      for (int c = 0; c < KT_MAX_SC; ++c) {
        int64_t x = KT_INT32_MAX;
        if (c < v.SC)
          for (int n = lo + threadIdx.x; n < hi; n += BLOCK) {
            const int64_t k = (int64_t)c * N + n;
            if (v.f_elig[k] && v.f_cnt[k] < x) x = v.f_cnt[k];
          }
        m[c] = -x;
      }
      tm.reduce(m, v.SC, 0u, sh);
      for (int c = 0; c < v.SC; ++c)
        minv[c] = v.f_minz[c] ? 0 : (int32_t)(-m[c]);
    }
  }
  const uint8_t* m0 = a.m0 + w * NN;
  const uint8_t* fit = a.fit_ok + w * NN;
  const int64_t* traw = a.taint_raw + w * NN;
  const int64_t* nraw = a.na_raw + w * NN;
  int64_t tmx = 0, nmx = 0, l = KT_I64_MAX, h = -KT_I64_MAX, np = 0;
  for (int n = lo + threadIdx.x; n < hi; n += BLOCK) {
    bool f = m0[n] && fit[n];
    if (f && cm.has_ports)
      f = kt_ports_ok(a.ports + (int64_t)n * cm.P, cm.P, p.port_ids,
                      cm.tb.PP);
    if (f && groups) f = kt_group_mask(v, fam, n, minv);
    feas[n - lo] = f;
    if (!f) continue;
    tmx = traw[n] > tmx ? traw[n] : tmx;
    nmx = nraw[n] > nmx ? nraw[n] : nmx;
    if (groups && fam.ipa_score) {
      const int64_t s = v.iscore[n];
      l = s < l ? s : l;
      h = s > h ? s : h;
    }
    if (spread_s && v.s_keys_ok[n]) {
      ++np;
      for (int c = 0; c < v.SC; ++c)
        cm.flags[c * NG + v.s_dom[(int64_t)c * N + n]] = epoch;
    }
  }
  // the normalization maxima and the group score partials, fused
  int64_t tmax = 0, namax = 0, lo_s = 0, hi_s = 0, npart = 0;
  if (cm.norm_live || gs) {
    int64_t r[5] = {tmx, nmx, -l, h, np};
    tm.reduce(r, 5, 1u << 4, sh);
    tmax = r[0];
    namax = r[1];
    lo_s = -r[2];
    hi_s = r[3];
    npart = r[4];
  }
  int64_t rmin = 0, rmax = 0;
  bool has_s = false;
  if (spread_s) {
    has_s = kt_has_s(v);
    // distinct scored domains: the flags of this epoch on the team's rows
    int64_t dct[KT_MAX_SC];
#pragma unroll
    for (int c = 0; c < KT_MAX_SC; ++c) {
      int64_t x = 0;
      if (c < v.SC)
        for (int n = lo + threadIdx.x; n < hi; n += BLOCK)
          x += __ldcg(cm.flags + c * NG + a.offset + n) == epoch;
      dct[c] = x;
    }
    tm.reduce(dct, v.SC, 0xffu, sh);
    double weight[KT_MAX_SC];
    for (int c = 0; c < v.SC; ++c) {
      const int64_t size = v.s_is_host[c] ? npart : dct[c];
      weight[c] = log(__dadd_rn((double)size, 2.0));
    }
    // the raw spread scores (block_spread_raw) and their range
    int64_t rl = KT_INT32_MAX, rh = 0;
    for (int n = lo + threadIdx.x; n < hi; n += BLOCK) {
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
  // the totals and the first max
  const CfgC& cfg = cm.cfg;
  const int64_t* sfit = a.s_fit + w * NN;
  const int64_t* sbal = a.s_bal + w * NN;
  const int64_t* simg = a.s_img + w * NN;
  int64_t key = KT_I64_MIN;
  for (int n = lo + threadIdx.x; n < hi; n += BLOCK) {
    int64_t val = -1;
    if (feas[n - lo]) {
      const int64_t tn = cm.norm_live
          ? cfg.w_taint * kt_normalize(traw[n], tmax, true)
            + cfg.w_node_affinity * kt_normalize(nraw[n], namax, false)
          : cfg.w_taint * KT_MAX_SCORE;
      val = cfg.w_fit * sfit[n] + cfg.w_balanced * sbal[n] + tn
            + cfg.w_image * simg[n];
      if (gs)
        val += kt_group_score(v, fam, n, true, spread_s ? gsc[n - lo] : 0,
                              cm.w_spread, cm.w_ipa, has_s, rmin, rmax,
                              lo_s, hi_s);
    }
    const int64_t k = ((val + 1) << 32)
                      | (int64_t)(0x7fffffff - (a.offset + n));
    key = k > key ? k : key;
  }
  int64_t kk[1] = {key};
  tm.reduce(kk, 1, 0u, sh);
  return kk[0];
}

// group_update (:1468-1517) of placing a pod of row u on local row lb of
// shard `go`, as its (consumer row v, term) pairs — candidates j in the
// order spr_f [U, SC], spr_s [U, SC], the existing-anti veto [U, TAA],
// the incoming-anti counts [U, TAA], the required-affinity counts
// [U, TA], the preferred terms [U, CT] and [U, PT] of the active
// families. The gates read only the chosen node, so one thread decides a
// pair and lists it (PlanInc) when it increments; then every thread
// sweeps its own rows over the list once.

__device__ __forceinline__ int plan_candidates(const GroupsC& g,
                                               const FamC& fam) {
  return g.U * ((fam.spr_f ? g.SC : 0) + (fam.spr_s ? g.SC : 0)
                + (fam.ipa_anti ? 2 * g.TAA : 0) + (fam.ipa_req ? g.TA : 0)
                + (fam.ipa_score ? g.CT + g.PT : 0));
}

// candidate j's gate over the groups `g` / counters `c` of this shard
// (the chosen node on shard `go`, local row lb); an increment goes to the
// list, a hostname count straight to the chosen row (this CTA owns it:
// `owner`), and a required-affinity term of consumer row v to
// `on_a_total(v)` (one more active term whose key the node carries)
template <int BLOCK, class OnATotal>
__device__ void plan_gate(const FamC& fam, const GroupsC& g,
                          const GCarryC& c, const GroupsC& go, bool owner,
                          int lb, int64_t u, int64_t j,
                          PlanShared<BLOCK>& sh, OnATotal on_a_total) {
  const int64_t NN = g.N, NO = go.N, U = g.U, SC = g.SC, TA = g.TA;
  const int64_t TAA = g.TAA, CT = g.CT, PT = g.PT;
  PlanInc q{nullptr, nullptr, 1, 0, 0};
  do {
    if (fam.spr_f) {
      if (j < U * SC) {
        const int64_t vc = j, v = vc / SC, at = vc * NO + lb;
        q.tvb = go.spr_f_tv[at];
        if (g.m_spr_f[(u * U + v) * SC + vc % SC] && go.spr_f_elig[at]
            && q.tvb != 0) {
          q.tv = g.spr_f_tv + vc * NN;
          q.dst = c.spr_f_cnt + vc * NN;
        }
        break;
      }
      j -= U * SC;
    }
    if (fam.spr_s) {
      if (j < U * SC) {
        const int64_t vc = j, v = vc / SC, at = vc * NO + lb;
        if (!g.m_spr_s[(u * U + v) * SC + vc % SC]) break;
        if (g.spr_s_is_host[vc]) {
          // hostname constraints count the chosen node's own pods
          if (owner) atomicAdd(c.spr_s_cnt + vc * NN + lb, 1);
          break;
        }
        q.tvb = go.spr_s_tv[at];
        if (go.spr_s_elig[at] && q.tvb != 0) {
          q.tv = g.spr_s_tv + vc * NN;
          q.dst = c.spr_s_cnt + vc * NN;
        }
        break;
      }
      j -= U * SC;
    }
    if (fam.ipa_anti) {
      if (j < 2 * U * TAA) {
        const bool veto = j < U * TAA;
        const int64_t k = veto ? j : j - U * TAA, v = k / TAA, t = k % TAA;
        // the existing-anti veto reads the placed row's own terms, the
        // incoming-anti counts the consumer's
        const int64_t row = (veto ? u : v) * TAA + t;
        q.tvb = go.ipa_raa_tv[row * NO + lb];
        const bool m = veto ? g.m_ipa_exist[(u * U + v) * TAA + t]
                            : g.m_ipa_aa[(u * U + v) * TAA + t];
        if (m && q.tvb != 0) {
          q.tv = g.ipa_raa_tv + row * NN;
          q.dst = veto ? c.ipa_veto + v * NN : c.ipa_aa_cnt + k * NN;
        }
        break;
      }
      j -= 2 * U * TAA;
    }
    if (fam.ipa_req) {
      if (j < U * TA) {
        const int64_t v = j / TA;
        q.tvb = go.ipa_ra_tv[j * NO + lb];
        if (g.m_ipa_a[u * U + v] && g.ipa_ra_active[j] && q.tvb != 0) {
          q.tv = g.ipa_ra_tv + j * NN;
          q.dst = c.ipa_a_cnt + j * NN;
          on_a_total(v);
        }
        break;
      }
      j -= U * TA;
    }
    if (fam.ipa_score) {
      const bool stc = j < U * CT;
      const int64_t k = stc ? j : j - U * CT;
      const int64_t T = stc ? CT : PT, v = k / T, t = k % T;
      // consumer-side preferred terms matching the placed pod, then the
      // placed side's terms matching the consumer
      const int64_t row = stc ? v * CT + t : u * PT + t;
      q.add = stc ? g.w_stc[(u * U + v) * CT + t]
                  : g.w_stp[(u * U + v) * PT + t];
      q.tvb = (stc ? go.ipa_stc_tv : go.ipa_stp_tv)[row * NO + lb];
      if (q.add != 0 && q.tvb != 0) {
        q.tv = (stc ? g.ipa_stc_tv : g.ipa_stp_tv) + row * NN;
        q.dst = c.ipa_score + v * NN;
        q.wide = 1;
      }
    }
  } while (false);
  if (q.dst != nullptr) sh.inc[atomicAdd(&sh.n_inc, 1)] = q;
}

// every listed increment on the team's rows: the topology values of a
// chunk loaded before any add, the adds fire-and-forget (one writer an
// element: the thread that owns its row)
template <int BLOCK>
__device__ void plan_sweep(int lo, int hi, int ne, PlanShared<BLOCK>& sh) {
  for (int n = lo + threadIdx.x; n < hi; n += BLOCK)
    for (int e0 = 0; e0 < ne; e0 += 8) {
      int32_t x[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        x[j] = e0 + j < ne ? sh.inc[e0 + j].tv[n] : 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (e0 + j >= ne) break;
        const PlanInc& q = sh.inc[e0 + j];
        if (x[j] != q.tvb) continue;
        if (q.wide)
          atomicAdd((unsigned long long*)q.dst + n,
                    (unsigned long long)q.add);
        else
          atomicAdd((int*)q.dst + n, (int)q.add);
      }
    }
}

// one of the three fit surfaces (_row_refresh) of slot s at the touched
// row n, from its updated carry row: part 0 the fit (kt_fit), 1
// LeastAllocated, 2 Balanced (kt_fit_scores). Three threads a slot run
// the three chains side by side (the owner's refresh is the critical path
// between two evaluations); every load of a chunk is issued before its
// arithmetic.
__device__ __forceinline__ void plan_refresh(const PlanSpanC& cm,
                                             const PlanNodesC& a, int n,
                                             int s, int part) {
  const NodeC& na = a.na;
  const CfgC& cfg = cm.cfg;
  const int R = na.R;
  const int64_t at = s * (int64_t)na.N + n;
  const PodRowD ps = pod_row(cm.tb, cm.wt[s]);
  const int64_t* used = a.used + (int64_t)n * R;
  const int64_t* cap = na.cap + (int64_t)n * R;
  if (part == 0) {
    bool ok = (int64_t)a.npods[n] + 1 <= (int64_t)na.allowed_pods[n];
    for (int r0 = 0; r0 < R; r0 += 8) {
      int64_t q[8], u[8], c[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const bool in = r0 + j < R;
        q[j] = in ? ps.req[r0 + j] : 0;
        u[j] = in ? used[r0 + j] : 0;
        c[j] = in ? cap[r0 + j] : 0;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) ok &= (q[j] == 0) | (u[j] + q[j] <= c[j]);
    }
    a.fit_ok[at] = ok;
    return;
  }
  if (part == 2 && ps.skip_balanced) {
    a.s_bal[at] = 0;
    return;
  }
  int64_t capc[KT_MAX_C], usedc[KT_MAX_C], plain[KT_MAX_C];
#pragma unroll
  for (int c = 0; c < KT_MAX_C; ++c) {
    if (c >= cfg.C) break;
    const int col = cfg.score_cols[c];
    capc[c] = cap[col];
    plain[c] = used[col] + ps.req[col];
    const int sl = cfg.nonzero_slot[c];
    usedc[c] = cfg.col_nonzero[c]
        ? a.nonzero_used[(int64_t)n * 2 + sl] + ps.nonzero_req[sl]
        : plain[c];
  }
  if (part == 1)
    a.s_fit[at] = kt_least_allocated(cfg, capc, usedc);
  else
    a.s_bal[at] = kt_balanced(cfg.C, capc, plain);
}

// a CTA's dynamic shared memory for `span` rows
__host__ __device__ inline int plan_dyn_bytes(int span) {
  return (9 * span + 15) / 16 * 16;
}

// the whole span on the team's rows [lo, hi) of shard d of `all` (at most
// `span` rows a CTA).
// `shard_lead`: this CTA writes the shard's replicated scalars; `lead`:
// this CTA writes `packed`.
template <int BLOCK, class Team>
__device__ void plan_span(const PlanSpanC& cm, const PlanNodesC* all, int d,
                          int lo, int hi, int span, bool shard_lead,
                          bool lead, Team& tm, PlanShared<BLOCK>& sh) {
  const PlanNodesC& a = all[d];
  const int N = a.na.N, R = a.na.R, S = cm.S;
  const int64_t NN = N, NG = cm.n_global;
  const CfgC& cfg = cm.cfg;
  const bool groups = cm.has_groups != 0;
  int64_t* gsc = (int64_t*)kt_plan_dyn;
  uint8_t* feas = kt_plan_dyn + 8 * (int64_t)span;

  // ---- Phase A (:1334-1454): the slots' fit surfaces at the input carry
  const int rows = hi - lo;
  if (rows > 0)
    for (int64_t e = threadIdx.x; e < (int64_t)S * rows; e += BLOCK) {
      const int s = (int)(e / rows), n = lo + (int)(e % rows);
      const PodRowD p = pod_row(cm.tb, cm.wt[s]);
      const int64_t* used_row = a.used + (int64_t)n * R;
      int64_t s_fit, s_bal;
      kt_fit_scores(cfg, a.na, n, used_row, a.nonzero_used + (int64_t)n * 2,
                    p, &s_fit, &s_bal);
      a.fit_ok[s * NN + n] = kt_fit(a.na, n, used_row, a.npods[n], p);
      a.s_fit[s * NN + n] = s_fit;
      a.s_bal[s * NN + n] = s_bal;
    }
  if (groups && cm.fam.spr_s)
    for (int c = 0; c < a.g.SC; ++c)
      for (int n = lo + threadIdx.x; n < hi; n += BLOCK)
        cm.flags[c * NG + a.offset + n] = 0;
  if ((int)threadIdx.x < S)
    sh.a_total[threadIdx.x] =
        groups ? a.gc.ipa_a_total[cm.wt[threadIdx.x]] : 0;
  if (lead && threadIdx.x == 0) {
    sh.clean = 1;
    sh.n_conf = 0;
    sh.prefix = 0;
  }
  tm.sync();   // every flag zeroed before any is set
  int32_t epoch = 1;
  int64_t score;
  int32_t best;
  // the speculative choice of every slot
  for (int s = 0; s < S; ++s) {
    kt_plan_unkey(plan_eval<BLOCK>(cm, a, s, lo, hi, epoch++, tm, sh, feas, gsc),
                  &score, &best);
    if (lead && threadIdx.x == 0) sh.spec[s] = score >= 0 ? best : -1;
  }

  // ---- Phase B (:1456-1552): the exact serial replay
  for (int k = 0; k < cm.W; ++k) {
    const int w = cm.widx[k];
    const bool vld = cm.valid[k] != 0;
    kt_plan_unkey(plan_eval<BLOCK>(cm, a, w, lo, hi, epoch++, tm, sh, feas, gsc),
                  &score, &best);
    const bool assigned = score >= 0 && vld;
    if (assigned) {
      const int d_own = best / cm.n_local, lb = best - d_own * cm.n_local;
      const bool owner = d_own == d && lb >= lo && lb < hi;
      const int t = threadIdx.x, wp = t >> 5, lane = t & 31;
      const int ncand = groups ? plan_candidates(a.g, cm.fam) : 0;
      // threads [0, KT_INC_CAP) decide the group increments; on the CTA
      // that owns the chosen row, the next warp writes its carry row, the
      // one after its ports, and after the barrier the last three warps
      // refresh the slots' fit surfaces there (a warp a surface) while the
      // rest sweep
      for (int base = 0;; base += KT_INC_CAP) {
        if (t < KT_INC_CAP && base + t < ncand)
          plan_gate<BLOCK>(cm.fam, a.g, a.gc, all[d_own].g, owner, lb,
                           cm.wt[w], base + t, sh, [&](int64_t v) {
            // the slots' a_total, and the shard's (`shard_lead`)
            for (int s = 0; s < cm.S; ++s)
              if (cm.wt[s] == v)
                atomicAdd((unsigned long long*)&sh.a_total[s], 1ull);
            if (shard_lead)
              atomicAdd((unsigned long long*)(a.gc.ipa_a_total + v), 1ull);
          });
        if (base == 0 && owner && wp == KT_INC_CAP / 32) {
          const PodRowD p = pod_row(cm.tb, cm.wt[w]);
          for (int r = lane; r < R + 3; r += 32) {
            if (r < R)
              a.used[(int64_t)lb * R + r] += p.req[r];
            else if (r < R + 2)
              a.nonzero_used[(int64_t)lb * 2 + r - R] +=
                  p.nonzero_req[r - R];
            else
              a.npods[lb] += 1;
          }
        }
        if (base == 0 && owner && wp == KT_INC_CAP / 32 + 1
            && cm.has_ports)
          kt_warp_place_ports(a.ports + (int64_t)lb * cm.P, cm.P,
                              pod_row(cm.tb, cm.wt[w]), cm.tb.PP, lane);
        __syncthreads();
        if (base == 0 && owner && t >= BLOCK - 3 * KT_PLAN_MAX_S
            && (BLOCK - 1 - t) % KT_PLAN_MAX_S < S)
          plan_refresh(cm, a, lb, (BLOCK - 1 - t) % KT_PLAN_MAX_S,
                       (BLOCK - 1 - t) / KT_PLAN_MAX_S);
        plan_sweep<BLOCK>(lo, hi, sh.n_inc, sh);
        if (base + KT_INC_CAP >= ncand) break;
        __syncthreads();
        if (t == 0) sh.n_inc = 0;
        __syncthreads();
      }
    }
    if (lead && threadIdx.x == 0) {
      const int32_t y = assigned ? best : -1;
      const bool conflict = vld && y != sh.spec[w];
      sh.prefix += sh.clean && vld && !conflict;
      sh.clean = sh.clean && !conflict;
      sh.n_conf += conflict;
      cm.packed[k] = y;
    }
  }
  if (lead && threadIdx.x == 0) {
    cm.packed[cm.W] = sh.n_conf;
    cm.packed[cm.W + 1] = sh.prefix;
  }
  tm.finish();
}
