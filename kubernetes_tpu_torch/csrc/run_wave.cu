// run_wave: speculative wave placement of a same-signature run of group
// pods (PodTopologySpread / InterPodAffinity), merge tier + serial tier.
//
// Replaces kubernetes_tpu/ops/program.py run_wave (:2041; the jit
// _run_wave_same_fn :2034 over _run_wave_same_impl :1703, its loop state
// _SameWaveState :1684), with wave_fold (ops/groups.py :1215) for the one
// wave row.
//
// Merge tier, per wave (JAX merge_body :1828-2000):
//   1. evaluate the row over N (fit, Balanced f64, the hoisted statics,
//      the group mask and scores);
//   2. the exactness preconditions: a flat inter-pod score surface over
//      the feasible set, no keyed node skew-masked at wave start (the
//      monotonicity of the [K, J] matrix is checked in step 5);
//   3. the top-K candidates, ties to the lowest node index (the index
//      rides in the key);
//   4. with a self-matching anti term: the champion per anti domain, a
//      segment max of score·N − idx (atomicMax on int64);
//   5. the [K, J] post-placement matrix (lean_eval.cuh kt_uniform_entry,
//      run_uniform's entry code) and its flat keys (score desc, node asc,
//      j asc);
//   6. the top-Lw merge, in the sorted order;
//   7. the spread skew replayed at domain level: rank-in-domain over the
//      Lw prefix, the level table d_need [SC, 32], the level climb with
//      M_CAP = 32;
//   8. the depth / keyless cut and the conflict-free prefix;
//   9. the accepted deltas folded into the loop state (counts, resources,
//      the own-row spread and anti counters via domain shares).
// Serial tier (JAX serial_body :2003-2028): the exact per-pod rule for
// what the merge tier left, one pod per step; a pod that fits nowhere
// leaves the state unchanged, so the rest of the run fails with it and
// the step count is settled at once. Then wave_fold of the per-node
// placement counts into every consumer row of the group carry.
//
// What bounds it on an H100: a chain of dependent steps — waves, and
// inside each wave eval → select → matrix → select → replay → fold — over
// at most a few MB of L2-resident state; latency (barriers and the
// dependent chain), not bytes or operations.
//
// Design: ONE launch a call of a thread-block cluster of KT_WAVE_CLUSTER
// CTAs × KT_PLAN_BLOCK threads (cudaLaunchKernelEx with the cluster
// dimension), so the merge loop's condition (ok & progress & done < W) is
// read on the device and no wave costs a host round trip. Each CTA owns a
// contiguous range of ⌈N / C⌉ rows, one row a thread at N = 8,192, and
// runs every pass over the node axis on its rows: the evaluation, the
// start check, the champion segment max, elig_dom and d_need, the fold
// and the domain shares. Every cross-row value is a team reduction on
// plan_span.cuh's ClusterTeam (integer max or sum, so any partition gives
// the same bits).
//   - The two top-k's are selections of unique keys (the node index, and
//     node · J + j, ride in them), so a radix select of exactly K (Lw)
//     keys gives the set a sort gives: 8-bit digits from the highest bit
//     where the keys differ, each pass a 256-bin histogram in every CTA's
//     shared memory summed over the cluster through distributed shared
//     memory, ending at the first digit whose bin holds exactly the keys
//     still wanted. The top-K is only a set (the matrix keys order it);
//     each CTA expands its own candidates. The top-Lw keys go to the
//     leader CTA's shared memory and only they are sorted there.
//   - The spread replay runs in the leader CTA's shared memory in
//     O(Lw · SC): newcnt = f_cnt + rank + 1 and the level climb's
//     cum_excl are both prefix counts over the ordered entries (of a
//     domain, of a level), taken by one warp walking the entries 32 at a
//     time (__match_any_sync within a chunk, a shared table of running
//     counts across chunks: domains hashed into it, levels indexed).
//   - The serial tier's argmax is the team's max of the packed key
//     ((score + 1) << 32) | (INT32_MAX − index), ties to the lowest index.
//   - The final wave_fold is the team's: each domain share one cluster
//     barrier, three rotating segment buffers.
// The wrapper hands the kernel fresh copies of the carry fields it writes
// and one carved scratch allocation.

#include "plan_span.cuh"
#include "sort.cuh"

#define KT_WAVE_CLUSTER 16
#define KT_WAVE_MAX_L 1024   // K and Lw: keys the leader holds
#define KT_WAVE_HASH 2048    // the replay's domain table, 2 · KT_WAVE_MAX_L

// the kernel's arguments, mirrored field for field by ctypes
// (ops/kernels.py WaveArgsC)
struct WaveArgs {
  NodeC na;
  TableC tb;
  CfgC cfg;
  GroupsC g;
  GCarryC gin;            // input group carry (read)
  GCarryC gout;           // fresh copy of gin: wave_fold writes it
  FamC fam;
  int64_t* used;          // [N, R] fresh copies: the loop state
  int64_t* nonzero_used;  // [N, 2]
  int32_t* npods;         // [N]
  const uint8_t* m0;      // wave_statics of the row, [N] each
  const int64_t* taint_raw;
  const int64_t* na_raw;
  const int64_t* s_img;
  const uint8_t* valid;   // [B] prefix mask
  int32_t wt, B, K, J, Lw, norm_live, anti_term, merge_on;
  int64_t w_spread, w_ipa;
  // scratch, one carved allocation (ops/kernels.py wave_parts)
  int32_t* f_cnt;         // [SC, N] own-row spread filter counts
  int32_t* veto;          // [N] own-row existing-anti veto
  int32_t* aa_cnt;        // [TAA, N] own-row incoming-anti counts
  int32_t* cnt_n;         // [N] accepted placements per node
  int32_t* cnt_add;       // [N] a wave's placements per node (0 between)
  int32_t* dshare;        // [SC + TAA, N] a wave's domain shares (0 between)
  int32_t* elig_dom;      // [SC, N] domains with an eligible member
  int32_t* flags;         // [SC, N] epoch-tagged spread domain flags
  uint8_t* gmask;         // [N]
  int64_t* masked;        // [N] total, -1 where infeasible
  int64_t* champ;         // [N] champion keys per anti domain
  int64_t* fseg;          // [3, N] wave_fold's rotating domain sums
  int64_t* keys1;         // [N, J] the matrix keys of the candidates
  int32_t* packed;        // [B + 4]
};

// a CTA's dynamic shared memory: its rows' raw spread scores and
// feasible set, then the leader's arrays (wave_dyn_bytes)
__host__ __device__ inline int wave_dyn_bytes(int span) {
  return (9 * span + 15) / 16 * 16
         + KT_WAVE_MAX_L * (8 + 4 * 6 + 2) + KT_WAVE_HASH * 8;
}

namespace {

constexpr int BLOCK = KT_PLAN_BLOCK;
using Team = ClusterTeam<BLOCK>;

struct Ctl {              // loop control (the leader's; the others copy)
  int32_t done, prog, ok, waves, confs, first, acc;
};

struct WaveShared {
  uint32_t hist[2][256];  // a select pass's bins, by pass parity
  uint32_t tot[256];      // the cluster's bins
  uint64_t prefix;        // the select's state
  int64_t want;
  int32_t done;
  int32_t minv[KT_MAX_SC];
  int32_t dloc[KT_MAX_SC][KT_M_CAP];   // this CTA's d_need histogram
  // the leader's
  int32_t kc;                          // top-K candidates compacted
  int32_t count;                       // top-Lw keys compacted
  int32_t dhist[KT_MAX_SC][KT_M_CAP];  // the cluster's d_need histogram
  int32_t dneed[KT_MAX_SC][KT_M_CAP];
  int32_t pos[KT_M_CAP];               // where a level's need is met
  int32_t lvlcnt[KT_M_CAP];
  int32_t first_viol, nsel;
  Ctl ctl;
  Ctl ctl_copy;                        // every CTA's copy of the leader's
};

struct Dyn {
  int64_t* gsc;       // [span]
  uint8_t* feas;      // [span]
  int64_t* keys;      // [KT_WAVE_MAX_L] the leader's top-Lw keys
  int32_t* cand;      // [KT_WAVE_MAX_L] the leader's top-K rows
  int32_t* node_i;    // [KT_WAVE_MAX_L]
  int32_t* j_i;
  int32_t* slot;      // an entry's domain slot, -1 when not gated
  int32_t* newcnt;
  int32_t* lvl;
  int32_t* hcnt;      // [KT_WAVE_HASH]
  int32_t* hkey;      // [KT_WAVE_HASH]
  uint8_t* gate;      // [KT_WAVE_MAX_L]
  uint8_t* viol;
};

__device__ __forceinline__ Dyn dyn_of(int span) {
  Dyn d;
  unsigned char* p = kt_plan_dyn;
  d.gsc = (int64_t*)p;
  d.feas = p + 8 * (int64_t)span;
  p += (9 * span + 15) / 16 * 16;
  d.keys = (int64_t*)p;
  p += 8 * KT_WAVE_MAX_L;
  d.cand = (int32_t*)p;
  d.node_i = d.cand + KT_WAVE_MAX_L;
  d.j_i = d.node_i + KT_WAVE_MAX_L;
  d.slot = d.j_i + KT_WAVE_MAX_L;
  d.newcnt = d.slot + KT_WAVE_MAX_L;
  d.lvl = d.newcnt + KT_WAVE_MAX_L;
  d.hcnt = d.lvl + KT_WAVE_MAX_L;
  d.hkey = d.hcnt + KT_WAVE_HASH;
  d.gate = (uint8_t*)(d.hkey + KT_WAVE_HASH);
  d.viol = d.gate + KT_WAVE_MAX_L;
  return d;
}

__device__ __forceinline__ unsigned lanes_below() {
  return (1u << (threadIdx.x & 31)) - 1u;
}

// the masked score of the j1-th pod of the row on `node` (lean_eval.cuh
// kt_uniform_entry, -1 where it does not fit): the node's carry rows are
// another CTA's, so they are read past L1
__device__ __forceinline__ int64_t wave_entry(const WaveArgs& a, int node,
                                              const PodRowD& p, int64_t j1) {
  const CfgC& cfg = a.cfg;
  const NodeC& na = a.na;
  const int64_t* cap = na.cap + (int64_t)node * na.R;
  const long long* used = (const long long*)(a.used + (int64_t)node * na.R);
  const long long* nz = (const long long*)(a.nonzero_used + (int64_t)node * 2);
  if (!((int64_t)__ldcg(a.npods + node) + j1
        <= (int64_t)na.allowed_pods[node]))
    return -1;
  for (int r = 0; r < na.R; ++r) {
    const int64_t q = p.req[r];
    if (q != 0 && !((int64_t)__ldcg(used + r) + j1 * q <= cap[r])) return -1;
  }
  int64_t capc[KT_MAX_C], usedc[KT_MAX_C], plain[KT_MAX_C];
  for (int c = 0; c < cfg.C; ++c) {
    const int col = cfg.score_cols[c];
    capc[c] = cap[col];
    plain[c] = (int64_t)__ldcg(used + col) + j1 * p.req[col];
    if (cfg.col_nonzero[c]) {
      const int s = cfg.nonzero_slot[c];
      usedc[c] = (int64_t)__ldcg(nz + s) + j1 * p.nonzero_req[s];
    } else {
      usedc[c] = plain[c];
    }
  }
  const int64_t s_fit = kt_least_allocated(cfg, capc, usedc);
  const int64_t s_bal = p.skip_balanced ? 0 : kt_balanced(cfg.C, capc, plain);
  return cfg.w_fit * s_fit + cfg.w_balanced * s_bal
         + cfg.w_taint * KT_MAX_SCORE + cfg.w_image * a.s_img[node];
}

// c more pods of the row on row n: its carry rows and its placement
// count. Only the columns the pod requests move, and every load is issued
// before any store (the rows sit in L2 after a cluster barrier: a chain of
// dependent round trips a column otherwise: PERF.md §6, row 6).
__device__ __forceinline__ void kt_wave_place(const WaveArgs& a,
                                              const PodRowD& p, int n,
                                              int32_t c) {
  const int R = a.na.R;
  int64_t* u = a.used + (int64_t)n * R;
  int64_t* nz = a.nonzero_used + (int64_t)n * 2;
  const int64_t nz0 = nz[0], nz1 = nz[1];
  const int32_t np = a.npods[n], cn = a.cnt_n[n];
  for (int r0 = 0; r0 < R; r0 += 8) {
    int64_t q[8], x[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      q[j] = r0 + j < R ? p.req[r0 + j] : 0;
      x[j] = q[j] != 0 ? u[r0 + j] : 0;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (q[j] != 0) u[r0 + j] = x[j] + (int64_t)c * q[j];
  }
  nz[0] = nz0 + (int64_t)c * p.nonzero_req[0];
  nz[1] = nz1 + (int64_t)c * p.nonzero_req[1];
  a.npods[n] = np + c;
  a.cnt_n[n] = cn + c;
}

// eval_row (JAX :1792-1815) on the CTA's rows [lo, hi): the spread minima
// into ws.minv (a team reduction), gmask, the feasible set (d.feas) and
// masked, with the normalization maxima and the group scores (plan_span.cuh
// plan_eval's reductions) where the families need them. `epoch` tags the
// spread domain flags. Ends with a barrier.
__device__ void wave_eval(const WaveArgs& a, const GViewD& v,
                          const PodRowD& p, int lo, int hi, int32_t epoch,
                          Team& tm, PlanShared<BLOCK>& sh, WaveShared& ws,
                          const Dyn& d) {
  __syncthreads();
  const int N = a.na.N, R = a.na.R;
  const int64_t NN = N;
  const FamC& fam = a.fam;
  const bool gs = fam.spr_s || fam.ipa_score;
  if (fam.spr_f) {
    int64_t m[KT_MAX_SC];
#pragma unroll
    for (int c = 0; c < KT_MAX_SC; ++c) {
      int64_t x = KT_INT32_MAX;
      if (c < v.SC)
        for (int n = lo + threadIdx.x; n < hi; n += BLOCK) {
          const int64_t k = c * NN + n;
          if (v.f_elig[k] && v.f_cnt[k] < x) x = v.f_cnt[k];
        }
      m[c] = -x;
    }
    tm.reduce(m, v.SC, 0u, sh);
    if (threadIdx.x == 0) {
#pragma unroll
      for (int c = 0; c < KT_MAX_SC; ++c)
        if (c < v.SC) ws.minv[c] = v.f_minz[c] ? 0 : (int32_t)(-m[c]);
    }
    __syncthreads();
  }
  int64_t tmx = 0, nmx = 0, l = KT_I64_MAX, h = -KT_I64_MAX, np = 0;
  for (int n = lo + threadIdx.x; n < hi; n += BLOCK) {
    const bool fit = kt_fit(a.na, n, a.used + (int64_t)n * R, a.npods[n], p);
    const bool gm = a.m0[n] && kt_group_mask(v, fam, n, ws.minv);
    const bool f = gm && fit;
    a.gmask[n] = gm;
    d.feas[n - lo] = f;
    if (!f) continue;
    if (a.norm_live) {
      tmx = a.taint_raw[n] > tmx ? a.taint_raw[n] : tmx;
      nmx = a.na_raw[n] > nmx ? a.na_raw[n] : nmx;
    }
    if (fam.ipa_score) {
      const int64_t s = v.iscore[n];
      l = s < l ? s : l;
      h = s > h ? s : h;
    }
    if (fam.spr_s && v.s_keys_ok[n]) {
      ++np;
      for (int c = 0; c < v.SC; ++c)
        a.flags[c * NN + v.s_dom[c * NN + n]] = epoch;
    }
  }
  int64_t tmax = 0, namax = 0, lo_s = 0, hi_s = 0, npart = 0;
  if (a.norm_live || gs) {
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
  if (fam.spr_s) {
    has_s = kt_has_s(v);
    // distinct scored domains: the flags of this epoch on the CTA's rows
    int64_t dct[KT_MAX_SC];
#pragma unroll
    for (int c = 0; c < KT_MAX_SC; ++c) {
      int64_t x = 0;
      if (c < v.SC)
        for (int n = lo + threadIdx.x; n < hi; n += BLOCK)
          x += __ldcg(a.flags + c * NN + n) == epoch;
      dct[c] = x;
    }
    tm.reduce(dct, v.SC, 0xffu, sh);
    double weight[KT_MAX_SC];
    for (int c = 0; c < v.SC; ++c) {
      const int64_t size = v.s_is_host[c] ? npart : dct[c];
      weight[c] = log(__dadd_rn((double)size, 2.0));
    }
    int64_t rl = KT_INT32_MAX, rh = 0;
    for (int n = lo + threadIdx.x; n < hi; n += BLOCK) {
      double tot = 0.0;
      for (int c = 0; c < v.SC; ++c) {
        const int64_t k = c * NN + n;
        const double x = (v.s_act[c] && v.s_tv[k] != 0)
            ? __dadd_rn(__dmul_rn((double)v.s_cnt[k], weight[c]),
                        (double)(v.s_skew[c] - 1))
            : 0.0;
        tot = c == 0 ? x : __dadd_rn(tot, x);
      }
      const int64_t r = (int64_t)rint(tot);
      d.gsc[n - lo] = r;
      if (d.feas[n - lo] && v.s_keys_ok[n]) {
        rl = r < rl ? r : rl;
        rh = r > rh ? r : rh;
      }
    }
    int64_t q[2] = {-rl, rh};
    tm.reduce(q, 2, 0u, sh);
    rmin = -q[0];
    rmax = q[1];
  }
  const CfgC& cfg = a.cfg;
  for (int n = lo + threadIdx.x; n < hi; n += BLOCK) {
    int64_t val = -1;
    if (d.feas[n - lo]) {
      int64_t s_fit, s_bal;
      kt_fit_scores(cfg, a.na, n, a.used + (int64_t)n * R,
                    a.nonzero_used + (int64_t)n * 2, p, &s_fit, &s_bal);
      const int64_t tn = a.norm_live
          ? cfg.w_taint * kt_normalize(a.taint_raw[n], tmax, true)
            + cfg.w_node_affinity * kt_normalize(a.na_raw[n], namax, false)
          : cfg.w_taint * KT_MAX_SCORE;
      val = cfg.w_fit * s_fit + cfg.w_balanced * s_bal + tn
            + cfg.w_image * a.s_img[n];
      if (gs)
        val += kt_group_score(v, fam, n, true, fam.spr_s ? d.gsc[n - lo] : 0,
                              a.w_spread, a.w_ipa, has_s, rmin, rmax, lo_s,
                              hi_s);
    }
    a.masked[n] = val;
  }
  __syncthreads();
}

// The radix select over the team: the u-threshold T (u = key − base in
// uint64) such that exactly `want` of the team's `total` unique keys have
// u >= T. `key(i)` is this CTA's i-th key, i < items (the same `items` in
// every thread of the CTA). Every CTA ends with the same T.
template <class KeyAt>
__device__ uint64_t team_select(KeyAt key, int items, int64_t base,
                                uint64_t range, int64_t want, int64_t total,
                                WaveShared& ws, int& hpar) {
  if (want >= total) return 0;
  cg::cluster_group cl = cg::this_cluster();
  const int C = (int)cl.num_blocks(), lane = threadIdx.x & 31;
  const int bits = 64 - __clzll((long long)range);
  uint64_t prefix = 0;
  for (int shift = ((bits + 7) / 8) * 8 - 8; shift >= 0; shift -= 8) {
    uint32_t* hist = ws.hist[hpar];
    hpar ^= 1;
    for (int b = threadIdx.x; b < 256; b += BLOCK) hist[b] = 0;
    __syncthreads();
    const uint64_t hmask = shift + 8 >= 64 ? 0ull : (~0ull << (shift + 8));
    for (int r = 0; r < items; r += BLOCK) {
      const int i = r + threadIdx.x;
      unsigned digit = 256;                  // no bin
      if (i < items) {
        const uint64_t u = (uint64_t)key(i) - (uint64_t)base;
        if ((u & hmask) == prefix) digit = (unsigned)(u >> shift) & 255u;
      }
      const unsigned peers = __match_any_sync(0xffffffffu, digit);
      if (digit < 256 && __ffs(peers) - 1 == lane)
        atomicAdd(&hist[digit], (unsigned)__popc(peers));
    }
    // the bins of every CTA, summed through distributed shared memory
    cl.sync();
    if (threadIdx.x < 256) {
      // every CTA's bin issued before any add
      uint32_t x[KT_WAVE_CLUSTER];
#pragma unroll
      for (int q = 0; q < KT_WAVE_CLUSTER; ++q)
        x[q] = q < C ? cl.map_shared_rank(hist, q)[threadIdx.x] : 0u;
      uint32_t s = 0;
#pragma unroll
      for (int q = 0; q < KT_WAVE_CLUSTER; ++q) s += x[q];
      ws.tot[threadIdx.x] = s;
    }
    __syncthreads();
    if (threadIdx.x < 32) {
      // eight bins a lane from the top; the lane whose bins hold the
      // want-th key walks them
      uint32_t loc[8];
      int64_t own = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        loc[j] = ws.tot[255 - 8 * lane - j];
        own += loc[j];
      }
      int64_t incl = own;
      for (int o = 1; o < 32; o <<= 1) {
        const int64_t t = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += t;
      }
      const int64_t excl = incl - own;
      if (excl < want && incl >= want) {
        int64_t cum = excl;
        int j = 0;
        for (; j < 7; ++j) {
          if (cum + loc[j] >= want) break;
          cum += loc[j];
        }
        ws.prefix = prefix | ((uint64_t)(255 - 8 * lane - j) << shift);
        ws.want = want - cum;
        ws.done = (int64_t)loc[j] == want - cum;
      }
    }
    __syncthreads();
    prefix = ws.prefix;
    want = ws.want;
    const bool done = ws.done != 0;
    if (done) break;
  }
  return prefix;
}

// the domain table's slot of key `dom` (>= 0), inserted if new
__device__ __forceinline__ int hash_slot(int32_t* hkey, int32_t dom) {
  int s = (int)(((uint32_t)dom * 2654435761u) & (KT_WAVE_HASH - 1));
  for (;;) {
    const int32_t prev = atomicCAS(&hkey[s], -1, dom);
    if (prev == -1 || prev == dom) return s;
    s = (s + 1) & (KT_WAVE_HASH - 1);
  }
}

// steps 6-8 on the leader CTA: order the top-Lw keys, the spread replay
// and the cut; then the accepted entries into cnt_add, packed and the
// domain shares, and ctl. `prev_acc`: the last wave's accepted count,
// whose domain shares are zeroed first.
__device__ void leader_wave(const WaveArgs& a, const GViewD& v, int W,
                            bool iter_ok, WaveShared& ws, const Dyn& d) {
  const int N = a.na.N, SC = a.g.SC, TAA = a.g.TAA, J = a.J, Lw = a.Lw;
  const int64_t NN = N, M = NN * J;
  const int wt = a.wt;
  const uint8_t* mf_self = a.g.m_spr_f + ((int64_t)wt * a.g.U + wt) * SC;
  const uint8_t* mex = a.g.m_ipa_exist + ((int64_t)wt * a.g.U + wt) * TAA;
  const uint8_t* maa = a.g.m_ipa_aa + ((int64_t)wt * a.g.U + wt) * TAA;
  const int32_t* atv = a.anti_term >= 0
      ? a.g.ipa_raa_tv + ((int64_t)wt * TAA + a.anti_term) * NN : nullptr;
  // the last wave's domain shares back to zero (every CTA has read them)
  for (int i = threadIdx.x; i < ws.ctl.acc; i += BLOCK) {
    const int node = d.node_i[i];
    if (a.fam.spr_f)
      for (int c = 0; c < SC; ++c) {
        const int64_t k = c * NN + node;
        if (mf_self[c] && v.f_tv[k] != 0 && v.f_elig[k])
          a.dshare[c * NN + v.f_dom[k]] = 0;
      }
    if (a.fam.ipa_anti)
      for (int t = 0; t < TAA; ++t) {
        const int64_t b = ((int64_t)wt * TAA + t) * NN;
        if ((mex[t] || maa[t]) && a.g.ipa_raa_tv[b + node] != 0)
          a.dshare[(SC + t) * NN + a.g.ipa_raa_dom[b + node]] = 0;
      }
  }
  int P = 1;
  while (P < Lw) P <<= 1;
  for (int i = Lw + threadIdx.x; i < P; i += BLOCK) d.keys[i] = KT_I64_MIN;
  block_sort_desc<BLOCK>(d.keys, P);
  const int avail = W - ws.ctl.done;
  if (threadIdx.x == 0) {
    ws.nsel = 0;
    ws.first_viol = Lw;
  }
  for (int i = threadIdx.x; i < Lw; i += BLOCK) {
    const int64_t key = d.keys[i];
    const int64_t q = floordiv(key + M - 1, M);   // the entry's score
    const int64_t ent = q * M - key;              // node * J + j
    d.node_i[i] = (int32_t)(ent / J);
    d.j_i[i] = (int32_t)(ent % J);
    d.viol[i] = 0;
  }
  __syncthreads();
  // sel_ok is a prefix: keys descend and i < avail is a prefix
  for (int i = threadIdx.x; i < Lw; i += BLOCK)
    if (d.keys[i] > -M && i < avail) atomicAdd(&ws.nsel, 1);
  if (a.fam.spr_f && (int)threadIdx.x < SC) {
    const int c = threadIdx.x;
    int32_t run = 0;
    for (int m = 0; m < KT_M_CAP; ++m) {
      run += ws.dhist[c][m];
      ws.dneed[c][m] = run;
    }
  }
  __syncthreads();
  const int nsel = ws.nsel;

  // 7. the spread replay, a constraint at a time
  if (a.fam.spr_f) {
    for (int c = 0; c < SC; ++c) {
      for (int s = threadIdx.x; s < KT_WAVE_HASH; s += BLOCK) {
        d.hkey[s] = -1;
        d.hcnt[s] = 0;
      }
      if (threadIdx.x < KT_M_CAP) {
        ws.lvlcnt[threadIdx.x] = 0;
        ws.pos[threadIdx.x] = ws.dneed[c][threadIdx.x] == 0 ? -1
                                                            : 0x7fffffff;
      }
      __syncthreads();
      for (int i = threadIdx.x; i < Lw; i += BLOCK) {
        const int64_t k = c * NN + d.node_i[i];
        const bool g = mf_self[c] && v.f_elig[k] && i < nsel;
        d.gate[i] = g;
        d.slot[i] = g ? hash_slot(d.hkey, v.f_dom[k]) : -1;
        // the entry's node count before the wave (another CTA's row)
        d.newcnt[i] = g ? __ldcg(a.f_cnt + k) : 0;
      }
      __syncthreads();
      if (threadIdx.x < 32) {
        // the entries in order, 32 at a time: rank in domain and rank in
        // level are counts of the earlier gated entries sharing the key
        const int lane = threadIdx.x;
        const uint32_t lvl0 = (uint32_t)ws.minv[c] + 1u;
        for (int i0 = 0; i0 < Lw; i0 += 32) {
          const int i = i0 + lane;
          const int s = i < Lw ? d.slot[i] : -1;
          const unsigned peers = __match_any_sync(0xffffffffu, s);
          const int top = 31 - __clz(peers);
          int32_t nc = 0;
          int lv = -1;
          if (s >= 0) {
            nc = d.newcnt[i] + d.hcnt[s] + __popc(peers & lanes_below())
                 + 1;
            d.newcnt[i] = nc;
            const uint32_t m = (uint32_t)nc - lvl0;
            if (m < KT_M_CAP) lv = (int)m;
          }
          __syncwarp();
          if (s >= 0 && lane == top) d.hcnt[s] += __popc(peers);
          const unsigned lp = __match_any_sync(0xffffffffu, lv);
          if (lv >= 0) {
            const int32_t q = ws.lvlcnt[lv] + __popc(lp & lanes_below());
            if (q + 1 == ws.dneed[c][lv]) ws.pos[lv] = i;
          }
          __syncwarp();
          if (lv >= 0 && lane == 31 - __clz(lp))
            ws.lvlcnt[lv] += __popc(lp);
          __syncwarp();
        }
      }
      __syncthreads();
      if (v.f_act[c])
        for (int i = threadIdx.x; i < nsel; i += BLOCK) {
          if (!d.gate[i]) continue;
          int32_t up = 0;
          for (int m = 0; m < KT_M_CAP; ++m) up += ws.pos[m] < i;
          const int32_t min_i = v.f_minz[c]
              ? 0 : (int32_t)((uint32_t)ws.minv[c] + (uint32_t)up);
          if ((int64_t)d.newcnt[i] + v.f_self[c] - min_i > v.f_skew[c]
              || up >= KT_M_CAP)
            d.viol[i] = 1;
        }
      __syncthreads();
    }
  }

  // 8. conflict cuts and the conflict-free prefix
  for (int i = threadIdx.x; i < nsel; i += BLOCK) {
    bool viol = d.viol[i] != 0;
    if (atv != nullptr) {
      // a keyless node hides its deeper entries from the jcap = 1 merge
      viol = viol || atv[d.node_i[i]] == 0;
    } else {
      // depth cut: a candidate consuming its last matrix entry
      viol = viol || d.j_i[i] == J - 1;
    }
    if (viol) atomicMin(&ws.first_viol, i);
  }
  __syncthreads();
  const int fv = ws.first_viol;
  // accept = sel_ok & (no violation strictly before i)
  const int acc = !iter_ok ? 0 : (fv + 1 < nsel ? fv + 1 : nsel);

  // 9. the accepted prefix: per-node counts, assignments, domain shares
  for (int i = threadIdx.x; i < acc; i += BLOCK) {
    const int node = d.node_i[i];
    atomicAdd(&a.cnt_add[node], 1);
    a.packed[ws.ctl.done + i] = node;
    if (a.fam.spr_f)
      for (int c = 0; c < SC; ++c) {
        const int64_t k = c * NN + node;
        if (mf_self[c] && v.f_tv[k] != 0 && v.f_elig[k])
          atomicAdd(&a.dshare[c * NN + v.f_dom[k]], 1);
      }
    if (a.fam.ipa_anti)
      for (int t = 0; t < TAA; ++t) {
        const int64_t b = ((int64_t)wt * TAA + t) * NN;
        if ((mex[t] || maa[t]) && a.g.ipa_raa_tv[b + node] != 0)
          atomicAdd(&a.dshare[(SC + t) * NN + a.g.ipa_raa_dom[b + node]],
                    1);
      }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    Ctl& ctl = ws.ctl;
    ctl.confs += (acc < avail && iter_ok) ? 1 : 0;
    if (ctl.waves == 0) ctl.first = acc;
    ctl.waves += 1;
    ctl.done += acc;
    ctl.prog = acc > 0;
    ctl.ok = ctl.ok && iter_ok;
    ctl.acc = acc;
  }
}

// one merge wave on the CTA's rows; every CTA returns with the leader's
// ctl in `ctl`
__device__ void merge_wave(const WaveArgs& a, const GViewD& v,
                           const PodRowD& p, int lo, int hi, int W,
                           int32_t epoch, Ctl& ctl, Team& tm,
                           PlanShared<BLOCK>& sh, WaveShared& ws,
                           const Dyn& d, int& hpar) {
  cg::cluster_group cl = cg::this_cluster();
  const bool lead = cl.block_rank() == 0;
  const int N = a.na.N, SC = a.g.SC, TAA = a.g.TAA;
  const int K = a.K, J = a.J, Lw = a.Lw;
  const int64_t NN = N, M = NN * J;
  const int wt = a.wt;
  if (lead && threadIdx.x == 0) {
    ws.kc = 0;
    ws.count = 0;
  }
  if (a.fam.spr_f)
    for (int t = threadIdx.x; t < SC * KT_M_CAP; t += BLOCK) {
      if (lead) ws.dhist[t / KT_M_CAP][t % KT_M_CAP] = 0;
      ws.dloc[t / KT_M_CAP][t % KT_M_CAP] = 0;
    }
  wave_eval(a, v, p, lo, hi, epoch, tm, sh, ws, d);

  const int32_t* atv = nullptr;
  const int32_t* adom = nullptr;
  if (a.anti_term >= 0) {
    const int64_t b = ((int64_t)wt * TAA + a.anti_term) * NN;
    atv = a.g.ipa_raa_tv + b;
    adom = a.g.ipa_raa_dom + b;
  }
  // 2. flat inter-pod surface over the feasible set, no keyed node
  // skew-masked at wave start, the key range of step 3; 4. the anti
  // domains' champions; d_need's histogram of the domain slots
  int64_t l = KT_I64_MAX, h = -KT_I64_MAX, bad = 0;
  int64_t kmax = KT_I64_MIN, nkmin = KT_I64_MIN;
  for (int n = lo + threadIdx.x; n < hi; n += BLOCK) {
    const int64_t mk = a.masked[n];
    if (d.feas[n - lo]) {
      const int64_t s = v.iscore[n];
      l = s < l ? s : l;
      h = s > h ? s : h;
    }
    if (a.fam.spr_f)
      for (int c = 0; c < SC; ++c) {
        const int64_t e = c * NN + n;
        if (v.f_act[c] && v.f_tv[e] != 0
            && (int64_t)v.f_cnt[e] + v.f_self[c] - ws.minv[c] > v.f_skew[c])
          ++bad;
        // a domain id IS the index of one of its nodes: the domains with
        // an eligible member, their counts read at that slot
        if (__ldcg(a.elig_dom + e)) {
          const int64_t m0 = (int64_t)v.f_cnt[e] - ws.minv[c];
          if (m0 < KT_M_CAP) atomicAdd(&ws.dloc[c][m0 < 0 ? 0 : m0], 1);
        }
      }
    // lax.top_k(masked0.astype(int32), K): ties to the lowest index
    const int64_t k0 = ((int64_t)(int32_t)mk + 1) * NN + (NN - 1 - n);
    kmax = k0 > kmax ? k0 : kmax;
    nkmin = -k0 > nkmin ? -k0 : nkmin;
    if (atv != nullptr && atv[n] != 0)
      atomicMax((long long*)&a.champ[adom[n]], (long long)(mk * NN - n));
  }
  if (a.fam.spr_f) {
    __syncthreads();
    int32_t* dh = cl.map_shared_rank(&ws.dhist[0][0], 0);
    for (int t = threadIdx.x; t < SC * KT_M_CAP; t += BLOCK) {
      const int32_t x = ws.dloc[t / KT_M_CAP][t % KT_M_CAP];
      if (x) atomicAdd(dh + t, x);
    }
  }
  int64_t r2[5] = {-l, h, bad, kmax, nkmin};
  tm.reduce(r2, 5, 1u << 2, sh);
  const bool flat = r2[1] <= -r2[0];
  const bool start_inert = r2[2] == 0;
  const int64_t base0 = -r2[4];

  // 3. top-K candidates: the K largest keys, as a set, into the leader
  auto key0 = [&](int i) -> int64_t {
    const int n = lo + i;
    return ((int64_t)(int32_t)a.masked[n] + 1) * NN + (NN - 1 - n);
  };
  const uint64_t t0 = team_select(key0, hi - lo, base0,
                                  (uint64_t)r2[3] - (uint64_t)base0, K, N,
                                  ws, hpar);
  {
    int32_t* cand = cl.map_shared_rank(d.cand, 0);
    int32_t* kc = cl.map_shared_rank(&ws.kc, 0);
    for (int r = 0; r < hi - lo; r += BLOCK) {
      const int i = r + threadIdx.x;
      const bool take = i < hi - lo
          && (uint64_t)key0(i) - (uint64_t)base0 >= t0;
      const unsigned vote = __ballot_sync(0xffffffffu, take);
      if (vote == 0) continue;
      const int lead_lane = __ffs(vote) - 1;
      int at = 0;
      if ((int)(threadIdx.x & 31) == lead_lane)
        at = atomicAdd(kc, __popc(vote));
      at = __shfl_sync(0xffffffffu, at, lead_lane);
      if (take) cand[at + __popc(vote & lanes_below())] = lo + i;
    }
  }
  tm.sync();   // every candidate in the leader

  // 5. the [K, J] matrix and its flat keys: a thread an entry, the K·J
  // entries cut into C equal ranges (a candidate's rows are another CTA's:
  // read past L1)
  const int jcap = a.anti_term >= 0 ? 1 : J;
  const int C = (int)cl.num_blocks();
  const int64_t KJ = (int64_t)K * J, chunk = (KJ + C - 1) / C;
  const int64_t e_lo = min(KJ, (int64_t)cl.block_rank() * chunk);
  const int64_t e_hi = min(KJ, e_lo + chunk);
  // this CTA's candidates, copied once from the leader
  if (!lead && e_hi > e_lo) {
    const int32_t* from = cl.map_shared_rank(d.cand, 0);
    for (int64_t k = e_lo / J + threadIdx.x; k <= (e_hi - 1) / J;
         k += BLOCK)
      d.cand[k] = from[k];
  }
  __syncthreads();
  const int32_t* cand = d.cand;
  auto entry = [&](int64_t e, int* node_out) -> int64_t {
    const int j = (int)(e % J);
    const int node = cand[e / J];
    *node_out = node;
    if (j >= jcap || !__ldcg(a.gmask + node)) return -1;
    if (atv != nullptr && atv[node] != 0
        && (int64_t)__ldcg((const long long*)(a.masked + node)) * NN - node
               != (int64_t)__ldcg((const long long*)(a.champ + adom[node])))
      return -1;
    return wave_entry(a, node, p, j + 1);
  };
  int64_t mono_bad = 0, k1max = KT_I64_MIN, nk1min = KT_I64_MIN;
  for (int64_t e0 = e_lo; e0 < e_hi; e0 += BLOCK) {
    const int64_t e = e0 + threadIdx.x;
    const bool in = e < e_hi;
    int node = 0;
    const int64_t mk = in ? entry(e, &node) : -1;
    // the entry before, the lane before's (the warp's first lane
    // evaluates it)
    int64_t prev = __shfl_up_sync(0xffffffffu, mk, 1);
    const int j = (int)(e % J);
    if (in && j > 0 && (threadIdx.x & 31) == 0) {
      int nd;
      prev = entry(e - 1, &nd);
    }
    if (!in) continue;
    if (j > 0 && mk > prev) ++mono_bad;
    const int64_t key = mk * M - ((int64_t)node * J + j);
    a.keys1[e] = key;
    k1max = key > k1max ? key : k1max;
    nk1min = -key > nk1min ? -key : nk1min;
  }
  int64_t r3[3] = {mono_bad, k1max, nk1min};
  tm.reduce(r3, 3, 1u, sh);
  const bool mono_ok = r3[0] == 0;
  const int64_t base1 = -r3[2];
  if (atv != nullptr)
    for (int n = lo + threadIdx.x; n < hi; n += BLOCK) a.champ[n] = KT_I64_MIN;

  // 6. the top-Lw merge: the Lw largest keys into the leader
  auto key1 = [&](int i) -> int64_t { return a.keys1[e_lo + i]; };
  const int items = (int)(e_hi - e_lo);
  const uint64_t t1 = team_select(key1, items, base1,
                                  (uint64_t)r3[1] - (uint64_t)base1, Lw,
                                  (int64_t)K * J, ws, hpar);
  {
    int32_t* cnt = cl.map_shared_rank(&ws.count, 0);
    int64_t* keys = cl.map_shared_rank(d.keys, 0);
    for (int r = 0; r < items; r += BLOCK) {
      const int i = r + threadIdx.x;
      int64_t key = 0;
      bool take = false;
      if (i < items) {
        key = key1(i);
        take = (uint64_t)key - (uint64_t)base1 >= t1;
      }
      const unsigned vote = __ballot_sync(0xffffffffu, take);
      if (vote == 0) continue;
      const int lead_lane = __ffs(vote) - 1;
      int at = 0;
      if ((int)(threadIdx.x & 31) == lead_lane)
        at = atomicAdd(cnt, __popc(vote));
      at = __shfl_sync(0xffffffffu, at, lead_lane);
      if (take) keys[at + __popc(vote & lanes_below())] = key;
    }
  }
  tm.sync();
  if (lead) leader_wave(a, v, W, mono_ok && flat && start_inert, ws, d);
  tm.sync();
  // one remote read a CTA, not a thread: the leader's shared memory serves
  // every CTA's reads
  if (threadIdx.x == 0) ws.ctl_copy = *cl.map_shared_rank(&ws.ctl, 0);
  __syncthreads();
  ctl = ws.ctl_copy;

  // 9. fold the accepted prefix into the loop state on the CTA's rows
  const uint8_t* mf_self = a.g.m_spr_f + ((int64_t)wt * a.g.U + wt) * SC;
  const uint8_t* mex = a.g.m_ipa_exist + ((int64_t)wt * a.g.U + wt) * TAA;
  const uint8_t* maa = a.g.m_ipa_aa + ((int64_t)wt * a.g.U + wt) * TAA;
  for (int n = lo + threadIdx.x; n < hi; n += BLOCK) {
    const int32_t c = __ldcg(a.cnt_add + n);
    if (c != 0) {
      a.cnt_add[n] = 0;
      kt_wave_place(a, p, n, c);
    }
    if (a.fam.spr_f)
      for (int cc = 0; cc < SC; ++cc) {
        const int64_t e = cc * NN + n;
        if (mf_self[cc] && v.f_tv[e] != 0)
          a.f_cnt[e] += __ldcg(a.dshare + cc * NN + v.f_dom[e]);
      }
    if (a.fam.ipa_anti)
      for (int t = 0; t < TAA; ++t) {
        if (!mex[t] && !maa[t]) continue;
        const int64_t b = ((int64_t)wt * TAA + t) * NN;
        if (a.g.ipa_raa_tv[b + n] == 0) continue;
        const int32_t x =
            __ldcg(a.dshare + (SC + t) * NN + a.g.ipa_raa_dom[b + n]);
        if (mex[t]) a.veto[n] += x;
        if (maa[t]) a.aa_cnt[t * NN + n] += x;
      }
  }
}

// _dom_share for the team: out(n, Σ_m w(m) over the nodes m
// sharing n's topology value) on the CTA's rows, 0 where tv == 0. Term k
// sums into fseg[k % 3] and zeroes this CTA's rows of fseg[(k + 1) % 3],
// which every CTA read two terms ago (before the last term's barrier).
// One cluster barrier a term.
template <class WFn, class OutFn>
__device__ void team_dom_share(const WaveArgs& a, const int32_t* tv,
                               const int32_t* dom, int lo, int hi, int& k,
                               Team& tm, WFn w, OutFn out) {
  const int64_t NN = a.na.N;
  int64_t* seg = a.fseg + (k % 3) * NN;
  int64_t* nxt = a.fseg + ((k + 1) % 3) * NN;
  ++k;
  for (int n = lo + threadIdx.x; n < hi; n += BLOCK) {
    nxt[n] = 0;
    if (tv[n] == 0) continue;
    const int64_t x = w(n);
    if (x != 0)
      atomicAdd((unsigned long long*)&seg[dom[n]], (unsigned long long)x);
  }
  tm.sync();
  for (int n = lo + threadIdx.x; n < hi; n += BLOCK)
    out(n, tv[n] != 0 ? (int64_t)__ldcg((const long long*)&seg[dom[n]])
                      : (int64_t)0);
}

// wave_fold (kubernetes_tpu/ops/groups.py :1215-1311) for the single wave
// row u on the team: the per-node placement counts cnt[n] into the group
// carry c (in place), each counter element written by the thread that owns
// its row
__device__ void team_wave_fold(const WaveArgs& a, const GCarryC& c,
                               const int32_t* cnt, int lo, int hi, Team& tm,
                               PlanShared<BLOCK>& sh) {
  const GroupsC& g = a.g;
  const FamC& fam = a.fam;
  const int u = a.wt;
  const int64_t NN = g.N, U = g.U, SC = g.SC, TA = g.TA, TAA = g.TAA;
  const int64_t CT = g.CT, PT = g.PT;
  int k = 0;
  auto share = [&](const int32_t* tv, const int32_t* dom, auto w,
                   auto out) {
    team_dom_share(a, tv, dom, lo, hi, k, tm, w, out);
  };
  auto all = [&](int n) { return (int64_t)cnt[n]; };
  if (fam.spr_f) {
    for (int64_t v = 0; v < U; ++v)
      for (int64_t cc = 0; cc < SC; ++cc) {
        if (!g.m_spr_f[(u * U + v) * SC + cc]) continue;
        const int64_t b = (v * SC + cc) * NN;
        const uint8_t* el = g.spr_f_elig + b;
        int32_t* dst = c.spr_f_cnt + b;
        share(g.spr_f_tv + b, g.spr_f_dom + b,
              [&](int n) { return (int64_t)(el[n] ? cnt[n] : 0); },
              [&](int n, int64_t x) { dst[n] += (int32_t)x; });
      }
  }
  if (fam.spr_s) {
    for (int64_t v = 0; v < U; ++v)
      for (int64_t cc = 0; cc < SC; ++cc) {
        if (!g.m_spr_s[(u * U + v) * SC + cc]) continue;
        const int64_t b = (v * SC + cc) * NN;
        int32_t* dst = c.spr_s_cnt + b;
        if (g.spr_s_is_host[v * SC + cc]) {
          // hostname constraints count the node's own pods, ungated
          for (int n = lo + threadIdx.x; n < hi; n += BLOCK) dst[n] += cnt[n];
          continue;
        }
        const uint8_t* el = g.spr_s_elig + b;
        share(g.spr_s_tv + b, g.spr_s_dom + b,
              [&](int n) { return (int64_t)(el[n] ? cnt[n] : 0); },
              [&](int n, int64_t x) { dst[n] += (int32_t)x; });
      }
  }
  if (fam.ipa_anti) {
    // existing-anti veto: shared along the placed row's term topology
    for (int64_t t = 0; t < TAA; ++t) {
      const int64_t b = (u * TAA + t) * NN;
      share(g.ipa_raa_tv + b, g.ipa_raa_dom + b, all,
            [&](int n, int64_t x) {
              for (int64_t v = 0; v < U; ++v)
                if (g.m_ipa_exist[(u * U + v) * TAA + t])
                  c.ipa_veto[v * NN + n] += (int32_t)x;
            });
    }
    // incoming-anti counts: shared along the consumer's term topology
    for (int64_t v = 0; v < U; ++v)
      for (int64_t t = 0; t < TAA; ++t) {
        if (!g.m_ipa_aa[(u * U + v) * TAA + t]) continue;
        const int64_t b = (v * TAA + t) * NN;
        int32_t* dst = c.ipa_aa_cnt + b;
        share(g.ipa_raa_tv + b, g.ipa_raa_dom + b, all,
              [&](int n, int64_t x) { dst[n] += (int32_t)x; });
      }
  }
  if (fam.ipa_req) {
    for (int64_t v = 0; v < U; ++v) {
      if (!g.m_ipa_a[u * U + v]) continue;
      for (int64_t t = 0; t < TA; ++t) {
        if (!g.ipa_ra_active[v * TA + t]) continue;
        const int64_t b = (v * TA + t) * NN;
        int32_t* dst = c.ipa_a_cnt + b;
        share(g.ipa_ra_tv + b, g.ipa_ra_dom + b, all,
              [&](int n, int64_t x) { dst[n] += (int32_t)x; });
      }
      // a_total: Σ_n cnt[n] · (# active terms whose key the node carries)
      int64_t part[1] = {0};
      for (int n = lo + threadIdx.x; n < hi; n += BLOCK) {
        int64_t kk = 0;
        for (int64_t t = 0; t < TA; ++t)
          kk += g.ipa_ra_active[v * TA + t]
                && g.ipa_ra_tv[(v * TA + t) * NN + n] != 0;
        part[0] += (int64_t)cnt[n] * kk;
      }
      tm.reduce(part, 1, 1u, sh);
      if (cg::this_cluster().block_rank() == 0 && threadIdx.x == 0)
        c.ipa_a_total[v] += part[0];
    }
  }
  if (fam.ipa_score) {
    // consumer-side preferred terms matching the placed pod
    for (int64_t v = 0; v < U; ++v)
      for (int64_t t = 0; t < CT; ++t) {
        const int64_t w = g.w_stc[(u * U + v) * CT + t];
        if (w == 0) continue;
        const int64_t b = (v * CT + t) * NN;
        int64_t* dst = c.ipa_score + v * NN;
        share(g.ipa_stc_tv + b, g.ipa_stc_dom + b,
              [&](int n) { return w * cnt[n]; },
              [&](int n, int64_t x) { dst[n] += x; });
      }
    // placed-side terms: share along the placed row's term topology, then
    // weight per consumer
    for (int64_t t = 0; t < PT; ++t) {
      const int64_t b = (u * PT + t) * NN;
      share(g.ipa_stp_tv + b, g.ipa_stp_dom + b, all,
            [&](int n, int64_t x) {
              for (int64_t v = 0; v < U; ++v)
                c.ipa_score[v * NN + n] += g.w_stp[(u * U + v) * PT + t] * x;
            });
    }
  }
}

__global__ void __launch_bounds__(BLOCK, 1)
run_wave_kernel(const __grid_constant__ WaveArgs a) {
  __shared__ PlanShared<BLOCK> sh;
  __shared__ WaveShared ws;
  cg::cluster_group cl = cg::this_cluster();
  const int C = (int)cl.num_blocks(), rank = (int)cl.block_rank();
  const bool lead = rank == 0;
  const int N = a.na.N, SC = a.g.SC, TAA = a.g.TAA;
  const int64_t NN = N;
  const int span = (N + C - 1) / C;
  const int lo = min(N, rank * span), hi = min(N, lo + span);
  const int wt = a.wt;
  const PodRowD p = pod_row(a.tb, wt);
  const Dyn d = dyn_of(span);
  Team tm;
  int hpar = 0;

  // the loop state on the CTA's rows; the scratch the waves keep at 0
  for (int n = lo + threadIdx.x; n < hi; n += BLOCK) {
    for (int c = 0; c < SC; ++c) {
      a.f_cnt[c * NN + n] = a.gin.spr_f_cnt[((int64_t)wt * SC + c) * NN + n];
      a.elig_dom[c * NN + n] = 0;
      a.flags[c * NN + n] = 0;
    }
    for (int t = 0; t < TAA; ++t)
      a.aa_cnt[t * NN + n] =
          a.gin.ipa_aa_cnt[((int64_t)wt * TAA + t) * NN + n];
    for (int t = 0; t < SC + TAA; ++t) a.dshare[t * NN + n] = 0;
    a.veto[n] = a.gin.ipa_veto[(int64_t)wt * NN + n];
    a.cnt_n[n] = 0;
    a.cnt_add[n] = 0;
    a.champ[n] = KT_I64_MIN;
    for (int s = 0; s < 3; ++s) a.fseg[s * NN + n] = 0;
  }
  for (int b = rank * BLOCK + threadIdx.x; b < a.B; b += C * BLOCK)
    a.packed[b] = -1;
  int W = 0;
  for (int b0 = 0; b0 < a.B; b0 += BLOCK) {
    const int b = b0 + threadIdx.x;
    W += __syncthreads_count(b < a.B && a.valid[b] != 0);
  }
  if (lead && threadIdx.x == 0) {
    ws.ctl.done = 0;
    ws.ctl.prog = 1;
    ws.ctl.ok = 1;
    ws.ctl.waves = 0;
    ws.ctl.confs = 0;
    ws.ctl.first = -1;
    ws.ctl.acc = 0;
  }
  GViewD v = view_of(a.g, a.gin, wt);
  v.f_cnt = a.f_cnt;
  v.veto = a.veto;
  v.aa_cnt = a.aa_cnt;
  const bool merge = a.merge_on && !a.norm_live;
  tm.sync();   // every scratch row zeroed before another CTA writes it
  if (merge && a.fam.spr_f) {
    for (int n = lo + threadIdx.x; n < hi; n += BLOCK)
      for (int c = 0; c < SC; ++c)
        if (v.f_elig[c * NN + n]) a.elig_dom[c * NN + v.f_dom[c * NN + n]] = 1;
  }
  // (the first evaluation's reduction orders the marks before any read)

  Ctl ctl = {0, 1, 1, 0, 0, -1, 0};
  int32_t epoch = 1;
  // merge tier: gated entirely by merge_on and a static normalization
  if (merge) {
    while (ctl.ok && ctl.prog && ctl.done < W)
      merge_wave(a, v, p, lo, hi, W, epoch++, ctl, tm, sh, ws, d, hpar);
  }

  // serial tier
  int32_t steps = 0;
  const uint8_t* mf_self = a.g.m_spr_f + ((int64_t)wt * a.g.U + wt) * SC;
  const uint8_t* mex = a.g.m_ipa_exist + ((int64_t)wt * a.g.U + wt) * TAA;
  const uint8_t* maa = a.g.m_ipa_aa + ((int64_t)wt * a.g.U + wt) * TAA;
  int32_t done = ctl.done;
  while (done < W) {
    wave_eval(a, v, p, lo, hi, epoch++, tm, sh, ws, d);
    int64_t key[1] = {KT_I64_MIN};
    for (int n = lo + threadIdx.x; n < hi; n += BLOCK) {
      const int64_t k = ((a.masked[n] + 1) << 32)
                        | (int64_t)(0x7fffffff - n);
      key[0] = k > key[0] ? k : key[0];
    }
    tm.reduce(key, 1, 0u, sh);
    int64_t score;
    int32_t best;
    kt_plan_unkey(key[0], &score, &best);
    if (score < 0) {
      // the state is unchanged: every remaining pod fails the same way
      steps += W - done;
      done = W;
      break;
    }
    if (threadIdx.x == 0 && best >= lo && best < hi)
      kt_wave_place(a, p, best, 1);
    if (lead && threadIdx.x == 0) a.packed[done] = best;
    for (int n = lo + threadIdx.x; n < hi; n += BLOCK) {
      if (a.fam.spr_f)
        for (int c = 0; c < SC; ++c) {
          const int32_t tvb = v.f_tv[c * NN + best];
          if (mf_self[c] && v.f_elig[c * NN + best] && tvb != 0
              && v.f_tv[c * NN + n] == tvb)
            a.f_cnt[c * NN + n] += 1;
        }
      if (a.fam.ipa_anti)
        for (int t = 0; t < TAA; ++t) {
          const int32_t* tv = a.g.ipa_raa_tv + ((int64_t)wt * TAA + t) * NN;
          if (tv[best] == 0 || tv[n] != tv[best]) continue;
          if (mex[t]) a.veto[n] += 1;
          if (maa[t]) a.aa_cnt[t * NN + n] += 1;
        }
    }
    done += 1;
    steps += 1;
  }

  tm.sync();   // every CTA's counts final
  team_wave_fold(a, a.gout, a.cnt_n, lo, hi, tm, sh);
  if (lead && threadIdx.x == 0) {
    a.packed[a.B] = ctl.waves;
    a.packed[a.B + 1] = ctl.confs;
    a.packed[a.B + 2] = ctl.first;
    a.packed[a.B + 3] = steps;
  }
  tm.finish();
}

}  // namespace

extern "C" int ktpu_run_wave(const WaveArgs* args, void* stream) {
  const int C = KT_WAVE_CLUSTER, N = args->na.N;
  const int smem = wave_dyn_bytes((N + C - 1) / C);
  cudaError_t e = cudaFuncSetAttribute(
      run_wave_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(run_wave_kernel,
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
  e = cudaLaunchKernelEx(&cfg, run_wave_kernel, *args);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
