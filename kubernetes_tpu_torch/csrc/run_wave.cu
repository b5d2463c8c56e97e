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
//      rides in the sort key);
//   4. with a self-matching anti term: the champion per anti domain, a
//      segment max of score·N − idx (atomicMax on int64);
//   5. the [K, J] post-placement matrix (lean_eval.cuh kt_uniform_entry,
//      run_uniform's entry code) and its flat keys (score desc, node asc,
//      j asc);
//   6. the top-Lw merge (a bitonic sort, sort.cuh);
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
// inside each wave eval → sort → matrix → sort → replay → fold — over
// at most a few MB of L2-resident state; latency (barriers and the
// dependent chain), not bytes or operations.
//
// Design: the whole call is ONE persistent single-block launch, so the
// merge loop's condition (ok & progress & done < W) is read on the
// device and no wave costs a host round trip. 1,024 threads own the node
// axis (node n belongs to thread n % 1024); the sorts are the block-level
// bitonic network over global scratch; every reduction is a block
// reduction. The wrapper hands the kernel fresh copies of the carry
// fields it writes.

#include "group_eval.cuh"
#include "sort.cuh"

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
  // scratch
  int32_t* f_cnt;         // [SC, N] own-row spread filter counts
  int32_t* veto;          // [N] own-row existing-anti veto
  int32_t* aa_cnt;        // [TAA, N] own-row incoming-anti counts
  int32_t* cnt_n;         // [N] accepted placements per node
  int32_t* cnt_add;       // [N] this wave's placements per node
  uint8_t* gmask;         // [N]
  uint8_t* feas;          // [N]
  int64_t* masked;        // [N] total, -1 where infeasible
  int64_t* gsc;           // [N] weighted group scores
  int32_t* flags;         // [SC, N] spread domain flags
  int64_t* seg;           // [N] domain segments
  int32_t* elig_dom;      // [SC, N]
  int64_t* keys0;         // [P0]
  int32_t* cand;          // [K]
  int64_t* keys1;         // [P1]
  int32_t* node_i;        // [Lw]
  int32_t* j_i;           // [Lw]
  uint8_t* gate;          // [Lw, SC]
  int32_t* dom_ic;        // [Lw, SC]
  int32_t* newcnt;        // [Lw, SC]
  uint32_t* lvlmask;      // [Lw, SC] bit m: level m reached
  int32_t P0, P1;
  int32_t* packed;        // [B + 4]
};

namespace {

constexpr int BLOCK = 1024;

struct Ctl {              // loop control, shared by the block
  int32_t done, prog, ok, waves, confs, first, steps;
};

// eval_row (JAX :1792-1815): gmask = statics mask & group mask, feas,
// masked total. Ends with a barrier.
__device__ void wave_eval(const WaveArgs& a, const GViewD& v,
                          const PodRowD& p, int32_t* minv,
                          BlockScratch<BLOCK>& sh) {
  const int N = a.na.N, R = a.na.R;
  if (a.fam.spr_f) block_spread_min<BLOCK>(v, minv, sh);
  int64_t tm = 0, nm = 0;
  for (int n = threadIdx.x; n < N; n += BLOCK) {
    const bool fit = kt_fit(a.na, n, a.used + (int64_t)n * R, a.npods[n], p);
    const bool gm = a.m0[n] && kt_group_mask(v, a.fam, n, minv);
    const bool f = gm && fit;
    a.gmask[n] = gm;
    a.feas[n] = f;
    if (a.norm_live && f) {
      tm = a.taint_raw[n] > tm ? a.taint_raw[n] : tm;
      nm = a.na_raw[n] > nm ? a.na_raw[n] : nm;
    }
  }
  int64_t tmax = 0, namax = 0;
  if (a.norm_live) {
    tmax = block_max<BLOCK>(tm, sh);
    namax = block_max<BLOCK>(nm, sh);
  }
  const bool gs = a.fam.spr_s || a.fam.ipa_score;
  if (gs)
    block_group_scores<BLOCK>(v, a.fam, a.w_spread, a.w_ipa, a.feas,
                              a.flags, a.gsc, sh);
  const CfgC& cfg = a.cfg;
  for (int n = threadIdx.x; n < N; n += BLOCK) {
    int64_t val = -1;
    if (a.feas[n]) {
      int64_t s_fit, s_bal;
      kt_fit_scores(cfg, a.na, n, a.used + (int64_t)n * R,
                    a.nonzero_used + (int64_t)n * 2, p, &s_fit, &s_bal);
      const int64_t tn = a.norm_live
          ? cfg.w_taint * kt_normalize(a.taint_raw[n], tmax, true)
            + cfg.w_node_affinity * kt_normalize(a.na_raw[n], namax, false)
          : cfg.w_taint * KT_MAX_SCORE;
      val = cfg.w_fit * s_fit + cfg.w_balanced * s_bal + tn
            + cfg.w_image * a.s_img[n] + (gs ? a.gsc[n] : 0);
    }
    a.masked[n] = val;
  }
  __syncthreads();
}

// one merge wave; updates the loop state and ctl (thread 0). Returns
// after a barrier.
__device__ void merge_wave(const WaveArgs& a, const GViewD& v,
                           const PodRowD& p, int W, Ctl& ctl,
                           int32_t* minv, int32_t* d_need,
                           BlockScratch<BLOCK>& sh) {
  const int N = a.na.N, R = a.na.R, SC = a.g.SC, TAA = a.g.TAA;
  const int K = a.K, J = a.J, Lw = a.Lw;
  const int64_t NN = N;
  const int wt = a.wt;
  wave_eval(a, v, p, minv, sh);
  const int avail = W - ctl.done;

  // 2. flat inter-pod surface over the feasible set
  int64_t lo = KT_I64_MAX, hi = -KT_I64_MAX;
  for (int n = threadIdx.x; n < N; n += BLOCK) {
    if (!a.feas[n]) continue;
    const int64_t s = v.iscore[n];
    lo = s < lo ? s : lo;
    hi = s > hi ? s : hi;
  }
  lo = block_min<BLOCK>(lo, sh);
  hi = block_max<BLOCK>(hi, sh);
  const bool flat = hi <= lo;
  // no keyed node skew-masked at wave start
  bool start_inert = true;
  if (a.fam.spr_f) {
    int64_t bad = 0;
    for (int64_t e = threadIdx.x; e < (int64_t)SC * N; e += BLOCK) {
      const int c = (int)(e / N);
      if (v.f_act[c] && v.f_tv[e] != 0
          && (int64_t)v.f_cnt[e] + v.f_self[c] - minv[c] > v.f_skew[c])
        ++bad;
    }
    start_inert = block_sum<BLOCK>(bad, sh) == 0;
  }

  // 3. top-K candidates: lax.top_k(masked0.astype(int32), K)
  for (int t = threadIdx.x; t < a.P0; t += BLOCK)
    a.keys0[t] = t < N
        ? ((int64_t)(int32_t)a.masked[t] + 1) * NN + (NN - 1 - t)
        : KT_I64_MIN;
  block_sort_desc<BLOCK>(a.keys0, a.P0);
  for (int k = threadIdx.x; k < K; k += BLOCK)
    a.cand[k] = N - 1 - (int)(a.keys0[k] % NN);

  // 4. champion per anti-topology domain
  const int32_t* atv = nullptr;
  const int32_t* adom = nullptr;
  if (a.anti_term >= 0) {
    const int64_t b = ((int64_t)wt * TAA + a.anti_term) * NN;
    atv = a.g.ipa_raa_tv + b;
    adom = a.g.ipa_raa_dom + b;
    for (int n = threadIdx.x; n < N; n += BLOCK) a.seg[n] = KT_I64_MIN;
    __syncthreads();
    for (int n = threadIdx.x; n < N; n += BLOCK)
      if (atv[n] != 0)
        atomicMax((long long*)&a.seg[adom[n]],
                  (long long)(a.masked[n] * NN - n));
  }
  __syncthreads();

  // 5. the [K, J] matrix and its flat keys
  const int jcap = a.anti_term >= 0 ? 1 : J;
  const int64_t M = NN * J;
  const CfgC& cfg = a.cfg;
  int64_t mono_bad = 0;
  for (int k = threadIdx.x; k < K; k += BLOCK) {
    const int node = a.cand[k];
    const bool champ = a.anti_term < 0 || atv[node] == 0
        || a.masked[node] * NN - node == a.seg[adom[node]];
    const bool gm = a.gmask[node] && champ;
    const int64_t sadd = cfg.w_taint * KT_MAX_SCORE
                         + cfg.w_image * a.s_img[node];
    int64_t prev = 0;
    for (int j = 0; j < J; ++j) {
      int64_t mk = -1;
      if (gm && j < jcap) {
        bool fit;
        int64_t sf, sb;
        kt_uniform_entry(cfg, a.na, node, a.used + (int64_t)node * R,
                         a.nonzero_used + (int64_t)node * 2, a.npods[node],
                         p, j + 1, &fit, &sf, &sb);
        if (fit) mk = cfg.w_fit * sf + cfg.w_balanced * sb + sadd;
      }
      if (j > 0 && mk > prev) ++mono_bad;
      prev = mk;
      a.keys1[(int64_t)k * J + j] = mk * M - ((int64_t)node * J + j);
    }
  }
  for (int t = K * J + threadIdx.x; t < a.P1; t += BLOCK)
    a.keys1[t] = KT_I64_MIN;
  const bool mono_ok = block_sum<BLOCK>(mono_bad, sh) == 0;

  // 6. the top-Lw merge
  block_sort_desc<BLOCK>(a.keys1, a.P1);
  int64_t nsel_part = 0;
  for (int i = threadIdx.x; i < Lw; i += BLOCK) {
    const int64_t key = a.keys1[i];
    const int64_t q = floordiv(key + M - 1, M);   // the entry's score
    const int64_t ent = q * M - key;              // node * J + j
    a.node_i[i] = (int32_t)(ent / J);
    a.j_i[i] = (int32_t)(ent % J);
    nsel_part += key > -M && i < avail;
  }
  // sel_ok is a prefix: keys descend and i < avail is a prefix
  const int nsel = (int)block_sum<BLOCK>(nsel_part, sh);

  // 7. spread skew replayed at domain level
  const uint8_t* mf_self = a.g.m_spr_f + ((int64_t)wt * a.g.U + wt) * SC;
  if (a.fam.spr_f) {
    for (int e = threadIdx.x; e < Lw * SC; e += BLOCK) {
      const int i = e / SC, c = e % SC;
      const int64_t k = (int64_t)c * NN + a.node_i[i];
      a.gate[e] = mf_self[c] && v.f_elig[k] && i < nsel;
      a.dom_ic[e] = v.f_dom[k];
      a.lvlmask[e] = 0;
    }
    for (int64_t e = threadIdx.x; e < (int64_t)SC * N; e += BLOCK)
      a.elig_dom[e] = 0;
    for (int t = threadIdx.x; t < SC * KT_M_CAP; t += BLOCK) d_need[t] = 0;
    __syncthreads();
    for (int e = threadIdx.x; e < Lw * SC; e += BLOCK) {
      const int i = e / SC, c = e % SC;
      const int32_t d = a.dom_ic[e];
      int32_t r = 0;
      for (int i2 = 0; i2 < i; ++i2)
        r += a.gate[i2 * SC + c] && a.dom_ic[i2 * SC + c] == d;
      a.newcnt[e] = v.f_cnt[(int64_t)c * NN + a.node_i[i]] + r + 1;
    }
    // a domain id IS the index of one of its nodes: mark the domains with
    // an eligible member, read their counts at that slot
    for (int64_t e = threadIdx.x; e < (int64_t)SC * N; e += BLOCK)
      if (v.f_elig[e])
        a.elig_dom[(e / N) * NN + v.f_dom[e]] = 1;
    __syncthreads();
    // d_need[c, m]: eligible domains still below min0 + m + 1
    for (int64_t e = threadIdx.x; e < (int64_t)SC * N; e += BLOCK) {
      if (!a.elig_dom[e]) continue;
      const int c = (int)(e / N);
      int64_t m0 = (int64_t)v.f_cnt[e] - minv[c];
      for (int64_t m = m0 < 0 ? 0 : m0; m < KT_M_CAP; ++m)
        atomicAdd(&d_need[c * KT_M_CAP + m], 1);
    }
    __syncthreads();
    // the level climb: cum_excl over the speculated sequence vs d_need
    for (int t = threadIdx.x; t < SC * KT_M_CAP; t += BLOCK) {
      const int c = t / KT_M_CAP, m = t % KT_M_CAP;
      const int32_t lvl = (int32_t)((uint32_t)minv[c] + (uint32_t)(m + 1));
      const int32_t need = d_need[t];
      int32_t cum = 0;
      for (int i = 0; i < Lw; ++i) {
        if (cum >= need) atomicOr(&a.lvlmask[i * SC + c], 1u << m);
        cum += a.gate[i * SC + c] && a.newcnt[i * SC + c] == lvl;
      }
    }
    __syncthreads();
  }

  // 8. conflict cuts and the conflict-free prefix
  int64_t first_viol = Lw;
  for (int i = threadIdx.x; i < Lw; i += BLOCK) {
    if (i >= nsel) continue;
    bool viol = false;
    if (a.fam.spr_f) {
      for (int c = 0; c < SC; ++c) {
        const int e = i * SC + c;
        if (!v.f_act[c] || !a.gate[e]) continue;
        const int32_t up = __popc(a.lvlmask[e]);
        const int32_t min_i = v.f_minz[c] ? 0 : (int32_t)((uint32_t)minv[c]
                                                         + (uint32_t)up);
        if ((int64_t)a.newcnt[e] + v.f_self[c] - min_i > v.f_skew[c]
            || up >= KT_M_CAP)
          viol = true;
      }
    }
    if (a.anti_term >= 0) {
      // a keyless node hides its deeper entries from the jcap = 1 merge
      viol = viol || atv[a.node_i[i]] == 0;
    } else {
      // depth cut: a candidate consuming its last matrix entry
      viol = viol || a.j_i[i] == J - 1;
    }
    if (viol && i < first_viol) first_viol = i;
  }
  first_viol = block_min<BLOCK>(first_viol, sh);
  const bool iter_ok = mono_ok && flat && start_inert;
  // accept = sel_ok & (no violation strictly before i)
  const int acc = !iter_ok ? 0
      : (int)(first_viol + 1 < nsel ? first_viol + 1 : nsel);

  // 9. fold the accepted prefix into the loop state
  for (int n = threadIdx.x; n < N; n += BLOCK) a.cnt_add[n] = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < acc; i += BLOCK) {
    atomicAdd(&a.cnt_add[a.node_i[i]], 1);
    a.packed[ctl.done + i] = a.node_i[i];
  }
  __syncthreads();
  for (int n = threadIdx.x; n < N; n += BLOCK) {
    const int32_t c = a.cnt_add[n];
    if (c == 0) continue;
    int64_t* u = a.used + (int64_t)n * R;
    for (int r = 0; r < R; ++r) u[r] += (int64_t)c * p.req[r];
    a.nonzero_used[(int64_t)n * 2] += (int64_t)c * p.nonzero_req[0];
    a.nonzero_used[(int64_t)n * 2 + 1] += (int64_t)c * p.nonzero_req[1];
    a.npods[n] += c;
    a.cnt_n[n] += c;
  }
  if (a.fam.spr_f) {
    for (int c = 0; c < SC; ++c) {
      if (!mf_self[c]) continue;
      const int64_t b = (int64_t)c * NN;
      block_dom_share<BLOCK>(
          v.f_tv + b, v.f_dom + b, N, a.seg,
          [&](int n) { return (int64_t)(v.f_elig[b + n] ? a.cnt_add[n] : 0); },
          [&](int n, int64_t x) { a.f_cnt[b + n] += (int32_t)x; });
    }
  }
  if (a.fam.ipa_anti) {
    const uint8_t* mex = a.g.m_ipa_exist + ((int64_t)wt * a.g.U + wt) * TAA;
    const uint8_t* maa = a.g.m_ipa_aa + ((int64_t)wt * a.g.U + wt) * TAA;
    for (int t = 0; t < TAA; ++t) {
      if (!mex[t] && !maa[t]) continue;
      const int64_t b = ((int64_t)wt * TAA + t) * NN;
      block_dom_share<BLOCK>(
          a.g.ipa_raa_tv + b, a.g.ipa_raa_dom + b, N, a.seg,
          [&](int n) { return (int64_t)a.cnt_add[n]; },
          [&](int n, int64_t x) {
            if (mex[t]) a.veto[n] += (int32_t)x;
            if (maa[t]) a.aa_cnt[(int64_t)t * NN + n] += (int32_t)x;
          });
    }
  }
  if (threadIdx.x == 0) {
    ctl.confs += (acc < avail && iter_ok) ? 1 : 0;
    if (ctl.waves == 0) ctl.first = acc;
    ctl.waves += 1;
    ctl.done += acc;
    ctl.prog = acc > 0;
    ctl.ok = ctl.ok && iter_ok;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(BLOCK) run_wave_kernel(WaveArgs a) {
  __shared__ BlockScratch<BLOCK> sh;
  __shared__ int32_t minv[KT_MAX_SC];
  __shared__ int32_t d_need[KT_MAX_SC * KT_M_CAP];
  __shared__ Ctl ctl;
  const int N = a.na.N, SC = a.g.SC, TAA = a.g.TAA;
  const int64_t NN = N;
  const int wt = a.wt;
  const PodRowD p = pod_row(a.tb, wt);

  // loop state: the own-row counters, the output prefix
  for (int64_t e = threadIdx.x; e < (int64_t)SC * N; e += BLOCK)
    a.f_cnt[e] = a.gin.spr_f_cnt[(int64_t)wt * SC * NN + e];
  for (int64_t e = threadIdx.x; e < (int64_t)TAA * N; e += BLOCK)
    a.aa_cnt[e] = a.gin.ipa_aa_cnt[(int64_t)wt * TAA * NN + e];
  for (int n = threadIdx.x; n < N; n += BLOCK) {
    a.veto[n] = a.gin.ipa_veto[(int64_t)wt * NN + n];
    a.cnt_n[n] = 0;
  }
  int64_t w_part = 0;
  for (int b = threadIdx.x; b < a.B; b += BLOCK) {
    a.packed[b] = -1;
    w_part += a.valid[b] != 0;
  }
  const int W = (int)block_sum<BLOCK>(w_part, sh);
  if (threadIdx.x == 0) {
    ctl.done = 0;
    ctl.prog = 1;
    ctl.ok = 1;
    ctl.waves = 0;
    ctl.confs = 0;
    ctl.first = -1;
    ctl.steps = 0;
  }
  GViewD v = view_of(a.g, a.gin, wt);
  v.f_cnt = a.f_cnt;
  v.veto = a.veto;
  v.aa_cnt = a.aa_cnt;
  __syncthreads();

  // merge tier: gated entirely by merge_on and a static normalization
  if (a.merge_on && !a.norm_live) {
    while (ctl.ok && ctl.prog && ctl.done < W)
      merge_wave(a, v, p, W, ctl, minv, d_need, sh);
  }

  // serial tier
  const uint8_t* mf_self = a.g.m_spr_f + ((int64_t)wt * a.g.U + wt) * SC;
  const uint8_t* mex = a.g.m_ipa_exist + ((int64_t)wt * a.g.U + wt) * TAA;
  const uint8_t* maa = a.g.m_ipa_aa + ((int64_t)wt * a.g.U + wt) * TAA;
  while (ctl.done < W) {
    wave_eval(a, v, p, minv, sh);
    int64_t bv = KT_I64_MIN;
    int32_t bi = 0x7fffffff;
    for (int n = threadIdx.x; n < N; n += BLOCK)
      argmax_merge(bv, bi, a.masked[n], n);
    block_argmax<BLOCK>(bv, bi, sh);
    if (bv < 0) {
      // the state is unchanged: every remaining pod fails the same way
      if (threadIdx.x == 0) {
        ctl.steps += W - ctl.done;
        ctl.done = W;
      }
      __syncthreads();
      break;
    }
    const int best = bi;
    if (threadIdx.x == 0) {
      int64_t* u = a.used + (int64_t)best * a.na.R;
      for (int r = 0; r < a.na.R; ++r) u[r] += p.req[r];
      a.nonzero_used[(int64_t)best * 2] += p.nonzero_req[0];
      a.nonzero_used[(int64_t)best * 2 + 1] += p.nonzero_req[1];
      a.npods[best] += 1;
      a.cnt_n[best] += 1;
      a.packed[ctl.done] = best;
    }
    if (a.fam.spr_f) {
      for (int64_t e = threadIdx.x; e < (int64_t)SC * N; e += BLOCK) {
        const int64_t c = e / N;
        const int32_t tvb = v.f_tv[c * NN + best];
        if (mf_self[c] && v.f_elig[c * NN + best] && tvb != 0
            && v.f_tv[e] == tvb)
          a.f_cnt[e] += 1;
      }
    }
    if (a.fam.ipa_anti) {
      for (int n = threadIdx.x; n < N; n += BLOCK) {
        for (int t = 0; t < TAA; ++t) {
          const int32_t* tv = a.g.ipa_raa_tv + ((int64_t)wt * TAA + t) * NN;
          if (tv[best] == 0 || tv[n] != tv[best]) continue;
          if (mex[t]) a.veto[n] += 1;
          if (maa[t]) a.aa_cnt[(int64_t)t * NN + n] += 1;
        }
      }
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      ctl.done += 1;
      ctl.steps += 1;
    }
    __syncthreads();
  }

  block_wave_fold<BLOCK>(a.g, a.gout, a.fam, wt, a.cnt_n, a.seg, sh);
  if (threadIdx.x == 0) {
    a.packed[a.B] = ctl.waves;
    a.packed[a.B + 1] = ctl.confs;
    a.packed[a.B + 2] = ctl.first;
    a.packed[a.B + 3] = ctl.steps;
  }
}

}  // namespace

extern "C" int ktpu_run_wave(const WaveArgs* args, void* stream) {
  run_wave_kernel<<<1, BLOCK, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}
