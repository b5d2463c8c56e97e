// run_plan: the drain compiler's plan program — one mixed-signature span
// (group rows, group-free rows, host-port rows) in one launch.
//
// Replaces kubernetes_tpu/ops/program.py run_plan (:1608; the jit
// _run_plan_fn :1597) and run_wave_scan (:1570; _run_wave_scan_fn
// :1563), both over _run_wave_scan_impl (:1259-1560), with its loop state
// _WaveState (:1233) and wave_fold (ops/groups.py :1215) for the span's
// rows.
//
//   Phase A (:1334-1454): the fit surfaces (fit_mask, LeastAllocated,
//     Balanced) of the S slots at the pre-span carry, the slots' group
//     counters gathered from the carry, and each slot's speculative
//     argmax (first maximum of where(feasible, total, -1), -1 when
//     nothing is feasible).
//   Phase B (:1456-1552), one step per pod in serial order: the slot's
//     feasibility (hoisted static mask & maintained fit surface, & the
//     live ports mask with has_ports, & the group mask with has_groups,
//     the spread minimum re-reduced every step), DefaultNormalize of the
//     raw taint / preferred-affinity counts over the feasible set (or the
//     constant w_taint·100 without norm_live), the f64 Balanced term, the
//     group scores, the first-max argmax; then, when placed, the carry
//     rows, the fit surfaces of ALL S slots at the touched node
//     (_row_refresh semantics), the group counters of all S consumer
//     slots (f_cnt, s_cnt, veto, aa_cnt, a_cnt, a_total int64, iscore
//     int64), the per-slot placement counts, the ports row; and the
//     conflict / prefix stats against the speculative choice.
//   Epilogue (:1554-1560): wave_fold of the placement counts into the
//     fresh group carry, once per distinct row (a padded duplicate slot's
//     counts are zero).
//
// What bounds it on an H100: Phase B is a chain of W dependent steps —
// step k+1 reads the counters step k wrote — each a few passes over the
// node axis and a dozen block-wide reductions, on well under a megabyte
// of L2-resident state. The bound is latency (barriers and the dependent
// chain), not bytes or operations.
//
// Design: ONE persistent single-block launch per span (like run_batch.cu
// and run_wave.cu), so no step costs a host round trip and every
// reduction is a block reduction (warp shuffles plus shared memory).
// 1,024 threads own the node axis (node n belongs to thread n % 1024).
// The group counter updates test each (slot, term) gate once at the
// chosen node and sweep the node axis only for the pairs that increment,
// each element written by the thread that owns its node; the epilogue
// reuses group_eval.cuh's block_wave_fold. A multi-block cooperative launch would split each pass
// over more SMs but add a grid-wide barrier per reduction (a dozen per
// step); it is left for when plan spans carry load. The wrapper hands the
// kernel fresh copies of every carry field it writes.

#include "group_eval.cuh"

#define KT_PLAN_MAX_S 32

// the kernel's arguments, mirrored field for field by ctypes
// (ops/kernels.py PlanArgsC)
struct PlanArgs {
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
  int32_t* ports;         // [N, P] fresh copy (has_ports only)
  int32_t P;
  const uint8_t* m0;      // stacked wave_statics, [S, N] each
  const int64_t* taint_raw;
  const int64_t* na_raw;
  const int64_t* s_img;
  const uint8_t* valid;   // [W]
  const int32_t* widx;    // [W] slot of each pod
  int32_t wt[KT_PLAN_MAX_S];
  int32_t S, W, norm_live, has_groups, has_ports;
  int64_t w_spread, w_ipa;
  // loop state (scratch)
  uint8_t* fit_ok;        // [S, N]
  int64_t* s_fit;         // [S, N]
  int64_t* s_bal;         // [S, N]
  int32_t* f_cnt;         // [S, SC, N]
  int32_t* s_cnt;         // [S, SC, N]
  int32_t* veto;          // [S, N]
  int32_t* a_cnt;         // [S, TA, N]
  int64_t* a_total;       // [S]
  int32_t* aa_cnt;        // [S, TAA, N]
  int64_t* iscore;        // [S, N]
  int32_t* cnt_sn;        // [S, N] accepted placements (fold input)
  // evaluation scratch
  uint8_t* feas;          // [N]
  int64_t* gsc;           // [N] weighted group scores
  int32_t* flags;         // [SC, N] spread domain flags
  int64_t* seg;           // [N] domain segments (wave_fold)
  int32_t* packed;        // [W + 2]
};

namespace {

constexpr int BLOCK = 1024;

struct Ctl {              // step control, shared by the block
  int32_t spec[KT_PLAN_MAX_S];
  int32_t clean, n_conf, prefix;
};

// the group view of slot w over the loop state's counters
__device__ GViewD slot_view(const PlanArgs& a, int w) {
  const int64_t N = a.na.N, SC = a.g.SC, TA = a.g.TA, TAA = a.g.TAA;
  GViewD v = view_of(a.g, a.gin, a.wt[w]);
  v.f_cnt = a.f_cnt + w * SC * N;
  v.s_cnt = a.s_cnt + w * SC * N;
  v.veto = a.veto + w * N;
  v.a_cnt = a.a_cnt + w * TA * N;
  v.a_total = a.a_total[w];
  v.aa_cnt = a.aa_cnt + w * TAA * N;
  v.iscore = a.iscore + w * N;
  return v;
}

// _eval (:1384-1430) of slot w at the loop state and its first-max
// argmax: *best_v = max of where(feasible, total, -1), *best_i its lowest
// index. Starts and ends with a barrier.
__device__ void plan_eval(const PlanArgs& a, int w, int32_t* minv,
                          BlockScratch<BLOCK>& sh, int64_t* best_v,
                          int32_t* best_i) {
  const int N = a.na.N;
  const int64_t NN = N;
  __syncthreads();
  const PodRowD p = pod_row(a.tb, a.wt[w]);
  GViewD v;
  if (a.has_groups) {
    v = slot_view(a, w);
    if (a.fam.spr_f) block_spread_min<BLOCK>(v, minv, sh);
  }
  const uint8_t* m0 = a.m0 + w * NN;
  const uint8_t* fit = a.fit_ok + w * NN;
  const int64_t* traw = a.taint_raw + w * NN;
  const int64_t* nraw = a.na_raw + w * NN;
  int64_t tm = 0, nm = 0;
  for (int n = threadIdx.x; n < N; n += BLOCK) {
    bool f = m0[n] && fit[n];
    if (f && a.has_ports)
      f = kt_ports_ok(a.ports + (int64_t)n * a.P, a.P, p.port_ids, a.tb.PP);
    if (f && a.has_groups) f = kt_group_mask(v, a.fam, n, minv);
    a.feas[n] = f;
    if (a.norm_live && f) {
      tm = traw[n] > tm ? traw[n] : tm;
      nm = nraw[n] > nm ? nraw[n] : nm;
    }
  }
  int64_t tmax = 0, namax = 0;
  if (a.norm_live) {
    tmax = block_max<BLOCK>(tm, sh);
    namax = block_max<BLOCK>(nm, sh);
  }
  const bool gs = a.has_groups && (a.fam.spr_s || a.fam.ipa_score);
  if (gs)
    block_group_scores<BLOCK>(v, a.fam, a.w_spread, a.w_ipa, a.feas,
                              a.flags, a.gsc, sh);
  const CfgC& cfg = a.cfg;
  const int64_t* sfit = a.s_fit + w * NN;
  const int64_t* sbal = a.s_bal + w * NN;
  const int64_t* simg = a.s_img + w * NN;
  int64_t bv = KT_I64_MIN;
  int32_t bi = 0x7fffffff;
  for (int n = threadIdx.x; n < N; n += BLOCK) {
    int64_t val = -1;
    if (a.feas[n]) {
      const int64_t tn = a.norm_live
          ? cfg.w_taint * kt_normalize(traw[n], tmax, true)
            + cfg.w_node_affinity * kt_normalize(nraw[n], namax, false)
          : cfg.w_taint * KT_MAX_SCORE;
      val = cfg.w_fit * sfit[n] + cfg.w_balanced * sbal[n] + tn
            + cfg.w_image * simg[n] + (gs ? a.gsc[n] : 0);
    }
    argmax_merge(bv, bi, val, n);
  }
  block_argmax<BLOCK>(bv, bi, sh);
  *best_v = bv;
  *best_i = bi;
}

// the group counter increments of placing slot w on node `best`, over
// the S consumer slots (:1468-1517). The gates of each (slot, term) pair
// read only the chosen node, so they are the same in every thread and
// the node loops run only where an increment can land; thread n % BLOCK
// owns node n in every loop, so each counter element is written by one
// thread. Ends with a barrier.
__device__ void plan_group_update(const PlanArgs& a, int w, int best) {
  const GroupsC& g = a.g;
  const int N = g.N;
  const int64_t NN = N, U = g.U, SC = g.SC, TA = g.TA, TAA = g.TAA;
  const int64_t CT = g.CT, PT = g.PT;
  const int64_t up = a.wt[w];   // placed row
  for (int s = 0; s < a.S; ++s) {
    const int64_t r = a.wt[s];  // consumer row
    if (a.fam.spr_f) {
      for (int64_t c = 0; c < SC; ++c) {
        const int64_t b = (r * SC + c) * NN;
        const int32_t* tv = g.spr_f_tv + b;
        const int32_t tvb = tv[best];
        if (!g.m_spr_f[(up * U + r) * SC + c] || !g.spr_f_elig[b + best]
            || tvb == 0)
          continue;
        int32_t* dst = a.f_cnt + ((int64_t)s * SC + c) * NN;
        for (int n = threadIdx.x; n < N; n += BLOCK)
          if (tv[n] == tvb) dst[n] += 1;
      }
    }
    if (a.fam.spr_s) {
      for (int64_t c = 0; c < SC; ++c) {
        if (!g.m_spr_s[(up * U + r) * SC + c]) continue;
        const int64_t b = (r * SC + c) * NN;
        int32_t* dst = a.s_cnt + ((int64_t)s * SC + c) * NN;
        if (g.spr_s_is_host[r * SC + c]) {
          // hostname constraints count the chosen node's own pods
          if ((int)threadIdx.x == best % BLOCK) dst[best] += 1;
          continue;
        }
        const int32_t* tv = g.spr_s_tv + b;
        const int32_t tvb = tv[best];
        if (!g.spr_s_elig[b + best] || tvb == 0) continue;
        for (int n = threadIdx.x; n < N; n += BLOCK)
          if (tv[n] == tvb) dst[n] += 1;
      }
    }
    if (a.fam.ipa_anti) {
      // existing-anti veto: the placed row's own anti terms
      for (int64_t t = 0; t < TAA; ++t) {
        const int32_t* tv = g.ipa_raa_tv + (up * TAA + t) * NN;
        const int32_t tvb = tv[best];
        if (!g.m_ipa_exist[(up * U + r) * TAA + t] || tvb == 0) continue;
        int32_t* dst = a.veto + (int64_t)s * NN;
        for (int n = threadIdx.x; n < N; n += BLOCK)
          if (tv[n] == tvb) dst[n] += 1;
      }
      // incoming-anti counts, along the consumer's term topology
      for (int64_t t = 0; t < TAA; ++t) {
        const int32_t* tv = g.ipa_raa_tv + (r * TAA + t) * NN;
        const int32_t tvb = tv[best];
        if (!g.m_ipa_aa[(up * U + r) * TAA + t] || tvb == 0) continue;
        int32_t* dst = a.aa_cnt + ((int64_t)s * TAA + t) * NN;
        for (int n = threadIdx.x; n < N; n += BLOCK)
          if (tv[n] == tvb) dst[n] += 1;
      }
    }
    if (a.fam.ipa_req && g.m_ipa_a[up * U + r]) {
      int64_t k = 0;
      for (int64_t t = 0; t < TA; ++t) {
        const int32_t* tv = g.ipa_ra_tv + (r * TA + t) * NN;
        const int32_t tvb = tv[best];
        if (!g.ipa_ra_active[r * TA + t] || tvb == 0) continue;
        ++k;
        int32_t* dst = a.a_cnt + ((int64_t)s * TA + t) * NN;
        for (int n = threadIdx.x; n < N; n += BLOCK)
          if (tv[n] == tvb) dst[n] += 1;
      }
      if (threadIdx.x == 0) a.a_total[s] += k;   // int64
    }
    if (a.fam.ipa_score) {
      int64_t* dst = a.iscore + (int64_t)s * NN;
      // consumer-side preferred terms matching the placed pod
      for (int64_t t = 0; t < CT; ++t) {
        const int64_t wgt = g.w_stc[(up * U + r) * CT + t];
        const int32_t* tv = g.ipa_stc_tv + (r * CT + t) * NN;
        const int32_t tvb = tv[best];
        if (wgt == 0 || tvb == 0) continue;
        for (int n = threadIdx.x; n < N; n += BLOCK)
          if (tv[n] == tvb) dst[n] += wgt;
      }
      // placed-side terms matching the consumer
      for (int64_t t = 0; t < PT; ++t) {
        const int64_t wgt = g.w_stp[(up * U + r) * PT + t];
        const int32_t* tv = g.ipa_stp_tv + (up * PT + t) * NN;
        const int32_t tvb = tv[best];
        if (wgt == 0 || tvb == 0) continue;
        for (int n = threadIdx.x; n < N; n += BLOCK)
          if (tv[n] == tvb) dst[n] += wgt;
      }
    }
  }
  if (threadIdx.x == 0) a.cnt_sn[(int64_t)w * NN + best] += 1;
  __syncthreads();
}

__global__ void __launch_bounds__(BLOCK) run_plan_kernel(PlanArgs a) {
  __shared__ BlockScratch<BLOCK> sh;
  __shared__ int32_t minv[KT_MAX_SC];
  __shared__ Ctl ctl;
  const int N = a.na.N, R = a.na.R, S = a.S;
  const int64_t NN = N;
  const CfgC& cfg = a.cfg;

  // ---- Phase A: fit surfaces of every slot at the input carry
  for (int64_t e = threadIdx.x; e < (int64_t)S * N; e += BLOCK) {
    const int s = (int)(e / NN), n = (int)(e % NN);
    const PodRowD p = pod_row(a.tb, a.wt[s]);
    const int64_t* used_row = a.used + (int64_t)n * R;
    int64_t s_fit, s_bal;
    kt_fit_scores(cfg, a.na, n, used_row, a.nonzero_used + (int64_t)n * 2,
                  p, &s_fit, &s_bal);
    a.fit_ok[e] = kt_fit(a.na, n, used_row, a.npods[n], p);
    a.s_fit[e] = s_fit;
    a.s_bal[e] = s_bal;
  }
  // the slots' group counters, gathered from the carry
  if (a.has_groups) {
    const GroupsC& g = a.g;
    const int64_t SC = g.SC, TA = g.TA, TAA = g.TAA;
    for (int64_t e = threadIdx.x; e < S * SC * NN; e += BLOCK) {
      const int64_t s = e / (SC * NN), r = e % (SC * NN);
      const int64_t src = (int64_t)a.wt[s] * SC * NN + r;
      a.f_cnt[e] = a.gin.spr_f_cnt[src];
      a.s_cnt[e] = a.gin.spr_s_cnt[src];
    }
    for (int64_t e = threadIdx.x; e < S * TA * NN; e += BLOCK) {
      const int64_t s = e / (TA * NN), r = e % (TA * NN);
      a.a_cnt[e] = a.gin.ipa_a_cnt[(int64_t)a.wt[s] * TA * NN + r];
    }
    for (int64_t e = threadIdx.x; e < S * TAA * NN; e += BLOCK) {
      const int64_t s = e / (TAA * NN), r = e % (TAA * NN);
      a.aa_cnt[e] = a.gin.ipa_aa_cnt[(int64_t)a.wt[s] * TAA * NN + r];
    }
    for (int64_t e = threadIdx.x; e < S * NN; e += BLOCK) {
      const int64_t s = e / NN, n = e % NN;
      a.veto[e] = a.gin.ipa_veto[(int64_t)a.wt[s] * NN + n];
      a.iscore[e] = a.gin.ipa_score[(int64_t)a.wt[s] * NN + n];
      a.cnt_sn[e] = 0;
    }
    if ((int)threadIdx.x < S) a.a_total[threadIdx.x] = a.gin.ipa_a_total[
        a.wt[threadIdx.x]];
  }
  // the speculative choice of every slot (plan_eval starts with the
  // barrier that publishes the surfaces above)
  for (int s = 0; s < S; ++s) {
    int64_t bv;
    int32_t bi;
    plan_eval(a, s, minv, sh, &bv, &bi);
    if (threadIdx.x == 0) ctl.spec[s] = bv >= 0 ? bi : -1;
  }
  if (threadIdx.x == 0) {
    ctl.clean = 1;
    ctl.n_conf = 0;
    ctl.prefix = 0;
  }

  // ---- Phase B: the exact serial replay
  for (int k = 0; k < a.W; ++k) {
    const int w = a.widx[k];
    const bool vld = a.valid[k] != 0;
    int64_t bv;
    int32_t bi;
    plan_eval(a, w, minv, sh, &bv, &bi);
    const int best = bi;
    const bool assigned = bv >= 0 && vld;
    if (assigned) {
      const PodRowD p = pod_row(a.tb, a.wt[w]);
      int64_t* used_row = a.used + (int64_t)best * R;
      int64_t* nz_row = a.nonzero_used + (int64_t)best * 2;
      if (threadIdx.x == 0) {
        for (int r = 0; r < R; ++r) used_row[r] += p.req[r];
        nz_row[0] += p.nonzero_req[0];
        nz_row[1] += p.nonzero_req[1];
        a.npods[best] += 1;
        if (a.has_ports) {
          // the pod's port ids into the first free slots of the row
          bool any_port = false;
          for (int q = 0; q < a.tb.PP; ++q)
            any_port = any_port || p.port_ids[q];
          if (any_port) {
            int32_t* row = a.ports + (int64_t)best * a.P;
            int rank = 0;
            for (int slot = 0; slot < a.P; ++slot) {
              if (row[slot] != 0) continue;
              row[slot] = rank < a.tb.PP ? p.port_ids[rank] : 0;
              ++rank;
            }
          }
        }
      }
      __syncthreads();
      // refresh the fit surfaces of every slot at the touched node
      if ((int)threadIdx.x < S) {
        const int s = threadIdx.x;
        const PodRowD ps = pod_row(a.tb, a.wt[s]);
        int64_t s_fit, s_bal;
        kt_fit_scores(cfg, a.na, best, used_row, nz_row, ps, &s_fit, &s_bal);
        a.fit_ok[s * NN + best] = kt_fit(a.na, best, used_row,
                                         a.npods[best], ps);
        a.s_fit[s * NN + best] = s_fit;
        a.s_bal[s * NN + best] = s_bal;
      }
      if (a.has_groups) plan_group_update(a, w, best);
    }
    if (threadIdx.x == 0) {
      const int32_t y = assigned ? best : -1;
      const bool conflict = vld && y != ctl.spec[w];
      ctl.prefix += ctl.clean && vld && !conflict;
      ctl.clean = ctl.clean && !conflict;
      ctl.n_conf += conflict;
      a.packed[k] = y;
    }
  }
  __syncthreads();

  // ---- epilogue: fold the placements into the fresh group carry
  if (a.has_groups) {
    for (int s = 0; s < S; ++s) {
      bool dup = false;
      for (int q = 0; q < s; ++q) dup = dup || a.wt[q] == a.wt[s];
      if (dup) continue;   // a padded duplicate slot placed nothing
      block_wave_fold<BLOCK>(a.g, a.gout, a.fam, a.wt[s],
                             a.cnt_sn + (int64_t)s * NN, a.seg, sh);
    }
  }
  if (threadIdx.x == 0) {
    a.packed[a.W] = ctl.n_conf;
    a.packed[a.W + 1] = ctl.prefix;
  }
}

}  // namespace

extern "C" int ktpu_run_plan(const PlanArgs* args, void* stream) {
  run_plan_kernel<<<1, BLOCK, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}
