// run_plan_sharded: the drain compiler's plan program over the node-sharded
// mesh — one mixed-signature span (group rows, group-free rows, host-port
// rows), its node axis split into shards.
//
// Replaces kubernetes_tpu/parallel/sharding.py run_plan_sharded (:867;
// the jit :841) over its SPMD body _plan_local (:563-837): the plan
// program of run_plan.cu with every per-step argmax a global first max,
// every read of the chosen node's row an owner broadcast (`own`,
// :638-643), and the group normalizers and the spread minimum exchanged.
//
// Two placements, two implementations:
//
// Every shard on one card (ops/kernels.py plan_sharded_placement "one"):
// ONE cooperative launch a span (ktpu_plan_span_grid), the body of
// plan_span.cuh over D shards. The grid is D teams of T blocks of
// KT_PLAN_BLOCK (512) threads, T = ceil(n_local / 512), block b in shard
// b / T; each block owns a contiguous range of its shard's rows. Each exchange of the
// chain below becomes one grid-wide reduction: every block writes its
// part into its slot of a [2, D·T, 8] buffer, grid.sync, and each
// block's warp 0 folds the slots (summed or maxed as `exchange` does),
// the two halves alternating by reduction. The owner broadcast needs no exchange: the
// chosen node's topology values are read from the owning shard's static
// arrays, which lie on the same card. Nothing reads back to the host
// between evaluations. A shard's team is its T blocks of the grid: a
// cluster of CTAs a shard inside the cooperative grid would add a
// cluster barrier to every grid barrier, since the fold spans the shards.
//
// Shards on several cards ("cards"): a launch cannot wait on another
// card's launch, so each step is a chain of launches per shard with the
// exchange (kubernetes_tpu_torch/parallel/sharding.py) between them; the
// wrapper (ops/kernels.py run_plan_sharded_cuda) drives it from the host
// without reading anything back:
//   init (one block a shard): the fit surfaces of the S slots at the
//     pre-span carry (Phase A, :586-592) and the step control;
//   per evaluation of slot w — the S speculative choices of Phase A
//     (spec_one, :686-693), then one per pod of Phase B (:697-822):
//     min    (group rows with DoNotSchedule terms): the shard's spread
//            minima, negated → exchange (max);
//     eval   the feasible set (hoisted static mask & the slot's fit
//            surface, & the live ports mask, & the group mask with the
//            global minima), its normalization maxima (norm_live) and the
//            group score partials: the scored-node count and the
//            [SC, n_global] domain flags (summed: the domain ids are
//            GLOBAL), the score surface's range → exchange;
//     raw    (ScheduleAnyway rows): the raw spread scores weighted from
//            the summed count and flags, their range → exchange (max);
//     select the totals and the shard's first max as one int64 key
//            ((score + 1) << 32) | (INT32_MAX - global index) → exchange
//            (max): the JAX program's pmax of the score, then pmin of the
//            index;
//     apply  a speculative choice records the slot's spec; a pod step
//            places on the owning shard (the carry rows, the fit surfaces
//            of all S slots at the row, the ports row), counts the
//            conflict and prefix against the spec on every shard, and the
//            owner writes the chosen node's topology values into the own
//            vector → exchange (sum);
//     update (group rows): every shard adds the increments to its slice
//            of the group counts.
//   Epilogue: the JAX program folds the span's placement counts into the
//   full group carry with wave_fold (n_seg = n_global, its segments
//   psum'd); this kernel applies group_update's increments to the full
//   carry at every placement instead — the same integer adds, so the
//   same counts — and the slots' views read the carry rows directly.
//   cache.sig is zeroed (the wrapper's output carry).
//
// Arithmetic: as run_plan.cu — int64 scores and counts of the score
// surface and a_total, the spread weight's log from libdevice, built
// with --fmad=false.
//
// What bounds it on an H100: the dependent chain of S + W evaluations,
// each moving well under a megabyte: latency, not bytes or operations. On
// one card that is one to five grid barriers an evaluation (the
// reductions of the active families only). On several cards each
// evaluation is 4 to 6 launches a shard and up to five exchanges; that
// chain keeps every launch to one block a shard, so a launch is a few
// microseconds of work, and skips the launches and exchanges of the
// inactive families (the minima without DoNotSchedule terms, the raw
// pass without ScheduleAnyway terms, the own vector and the update on a
// group-free span).

#include "plan_span.cuh"

// one shard's arguments, mirrored field for field by ctypes
// (ops/kernels.py PlanShardC)
struct PlanShardC {
  NodeC na;
  TableC tb;
  CfgC cfg;
  GroupsC g;              // the shard's GroupsDev
  GCarryC gc;             // the output group counts, written in place
  FamC fam;
  int64_t* used;          // [N, R] fresh copies: the loop state
  int64_t* nonzero_used;  // [N, 2]
  int32_t* npods;         // [N]
  int32_t* ports;         // [N, P] fresh copy (has_ports only)
  int32_t P;
  const uint8_t* m0;      // the shard's stacked surfaces, [S, N] each
  const int64_t* taint_raw;
  const int64_t* na_raw;
  const int64_t* s_img;
  const uint8_t* valid;   // [W] replicated
  const int32_t* widx;    // [W] slot of each pod
  int32_t wt[KT_PLAN_MAX_S];
  int32_t S, W, norm_live, has_groups, has_ports;
  int64_t w_spread, w_ipa;
  int32_t offset;         // global index of the shard's row 0
  int32_t n_global;       // rows over all shards
  uint8_t* fit_ok;        // [S, N] the slots' fit surfaces
  int64_t* s_fit;         // [S, N]
  int64_t* s_bal;         // [S, N]
  uint8_t* feas;          // [N] the evaluation's feasible set
  int64_t* gsc;           // [N] its raw spread scores
  int64_t* loc1;          // [SC] the spread minima, negated
  int64_t* loc2;          // [1 + SC·n_global + 4]: npart, flags | tmax,
                          //   namax, -lo, hi
  int64_t* loc3;          // [2]: -rmin, rmax
  int64_t* key;           // [1] the shard's packed first max
  int64_t* own;           // [_own_len] the chosen node's values
  int32_t* ctl;           // [KT_PLAN_MAX_S + 3]: spec, clean, n_conf, prefix
  int32_t* packed;        // [W + 2] (shard 0), else nullptr
};

namespace {

constexpr int BLOCK = 1024;

// the slot an evaluation reads: `spec` for a speculative choice of Phase
// A, else pod k's slot (read on the device: no readback drives the chain)
__device__ __forceinline__ int slot_of(const PlanShardC& a, int k, int spec) {
  return spec >= 0 ? spec : a.widx[k];
}

__device__ __forceinline__ int64_t flag_w(const PlanShardC& a) {
  return 1 + (a.has_groups ? (int64_t)a.g.SC * a.n_global : 0);
}

// decode an exchanged key: (gscore, global index)
__device__ __forceinline__ void unkey(int64_t k, int64_t* gscore,
                                      int32_t* gbest) {
  *gscore = (k >> 32) - 1;
  *gbest = 0x7fffffff - (int32_t)(k & 0xffffffffLL);
}

__global__ void __launch_bounds__(BLOCK) plan_init_kernel(PlanShardC a) {
  const int N = a.na.N, S = a.S;
  const int64_t NN = N;
  for (int64_t e = threadIdx.x; e < (int64_t)S * N; e += BLOCK) {
    const int s = (int)(e / NN), n = (int)(e % NN);
    const PodRowD p = pod_row(a.tb, a.wt[s]);
    const int64_t* used_row = a.used + (int64_t)n * a.na.R;
    int64_t s_fit, s_bal;
    kt_fit_scores(a.cfg, a.na, n, used_row, a.nonzero_used + (int64_t)n * 2,
                  p, &s_fit, &s_bal);
    a.fit_ok[e] = kt_fit(a.na, n, used_row, a.npods[n], p);
    a.s_fit[e] = s_fit;
    a.s_bal[e] = s_bal;
  }
  if (threadIdx.x == 0) {
    a.ctl[KT_PLAN_MAX_S] = 1;        // clean
    a.ctl[KT_PLAN_MAX_S + 1] = 0;    // n_conf
    a.ctl[KT_PLAN_MAX_S + 2] = 0;    // prefix
  }
}

__global__ void __launch_bounds__(BLOCK)
plan_min_kernel(PlanShardC a, int k, int spec) {
  __shared__ BlockScratch<BLOCK> sh;
  const int w = slot_of(a, k, spec);
  block_spread_min_local<BLOCK>(view_of(a.g, a.gc, a.wt[w]), a.loc1, true,
                                sh);
}

__global__ void __launch_bounds__(BLOCK)
plan_eval_kernel(PlanShardC a, int k, int spec, const int64_t* glob1) {
  __shared__ BlockScratch<BLOCK> sh;
  const int w = slot_of(a, k, spec);
  __shared__ int32_t minv[KT_MAX_SC];
  const int N = a.na.N;
  const int64_t NN = N, W = flag_w(a);
  const PodRowD p = pod_row(a.tb, a.wt[w]);
  GViewD v;
  if (a.has_groups) {
    v = view_of(a.g, a.gc, a.wt[w]);
    if (a.fam.spr_f && (int)threadIdx.x < v.SC) {
      const int c = threadIdx.x;
      minv[c] = v.f_minz[c] ? 0 : (int32_t)(-glob1[c]);
    }
  }
  __syncthreads();
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
    if (f) {
      tm = traw[n] > tm ? traw[n] : tm;
      nm = nraw[n] > nm ? nraw[n] : nm;
    }
  }
  int64_t tmax = 0, namax = 0;
  if (a.norm_live) {
    tmax = block_max<BLOCK>(tm, sh);
    namax = block_max<BLOCK>(nm, sh);
  }
  int64_t npart = 0, lo = KT_I64_MAX, hi = -KT_I64_MAX;
  if (a.has_groups)
    block_score_partials<BLOCK>(v, a.fam, a.feas, a.loc2 + 1, a.n_global,
                                &npart, &lo, &hi, sh);
  else
    __syncthreads();
  if (threadIdx.x == 0) {
    a.loc2[0] = npart;
    a.loc2[W] = tmax;
    a.loc2[W + 1] = namax;
    a.loc2[W + 2] = -lo;
    a.loc2[W + 3] = hi;
  }
}

__global__ void __launch_bounds__(BLOCK)
plan_raw_kernel(PlanShardC a, int k, int spec, const int64_t* glob2) {
  __shared__ BlockScratch<BLOCK> sh;
  const int w = slot_of(a, k, spec);
  const GViewD v = view_of(a.g, a.gc, a.wt[w]);
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

__global__ void __launch_bounds__(BLOCK)
plan_select_kernel(PlanShardC a, int k, int spec, const int64_t* glob2,
                   const int64_t* glob3) {
  __shared__ BlockScratch<BLOCK> sh;
  const int w = slot_of(a, k, spec);
  const int N = a.na.N;
  const int64_t NN = N, W = flag_w(a);
  const int64_t tmax = glob2[W], namax = glob2[W + 1];
  const int64_t lo = -glob2[W + 2], hi = glob2[W + 3];
  const bool gs = a.has_groups && (a.fam.spr_s || a.fam.ipa_score);
  GViewD v;
  bool has_s = false;
  int64_t rmin = 0, rmax = 0;
  if (a.has_groups) {
    v = view_of(a.g, a.gc, a.wt[w]);
    if (a.fam.spr_s) {
      has_s = kt_has_s(v);
      rmin = -glob3[0];
      rmax = glob3[1];
    }
  }
  const CfgC& cfg = a.cfg;
  const int64_t* sfit = a.s_fit + w * NN;
  const int64_t* sbal = a.s_bal + w * NN;
  const int64_t* simg = a.s_img + w * NN;
  const int64_t* traw = a.taint_raw + w * NN;
  const int64_t* nraw = a.na_raw + w * NN;
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
            + cfg.w_image * simg[n];
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

// spec >= 0: record slot spec's speculative choice; else pod step k
__global__ void __launch_bounds__(BLOCK)
plan_apply_kernel(PlanShardC a, int k, int spec, const int64_t* gkey) {
  int64_t gscore;
  int32_t gbest;
  unkey(*gkey, &gscore, &gbest);
  if (spec >= 0) {
    if (threadIdx.x == 0) a.ctl[spec] = gscore >= 0 ? gbest : -1;
    return;
  }
  const int R = a.na.R, S = a.S;
  const int64_t NN = a.na.N;
  const int w = a.widx[k];
  const bool vld = a.valid[k] != 0;
  const bool assigned = gscore >= 0 && vld;
  const int lb = gbest - a.offset;
  const bool mine = assigned && lb >= 0 && lb < a.na.N;
  if (mine) {
    const PodRowD p = pod_row(a.tb, a.wt[w]);
    int64_t* used_row = a.used + (int64_t)lb * R;
    int64_t* nz_row = a.nonzero_used + (int64_t)lb * 2;
    if (threadIdx.x == 0) {
      for (int r = 0; r < R; ++r) used_row[r] += p.req[r];
      nz_row[0] += p.nonzero_req[0];
      nz_row[1] += p.nonzero_req[1];
      a.npods[lb] += 1;
      if (a.has_ports) {
        // the pod's port ids into the first free slots of the row
        bool any_port = false;
        for (int q = 0; q < a.tb.PP; ++q) any_port = any_port || p.port_ids[q];
        if (any_port) {
          int32_t* row = a.ports + (int64_t)lb * a.P;
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
    // refresh the fit surfaces of every slot at the touched row
    if ((int)threadIdx.x < S) {
      const int s = threadIdx.x;
      const PodRowD ps = pod_row(a.tb, a.wt[s]);
      int64_t s_fit, s_bal;
      kt_fit_scores(a.cfg, a.na, lb, used_row, nz_row, ps, &s_fit, &s_bal);
      a.fit_ok[s * NN + lb] = kt_fit(a.na, lb, used_row, a.npods[lb], ps);
      a.s_fit[s * NN + lb] = s_fit;
      a.s_bal[s * NN + lb] = s_bal;
    }
  }
  if (threadIdx.x == 0) {
    int32_t* ctl = a.ctl;
    const int32_t y = assigned ? gbest : -1;
    const bool conflict = vld && y != ctl[w];
    int32_t& clean = ctl[KT_PLAN_MAX_S];
    ctl[KT_PLAN_MAX_S + 2] += clean && vld && !conflict;
    clean = clean && !conflict;
    ctl[KT_PLAN_MAX_S + 1] += conflict;
    if (a.packed) {
      a.packed[k] = y;
      if (k == a.W - 1) {
        a.packed[a.W] = ctl[KT_PLAN_MAX_S + 1];
        a.packed[a.W + 1] = ctl[KT_PLAN_MAX_S + 2];
      }
    }
  }
  if (a.has_groups) block_own_write<BLOCK>(a.g, mine ? lb : -1, a.own);
}

__global__ void __launch_bounds__(BLOCK)
plan_update_kernel(PlanShardC a, int k, const int64_t* gkey,
                   const int64_t* gown) {
  int64_t gscore;
  int32_t gbest;
  unkey(*gkey, &gscore, &gbest);
  if (!(gscore >= 0 && a.valid[k])) return;
  const int lb = gbest - a.offset;
  block_group_update_own<BLOCK>(a.g, a.gc, a.fam, a.wt[a.widx[k]], gown,
                                lb >= 0 && lb < a.na.N ? lb : -1);
}

}  // namespace

extern "C" int ktpu_plan_shard_init(const PlanShardC* a, void* stream) {
  plan_init_kernel<<<1, BLOCK, 0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

extern "C" int ktpu_plan_shard_min(const PlanShardC* a, int k, int spec,
                                   void* stream) {
  plan_min_kernel<<<1, BLOCK, 0, (cudaStream_t)stream>>>(*a, k, spec);
  return (int)cudaGetLastError();
}

extern "C" int ktpu_plan_shard_eval(const PlanShardC* a, int k, int spec,
                                    const int64_t* glob1, void* stream) {
  plan_eval_kernel<<<1, BLOCK, 0, (cudaStream_t)stream>>>(*a, k, spec,
                                                           glob1);
  return (int)cudaGetLastError();
}

extern "C" int ktpu_plan_shard_raw(const PlanShardC* a, int k, int spec,
                                   const int64_t* glob2, void* stream) {
  plan_raw_kernel<<<1, BLOCK, 0, (cudaStream_t)stream>>>(*a, k, spec,
                                                          glob2);
  return (int)cudaGetLastError();
}

extern "C" int ktpu_plan_shard_select(const PlanShardC* a, int k, int spec,
                                      const int64_t* glob2,
                                      const int64_t* glob3, void* stream) {
  plan_select_kernel<<<1, BLOCK, 0, (cudaStream_t)stream>>>(*a, k, spec,
                                                             glob2, glob3);
  return (int)cudaGetLastError();
}

extern "C" int ktpu_plan_shard_apply(const PlanShardC* a, int k, int spec,
                                     const int64_t* gkey, void* stream) {
  plan_apply_kernel<<<1, BLOCK, 0, (cudaStream_t)stream>>>(*a, k, spec,
                                                            gkey);
  return (int)cudaGetLastError();
}

extern "C" int ktpu_plan_shard_update(const PlanShardC* a, int k,
                                      const int64_t* gkey,
                                      const int64_t* gown, void* stream) {
  plan_update_kernel<<<1, BLOCK, 0, (cudaStream_t)stream>>>(*a, k, gkey,
                                                             gown);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// every shard on one card: the whole span in one cooperative launch

namespace {

constexpr int PBLOCK = KT_PLAN_BLOCK;

__global__ void __launch_bounds__(PBLOCK, 1)
plan_span_grid_kernel(const __grid_constant__ PlanSpanC cm,
                      const PlanNodesC* all, int T) {
  __shared__ PlanShared<PBLOCK> sh;
  const int d = blockIdx.x / T, r = blockIdx.x % T;
  const int n = cm.n_local, span = (n + T - 1) / T;
  const int lo = min(n, r * span), hi = min(n, lo + span);
  GridTeam<PBLOCK> tm{cm.part};
  plan_span<PBLOCK>(cm, all, d, lo, hi, span, r == 0, blockIdx.x == 0, tm,
                    sh);
}

}  // namespace

// all: the D shards' PlanNodesC in device memory; T blocks a shard (the
// wrapper's T: its partial slots are sized by D·T)
extern "C" int ktpu_plan_span_grid(const PlanSpanC* cm, const void* all,
                                   int D, int T, void* stream) {
  const PlanNodesC* nodes = (const PlanNodesC*)all;
  void* kargs[] = {(void*)cm, (void*)&nodes, (void*)&T};
  const int smem = plan_dyn_bytes((cm->n_local + T - 1) / T);
  cudaError_t e = cudaFuncSetAttribute(
      plan_span_grid_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e == cudaSuccess)
    e = cudaLaunchCooperativeKernel((const void*)plan_span_grid_kernel,
                                    dim3(D * T), dim3(PBLOCK), kargs, smem,
                                    (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
