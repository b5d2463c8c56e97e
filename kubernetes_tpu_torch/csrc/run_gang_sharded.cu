// run_gang_sharded: the gang scan tier over the node-sharded mesh — one
// gang's members placed all or nothing, the node axis split into shards.
//
// Replaces kubernetes_tpu/parallel/sharding.py _run_gang_scan_sharded_jit
// (:1018) over its SPMD body _gang_scan_local (:890-1016): run_gang.cu's
// scan tier with the argmax a global first max, the chosen row refreshed
// on the shard that owns it, and the contiguity counts — one per GLOBAL
// topology domain id — bumped with the chosen node's id.
//
// Two placements, two implementations:
//
// Every shard on one card (ops/kernels.py plan_sharded_placement "one"):
// ONE cooperative launch a gang (ktpu_gang_span_grid) of D teams of T
// blocks of KT_PLAN_BLOCK (512) threads, T = ceil(n_local / 512) capped by
// the card's SMs / D, block b in shard b / T; each block owns a contiguous
// range of its shard's rows and is the only writer of them. The gang's
// body is gang_span.cuh's (the hoist, the member scan with one grid
// reduction a member when the maxima repeat, the contiguity counts a row
// at a time in each block's shared memory, the owner block's placement
// and three-warp refresh, the verdict); run_gang.cu runs the same body as
// a thread-block cluster on one device.
//
// Shards on several cards ("cards"): launches per shard, with the
// exchange (kubernetes_tpu_torch/parallel/sharding.py) between them; the
// wrapper (ops/kernels.py _gang_sharded_chain) drives the members from
// the host without reading anything back:
//   init: the entry carry into the fresh output rows, the fit surfaces of
//     the S signature slots at it (gang_span.cuh's hoist, :906-917),
//     the contiguity counts ([n_global], replicated on every shard) and
//     the placed count zeroed;
//   per member: eval — the feasible set and the maxima of taint_raw,
//     na_raw and (w_contig) the domain counts over it → exchange (max);
//     select — the totals, the shard's first max as one int64 key →
//     exchange (max); apply — on the owning shard the placement and the
//     refresh of the row for every slot, on every shard the placed count,
//     on shard 0 the raw assignment, and (w_contig) the chosen node's
//     domain id into `own` → exchange (sum); update (w_contig) — every
//     shard's contiguity count of that domain;
//   verdict: accept = placed >= needed; a rejected gang leaves every
//     shard's carry as it came (the output rows get the input's back and
//     the signature cache keeps its sig), an accepted one zeroes
//     cache.sig on every shard; shard 0 writes the packed tail.
// The packed layout is run_gang's: [raw assignments (B); accept; placed;
// 1; 1].
//
// What bounds it on an H100: the dependent chain of B members; a member
// moves well under a megabyte. Latency, not bytes or operations. On one
// card a member is one or two grid barriers; on several cards 3 to 4
// launches a shard and 2 to 3 exchanges (the design keeps each launch to
// one block a shard and skips the contiguity exchange and launch when
// w_contig is 0).

#include "gang_span.cuh"

// one shard's arguments, mirrored field for field by ctypes
// (ops/kernels.py GangShardC)
struct GangShardC {
  NodeC na;
  TableC tb;
  CfgC cfg;
  const int64_t* used_in;   // the input carry (read)
  const int64_t* nz_in;
  const int32_t* npods_in;
  const int32_t* sig_in;
  int64_t* used;            // the output carry rows (written)
  int64_t* nonzero_used;
  int32_t* npods;
  int32_t* sig_out;
  const uint8_t* m0;        // the shard's stacked surfaces, [S, N] each
  const int64_t* taint_raw;
  const int64_t* na_raw;
  const int64_t* s_img;
  const uint8_t* valid;     // [B] replicated
  const int32_t* tidx;      // [B]
  const int32_t* widx;      // [B]
  const int32_t* wt;        // [S] the slots' table rows
  const int32_t* dom;       // [N] the shard's slice of the global domain ids
  int32_t S, B, needed, w_contig, offset, n_global;
  uint8_t* fit_ok;          // [S, N]
  int64_t* s_fit;           // [S, N]
  int64_t* s_bal;           // [S, N]
  int32_t* domcnt;          // [n_global] replicated contiguity counts
  int32_t* placed;          // [1]
  int64_t* loc;             // [3] the maxima
  int64_t* key;             // [1] the shard's packed first max
  int64_t* own;             // [1] the chosen node's domain id
  int32_t* packed;          // [B + 4] (shard 0), else nullptr
};

namespace {

constexpr int BLOCK = 1024;

__device__ __forceinline__ void unkey(int64_t k, int64_t* gscore,
                                      int32_t* gbest) {
  *gscore = (k >> 32) - 1;
  *gbest = 0x7fffffff - (int32_t)(k & 0xffffffffLL);
}

__global__ void __launch_bounds__(BLOCK) gang_init_kernel(GangShardC a) {
  const int N = a.na.N, R = a.na.R, S = a.S;
  const int64_t NN = N;
  for (int64_t e = threadIdx.x; e < NN * R; e += BLOCK)
    a.used[e] = a.used_in[e];
  for (int64_t e = threadIdx.x; e < NN * 2; e += BLOCK)
    a.nonzero_used[e] = a.nz_in[e];
  for (int n = threadIdx.x; n < N; n += BLOCK) a.npods[n] = a.npods_in[n];
  for (int n = threadIdx.x; n < a.n_global; n += BLOCK) a.domcnt[n] = 0;
  if (threadIdx.x == 0) *a.placed = 0;
  for (int64_t e = threadIdx.x; e < (int64_t)S * N; e += BLOCK) {
    const int s = (int)(e / NN), n = (int)(e % NN);
    const PodRowD p = pod_row(a.tb, a.wt[s]);
    const int64_t* used_row = a.used_in + (int64_t)n * R;
    int64_t s_fit, s_bal;
    kt_fit_scores(a.cfg, a.na, n, used_row, a.nz_in + (int64_t)n * 2, p,
                  &s_fit, &s_bal);
    a.fit_ok[e] = kt_fit(a.na, n, used_row, a.npods_in[n], p);
    a.s_fit[e] = s_fit;
    a.s_bal[e] = s_bal;
  }
}

__global__ void __launch_bounds__(BLOCK) gang_eval_kernel(GangShardC a, int k) {
  __shared__ BlockScratch<BLOCK> sh;
  const int64_t NN = a.na.N;
  const int s = a.widx[k];
  const uint8_t* m0 = a.m0 + s * NN;
  const uint8_t* fit = a.fit_ok + s * NN;
  const int64_t* traw = a.taint_raw + s * NN;
  const int64_t* nraw = a.na_raw + s * NN;
  int64_t tm = 0, nm = 0, dm = 0;
  for (int n = threadIdx.x; n < a.na.N; n += BLOCK) {
    if (!(m0[n] && fit[n])) continue;
    tm = traw[n] > tm ? traw[n] : tm;
    nm = nraw[n] > nm ? nraw[n] : nm;
    if (a.w_contig) {
      const int64_t dc = a.domcnt[a.dom[n]];
      dm = dc > dm ? dc : dm;
    }
  }
  const int64_t tmax = block_max<BLOCK>(tm, sh);
  const int64_t namax = block_max<BLOCK>(nm, sh);
  const int64_t dmax = block_max<BLOCK>(dm, sh);
  if (threadIdx.x == 0) {
    a.loc[0] = tmax;
    a.loc[1] = namax;
    a.loc[2] = dmax;
  }
}

__global__ void __launch_bounds__(BLOCK)
gang_select_kernel(GangShardC a, int k, const int64_t* glob) {
  __shared__ BlockScratch<BLOCK> sh;
  const int64_t NN = a.na.N;
  const int s = a.widx[k];
  const CfgC& cfg = a.cfg;
  const uint8_t* m0 = a.m0 + s * NN;
  const uint8_t* fit = a.fit_ok + s * NN;
  const int64_t* traw = a.taint_raw + s * NN;
  const int64_t* nraw = a.na_raw + s * NN;
  const int64_t* simg = a.s_img + s * NN;
  const int64_t* sfit = a.s_fit + s * NN;
  const int64_t* sbal = a.s_bal + s * NN;
  int64_t bv = KT_I64_MIN;
  int32_t bi = 0x7fffffff;
  for (int n = threadIdx.x; n < a.na.N; n += BLOCK) {
    int64_t val = -1;
    if (m0[n] && fit[n]) {
      val = cfg.w_fit * sfit[n] + cfg.w_balanced * sbal[n]
            + cfg.w_taint * kt_normalize(traw[n], glob[0], true)
            + cfg.w_node_affinity * kt_normalize(nraw[n], glob[1], false)
            + cfg.w_image * simg[n];
      if (a.w_contig)
        val += a.w_contig * kt_normalize(a.domcnt[a.dom[n]], glob[2], false);
    }
    argmax_merge(bv, bi, val, n);
  }
  block_argmax<BLOCK>(bv, bi, sh);
  if (threadIdx.x == 0)
    *a.key = ((bv + 1) << 32) | (int64_t)(0x7fffffff - (a.offset + bi));
}

__global__ void __launch_bounds__(BLOCK)
gang_apply_kernel(GangShardC a, int k, const int64_t* gkey) {
  int64_t gscore;
  int32_t gbest;
  unkey(*gkey, &gscore, &gbest);
  const bool assigned = gscore >= 0 && a.valid[k];
  const int lb = gbest - a.offset;
  const bool mine = assigned && lb >= 0 && lb < a.na.N;
  const int R = a.na.R;
  const int64_t NN = a.na.N;
  if (mine) {
    const PodRowD p = pod_row(a.tb, a.tidx[k]);
    int64_t* used_row = a.used + (int64_t)lb * R;
    int64_t* nz_row = a.nonzero_used + (int64_t)lb * 2;
    if (threadIdx.x == 0) {
      for (int r = 0; r < R; ++r) used_row[r] += p.req[r];
      nz_row[0] += p.nonzero_req[0];
      nz_row[1] += p.nonzero_req[1];
      a.npods[lb] += 1;
    }
    __syncthreads();
    // the touched row, refreshed for every slot (duplicates included)
    if ((int)threadIdx.x < a.S) {
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
    *a.placed += assigned;
    *a.own = mine ? a.dom[lb] : 0;
    if (a.packed) a.packed[k] = assigned ? gbest : -1;
  }
}

__global__ void gang_update_kernel(GangShardC a, int k, const int64_t* gkey,
                                   const int64_t* gown) {
  int64_t gscore;
  int32_t gbest;
  unkey(*gkey, &gscore, &gbest);
  if (gscore >= 0 && a.valid[k]) a.domcnt[*gown] += 1;
}

__global__ void __launch_bounds__(BLOCK) gang_verdict_kernel(GangShardC a) {
  const int placed = *a.placed;
  const bool accept = placed >= a.needed;
  if (!accept) {
    const int64_t NN = a.na.N;
    for (int64_t e = threadIdx.x; e < NN * a.na.R; e += BLOCK)
      a.used[e] = a.used_in[e];
    for (int64_t e = threadIdx.x; e < NN * 2; e += BLOCK)
      a.nonzero_used[e] = a.nz_in[e];
    for (int n = threadIdx.x; n < a.na.N; n += BLOCK)
      a.npods[n] = a.npods_in[n];
  }
  if (threadIdx.x == 0) {
    *a.sig_out = accept ? 0 : *a.sig_in;
    if (a.packed) {
      a.packed[a.B] = accept;
      a.packed[a.B + 1] = placed;
      a.packed[a.B + 2] = 1;
      a.packed[a.B + 3] = 1;
    }
  }
}

}  // namespace

extern "C" int ktpu_gang_shard_init(const GangShardC* a, void* stream) {
  gang_init_kernel<<<1, BLOCK, 0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

extern "C" int ktpu_gang_shard_eval(const GangShardC* a, int k,
                                    void* stream) {
  gang_eval_kernel<<<1, BLOCK, 0, (cudaStream_t)stream>>>(*a, k);
  return (int)cudaGetLastError();
}

extern "C" int ktpu_gang_shard_select(const GangShardC* a, int k,
                                      const int64_t* glob, void* stream) {
  gang_select_kernel<<<1, BLOCK, 0, (cudaStream_t)stream>>>(*a, k, glob);
  return (int)cudaGetLastError();
}

extern "C" int ktpu_gang_shard_apply(const GangShardC* a, int k,
                                     const int64_t* gkey, void* stream) {
  gang_apply_kernel<<<1, BLOCK, 0, (cudaStream_t)stream>>>(*a, k, gkey);
  return (int)cudaGetLastError();
}

extern "C" int ktpu_gang_shard_update(const GangShardC* a, int k,
                                      const int64_t* gkey,
                                      const int64_t* gown, void* stream) {
  gang_update_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(*a, k, gkey, gown);
  return (int)cudaGetLastError();
}

extern "C" int ktpu_gang_shard_verdict(const GangShardC* a, void* stream) {
  gang_verdict_kernel<<<1, BLOCK, 0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// every shard on one card: the whole gang in one cooperative launch, the
// body of gang_span.cuh on plan_span.cuh's GridTeam

namespace {

constexpr int GBLOCK = KT_PLAN_BLOCK;

__global__ void __launch_bounds__(GBLOCK, 1)
gang_span_grid_kernel(const __grid_constant__ GangSpanC cm,
                      const GangNodesC* all, int T) {
  __shared__ PlanShared<GBLOCK> sh;
  const int d = blockIdx.x / T, rk = blockIdx.x % T;
  const int nl = cm.n_local, span = (nl + T - 1) / T;
  const int lo = min(nl, rk * span), hi = min(nl, lo + span);
  GridTeam<GBLOCK> tm{cm.part};
  gang_span<GBLOCK>(cm, all, d, lo, hi, rk == 0, blockIdx.x == 0, tm, sh);
}

}  // namespace

// all: the D shards' GangNodesC in device memory; T blocks a shard (the
// wrapper's T: its partial slots are sized by D·T)
extern "C" int ktpu_gang_span_grid(const GangSpanC* cm, const void* all,
                                   int D, int T, void* stream) {
  const GangNodesC* nodes = (const GangNodesC*)all;
  void* kargs[] = {(void*)cm, (void*)&nodes, (void*)&T};
  const int smem = gang_dyn_bytes((cm->n_local + T - 1) / T);
  cudaError_t e = cudaFuncSetAttribute(
      gang_span_grid_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e == cudaSuccess)
    e = cudaLaunchCooperativeKernel((const void*)gang_span_grid_kernel,
                                    dim3(D * T), dim3(GBLOCK), kargs, smem,
                                    (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
