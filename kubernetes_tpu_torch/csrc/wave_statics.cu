// wave_statics: the carry-independent per-signature surfaces of the wave
// program.
//
// Replaces kubernetes_tpu/ops/program.py wave_statics (:1676; the jit
// _wave_statics_jit :1635): for each table row wt[s] and node n, the
// static filter mask (valid, node name, unschedulable, taints, selector;
// ports are vacuous for sig != 0 rows), the untolerated PreferNoSchedule
// count, the preferred node-affinity weight and the ImageLocality score →
// [S, N] arrays. `feats` = (taints, selectors, images) skips a family the
// rows cannot exercise, exactly like the JAX program's static flags (its
// outputs are then the identity: mask bits set, counts zero).
//
// The node-sharded mesh (kubernetes_tpu/ops/program.py :1635 under XLA's
// partitioning, the image counts psum'd) is the same entry over a shard
// table passed by value, up to KT_WS_MAX_SHARDS shards of one card (one
// device is the table of one shard): a global row is its shard's offset
// plus its local row, the shards in mesh order, and each shard's surfaces
// go to its own outputs. ImageLocality's spread counts are cluster-wide,
// so the counts are summed over every shard's rows inside the launch.
// Shards on several cards launch this kernel once a card twice, with the
// psum between (`cnt_out`: the card's counts only; `cnt_in`: the
// surfaces from the summed counts).
//
// What bounds it on an H100: the work per (s, n) is the lean filter and
// score loops over the node's occupied taint, label and image slots —
// integer operations on a few hundred bytes of node row; S·N is at most
// a few hundred thousand, so one call is launch-latency bound: the
// wrapper's host time and one launch are its floor.
//
// Design: ONE launch a call, ⌈N / 256⌉ CTAs of 256 threads a table row
// (grid CTAs × S), CTA x owning the x-th contiguous share of the global
// rows, a thread a row. When images count, the row's CTAs launch as
// thread-block clusters of KT_WS_CLUSTER (their count rounded up to a
// whole number of clusters) and each cluster counts the whole row: CTA r
// counts the valid rows of the r-th sixteenth holding each image (warp
// ballots into shared memory), one cluster barrier, a thread a (CTA,
// count) adds the sixteen partials through distributed shared memory, one
// more barrier (no CTA leaves while another reads its partials). Without
// counts to sum (no images, or the chain's summed counts given) nothing
// crosses rows and the launch is a plain grid. Then every thread
// evaluates the lean device functions of lean_eval.cuh — the same code
// run_batch and run_uniform run — and writes the four surfaces. The image
// loops read each image slot of a row once for its presence bits, sum
// sizes only for the images the row holds, and keep no per-thread array
// indexed at run time (it would live in local memory).

#include <cooperative_groups.h>

#include "lean_eval.cuh"

namespace cg = cooperative_groups;

#define KT_WS_MAX_S 64
#define KT_WS_MAX_SHARDS 4
#define KT_WS_CLUSTER 16

// one node shard: its columns and its four [S, rows] outputs
// (ops/kernels.py StaticsShardC)
struct StaticsShard {
  NodeC na;
  uint8_t* mask;          // [S, rows]
  int64_t* taint_raw;     // [S, rows]
  int64_t* na_raw;        // [S, rows]
  int64_t* s_img;         // [S, rows]
};

// mirrored field for field by ctypes (ops/kernels.py StaticsArgsC)
struct StaticsArgs {
  StaticsShard s[KT_WS_MAX_SHARDS];
  int32_t D;              // shards in use
  int32_t N;              // the shards' rows together
  TableC tb;
  int32_t wt[KT_WS_MAX_S];
  int32_t S, has_taints, has_sel, has_img;
  const int64_t* cnt_in;  // [S, IC + 1] summed counts (null: summed here)
  int64_t* cnt_out;       // [S, IC + 1] the table's counts only (null: no)
};

namespace {

constexpr int BLOCK = 256;

// CTAs a row: ⌈N / BLOCK⌉, and with clusters a whole number of them
__host__ __device__ inline int statics_ctas(int N, bool clusters) {
  const int b = (N + BLOCK - 1) / BLOCK;
  if (!clusters) return b > 0 ? b : 1;
  return (b + KT_WS_CLUSTER - 1) / KT_WS_CLUSTER * KT_WS_CLUSTER;
}

// global row n: its shard and local row *m (n < N)
__device__ __forceinline__ int shard_of(const StaticsArgs& a, int n, int* m) {
  int d = 0;
#pragma unroll
  for (int k = 0; k < KT_WS_MAX_SHARDS - 1; ++k)
    if (d + 1 < a.D && n >= a.s[d].na.N) {
      n -= a.s[d].na.N;
      ++d;
    }
  *m = n;
  return d;
}

// bit c: row m holds image c of the pod row (image_locality_score's
// presence): one pass over the row's image slots, each slot loaded once
__device__ __forceinline__ uint32_t image_bits(const NodeC& na, int m,
                                               const PodRowD& p, int IC) {
  uint32_t bits = 0;
  const int64_t base = (int64_t)m * na.I;
#pragma unroll 4
  for (int i = 0; i < na.I; ++i) {
    const int32_t id = na.image_id[base + i];
    if (id == 0) continue;
    for (int c = 0; c < IC; ++c)
      if (p.img_ids[c] == id) bits |= 1u << c;
  }
  return bits;
}

// kt_image_score of row m from the summed counts (the same operations in
// the same order): an image the row does not hold (its bit clear) has
// size 0 and adds (int64)(0.0 · spread) = 0, so only the held ones are
// summed over the slots
__device__ __forceinline__ int64_t image_score(const NodeC& na, int m,
                                               const PodRowD& p, int IC,
                                               uint32_t bits,
                                               const int64_t* num_with,
                                               int64_t total) {
  if (p.img_containers <= 0) return 0;
  const double tot = (double)(total > 1 ? total : 1);
  const int64_t base = (int64_t)m * na.I;
  int64_t sum = 0;
  for (int c = 0; c < IC; ++c) {
    if (!((bits >> c) & 1u)) continue;
    const int32_t id = p.img_ids[c];
    int64_t size = 0;
    for (int i = 0; i < na.I; ++i)
      if (na.image_id[base + i] == id) size += na.image_size[base + i];
    const double spread = __ddiv_rn((double)num_with[c], tot);
    sum += (int64_t)__dmul_rn((double)size, spread);
  }
  const int64_t nc = p.img_containers > 1 ? p.img_containers : 1;
  const int64_t max_thr = KT_IMG_MAX_CONTAINER_THRESHOLD * nc;
  int64_t cl = sum < KT_IMG_MIN_THRESHOLD ? KT_IMG_MIN_THRESHOLD : sum;
  if (cl > max_thr) cl = max_thr;
  int64_t den = max_thr - KT_IMG_MIN_THRESHOLD;
  if (den < 1) den = 1;
  return floordiv(KT_MAX_SCORE * (cl - KT_IMG_MIN_THRESHOLD), den);
}

// CTA x of row y evaluates the x-th of gridDim.x contiguous shares of the
// global rows. When the image counts are summed here the row's CTAs are
// clusters of KT_WS_CLUSTER, and each cluster counts the whole row (CTA r
// of a cluster the r-th of KT_WS_CLUSTER shares), so every CTA holds the
// row's counts after its own cluster's barriers.
__global__ void __launch_bounds__(BLOCK)
statics_kernel(const __grid_constant__ StaticsArgs a) {
  // [0, IC): valid rows holding image c; [IC]: valid rows
  __shared__ int64_t part[KT_MAX_IC + 1];
  __shared__ int64_t cnt[KT_MAX_IC + 1];
  const int C = gridDim.x, rank = blockIdx.x;
  const int s = blockIdx.y;
  const int N = a.N;
  const int span = (N + C - 1) / C;
  const int lo = min(N, rank * span), hi = min(N, lo + span);
  const PodRowD p = pod_row(a.tb, a.wt[s]);
  const int IC = a.tb.IC;

  if (a.has_img && a.cnt_in == nullptr) {
    cg::cluster_group cl = cg::this_cluster();
    const int K = (int)cl.num_blocks(), kspan = (N + K - 1) / K;
    const int klo = min(N, (int)cl.block_rank() * kspan);
    const int khi = min(N, klo + kspan);
    for (int c = threadIdx.x; c <= IC; c += BLOCK) part[c] = cnt[c] = 0;
    __syncthreads();
    const int lane = threadIdx.x & 31;
    for (int n0 = klo; n0 < khi; n0 += BLOCK) {   // warp-uniform trips
      const int n = n0 + threadIdx.x;
      bool valid = false;
      uint32_t bits = 0;
      if (n < khi) {
        int m;
        const NodeC& na = a.s[shard_of(a, n, &m)].na;
        valid = na.valid[m] != 0;
        if (valid) bits = image_bits(na, m, p, IC);
      }
      const int nv = __popc(__ballot_sync(0xffffffffu, valid));
      if (lane == 0 && nv)
        atomicAdd((unsigned long long*)&part[IC], (unsigned long long)nv);
      for (int c = 0; c < IC; ++c) {
        const int k = __popc(__ballot_sync(0xffffffffu, (bits >> c) & 1u));
        if (lane == 0 && k)
          atomicAdd((unsigned long long*)&part[c], (unsigned long long)k);
      }
    }
    cl.sync();
    // a thread a (CTA, count): every partial read at once through DSMEM
    for (int t = threadIdx.x; t < K * (IC + 1); t += BLOCK) {
      const int c = t % (IC + 1);
      atomicAdd((unsigned long long*)&cnt[c],
                (unsigned long long)*cl.map_shared_rank(&part[c],
                                                        t / (IC + 1)));
    }
    // every CTA's partials read before any CTA leaves; cnt complete
    cl.sync();
    if (a.cnt_out != nullptr) {
      if (rank == 0)
        for (int c = threadIdx.x; c <= IC; c += BLOCK)
          a.cnt_out[(int64_t)s * (IC + 1) + c] = cnt[c];
      return;
    }
  } else if (a.has_img) {
    for (int c = threadIdx.x; c <= IC; c += BLOCK)
      cnt[c] = a.cnt_in[(int64_t)s * (IC + 1) + c];
    __syncthreads();
  }

  for (int n = lo + threadIdx.x; n < hi; n += BLOCK) {
    int m;
    const StaticsShard& sh = a.s[shard_of(a, n, &m)];
    const NodeC& na = sh.na;
    bool ok = na.valid[m] != 0;
    ok = ok && (p.node_name_id == 0 || na.name_id[m] == p.node_name_id);
    ok = ok && (!na.unschedulable[m] || p.tolerates_unsched);
    int64_t traw = 0, nraw = 0, simg = 0;
    if (a.has_taints) {
      ok = ok && kt_taints_ok(na, m, p, a.tb.TT);
      traw = kt_taint_prefer(na, m, p, a.tb.TT);
    }
    if (a.has_sel) {
      ok = ok && kt_selector_ok(na, m, p, a.tb.Q, a.tb.TM, a.tb.V);
      nraw = kt_pref_score(na, m, p, a.tb.PT, a.tb.Q, a.tb.V);
    }
    if (a.has_img)
      simg = image_score(na, m, p, IC, image_bits(na, m, p, IC), cnt,
                         cnt[IC]);
    const int64_t o = (int64_t)s * na.N + m;
    sh.mask[o] = ok;
    sh.taint_raw[o] = traw;
    sh.na_raw[o] = nraw;
    sh.s_img[o] = simg;
  }
}

}  // namespace

// one launch: the surfaces of the S rows over the D shards of the table
// (or, with cnt_out, the table's image counts only)
extern "C" int ktpu_wave_statics(const StaticsArgs* args, void* stream) {
  if (args->S <= 0) return 0;
  if (args->S > KT_WS_MAX_S || args->D < 1 || args->D > KT_WS_MAX_SHARDS)
    return (int)cudaErrorInvalidValue;
  const bool counting = args->has_img && args->cnt_in == nullptr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(statics_ctas(args->N, counting), args->S);
  cfg.blockDim = dim3(BLOCK);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute at[1];
  if (counting) {
    cudaError_t e = cudaFuncSetAttribute(
        statics_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
    at[0].id = cudaLaunchAttributeClusterDimension;
    at[0].val.clusterDim.x = KT_WS_CLUSTER;
    at[0].val.clusterDim.y = 1;
    at[0].val.clusterDim.z = 1;
    cfg.attrs = at;
    cfg.numAttrs = 1;
  }
  cudaError_t e = cudaLaunchKernelEx(&cfg, statics_kernel, *args);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
