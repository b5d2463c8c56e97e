// cluster_probe: utilization, fragmentation and domain-imbalance
// statistics of the resident carry, once per device drain.
//
// Replaces kubernetes_tpu/ops/program.py cluster_probe (:893; the jit
// _cluster_probe_jit :888 over _probe_math :803). For each resource
// column r over the m participating cells (valid node, cap > 0):
//   p50 / p90 / p99 / max  nearest rank: the element at N - m + idx of
//                          the sorted util column, idx = floor(q·(m−1) +
//                          0.5) in float64, util = f32(used) / f32(cap)
//                          and −1 for non-participants (so they sort to
//                          the front);
//   mean                   f32(Σ used) / f32(Σ cap);
//   frag                   1 − f32(max free) / f32(Σ free);
//   stranded               f32(Σ free on tight nodes) / f32(Σ free), a
//                          tight node being valid with its bottleneck
//                          util ≥ 0.95f;
// then the per-domain pod density over the gang dom-id column (count of
// populated domains, max, min, max − min) and the valid node count.
//
// Bit parity with the plain version: every sum is exact int64, every
// int64 → f32 conversion rounds to nearest (__ll2float_rn), every f32
// division is IEEE (__fdiv_rn), the tight test compares in float32, and
// the rank arithmetic is float64 without contraction (__dmul_rn /
// __dadd_rn, and the file builds with --fmad=false). An order statistic
// is a value of the column, so selecting it instead of sorting gives the
// same bits.
//
// The mesh's probe (kubernetes_tpu/parallel/sharding.py cluster_probe_sharded
// :1198, _cluster_probe_sharded_jit :1157: an all-gather onto lane 0 and
// _probe_math there) is the same entry on its shards: the kernel takes a
// shard table by value, up to KT_PROBE_MAX_SHARDS shards (row 11, one
// device, is the table of one shard). A global row is its shard's offset
// plus its local row, the shards in mesh order; every statistic is an
// exact sum, a max, a count or a rank over the same cells as the gathered
// columns, so the outputs keep their bits without the gather.
//
// What bounds it on an H100: the bytes. It needs the valid rows' cap,
// the participating cells' used and the node columns once (under 0.9 MB
// at 5,000 valid nodes of 8,192 and R = 16); the work is a few
// comparisons per cell. At that size the floor is one launch and the few
// dependent phases inside it.
//
// Design: ONE launch a call of a thread-block cluster of KT_PROBE_CLUSTER
// CTAs × 1,024 threads (cudaLaunchKernelEx with the cluster dimension; a
// cluster barrier is a hardware barrier, cheaper than a cooperative
// grid's, and 16 CTAs hold the main path's 16 columns, one CTA a column).
// CTA c owns a contiguous range of rows. Four phases, a cluster barrier
// between them:
//   1. a thread a row: the bottleneck util and the tight flag into a
//      scratch byte a row, and every cell's order-preserving util key
//      (0 where the cell does not participate) into a column-major
//      scratch [R, N], so a column reads contiguously; the [ndom] domain
//      counts zeroed;
//   2. a thread a cell (each thread keeps one column: the CTA's rows in
//      row-major order, BLOCK / R · R threads): the column sums, the max
//      free block and the participant counts of the CTA's rows into its
//      shared memory; a thread a row: the per-domain pod / node counts as
//      int64 atomics;
//   3. CTA c takes columns c, c + C, ...: every CTA's partials of the
//      column through distributed shared memory; the column's keys into
//      shared memory (N ≤ KT_PROBE_SMEM_KEYS, else read in place) with
//      their min and max, whose common leading digits every target shares;
//      then ONE multi-target radix select over the remaining 8-bit digits
//      finds the four order statistics: each pass one sweep building the
//      four targets' 256-bin histograms (a key counts toward every target
//      whose prefix it matches, warp-aggregated by its digit and target
//      set), a warp a target finding its bin;
//   4. CTA 0: the domain statistics and the valid count.
// The kernel never writes its inputs; its scratch and outputs are carved
// by the wrapper from one allocation.

#include <cooperative_groups.h>

#include "lean_eval.cuh"

namespace cg = cooperative_groups;

#define KT_PROBE_MAX_SHARDS 4
#define KT_PROBE_CLUSTER 16
#define KT_PROBE_SMEM_KEYS 32768   // util keys a CTA holds (128 KB)

// one node shard's columns (ops/kernels.py ProbeShardC)
struct ProbeShard {
  const int64_t* cap;     // [rows, R]
  const uint8_t* valid;   // [rows]
  const int64_t* used;    // [rows, R]
  const int32_t* npods;   // [rows]
  int32_t rows;
};

// mirrored field for field by ctypes (ops/kernels.py ProbeArgsC)
struct ProbeArgs {
  ProbeShard s[KT_PROBE_MAX_SHARDS];
  int32_t D;              // shards in use
  const int32_t* dom;     // [N], N = the shards' rows
  int32_t N, R, ndom;
  uint8_t* tight;         // [N] scratch
  uint32_t* keys;         // [R, N] scratch: the cells' util keys
  int64_t* dom_pods;      // [ndom] scratch, zeroed in phase 1
  int64_t* dom_nodes;     // [ndom] scratch, zeroed in phase 1
  float* per_res;         // [R, 7]
  float* dom_stats;       // [4]
  int32_t* valid_count;   // []
};

#define KT_PROBE_PARTS 6        // a column's partials: four sums, a count,
                                // the max free block

// a CTA's dynamic shared memory: its column partials (int64 [R, 6]), then
// a column's util keys when they fit
__host__ __device__ inline int probe_dyn_bytes(int N, int R) {
  return 8 * KT_PROBE_PARTS * R + (N <= KT_PROBE_SMEM_KEYS ? 4 * N : 0);
}

extern __shared__ __align__(16) int64_t kt_probe_dyn[];

namespace {

constexpr int BLOCK = 1024;

__device__ __forceinline__ float f32_ratio(int64_t num, int64_t den) {
  return __fdiv_rn(__ll2float_rn(num), __ll2float_rn(den > 1 ? den : 1));
}

__device__ __forceinline__ bool participates(const ProbeShard& s, int m,
                                             int R, int r) {
  return s.valid[m] && s.cap[(int64_t)m * R + r] > 0;
}

__device__ __forceinline__ float util_of(const ProbeShard& s, int m, int R,
                                         int r) {
  const int64_t k = (int64_t)m * R + r;
  return f32_ratio(s.used[k], s.cap[k]);
}

// global row n: its shard d and local row *m (n < N)
__device__ __forceinline__ int shard_of(const ProbeArgs& a, int n, int* m) {
  int d = 0;
#pragma unroll
  for (int k = 0; k < KT_PROBE_MAX_SHARDS - 1; ++k)
    if (k + 1 < a.D && n >= a.s[k].rows) {
      n -= a.s[k].rows;
      d = k + 1;
    } else {
      break;
    }
  *m = n;
  return d;
}

// order-preserving uint32 key of a float (negatives flipped whole,
// non-negatives with the sign bit set)
__device__ __forceinline__ uint32_t fkey(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float unkey(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// the bucket of a 256-bucket histogram that holds rank kk among the keys
// counted, and kk's rank inside it: one warp, eight buckets a lane, an
// inclusive scan of the lanes' counts; the lane whose range covers kk
// walks its eight (the first bucket b with Σ hist[0..b] > kk, 255 when
// none is)
__device__ __forceinline__ void select_bucket(const uint32_t* hist,
                                              int64_t kk, uint32_t* bucket,
                                              int64_t* rank) {
  const int lane = threadIdx.x & 31;
  uint32_t loc[8];
  int64_t own = 0;
  for (int j = 0; j < 8; ++j) {
    loc[j] = hist[lane * 8 + j];
    own += loc[j];
  }
  int64_t incl = own;
  for (int o = 1; o < 32; o <<= 1) {
    const int64_t t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += t;
  }
  const int64_t excl = incl - own;
  const bool hit = excl <= kk && kk < incl;
  const unsigned any = __ballot_sync(0xffffffffu, hit);
  if (hit) {
    int64_t cum = excl;
    int j = 0;
    for (; j < 7; ++j) {
      if (cum + loc[j] > kk) break;
      cum += loc[j];
    }
    *bucket = lane * 8 + j;
    *rank = kk - cum;
  } else if (any == 0 && lane == 31) {
    *bucket = 255;
    *rank = kk - (incl - loc[7]);
  }
}

struct ProbeShared {
  BlockScratch<BLOCK> bs;
  uint32_t hist[4][256];     // the four targets' bins
  uint32_t prefix[4];        // each target's digits so far
  int64_t kk[4];             // each target's rank among its prefix's keys
  uint32_t bucket[4];
  int64_t rank[4];
  int32_t nkeys;
  float fmx[BLOCK / 32], fmn[BLOCK / 32];
};

// phase 3 for column r on this CTA
__device__ void probe_column(const ProbeArgs& a, int r, ProbeShared& sh) {
  cg::cluster_group cl = cg::this_cluster();
  const int R = a.R, N = a.N, lane = threadIdx.x & 31;
  const bool in_smem = N <= KT_PROBE_SMEM_KEYS;
  uint32_t* skeys = (uint32_t*)(kt_probe_dyn + KT_PROBE_PARTS * R);
  const uint32_t* col = a.keys + (int64_t)r * N;
  float* out = a.per_res + (int64_t)r * 7;
  // every CTA's partials of the column
  __shared__ int64_t tot[KT_PROBE_PARTS];
  if (threadIdx.x < KT_PROBE_PARTS) {
    const int k = threadIdx.x;
    const int C = (int)cl.num_blocks();
    int64_t x = k == 5 ? KT_I64_MIN : 0;
    for (int q = 0; q < C; ++q) {
      const int64_t y = cl.map_shared_rank(kt_probe_dyn, q)[r * KT_PROBE_PARTS
                                                            + k];
      x = k == 5 ? (y > x ? y : x) : x + y;
    }
    tot[k] = x;
  }
  if (threadIdx.x == 0) sh.nkeys = 0;
  __syncthreads();
  const int64_t s_used = tot[0], s_cap = tot[1], s_free = tot[2];
  const int64_t s_strand = tot[3], mc = tot[4], mx = tot[5];
  if (threadIdx.x == 0) {
    out[4] = s_cap > 0 ? f32_ratio(s_used, s_cap) : 0.0f;
    out[5] = s_free > 0 ? __fsub_rn(1.0f, f32_ratio(mx, s_free)) : 0.0f;
    out[6] = s_free > 0 ? f32_ratio(s_strand, s_free) : 0.0f;
  }
  if (mc == 0) {
    if (threadIdx.x < 4) out[threadIdx.x] = 0.0f;
    __syncthreads();
    return;
  }
  // the participants' keys (into shared memory when they fit, a warp's
  // slots with one shared atomic: the selection reads them as a multiset),
  // their min and max
  int64_t hi = 0, nlo = -(int64_t)0xffffffffLL;
  // the keys are other CTAs' writes: read past L1, four a thread issued
  // together
  for (int i00 = 0; i00 < N; i00 += 4 * BLOCK) {
    uint32_t k4[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = i00 + j * BLOCK + threadIdx.x;
      k4[j] = i < N ? __ldcg(col + i) : 0u;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t key = k4[j];
      const bool take = key != 0;
      if (take) {
        hi = key > hi ? key : hi;
        nlo = -(int64_t)key > nlo ? -(int64_t)key : nlo;
      }
      if (!in_smem) continue;
      const unsigned vote = __ballot_sync(0xffffffffu, take);
      if (vote == 0) continue;
      const int lead = __ffs(vote) - 1;
      int at = 0;
      if (lane == lead) at = atomicAdd(&sh.nkeys, __popc(vote));
      at = __shfl_sync(0xffffffffu, at, lead);
      if (take) skeys[at + __popc(vote & ((1u << lane) - 1u))] = key;
    }
  }
  hi = block_max<BLOCK>(hi, sh.bs);
  nlo = block_max<BLOCK>(nlo, sh.bs);
  const uint32_t kmax = (uint32_t)hi, kmin = (uint32_t)(-nlo);
  // the digits every participant shares are every target's
  int shift0 = -8;
  uint32_t pmask = 0xffffffffu;
  if (kmax != kmin) {
    const int hb = 31 - __clz(kmax ^ kmin);
    shift0 = hb / 8 * 8;
    pmask = shift0 + 8 >= 32 ? 0u : ~0u << (shift0 + 8);
  }
  if (threadIdx.x < 4) {
    const double qs[4] = {0.5, 0.9, 0.99, 1.0};
    const int q = threadIdx.x;
    // rank among the participants (the sorted column's position N - m +
    // idx, clipped to [0, N - 1], minus the N - m leading −1s)
    const double mf = (double)mc;
    const int32_t idx =
        (int32_t)floor(__dadd_rn(__dmul_rn(qs[q], __dsub_rn(mf, 1.0)), 0.5));
    int64_t at = (int64_t)N - mc + idx;
    at = at < 0 ? 0 : (at > N - 1 ? N - 1 : at);
    sh.kk[q] = at - ((int64_t)N - mc);
    sh.prefix[q] = kmin & pmask;
  }
  __syncthreads();
  const int nk = in_smem ? sh.nkeys : N;
  for (int shift = shift0; shift >= 0; shift -= 8) {
    for (int b = threadIdx.x; b < 4 * 256; b += BLOCK) (&sh.hist[0][0])[b] = 0;
    __syncthreads();
    uint32_t pre[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) pre[q] = sh.prefix[q];
    // one sweep: each key toward every target whose prefix it matches
    for (int i0 = 0; i0 < nk; i0 += BLOCK) {
      const int i = i0 + threadIdx.x;
      const uint32_t key =
          i < nk ? (in_smem ? skeys[i] : __ldcg(col + i)) : 0u;
      unsigned tgt = 0;
      if (key != 0)
#pragma unroll
        for (int q = 0; q < 4; ++q) tgt |= ((key & pmask) == pre[q]) << q;
      const unsigned digit = (key >> shift) & 255u;
      const unsigned tag = tgt ? (tgt << 8) | digit : 0u;
      const unsigned peers = __match_any_sync(0xffffffffu, tag);
      if (tag != 0 && __ffs(peers) - 1 == lane)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if ((tgt >> q) & 1)
            atomicAdd(&sh.hist[q][digit], (unsigned)__popc(peers));
    }
    __syncthreads();
    const int w = threadIdx.x >> 5;
    if (w < 4)
      select_bucket(sh.hist[w], sh.kk[w], &sh.bucket[w], &sh.rank[w]);
    __syncthreads();
    if (threadIdx.x < 4) {
      const int q = threadIdx.x;
      sh.prefix[q] |= sh.bucket[q] << shift;
      sh.kk[q] = sh.rank[q];
    }
    pmask |= 255u << shift;
    __syncthreads();
  }
  if (threadIdx.x < 4) out[threadIdx.x] = unkey(sh.prefix[threadIdx.x]);
  __syncthreads();
}

__global__ void __launch_bounds__(BLOCK, 1)
probe_kernel(const __grid_constant__ ProbeArgs a) {
  __shared__ ProbeShared sh;
  cg::cluster_group cl = cg::this_cluster();
  const int C = (int)cl.num_blocks(), rank = (int)cl.block_rank();
  const int N = a.N, R = a.R;
  const int span = (N + C - 1) / C;
  const int lo = min(N, rank * span), hi = min(N, lo + span);
  int64_t* part = kt_probe_dyn;          // [R, KT_PROBE_PARTS]
  for (int t = threadIdx.x; t < R * KT_PROBE_PARTS; t += BLOCK)
    part[t] = t % KT_PROBE_PARTS == 5 ? KT_I64_MIN : 0;

  // 1. a thread a row: the tight flag and the cells' keys; the domain
  // counts zeroed
  for (int n = lo + threadIdx.x; n < hi; n += BLOCK) {
    int m;
    const ProbeShard& s = a.s[shard_of(a, n, &m)];
    const bool valid = s.valid[m];
    const int64_t* cap = s.cap + (int64_t)m * R;
    const int64_t* used = s.used + (int64_t)m * R;
    // max over the row of util, 0 where the cell does not participate
    float bottleneck = -INFINITY;
    for (int r0 = 0; r0 < R; r0 += 8) {
      int64_t c8[8], u8[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        c8[j] = r0 + j < R ? cap[r0 + j] : 0;
        u8[j] = r0 + j < R ? used[r0 + j] : 0;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (r0 + j >= R) break;
        const bool p = valid && c8[j] > 0;
        const float util = p ? f32_ratio(u8[j], c8[j]) : 0.0f;
        bottleneck = fmaxf(bottleneck, util);
        a.keys[(int64_t)(r0 + j) * N + n] = p ? fkey(util) : 0u;
      }
    }
    a.tight[n] = valid && bottleneck >= 0.95f;
  }
  for (int d = rank * BLOCK + threadIdx.x; d < a.ndom; d += C * BLOCK) {
    a.dom_pods[d] = 0;
    a.dom_nodes[d] = 0;
  }
  cl.sync();

  // 2. a thread a cell of the CTA's rows, its column fixed: the column
  // partials; then a thread a row: the domain counts
  const int Wc = BLOCK / R * R;
  if ((int)threadIdx.x < Wc) {
    const int r = threadIdx.x % R;
    int64_t su = 0, sc = 0, sf = 0, ss = 0, mcnt = 0, mx = KT_I64_MIN;
    // four cells at a time, every load issued before any test
    for (int64_t e0 = (int64_t)lo * R + threadIdx.x; e0 < (int64_t)hi * R;
         e0 += 4 * (int64_t)Wc) {
      int64_t cv[4], uv[4];
      bool vv[4], tv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t e = e0 + j * (int64_t)Wc;
        const bool in = e < (int64_t)hi * R;
        const int n = in ? (int)(e / R) : lo;
        int m;
        const ProbeShard& s = a.s[shard_of(a, n, &m)];
        const int64_t k = (int64_t)m * R + r;
        vv[j] = in && s.valid[m];
        cv[j] = in ? s.cap[k] : 0;
        uv[j] = in ? s.used[k] : 0;
        tv[j] = in && __ldcg(a.tight + n);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (e0 + j * (int64_t)Wc >= (int64_t)hi * R) break;
        int64_t free = 0;
        if (vv[j] && cv[j] > 0) {
          su += uv[j];
          sc += cv[j];
          free = cv[j] - uv[j];
          ++mcnt;
        }
        sf += free;
        if (tv[j]) ss += free;
        mx = free > mx ? free : mx;
      }
    }
    int64_t* pr = part + r * KT_PROBE_PARTS;
    atomicAdd((unsigned long long*)&pr[0], (unsigned long long)su);
    atomicAdd((unsigned long long*)&pr[1], (unsigned long long)sc);
    atomicAdd((unsigned long long*)&pr[2], (unsigned long long)sf);
    atomicAdd((unsigned long long*)&pr[3], (unsigned long long)ss);
    atomicAdd((unsigned long long*)&pr[4], (unsigned long long)mcnt);
    atomicMax((long long*)&pr[5], (long long)mx);
  }
  for (int n = lo + threadIdx.x; n < hi; n += BLOCK) {
    int m;
    const ProbeShard& s = a.s[shard_of(a, n, &m)];
    if (!s.valid[m]) continue;
    int d = a.dom[n];
    d = d < 0 ? 0 : (d > a.ndom - 1 ? a.ndom - 1 : d);
    atomicAdd((unsigned long long*)(a.dom_pods + d),
              (unsigned long long)(int64_t)s.npods[m]);
    atomicAdd((unsigned long long*)(a.dom_nodes + d), 1ull);
  }
  cl.sync();

  // 3. the columns
  for (int r = rank; r < R; r += C) probe_column(a, r, sh);
  cl.sync();   // every CTA's partials read before any CTA exits

  // 4. the domain statistics and the valid count
  if (rank != 0) return;
  int64_t populated = 0, nvalid = 0;
  float dmax = -INFINITY, dmin = INFINITY;
  for (int d = threadIdx.x; d < a.ndom; d += BLOCK) {
    const int64_t nodes =
        (int64_t)__ldcg((const long long*)(a.dom_nodes + d));
    if (nodes <= 0) continue;
    ++populated;
    const float load = f32_ratio(
        (int64_t)__ldcg((const long long*)(a.dom_pods + d)), nodes);
    dmax = fmaxf(dmax, load);
    dmin = fminf(dmin, load);
  }
#pragma unroll
  for (int d = 0; d < KT_PROBE_MAX_SHARDS; ++d) {
    if (d >= a.D) break;
    const ProbeShard& s = a.s[d];
    for (int m = threadIdx.x; m < s.rows; m += BLOCK)
      nvalid += s.valid[m] != 0;
  }
  for (int o = 16; o > 0; o >>= 1) {
    dmax = fmaxf(dmax, __shfl_down_sync(0xffffffffu, dmax, o));
    dmin = fminf(dmin, __shfl_down_sync(0xffffffffu, dmin, o));
  }
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    sh.fmx[w] = dmax;
    sh.fmn[w] = dmin;
  }
  populated = block_sum<BLOCK>(populated, sh.bs);   // also syncs fmx / fmn
  nvalid = block_sum<BLOCK>(nvalid, sh.bs);
  if (threadIdx.x == 0) {
    float mx = sh.fmx[0], mn = sh.fmn[0];
    for (int k = 1; k < BLOCK / 32; ++k) {
      mx = fmaxf(mx, sh.fmx[k]);
      mn = fminf(mn, sh.fmn[k]);
    }
    const bool any = populated > 0;
    a.dom_stats[0] = __ll2float_rn(populated);
    a.dom_stats[1] = any ? mx : 0.0f;
    a.dom_stats[2] = any ? mn : 0.0f;
    a.dom_stats[3] = any ? __fsub_rn(mx, mn) : 0.0f;
    *a.valid_count = (int32_t)nvalid;
  }
}

}  // namespace

extern "C" int ktpu_cluster_probe(const ProbeArgs* args, void* stream) {
  const int smem = probe_dyn_bytes(args->N, args->R);
  cudaError_t e = cudaFuncSetAttribute(
      probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(probe_kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(KT_PROBE_CLUSTER);
  cfg.blockDim = dim3(BLOCK);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = KT_PROBE_CLUSTER;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, probe_kernel, *args);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
