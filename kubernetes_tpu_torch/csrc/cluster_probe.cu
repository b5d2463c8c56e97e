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
// _probe_math there) is the same entry on its shards: the kernels take a
// shard table by value, up to KT_PROBE_MAX_SHARDS shards (row 11, one
// device, is the table of one shard). A global row is its shard's offset
// plus its local row, the shards in mesh order; every statistic is an
// exact sum, a max, a count or a rank over the same cells as the gathered
// columns, so the outputs keep their bits without the gather.
//
// What bounds it on an H100: the bytes. It needs the valid rows' cap,
// the participating cells' used and the node columns once (under 0.9 MB
// at 5,000 valid nodes of 8,192 and R = 16); the work is a few
// comparisons per cell. At that size each of the three launches is a few
// microseconds of launch latency.
//
// Design: three launches on the drain's stream, their scratch and outputs
// carved by the wrapper from one allocation.
//   (a) one thread per node: the bottleneck util and tight flag into a
//       scratch byte per node; the [ndom] domain counts zeroed;
//   (b) five blocks per resource column: one takes the int64 sums and
//       the max free block, each of the other four one order statistic
//       by a radix select over the f32 bits (four 8-bit passes, a
//       256-bucket shared histogram each, its bucket found by a warp
//       scan), which works at any N where a shared-memory sort would stop
//       fitting past 2^15 nodes; after them, blocks of a thread per node
//       add the per-domain pod / node counts as int64 atomics;
//   (c) one block: the domain statistics and the valid count.
// The kernels never write their inputs.

#include "lean_eval.cuh"

#define KT_PROBE_MAX_SHARDS 4

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
  int64_t* dom_pods;      // [ndom] scratch, zeroed by launch (a)
  int64_t* dom_nodes;     // [ndom] scratch, zeroed by launch (a)
  float* per_res;         // [R, 7]
  float* dom_stats;       // [4]
  int32_t* valid_count;   // []
};

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

// launch (a): a thread per global row, and the [ndom] domain counts
// zeroed, a thread an entry
__global__ void __launch_bounds__(256)
probe_nodes(const __grid_constant__ ProbeArgs a) {
  const int n = blockIdx.x * 256 + threadIdx.x;
  if (n < a.N) {
    int m;
    const ProbeShard& s = a.s[shard_of(a, n, &m)];
    // max over the row of util, 0 where the cell does not participate
    float bottleneck = -INFINITY;
    for (int r = 0; r < a.R; ++r)
      bottleneck = fmaxf(bottleneck, participates(s, m, a.R, r)
                                         ? util_of(s, m, a.R, r) : 0.0f);
    a.tight[n] = s.valid[m] && bottleneck >= 0.95f;
  }
  if (n < a.ndom) {
    a.dom_pods[n] = 0;
    a.dom_nodes[n] = 0;
  }
}

// the bucket of the 256-bucket histogram that holds rank kk among the
// keys counted, and kk's rank inside it: warp 0, eight buckets a lane,
// an inclusive scan of the lanes' counts; the lane whose range covers kk
// walks its eight (the first bucket b with Σ hist[0..b] > kk, 255 when
// none is)
__device__ __forceinline__ void select_bucket(const uint32_t* hist,
                                              int64_t kk, uint32_t* bucket,
                                              int64_t* rank) {
  const int lane = threadIdx.x;
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

// launch (b): blocks [0, 5R) — block 5r + q < 4 selects column r's order
// statistic q, block 5r + 4 takes the column's sums and its max free block
// — then blocks of a thread per global row add the domain counts
__global__ void __launch_bounds__(BLOCK)
probe_columns(const __grid_constant__ ProbeArgs a) {
  __shared__ BlockScratch<BLOCK> sh;
  __shared__ uint32_t hist[256];
  __shared__ uint32_t sel_bucket;
  __shared__ int64_t sel_rank;
  const int R = a.R, N = a.N;
  if ((int)blockIdx.x >= 5 * R) {
    const int n = (blockIdx.x - 5 * R) * BLOCK + threadIdx.x;
    if (n >= N) return;
    int m;
    const ProbeShard& s = a.s[shard_of(a, n, &m)];
    if (!s.valid[m]) return;
    int d = a.dom[n];
    d = d < 0 ? 0 : (d > a.ndom - 1 ? a.ndom - 1 : d);
    atomicAdd((unsigned long long*)(a.dom_pods + d),
              (unsigned long long)(int64_t)s.npods[m]);
    atomicAdd((unsigned long long*)(a.dom_nodes + d), 1ull);
    return;
  }
  const int r = blockIdx.x / 5;
  const int qi = blockIdx.x % 5;
  float* out = a.per_res + (int64_t)r * 7;
  if (qi == 4) {
    int64_t s_used = 0, s_cap = 0, s_free = 0, s_strand = 0;
    int64_t mx = KT_I64_MIN;
    int off = 0;
#pragma unroll
    for (int d = 0; d < KT_PROBE_MAX_SHARDS; ++d) {
      if (d >= a.D) break;
      const ProbeShard& s = a.s[d];
      for (int m = threadIdx.x; m < s.rows; m += BLOCK) {
        int64_t free = 0;
        if (participates(s, m, R, r)) {
          const int64_t k = (int64_t)m * R + r;
          s_used += s.used[k];
          s_cap += s.cap[k];
          free = s.cap[k] - s.used[k];
        }
        s_free += free;
        if (a.tight[off + m]) s_strand += free;
        mx = free > mx ? free : mx;
      }
      off += s.rows;
    }
    s_used = block_sum<BLOCK>(s_used, sh);
    s_cap = block_sum<BLOCK>(s_cap, sh);
    s_free = block_sum<BLOCK>(s_free, sh);
    s_strand = block_sum<BLOCK>(s_strand, sh);
    mx = block_max<BLOCK>(mx, sh);
    if (threadIdx.x == 0) {
      out[4] = s_cap > 0 ? f32_ratio(s_used, s_cap) : 0.0f;
      out[5] = s_free > 0 ? __fsub_rn(1.0f, f32_ratio(mx, s_free)) : 0.0f;
      out[6] = s_free > 0 ? f32_ratio(s_strand, s_free) : 0.0f;
    }
    return;
  }
  int64_t mcount = 0;
#pragma unroll
  for (int d = 0; d < KT_PROBE_MAX_SHARDS; ++d) {
    if (d >= a.D) break;
    const ProbeShard& s = a.s[d];
    for (int m = threadIdx.x; m < s.rows; m += BLOCK)
      mcount += participates(s, m, R, r);
  }
  const int64_t mc = block_sum<BLOCK>(mcount, sh);
  if (mc == 0) {
    if (threadIdx.x == 0) out[qi] = 0.0f;
    return;
  }
  const double qs[4] = {0.5, 0.9, 0.99, 1.0};
  // rank among the participants (the sorted column's position N - m +
  // idx, clipped to [0, N - 1], minus the N - m leading −1s)
  const double mf = (double)mc;
  const int32_t idx =
      (int32_t)floor(__dadd_rn(__dmul_rn(qs[qi], __dsub_rn(mf, 1.0)), 0.5));
  int64_t at = (int64_t)N - mc + idx;
  at = at < 0 ? 0 : (at > N - 1 ? N - 1 : at);
  int64_t kk = at - ((int64_t)N - mc);
  uint32_t prefix = 0, pmask = 0;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int b = threadIdx.x; b < 256; b += BLOCK) hist[b] = 0;
    __syncthreads();
#pragma unroll
    for (int d = 0; d < KT_PROBE_MAX_SHARDS; ++d) {
      if (d >= a.D) break;
      const ProbeShard& s = a.s[d];
      for (int m = threadIdx.x; m < s.rows; m += BLOCK) {
        if (!participates(s, m, R, r)) continue;
        const uint32_t key = fkey(util_of(s, m, R, r));
        if ((key & pmask) == prefix)
          atomicAdd(&hist[(key >> shift) & 255u], 1u);
      }
    }
    __syncthreads();
    if (threadIdx.x < 32) select_bucket(hist, kk, &sel_bucket, &sel_rank);
    __syncthreads();
    prefix |= sel_bucket << shift;
    pmask |= 255u << shift;
    kk = sel_rank;
    __syncthreads();
  }
  if (threadIdx.x == 0) out[qi] = unkey(prefix);
}

// launch (c): one block
__global__ void __launch_bounds__(BLOCK)
probe_domains(const __grid_constant__ ProbeArgs a) {
  __shared__ BlockScratch<BLOCK> sh;
  __shared__ float fmx[BLOCK / 32], fmn[BLOCK / 32];
  int64_t populated = 0, nvalid = 0;
  float dmax = -INFINITY, dmin = INFINITY;
  for (int d = threadIdx.x; d < a.ndom; d += BLOCK) {
    if (a.dom_nodes[d] <= 0) continue;
    ++populated;
    const float load = f32_ratio(a.dom_pods[d], a.dom_nodes[d]);
    dmax = fmaxf(dmax, load);
    dmin = fminf(dmin, load);
  }
#pragma unroll
  for (int d = 0; d < KT_PROBE_MAX_SHARDS; ++d) {
    if (d >= a.D) break;
    const ProbeShard& s = a.s[d];
    for (int m = threadIdx.x; m < s.rows; m += BLOCK) nvalid += s.valid[m] != 0;
  }
  for (int o = 16; o > 0; o >>= 1) {
    dmax = fmaxf(dmax, __shfl_down_sync(0xffffffffu, dmax, o));
    dmin = fminf(dmin, __shfl_down_sync(0xffffffffu, dmin, o));
  }
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    fmx[w] = dmax;
    fmn[w] = dmin;
  }
  populated = block_sum<BLOCK>(populated, sh);   // also syncs fmx / fmn
  nvalid = block_sum<BLOCK>(nvalid, sh);
  if (threadIdx.x == 0) {
    float mx = fmx[0], mn = fmn[0];
    for (int k = 1; k < BLOCK / 32; ++k) {
      mx = fmaxf(mx, fmx[k]);
      mn = fminf(mn, fmn[k]);
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
  const ProbeArgs& a = *args;
  cudaStream_t st = (cudaStream_t)stream;
  const int n_a = a.N > a.ndom ? a.N : a.ndom;
  if (n_a > 0) probe_nodes<<<(n_a + 255) / 256, 256, 0, st>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int blocks = 5 * a.R + (a.N + BLOCK - 1) / BLOCK;
  if (blocks > 0) probe_columns<<<blocks, BLOCK, 0, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  probe_domains<<<1, BLOCK, 0, st>>>(a);
  return (int)cudaGetLastError();
}
