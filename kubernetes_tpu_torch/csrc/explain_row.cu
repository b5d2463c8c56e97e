// explain_row: the per-plugin score decomposition of one signature row
// at one carry, and its top-k nodes.
//
// Replaces kubernetes_tpu/ops/program.py explain_row (:700; the jits
// _explain_lean :695 and _explain_groups :689 over _explain_masks :663).
// The row is evaluated exactly as one scan step evaluates it (_eval_pod
// with sig = 0, so the SigCache is never read; no overlay): the lean
// filters and scores of lean_eval.cuh, and with groups the group mask
// folded into the feasible set before the TaintToleration / NodeAffinity
// normalization and the group scores of group_eval.cuh. Then for every
// node, feasible or not, the columns
//   w_fit·s_fit, w_balanced·s_bal, w_taint·norm(taint, reversed),
//   w_node_affinity·norm(affinity), w_image·s_img, total − base,
// and the key = int32(total) where feasible, −1 elsewhere. The top k keys
// in descending order, ties to the lowest index (lax.top_k's order), give
// idx; totals is the int64 masked total at idx, cols the columns at idx,
// and the fourth output the feasible count.
//
// What bounds it on an H100: one row over N nodes, a few hundred bytes
// per node (the node columns, the carry rows, with groups the row's
// [SC / TA / TAA, N] tensors): at N = 8,192 a few MB at most, a
// microsecond of HBM time; the per-row filters are dependent loads, so
// the row's latency is what remains, and it shrinks with the rows spread
// over the card.
//
// Design: ONE cooperative launch, a grid of G = min(ceil(N / 256), SMs)
// blocks, one thread a node row (grid-stride past G · 256 rows). The
// cluster-wide values — the spread minima, ImageLocality's image counts,
// the two normalization maxima, the feasible count, and with groups the
// scored count, the distinct domains (the first setter of a domain flag
// counts it), the inter-pod score range and the raw spread range — are
// per-block partials (warp shuffles, shared atomics) written to a
// [G, parts] buffer, and every block reduces that buffer after a grid
// barrier (cooperative_groups grid.sync: the cooperative launch makes the
// whole grid resident, so the barrier cannot hang; at most four barriers
// a call, two for a lean row). The top-k needs no k rounds: each node's
// key is packed as (int64)int32(masked) << 32 | (N − 1 − n), unique, so
// its largest value is the first maximum with ties to the lowest index;
// each block sorts its rows' packed keys in shared memory and keeps k,
// and block 0 sorts the G·k candidates and writes idx, totals, cols and
// the feasible count. Every sum, minimum and maximum is an integer one,
// so the order of the reductions changes no bit. The grid barrier needs
// no relocatable device code (-rdc) under CUDA 12: grid.sync runs on the
// workspace the cooperative launch hands the kernel (only the multi-grid
// group needs the device runtime), so this source builds with the common
// flags (ops/kernels.py NVCC_FLAGS).

#include <cooperative_groups.h>

#include "group_eval.cuh"
#include "select.cuh"
#include "sort.cuh"

namespace cg = cooperative_groups;

// the kernel's arguments, mirrored field for field by ctypes
// (ops/kernels.py ExplainArgsC); every scratch pointer is a piece of one
// buffer the wrapper allocates
struct ExplainArgs {
  NodeC na;
  TableC tb;
  CarryC c;               // c.cache: scratch the kernel fills (sig unused)
  CfgC cfg;
  GroupsC g;
  GCarryC gc;
  FamC fam;
  int32_t has_groups, tidx, k;
  int64_t w_spread, w_ipa;
  int64_t* part;          // [G, NP] per-block partials
  int64_t* cand;          // [G, k] each block's top-k packed keys
  int64_t* masked;        // [N] total where feasible, else −1
  int64_t* gsc;           // [N] raw spread, then weighted group scores
  uint8_t* feas;          // [N] the feasible set
  int32_t* flags;         // [SC * N] spread domain flags
  int32_t* idx;           // [k]
  int64_t* totals;        // [k]
  int64_t* cols;          // [k, 6]
  int32_t* feasible;      // []
};

namespace {

constexpr int BLOCK = 256;

// the partials' columns: sums, then maxima, then minima
constexpr int OFF_CNT = 0;                    // image counts [KT_MAX_IC]
constexpr int OFF_VALID = OFF_CNT + KT_MAX_IC;
constexpr int OFF_NFEAS = OFF_VALID + 1;
constexpr int OFF_NPART = OFF_NFEAS + 1;      // scored rows
constexpr int OFF_DIST = OFF_NPART + 1;       // distinct domains [SC]
constexpr int OFF_TMAX = OFF_DIST + KT_MAX_SC;
constexpr int OFF_NAMAX = OFF_TMAX + 1;
constexpr int OFF_HI = OFF_NAMAX + 1;         // inter-pod score range
constexpr int OFF_RMAX = OFF_HI + 1;          // raw spread range
constexpr int OFF_MIN = OFF_RMAX + 1;         // spread minima [SC]
constexpr int OFF_LO = OFF_MIN + KT_MAX_SC;
constexpr int OFF_RMIN = OFF_LO + 1;
constexpr int NP = OFF_RMIN + 1;

__device__ __forceinline__ int64_t part_identity(int c) {
  if (c < OFF_TMAX) return 0;
  if (c == OFF_HI) return -KT_I64_MAX;
  if (c < OFF_MIN) return 0;
  if (c == OFF_LO) return KT_I64_MAX;
  return KT_INT32_MAX;                        // the minima, rmin
}

// this block's partials to part[blockIdx.x], a grid barrier, then every
// block's reduction of all G rows into glob (shared). A phase only moves
// its own columns of acc, so a block that rewrites its row for the next
// phase while another still reduces this one changes no column that
// reduction reads.
__device__ void grid_reduce(cg::grid_group& grid, const int64_t* acc,
                            int64_t* part, int64_t* glob) {
  __syncthreads();
  const int t = threadIdx.x;
  if (t < NP) {
    part[(int64_t)blockIdx.x * NP + t] = acc[t];
    glob[t] = part_identity(t);
  }
  grid.sync();
  // every thread folds a few of the G·NP partials into its block's glob
  for (int e = t; e < (int)gridDim.x * NP; e += blockDim.x) {
    const int c = e % NP;
    const int64_t x = part[e];
    if (c < OFF_TMAX)
      atomicAdd((unsigned long long*)&glob[c], (unsigned long long)x);
    else if (c < OFF_MIN)
      atomicMax((long long*)&glob[c], (long long)x);
    else
      atomicMin((long long*)&glob[c], (long long)x);
  }
  __syncthreads();
}

// the packed top-k key: int32 key high, N − 1 − n low
__device__ __forceinline__ int64_t pack_key(int64_t masked, int n, int N) {
  return (int64_t)(int32_t)masked * 4294967296LL + (int64_t)(N - 1 - n);
}

__global__ void __launch_bounds__(BLOCK) explain_kernel(ExplainArgs a) {
  extern __shared__ int64_t keys_sh[];
  __shared__ int64_t acc[NP];
  __shared__ int64_t glob[NP];
  __shared__ int32_t minv[KT_MAX_SC];
  cg::grid_group grid = cg::this_grid();
  const int N = a.na.N, t = threadIdx.x;
  const int stride = gridDim.x * BLOCK;
  const int first = blockIdx.x * BLOCK + t;
  const bool groups = a.has_groups != 0;
  const bool gscores = groups && (a.fam.spr_s || a.fam.ipa_score);
  const bool spread_s = gscores && a.fam.spr_s;
  const PodRowD p = pod_row(a.tb, a.tidx);
  const CacheC& pc = a.c.cache;
  const int IC = a.tb.IC;
  GViewD v;
  if (t < NP) acc[t] = part_identity(t);
  if (groups) v = view_of(a.g, a.gc, a.tidx);
  if (groups && (a.fam.spr_f || spread_s)) {
    // phase A: the DoNotSchedule minima; the domain flags zeroed
    if (a.fam.spr_f) {
      for (int c = 0; c < v.SC; ++c) {
        int64_t m = KT_INT32_MAX;
        for (int n = first; n < N; n += stride) {
          const int64_t k = (int64_t)c * N + n;
          if (v.f_elig[k] && v.f_cnt[k] < m) m = v.f_cnt[k];
        }
        __syncthreads();
        acc_min(&acc[OFF_MIN + c], m);
      }
    }
    if (spread_s)
      for (int64_t e = first; e < (int64_t)v.SC * N; e += stride)
        a.flags[e] = 0;
    grid_reduce(grid, acc, a.part, glob);
    if (t < v.SC)
      minv[t] = v.f_minz[t] ? 0 : (int32_t)glob[OFF_MIN + t];
    __syncthreads();
  }

  // phase B: the row's parts, the feasible set, the first partials
  {
    int64_t cnt[KT_MAX_IC];
    for (int c = 0; c < IC; ++c) cnt[c] = 0;
    int64_t nvalid = 0, nfeas = 0, npart = 0, tm = 0, nm = 0;
    int64_t lo = KT_I64_MAX, hi = -KT_I64_MAX;
    int64_t dist[KT_MAX_SC];
    for (int c = 0; c < KT_MAX_SC; ++c) dist[c] = 0;
    for (int n = first; n < N; n += stride) {
      const bool gm = !groups || kt_group_mask(v, a.fam, n, minv);
      const uint32_t bits = kt_row_parts(a.cfg, a.na, a.tb, a.c, p, n, pc);
      nvalid += a.na.valid[n] != 0;
      for (int c = 0; c < IC; ++c) cnt[c] += (bits >> c) & 1u;
      const bool f = gm && pc.static_mask[n] && pc.fit_ok[n];
      a.feas[n] = f;
      if (!f) continue;
      ++nfeas;
      tm = pc.taint_raw[n] > tm ? pc.taint_raw[n] : tm;
      nm = pc.na_raw[n] > nm ? pc.na_raw[n] : nm;
      if (gscores && a.fam.ipa_score) {
        const int64_t s = v.iscore[n];
        lo = s < lo ? s : lo;
        hi = s > hi ? s : hi;
      }
      if (spread_s && v.s_keys_ok[n]) {
        ++npart;
        for (int c = 0; c < v.SC; ++c) {
          const int64_t k = (int64_t)c * N;
          if (atomicExch(&a.flags[k + v.s_dom[k + n]], 1) == 0) ++dist[c];
        }
      }
    }
    __syncthreads();
    for (int c = 0; c < IC; ++c) acc_add(&acc[OFF_CNT + c], cnt[c]);
    acc_add(&acc[OFF_VALID], nvalid);
    acc_add(&acc[OFF_NFEAS], nfeas);
    acc_max(&acc[OFF_TMAX], tm);
    acc_max(&acc[OFF_NAMAX], nm);
    if (gscores) {
      acc_add(&acc[OFF_NPART], npart);
      for (int c = 0; c < KT_MAX_SC; ++c) acc_add(&acc[OFF_DIST + c], dist[c]);
      acc_min(&acc[OFF_LO], lo);
      acc_max(&acc[OFF_HI], hi);
    }
    grid_reduce(grid, acc, a.part, glob);
  }
  const int64_t tmax = glob[OFF_TMAX], namax = glob[OFF_NAMAX];

  // phase C: ImageLocality from the cluster-wide counts; with the
  // ScheduleAnyway family the raw spread scores and their range
  {
    double weight[KT_MAX_SC];
    if (spread_s)
      for (int c = 0; c < v.SC; ++c) {
        const int64_t size =
            v.s_is_host[c] ? glob[OFF_NPART] : glob[OFF_DIST + c];
        weight[c] = log(__dadd_rn((double)size, 2.0));
      }
    int64_t rl = KT_INT32_MAX, rh = 0;
    for (int n = first; n < N; n += stride) {
      pc.s_img[n] = kt_row_s_img(a.na, a.tb, p, n, &glob[OFF_CNT],
                                 glob[OFF_VALID]);
      if (!spread_s) continue;
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
      a.gsc[n] = r;
      if (a.feas[n] && v.s_keys_ok[n]) {
        rl = r < rl ? r : rl;
        rh = r > rh ? r : rh;
      }
    }
    if (spread_s) {
      __syncthreads();
      acc_min(&acc[OFF_RMIN], rl);
      acc_max(&acc[OFF_RMAX], rh);
      grid_reduce(grid, acc, a.part, glob);
    }
  }

  // phase D: totals, the packed keys, each block's top k
  const bool has_s = spread_s && kt_has_s(v);
  const int rounds = (N + stride - 1) / stride;
  int P = BLOCK;
  while (P < rounds * BLOCK) P <<= 1;
  for (int i = t; i < P; i += BLOCK) keys_sh[i] = KT_I64_MIN;
  __syncthreads();
  for (int r = 0, n = first; n < N; ++r, n += stride) {
    int64_t total = kt_total(a.cfg, pc, n, tmax, namax);
    const bool f = a.feas[n] != 0;
    if (gscores) {
      const int64_t gs = kt_group_score(
          v, a.fam, n, f, a.gsc[n], a.w_spread, a.w_ipa, has_s,
          glob[OFF_RMIN], glob[OFF_RMAX], glob[OFF_LO], glob[OFF_HI]);
      a.gsc[n] = gs;
      total += gs;
    }
    const int64_t m = f ? total : -1;
    a.masked[n] = m;
    keys_sh[r * BLOCK + t] = pack_key(m, n, N);
  }
  block_sort_desc<BLOCK>(keys_sh, P);
  if (t < a.k) a.cand[(int64_t)blockIdx.x * a.k + t] = keys_sh[t];
  grid.sync();

  // phase E, block 0: the merge of the G·k candidates
  if (blockIdx.x != 0) return;
  const int nc = gridDim.x * a.k;
  int Pm = 1;
  while (Pm < nc) Pm <<= 1;
  for (int i = t; i < Pm; i += BLOCK)
    keys_sh[i] = i < nc ? a.cand[i] : KT_I64_MIN;
  block_sort_desc<BLOCK>(keys_sh, Pm);
  if (t < a.k) {
    const int n = N - 1 - (int)(uint32_t)(uint64_t)keys_sh[t];
    int64_t* row = a.cols + (int64_t)t * 6;
    row[0] = a.cfg.w_fit * pc.s_fit[n];
    row[1] = a.cfg.w_balanced * pc.s_bal[n];
    row[2] = a.cfg.w_taint * kt_normalize(pc.taint_raw[n], tmax, true);
    row[3] = a.cfg.w_node_affinity * kt_normalize(pc.na_raw[n], namax, false);
    row[4] = a.cfg.w_image * pc.s_img[n];
    row[5] = gscores ? a.gsc[n] : 0;
    a.idx[t] = n;
    a.totals[t] = a.masked[n];
  }
  if (t == 0) *a.feasible = (int32_t)glob[OFF_NFEAS];
}

}  // namespace

// the partials' width, for the wrapper's scratch
extern "C" int ktpu_explain_parts() { return NP; }

// grid: the wrapper's G (its part / cand scratch is sized by it)
extern "C" int ktpu_explain_row(const ExplainArgs* args, int grid,
                                void* stream) {
  const ExplainArgs a = *args;
  const int N = a.na.N;
  if (N <= 0 || a.k <= 0 || grid <= 0) return (int)cudaGetLastError();
  const int stride = grid * BLOCK;
  const int rounds = (N + stride - 1) / stride;
  int P = BLOCK, Pm = 1;
  while (P < rounds * BLOCK) P <<= 1;
  while (Pm < grid * a.k) Pm <<= 1;
  const size_t smem = (size_t)(P > Pm ? P : Pm) * sizeof(int64_t);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        explain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  void* kargs[] = {(void*)&a};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)explain_kernel, dim3(grid), dim3(BLOCK), kargs, smem,
      (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
