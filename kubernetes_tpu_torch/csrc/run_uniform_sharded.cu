// run_uniform_sharded: the closed-form same-signature run on the mesh,
// and with the gang verdict the mesh's closed-form gang tier.
//
// Replaces kubernetes_tpu/parallel/sharding.py _run_uniform_sharded_jit
// (:519) over _uniform_local_core (:416-516), and
// _run_gang_uniform_sharded_jit (:1042-1071). Each shard evaluates the
// run's row over its N rows, takes its local top-K_loc candidates
// (K_loc = min(K, N); every member of the global top-K ranks inside its
// own shard's top-K_loc), builds their [K_loc, J] matrix of
// post-placement scores with GLOBAL entry ids, and sends its local
// top-L_loc keys; the gathered keys give the run's top-L.
//
// What only the set decides. The matrix reads its candidates as a set:
// an entry's key folds in its node and column, not the candidate's rank,
// and the monotonicity flag, the deep count and the cache refresh are
// per candidate. The local top-L_loc is read only by the merge, which
// orders it again. So both are a SELECTION (select.cuh's radix select on
// the unique keys, no sort), and only the merged top-L, which orders the
// assignments, is sorted (in shared memory where it fits). With
// K_loc = N every row is a candidate and nothing is selected.
//
// The steps of every shard, on its device's stream, with the exchange
// (kubernetes_tpu_torch/parallel/sharding.py) between them; the wrapper
// is ops/kernels.py _uniform_sharded_run:
//   1. ush_parts_kernel, a grid over the shard's rows (one thread a row):
//      the run's row parts into the fresh SigCache, the carry rows copied
//      into the output carry, and each block's image counts, valid rows
//      and feasible maxima (shard_eval.cuh's layout) as partials;
//   2. exchange: the blocks' and shards' partials summed and maxed in one
//      reduction (lean_exchange);
//   3. ush_fused_kernel, one block, when the shard's row keys and its
//      K_loc·J matrix keys fit in shared memory: the row keys (with
//      ImageLocality on a miss), the top-K_loc selection, the matrix (one
//      thread an entry), the monotonicity check, the top-L_loc
//      selection, and the shard's two flags beside its keys. Otherwise
//      (row 14c's 32,768 keys a shard) the same steps as a multi-block
//      chain: ush_keys_kernel (a grid over the rows), ush_rowsel_kernel
//      (one block; only when K_loc < N), ush_matrix_kernel (a grid over
//      the entries) and ush_select_kernel (one block);
//   4. exchange: the all-gather of every shard's [L_loc keys, 2 flags];
//   5. ush_finalize_kernel, one block: the top-L of the gathered keys,
//      sorted; the assignments; the selections per global node; the
//      verdict from what every shard holds — exact (every shard's flags),
//      depth (no node with J or more of the selected entries), placed and
//      accept — BEFORE anything is written: the placement and the cache
//      refresh at the shard's candidates only when the run applies (the
//      gang: accept ∧ exact ∧ depth; a plain run: always), else the fresh
//      SigCache takes the input's back (the only part of the output
//      carry the run wrote). Shard 0 writes the packed result.
// Each launch serves every shard of one device (up to four, then another
// launch): the grid kernels take the shard from blockIdx.y, the one-block
// kernels run one block a shard, so the shards of a card run side by side
// and each merges the gathered keys in its own block. Three launches a
// device and two exchanges a run where launch 3 fits one block.
//
// What bounds it on an H100: latency — the dependent launches, the
// exchanges between them, and each one-block step's barriers; the bytes
// (the node rows once, the matrix) are tens of microseconds of HBM time
// at most.

#include "closed_form.cuh"
#include "select.cuh"
#include "sort.cuh"

struct UniShardC {        // one shard's arguments for one run
  NodeC na;
  TableC tb;
  CarryC cin;             // read only
  CarryC cout;            // fresh tensors, written in full
  CfgC cfg;
  int32_t sig, tidx;
  int32_t offset;         // global index of the shard's row 0
  int32_t n_global;       // rows over all shards
  int32_t K, J, L, L_loc, n_actual;   // K = the local K_loc
  int32_t fused;          // launch 3 in one block
  int64_t* loc;           // [blocks, KT_SHARD_LOC] launch 1's partials
  int64_t* keys0;         // [N] the row keys (multi-block chain)
  int32_t* cand;          // [K_loc] the candidates' rows, in no order
  int64_t* keys1;         // [K_loc·J] the matrix keys (multi-block chain)
  uint8_t* fit_kj;        // [K_loc·J]
  int64_t* sfit_kj;
  int64_t* sbal_kj;
  int64_t* send;          // [L_loc + 2] top-L_loc keys, monotone, norm
  int32_t* gcount;        // [n_global] selections per global node
  int64_t* top;           // [pow2(min(D·L_loc, L))] the sorted top-L when
                          // it does not fit in shared memory, else null
};

// the shards of one device that one launch serves, blockIdx.y (grid
// kernels) or blockIdx.x (one-block kernels) picking the shard; four
// keep the launch's parameters under 4 KB
#define KT_USH_MAX_SHARDS 4
struct UniBatchC {
  UniShardC s[KT_USH_MAX_SHARDS];
};

namespace {

constexpr int PBLOCK = 256;     // the grid kernels
constexpr int SBLOCK = 1024;    // the one-block kernels

// the row key of row n (ImageLocality first on a miss): masked score,
// ties to the lowest row
__device__ __forceinline__ int64_t row_key(const UniShardC& a,
                                           const PodRowD& p, int n,
                                           bool use_fast,
                                           const int64_t* glob) {
  if (!use_fast) shard_s_img(a.na, a.tb, p, n, glob, a.cout.cache);
  return kt_row_key(a.cfg, a.cout.cache, n, a.na.N, glob);
}

// matrix entry (k, j) at candidate row `node`: its flat key
// masked · M − ((offset + node) · J + j)
__device__ __forceinline__ int64_t matrix_entry(const UniShardC& a,
                                                const PodRowD& p,
                                                const int64_t* glob, int k,
                                                int j, int node) {
  return kt_matrix_entry(a.cfg, a.na, a.cin, a.cout.cache, p, glob,
                         OvlD{nullptr, nullptr}, node,
                         (int64_t)a.offset + node, j, a.J,
                         (int64_t)a.n_global * a.J, (int64_t)k * a.J + j,
                         a.fit_kj, a.sfit_kj, a.sbal_kj);
}

// the monotonicity check over the matrix keys and the top-L_loc
// selection into a.send, with the shard's flags after the keys (one
// block; `keys1` in shared or global memory)
template <int BLOCK>
__device__ __forceinline__ void send_top(const UniShardC& a,
                                         const int64_t* keys1,
                         const int64_t* glob, SelScratch<BLOCK>& ss) {
  const int KJ = a.K * a.J;
  const int64_t M = (int64_t)a.n_global * a.J;
  bool mono = true;
  for (int e = threadIdx.x; e < KJ; e += BLOCK)
    if (e % a.J != 0
        && kt_key_score(keys1[e], M) > kt_key_score(keys1[e - 1], M))
      mono = false;
  mono = __syncthreads_and(mono);
  const auto key = [keys1](int i) { return keys1[i]; };
  const int64_t T = a.L_loc < KJ
      ? block_select_kth<BLOCK>(key, KJ, a.L_loc, ss) : KT_I64_MIN;
  block_compact_ge<BLOCK>(key, KJ, T, a.send, nullptr, ss);
  if (threadIdx.x == 0) {
    a.send[a.L_loc] = mono;
    a.send[a.L_loc + 1] = glob[KT_MAX_IC + 1] == 0 && glob[KT_MAX_IC + 2] == 0;
  }
}

// 1. the parts of every row, the carry rows copied, the block partials
__global__ void __launch_bounds__(PBLOCK) ush_parts_kernel(UniBatchC b) {
  __shared__ int64_t acc[KT_SHARD_LOC];
  const UniShardC& a = b.s[blockIdx.y];
  const int N = a.na.N, IC = a.tb.IC;
  const PodRowD p = pod_row(a.tb, a.tidx);
  const bool use_fast = a.sig != 0 && a.sig == *a.cin.cache.sig;
  if (threadIdx.x < KT_SHARD_LOC) acc[threadIdx.x] = 0;
  __syncthreads();
  int64_t cnt[KT_MAX_IC];
  for (int c = 0; c < IC; ++c) cnt[c] = 0;
  int64_t nvalid = 0, tm = 0, nm = 0;
  for (int n = blockIdx.x * PBLOCK + threadIdx.x; n < N;
       n += gridDim.x * PBLOCK) {
    kt_carry_row_copy(a.cin, a.cout, n, a.na.R);
    kt_closed_row(a.cfg, a.na, a.tb, a.cin, a.cout, p, n, use_fast,
                  OvlD{nullptr, nullptr}, cnt, nvalid, tm, nm);
  }
  // on the fast path the counts stay zero: s_img is cached
  for (int c = 0; c < IC; ++c) acc_add(&acc[c], cnt[c]);
  acc_add(&acc[KT_MAX_IC], nvalid);
  acc_max(&acc[KT_MAX_IC + 1], tm);
  acc_max(&acc[KT_MAX_IC + 2], nm);
  __syncthreads();
  if (threadIdx.x < KT_SHARD_LOC)
    a.loc[(int64_t)blockIdx.x * KT_SHARD_LOC + threadIdx.x] =
        acc[threadIdx.x];
}

// 3, fused: keys, top-K_loc, the matrix, top-L_loc in one block
__global__ void __launch_bounds__(SBLOCK)
ush_fused_kernel(UniBatchC b, const int64_t* glob) {
  extern __shared__ int64_t keys_sh[];      // the row keys, then the matrix's
  __shared__ SelScratch<SBLOCK> ss;
  const UniShardC& a = b.s[blockIdx.x];
  const int N = a.na.N, K = a.K, J = a.J;
  int32_t* cand_sh = (int32_t*)(keys_sh + (N > K * J ? N : K * J));
  const PodRowD p = pod_row(a.tb, a.tidx);
  const bool use_fast = a.sig != 0 && a.sig == *a.cin.cache.sig;
  for (int n = threadIdx.x; n < N; n += SBLOCK)
    keys_sh[n] = row_key(a, p, n, use_fast, glob);
  __syncthreads();
  if (K < N) {
    const int64_t* ks = keys_sh;
    const auto key = [ks](int i) { return ks[i]; };
    const int64_t T = block_select_kth<SBLOCK>(key, N, K, ss);
    block_compact_ge<SBLOCK>(key, N, T, nullptr, cand_sh, ss);
  } else {
    for (int k = threadIdx.x; k < K; k += SBLOCK) cand_sh[k] = k;
    __syncthreads();
  }
  for (int k = threadIdx.x; k < K; k += SBLOCK) a.cand[k] = cand_sh[k];
  // the keys region now holds the matrix: one thread an entry
  for (int e = threadIdx.x; e < K * J; e += SBLOCK)
    keys_sh[e] = matrix_entry(a, p, glob, e / J, e % J, cand_sh[e / J]);
  __syncthreads();
  send_top<SBLOCK>(a, keys_sh, glob, ss);
  if (threadIdx.x == 0) *a.cout.cache.sig = a.sig;
}

// 3, the multi-block chain: the row keys over the grid
__global__ void __launch_bounds__(PBLOCK)
ush_keys_kernel(UniBatchC b, const int64_t* glob) {
  const UniShardC& a = b.s[blockIdx.y];
  const PodRowD p = pod_row(a.tb, a.tidx);
  const bool use_fast = a.sig != 0 && a.sig == *a.cin.cache.sig;
  const int n = blockIdx.x * PBLOCK + threadIdx.x;
  if (n < a.na.N) a.keys0[n] = row_key(a, p, n, use_fast, glob);
  if (n == 0) *a.cout.cache.sig = a.sig;
}

// the top-K_loc rows (only when K_loc < N)
__global__ void __launch_bounds__(SBLOCK) ush_rowsel_kernel(UniBatchC b) {
  __shared__ SelScratch<SBLOCK> ss;
  const UniShardC& a = b.s[blockIdx.x];
  const int64_t* keys0 = a.keys0;
  const auto key = [keys0](int i) { return keys0[i]; };
  const int64_t T = block_select_kth<SBLOCK>(key, a.na.N, a.K, ss);
  block_compact_ge<SBLOCK>(key, a.na.N, T, nullptr, a.cand, ss);
}

// the matrix over the grid, one thread an entry (the candidates are the
// rows themselves when K_loc = N)
__global__ void __launch_bounds__(PBLOCK)
ush_matrix_kernel(UniBatchC b, const int64_t* glob) {
  const UniShardC& a = b.s[blockIdx.y];
  const int64_t e = (int64_t)blockIdx.x * PBLOCK + threadIdx.x;
  if (e >= (int64_t)a.K * a.J) return;
  const int k = (int)(e / a.J), j = (int)(e % a.J);
  const bool all = a.K == a.na.N;
  const int node = all ? k : a.cand[k];
  if (all && j == 0) a.cand[k] = k;
  const PodRowD p = pod_row(a.tb, a.tidx);
  a.keys1[e] = matrix_entry(a, p, glob, k, j, node);
}

__global__ void __launch_bounds__(SBLOCK)
ush_select_kernel(UniBatchC b, const int64_t* glob) {
  __shared__ SelScratch<SBLOCK> ss;
  const UniShardC& a = b.s[blockIdx.x];
  send_top<SBLOCK>(a, a.keys1, glob, ss);
}

// the gathered keys sorted in shared memory whole up to this many
constexpr int SORT_ALL = 4096;

// 5. the merged top-L, the verdict, then the carry (see the header).
// `gathered` is [D, L_loc + 2]; the block of shard `packed_at` of the
// launch writes `packed`: [L assignments; exact; depth], or with `gang`
// [L; accept; placed; exact; depth].
__global__ void __launch_bounds__(SBLOCK)
ush_finalize_kernel(UniBatchC b, const int64_t* gathered, int D,
                    int32_t* packed, int packed_at, int needed, int gang) {
  extern __shared__ int64_t top_sh[];
  __shared__ SelScratch<SBLOCK> ss;
  __shared__ int64_t placed_sh;
  const UniShardC& a = b.s[blockIdx.x];
  int32_t* out = (int)blockIdx.x == packed_at ? packed : nullptr;
  const int t = threadIdx.x;
  const int N = a.na.N, R = a.na.R, J = a.J, L = a.L, L_loc = a.L_loc;
  const int64_t M = (int64_t)a.n_global * J;
  int64_t* top = a.top ? a.top : top_sh;
  for (int g = t; g < a.n_global; g += SBLOCK) a.gcount[g] = 0;
  if (t == 0) placed_sh = 0;
  // exact: every shard's monotonicity and the normalization constancy
  bool ok = true;
  for (int d = t; d < D; d += SBLOCK) {
    const int64_t* f = gathered + (int64_t)d * (L_loc + 2) + L_loc;
    ok = ok && f[0] != 0 && f[1] != 0;
  }
  const bool exact = __syncthreads_and(ok);
  // the top-L of the D·L_loc gathered keys, sorted
  const int n = D * L_loc;
  const int take = n < L ? n : L;
  const auto key = [gathered, L_loc](int i) {
    return gathered[(int64_t)(i / L_loc) * (L_loc + 2) + i % L_loc];
  };
  int P = 1;
  if (n <= SORT_ALL) {
    while (P < n) P <<= 1;
    for (int i = t; i < P; i += SBLOCK) top[i] = i < n ? key(i) : KT_I64_MIN;
  } else {
    const int64_t T = take < n
        ? block_select_kth<SBLOCK>(key, n, take, ss) : KT_I64_MIN;
    block_compact_ge<SBLOCK>(key, n, T, top, nullptr, ss);
    while (P < take) P <<= 1;
    for (int i = take + t; i < P; i += SBLOCK) top[i] = KT_I64_MIN;
  }
  block_sort_desc<SBLOCK>(top, P);
  // the assignments and the selections per global node
  int64_t placed = 0;
  for (int i = t; i < L; i += SBLOCK) {
    const int64_t k = i < take ? top[i] : KT_I64_MIN;
    if (i < take && i < a.n_actual && k > -M) {
      atomicAdd(&a.gcount[(kt_key_score(k, M) * M - k) / J], 1);
      ++placed;
    }
  }
  acc_add(&placed_sh, placed);
  __syncthreads();
  bool deep = false;
  for (int i = t; i < L; i += SBLOCK) {
    const int64_t k = i < take ? top[i] : KT_I64_MIN;
    int32_t g = -1;
    if (i < take && i < a.n_actual && k > -M) {
      g = (int32_t)((kt_key_score(k, M) * M - k) / J);     // global node
      deep = deep || a.gcount[g] >= J;
    }
    if (out) out[i] = g;
  }
  const bool depth = !__syncthreads_or(deep);
  const int64_t np = placed_sh;
  const bool accept = np >= needed;
  const bool apply = !gang || (accept && exact && depth);
  if (out && t == 0) {
    if (gang) {
      out[L] = accept;
      out[L + 1] = (int32_t)np;
      out[L + 2] = exact;
      out[L + 3] = depth;
    } else {
      out[L] = exact;
      out[L + 1] = depth;
    }
  }
  const CarryC& c = a.cout;
  if (apply) {
    const PodRowD p = pod_row(a.tb, a.tidx);
    for (int k = t; k < a.K; k += SBLOCK) {
      const int node = a.cand[k];
      kt_closed_apply(c, p, R, node, a.gcount[a.offset + node], J,
                      (int64_t)k * J, a.fit_kj, a.sfit_kj, a.sbal_kj);
    }
  } else {
    for (int r = t; r < N; r += SBLOCK) kt_cache_copy(a.cin.cache, c.cache, r);
    if (t == 0) *c.cache.sig = *a.cin.cache.sig;
  }
}

size_t fused_smem(const UniShardC& a) {
  const int KJ = a.K * a.J;
  return (size_t)(a.na.N > KJ ? a.na.N : KJ) * sizeof(int64_t)
       + (size_t)a.K * sizeof(int32_t);
}

int set_smem(const void* fn, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

// every entry takes the device's first `S` shards of `b` (S <= 4, one
// shape): the shard index is blockIdx.y of the grid kernels and blockIdx.x
// of the one-block kernels

// 1: `blocks` = ceil(N / 256), the partials' rows a shard
extern "C" int ktpu_ush_parts(const UniBatchC* b, int S, int blocks,
                              void* stream) {
  ush_parts_kernel<<<dim3(blocks, S), PBLOCK, 0, (cudaStream_t)stream>>>(
      *b);
  return (int)cudaGetLastError();
}

// 3: the fused kernel, or the multi-block chain
extern "C" int ktpu_ush_select(const UniBatchC* b, int S, const int64_t* glob,
                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const UniShardC& a = b->s[0];
  if (a.fused) {
    const size_t smem = fused_smem(a);
    const int rc = set_smem((const void*)ush_fused_kernel, smem);
    if (rc) return rc;
    ush_fused_kernel<<<S, SBLOCK, smem, s>>>(*b, glob);
    return (int)cudaGetLastError();
  }
  const int N = a.na.N;
  const int64_t KJ = (int64_t)a.K * a.J;
  ush_keys_kernel<<<dim3((N + PBLOCK - 1) / PBLOCK, S), PBLOCK, 0, s>>>(
      *b, glob);
  if (a.K < N) ush_rowsel_kernel<<<S, SBLOCK, 0, s>>>(*b);
  ush_matrix_kernel<<<dim3((unsigned)((KJ + PBLOCK - 1) / PBLOCK), S),
                      PBLOCK, 0, s>>>(*b, glob);
  ush_select_kernel<<<S, SBLOCK, 0, s>>>(*b, glob);
  return (int)cudaGetLastError();
}

// 5: the finalize; `packed` is written by shard `packed_at` of the launch
// (-1: none of them)
extern "C" int ktpu_ush_finalize(const UniBatchC* b, int S,
                                 const int64_t* gathered, int D,
                                 int32_t* packed, int packed_at, int needed,
                                 int gang, void* stream) {
  const UniShardC& a = b->s[0];
  size_t smem = 0;
  if (!a.top) {
    const int n = D * a.L_loc, take = n < a.L ? n : a.L;
    int P = 1;
    while (P < (n <= SORT_ALL ? n : take)) P <<= 1;
    smem = (size_t)P * sizeof(int64_t);
  }
  const int rc = set_smem((const void*)ush_finalize_kernel, smem);
  if (rc) return rc;
  ush_finalize_kernel<<<S, SBLOCK, smem, (cudaStream_t)stream>>>(
      *b, gathered, D, packed, packed_at, needed, gang);
  return (int)cudaGetLastError();
}
