// run_uniform_sharded: the closed-form same-signature run on the mesh.
//
// Replaces kubernetes_tpu/parallel/sharding.py _run_uniform_sharded_jit
// (:519) over _uniform_local_core (:416-516). Each shard evaluates the
// run's row over its N rows, takes its local top-K_loc candidates
// (K_loc = min(K, N); every member of the global top-K ranks inside its
// own shard's top-K_loc), builds their [K_loc, J] matrix with GLOBAL
// entry ids, and takes its local top-L_loc keys; the all-gathered keys
// merge into the run's top-L. Launches per shard, on the shard's stream,
// with the exchange (kubernetes_tpu_torch/parallel/sharding.py) between
// them; the wrapper is ops/kernels.py run_uniform_sharded_cuda:
//   1. ktpu_uniform_shard_parts (one block): the run's row over the shard,
//      as run_uniform.cu launch 1 does, into the fresh SigCache, with the
//      image counts and the feasible maxima sent out (shard_eval.cuh);
//   2. exchange: the sums and maxima;
//   3. ktpu_uniform_shard_topk: ImageLocality on a miss and the static
//      scores with the cluster-wide maxima, then the row keys (one block);
//      the local top-K_loc, ties to the lowest index (a bitonic sort,
//      sort.cuh); the [K_loc, J] matrix with entry ids (offset + cand)·J
//      + j (uniform_matrix.cuh); the local top-L_loc (a second sort).
//      Keys stay int64, as in run_uniform.cu;
//   4. exchange: the all-gather of the D·L_loc keys. A key decodes to its
//      global node, so no node list rides along;
//   5. ktpu_uniform_merge, once per device: the hand-written merge top-L,
//      the gathered keys padded to a power of two and sorted (sort.cuh);
//   6. ktpu_uniform_shard_finalize (one block): the assignments, the
//      shard's counts, carry update and cache refresh at its candidates,
//      and its flags: exact (monotonicity on its candidates and the
//      normalization constancy) and depth;
//   7. exchange: the min of the flags (the JAX program's pmin).
// The flags are checked over a superset of the single-device candidates,
// so they may be False where run_uniform's are True (the scheduler then
// replays on the scan); the assignments equal run_uniform's wherever both
// report exact.
//
// What bounds it on an H100: as run_uniform.cu, latency — the sorts and
// the dependent launches — now 4·D + 1 of them plus the exchange.

#include "shard_eval.cuh"
#include "sort.cuh"
#include "uniform_matrix.cuh"

struct UniShardC {        // one shard's arguments for one run
  NodeC na;
  TableC tb;
  CarryC cin;             // read only
  CarryC cout;            // fresh copies, written
  CfgC cfg;
  int32_t sig, tidx;
  int32_t offset;         // global index of the shard's row 0
  int32_t n_global;       // rows over all shards
  int32_t K, J, L, n_actual;   // K = the local K_loc
  int64_t* loc;           // [KT_SHARD_LOC] the shard's exchanged parts
  int64_t* static_add;    // [N]
  int64_t* keys0;         // [P0]
  int32_t P0;
  int32_t* cand;          // [K_loc]
  int64_t* keys1;         // [P1]
  int32_t P1;
  uint8_t* fit_kj;        // [K_loc·J]
  int64_t* sfit_kj;
  int64_t* sbal_kj;
  int32_t* counts;        // [N]
  int32_t* flags;         // [2]: monotonicity, normalization constancy
  int32_t* packed;        // [L + 2]: assignments, exact, depth
};

namespace {

constexpr int EBLOCK = 512;
constexpr int FBLOCK = 1024;

__global__ void __launch_bounds__(EBLOCK) uniform_parts_kernel(UniShardC a) {
  __shared__ BlockScratch<EBLOCK> sh;
  const PodRowD p = pod_row(a.tb, a.tidx);
  const bool use_fast = a.sig != 0 && a.sig == *a.cin.cache.sig;
  shard_parts<EBLOCK>(a.cfg, a.na, a.tb, a.cin, p, use_fast, a.cin.cache,
                      a.cout.cache, sh, a.loc);
}

__global__ void __launch_bounds__(EBLOCK)
uniform_keys_kernel(UniShardC a, const int64_t* glob) {
  const PodRowD p = pod_row(a.tb, a.tidx);
  const bool use_fast = a.sig != 0 && a.sig == *a.cin.cache.sig;
  const CacheC& out = a.cout.cache;
  const int64_t tmax = glob[KT_MAX_IC + 1], namax = glob[KT_MAX_IC + 2];
  const int N = a.na.N;
  for (int n = threadIdx.x; n < a.P0; n += EBLOCK) {
    if (n >= N) {
      a.keys0[n] = KT_I64_MIN;
      continue;
    }
    if (!use_fast) shard_s_img(a.na, a.tb, p, n, glob, out);
    const int64_t add =
        a.cfg.w_taint * kt_normalize(out.taint_raw[n], tmax, true)
        + a.cfg.w_node_affinity * kt_normalize(out.na_raw[n], namax, false)
        + a.cfg.w_image * out.s_img[n];
    a.static_add[n] = add;
    const bool feas = out.static_mask[n] && out.fit_ok[n];
    const int64_t masked =
        feas ? a.cfg.w_fit * out.s_fit[n] + a.cfg.w_balanced * out.s_bal[n]
                   + add
             : -1;
    a.keys0[n] = (masked + 1) * N + (N - 1 - n);
  }
  if (threadIdx.x == 0) {
    *out.sig = a.sig;
    a.flags[0] = 1;                             // monotonicity held
    a.flags[1] = tmax == 0 && namax == 0;       // normalization constant
  }
}

__global__ void merge_pad_kernel(const int64_t* gathered, int n,
                                 int64_t* merged, int P) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < P) merged[t] = t < n ? gathered[t] : KT_I64_MIN;
}

__global__ void __launch_bounds__(FBLOCK)
uniform_shard_finalize_kernel(UniShardC a, const int64_t* merged) {
  __shared__ BlockScratch<FBLOCK> sh;
  const PodRowD p = pod_row(a.tb, a.tidx);
  const int N = a.na.N, R = a.na.R, J = a.J, L = a.L;
  for (int n = threadIdx.x; n < N; n += FBLOCK) a.counts[n] = 0;
  __syncthreads();
  const int64_t M = (int64_t)a.n_global * J;
  for (int i = threadIdx.x; i < L; i += FBLOCK) {
    const int64_t key = merged[i];
    int32_t g = -1;
    if (key > -M && i < a.n_actual) {
      const int64_t q = floordiv(key + M - 1, M);   // the entry's score
      const int64_t ent = q * M - key;              // global node · J + j
      g = (int32_t)(ent / J);
      const int lid = g - a.offset;
      if (lid >= 0 && lid < N) atomicAdd(&a.counts[lid], 1);
    }
    a.packed[i] = g;
  }
  __syncthreads();
  const CarryC& c = a.cout;
  int64_t deep = 0;
  for (int k = threadIdx.x; k < a.K; k += FBLOCK) {
    const int node = a.cand[k];
    const int64_t cnt = a.counts[node];
    if (cnt >= J) ++deep;
    if (cnt > 0) {
      int64_t* used = c.used + (int64_t)node * R;
      for (int r = 0; r < R; ++r) used[r] += cnt * p.req[r];
      c.nonzero_used[(int64_t)node * 2] += cnt * p.nonzero_req[0];
      c.nonzero_used[(int64_t)node * 2 + 1] += cnt * p.nonzero_req[1];
      c.npods[node] += (int32_t)cnt;
    }
    const int64_t jj = (int64_t)k * J + (cnt < J - 1 ? cnt : J - 1);
    c.cache.fit_ok[node] = a.fit_kj[jj];
    c.cache.s_fit[node] = a.sfit_kj[jj];
    c.cache.s_bal[node] = a.sbal_kj[jj];
  }
  deep = block_sum<FBLOCK>(deep, sh);
  if (threadIdx.x == 0) {
    a.packed[L] = a.flags[0] && a.flags[1];
    a.packed[L + 1] = deep == 0;
  }
}

}  // namespace

extern "C" int ktpu_uniform_shard_parts(const UniShardC* a, void* stream) {
  uniform_parts_kernel<<<1, EBLOCK, 0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

extern "C" int ktpu_uniform_shard_topk(const UniShardC* a,
                                       const int64_t* glob, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  uniform_keys_kernel<<<1, EBLOCK, 0, s>>>(*a, glob);
  kt_sort_desc(a->keys0, a->P0, s);
  const OvlD ovl{nullptr, nullptr};
  uniform_matrix_kernel<<<(a->K + MBLOCK - 1) / MBLOCK, MBLOCK, 0, s>>>(
      a->na, a->tb, a->cin, a->cout.cache, a->cfg, ovl, a->tidx, a->keys0,
      a->static_add, a->K, a->J, (int64_t)a->n_global * a->J, a->offset,
      a->cand, a->keys1, a->fit_kj, a->sfit_kj, a->sbal_kj, a->flags);
  kt_sort_desc(a->keys1, a->P1, s);
  return (int)cudaGetLastError();
}

extern "C" int ktpu_uniform_merge(const int64_t* gathered, int n,
                                  int64_t* merged, int P, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  merge_pad_kernel<<<(P + 255) / 256, 256, 0, s>>>(gathered, n, merged, P);
  kt_sort_desc(merged, P, s);
  return (int)cudaGetLastError();
}

extern "C" int ktpu_uniform_shard_finalize(const UniShardC* a,
                                           const int64_t* merged,
                                           void* stream) {
  uniform_shard_finalize_kernel<<<1, FBLOCK, 0, (cudaStream_t)stream>>>(
      *a, merged);
  return (int)cudaGetLastError();
}
