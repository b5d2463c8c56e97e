// run_uniform: closed-form assignment of a same-signature run of pods.
//
// Replaces kubernetes_tpu/ops/program.py run_uniform (:1207; the jit
// _run_uniform_jit :1190 over _uniform_core :1076 and _uniform_matrix
// :1007), with its nominated-pod overlay variant: the overlay (null
// pointers: none) folds into the fit of the run's row in launch 1 — so
// into the candidate keys, the normalization maxima and the fresh
// SigCache — and into the fit of every matrix entry in launch 3
// (:1135-1140); the scores and the carry update never see it.
//
// The run's L pods take the top-L entries of a [K, J] matrix of
// post-placement scores (entry (k, j) = score of candidate node k after
// its (j+1)-th placement), keyed (score desc, node asc, j asc). Launches,
// all on the caller's stream:
//   1. uniform_eval_kernel (one block): the run's row over all N nodes —
//      filters, raw scores, the SigCache fast path, the normalization
//      maxima — writing the fresh SigCache and the candidate keys;
//   2. bitonic sort of the N candidate keys (sort.cuh): top-K with ties to
//      the lowest node index (the index is folded into the key);
//   3. uniform_matrix_kernel (one thread per candidate): the J
//      post-placement entries, their flat keys and the monotonicity flag;
//   4. bitonic sort of the K·J flat keys (65,536 keys at 8,192 nodes and
//      batch 8,192: 512 KB, more than one block's shared memory, so the
//      sort runs chunked in shared memory with global-memory strides);
//   5. uniform_finalize_kernel (one block): assignments, per-node counts,
//      the carry update, the cache refresh at each candidate, and the
//      packed [L + 2] output with the exactness and depth flags.
//
// The closed-form gang tier (kubernetes_tpu/ops/gang.py
// _run_gang_uniform_jit :198-218, entry ktpu_run_gang_uniform) runs the
// same five launches, then a one-block epilogue with the gang verdict.
//
// What bounds it on an H100: the work is small (tens of MB moved, a few
// million integer operations); the two sorts and the five dependent
// launches make it latency bound. The sorts dominate: the 65,536-key
// bitonic network is 136 compare-exchange stages, 15 of them in global
// memory. Keys are int64 throughout (the JAX program narrows them to
// int32 where the range allows; values and order are the same).

#include "sort.cuh"
#include "uniform_matrix.cuh"

namespace {

constexpr int EBLOCK = 512;
constexpr int FBLOCK = 1024;

__global__ void __launch_bounds__(EBLOCK)
uniform_eval_kernel(NodeC na, TableC tb, CarryC cin, CacheC out, CfgC cfg,
                    OvlD ovl, int32_t sig, int32_t tidx, int64_t* static_add,
                    int64_t* keys0, int P0, int32_t* flags) {
  __shared__ BlockScratch<EBLOCK> sh;
  __shared__ int64_t num_with[KT_MAX_IC];
  const PodRowD p = pod_row(tb, tidx);
  const bool use_fast = sig != 0 && sig == *cin.cache.sig;
  int64_t tmax, namax;
  block_eval_parts<EBLOCK>(cfg, na, tb, cin, p, use_fast, cin.cache, out,
                           sh, num_with, &tmax, &namax, nullptr, ovl);
  const int N = na.N;
  for (int n = threadIdx.x; n < P0; n += EBLOCK) {
    if (n >= N) {
      keys0[n] = KT_I64_MIN;
      continue;
    }
    const int64_t add =
        cfg.w_taint * kt_normalize(out.taint_raw[n], tmax, true)
        + cfg.w_node_affinity * kt_normalize(out.na_raw[n], namax, false)
        + cfg.w_image * out.s_img[n];
    static_add[n] = add;
    const bool feas = out.static_mask[n] && out.fit_ok[n];
    const int64_t masked =
        feas ? cfg.w_fit * out.s_fit[n] + cfg.w_balanced * out.s_bal[n] + add
             : -1;
    keys0[n] = (masked + 1) * N + (N - 1 - n);
  }
  if (threadIdx.x == 0) {
    *out.sig = sig;
    flags[0] = 1;                             // monotonicity held
    flags[1] = tmax == 0 && namax == 0;       // normalization constant
  }
}

__global__ void __launch_bounds__(FBLOCK)
uniform_finalize_kernel(CarryC cout, TableC tb, int32_t tidx, int N, int R,
                        const int64_t* keys1, const int32_t* cand,
                        const uint8_t* fit_kj, const int64_t* sfit_kj,
                        const int64_t* sbal_kj, int K, int J, int L,
                        int n_actual, int32_t* counts,
                        const int32_t* flags, int32_t* packed) {
  __shared__ BlockScratch<FBLOCK> sh;
  const PodRowD p = pod_row(tb, tidx);
  for (int n = threadIdx.x; n < N; n += FBLOCK) counts[n] = 0;
  __syncthreads();
  const int64_t M = (int64_t)N * J;
  for (int i = threadIdx.x; i < L; i += FBLOCK) {
    const int64_t key = keys1[i];
    int32_t a = -1;
    if (key > -M && i < n_actual) {
      const int64_t q = floordiv(key + M - 1, M);   // the entry's score
      const int64_t ent = q * M - key;              // node * J + j
      a = (int32_t)(ent / J);
      atomicAdd(&counts[a], 1);
    }
    packed[i] = a;
  }
  __syncthreads();
  int64_t deep = 0;
  for (int k = threadIdx.x; k < K; k += FBLOCK) {
    const int node = cand[k];
    const int64_t cnt = counts[node];
    if (cnt >= J) ++deep;
    if (cnt > 0) {
      int64_t* used = cout.used + (int64_t)node * R;
      for (int r = 0; r < R; ++r) used[r] += cnt * p.req[r];
      cout.nonzero_used[(int64_t)node * 2] += cnt * p.nonzero_req[0];
      cout.nonzero_used[(int64_t)node * 2 + 1] += cnt * p.nonzero_req[1];
      cout.npods[node] += (int32_t)cnt;
    }
    const int64_t jj = (int64_t)k * J + (cnt < J - 1 ? cnt : J - 1);
    cout.cache.fit_ok[node] = fit_kj[jj];
    cout.cache.s_fit[node] = sfit_kj[jj];
    cout.cache.s_bal[node] = sbal_kj[jj];
  }
  deep = block_sum<FBLOCK>(deep, sh);
  if (threadIdx.x == 0) {
    packed[L] = flags[0] && flags[1];
    packed[L + 1] = deep == 0;
  }
}

// the five launches of one closed-form run (see the header)
void launch_uniform(const NodeC* na, const TableC* tb, const CarryC* cin,
                    const CarryC* cout, const CfgC* cfg, int sig, int tidx,
                    int n_actual, int L, int K, int J, int64_t* static_add,
                    int64_t* keys0, int P0, int32_t* cand, int64_t* keys1,
                    int P1, uint8_t* fit_kj, int64_t* sfit_kj,
                    int64_t* sbal_kj, int32_t* counts, int32_t* flags,
                    int32_t* packed, const OvlD& ovl, cudaStream_t s) {
  uniform_eval_kernel<<<1, EBLOCK, 0, s>>>(*na, *tb, *cin, cout->cache, *cfg,
                                           ovl, sig, tidx, static_add, keys0,
                                           P0, flags);
  kt_sort_desc(keys0, P0, s);
  uniform_matrix_kernel<<<(K + MBLOCK - 1) / MBLOCK, MBLOCK, 0, s>>>(
      *na, *tb, *cin, cout->cache, *cfg, ovl, tidx, keys0, static_add, K, J,
      (int64_t)na->N * J, cand, keys1, fit_kj, sfit_kj, sbal_kj, flags);
  kt_sort_desc(keys1, P1, s);
  uniform_finalize_kernel<<<1, FBLOCK, 0, s>>>(
      *cout, *tb, tidx, na->N, na->R, keys1, cand, fit_kj, sfit_kj, sbal_kj,
      K, J, L, n_actual, counts, flags, packed);
}

}  // namespace

extern "C" int ktpu_run_uniform(const NodeC* na, const TableC* tb,
                                const CarryC* cin, const CarryC* cout,
                                const CfgC* cfg, int sig, int tidx,
                                int n_actual, int L, int K, int J,
                                int64_t* static_add, int64_t* keys0, int P0,
                                int32_t* cand, int64_t* keys1, int P1,
                                uint8_t* fit_kj, int64_t* sfit_kj,
                                int64_t* sbal_kj, int32_t* counts,
                                int32_t* flags, int32_t* packed,
                                const int64_t* ovl_used,
                                const int32_t* ovl_npods, void* stream) {
  const OvlD ovl{ovl_used, ovl_npods};
  launch_uniform(na, tb, cin, cout, cfg, sig, tidx, n_actual, L, K, J,
                 static_add, keys0, P0, cand, keys1, P1, fit_kj, sfit_kj,
                 sbal_kj, counts, flags, packed, ovl, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// the closed-form gang tier: the same five launches into a scratch
// [L + 2] result, then the one-block gang epilogue
extern "C" int ktpu_run_gang_uniform(const NodeC* na, const TableC* tb,
                                     const CarryC* cin, const CarryC* cout,
                                     const CfgC* cfg, int sig, int tidx,
                                     int n_actual, int needed, int L, int K,
                                     int J, int64_t* static_add,
                                     int64_t* keys0, int P0, int32_t* cand,
                                     int64_t* keys1, int P1, uint8_t* fit_kj,
                                     int64_t* sfit_kj, int64_t* sbal_kj,
                                     int32_t* counts, int32_t* flags,
                                     int32_t* pu, int32_t* packed,
                                     void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const OvlD ovl{nullptr, nullptr};
  launch_uniform(na, tb, cin, cout, cfg, sig, tidx, n_actual, L, K, J,
                 static_add, keys0, P0, cand, keys1, P1, fit_kj, sfit_kj,
                 sbal_kj, counts, flags, pu, ovl, s);
  gang_uniform_epilogue_kernel<FBLOCK><<<1, FBLOCK, 0, s>>>(
      *cin, *cout, na->N, na->R, L, needed, pu, packed);
  return (int)cudaGetLastError();
}
