// The closed form's [K, J] matrix (kubernetes_tpu/ops/program.py
// _uniform_matrix :1007) for run_uniform.cu (run_uniform_sharded.cu
// builds its own, one thread an entry): one thread per candidate k (the
// k-th of the sorted row keys `keys0`, whose node index is folded in
// modulo N) writes its J post-placement entries — fit, LeastAllocated,
// BalancedAllocation — and their flat keys `masked · M − entry id`,
// entry id = node · J + j and M = N · J, so keys are unique. A rising
// score sequence clears the monotonicity flag. `ovl` (null pointers: none)
// folds the nominated-pod overlay into the fit only.
#pragma once

#include "lean_eval.cuh"

constexpr int MBLOCK = 256;

namespace {

__global__ void __launch_bounds__(MBLOCK)
uniform_matrix_kernel(NodeC na, TableC tb, CarryC cin, CacheC out,
                      CfgC cfg, OvlD ovl, int32_t tidx, const int64_t* keys0,
                      const int64_t* static_add, int K, int J, int64_t M,
                      int32_t* cand, int64_t* keys1,
                      uint8_t* fit_kj, int64_t* sfit_kj, int64_t* sbal_kj,
                      int32_t* flags) {
  const int k = blockIdx.x * MBLOCK + threadIdx.x;
  if (k >= K) return;
  const PodRowD p = pod_row(tb, tidx);
  const int N = na.N;
  const int node = N - 1 - (int)(keys0[k] % N);
  cand[k] = node;
  const bool sm = out.static_mask[node] != 0;
  const int64_t sadd = static_add[node];
  const int64_t* used = cin.used + (int64_t)node * na.R;
  const int64_t* nz = cin.nonzero_used + (int64_t)node * 2;
  const int64_t npods = cin.npods[node];
  const int64_t* ovl_row =
      ovl.used ? ovl.used + (int64_t)node * na.R : nullptr;
  const int64_t ovl_np = ovl.used ? ovl.npods[node] : 0;
  int64_t prev = 0;
  bool mono = true;
  for (int j = 0; j < J; ++j) {
    bool fit;
    int64_t s_fit, s_bal;
    kt_uniform_entry(cfg, na, node, used, nz, npods, p, j + 1, &fit, &s_fit,
                     &s_bal, ovl_row, ovl_np);
    const int64_t masked = (sm && fit)
        ? cfg.w_fit * s_fit + cfg.w_balanced * s_bal + sadd : -1;
    if (j > 0 && masked > prev) mono = false;
    prev = masked;
    const int64_t idx = (int64_t)k * J + j;
    keys1[idx] = masked * M - ((int64_t)node * J + j);
    fit_kj[idx] = fit;
    sfit_kj[idx] = s_fit;
    sbal_kj[idx] = s_bal;
  }
  if (!mono) flags[0] = 0;
}

// the gang verdict over a closed-form result (kubernetes_tpu/ops/gang.py
// _run_gang_uniform_jit :198-218): placed counts the selections (even
// when an exactness flag failed), accept = placed >= needed, and the
// output carry keeps run_uniform's result only when the gang is accepted
// and both flags held — otherwise it receives the input carry's values,
// SigCache included, on the device. packed [L + 4] = [assignments;
// accept; placed; exact; depth].
template <int FBLOCK>
__global__ void __launch_bounds__(FBLOCK)
gang_uniform_epilogue_kernel(CarryC cin, CarryC cout, int N, int R, int L,
                             int needed, const int32_t* pu,
                             int32_t* packed) {
  __shared__ BlockScratch<FBLOCK> sh;
  int64_t cnt = 0;
  for (int i = threadIdx.x; i < L; i += FBLOCK) {
    packed[i] = pu[i];
    cnt += pu[i] >= 0;
  }
  const int64_t placed = block_sum<FBLOCK>(cnt, sh);
  const bool exact = pu[L] != 0, depth = pu[L + 1] != 0;
  const bool accept = placed >= needed;
  if (!(accept && exact && depth)) {
    const int64_t NN = N;
    for (int64_t e = threadIdx.x; e < NN * R; e += FBLOCK)
      cout.used[e] = cin.used[e];
    for (int64_t e = threadIdx.x; e < NN * 2; e += FBLOCK)
      cout.nonzero_used[e] = cin.nonzero_used[e];
    const CacheC& a = cin.cache;
    const CacheC& b = cout.cache;
    for (int n = threadIdx.x; n < N; n += FBLOCK) {
      cout.npods[n] = cin.npods[n];
      b.static_mask[n] = a.static_mask[n];
      b.taint_raw[n] = a.taint_raw[n];
      b.na_raw[n] = a.na_raw[n];
      b.s_img[n] = a.s_img[n];
      b.fit_ok[n] = a.fit_ok[n];
      b.s_fit[n] = a.s_fit[n];
      b.s_bal[n] = a.s_bal[n];
    }
    if (threadIdx.x == 0) *b.sig = *a.sig;
  }
  if (threadIdx.x == 0) {
    packed[L] = accept;
    packed[L + 1] = (int32_t)placed;
    packed[L + 2] = exact;
    packed[L + 3] = depth;
  }
}

}  // namespace
