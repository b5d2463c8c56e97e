// The closed form's [K, J] matrix (kubernetes_tpu/ops/program.py
// _uniform_matrix :1007), shared by run_uniform.cu and
// run_uniform_sharded.cu: one thread per candidate k (the k-th of the
// sorted row keys `keys0`, whose node index is folded in modulo N) writes
// its J post-placement entries — fit, LeastAllocated, BalancedAllocation
// — and their flat keys `masked · M − entry id`, entry id =
// (offset + node) · J + j with `offset` the global index of row 0 (0 on
// one device, the shard's first row on the mesh) and M = (global rows) ·
// J, so keys are unique across shards. A rising score sequence clears the
// monotonicity flag. `ovl` (null pointers: none) folds the nominated-pod
// overlay into the fit only.
#pragma once

#include "lean_eval.cuh"

constexpr int MBLOCK = 256;

namespace {

__global__ void __launch_bounds__(MBLOCK)
uniform_matrix_kernel(NodeC na, TableC tb, CarryC cin, CacheC out,
                      CfgC cfg, OvlD ovl, int32_t tidx, const int64_t* keys0,
                      const int64_t* static_add, int K, int J, int64_t M,
                      int offset, int32_t* cand, int64_t* keys1,
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
    keys1[idx] = masked * M - ((int64_t)(offset + node) * J + j);
    fit_kj[idx] = fit;
    sfit_kj[idx] = s_fit;
    sbal_kj[idx] = s_bal;
  }
  if (!mono) flags[0] = 0;
}

}  // namespace
