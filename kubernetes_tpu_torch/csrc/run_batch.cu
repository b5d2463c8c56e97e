// run_batch: the sequential lean scan over a span of pods.
//
// Replaces kubernetes_tpu/ops/program.py run_batch (:984; _run_batch_impl
// :929 with _eval_pod :495, _apply_assignment :906, _row_refresh :458),
// lean variant: no group kernels, no nominated-pod overlay.
//
// What bounds it on an H100: the scan is sequential in pods — pod i+1
// reads the carry pod i wrote — so the span is a chain of B dependent
// steps, each an O(N) pass over the node axis plus three block-wide
// reductions (ImageLocality counts, the normalization maxima, the
// first-max argmax). At N = 8192 nodes one step moves well under a
// megabyte, so the bound is latency (barriers and the dependent chain),
// not bytes or operations.
//
// Design: ONE persistent launch per span and a single block that loops
// over the pods, so the chain never leaves the SM: the carry and the
// signature cache stay in global memory (L2-resident at these sizes), each
// step is parallel in nodes across the block's threads, the reductions are
// warp shuffles plus shared memory, and one thread applies the placement
// (port ids into the first free slots) and refreshes the touched cache
// row. Same-signature pods take the SigCache fast path: only the
// feasibility maxima and the argmax are recomputed. The block writes the
// carry it was given in place; the wrapper hands it fresh copies.

#include "lean_eval.cuh"

namespace {

constexpr int BLOCK = 512;

__global__ void __launch_bounds__(BLOCK)
run_batch_kernel(NodeC na, TableC tb, CarryC c, CfgC cfg,
                 const uint8_t* __restrict__ valid,
                 const int32_t* __restrict__ sig,
                 const int32_t* __restrict__ tidx, int B,
                 int32_t* __restrict__ out) {
  __shared__ BlockScratch<BLOCK> sh;
  __shared__ int64_t num_with[KT_MAX_IC];
  for (int i = 0; i < B; ++i) {
    const int32_t s = sig[i];
    const PodRowD p = pod_row(tb, tidx[i]);
    const bool use_fast = s != 0 && s == *c.cache.sig;
    int64_t tmax, namax;
    block_eval_parts<BLOCK>(cfg, na, tb, c, p, use_fast, c.cache, c.cache,
                            sh, num_with, &tmax, &namax);
    // masked total + first-max argmax (:949-951)
    int64_t bv = KT_I64_MIN;
    int32_t bi = 0x7fffffff;
    for (int n = threadIdx.x; n < na.N; n += BLOCK) {
      const bool feas = c.cache.static_mask[n] && c.cache.fit_ok[n];
      const int64_t v = feas ? kt_total(cfg, c.cache, n, tmax, namax) : -1;
      argmax_merge(bv, bi, v, n);
    }
    block_argmax<BLOCK>(bv, bi, sh);
    if (threadIdx.x == 0) {
      const int best = bi;
      const bool assigned = bv >= 0 && valid[i];
      if (assigned) {
        // _apply_assignment (:906)
        int64_t* used_row = c.used + (int64_t)best * na.R;
        for (int r = 0; r < na.R; ++r) used_row[r] += p.req[r];
        int64_t* nz_row = c.nonzero_used + (int64_t)best * 2;
        nz_row[0] += p.nonzero_req[0];
        nz_row[1] += p.nonzero_req[1];
        c.npods[best] += 1;
        bool any_port = false;
        for (int q = 0; q < tb.PP; ++q) any_port = any_port || p.port_ids[q];
        if (any_port) {
          int32_t* row = c.ports + (int64_t)best * c.P;
          int rank = 0;
          for (int slot = 0; slot < c.P; ++slot) {
            if (row[slot] != 0) continue;
            row[slot] = rank < tb.PP ? p.port_ids[rank] : 0;
            ++rank;
          }
        }
        // _row_refresh (:458) at the post-placement carry
        int64_t s_fit, s_bal;
        kt_fit_scores(cfg, na, best, used_row, nz_row, p, &s_fit, &s_bal);
        c.cache.fit_ok[best] = kt_fit(na, best, used_row, c.npods[best], p);
        c.cache.s_fit[best] = s_fit;
        c.cache.s_bal[best] = s_bal;
      }
      *c.cache.sig = s;
      out[i] = assigned ? best : -1;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int ktpu_run_batch(const NodeC* na, const TableC* tb,
                              const CarryC* carry, const CfgC* cfg,
                              const uint8_t* valid, const int32_t* sig,
                              const int32_t* tidx, int B, int32_t* out,
                              void* stream) {
  if (B > 0) {
    run_batch_kernel<<<1, BLOCK, 0, (cudaStream_t)stream>>>(
        *na, *tb, *carry, *cfg, valid, sig, tidx, B, out);
  }
  return (int)cudaGetLastError();
}
