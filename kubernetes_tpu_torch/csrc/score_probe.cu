// score_probe: the float score surface of one signature row at one carry,
// the sanitizer rails' NaN/inf probe (one launch per device drain with the
// SanitizerRails gate on).
//
// Replaces kubernetes_tpu/ops/program.py score_probe (:767; the jit
// _score_probe_jit :743). For every node row n, padded rows included:
//   total[n] = f32(w_fit·s_fit + w_balanced·s_bal)   (the int64 Fit and
//              BalancedAllocation scores of the row at the carry, the
//              pod's request added, BalancedAllocation 0 for a
//              skip_balanced row);
//   std[n]   = f32(population std of the utilization fractions of the
//              scored columns), the float BalancedAllocation surface before
//              its int floor, whatever skip_balanced says.
//
// Bit parity with the plain version and the JAX program: the scores are
// lean_eval.cuh's kt_fit_scores, the std its kt_balanced_std (rounded
// float64 intrinsics, the column sums left to right, built with
// --fmad=false), and both conversions to float32 round to nearest
// (__ll2float_rn, __double2float_rn). The totals stay below 2^24, so
// their conversion is exact.
//
// What bounds it on an H100: the bytes. Per valid row it reads the scored
// columns of cap and used and the nonzero row, and writes 8 bytes: about
// 0.4 MB at 5,000 valid rows of 8,192 and C = 2, a fraction of a
// microsecond at 3.35 TB/s; the arithmetic is a few dozen float64
// operations a row. At this size the launch itself dominates.
//
// Design: one thread per node row, 256 a block, no shared memory and no
// atomics; each thread evaluates its row independently and writes its two
// outputs. The kernel never writes the carry.

#include "lean_eval.cuh"

// mirrored field for field by ctypes in ops/kernels.py (ScoreProbeArgsC);
// outside the anonymous namespace so the C entry keeps external linkage
struct ScoreProbeArgs {
  NodeC na;
  TableC tb;
  CfgC cfg;
  const int64_t* used;          // [N, R]
  const int64_t* nonzero_used;  // [N, 2]
  int32_t tidx;
  float* total;                 // [N]
  float* stdv;                  // [N]
};

namespace {

__global__ void score_probe_kernel(const ScoreProbeArgs a) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= a.na.N) return;
  const PodRowD p = pod_row(a.tb, a.tidx);
  const int64_t* used_row = a.used + (int64_t)n * a.na.R;
  const int64_t* nz_row = a.nonzero_used + (int64_t)n * 2;
  int64_t s_fit, s_bal;
  kt_fit_scores(a.cfg, a.na, n, used_row, nz_row, p, &s_fit, &s_bal);
  int64_t capc[KT_MAX_C], plain[KT_MAX_C];
  const int64_t* cap = a.na.cap + (int64_t)n * a.na.R;
  for (int c = 0; c < a.cfg.C; ++c) {
    const int col = a.cfg.score_cols[c];
    capc[c] = cap[col];
    plain[c] = used_row[col] + p.req[col];
  }
  a.total[n] = __ll2float_rn(a.cfg.w_fit * s_fit + a.cfg.w_balanced * s_bal);
  a.stdv[n] = __double2float_rn(kt_balanced_std(a.cfg.C, capc, plain));
}

}  // namespace

extern "C" int ktpu_score_probe(const ScoreProbeArgs* args, void* stream) {
  const ScoreProbeArgs a = *args;
  if (a.na.N > 0)
    score_probe_kernel<<<(a.na.N + 255) / 256, 256, 0,
                         (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
