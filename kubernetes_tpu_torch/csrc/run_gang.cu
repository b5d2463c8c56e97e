// run_gang, scan tier: all-or-nothing placement of one gang's members.
//
// Replaces kubernetes_tpu/ops/gang.py run_gang (:221) on its scan tier,
// _run_gang_scan_impl (:65-188; the jit _run_gang_scan_fn :192). The
// closed-form tier is run_uniform.cu with the gang verdict.
//
// Two launches on the caller's stream:
//   1. gang_hoist_kernel (grid-wide, one thread per element): the fit
//      parts of every signature slot at the gang's entry carry —
//      fit_mask, LeastAllocated / MostAllocated and Balanced, [S, N]
//      each (:93-104) — plus the output carry's starting copy of used /
//      nonzero_used / npods and the zeroed per-domain member counts;
//   2. gang_scan_kernel (one persistent block): the member scan
//      (:106-164). Each step takes feasible = static mask & fit surface
//      of the member's slot, DefaultNormalizes the PreferNoSchedule
//      counts (reverse) and the preferred-affinity weights over the
//      feasible set, adds the contiguity column (the DefaultNormalized
//      member count of each node's topology domain) when w_contig > 0,
//      takes the int64 first-max argmax against the -1 sentinel, and on
//      a placement updates used / nonzero / npods at the chosen node and
//      refreshes that node's fit parts for every slot, duplicates
//      included (the _row_refresh arithmetic of :137-153). Then the
//      verdict (:171-188): accept = placed >= needed; a rejected gang's
//      output carry is the input's values, SigCache included; an
//      accepted one keeps the final state and zeroes the signature. The
//      raw assignments are written either way.
//
// What bounds it on an H100: the scan is a chain of B dependent steps,
// each three passes over the node axis and four block-wide reductions on
// L2-resident state — latency (barriers and the dependent chain), not
// bytes or operations. The hoist is the only grid-wide pass.
//
// Design: like run_batch.cu and run_plan.cu, one single-block launch per
// scan (1,024 threads own the node axis, node n belongs to thread
// n % 1,024), so no step costs a host round trip and every reduction is
// a block reduction. The SigCache's other fields are shared with the
// input carry (the kernel writes only a fresh signature scalar); the
// wrapper hands the kernel fresh buffers for every carry field it
// writes, so the input carry is never written.

#include "lean_eval.cuh"

// the kernel's arguments, mirrored field for field by ctypes
// (ops/kernels.py GangArgsC)
struct GangArgs {
  NodeC na;
  TableC tb;
  CfgC cfg;
  const int64_t* used_in;     // [N, R] the input carry (read only)
  const int64_t* nz_in;       // [N, 2]
  const int32_t* npods_in;    // [N]
  const int32_t* sig_in;      // scalar
  int64_t* used;              // [N, R] fresh: loop state, then the verdict
  int64_t* nonzero_used;      // [N, 2]
  int32_t* npods;             // [N]
  int32_t* sig_out;           // scalar
  const uint8_t* m0;          // stacked wave_statics, [S, N] each
  const int64_t* taint_raw;
  const int64_t* na_raw;
  const int64_t* s_img;
  const uint8_t* valid;       // [B]
  const int32_t* tidx;        // [B]
  const int32_t* widx;        // [B] slot of each member
  const int32_t* wt;          // [S] signature row of each slot
  const int32_t* dom;         // [N] topology domain of each node row
  int32_t S, B, needed, w_contig;
  uint8_t* fit_ok;            // [S, N] scratch: the fit surfaces
  int64_t* s_fit;             // [S, N]
  int64_t* s_bal;             // [S, N]
  int32_t* domcnt;            // [N] members placed per domain
  int32_t* packed;            // [B + 4]
};

namespace {

constexpr int HBLOCK = 256;
constexpr int BLOCK = 1024;

__global__ void __launch_bounds__(HBLOCK) gang_hoist_kernel(GangArgs a) {
  const int64_t e = (int64_t)blockIdx.x * HBLOCK + threadIdx.x;
  const int64_t N = a.na.N, R = a.na.R;
  if (e < N * R) a.used[e] = a.used_in[e];
  if (e < N * 2) a.nonzero_used[e] = a.nz_in[e];
  if (e < N) {
    a.npods[e] = a.npods_in[e];
    a.domcnt[e] = 0;
  }
  if (e < (int64_t)a.S * N) {
    const int s = (int)(e / N), n = (int)(e % N);
    const PodRowD p = pod_row(a.tb, a.wt[s]);
    const int64_t* used_row = a.used_in + (int64_t)n * R;
    int64_t s_fit, s_bal;
    kt_fit_scores(a.cfg, a.na, n, used_row, a.nz_in + (int64_t)n * 2, p,
                  &s_fit, &s_bal);
    a.fit_ok[e] = kt_fit(a.na, n, used_row, a.npods_in[n], p);
    a.s_fit[e] = s_fit;
    a.s_bal[e] = s_bal;
  }
}

__global__ void __launch_bounds__(BLOCK) gang_scan_kernel(GangArgs a) {
  __shared__ BlockScratch<BLOCK> sh;
  __shared__ int32_t placed;
  const int N = a.na.N, R = a.na.R;
  const int64_t NN = N;
  const CfgC& cfg = a.cfg;
  const int64_t wc = a.w_contig;
  if (threadIdx.x == 0) placed = 0;
  for (int k = 0; k < a.B; ++k) {
    __syncthreads();
    const int s = a.widx[k];
    const uint8_t* m0 = a.m0 + s * NN;
    const uint8_t* fit = a.fit_ok + s * NN;
    const int64_t* traw = a.taint_raw + s * NN;
    const int64_t* nraw = a.na_raw + s * NN;
    // the default_normalize maxima over the feasible set (at least 0)
    int64_t tm = 0, nm = 0, dm = 0;
    for (int n = threadIdx.x; n < N; n += BLOCK) {
      if (!(m0[n] && fit[n])) continue;
      tm = traw[n] > tm ? traw[n] : tm;
      nm = nraw[n] > nm ? nraw[n] : nm;
      if (wc) {
        const int64_t d = a.domcnt[a.dom[n]];
        dm = d > dm ? d : dm;
      }
    }
    const int64_t tmax = block_max<BLOCK>(tm, sh);
    const int64_t namax = block_max<BLOCK>(nm, sh);
    const int64_t dmax = wc ? block_max<BLOCK>(dm, sh) : 0;
    const int64_t* sfit = a.s_fit + s * NN;
    const int64_t* sbal = a.s_bal + s * NN;
    const int64_t* simg = a.s_img + s * NN;
    int64_t bv = KT_I64_MIN;
    int32_t bi = 0x7fffffff;
    for (int n = threadIdx.x; n < N; n += BLOCK) {
      int64_t val = -1;
      if (m0[n] && fit[n]) {
        val = cfg.w_fit * sfit[n] + cfg.w_balanced * sbal[n]
            + cfg.w_taint * kt_normalize(traw[n], tmax, true)
            + cfg.w_node_affinity * kt_normalize(nraw[n], namax, false)
            + cfg.w_image * simg[n];
        if (wc)
          val += wc * kt_normalize(a.domcnt[a.dom[n]], dmax, false);
      }
      argmax_merge(bv, bi, val, n);
    }
    block_argmax<BLOCK>(bv, bi, sh);
    const int best = bi;
    const bool assigned = bv >= 0 && a.valid[k] != 0;
    if (assigned) {
      int64_t* used_row = a.used + (int64_t)best * R;
      int64_t* nz_row = a.nonzero_used + (int64_t)best * 2;
      if (threadIdx.x == 0) {
        const PodRowD p = pod_row(a.tb, a.tidx[k]);
        for (int r = 0; r < R; ++r) used_row[r] += p.req[r];
        nz_row[0] += p.nonzero_req[0];
        nz_row[1] += p.nonzero_req[1];
        a.npods[best] += 1;
        if (wc) a.domcnt[a.dom[best]] += 1;
        placed += 1;
      }
      __syncthreads();
      // refresh the touched node's fit parts for every slot
      for (int s2 = threadIdx.x; s2 < a.S; s2 += BLOCK) {
        const PodRowD ps = pod_row(a.tb, a.wt[s2]);
        int64_t s_fit, s_bal;
        kt_fit_scores(cfg, a.na, best, used_row, nz_row, ps, &s_fit, &s_bal);
        a.fit_ok[s2 * NN + best] = kt_fit(a.na, best, used_row,
                                          a.npods[best], ps);
        a.s_fit[s2 * NN + best] = s_fit;
        a.s_bal[s2 * NN + best] = s_bal;
      }
    }
    if (threadIdx.x == 0) a.packed[k] = assigned ? best : -1;
  }
  __syncthreads();
  // the verdict: a rejected gang leaves the carry as it came
  const bool accept = placed >= a.needed;
  if (!accept) {
    for (int64_t e = threadIdx.x; e < NN * R; e += BLOCK)
      a.used[e] = a.used_in[e];
    for (int64_t e = threadIdx.x; e < NN * 2; e += BLOCK)
      a.nonzero_used[e] = a.nz_in[e];
    for (int n = threadIdx.x; n < N; n += BLOCK) a.npods[n] = a.npods_in[n];
  }
  if (threadIdx.x == 0) {
    *a.sig_out = accept ? 0 : *a.sig_in;
    a.packed[a.B] = accept;
    a.packed[a.B + 1] = placed;
    a.packed[a.B + 2] = 1;
    a.packed[a.B + 3] = 1;
  }
}

}  // namespace

extern "C" int ktpu_run_gang(const GangArgs* args, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t N = args->na.N;
  int64_t work = (int64_t)args->S * N;
  if (N * args->na.R > work) work = N * args->na.R;
  if (N * 2 > work) work = N * 2;
  const int grid = (int)((work + HBLOCK - 1) / HBLOCK);
  gang_hoist_kernel<<<grid, HBLOCK, 0, s>>>(*args);
  gang_scan_kernel<<<1, BLOCK, 0, s>>>(*args);
  return (int)cudaGetLastError();
}
