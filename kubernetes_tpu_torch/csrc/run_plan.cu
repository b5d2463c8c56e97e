// run_plan: the drain compiler's plan program — one mixed-signature span
// (group rows, group-free rows, host-port rows) in one launch.
//
// Replaces kubernetes_tpu/ops/program.py run_plan (:1608; the jit
// _run_plan_fn :1597) and run_wave_scan (:1570; _run_wave_scan_fn
// :1563), both over _run_wave_scan_impl (:1259-1560), with its loop state
// _WaveState (:1233) and wave_fold (ops/groups.py :1215) for the span's
// rows.
//
//   Phase A (:1334-1454): the fit surfaces (fit_mask, LeastAllocated,
//     Balanced) of the S slots at the pre-span carry and each slot's
//     speculative argmax (first maximum of where(feasible, total, -1), -1
//     when nothing is feasible).
//   Phase B (:1456-1552), one step per pod in serial order: the slot's
//     feasibility (hoisted static mask & maintained fit surface, & the
//     live ports mask with has_ports, & the group mask with has_groups,
//     the spread minimum re-reduced every step), DefaultNormalize of the
//     raw taint / preferred-affinity counts over the feasible set (or the
//     constant w_taint·100 without norm_live), the f64 Balanced term, the
//     group scores, the first-max argmax; then, when placed, the carry
//     rows, the fit surfaces of ALL S slots at the touched node
//     (_row_refresh semantics), the group counters, the ports row; and
//     the conflict / prefix stats against the speculative choice.
//   The epilogue's wave_fold (:1554-1560) is group_update applied at each
//   placement to the output carry: the same integer adds.
//
// What bounds it on an H100: Phase B is a chain of S + W dependent
// evaluations — each reads the counters the last one wrote — each a few
// passes over the node axis and a few reductions over it, on well under a
// megabyte of L2-resident state. The bound is latency (the dependent
// loads of a row and the barriers), not bytes or operations.
//
// Design: ONE launch a span of a thread-block cluster of KT_PLAN_CLUSTER
// CTAs of KT_PLAN_BLOCK threads (cudaLaunchKernelEx with the cluster
// dimension), the span's body in plan_span.cuh. Each CTA owns a
// contiguous range of N / C rows, one row a thread at N = 8,192, so a
// pass over the node axis is one dependent chain a thread instead of
// eight on one SM. Each reduction is a block reduction, one cluster
// barrier, and a fold of the C partials warp 0 reads through distributed
// shared memory; the spread minima, the maxima with the score partials,
// the distinct domains, the raw range and the argmax key are one
// reduction each. C = 16 (non-portable) CTAs of 512 threads (128
// registers a thread) are the measured choice against C = 8 and against
// 1,024 threads (64 registers, spilling; PERF.md §6, row 7). The wrapper
// hands the kernel fresh copies of every carry field it writes.

#include "plan_span.cuh"

#define KT_PLAN_CLUSTER 16

// the kernel's arguments, mirrored field for field by ctypes
// (ops/kernels.py PlanArgsC)
struct PlanArgs {
  PlanSpanC cm;
  PlanNodesC nodes;
};

namespace {

constexpr int BLOCK = KT_PLAN_BLOCK;

__global__ void __launch_bounds__(BLOCK, 1)
run_plan_kernel(const __grid_constant__ PlanArgs a) {
  __shared__ PlanShared<BLOCK> sh;
  cg::cluster_group cl = cg::this_cluster();
  const int C = (int)cl.num_blocks(), r = (int)cl.block_rank();
  const int N = a.nodes.na.N, span = (N + C - 1) / C;
  const int lo = min(N, r * span), hi = min(N, lo + span);
  ClusterTeam<BLOCK> tm;
  plan_span<BLOCK>(a.cm, &a.nodes, 0, lo, hi, span, r == 0, r == 0, tm, sh);
}

}  // namespace

extern "C" int ktpu_run_plan(const PlanArgs* args, void* stream) {
  const int C = KT_PLAN_CLUSTER, N = args->nodes.na.N;
  const int smem = plan_dyn_bytes((N + C - 1) / C);
  cudaError_t e = cudaFuncSetAttribute(
      run_plan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(run_plan_kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C);
  cfg.blockDim = dim3(BLOCK);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = C;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, run_plan_kernel, *args);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
