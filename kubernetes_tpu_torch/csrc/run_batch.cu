// run_batch: the sequential scan over a span of pods.
//
// Replaces kubernetes_tpu/ops/program.py run_batch (:984; _run_batch_impl
// :929 with _eval_pod :495, _apply_assignment :906, _row_refresh :458 and
// the group steps: group_mask / group_scores inside _eval_pod :544-555,
// group_update per placement :961-966), and its nominated-pod overlay
// variant (lean scan only): the overlay folds into the slow path's fit
// and the row refresh, each nominated pod's own nomination is taken back
// out of its EFFECTIVE mask at its nominated row (:515-528; the cached
// fit_ok stays signature-pure), and a bound nominated pod consumes its
// nomination at that row, not at the chosen one (:942-966). The overlay
// the kernel consumes is a scratch copy the wrapper makes; the caller's
// is never written.
//
// What bounds it on an H100: the scan is sequential in pods — pod i+1
// reads the carry pod i wrote — so the span is a chain of B dependent
// steps, each a pass or two over the node axis and a few reductions over
// it (ImageLocality's counts on a signature change, the normalization
// maxima, the first-max argmax; with groups also the spread minima, the
// domain flags and the score ranges). At N = 8,192 nodes one step moves
// well under a megabyte, so the bound is latency (the dependent loads of
// a row and the barriers), not bytes or operations.
//
// Design: ONE launch a span of a thread-block cluster of KT_BATCH_CLUSTER
// CTAs of KT_PLAN_BLOCK threads (cudaLaunchKernelEx with the cluster
// dimension), as run_plan.cu. Each CTA owns a contiguous range of ⌈N / C⌉
// rows, one row a thread at N = 8,192 (a thread loops past C · 512 rows).
// The span's body is batch_span.cuh's, for a team of CTAs over a table of
// D shards: this kernel is its one-shard case on plan_span.cuh's
// ClusterTeam (each cross-row value one team reduction: warp shuffles,
// the block's part, one cluster barrier, warp 0 folding the C partial
// slots through distributed shared memory); run_batch_sharded.cu runs the
// same body as one cooperative grid over a mesh's shards on one card. The
// overlay variant is this kernel's only: the mesh refuses pending
// nominations. CTA 0 writes the SigCache signature, ipa_a_total and the
// assignments.

#include "batch_span.cuh"

#define KT_BATCH_CLUSTER 16

// the kernel's arguments, mirrored field for field by ctypes
// (ops/kernels.py BatchArgsC): the span and its one shard
struct BatchArgs {
  BatchSpanC cm;
  BatchNodesC nodes;
};

namespace {

constexpr int BLOCK = KT_PLAN_BLOCK;

__global__ void __launch_bounds__(BLOCK, 1)
run_batch_kernel(const __grid_constant__ BatchArgs a) {
  __shared__ PlanShared<BLOCK> sh;
  __shared__ int64_t img[KT_MAX_IC + 1];   // ImageLocality's counts
  cg::cluster_group cl = cg::this_cluster();
  const int C = (int)cl.num_blocks(), rank = (int)cl.block_rank();
  const int N = a.nodes.na.N, span = (N + C - 1) / C;
  const int lo = min(N, rank * span), hi = min(N, lo + span);
  ClusterTeam<BLOCK> tm;
  batch_span<BLOCK>(a.cm, &a.nodes, 0, lo, hi, span, rank == 0, rank == 0,
                    tm, sh, img);
}

}  // namespace

extern "C" int ktpu_run_batch(const BatchArgs* args, void* stream) {
  if (args->cm.B <= 0) return 0;
  const int C = KT_BATCH_CLUSTER, N = args->nodes.na.N;
  const int smem = batch_dyn_bytes((N + C - 1) / C,
                                   args->cm.has_groups ? args->nodes.g.U
                                                       : 0);
  cudaError_t e = cudaFuncSetAttribute(
      run_batch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(run_batch_kernel,
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
  e = cudaLaunchKernelEx(&cfg, run_batch_kernel, *args);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
