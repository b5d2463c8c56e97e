// run_gang, scan tier: all-or-nothing placement of one gang's members.
//
// Replaces kubernetes_tpu/ops/gang.py run_gang (:221) on its scan tier,
// _run_gang_scan_impl (:65-188; the jit _run_gang_scan_fn :192). The
// closed-form tier is run_uniform.cu with the gang verdict.
//
// What bounds it on an H100: the scan is a chain of B dependent members,
// each a pass or two over the node axis and one or two reductions over
// it on L2-resident state (the hoisted fit surfaces, the carry rows), then
// the chosen row's refresh for every signature slot. At N = 8,192 a
// member moves well under a megabyte: latency (the team barriers and the
// dependent chain), not bytes or operations.
//
// Design: ONE launch a gang of a thread-block cluster of KT_GANG_CLUSTER
// CTAs of KT_PLAN_BLOCK threads (cudaLaunchKernelEx with the cluster
// dimension), as run_batch.cu. Each CTA owns a contiguous range of ⌈N / C⌉
// rows, one row a thread at N = 8,192 (a thread loops past C · 512 rows),
// and keeps its rows' contiguity counts in its own shared memory. The
// gang's body is gang_span.cuh's, for a team of CTAs over a table of D
// shards: this kernel is its one-shard case (offset 0) on plan_span.cuh's
// ClusterTeam (a member's maxima and speculated key in one reduction:
// warp shuffles, the block's part, one cluster barrier, warp 0 folding
// the C partial slots through distributed shared memory);
// run_gang_sharded.cu runs the same body as one cooperative grid over a
// mesh's shards on one card. The cluster team reads no global slots: the
// span struct's `part` is null. CTA 0 writes the signature, the raw
// assignments and the packed tail.

#include "gang_span.cuh"

#define KT_GANG_CLUSTER 16

namespace {

constexpr int BLOCK = KT_PLAN_BLOCK;

__global__ void __launch_bounds__(BLOCK, 1)
run_gang_kernel(const __grid_constant__ GangSpanC cm,
                const __grid_constant__ GangNodesC nodes) {
  __shared__ PlanShared<BLOCK> sh;
  cg::cluster_group cl = cg::this_cluster();
  const int C = (int)cl.num_blocks(), rank = (int)cl.block_rank();
  const int N = cm.n_local, span = (N + C - 1) / C;
  const int lo = min(N, rank * span), hi = min(N, lo + span);
  ClusterTeam<BLOCK> tm;
  gang_span<BLOCK>(cm, &nodes, 0, lo, hi, rank == 0, rank == 0, tm, sh);
}

}  // namespace

// cm: the gang (n_local = N, D = 1, part = nullptr); nodes: its one shard
// at offset 0 with the fit surfaces' scratch
extern "C" int ktpu_run_gang(const GangSpanC* cm, const GangNodesC* nodes,
                             void* stream) {
  const int C = KT_GANG_CLUSTER;
  const int smem = gang_dyn_bytes((cm->n_local + C - 1) / C);
  cudaError_t e = cudaFuncSetAttribute(
      run_gang_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(run_gang_kernel,
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
  e = cudaLaunchKernelEx(&cfg, run_gang_kernel, *cm, *nodes);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
