// diagnose_row: each node's first failing filter for up to KT_DIAG_MAX_S
// signature rows, plus the fit detail of the NodeResourcesFit reasons.
//
// Replaces kubernetes_tpu/ops/program.py diagnose_row (:627; the jits
// _diagnose_lean :621 and _diagnose_groups :614 over _diagnose_masks
// :579) with ops/groups.py group_reason_masks (:340). The slot of node n
// for row u is the first of, in the host plugin order (_diagnose_masks
// :599-610):
//   invalid → unschedulable → node name → taint → selector → ports →
//   fit → spread label → spread skew → affinity → anti → existing anti
//   → feasible (DIAG_* values :564-576),
// with pods_fail[n] = npods + 1 > allowed_pods and cols_fail[n, r] =
// req[r] != 0 & used[n, r] + req[r] > cap[n, r]. Spread attributes a node
// to its FIRST failing DoNotSchedule constraint (missing key → label,
// else skew), against the per-constraint minimum over the count-eligible
// nodes; the lean launch reads no group tensors. The JAX package calls
// the program once a row; a failed drain here diagnoses all its rows in
// one launch, each row's outputs those of its own call.
//
// What bounds it on an H100: one pass over the node rows a row (the lean
// filter loops over each node's occupied taint, label and port slots,
// and with groups the row's [SC / TA / TAA, N] tensors), a few hundred
// bytes per node: at N = 8,192 a few MB at most, launch-latency bound;
// the scheduler's readback of the results is the rest of its cost.
//
// Design: ONE launch for S rows, ⌈N / 256⌉ CTAs of 256 threads a row
// (grid CTAs × S), CTA x owning the x-th contiguous share of the nodes, a
// thread a node. The one cross-node dependency, the spread minimum, is
// reduced once a cluster: with it, the row's CTAs launch as thread-block
// clusters of KT_DIAG_CLUSTER (their count rounded up to a whole number of
// clusters) and each cluster reduces the whole node axis: CTA r's minimum
// over the r-th sixteenth into its shared memory, one cluster barrier, a
// thread a (CTA, constraint) folding the partials through distributed
// shared memory, one more barrier before any CTA leaves. Without it (lean
// rows, no DoNotSchedule family) nothing crosses nodes and the launch is
// a plain grid. The outputs of all rows are one packed buffer (slot, then
// pods_fail, then cols_fail), read back in one copy.

#include <cooperative_groups.h>

#include "group_eval.cuh"

namespace cg = cooperative_groups;

#define KT_DIAG_MAX_S 64
#define KT_DIAG_CLUSTER 16

// the kernel's arguments, mirrored field for field by ctypes
// (ops/kernels.py DiagArgsC); everything but the rows and the output is
// the diagnosis context's, packed once per context
struct DiagArgs {
  NodeC na;
  TableC tb;
  const int64_t* used;    // [N, R] node state (the post-commit truth)
  const int32_t* npods;   // [N]
  const int32_t* ports;   // [N, P]
  int32_t P, has_groups;
  GroupsC g;
  GCarryC gc;
  FamC fam;
  int32_t rows[KT_DIAG_MAX_S];
  int32_t S;
  // slot i32 [S, N], then pods_fail u8 [S, N], then cols_fail u8 [S, N, R]
  uint8_t* out;
};

namespace {

constexpr int BLOCK = 256;

// CTAs a row: ⌈N / BLOCK⌉, and with clusters a whole number of them
__host__ __device__ inline int diag_ctas(int N, bool clusters) {
  const int b = (N + BLOCK - 1) / BLOCK;
  if (!clusters) return b;
  return (b + KT_DIAG_CLUSTER - 1) / KT_DIAG_CLUSTER * KT_DIAG_CLUSTER;
}

constexpr int32_t DIAG_FEASIBLE = 0;
constexpr int32_t DIAG_INVALID = -1;
constexpr int32_t DIAG_NODE_UNSCHEDULABLE = 1;
constexpr int32_t DIAG_NODE_NAME = 2;
constexpr int32_t DIAG_TAINT = 3;
constexpr int32_t DIAG_NODE_AFFINITY = 4;
constexpr int32_t DIAG_PORTS = 5;
constexpr int32_t DIAG_FIT = 6;
constexpr int32_t DIAG_SPREAD_LABEL = 7;
constexpr int32_t DIAG_SPREAD_SKEW = 8;
constexpr int32_t DIAG_IPA_AFFINITY = 9;
constexpr int32_t DIAG_IPA_ANTI = 10;
constexpr int32_t DIAG_IPA_EXISTING_ANTI = 11;

__global__ void __launch_bounds__(BLOCK)
diagnose_kernel(const __grid_constant__ DiagArgs a) {
  __shared__ BlockScratch<BLOCK> sh;
  __shared__ int32_t part[KT_MAX_SC];   // this CTA's spread minima
  __shared__ int32_t minv[KT_MAX_SC];   // the row's
  // CTA x of row y evaluates the x-th of gridDim.x shares of the nodes
  const int C = gridDim.x, rank = blockIdx.x;
  const int N = a.na.N, R = a.na.R;
  const int64_t NN = N;
  const int s = blockIdx.y, tidx = a.rows[s];
  const int span = (N + C - 1) / C;
  const int lo = min(N, rank * span), hi = min(N, lo + span);
  GViewD v;
  if (a.has_groups) {
    v = view_of(a.g, a.gc, tidx);
    if (a.fam.spr_f) {
      // block_spread_min: each cluster of the row reduces the whole node
      // axis, CTA r of it the r-th of KT_DIAG_CLUSTER shares
      cg::cluster_group cl = cg::this_cluster();
      const int K = (int)cl.num_blocks(), kspan = (N + K - 1) / K;
      const int klo = min(N, (int)cl.block_rank() * kspan);
      const int khi = min(N, klo + kspan);
      if ((int)threadIdx.x < v.SC) minv[threadIdx.x] = KT_INT32_MAX;
      for (int c = 0; c < v.SC; ++c) {
        int64_t m = KT_INT32_MAX;
        for (int n = klo + threadIdx.x; n < khi; n += BLOCK) {
          const int64_t k = (int64_t)c * NN + n;
          if (v.f_elig[k] && v.f_cnt[k] < m) m = v.f_cnt[k];
        }
        m = block_min<BLOCK>(m, sh);
        if (threadIdx.x == 0) part[c] = (int32_t)m;
      }
      cl.sync();
      // a thread a (CTA, constraint): every partial read at once
      if ((int)threadIdx.x < K * v.SC)
        atomicMin(&minv[threadIdx.x % v.SC],
                  *cl.map_shared_rank(&part[threadIdx.x % v.SC],
                                      threadIdx.x / v.SC));
      // every CTA's minima read before any CTA leaves; minv complete
      cl.sync();
      if ((int)threadIdx.x < v.SC && v.f_minz[threadIdx.x])
        minv[threadIdx.x] = 0;
      __syncthreads();
    }
  }
  const PodRowD p = pod_row(a.tb, tidx);
  int32_t* slot = (int32_t*)a.out + s * NN;
  uint8_t* pods_out = a.out + 4 * a.S * NN + s * NN;
  uint8_t* cols_out = a.out + 5 * a.S * NN + s * NN * R;
  for (int n = lo + threadIdx.x; n < hi; n += BLOCK) {
    // fit detail (every node, whatever its slot)
    const int64_t* cap = a.na.cap + n * (int64_t)R;
    const int64_t* used = a.used + n * (int64_t)R;
    const bool pods_fail =
        (int64_t)a.npods[n] + 1 > (int64_t)a.na.allowed_pods[n];
    bool any_col = false;
    for (int r = 0; r < R; ++r) {
      const bool f = p.req[r] != 0 && used[r] + p.req[r] > cap[r];
      cols_out[n * (int64_t)R + r] = f;
      any_col = any_col || f;
    }
    pods_out[n] = pods_fail;

    int32_t sl = DIAG_FEASIBLE;
    if (!a.na.valid[n]) {
      sl = DIAG_INVALID;
    } else if (a.na.unschedulable[n] && !p.tolerates_unsched) {
      sl = DIAG_NODE_UNSCHEDULABLE;
    } else if (!(p.node_name_id == 0 || a.na.name_id[n] == p.node_name_id)) {
      sl = DIAG_NODE_NAME;
    } else if (!kt_taints_ok(a.na, n, p, a.tb.TT)) {
      sl = DIAG_TAINT;
    } else if (!kt_selector_ok(a.na, n, p, a.tb.Q, a.tb.TM, a.tb.V)) {
      sl = DIAG_NODE_AFFINITY;
    } else if (!kt_ports_ok(a.ports + n * (int64_t)a.P, a.P, p.port_ids,
                            a.tb.PP)) {
      sl = DIAG_PORTS;
    } else if (pods_fail || any_col) {
      sl = DIAG_FIT;
    } else if (a.has_groups) {
      // group_reason_masks (:340), layered in the host plugin order
      if (a.fam.spr_f) {
        for (int c = 0; c < v.SC; ++c) {
          if (!v.f_act[c]) continue;
          const int64_t k = (int64_t)c * NN + n;
          if (v.f_tv[k] == 0) {
            sl = DIAG_SPREAD_LABEL;
            break;
          }
          if ((int64_t)v.f_cnt[k] + v.f_self[c] - minv[c] > v.f_skew[c]) {
            sl = DIAG_SPREAD_SKEW;
            break;
          }
        }
      }
      if (sl == DIAG_FEASIBLE && a.fam.ipa_req) {
        bool any = false, tv_all = true, pods_exist = true;
        for (int t = 0; t < v.TA; ++t) {
          if (!v.ra_act[t]) continue;
          const int64_t k = (int64_t)t * NN + n;
          any = true;
          tv_all = tv_all && v.ra_tv[k] != 0;
          pods_exist = pods_exist && v.a_cnt[k] > 0;
        }
        const bool escape = v.a_total == 0 && v.self_all;
        if (any && !(tv_all && (pods_exist || escape)))
          sl = DIAG_IPA_AFFINITY;
      }
      if (sl == DIAG_FEASIBLE && a.fam.ipa_anti) {
        for (int t = 0; t < v.TAA; ++t) {
          const int64_t k = (int64_t)t * NN + n;
          if (v.raa_act[t] && v.raa_tv[k] != 0 && v.aa_cnt[k] > 0) {
            sl = DIAG_IPA_ANTI;
            break;
          }
        }
        if (sl == DIAG_FEASIBLE && v.veto[n] != 0)
          sl = DIAG_IPA_EXISTING_ANTI;
      }
    }
    slot[n] = sl;
  }
}

}  // namespace

extern "C" int ktpu_diagnose_row(const DiagArgs* args, void* stream) {
  if (args->S <= 0 || args->na.N <= 0) return 0;
  if (args->S > KT_DIAG_MAX_S) return (int)cudaErrorInvalidValue;
  const bool spread = args->has_groups && args->fam.spr_f;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(diag_ctas(args->na.N, spread), args->S);
  cfg.blockDim = dim3(BLOCK);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute at[1];
  if (spread) {
    cudaError_t e = cudaFuncSetAttribute(
        diagnose_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
    at[0].id = cudaLaunchAttributeClusterDimension;
    at[0].val.clusterDim.x = KT_DIAG_CLUSTER;
    at[0].val.clusterDim.y = 1;
    at[0].val.clusterDim.z = 1;
    cfg.attrs = at;
    cfg.numAttrs = 1;
  }
  cudaError_t e = cudaLaunchKernelEx(&cfg, diagnose_kernel, *args);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
