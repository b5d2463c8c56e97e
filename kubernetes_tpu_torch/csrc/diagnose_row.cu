// diagnose_row: each node's first failing filter for one signature row,
// plus the fit detail of the NodeResourcesFit reasons.
//
// Replaces kubernetes_tpu/ops/program.py diagnose_row (:627; the jits
// _diagnose_lean :621 and _diagnose_groups :614 over _diagnose_masks
// :579) with ops/groups.py group_reason_masks (:340). The slot of node n
// is the first of, in the host plugin order (_diagnose_masks :599-610):
//   invalid → unschedulable → node name → taint → selector → ports →
//   fit → spread label → spread skew → affinity → anti → existing anti
//   → feasible (DIAG_* values :564-576),
// with pods_fail[n] = npods + 1 > allowed_pods and cols_fail[n, r] =
// req[r] != 0 & used[n, r] + req[r] > cap[n, r]. Spread attributes a node
// to its FIRST failing DoNotSchedule constraint (missing key → label,
// else skew), against the per-constraint minimum over the count-eligible
// nodes; the lean launch reads no group tensors.
//
// What bounds it on an H100: one pass over the node rows (the lean filter
// loops over each node's occupied taint, label and port slots, and with
// groups the row's [SC / TA / TAA, N] tensors), a few hundred bytes per
// node: at N = 8,192 a few MB at most, launch-latency bound.
//
// Design: one thread per node over a grid of 256-thread blocks — the
// port's first kernel that spreads over many SMs. Its one cross-node
// dependency, the spread minimum, is recomputed by every block over the
// whole node axis (block_spread_min, SC·N int32 reads per block, L2
// resident) before its nodes take the skew test: no atomics, no second
// launch and no grid-wide barrier.

#include "group_eval.cuh"

// the kernel's arguments, mirrored field for field by ctypes
// (ops/kernels.py DiagArgsC)
struct DiagArgs {
  NodeC na;
  TableC tb;
  const int64_t* used;    // [N, R] node state (the post-commit truth)
  const int32_t* npods;   // [N]
  const int32_t* ports;   // [N, P]
  int32_t P, tidx, has_groups;
  GroupsC g;
  GCarryC gc;
  FamC fam;
  int32_t* slot;          // [N]
  uint8_t* pods_fail;     // [N]
  uint8_t* cols_fail;     // [N, R]
};

namespace {

constexpr int BLOCK = 256;

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


__global__ void __launch_bounds__(BLOCK) diagnose_kernel(DiagArgs a) {
  __shared__ BlockScratch<BLOCK> sh;
  __shared__ int32_t minv[KT_MAX_SC];
  const int N = a.na.N, R = a.na.R;
  const int64_t NN = N;
  GViewD v;
  if (a.has_groups) {
    v = view_of(a.g, a.gc, a.tidx);
    // every block reduces the whole node axis (ends with a barrier)
    if (a.fam.spr_f) block_spread_min<BLOCK>(v, minv, sh);
  }
  const int n = blockIdx.x * BLOCK + threadIdx.x;
  if (n >= N) return;
  const PodRowD p = pod_row(a.tb, a.tidx);
  // fit detail (every node, whatever its slot)
  const int64_t* cap = a.na.cap + n * (int64_t)R;
  const int64_t* used = a.used + n * (int64_t)R;
  const bool pods_fail = (int64_t)a.npods[n] + 1 > (int64_t)a.na.allowed_pods[n];
  bool any_col = false;
  for (int r = 0; r < R; ++r) {
    const bool f = p.req[r] != 0 && used[r] + p.req[r] > cap[r];
    a.cols_fail[n * (int64_t)R + r] = f;
    any_col = any_col || f;
  }
  a.pods_fail[n] = pods_fail;

  int32_t s = DIAG_FEASIBLE;
  if (!a.na.valid[n]) {
    s = DIAG_INVALID;
  } else if (a.na.unschedulable[n] && !p.tolerates_unsched) {
    s = DIAG_NODE_UNSCHEDULABLE;
  } else if (!(p.node_name_id == 0 || a.na.name_id[n] == p.node_name_id)) {
    s = DIAG_NODE_NAME;
  } else if (!kt_taints_ok(a.na, n, p, a.tb.TT)) {
    s = DIAG_TAINT;
  } else if (!kt_selector_ok(a.na, n, p, a.tb.Q, a.tb.TM, a.tb.V)) {
    s = DIAG_NODE_AFFINITY;
  } else if (!kt_ports_ok(a.ports + n * (int64_t)a.P, a.P, p.port_ids,
                          a.tb.PP)) {
    s = DIAG_PORTS;
  } else if (pods_fail || any_col) {
    s = DIAG_FIT;
  } else if (a.has_groups) {
    // group_reason_masks (:340), layered in the host plugin order
    if (a.fam.spr_f) {
      for (int c = 0; c < v.SC; ++c) {
        if (!v.f_act[c]) continue;
        const int64_t k = (int64_t)c * NN + n;
        if (v.f_tv[k] == 0) {
          s = DIAG_SPREAD_LABEL;
          break;
        }
        if ((int64_t)v.f_cnt[k] + v.f_self[c] - minv[c] > v.f_skew[c]) {
          s = DIAG_SPREAD_SKEW;
          break;
        }
      }
    }
    if (s == DIAG_FEASIBLE && a.fam.ipa_req) {
      bool any = false, tv_all = true, pods_exist = true;
      for (int t = 0; t < v.TA; ++t) {
        if (!v.ra_act[t]) continue;
        const int64_t k = (int64_t)t * NN + n;
        any = true;
        tv_all = tv_all && v.ra_tv[k] != 0;
        pods_exist = pods_exist && v.a_cnt[k] > 0;
      }
      const bool escape = v.a_total == 0 && v.self_all;
      if (any && !(tv_all && (pods_exist || escape))) s = DIAG_IPA_AFFINITY;
    }
    if (s == DIAG_FEASIBLE && a.fam.ipa_anti) {
      for (int t = 0; t < v.TAA; ++t) {
        const int64_t k = (int64_t)t * NN + n;
        if (v.raa_act[t] && v.raa_tv[k] != 0 && v.aa_cnt[k] > 0) {
          s = DIAG_IPA_ANTI;
          break;
        }
      }
      if (s == DIAG_FEASIBLE && v.veto[n] != 0) s = DIAG_IPA_EXISTING_ANTI;
    }
  }
  a.slot[n] = s;
}

}  // namespace

extern "C" int ktpu_diagnose_row(const DiagArgs* args, void* stream) {
  const int N = args->na.N;
  if (N > 0)
    diagnose_kernel<<<(N + BLOCK - 1) / BLOCK, BLOCK, 0,
                      (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}
