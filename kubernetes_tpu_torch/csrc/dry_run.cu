// dry_run: the batched preemption dry run over the candidate-node axis.
//
// Replaces kubernetes_tpu/ops/program.py dry_run_select_victims (:2169;
// the jit _dry_run_select_victims_jit :2092, with _dry_run_spread_ok
// :2077 and the spread tensors of ops/groups.py DryRunSpread :151-228):
// select_victims_on_node (default_preemption.go:583) for every candidate
// at once. Per candidate c (node row cand[c]):
//   1. the preemptor's static filters on the node (name, unschedulable,
//      taints, selector / required node affinity);
//   2. the fit with every valid victim removed and the nominated-pod
//      overlay added: base_used = used + ovl_used − Σ victim_req,
//      base_npods = npods + ovl_npods − #victims; with a DoNotSchedule
//      spread, the matching victims' counts removed too and the skew
//      test of _dry_run_spread_ok (the criticalPaths closed form
//      min(x, other_min), the minDomains zero floor);
//   3. the reprieve scan over the V victim slots in reprieve order: a
//      valid victim is added back when the preemptor still fits (pods,
//      every resource column, the spread skew), and the running state
//      moves only then.
// Output bool [C, V+1]: column 0 = step 2's verdict, column 1+v = victim
// v reprieved. All integer arithmetic is the JAX program's: int64
// resources, int32 pod and spread counts.
//
// What bounds it on an H100: each candidate is independent and its only
// sequential dependency is its own V-step scan, so one thread owns one
// candidate and the grid spans the candidate axis (C = 8,192 at the
// PreemptionChurn shape: 32 blocks of 256 threads). The work is a few
// hundred integer operations per candidate-victim pair and the bytes are
// the victims' request rows (C·V·R int64), so the kernel is bound by its
// loads and by launch latency, far below either roof. A thread walks its
// victim rows in order (stride V·R·8 bytes between neighbouring
// threads, not coalesced): fine for a first kernel at V = 1..8.

#include "lean_eval.cuh"

#define KT_DRY_MAX_R 64     // resource columns (ops/kernels.py MAX_DRY_R)
#define KT_DRY_MAX_SC 8     // spread constraints (ops/groups.py SC bound)

namespace {

constexpr int DBLOCK = 256;

}  // namespace

struct DryArgsC {         // mirrored field for field by ops/kernels.py
  NodeC na;
  TableC tb;                    // the preemptor's row as a one-row table
  const int64_t* used;          // [N, R] node state
  const int32_t* npods;         // [N]
  const int32_t* cand;          // [C]
  const int64_t* victim_req;    // [C, V, R]
  const uint8_t* victim_valid;  // [C, V]
  const int64_t* ovl_used;      // [C, R]
  const int32_t* ovl_npods;     // [C]
  int32_t C, V, has_spread;
  // groups.DryRunSpread (has_spread = 0: none)
  const int32_t* max_skew;      // [SC]
  const int32_t* self_match;    // [SC]
  const uint8_t* min_zero;      // [SC]
  const uint8_t* tv_ok;         // [C, SC]
  const int32_t* cnt0;          // [C, SC]
  const int32_t* other_min;     // [C, SC]
  const uint8_t* vic_match;     // [C, V, SC]
  int32_t SC;
  uint8_t* out;                 // [C, V+1]
};

namespace {

// _dry_run_spread_ok (:2077) for candidate c given its removed counts
__device__ __forceinline__ bool spread_ok(const DryArgsC& a, int c,
                                          const int32_t* removed) {
  for (int j = 0; j < a.SC; ++j) {
    const int64_t cj = (int64_t)c * a.SC + j;
    const int32_t x = a.cnt0[cj] - removed[j];
    const int32_t om = a.other_min[cj];
    const int32_t min_eff = a.min_zero[j] ? 0 : (x < om ? x : om);
    if (!a.tv_ok[cj]) return false;
    if (!(x + a.self_match[j] - min_eff <= a.max_skew[j])) return false;
  }
  return true;
}

__global__ void __launch_bounds__(DBLOCK) dry_run_kernel(DryArgsC a) {
  const int c = blockIdx.x * DBLOCK + threadIdx.x;
  if (c >= a.C) return;
  const NodeC& na = a.na;
  const int R = na.R, V = a.V;
  uint8_t* out = a.out + (int64_t)c * (V + 1);
  const int node = a.cand[c];
  if (node < 0 || node >= na.N) {
    // a row outside the node axis (the wrapper's caller never passes
    // one): no candidate, nothing reprieved
    for (int v = 0; v <= V; ++v) out[v] = 0;
    return;
  }
  const PodRowD p = pod_row(a.tb, 0);
  // 1. the static filters (_dry_run_select_victims_jit :2128-2133)
  bool m = na.valid[node] != 0;
  m = m && (p.node_name_id == 0 || na.name_id[node] == p.node_name_id);
  m = m && (!na.unschedulable[node] || p.tolerates_unsched);
  m = m && kt_taints_ok(na, node, p, a.tb.TT);
  m = m && kt_selector_ok(na, node, p, a.tb.Q, a.tb.TM, a.tb.V);
  // 2. every victim removed, the overlay added (:2134-2144)
  const int64_t* vreq = a.victim_req + (int64_t)c * V * R;
  const uint8_t* vvalid = a.victim_valid + (int64_t)c * V;
  const int64_t* cap = na.cap + (int64_t)node * R;
  int64_t used[KT_DRY_MAX_R];
  int32_t nv = 0;
  for (int r = 0; r < R; ++r) {
    int64_t total = 0;
    for (int v = 0; v < V; ++v)
      if (vvalid[v]) total += vreq[(int64_t)v * R + r];
    used[r] = a.used[(int64_t)node * R + r] + a.ovl_used[(int64_t)c * R + r]
              - total;
  }
  for (int v = 0; v < V; ++v) nv += vvalid[v] ? 1 : 0;
  int32_t npods = a.npods[node] + a.ovl_npods[c] - nv;
  bool fits = m && (int64_t)npods + 1 <= (int64_t)na.allowed_pods[node];
  for (int r = 0; r < R && fits; ++r) {
    const int64_t q = p.req[r];
    if (q != 0 && !(used[r] + q <= cap[r])) fits = false;
  }
  int32_t removed[KT_DRY_MAX_SC];
  const uint8_t* vm =
      a.has_spread ? a.vic_match + (int64_t)c * V * a.SC : nullptr;
  if (a.has_spread) {
    for (int j = 0; j < a.SC; ++j) {
      int32_t s = 0;
      for (int v = 0; v < V; ++v)
        if (vvalid[v] && vm[(int64_t)v * a.SC + j]) ++s;
      removed[j] = s;
    }
    fits = fits && spread_ok(a, c, removed);
  }
  out[0] = fits;
  // 3. the reprieve scan (:2152-2166)
  for (int v = 0; v < V; ++v) {
    const int64_t* req_v = vreq + (int64_t)v * R;
    const int32_t t_npods = npods + 1;
    bool ok = vvalid[v] && (int64_t)t_npods + 1
                               <= (int64_t)na.allowed_pods[node];
    for (int r = 0; r < R && ok; ++r) {
      const int64_t q = p.req[r];
      if (q != 0 && !(used[r] + req_v[r] + q <= cap[r])) ok = false;
    }
    if (a.has_spread && ok) {
      int32_t t_removed[KT_DRY_MAX_SC];
      for (int j = 0; j < a.SC; ++j)
        t_removed[j] = removed[j] - (vm[(int64_t)v * a.SC + j] ? 1 : 0);
      ok = spread_ok(a, c, t_removed);
      if (ok)
        for (int j = 0; j < a.SC; ++j) removed[j] = t_removed[j];
    }
    if (ok) {
      for (int r = 0; r < R; ++r) used[r] += req_v[r];
      npods = t_npods;
    }
    out[1 + v] = ok;
  }
}

}  // namespace

extern "C" int ktpu_dry_run(const DryArgsC* args, void* stream) {
  if (args->C > 0) {
    dry_run_kernel<<<(args->C + DBLOCK - 1) / DBLOCK, DBLOCK, 0,
                     (cudaStream_t)stream>>>(*args);
  }
  return (int)cudaGetLastError();
}
