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
//      every requested resource column, the spread skew), and the
//      running state moves only then.
// Output bool [C, V+1]: column 0 = step 2's verdict, column 1+v = victim
// v reprieved. All integer arithmetic is the JAX program's: int64
// resources, int32 pod and spread counts.
//
// The subset entry: the Evaluator re-evaluates a preemptor's
// overlay-touched candidates through `sub` [C], positions into the plan's
// candidate axis; the kernel reads cand, victim_req, victim_valid and the
// spread tensors through it in place (no gathers), and the output and the
// overlay rows are in the order of `sub`. Without `sub`, output row i is
// candidate i. The wave-constant arguments (DryPlanC) are packed once per
// plan by the wrapper (ops/kernels.py DryRunArgs).
//
// What bounds it on an H100: each candidate is independent and its only
// sequential dependency is its own V-step scan; the bytes are the
// victims' requested columns (C·V·R int64 at most) and a few hundred
// integer operations per candidate-victim pair, far below either roof,
// so the kernel is bound by its dependent loads and launch latency.
//
// Design: one warp a candidate. Only the preemptor's requested columns
// (req != 0) move the verdict, so lane l holds the running sum of
// columns l and l + 32 when requested (R ≤ 64) in registers, the victim
// rows are read coalesced (neighbouring lanes, neighbouring columns), and
// a fit is one __all_sync over the lanes; with a spread, lane j < SC holds
// constraint j's removed count, and the skew test is another __all_sync.
// The static filters and the victim validity bits are warp-uniform
// loads. No per-thread array, so no local memory.

#include "lean_eval.cuh"

#define KT_DRY_MAX_R 64     // resource columns (ops/kernels.py MAX_DRY_R)
#define KT_DRY_MAX_SC 8     // spread constraints (ops/groups.py SC bound)

// the wave-constant arguments, mirrored field for field by
// ops/kernels.py DryPlanC
struct DryPlanC {
  NodeC na;
  TableC tb;                    // the preemptor's row as a one-row table
  const int64_t* used;          // [N, R] node state
  const int32_t* npods;         // [N]
  const int32_t* cand;          // [Cp] the plan's candidate node rows
  const int64_t* victim_req;    // [Cp, V, R]
  const uint8_t* victim_valid;  // [Cp, V]
  int32_t Cp, V, has_spread;
  // groups.DryRunSpread (has_spread = 0: none)
  const int32_t* max_skew;      // [SC]
  const int32_t* self_match;    // [SC]
  const uint8_t* min_zero;      // [SC]
  const uint8_t* tv_ok;         // [Cp, SC]
  const int32_t* cnt0;          // [Cp, SC]
  const int32_t* other_min;     // [Cp, SC]
  const uint8_t* vic_match;     // [Cp, V, SC]
  int32_t SC;
};

namespace {

constexpr int DBLOCK = 256;            // 8 candidates a block
constexpr unsigned FULL = 0xffffffffu;

// _dry_run_spread_ok (:2077) for one candidate, lane j < SC testing
// constraint j at its removed count `rem`; every lane gets the verdict
struct SpreadLane {
  int32_t cnt0 = 0, om = 0, self_match = 0, max_skew = 0;
  bool tv_ok = true, min_zero = false, on = false;
  __device__ bool ok(int32_t rem) const {
    bool good = true;
    if (on) {
      const int32_t x = cnt0 - rem;
      const int32_t min_eff = min_zero ? 0 : (x < om ? x : om);
      good = tv_ok && x + self_match - min_eff <= max_skew;
    }
    return __all_sync(FULL, good);
  }
};

__global__ void __launch_bounds__(DBLOCK)
dry_run_kernel(const __grid_constant__ DryPlanC a, const int32_t* sub,
               const int64_t* ovl_used, const int32_t* ovl_npods, int C,
               uint8_t* out_all) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * (DBLOCK / 32) + (int)(threadIdx.x >> 5);
  if (i >= C) return;   // the whole warp
  const NodeC& na = a.na;
  const int R = na.R, V = a.V;
  uint8_t* out = out_all + (int64_t)i * (V + 1);
  const int c = sub ? sub[i] : i;
  const int node = (c >= 0 && c < a.Cp) ? a.cand[c] : -1;
  if (node < 0 || node >= na.N) {
    // a position or row outside the axes (the callers never pass one):
    // no candidate, nothing reprieved
    for (int v = lane; v <= V; v += 32) out[v] = 0;
    return;
  }
  const PodRowD p = pod_row(a.tb, 0);
  // 1. the static filters (_dry_run_select_victims_jit :2128-2133), alike
  // in every lane
  bool m = na.valid[node] != 0;
  m = m && (p.node_name_id == 0 || na.name_id[node] == p.node_name_id);
  m = m && (!na.unschedulable[node] || p.tolerates_unsched);
  m = m && kt_taints_ok(na, node, p, a.tb.TT);
  m = m && kt_selector_ok(na, node, p, a.tb.Q, a.tb.TM, a.tb.V);
  // 2. every victim removed, the overlay added (:2134-2144), on this
  // lane's requested columns
  const int c0 = lane, c1 = lane + 32;
  const int64_t q0 = c0 < R ? p.req[c0] : 0;
  const int64_t q1 = c1 < R ? p.req[c1] : 0;
  const int64_t* vreq = a.victim_req + (int64_t)c * V * R;
  const uint8_t* vvalid = a.victim_valid + (int64_t)c * V;
  const int64_t row = (int64_t)node * R, orow = (int64_t)i * R;
  int64_t cap0 = 0, cap1 = 0, u0 = 0, u1 = 0;
  if (q0) {
    cap0 = na.cap[row + c0];
    u0 = a.used[row + c0] + ovl_used[orow + c0];
  }
  if (q1) {
    cap1 = na.cap[row + c1];
    u1 = a.used[row + c1] + ovl_used[orow + c1];
  }
  const bool sp = a.has_spread != 0;
  SpreadLane sl;
  const uint8_t* vm = nullptr;
  int32_t removed = 0;
  if (sp && lane < a.SC) {
    const int64_t cj = (int64_t)c * a.SC + lane;
    sl.on = true;
    sl.cnt0 = a.cnt0[cj];
    sl.om = a.other_min[cj];
    sl.tv_ok = a.tv_ok[cj] != 0;
    sl.min_zero = a.min_zero[lane] != 0;
    sl.self_match = a.self_match[lane];
    sl.max_skew = a.max_skew[lane];
    vm = a.vic_match + (int64_t)c * V * a.SC + lane;
  }
  int32_t nv = 0;
  for (int v = 0; v < V; ++v) {
    if (!vvalid[v]) continue;
    ++nv;
    if (q0) u0 -= vreq[(int64_t)v * R + c0];
    if (q1) u1 -= vreq[(int64_t)v * R + c1];
    if (vm && vm[(int64_t)v * a.SC]) ++removed;
  }
  int32_t npods = a.npods[node] + ovl_npods[i] - nv;
  const int64_t allowed = na.allowed_pods[node];
  const bool cols = __all_sync(FULL, (!q0 || u0 + q0 <= cap0)
                                     && (!q1 || u1 + q1 <= cap1));
  bool fits = m && (int64_t)npods + 1 <= allowed && cols;
  if (sp) {
    const bool s_ok = sl.ok(removed);
    fits = fits && s_ok;
  }
  if (lane == 0) out[0] = fits;
  // 3. the reprieve scan (:2152-2166)
  for (int v = 0; v < V; ++v) {
    const bool valid = vvalid[v] != 0;
    const int32_t t_npods = npods + 1;
    int64_t r0 = 0, r1 = 0;
    if (valid && q0) r0 = vreq[(int64_t)v * R + c0];
    if (valid && q1) r1 = vreq[(int64_t)v * R + c1];
    const bool vcols = __all_sync(FULL, (!q0 || u0 + r0 + q0 <= cap0)
                                        && (!q1 || u1 + r1 + q1 <= cap1));
    bool ok = valid && (int64_t)t_npods + 1 <= allowed && vcols;
    const int32_t t_removed = removed - ((vm && vm[(int64_t)v * a.SC]) ? 1
                                                                      : 0);
    if (sp) {
      const bool s_ok = sl.ok(t_removed);
      ok = ok && s_ok;
    }
    if (ok) {
      u0 += r0;
      u1 += r1;
      npods = t_npods;
      removed = t_removed;
    }
    if (lane == 0) out[1 + v] = ok;
  }
}

}  // namespace

// plan: the wave-constant arguments; sub: [C] positions into the plan's
// candidate axis, or nullptr (row i is candidate i, C = Cp); ovl_used
// [C, R] and ovl_npods [C]: the nominated-pod overlay in the output's
// order; out: bool [C, V+1]
extern "C" int ktpu_dry_run(const DryPlanC* plan, const int32_t* sub,
                            const int64_t* ovl_used,
                            const int32_t* ovl_npods, int C, uint8_t* out,
                            void* stream) {
  if (C > 0) {
    const int per = DBLOCK / 32;
    dry_run_kernel<<<(C + per - 1) / per, DBLOCK, 0,
                     (cudaStream_t)stream>>>(*plan, sub, ovl_used, ovl_npods,
                                             C, out);
  }
  return (int)cudaGetLastError();
}
