// Per-node filter and score math of the lean device program, shared by the
// scan kernel (run_batch.cu), the closed-form kernels (run_uniform.cu) and
// the preemption dry run (dry_run.cu) so all compute the same bits. Each function is the CUDA form of the
// matching function in kubernetes_tpu/ops/program.py (line numbers below)
// and of its plain PyTorch twin in kubernetes_tpu_torch/ops/program.py.
//
// Arithmetic rules that keep the kernels equal to the JAX program:
//  - every integer division goes through floordiv (JAX's `//` floors);
//  - the float64 BalancedAllocation and ImageLocality arithmetic uses the
//    explicitly rounded intrinsics (__dadd_rn, __dmul_rn, ...), so no
//    multiply-add is ever contracted into an FMA, and the column sums run
//    left to right like XLA's and numpy's for these short rows.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define KT_MAX_SCORE 100LL
#define KT_EFFECT_NO_SCHEDULE 1
#define KT_EFFECT_PREFER_NO_SCHEDULE 2
#define KT_EFFECT_NO_EXECUTE 3
#define KT_OP_IN 1
#define KT_OP_NOT_IN 2
#define KT_OP_EXISTS 3
#define KT_OP_DOES_NOT_EXIST 4
#define KT_OP_GT 5
#define KT_OP_LT 6
#define KT_TOL_EXISTS 2
#define KT_I64_MIN (-9223372036854775807LL - 1LL)
#define KT_MAX_C 8    // score columns
#define KT_MAX_IC 16  // container images per pod
// plugins/imagelocality.py thresholds
#define KT_IMG_MIN_THRESHOLD (23LL * 1024 * 1024)
#define KT_IMG_MAX_CONTAINER_THRESHOLD (1000LL * 1024 * 1024)

// ---------------------------------------------------------------------------
// argument structs (mirrored field for field by ctypes in ops/kernels.py)

struct NodeC {            // the static node columns (state/tensorize.py)
  const int64_t* cap;           // [N, R]
  const int32_t* allowed_pods;  // [N]
  const uint8_t* valid;         // [N]
  const uint8_t* unschedulable; // [N]
  const int32_t* name_id;       // [N]
  const int32_t* taint_key;     // [N, T]
  const int32_t* taint_val;
  const int32_t* taint_eff;
  const int32_t* label_key;     // [N, Lb]
  const int32_t* label_kv;
  const int64_t* label_num;
  const int32_t* image_id;      // [N, I]
  const int64_t* image_size;
  int32_t N, R, T, Lb, I;
};

struct CacheC {           // SigCache
  int32_t* sig;                 // scalar
  uint8_t* static_mask;         // [N]
  int64_t* taint_raw;
  int64_t* na_raw;
  int64_t* s_img;
  uint8_t* fit_ok;
  int64_t* s_fit;
  int64_t* s_bal;
};

struct CarryC {
  int64_t* used;                // [N, R]
  int64_t* nonzero_used;        // [N, 2]
  int32_t* npods;               // [N]
  int32_t* ports;               // [N, P]
  int32_t P;
  CacheC cache;
};

struct TableC {           // PodTableDev ([U, ...])
  const int64_t* req;           // [U, R]
  const int64_t* nonzero_req;   // [U, 2]
  const int32_t* node_name_id;  // [U]
  const int32_t* tol_key;       // [U, TT]
  const int32_t* tol_val;
  const int32_t* tol_eff;
  const int32_t* tol_op;
  const uint8_t* tolerates_unsched;  // [U]
  const int32_t* ns_sel_val;    // [U, Q]
  const uint8_t* aff_has;       // [U]
  const uint8_t* aff_term_valid;  // [U, TM]
  const int32_t* aff_key;       // [U, TM, Q]
  const int32_t* aff_op;
  const int64_t* aff_num;
  const int32_t* aff_val;       // [U, TM, Q, V]
  const int64_t* pref_weight;   // [U, PT]
  const int32_t* pref_key;      // [U, PT, Q]
  const int32_t* pref_op;
  const int64_t* pref_num;
  const int32_t* pref_val;      // [U, PT, Q, V]
  const int32_t* port_ids;      // [U, PP]
  const uint8_t* skip_balanced; // [U]
  const int32_t* img_ids;       // [U, IC]
  const int32_t* img_containers;  // [U]
  int32_t U, R, TT, Q, TM, V, PT, PP, IC;
};

struct CfgC {             // ScoreConfig
  int32_t C;
  int32_t score_cols[KT_MAX_C];
  int64_t col_weights[KT_MAX_C];
  int32_t col_nonzero[KT_MAX_C];
  int32_t nonzero_slot[KT_MAX_C];
  int64_t w_fit, w_balanced, w_taint, w_node_affinity, w_image;
  int32_t most_allocated;
};

// one pod's table row
struct PodRowD {
  const int64_t* req;
  const int64_t* nonzero_req;
  int32_t node_name_id;
  const int32_t* tol_key;
  const int32_t* tol_val;
  const int32_t* tol_eff;
  const int32_t* tol_op;
  bool tolerates_unsched;
  const int32_t* ns_sel_val;
  bool aff_has;
  const uint8_t* aff_term_valid;
  const int32_t* aff_key;
  const int32_t* aff_op;
  const int64_t* aff_num;
  const int32_t* aff_val;
  const int64_t* pref_weight;
  const int32_t* pref_key;
  const int32_t* pref_op;
  const int64_t* pref_num;
  const int32_t* pref_val;
  const int32_t* port_ids;
  bool skip_balanced;
  const int32_t* img_ids;
  int32_t img_containers;
};

__device__ __forceinline__ PodRowD pod_row(const TableC& t, int u) {
  PodRowD p;
  const int tq = t.TM * t.Q, pq = t.PT * t.Q;
  p.req = t.req + (int64_t)u * t.R;
  p.nonzero_req = t.nonzero_req + (int64_t)u * 2;
  p.node_name_id = t.node_name_id[u];
  p.tol_key = t.tol_key + (int64_t)u * t.TT;
  p.tol_val = t.tol_val + (int64_t)u * t.TT;
  p.tol_eff = t.tol_eff + (int64_t)u * t.TT;
  p.tol_op = t.tol_op + (int64_t)u * t.TT;
  p.tolerates_unsched = t.tolerates_unsched[u] != 0;
  p.ns_sel_val = t.ns_sel_val + (int64_t)u * t.Q;
  p.aff_has = t.aff_has[u] != 0;
  p.aff_term_valid = t.aff_term_valid + (int64_t)u * t.TM;
  p.aff_key = t.aff_key + (int64_t)u * tq;
  p.aff_op = t.aff_op + (int64_t)u * tq;
  p.aff_num = t.aff_num + (int64_t)u * tq;
  p.aff_val = t.aff_val + (int64_t)u * tq * t.V;
  p.pref_weight = t.pref_weight + (int64_t)u * t.PT;
  p.pref_key = t.pref_key + (int64_t)u * pq;
  p.pref_op = t.pref_op + (int64_t)u * pq;
  p.pref_num = t.pref_num + (int64_t)u * pq;
  p.pref_val = t.pref_val + (int64_t)u * pq * t.V;
  p.port_ids = t.port_ids + (int64_t)u * t.PP;
  p.skip_balanced = t.skip_balanced[u] != 0;
  p.img_ids = t.img_ids + (int64_t)u * t.IC;
  p.img_containers = t.img_containers[u];
  return p;
}

__device__ __forceinline__ int64_t floordiv(int64_t a, int64_t b) {
  int64_t q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) --q;
  return q;
}

// ---------------------------------------------------------------------------
// filters (program.py:110-217)

// fit_mask (:110) for one node, given the carry's row
__device__ __forceinline__ bool kt_fit(const NodeC& na, int n,
                                       const int64_t* used_row, int32_t npods,
                                       const PodRowD& p) {
  if (!((int64_t)npods + 1 <= (int64_t)na.allowed_pods[n])) return false;
  const int64_t* cap = na.cap + (int64_t)n * na.R;
  for (int r = 0; r < na.R; ++r) {
    const int64_t q = p.req[r];
    if (q != 0 && !(used_row[r] + q <= cap[r])) return false;
  }
  return true;
}

// The nominated-pod overlay (_slow_parts :424-454 `overlay`): nominated
// pods' requests and counts per node row, folded into the FIT only. Null
// pointers = no overlay; the lean launches pass nulls and take kt_fit.
struct OvlD {
  const int64_t* used;          // [N, R]
  const int32_t* npods;         // [N]
};

// fit_mask at `used + ovl_used`, `npods + ovl_npods` (the overlaid fit of
// _slow_parts and _row_refresh)
__device__ __forceinline__ bool kt_fit_ovl(const NodeC& na, int n,
                                           const int64_t* used_row,
                                           int32_t npods, const PodRowD& p,
                                           const OvlD& ovl) {
  if (ovl.used == nullptr) return kt_fit(na, n, used_row, npods, p);
  const int64_t* orow = ovl.used + (int64_t)n * na.R;
  const int32_t onp = npods + ovl.npods[n];
  if (!((int64_t)onp + 1 <= (int64_t)na.allowed_pods[n])) return false;
  const int64_t* cap = na.cap + (int64_t)n * na.R;
  for (int r = 0; r < na.R; ++r) {
    const int64_t q = p.req[r];
    if (q != 0 && !(used_row[r] + orow[r] + q <= cap[r])) return false;
  }
  return true;
}

// _eval_pod's self-exclusion (:515-528): the fit at the pod's own
// nominated row `n` with its own nomination taken back out of the overlay.
// The overlay holds the pod's own request and count there, so removing
// them and adding the pod back leaves used + ovl ≤ cap on the pod's
// columns and npods + ovl_npods ≤ allowed.
__device__ __forceinline__ bool kt_own_nomination_fit(
    const NodeC& na, int n, const int64_t* used_row, int32_t npods,
    const PodRowD& p, const OvlD& ovl) {
  const int64_t* orow = ovl.used + (int64_t)n * na.R;
  const int32_t onp = npods + ovl.npods[n];
  if (!((int64_t)onp <= (int64_t)na.allowed_pods[n])) return false;
  const int64_t* cap = na.cap + (int64_t)n * na.R;
  for (int r = 0; r < na.R; ++r)
    if (p.req[r] != 0 && !(used_row[r] + orow[r] <= cap[r])) return false;
  return true;
}

// tolerates (:116) for toleration tt (with op `op`) against taint (k, v, e)
__device__ __forceinline__ bool kt_tolerates(const PodRowD& p, int tt,
                                             int32_t op, int32_t k,
                                             int32_t v, int32_t e) {
  const int32_t tk = p.tol_key[tt], te = p.tol_eff[tt];
  return op != 0 && (tk == 0 || tk == k) && (te == 0 || te == e)
      && (op == KT_TOL_EXISTS || p.tol_val[tt] == v);
}

// taint_filter_mask (:126)
__device__ __forceinline__ bool kt_taints_ok(const NodeC& na, int n,
                                             const PodRowD& p, int TT) {
  const int64_t base = (int64_t)n * na.T;
  for (int t = 0; t < na.T; ++t) {
    const int32_t e = na.taint_eff[base + t];
    if (e != KT_EFFECT_NO_SCHEDULE && e != KT_EFFECT_NO_EXECUTE) continue;
    const int32_t k = na.taint_key[base + t], v = na.taint_val[base + t];
    bool tol = false;
    for (int tt = 0; tt < TT && !tol; ++tt)
      tol = kt_tolerates(p, tt, p.tol_op[tt], k, v, e);
    if (!tol) return false;
  }
  return true;
}

// taint_prefer_count (:138)
__device__ __forceinline__ int64_t kt_taint_prefer(const NodeC& na, int n,
                                                   const PodRowD& p, int TT) {
  const int64_t base = (int64_t)n * na.T;
  int64_t cnt = 0;
  for (int t = 0; t < na.T; ++t) {
    const int32_t e = na.taint_eff[base + t];
    if (e != KT_EFFECT_PREFER_NO_SCHEDULE) continue;
    const int32_t k = na.taint_key[base + t], v = na.taint_val[base + t];
    bool tol = false;
    for (int tt = 0; tt < TT && !tol; ++tt) {
      const int32_t te = p.tol_eff[tt];
      const int32_t op = (te == 0 || te == KT_EFFECT_PREFER_NO_SCHEDULE)
                             ? p.tol_op[tt] : 0;
      tol = kt_tolerates(p, tt, op, k, v, e);
    }
    if (!tol) ++cnt;
  }
  return cnt;
}

// _requirement_ok (:153) for one node
__device__ __forceinline__ bool kt_requirement(const NodeC& na, int n,
                                               int32_t key, int32_t op,
                                               int64_t num,
                                               const int32_t* vals, int V) {
  if (op < KT_OP_IN || op > KT_OP_LT) return true;  // padding / unknown
  const int64_t base = (int64_t)n * na.Lb;
  bool present = false, kv_match = false;
  int64_t numeric = KT_I64_MIN;
  for (int l = 0; l < na.Lb; ++l) {
    const bool hit = key != 0 && na.label_key[base + l] == key;
    if (hit) {
      present = true;
      const int64_t x = na.label_num[base + l];
      if (x > numeric) numeric = x;
    }
    const int32_t kv = na.label_kv[base + l];
    for (int v = 0; v < V; ++v)
      if (vals[v] != 0 && vals[v] == kv) kv_match = true;
  }
  const bool has_numeric = present && numeric != KT_I64_MIN;
  switch (op) {
    case KT_OP_IN: return kv_match;
    case KT_OP_NOT_IN: return !kv_match;
    case KT_OP_EXISTS: return present;
    case KT_OP_DOES_NOT_EXIST: return !present;
    case KT_OP_GT: return has_numeric && numeric > num;
    default: return has_numeric && numeric < num;  // KT_OP_LT
  }
}

// _term_ok (:171): requirements ANDed
__device__ __forceinline__ bool kt_term(const NodeC& na, int n,
                                        const int32_t* keys,
                                        const int32_t* ops,
                                        const int64_t* nums,
                                        const int32_t* vals, int Q, int V) {
  for (int q = 0; q < Q; ++q)
    if (!kt_requirement(na, n, keys[q], ops[q], nums[q], vals + q * V, V))
      return false;
  return true;
}

// selector_mask (:177)
__device__ __forceinline__ bool kt_selector_ok(const NodeC& na, int n,
                                               const PodRowD& p, int Q,
                                               int TM, int V) {
  const int64_t base = (int64_t)n * na.Lb;
  for (int q = 0; q < Q; ++q) {
    const int32_t want = p.ns_sel_val[q];
    if (want == 0) continue;
    bool present = false;
    for (int l = 0; l < na.Lb && !present; ++l)
      present = na.label_kv[base + l] == want;
    if (!present) return false;
  }
  if (!p.aff_has) return true;
  for (int t = 0; t < TM; ++t) {
    if (!p.aff_term_valid[t]) continue;
    if (kt_term(na, n, p.aff_key + t * Q, p.aff_op + t * Q,
                p.aff_num + t * Q, p.aff_val + t * Q * V, Q, V))
      return true;
  }
  return false;
}

// preferred_affinity_score (:197); zero-weight terms add nothing
__device__ __forceinline__ int64_t kt_pref_score(const NodeC& na, int n,
                                                 const PodRowD& p, int PT,
                                                 int Q, int V) {
  int64_t s = 0;
  for (int t = 0; t < PT; ++t) {
    const int64_t w = p.pref_weight[t];
    if (w == 0) continue;
    if (kt_term(na, n, p.pref_key + t * Q, p.pref_op + t * Q,
                p.pref_num + t * Q, p.pref_val + t * Q * V, Q, V))
      s += w;
  }
  return s;
}

// ports_mask (:207) against one node's carried port row
__device__ __forceinline__ bool kt_ports_ok(const int32_t* row, int P,
                                            const int32_t* pid, int PP) {
  int needed = 0;
  for (int q = 0; q < PP; ++q) {
    const int32_t x = pid[q];
    if (x == 0) continue;
    ++needed;
    for (int s = 0; s < P; ++s)
      if (row[s] == x) return false;
  }
  int free_slots = 0;
  for (int s = 0; s < P; ++s) free_slots += row[s] == 0;
  return free_slots >= needed;
}

// ---------------------------------------------------------------------------
// scores (program.py:230-306)

// image_locality_score (:230), part 1: per container c, does node n hold
// the image (bit c of the result) and its stored size
__device__ __forceinline__ uint32_t kt_image_presence(const NodeC& na, int n,
                                                      const PodRowD& p,
                                                      int IC,
                                                      int64_t* size_c) {
  uint32_t bits = 0;
  const int64_t base = (int64_t)n * na.I;
  for (int c = 0; c < IC; ++c) {
    const int32_t id = p.img_ids[c];
    int64_t s = 0;
    if (id != 0) {
      for (int i = 0; i < na.I; ++i)
        if (na.image_id[base + i] == id) {
          s += na.image_size[base + i];
          bits |= 1u << c;
        }
    }
    size_c[c] = s;
  }
  return bits;
}

// image_locality_score, part 2: the score from the cluster-wide counts
__device__ __forceinline__ int64_t kt_image_score(const PodRowD& p, int IC,
                                                  const int64_t* size_c,
                                                  const int64_t* num_with,
                                                  int64_t total) {
  if (p.img_containers <= 0) return 0;
  const double tot = (double)(total > 1 ? total : 1);
  int64_t sum = 0;
  for (int c = 0; c < IC; ++c) {
    const double spread = __ddiv_rn((double)num_with[c], tot);
    sum += (int64_t)__dmul_rn((double)size_c[c], spread);
  }
  const int64_t nc = p.img_containers > 1 ? p.img_containers : 1;
  const int64_t max_thr = KT_IMG_MAX_CONTAINER_THRESHOLD * nc;
  int64_t cl = sum < KT_IMG_MIN_THRESHOLD ? KT_IMG_MIN_THRESHOLD : sum;
  if (cl > max_thr) cl = max_thr;
  int64_t den = max_thr - KT_IMG_MIN_THRESHOLD;
  if (den < 1) den = 1;
  return floordiv(KT_MAX_SCORE * (cl - KT_IMG_MIN_THRESHOLD), den);
}

// least_allocated (:261) over the C configured columns
__device__ __forceinline__ int64_t kt_least_allocated(const CfgC& cfg,
                                                      const int64_t* cap,
                                                      const int64_t* used) {
  int64_t score_sum = 0, w_sum = 0;
  for (int c = 0; c < cfg.C; ++c) {
    if (cap[c] <= 0) continue;
    int64_t raw = 0;
    if (!(used[c] > cap[c])) {
      raw = cfg.most_allocated
                ? floordiv(used[c] * KT_MAX_SCORE, cap[c])
                : floordiv((cap[c] - used[c]) * KT_MAX_SCORE, cap[c]);
    }
    score_sum += raw * cfg.col_weights[c];
    w_sum += cfg.col_weights[c];
  }
  return w_sum > 0 ? floordiv(score_sum, w_sum) : 0;
}

// the population std (float64) of the utilization fractions of
// balanced_allocation (:278), before its int floor (score_probe reads it)
__device__ __forceinline__ double kt_balanced_std(int C, const int64_t* cap,
                                                  const int64_t* used) {
  double frac[KT_MAX_C];
  bool ok[KT_MAX_C];
  int64_t cnt = 0;
  double total = 0.0;
  for (int c = 0; c < C; ++c) {
    ok[c] = cap[c] > 0;
    const double capd = (double)(cap[c] > 1 ? cap[c] : 1);
    const double f = fmin(__ddiv_rn((double)used[c], capd), 1.0);
    frac[c] = ok[c] ? f : 0.0;
    cnt += ok[c] ? 1 : 0;
    total = c == 0 ? frac[0] : __dadd_rn(total, frac[c]);
  }
  const double cntf = (double)(cnt > 1 ? cnt : 1);
  const double mean = __ddiv_rn(total, cntf);
  double var = 0.0;
  for (int c = 0; c < C; ++c) {
    const double d = __dsub_rn(frac[c], mean);
    const double sq = ok[c] ? __dmul_rn(d, d) : 0.0;
    var = c == 0 ? sq : __dadd_rn(var, sq);
  }
  return __dsqrt_rn(__ddiv_rn(var, cntf));
}

// balanced_allocation (:278): 100·(1 − population std of the fractions)
__device__ __forceinline__ int64_t kt_balanced(int C, const int64_t* cap,
                                               const int64_t* used) {
  const double stdv = kt_balanced_std(C, cap, used);
  const double x = __dadd_rn(__dmul_rn(__dsub_rn(1.0, stdv), 100.0), 1e-9);
  return (int64_t)floor(x);
}

// _fit_scores (:409) for one node at the given carry rows (the pod's
// request is added here)
__device__ __forceinline__ void kt_fit_scores(const CfgC& cfg,
                                              const NodeC& na, int n,
                                              const int64_t* used_row,
                                              const int64_t* nz_row,
                                              const PodRowD& p,
                                              int64_t* s_fit,
                                              int64_t* s_bal) {
  int64_t capc[KT_MAX_C], usedc[KT_MAX_C], plain[KT_MAX_C];
  const int64_t* cap = na.cap + (int64_t)n * na.R;
  for (int c = 0; c < cfg.C; ++c) {
    const int col = cfg.score_cols[c];
    capc[c] = cap[col];
    plain[c] = used_row[col] + p.req[col];
    if (cfg.col_nonzero[c]) {
      const int s = cfg.nonzero_slot[c];
      usedc[c] = nz_row[s] + p.nonzero_req[s];
    } else {
      usedc[c] = plain[c];
    }
  }
  *s_fit = kt_least_allocated(cfg, capc, usedc);
  *s_bal = p.skip_balanced ? 0 : kt_balanced(cfg.C, capc, plain);
}

// parts 1 and 2 of _row_refresh (:458) at the touched row n, from its
// updated carry row (used_row, nz_row): 1 LeastAllocated into *s_fit, 2
// Balanced into *s_bal, for the batch and gang span bodies, which run the
// refresh's three parts side by side, a thread each (the refresh is the
// critical path between two evaluations); part 0, the fit, stays with
// each body (the batch's overlaid early exit, the gang's plain one). The
// plan keeps its own refresh (plan_span.cuh plan_refresh): calling this
// one there measured 3 % slower on its cluster and grid.
__device__ __forceinline__ void kt_refresh_score(
    const CfgC& cfg, const NodeC& na, int n, const int64_t* used_row,
    const int64_t* nz_row, const PodRowD& p, int part, int64_t* s_fit,
    int64_t* s_bal) {
  if (part == 2 && p.skip_balanced) {
    *s_bal = 0;
    return;
  }
  const int64_t* cap = na.cap + (int64_t)n * na.R;
  int64_t capc[KT_MAX_C], usedc[KT_MAX_C], plain[KT_MAX_C];
#pragma unroll
  for (int c = 0; c < KT_MAX_C; ++c) {
    if (c >= cfg.C) break;
    const int col = cfg.score_cols[c];
    capc[c] = cap[col];
    plain[c] = used_row[col] + p.req[col];
    const int sl = cfg.nonzero_slot[c];
    usedc[c] = cfg.col_nonzero[c] ? nz_row[sl] + p.nonzero_req[sl]
                                  : plain[c];
  }
  if (part == 1)
    *s_fit = kt_least_allocated(cfg, capc, usedc);
  else
    *s_bal = kt_balanced(cfg.C, capc, plain);
}

// default_normalize (:293) of one score given the feasible-set maximum
__device__ __forceinline__ int64_t kt_normalize(int64_t s, int64_t maxc,
                                                bool reverse) {
  if (maxc > 0) {
    const int64_t scaled = floordiv(s * KT_MAX_SCORE, maxc);
    return reverse ? KT_MAX_SCORE - scaled : scaled;
  }
  return reverse ? KT_MAX_SCORE : s;
}

// ---------------------------------------------------------------------------
// block-wide reductions (one block evaluates the whole node axis)

template <int BLOCK>
struct BlockScratch {
  int64_t v[BLOCK / 32];
  int32_t i[BLOCK / 32];
  int64_t out_v;
  int32_t out_i;
};

template <int BLOCK>
__device__ __forceinline__ int64_t block_sum(int64_t x,
                                             BlockScratch<BLOCK>& sh) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) sh.v[w] = x;
  __syncthreads();
  if (threadIdx.x == 0) {
    int64_t s = 0;
    for (int k = 0; k < BLOCK / 32; ++k) s += sh.v[k];
    sh.out_v = s;
  }
  __syncthreads();
  return sh.out_v;
}

template <int BLOCK>
__device__ __forceinline__ int64_t block_max(int64_t x,
                                             BlockScratch<BLOCK>& sh) {
  for (int o = 16; o > 0; o >>= 1) {
    const int64_t y = __shfl_down_sync(0xffffffffu, x, o);
    x = y > x ? y : x;
  }
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) sh.v[w] = x;
  __syncthreads();
  if (threadIdx.x == 0) {
    int64_t m = sh.v[0];
    for (int k = 1; k < BLOCK / 32; ++k) m = sh.v[k] > m ? sh.v[k] : m;
    sh.out_v = m;
  }
  __syncthreads();
  return sh.out_v;
}

// first-max argmax: the larger value wins, ties go to the lower index
__device__ __forceinline__ void argmax_merge(int64_t& v, int32_t& i,
                                             int64_t v2, int32_t i2) {
  if (v2 > v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

template <int BLOCK>
__device__ __forceinline__ void block_argmax(int64_t& v, int32_t& i,
                                             BlockScratch<BLOCK>& sh) {
  for (int o = 16; o > 0; o >>= 1) {
    const int64_t v2 = __shfl_down_sync(0xffffffffu, v, o);
    const int32_t i2 = __shfl_down_sync(0xffffffffu, i, o);
    argmax_merge(v, i, v2, i2);
  }
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    sh.v[w] = v;
    sh.i[w] = i;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int64_t bv = sh.v[0];
    int32_t bi = sh.i[0];
    for (int k = 1; k < BLOCK / 32; ++k) argmax_merge(bv, bi, sh.v[k], sh.i[k]);
    sh.out_v = bv;
    sh.out_i = bi;
  }
  __syncthreads();
  v = sh.out_v;
  i = sh.out_i;
}

// _slow_parts (:424) for the one row n, for kernels that run a thread a
// row (run_batch.cu, explain_row.cu, run_uniform.cu, run_uniform_sharded.cu):
// every SigCache part but s_img into `out`, the overlay `ovl` (null
// pointers: none, the default) in the fit only. Returns the
// image-presence bits of a valid row (0 for an invalid one): its share of
// ImageLocality's counts.
__device__ __forceinline__ uint32_t kt_row_parts(
    const CfgC& cfg, const NodeC& na, const TableC& tb, const CarryC& carry,
    const PodRowD& p, int n, const CacheC& out,
    const OvlD& ovl = OvlD{nullptr, nullptr}) {
  const int64_t* used_row = carry.used + (int64_t)n * na.R;
  const int32_t* port_row = carry.ports + (int64_t)n * carry.P;
  // every filter reads only row n and the pod's row, so all of them are
  // evaluated (no short circuit): their loads overlap instead of waiting
  // on the previous filter's answer
  const bool m = (na.valid[n] != 0)
      & (p.node_name_id == 0 || na.name_id[n] == p.node_name_id)
      & (!na.unschedulable[n] || p.tolerates_unsched)
      & kt_taints_ok(na, n, p, tb.TT)
      & kt_selector_ok(na, n, p, tb.Q, tb.TM, tb.V)
      & kt_ports_ok(port_row, carry.P, p.port_ids, tb.PP);
  int64_t s_fit, s_bal;
  kt_fit_scores(cfg, na, n, used_row, carry.nonzero_used + (int64_t)n * 2, p,
                &s_fit, &s_bal);
  out.static_mask[n] = m;
  out.taint_raw[n] = kt_taint_prefer(na, n, p, tb.TT);
  out.na_raw[n] = kt_pref_score(na, n, p, tb.PT, tb.Q, tb.V);
  out.fit_ok[n] = kt_fit_ovl(na, n, used_row, carry.npods[n], p, ovl);
  out.s_fit[n] = s_fit;
  out.s_bal[n] = s_bal;
  if (!na.valid[n]) return 0;
  int64_t size_c[KT_MAX_IC];
  return kt_image_presence(na, n, p, tb.IC, size_c);
}

// ImageLocality of row n from the cluster-wide counts (num_with[IC],
// total valid rows)
__device__ __forceinline__ int64_t kt_row_s_img(const NodeC& na,
                                                const TableC& tb,
                                                const PodRowD& p, int n,
                                                const int64_t* num_with,
                                                int64_t total) {
  int64_t size_c[KT_MAX_IC];
  kt_image_presence(na, n, p, tb.IC, size_c);
  return kt_image_score(p, tb.IC, size_c, num_with, total);
}

// the weighted total of _eval_pod (:539) for node n from its parts
__device__ __forceinline__ int64_t kt_total(const CfgC& cfg, const CacheC& c,
                                            int n, int64_t tmax,
                                            int64_t namax) {
  return cfg.w_fit * c.s_fit[n] + cfg.w_balanced * c.s_bal[n]
       + cfg.w_taint * kt_normalize(c.taint_raw[n], tmax, true)
       + cfg.w_node_affinity * kt_normalize(c.na_raw[n], namax, false)
       + cfg.w_image * c.s_img[n];
}

// one entry of the closed-form [K, J] matrix (_uniform_matrix :1007): fit
// and post-placement scores of the j1-th same-signature pod on `node`,
// from that node's carry rows; `ovl_used` (null: none) and `ovl_npods`
// are the node's nominated-pod overlay, folded into the fit only
// (_uniform_core :1135-1140)
__device__ __forceinline__ void kt_uniform_entry(
    const CfgC& cfg, const NodeC& na, int node, const int64_t* used,
    const int64_t* nz, int64_t npods, const PodRowD& p, int64_t j1,
    bool* fit_out, int64_t* s_fit, int64_t* s_bal,
    const int64_t* ovl_used = nullptr, int64_t ovl_npods = 0) {
  const int64_t* cap = na.cap + (int64_t)node * na.R;
  bool fit = npods + ovl_npods + j1 <= (int64_t)na.allowed_pods[node];
  for (int r = 0; r < na.R; ++r) {
    const int64_t q = p.req[r];
    const int64_t fit_used = ovl_used ? used[r] + ovl_used[r] : used[r];
    if (q != 0 && !(fit_used + j1 * q <= cap[r])) fit = false;
  }
  int64_t capc[KT_MAX_C], usedc[KT_MAX_C], plain[KT_MAX_C];
  for (int c = 0; c < cfg.C; ++c) {
    const int col = cfg.score_cols[c];
    capc[c] = cap[col];
    plain[c] = used[col] + j1 * p.req[col];
    if (cfg.col_nonzero[c]) {
      const int s = cfg.nonzero_slot[c];
      usedc[c] = nz[s] + j1 * p.nonzero_req[s];
    } else {
      usedc[c] = plain[c];
    }
  }
  *fit_out = fit;
  *s_fit = kt_least_allocated(cfg, capc, usedc);
  *s_bal = p.skip_balanced ? 0 : kt_balanced(cfg.C, capc, plain);
}
