// The per-row and per-candidate steps of the closed-form run
// (kubernetes_tpu/ops/program.py _uniform_core :1076, _uniform_matrix
// :1007), shared by run_uniform.cu (one device) and
// run_uniform_sharded.cu (a node shard), so both compute the same bits.
//
// The cluster-wide values a row needs arrive as `glob`, shard_eval.cuh's
// layout: ImageLocality's image counts [0, KT_MAX_IC), the valid rows at
// KT_MAX_IC, the feasible TaintToleration / NodeAffinity maxima at
// KT_MAX_IC + 1 and + 2. Keys fold the node index in, so they are unique:
// a row key is (masked + 1) · N + (N − 1 − n) (ties to the lowest row), a
// matrix key masked · M − (node · J + j) with M = n_global · J (score
// desc, node asc, j asc); masked is −1 where infeasible.
#pragma once

#include "shard_eval.cuh"

// the carry-independent score of row n: the normalized TaintToleration
// and NodeAffinity terms and ImageLocality
__device__ __forceinline__ int64_t kt_static_add(const CfgC& cfg,
                                                 const CacheC& out, int n,
                                                 int64_t tmax,
                                                 int64_t namax) {
  return cfg.w_taint * kt_normalize(out.taint_raw[n], tmax, true)
       + cfg.w_node_affinity * kt_normalize(out.na_raw[n], namax, false)
       + cfg.w_image * out.s_img[n];
}

// an entry's masked score from its matrix key (the floor division by M)
__device__ __forceinline__ int64_t kt_key_score(int64_t key, int64_t M) {
  return floordiv(key + M - 1, M);
}

// row n of the SigCache `in` into `out`: every load before any store, so
// the loads are in flight together (a store could alias a later load)
__device__ __forceinline__ void kt_cache_copy(const CacheC& in,
                                              const CacheC& out, int n) {
  const uint8_t m = in.static_mask[n], f = in.fit_ok[n];
  const int64_t tr = in.taint_raw[n], nr = in.na_raw[n], im = in.s_img[n];
  const int64_t sf = in.s_fit[n], sb = in.s_bal[n];
  out.static_mask[n] = m;
  out.taint_raw[n] = tr;
  out.na_raw[n] = nr;
  out.s_img[n] = im;
  out.fit_ok[n] = f;
  out.s_fit[n] = sf;
  out.s_bal[n] = sb;
}

// the carry's row n (used, nonzero_used, npods) into the output carry,
// four loads in flight before their stores
__device__ __forceinline__ void kt_carry_row_copy(const CarryC& cin,
                                                  const CarryC& cout, int n,
                                                  int R) {
  const int64_t* src = cin.used + (int64_t)n * R;
  int64_t* dst = cout.used + (int64_t)n * R;
  for (int r0 = 0; r0 < R; r0 += 4) {
    int64_t v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (r0 + q < R) v[q] = src[r0 + q];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (r0 + q < R) dst[r0 + q] = v[q];
  }
  const int64_t z0 = cin.nonzero_used[(int64_t)n * 2];
  const int64_t z1 = cin.nonzero_used[(int64_t)n * 2 + 1];
  const int32_t np = cin.npods[n];
  cout.nonzero_used[(int64_t)n * 2] = z0;
  cout.nonzero_used[(int64_t)n * 2 + 1] = z1;
  cout.npods[n] = np;
}

// row n's SigCache step: on a miss every part but s_img into cout.cache
// (the overlay `ovl`, null pointers for none, in the fit), the row's
// image-presence bits into cnt[IC] and its validity into nvalid; on a hit
// the cached parts copied (the counts stay zero: s_img is cached). Then
// the row's share of the feasible maxima tm / nm.
__device__ __forceinline__ void kt_closed_row(
    const CfgC& cfg, const NodeC& na, const TableC& tb, const CarryC& cin,
    const CarryC& cout, const PodRowD& p, int n, bool use_fast,
    const OvlD& ovl, int64_t* cnt, int64_t& nvalid, int64_t& tm,
    int64_t& nm) {
  const CacheC& out = cout.cache;
  if (!use_fast) {
    const uint32_t bits = kt_row_parts(cfg, na, tb, cin, p, n, out, ovl);
    nvalid += na.valid[n] != 0;
    for (int c = 0; c < tb.IC; ++c) cnt[c] += (bits >> c) & 1u;
  } else {
    kt_cache_copy(cin.cache, out, n);
  }
  if (out.static_mask[n] && out.fit_ok[n]) {
    tm = out.taint_raw[n] > tm ? out.taint_raw[n] : tm;
    nm = out.na_raw[n] > nm ? out.na_raw[n] : nm;
  }
}

// the row key of row n of N (its SigCache parts complete)
__device__ __forceinline__ int64_t kt_row_key(const CfgC& cfg,
                                              const CacheC& out, int n,
                                              int N, const int64_t* glob) {
  const bool feas = out.static_mask[n] && out.fit_ok[n];
  const int64_t masked =
      feas ? cfg.w_fit * out.s_fit[n] + cfg.w_balanced * out.s_bal[n]
                 + kt_static_add(cfg, out, n, glob[KT_MAX_IC + 1],
                                 glob[KT_MAX_IC + 2])
           : -1;
  return (masked + 1) * N + (N - 1 - n);
}

// matrix entry (k, j) = e at candidate row `node` (global id `gnode`):
// its fit and post-placement scores into fit_kj / sfit_kj / sbal_kj[e];
// returns its key. The overlay `ovl` folds into the fit only
// (_uniform_core :1135-1140).
__device__ __forceinline__ int64_t kt_matrix_entry(
    const CfgC& cfg, const NodeC& na, const CarryC& cin, const CacheC& out,
    const PodRowD& p, const int64_t* glob, const OvlD& ovl, int node,
    int64_t gnode, int j, int J, int64_t M, int64_t e, uint8_t* fit_kj,
    int64_t* sfit_kj, int64_t* sbal_kj) {
  const int64_t* used = cin.used + (int64_t)node * na.R;
  const int64_t* nz = cin.nonzero_used + (int64_t)node * 2;
  const int64_t* ovl_row =
      ovl.used ? ovl.used + (int64_t)node * na.R : nullptr;
  const int64_t ovl_np = ovl.used ? ovl.npods[node] : 0;
  bool fit;
  int64_t s_fit, s_bal;
  kt_uniform_entry(cfg, na, node, used, nz, cin.npods[node], p, j + 1, &fit,
                   &s_fit, &s_bal, ovl_row, ovl_np);
  const int64_t masked = (out.static_mask[node] && fit)
      ? cfg.w_fit * s_fit + cfg.w_balanced * s_bal
            + kt_static_add(cfg, out, node, glob[KT_MAX_IC + 1],
                            glob[KT_MAX_IC + 2])
      : -1;
  fit_kj[e] = fit;
  sfit_kj[e] = s_fit;
  sbal_kj[e] = s_bal;
  return masked * M - (gnode * J + j);
}

// the SigCache refreshed at a candidate row `node` that took `cnt` of
// the selected entries, from its entry min(cnt, J − 1) (`row` = k · J,
// its first entry). Entry j = cnt IS the next pod's evaluation; an
// untouched candidate rewrites its count-0 entry, which equals its parts.
__device__ __forceinline__ void kt_cache_refresh(
    const CacheC& c, int node, int64_t cnt, int J, int64_t row,
    const uint8_t* fit_kj, const int64_t* sfit_kj, const int64_t* sbal_kj) {
  const int64_t jj = row + (cnt < J - 1 ? cnt : J - 1);
  const uint8_t f = fit_kj[jj];
  const int64_t sf = sfit_kj[jj], sb = sbal_kj[jj];
  c.fit_ok[node] = f;
  c.s_fit[node] = sf;
  c.s_bal[node] = sb;
}

// the run applied at one candidate row `node`: the carry update, then
// the cache refresh
__device__ __forceinline__ void kt_closed_apply(
    const CarryC& c, const PodRowD& p, int R, int node, int64_t cnt, int J,
    int64_t row, const uint8_t* fit_kj, const int64_t* sfit_kj,
    const int64_t* sbal_kj) {
  if (cnt > 0) {
    int64_t* used = c.used + (int64_t)node * R;
    for (int r = 0; r < R; ++r) used[r] += cnt * p.req[r];
    c.nonzero_used[(int64_t)node * 2] += cnt * p.nonzero_req[0];
    c.nonzero_used[(int64_t)node * 2 + 1] += cnt * p.nonzero_req[1];
    c.npods[node] += (int32_t)cnt;
  }
  kt_cache_refresh(c.cache, node, cnt, J, row, fit_kj, sfit_kj, sbal_kj);
}
