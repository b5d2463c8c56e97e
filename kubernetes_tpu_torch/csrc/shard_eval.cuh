// The per-shard halves of the lean step on the node-sharded mesh, shared by
// run_batch_sharded.cu and run_uniform_sharded.cu. A shard holds node rows
// [offset, offset + N) of the cluster; the cluster-wide quantities of a
// step — ImageLocality's image counts and the DefaultNormalize maxima
// (kubernetes_tpu/ops/program.py image_locality_score :244-248 and
// default_normalize :293-301 under `axis`) — cross the shards between
// two launches, through the exchange in kubernetes_tpu_torch/parallel/
// sharding.py (lean_exchange).
//
// The exchanged vector, int64 [KT_SHARD_LOC]:
//   [0, KT_MAX_IC)  nodes of the shard holding each container image
//   KT_MAX_IC       valid nodes of the shard        (both summed)
//   KT_MAX_IC + 1   max taint_raw over the feasible rows
//   KT_MAX_IC + 2   max na_raw over the feasible rows (both maxed)
// On the SigCache fast path the counts are zero: s_img is cached.
#pragma once

#include "lean_eval.cuh"

#define KT_SHARD_LOC (KT_MAX_IC + 3)

// part 1, by one block over the shard's N rows: on a cache miss every
// SigCache part but s_img into `out` (s_img needs the cluster-wide
// counts), and the shard's image counts; on a hit the cached parts
// (copied when `out` is another cache). Then the shard's feasible maxima.
// Writes loc[KT_SHARD_LOC]. Ends with a __syncthreads.
template <int BLOCK>
__device__ void shard_parts(const CfgC& cfg, const NodeC& na,
                            const TableC& tb, const CarryC& carry,
                            const PodRowD& p, bool use_fast,
                            const CacheC& in, const CacheC& out,
                            BlockScratch<BLOCK>& sh, int64_t* loc) {
  const int N = na.N;
  const int IC = tb.IC;
  if (!use_fast) {
    int64_t cnt[KT_MAX_IC];
    for (int c = 0; c < IC; ++c) cnt[c] = 0;
    int64_t nvalid = 0;
    for (int n = threadIdx.x; n < N; n += BLOCK) {
      if (!na.valid[n]) continue;
      ++nvalid;
      int64_t size_c[KT_MAX_IC];
      const uint32_t bits = kt_image_presence(na, n, p, IC, size_c);
      for (int c = 0; c < IC; ++c) cnt[c] += (bits >> c) & 1u;
    }
    for (int c = 0; c < IC; ++c) {
      const int64_t s = block_sum<BLOCK>(cnt[c], sh);
      if (threadIdx.x == 0) loc[c] = s;
    }
    const int64_t total = block_sum<BLOCK>(nvalid, sh);
    if (threadIdx.x == 0) {
      for (int c = IC; c < KT_MAX_IC; ++c) loc[c] = 0;
      loc[KT_MAX_IC] = total;
    }
    for (int n = threadIdx.x; n < N; n += BLOCK) {
      const int64_t* used_row = carry.used + (int64_t)n * na.R;
      const int32_t* port_row = carry.ports + (int64_t)n * carry.P;
      bool m = na.valid[n] != 0;
      m = m && (p.node_name_id == 0 || na.name_id[n] == p.node_name_id);
      m = m && (!na.unschedulable[n] || p.tolerates_unsched);
      m = m && kt_taints_ok(na, n, p, tb.TT);
      m = m && kt_selector_ok(na, n, p, tb.Q, tb.TM, tb.V);
      m = m && kt_ports_ok(port_row, carry.P, p.port_ids, tb.PP);
      int64_t s_fit, s_bal;
      kt_fit_scores(cfg, na, n, used_row,
                    carry.nonzero_used + (int64_t)n * 2, p, &s_fit, &s_bal);
      out.static_mask[n] = m;
      out.taint_raw[n] = kt_taint_prefer(na, n, p, tb.TT);
      out.na_raw[n] = kt_pref_score(na, n, p, tb.PT, tb.Q, tb.V);
      out.fit_ok[n] = kt_fit(na, n, used_row, carry.npods[n], p);
      out.s_fit[n] = s_fit;
      out.s_bal[n] = s_bal;
    }
  } else {
    if (threadIdx.x == 0)
      for (int c = 0; c <= KT_MAX_IC; ++c) loc[c] = 0;
    if (out.static_mask != in.static_mask) {
      for (int n = threadIdx.x; n < N; n += BLOCK) {
        out.static_mask[n] = in.static_mask[n];
        out.taint_raw[n] = in.taint_raw[n];
        out.na_raw[n] = in.na_raw[n];
        out.s_img[n] = in.s_img[n];
        out.fit_ok[n] = in.fit_ok[n];
        out.s_fit[n] = in.s_fit[n];
        out.s_bal[n] = in.s_bal[n];
      }
    }
  }
  // each thread re-reads only the rows it wrote above
  int64_t tm = 0, nm = 0;
  for (int n = threadIdx.x; n < N; n += BLOCK) {
    if (out.static_mask[n] && out.fit_ok[n]) {
      tm = out.taint_raw[n] > tm ? out.taint_raw[n] : tm;
      nm = out.na_raw[n] > nm ? out.na_raw[n] : nm;
    }
  }
  const int64_t tmax = block_max<BLOCK>(tm, sh);
  const int64_t namax = block_max<BLOCK>(nm, sh);
  if (threadIdx.x == 0) {
    loc[KT_MAX_IC + 1] = tmax;
    loc[KT_MAX_IC + 2] = namax;
  }
}

// part 2, for row n on a cache miss: ImageLocality from the cluster-wide
// counts `glob` (the exchanged vector)
__device__ __forceinline__ void shard_s_img(const NodeC& na, const TableC& tb,
                                            const PodRowD& p, int n,
                                            const int64_t* glob,
                                            const CacheC& out) {
  int64_t size_c[KT_MAX_IC];
  kt_image_presence(na, n, p, tb.IC, size_c);
  out.s_img[n] = kt_image_score(p, tb.IC, size_c, glob, glob[KT_MAX_IC]);
}
