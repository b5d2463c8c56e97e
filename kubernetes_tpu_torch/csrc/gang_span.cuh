// The gang scan's span — kubernetes_tpu/ops/gang.py _run_gang_scan_impl
// (:65-188) and its SPMD twin kubernetes_tpu/parallel/sharding.py
// _gang_scan_local (:890-1016) — written once for a team of CTAs that
// splits the node axis, shared by run_gang.cu (one device: a thread-block
// cluster, plan_span.cuh's ClusterTeam, the one-shard case) and
// run_gang_sharded.cu's ktpu_gang_span_grid (a mesh's shards on one card:
// one cooperative grid, GridTeam), as batch_span.cuh is for the scan. The
// node axis may be cut into D equal shards, each with its own arrays
// (GangNodesC); every CTA owns a contiguous range of one shard's rows and
// is the only writer of them. In order:
//   1. the hoist, each CTA over its own rows: the entry carry into the
//      fresh output rows, and the S slots' fit surfaces at it (fit_mask,
//      LeastAllocated / MostAllocated and Balanced, :93-101). Every later
//      read of a row is by the CTA that owns it, so a block barrier
//      suffices: the first reduction's team barrier follows;
//   2. per member (a member that is not valid only writes its -1): one
//      pass over the CTA's rows takes the feasible maxima of taint_raw,
//      na_raw and (w_contig) the contiguity counts, and the packed key
//      ((score + 1) << 32) | (INT32_MAX − global row) under the LAST
//      member's maxima; ONE team reduction carries the four. When the
//      maxima equal the last member's, that key is the key; otherwise a
//      second pass and reduction take it. The largest key is the lowest
//      global row among the maxima, so a tie across a CTA or shard
//      boundary goes to the lowest global row (the JAX program's first
//      max, its pmax then pmin over the shards);
//   3. every CTA decodes the same first max. The contiguity counts are
//      kept a row at a time: each CTA holds, in shared memory, the count
//      of each of its rows' domains and bumps the rows whose domain is the
//      chosen node's, read from the owning shard's domain ids on the same
//      card — from the key it decoded itself, so no count is read by one
//      CTA while another writes it, and no exchange is needed;
//   4. on the CTA that owns the chosen row: the placement (one warp),
//      then the S slots' refresh of that row, its three parts (fit,
//      LeastAllocated, Balanced) side by side in three warps (one warp
//      running them in turn set a scan step's pace, PERF.md §6);
//   5. the verdict (:171-188): accept = placed >= needed (every CTA counts
//      the placements it decoded). A rejected gang's CTAs restore their
//      own output rows from the input; the first CTA of each shard writes
//      its signature (0 accepted, the input's rejected); the lead CTA
//      writes the packed tail [accept; placed; 1; 1] after the raw
//      assignments.
// The SigCache's other fields are shared with the input carry (the
// kernels write only a fresh signature scalar); the wrappers hand the
// kernels fresh buffers for every carry field they write, so the input
// carry is never written.
#pragma once

#include "plan_span.cuh"

// what every shard of the gang shares, mirrored field for field by ctypes
// (ops/kernels.py GangSpanC)
struct GangSpanC {
  TableC tb;
  CfgC cfg;
  const uint8_t* valid;     // [B]
  const int32_t* tidx;      // [B]
  const int32_t* widx;      // [B] slot of each member
  const int32_t* wt;        // [S] the slots' table rows
  int32_t S, B, needed, w_contig, n_local, D;
  int64_t* part;            // [2, blocks, KT_RED_K] a grid team's slots
                            // (nullptr for a cluster)
  int32_t* packed;          // [B + 4]
};

// one node shard's arrays (ops/kernels.py GangNodesC); on one device the
// shard is the whole axis
struct GangNodesC {
  NodeC na;
  const int64_t* used_in;   // the input carry (read)
  const int64_t* nz_in;
  const int32_t* npods_in;
  const int32_t* sig_in;
  int64_t* used;            // the output carry rows (written)
  int64_t* nonzero_used;
  int32_t* npods;
  int32_t* sig_out;
  const uint8_t* m0;        // the shard's stacked surfaces, [S, N] each
  const int64_t* taint_raw;
  const int64_t* na_raw;
  const int64_t* s_img;
  const int32_t* dom;       // [N] the shard's slice of the global domain ids
  uint8_t* fit_ok;          // [S, N] the slots' fit surfaces
  int64_t* s_fit;           // [S, N]
  int64_t* s_bal;           // [S, N]
  int32_t offset;           // global index of the shard's row 0
};

// a CTA's dynamic shared memory for `span` rows: the contiguity count of
// each row's domain
__host__ __device__ inline int gang_dyn_bytes(int span) {
  return (4 * span + 15) / 16 * 16;
}

// a member's total at element `at` of its slot's surfaces (a feasible
// row, its domain count dc) under the maxima m[3]
__device__ __forceinline__ int64_t gang_total(const GangSpanC& cm,
                                              const GangNodesC& a,
                                              int64_t at, int64_t dc,
                                              const int64_t* m) {
  const CfgC& cfg = cm.cfg;
  int64_t val = cfg.w_fit * a.s_fit[at] + cfg.w_balanced * a.s_bal[at]
      + cfg.w_taint * kt_normalize(a.taint_raw[at], m[0], true)
      + cfg.w_node_affinity * kt_normalize(a.na_raw[at], m[1], false)
      + cfg.w_image * a.s_img[at];
  if (cm.w_contig) val += cm.w_contig * kt_normalize(dc, m[2], false);
  return val;
}

// the whole gang on the team's rows [lo, hi) of shard d of `all`.
// `shard_lead`: this CTA writes the shard's signature; `lead`: this CTA
// writes the raw assignments and the packed tail.
template <int BLOCK, class Team>
__device__ void gang_span(const GangSpanC& cm, const GangNodesC* all, int d,
                          int lo, int hi, bool shard_lead, bool lead,
                          Team& tm, PlanShared<BLOCK>& sh) {
  const GangNodesC& a = all[d];
  const int nl = cm.n_local;
  const int t = threadIdx.x, wp = t >> 5, lane = t & 31;
  const int R = a.na.R, S = cm.S, off = a.offset;
  const int64_t NN = nl;
  int32_t* cnt = (int32_t*)kt_plan_dyn;   // [span] each row's domain count

  // ---- 1. the hoist (:93-101) over the CTA's rows
  const int rows = hi - lo;
  for (int64_t e = t; e < (int64_t)rows * R; e += BLOCK)
    a.used[(int64_t)lo * R + e] = a.used_in[(int64_t)lo * R + e];
  for (int64_t e = t; e < (int64_t)rows * 2; e += BLOCK)
    a.nonzero_used[(int64_t)lo * 2 + e] = a.nz_in[(int64_t)lo * 2 + e];
  for (int n = lo + t; n < hi; n += BLOCK) {
    a.npods[n] = a.npods_in[n];
    cnt[n - lo] = 0;
  }
  if (rows > 0)
    for (int64_t e = t; e < (int64_t)S * rows; e += BLOCK) {
      const int s = (int)(e / rows), n = lo + (int)(e % rows);
      const PodRowD p = pod_row(cm.tb, cm.wt[s]);
      const int64_t* used_row = a.used_in + (int64_t)n * R;
      int64_t s_fit, s_bal;
      kt_fit_scores(cm.cfg, a.na, n, used_row, a.nz_in + (int64_t)n * 2, p,
                    &s_fit, &s_bal);
      a.fit_ok[s * NN + n] = kt_fit(a.na, n, used_row, a.npods_in[n], p);
      a.s_fit[s * NN + n] = s_fit;
      a.s_bal[s * NN + n] = s_bal;
    }

  // ---- 2.-4. the member scan (:106-164)
  int64_t prev[3] = {0, 0, 0};   // the last member's maxima
  int32_t placed = 0;
  for (int k = 0; k < cm.B; ++k) {
    if (!cm.valid[k]) {
      if (lead && t == 0) cm.packed[k] = -1;
      continue;
    }
    const int s = cm.widx[k];
    const uint8_t* m0 = a.m0 + s * NN;
    const uint8_t* fit = a.fit_ok + s * NN;
    // the last member's row writes (other threads of this CTA) before
    // any read of this one
    __syncthreads();
    int64_t r[4] = {0, 0, 0, KT_I64_MIN};
    for (int n = lo + t; n < hi; n += BLOCK) {
      if (!(m0[n] && fit[n])) {
        const int64_t kk = (int64_t)(0x7fffffff - (off + n));
        r[3] = kk > r[3] ? kk : r[3];
        continue;
      }
      const int64_t at = s * NN + n, dc = cnt[n - lo];
      r[0] = a.taint_raw[at] > r[0] ? a.taint_raw[at] : r[0];
      r[1] = a.na_raw[at] > r[1] ? a.na_raw[at] : r[1];
      r[2] = dc > r[2] ? dc : r[2];
      // (under maxima that do not hold, a score may fall below -1: the
      // shift is unsigned, and that key is thrown away)
      const int64_t val = gang_total(cm, a, at, dc, prev);
      const int64_t kk = (int64_t)((uint64_t)(val + 1) << 32)
                         | (int64_t)(0x7fffffff - (off + n));
      r[3] = kk > r[3] ? kk : r[3];
    }
    tm.reduce(r, 4, 0u, sh);
    int64_t key = r[3];
    if (r[0] != prev[0] || r[1] != prev[1] || r[2] != prev[2]) {
      // the key under this member's maxima
      key = KT_I64_MIN;
      for (int n = lo + t; n < hi; n += BLOCK) {
        const int64_t at = s * NN + n;
        const int64_t val = (m0[n] && fit[n])
            ? gang_total(cm, a, at, cnt[n - lo], r) : -1;
        const int64_t kk = ((val + 1) << 32)
                           | (int64_t)(0x7fffffff - (off + n));
        key = kk > key ? kk : key;
      }
      int64_t kk[1] = {key};
      tm.reduce(kk, 1, 0u, sh);
      key = kk[0];
      prev[0] = r[0];
      prev[1] = r[1];
      prev[2] = r[2];
    }
    int64_t score;
    int32_t best;
    kt_plan_unkey(key, &score, &best);
    const bool assigned = score >= 0;
    if (lead && t == 0) cm.packed[k] = assigned ? best : -1;
    if (!assigned) continue;
    ++placed;
    const int d_own = best / nl, lb = best - d_own * nl;
    if (cm.w_contig) {
      // the contiguity counts of the CTA's rows in the chosen domain
      const int32_t x = all[d_own].dom[lb];
      for (int n = lo + t; n < hi; n += BLOCK)
        if (a.dom[n] == x) ++cnt[n - lo];
    }
    if (d_own != d || lb < lo || lb >= hi) continue;
    // the placement (:126-128) on the owning CTA
    if (wp == 0) {
      const PodRowD p = pod_row(cm.tb, cm.tidx[k]);
      for (int rr = lane; rr < R + 3; rr += 32) {
        if (rr < R)
          a.used[(int64_t)lb * R + rr] += p.req[rr];
        else if (rr < R + 2)
          a.nonzero_used[(int64_t)lb * 2 + rr - R] += p.nonzero_req[rr - R];
        else
          a.npods[lb] += 1;
      }
    }
    __syncthreads();
    // the touched row, refreshed for every slot (duplicates included,
    // :130-158): the last three warps a part each, a lane a slot
    if (wp >= BLOCK / 32 - 3)
      for (int s2 = lane; s2 < S; s2 += 32) {
        const int64_t at = s2 * NN + lb;
        const int64_t* used_row = a.used + (int64_t)lb * R;
        const PodRowD ps = pod_row(cm.tb, cm.wt[s2]);
        if (wp == BLOCK / 32 - 1)
          a.fit_ok[at] = kt_fit(a.na, lb, used_row, a.npods[lb], ps);
        else
          kt_refresh_score(cm.cfg, a.na, lb, used_row,
                           a.nonzero_used + (int64_t)lb * 2, ps,
                           BLOCK / 32 - 1 - wp, a.s_fit + at, a.s_bal + at);
      }
  }

  // ---- 5. the verdict (:171-188)
  const bool accept = placed >= cm.needed;
  __syncthreads();   // every placement and refresh of this CTA done
  if (!accept) {
    for (int64_t e = t; e < (int64_t)rows * R; e += BLOCK)
      a.used[(int64_t)lo * R + e] = a.used_in[(int64_t)lo * R + e];
    for (int64_t e = t; e < (int64_t)rows * 2; e += BLOCK)
      a.nonzero_used[(int64_t)lo * 2 + e] = a.nz_in[(int64_t)lo * 2 + e];
    for (int n = lo + t; n < hi; n += BLOCK) a.npods[n] = a.npods_in[n];
  }
  if (shard_lead && t == 0) *a.sig_out = accept ? 0 : *a.sig_in;
  if (lead && t == 0) {
    cm.packed[cm.B] = accept;
    cm.packed[cm.B + 1] = placed;
    cm.packed[cm.B + 2] = 1;
    cm.packed[cm.B + 3] = 1;
  }
  tm.finish();   // no CTA leaves while another can read its slots
}
