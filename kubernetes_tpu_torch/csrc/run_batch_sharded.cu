// run_batch_sharded: the lean scan over the node-sharded mesh.
//
// Replaces kubernetes_tpu/parallel/sharding.py _run_batch_sharded_jit
// (:158) in lean mode: its _sharded_step (:113-155), one pod placement
// on a node shard with _eval_pod under `axis` (kubernetes_tpu/ops/
// program.py :495), the pmax of the best score and the pmin of the global
// index among the shards holding it, then _apply_assignment (:906) and
// _row_refresh (:458) on the owning shard.
//
// A persistent kernel cannot wait on another shard's kernel, so each pod
// step is a short chain of launches per shard, with the exchange
// (kubernetes_tpu_torch/parallel/sharding.py) between them; the wrapper
// (ops/kernels.py run_batch_sharded_cuda) drives the pods from the host
// without reading anything back:
//   1. shard_eval (one block a shard): the mask, the raw scores and the
//      SigCache fast or slow path into the shard's cache, and the
//      exchanged vector of shard_eval.cuh — image counts on a miss, the
//      feasible maxima of taint_raw and na_raw;
//   2. exchange: the sums and the maxima (lean_exchange);
//   3. shard_select (one block a shard): on a miss ImageLocality from the
//      cluster-wide counts, the totals with the cluster-wide maxima, the
//      shard's first max, packed into ONE int64 key
//      ((score + 1) << 32) | (INT32_MAX - global index), so the JAX
//      program's pmax of the score then pmin of the index is one max;
//   4. exchange: the max of the keys (pmax);
//   5. shard_apply (one thread a shard): the placement on the owning
//      shard and the refresh of the placed row; every shard stores the
//      pod's signature; shard 0 writes the assignment.
// `sig` is replicated, so every shard takes the same branch.
//
// What bounds it on an H100: as run_batch.cu, the dependent chain of B
// steps; here each step is 3·D launches plus the exchange's small
// copies and reductions, so launch latency, not bytes or operations.

#include "shard_eval.cuh"

struct ShardStepC {       // one shard's arguments, fixed for a span
  NodeC na;
  TableC tb;
  CarryC c;               // the output carry, written in place
  CfgC cfg;
  const uint8_t* valid;   // [B]
  const int32_t* sig;     // [B]
  const int32_t* tidx;    // [B]
  int32_t offset;         // global index of the shard's row 0
  int64_t* loc;           // [KT_SHARD_LOC] the shard's exchanged parts
  int64_t* key;           // [1] the shard's packed first max
  int32_t* out;           // [B] assignments (shard 0), else nullptr
};

namespace {

constexpr int BLOCK = 512;

__device__ __forceinline__ bool row_ok(const ShardStepC& a, int u) {
  return u >= 0 && u < a.tb.U;
}

__global__ void __launch_bounds__(BLOCK)
shard_eval_kernel(ShardStepC a, int i) {
  __shared__ BlockScratch<BLOCK> sh;
  const int u = a.tidx[i];
  if (!row_ok(a, u)) {
    // a row outside the table: shard_apply reports it
    if (threadIdx.x == 0)
      for (int k = 0; k < KT_SHARD_LOC; ++k) a.loc[k] = 0;
    return;
  }
  const PodRowD p = pod_row(a.tb, u);
  const bool use_fast = a.sig[i] != 0 && a.sig[i] == *a.c.cache.sig;
  shard_parts<BLOCK>(a.cfg, a.na, a.tb, a.c, p, use_fast, a.c.cache,
                     a.c.cache, sh, a.loc);
}

__global__ void __launch_bounds__(BLOCK)
shard_select_kernel(ShardStepC a, int i, const int64_t* glob) {
  __shared__ BlockScratch<BLOCK> sh;
  const int u = a.tidx[i];
  if (!row_ok(a, u)) {
    if (threadIdx.x == 0) *a.key = 0;
    return;
  }
  const PodRowD p = pod_row(a.tb, u);
  const bool use_fast = a.sig[i] != 0 && a.sig[i] == *a.c.cache.sig;
  const CacheC& cc = a.c.cache;
  const int64_t tmax = glob[KT_MAX_IC + 1], namax = glob[KT_MAX_IC + 2];
  int64_t bv = KT_I64_MIN;
  int32_t bi = 0x7fffffff;
  for (int n = threadIdx.x; n < a.na.N; n += BLOCK) {
    if (!use_fast) shard_s_img(a.na, a.tb, p, n, glob, cc);
    const bool feas = cc.static_mask[n] && cc.fit_ok[n];
    const int64_t val = feas ? kt_total(a.cfg, cc, n, tmax, namax) : -1;
    argmax_merge(bv, bi, val, n);
  }
  block_argmax<BLOCK>(bv, bi, sh);
  if (threadIdx.x == 0)
    *a.key = ((bv + 1) << 32) | (int64_t)(0x7fffffff - (a.offset + bi));
}

// _apply_assignment + _row_refresh of the lean scan at local row `best`
__device__ void place_lean(const ShardStepC& a, const PodRowD& p, int best) {
  const NodeC& na = a.na;
  const CarryC& c = a.c;
  int64_t* used_row = c.used + (int64_t)best * na.R;
  for (int r = 0; r < na.R; ++r) used_row[r] += p.req[r];
  int64_t* nz_row = c.nonzero_used + (int64_t)best * 2;
  nz_row[0] += p.nonzero_req[0];
  nz_row[1] += p.nonzero_req[1];
  c.npods[best] += 1;
  bool any_port = false;
  for (int q = 0; q < a.tb.PP; ++q) any_port = any_port || p.port_ids[q];
  if (any_port) {
    int32_t* row = c.ports + (int64_t)best * c.P;
    int rank = 0;
    for (int slot = 0; slot < c.P; ++slot) {
      if (row[slot] != 0) continue;
      row[slot] = rank < a.tb.PP ? p.port_ids[rank] : 0;
      ++rank;
    }
  }
  int64_t s_fit, s_bal;
  kt_fit_scores(a.cfg, na, best, used_row, nz_row, p, &s_fit, &s_bal);
  c.cache.fit_ok[best] = kt_fit(na, best, used_row, c.npods[best], p);
  c.cache.s_fit[best] = s_fit;
  c.cache.s_bal[best] = s_bal;
}

__global__ void shard_apply_kernel(ShardStepC a, int i, const int64_t* gkey) {
  const int u = a.tidx[i];
  if (!row_ok(a, u)) {
    // the commit rejects any assignment below -1
    if (a.out) a.out[i] = -2;
    return;
  }
  const int64_t k = *gkey;
  const int64_t gscore = (k >> 32) - 1;
  const int32_t gbest = 0x7fffffff - (int32_t)(k & 0xffffffffLL);
  const bool assigned = gscore >= 0 && a.valid[i];
  const int lidx = gbest - a.offset;
  if (assigned && lidx >= 0 && lidx < a.na.N)
    place_lean(a, pod_row(a.tb, u), lidx);
  *a.c.cache.sig = a.sig[i];
  if (a.out) a.out[i] = assigned ? gbest : -1;
}

}  // namespace

extern "C" int ktpu_shard_eval(const ShardStepC* a, int i, void* stream) {
  shard_eval_kernel<<<1, BLOCK, 0, (cudaStream_t)stream>>>(*a, i);
  return (int)cudaGetLastError();
}

extern "C" int ktpu_shard_select(const ShardStepC* a, int i,
                                 const int64_t* glob, void* stream) {
  shard_select_kernel<<<1, BLOCK, 0, (cudaStream_t)stream>>>(*a, i, glob);
  return (int)cudaGetLastError();
}

extern "C" int ktpu_shard_apply(const ShardStepC* a, int i,
                                const int64_t* gkey, void* stream) {
  shard_apply_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(*a, i, gkey);
  return (int)cudaGetLastError();
}
