// wave_statics: the carry-independent per-signature surfaces of the wave
// program.
//
// Replaces kubernetes_tpu/ops/program.py wave_statics (:1676; the jit
// _wave_statics_jit :1635): for each table row wt[s] and node n, the
// static filter mask (valid, node name, unschedulable, taints, selector;
// ports are vacuous for sig != 0 rows), the untolerated PreferNoSchedule
// count, the preferred node-affinity weight and the ImageLocality score →
// [S, N] arrays. `feats` = (taints, selectors, images) skips a family the
// rows cannot exercise, exactly like the JAX program's static flags (its
// outputs are then the identity: mask bits set, counts zero).
//
// What bounds it on an H100: the work per (s, n) is the lean filter and
// score loops over the node's occupied taint, label and image slots —
// integer operations on a few hundred bytes of node row; S·N is at most
// a few ten thousand, so one call is launch-latency bound.
//
// Design: two launches, the row ids passed by value in the launch
// arguments (no host-to-device copy before the kernel). image_counts (one block per signature) reduces
// the cluster-wide ImageLocality spread counts (nodes holding each of the
// row's images, and the valid-node total); statics (one thread per
// (s, n)) evaluates the lean device functions of lean_eval.cuh — the same
// code run_batch and run_uniform run — and writes the four surfaces.
//
// On the node-sharded mesh (kubernetes_tpu/ops/program.py :1635 under
// XLA's partitioning) the two launches run apart, per shard, with the psum
// of the image counts between them (ktpu_wave_image_counts,
// ktpu_wave_statics_counted): ImageLocality's spread is cluster-wide.

#include "lean_eval.cuh"

#define KT_WS_MAX_S 64

// the signature table rows, by value
struct WaveRows {
  int32_t u[KT_WS_MAX_S];
};

namespace {

constexpr int CBLOCK = 512;
constexpr int SBLOCK = 256;

// img_cnt[s * (IC + 1) + c]: valid nodes holding image c of row wt[s];
// img_cnt[s * (IC + 1) + IC]: valid nodes
__global__ void __launch_bounds__(CBLOCK)
image_counts_kernel(NodeC na, TableC tb, WaveRows wt,
                    int64_t* __restrict__ img_cnt) {
  __shared__ BlockScratch<CBLOCK> sh;
  const int s = blockIdx.x;
  const PodRowD p = pod_row(tb, wt.u[s]);
  const int IC = tb.IC;
  int64_t cnt[KT_MAX_IC];
  for (int c = 0; c < IC; ++c) cnt[c] = 0;
  int64_t nvalid = 0;
  for (int n = threadIdx.x; n < na.N; n += CBLOCK) {
    if (!na.valid[n]) continue;
    ++nvalid;
    int64_t size_c[KT_MAX_IC];
    const uint32_t bits = kt_image_presence(na, n, p, IC, size_c);
    for (int c = 0; c < IC; ++c) cnt[c] += (bits >> c) & 1u;
  }
  int64_t* o = img_cnt + (int64_t)s * (IC + 1);
  for (int c = 0; c < IC; ++c) {
    const int64_t v = block_sum<CBLOCK>(cnt[c], sh);
    if (threadIdx.x == 0) o[c] = v;
  }
  const int64_t total = block_sum<CBLOCK>(nvalid, sh);
  if (threadIdx.x == 0) o[IC] = total;
}

__global__ void __launch_bounds__(SBLOCK)
statics_kernel(NodeC na, TableC tb, WaveRows wt, int S,
               int has_taints, int has_sel, int has_img,
               const int64_t* __restrict__ img_cnt,
               uint8_t* __restrict__ mask, int64_t* __restrict__ taint_raw,
               int64_t* __restrict__ na_raw, int64_t* __restrict__ s_img) {
  const int64_t e = (int64_t)blockIdx.x * SBLOCK + threadIdx.x;
  if (e >= (int64_t)S * na.N) return;
  const int s = (int)(e / na.N), n = (int)(e % na.N);
  const PodRowD p = pod_row(tb, wt.u[s]);
  bool m = na.valid[n] != 0;
  m = m && (p.node_name_id == 0 || na.name_id[n] == p.node_name_id);
  m = m && (!na.unschedulable[n] || p.tolerates_unsched);
  int64_t traw = 0, nraw = 0, simg = 0;
  if (has_taints) {
    m = m && kt_taints_ok(na, n, p, tb.TT);
    traw = kt_taint_prefer(na, n, p, tb.TT);
  }
  if (has_sel) {
    m = m && kt_selector_ok(na, n, p, tb.Q, tb.TM, tb.V);
    nraw = kt_pref_score(na, n, p, tb.PT, tb.Q, tb.V);
  }
  if (has_img) {
    const int64_t* cnt = img_cnt + (int64_t)s * (tb.IC + 1);
    int64_t size_c[KT_MAX_IC];
    kt_image_presence(na, n, p, tb.IC, size_c);
    simg = kt_image_score(p, tb.IC, size_c, cnt, cnt[tb.IC]);
  }
  mask[e] = m;
  taint_raw[e] = traw;
  na_raw[e] = nraw;
  s_img[e] = simg;
}

}  // namespace

extern "C" int ktpu_wave_statics(const NodeC* na, const TableC* tb,
                                 const WaveRows* wt, int S, int has_taints,
                                 int has_sel, int has_img, int64_t* img_cnt,
                                 uint8_t* mask, int64_t* taint_raw,
                                 int64_t* na_raw, int64_t* s_img,
                                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (S <= 0) return 0;
  if (S > KT_WS_MAX_S) return (int)cudaErrorInvalidValue;
  if (has_img)
    image_counts_kernel<<<S, CBLOCK, 0, st>>>(*na, *tb, *wt, img_cnt);
  const int64_t total = (int64_t)S * na->N;
  statics_kernel<<<(unsigned)((total + SBLOCK - 1) / SBLOCK), SBLOCK, 0,
                   st>>>(*na, *tb, *wt, S, has_taints, has_sel, has_img,
                         img_cnt, mask, taint_raw, na_raw, s_img);
  return (int)cudaGetLastError();
}

// the two launches apart, for the node-sharded mesh (ops/kernels.py
// wave_statics_sharded_cuda): each shard's image counts, the psum of the
// counts over the shards, then each shard's statics from the cluster-wide
// counts
extern "C" int ktpu_wave_image_counts(const NodeC* na, const TableC* tb,
                                      const WaveRows* wt, int S,
                                      int64_t* img_cnt, void* stream) {
  if (S <= 0) return 0;
  if (S > KT_WS_MAX_S) return (int)cudaErrorInvalidValue;
  image_counts_kernel<<<S, CBLOCK, 0, (cudaStream_t)stream>>>(*na, *tb, *wt,
                                                               img_cnt);
  return (int)cudaGetLastError();
}

extern "C" int ktpu_wave_statics_counted(const NodeC* na, const TableC* tb,
                                         const WaveRows* wt, int S,
                                         int has_taints, int has_sel,
                                         int has_img, const int64_t* img_cnt,
                                         uint8_t* mask, int64_t* taint_raw,
                                         int64_t* na_raw, int64_t* s_img,
                                         void* stream) {
  if (S <= 0) return 0;
  if (S > KT_WS_MAX_S) return (int)cudaErrorInvalidValue;
  const int64_t total = (int64_t)S * na->N;
  statics_kernel<<<(unsigned)((total + SBLOCK - 1) / SBLOCK), SBLOCK, 0,
                   (cudaStream_t)stream>>>(*na, *tb, *wt, S, has_taints,
                                           has_sel, has_img, img_cnt, mask,
                                           taint_raw, na_raw, s_img);
  return (int)cudaGetLastError();
}
