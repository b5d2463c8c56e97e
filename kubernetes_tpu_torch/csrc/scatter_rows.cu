// scatter_rows: dirty node rows into a fresh copy of the resident
// NodeArrays.
//
// Replaces kubernetes_tpu/ops/program.py scatter_rows (:726; the jit
// _scatter_rows_jit :722): out[f][idx[d]] = rows[f][d] for every
// NodeArrays field f, every other row a copy of the previous device arrays
// (non-writing: in-flight drains still hold them). Duplicate indices carry
// identical rows, so which of them the row map keeps does not matter.
//
// What bounds it on an H100: bytes. Every output element is written once,
// from the previous copy or from its staged row; there is no arithmetic.
// At 8,192 nodes the whole NodeArrays is a few MB, so one call moves a
// few microseconds' worth of HBM traffic and the launch itself is most of
// its time.
//
// Design: one launch writes every output element of every field.
// blockIdx.y selects the field; the threads of that row of blocks stride
// over the field in units of the widest power of two (up to 16 bytes)
// that divides its row width and its three pointers, so bool, int32 and
// int64 columns are copied as they are, and the wide ones in 16-byte
// vectors. A device row map ([N] int32: the staged row of node n, or -1)
// picks each unit's source, so a node row is read from exactly one place.

#include <cstdint>
#include <cuda_runtime.h>

#define KT_SCATTER_MAX_FIELDS 24

struct ScatterField {
  void* dst;              // [N, row] fresh output
  const void* base;       // [N, row] previous device copy
  const void* rows;       // [D, row] staging rows
  int64_t row_units;      // units per node row
  int32_t unit_bytes;     // 1, 2, 4, 8 or 16
  int32_t pad;
};

struct ScatterC {
  ScatterField f[KT_SCATTER_MAX_FIELDS];
  int32_t nf, N, D;
};

namespace {

constexpr int THREADS = 256;

template <typename T>
__device__ __forceinline__ void copy_field(const ScatterField& f, int N,
                                           const int32_t* __restrict__ map) {
  T* dst = (T*)f.dst;
  const T* base = (const T*)f.base;
  const T* rows = (const T*)f.rows;
  const int64_t total = (int64_t)N * f.row_units;
  for (int64_t u = (int64_t)blockIdx.x * THREADS + threadIdx.x; u < total;
       u += (int64_t)gridDim.x * THREADS) {
    const int64_t n = u / f.row_units;
    const int32_t r = map[n];
    dst[u] = r >= 0 ? rows[(int64_t)r * f.row_units + (u - n * f.row_units)]
                    : base[u];
  }
}

__global__ void __launch_bounds__(THREADS)
scatter_rows_kernel(ScatterC s, const int32_t* __restrict__ map) {
  const ScatterField f = s.f[blockIdx.y];
  switch (f.unit_bytes) {
    case 16: copy_field<uint4>(f, s.N, map); break;
    case 8: copy_field<uint2>(f, s.N, map); break;
    case 4: copy_field<uint32_t>(f, s.N, map); break;
    case 2: copy_field<uint16_t>(f, s.N, map); break;
    default: copy_field<uint8_t>(f, s.N, map); break;
  }
}

}  // namespace

extern "C" int ktpu_scatter_rows(const ScatterC* s, const int32_t* map,
                                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (s->nf <= 0 || s->nf > KT_SCATTER_MAX_FIELDS)
    return (int)cudaErrorInvalidValue;
  if (s->N <= 0) return 0;
  int64_t widest = 1;
  for (int i = 0; i < s->nf; ++i)
    widest = s->f[i].row_units > widest ? s->f[i].row_units : widest;
  int64_t blocks = ((int64_t)s->N * widest + THREADS - 1) / THREADS;
  if (blocks > 256) blocks = 256;
  scatter_rows_kernel<<<dim3((unsigned)blocks, (unsigned)s->nf), THREADS, 0,
                        st>>>(*s, map);
  return (int)cudaGetLastError();
}
