// Kernel K1: codebook distance sweep with a running top-k, for Hopper (sm_90a).
//
// Replaces medtok_tpu/ops/vq_pallas.py::fused_topk_l2 (kernel _topk_kernel,
// selection _scan_topk). For z [B, D] against a codebook slice e [N, D]
// (both fp32) it returns the k smallest d = (|z|^2 + |e|^2) - 2 z.e per row,
// ordered by (value, index) so that ties go to the lowest index, without
// ever writing the [B, N] distance matrix out. The sweep is templated on
// the width D and built at 16, 32, 64, 128 and 256 (the export's codebook:
// 64); the wrapper zero-pads any other width up to the next one, which adds
// exact zeros to every sum. k is 1 to 8.
//
// Bound: 2*B*N*D fp32 operations against a few MB of data (the 21000x64
// codebook is 5.4 MB), so the sweep is bound by the fp32 CUDA-core rate. The
// dot products use fp32 FMA only: TF32 tensor-core math would round the
// inputs to 10 mantissa bits and change which codewords are nearest.
//
// Design. The TPU kernel walks N serially on one core and carries the running
// top-k in VMEM; here blocks run in parallel, so the work is split two ways:
//   * blockIdx.x takes a tile of TB=64 z rows, staged once in shared memory;
//   * blockIdx.y takes a contiguous range of codebook tiles ("split"), so
//     that even B=4096 gives several blocks per SM.
// Inside a block, 256 threads (16 x 16) compute a 64 x 128 distance tile per
// staged codebook tile; each thread owns 4 rows x 8 columns (columns
// tx + 16*c, which keeps the float4 shared-memory reads free of bank
// conflicts with the D + 4 float padded row stride). The z and codebook tiles
// take (64 + 128) x (D + 4) floats of dynamic shared memory: 52 KB at D =
// 64, 200 KB at D = 256 (one block an SM). Each thread keeps a
// register top-k per row over the columns it owns. It visits its columns in
// ascending index order, so a strict "<" insert keeps the lower index ahead
// on equal values. At the end of the split, the 16 per-thread lists of a row
// merge in shared memory by (value, index), and a second small kernel merges
// the per-split lists the same way.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

constexpr int TB = 64;         // z rows per block
constexpr int TN = 128;        // codebook rows per staged tile
constexpr int THREADS = 256;   // 16 x 16
constexpr int RPT = TB / 16;   // rows per thread
constexpr int CPT = TN / 16;   // columns per thread
constexpr int MERGE_THREADS = 128;

__device__ __forceinline__ bool lex_less(float va, int ia, float vb, int ib) {
  return va < vb || (va == vb && ia < ib);
}

// Insert (v, i) into a sorted list whose entries all have smaller indices:
// equal values then rank by position, so a strict "<" suffices.
template <int K>
__device__ __forceinline__ void insert_ascending(float (&bv)[K], int (&bi)[K],
                                                 float v, int i) {
  if (v < bv[K - 1]) {
    bv[K - 1] = v;
    bi[K - 1] = i;
#pragma unroll
    for (int p = K - 1; p > 0; --p) {
      if (bv[p] < bv[p - 1]) {
        float tv = bv[p]; bv[p] = bv[p - 1]; bv[p - 1] = tv;
        int ti = bi[p]; bi[p] = bi[p - 1]; bi[p - 1] = ti;
      }
    }
  }
}

// Insert (v, i) into a list sorted by (value, index), any index order.
template <int K>
__device__ __forceinline__ void insert_lex(float (&bv)[K], int (&bi)[K],
                                           float v, int i) {
  if (lex_less(v, i, bv[K - 1], bi[K - 1])) {
    bv[K - 1] = v;
    bi[K - 1] = i;
#pragma unroll
    for (int p = K - 1; p > 0; --p) {
      if (lex_less(bv[p], bi[p], bv[p - 1], bi[p - 1])) {
        float tv = bv[p]; bv[p] = bv[p - 1]; bv[p - 1] = tv;
        int ti = bi[p]; bi[p] = bi[p - 1]; bi[p - 1] = ti;
      }
    }
  }
}

// D: the embedding width; LD = D + 4 is the padded shared-memory row stride
template <int K, int D>
__global__ void __launch_bounds__(THREADS)
topk_partial_kernel(const float* __restrict__ z, const float* __restrict__ e,
                    int B, int N, int tiles_per_split,
                    float* __restrict__ part_v, int* __restrict__ part_i) {
  constexpr int LD = D + 4;
  extern __shared__ __align__(16) float smem[];
  float* z_s = smem;               // [TB][LD]
  float* e_s = z_s + TB * LD;      // [TN][LD]
  float* zsq_s = e_s + TN * LD;    // [TB]
  float* esq_s = zsq_s + TB;       // [TN]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int row0 = blockIdx.x * TB;
  const int split = blockIdx.y;
  const int col_begin = split * tiles_per_split * TN;
  const int col_end = min(N, col_begin + tiles_per_split * TN);

  for (int i = tid; i < TB * (D / 4); i += THREADS) {
    const int r = i / (D / 4), c4 = i % (D / 4);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < B)
      v = reinterpret_cast<const float4*>(z + (size_t)(row0 + r) * D)[c4];
    *reinterpret_cast<float4*>(&z_s[r * LD + c4 * 4]) = v;
  }
  __syncthreads();
  if (tid < TB) {
    float s = 0.f;
    for (int d = 0; d < D; ++d) s = fmaf(z_s[tid * LD + d], z_s[tid * LD + d], s);
    zsq_s[tid] = s;
  }

  float bv[RPT][K];
  int bi[RPT][K];
#pragma unroll
  for (int r = 0; r < RPT; ++r)
#pragma unroll
    for (int j = 0; j < K; ++j) { bv[r][j] = INFINITY; bi[r][j] = INT_MAX; }

  for (int t0 = col_begin; t0 < col_end; t0 += TN) {
    __syncthreads();  // the previous tile is consumed
    for (int i = tid; i < TN * (D / 4); i += THREADS) {
      const int r = i / (D / 4), c4 = i % (D / 4);
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (t0 + r < col_end)
        v = reinterpret_cast<const float4*>(e + (size_t)(t0 + r) * D)[c4];
      *reinterpret_cast<float4*>(&e_s[r * LD + c4 * 4]) = v;
    }
    __syncthreads();
    if (tid < TN) {
      float s = 0.f;
      for (int d = 0; d < D; d += 4) {
        const float4 v = *reinterpret_cast<const float4*>(&e_s[tid * LD + d]);
        s = fmaf(v.x, v.x, s); s = fmaf(v.y, v.y, s);
        s = fmaf(v.z, v.z, s); s = fmaf(v.w, v.w, s);
      }
      esq_s[tid] = s;
    }
    __syncthreads();

    float acc[RPT][CPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r)
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[r][c] = 0.f;

#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 a[RPT], b[CPT];
#pragma unroll
      for (int r = 0; r < RPT; ++r)
        a[r] = *reinterpret_cast<const float4*>(&z_s[(ty * RPT + r) * LD + d]);
#pragma unroll
      for (int c = 0; c < CPT; ++c)
        b[c] = *reinterpret_cast<const float4*>(&e_s[(tx + 16 * c) * LD + d]);
#pragma unroll
      for (int r = 0; r < RPT; ++r)
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          float s = acc[r][c];
          s = fmaf(a[r].x, b[c].x, s);
          s = fmaf(a[r].y, b[c].y, s);
          s = fmaf(a[r].z, b[c].z, s);
          s = fmaf(a[r].w, b[c].w, s);
          acc[r][c] = s;
        }
    }

#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const float zq = zsq_s[ty * RPT + r];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int col = t0 + tx + 16 * c;
        if (col < col_end) {
          const float dv = (zq + esq_s[tx + 16 * c]) - 2.0f * acc[r][c];
          insert_ascending<K>(bv[r], bi[r], dv, col);
        }
      }
    }
  }

  // merge the 16 per-thread lists of each row by (value, index)
  __syncthreads();
  float* cv = smem;                                        // [TB][16*K]
  int* ci = reinterpret_cast<int*>(smem + TB * 16 * K);    // [TB][16*K]
#pragma unroll
  for (int r = 0; r < RPT; ++r)
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int o = (ty * RPT + r) * 16 * K + tx * K + j;
      cv[o] = bv[r][j];
      ci[o] = bi[r][j];
    }
  __syncthreads();
  if (tid < TB && row0 + tid < B) {
    float ov[K];
    int oi[K];
#pragma unroll
    for (int j = 0; j < K; ++j) { ov[j] = INFINITY; oi[j] = INT_MAX; }
    const float* v = cv + tid * 16 * K;
    const int* ix = ci + tid * 16 * K;
    for (int q = 0; q < 16 * K; ++q) insert_lex<K>(ov, oi, v[q], ix[q]);
    const size_t o = ((size_t)split * B + row0 + tid) * K;
#pragma unroll
    for (int j = 0; j < K; ++j) { part_v[o + j] = ov[j]; part_i[o + j] = oi[j]; }
  }
}

template <int K>
__global__ void __launch_bounds__(MERGE_THREADS)
topk_merge_kernel(const float* __restrict__ part_v, const int* __restrict__ part_i,
                  int B, int S, float* __restrict__ vals, int* __restrict__ idx) {
  const int row = blockIdx.x * MERGE_THREADS + threadIdx.x;
  if (row >= B) return;
  float ov[K];
  int oi[K];
#pragma unroll
  for (int j = 0; j < K; ++j) { ov[j] = INFINITY; oi[j] = INT_MAX; }
  for (int s = 0; s < S; ++s) {
    const size_t o = ((size_t)s * B + row) * K;
#pragma unroll
    for (int j = 0; j < K; ++j) insert_lex<K>(ov, oi, part_v[o + j], part_i[o + j]);
  }
#pragma unroll
  for (int j = 0; j < K; ++j) {
    vals[(size_t)row * K + j] = ov[j];
    idx[(size_t)row * K + j] = oi[j];
  }
}

template <int K, int D>
cudaError_t launch(const float* z, const float* e, int B, int N, int n_splits,
                   int tiles_per_split, float* part_v, int* part_i,
                   float* vals, int* idx, cudaStream_t stream) {
  const size_t sweep = sizeof(float) * ((TB + TN) * (D + 4) + TB + TN);
  const size_t merge = (sizeof(float) + sizeof(int)) * TB * 16 * K;
  const size_t smem = sweep > merge ? sweep : merge;
  cudaError_t err = cudaFuncSetAttribute(
      topk_partial_kernel<K, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((B + TB - 1) / TB, n_splits);
  topk_partial_kernel<K, D><<<grid, THREADS, smem, stream>>>(
      z, e, B, N, tiles_per_split, part_v, part_i);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  topk_merge_kernel<K><<<(B + MERGE_THREADS - 1) / MERGE_THREADS, MERGE_THREADS,
                         0, stream>>>(part_v, part_i, B, n_splits, vals, idx);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_k(int k, const float* z, const float* e, int B, int N, int n_splits,
                     int tiles_per_split, float* pv, int* pi, float* ov, int* oi,
                     cudaStream_t s) {
  switch (k) {
    case 1: return launch<1, D>(z, e, B, N, n_splits, tiles_per_split, pv, pi, ov, oi, s);
    case 2: return launch<2, D>(z, e, B, N, n_splits, tiles_per_split, pv, pi, ov, oi, s);
    case 3: return launch<3, D>(z, e, B, N, n_splits, tiles_per_split, pv, pi, ov, oi, s);
    case 4: return launch<4, D>(z, e, B, N, n_splits, tiles_per_split, pv, pi, ov, oi, s);
    case 5: return launch<5, D>(z, e, B, N, n_splits, tiles_per_split, pv, pi, ov, oi, s);
    case 6: return launch<6, D>(z, e, B, N, n_splits, tiles_per_split, pv, pi, ov, oi, s);
    case 7: return launch<7, D>(z, e, B, N, n_splits, tiles_per_split, pv, pi, ov, oi, s);
    case 8: return launch<8, D>(z, e, B, N, n_splits, tiles_per_split, pv, pi, ov, oi, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Codebook tile width, so the wrapper can size the splits.
extern "C" int medtok_topk_tile_n() { return TN; }

// z [B, dim] and e [N, dim] fp32 row-major on the device (e may point into a
// larger codebook: a region is a pointer offset plus a row count); dim is
// 16, 32, 64, 128 or 256 and k is 1 to 8.
// part_v/part_i hold [n_splits, B, k]; vals/idx receive [B, k].
extern "C" int medtok_topk_l2(const void* z, const void* e, int B, int N,
                              int dim, int k, int n_splits, int tiles_per_split,
                              void* part_v, void* part_i, void* vals, void* idx,
                              void* stream) {
  if (B <= 0 || N <= 0 || n_splits <= 0 || tiles_per_split <= 0)
    return (int)cudaErrorInvalidValue;
  const float* zf = static_cast<const float*>(z);
  const float* ef = static_cast<const float*>(e);
  float* pv = static_cast<float*>(part_v);
  int* pi = static_cast<int*>(part_i);
  float* ov = static_cast<float*>(vals);
  int* oi = static_cast<int*>(idx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dim) {
    case 16: err = launch_k<16>(k, zf, ef, B, N, n_splits, tiles_per_split, pv, pi, ov, oi, s); break;
    case 32: err = launch_k<32>(k, zf, ef, B, N, n_splits, tiles_per_split, pv, pi, ov, oi, s); break;
    case 64: err = launch_k<64>(k, zf, ef, B, N, n_splits, tiles_per_split, pv, pi, ov, oi, s); break;
    case 128: err = launch_k<128>(k, zf, ef, B, N, n_splits, tiles_per_split, pv, pi, ov, oi, s); break;
    case 256: err = launch_k<256>(k, zf, ef, B, N, n_splits, tiles_per_split, pv, pi, ov, oi, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}
