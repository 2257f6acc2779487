// Kernels K5 (adj_count) and K5-lane (adj_count_onehot): the Count step of
// the dense normalized GCN adjacency, for Hopper (sm_90a).
//
//   Count[b, i, j] = sum_e bf16(w[b, e]) * 1[dst[b, e] == i] * 1[src[b, e] == j]
//
// Replace the Pallas kernels of scripts/bench_adj.py: K5 the edge-major
// count_kernel (pallas_count), K5-lane the lane-major count_kernel_lane
// (pallas_lane). Both TPU kernels build bf16 one-hots of the edge indices in
// VMEM and multiply them on the MXU with fp32 sums; Count is the first step
// of medtok_tpu/models/layers.py::gcn_norm_adj. Inputs: src, dst int32
// [B*Epg] (within-graph node indices, chunked per graph), w fp32 [B*Epg]
// (padding edges carry 0). Output: fp32 [B, Ln, Ln], every element written.
// An index outside [0, Ln) matches no one-hot row, as in the TPU kernels.
// Each weight is rounded to bf16 first, as the TPU kernels' one-hots do.
//
// Determinism: every Count cell is summed by one thread (K5) or one warp's
// MMA sequence (K5-lane) in a fixed order; there are no atomics. Products of
// 0/1 with a bf16 weight are exact, and integer sums below 2^24 are exact,
// so binary weights give the exact histogram.
//
// Bound at the Ln=512 tail shape (B=512, Epg=8192): the function reads 50 MB
// of edges, writes 537 MB of Count and does one add per edge, so bytes bound
// it at about 0.175 ms at 3.35 TB/s, for both kernels. K5-lane's method, the
// TPU kernels' product, adds 2*Ln*Ln*E one-hot MACs (up to 2.2 TFLOP, about
// 2.2 ms at the bf16 tensor-core peak): a floor of that design, not of the
// function.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

namespace {

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// ------------------------------------------------------------ K5: CUDA cores
//
// One block per (graph b, tile of K5_ROWS destination rows); one thread owns
// one destination row i. The block first zeroes its rows of Count in device
// memory (coalesced), then stages the graph's edges through shared memory
// in chunks and skips a chunk whose weights are all 0. Each thread scans the
// staged destinations in edge order (broadcast reads, four at a time) and,
// on dst == i, adds the weight to Count[b, i, src] in place: the cell is
// owned by that thread alone, so the sum runs in edge order with no atomics.
// The zeroing is ordered before the adds by __syncthreads (block scope).

constexpr int K5_ROWS = 128;   // destination rows per block, one per thread
constexpr int K5_CHUNK = 1024; // staged edges per chunk

__global__ void __launch_bounds__(K5_ROWS)
adj_count_kernel(const int* __restrict__ src, const int* __restrict__ dst,
                 const float* __restrict__ w, float* __restrict__ out, int Ln,
                 int Epg) {
  __shared__ __align__(16) int dst_s[K5_CHUNK];
  __shared__ int src_s[K5_CHUNK];
  __shared__ float w_s[K5_CHUNK];

  const int b = blockIdx.x;
  const int r0 = blockIdx.y * K5_ROWS;
  const int rows = min(K5_ROWS, Ln - r0);
  const int i = r0 + threadIdx.x;

  // zero rows [r0, r0 + rows) of graph b: one contiguous range
  float* tile = out + ((size_t)b * Ln + r0) * Ln;
  const size_t n = (size_t)rows * Ln;
  if ((Ln & 3) == 0) {
    float4* t4 = reinterpret_cast<float4*>(tile);
    for (size_t x = threadIdx.x; x < n / 4; x += K5_ROWS)
      t4[x] = make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    for (size_t x = threadIdx.x; x < n; x += K5_ROWS) tile[x] = 0.f;
  }

  float* row = out + ((size_t)b * Ln + i) * Ln;  // used only when i < Ln
  const size_t e0 = (size_t)b * Epg;
  for (int c0 = 0; c0 < Epg; c0 += K5_CHUNK) {
    const int ne = min(K5_CHUNK, Epg - c0);
    int nonzero = 0;
    for (int e = threadIdx.x; e < K5_CHUNK; e += K5_ROWS) {
      if (e < ne) {
        const float we = bf16_round(w[e0 + c0 + e]);
        dst_s[e] = dst[e0 + c0 + e];
        src_s[e] = src[e0 + c0 + e];
        w_s[e] = we;
        nonzero |= we != 0.f;
      } else {
        dst_s[e] = -1;  // matches no row
        src_s[e] = 0;
        w_s[e] = 0.f;
      }
    }
    // also orders the previous chunk's scan before this chunk's staging
    // and, on the first chunk, the zeroing before the adds
    if (!__syncthreads_or(nonzero)) continue;
    if (i < Ln) {
      const int4* d4 = reinterpret_cast<const int4*>(dst_s);
      for (int e = 0; e < ne; e += 4) {
        const int4 d = d4[e >> 2];
        if (d.x == i || d.y == i || d.z == i || d.w == i) {
          const int dd[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const int s = src_s[e + x];
            if (dd[x] == i && (unsigned)s < (unsigned)Ln) row[s] += w_s[e + x];
          }
        }
      }
    }
    __syncthreads();  // the scan is done before the next chunk is staged
  }
}

// ------------------------------------------------------- K5-lane: tensor cores
//
// Per graph, Count = D^T S with D[e, i] = bf16(w_e) 1[dst_e = i] and
// S[e, j] = 1[src_e = j]: a [Ln x E] by [E x Ln] product. One block of 8
// warps per (graph b, 128 x 128 tile of Count). For each chunk of 64 edges
// it stages the indices and weights, skips the chunk if every weight is 0,
// and otherwise writes the bf16 one-hot tiles D^T [128 x 64] (stored as
// [e][i], WMMA col_major) and S [64 x 128] ([e][j], row_major) into shared
// memory, 16 bytes per store, compared against the tile's node range. Each
// warp multiplies its 32 x 64 part with nvcuda::wmma m16n16k16 bf16
// fragments into fp32 accumulators (2 x 4 fragments). At the end the
// accumulators go through shared memory so that the ragged edge of Count
// is masked and the writes to device memory are coalesced.

constexpr int TI = 128;          // Count rows per block
constexpr int TJ = 128;          // Count columns per block
constexpr int KC = 64;           // edges per chunk
constexpr int LN_PAD = 8;        // bf16 row padding of the one-hot tiles
constexpr int A_LD = TI + LN_PAD;
constexpr int B_LD = TJ + LN_PAD;
constexpr int C_LD = TJ + 4;     // fp32 row stride of the output staging
constexpr int LANE_WARPS = 8;    // 4 x 2 warps, each 32 rows x 64 columns
constexpr int LANE_THREADS = 32 * LANE_WARPS;
constexpr size_t A_BYTES = sizeof(__nv_bfloat16) * KC * A_LD;
constexpr size_t B_BYTES = sizeof(__nv_bfloat16) * KC * B_LD;
constexpr size_t C_BYTES = sizeof(float) * TI * C_LD;
constexpr size_t LANE_SMEM = (A_BYTES + B_BYTES > C_BYTES ? A_BYTES + B_BYTES : C_BYTES);

// 8 bf16 one-hot values, (index - base == x) ? value : 0 for x in 0..7
__device__ __forceinline__ uint4 onehot8(int rel, __nv_bfloat16 value) {
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  uint4 u;
  __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&u);
#pragma unroll
  for (int x = 0; x < 8; ++x) h[x] = rel == x ? value : zero;
  return u;
}

__global__ void __launch_bounds__(LANE_THREADS)
adj_count_onehot_kernel(const int* __restrict__ src, const int* __restrict__ dst,
                        const float* __restrict__ w, float* __restrict__ out,
                        int Ln, int Epg, int tiles_j) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* a_s = reinterpret_cast<__nv_bfloat16*>(smem);            // [KC][A_LD]
  __nv_bfloat16* b_s = reinterpret_cast<__nv_bfloat16*>(smem + A_BYTES);  // [KC][B_LD]
  float* c_s = reinterpret_cast<float*>(smem);  // [TI][C_LD], after the loop
  __shared__ int dst_s[KC];
  __shared__ int src_s[KC];
  __shared__ float w_s[KC];  // bf16-rounded

  const int b = blockIdx.x;
  const int i0 = (blockIdx.y / tiles_j) * TI;
  const int j0 = (blockIdx.y % tiles_j) * TJ;
  const int warp = threadIdx.x / 32;
  const int wr = warp / 2;  // rows wr*32 .. +32 of the tile
  const int wc = warp % 2;  // columns wc*64 .. +64

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int fi = 0; fi < 2; ++fi)
#pragma unroll
    for (int fj = 0; fj < 4; ++fj) wmma::fill_fragment(acc[fi][fj], 0.f);

  const size_t e0 = (size_t)b * Epg;
  const __nv_bfloat16 one = __float2bfloat16(1.f);
  for (int c0 = 0; c0 < Epg; c0 += KC) {
    int nonzero = 0;
    if (threadIdx.x < KC) {
      const int e = c0 + threadIdx.x;
      if (e < Epg) {
        const float we = bf16_round(w[e0 + e]);
        dst_s[threadIdx.x] = dst[e0 + e];
        src_s[threadIdx.x] = src[e0 + e];
        w_s[threadIdx.x] = we;
        nonzero = we != 0.f;
      } else {
        dst_s[threadIdx.x] = -1;
        src_s[threadIdx.x] = -1;
        w_s[threadIdx.x] = 0.f;
      }
    }
    // also orders the previous chunk's products before this chunk's tiles
    if (!__syncthreads_or(nonzero)) continue;

    // one-hot tiles: KC rows of TI (resp. TJ) values, 8 per 16-byte store
    for (int v = threadIdx.x; v < KC * TI / 8; v += LANE_THREADS) {
      const int e = v / (TI / 8), x0 = (v % (TI / 8)) * 8;
      *reinterpret_cast<uint4*>(a_s + e * A_LD + x0) =
          onehot8(dst_s[e] - (i0 + x0), __float2bfloat16(w_s[e]));
    }
    for (int v = threadIdx.x; v < KC * TJ / 8; v += LANE_THREADS) {
      const int e = v / (TJ / 8), x0 = (v % (TJ / 8)) * 8;
      *reinterpret_cast<uint4*>(b_s + e * B_LD + x0) =
          onehot8(src_s[e] - (j0 + x0), one);
    }
    __syncthreads();

#pragma unroll
    for (int ks = 0; ks < KC; ks += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[4];
#pragma unroll
      for (int fi = 0; fi < 2; ++fi)
        wmma::load_matrix_sync(fa[fi], a_s + ks * A_LD + wr * 32 + fi * 16, A_LD);
#pragma unroll
      for (int fj = 0; fj < 4; ++fj)
        wmma::load_matrix_sync(fb[fj], b_s + ks * B_LD + wc * 64 + fj * 16, B_LD);
#pragma unroll
      for (int fi = 0; fi < 2; ++fi)
#pragma unroll
        for (int fj = 0; fj < 4; ++fj) wmma::mma_sync(acc[fi][fj], fa[fi], fb[fj], acc[fi][fj]);
    }
  }

  __syncthreads();  // the last products are done before c_s reuses the tiles
#pragma unroll
  for (int fi = 0; fi < 2; ++fi)
#pragma unroll
    for (int fj = 0; fj < 4; ++fj)
      wmma::store_matrix_sync(c_s + (wr * 32 + fi * 16) * C_LD + wc * 64 + fj * 16,
                              acc[fi][fj], C_LD, wmma::mem_row_major);
  __syncthreads();

  const bool vec = (Ln & 3) == 0;
  for (int v = threadIdx.x; v < TI * TJ / 4; v += LANE_THREADS) {
    const int r = v / (TJ / 4), c = (v % (TJ / 4)) * 4;
    const int gi = i0 + r, gj = j0 + c;
    if (gi >= Ln) continue;
    const float* cs = c_s + r * C_LD + c;
    float* o = out + ((size_t)b * Ln + gi) * Ln + gj;
    if (vec && gj + 3 < Ln) {
      *reinterpret_cast<float4*>(o) = make_float4(cs[0], cs[1], cs[2], cs[3]);
    } else {
      for (int x = 0; x < 4 && gj + x < Ln; ++x) o[x] = cs[x];
    }
  }
}

// shapes the launches take: grid.y (row tiles) is at most 65535
bool bad_args(int B, int Ln, int Epg) {
  return B <= 0 || Ln <= 0 || Epg <= 0 || (Ln + TI - 1) / TI > 255;
}

}  // namespace

// K5. src, dst: int32 [B*Epg]; w: fp32 [B*Epg]; out: fp32 [B, Ln, Ln],
// 16-byte aligned. Launches on `stream`; returns cudaGetLastError().
extern "C" int medtok_adj_count(const void* src, const void* dst, const void* w,
                                void* out, int B, int Ln, int Epg, void* stream) {
  if (bad_args(B, Ln, Epg)) return (int)cudaErrorInvalidValue;
  const dim3 grid(B, (Ln + K5_ROWS - 1) / K5_ROWS);
  adj_count_kernel<<<grid, K5_ROWS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(src), static_cast<const int*>(dst),
      static_cast<const float*>(w), static_cast<float*>(out), Ln, Epg);
  return (int)cudaGetLastError();
}

// K5-lane. Arguments as K5.
extern "C" int medtok_adj_count_onehot(const void* src, const void* dst,
                                       const void* w, void* out, int B, int Ln,
                                       int Epg, void* stream) {
  if (bad_args(B, Ln, Epg)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      adj_count_onehot_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)LANE_SMEM);
  if (err != cudaSuccess) return (int)err;
  const int tiles_i = (Ln + TI - 1) / TI, tiles_j = (Ln + TJ - 1) / TJ;
  const dim3 grid(B, tiles_i * tiles_j);
  adj_count_onehot_kernel<<<grid, LANE_THREADS, LANE_SMEM,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(src), static_cast<const int*>(dst),
      static_cast<const float*>(w), static_cast<float*>(out), Ln, Epg, tiles_j);
  return (int)cudaGetLastError();
}
