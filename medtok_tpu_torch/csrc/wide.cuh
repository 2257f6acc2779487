// Building blocks of the attention kernels' wide routes (head widths above
// the widest built width, 256), shared by segment_attention.cu (K2 / K4)
// and flash_attention.cu (K3).
//
// A wide kernel reads Dh at run time, so nothing is sized by it: a block of
// WT = 128 threads stages the operands through shared memory in chunks of
// WC = 32 columns (a scalar load per element, so any Dh and any alignment
// of a row's end work), and keeps its fp32 output sums in a global scratch
// buffer the wrapper allocates (one fp32 row per output row; K3-dkv: per
// output row and query split), where each thread owns the columns d =
// threadIdx.x (mod WT) of every row its block writes: no two threads touch
// one element, so the scratch needs no synchronisation and no atomics, and
// a launch is deterministic. The last step of a block (K3-dkv: a second
// kernel) writes its rows of the output in the input's dtype.
//
// Products: a dot product is one fp32 FMA chain over d in ascending order
// (tile_dots), the bf16 operands converted exactly; a product of rounded
// probabilities with V (or of ds with K, Q) is a second FMA chain over the
// block's keys (queries) in ascending order, added to the rescaled earlier
// sum as the plain versions add the block's matmul.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int WT = 128;  // threads of a wide block; B rows (keys) of a score tile
constexpr int WC = 32;   // columns a staged chunk
constexpr int WQ = 8;    // query rows a wide block owns (K2 / K4 / K3-fwd / dq)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T and back: where the plain versions cast an fp32 operand to
// its partner's dtype before a product (round to nearest even)
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f32(from_f32<T>(x)); }

// Shared memory of tile_dots: WQ rows of A and WT rows of B, WC columns each
// (B's rows padded by one float, so thread t reading row t is free of bank
// conflicts; A's read four columns at a time).
struct __align__(16) DotTiles {
  float a[WQ][WC];
  float b[WT][WC + 1];
};

// acc[r] = sum_d A[r][d] B[threadIdx.x][d] for r < WQ: row r of A at
// A + r * a_stride (rows na.. read as zero), row c of B at B + c * b_stride
// (rows nb.. read as zero); d from 0 to Dh - 1 in order, one FMA chain.
// Every thread of the block must call it (it synchronises).
template <typename T>
__device__ void tile_dots(const T* A, size_t a_stride, int na, const T* B, size_t b_stride,
                          int nb, int Dh, DotTiles& s, float (&acc)[WQ]) {
#pragma unroll
  for (int r = 0; r < WQ; ++r) acc[r] = 0.f;
  for (int d0 = 0; d0 < Dh; d0 += WC) {
    const int dn = min(WC, Dh - d0);
    __syncthreads();  // the previous chunk is consumed
    for (int e = threadIdx.x; e < WQ * WC; e += WT) {
      const int r = e / WC, c = e % WC;
      s.a[r][c] = r < na && c < dn ? to_f32(A[r * a_stride + d0 + c]) : 0.f;
    }
    for (int e = threadIdx.x; e < WT * WC; e += WT) {
      const int r = e / WC, c = e % WC;
      s.b[r][c] = r < nb && c < dn ? to_f32(B[r * b_stride + d0 + c]) : 0.f;
    }
    __syncthreads();
    const float* bt = s.b[threadIdx.x];
    int c = 0;
    for (; c + 4 <= dn; c += 4) {
      const float b0 = bt[c], b1 = bt[c + 1], b2 = bt[c + 2], b3 = bt[c + 3];
#pragma unroll
      for (int r = 0; r < WQ; ++r) {
        const float4 a = *reinterpret_cast<const float4*>(&s.a[r][c]);
        acc[r] = fmaf(a.w, b3, fmaf(a.z, b2, fmaf(a.y, b1, fmaf(a.x, b0, acc[r]))));
      }
    }
    for (; c < dn; ++c) {
      const float bv = bt[c];
#pragma unroll
      for (int r = 0; r < WQ; ++r) acc[r] = fmaf(s.a[r][c], bv, acc[r]);
    }
  }
  __syncthreads();
}

// Per row r < WQ of p[WQ][n]: the maximum (kMax) or the sum of p[r][0..n),
// into out[r]. Warp w takes rows w, w + 4; a lane strides the row, then the
// warp reduces by shuffles (a fixed order, so the sum is deterministic).
template <bool kMax>
__device__ void row_reduce(const float* p, int ld, int n, float* out) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < WQ; r += WT / 32) {
    float x = kMax ? -INFINITY : 0.f;
    for (int j = lane; j < n; j += 32) x = kMax ? fmaxf(x, p[r * ld + j]) : x + p[r * ld + j];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float y = __shfl_xor_sync(0xffffffffu, x, o);
      x = kMax ? fmaxf(x, y) : x + y;
    }
    if (lane == 0) out[r] = x;
  }
}

// The online softmax's P.V step for the block's WQ query rows: for each
// column d this thread owns, acc[r][d] = acc[r][d] * alpha[r] + sum_j
// p[r][j] V[j][d] over the block's nk keys (p already rounded). acc row r
// at acc + r * Dh; row j of V at V + j * v_stride. Rows r >= nq are left
// alone. p is 16-byte aligned and ld a multiple of 4: p is read four keys at
// a time, the same FMA chain in the same order.
template <typename T>
__device__ void pv_update(float* acc, int nq, const float* alpha, const float* p, int ld,
                          const T* V, size_t v_stride, int nk, int Dh) {
  for (int d = threadIdx.x; d < Dh; d += WT) {
    float sum[WQ];
#pragma unroll
    for (int r = 0; r < WQ; ++r) sum[r] = 0.f;
    int j = 0;
    for (; j + 4 <= nk; j += 4) {
      const float v0 = to_f32(V[j * v_stride + d]), v1 = to_f32(V[(j + 1) * v_stride + d]);
      const float v2 = to_f32(V[(j + 2) * v_stride + d]), v3 = to_f32(V[(j + 3) * v_stride + d]);
#pragma unroll
      for (int r = 0; r < WQ; ++r) {
        const float4 pp = *reinterpret_cast<const float4*>(p + r * ld + j);
        sum[r] = fmaf(pp.w, v3, fmaf(pp.z, v2, fmaf(pp.y, v1, fmaf(pp.x, v0, sum[r]))));
      }
    }
    for (; j < nk; ++j) {
      const float vj = to_f32(V[j * v_stride + d]);
#pragma unroll
      for (int r = 0; r < WQ; ++r) sum[r] = fmaf(p[r * ld + j], vj, sum[r]);
    }
#pragma unroll
    for (int r = 0; r < WQ; ++r)
      if (r < nq) acc[(size_t)r * Dh + d] = acc[(size_t)r * Dh + d] * alpha[r] + sum[r];
  }
}

// acc rows r < nq of the block (each Dh wide) to zero, by the threads that
// own their columns
__device__ __forceinline__ void zero_rows(float* acc, int nq, int Dh) {
  for (int r = 0; r < nq; ++r)
    for (int d = threadIdx.x; d < Dh; d += WT) acc[(size_t)r * Dh + d] = 0.f;
}

}  // namespace
