// Building blocks of the attention kernels' wide routes (head widths above
// the widest built width, 256), shared by segment_attention.cu (K2 / K4)
// and flash_attention.cu (K3). A wide kernel reads Dh at run time. Two
// families:
//
// bf16, on the tensor cores (K2 / K4 and K3's forward, dq and dk / dv),
// with wgmma. A block is warp-specialized: a producer warpgroup streams the head width
// through shared memory in chunks of XC = 64 columns (stage_chunk, by
// cp.async into wgmma's 128-byte swizzle layout, sw_off: 16-byte copies
// where every row start and Dh allow it, else 4-byte copies, else (odd Dh)
// plain 2-byte stores; zeros past Dh and past the last row), several
// stages ahead, each stage handed to the two consumer warpgroups by a
// `full` mbarrier and back by an `empty` one; setmaxnreg moves the
// producer's registers to the consumers (X_REGS_*: a launch is refused
// unless the kernel was built with the registers the split needs, which
// also keep a block alone on its SM). A consumer
// warpgroup multiplies 64 query rows (K3's dk / dv: 64 key rows), its
// wgmma reading K and V (and K3's Q) straight from shared memory. A score tile S = Q K^T is the sum of the
// chunks' products (fp32 sums, bf16 operands exact). The output columns
// are split into slices of a few chunks (192 columns; K3: 192 or 256, its
// dq 192, its dk / dv 128), a
// grid dimension: each block holds its slice of O in registers and
// recomputes S for it; the rounded probabilities, repacked from S's
// registers as A fragments, are multiplied into the slice's chunks of V.
// Nothing is kept in global memory between key blocks and there are no
// atomics, so a launch is deterministic. The fragment layouts are those of
// mma_bf16.cuh.
//
// fp32, on the CUDA cores: a block of WT =
// 128 threads stages the operands through shared memory in chunks of WC =
// 32 columns (a scalar load per element, so any Dh and any alignment of a
// row's end work), and keeps its fp32 output sums in a global scratch
// buffer the wrapper allocates (one fp32 row per output row; K3-dkv: per
// output row and query split), where each thread owns the columns d =
// threadIdx.x (mod WT) of every row its block writes: no two threads touch
// one element, so the scratch needs no synchronisation and no atomics, and
// a launch is deterministic. The last step of a block (K3-dkv: a second
// kernel) writes its rows of the output in the input's dtype. Products: a
// dot product is one fp32 FMA chain over d in ascending order
// (tile_dots), the bf16 operands converted exactly; a product of rounded
// probabilities with V (or of ds with K, Q) is a second FMA chain over the
// block's keys (queries) in ascending order, added to the rescaled earlier
// sum as the plain versions add the block's matmul.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "mma_bf16.cuh"

namespace {

constexpr int WT = 128;  // threads of a wide block; B rows (keys) of a score tile
constexpr int WC = 32;   // columns a staged chunk
constexpr int WQ = 8;    // query rows a wide block owns (fp32 K2 / K4 / K3-fwd / K3-dq)

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

// ------------------------------------------------- bf16, tensor cores --

constexpr int XC = 64;              // columns of a staged chunk (128 bytes a row)
constexpr int X_SMEM_MAX = 232448;  // shared memory a block may take
constexpr int X_ROWS8 = 1024;       // bytes of 8 rows of a staged chunk

// setmaxnreg's split of a warp-specialized block of X_THREADS: the
// producer warpgroup drops to X_REGS_PRODUCER registers a thread, the two
// consumer warpgroups rise to X_REGS_CONSUMER. setmaxnreg.inc is met only
// from the registers the block was launched with, and waits until they are
// free: a kernel that ptxas built with fewer than X_REGS_LAUNCH registers a
// thread would wait there forever. Each launcher reads the count ptxas gave
// its kernel once (x_regs_of) and refuses to launch below X_REGS_LAUNCH. At
// X_REGS_LAUNCH a block holds 64,512 of an SM's 65,536 registers, so it is
// alone on its SM.
constexpr int X_THREADS = 384;
constexpr int X_REGS_PRODUCER = 40;
constexpr int X_REGS_CONSUMER = 232;
constexpr int X_REGS_LAUNCH = (128 * X_REGS_PRODUCER + 256 * X_REGS_CONSUMER) / X_THREADS;
static_assert(X_REGS_LAUNCH * X_THREADS == 128 * X_REGS_PRODUCER + 256 * X_REGS_CONSUMER &&
                  X_REGS_LAUNCH * X_THREADS <= 65536 && 2 * X_REGS_LAUNCH * X_THREADS > 65536,
              "the register split must fill one block's launch registers, one block an SM");

// cudaSuccess when kernel was built with the registers its split needs,
// else cudaErrorLaunchOutOfResources (or cudaFuncGetAttributes's error)
template <typename Kernel>
int x_regs_of(Kernel* kernel) {
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, kernel);
  if (e != cudaSuccess) return (int)e;
  return a.numRegs >= X_REGS_LAUNCH ? (int)cudaSuccess : (int)cudaErrorLaunchOutOfResources;
}

// The widest copy every row start of a bf16 [.., Dh] row-major tensor
// (16-byte aligned, row strides multiples of Dh) allows, in elements: 8
// (16 bytes) when Dh % 8 == 0, 2 (4 bytes) when Dh is even, else 1.
__host__ __device__ __forceinline__ int copy_elems(int Dh) {
  return Dh % 8 == 0 ? 8 : Dh % 2 == 0 ? 2 : 1;
}

// Byte offset of element (r, c) of a staged chunk (c < XC) in wgmma's
// 128-byte swizzle layout: row r is the 128 bytes at r * 128, its 16-byte
// piece j (columns 8j .. 8j + 7) stored at piece j ^ (r % 8), so the 8
// rows of an 8 x 8 block lie in 8 different bank groups. A chunk starts on
// a 1024-byte boundary (8 rows), as the swizzle is of address bits.
__device__ __forceinline__ int sw_off(int r, int c) {
  return r * 128 + ((((c >> 3) ^ r) & 7) << 4) + (c & 7) * 2;
}

// Columns [col0, col0 + XC) of rows [0, rows) of a bf16 matrix (row r at
// src + r * stride) into a staged chunk at dst (sw_off), `elems` elements a
// copy (copy_elems; 8 and 2 by cp.async, 1 by plain loads and stores):
// zeros in rows >= valid and in columns >= Dh. nthr threads share the
// work, this one being number tid (16-byte copies: a warp's 32 are 4 whole
// rows, four bank wavefronts); src must point at an element of the tensor.
__device__ __forceinline__ void stage_chunk(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                            size_t stride, int rows, int valid, int col0,
                                            int Dh, int elems, int tid, int nthr) {
  unsigned char* d = reinterpret_cast<unsigned char*>(dst);
  if (elems == 8) {
    for (int i = tid; i < rows * (XC / 8); i += nthr) {
      const int r = i / (XC / 8), c = (i % (XC / 8)) * 8;
      const bool in = r < valid && col0 + c < Dh;
      cp_async16(d + sw_off(r, c), in ? src + r * stride + col0 + c : src, in);
    }
  } else if (elems == 2) {
    for (int i = tid; i < rows * (XC / 2); i += nthr) {
      const int r = i / (XC / 2), c = (i % (XC / 2)) * 2;
      const bool in = r < valid && col0 + c < Dh;
      cp_async4(d + sw_off(r, c), in ? src + r * stride + col0 + c : src, in);
    }
  } else {
    for (int i = tid; i < rows * XC; i += nthr) {
      const int r = i / XC, c = i % XC;
      const bool in = r < valid && col0 + c < Dh;
      *reinterpret_cast<__nv_bfloat16*>(d + sw_off(r, c)) =
          in ? src[r * stride + col0 + c] : __float2bfloat16_rn(0.f);
    }
  }
}

// Rows [0, rows) x columns [0, cols) of a shared bf16 tile (row r at src +
// r * ld, ld a multiple of 8) to dst (row r at dst + r * stride), `elems`
// elements a store (copy_elems of the tensor's Dh; cols is then a multiple
// of it). The block's nthr threads share the work.
__device__ __forceinline__ void store_tile(__nv_bfloat16* dst, size_t stride,
                                           const __nv_bfloat16* src, int ld, int rows,
                                           int cols, int elems, int nthr) {
  const int per = cols / elems;  // stores a row
  for (int i = threadIdx.x; i < rows * per; i += nthr) {
    const int r = i / per, c = (i % per) * elems;
    __nv_bfloat16* o = dst + r * stride + c;
    const __nv_bfloat16* s = src + r * ld + c;
    if (elems == 8)
      *reinterpret_cast<uint4*>(o) = *reinterpret_cast<const uint4*>(s);
    else if (elems == 2)
      *reinterpret_cast<uint32_t*>(o) = *reinterpret_cast<const uint32_t*>(s);
    else
      *o = *s;
  }
}

// 16-column steps of the chunk from column col0 that hold a column < Dh
__device__ __forceinline__ int live_steps(int Dh, int col0) {
  return min(XC / 16, (Dh - col0 + 15) / 16);
}

// ---- warp specialization: a producer warpgroup stages the chunks, two
// consumer warpgroups multiply; a stage's `full` mbarrier completes when
// the producer's copies into it have landed, its `empty` one when every
// consumer thread is done reading it.

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}\n"
               :: "r"(smem_u32(bar)) : "memory");
}
// arrives on bar once every cp.async this thread started before has landed
__device__ __forceinline__ void mbar_arrive_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" :: "r"(smem_u32(bar))
               : "memory");
}
// waits until the phase of bar with this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}
// the calling warp's warpgroup, as a value the compiler knows is uniform
// over the warp
__device__ __forceinline__ int warpgroup_index() {
  return __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
}
template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}
template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}
// a barrier of the consumer warpgroups alone (id 1, 256 threads)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// ---- wgmma (sm_90a): a warpgroup of 4 warps multiplies 64 rows, warp w
// owning rows 16w .. 16w + 15 in the C-fragment layout of mma_bf16.cuh
// (d[4j .. 4j + 3] is that layout's fragment of columns 8j .. 8j + 7).

// The shared-memory descriptor of an operand in a staged chunk (sw_off):
// its start, 8 rows on is X_ROWS8 bytes on, 128-byte swizzle. The same
// descriptor serves an operand whose rows are the product's M or N rows
// and whose columns the reduction (Q and K of S = Q K^T; the start moves
// 32 bytes a 16-column step) and one whose rows are the reduction (V of
// O = P V, multiplied transposed; the start moves 2048 bytes a 16-row
// step).
__device__ __forceinline__ uint64_t wg_desc(const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return (uint64_t)((a & 0x3FFFF) >> 4) | (uint64_t)1 << 16 |
         (uint64_t)(X_ROWS8 >> 4) << 32 | (uint64_t)1 << 62;
}

// generic-proxy writes to shared memory (cp.async, stores) made visible to
// wgmma's reads; each writing thread, before the barrier
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// all but the last committed batch of wgmma have completed
__device__ __forceinline__ void wg_wait_prev() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// Pins registers to this point: before wg_fence, every write of the
// accumulators and A fragments the next wgmma take (so none is moved past
// the fence); after wg_wait_all, the registers a wgmma wrote or read (so
// the compiler neither reads nor reuses them while it runs).
template <int N>
__device__ __forceinline__ void wg_hold(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void wg_hold(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}


#define WG_D32                                                                              \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),       \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),            \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),         \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),         \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define WG_REGS32                                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "   \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d[64 x 64] = A (shared, K-major: the warpgroup's 64 rows) times B (64
// rows at b, K-major), plus d when acc is 1
__device__ __forceinline__ void wg_ss_n64(float (&d)[32], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_REGS32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_D32
      : "l"(a), "l"(b), "r"(acc));
}

// d[64 x 64] += A (registers: the warp's A fragment) times B (16 reduction
// rows of 64 columns at b, MN-major: V's rows)
__device__ __forceinline__ void wg_rs_n64_t(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[64 x 128] = A (registers: the warp's A fragment) times B (128 rows at
// b, K-major: B^T's rows are the 128 output columns), plus d when acc is 1
__device__ __forceinline__ void wg_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                           int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

#undef WG_D32
#undef WG_REGS32

}  // namespace
