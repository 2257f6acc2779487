// Kernel K1: codebook distance sweep with a running top-k, for Hopper (sm_90a).
//
// Replaces medtok_tpu/ops/vq_pallas.py::fused_topk_l2 (kernel _topk_kernel,
// selection _scan_topk). For z [B, D] against a codebook slice e [N, D]
// (both fp32) it returns the k smallest d = (|z|^2 + |e|^2) - 2 z.e per row,
// ordered by (value, index) so that ties go to the lowest index, without
// ever writing the [B, N] distance matrix out. The kernels are templated on
// the width D and built at 16, 32, 64, 128 and 256 (the export's codebook:
// 64); the wrapper zero-pads any other width up to the next one, which adds
// exact zeros to every sum. k is 1 to 8. A wider D or a larger k takes the
// wide route at the end of the file: fp32 distances on the CUDA cores, as
// the plain version computes them (|z|^2 + |e|^2 - 2 z.e), for z rows in
// chunks that bound the [rows, N] scratch, then a per-row selection of the
// k smallest by (value, index) in k rounds (each the least pair above the
// last pick); any D, any k up to N, O(k N) work a row for the selection.
//
// Precision. One TF32 product (10 mantissa bits) would move a distance by
// about 1e-3 and change which codewords are nearest. The sweep uses 3xTF32:
// each fp32 value x is split into hi = tf32(x) and lo = tf32(x - hi) (round
// to nearest, ties away from zero), and z.e is summed in fp32 as hi.hi +
// hi.lo + lo.hi (lo.lo, below 2^-22 of the product, is left out). That
// keeps about 22 of fp32's 24 bits: each product's relative error is about
// 3 * 2^-22 = 7e-7, so on the quantizer's unit-length rows a distance is off
// by at most about 1.5e-6, below the fp32 FMA chain's own worst case at D =
// 64 (about 4e-6) and the 1e-5 gap under which two distances count as tied.
// The norms |x|^2 are one sequential fp32 FMA loop per row, so identical
// codewords get identical distances, and the lowest index wins their tie.
//
// Bound: 2*B*N*D operations against a few MB of data (the 21000 x 64
// codebook is 5.4 MB), so operations bound the sweep. At the export's shape
// (z [4096, 64], e [21000, 64]: 11.01 GFLOP) three TF32 products each on
// the tensor cores (495 TFLOP/s dense) take at least 0.0667 ms; the same
// work in fp32 on the CUDA cores (67 TFLOP/s) at least 0.1643 ms.
//
// Design, in order of the work:
//   1. tf32_split_kernel writes hi and lo of every element of z and e (fp32
//      bit patterns) and |x|^2 of every row into a scratch buffer the
//      wrapper allocates (2 (B + N) D + B + N + 1 floats; the last is a +inf
//      for columns past a range). Within each 16-column chunk it stores
//      column c + 4j at position 4c + j, so the four values a lane needs
//      for two mma k-steps are one 16-byte load. The split happens once per
//      call, not in the sweep's inner loop.
//   2. topk_tf32_kernel. blockIdx.x takes a tile of TB z rows, blockIdx.y a
//      contiguous range of TN-row codebook tiles (a "split"; the wrapper
//      sizes the splits so that the blocks fill the SMs in one wave).
//      Each warp owns 16 z rows and all TN columns of a tile: NT n8 tiles of
//      mma.sync.m16n8k8 tf32 with fp32 sums, 3 mma a tile per 8-deep step
//      (lo.hi, hi.lo, hi.hi). z's hi / lo stay in shared memory for the
//      whole range; the codebook's hi, lo and |e|^2 arrive by 16-byte (|e|^2:
//      4-byte) cp.async into STAGES buffers. Each buffer has two mbarriers,
//      one per tile each: "full" completes when every thread's copies have
//      landed, "empty" when every warp is done reading. The next tile is
//      staged one tile ahead, into the buffer left by the tile before the
//      previous one, so with three buffers a warp can run a tile ahead of
//      the slowest: the warps do not move in lockstep, and one warp's
//      selection overlaps another's products. Rows are padded to LD floats,
//      LD = 16 (mod 32), so the 16-byte fragment loads (rows g and g + 8,
//      position 4t of a chunk, g = lane / 4, t = lane % 4) are free of bank
//      conflicts.
//      Selection from the C fragments: a lane holds rows g and g + 8 at
//      columns 2t and 2t + 1 of each n8 tile and keeps a sorted top-k list
//      per row. A tile's distances are selected while the next tile's
//      products are in flight. Each value is first tested against thr, the
//      smallest k-th value of the quad's four lists of its row (branch-free,
//      into a bit mask); the few that pass are inserted in ascending column
//      order, so a strict "<" keeps the lower index ahead on equal values.
//      At the end of the range the four lanes of a quad merge their lists by
//      (value, index) with shuffles (k rounds of a quad minimum); a warp
//      owns its rows, so no other merge is needed inside the block.
//   3. topk_merge_kernel merges the per-split lists the same way (no launch
//      when there is one split: the sweep writes the result itself).
// Tiles by width (Tile<D>): D <= 64 takes 8 warps (TB = 128) and 3 stages
// of 64 codebook rows (201 KB of shared memory at D = 64), D = 128 4 warps
// and 2 stages of 64 rows (217 KB), D = 256 2 warps and 2 stages of 32 rows
// (204 KB); with two stages a warp cannot run ahead. Shared memory holds one
// block an SM at every width, so registers are not capped below what one
// block allows (155-179 a thread at D = 64, k = 1-8, no spills): capping
// them at the 128 that two blocks would need spilled, and 16 warps a block
// (two side by side on each 16 rows) ran no faster on the card. No atomics,
// so a launch is deterministic. wgmma, TMA and warp specialisation would feed
// the tensor cores faster; they are not used here.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "mma_bf16.cuh"  // cp.async helpers, FULL_MASK

namespace {

constexpr int SPLIT_THREADS = 128;
constexpr int SPLIT_ROWS = 32;  // rows a block of the split kernel
constexpr int MERGE_THREADS = 128;

// Tile shape of the sweep at width D (see the note above).
template <int D>
struct Tile {
  static constexpr int WARPS = D <= 64 ? 8 : D == 128 ? 4 : 2;
  static constexpr int NT = D <= 128 ? 8 : 4;
  static constexpr int STAGES = D <= 64 ? 3 : 2;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int TB = 16 * WARPS;  // z rows a block
  static constexpr int TN = 8 * NT;      // codebook rows a staged tile
  static constexpr int LD = (D % 32 == 0 ? D : D + 16) + 16;  // = 16 (mod 32)
  static constexpr size_t SMEM =
      sizeof(float) * (2 * (TB + STAGES * TN) * LD + STAGES * TN);
};

__device__ __forceinline__ bool lex_less(float va, int ia, float vb, int ib) {
  return va < vb || (va == vb && ia < ib);
}

// Insert (v, i), v < bv[K - 1], into a sorted list whose entries all have
// smaller indices: equal values then rank by position, so v goes after
// them. Straight-line selects, no branches.
template <int K>
__device__ __forceinline__ void insert_sorted(float (&bv)[K], int (&bi)[K], float v, int i) {
#pragma unroll
  for (int p = K - 1; p > 0; --p) {
    const bool shift = v < bv[p - 1];           // v goes above p - 1
    const bool here = !shift && v < bv[p];      // v lands at p
    const float nv = shift ? bv[p - 1] : here ? v : bv[p];
    const int ni = shift ? bi[p - 1] : here ? i : bi[p];
    bv[p] = nv;
    bi[p] = ni;
  }
  if (v < bv[0]) { bv[0] = v; bi[0] = i; }
}

__device__ __forceinline__ float quad_min(float v) {
  v = fminf(v, __shfl_xor_sync(FULL_MASK, v, 1));
  return fminf(v, __shfl_xor_sync(FULL_MASK, v, 2));
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

// x rounded to TF32 (10 mantissa bits; nearest, ties away from zero), as an
// fp32 bit pattern with the 13 low bits cleared
__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r & 0xffffe000u);
}

// mbarriers in shared memory: a stage's "full" barrier completes when every
// thread's copies into it have landed (cp.async arrives for the thread once
// its earlier copies complete), its "empty" barrier when every warp is done
// reading it. A wait names the parity of the phase it waits for.
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_on_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile("{\n"
               ".reg .pred p;\n"
               "WAIT:\n"
               "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
               "@!p bra WAIT;\n"
               "}\n"
               :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}

// d += a (16x8, row) * b (8x8, col), tf32 in, fp32 sums. a = (row g, col t),
// (g + 8, t), (g, t + 4), (g + 8, t + 4); b = (row t, col g), (t + 4, g)
__device__ __forceinline__ void mma_tf32(float (&d)[4], float a0, float a1, float a2,
                                         float a3, float b0, float b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(__float_as_uint(a0)), "r"(__float_as_uint(a1)), "r"(__float_as_uint(a2)),
        "r"(__float_as_uint(a3)), "r"(__float_as_uint(b0)), "r"(__float_as_uint(b1)));
}

// The three products of two 8-deep steps: the A fragments of rows g / g + 8
// and the B fragment of column g each hold (k-step 0: .x, .y; k-step 1: .z,
// .w), as the split kernel's chunk order places them.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const float4& ah0,
                                           const float4& ah1, const float4& al0,
                                           const float4& al1, const float4& bh,
                                           const float4& bl) {
  mma_tf32(d, al0.x, al1.x, al0.y, al1.y, bh.x, bh.y);
  mma_tf32(d, ah0.x, ah1.x, ah0.y, ah1.y, bl.x, bl.y);
  mma_tf32(d, ah0.x, ah1.x, ah0.y, ah1.y, bh.x, bh.y);
  mma_tf32(d, al0.z, al1.z, al0.w, al1.w, bh.z, bh.w);
  mma_tf32(d, ah0.z, ah1.z, ah0.w, ah1.w, bl.z, bl.w);
  mma_tf32(d, ah0.z, ah1.z, ah0.w, ah1.w, bh.z, bh.w);
}

// Rows [0, B) are z's, rows [B, B + N) the codebook's: hi, lo (columns
// permuted within 16-column chunks) and |x|^2 by a sequential FMA loop. A
// block takes SPLIT_ROWS rows through shared memory, so that its reads and
// writes of device memory are coalesced while each row's norm is still one
// thread's loop; its row stride D + 1 keeps that loop free of bank
// conflicts.
template <int D>
__global__ void __launch_bounds__(SPLIT_THREADS)
tf32_split_kernel(const float* __restrict__ z, int B, const float* __restrict__ e, int N,
                  float* __restrict__ zh, float* __restrict__ zl, float* __restrict__ zq,
                  float* __restrict__ eh, float* __restrict__ el, float* __restrict__ eq) {
  constexpr int CH = D / 4, LDX = D + 1;
  __shared__ float xs[SPLIT_ROWS * LDX];
  const int r0 = blockIdx.x * SPLIT_ROWS, tid = threadIdx.x;
  if (r0 + tid == 0) eq[N] = INFINITY;  // |e|^2 of the rows past a range
  auto offset = [&](int q) {            // row q's offset in z (q < B) or e
    return (size_t)(q < B ? q : q - B) * D;
  };
  for (int i = tid; i < SPLIT_ROWS * CH; i += SPLIT_THREADS) {
    const int r = i / CH, c = i % CH, q = r0 + r;
    if (q < B + N) {
      const float4 v = reinterpret_cast<const float4*>((q < B ? z : e) + offset(q))[c];
      float* x = xs + r * LDX + 4 * c;
      x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
    }
  }
  __syncthreads();
  if (tid < SPLIT_ROWS && r0 + tid < B + N) {
    const int q = r0 + tid;
    float s = 0.f;
#pragma unroll 16
    for (int d = 0; d < D; ++d) s = fmaf(xs[tid * LDX + d], xs[tid * LDX + d], s);
    if (q < B) zq[q] = s; else eq[q - B] = s;
  }
  for (int i = tid; i < SPLIT_ROWS * CH; i += SPLIT_THREADS) {
    const int r = i / CH, c = i % CH, q = r0 + r;
    if (q >= B + N) continue;
    const float* x = xs + r * LDX + 16 * (c / 4) + c % 4;  // position 4u + j holds column u + 4j
    float hv[4], lv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      hv[j] = tf32_rna(x[4 * j]);
      lv[j] = tf32_rna(x[4 * j] - hv[j]);
    }
    const size_t o = offset(q) + 4 * c;
    *reinterpret_cast<float4*>((q < B ? zh : eh) + o) = make_float4(hv[0], hv[1], hv[2], hv[3]);
    *reinterpret_cast<float4*>((q < B ? zl : el) + o) = make_float4(lv[0], lv[1], lv[2], lv[3]);
  }
}

template <int K, int D>
__global__ void __launch_bounds__(Tile<D>::THREADS, 1)
topk_tf32_kernel(const float* __restrict__ zh_g, const float* __restrict__ zl_g,
                 const float* __restrict__ zq_g, const float* __restrict__ eh_g,
                 const float* __restrict__ el_g, const float* __restrict__ eq_g,
                 int B, int N, int tiles_per_split,
                 float* __restrict__ out_v, int* __restrict__ out_i) {
  using T = Tile<D>;
  constexpr int LD = T::LD, TB = T::TB, TN = T::TN, NT = T::NT, S = T::STAGES;
  constexpr int CH = D / 4;  // 16-byte chunks a row
  extern __shared__ __align__(16) float smem[];
  float* zh = smem;                  // [TB][LD]
  float* zl = zh + TB * LD;          // [TB][LD]
  float* eh = zl + TB * LD;          // [S][TN][LD]
  float* el = eh + S * TN * LD;      // [S][TN][LD]
  float* eq = el + S * TN * LD;      // [S][TN]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * TB;
  const int col_begin = blockIdx.y * tiles_per_split * TN;
  const int col_end = min(N, col_begin + tiles_per_split * TN);
  const int n_tiles = (col_end - col_begin + TN - 1) / TN;

  __shared__ uint64_t full[S], empty[S];
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], T::THREADS);
      mbar_init(&empty[s], T::WARPS);
    }
  }
  __syncthreads();

  // tile `tile` of the range into stage tile % S (rows past the range are
  // zeros, their |e|^2 the +inf after the last one: never selected); the
  // stage's full barrier completes when every thread's copies have landed
  auto stage = [&](int tile) {
    const int c0 = col_begin + tile * TN, buf = tile % S;
    float* dh = eh + buf * TN * LD;
    float* dl = el + buf * TN * LD;
    for (int i = tid; i < TN * CH; i += T::THREADS) {
      const int r = i / CH, c = i % CH;
      const size_t off = (size_t)min(c0 + r, N - 1) * D + 4 * c;
      cp_async16(dh + r * LD + 4 * c, eh_g + off, c0 + r < col_end);
      cp_async16(dl + r * LD + 4 * c, el_g + off, c0 + r < col_end);
    }
    for (int i = tid; i < TN; i += T::THREADS)
      cp_async4(eq + buf * TN + i, eq_g + (c0 + i < col_end ? c0 + i : N), true);
    mbar_arrive_on_copies(&full[buf]);
  };
  // z's tile (zeros past B) lands with the first codebook tile
  for (int i = tid; i < TB * CH; i += T::THREADS) {
    const int r = i / CH, c = i % CH;
    const size_t off = (size_t)min(row0 + r, B - 1) * D + 4 * c;
    cp_async16(zh + r * LD + 4 * c, zh_g + off, row0 + r < B);
    cp_async16(zl + r * LD + 4 * c, zl_g + off, row0 + r < B);
  }
  stage(0);

  float bv[2][K];
  int bi[2][K];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int j = 0; j < K; ++j) { bv[r][j] = INFINITY; bi[r][j] = INT_MAX; }
  const int wrow = row0 + warp * 16 + g;  // this lane's rows: wrow, wrow + 8
  const float zq0 = wrow < B ? zq_g[wrow] : 0.f;
  const float zq1 = wrow + 8 < B ? zq_g[wrow + 8] : 0.f;
  const float* ah = zh + (warp * 16 + g) * LD + 4 * t;
  const float* al = zl + (warp * 16 + g) * LD + 4 * t;

  // The previous tile's distances (C fragment layout: rows g, g + 8 at
  // columns 2t, 2t + 1 of each n8 tile) and its first column; -1 before the
  // first tile. A tile's selection runs while the next tile's products are
  // in flight.
  //
  // Filter: a value is a candidate for a lane's list only if it is below
  // thr, the smallest k-th value of the quad's four lists of that row (taken
  // at each tile's start, lowered with the lane's own k-th). Those lists
  // hold k entries at or below thr, all from earlier columns, so a value at
  // or above thr cannot be among the row's k smallest; and thr never
  // exceeds the lane's own k-th, so a value below it belongs in the list.
  // The test is branch-free: it sets bit 2j + h of the row's mask for the
  // value at column 2t + h of n8 tile j; the candidates are then taken in
  // ascending column order (lowest bit first), a group of n8 tiles after
  // each 16-deep step's products.
  float dp[NT][4];
  int cprev = -1;
  float thr0 = INFINITY, thr1 = INFINITY;
  uint32_t m0 = 0, m1 = 0;
  auto masks = [&]() {
    thr0 = quad_min(bv[0][K - 1]);
    thr1 = quad_min(bv[1][K - 1]);
    m0 = m1 = 0;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        m0 |= (uint32_t)(dp[j][h] < thr0) << (2 * j + h);
        m1 |= (uint32_t)(dp[j][2 + h] < thr1) << (2 * j + h);
      }
  };
  auto take = [&](uint32_t bits, int r, float& thr) {
    while (bits) {
      const int b = __ffs(bits) - 1;
      bits &= bits - 1;
      // value b of the row: a tree of selects on b's bits, low bit first
      float v[2 * NT];
#pragma unroll
      for (int q = 0; q < 2 * NT; ++q) v[q] = dp[q >> 1][2 * r + (q & 1)];
#pragma unroll
      for (int w = 1; w < 2 * NT; w *= 2)
#pragma unroll
        for (int q = 0; q < 2 * NT; q += 2 * w) v[q] = (b & w) ? v[q + w] : v[q];
      if (v[0] < thr) {
        insert_sorted<K>(bv[r], bi[r], v[0], cprev + (b >> 1) * 8 + 2 * t + (b & 1));
        thr = fminf(thr, bv[r][K - 1]);
      }
    }
  };
  constexpr int KC = D / 16;

  for (int it = 0; it < n_tiles; ++it) {
    // Tile it + 1 goes into the stage that tile it + 1 - S left, once every
    // warp is done with that tile. With three stages that is tile it - 2, so
    // a warp may run a tile ahead of the slowest one: the warps do not move
    // in lockstep, and one warp's selection overlaps another's products.
    if (it + 1 < n_tiles) {
      if (it + 1 >= S) mbar_wait(&empty[(it + 1) % S], ((it + 1 - S) / S) & 1);
      stage(it + 1);
    }
    mbar_wait(&full[it % S], (it / S) & 1);
    if (cprev >= 0) masks();

    const int buf = it % S;
    const float* bh = eh + (buf * TN + g) * LD + 4 * t;
    const float* bl = el + (buf * TN + g) * LD + 4 * t;
    float acc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < KC; ++kk) {
      const int kc = 16 * kk;
      const float4 ah0 = *reinterpret_cast<const float4*>(ah + kc);
      const float4 ah1 = *reinterpret_cast<const float4*>(ah + 8 * LD + kc);
      const float4 al0 = *reinterpret_cast<const float4*>(al + kc);
      const float4 al1 = *reinterpret_cast<const float4*>(al + 8 * LD + kc);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float4 bh4 = *reinterpret_cast<const float4*>(bh + j * 8 * LD + kc);
        const float4 bl4 = *reinterpret_cast<const float4*>(bl + j * 8 * LD + kc);
        mma_3xtf32(acc[j], ah0, ah1, al0, al1, bh4, bl4);
      }
      // the previous tile's candidates in n8 tiles j with j * KC / NT == kk
      uint32_t grp = 0;
#pragma unroll
      for (int j = 0; j < NT; ++j)
        if (j * KC / NT == kk) grp |= 3u << (2 * j);
      take(m0 & grp, 0, thr0);
      take(m1 & grp, 1, thr1);
    }

    // distances (|z|^2 + |e|^2) - 2 z.e; |e|^2 is +inf past the range
    const float* q = eq + buf * TN + 2 * t;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float2 e2 = *reinterpret_cast<const float2*>(q + j * 8);
      dp[j][0] = (zq0 + e2.x) - 2.0f * acc[j][0];
      dp[j][1] = (zq0 + e2.y) - 2.0f * acc[j][1];
      dp[j][2] = (zq1 + e2.x) - 2.0f * acc[j][2];
      dp[j][3] = (zq1 + e2.y) - 2.0f * acc[j][3];
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[buf]);
    cprev = col_begin + it * TN;
  }
  masks();
  take(m0, 0, thr0);
  take(m1, 1, thr1);

  // merge the quad's four lists of each row: k rounds of a quad minimum by
  // (value, index); the lane holding it drops its head. Indices differ
  // across the quad, so one lane drops (or several, on unfilled entries).
  const size_t o = ((size_t)blockIdx.y * B + wrow) * K;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      float v = bv[r][0];
      int i = bi[r][0];
#pragma unroll
      for (int m = 1; m < 4; m <<= 1) {
        const float v2 = __shfl_xor_sync(FULL_MASK, v, m);
        const int i2 = __shfl_xor_sync(FULL_MASK, i, m);
        if (lex_less(v2, i2, v, i)) { v = v2; i = i2; }
      }
      if (bi[r][0] == i) {
#pragma unroll
        for (int p = 0; p < K - 1; ++p) { bv[r][p] = bv[r][p + 1]; bi[r][p] = bi[r][p + 1]; }
        bv[r][K - 1] = INFINITY;
        bi[r][K - 1] = INT_MAX;
      }
      if (t == 0 && wrow + 8 * r < B) {
        out_v[o + (size_t)8 * r * K + j] = v;
        out_i[o + (size_t)8 * r * K + j] = i;
      }
    }
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
                   int tiles_per_split, float* scratch, float* part_v, int* part_i,
                   float* vals, int* idx, cudaStream_t stream) {
  using T = Tile<D>;
  float* zh = scratch;
  float* zl = zh + (size_t)B * D;
  float* eh = zl + (size_t)B * D;
  float* el = eh + (size_t)N * D;
  float* eq = el + (size_t)N * D;
  float* zq = eq + N + 1;
  tf32_split_kernel<D><<<(B + N + SPLIT_ROWS - 1) / SPLIT_ROWS, SPLIT_THREADS, 0,
                         stream>>>(z, B, e, N, zh, zl, zq, eh, el, eq);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(topk_tf32_kernel<K, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::SMEM);
  if (err != cudaSuccess) return err;
  const bool direct = n_splits == 1;  // one split: the sweep writes the result
  dim3 grid((B + T::TB - 1) / T::TB, n_splits);
  topk_tf32_kernel<K, D><<<grid, T::THREADS, T::SMEM, stream>>>(
      zh, zl, zq, eh, el, eq, B, N, tiles_per_split, direct ? vals : part_v,
      direct ? idx : part_i);
  err = cudaGetLastError();
  if (err != cudaSuccess || direct) return err;
  topk_merge_kernel<K><<<(B + MERGE_THREADS - 1) / MERGE_THREADS, MERGE_THREADS,
                         0, stream>>>(part_v, part_i, B, n_splits, vals, idx);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_k(int k, const float* z, const float* e, int B, int N, int n_splits,
                     int tiles_per_split, float* sc, float* pv, int* pi, float* ov,
                     int* oi, cudaStream_t s) {
  switch (k) {
    case 1: return launch<1, D>(z, e, B, N, n_splits, tiles_per_split, sc, pv, pi, ov, oi, s);
    case 2: return launch<2, D>(z, e, B, N, n_splits, tiles_per_split, sc, pv, pi, ov, oi, s);
    case 3: return launch<3, D>(z, e, B, N, n_splits, tiles_per_split, sc, pv, pi, ov, oi, s);
    case 4: return launch<4, D>(z, e, B, N, n_splits, tiles_per_split, sc, pv, pi, ov, oi, s);
    case 5: return launch<5, D>(z, e, B, N, n_splits, tiles_per_split, sc, pv, pi, ov, oi, s);
    case 6: return launch<6, D>(z, e, B, N, n_splits, tiles_per_split, sc, pv, pi, ov, oi, s);
    case 7: return launch<7, D>(z, e, B, N, n_splits, tiles_per_split, sc, pv, pi, ov, oi, s);
    case 8: return launch<8, D>(z, e, B, N, n_splits, tiles_per_split, sc, pv, pi, ov, oi, s);
    default: return cudaErrorInvalidValue;
  }
}

// ------------------------------------------------------------ wide route --
// k above 8 or D above 256 (see the note at the top).
constexpr int WIDE_TILE = 16;     // z rows x codewords of a distance tile
constexpr int WIDE_CHUNK = 32;    // columns a staged chunk
constexpr int SELECT_THREADS = 256;

// |x|^2 of rows [0, n) of x [n, D], one thread a row, one FMA chain in order
__global__ void __launch_bounds__(128)
wide_norms_kernel(const float* __restrict__ x, int n, int D, float* __restrict__ out) {
  const int r = blockIdx.x * 128 + threadIdx.x;
  if (r >= n) return;
  const float* row = x + (size_t)r * D;
  float acc = 0.f;
  for (int d = 0; d < D; ++d) acc = fmaf(row[d], row[d], acc);
  out[r] = acc;
}

// dist[r][c] = (zq[r] + eq[c]) - 2 z_r.e_c for z rows [0, nr) against
// codewords [0, N); z.e one FMA chain over d in order
__global__ void __launch_bounds__(WIDE_TILE * WIDE_TILE)
wide_dist_kernel(const float* __restrict__ z, const float* __restrict__ zq, int nr,
                 const float* __restrict__ e, const float* __restrict__ eq, int N, int D,
                 float* __restrict__ dist) {
  __shared__ float zs[WIDE_TILE][WIDE_CHUNK + 1];
  __shared__ float es[WIDE_TILE][WIDE_CHUNK + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * WIDE_TILE + tx;
  const int r0 = blockIdx.y * WIDE_TILE, c0 = blockIdx.x * WIDE_TILE;
  float acc = 0.f;
  for (int d0 = 0; d0 < D; d0 += WIDE_CHUNK) {
    const int dn = min(WIDE_CHUNK, D - d0);
    __syncthreads();  // the previous chunk is consumed
    for (int i = tid; i < WIDE_TILE * WIDE_CHUNK; i += WIDE_TILE * WIDE_TILE) {
      const int r = i / WIDE_CHUNK, c = i % WIDE_CHUNK;
      zs[r][c] = r0 + r < nr && c < dn ? z[(size_t)(r0 + r) * D + d0 + c] : 0.f;
      es[r][c] = c0 + r < N && c < dn ? e[(size_t)(c0 + r) * D + d0 + c] : 0.f;
    }
    __syncthreads();
    for (int c = 0; c < dn; ++c) acc = fmaf(zs[ty][c], es[tx][c], acc);
  }
  const int r = r0 + ty, c = c0 + tx;
  if (r < nr && c < N) dist[(size_t)r * N + c] = (zq[r] + eq[c]) - 2.f * acc;
}

// The k smallest of each row of dist [rows, N] by (value, index): round j
// takes the least pair above round j - 1's pick. One block a row.
__global__ void __launch_bounds__(SELECT_THREADS)
wide_select_kernel(const float* __restrict__ dist, int N, int k, float* __restrict__ vals,
                   int* __restrict__ idx) {
  constexpr int WARPS = SELECT_THREADS / 32;
  __shared__ float warp_v[WARPS];
  __shared__ int warp_i[WARPS];
  __shared__ float pick_v;
  __shared__ int pick_i;
  const float* row = dist + (size_t)blockIdx.x * N;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  float prev_v = -INFINITY;
  int prev_i = -1;
  for (int j = 0; j < k; ++j) {
    float bv = INFINITY;
    int bi = INT_MAX;
    for (int c = threadIdx.x; c < N; c += SELECT_THREADS) {
      const float x = row[c];
      const bool above = x > prev_v || (x == prev_v && c > prev_i);
      if (above && lex_less(x, c, bv, bi)) { bv = x; bi = c; }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(FULL_MASK, bv, o);
      const int oi = __shfl_xor_sync(FULL_MASK, bi, o);
      if (lex_less(ov, oi, bv, bi)) { bv = ov; bi = oi; }
    }
    if (lane == 0) { warp_v[warp] = bv; warp_i[warp] = bi; }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int w = 1; w < WARPS; ++w)
        if (lex_less(warp_v[w], warp_i[w], bv, bi)) { bv = warp_v[w]; bi = warp_i[w]; }
      pick_v = bv;
      pick_i = bi;
      vals[(size_t)blockIdx.x * k + j] = bv;
      idx[(size_t)blockIdx.x * k + j] = bi;
    }
    __syncthreads();
    prev_v = pick_v;
    prev_i = pick_i;
    __syncthreads();  // pick_v / pick_i are rewritten by the next round
  }
}

cudaError_t launch_wide(const float* z, const float* e, int B, int N, int D, int k, int rows,
                        float* scratch, float* vals, int* idx, cudaStream_t s) {
  float* zq = scratch;
  float* eq = zq + B;
  float* dist = eq + N;
  wide_norms_kernel<<<(B + 127) / 128, 128, 0, s>>>(z, B, D, zq);
  wide_norms_kernel<<<(N + 127) / 128, 128, 0, s>>>(e, N, D, eq);
  cudaError_t err = cudaGetLastError();
  for (int r0 = 0; r0 < B && err == cudaSuccess; r0 += rows) {
    const int nr = min(rows, B - r0);
    const dim3 grid((N + WIDE_TILE - 1) / WIDE_TILE, (nr + WIDE_TILE - 1) / WIDE_TILE);
    wide_dist_kernel<<<grid, dim3(WIDE_TILE, WIDE_TILE), 0, s>>>(
        z + (size_t)r0 * D, zq + r0, nr, e, eq, N, D, dist);
    wide_select_kernel<<<nr, SELECT_THREADS, 0, s>>>(dist, N, k, vals + (size_t)r0 * k,
                                                      idx + (size_t)r0 * k);
    err = cudaGetLastError();
  }
  return err;
}

}  // namespace

// z rows a block and codebook rows a staged tile at a built width (0 for
// any other), so the wrapper can size the splits.
extern "C" int medtok_topk_tile_b(int dim) {
  switch (dim) {
    case 16: return Tile<16>::TB;
    case 32: return Tile<32>::TB;
    case 64: return Tile<64>::TB;
    case 128: return Tile<128>::TB;
    case 256: return Tile<256>::TB;
    default: return 0;
  }
}

extern "C" int medtok_topk_tile_n(int dim) {
  switch (dim) {
    case 16: return Tile<16>::TN;
    case 32: return Tile<32>::TN;
    case 64: return Tile<64>::TN;
    case 128: return Tile<128>::TN;
    case 256: return Tile<256>::TN;
    default: return 0;
  }
}

// z [B, dim] and e [N, dim] fp32 row-major on the device (e may point into a
// larger codebook: a region is a pointer offset plus a row count); dim is
// 16, 32, 64, 128 or 256 and k is 1 to 8. scratch holds 2 (B + N) dim + B +
// N + 1 floats; part_v / part_i hold [n_splits, B, k] (unused for one split);
// vals / idx receive [B, k].
extern "C" int medtok_topk_l2(const void* z, const void* e, int B, int N,
                              int dim, int k, int n_splits, int tiles_per_split,
                              void* scratch, void* part_v, void* part_i, void* vals,
                              void* idx, void* stream) {
  if (B <= 0 || N <= 0 || n_splits <= 0 || tiles_per_split <= 0)
    return (int)cudaErrorInvalidValue;
  const float* zf = static_cast<const float*>(z);
  const float* ef = static_cast<const float*>(e);
  float* sc = static_cast<float*>(scratch);
  float* pv = static_cast<float*>(part_v);
  int* pi = static_cast<int*>(part_i);
  float* ov = static_cast<float*>(vals);
  int* oi = static_cast<int*>(idx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dim) {
    case 16: err = launch_k<16>(k, zf, ef, B, N, n_splits, tiles_per_split, sc, pv, pi, ov, oi, s); break;
    case 32: err = launch_k<32>(k, zf, ef, B, N, n_splits, tiles_per_split, sc, pv, pi, ov, oi, s); break;
    case 64: err = launch_k<64>(k, zf, ef, B, N, n_splits, tiles_per_split, sc, pv, pi, ov, oi, s); break;
    case 128: err = launch_k<128>(k, zf, ef, B, N, n_splits, tiles_per_split, sc, pv, pi, ov, oi, s); break;
    case 256: err = launch_k<256>(k, zf, ef, B, N, n_splits, tiles_per_split, sc, pv, pi, ov, oi, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}

// The wide route (the wrapper takes it for k above 8 or dim above 256): z
// [B, dim] and e [N, dim] fp32 row-major, any dim >= 1 and 1 <= k <= N;
// rows z rows a chunk (1 to 1,048,560); scratch holds B + N + rows * N
// floats; vals / idx receive [B, k].
extern "C" int medtok_topk_l2_wide(const void* z, const void* e, int B, int N, int dim,
                                   int k, int rows, void* scratch, void* vals, void* idx,
                                   void* stream) {
  if (B <= 0 || N <= 0 || dim <= 0 || k < 1 || k > N || rows <= 0 ||
      (rows + WIDE_TILE - 1) / WIDE_TILE > 65535)
    return (int)cudaErrorInvalidValue;
  return (int)launch_wide(static_cast<const float*>(z), static_cast<const float*>(e), B, N,
                          dim, k, rows, static_cast<float*>(scratch),
                          static_cast<float*>(vals), static_cast<int*>(idx),
                          static_cast<cudaStream_t>(stream));
}
