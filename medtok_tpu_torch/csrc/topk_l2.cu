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
// wide route at the end of the file (any D, any k up to N; see "Wide route"
// below).
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
//
// Wide route (k above 8 or D above 256), the same 3xTF32 arithmetic and
// selection, for any D. Bound at the timed shape (z [4096, 320], e [21000,
// 320], k 9): 55.05 GFLOP of fp32 products, three TF32 products each, at
// least 0.3336 ms on the tensor cores. A codebook of that width (53.8 MB of
// hi and lo) no longer fits in L2 beside z, and z no longer fits in shared
// memory, so the design streams both and makes each staged byte feed more
// products:
//   1. wide_split_kernel writes hi / lo of z and e row-major at width DP (D
//      rounded up to 32; zero columns add exact zeros) and |x|^2 as one FMA
//      chain a row in column order, so identical codewords get identical
//      norms.
//   2. topk_wide_kernel, warp-specialized as the bf16 attention kernels
//      (wide.cuh): a producer warpgroup stages, by 16-byte cp.async into
//      wgmma's 128-byte swizzle layout, a 32-column chunk of z's hi and lo
//      for the block's 128 rows and of the tile's hi and lo for its 128
//      codebook rows, KW_STAGES ahead through `full` / `empty` mbarriers;
//      two consumer warpgroups (64 z rows each) multiply with wgmma's tf32
//      form, m64n128k8 with both operands K-major in shared memory (row-major
//      z and e are), lo.hi + hi.lo + hi.hi per 8-deep step into 64 fp32
//      registers a thread: a tile's [64 x 128] sums stay in registers over
//      the whole width, every column summed in one order (duplicated
//      codewords give bit-identical distances). The C fragments are those
//      of mma.sync, so the tile is selected from the registers with the main
//      sweep's scheme (thr filter, sorted per-lane lists of KC = 8 or 16
//      entries for k up to 8 or 16, the quad merge at the end); blocks split
//      the codebook's tiles over one wave (the wrapper's plan), merged by
//      topk_merge_kernel. No [B, N] matrix is written for k up to 16.
//      Against mma.sync (the main sweep), wgmma reads its operands from
//      shared memory once a warpgroup rather than once a warp, and a block
//      of 128 x 128 outputs stages 64 KB for 2 x 128 x 128 x 32 x 3 products.
//   3. k above 16: the same sweep writes its tiles' distances to a [rows, N]
//      scratch (KC = 0) for z rows in chunks, and radix_select_kernel picks
//      the k smallest of each row by (value, index), one 512-thread block a
//      row, reading the row a fixed number of times whatever k is (steps 1-3
//      at most 7, step 4 never): (1) an order-preserving uint32 key of each
//      distance (-0 made +0, NaN last), kept in shared memory where the row
//      fits (21000 keys are 84 KB: then device memory is read once), with
//      the row's least and largest key; (2) the k-th smallest key T by a
//      radix select of 8-bit digits of key - least, from the top bit of
//      the row's spread (at most 4 passes, each a per-warp shared-memory
//      histogram and a scan of its 256 bins); (3) compaction in index
//      order, every key below T and then the first k - (count below) equal
//      to it (ballots within a warp's contiguous segment, a scan across the
//      warps), so ties at the k-th place go to the lowest index; (4) the k
//      survivors sorted by (key, index): bitonic in shared memory for k up
//      to 4,096, else a stable LSD radix sort of the keys through a global
//      [rows, 2, k] scratch (at most 4 passes over the survivors, none over
//      the row). Bound: reading the [rows, N] distances once (344 MB at
//      4096 x 21000: 0.10 ms) against the function's 0.3336 ms of products.
//      The plan (which steps run in shared memory, the chunk rows) is the
//      wrapper's (topk_l2.wide_plan).

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "mma_bf16.cuh"  // cp.async helpers, FULL_MASK
#include "wide.cuh"      // mbarriers, warp specialization, wgmma descriptors

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
    mbar_arrive_copies(&full[buf]);
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

// The k smallest of each row over S splits' lists [S, B, k] (k <= K: the
// list holds K, so its first k are the k smallest), by (value, index).
template <int K>
__global__ void __launch_bounds__(MERGE_THREADS)
topk_merge_kernel(const float* __restrict__ part_v, const int* __restrict__ part_i,
                  int B, int S, int k, float* __restrict__ vals, int* __restrict__ idx) {
  const int row = blockIdx.x * MERGE_THREADS + threadIdx.x;
  if (row >= B) return;
  float ov[K];
  int oi[K];
#pragma unroll
  for (int j = 0; j < K; ++j) { ov[j] = INFINITY; oi[j] = INT_MAX; }
  for (int s = 0; s < S; ++s) {
    const size_t o = ((size_t)s * B + row) * k;
    for (int j = 0; j < k; ++j) insert_lex<K>(ov, oi, part_v[o + j], part_i[o + j]);
  }
#pragma unroll
  for (int j = 0; j < K; ++j) {
    if (j >= k) break;
    vals[(size_t)row * k + j] = ov[j];
    idx[(size_t)row * k + j] = oi[j];
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
                         0, stream>>>(part_v, part_i, B, n_splits, K, vals, idx);
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
constexpr int KW_TB = 128;     // z rows a block: 64 a consumer warpgroup
constexpr int KW_TN = 128;     // codebook rows a tile (the wgmma's n)
constexpr int KW_DC = 32;      // columns a staged chunk: 128-byte rows
constexpr int KW_STAGES = 3;   // pipeline stages
constexpr int KW_CAP = 16;     // the largest k a register list holds
constexpr int KW_THREADS = X_THREADS;  // two consumer warpgroups and a producer warpgroup
constexpr int KW_ZCHUNK = KW_TB * KW_DC * 4;  // bytes of z's hi or lo chunk
constexpr int KW_ECHUNK = KW_TN * KW_DC * 4;  // bytes of the codebook's hi or lo chunk
constexpr int KW_STAGE = 2 * (KW_ZCHUNK + KW_ECHUNK);
static_assert(KW_DC * 4 == 128 && KW_ZCHUNK % X_ROWS8 == 0 && KW_ECHUNK % X_ROWS8 == 0,
              "a chunk is 128-byte rows in whole 8-row swizzle atoms");

// dynamic shared memory of the wide sweep: the stages, each tile's |e|^2
// beside its stage, the mbarriers
__host__ __device__ constexpr size_t topk_wide_smem() {
  return (size_t)KW_STAGES * (KW_STAGE + KW_TN * 4) + 16 * KW_STAGES;
}

// Rows [0, B) are z's, rows [B, B + N) the codebook's, each D wide: hi and
// lo row-major at width DP (a multiple of KW_DC; zeros past D) and |x|^2 as
// one FMA chain over d in order. A block takes SPLIT_ROWS rows through
// shared memory 32 columns at a time, a warp's reads and writes coalesced;
// thread r < SPLIT_ROWS carries row r's chain.
__global__ void __launch_bounds__(SPLIT_THREADS)
wide_split_kernel(const float* __restrict__ z, int B, const float* __restrict__ e, int N, int D,
                  int DP, float* __restrict__ zh, float* __restrict__ zl, float* __restrict__ zq,
                  float* __restrict__ eh, float* __restrict__ el, float* __restrict__ eq) {
  __shared__ float xs[SPLIT_ROWS][33];
  const int r0 = blockIdx.x * SPLIT_ROWS, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  if (r0 + tid == 0) eq[N] = INFINITY;  // |e|^2 of the rows past a range
  float norm = 0.f;
  for (int d0 = 0; d0 < DP; d0 += 32) {
    const int c = d0 + lane;
    for (int r = warp; r < SPLIT_ROWS; r += SPLIT_THREADS / 32) {
      const int q = r0 + r;
      if (q >= B + N) break;
      const size_t row = q < B ? q : q - B;
      const float x = c < D ? (q < B ? z : e)[row * D + c] : 0.f;
      xs[r][lane] = x;
      const float h = tf32_rna(x);
      (q < B ? zh : eh)[row * DP + c] = h;
      (q < B ? zl : el)[row * DP + c] = tf32_rna(x - h);
    }
    __syncthreads();
    if (tid < SPLIT_ROWS)
      for (int j = 0; j < 32; ++j) norm = fmaf(xs[tid][j], xs[tid][j], norm);
    __syncthreads();  // xs is rewritten by the next chunk
  }
  if (tid < SPLIT_ROWS && r0 + tid < B + N) {
    const int q = r0 + tid;
    if (q < B) zq[q] = norm; else eq[q - B] = norm;
  }
}

// Byte offset of fp32 element (r, c) of a staged chunk (c < KW_DC) in
// wgmma's 128-byte swizzle layout: row r is the 128 bytes at r * 128, its
// 16-byte piece j (columns 4j .. 4j + 3) stored at piece j ^ (r % 8)
// (sw_off's layout, four fp32 to a piece).
__device__ __forceinline__ int sw_off_f32(int r, int c) {
  return r * 128 + ((((c >> 2) ^ r) & 7) << 4) + (c & 3) * 4;
}

// Columns [col0, col0 + KW_DC) of rows [0, rows) of an fp32 matrix (row r at
// src + r * stride) into a staged chunk by 16-byte cp.async, zeros in rows
// >= valid; the nthr threads share the work, this one being number tid.
__device__ __forceinline__ void stage_chunk_f32(uint8_t* dst, const float* src, int stride,
                                                int rows, int valid, int col0, int tid,
                                                int nthr) {
  for (int i = tid; i < rows * (KW_DC / 4); i += nthr) {
    const int r = i / (KW_DC / 4), c = (i % (KW_DC / 4)) * 4;
    const bool in = r < valid;
    cp_async16(dst + sw_off_f32(r, c), in ? src + (size_t)r * stride + col0 + c : src, in);
  }
}

// d[64 x 128] (+)= A (64 rows, shared, K-major) times B (128 rows, shared,
// K-major), tf32 operands, fp32 sums: one 8-deep step of wgmma's tf32 form
__device__ __forceinline__ void wg_tf32_n128(float (&d)[64], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n}\n"
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
      : "l"(a), "l"(b), "r"(acc));
}

// The wide sweep. Block (x, y) takes z rows [128 x, 128 x + 128) against
// the codebook tiles of split y; each tile's distances (|z|^2 + |e|^2) -
// 2 z.e stay in the consumers' registers. KC > 0: each lane keeps a sorted
// list of KC per row (KC >= k), and the block writes each row's k smallest
// of its range to out_v / out_i ([gridDim.y, B, k]); KC == 0: the block
// writes the distances to dist [B, N] instead.
template <int KC>
__global__ void __launch_bounds__(KW_THREADS, 1)
topk_wide_kernel(const float* __restrict__ zh_g, const float* __restrict__ zl_g,
                 const float* __restrict__ zq_g, const float* __restrict__ eh_g,
                 const float* __restrict__ el_g, const float* __restrict__ eq_g, int B, int N,
                 int DP, int k, int tiles_per_split, float* __restrict__ out_v,
                 int* __restrict__ out_i, float* __restrict__ dist) {
  constexpr int LK = KC > 0 ? KC : 1;  // a list's length
  extern __shared__ __align__(1024) uint8_t kw_smem[];
  uint8_t* ring = kw_smem;  // [KW_STAGES][zh, zl, eh, el chunks]
  float* eqs = reinterpret_cast<float*>(ring + KW_STAGES * KW_STAGE);  // [KW_STAGES][KW_TN]
  uint64_t* full = reinterpret_cast<uint64_t*>(eqs + KW_STAGES * KW_TN);  // [KW_STAGES]
  uint64_t* empty = full + KW_STAGES;                                      // [KW_STAGES]

  const int nch = DP / KW_DC;
  const int row0 = blockIdx.x * KW_TB;
  const int col_begin = blockIdx.y * tiles_per_split * KW_TN;
  const int col_end = min(N, col_begin + tiles_per_split * KW_TN);
  const int n_tiles = (col_end - col_begin + KW_TN - 1) / KW_TN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wg = warpgroup_index();  // 0, 1: z rows 64 wg .. 64 wg + 63; 2: the producer
  if (smem_u32(kw_smem) % X_ROWS8) __trap();  // the swizzle needs 1024-byte chunks
  if (threadIdx.x == 0) {
    for (int i = 0; i < KW_STAGES; ++i) {
      mbar_init(&full[i], 128);   // the producer's threads, once their copies land
      mbar_init(&empty[i], 256);  // every consumer thread
    }
  }
  __syncthreads();

  if (wg == 2) {
    // the producer: a tile is nch steps, each z's and the tile's hi and lo
    // chunk; the last also the tile's |e|^2 (+inf past the range)
    regs_dec<X_REGS_PRODUCER>();
    const int tid = threadIdx.x - 256;
    int it = 0;
    for (int tile = 0; tile < n_tiles; ++tile) {
      const int c0 = col_begin + tile * KW_TN;
      for (int c = 0; c < nch; ++c, ++it) {
        const int slot = it % KW_STAGES;
        if (it >= KW_STAGES) mbar_wait(&empty[slot], ((it / KW_STAGES) - 1) & 1);
        uint8_t* st = ring + slot * KW_STAGE;
        const size_t zoff = (size_t)row0 * DP, eoff = (size_t)c0 * DP;
        stage_chunk_f32(st, zh_g + zoff, DP, KW_TB, B - row0, c * KW_DC, tid, 128);
        stage_chunk_f32(st + KW_ZCHUNK, zl_g + zoff, DP, KW_TB, B - row0, c * KW_DC, tid, 128);
        stage_chunk_f32(st + 2 * KW_ZCHUNK, eh_g + eoff, DP, KW_TN, col_end - c0, c * KW_DC, tid,
                        128);
        stage_chunk_f32(st + 2 * KW_ZCHUNK + KW_ECHUNK, el_g + eoff, DP, KW_TN, col_end - c0,
                        c * KW_DC, tid, 128);
        if (c == nch - 1)
          cp_async4(eqs + slot * KW_TN + tid, eq_g + (c0 + tid < col_end ? c0 + tid : N), true);
        mbar_arrive_copies(&full[slot]);
      }
    }
    return;
  }

  // the consumers: a thread holds rows wrow and wrow + 8 at columns 8j + 2t
  // and 8j + 2t + 1 of the tile (C fragment j of its warp's 16 rows)
  regs_inc<X_REGS_CONSUMER>();
  const int wrow = row0 + 64 * wg + 16 * (warp & 3) + g;
  const float zq0 = wrow < B ? zq_g[wrow] : 0.f;
  const float zq1 = wrow + 8 < B ? zq_g[wrow + 8] : 0.f;
  const int a_rows = 64 * wg * 128;  // byte offset of the warpgroup's rows in z's chunk
  float bv[2][LK];
  int bi[2][LK];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int j = 0; j < LK; ++j) { bv[r][j] = INFINITY; bi[r][j] = INT_MAX; }
  int got = 0, done = 0;  // steps acquired, steps released
  auto acquire = [&]() {
    mbar_wait(&full[got % KW_STAGES], (got / KW_STAGES) & 1);
    fence_async_smem();
    return ring + (got++ % KW_STAGES) * KW_STAGE;
  };
  auto release = [&]() { mbar_arrive(&empty[done++ % KW_STAGES]); };

  float acc[64];
  for (int tile = 0; tile < n_tiles; ++tile) {
    // z.e over the width: per 8-deep step lo.hi + hi.lo + hi.hi (lo.lo is
    // below 2^-22 of the product), every column summed in one order
    for (int c = 0; c < nch; ++c) {
      const uint8_t* st = acquire();
      const uint8_t* ah = st + a_rows;
      const uint8_t* al = ah + KW_ZCHUNK;
      const uint8_t* bh = st + 2 * KW_ZCHUNK;
      const uint8_t* bl = bh + KW_ECHUNK;
      if (c > 0) wg_hold(acc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < KW_DC / 8; ++kk) {
        wg_tf32_n128(acc, wg_desc(al + kk * 32), wg_desc(bh + kk * 32), c > 0 || kk > 0);
        wg_tf32_n128(acc, wg_desc(ah + kk * 32), wg_desc(bl + kk * 32), 1);
        wg_tf32_n128(acc, wg_desc(ah + kk * 32), wg_desc(bh + kk * 32), 1);
      }
      wg_commit();
      if (c > 0) {  // the previous chunk's products are done: free its stage
        wg_wait_prev();
        release();
      }
    }
    wg_wait_all();
    wg_hold(acc);
    // distances (|z|^2 + |e|^2) - 2 z.e; |e|^2 (+inf past the range) from
    // the tile's last stage, released after
    const float* q = eqs + ((got - 1) % KW_STAGES) * KW_TN + 2 * t;
#pragma unroll
    for (int j = 0; j < KW_TN / 8; ++j) {
      const float2 e2 = *reinterpret_cast<const float2*>(q + 8 * j);
      acc[4 * j] = (zq0 + e2.x) - 2.0f * acc[4 * j];
      acc[4 * j + 1] = (zq0 + e2.y) - 2.0f * acc[4 * j + 1];
      acc[4 * j + 2] = (zq1 + e2.x) - 2.0f * acc[4 * j + 2];
      acc[4 * j + 3] = (zq1 + e2.y) - 2.0f * acc[4 * j + 3];
    }
    release();
    const int cbase = col_begin + tile * KW_TN;

    if constexpr (KC == 0) {
#pragma unroll
      for (int j = 0; j < KW_TN / 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = wrow + 8 * r, col = cbase + 8 * j + 2 * t;
          if (row >= B) continue;
          float* o = dist + (size_t)row * N + col;
          if (col < col_end) o[0] = acc[4 * j + 2 * r];
          if (col + 1 < col_end) o[1] = acc[4 * j + 2 * r + 1];
        }
    } else {
      // Filter, as the main sweep's: a value is a candidate for the lane's
      // list of its row only if it is below thr, the smallest last entry of
      // the quad's four lists of that row (a branch-free test into bit 2j +
      // h for column 8j + 2t + h); the candidates are inserted in ascending
      // column order, so a strict "<" keeps the lower index ahead on equal
      // values.
      float thr[2];
      uint32_t m[2] = {0u, 0u};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        thr[r] = quad_min(bv[r][LK - 1]);
#pragma unroll
        for (int j = 0; j < KW_TN / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            m[r] |= (uint32_t)(acc[4 * j + 2 * r + h] < thr[r]) << (2 * j + h);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        uint32_t bits = m[r];
        while (bits) {
          const int b = __ffs(bits) - 1;
          bits &= bits - 1;
          // value b of the row: a tree of selects on b's bits, low bit first
          float v[KW_TN / 4];
#pragma unroll
          for (int x = 0; x < KW_TN / 4; ++x) v[x] = acc[4 * (x >> 1) + 2 * r + (x & 1)];
#pragma unroll
          for (int w = 1; w < KW_TN / 4; w *= 2)
#pragma unroll
            for (int x = 0; x < KW_TN / 4; x += 2 * w) v[x] = (b & w) ? v[x + w] : v[x];
          if (v[0] < thr[r]) {
            insert_sorted<LK>(bv[r], bi[r], v[0], cbase + (b >> 1) * 8 + 2 * t + (b & 1));
            thr[r] = fminf(thr[r], bv[r][LK - 1]);
          }
        }
      }
    }
  }

  if constexpr (KC > 0) {
    // merge the quad's four lists of each row: k rounds of a quad minimum
    // by (value, index); the lane holding it drops its head
    const size_t o = ((size_t)blockIdx.y * B + wrow) * k;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      for (int j = 0; j < k; ++j) {
        float v = bv[r][0];
        int i = bi[r][0];
#pragma unroll
        for (int s = 1; s < 4; s <<= 1) {
          const float v2 = __shfl_xor_sync(FULL_MASK, v, s);
          const int i2 = __shfl_xor_sync(FULL_MASK, i, s);
          if (lex_less(v2, i2, v, i)) { v = v2; i = i2; }
        }
        if (bi[r][0] == i) {
#pragma unroll
          for (int p = 0; p < LK - 1; ++p) { bv[r][p] = bv[r][p + 1]; bi[r][p] = bi[r][p + 1]; }
          bv[r][LK - 1] = INFINITY;
          bi[r][LK - 1] = INT_MAX;
        }
        if (t == 0 && wrow + 8 * r < B) {
          out_v[o + (size_t)8 * r * k + j] = v;
          out_i[o + (size_t)8 * r * k + j] = i;
        }
      }
    }
  }
}

// ------------------------------------------------------- the selection --
// k above 16 (item 3 of "Wide route" at the top): one block a row of the
// [rows, N] distances.
constexpr int SELECT_THREADS = 512;
constexpr int SELECT_WARPS = SELECT_THREADS / 32;
constexpr int SELECT_BINS = 256;       // an 8-bit digit
constexpr int SELECT_SORT_MAX = 4096;  // the most survivors (k up to a power of 2) sorted in shared memory
constexpr int SELECT_MISC = 2048;      // bytes of shared memory for reductions and digit offsets

__host__ __device__ constexpr int pow2_at_least(int k) {
  int p = 1;
  while (p < k) p <<= 1;
  return p;
}

// Dynamic shared memory of the selection: the survivors to sort
// (sort_shared), the per-warp histograms (a second table for the global
// sort), SELECT_MISC bytes, the row's keys (row_shared; 3 words of slack
// align their 16-byte stores).
__host__ __device__ constexpr size_t select_smem(int N, int k, int row_shared, int sort_shared) {
  return (sort_shared ? 8 * (size_t)pow2_at_least(k) : 0) +
         4 * (size_t)SELECT_WARPS * SELECT_BINS * (sort_shared ? 1 : 2) + SELECT_MISC +
         (row_shared ? 4 * ((size_t)N + 3) : 0);
}

// An order-preserving key of a distance: -0 is +0 (equal values rank by
// index), NaN above everything (a sort puts it last).
__device__ __forceinline__ uint32_t order_key(float x) {
  if (x != x) return 0xffffffffu;
  uint32_t b = __float_as_uint(x);
  if (b == 0x80000000u) b = 0u;
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// The block's least and largest key, in every thread (red: 2 x SELECT_WARPS words)
__device__ __forceinline__ void block_min_max(uint32_t& lo, uint32_t& hi, uint32_t* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  lo = __reduce_min_sync(FULL_MASK, lo);
  hi = __reduce_max_sync(FULL_MASK, hi);
  if (lane == 0) { red[warp] = lo; red[SELECT_WARPS + warp] = hi; }
  __syncthreads();
  for (int w = 0; w < SELECT_WARPS; ++w) { lo = min(lo, red[w]); hi = max(hi, red[SELECT_WARPS + w]); }
  __syncthreads();
}

// Sums the per-warp histograms bin by bin, zeroing them, and scans the
// sums: thread b < SELECT_BINS gets the count of the bins below b (excl)
// and through b (incl). Every thread calls it; red: SELECT_WARPS words.
__device__ __forceinline__ void scan_bins(uint32_t* hist, uint32_t* red, uint32_t& excl,
                                          uint32_t& incl) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  uint32_t n = 0;
  incl = 0;
  if (tid < SELECT_BINS) {
    for (int w = 0; w < SELECT_WARPS; ++w) {
      n += hist[w * SELECT_BINS + tid];
      hist[w * SELECT_BINS + tid] = 0;
    }
    incl = n;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t y = __shfl_up_sync(FULL_MASK, incl, o);
      if (lane >= o) incl += y;
    }
    if (lane == 31) red[warp] = incl;
  }
  __syncthreads();
  if (tid < SELECT_BINS)
    for (int w = 0; w < warp; ++w) incl += red[w];
  excl = incl - n;
}

// The k smallest of each row of dist [rows, N] by (value, index), read a
// fixed number of times whatever k is. One block a row:
//   1. keys (order_key) of the row, kept in shared memory where the row
//      fits (row_shared: one read of device memory; else each step below
//      reads the row again), and their least lo and largest hi;
//   2. the k-th smallest key T by a radix select on key - lo, 8 bits a
//      pass from the highest bit of hi - lo: a per-warp histogram of the
//      keys that share the digits fixed so far, then a scan of its bins
//      picks the next digit (at most 4 passes; 3 for distances within one
//      binade's width of each other);
//   3. compaction in index order: every key below T, then the first k - c
//      keys equal to T (c: the count below), each warp taking a contiguous
//      segment of the row with ballots and the warps' counts scanned, so
//      ties at the k-th place go to the lowest index;
//   4. the k survivors (key << 32 | index) sorted: bitonic in shared
//      memory for k up to SELECT_SORT_MAX (sort_shared), else a stable LSD
//      radix sort by key (8 bits a pass, at most 4) through sort_g [rows, 2,
//      k], whose input is in index order already; values are read back
//      from the row, so -0 stays -0.
// Steps 1-3 read the row at most 7 times (step 1 once, step 2 once a
// pass, step 3 twice); no step loops over k.
__global__ void __launch_bounds__(SELECT_THREADS, 2)
radix_select_kernel(const float* __restrict__ dist, int N, int k, int row_shared,
                    int sort_shared, float* __restrict__ vals, int* __restrict__ idx,
                    unsigned long long* __restrict__ sort_g) {
  extern __shared__ __align__(16) uint8_t sel_smem[];
  const int kp = sort_shared ? pow2_at_least(k) : 0;
  const int tables = sort_shared ? 1 : 2;
  unsigned long long* sorted = reinterpret_cast<unsigned long long*>(sel_smem);  // [kp]
  uint32_t* hist = reinterpret_cast<uint32_t*>(sel_smem + 8 * (size_t)kp);  // [tables][WARPS][BINS]
  uint32_t* misc = hist + tables * SELECT_WARPS * SELECT_BINS;  // [0, 32) reductions, 32-33
                                                                 // the digit, [64, 96) the
                                                                 // warps' counts, [256, 512) run
  const size_t r = blockIdx.x;
  const float* row = dist + r * N;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned lt = (1u << lane) - 1;
  uint32_t* h = hist + warp * SELECT_BINS;  // this warp's histogram (table 0)
  for (int i = tid; i < tables * SELECT_WARPS * SELECT_BINS; i += SELECT_THREADS) hist[i] = 0;

  // 1. keys: 16-byte loads after the first `head` columns, stored so that
  // those land 16-byte aligned in shared memory too
  const int head = min(N, (int)((16 - (reinterpret_cast<uintptr_t>(row) & 15)) & 15) / 4);
  uint32_t* keys = misc + SELECT_MISC / 4 + ((4 - head) & 3);
  uint32_t lo = 0xffffffffu, hi = 0u;
  if (tid < head) {
    const uint32_t key = order_key(row[tid]);
    if (row_shared) keys[tid] = key;
    lo = hi = key;
  }
  const int n4 = (N - head) / 4;
  const float4* body = reinterpret_cast<const float4*>(row + head);
#pragma unroll 4
  for (int i = tid; i < n4; i += SELECT_THREADS) {
    const float4 v = body[i];
    const uint4 q = make_uint4(order_key(v.x), order_key(v.y), order_key(v.z), order_key(v.w));
    if (row_shared) *reinterpret_cast<uint4*>(keys + head + 4 * i) = q;
    lo = min(lo, min(min(q.x, q.y), min(q.z, q.w)));
    hi = max(hi, max(max(q.x, q.y), max(q.z, q.w)));
  }
  for (int c = head + 4 * n4 + tid; c < N; c += SELECT_THREADS) {
    const uint32_t key = order_key(row[c]);
    if (row_shared) keys[c] = key;
    lo = min(lo, key);
    hi = max(hi, key);
  }
  block_min_max(lo, hi, misc);
  auto key_at = [&](int c) -> uint32_t { return row_shared ? keys[c] : order_key(row[c]); };

  // 2. the radix select: prefix holds the k-th key's offset from lo above
  // bit `top`, krem its rank (from 1) among the keys that share it
  const uint32_t range = hi - lo;
  uint32_t prefix = 0;
  int krem = k;
  for (int top = range ? 32 - __clz(range) : 0; top > 0;) {
    const int shift = max(top - 8, 0);
    const uint32_t mask = (1u << (top - shift)) - 1;
    for (int c = tid; c < N; c += SELECT_THREADS) {
      const uint32_t u = key_at(c) - lo;
      if (((uint64_t)u >> top) == prefix) atomicAdd(&h[(u >> shift) & mask], 1u);
    }
    __syncthreads();
    uint32_t excl, incl;
    scan_bins(hist, misc, excl, incl);
    if (tid < SELECT_BINS && excl < (uint32_t)krem && (uint32_t)krem <= incl) {
      misc[32] = tid;
      misc[33] = excl;
    }
    __syncthreads();
    prefix = (prefix << (top - shift)) | misc[32];
    krem -= (int)misc[33];
    top = shift;
  }
  const uint32_t T = lo + prefix;
  const int need = krem, n_below = k - krem;  // keys equal to T to keep; keys below T

  // 3. compaction in index order: warp w takes columns [c0, c1)
  const int seg = ((N + SELECT_WARPS - 1) / SELECT_WARPS + 31) / 32 * 32;
  const int c0 = min(N, warp * seg), c1 = min(N, c0 + seg);
  int below = 0, equal = 0;
  for (int base = c0; base < c1; base += 32) {
    const bool in = base + lane < c1;
    const uint32_t key = in ? key_at(base + lane) : 0u;
    below += __popc(__ballot_sync(FULL_MASK, in && key < T));
    equal += __popc(__ballot_sync(FULL_MASK, in && key == T));
  }
  if (lane == 0) {
    misc[64 + warp] = below;
    misc[64 + SELECT_WARPS + warp] = equal;
  }
  __syncthreads();
  int nb = 0, ne = 0;  // this warp's first slots among the keys below T and equal to it
  for (int w = 0; w < warp; ++w) {
    nb += misc[64 + w];
    ne += misc[64 + SELECT_WARPS + w];
  }
  unsigned long long* out_g = sort_g + r * 2 * (size_t)k;
  auto put = [&](int pos, uint32_t key, int c) {
    const unsigned long long v = ((unsigned long long)key << 32) | (uint32_t)c;
    if (sort_shared) sorted[pos] = v; else out_g[pos] = v;
  };
  const int nb_end = nb + below, ne_end = min(need, ne + equal);
  for (int base = c0; base < c1 && (nb < nb_end || ne < ne_end); base += 32) {
    const bool in = base + lane < c1;
    const uint32_t key = in ? key_at(base + lane) : 0u;
    const unsigned mb = __ballot_sync(FULL_MASK, in && key < T);
    const unsigned me = __ballot_sync(FULL_MASK, in && key == T);
    if (in && key < T) {
      put(nb + __popc(mb & lt), key, base + lane);
    } else if (in && key == T) {
      const int q = ne + __popc(me & lt);
      if (q < need) put(n_below + q, key, base + lane);
    }
    nb += __popc(mb);
    ne += __popc(me);
  }
  __syncthreads();

  // 4. the survivors in (key, index) order
  float* ov = vals + r * k;
  int* oi = idx + r * k;
  if (sort_shared) {
    for (int i = k + tid; i < kp; i += SELECT_THREADS) sorted[i] = ~0ull;
    __syncthreads();
    for (int size = 2; size <= kp; size <<= 1)
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        for (int i = tid; i < kp / 2; i += SELECT_THREADS) {
          const int a = 2 * i - (i & (stride - 1)), b = a + stride;
          const unsigned long long x = sorted[a], y = sorted[b];
          if ((x > y) == ((a & size) == 0)) { sorted[a] = y; sorted[b] = x; }
        }
        __syncthreads();
      }
    for (int j = tid; j < k; j += SELECT_THREADS) {
      const int c = (int)(uint32_t)sorted[j];
      oi[j] = c;
      ov[j] = row[c];
    }
    return;
  }
  // stable LSD passes over the survivors' key - lo (all within [0, T - lo]);
  // a tile of SELECT_THREADS survivors at a time: lanes of one digit ranked
  // by __match_any_sync, warps by a scan over tables[tile % 2] (the other
  // table zeroed meanwhile), tiles by run[]
  const uint32_t span = T - lo;
  const int sbits = span ? 32 - __clz(span) : 0;
  uint32_t* run = misc + 256;
  unsigned long long* src = out_g;
  unsigned long long* dst = out_g + k;
  for (int shift = 0; shift < sbits; shift += 8) {
    const bool last = shift + 8 >= sbits;
    for (int i = tid; i < k; i += SELECT_THREADS)
      atomicAdd(&h[(((uint32_t)(src[i] >> 32) - lo) >> shift) & 0xff], 1u);
    __syncthreads();
    uint32_t excl, incl;
    scan_bins(hist, misc, excl, incl);
    if (tid < SELECT_BINS) run[tid] = excl;
    __syncthreads();
    int tb = 0;
    for (int t0 = 0; t0 < k; t0 += SELECT_THREADS, tb ^= 1) {
      const int i = t0 + tid;
      const bool in = i < k;
      const unsigned long long v = in ? src[i] : 0ull;
      const int d = in ? (int)((((uint32_t)(v >> 32) - lo) >> shift) & 0xff) : SELECT_BINS;
      const unsigned peers = __match_any_sync(FULL_MASK, d);
      uint32_t* cur = hist + tb * SELECT_WARPS * SELECT_BINS;
      uint32_t* nxt = hist + (tb ^ 1) * SELECT_WARPS * SELECT_BINS;
      if (in && lane == __ffs(peers) - 1) cur[warp * SELECT_BINS + d] = __popc(peers);
      __syncthreads();
      if (tid < SELECT_BINS) {
        uint32_t s = run[tid];
        for (int w = 0; w < SELECT_WARPS; ++w) {
          const uint32_t n = cur[w * SELECT_BINS + tid];
          cur[w * SELECT_BINS + tid] = s;
          s += n;
          nxt[w * SELECT_BINS + tid] = 0;
        }
        run[tid] = s;
      }
      __syncthreads();
      if (in) {
        const int pos = cur[warp * SELECT_BINS + d] + __popc(peers & lt);
        if (last) {
          const int c = (int)(uint32_t)v;
          oi[pos] = c;
          ov[pos] = row[c];
        } else {
          dst[pos] = v;
        }
      }
    }
    __syncthreads();
    for (int i = tid; i < 2 * SELECT_WARPS * SELECT_BINS; i += SELECT_THREADS) hist[i] = 0;
    __syncthreads();
    unsigned long long* t = src;
    src = dst;
    dst = t;
  }
  if (sbits == 0)  // every survivor has key T: index order is the order
    for (int j = tid; j < k; j += SELECT_THREADS) {
      const int c = (int)(uint32_t)src[j];
      oi[j] = c;
      ov[j] = row[c];
    }
}

// One launch of the selection over rows [0, B) of dist [B, N].
cudaError_t select_rows(const float* dist, int B, int N, int k, int row_shared, int sort_shared,
                        int sel_smem, float* vals, int* idx, unsigned long long* sort_g,
                        cudaStream_t s) {
  const cudaError_t err = cudaFuncSetAttribute(
      radix_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, sel_smem);
  if (err != cudaSuccess) return err;
  radix_select_kernel<<<B, SELECT_THREADS, sel_smem, s>>>(dist, N, k, row_shared, sort_shared,
                                                          vals, idx, sort_g);
  return cudaGetLastError();
}

// The selection's arguments as the wrapper's plan gives them
bool select_args_ok(int N, int k, int row_shared, int sort_shared, int sel_smem) {
  return k >= 1 && k <= N && (!sort_shared || pow2_at_least(k) <= SELECT_SORT_MAX) &&
         (size_t)sel_smem == select_smem(N, k, row_shared, sort_shared) &&
         sel_smem <= X_SMEM_MAX;
}

// x_regs_of of one build of the wide sweep, read at its first launch
template <int KC>
int topk_wide_regs() {
  static const int code = x_regs_of(topk_wide_kernel<KC>);
  return code;
}

// One launch of the wide sweep over z rows [0, B) (pointers at the rows'
// hi / lo / |z|^2), once its build has the registers its split needs.
template <int KC>
cudaError_t sweep_wide(const float* zh, const float* zl, const float* zq, const float* eh,
                       const float* el, const float* eq, int B, int N, int DP, int k,
                       int splits, int tiles_per_split, int smem, float* out_v, int* out_i,
                       float* dist, cudaStream_t s) {
  const int regs = topk_wide_regs<KC>();
  if (regs != cudaSuccess) return (cudaError_t)regs;
  const cudaError_t err = cudaFuncSetAttribute(
      topk_wide_kernel<KC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  topk_wide_kernel<KC><<<dim3((B + KW_TB - 1) / KW_TB, splits), KW_THREADS, smem, s>>>(
      zh, zl, zq, eh, el, eq, B, N, DP, k, tiles_per_split, out_v, out_i, dist);
  return cudaGetLastError();
}

cudaError_t launch_wide(const float* z, const float* e, int B, int N, int D, int DP, int k,
                        int splits, int tiles_per_split, int rows, int smem, int row_shared,
                        int sort_shared, int sel_smem, float* scratch, float* part_v,
                        int* part_i, float* vals, int* idx, cudaStream_t s) {
  float* zh = scratch;
  float* zl = zh + (size_t)B * DP;
  float* eh = zl + (size_t)B * DP;
  float* el = eh + (size_t)N * DP;
  float* eq = el + (size_t)N * DP;
  float* zq = eq + N + 1;
  float* dist = zq + B;
  wide_split_kernel<<<(B + N + SPLIT_ROWS - 1) / SPLIT_ROWS, SPLIT_THREADS, 0, s>>>(
      z, B, e, N, D, DP, zh, zl, zq, eh, el, eq);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (k > KW_CAP) {  // the distances of `rows` z rows at a time, then the selection
    // the global sort's [rows, 2, k] survivors after the distances, 8-byte aligned
    unsigned long long* sort_g = reinterpret_cast<unsigned long long*>(
        (reinterpret_cast<uintptr_t>(dist + (size_t)rows * N) + 7) & ~(uintptr_t)7);
    for (int r0 = 0; r0 < B && err == cudaSuccess; r0 += rows) {
      const int nr = min(rows, B - r0);
      const size_t zo = (size_t)r0 * DP;
      err = sweep_wide<0>(zh + zo, zl + zo, zq + r0, eh, el, eq, nr, N, DP, k, splits,
                          tiles_per_split, smem, nullptr, nullptr, dist, s);
      if (err != cudaSuccess) return err;
      err = select_rows(dist, nr, N, k, row_shared, sort_shared, sel_smem,
                        vals + (size_t)r0 * k, idx + (size_t)r0 * k, sort_g, s);
    }
    return err;
  }
  const bool direct = splits == 1;  // one split: the sweep writes the result
  float* ov = direct ? vals : part_v;
  int* oi = direct ? idx : part_i;
  err = k <= 8 ? sweep_wide<8>(zh, zl, zq, eh, el, eq, B, N, DP, k, splits, tiles_per_split,
                               smem, ov, oi, nullptr, s)
               : sweep_wide<KW_CAP>(zh, zl, zq, eh, el, eq, B, N, DP, k, splits,
                                    tiles_per_split, smem, ov, oi, nullptr, s);
  if (err != cudaSuccess || direct) return err;
  const dim3 grid((B + MERGE_THREADS - 1) / MERGE_THREADS);
  if (k <= 8)
    topk_merge_kernel<8><<<grid, MERGE_THREADS, 0, s>>>(part_v, part_i, B, splits, k, vals, idx);
  else
    topk_merge_kernel<KW_CAP><<<grid, MERGE_THREADS, 0, s>>>(part_v, part_i, B, splits, k, vals,
                                                              idx);
  return cudaGetLastError();
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
// [B, dim] and e [N, dim] fp32 row-major, any dim >= 1 and 1 <= k <= N, by
// the wrapper's plan: dp = dim rounded up to a multiple of 32, `splits`
// splits of `tiles_per_split` 128-row codebook tiles (every tile in one),
// `smem` bytes of dynamic shared memory for the sweep (at least its
// stages', at most 232,448). For k above 16 also `rows` z rows a distance
// chunk and the selection's route: row_shared (the row's keys in shared
// memory), sort_shared (the survivors sorted there; k rounded up to a power
// of 2 at most 4,096) and sel_smem bytes, select_smem's count for them.
// scratch holds 2 (B + N) dp + B + N + 1 floats, for k above 16 rows * N
// more, and without sort_shared 2 + 4 * rows * k more; part_v / part_i hold
// [splits, B, k] (unused for one split or k above 16); vals / idx receive
// [B, k].
extern "C" int medtok_topk_l2_wide(const void* z, const void* e, int B, int N, int dim, int dp,
                                   int k, int splits, int tiles_per_split, int rows, int smem,
                                   int row_shared, int sort_shared, int sel_smem,
                                   void* scratch, void* part_v, void* part_i, void* vals,
                                   void* idx, void* stream) {
  if (B <= 0 || N <= 0 || dim <= 0 || dp < dim || dp % KW_DC || dp - dim >= KW_DC || k < 1 ||
      k > N || splits < 1 || splits > 65535 || tiles_per_split < 1 ||
      (long long)(splits - 1) * tiles_per_split * KW_TN >= N ||
      (long long)splits * tiles_per_split * KW_TN < N ||
      smem < (long long)topk_wide_smem() || smem > X_SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  if (k > KW_CAP && (rows < 1 || !select_args_ok(N, k, row_shared, sort_shared, sel_smem)))
    return (int)cudaErrorInvalidValue;
  return (int)launch_wide(static_cast<const float*>(z), static_cast<const float*>(e), B, N, dim,
                          dp, k, splits, tiles_per_split, rows, smem, row_shared, sort_shared,
                          sel_smem, static_cast<float*>(scratch),
                          static_cast<float*>(part_v), static_cast<int*>(part_i),
                          static_cast<float*>(vals), static_cast<int*>(idx),
                          static_cast<cudaStream_t>(stream));
}

// The selection alone: the k smallest of each row of dist [B, N] fp32 by
// (value, index), by the wrapper's plan (row_shared, sort_shared, sel_smem
// as for medtok_topk_l2_wide); sort_scratch holds B * 2 * k 8-byte words
// (8-byte aligned; unused with sort_shared); vals / idx receive [B, k].
extern "C" int medtok_topk_select(const void* dist, int B, int N, int k, int row_shared,
                                  int sort_shared, int sel_smem, void* sort_scratch, void* vals,
                                  void* idx, void* stream) {
  if (B <= 0 || !select_args_ok(N, k, row_shared, sort_shared, sel_smem) ||
      (!sort_shared && reinterpret_cast<uintptr_t>(sort_scratch) % 8))
    return (int)cudaErrorInvalidValue;
  return (int)select_rows(static_cast<const float*>(dist), B, N, k, row_shared, sort_shared,
                          sel_smem, static_cast<float*>(vals), static_cast<int*>(idx),
                          static_cast<unsigned long long*>(sort_scratch),
                          static_cast<cudaStream_t>(stream));
}
