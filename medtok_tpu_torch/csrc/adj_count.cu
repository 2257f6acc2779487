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
// Both run in two launches. Launch 1, shared (adj_bucket_kernel): a stable
// counting sort of each graph's kept edges by 128 x 128 Count tile into
// scratch from the wrapper. Launch 2 gives each (graph, tile) one block,
// which reads only its tile's edges: K5 adds them on the CUDA cores into an
// fp32 tile in shared memory (adj_count_tile_kernel), K5-lane multiplies
// their one-hots on the tensor cores (adj_count_onehot_kernel).
//
// Determinism: every Count cell is summed in a fixed order, by fp32 adds
// in edge order (K5) or by one lane's mma sequence (K5-lane), and no atomic
// decides where an edge goes or the order of a sum (the pre-pass counts
// with shared atomics; a count does not depend on the order of its adds).
// So K5's Count is bit for bit the sequential fp32 sum of the bf16
// weights. Products of 0/1 with a bf16 weight are exact, and
// integer sums below 2^24 are exact, so binary weights give the exact
// histogram in both.
//
// Bound at the Ln=512 tail shape (B=512, Epg=8192): the function reads 50 MB
// of edges, writes 537 MB of Count and does one add per edge, so bytes bound
// it at about 0.175 ms at 3.35 TB/s, for both kernels (K5-lane's section
// has its product count).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "mma_bf16.cuh"

namespace {

// ------------------------------------------- launch 1 of both: the buckets
//
// adj_bucket_kernel, one block per graph: a stable counting sort of the
// graph's kept edges by TI x TJ Count tile into `lists` (B * Epg entries,
// from the wrapper) with each tile's start in `offsets` ([B, tiles + 1]). An
// edge is kept when bf16(w) != 0 and both ends lie in [0, Ln) (an index
// outside matches no one-hot row, as in the TPU kernels; dropping a zero
// weight drops exact zeros) and is packed into 4 bytes: bf16 weight << 16 |
// src % TJ << 8 | dst % TI. Warp w of 16 takes the w-th sixteenth of the
// slots, so a tile's list is warp 0's edges, then warp 1's, ...: edge order.
// A first pass counts each warp's edges by tile (shared atomicAdd: a count
// does not depend on the order of its adds), a prefix over (tile, warp)
// gives each its start, a second pass writes them; within a warp,
// __match_any_sync and a popc rank the lanes of one tile. Up to
// BUCKET_TILES tiles are counted per pass pair (Ln <= 2816 takes one). No
// atomic claims a slot: a list position is the edge's rank in edge order.

constexpr int TI = 128;                          // Count rows per tile
constexpr int TJ = 128;                          // Count columns per tile
constexpr int BUCKET_WARPS = 16;                 // a graph's slots in 16 runs
constexpr int BUCKET_THREADS = 32 * BUCKET_WARPS;
constexpr int BUCKET_TILES = 512;                // tiles counted per pass pair
constexpr int BUCKET_ROUNDS = 16;                // rounds of 32 slots in flight

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

__global__ void __launch_bounds__(BUCKET_THREADS)
adj_bucket_kernel(const int* __restrict__ src, const int* __restrict__ dst,
                  const float* __restrict__ w, uint32_t* __restrict__ lists,
                  int* __restrict__ offsets, int Ln, int Epg, int tiles_j, int tiles) {
  __shared__ int cur[BUCKET_WARPS][BUCKET_TILES];  // counts, then write positions
  __shared__ int part[BUCKET_WARPS];

  const int b = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const unsigned lt = lanemask_lt();
  const size_t e0 = (size_t)b * Epg;
  const int seg = (Epg + BUCKET_WARPS - 1) / BUCKET_WARPS;
  const int s0 = min(warp * seg, Epg), s1 = min(s0 + seg, Epg);  // this warp's slots
  int* off = offsets + (size_t)b * (tiles + 1);

  int base = 0;  // kept edges of the earlier tile groups
  for (int g0 = 0; g0 < tiles; g0 += BUCKET_TILES) {
    const int ng = min(BUCKET_TILES, tiles - g0);
    for (int x = threadIdx.x; x < BUCKET_WARPS * BUCKET_TILES; x += BUCKET_THREADS)
      cur[x / BUCKET_TILES][x % BUCKET_TILES] = 0;
    __syncthreads();
    for (int pass = 0; pass < 2; ++pass) {  // 0 counts, 1 writes
      for (int x0 = s0; x0 < s1; x0 += 32 * BUCKET_ROUNDS) {
        int sv[BUCKET_ROUNDS], dv[BUCKET_ROUNDS];
        float wv[BUCKET_ROUNDS];
#pragma unroll
        for (int r = 0; r < BUCKET_ROUNDS; ++r) {  // every load in flight at once
          const size_t e = e0 + min(x0 + r * 32 + lane, s1 - 1);
          sv[r] = src[e];
          dv[r] = dst[e];
          wv[r] = w[e];
        }
#pragma unroll
        for (int r = 0; r < BUCKET_ROUNDS; ++r) {
          const uint32_t wb = __bfloat16_as_ushort(__float2bfloat16(wv[r]));
          const unsigned s = sv[r], d = dv[r];
          int key = -1;  // this group's tile of a kept edge
          if (x0 + r * 32 + lane < s1 && s < (unsigned)Ln && d < (unsigned)Ln &&
              (wb & 0x7FFFu) != 0) {
            const int tile = (int)(d / TI) * tiles_j + (int)(s / TJ) - g0;
            if (tile >= 0 && tile < ng) key = tile;
          }
          if (pass == 0) {  // a count: the order of the adds does not matter
            if (key >= 0) atomicAdd(&cur[warp][key], 1);
            continue;
          }
          // pass 1: the lanes of this tile, ranked below this lane
          const unsigned same = __match_any_sync(FULL_MASK, key);
          const int c = key >= 0 ? cur[warp][key] : 0;
          __syncwarp();
          if (key >= 0 && lane == __ffs(same) - 1) cur[warp][key] = c + __popc(same);
          __syncwarp();
          if (key >= 0)
            lists[e0 + c + __popc(same & lt)] = wb << 16 | (s % TJ) << 8 | (d % TI);
        }
      }
      if (pass == 1) break;
      // write positions: over tiles, then over warps within a tile
      __syncthreads();
      constexpr int PER = BUCKET_TILES / BUCKET_THREADS;  // tiles a thread
      int tot[PER], sum = 0;
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int t = threadIdx.x * PER + k;
        int run = 0;
#pragma unroll
        for (int x = 0; x < BUCKET_WARPS; ++x) {
          const int c = cur[x][t];
          cur[x][t] = run;
          run += c;
        }
        tot[k] = run;
        sum += run;
      }
      int incl = sum;  // inclusive scan of the threads' sums within the warp
#pragma unroll
      for (int d = 1; d < 32; d *= 2) {
        const int v = __shfl_up_sync(FULL_MASK, incl, d);
        if (lane >= d) incl += v;
      }
      if (lane == 31) part[warp] = incl;
      __syncthreads();
      int start = base + incl - sum, total = 0;
#pragma unroll
      for (int x = 0; x < BUCKET_WARPS; ++x) {
        start += x < warp ? part[x] : 0;
        total += part[x];
      }
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int t = threadIdx.x * PER + k;
#pragma unroll
        for (int x = 0; x < BUCKET_WARPS; ++x) cur[x][t] += start;
        if (t < ng) off[g0 + t] = start;
        start += tot[k];
      }
      base += total;
      __syncthreads();
    }
    __syncthreads();  // the positions are used before the next group resets them
  }
  if (threadIdx.x == 0) off[tiles] = base;
}

// ------------------------------------------------------------ K5: CUDA cores
//
// adj_count_tile_kernel, one block of COUNT_WARPS warps per (graph, tile), a
// graph's tiles neighbours in the grid. The block zeroes an fp32 TI x TJ
// tile in shared memory and copies its tile's list in parts of COUNT_CHUNK
// entries (the first part's loads are issued before the zeroing). Warp w
// owns tile rows COUNT_ROWS * w .. + COUNT_ROWS: it takes each part 32
// entries at a time, a lane an entry, groups the lanes whose entries lie in
// its rows by cell (__match_any_sync), and each group's first lane adds the
// group's bf16 weights to the cell in lane order. Rounds follow one another
// (__syncwarp), so every cell is a sequence of fp32 adds in edge order, one
// add per kept edge; no atomics, and nothing is read back from Count. A
// warp then writes its own rows once, whole, with evict-first stores: a
// lane 4 columns as float4, or the columns lane + 32k as floats where a row
// is not 16-byte aligned (Ln % 4 != 0), masked at the ragged edge. A tile
// with no kept edge writes zeros and stages nothing.
//
// The 64 KB tile allows 3 blocks an SM. A lane takes an entry, not a row:
// with a thread per row walking every entry, the walk's latency kept the
// stores below the card's write rate (PERF.md's K5 step table).

constexpr int COUNT_WARPS = 8;
constexpr int COUNT_THREADS = 32 * COUNT_WARPS;
constexpr int COUNT_ROWS = TI / COUNT_WARPS;     // tile rows a warp owns
constexpr int COUNT_CHUNK = 2048;                // list entries a part
constexpr int COUNT_ROUNDS = COUNT_CHUNK / COUNT_THREADS;
constexpr uint32_t NO_ROW = 0xFFu;               // a lane past the part: dst 255 is no row
constexpr size_t COUNT_SMEM = sizeof(float) * TI * TJ + sizeof(uint32_t) * COUNT_CHUNK;

__global__ void __launch_bounds__(COUNT_THREADS, 3)
adj_count_tile_kernel(const uint32_t* __restrict__ lists, const int* __restrict__ offsets,
                      float* __restrict__ out, int Ln, int Epg, int tiles_j, int tiles) {
  extern __shared__ __align__(16) float count_smem[];
  float* tile = count_smem;                                          // [TI][TJ]
  uint32_t* part = reinterpret_cast<uint32_t*>(count_smem + TI * TJ);  // [COUNT_CHUNK]

  const int b = blockIdx.x / tiles, t = blockIdx.x % tiles;
  const int i0 = (t / tiles_j) * TI, j0 = (t % tiles_j) * TJ;
  const int r = threadIdx.x, warp = r / 32, lane = r % 32;
  const int* off = offsets + (size_t)b * (tiles + 1);
  const int first = off[t], len = off[t + 1] - first;
  const uint32_t* edges = lists + (size_t)b * Epg + first;  // this tile's list

  for (int c0 = 0; c0 < len; c0 += COUNT_CHUNK) {
    // 1. the part's entries, every load in flight at once
    const int m = min(COUNT_CHUNK, len - c0);
    uint32_t v[COUNT_ROUNDS];
#pragma unroll
    for (int k = 0; k < COUNT_ROUNDS; ++k)
      v[k] = edges[c0 + min(k * COUNT_THREADS + r, m - 1)];
    if (c0 == 0) {
      float4* t4 = reinterpret_cast<float4*>(tile);
      for (int x = r; x < TI * TJ / 4; x += COUNT_THREADS)
        t4[x] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncthreads();  // the previous part's walk is done
#pragma unroll
    for (int k = 0; k < COUNT_ROUNDS; ++k) {
      const int x = k * COUNT_THREADS + r;
      if (x < m) part[x] = v[k];
    }
    __syncthreads();  // the part and, first, the zeroed tile are complete
    // 2. the walk: 32 entries a round; the first lane of each group of one
    // cell in this warp's rows adds the group's weights in lane order
    for (int x0 = 0; x0 < m; x0 += 32) {
      const uint32_t en = x0 + lane < m ? part[x0 + lane] : NO_ROW;
      const bool in = (en & 0xFFu) / COUNT_ROWS == (uint32_t)warp;
      const unsigned same = __match_any_sync(FULL_MASK, in ? (en & 0xFFFFu) : 0xFFFFFFFFu);
      if (in && lane == __ffs(same) - 1) {
        float* cell = tile + (en & 0xFFu) * TJ + (en >> 8 & 0xFFu);
        float sum = *cell;
        for (unsigned g = same; g; g &= g - 1)
          sum += __uint_as_float(part[x0 + __ffs(g) - 1] & 0xFFFF0000u);
        *cell = sum;
      }
      __syncwarp();  // this round's sums are seen by the next round's lanes
    }
  }

  // 3. epilogue: the warp's own rows, whole, as soon as its walk is done
  // (no other warp adds to them), masked at the ragged edge
  const bool vec = (Ln & 3) == 0;
  for (int i = warp * COUNT_ROWS; i < min((warp + 1) * COUNT_ROWS, Ln - i0); ++i) {
    float* orow = out + ((size_t)b * Ln + i0 + i) * Ln + j0;
    const float* trow = tile + i * TJ;
    if (vec) {  // j0 and Ln are multiples of 4: a lane's 4 columns are all in or all out
      const int c = 4 * lane;
      if (j0 + c < Ln)
        __stcs(reinterpret_cast<float4*>(orow + c),
               len ? *reinterpret_cast<const float4*>(trow + c) : make_float4(0.f, 0.f, 0.f, 0.f));
    } else {
#pragma unroll
      for (int k = 0; k < TJ / 32; ++k) {
        const int c = lane + 32 * k;
        if (j0 + c < Ln) __stcs(orow + c, len ? trow[c] : 0.f);
      }
    }
  }
}

// ------------------------------------------------------- K5-lane: tensor cores
//
// Per graph, Count = D^T S with D[e, i] = bf16(w_e) 1[dst_e = i] and
// S[e, j] = 1[src_e = j]. An edge lands in one Count tile, so K5-lane
// multiplies each edge only there. adj_count_onehot_kernel, one block per
// (graph, tile): the block copies its tile's list into shared memory,
// LANE_CHUNK entries at a time, and when the list may not take another
// copy, or at the end, sorts it stably by 16-row slab (dst % TI >> 4) into
// `sorted`, each slab's run padded with zero entries to a multiple of 16
// (ballot ranks: the order within a slab stays the edge order). Warp w owns
// slab w: Count rows i0 + 16w .. +16, TJ / 2 columns at a time (8 fp32
// m16n8k16 accumulators). For each 16 entries of its run, lane (g, t) reads
// entries 2t, 2t+1, 2t+8, 2t+9 and builds the bf16 fragments in registers:
// A[row, k] = (dst_k & 15) == row ? w_k : 0 for rows g and g+8, B[k, col] =
// src_k == col ? 1 : 0 for column g of each 8-column fragment (a bit per
// fragment, then one multiply by bf16 1.0). No one-hot tile is stored and no
// ldmatrix is needed. Each lane writes its accumulators once as float2, a
// full 32-byte sector a row and fragment, with evict-first stores, masked at
// the ragged edge. A tile with no edge runs no product and writes zeros. A
// tile whose list is sorted more than once reads its sums so far back from
// Count.
//
// The products are 2 * 16 * TJ FLOP per padded kept edge, 15 GFLOP at the
// Ln=512 tail shape (0.015 ms at the bf16 peak), against 2 * Ln * Ln per
// edge (1.6 TFLOP) when every tile multiplies every edge. A Count cell is
// summed by one lane's fixed mma sequence, and a later sort's products add
// to the stored sums in the same order: two launches give the same bits.

constexpr int LANE_WARPS = TI / 16;              // one warp per 16-row slab
constexpr int LANE_THREADS = 32 * LANE_WARPS;
constexpr int LANE_CHUNK = 2048;                 // list entries a copy step
constexpr int LANE_ROUNDS = LANE_CHUNK / LANE_THREADS;
constexpr int LIST_CAP = 2 * LANE_CHUNK;         // entries held before a sort
constexpr int SORT_CAP = LIST_CAP + 15 * LANE_WARPS;
constexpr int HALF = TJ / 16;                    // 8-column fragments in TJ / 2
constexpr uint32_t BF16_ONE = 0x3F80u;

// A values of entries lo (k) and hi (k+1) in row `row` of their slab
__device__ __forceinline__ uint32_t a_pair(uint32_t lo, uint32_t hi, uint32_t row) {
  return ((lo & 15u) == row ? lo >> 16 : 0u) | ((hi & 15u) == row ? hi & 0xFFFF0000u : 0u);
}

// 1 << f when the entry's column is column 8f + g of a half, where cb is
// the half's first column plus g; else 0
__device__ __forceinline__ uint32_t frag_bit(uint32_t en, uint32_t cb) {
  const uint32_t u = (en >> 8 & 0xFFu) - cb;
  return (u & 7u) == 0 && u < 8u * HALF ? 1u << (u >> 3) : 0u;
}

__device__ __forceinline__ void store2(float* out, size_t row_base, int c, int Ln,
                                       bool vec, float x, float y) {
  float* p = out + row_base + c;
  if (vec && c + 1 < Ln) {
    __stcs(reinterpret_cast<float2*>(p), make_float2(x, y));
  } else {
    if (c < Ln) __stcs(p, x);
    if (c + 1 < Ln) __stcs(p + 1, y);
  }
}

// what store2 wrote there (0 where it wrote nothing)
__device__ __forceinline__ float2 load2(const float* out, size_t row_base, int c, int Ln,
                                        bool vec) {
  const float* p = out + row_base + c;
  if (vec && c + 1 < Ln) return *reinterpret_cast<const float2*>(p);
  return make_float2(c < Ln ? p[0] : 0.f, c + 1 < Ln ? p[1] : 0.f);
}

__global__ void __launch_bounds__(LANE_THREADS, 4)
adj_count_onehot_kernel(const uint32_t* __restrict__ lists, const int* __restrict__ offsets,
                        float* __restrict__ out, int Ln, int Epg, int tiles_j, int tiles) {
  __shared__ __align__(16) uint32_t list[LIST_CAP];
  __shared__ __align__(16) uint32_t sorted[SORT_CAP];
  __shared__ int slab_cnt[LANE_WARPS];

  const int b = blockIdx.x / tiles, tile = blockIdx.x % tiles;
  const int i0 = (tile / tiles_j) * TI, j0 = (tile % tiles_j) * TJ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const unsigned lt = lanemask_lt();
  // this lane's Count rows: i0 + 16 warp + g (+ 8); columns j0 + 8f + 2t (+ 1)
  const uint32_t g = lane / 4, t = lane % 4;
  const int r_lo = i0 + 16 * warp + g, r_hi = r_lo + 8;
  const size_t row_lo = ((size_t)b * Ln + r_lo) * Ln, row_hi = ((size_t)b * Ln + r_hi) * Ln;
  const bool vec = (Ln & 1) == 0;

  const int* off = offsets + (size_t)b * (tiles + 1);
  const int first = off[tile], len = off[tile + 1] - first;
  const uint32_t* edges = lists + (size_t)b * Epg + first;  // this tile's list
  int n = 0;             // entries in `list`, the same in every thread
  bool written = false;  // this tile's Count holds the sums of earlier sorts
  for (int c0 = 0; c0 < len; c0 += LANE_CHUNK) {
    // 1. copy the next entries of the tile's list, every load in flight
    const int m = min(LANE_CHUNK, len - c0);
    uint32_t v[LANE_ROUNDS];
#pragma unroll
    for (int k = 0; k < LANE_ROUNDS; ++k)
      v[k] = edges[c0 + min(k * LANE_THREADS + (int)threadIdx.x, m - 1)];
#pragma unroll
    for (int k = 0; k < LANE_ROUNDS; ++k) {
      const int x = k * LANE_THREADS + threadIdx.x;
      if (x < m) list[n + x] = v[k];
    }
    n += m;
    if (n <= LIST_CAP - LANE_CHUNK && c0 + LANE_CHUNK < len) continue;

    // 2. sort the list stably by slab, each slab's run padded to 16
    __syncthreads();  // the list is complete
    const uint32_t mine = (uint32_t)warp;
    int my = 0;
    for (int x0 = 0; x0 < n; x0 += 32) {
      const int x = x0 + lane;
      my += __popc(__ballot_sync(FULL_MASK, x < n && (list[x] & 0xFFu) >> 4 == mine));
    }
    if (lane == 0) slab_cnt[warp] = my;
    __syncthreads();
    int run = 0;
#pragma unroll
    for (int x = 0; x < LANE_WARPS; ++x) run += x < warp ? (slab_cnt[x] + 15) & ~15 : 0;
    int p = run;
    for (int x0 = 0; x0 < n; x0 += 32) {
      const int x = x0 + lane;
      const uint32_t en = x < n ? list[x] : 0u;
      const unsigned sel = __ballot_sync(FULL_MASK, x < n && (en & 0xFFu) >> 4 == mine);
      if (sel >> lane & 1u) sorted[p + __popc(sel & lt)] = en;
      p += __popc(sel);
    }
    const int end = run + ((my + 15) & ~15);
    if (p + lane < end) sorted[p + lane] = 0u;  // zero weight: adds exact zeros
    __syncthreads();  // every warp is done with the list before the next copy

    // 3. products over this warp's run, its slab's rows by TJ / 2 columns
    // at a time; after an earlier sort, the sums so far come back from Count
#pragma unroll 1
    for (int h = 0; h < 2; ++h) {
      float acc[HALF][4];
#pragma unroll
      for (int f = 0; f < HALF; ++f) {
        const int c = j0 + 8 * HALF * h + 8 * f + 2 * t;
        const float2 lo = written && r_lo < Ln ? load2(out, row_lo, c, Ln, vec) : make_float2(0.f, 0.f);
        const float2 hi = written && r_hi < Ln ? load2(out, row_hi, c, Ln, vec) : make_float2(0.f, 0.f);
        acc[f][0] = lo.x, acc[f][1] = lo.y, acc[f][2] = hi.x, acc[f][3] = hi.y;
      }
      for (int k0 = run; k0 < end; k0 += 16) {
        const uint2 lo = *reinterpret_cast<const uint2*>(sorted + k0 + 2 * t);
        const uint2 hi = *reinterpret_cast<const uint2*>(sorted + k0 + 2 * t + 8);
        const uint32_t a[4] = {a_pair(lo.x, lo.y, g), a_pair(lo.x, lo.y, g + 8),
                               a_pair(hi.x, hi.y, g), a_pair(hi.x, hi.y, g + 8)};
        // bit f of m01 (m89) is set when entry 2t (2t+8) has this lane's
        // column of fragment f, bit 16 + f when entry 2t+1 (2t+9) has
        const uint32_t cb = 8 * HALF * h + g;
        const uint32_t m01 = frag_bit(lo.x, cb) | frag_bit(lo.y, cb) << 16;
        const uint32_t m89 = frag_bit(hi.x, cb) | frag_bit(hi.y, cb) << 16;
#pragma unroll
        for (int f = 0; f < HALF; ++f)
          mma_bf16(acc[f], a, (m01 >> f & 0x10001u) * BF16_ONE, (m89 >> f & 0x10001u) * BF16_ONE);
      }
      // 4. epilogue: float2 a lane, a full 32-byte sector a row and fragment
#pragma unroll
      for (int f = 0; f < HALF; ++f) {
        const int c = j0 + 8 * HALF * h + 8 * f + 2 * t;
        if (r_lo < Ln) store2(out, row_lo, c, Ln, vec, acc[f][0], acc[f][1]);
        if (r_hi < Ln) store2(out, row_hi, c, Ln, vec, acc[f][2], acc[f][3]);
      }
    }
    written = true;
    n = 0;
  }
  if (written) return;
  // a tile with no edge: zeros, no product
#pragma unroll
  for (int f = 0; f < 2 * HALF; ++f) {
    const int c = j0 + 8 * f + 2 * t;
    if (r_lo < Ln) store2(out, row_lo, c, Ln, vec, 0.f, 0.f);
    if (r_hi < Ln) store2(out, row_hi, c, Ln, vec, 0.f, 0.f);
  }
}

// shapes the launches take: at most 255 tiles a side (Ln <= 32640, the
// wrapper's limit)
bool bad_args(int B, int Ln, int Epg) {
  return B <= 0 || Ln <= 0 || Epg <= 0 || (Ln + TI - 1) / TI > 255;
}

int lane_tiles(int Ln) { return ((Ln + TI - 1) / TI) * ((Ln + TJ - 1) / TJ); }

// Launch 1 on `s`, then launch 2: `kernel`, one block of `threads` per
// (graph, tile) with `smem` bytes of dynamic shared memory (above 48 KB only
// after raising the kernel's limit). Returns the first error.
cudaError_t bucket_then(void (*kernel)(const uint32_t*, const int*, float*, int, int, int, int),
                        int threads, size_t smem, const void* src, const void* dst,
                        const void* w, void* out, void* lists, void* offsets, int B, int Ln,
                        int Epg, cudaStream_t s) {
  if (bad_args(B, Ln, Epg)) return cudaErrorInvalidValue;
  const int tiles_j = (Ln + TJ - 1) / TJ, tiles = lane_tiles(Ln);
  if ((long long)B * tiles > 0x7FFFFFFF) return cudaErrorInvalidValue;
  adj_bucket_kernel<<<B, BUCKET_THREADS, 0, s>>>(
      static_cast<const int*>(src), static_cast<const int*>(dst),
      static_cast<const float*>(w), static_cast<uint32_t*>(lists),
      static_cast<int*>(offsets), Ln, Epg, tiles_j, tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  // a graph's tiles are neighbours in the grid
  kernel<<<B * tiles, threads, smem, s>>>(static_cast<const uint32_t*>(lists),
                                          static_cast<const int*>(offsets),
                                          static_cast<float*>(out), Ln, Epg, tiles_j, tiles);
  return cudaGetLastError();
}

}  // namespace

// K5-lane's Count tiles per graph: the length of a graph's row of `offsets`
// is this plus one
extern "C" int medtok_adj_lane_tiles(int Ln) { return lane_tiles(Ln); }

// K5. src, dst: int32 [B*Epg]; w: fp32 [B*Epg]; out: fp32 [B, Ln, Ln],
// 16-byte aligned; scratch from the caller: lists int32 [B*Epg], offsets
// int32 [B * (medtok_adj_lane_tiles(Ln) + 1)]. Launches on `stream`;
// returns the first CUDA error, else 0.
extern "C" int medtok_adj_count(const void* src, const void* dst, const void* w, void* out,
                                void* lists, void* offsets, int B, int Ln, int Epg,
                                void* stream) {
  return (int)bucket_then(adj_count_tile_kernel, COUNT_THREADS, COUNT_SMEM, src, dst, w, out,
                          lists, offsets, B, Ln, Epg, static_cast<cudaStream_t>(stream));
}

// K5-lane. Arguments as K5.
extern "C" int medtok_adj_count_onehot(const void* src, const void* dst, const void* w,
                                       void* out, void* lists, void* offsets, int B, int Ln,
                                       int Epg, void* stream) {
  return (int)bucket_then(adj_count_onehot_kernel, LANE_THREADS, 0, src, dst, w, out, lists,
                          offsets, B, Ln, Epg, static_cast<cudaStream_t>(stream));
}
