// Kernels K2 and K4: block-diagonal (sequence-packed) attention, forward
// only, for Hopper (sm_90a).
//
// K2 replaces medtok_tpu/ops/flash_attention.py::packed_segment_attention
// (kernel _flash_seg_kernel): q, k, v, out are [B, H, L, Dh]. K4 replaces
// packed_segment_attention_nt (kernel _flash_seg_kernel_nt): the same
// attention with q, k, v, out in the projection layout [B, L, H, Dh]. Each
// kernel below is templated on the layout: element (b, h, i, d) sits at
// b*L*H*Dh + h*head_stride + i*row_stride + d, with (head, row) strides
// (L*Dh, Dh) for K2 and (Dh, H*Dh) for K4. Dh is contiguous in both, so a
// row is one run of 2*Dh (bf16) or 4*Dh (fp32) bytes. Each kernel is also
// templated on Dh and built at 16, 32, 64, 128 and 256 (bert-base: 64); the
// wrapper zero-pads any other width up to the next one, which changes no
// score and no kept column. seg is [B, L] int32.
// Query i of a row attends to key j iff seg_i == seg_j > 0; the scores
// q.k * sm_scale and the softmax run in fp32, and a query row with no valid
// key (padding) writes 0. As in the TPU kernel, bf16 probabilities are
// rounded to bf16 before the P.V product, while the row sum l is taken over
// the unrounded fp32 ones; keys are taken in blocks of 128 (the TPU kernel's
// block_k), each rounded against the running maximum of the blocks so far,
// so for L <= 128 that is the row's own maximum.
//
// Bound: at the packed BERT shape [256, 12, 128, 64] in bf16 the kernel must
// read q, k and v at the positions that hold a token (padding needs none of
// them) and write all of o, at most 4 x 50.3 MB per layer (about 60 us at
// 3.35 TB/s), while the block-diagonal products are at most 12.9 GFLOP
// (under 20 us on the bf16 tensor cores), so it is bound by bytes.
//
// bf16 design (segment_attention_mma_kernel). One block of 4 warps per
// (row b, head h, tile of 64 queries); a warp owns 16 queries. The products
// run on the tensor cores with mma.sync m16n8k16 (bf16 in, fp32 sums): Q's
// A-fragments are loaded once with ldmatrix and kept in registers, K comes in
// as the B operand with ldmatrix. The scores of a 128-key block are computed
// twice, first for the block's exact maximum (quad shuffles), then for P, so
// that only one 16-key group's scores are live in registers (keeping a whole
// block's spilled them); the second pass converts its fp32 fragments
// straight into the bf16 A-fragments of P.V (the rounding point above), with
// V loaded by ldmatrix.trans. Tile skipping: the keys come in groups of 16;
// a warp multiplies only the groups whose range of nonzero segment ids meets
// its queries' range (conservative, so exact for segments that are not
// contiguous), and the block stages only the groups that one of its warps
// needs, so a 64-query tile of a packed row reads about its own share of K
// and V, and a tile of padding reads nothing but its segment ids. Loads are
// 16-byte cp.async with zero fill past L into rows padded to Dh + 8 bf16,
// so ldmatrix is free of bank conflicts at every width; Q, K and V live in
// dynamic shared memory (46 KB a block at Dh = 64, 169 KB at Dh = 256).
// The key block is not double-buffered: at the packed shape (L = 128) it is
// the row's only one, and loads overlap products across the blocks resident
// on an SM instead. The output is staged
// through the warp's Q rows for coalesced 16-byte stores in either layout.
// No atomics on the data, so a launch is deterministic. wgmma, TMA and warp
// specialisation would speed up products that are not the bound here.
//
// fp32 path (segment_attention_fp32_kernel), the parity path: it needs exact
// fp32 products, which the bf16 tensor cores do not give. One block per (row
// b, head h, tile of 128 queries), one thread per query with its q row and
// fp32 accumulator in registers (at Dh = 256 they spill to local memory);
// keys and values stream through shared memory in tiles of 32 (16 at Dh =
// 256) and a thread skips keys of other segments.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "mma_bf16.cuh"

namespace {

constexpr float MASKED = -1e30f;  // the TPU kernel's finite stand-in for -inf

// ------------------------------------------------------------ fp32 path --

constexpr int QT = 128;   // queries per block (one per thread)

// keys per staged tile: two fp32 tiles of at most 32 KB
template <int DH>
__host__ __device__ constexpr int tk_rows() { return DH <= 128 ? 32 : 16; }

__device__ __forceinline__ void load8(const float* p, float* o) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}

__device__ __forceinline__ void store8(float* p, const float* o) {
  reinterpret_cast<float4*>(p)[0] = make_float4(o[0], o[1], o[2], o[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(o[4], o[5], o[6], o[7]);
}

// kBLHD: the [B, L, H, Dh] layout (K4); otherwise [B, H, L, Dh] (K2)
template <int DH, bool kBLHD>
__global__ void __launch_bounds__(QT)
segment_attention_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                              const float* __restrict__ v, const int* __restrict__ seg,
                              float* __restrict__ out, int H, int L, float sm_scale) {
  constexpr int TK = tk_rows<DH>();
  __shared__ __align__(16) float k_s[TK][DH];
  __shared__ __align__(16) float v_s[TK][DH];
  __shared__ int seg_s[TK];

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int qi = blockIdx.y * QT + threadIdx.x;
  const size_t row_stride = kBLHD ? (size_t)H * DH : (size_t)DH;
  const size_t head_stride = kBLHD ? (size_t)DH : (size_t)L * DH;
  const size_t base = (size_t)b * L * H * DH + (size_t)h * head_stride;
  const int* seg_row = seg + (size_t)b * L;
  const int my_seg = qi < L ? seg_row[qi] : 0;

  float qr[DH];
  float acc[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) { qr[d] = 0.f; acc[d] = 0.f; }
  if (qi < L) {
#pragma unroll
    for (int d = 0; d < DH; d += 8) load8(q + base + (size_t)qi * row_stride + d, qr + d);
  }
  float m = -INFINITY;
  float l = 0.f;

  for (int t0 = 0; t0 < L; t0 += TK) {
    __syncthreads();  // the previous tile is consumed
    for (int i = threadIdx.x; i < TK * DH / 8; i += QT) {
      const int j = i / (DH / 8), d = (i % (DH / 8)) * 8;
      float kb[8], vb[8];
      if (t0 + j < L) {
        load8(k + base + (size_t)(t0 + j) * row_stride + d, kb);
        load8(v + base + (size_t)(t0 + j) * row_stride + d, vb);
      } else {
#pragma unroll
        for (int x = 0; x < 8; ++x) { kb[x] = 0.f; vb[x] = 0.f; }
      }
      store8(&k_s[j][d], kb);
      store8(&v_s[j][d], vb);
    }
    if (threadIdx.x < TK)
      seg_s[threadIdx.x] = t0 + threadIdx.x < L ? seg_row[t0 + threadIdx.x] : 0;
    __syncthreads();

    if (my_seg > 0) {
      const int jn = min(TK, L - t0);
      for (int j = 0; j < jn; ++j) {
        if (seg_s[j] != my_seg) continue;
        float s = 0.f;
#pragma unroll
        for (int d = 0; d < DH; d += 4) {
          const float4 kk = *reinterpret_cast<const float4*>(&k_s[j][d]);
          s = fmaf(qr[d], kk.x, s);
          s = fmaf(qr[d + 1], kk.y, s);
          s = fmaf(qr[d + 2], kk.z, s);
          s = fmaf(qr[d + 3], kk.w, s);
        }
        s *= sm_scale;
        if (s > m) {
          const float a = expf(m - s);
          l *= a;
#pragma unroll
          for (int d = 0; d < DH; ++d) acc[d] *= a;
          m = s;
        }
        const float p = expf(s - m);
        l += p;
#pragma unroll
        for (int d = 0; d < DH; d += 4) {
          const float4 vv = *reinterpret_cast<const float4*>(&v_s[j][d]);
          acc[d] = fmaf(p, vv.x, acc[d]);
          acc[d + 1] = fmaf(p, vv.y, acc[d + 1]);
          acc[d + 2] = fmaf(p, vv.z, acc[d + 2]);
          acc[d + 3] = fmaf(p, vv.w, acc[d + 3]);
        }
      }
    }
  }

  if (qi < L) {
    const float denom = l == 0.f ? 1.f : l;  // no valid key: acc is 0
#pragma unroll
    for (int d = 0; d < DH; ++d) acc[d] = acc[d] / denom;
#pragma unroll
    for (int d = 0; d < DH; d += 8) store8(out + base + (size_t)qi * row_stride + d, acc + d);
  }
}

// ------------------------------------------------------------ bf16 path --

constexpr int WARPS = 4;
constexpr int BQ = 16 * WARPS;  // queries per block, 16 per warp
constexpr int KC = 128;         // keys per block of the online softmax
constexpr int GK = 16;          // keys per skip group (one P.V k-step)
constexpr int NG = KC / GK;     // skip groups per key block
constexpr unsigned FULL = FULL_MASK;

// dynamic shared memory of a block: Q (then the output), K and V in rows
// padded to DH + 8 bf16
template <int DH>
__host__ __device__ constexpr size_t mma_smem_bytes() {
  return (size_t)(BQ + 2 * KC) * (DH + 8) * 2;
}

// Fragment layout of m16n8k16: see mma_bf16.cuh. Up to Dh = 64 four blocks
// share an SM (at most 128 registers a thread); wider heads take more.
template <int DH, bool kBLHD>
__global__ void __launch_bounds__(32 * WARPS, DH <= 64 ? 4 : 1)
segment_attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v,
                             const int* __restrict__ seg,
                             __nv_bfloat16* __restrict__ out, int H, int L,
                             float sm_scale) {
  constexpr int SROW = DH + 8;    // padded shared-memory row, in bf16
  constexpr int CH = DH / 8;      // 16-byte chunks of a row
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem);  // [BQ * SROW]: Q, then the output
  __nv_bfloat16* k_s = q_s + BQ * SROW;       // [KC * SROW]
  __nv_bfloat16* v_s = k_s + KC * SROW;       // [KC * SROW]
  __shared__ int kseg_s[KC];
  __shared__ unsigned staged;  // key groups of this block's key block to load

  const int n_qt = (L + BQ - 1) / BQ;
  const int bh = blockIdx.x / n_qt;
  const int b = bh / H, h = bh % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = (blockIdx.x % n_qt) * BQ + warp * 16;  // the warp's first query
  const size_t row_stride = kBLHD ? (size_t)H * DH : (size_t)DH;
  const size_t head_stride = kBLHD ? (size_t)DH : (size_t)L * DH;
  const size_t base = (size_t)b * L * H * DH + (size_t)h * head_stride;
  const int* seg_row = seg + (size_t)b * L;
  __nv_bfloat16* q_w = q_s + warp * 16 * SROW;

  // the segment ids of the warp's queries and of the first key block, loaded
  // together; then the range [lo, hi] of the queries' nonzero ones
  const int my = (lane < 16 && q0 + lane < L) ? seg_row[q0 + lane] : 0;
  for (int j = threadIdx.x; j < KC; j += 32 * WARPS) kseg_s[j] = j < L ? seg_row[j] : 0;
  if (threadIdx.x == 0) staged = 0u;
  int lo = my > 0 ? my : INT_MAX, hi = my;
#pragma unroll
  for (int x = 16; x > 0; x >>= 1) {
    lo = min(lo, __shfl_xor_sync(FULL, lo, x));
    hi = max(hi, __shfl_xor_sync(FULL, hi, x));
  }
  const bool live = hi > 0;  // else every query is padding: the output is 0
  const int seg_r[2] = {__shfl_sync(FULL, my, g), __shfl_sync(FULL, my, g + 8)};

  if (live) {  // the warp's 16 Q rows, CH x 16 bytes each
    for (int i = lane; i < 16 * CH; i += 32) {
      const int r = i / CH, c = (i % CH) * 8, qi = q0 + r;
      cp_async16(q_w + r * SROW + c, q + base + (size_t)min(qi, L - 1) * row_stride + c,
                 qi < L);
    }
  }

  uint32_t qf[DH / 16][4];  // Q's A-fragments, one per 16-wide k-step
  float o[DH / 8][4];       // output accumulators, one tile per 8 dims
  float m_run[2] = {MASKED, MASKED}, l_run[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  for (int c0 = 0; c0 < L; c0 += KC) {
    if (c0 > 0) {
      __syncthreads();  // the previous key block is consumed
      for (int j = threadIdx.x; j < KC; j += 32 * WARPS)
        kseg_s[j] = c0 + j < L ? seg_row[c0 + j] : 0;
      if (threadIdx.x == 0) staged = 0u;
    }
    __syncthreads();

    // groups whose nonzero segment range meets the warp's: lane handles keys
    // 4*lane .. 4*lane+3 of group lane / 4
    int klo = INT_MAX, khi = 0;
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int s = kseg_s[4 * lane + x];
      if (s > 0) { klo = min(klo, s); khi = max(khi, s); }
    }
#pragma unroll
    for (int x = 1; x < 4; x <<= 1) {
      klo = min(klo, __shfl_xor_sync(FULL, klo, x));
      khi = max(khi, __shfl_xor_sync(FULL, khi, x));
    }
    const unsigned meet = __ballot_sync(FULL, live && klo <= hi && lo <= khi);
    unsigned groups = 0u;
#pragma unroll
    for (int grp = 0; grp < NG; ++grp) groups |= ((meet >> (4 * grp)) & 1u) << grp;
    if (lane == 0 && groups) atomicOr(&staged, groups);
    __syncthreads();

    const unsigned need = staged;
    for (int i = threadIdx.x; i < KC * CH; i += 32 * WARPS) {
      const int r = i / CH, c = (i % CH) * 8, kj = c0 + r;
      if (!((need >> (r / GK)) & 1u)) continue;
      const size_t off = base + (size_t)min(kj, L - 1) * row_stride + c;
      cp_async16(k_s + r * SROW + c, k + off, kj < L);
      cp_async16(v_s + r * SROW + c, v + off, kj < L);
    }
    cp_async_wait_all();  // this thread's copies (in the first block, its Q rows too)
    __syncthreads();

    if (c0 == 0 && live) {
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk)
        ldmatrix_x4(qf[kk], q_w + (lane & 15) * SROW + kk * 16 + (lane >> 4) * 8);
    }
    if (!groups) continue;  // warp-uniform: no key here meets the warp's queries

    // S = Q K^T of one 16-key group (two 8-key tiles), scaled, and -inf
    // (exp gives 0) where the pair is masked. Two passes recompute it, so
    // that only one group's scores are live: the first for the block
    // maximum, the second for P and P V. The tensor cores give the same bits
    // both times.
    auto scores = [&](int grp, float (&s)[2][4]) {
#pragma unroll
      for (int x = 0; x < 2; ++x)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[x][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        uint32_t kb[4];
        ldmatrix_x4(kb, k_s + (grp * GK + (lane & 7) + ((lane >> 4) << 3)) * SROW +
                            kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[0], qf[kk], kb[0], kb[1]);
        mma_bf16(s[1], qf[kk], kb[2], kb[3]);
      }
#pragma unroll
      for (int x = 0; x < 2; ++x)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int sr = seg_r[e >> 1];
          const bool valid = sr > 0 && kseg_s[grp * GK + 8 * x + 2 * t + (e & 1)] == sr;
          s[x][e] = valid ? s[x][e] * sm_scale : -INFINITY;
        }
    };

    float mx[2] = {MASKED, MASKED};
#pragma unroll
    for (int grp = 0; grp < NG; ++grp) {
      if (!((groups >> grp) & 1u)) continue;
      float s[2][4];
      scores(grp, s);
#pragma unroll
      for (int x = 0; x < 2; ++x)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[x][e]);
    }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 2));
      const float m_next = fmaxf(m_run[r], mx[r]);
      alpha[r] = expf(m_run[r] - m_next);
      m_run[r] = m_next;
    }
    if (c0 > 0) {
#pragma unroll
      for (int n = 0; n < DH / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e >> 1];
    }

    // P = exp(S - m) in fp32 for the row sums, rounded to bf16 for P V
#pragma unroll
    for (int grp = 0; grp < NG; ++grp) {
      if (!((groups >> grp) & 1u)) continue;
      float p[2][4];
      scores(grp, p);
#pragma unroll
      for (int x = 0; x < 2; ++x)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[x][e] = expf(p[x][e] - m_run[e >> 1]);
          rs[e >> 1] += p[x][e];
        }
      const uint32_t pa[4] = {pack_bf16(p[0][0], p[0][1]), pack_bf16(p[0][2], p[0][3]),
                              pack_bf16(p[1][0], p[1][1]), pack_bf16(p[1][2], p[1][3])};
#pragma unroll
      for (int dn = 0; dn < DH / 16; ++dn) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, v_s + (grp * GK + (lane & 7) + ((lane >> 3) & 1) * 8) * SROW +
                                  dn * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * dn], pa, vb[0], vb[1]);
        mma_bf16(o[2 * dn + 1], pa, vb[2], vb[3]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(FULL, rs[r], 1);
      rs[r] += __shfl_xor_sync(FULL, rs[r], 2);
      l_run[r] = l_run[r] * alpha[r] + rs[r];
    }
  }

  // O / l, staged in the warp's Q rows, then written as 16-byte row pieces.
  // A row with no valid key (l == 0) writes 0 without a division: a zero
  // numerator sends the IEEE division down its slow path, which cost a
  // packed row's padding more than the whole attention. A warp of padding
  // writes its zeros straight away.
  if (live) {
    __syncwarp();
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float x0 = 0.f, x1 = 0.f;
        if (l_run[r] > 0.f) {
          x0 = o[n][2 * r] / l_run[r];
          x1 = o[n][2 * r + 1] / l_run[r];
        }
        *reinterpret_cast<uint32_t*>(q_w + (g + 8 * r) * SROW + n * 8 + 2 * t) =
            pack_bf16(x0, x1);
      }
    __syncwarp();
  }
  for (int i = lane; i < 16 * CH; i += 32) {
    const int r = i / CH, c = (i % CH) * 8, qi = q0 + r;
    if (qi < L)
      *reinterpret_cast<uint4*>(out + base + (size_t)qi * row_stride + c) =
          live ? *reinterpret_cast<const uint4*>(q_w + r * SROW + c) : make_uint4(0, 0, 0, 0);
  }
}

template <int DH, bool kBLHD>
cudaError_t launch(const void* q, const void* k, const void* v, const int* seg, void* out,
                   int B, int H, int L, float sm_scale, int is_bf16, cudaStream_t s) {
  if (is_bf16) {
    const long long blocks = (long long)B * H * ((L + BQ - 1) / BQ);
    if (blocks > INT_MAX) return cudaErrorInvalidValue;
    constexpr size_t smem = mma_smem_bytes<DH>();
    if (smem > 48 * 1024) {  // above 48 KB only after raising the kernel's limit
      const cudaError_t e = cudaFuncSetAttribute(segment_attention_mma_kernel<DH, kBLHD>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 (int)smem);
      if (e != cudaSuccess) return e;
    }
    segment_attention_mma_kernel<DH, kBLHD><<<(unsigned)blocks, 32 * WARPS, smem, s>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), seg, static_cast<__nv_bfloat16*>(out), H, L,
        sm_scale);
  } else {
    const dim3 grid(B * H, (L + QT - 1) / QT);
    segment_attention_fp32_kernel<DH, kBLHD><<<grid, QT, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), seg, static_cast<float*>(out), H, L, sm_scale);
  }
  return cudaGetLastError();
}

// Dh: one of the widths the kernels are built at (16, 32, 64, 128, 256)
template <bool kBLHD>
int dispatch(const void* q, const void* k, const void* v, const void* seg,
             void* out, int B, int H, int L, int Dh, float sm_scale,
             int is_bf16, void* stream) {
  if (B <= 0 || H <= 0 || L <= 0) return (int)cudaErrorInvalidValue;
  const int* sp = static_cast<const int*>(seg);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (Dh) {
    case 16: return (int)launch<16, kBLHD>(q, k, v, sp, out, B, H, L, sm_scale, is_bf16, s);
    case 32: return (int)launch<32, kBLHD>(q, k, v, sp, out, B, H, L, sm_scale, is_bf16, s);
    case 64: return (int)launch<64, kBLHD>(q, k, v, sp, out, B, H, L, sm_scale, is_bf16, s);
    case 128: return (int)launch<128, kBLHD>(q, k, v, sp, out, B, H, L, sm_scale, is_bf16, s);
    case 256: return (int)launch<256, kBLHD>(q, k, v, sp, out, B, H, L, sm_scale, is_bf16, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// K2. q, k, v, out: [B, H, L, Dh] contiguous, 16-byte aligned, bf16
// (is_bf16=1) or fp32; seg: [B, L] int32. Dh: 16, 32, 64, 128 or 256.
extern "C" int medtok_segment_attention(const void* q, const void* k,
                                        const void* v, const void* seg,
                                        void* out, int B, int H, int L, int Dh,
                                        float sm_scale, int is_bf16,
                                        void* stream) {
  return dispatch<false>(q, k, v, seg, out, B, H, L, Dh, sm_scale, is_bf16, stream);
}

// K4. As K2 with q, k, v, out in [B, L, H, Dh].
extern "C" int medtok_segment_attention_nt(const void* q, const void* k,
                                           const void* v, const void* seg,
                                           void* out, int B, int H, int L,
                                           int Dh, float sm_scale, int is_bf16,
                                           void* stream) {
  return dispatch<true>(q, k, v, seg, out, B, H, L, Dh, sm_scale, is_bf16, stream);
}

extern "C" const char* medtok_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
