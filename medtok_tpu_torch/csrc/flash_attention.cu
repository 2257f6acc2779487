// Kernel K3: flash attention with a key-padding mask and hashed
// attention-probability dropout, forward (K3-fwd) and backward (K3-dq,
// K3-dkv), for Hopper (sm_90a).
//
// Replaces medtok_tpu/ops/flash_attention.py::flash_attention, whose Pallas
// kernels are _flash_kernel (forward), _flash_bwd_dq_kernel and
// _flash_bwd_dkv_kernel. q, k, v, dO and the outputs are [B*H, L, Dh] in
// bf16 or fp32; every kernel is templated on the head width Dh and built at
// 16, 32, 64, 128 and 256 (the EHR encoder: 64 wide, 4 heads, Dh = 16; the
// wrapper zero-pads any other width up to the next one, which changes no
// score and no kept column). mask is [B, Lk] bytes (non-zero = valid key,
// shared by the H heads of a row); lse and delta are [B*H, Lq] fp32.
// Semantics, as in the TPU kernels:
//   s_ij = sm_scale * q_i.k_j on valid keys; out_i = sum_j p~_ij v_j / l_i
//   with p_ij = exp(s_ij - m_i), l_i = sum_j p_ij (undropped) and
//   p~_ij = keep_ij p_ij / (1 - rate); keep_ij = hash(seed, bh, i, j) >=
//   threshold, the TPU kernel's _uniform_hash of the GLOBAL coordinates, so
//   the bits match it for any tiling. lse_i = m_i + log l_i. A row with no
//   valid key writes out 0 and lse -1e30 (its m never leaves the sentinel).
//   Backward, with a_ij = exp(s_ij - lse_i), t_ij = keep_ij/(1-rate) dO_i.v_j
//   and D_i = dO_i.O_i: ds_ij = a_ij (t_ij - D_i), dQ_i = sm_scale sum_j
//   ds_ij k_j, dK_j = sm_scale sum_i ds_ij q_i, dV_j = sum_i a~_ij dO_i.
// bf16 inputs are multiplied exactly with fp32 sums; p~ (forward), ds and
// a~ (backward) round to bf16 before their products, where the TPU kernel
// casts them to the operand's type. In the forward that is against the
// running maximum of 512-key blocks (the TPU kernel's default block_k, which
// the EHR encoder uses); the backward has no running maximum.
//
// Bound: at the EHR shape (B*H = 1024, L = 2003, Dh = 16, bf16) the three
// kernels move 0.27-0.41 GB each (q, k, v, dO, out: 65.6 MB apiece), 0.08-
// 0.12 ms at 3.35 TB/s, while the products are 4, 6 and 8 x Dh FLOP per
// (query, valid key): on the EHR batches (64% of the keys valid) 168, 252
// and 335 GFLOP, 0.17-0.34 ms on the bf16 tensor cores, so operations bound
// them. Outside that bound every score also costs CUDA-core work: one exp
// (the SFU does 16 a clock per SM: 2.6e9 scores a launch on the EHR batches
// take 0.6 ms at 1.98 GHz on 132 SMs) and, with dropout, about ten integer
// operations of the hash, plus the mask, the softmax terms and a bf16
// conversion: about 15 issue slots a score in the forward and 17-19 in each
// backward kernel, 1.1-1.5 ms a launch at 4 warp-instructions a clock per
// SM. That issue floor, not the FLOPs, is what the bf16 design works
// against.
//
// Design of the bf16 kernels (flash_fwd_mma_kernel, flash_dq_mma_kernel,
// flash_dkv_mma_kernel). The products run on the tensor cores with mma.sync
// m16n8k16 (bf16 in, fp32 sums). A block of 8 warps owns 128 rows of one
// (b, h), 16 per warp, and loops over the other axis in tiles of 64, staged
// by 16-byte cp.async into rows padded to Dh + 8 bf16 (ldmatrix is then free
// of bank conflicts at every width), two tiles in flight. A warp keeps its
// 16 rows' operands as A fragments (Dh / 16 k-steps) and its sums as Dh / 8
// C fragments. Nothing carries across blocks and there are no atomics, so
// the results are identical from run to run.
//   fwd: the block reads the row's key mask once, as bits in shared memory.
//       Each 512-key block is walked twice: pass 0 stages K alone and takes
//       the block's maximum of s * c (c = sm_scale log2 e) over the valid
//       keys by mma, reduced across the quad of lanes that holds a row; the
//       running maximum m2 moves to it and acc and l are rescaled by
//       alpha = 2^(m2_old - m2) once. Pass 1 stages K and V, recomputes S
//       (the tensor cores give the same bits), takes p = 2^(s c - m2), adds
//       the unrounded p to l, applies the keep bit and 1/(1 - rate), and
//       rounds the fp32 fragments of p~ to bf16 as the A fragment of
//       acc += p~ V (V by ldmatrix.trans): the TPU's p.astype(v.dtype)
//       against the running maximum after each 512-key block. A key tile
//       with no valid key is never staged, a 16-key group with none is not
//       multiplied, so a 512-key block with none is skipped whole (its
//       maximum would be the sentinel: alpha = 1, nothing changes). lse =
//       m2 ln 2 + ln l.
//   dq: a warp keeps Q and dO as A fragments; per 16-key group S = Q K^T
//       and dP = dO V^T are mmas, and the fp32 ds fragments, rounded to
//       bf16, are the A fragment of dQ += ds K (K by ldmatrix.trans): the
//       TPU's ds.astype(k.dtype). The key mask is read once as bits, and key
//       tiles and groups are skipped as in the forward, so with suffix
//       padding the loop ends at the row's last valid key (a mask with holes
//       is handled the same way).
//   dkv: a warp keeps K and V as A fragments; per 16-query group
//       S^T = K Q^T and dP^T = V dO^T, with lse and D per column; the
//       rounded fp32 fragments of a~^T and ds^T are the A fragments of
//       dV += a~^T dO and dK += ds^T Q (the TPU's a_drop.astype(do.dtype)
//       and ds.astype(q.dtype)). A block whose 128 keys are all masked
//       writes zeros and returns before staging a query tile; a warp whose
//       16 keys are all masked skips its products.
// Per score the CUDA-core work is kept small: log2(e) is folded into the
// scale, the running maximum and lse, so p = ex2(s * c - m2) is one FFMA and
// one SFU op; the hash starts from one 3-input xor of premultiplied row,
// column and seed terms; rate 0 compiles without any keep-bit arithmetic; a
// group whose 16 keys are all valid skips the mask test. The staged tiles
// and the mask bits live in dynamic shared memory: 12 KB a block at Dh = 16,
// 135 KB at Dh = 256.
//
// fp32 kernels (flash_fwd_kernel, flash_dq_kernel, flash_dkv_kernel), the
// parity path: exact fp32 products, which the bf16 tensor cores do not give,
// on CUDA cores. One thread owns one row and keeps its Dh-wide operands and
// sums in registers (at Dh = 256 they spill to local memory); the other
// axis streams through shared memory in fp32 tiles of 64 rows (32 KB of
// tiles at most: fewer rows above Dh = 64). The forward takes one pass with
// the online softmax (rescaling when the running max grows); dq keeps q,
// dO, lse, D and dq, with keys streaming as in the forward; dkv keeps k, v,
// dk and dv, with query / dO tiles and their lse and D streaming.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

#include "mma_bf16.cuh"

namespace {

constexpr int RT = 128;           // rows owned by an fp32 block (one per thread)
constexpr int KB = 512;           // the forward's bf16 key block (TPU block_k)
constexpr float MASKED = -1e30f;  // finite -inf stand-in, as in the TPU kernel

constexpr uint32_t ROW_MUL = 2654435761u;
constexpr uint32_t COL_MUL = 0x85EBCA6Bu;
constexpr uint32_t BH_MUL = 0x9E3779B9u;

// rows of the other axis an fp32 kernel stages per tile: 64 up to Dh = 64,
// then as many as keep two fp32 tiles within 32 KB
template <int DH>
__host__ __device__ constexpr int st_rows() { return DH <= 64 ? 64 : 4096 / DH; }

// The last rounds of the TPU kernel's _uniform_hash, from x = row*ROW_MUL ^
// col*COL_MUL ^ (seed + bh*BH_MUL): two xorshift-multiply rounds and a final
// xorshift, all mod 2^32.
__device__ __forceinline__ uint32_t hash_rounds(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  return x ^ (x >> 16);
}

// _uniform_hash with its row, column and (seed, bh) terms premultiplied;
// the first step is one 3-input xor
__device__ __forceinline__ uint32_t hash_bits(uint32_t row_term,
                                              uint32_t col_term,
                                              uint32_t seed_term) {
  return hash_rounds(row_term ^ col_term ^ seed_term);
}

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

template <int DH>
__device__ __forceinline__ void load_row(const float* p, float* o) {
#pragma unroll
  for (int d = 0; d < DH; d += 8) load8(p + d, o + d);
}

template <int DH>
__device__ __forceinline__ void store_row(float* p, const float* o) {
#pragma unroll
  for (int d = 0; d < DH; d += 8) store8(p + d, o + d);
}

template <int DH>
__device__ __forceinline__ float dot(const float* a, const float* b) {
  float s = 0.f;
#pragma unroll
  for (int d = 0; d < DH; d += 4) {
    const float4 bb = *reinterpret_cast<const float4*>(b + d);
    s = fmaf(a[d], bb.x, s);
    s = fmaf(a[d + 1], bb.y, s);
    s = fmaf(a[d + 2], bb.z, s);
    s = fmaf(a[d + 3], bb.w, s);
  }
  return s;
}

template <int DH>
__device__ __forceinline__ void axpy(float a, const float* x, float* y) {
#pragma unroll
  for (int d = 0; d < DH; d += 4) {
    const float4 xx = *reinterpret_cast<const float4*>(x + d);
    y[d] = fmaf(a, xx.x, y[d]);
    y[d + 1] = fmaf(a, xx.y, y[d + 1]);
    y[d + 2] = fmaf(a, xx.z, y[d + 2]);
    y[d + 3] = fmaf(a, xx.w, y[d + 3]);
  }
}

// Stage rows [r0, r0 + ST) of two [rows, DH] fp32 arrays into shared
// tiles, zeros past the end, in chunks of 8.
template <int DH, int ST>
__device__ __forceinline__ void stage_tiles(const float* a, const float* b, int r0,
                                            int rows, float (*a_s)[DH],
                                            float (*b_s)[DH]) {
  for (int i = threadIdx.x; i < ST * DH / 8; i += RT) {
    const int j = i / (DH / 8), d = (i % (DH / 8)) * 8;
    float ab[8], bb[8];
#pragma unroll
    for (int x = 0; x < 8; ++x) { ab[x] = 0.f; bb[x] = 0.f; }
    if (r0 + j < rows) {
      load8(a + (size_t)(r0 + j) * DH + d, ab);
      load8(b + (size_t)(r0 + j) * DH + d, bb);
    }
    store8(&a_s[j][d], ab);
    store8(&b_s[j][d], bb);
  }
}

struct Params {
  int H, Lq, Lk;
  float sm_scale, rate;
  uint32_t threshold;
  // the dropout seed, one int64 in device memory (read only when rate > 0),
  // so a seed drawn on the device reaches the kernel without a host sync
  const long long* seed;
};

// seed + bh * BH_MUL: the (seed, bh) term of the hash, mod 2^32
__device__ __forceinline__ uint32_t seed_term_of(const Params& P, int bh) {
  const uint32_t seed = P.rate > 0.f ? (uint32_t)P.seed[0] : 0u;
  return seed + (uint32_t)bh * BH_MUL;
}

// ------------------------------------------------------ K3-fwd, fp32 ----
template <int DH>
__global__ void __launch_bounds__(RT)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const uint8_t* __restrict__ mask,
                 float* __restrict__ out, float* __restrict__ lse, Params P) {
  constexpr int ST = st_rows<DH>();
  __shared__ __align__(16) float k_s[ST][DH];
  __shared__ __align__(16) float v_s[ST][DH];
  __shared__ uint32_t col_s[ST];
  __shared__ int valid_s[ST];

  const int bh = blockIdx.x;
  const int b = bh / P.H;
  const int qi = blockIdx.y * RT + threadIdx.x;
  const bool live = qi < P.Lq;
  const float* kb = k + (size_t)bh * P.Lk * DH;
  const float* vb = v + (size_t)bh * P.Lk * DH;
  const uint8_t* mrow = mask + (size_t)b * P.Lk;

  float qr[DH], acc[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) { qr[d] = 0.f; acc[d] = 0.f; }
  if (live) load_row<DH>(q + ((size_t)bh * P.Lq + qi) * DH, qr);
  float m = MASKED, l = 0.f;
  const bool drop = P.rate > 0.f;
  const float keep_scale = drop ? 1.f / (1.f - P.rate) : 1.f;
  const uint32_t row_term = (uint32_t)qi * ROW_MUL;
  const uint32_t seed_term = seed_term_of(P, bh);

  for (int t0 = 0; t0 < P.Lk; t0 += ST) {
    __syncthreads();  // the previous tile is consumed
    stage_tiles<DH, ST>(kb, vb, t0, P.Lk, k_s, v_s);
    if (threadIdx.x < ST) {  // the mask and hash column terms of the tile
      const int j = t0 + threadIdx.x;
      valid_s[threadIdx.x] = j < P.Lk && mrow[j] != 0;
      col_s[threadIdx.x] = (uint32_t)j * COL_MUL;
    }
    __syncthreads();

    const int jn = min(ST, P.Lk - t0);
    for (int j = 0; j < jn; ++j) {
      if (!valid_s[j]) continue;  // the same key for every thread
      const float s = dot<DH>(qr, k_s[j]) * P.sm_scale;
      if (s > m) {
        const float a = expf(m - s);
        l *= a;
#pragma unroll
        for (int d = 0; d < DH; ++d) acc[d] *= a;
        m = s;
      }
      const float p = expf(s - m);
      l += p;
      float pn = p;
      if (drop)
        pn = hash_bits(row_term, col_s[j], seed_term) >= P.threshold
                 ? p * keep_scale : 0.f;
      axpy<DH>(pn, v_s[j], acc);
    }
  }

  if (live) {
    const float safe_l = l == 0.f ? 1.f : l;  // no valid key: acc is 0
#pragma unroll
    for (int d = 0; d < DH; ++d) acc[d] = acc[d] / safe_l;
    store_row<DH>(out + ((size_t)bh * P.Lq + qi) * DH, acc);
    lse[(size_t)bh * P.Lq + qi] = m + logf(safe_l);
  }
}

// ------------------------------------------------------- K3-dq, fp32 ----
template <int DH>
__global__ void __launch_bounds__(RT)
flash_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const uint8_t* __restrict__ mask,
                const float* __restrict__ lse, const float* __restrict__ delta,
                const float* __restrict__ dout, float* __restrict__ dq, Params P) {
  constexpr int ST = st_rows<DH>();
  __shared__ __align__(16) float k_s[ST][DH];
  __shared__ __align__(16) float v_s[ST][DH];
  __shared__ uint32_t col_s[ST];
  __shared__ int valid_s[ST];

  const int bh = blockIdx.x;
  const int b = bh / P.H;
  const int qi = blockIdx.y * RT + threadIdx.x;
  const bool live = qi < P.Lq;
  const float* kb = k + (size_t)bh * P.Lk * DH;
  const float* vb = v + (size_t)bh * P.Lk * DH;
  const uint8_t* mrow = mask + (size_t)b * P.Lk;

  float qr[DH], dor[DH], acc[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) { qr[d] = 0.f; dor[d] = 0.f; acc[d] = 0.f; }
  float lse_i = 0.f, d_i = 0.f;
  if (live) {
    const size_t row = (size_t)bh * P.Lq + qi;
    load_row<DH>(q + row * DH, qr);
    load_row<DH>(dout + row * DH, dor);
    lse_i = lse[row];
    d_i = delta[row];
  }
  const bool drop = P.rate > 0.f;
  const float keep_scale = drop ? 1.f / (1.f - P.rate) : 1.f;
  const uint32_t row_term = (uint32_t)qi * ROW_MUL;
  const uint32_t seed_term = seed_term_of(P, bh);

  for (int t0 = 0; t0 < P.Lk; t0 += ST) {
    __syncthreads();
    stage_tiles<DH, ST>(kb, vb, t0, P.Lk, k_s, v_s);
    if (threadIdx.x < ST) {
      const int j = t0 + threadIdx.x;
      valid_s[threadIdx.x] = j < P.Lk && mrow[j] != 0;
      col_s[threadIdx.x] = (uint32_t)j * COL_MUL;
    }
    __syncthreads();

    const int jn = min(ST, P.Lk - t0);
    for (int j = 0; j < jn; ++j) {
      if (!valid_s[j]) continue;
      const float a = expf(dot<DH>(qr, k_s[j]) * P.sm_scale - lse_i);
      float t = dot<DH>(dor, v_s[j]);
      if (drop)
        t *= hash_bits(row_term, col_s[j], seed_term) >= P.threshold
                 ? keep_scale : 0.f;
      axpy<DH>(a * (t - d_i), k_s[j], acc);
    }
  }

  if (live) {
#pragma unroll
    for (int d = 0; d < DH; ++d) acc[d] *= P.sm_scale;
    store_row<DH>(dq + ((size_t)bh * P.Lq + qi) * DH, acc);
  }
}

// ------------------------------------------------------ K3-dkv, fp32 ----
template <int DH>
__global__ void __launch_bounds__(RT)
flash_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const uint8_t* __restrict__ mask,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 const float* __restrict__ dout, float* __restrict__ dk,
                 float* __restrict__ dv, Params P) {
  constexpr int ST = st_rows<DH>();
  __shared__ __align__(16) float q_s[ST][DH];
  __shared__ __align__(16) float do_s[ST][DH];
  __shared__ float lse_s[ST];
  __shared__ float d_s[ST];
  __shared__ uint32_t row_s[ST];

  const int bh = blockIdx.x;
  const int b = bh / P.H;
  const int kj = blockIdx.y * RT + threadIdx.x;
  const bool live = kj < P.Lk;
  const bool valid = live && mask[(size_t)b * P.Lk + kj] != 0;
  const float* qb = q + (size_t)bh * P.Lq * DH;
  const float* dob = dout + (size_t)bh * P.Lq * DH;

  float kr[DH], vr[DH], dkr[DH], dvr[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) { kr[d] = 0.f; vr[d] = 0.f; dkr[d] = 0.f; dvr[d] = 0.f; }
  if (live) {
    const size_t row = (size_t)bh * P.Lk + kj;
    load_row<DH>(k + row * DH, kr);
    load_row<DH>(v + row * DH, vr);
  }
  const bool drop = P.rate > 0.f;
  const float keep_scale = drop ? 1.f / (1.f - P.rate) : 1.f;
  const uint32_t col_term = (uint32_t)kj * COL_MUL;
  const uint32_t seed_term = seed_term_of(P, bh);

  for (int t0 = 0; t0 < P.Lq; t0 += ST) {
    __syncthreads();
    stage_tiles<DH, ST>(qb, dob, t0, P.Lq, q_s, do_s);
    if (threadIdx.x < ST) {
      const int i = t0 + threadIdx.x;
      const bool in = i < P.Lq;
      lse_s[threadIdx.x] = in ? lse[(size_t)bh * P.Lq + i] : 0.f;
      d_s[threadIdx.x] = in ? delta[(size_t)bh * P.Lq + i] : 0.f;
      row_s[threadIdx.x] = (uint32_t)i * ROW_MUL;
    }
    __syncthreads();

    if (!valid) continue;  // a masked key gets zero gradients
    const int in = min(ST, P.Lq - t0);
    for (int i = 0; i < in; ++i) {
      // dot reads its second operand as float4s, so the register row goes
      // first and the shared row second
      const float a = expf(dot<DH>(kr, q_s[i]) * P.sm_scale - lse_s[i]);
      float t = dot<DH>(vr, do_s[i]);
      float kf = 1.f;
      if (drop)
        kf = hash_bits(row_s[i], col_term, seed_term) >= P.threshold
                 ? keep_scale : 0.f;
      t *= kf;
      axpy<DH>(a * kf, do_s[i], dvr);
      axpy<DH>(a * (t - d_s[i]), q_s[i], dkr);
    }
  }

  if (live) {
#pragma unroll
    for (int d = 0; d < DH; ++d) dkr[d] *= P.sm_scale;
    const size_t row = (size_t)bh * P.Lk + kj;
    store_row<DH>(dk + row * DH, dkr);
    store_row<DH>(dv + row * DH, dvr);
  }
}

// ----------------------------------------------- K3, bf16 tensor cores ----
using bf16 = __nv_bfloat16;

constexpr int MW = 8;              // warps of a block
constexpr int MR = 16 * MW;        // rows owned by a block, 16 per warp
constexpr int MT = 64;             // rows of the other axis per staged tile
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// padded shared row, in bf16: Dh + 8 keeps the 8 rows of an ldmatrix on
// distinct 16-byte bank groups at every width
template <int DH>
__host__ __device__ constexpr int mrow() { return DH + 8; }

// bytes of the two double-buffered tiles of two arrays
template <int DH>
__host__ __device__ constexpr size_t tile_bytes() {
  return 4 * (size_t)MT * mrow<DH>() * sizeof(bf16);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The A fragments of rows [r0, r0 + 16) of a [rows, DH] bf16 array, one per
// 16-wide k-step, zeros past the end.
template <int DH>
__device__ __forceinline__ void load_a_frags(const bf16* base, int r0, int rows, int g, int t,
                                             uint32_t (*a)[4]) {
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int r = r0 + g + 8 * (x & 1), c = kk * 16 + 2 * t + 8 * (x >> 1);
      a[kk][x] = r < rows ? *reinterpret_cast<const uint32_t*>(base + (size_t)r * DH + c) : 0u;
    }
}

// Copy rows [r0, r0 + MT) of a [rows, DH] bf16 array (and of b, unless it
// is null) into padded shared tiles by cp.async, zeros past the end: DH / 8
// chunks of 16 bytes a row.
template <int DH>
__device__ __forceinline__ void stage_mma(const bf16* a, const bf16* b, int r0, int rows,
                                          bf16* a_s, bf16* b_s) {
  constexpr int CH = DH / 8;
  for (int i = threadIdx.x; i < MT * CH; i += 32 * MW) {
    const int r = i / CH, c = (i % CH) * 8, row = r0 + r;
    const size_t off = (size_t)min(row, rows - 1) * DH + c;
    cp_async16(a_s + r * mrow<DH>() + c, a + off, row < rows);
    if (b != nullptr) cp_async16(b_s + r * mrow<DH>() + c, b + off, row < rows);
  }
}

// Stores a warp's 16 x DH fp32 result (DH / 8 C fragments) as bf16 rows
// [r0, r0 + 16) of a [rows, DH] array.
template <int DH>
__device__ __forceinline__ void store_c_frags(bf16* base, int r0, int rows, int g, int t,
                                              const float (*c)[4]) {
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + g + 8 * r;
      if (row < rows)
        *reinterpret_cast<uint32_t*>(base + (size_t)row * DH + 8 * n + 2 * t) =
            pack_bf16(c[n][2 * r], c[n][2 * r + 1]);
    }
}

// B fragments of one 16-row group at p (rows of LD bf16) over 16 columns:
// `direct` for a product with the group's rows as the n dimension (S =
// Q K^T: K), `trans` for one with them as the k dimension (dQ = ds K: K).
template <int LD>
__device__ __forceinline__ void b_frags(const bf16* p, int lane, uint32_t* direct) {
  ldmatrix_x4(direct, p + ((lane & 7) + ((lane >> 4) << 3)) * LD + ((lane >> 3) & 1) * 8);
}
template <int LD>
__device__ __forceinline__ void b_frags_trans(const bf16* p, int lane, uint32_t* trans) {
  ldmatrix_x4_trans(trans, p + ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8);
}

// s[2][4] = A (16 x DH, A fragments) times the 16 rows at p, transposed
template <int DH>
__device__ __forceinline__ void mma_rows(float (*s)[4], const uint32_t (*a)[4], const bf16* p,
                                         int lane) {
  constexpr int LD = mrow<DH>();
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    uint32_t f[4];
    b_frags<LD>(p + kk * 16, lane, f);
    mma_bf16(s[0], a[kk], f[0], f[1]);
    mma_bf16(s[1], a[kk], f[2], f[3]);
  }
}

// acc (16 x DH, C fragments) += A (16 x 16 rows, one A fragment) times the
// 16 rows at p
template <int DH>
__device__ __forceinline__ void mma_acc(float (*acc)[4], const uint32_t* a, const bf16* p,
                                        int lane) {
  constexpr int LD = mrow<DH>();
#pragma unroll
  for (int dn = 0; dn < DH / 16; ++dn) {
    uint32_t f[4];
    b_frags_trans<LD>(p + dn * 16, lane, f);
    mma_bf16(acc[2 * dn], a, f[0], f[1]);
    mma_bf16(acc[2 * dn + 1], a, f[2], f[3]);
  }
}

// the A fragment of a 16 x 16 product from two neighbouring C fragments,
// rounded to bf16
__device__ __forceinline__ void pack_a(const float (*c)[4], uint32_t* a) {
  a[0] = pack_bf16(c[0][0], c[0][1]);
  a[1] = pack_bf16(c[0][2], c[0][3]);
  a[2] = pack_bf16(c[1][0], c[1][1]);
  a[3] = pack_bf16(c[1][2], c[1][3]);
}

// The row's key mask as bits in shared memory (bit j of word j / 32 = key
// j valid), one ballot a warp per word.
__device__ __forceinline__ void load_key_bits(const uint8_t* mrow, int Lk, int n_words,
                                              uint32_t* kbits) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int w = warp; w < n_words; w += MW) {
    const int j = w * 32 + lane;
    const unsigned bits = __ballot_sync(FULL_MASK, j < Lk && mrow[j] != 0);
    if (lane == 0) kbits[w] = bits;
  }
}

template <int DH, bool kDrop>
__global__ void __launch_bounds__(32 * MW)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const uint8_t* __restrict__ mask,
                     bf16* __restrict__ out, float* __restrict__ lse, Params P) {
  constexpr int LD = mrow<DH>(), TILE = MT * LD, TPB = KB / MT;  // tiles per key block
  extern __shared__ __align__(16) uint8_t smem[];
  bf16* k_s = reinterpret_cast<bf16*>(smem);                        // [2][TILE]
  bf16* v_s = k_s + 2 * TILE;                                       // [2][TILE]
  uint32_t* kbits = reinterpret_cast<uint32_t*>(v_s + 2 * TILE);   // the key mask

  const int bh = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.y * MR + warp * 16;  // the warp's first query
  const int n_words = (P.Lk + 31) / 32;
  const int n_tiles = (P.Lk + MT - 1) / MT;
  const bf16* kb = k + (size_t)bh * P.Lk * DH;
  const bf16* vb = v + (size_t)bh * P.Lk * DH;
  load_key_bits(mask + (size_t)(bh / P.H) * P.Lk, P.Lk, n_words, kbits);

  const bool warp_live = q0 < P.Lq;
  uint32_t qa[DH / 16][4];
  load_a_frags<DH>(q + (size_t)bh * P.Lq * DH, q0, P.Lq, g, t, qa);
  const float c = P.sm_scale * LOG2E;
  const float keep_scale = kDrop ? 1.f / (1.f - P.rate) : 1.f;
  const uint32_t seed_term = seed_term_of(P, bh);
  uint32_t rs[2];  // row term ^ seed term of rows g, g + 8
#pragma unroll
  for (int r = 0; r < 2; ++r) rs[r] = (uint32_t)(q0 + g + 8 * r) * ROW_MUL ^ seed_term;
  // per row g, g + 8: the running maximum of s * c, this key block's
  // maximum (pass 0) and this thread's share of l (its columns)
  float m2[2] = {MASKED, MASKED}, mx[2] = {MASKED, MASKED}, l[2] = {0.f, 0.f};
  float acc[DH / 8][4] = {};
  __syncthreads();  // kbits is complete

  auto word = [&](int w) { return w < n_words ? kbits[w] : 0u; };
  auto next_tile = [&](int tile) {  // the first tile from `tile` with a valid key
    while (tile < n_tiles && (word(2 * tile) | word(2 * tile + 1)) == 0u) ++tile;
    return tile;
  };
  // the step after (tile, pass): the next tile of the same key block and
  // pass with a valid key; after a block's pass 0 its first such tile in
  // pass 1; after its pass 1 the first tile of a later block with one
  auto advance = [&](int tile, int pass, int& ntile, int& npass) {
    const int block0 = tile / TPB * TPB;
    const int nt = next_tile(tile + 1);
    if (nt < min(block0 + TPB, n_tiles)) {
      ntile = nt;
      npass = pass;
    } else if (pass == 0) {
      ntile = next_tile(block0);
      npass = 1;
    } else {
      ntile = nt;
      npass = 0;
    }
  };
  auto stage = [&](int tile, int pass, int buf) {  // pass 0 needs K alone
    stage_mma<DH>(kb, pass ? vb : nullptr, tile * MT, P.Lk, k_s + buf * TILE,
                  v_s + buf * TILE);
    cp_async_commit();
  };

  int tile = next_tile(0), pass = 0, buf = 0;
  if (tile < n_tiles) stage(tile, 0, 0);
  while (tile < n_tiles) {
    int ntile, npass;
    advance(tile, pass, ntile, npass);
    if (ntile < n_tiles) {
      stage(ntile, npass, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // every thread's copies of this tile have landed

    if (warp_live) {
#pragma unroll
      for (int grp = 0; grp < MT / 16; ++grp) {
        const uint32_t gb = (word(2 * tile + (grp >> 1)) >> (16 * (grp & 1))) & 0xFFFFu;
        if (gb == 0u) continue;  // uniform over the block
        const bool full = gb == 0xFFFFu;
        float s[2][4] = {};
        mma_rows<DH>(s, qa, k_s + buf * TILE + grp * 16 * LD, lane);
        if (pass == 0) {
#pragma unroll
          for (int x = 0; x < 2; ++x)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (full || ((gb >> (8 * x + 2 * t + (e & 1))) & 1u))
                mx[e >> 1] = fmaxf(mx[e >> 1], s[x][e] * c);
          continue;
        }
        const int j0 = tile * MT + grp * 16 + 2 * t;  // columns j0 + {0, 1, 8, 9}
#pragma unroll
        for (int x = 0; x < 2; ++x)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1;
            float p = ex2(fmaf(s[x][e], c, -m2[r]));
            if (!full && !((gb >> (8 * x + 2 * t + (e & 1))) & 1u)) p = 0.f;
            l[r] += p;
            if (kDrop) {
              const uint32_t ct = (uint32_t)(j0 + 8 * x + (e & 1)) * COL_MUL;
              p = hash_rounds(rs[r] ^ ct) >= P.threshold ? p * keep_scale : 0.f;
            }
            s[x][e] = p;
          }
        uint32_t pa[4];
        pack_a(s, pa);
        mma_acc<DH>(acc, pa, v_s + buf * TILE + grp * 16 * LD, lane);
      }
    }
    if (pass == 0 && npass == 1) {
      // the key block's maximum is complete: take it across the quad that
      // holds a row, move the running maximum and rescale once
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL_MASK, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL_MASK, mx[r], 2));
        const float m_next = fmaxf(m2[r], mx[r]);
        const float alpha = ex2(m2[r] - m_next);
        l[r] *= alpha;
#pragma unroll
        for (int n = 0; n < DH / 8; ++n) {
          acc[n][2 * r] *= alpha;
          acc[n][2 * r + 1] *= alpha;
        }
        m2[r] = m_next;
        mx[r] = MASKED;
      }
    }
    __syncthreads();  // this buffer is consumed before the next stage overwrites it
    tile = ntile;
    pass = npass;
    buf ^= 1;
  }

  // l over the quad; out = acc / l, and a row with no valid key (l = 0)
  // writes 0 and lse -1e30
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(FULL_MASK, l[r], 1);
    l[r] += __shfl_xor_sync(FULL_MASK, l[r], 2);
  }
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float lr = l[e >> 1];
      acc[n][e] = lr > 0.f ? acc[n][e] / lr : 0.f;
    }
  store_c_frags<DH>(out + (size_t)bh * P.Lq * DH, q0, P.Lq, g, t, acc);
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + g + 8 * r;
      if (row < P.Lq)
        lse[(size_t)bh * P.Lq + row] = l[r] > 0.f ? m2[r] * LN2 + logf(l[r]) : MASKED;
    }
  }
}

template <int DH, bool kDrop>
__global__ void __launch_bounds__(32 * MW)
flash_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const uint8_t* __restrict__ mask,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    const bf16* __restrict__ dout, bf16* __restrict__ dq, Params P) {
  constexpr int LD = mrow<DH>(), TILE = MT * LD;
  extern __shared__ __align__(16) uint8_t smem[];
  bf16* k_s = reinterpret_cast<bf16*>(smem);                        // [2][TILE]
  bf16* v_s = k_s + 2 * TILE;                                       // [2][TILE]
  uint32_t* kbits = reinterpret_cast<uint32_t*>(v_s + 2 * TILE);   // the key mask

  const int bh = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.y * MR + warp * 16;  // the warp's first query
  const int n_words = (P.Lk + 31) / 32;
  const int n_tiles = (P.Lk + MT - 1) / MT;
  const bf16* kb = k + (size_t)bh * P.Lk * DH;
  const bf16* vb = v + (size_t)bh * P.Lk * DH;
  load_key_bits(mask + (size_t)(bh / P.H) * P.Lk, P.Lk, n_words, kbits);

  const bool warp_live = q0 < P.Lq;
  uint32_t qa[DH / 16][4], da[DH / 16][4];
  load_a_frags<DH>(q + (size_t)bh * P.Lq * DH, q0, P.Lq, g, t, qa);
  load_a_frags<DH>(dout + (size_t)bh * P.Lq * DH, q0, P.Lq, g, t, da);
  const float c = P.sm_scale * LOG2E;
  const float keep_scale = kDrop ? 1.f / (1.f - P.rate) : 1.f;
  const uint32_t seed_term = seed_term_of(P, bh);
  float lse2[2], dd[2];
  uint32_t rs[2];  // row term ^ seed term of rows g, g + 8
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + g + 8 * r;
    const bool in = row < P.Lq;
    lse2[r] = in ? lse[(size_t)bh * P.Lq + row] * LOG2E : 0.f;
    dd[r] = in ? delta[(size_t)bh * P.Lq + row] : 0.f;
    rs[r] = (uint32_t)row * ROW_MUL ^ seed_term;
  }
  float acc[DH / 8][4] = {};
  __syncthreads();  // kbits is complete

  auto word = [&](int w) { return w < n_words ? kbits[w] : 0u; };
  auto next_tile = [&](int tile) {  // the first tile from `tile` with a valid key
    while (tile < n_tiles && (word(2 * tile) | word(2 * tile + 1)) == 0u) ++tile;
    return tile;
  };

  int tile = next_tile(0), buf = 0;
  if (tile < n_tiles) {
    stage_mma<DH>(kb, vb, tile * MT, P.Lk, k_s, v_s);
    cp_async_commit();
  }
  while (tile < n_tiles) {
    const int next = next_tile(tile + 1);
    if (next < n_tiles) {
      stage_mma<DH>(kb, vb, next * MT, P.Lk, k_s + (buf ^ 1) * TILE, v_s + (buf ^ 1) * TILE);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // every thread's copies of this tile have landed

    if (warp_live) {
#pragma unroll
      for (int grp = 0; grp < MT / 16; ++grp) {
        const uint32_t gb = (word(2 * tile + (grp >> 1)) >> (16 * (grp & 1))) & 0xFFFFu;
        if (gb == 0u) continue;  // uniform over the block
        const bf16* kg = k_s + buf * TILE + grp * 16 * LD;
        float s[2][4] = {}, dp[2][4] = {};
        mma_rows<DH>(s, qa, kg, lane);
        mma_rows<DH>(dp, da, v_s + buf * TILE + grp * 16 * LD, lane);

        const int j0 = tile * MT + grp * 16 + 2 * t;  // columns j0 + {0, 1, 8, 9}
        float ds[2][4];
#pragma unroll
        for (int x = 0; x < 2; ++x)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1, col = 8 * x + 2 * t + (e & 1);
            float a = ex2(fmaf(s[x][e], c, -lse2[r]));
            if (gb != 0xFFFFu && !((gb >> col) & 1u)) a = 0.f;
            float tt = dp[x][e];
            if (kDrop) {
              const uint32_t ct = (uint32_t)(j0 + 8 * x + (e & 1)) * COL_MUL;
              tt = hash_rounds(rs[r] ^ ct) >= P.threshold ? tt * keep_scale : 0.f;
            }
            ds[x][e] = a * (tt - dd[r]);
          }
        uint32_t dsa[4];
        pack_a(ds, dsa);
        mma_acc<DH>(acc, dsa, kg, lane);
      }
    }
    __syncthreads();  // this buffer is consumed before the next stage overwrites it
    tile = next;
    buf ^= 1;
  }

#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] *= P.sm_scale;
  store_c_frags<DH>(dq + (size_t)bh * P.Lq * DH, q0, P.Lq, g, t, acc);
}

template <int DH, bool kDrop>
__global__ void __launch_bounds__(32 * MW)
flash_dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const uint8_t* __restrict__ mask,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     const bf16* __restrict__ dout, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, Params P) {
  constexpr int LD = mrow<DH>(), TILE = MT * LD;
  extern __shared__ __align__(16) uint8_t smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);                       // [2][TILE]
  bf16* do_s = q_s + 2 * TILE;                                     // [2][TILE]
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * TILE);       // [2][MT]
  float* d_s = lse_s + 2 * MT;                                     // [2][MT]

  const int bh = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.y * MR + warp * 16;  // the warp's first key
  const uint8_t* mrow = mask + (size_t)(bh / P.H) * P.Lk;
  const bf16* qb = q + (size_t)bh * P.Lq * DH;
  const bf16* dob = dout + (size_t)bh * P.Lq * DH;
  const float* lseb = lse + (size_t)bh * P.Lq;
  const float* deltab = delta + (size_t)bh * P.Lq;

  // the warp's 16 keys' mask bits; a block with no valid key stages nothing
  const int kj = k0 + (lane & 15);
  const uint32_t kbits =
      __ballot_sync(FULL_MASK, lane < 16 && kj < P.Lk && mrow[kj] != 0) & 0xFFFFu;
  const bool block_live = __syncthreads_or(kbits != 0u);

  float dk_acc[DH / 8][4] = {}, dv_acc[DH / 8][4] = {};
  if (block_live) {
    uint32_t ka[DH / 16][4], va[DH / 16][4];
    load_a_frags<DH>(k + (size_t)bh * P.Lk * DH, k0, P.Lk, g, t, ka);
    load_a_frags<DH>(v + (size_t)bh * P.Lk * DH, k0, P.Lk, g, t, va);
    const float c = P.sm_scale * LOG2E;
    const float keep_scale = kDrop ? 1.f / (1.f - P.rate) : 1.f;
    const uint32_t seed_term = seed_term_of(P, bh);
    uint32_t cs[2];   // column (key) term ^ seed term of rows g, g + 8
    bool valid[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      cs[r] = (uint32_t)(k0 + g + 8 * r) * COL_MUL ^ seed_term;
      valid[r] = (kbits >> (g + 8 * r)) & 1u;
    }

    auto stage = [&](int tile, int buf) {
      stage_mma<DH>(qb, dob, tile * MT, P.Lq, q_s + buf * TILE, do_s + buf * TILE);
      for (int i = threadIdx.x; i < MT; i += 32 * MW) {
        const int row = tile * MT + i;
        const int src = min(row, P.Lq - 1);
        cp_async4(&lse_s[buf * MT + i], lseb + src, row < P.Lq);
        cp_async4(&d_s[buf * MT + i], deltab + src, row < P.Lq);
      }
      cp_async_commit();
    };

    const int n_tiles = (P.Lq + MT - 1) / MT;
    stage(0, 0);
    for (int tile = 0; tile < n_tiles; ++tile) {
      const int buf = tile & 1;
      if (tile + 1 < n_tiles) {
        stage(tile + 1, buf ^ 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();

      if (kbits != 0u) {  // a warp of masked keys has zero gradients
#pragma unroll
        for (int grp = 0; grp < MT / 16; ++grp) {
          const bf16* qg = q_s + buf * TILE + grp * 16 * LD;
          const bf16* dog = do_s + buf * TILE + grp * 16 * LD;
          float st[2][4] = {}, dpt[2][4] = {};
          mma_rows<DH>(st, ka, qg, lane);
          mma_rows<DH>(dpt, va, dog, lane);

          const int li = grp * 16 + 2 * t;  // local columns li + {0, 1, 8, 9}
          float ds[2][4], ad[2][4];
#pragma unroll
          for (int x = 0; x < 2; ++x)
#pragma unroll
            for (int cc = 0; cc < 2; ++cc) {
              const int col = li + 8 * x + cc;
              const float l2 = lse_s[buf * MT + col] * LOG2E, dcol = d_s[buf * MT + col];
              const uint32_t rt = (uint32_t)(tile * MT + col) * ROW_MUL;
#pragma unroll
              for (int r = 0; r < 2; ++r) {
                const int e = 2 * r + cc;
                float a = ex2(fmaf(st[x][e], c, -l2));
                if (!valid[r]) a = 0.f;
                float tt = dpt[x][e], a_drop = a;
                if (kDrop) {
                  const bool keep = hash_rounds(rt ^ cs[r]) >= P.threshold;
                  tt = keep ? tt * keep_scale : 0.f;
                  a_drop = keep ? a * keep_scale : 0.f;
                }
                ds[x][e] = a * (tt - dcol);
                ad[x][e] = a_drop;
              }
            }
          uint32_t dsa[4], ada[4];
          pack_a(ds, dsa);
          pack_a(ad, ada);
          mma_acc<DH>(dk_acc, dsa, qg, lane);
          mma_acc<DH>(dv_acc, ada, dog, lane);
        }
      }
      __syncthreads();  // this buffer is consumed before the next stage overwrites it
    }
  }

#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] *= P.sm_scale;
  store_c_frags<DH>(dk + (size_t)bh * P.Lk * DH, k0, P.Lk, g, t, dk_acc);
  store_c_frags<DH>(dv + (size_t)bh * P.Lk * DH, k0, P.Lk, g, t, dv_acc);
}

// Calls f(std::integral_constant<int, W>()) for Dh = W, one of the widths
// the kernels are built at; any other Dh is refused.
template <typename F>
cudaError_t with_width(int Dh, F&& f) {
  switch (Dh) {
    case 16: return f(std::integral_constant<int, 16>());
    case 32: return f(std::integral_constant<int, 32>());
    case 64: return f(std::integral_constant<int, 64>());
    case 128: return f(std::integral_constant<int, 128>());
    case 256: return f(std::integral_constant<int, 256>());
    default: return cudaErrorInvalidValue;
  }
}

// Launch `kernel` with `smem` bytes of dynamic shared memory (above 48 KB
// only after raising the kernel's limit).
template <typename... KArgs, typename... Args>
cudaError_t launch(void (*kernel)(KArgs...), dim3 grid, int threads, size_t smem,
                   cudaStream_t s, Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, threads, smem, s>>>(args...);
  return cudaGetLastError();
}

bool bad_shape(int B, int H, int Lq, int Lk) {
  return B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0;
}

Params params(int H, int Lq, int Lk, float sm_scale, float rate,
              unsigned threshold, const void* seed) {
  return Params{H, Lq, Lk, sm_scale, rate, threshold,
                static_cast<const long long*>(seed)};
}

// bytes of the key-mask bits of one row
size_t bits_bytes(int Lk) { return (size_t)((Lk + 31) / 32) * sizeof(uint32_t); }

template <typename T>
const T* in(const void* p) { return static_cast<const T*>(p); }
template <typename T>
T* outp(void* p) { return static_cast<T*>(p); }

}  // namespace

// All tensors contiguous and 16-byte aligned. q, dO, out, dq: [B*H, Lq, Dh];
// k, v, dk, dv: [B*H, Lk, Dh]; Dh one of 16, 32, 64, 128, 256; bf16
// (is_bf16 = 1) or fp32. mask: [B, Lk] bytes. lse, delta: [B*H, Lq] fp32.
// Dropout is on when rate > 0; a probability is kept where its hash >=
// threshold (uint32(rate * 2^32)). seed: one int64 on the device, of which
// the low 32 bits seed the hash (unread, and may be null, when rate is 0).
extern "C" int medtok_flash_fwd(const void* q, const void* k, const void* v,
                                const void* mask, void* out, void* lse, int B,
                                int H, int Lq, int Lk, int Dh, float sm_scale,
                                float rate, unsigned threshold, const void* seed,
                                int is_bf16, void* stream) {
  if (bad_shape(B, H, Lq, Lk)) return (int)cudaErrorInvalidValue;
  const Params P = params(H, Lq, Lk, sm_scale, rate, threshold, seed);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* m = in<uint8_t>(mask);
  float* l = outp<float>(lse);
  return (int)with_width(Dh, [&](auto w) {
    constexpr int DH = decltype(w)::value;
    if (is_bf16) {
      const dim3 grid(B * H, (Lq + MR - 1) / MR);
      const size_t smem = tile_bytes<DH>() + bits_bytes(Lk);
      auto kernel = rate > 0.f ? flash_fwd_mma_kernel<DH, true> : flash_fwd_mma_kernel<DH, false>;
      return launch(kernel, grid, 32 * MW, smem, s, in<bf16>(q), in<bf16>(k), in<bf16>(v), m,
                    outp<bf16>(out), l, P);
    }
    const dim3 grid(B * H, (Lq + RT - 1) / RT);
    return launch(flash_fwd_kernel<DH>, grid, RT, 0, s, in<float>(q), in<float>(k),
                  in<float>(v), m, outp<float>(out), l, P);
  });
}

extern "C" int medtok_flash_dq(const void* q, const void* k, const void* v,
                               const void* mask, const void* lse,
                               const void* delta, const void* dout, void* dq,
                               int B, int H, int Lq, int Lk, int Dh,
                               float sm_scale, float rate, unsigned threshold,
                               const void* seed, int is_bf16, void* stream) {
  if (bad_shape(B, H, Lq, Lk)) return (int)cudaErrorInvalidValue;
  const Params P = params(H, Lq, Lk, sm_scale, rate, threshold, seed);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* m = in<uint8_t>(mask);
  const float* l = in<float>(lse);
  const float* dd = in<float>(delta);
  return (int)with_width(Dh, [&](auto w) {
    constexpr int DH = decltype(w)::value;
    if (is_bf16) {
      const dim3 grid(B * H, (Lq + MR - 1) / MR);
      const size_t smem = tile_bytes<DH>() + bits_bytes(Lk);
      auto kernel = rate > 0.f ? flash_dq_mma_kernel<DH, true> : flash_dq_mma_kernel<DH, false>;
      return launch(kernel, grid, 32 * MW, smem, s, in<bf16>(q), in<bf16>(k), in<bf16>(v), m,
                    l, dd, in<bf16>(dout), outp<bf16>(dq), P);
    }
    const dim3 grid(B * H, (Lq + RT - 1) / RT);
    return launch(flash_dq_kernel<DH>, grid, RT, 0, s, in<float>(q), in<float>(k),
                  in<float>(v), m, l, dd, in<float>(dout), outp<float>(dq), P);
  });
}

extern "C" int medtok_flash_dkv(const void* q, const void* k, const void* v,
                                const void* mask, const void* lse,
                                const void* delta, const void* dout, void* dk,
                                void* dv, int B, int H, int Lq, int Lk, int Dh,
                                float sm_scale, float rate, unsigned threshold,
                                const void* seed, int is_bf16, void* stream) {
  if (bad_shape(B, H, Lq, Lk)) return (int)cudaErrorInvalidValue;
  const Params P = params(H, Lq, Lk, sm_scale, rate, threshold, seed);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* m = in<uint8_t>(mask);
  const float* l = in<float>(lse);
  const float* dd = in<float>(delta);
  return (int)with_width(Dh, [&](auto w) {
    constexpr int DH = decltype(w)::value;
    if (is_bf16) {
      const dim3 grid(B * H, (Lk + MR - 1) / MR);
      const size_t smem = tile_bytes<DH>() + 4 * MT * sizeof(float);
      auto kernel = rate > 0.f ? flash_dkv_mma_kernel<DH, true> : flash_dkv_mma_kernel<DH, false>;
      return launch(kernel, grid, 32 * MW, smem, s, in<bf16>(q), in<bf16>(k), in<bf16>(v), m,
                    l, dd, in<bf16>(dout), outp<bf16>(dk), outp<bf16>(dv), P);
    }
    const dim3 grid(B * H, (Lk + RT - 1) / RT);
    return launch(flash_dkv_kernel<DH>, grid, RT, 0, s, in<float>(q), in<float>(k),
                  in<float>(v), m, l, dd, in<float>(dout), outp<float>(dk), outp<float>(dv), P);
  });
}
