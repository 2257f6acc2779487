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

#include <climits>
#include <cmath>
#include <cstdint>
#include <type_traits>

#include "mma_bf16.cuh"
#include "wide.cuh"

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

// ------------------------------------------------------ K3, wide route ----
// Head widths above 256 (wide.cuh), with the plain versions' rounding
// points.
//   fwd, bf16 (flash_fwd_wide_mma_kernel), on the tensor cores with wgmma.
//       A block owns MR = 128 queries of one b*h and one slice of NV x 64
//       output columns (the wrapper's plan: ceil(Dh / 256) slices of 192
//       or 256 columns, NV 3 or 4); its
//       blocks are numbered slice fastest, then query tile, then b*h. It is
//       warp-specialized as K2's wide kernel is: two consumer warpgroups
//       (64 queries each, X_REGS_CONSUMER registers a thread) multiply, a
//       producer warpgroup (X_REGS_PRODUCER) starts every copy, XST_FWD stages ahead, handed over
//       by `full` / `empty` mbarriers. Q's 64-column chunks are staged once
//       and stay in shared memory where they fit (q_resident: Dh up to about
//       640), else come again in each stage beside K's. The keys come in
//       tiles of MT = 64 and blocks of KB = 512, walked twice as
//       flash_fwd_mma_kernel walks them (tiles with no valid key are never
//       staged): a (tile, pass) is ceil(Dh / 64) score steps, each four
//       wgmma m64n64k16 (one per 16 columns, Q and K both read from shared
//       memory) into a fresh accumulator, whose product is added to S = Q
//       K^T for the warpgroup's rows in fp32 once it is done (32 + 32
//       registers a thread; wgmma's own sum over the whole width rounds
//       otherwise than an fp32 product, and at 4,096 keys 1.2% of the
//       outputs then differed from the plain version's). Pass 0 takes the
//       key block's maximum of s * c (c = sm_scale log2 e) over the valid
//       keys; when the block's pass 0 ends, the running maximum m2 moves to
//       it across the quad and O and l are rescaled once. Pass 1 recomputes S (the
//       tensor cores give the same bits), takes p = 2^(s c - m2), adds the
//       unrounded p to l, applies the hashed keep factor and 1 / (1 - rate)
//       per element, and rounds p~ to bf16 as the A fragments of P V (0 on
//       a 16-key group with no valid key, so every wgmma runs
//       unconditionally); the slice's V steps follow, each a wgmma
//       m64n64k16 per 16 keys into its 32 registers of O. That is the TPU's
//       p.astype(v.dtype) against the running maximum after each 512-key
//       block. At the end O / l is staged through shared memory and stored;
//       the blocks of slice 0 write lse = m2 ln 2 + ln l (-1e30 and an
//       output of 0 for a row with no valid key).
//   fwd, fp32 (flash_fwd_wide_kernel<float>), on the CUDA cores: one block
//       of WT threads per (b*h, WQ queries); keys in blocks of KB = 512,
//       each scored by four tile_dots of WT keys; per block the rows'
//       maximum, the running maximum m and alpha, p = exp(s - m) on valid
//       keys, l = l * alpha + sum p, then p times the keep scale into acc =
//       acc * alpha + p V. A block with no valid key changes nothing and is
//       skipped. lse = m + log l. The fp32 checks hold it to 1e-5, which no
//       bf16 or TF32 product meets, so it stays on the CUDA cores as the
//       main fp32 route does.
//   dkv, bf16 (flash_dkv_wide_mma_kernel), on the tensor cores with wgmma,
//       warp-specialized as the forward. A block owns DKV_KEYS = 128 keys of
//       one b*h, 64 a consumer warpgroup, and one slice of 128 output
//       columns of dK and dV (XNV_DKV = 2 chunks, the last slice what is
//       left; blocks numbered slice fastest, then key block, then b*h: the
//       plan's ceil(Dh / 128) slices), and walks the query tiles of DKV_QT
//       = 64 in order, as the TPU kernel walks its query blocks with dK and
//       dV in VMEM. A query tile is nc = ceil(Dh / 64) score steps, each
//       staging Q's and dO's chunk (and K's and V's unless they stay
//       resident, which they do where they fit: Dh up to 320) and summing
//       S^T = K Q^T and dP^T = V dO^T for the warpgroup's 64 keys by wgmma
//       m64n64k16 (K, V as A and Q, dO as B, all read from shared memory;
//       64 registers a thread). Then, on the fp32 fragments, a = 2^(s c -
//       lse log2 e) on valid keys (0 on masked ones), the hashed keep factor
//       from premultiplied terms, ds = a (keep dP - D) and a~ = keep a,
//       repacked from the registers as bf16 A fragments (the TPU's
//       ds.astype(q.dtype) and a_drop.astype(do.dtype)); the slice's two
//       steps stage its chunks of Q and dO again, read transposed as B, for
//       dV^T += a~^T dO and dK^T += ds^T Q (the sums, 2 x 64 registers a
//       thread, stay in registers over all the queries). Every wgmma runs
//       unconditionally; a block whose 128 keys are all masked writes zeros
//       and stages nothing. S and dP are recomputed for each slice (twice
//       the least products at Dh 320) so that the sums fit the consumers'
//       232 registers. No scratch, no second kernel, no atomics: a launch is
//       deterministic. lse and D of a tile come with its first step, into
//       one of two halves of a small ring.
//   dq, bf16 (flash_dq_wide_mma_kernel), on the tensor cores with wgmma,
//       warp-specialized as the forward. A block owns MR = 128 queries of
//       one b*h (64 a consumer warpgroup) and one slice of dQ's output
//       columns, and walks the key tiles in order, as the TPU kernel walks
//       its key blocks with dQ in VMEM: the slice's dQ stays in registers
//       for the whole walk (no scratch, no atomics, no second kernel, no
//       key split; blocks numbered slice fastest, then query tile, then
//       b*h). Registers decide the design: a consumer thread holds W / 2
//       fp32 sums of a W-column slice, NT / 2 each of S and dP for a tile
//       of NT keys and NT / 4 of ds's A fragments, within 232: NT =
//       XNT_DQ = 64 keys, slices of XNV_DQ = 3 chunks (192 columns; 96 + 32
//       + 32 + 16 registers), S and dP recomputed for each slice (10 Dh
//       operations a (query, key) at Dh 320 against the least 6 Dh). 32-key
//       tiles over 320 columns (no recompute, S and dP by the half-width
//       m64n32k16) took about 20% longer on an H100 at [8*2, 1100, 320]
//       (144 blocks, two waves of one a SM, the second nearly empty, against
//       288) and 3-5% less at EHRTrainer's [16*2, 2003, 320].
//       Bound: 6 Dh operations a (query, valid key), 37.17 GFLOP at [8*2,
//       1100, 320], 0.0376 ms at the bf16 peak: operations bound it, and
//       the per-score CUDA-core work (ex2, the hash, ds) sits between each
//       tile's products.
//       A key tile is nc = ceil(Dh / 64) score steps, each staging K's and
//       V's chunk (and Q's and dO's unless they stay resident, which they
//       do where they fit: Dh up to 320) and summing S = Q K^T and dP = dO
//       V^T for the warpgroup's 64 queries (Q, dO as A and K, V as B, all
//       read from shared memory); then, on the fp32 fragments, a = 2^(s c -
//       lse log2 e) on valid keys (0 on masked ones), the hashed keep
//       factor from premultiplied terms and ds = a (keep dP - D), repacked
//       from the registers as bf16 A fragments (the TPU's
//       ds.astype(k.dtype)); the slice's nv steps stage its chunks of K
//       again, read with the keys as the reduction (the forward's P V
//       mode), for dQ += ds K. lse and D of a thread's two rows are read
//       once into registers. S and dP are summed by wgmma over the whole
//       width, unlike the forward's S: chunk sums in fp32 cost a wait per
//       chunk, and dk / dv, whose kernel has no registers for them, differ
//       from the plain version in as many elements (about 0.7% at 4,096
//       keys on an H100, under the 1% the checks allow). A key tile with
//       no valid key is skipped by the producer and the consumers alike
//       (the key mask's bits in shared memory, as the forward keeps them);
//       a batch row with none writes dq = 0. dq = sm_scale dQ, staged as
//       bf16 rows and stored.
//   dq and dkv in fp32, on the CUDA cores. dq: one block of WT threads per
//       (b*h, WQ queries); dkv: one per (b*h, WT keys), thread t scoring
//       key t.
//   dq: key tiles of WT: s = q.k and t = dO.v by tile_dots, a = exp(s *
//       sm_scale - lse), ds = a (keep t - D), acc += ds K; a tile with no
//       valid key is skipped; dq = sm_scale acc.
//   dkv: query groups of WG = 32 (four tile_dots of WQ rows each for s and
//       for t): ds and a~ = keep a, rounded to T, staged in shared memory;
//       then the thread owning column d holds the group's q and dO at d in
//       registers and adds sum_i ds_ij q_id and sum_i a~_ij dO_id to row j
//       of the scratch, for each valid key j of the block (so a warp's
//       scratch accesses are 32 neighbouring columns of one row). The
//       query groups are split into runs of `gps` groups (blockIdx.z), each
//       summing into a scratch slab of its own, so that few (b*h, key
//       block) pairs still fill the card; a second kernel adds the slabs in
//       split order (dk = sm_scale acc_k). A block whose keys are all
//       masked leaves its slab rows zero.
constexpr int WG = 32;  // queries a dkv group

// the keep factor of element (row i, column j) of bh: 1 / (1 - rate) where
// the hash keeps it, 0 where it drops it, 1 without dropout
__device__ __forceinline__ float keep_factor(const Params& P, uint32_t seed_term, int i,
                                             int j, float keep_scale) {
  if (P.rate <= 0.f) return 1.f;
  return hash_bits((uint32_t)i * ROW_MUL, (uint32_t)j * COL_MUL, seed_term) >= P.threshold
             ? keep_scale : 0.f;
}

constexpr int XST_FWD = 4;  // pipeline stages of the bf16 wide forward
constexpr int XNV_FWD = 4;  // chunks of its output slice: 3 or 4
constexpr int FWD_THREADS = X_THREADS;  // two consumer warpgroups and a producer warpgroup
constexpr int FWD_QCHUNK = MR * XC * 2;  // bytes of Q's staged chunk
constexpr int FWD_KCHUNK = MT * XC * 2;  // bytes of a K or V chunk

// dynamic shared memory of the bf16 wide forward: Q's resident chunks (or
// room for one in each stage), the stages, their mbarriers and the
// key-mask bits, or the output tile if larger
__host__ __device__ constexpr size_t fwd_wide_smem(int Dh, int nv, bool q_resident, int Lk) {
  const size_t chunks = (size_t)(Dh + XC - 1) / XC;
  const size_t layout = (q_resident ? chunks * FWD_QCHUNK + (size_t)XST_FWD * FWD_KCHUNK
                                    : (size_t)XST_FWD * (FWD_QCHUNK + FWD_KCHUNK)) +
                        16 * XST_FWD + (size_t)((Lk + 31) / 32) * 4;
  const size_t out_tile = (size_t)MR * (nv * XC + 8) * 2;
  return layout > out_tile ? layout : out_tile;
}

template <int NV, bool kDrop>
__global__ void __launch_bounds__(FWD_THREADS, 1)
flash_fwd_wide_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const uint8_t* __restrict__ mask,
                          bf16* __restrict__ out, float* __restrict__ lse, int Dh, int slices,
                          int q_resident, Params P) {
  constexpr int TPB = KB / MT;  // tiles per key block
  const int nc = (Dh + XC - 1) / XC;  // score chunks
  // a stage: [Q's chunk unless resident,] K's or V's chunk
  const int stage_bytes = q_resident ? FWD_KCHUNK : FWD_QCHUNK + FWD_KCHUNK;
  extern __shared__ __align__(1024) uint8_t wide_smem[];
  uint8_t* q_res = wide_smem;  // resident: [nc][FWD_QCHUNK]
  uint8_t* ring = q_res + (q_resident ? nc * FWD_QCHUNK : 0);  // [XST_FWD][stage_bytes]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + XST_FWD * stage_bytes);  // [XST_FWD]
  uint64_t* empty = full + XST_FWD;                                               // [XST_FWD]
  uint32_t* kbits = reinterpret_cast<uint32_t*>(empty + XST_FWD);

  const int n_qt = (P.Lq + MR - 1) / MR;
  const int slice = blockIdx.x % slices;
  const int qt = (blockIdx.x / slices) % n_qt;
  const int bh = blockIdx.x / slices / n_qt;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wg = warpgroup_index();  // 0, 1: rows 64 wg .. 64 wg + 63; 2: the producer
  const int qb = qt * MR;            // the block's first query
  const int q0 = qb + warp * 16;     // a consumer warp's first query
  const int n0 = slice * NV * XC;    // the slice's first column
  const int nv = min(NV, (Dh - n0 + XC - 1) / XC);  // its chunks with a column < Dh
  const int elems = copy_elems(Dh);
  const int n_words = (P.Lk + 31) / 32;
  const int n_tiles = (P.Lk + MT - 1) / MT;
  const bf16* q_tile = q + ((size_t)bh * P.Lq + qb) * Dh;
  const bf16* kb = k + (size_t)bh * P.Lk * Dh;
  const bf16* vb = v + (size_t)bh * P.Lk * Dh;
  if (wg < 2) load_key_bits(mask + (size_t)(bh / P.H) * P.Lk, P.Lk, n_words, kbits);
  if (smem_u32(wide_smem) % X_ROWS8) __trap();  // the swizzle needs 1024-byte chunks
  if (threadIdx.x == 0) {
    for (int i = 0; i < XST_FWD; ++i) {
      mbar_init(&full[i], 128);   // the producer's threads, once their copies land
      mbar_init(&empty[i], 256);  // every consumer thread
    }
  }
  if (q_resident) {  // every thread copies a share, landed before the loop
    for (int c = 0; c < nc; ++c)
      stage_chunk(reinterpret_cast<bf16*>(q_res + c * FWD_QCHUNK), q_tile, Dh, MR, P.Lq - qb,
                  c * XC, Dh, elems, threadIdx.x, FWD_THREADS);
    cp_async_wait_all();
    fence_async_smem();
  }
  __syncthreads();  // kbits, the mbarriers and a resident Q are complete

  auto word = [&](int w) { return w < n_words ? kbits[w] : 0u; };
  auto next_tile = [&](int tile) {  // the first tile from `tile` with a valid key
    while (tile < n_tiles && (word(2 * tile) | word(2 * tile + 1)) == 0u) ++tile;
    return tile;
  };
  auto group_bits = [&](int tile, int grp) {  // valid keys of a 16-key group
    return (word(2 * tile + (grp >> 1)) >> (16 * (grp & 1))) & 0xFFFFu;
  };
  // (tile, pass) after (tile, pass): the next tile of the same key block
  // and pass with a valid key; after a block's pass 0 its first such tile
  // in pass 1; after its pass 1 the first tile of a later block with one
  // (flash_fwd_mma_kernel's order). A (tile, pass) is nc steps of score
  // chunks (Q's and K's), and in pass 1 then nv steps of V's chunks.
  auto advance = [&](int& tile, int& pass) {
    const int block0 = tile / TPB * TPB;
    const int nt = next_tile(tile + 1);
    if (nt < min(block0 + TPB, n_tiles)) {
      tile = nt;
    } else if (pass == 0) {
      tile = next_tile(block0);
      pass = 1;
    } else {
      tile = nt;
      pass = 0;
    }
  };

  if (wg == 2) {
    // the producer: every step's copies, XST_FWD stages ahead at most
    regs_dec<X_REGS_PRODUCER>();
    const int tid = threadIdx.x - 256;
    int it = 0;
    for (int tile = next_tile(0), pass = 0; tile < n_tiles; advance(tile, pass)) {
      const int r0 = tile * MT;
      for (int c = 0; c < (pass ? nc + nv : nc); ++c, ++it) {
        const int slot = it % XST_FWD;
        if (it >= XST_FWD) mbar_wait(&empty[slot], ((it / XST_FWD) - 1) & 1);
        uint8_t* st = ring + slot * stage_bytes;
        bf16* kv = reinterpret_cast<bf16*>(st + (q_resident ? 0 : FWD_QCHUNK));
        if (c < nc) {
          if (!q_resident)
            stage_chunk(reinterpret_cast<bf16*>(st), q_tile, Dh, MR, P.Lq - qb, c * XC, Dh,
                        elems, tid, 128);
          stage_chunk(kv, kb + (size_t)r0 * Dh, Dh, MT, P.Lk - r0, c * XC, Dh, elems,
                      tid, 128);
        } else {
          stage_chunk(kv, vb + (size_t)r0 * Dh, Dh, MT, P.Lk - r0, n0 + (c - nc) * XC, Dh,
                      elems, tid, 128);
        }
        if (elems == 1)  // plain stores: released by the arrive itself
          mbar_arrive(&full[slot]);
        else
          mbar_arrive_copies(&full[slot]);
      }
    }
    return;
  }

  // the consumers
  regs_inc<X_REGS_CONSUMER>();
  const float cs = P.sm_scale * LOG2E;
  const float keep_scale = kDrop ? 1.f / (1.f - P.rate) : 1.f;
  const uint32_t seed_term = seed_term_of(P, bh);
  uint32_t rs[2];  // row term ^ seed term of rows g, g + 8
#pragma unroll
  for (int r = 0; r < 2; ++r) rs[r] = (uint32_t)(q0 + g + 8 * r) * ROW_MUL ^ seed_term;
  // per row g, g + 8: the running maximum of s * c, this key block's
  // maximum (pass 0) and this thread's share of l (its columns)
  float m2[2] = {MASKED, MASKED}, mx[2] = {MASKED, MASKED}, l[2] = {0.f, 0.f};
  float o[NV][32];  // the slice of O, 32 registers (C fragments) a chunk
#pragma unroll
  for (int x = 0; x < NV; ++x)
#pragma unroll
    for (int e = 0; e < 32; ++e) o[x][e] = 0.f;
  int got = 0, done = 0;  // steps acquired, steps released
  // the next step's stage, once the producer's copies into it have landed
  auto acquire = [&]() {
    mbar_wait(&full[got % XST_FWD], (got / XST_FWD) & 1);
    fence_async_smem();
    return ring + (got++ % XST_FWD) * stage_bytes;
  };
  // the oldest unreleased stage, once the wgmma reading it have completed
  auto release = [&]() { mbar_arrive(&empty[done++ % XST_FWD]); };

  for (int tile = next_tile(0), pass = 0; tile < n_tiles;) {
    // S = Q K^T of the tile for the warpgroup's 64 rows, over the width:
    // each chunk's product in a fresh accumulator, added to the sum in fp32
    // (round to nearest) once it is done. wgmma's own sum of many k-steps
    // rounds otherwise than an fp32 product: summed over the whole width,
    // the rounded probabilities of 4,096 keys differed from the plain
    // version's in 1.2% of the outputs
    float s[32], sc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) s[e] = 0.f;
    for (int c = 0; c < nc; ++c) {
      const uint8_t* st = acquire();
      const uint8_t* qc = (q_resident ? q_res + c * FWD_QCHUNK : st) + sw_off(64 * wg, 0);
      const uint8_t* kc = st + (q_resident ? 0 : FWD_QCHUNK);
      const int ks = live_steps(Dh, c * XC);
      wg_fence();
      if (ks == XC / 16) {  // a whole chunk: the four k-steps unconditionally
#pragma unroll
        for (int kk = 0; kk < XC / 16; ++kk)
          wg_ss_n64(sc, wg_desc(qc + kk * 32), wg_desc(kc + kk * 32), kk > 0);
      } else {
        for (int kk = 0; kk < ks; ++kk)
          wg_ss_n64(sc, wg_desc(qc + kk * 32), wg_desc(kc + kk * 32), kk > 0);
      }
      wg_commit();
      wg_wait_all();  // the chunk's products are done: free its stage, add them
      wg_hold(sc);
      release();
#pragma unroll
      for (int e = 0; e < 32; ++e) s[e] += sc[e];
    }
    uint32_t pa[MT / 16][4];  // P's A fragments, one per 16-key group
#pragma unroll
    for (int grp = 0; grp < MT / 16; ++grp) {
      const uint32_t gb = group_bits(tile, grp);
      pa[grp][0] = pa[grp][1] = pa[grp][2] = pa[grp][3] = 0u;  // P = 0 on a group of no key
      if (gb == 0u) continue;  // uniform over the block
      const bool full_group = gb == 0xFFFFu;
      if (pass == 0) {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (full_group || ((gb >> (8 * (e >> 2) + 2 * t + (e & 1))) & 1u))
            mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], s[8 * grp + e] * cs);
        continue;
      }
      const int j0 = tile * MT + grp * 16 + 2 * t;  // columns j0 + {0, 1, 8, 9}
      float p[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int r = (e >> 1) & 1;
        float pv = ex2(fmaf(s[8 * grp + e], cs, -m2[r]));
        if (!full_group && !((gb >> (8 * (e >> 2) + 2 * t + (e & 1))) & 1u)) pv = 0.f;
        l[r] += pv;
        if (kDrop) {
          const uint32_t ct = (uint32_t)(j0 + 8 * (e >> 2) + (e & 1)) * COL_MUL;
          pv = hash_rounds(rs[r] ^ ct) >= P.threshold ? pv * keep_scale : 0.f;
        }
        p[e] = pv;
      }
      pa[grp][0] = pack_bf16(p[0], p[1]);
      pa[grp][1] = pack_bf16(p[2], p[3]);
      pa[grp][2] = pack_bf16(p[4], p[5]);
      pa[grp][3] = pack_bf16(p[6], p[7]);
    }
    if (pass == 1) {  // O += P V over the slice's chunks of V
#pragma unroll
      for (int x = 0; x < NV; ++x) {
        if (x >= nv) break;
        const uint8_t* vc = acquire() + (q_resident ? 0 : FWD_QCHUNK);
        wg_hold(o[x]);
#pragma unroll
        for (int grp = 0; grp < MT / 16; ++grp) wg_hold(pa[grp]);
        wg_fence();
#pragma unroll
        for (int grp = 0; grp < MT / 16; ++grp)
          wg_rs_n64_t(o[x], pa[grp], wg_desc(vc + sw_off(grp * 16, 0)));
        wg_commit();
        if (x > 0) {  // the previous chunk's products are done: free its stage
          wg_wait_prev();
          release();
        }
      }
      wg_wait_all();
#pragma unroll
      for (int x = 0; x < NV; ++x) wg_hold(o[x]);
#pragma unroll
      for (int grp = 0; grp < MT / 16; ++grp) wg_hold(pa[grp]);
      release();
    }
    const int was = pass;
    advance(tile, pass);
    if (was == 0 && pass == 1) {
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
        for (int x = 0; x < NV; ++x)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            o[x][4 * j + 2 * r] *= alpha;
            o[x][4 * j + 2 * r + 1] *= alpha;
          }
        m2[r] = m_next;
        mx[r] = MASKED;
      }
    }
  }

  // l over the quad; O / l (0 for a row with no valid key) staged as bf16
  // in shared memory, then stored row by row; lse from slice 0
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(FULL_MASK, l[r], 1);
    l[r] += __shfl_xor_sync(FULL_MASK, l[r], 2);
  }
  constexpr int OLD = NV * XC + 8;
  bf16* o_s = reinterpret_cast<bf16*>(wide_smem);  // [MR][OLD]
  consumers_sync();  // both warpgroups are done with Q and the stages
#pragma unroll
  for (int x = 0; x < NV; ++x)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float lr = l[r];
        const float x0 = lr > 0.f ? o[x][4 * j + 2 * r] / lr : 0.f;
        const float x1 = lr > 0.f ? o[x][4 * j + 2 * r + 1] / lr : 0.f;
        *reinterpret_cast<uint32_t*>(o_s + (warp * 16 + g + 8 * r) * OLD + x * XC + 8 * j +
                                     2 * t) = pack_bf16(x0, x1);
      }
  consumers_sync();
  store_tile(out + ((size_t)bh * P.Lq + qb) * Dh + n0, Dh, o_s, OLD, min(MR, P.Lq - qb),
             min(NV * XC, Dh - n0), elems, 256);
  if (slice == 0 && t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + g + 8 * r;
      if (row < P.Lq)
        lse[(size_t)bh * P.Lq + row] = l[r] > 0.f ? m2[r] * LN2 + logf(l[r]) : MASKED;
    }
  }
}

constexpr int XST_DKV = 4;        // pipeline stages of the bf16 wide dkv
constexpr int XNV_DKV = 2;        // chunks of its output slice (128 columns)
constexpr int DKV_KEYS = 128;     // keys a block: two consumer warpgroups of 64
constexpr int DKV_QT = 64;        // queries a tile
constexpr int DKV_THREADS = X_THREADS;
constexpr int DKV_QCHUNK = DKV_QT * XC * 2;    // bytes of Q's or dO's staged chunk
constexpr int DKV_KCHUNK = DKV_KEYS * XC * 2;  // bytes of K's or V's chunk
// past the stages: lse and D of two query tiles, the stages' mbarriers
constexpr int DKV_SMALL = 2 * 2 * DKV_QT * 4 + 16 * XST_DKV;

// dynamic shared memory of the bf16 wide dkv: K's and V's resident chunks
// (or room for one of each in every stage), the stages of Q's and dO's
// chunks, lse / D and the mbarriers; or the two output tiles if larger
__host__ __device__ constexpr size_t dkv_wide_smem(int Dh, bool kv_resident) {
  const size_t chunks = (size_t)(Dh + XC - 1) / XC;
  const size_t layout =
      (kv_resident ? chunks * 2 * DKV_KCHUNK + (size_t)XST_DKV * 2 * DKV_QCHUNK
                   : (size_t)XST_DKV * 2 * (DKV_QCHUNK + DKV_KCHUNK)) + DKV_SMALL;
  const size_t out_tiles = 2 * (size_t)DKV_KEYS * (XNV_DKV * XC + 8) * 2;
  return layout > out_tiles ? layout : out_tiles;
}

template <bool kDrop>
__global__ void __launch_bounds__(DKV_THREADS, 1)
flash_dkv_wide_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const uint8_t* __restrict__ mask,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          const bf16* __restrict__ dout, bf16* __restrict__ dk,
                          bf16* __restrict__ dv, int Dh, int slices, int kv_resident, Params P) {
  const int nc = (Dh + XC - 1) / XC;  // score chunks
  // a stage: Q's and dO's chunk [, K's and V's unless resident]
  const int stage_bytes = 2 * DKV_QCHUNK + (kv_resident ? 0 : 2 * DKV_KCHUNK);
  extern __shared__ __align__(1024) uint8_t wide_smem[];
  uint8_t* k_res = wide_smem;                  // resident: [nc][DKV_KCHUNK] of K
  uint8_t* v_res = k_res + nc * DKV_KCHUNK;    // then of V
  uint8_t* ring = wide_smem + (kv_resident ? 2 * nc * DKV_KCHUNK : 0);  // [XST_DKV][stage]
  float* lsed = reinterpret_cast<float*>(ring + XST_DKV * stage_bytes);  // [2][lse, D][DKV_QT]
  uint64_t* full = reinterpret_cast<uint64_t*>(lsed + 4 * DKV_QT);       // [XST_DKV]
  uint64_t* empty = full + XST_DKV;                                      // [XST_DKV]

  const int n_kb = (P.Lk + DKV_KEYS - 1) / DKV_KEYS;
  const int slice = blockIdx.x % slices;
  const int kb0 = (blockIdx.x / slices) % n_kb * DKV_KEYS;  // the block's first key
  const int bh = blockIdx.x / slices / n_kb;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wg = warpgroup_index();  // 0, 1: keys 64 wg .. 64 wg + 63; 2: the producer
  const int n0 = slice * XNV_DKV * XC;                    // the slice's first column
  const int nv = min(XNV_DKV, (Dh - n0 + XC - 1) / XC);  // its chunks with a column < Dh
  const int ncols = min(XNV_DKV * XC, Dh - n0);
  const int nrows = min(DKV_KEYS, P.Lk - kb0);
  const int elems = copy_elems(Dh);
  const int n_qt = (P.Lq + DKV_QT - 1) / DKV_QT;
  const uint8_t* mrow = mask + (size_t)(bh / P.H) * P.Lk;
  const size_t krow0 = (size_t)bh * P.Lk + kb0;
  const bf16* qb = q + (size_t)bh * P.Lq * Dh;
  const bf16* dob = dout + (size_t)bh * P.Lq * Dh;
  bf16* dk_b = dk + krow0 * Dh + n0;
  bf16* dv_b = dv + krow0 * Dh + n0;

  // a block whose 128 keys are all masked has zero gradients and stages nothing
  if (!__syncthreads_or((int)threadIdx.x < nrows && mrow[kb0 + threadIdx.x] != 0)) {
    for (int i = threadIdx.x; i < nrows * ncols; i += DKV_THREADS) {
      const size_t o = (size_t)(i / ncols) * Dh + i % ncols;
      dk_b[o] = dv_b[o] = __float2bfloat16_rn(0.f);
    }
    return;
  }
  if (smem_u32(wide_smem) % X_ROWS8) __trap();  // the swizzle needs 1024-byte chunks
  if (threadIdx.x == 0) {
    for (int i = 0; i < XST_DKV; ++i) {
      mbar_init(&full[i], 128);   // the producer's threads, once their copies land
      mbar_init(&empty[i], 256);  // every consumer thread
    }
  }
  if (kv_resident) {  // every thread copies a share, landed before the loop
    for (int c = 0; c < nc; ++c) {
      stage_chunk(reinterpret_cast<bf16*>(k_res + c * DKV_KCHUNK), k + krow0 * Dh, Dh,
                  DKV_KEYS, nrows, c * XC, Dh, elems, threadIdx.x, DKV_THREADS);
      stage_chunk(reinterpret_cast<bf16*>(v_res + c * DKV_KCHUNK), v + krow0 * Dh, Dh,
                  DKV_KEYS, nrows, c * XC, Dh, elems, threadIdx.x, DKV_THREADS);
    }
    cp_async_wait_all();
    fence_async_smem();
  }
  __syncthreads();  // the mbarriers and resident K / V are complete

  if (wg == 2) {
    // the producer: a query tile is nc steps of score chunks (Q's and dO's
    // chunk c, and K's and V's unless resident; the first step also lse and
    // D), then nv steps of the slice's chunks of Q and dO
    regs_dec<X_REGS_PRODUCER>();
    const int tid = threadIdx.x - 256;
    int it = 0;
    for (int qt = 0; qt < n_qt; ++qt) {
      const int r0 = qt * DKV_QT;
      for (int c = 0; c < nc + nv; ++c, ++it) {
        const int slot = it % XST_DKV;
        if (it >= XST_DKV) mbar_wait(&empty[slot], ((it / XST_DKV) - 1) & 1);
        uint8_t* st = ring + slot * stage_bytes;
        const int col0 = c < nc ? c * XC : n0 + (c - nc) * XC;
        stage_chunk(reinterpret_cast<bf16*>(st), qb + (size_t)r0 * Dh, Dh, DKV_QT, P.Lq - r0,
                    col0, Dh, elems, tid, 128);
        stage_chunk(reinterpret_cast<bf16*>(st + DKV_QCHUNK), dob + (size_t)r0 * Dh, Dh,
                    DKV_QT, P.Lq - r0, col0, Dh, elems, tid, 128);
        if (!kv_resident && c < nc) {
          stage_chunk(reinterpret_cast<bf16*>(st + 2 * DKV_QCHUNK), k + krow0 * Dh, Dh,
                      DKV_KEYS, nrows, col0, Dh, elems, tid, 128);
          stage_chunk(reinterpret_cast<bf16*>(st + 2 * DKV_QCHUNK + DKV_KCHUNK), v + krow0 * Dh,
                      Dh, DKV_KEYS, nrows, col0, Dh, elems, tid, 128);
        }
        // lse and D of the tile into its half of lsed (zeros past Lq). The
        // half is written again two tiles on, after the consumers released a
        // step of the next tile: nc + nv >= XST_DKV steps a tile (the entry
        // checks it), so they are done with this tile's terms by then.
        if (c == 0) {
          const int i = r0 + (tid & (DKV_QT - 1));
          const float* src = tid < DKV_QT ? lse : delta;
          cp_async4(lsed + (qt & 1) * 2 * DKV_QT + tid,
                    src + (size_t)bh * P.Lq + min(i, P.Lq - 1), i < P.Lq);
        }
        if (elems == 1) {  // plain stores: released by the arrive itself
          cp_async_wait_all();
          mbar_arrive(&full[slot]);
        } else {
          mbar_arrive_copies(&full[slot]);
        }
      }
    }
    return;
  }

  // the consumers: warpgroup wg owns keys kb0 + 64 wg .. + 63, a warp 16 of
  // them, a thread rows g and g + 8 of its warp's
  regs_inc<X_REGS_CONSUMER>();
  const float cs = P.sm_scale * LOG2E;
  const float keep_scale = kDrop ? 1.f / (1.f - P.rate) : 1.f;
  const uint32_t seed_term = seed_term_of(P, bh);
  const int wk = kb0 + 64 * wg + 16 * (warp & 3);  // the warp's first key
  uint32_t ks[2];  // key (column) term ^ seed term of rows g, g + 8
  bool valid[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = wk + g + 8 * r;
    ks[r] = (uint32_t)j * COL_MUL ^ seed_term;
    valid[r] = j < P.Lk && mrow[j] != 0;
  }
  const int wg_rows = 64 * wg * 128;  // byte offset of the warpgroup's rows in a K / V chunk
  float dk_acc[XNV_DKV][32], dv_acc[XNV_DKV][32];  // the slice of dK^T, dV^T, C fragments
#pragma unroll
  for (int x = 0; x < XNV_DKV; ++x)
#pragma unroll
    for (int e = 0; e < 32; ++e) dk_acc[x][e] = dv_acc[x][e] = 0.f;
  int got = 0, done = 0;  // steps acquired, steps released
  auto acquire = [&]() {
    mbar_wait(&full[got % XST_DKV], (got / XST_DKV) & 1);
    fence_async_smem();
    return ring + (got++ % XST_DKV) * stage_bytes;
  };
  auto release = [&]() { mbar_arrive(&empty[done++ % XST_DKV]); };

  for (int qt = 0; qt < n_qt; ++qt) {
    // S^T = K Q^T and dP^T = V dO^T for the warpgroup's 64 keys and the
    // tile's 64 queries, over the width; the first products start the sums
    float s[32], dp[32];
    for (int c = 0; c < nc; ++c) {
      const uint8_t* st = acquire();
      const uint8_t* kc = (kv_resident ? k_res + c * DKV_KCHUNK : st + 2 * DKV_QCHUNK) + wg_rows;
      const uint8_t* vc =
          (kv_resident ? v_res + c * DKV_KCHUNK : st + 2 * DKV_QCHUNK + DKV_KCHUNK) + wg_rows;
      if (c > 0) {
        wg_hold(s);
        wg_hold(dp);
      }
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < XC / 16; ++kk)
        wg_ss_n64(s, wg_desc(kc + kk * 32), wg_desc(st + kk * 32), c > 0 || kk > 0);
#pragma unroll
      for (int kk = 0; kk < XC / 16; ++kk)
        wg_ss_n64(dp, wg_desc(vc + kk * 32), wg_desc(st + DKV_QCHUNK + kk * 32), c > 0 || kk > 0);
      wg_commit();
      if (c > 0) {  // the previous chunk's products are done: free its stage
        wg_wait_prev();
        release();
      }
    }
    wg_wait_all();
    wg_hold(s);
    wg_hold(dp);
    release();

    // a = 2^(s c - lse log2 e) on valid keys, the keep factor, ds = a (keep
    // dP - D) into dp and a~ = keep a into s, per element (key row, query
    // column 8j + 2t + cc); a query past Lq has zero Q and dO rows, so its
    // s, dP and products are 0
    const float* lse_t = lsed + (qt & 1) * 2 * DKV_QT;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const int col = 8 * j + 2 * t + cc;
        const float l2 = lse_t[col] * LOG2E, dcol = lse_t[DKV_QT + col];
        const uint32_t rt = (uint32_t)(qt * DKV_QT + col) * ROW_MUL;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int e = 4 * j + 2 * r + cc;
          float a = ex2(fmaf(s[e], cs, -l2));
          if (!valid[r]) a = 0.f;
          float tt = dp[e], a_drop = a;
          if (kDrop) {
            const bool keep = hash_rounds(rt ^ ks[r]) >= P.threshold;
            tt = keep ? tt * keep_scale : 0.f;
            a_drop = keep ? a * keep_scale : 0.f;
          }
          dp[e] = a * (tt - dcol);
          s[e] = a_drop;
        }
      }
    // a~^T and ds^T, rounded to bf16, as the A fragments of the products
    // over the tile's queries (the TPU's a_drop.astype(do.dtype) and
    // ds.astype(q.dtype))
    uint32_t ada[DKV_QT / 16][4], dsa[DKV_QT / 16][4];
#pragma unroll
    for (int kk = 0; kk < DKV_QT / 16; ++kk)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        ada[kk][x] = pack_bf16(s[8 * kk + 2 * x], s[8 * kk + 2 * x + 1]);
        dsa[kk][x] = pack_bf16(dp[8 * kk + 2 * x], dp[8 * kk + 2 * x + 1]);
      }
    // dV^T += a~^T dO and dK^T += ds^T Q over the slice's chunks (dO and Q
    // staged row-major, read transposed)
#pragma unroll
    for (int x = 0; x < XNV_DKV; ++x) {
      if (x >= nv) break;
      const uint8_t* st = acquire();
      wg_hold(dv_acc[x]);
      wg_hold(dk_acc[x]);
#pragma unroll
      for (int kk = 0; kk < DKV_QT / 16; ++kk) {
        wg_hold(ada[kk]);
        wg_hold(dsa[kk]);
      }
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < DKV_QT / 16; ++kk)
        wg_rs_n64_t(dv_acc[x], ada[kk], wg_desc(st + DKV_QCHUNK + sw_off(16 * kk, 0)));
#pragma unroll
      for (int kk = 0; kk < DKV_QT / 16; ++kk)
        wg_rs_n64_t(dk_acc[x], dsa[kk], wg_desc(st + sw_off(16 * kk, 0)));
      wg_commit();
      if (x > 0) {  // the previous chunk's products are done: free its stage
        wg_wait_prev();
        release();
      }
    }
    wg_wait_all();
#pragma unroll
    for (int x = 0; x < XNV_DKV; ++x) {
      wg_hold(dv_acc[x]);
      wg_hold(dk_acc[x]);
    }
#pragma unroll
    for (int kk = 0; kk < DKV_QT / 16; ++kk) {
      wg_hold(ada[kk]);
      wg_hold(dsa[kk]);
    }
    release();
  }

  // dK = sm_scale * sums and dV, staged as bf16 rows in shared memory, then
  // stored row by row
  constexpr int OLD = XNV_DKV * XC + 8;
  bf16* dk_s = reinterpret_cast<bf16*>(wide_smem);  // [DKV_KEYS][OLD]
  bf16* dv_s = dk_s + DKV_KEYS * OLD;               // [DKV_KEYS][OLD]
  consumers_sync();  // both warpgroups are done with K, V and the stages
#pragma unroll
  for (int x = 0; x < XNV_DKV; ++x)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int o = (64 * wg + 16 * (warp & 3) + g + 8 * r) * OLD + x * XC + 8 * j + 2 * t;
        *reinterpret_cast<uint32_t*>(dk_s + o) = pack_bf16(
            P.sm_scale * dk_acc[x][4 * j + 2 * r], P.sm_scale * dk_acc[x][4 * j + 2 * r + 1]);
        *reinterpret_cast<uint32_t*>(dv_s + o) =
            pack_bf16(dv_acc[x][4 * j + 2 * r], dv_acc[x][4 * j + 2 * r + 1]);
      }
  consumers_sync();
  store_tile(dk_b, Dh, dk_s, OLD, nrows, ncols, elems, 256);
  store_tile(dv_b, Dh, dv_s, OLD, nrows, ncols, elems, 256);
}

constexpr int XST_DQ = 4;             // pipeline stages of the bf16 wide dq
constexpr int XNT_DQ = 64;             // keys a tile
constexpr int XNV_DQ = 3;              // chunks of an output slice (192 columns)
constexpr int DQ_THREADS = X_THREADS;  // two consumer warpgroups and a producer warpgroup
constexpr int DQ_QCHUNK = MR * XC * 2;  // bytes of Q's or dO's staged chunk

// dynamic shared memory of the bf16 wide dq: Q's and dO's resident chunks
// (or room for one of each in every stage), the stages of K's and V's
// chunks, their mbarriers and the key-mask bits; or the output tile if
// larger
__host__ __device__ constexpr size_t dq_wide_smem(int Dh, bool q_resident, int Lk) {
  const size_t chunks = (size_t)(Dh + XC - 1) / XC;
  const size_t kv = (size_t)2 * XNT_DQ * XC * 2;  // K's and V's chunk of a tile
  const size_t layout = (q_resident ? chunks * 2 * DQ_QCHUNK + (size_t)XST_DQ * kv
                                    : (size_t)XST_DQ * (kv + 2 * DQ_QCHUNK)) +
                        16 * XST_DQ + (size_t)((Lk + 31) / 32) * 4;
  const size_t out_tile = (size_t)MR * (XNV_DQ * XC + 8) * 2;
  return layout > out_tile ? layout : out_tile;
}

template <bool kDrop>
__global__ void __launch_bounds__(DQ_THREADS, 1)
flash_dq_wide_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const uint8_t* __restrict__ mask,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         const bf16* __restrict__ dout, bf16* __restrict__ dq, int Dh,
                         int slices, int q_resident, Params P) {
  constexpr int NT = XNT_DQ, NV = XNV_DQ;
  constexpr int KCH = NT * XC * 2;  // bytes of K's or V's staged chunk
  constexpr int WPT = NT / 32;      // key-mask words a tile
  const int nc = (Dh + XC - 1) / XC;  // score chunks
  // a stage: K's and V's chunk [, Q's and dO's unless resident]
  const int stage_bytes = 2 * KCH + (q_resident ? 0 : 2 * DQ_QCHUNK);
  extern __shared__ __align__(1024) uint8_t wide_smem[];
  uint8_t* q_res = wide_smem;                // resident: [nc][DQ_QCHUNK] of Q
  uint8_t* d_res = q_res + nc * DQ_QCHUNK;   // then of dO
  uint8_t* ring = wide_smem + (q_resident ? 2 * nc * DQ_QCHUNK : 0);  // [XST_DQ][stage]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + XST_DQ * stage_bytes);  // [XST_DQ]
  uint64_t* empty = full + XST_DQ;                                              // [XST_DQ]
  uint32_t* kbits = reinterpret_cast<uint32_t*>(empty + XST_DQ);

  const int n_qt = (P.Lq + MR - 1) / MR;
  const int slice = blockIdx.x % slices;
  const int qt = (blockIdx.x / slices) % n_qt;
  const int bh = blockIdx.x / slices / n_qt;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wg = warpgroup_index();  // 0, 1: queries 64 wg .. 64 wg + 63; 2: the producer
  const int qb = qt * MR;            // the block's first query
  const int q0 = qb + warp * 16;     // a consumer warp's first query
  const int n0 = slice * NV * XC;    // the slice's first column
  const int nv = min(NV, (Dh - n0 + XC - 1) / XC);  // its chunks with a column < Dh
  const int elems = copy_elems(Dh);
  const int n_words = (P.Lk + 31) / 32;
  const int n_tiles = (P.Lk + NT - 1) / NT;
  const size_t qrow0 = (size_t)bh * P.Lq + qb;
  const bf16* q_tile = q + qrow0 * Dh;
  const bf16* do_tile = dout + qrow0 * Dh;
  const bf16* kb = k + (size_t)bh * P.Lk * Dh;
  const bf16* vb = v + (size_t)bh * P.Lk * Dh;
  if (wg < 2) load_key_bits(mask + (size_t)(bh / P.H) * P.Lk, P.Lk, n_words, kbits);
  if (smem_u32(wide_smem) % X_ROWS8) __trap();  // the swizzle needs 1024-byte chunks
  if (threadIdx.x == 0) {
    for (int i = 0; i < XST_DQ; ++i) {
      mbar_init(&full[i], 128);   // the producer's threads, once their copies land
      mbar_init(&empty[i], 256);  // every consumer thread
    }
  }
  if (q_resident) {  // every thread copies a share, landed before the loop
    for (int c = 0; c < nc; ++c) {
      stage_chunk(reinterpret_cast<bf16*>(q_res + c * DQ_QCHUNK), q_tile, Dh, MR, P.Lq - qb,
                  c * XC, Dh, elems, threadIdx.x, DQ_THREADS);
      stage_chunk(reinterpret_cast<bf16*>(d_res + c * DQ_QCHUNK), do_tile, Dh, MR, P.Lq - qb,
                  c * XC, Dh, elems, threadIdx.x, DQ_THREADS);
    }
    cp_async_wait_all();
    fence_async_smem();
  }
  __syncthreads();  // kbits, the mbarriers and a resident Q / dO are complete

  auto word = [&](int w) { return w < n_words ? kbits[w] : 0u; };
  auto next_tile = [&](int tile) {  // the first tile from `tile` with a valid key
    for (; tile < n_tiles; ++tile) {
      uint32_t any = 0u;
#pragma unroll
      for (int w = 0; w < WPT; ++w) any |= word(tile * WPT + w);
      if (any != 0u) break;
    }
    return tile;
  };
  auto group_bits = [&](int tile, int grp) {  // valid keys of a 16-key group
    const int g16 = tile * (NT / 16) + grp;
    return (word(g16 >> 1) >> (16 * (g16 & 1))) & 0xFFFFu;
  };

  if (wg == 2) {
    // the producer: a key tile is nc steps of score chunks (K's and V's
    // chunk c, and Q's and dO's unless resident), then nv steps of the
    // slice's chunks of K
    regs_dec<X_REGS_PRODUCER>();
    const int tid = threadIdx.x - 256;
    int it = 0;
    for (int tile = next_tile(0); tile < n_tiles; tile = next_tile(tile + 1)) {
      const int r0 = tile * NT;
      for (int c = 0; c < nc + nv; ++c, ++it) {
        const int slot = it % XST_DQ;
        if (it >= XST_DQ) mbar_wait(&empty[slot], ((it / XST_DQ) - 1) & 1);
        uint8_t* st = ring + slot * stage_bytes;
        const int col0 = c < nc ? c * XC : n0 + (c - nc) * XC;
        stage_chunk(reinterpret_cast<bf16*>(st), kb + (size_t)r0 * Dh, Dh, NT, P.Lk - r0, col0,
                    Dh, elems, tid, 128);
        if (c < nc) {
          stage_chunk(reinterpret_cast<bf16*>(st + KCH), vb + (size_t)r0 * Dh, Dh, NT,
                      P.Lk - r0, col0, Dh, elems, tid, 128);
          if (!q_resident) {
            stage_chunk(reinterpret_cast<bf16*>(st + 2 * KCH), q_tile, Dh, MR, P.Lq - qb, col0,
                        Dh, elems, tid, 128);
            stage_chunk(reinterpret_cast<bf16*>(st + 2 * KCH + DQ_QCHUNK), do_tile, Dh, MR,
                        P.Lq - qb, col0, Dh, elems, tid, 128);
          }
        }
        if (elems == 1)  // plain stores: released by the arrive itself
          mbar_arrive(&full[slot]);
        else
          mbar_arrive_copies(&full[slot]);
      }
    }
    return;
  }

  // the consumers: warpgroup wg owns queries qb + 64 wg .. + 63, a warp 16
  // of them, a thread rows g and g + 8 of its warp's
  regs_inc<X_REGS_CONSUMER>();
  const float cs = P.sm_scale * LOG2E;
  const float keep_scale = kDrop ? 1.f / (1.f - P.rate) : 1.f;
  const uint32_t seed_term = seed_term_of(P, bh);
  float lse2[2], dd[2];  // lse log2 e and D of rows g, g + 8 (0 past Lq)
  uint32_t rs[2];        // row term ^ seed term of rows g, g + 8
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + g + 8 * r;
    const bool in = row < P.Lq;
    lse2[r] = in ? lse[(size_t)bh * P.Lq + row] * LOG2E : 0.f;
    dd[r] = in ? delta[(size_t)bh * P.Lq + row] : 0.f;
    rs[r] = (uint32_t)row * ROW_MUL ^ seed_term;
  }
  const int wg_rows = 64 * wg * 128;  // byte offset of the warpgroup's rows in a Q / dO chunk
  float acc[NV][32];  // the slice of dQ, 32 registers (C fragments) a chunk
#pragma unroll
  for (int x = 0; x < NV; ++x)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[x][e] = 0.f;
  int got = 0, done = 0;  // steps acquired, steps released
  // the next step's stage, once the producer's copies into it have landed
  auto acquire = [&]() {
    mbar_wait(&full[got % XST_DQ], (got / XST_DQ) & 1);
    fence_async_smem();
    return ring + (got++ % XST_DQ) * stage_bytes;
  };
  // the oldest unreleased stage, once the wgmma reading it have completed
  auto release = [&]() { mbar_arrive(&empty[done++ % XST_DQ]); };

  for (int tile = next_tile(0); tile < n_tiles; tile = next_tile(tile + 1)) {
    // S = Q K^T and dP = dO V^T for the warpgroup's 64 queries and the
    // tile's NT keys, over the width; the first products start the sums
    float s[NT / 2], dp[NT / 2];
    for (int c = 0; c < nc; ++c) {
      const uint8_t* st = acquire();
      const uint8_t* qc = (q_resident ? q_res + c * DQ_QCHUNK : st + 2 * KCH) + wg_rows;
      const uint8_t* dc =
          (q_resident ? d_res + c * DQ_QCHUNK : st + 2 * KCH + DQ_QCHUNK) + wg_rows;
      const int ks = live_steps(Dh, c * XC);
      if (c > 0) {
        wg_hold(s);
        wg_hold(dp);
      }
      wg_fence();
      if (ks == XC / 16) {  // a whole chunk: the four k-steps unconditionally
#pragma unroll
        for (int kk = 0; kk < XC / 16; ++kk)
          wg_ss_n64(s, wg_desc(qc + kk * 32), wg_desc(st + kk * 32), c > 0 || kk > 0);
#pragma unroll
        for (int kk = 0; kk < XC / 16; ++kk)
          wg_ss_n64(dp, wg_desc(dc + kk * 32), wg_desc(st + KCH + kk * 32), c > 0 || kk > 0);
      } else {
        for (int kk = 0; kk < ks; ++kk)
          wg_ss_n64(s, wg_desc(qc + kk * 32), wg_desc(st + kk * 32), c > 0 || kk > 0);
        for (int kk = 0; kk < ks; ++kk)
          wg_ss_n64(dp, wg_desc(dc + kk * 32), wg_desc(st + KCH + kk * 32), c > 0 || kk > 0);
      }
      wg_commit();
      if (c > 0) {  // the previous chunk's products are done: free its stage
        wg_wait_prev();
        release();
      }
    }
    wg_wait_all();
    wg_hold(s);
    wg_hold(dp);
    release();

    // a = 2^(s c - lse log2 e) on valid keys, the keep factor and ds = a
    // (keep dP - D) per element (query row, key column), rounded to bf16
    // as the A fragments of dQ += ds K (the TPU's ds.astype(k.dtype)); 0 on
    // a 16-key group with no valid key, so every wgmma runs
    // unconditionally
    uint32_t dsa[NT / 16][4];
#pragma unroll
    for (int grp = 0; grp < NT / 16; ++grp) {
      const uint32_t gb = group_bits(tile, grp);
      dsa[grp][0] = dsa[grp][1] = dsa[grp][2] = dsa[grp][3] = 0u;
      if (gb == 0u) continue;  // uniform over the block
      const bool full_group = gb == 0xFFFFu;
      const int j0 = tile * NT + grp * 16 + 2 * t;  // columns j0 + {0, 1, 8, 9}
      float ds[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int r = (e >> 1) & 1;
        float a = ex2(fmaf(s[8 * grp + e], cs, -lse2[r]));
        if (!full_group && !((gb >> (8 * (e >> 2) + 2 * t + (e & 1))) & 1u)) a = 0.f;
        float tt = dp[8 * grp + e];
        if (kDrop) {
          const uint32_t ct = (uint32_t)(j0 + 8 * (e >> 2) + (e & 1)) * COL_MUL;
          tt = hash_rounds(rs[r] ^ ct) >= P.threshold ? tt * keep_scale : 0.f;
        }
        ds[e] = a * (tt - dd[r]);
      }
#pragma unroll
      for (int x = 0; x < 4; ++x) dsa[grp][x] = pack_bf16(ds[2 * x], ds[2 * x + 1]);
    }
    // dQ += ds K over the slice's chunks of K (its rows the reduction)
#pragma unroll
    for (int x = 0; x < NV; ++x) {
      if (x >= nv) break;
      const uint8_t* kc = acquire();
      wg_hold(acc[x]);
#pragma unroll
      for (int grp = 0; grp < NT / 16; ++grp) wg_hold(dsa[grp]);
      wg_fence();
#pragma unroll
      for (int grp = 0; grp < NT / 16; ++grp)
        wg_rs_n64_t(acc[x], dsa[grp], wg_desc(kc + sw_off(grp * 16, 0)));
      wg_commit();
      if (x > 0) {  // the previous chunk's products are done: free its stage
        wg_wait_prev();
        release();
      }
    }
    wg_wait_all();
#pragma unroll
    for (int x = 0; x < NV; ++x) wg_hold(acc[x]);
#pragma unroll
    for (int grp = 0; grp < NT / 16; ++grp) wg_hold(dsa[grp]);
    release();
  }

  // dq = sm_scale * dQ (0 for a row with no valid key), staged as bf16 in
  // shared memory, then stored row by row
  constexpr int OLD = NV * XC + 8;
  bf16* o_s = reinterpret_cast<bf16*>(wide_smem);  // [MR][OLD]
  consumers_sync();  // both warpgroups are done with Q, dO and the stages
#pragma unroll
  for (int x = 0; x < NV; ++x)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<uint32_t*>(o_s + (warp * 16 + g + 8 * r) * OLD + x * XC + 8 * j +
                                     2 * t) =
            pack_bf16(P.sm_scale * acc[x][4 * j + 2 * r], P.sm_scale * acc[x][4 * j + 2 * r + 1]);
  consumers_sync();
  store_tile(dq + qrow0 * Dh + n0, Dh, o_s, OLD, min(MR, P.Lq - qb), min(NV * XC, Dh - n0),
             elems, 256);
}

template <typename T>
__global__ void __launch_bounds__(WT)
flash_fwd_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const uint8_t* __restrict__ mask,
                      T* __restrict__ out, float* __restrict__ lse, float* __restrict__ acc,
                      int Dh, Params P) {
  __shared__ DotTiles tiles;
  __shared__ __align__(16) float p_s[WQ][KB];
  __shared__ float m_s[WQ], l_s[WQ], alpha_s[WQ], red_s[WQ];

  const int bh = blockIdx.x;
  const int b = bh / P.H;
  const int i0 = blockIdx.y * WQ;
  const int nq = min(WQ, P.Lq - i0);
  const T* qb = q + ((size_t)bh * P.Lq + i0) * Dh;
  const T* kb = k + (size_t)bh * P.Lk * Dh;
  const T* vb = v + (size_t)bh * P.Lk * Dh;
  const uint8_t* mrow = mask + (size_t)b * P.Lk;
  float* acc_b = acc + ((size_t)bh * P.Lq + i0) * Dh;
  const float keep_scale = P.rate > 0.f ? 1.f / (1.f - P.rate) : 1.f;
  const uint32_t seed_term = seed_term_of(P, bh);
  const int t = threadIdx.x;

  if (t < WQ) {
    m_s[t] = MASKED;
    l_s[t] = 0.f;
  }
  zero_rows(acc_b, nq, Dh);
  __syncthreads();

  for (int j0 = 0; j0 < P.Lk; j0 += KB) {
    const int nk = min(KB, P.Lk - j0);
    bool any = false;
    for (int c = t; c < nk; c += WT) any = any || mrow[j0 + c] != 0;
    if (!__syncthreads_or(any)) continue;
    for (int c0 = 0; c0 < nk; c0 += WT) {
      float s[WQ];
      tile_dots(qb, (size_t)Dh, nq, kb + (size_t)(j0 + c0) * Dh, (size_t)Dh,
                min(WT, nk - c0), Dh, tiles, s);
      const int c = c0 + t;
      const bool valid = c < nk && mrow[j0 + c] != 0;
#pragma unroll
      for (int r = 0; r < WQ; ++r) p_s[r][c] = valid ? s[r] * P.sm_scale : MASKED;
    }
    __syncthreads();
    row_reduce<true>(&p_s[0][0], KB, nk, red_s);
    __syncthreads();
    if (t < WQ) {
      const float m_next = fmaxf(m_s[t], red_s[t]);
      alpha_s[t] = expf(m_s[t] - m_next);
      m_s[t] = m_next;
    }
    __syncthreads();
    for (int c = t; c < nk; c += WT) {
      const bool valid = mrow[j0 + c] != 0;
#pragma unroll
      for (int r = 0; r < WQ; ++r) p_s[r][c] = valid ? expf(p_s[r][c] - m_s[r]) : 0.f;
    }
    __syncthreads();
    row_reduce<false>(&p_s[0][0], KB, nk, red_s);
    __syncthreads();
    if (t < WQ) l_s[t] = l_s[t] * alpha_s[t] + red_s[t];
    for (int c = t; c < nk; c += WT) {
#pragma unroll
      for (int r = 0; r < WQ; ++r)
        p_s[r][c] = round_to<T>(p_s[r][c] * keep_factor(P, seed_term, i0 + r, j0 + c,
                                                         keep_scale));
    }
    __syncthreads();
    pv_update(acc_b, nq, alpha_s, &p_s[0][0], KB, vb + (size_t)j0 * Dh, (size_t)Dh, nk, Dh);
    __syncthreads();  // p_s and alpha_s are rewritten by the next block
  }

  for (int r = 0; r < nq; ++r) {
    const float safe_l = l_s[r] == 0.f ? 1.f : l_s[r];  // no valid key: acc is 0
    T* o = out + ((size_t)bh * P.Lq + i0 + r) * Dh;
    for (int d = t; d < Dh; d += WT) o[d] = from_f32<T>(acc_b[(size_t)r * Dh + d] / safe_l);
  }
  if (t < nq) lse[(size_t)bh * P.Lq + i0 + t] = m_s[t] + logf(l_s[t] == 0.f ? 1.f : l_s[t]);
}

template <typename T>
__global__ void __launch_bounds__(WT)
flash_dq_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const uint8_t* __restrict__ mask,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     const T* __restrict__ dout, T* __restrict__ dq, float* __restrict__ acc,
                     int Dh, Params P) {
  __shared__ DotTiles tiles;
  __shared__ __align__(16) float ds_s[WQ][WT];
  __shared__ float lse_s[WQ], d_s[WQ], one_s[WQ];

  const int bh = blockIdx.x;
  const int b = bh / P.H;
  const int i0 = blockIdx.y * WQ;
  const int nq = min(WQ, P.Lq - i0);
  const size_t row0 = (size_t)bh * P.Lq + i0;
  const T* kb = k + (size_t)bh * P.Lk * Dh;
  const T* vb = v + (size_t)bh * P.Lk * Dh;
  const uint8_t* mrow = mask + (size_t)b * P.Lk;
  float* acc_b = acc + row0 * Dh;
  const float keep_scale = P.rate > 0.f ? 1.f / (1.f - P.rate) : 1.f;
  const uint32_t seed_term = seed_term_of(P, bh);
  const int t = threadIdx.x;

  if (t < WQ) {
    lse_s[t] = t < nq ? lse[row0 + t] : 0.f;
    d_s[t] = t < nq ? delta[row0 + t] : 0.f;
    one_s[t] = 1.f;
  }
  zero_rows(acc_b, nq, Dh);
  __syncthreads();

  for (int j0 = 0; j0 < P.Lk; j0 += WT) {
    const int nk = min(WT, P.Lk - j0);
    const bool valid = t < nk && mrow[j0 + t] != 0;
    if (!__syncthreads_or(valid)) continue;
    float s[WQ], dp[WQ];
    tile_dots(q + row0 * Dh, (size_t)Dh, nq, kb + (size_t)j0 * Dh, (size_t)Dh, nk, Dh, tiles, s);
    tile_dots(dout + row0 * Dh, (size_t)Dh, nq, vb + (size_t)j0 * Dh, (size_t)Dh, nk, Dh, tiles,
              dp);
#pragma unroll
    for (int r = 0; r < WQ; ++r) {
      float ds = 0.f;
      if (valid && r < nq) {
        const float a = expf(s[r] * P.sm_scale - lse_s[r]);
        const float tt = dp[r] * keep_factor(P, seed_term, i0 + r, j0 + t, keep_scale);
        ds = a * (tt - d_s[r]);
      }
      ds_s[r][t] = round_to<T>(ds);
    }
    __syncthreads();
    pv_update(acc_b, nq, one_s, &ds_s[0][0], WT, kb + (size_t)j0 * Dh, (size_t)Dh, nk, Dh);
    __syncthreads();  // ds_s is rewritten by the next tile
  }

  for (int r = 0; r < nq; ++r) {
    T* o = dq + (row0 + r) * Dh;
    for (int d = t; d < Dh; d += WT) o[d] = from_f32<T>(P.sm_scale * acc_b[(size_t)r * Dh + d]);
  }
}

// dynamic shared memory of flash_dkv_wide_kernel: the score tiles, then ds
// and a~ of a query group (rows of WT floats, read four keys at a time)
constexpr size_t DKV_WIDE_SMEM = sizeof(DotTiles) + 2 * sizeof(float) * WG * WT;
static_assert(sizeof(DotTiles) % 16 == 0, "ds / a~ rows are 16-byte aligned");

// scratch: per split, the sums of dk then of dv, each [B*H, Lk, Dh]
template <typename T>
__global__ void __launch_bounds__(WT)
flash_dkv_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const uint8_t* __restrict__ mask,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      const T* __restrict__ dout, float* __restrict__ scratch, int gps,
                      int Dh, Params P) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  DotTiles& tiles = *reinterpret_cast<DotTiles*>(smem_raw);
  float (*ds_s)[WT] = reinterpret_cast<float (*)[WT]>(smem_raw + sizeof(DotTiles));
  float (*ad_s)[WT] = ds_s + WG;
  __shared__ float lse_s[WG], d_s[WG];
  __shared__ bool valid_s[WT];

  const int bh = blockIdx.x;
  const int b = bh / P.H;
  const int j0 = blockIdx.y * WT;
  const int nk = min(WT, P.Lk - j0);
  const int t = threadIdx.x;
  const bool valid = t < nk && mask[(size_t)b * P.Lk + j0 + t] != 0;
  const size_t krow0 = (size_t)bh * P.Lk + j0;
  const T* kb = k + krow0 * Dh;
  const T* vb = v + krow0 * Dh;
  const size_t slab = (size_t)gridDim.x * P.Lk * Dh;
  float* ak = scratch + 2 * blockIdx.z * slab + krow0 * Dh;  // the block's rows of its slabs
  float* av = ak + slab;
  const int i_end = min(P.Lq, (int)(blockIdx.z + 1) * gps * WG);
  const float keep_scale = P.rate > 0.f ? 1.f / (1.f - P.rate) : 1.f;
  const uint32_t seed_term = seed_term_of(P, bh);

  valid_s[t] = valid;
  zero_rows(ak, nk, Dh);
  zero_rows(av, nk, Dh);
  const bool any = __syncthreads_or(valid);  // else: zero gradients

  for (int i0 = blockIdx.z * gps * WG; any && i0 < i_end; i0 += WG) {
    const int ng = min(WG, i_end - i0);
    const size_t qrow0 = (size_t)bh * P.Lq + i0;
    __syncthreads();  // the previous group's ds / a~ are consumed
    if (t < WG) {
      lse_s[t] = t < ng ? lse[qrow0 + t] : 0.f;
      d_s[t] = t < ng ? delta[qrow0 + t] : 0.f;
    }
    for (int g = 0; g < WG; g += WQ) {
      const int nq = max(0, min(WQ, ng - g));
      float s[WQ], dp[WQ];
      tile_dots(q + (qrow0 + g) * Dh, (size_t)Dh, nq, kb, (size_t)Dh, nk, Dh, tiles, s);
      tile_dots(dout + (qrow0 + g) * Dh, (size_t)Dh, nq, vb, (size_t)Dh, nk, Dh, tiles, dp);
#pragma unroll
      for (int r = 0; r < WQ; ++r) {
        float ds = 0.f, ad = 0.f;
        if (valid && r < nq) {
          const float kf = keep_factor(P, seed_term, i0 + g + r, j0 + t, keep_scale);
          const float a = expf(s[r] * P.sm_scale - lse_s[g + r]);
          ad = a * kf;
          ds = a * (dp[r] * kf - d_s[g + r]);
        }
        ds_s[g + r][t] = round_to<T>(ds);
        ad_s[g + r][t] = round_to<T>(ad);
      }
    }
    __syncthreads();
    // column d of the group's q / dO rows in registers; each valid key's
    // sums over the group, four keys at a time, added to its scratch rows
    for (int d = t; d < Dh; d += WT) {
      float qd[WG], od[WG];
#pragma unroll
      for (int r = 0; r < WG; ++r) {
        qd[r] = r < ng ? to_f32(q[(qrow0 + r) * Dh + d]) : 0.f;
        od[r] = r < ng ? to_f32(dout[(qrow0 + r) * Dh + d]) : 0.f;
      }
      for (int c0 = 0; c0 < nk; c0 += 4) {
        float sk[4] = {0.f, 0.f, 0.f, 0.f}, sv[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int r = 0; r < WG; ++r) {
          const float4 x = *reinterpret_cast<const float4*>(&ds_s[r][c0]);
          const float4 y = *reinterpret_cast<const float4*>(&ad_s[r][c0]);
          sk[0] = fmaf(x.x, qd[r], sk[0]);
          sk[1] = fmaf(x.y, qd[r], sk[1]);
          sk[2] = fmaf(x.z, qd[r], sk[2]);
          sk[3] = fmaf(x.w, qd[r], sk[3]);
          sv[0] = fmaf(y.x, od[r], sv[0]);
          sv[1] = fmaf(y.y, od[r], sv[1]);
          sv[2] = fmaf(y.z, od[r], sv[2]);
          sv[3] = fmaf(y.w, od[r], sv[3]);
        }
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (c0 + c < nk && valid_s[c0 + c]) {
            ak[(size_t)(c0 + c) * Dh + d] += sk[c];
            av[(size_t)(c0 + c) * Dh + d] += sv[c];
          }
      }
    }
  }
}

// dk = sm_scale * (the splits' dk sums added in split order), dv likewise
// without the scale; n elements each
template <typename T>
__global__ void flash_dkv_wide_sum_kernel(const float* __restrict__ scratch, size_t n,
                                          int splits, float sm_scale, T* __restrict__ dk,
                                          T* __restrict__ dv) {
  for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < n;
       e += (size_t)gridDim.x * blockDim.x) {
    float sk = scratch[e], sv = scratch[n + e];
    for (int z = 1; z < splits; ++z) {
      sk += scratch[2 * z * n + e];
      sv += scratch[(2 * z + 1) * n + e];
    }
    dk[e] = from_f32<T>(sm_scale * sk);
    dv[e] = from_f32<T>(sv);
  }
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

// The wide route of K3: any Dh >= 1 (the wrappers take it above 256). The
// CUDA-core kernels (fp32: fwd, dq and dkv) take the
// arguments of medtok_flash_fwd / _dq / _dkv plus fp32 scratch for the sums:
// [B*H, Lq, Dh] (fwd, dq); dkv: for each split of `gps` query groups of WG
// (ceil(ceil(Lq / WG) / gps) splits), two [B*H, Lk, Dh] (dk's, then dv's).
namespace {

bool bad_wide(int B, int H, int Lq, int Lk, int Dh, int rows) {
  return bad_shape(B, H, Lq, Lk) || Dh <= 0 || (long long)B * H > INT_MAX ||
         (rows + WT - 1) / WT > 65535 || (rows + WQ - 1) / WQ > 65535;
}

// x_regs_of of one build of the bf16 wide forward, dq or dkv, read at its
// first launch
template <int NV, bool kDrop>
int fwd_wide_regs() {
  static const int code = x_regs_of(flash_fwd_wide_mma_kernel<NV, kDrop>);
  return code;
}
template <bool kDrop>
int dkv_wide_regs() {
  static const int code = x_regs_of(flash_dkv_wide_mma_kernel<kDrop>);
  return code;
}
template <bool kDrop>
int dq_wide_regs() {
  static const int code = x_regs_of(flash_dq_wide_mma_kernel<kDrop>);
  return code;
}

}  // namespace

extern "C" int medtok_flash_fwd_wide(const void* q, const void* k, const void* v,
                                     const void* mask, void* out, void* lse, void* scratch,
                                     int B, int H, int Lq, int Lk, int Dh, float sm_scale,
                                     float rate, unsigned threshold, const void* seed,
                                     int is_bf16, void* stream) {
  // fp32 only: bf16 takes medtok_flash_fwd_wide_mma
  if (is_bf16 || bad_wide(B, H, Lq, Lk, Dh, Lq)) return (int)cudaErrorInvalidValue;
  const Params P = params(H, Lq, Lk, sm_scale, rate, threshold, seed);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(B * H, (Lq + WQ - 1) / WQ);
  return (int)launch(flash_fwd_wide_kernel<float>, grid, WT, 0, s, in<float>(q), in<float>(k),
                     in<float>(v), in<uint8_t>(mask), outp<float>(out), outp<float>(lse),
                     outp<float>(scratch), Dh, P);
}

// The bf16 wide forward on the tensor cores, by the wrapper's plan:
// `slices` slices of nv chunks of 64 output columns (nv 3 or 4; every slice
// holds a column < Dh), Q resident in shared memory or not, `smem` bytes of
// dynamic shared memory (at least the kernel's need, at most 232,448). The
// other arguments as medtok_flash_fwd's; no scratch.
extern "C" int medtok_flash_fwd_wide_mma(const void* q, const void* k, const void* v,
                                         const void* mask, void* out, void* lse, int slices,
                                         int nv, int q_resident, int smem, int B, int H,
                                         int Lq, int Lk, int Dh, float sm_scale, float rate,
                                         unsigned threshold, const void* seed, int is_bf16,
                                         void* stream) {
  if (!is_bf16 || bad_shape(B, H, Lq, Lk) || Dh <= 0 || nv < 3 || nv > XNV_FWD ||
      slices < 1 || (long long)slices * nv * XC < Dh || (long long)(slices - 1) * nv * XC >= Dh ||
      smem < (long long)fwd_wide_smem(Dh, nv, q_resident != 0, Lk) || smem > X_SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)B * H * ((Lq + MR - 1) / MR) * slices;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  const Params P = params(H, Lq, Lk, sm_scale, rate, threshold, seed);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)blocks);
  // a kernel, once fwd_wide_regs has found the registers its split needs
  auto run = [&](auto kernel, int regs) {
    if (regs != cudaSuccess) return regs;
    return (int)launch(kernel, grid, FWD_THREADS, (size_t)smem, s, in<bf16>(q), in<bf16>(k),
                       in<bf16>(v), in<uint8_t>(mask), outp<bf16>(out), outp<float>(lse), Dh,
                       slices, q_resident, P);
  };
  const bool drop = rate > 0.f;
  if (nv == 3)
    return drop ? run(flash_fwd_wide_mma_kernel<3, true>, fwd_wide_regs<3, true>())
                : run(flash_fwd_wide_mma_kernel<3, false>, fwd_wide_regs<3, false>());
  return drop ? run(flash_fwd_wide_mma_kernel<4, true>, fwd_wide_regs<4, true>())
              : run(flash_fwd_wide_mma_kernel<4, false>, fwd_wide_regs<4, false>());
}

extern "C" int medtok_flash_dq_wide(const void* q, const void* k, const void* v,
                                    const void* mask, const void* lse, const void* delta,
                                    const void* dout, void* dq, void* scratch, int B, int H,
                                    int Lq, int Lk, int Dh, float sm_scale, float rate,
                                    unsigned threshold, const void* seed, int is_bf16,
                                    void* stream) {
  // fp32 only: bf16 takes medtok_flash_dq_wide_mma
  if (is_bf16 || bad_wide(B, H, Lq, Lk, Dh, Lq)) return (int)cudaErrorInvalidValue;
  const Params P = params(H, Lq, Lk, sm_scale, rate, threshold, seed);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(B * H, (Lq + WQ - 1) / WQ);
  return (int)launch(flash_dq_wide_kernel<float>, grid, WT, 0, s, in<float>(q), in<float>(k),
                     in<float>(v), in<uint8_t>(mask), in<float>(lse), in<float>(delta),
                     in<float>(dout), outp<float>(dq), outp<float>(scratch), Dh, P);
}

// The bf16 wide dq on the tensor cores, by the wrapper's plan: `slices`
// slices of 192 output columns (every slice holds a column < Dh), Q and dO
// resident in shared memory or not, `smem` bytes of dynamic shared memory
// (at least the kernel's need, at most 232,448). The other arguments as
// medtok_flash_dq's; no scratch.
extern "C" int medtok_flash_dq_wide_mma(const void* q, const void* k, const void* v,
                                        const void* mask, const void* lse, const void* delta,
                                        const void* dout, void* dq, int slices, int q_resident,
                                        int smem, int B, int H, int Lq, int Lk, int Dh,
                                        float sm_scale, float rate, unsigned threshold,
                                        const void* seed, int is_bf16, void* stream) {
  const int cols = XNV_DQ * XC;
  if (!is_bf16 || bad_shape(B, H, Lq, Lk) || Dh <= 0 || slices != (Dh + cols - 1) / cols ||
      smem < (long long)dq_wide_smem(Dh, q_resident != 0, Lk) || smem > X_SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)B * H * ((Lq + MR - 1) / MR) * slices;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  const Params P = params(H, Lq, Lk, sm_scale, rate, threshold, seed);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)blocks);
  // a kernel, once dq_wide_regs has found the registers its split needs
  auto run = [&](auto kernel, int regs) {
    if (regs != cudaSuccess) return regs;
    return (int)launch(kernel, grid, DQ_THREADS, (size_t)smem, s, in<bf16>(q), in<bf16>(k),
                       in<bf16>(v), in<uint8_t>(mask), in<float>(lse), in<float>(delta),
                       in<bf16>(dout), outp<bf16>(dq), Dh, slices, q_resident, P);
  };
  return rate > 0.f ? run(flash_dq_wide_mma_kernel<true>, dq_wide_regs<true>())
                    : run(flash_dq_wide_mma_kernel<false>, dq_wide_regs<false>());
}

extern "C" int medtok_flash_dkv_wide(const void* q, const void* k, const void* v,
                                     const void* mask, const void* lse, const void* delta,
                                     const void* dout, void* dk, void* dv, void* scratch,
                                     int gps, int B, int H, int Lq, int Lk, int Dh,
                                     float sm_scale, float rate, unsigned threshold,
                                     const void* seed, int is_bf16, void* stream) {
  // fp32 only: bf16 takes medtok_flash_dkv_wide_mma
  if (is_bf16 || bad_wide(B, H, Lq, Lk, Dh, Lk) || gps < 1) return (int)cudaErrorInvalidValue;
  const int groups = (Lq + WG - 1) / WG;
  const int splits = (groups + gps - 1) / gps;
  if (splits > 65535) return (int)cudaErrorInvalidValue;
  const Params P = params(H, Lq, Lk, sm_scale, rate, threshold, seed);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(B * H, (Lk + WT - 1) / WT, splits);
  float* acc = outp<float>(scratch);
  const size_t n = (size_t)B * H * Lk * Dh;
  const dim3 sum_grid((unsigned)((n + 255) / 256 < (1u << 20) ? (n + 255) / 256 : (1u << 20)));
  const cudaError_t e = launch(flash_dkv_wide_kernel<float>, grid, WT, DKV_WIDE_SMEM, s,
                               in<float>(q), in<float>(k), in<float>(v), in<uint8_t>(mask),
                               in<float>(lse), in<float>(delta), in<float>(dout), acc, gps, Dh, P);
  if (e != cudaSuccess) return (int)e;
  return (int)launch(flash_dkv_wide_sum_kernel<float>, sum_grid, 256, 0, s, (const float*)acc, n,
                     splits, sm_scale, outp<float>(dk), outp<float>(dv));
}

// The bf16 wide dk / dv on the tensor cores, by the wrapper's plan: `slices`
// slices of 128 output columns (every slice holds a column < Dh), K and V
// resident in shared memory or not, `smem` bytes of dynamic shared memory
// (at least the kernel's need, at most 232,448). The other arguments as
// medtok_flash_dkv's; no scratch. Dh above 192 (a query tile is at least
// XST_DKV steps).
extern "C" int medtok_flash_dkv_wide_mma(const void* q, const void* k, const void* v,
                                         const void* mask, const void* lse, const void* delta,
                                         const void* dout, void* dk, void* dv, int slices,
                                         int kv_resident, int smem, int B, int H, int Lq,
                                         int Lk, int Dh, float sm_scale, float rate,
                                         unsigned threshold, const void* seed, int is_bf16,
                                         void* stream) {
  const long long cols = (long long)XNV_DKV * XC;
  if (!is_bf16 || bad_shape(B, H, Lq, Lk) || Dh <= 0 || (Dh + XC - 1) / XC + 1 < XST_DKV ||
      slices != (Dh + cols - 1) / cols ||
      smem < (long long)dkv_wide_smem(Dh, kv_resident != 0) || smem > X_SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)B * H * ((Lk + DKV_KEYS - 1) / DKV_KEYS) * slices;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  const Params P = params(H, Lq, Lk, sm_scale, rate, threshold, seed);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)blocks);
  // a kernel, once dkv_wide_regs has found the registers its split needs
  auto run = [&](auto kernel, int regs) {
    if (regs != cudaSuccess) return regs;
    return (int)launch(kernel, grid, DKV_THREADS, (size_t)smem, s, in<bf16>(q), in<bf16>(k),
                       in<bf16>(v), in<uint8_t>(mask), in<float>(lse), in<float>(delta),
                       in<bf16>(dout), outp<bf16>(dk), outp<bf16>(dv), Dh, slices, kv_resident,
                       P);
  };
  return rate > 0.f ? run(flash_dkv_wide_mma_kernel<true>, dkv_wide_regs<true>())
                    : run(flash_dkv_wide_mma_kernel<false>, dkv_wide_regs<false>());
}
