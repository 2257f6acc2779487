// Kernel K3: flash attention with a key-padding mask and hashed
// attention-probability dropout, forward (K3-fwd) and backward (K3-dq,
// K3-dkv), for Hopper (sm_90a).
//
// Replaces medtok_tpu/ops/flash_attention.py::flash_attention, whose Pallas
// kernels are _flash_kernel (forward), _flash_bwd_dq_kernel and
// _flash_bwd_dkv_kernel. q, k, v, dO and the outputs are [B*H, L, Dh] in
// bf16 or fp32 with Dh = 16 (the EHR encoder: 64 wide, 4 heads); mask is
// [B, Lk] bytes (non-zero = valid key, shared by the H heads of a row); lse
// and delta are [B*H, Lq] fp32. Semantics, as in the TPU kernels:
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
// conversion, about 18 issue slots a score in each backward kernel: about
// 1.4 ms a launch at 4 warp-instructions a clock per SM. That issue floor,
// not the FLOPs, is what the backward's design works against.
//
// Design of the forward (flash_fwd_kernel, CUDA cores, both dtypes). The
// TPU walks the key axis serially in one grid dimension and carries m, l
// and acc in VMEM; here each block owns 128 queries of one (b, h), one
// thread per query keeping q, m, l and the fp32 accumulator in registers,
// and key/value tiles of 64 rows stream through shared memory, converted
// to fp32 once. fp32 takes one pass with the online softmax (rescaling
// when the running max grows). bf16 walks 512-key blocks in two passes,
// the first for the block's maximum (scores only), the second for p against
// it, so that p rounds where the TPU kernel rounds it. Masked keys are
// skipped (the test is uniform over the block).
//
// Design of the bf16 backward (flash_dq_mma_kernel, flash_dkv_mma_kernel).
// The products run on the tensor cores with mma.sync m16n8k16 (bf16 in, fp32
// sums). A block of 8 warps owns 128 rows of one (b, h), 16 per warp, and
// loops over the other axis in tiles of 64, staged by 16-byte cp.async into
// 48-byte rows (ldmatrix is then free of bank conflicts), two tiles in
// flight. Nothing carries across blocks and there are no atomics, so the
// gradients are identical from run to run.
//   dq: a warp keeps Q and dO as A fragments (one k-step at Dh = 16); per
//       16-key group S = Q K^T and dP = dO V^T are two mmas each, and the
//       fp32 ds fragments, rounded to bf16, are the A fragment of
//       dQ += ds K (K by ldmatrix.trans): the TPU's ds.astype(k.dtype).
//       The block reads the key mask once, as bits in shared memory; a key
//       tile with no valid key is never staged and a 16-key group with none
//       is not multiplied, so with suffix padding the loop ends at the
//       row's last valid key (a mask with holes is handled the same way).
//   dkv: a warp keeps K and V as A fragments; per 16-query group
//       S^T = K Q^T and dP^T = V dO^T, with lse and D per column; the
//       rounded fp32 fragments of a~^T and ds^T are the A fragments of
//       dV += a~^T dO and dK += ds^T Q (the TPU's a_drop.astype(do.dtype)
//       and ds.astype(q.dtype)). A block whose 128 keys are all masked
//       writes zeros and returns before staging a query tile; a warp whose
//       16 keys are all masked skips its products.
// Per score the CUDA-core work is kept small: log2(e) is folded into the
// scale and lse, so a = ex2(s * c - lse2) is one FFMA and one SFU op; the
// hash starts from one 3-input xor of premultiplied row, column and seed
// terms; rate 0 compiles without any keep-bit arithmetic; a group whose 16
// keys are all valid skips the mask test.
//
// fp32 backward (flash_dq_kernel, flash_dkv_kernel), the parity path: exact
// fp32 products, which the bf16 tensor cores do not give, on CUDA cores.
// dq: one thread per query keeps q, dO, lse, D and dq; keys stream as in the
// forward. dkv: one thread per key keeps k, v, dk and dv; query/dO tiles
// with their lse and D stream through shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

#include "mma_bf16.cuh"

namespace {

constexpr int DH = 16;            // head width
constexpr int RT = 128;           // rows owned by a block (one per thread)
constexpr int ST = 64;            // rows of the other axis staged per tile
constexpr int KB = 512;           // the forward's bf16 key block (TPU block_k)
constexpr float MASKED = -1e30f;  // finite -inf stand-in, as in the TPU kernel

constexpr uint32_t ROW_MUL = 2654435761u;
constexpr uint32_t COL_MUL = 0x85EBCA6Bu;
constexpr uint32_t BH_MUL = 0x9E3779B9u;

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

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* o) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* p, const float* o) {
  reinterpret_cast<float4*>(p)[0] = make_float4(o[0], o[1], o[2], o[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(o[4], o[5], o[6], o[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* o) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(o[2 * i], o[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

template <typename T>
__device__ __forceinline__ void load_row(const T* p, float* o) {
  load8(p, o);
  load8(p + 8, o + 8);
}

template <typename T>
__device__ __forceinline__ void store_row(T* p, const float* o) {
  store8(p, o);
  store8(p + 8, o + 8);
}

// x rounded to T and back: where the TPU kernel casts an fp32 operand to
// its partner's type before a product.
template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float dot16(const float* a, const float* b) {
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

__device__ __forceinline__ void axpy16(float a, const float* x, float* y) {
#pragma unroll
  for (int d = 0; d < DH; d += 4) {
    const float4 xx = *reinterpret_cast<const float4*>(x + d);
    y[d] = fmaf(a, xx.x, y[d]);
    y[d + 1] = fmaf(a, xx.y, y[d + 1]);
    y[d + 2] = fmaf(a, xx.z, y[d + 2]);
    y[d + 3] = fmaf(a, xx.w, y[d + 3]);
  }
}

// Stage rows [r0, r0 + ST) of a [rows, DH] array (and of b, unless it is
// null) into shared fp32 tiles, zeros past the end. ST * DH / 8 = 128
// chunks of 8: one per thread.
template <typename T>
__device__ __forceinline__ void stage_tiles(const T* a, const T* b, int r0,
                                            int rows, float (*a_s)[DH],
                                            float (*b_s)[DH]) {
  for (int i = threadIdx.x; i < ST * DH / 8; i += RT) {
    const int j = i / (DH / 8), d = (i % (DH / 8)) * 8;
    float ab[8], bb[8];
    const bool in = r0 + j < rows;
#pragma unroll
    for (int x = 0; x < 8; ++x) { ab[x] = 0.f; bb[x] = 0.f; }
    if (in) load8(a + (size_t)(r0 + j) * DH + d, ab);
    store8(&a_s[j][d], ab);
    if (b != nullptr) {
      if (in) load8(b + (size_t)(r0 + j) * DH + d, bb);
      store8(&b_s[j][d], bb);
    }
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

// ------------------------------------------------------------- K3-fwd ----
template <typename T>
__global__ void __launch_bounds__(RT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const uint8_t* __restrict__ mask,
                 T* __restrict__ out, float* __restrict__ lse, Params P) {
  // bf16 rounds p against the running maximum of KB-key blocks, so it
  // takes each block's maximum first; fp32 keeps one pass
  constexpr bool kBlockMax = std::is_same<T, __nv_bfloat16>::value;
  __shared__ __align__(16) float k_s[ST][DH];
  __shared__ __align__(16) float v_s[ST][DH];
  __shared__ uint32_t col_s[ST];
  __shared__ int valid_s[ST];

  const int bh = blockIdx.x;
  const int b = bh / P.H;
  const int qi = blockIdx.y * RT + threadIdx.x;
  const bool live = qi < P.Lq;
  const T* kb = k + (size_t)bh * P.Lk * DH;
  const T* vb = v + (size_t)bh * P.Lk * DH;
  const uint8_t* mrow = mask + (size_t)b * P.Lk;

  float qr[DH], acc[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) { qr[d] = 0.f; acc[d] = 0.f; }
  if (live) load_row(q + ((size_t)bh * P.Lq + qi) * DH, qr);
  float m = MASKED, l = 0.f;
  const bool drop = P.rate > 0.f;
  const float keep_scale = drop ? 1.f / (1.f - P.rate) : 1.f;
  const uint32_t row_term = (uint32_t)qi * ROW_MUL;
  const uint32_t seed_term = seed_term_of(P, bh);

  // the mask and hash column terms of the tile at t0
  auto stage_keys = [&](int t0) {
    if (threadIdx.x < ST) {
      const int j = t0 + threadIdx.x;
      valid_s[threadIdx.x] = j < P.Lk && mrow[j] != 0;
      col_s[threadIdx.x] = (uint32_t)j * COL_MUL;
    }
  };

  for (int c0 = 0; c0 < P.Lk; c0 += KB) {
    const int c1 = min(P.Lk, c0 + KB);  // KB is a multiple of ST
    if (kBlockMax) {
      float mb = m;
      for (int t0 = c0; t0 < c1; t0 += ST) {
        __syncthreads();  // the previous tile is consumed
        stage_tiles<T>(kb, nullptr, t0, P.Lk, k_s, nullptr);
        stage_keys(t0);
        __syncthreads();
        const int jn = min(ST, P.Lk - t0);
        for (int j = 0; j < jn; ++j)
          if (valid_s[j]) mb = fmaxf(mb, dot16(qr, k_s[j]) * P.sm_scale);
      }
      if (mb > m) {
        const float a = expf(m - mb);
        l *= a;
#pragma unroll
        for (int d = 0; d < DH; ++d) acc[d] *= a;
        m = mb;
      }
    }
    for (int t0 = c0; t0 < c1; t0 += ST) {
      __syncthreads();
      stage_tiles<T>(kb, vb, t0, P.Lk, k_s, v_s);
      stage_keys(t0);
      __syncthreads();

      const int jn = min(ST, P.Lk - t0);
      for (int j = 0; j < jn; ++j) {
        if (!valid_s[j]) continue;  // the same key for every thread
        const float s = dot16(qr, k_s[j]) * P.sm_scale;
        if (!kBlockMax && s > m) {
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
        axpy16(round_to<T>(pn), v_s[j], acc);
      }
    }
  }

  if (live) {
    const float safe_l = l == 0.f ? 1.f : l;  // no valid key: acc is 0
#pragma unroll
    for (int d = 0; d < DH; ++d) acc[d] = acc[d] / safe_l;
    store_row(out + ((size_t)bh * P.Lq + qi) * DH, acc);
    lse[(size_t)bh * P.Lq + qi] = m + logf(safe_l);
  }
}

// ------------------------------------------------------- K3-dq, fp32 ----
__global__ void __launch_bounds__(RT)
flash_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const uint8_t* __restrict__ mask,
                const float* __restrict__ lse, const float* __restrict__ delta,
                const float* __restrict__ dout, float* __restrict__ dq, Params P) {
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
    load_row(q + row * DH, qr);
    load_row(dout + row * DH, dor);
    lse_i = lse[row];
    d_i = delta[row];
  }
  const bool drop = P.rate > 0.f;
  const float keep_scale = drop ? 1.f / (1.f - P.rate) : 1.f;
  const uint32_t row_term = (uint32_t)qi * ROW_MUL;
  const uint32_t seed_term = seed_term_of(P, bh);

  for (int t0 = 0; t0 < P.Lk; t0 += ST) {
    __syncthreads();
    stage_tiles(kb, vb, t0, P.Lk, k_s, v_s);
    if (threadIdx.x < ST) {
      const int j = t0 + threadIdx.x;
      valid_s[threadIdx.x] = j < P.Lk && mrow[j] != 0;
      col_s[threadIdx.x] = (uint32_t)j * COL_MUL;
    }
    __syncthreads();

    const int jn = min(ST, P.Lk - t0);
    for (int j = 0; j < jn; ++j) {
      if (!valid_s[j]) continue;
      const float a = expf(dot16(qr, k_s[j]) * P.sm_scale - lse_i);
      float t = dot16(dor, v_s[j]);
      if (drop)
        t *= hash_bits(row_term, col_s[j], seed_term) >= P.threshold
                 ? keep_scale : 0.f;
      axpy16(a * (t - d_i), k_s[j], acc);
    }
  }

  if (live) {
#pragma unroll
    for (int d = 0; d < DH; ++d) acc[d] *= P.sm_scale;
    store_row(dq + ((size_t)bh * P.Lq + qi) * DH, acc);
  }
}

// ------------------------------------------------------ K3-dkv, fp32 ----
__global__ void __launch_bounds__(RT)
flash_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const uint8_t* __restrict__ mask,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 const float* __restrict__ dout, float* __restrict__ dk,
                 float* __restrict__ dv, Params P) {
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
    load_row(k + row * DH, kr);
    load_row(v + row * DH, vr);
  }
  const bool drop = P.rate > 0.f;
  const float keep_scale = drop ? 1.f / (1.f - P.rate) : 1.f;
  const uint32_t col_term = (uint32_t)kj * COL_MUL;
  const uint32_t seed_term = seed_term_of(P, bh);

  for (int t0 = 0; t0 < P.Lq; t0 += ST) {
    __syncthreads();
    stage_tiles(qb, dob, t0, P.Lq, q_s, do_s);
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
      // dot16 reads its second operand as float4s, so the register row
      // goes first and the shared row second
      const float a = expf(dot16(kr, q_s[i]) * P.sm_scale - lse_s[i]);
      float t = dot16(vr, do_s[i]);
      float kf = 1.f;
      if (drop)
        kf = hash_bits(row_s[i], col_term, seed_term) >= P.threshold
                 ? keep_scale : 0.f;
      t *= kf;
      axpy16(a * kf, do_s[i], dvr);
      axpy16(a * (t - d_s[i]), q_s[i], dkr);
    }
  }

  if (live) {
#pragma unroll
    for (int d = 0; d < DH; ++d) dkr[d] *= P.sm_scale;
    const size_t row = (size_t)bh * P.Lk + kj;
    store_row(dk + row * DH, dkr);
    store_row(dv + row * DH, dvr);
  }
}

// ------------------------------------------- K3-dq / K3-dkv, bf16 mma ----
using bf16 = __nv_bfloat16;

constexpr int MW = 8;              // warps of a block
constexpr int MR = 16 * MW;        // rows owned by a block, 16 per warp
constexpr int MT = 64;             // rows of the other axis per staged tile
constexpr int MROW = DH + 8;       // padded shared row, bf16 (48 bytes)
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The A fragment of rows [r0, r0 + 16) of a [rows, DH] bf16 array, zeros
// past the end (one k-step: Dh = 16).
__device__ __forceinline__ void load_a_frag(const bf16* base, int r0, int rows,
                                            int g, int t, uint32_t* a) {
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const int r = r0 + g + 8 * (x & 1), c = 2 * t + 8 * (x >> 1);
    a[x] = r < rows ? *reinterpret_cast<const uint32_t*>(base + (size_t)r * DH + c) : 0u;
  }
}

// Copy rows [r0, r0 + MT) of one or two [rows, DH] bf16 arrays into padded
// shared tiles by cp.async (zeros past the end): 2 chunks of 16 bytes a row.
__device__ __forceinline__ void stage_mma(const bf16* a, const bf16* b, int r0, int rows,
                                          bf16* a_s, bf16* b_s) {
  for (int i = threadIdx.x; i < MT * 2; i += 32 * MW) {
    const int r = i >> 1, c = (i & 1) * 8, row = r0 + r;
    const size_t off = (size_t)min(row, rows - 1) * DH + c;
    cp_async16(a_s + r * MROW + c, a + off, row < rows);
    cp_async16(b_s + r * MROW + c, b + off, row < rows);
  }
}

// Stores a warp's 16 x 16 fp32 result (two C fragments, times `scale`) as
// bf16 rows [r0, r0 + 16) of a [rows, DH] array.
__device__ __forceinline__ void store_c_frags(bf16* base, int r0, int rows, int g, int t,
                                              const float (*c)[4], float scale) {
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + g + 8 * r;
      if (row < rows)
        *reinterpret_cast<uint32_t*>(base + (size_t)row * DH + 8 * n + 2 * t) =
            pack_bf16(c[n][2 * r] * scale, c[n][2 * r + 1] * scale);
    }
}

// B fragments of one 16-row group at p (rows of 48 bytes): `direct` for a
// product with the group's rows as the n dimension (S = Q K^T: K), `trans`
// for one with them as the k dimension (dQ = ds K: K).
__device__ __forceinline__ void b_frags(const bf16* p, int lane, uint32_t* direct) {
  ldmatrix_x4(direct, p + ((lane & 7) + ((lane >> 4) << 3)) * MROW + ((lane >> 3) & 1) * 8);
}
__device__ __forceinline__ void b_frags_trans(const bf16* p, int lane, uint32_t* trans) {
  ldmatrix_x4_trans(trans, p + ((lane & 7) + ((lane >> 3) & 1) * 8) * MROW + (lane >> 4) * 8);
}

template <bool kDrop>
__global__ void __launch_bounds__(32 * MW)
flash_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const uint8_t* __restrict__ mask,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    const bf16* __restrict__ dout, bf16* __restrict__ dq, Params P) {
  extern __shared__ uint32_t kbits[];  // the row's key mask, bit j = key j
  __shared__ __align__(16) bf16 k_s[2][MT * MROW];
  __shared__ __align__(16) bf16 v_s[2][MT * MROW];

  const int bh = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.y * MR + warp * 16;  // the warp's first query
  const int n_words = (P.Lk + 31) / 32;
  const int n_tiles = (P.Lk + MT - 1) / MT;
  const uint8_t* mrow = mask + (size_t)(bh / P.H) * P.Lk;
  const bf16* kb = k + (size_t)bh * P.Lk * DH;
  const bf16* vb = v + (size_t)bh * P.Lk * DH;

  for (int w = warp; w < n_words; w += MW) {
    const int j = w * 32 + lane;
    const unsigned bits = __ballot_sync(FULL_MASK, j < P.Lk && mrow[j] != 0);
    if (lane == 0) kbits[w] = bits;
  }

  const bool warp_live = q0 < P.Lq;
  uint32_t qa[4], da[4];
  load_a_frag(q + (size_t)bh * P.Lq * DH, q0, P.Lq, g, t, qa);
  load_a_frag(dout + (size_t)bh * P.Lq * DH, q0, P.Lq, g, t, da);
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
  float acc[2][4] = {};
  __syncthreads();  // kbits is complete

  auto word = [&](int w) { return w < n_words ? kbits[w] : 0u; };
  auto next_tile = [&](int tile) {  // the first tile from `tile` with a valid key
    while (tile < n_tiles && (word(2 * tile) | word(2 * tile + 1)) == 0u) ++tile;
    return tile;
  };

  int tile = next_tile(0), buf = 0;
  if (tile < n_tiles) {
    stage_mma(kb, vb, tile * MT, P.Lk, k_s[0], v_s[0]);
    cp_async_commit();
  }
  while (tile < n_tiles) {
    const int next = next_tile(tile + 1);
    if (next < n_tiles) {
      stage_mma(kb, vb, next * MT, P.Lk, k_s[buf ^ 1], v_s[buf ^ 1]);
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
        const bf16* kg = k_s[buf] + grp * 16 * MROW;
        const bf16* vg = v_s[buf] + grp * 16 * MROW;
        uint32_t kf[4], vf[4];
        b_frags(kg, lane, kf);
        b_frags(vg, lane, vf);
        float s[2][4] = {}, dp[2][4] = {};
        mma_bf16(s[0], qa, kf[0], kf[1]);
        mma_bf16(s[1], qa, kf[2], kf[3]);
        mma_bf16(dp[0], da, vf[0], vf[1]);
        mma_bf16(dp[1], da, vf[2], vf[3]);

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
        const uint32_t dsa[4] = {pack_bf16(ds[0][0], ds[0][1]), pack_bf16(ds[0][2], ds[0][3]),
                                 pack_bf16(ds[1][0], ds[1][1]), pack_bf16(ds[1][2], ds[1][3])};
        uint32_t kt[4];
        b_frags_trans(kg, lane, kt);
        mma_bf16(acc[0], dsa, kt[0], kt[1]);
        mma_bf16(acc[1], dsa, kt[2], kt[3]);
      }
    }
    __syncthreads();  // this buffer is consumed before the next stage overwrites it
    tile = next;
    buf ^= 1;
  }

  store_c_frags(dq + (size_t)bh * P.Lq * DH, q0, P.Lq, g, t, acc, P.sm_scale);
}

template <bool kDrop>
__global__ void __launch_bounds__(32 * MW)
flash_dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const uint8_t* __restrict__ mask,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     const bf16* __restrict__ dout, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, Params P) {
  __shared__ __align__(16) bf16 q_s[2][MT * MROW];
  __shared__ __align__(16) bf16 do_s[2][MT * MROW];
  __shared__ float lse_s[2][MT];
  __shared__ float d_s[2][MT];

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

  float dk_acc[2][4] = {}, dv_acc[2][4] = {};
  if (block_live) {
    uint32_t ka[4], va[4];
    load_a_frag(k + (size_t)bh * P.Lk * DH, k0, P.Lk, g, t, ka);
    load_a_frag(v + (size_t)bh * P.Lk * DH, k0, P.Lk, g, t, va);
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
      stage_mma(qb, dob, tile * MT, P.Lq, q_s[buf], do_s[buf]);
      for (int i = threadIdx.x; i < MT; i += 32 * MW) {
        const int row = tile * MT + i;
        const int src = min(row, P.Lq - 1);
        cp_async4(&lse_s[buf][i], lseb + src, row < P.Lq);
        cp_async4(&d_s[buf][i], deltab + src, row < P.Lq);
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
          const bf16* qg = q_s[buf] + grp * 16 * MROW;
          const bf16* dog = do_s[buf] + grp * 16 * MROW;
          uint32_t qf[4], df[4];
          b_frags(qg, lane, qf);
          b_frags(dog, lane, df);
          float st[2][4] = {}, dpt[2][4] = {};
          mma_bf16(st[0], ka, qf[0], qf[1]);
          mma_bf16(st[1], ka, qf[2], qf[3]);
          mma_bf16(dpt[0], va, df[0], df[1]);
          mma_bf16(dpt[1], va, df[2], df[3]);

          const int li = grp * 16 + 2 * t;  // local columns li + {0, 1, 8, 9}
          float ds[2][4], ad[2][4];
#pragma unroll
          for (int x = 0; x < 2; ++x)
#pragma unroll
            for (int cc = 0; cc < 2; ++cc) {
              const int col = li + 8 * x + cc;
              const float l2 = lse_s[buf][col] * LOG2E, dcol = d_s[buf][col];
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
          const uint32_t dsa[4] = {pack_bf16(ds[0][0], ds[0][1]), pack_bf16(ds[0][2], ds[0][3]),
                                   pack_bf16(ds[1][0], ds[1][1]), pack_bf16(ds[1][2], ds[1][3])};
          const uint32_t ada[4] = {pack_bf16(ad[0][0], ad[0][1]), pack_bf16(ad[0][2], ad[0][3]),
                                   pack_bf16(ad[1][0], ad[1][1]), pack_bf16(ad[1][2], ad[1][3])};
          uint32_t qt[4], dt[4];
          b_frags_trans(qg, lane, qt);
          b_frags_trans(dog, lane, dt);
          mma_bf16(dk_acc[0], dsa, qt[0], qt[1]);
          mma_bf16(dk_acc[1], dsa, qt[2], qt[3]);
          mma_bf16(dv_acc[0], ada, dt[0], dt[1]);
          mma_bf16(dv_acc[1], ada, dt[2], dt[3]);
        }
      }
      __syncthreads();  // this buffer is consumed before the next stage overwrites it
    }
  }

  store_c_frags(dk + (size_t)bh * P.Lk * DH, k0, P.Lk, g, t, dk_acc, P.sm_scale);
  store_c_frags(dv + (size_t)bh * P.Lk * DH, k0, P.Lk, g, t, dv_acc, 1.f);
}

bool bad_shape(int B, int H, int Lq, int Lk, int Dh) {
  return B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0 || Dh != DH;
}

Params params(int H, int Lq, int Lk, float sm_scale, float rate,
              unsigned threshold, const void* seed) {
  return Params{H, Lq, Lk, sm_scale, rate, threshold,
                static_cast<const long long*>(seed)};
}

// Launch flash_dq_mma_kernel<kDrop> with the key-mask bits in dynamic
// shared memory (above 48 KB only after raising the kernel's limit).
template <bool kDrop>
cudaError_t launch_dq_mma(dim3 grid, cudaStream_t s, const bf16* q, const bf16* k,
                          const bf16* v, const uint8_t* m, const float* l,
                          const float* dd, const bf16* dout, bf16* dq, const Params& P) {
  const size_t bits = (size_t)((P.Lk + 31) / 32) * sizeof(uint32_t);
  if (bits > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_dq_mma_kernel<kDrop>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bits);
    if (e != cudaSuccess) return e;
  }
  flash_dq_mma_kernel<kDrop><<<grid, 32 * MW, bits, s>>>(q, k, v, m, l, dd, dout, dq, P);
  return cudaGetLastError();
}

}  // namespace

// All tensors contiguous and 16-byte aligned. q, dO, out, dq: [B*H, Lq, 16];
// k, v, dk, dv: [B*H, Lk, 16]; bf16 (is_bf16 = 1) or fp32. mask: [B, Lk]
// bytes. lse, delta: [B*H, Lq] fp32. Dropout is on when rate > 0; a
// probability is kept where its hash >= threshold (uint32(rate * 2^32)).
// seed: one int64 on the device, of which the low 32 bits seed the hash
// (unread, and may be null, when rate is 0).
extern "C" int medtok_flash_fwd(const void* q, const void* k, const void* v,
                                const void* mask, void* out, void* lse, int B,
                                int H, int Lq, int Lk, int Dh, float sm_scale,
                                float rate, unsigned threshold, const void* seed,
                                int is_bf16, void* stream) {
  if (bad_shape(B, H, Lq, Lk, Dh)) return (int)cudaErrorInvalidValue;
  const Params P = params(H, Lq, Lk, sm_scale, rate, threshold, seed);
  const dim3 grid(B * H, (Lq + RT - 1) / RT);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  float* l = static_cast<float*>(lse);
  if (is_bf16) {
    flash_fwd_kernel<bf16><<<grid, RT, 0, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), m, static_cast<bf16*>(out), l, P);
  } else {
    flash_fwd_kernel<float><<<grid, RT, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), m, static_cast<float*>(out), l, P);
  }
  return (int)cudaGetLastError();
}

extern "C" int medtok_flash_dq(const void* q, const void* k, const void* v,
                               const void* mask, const void* lse,
                               const void* delta, const void* dout, void* dq,
                               int B, int H, int Lq, int Lk, int Dh,
                               float sm_scale, float rate, unsigned threshold,
                               const void* seed, int is_bf16, void* stream) {
  if (bad_shape(B, H, Lq, Lk, Dh)) return (int)cudaErrorInvalidValue;
  const Params P = params(H, Lq, Lk, sm_scale, rate, threshold, seed);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  const float* l = static_cast<const float*>(lse);
  const float* dd = static_cast<const float*>(delta);
  if (is_bf16) {
    const dim3 grid(B * H, (Lq + MR - 1) / MR);
    const bf16 *qp = static_cast<const bf16*>(q), *kp = static_cast<const bf16*>(k),
               *vp = static_cast<const bf16*>(v), *dop = static_cast<const bf16*>(dout);
    bf16* dqp = static_cast<bf16*>(dq);
    return (int)(rate > 0.f ? launch_dq_mma<true>(grid, s, qp, kp, vp, m, l, dd, dop, dqp, P)
                            : launch_dq_mma<false>(grid, s, qp, kp, vp, m, l, dd, dop, dqp, P));
  }
  const dim3 grid(B * H, (Lq + RT - 1) / RT);
  flash_dq_kernel<<<grid, RT, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), m, l, dd, static_cast<const float*>(dout),
      static_cast<float*>(dq), P);
  return (int)cudaGetLastError();
}

extern "C" int medtok_flash_dkv(const void* q, const void* k, const void* v,
                                const void* mask, const void* lse,
                                const void* delta, const void* dout, void* dk,
                                void* dv, int B, int H, int Lq, int Lk, int Dh,
                                float sm_scale, float rate, unsigned threshold,
                                const void* seed, int is_bf16, void* stream) {
  if (bad_shape(B, H, Lq, Lk, Dh)) return (int)cudaErrorInvalidValue;
  const Params P = params(H, Lq, Lk, sm_scale, rate, threshold, seed);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  const float* l = static_cast<const float*>(lse);
  const float* dd = static_cast<const float*>(delta);
  if (is_bf16) {
    const dim3 grid(B * H, (Lk + MR - 1) / MR);
    const bf16 *qp = static_cast<const bf16*>(q), *kp = static_cast<const bf16*>(k),
               *vp = static_cast<const bf16*>(v), *dop = static_cast<const bf16*>(dout);
    bf16 *dkp = static_cast<bf16*>(dk), *dvp = static_cast<bf16*>(dv);
    if (rate > 0.f)
      flash_dkv_mma_kernel<true><<<grid, 32 * MW, 0, s>>>(qp, kp, vp, m, l, dd, dop, dkp, dvp, P);
    else
      flash_dkv_mma_kernel<false><<<grid, 32 * MW, 0, s>>>(qp, kp, vp, m, l, dd, dop, dkp, dvp, P);
    return (int)cudaGetLastError();
  }
  const dim3 grid(B * H, (Lk + RT - 1) / RT);
  flash_dkv_kernel<<<grid, RT, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), m, l, dd, static_cast<const float*>(dout),
      static_cast<float*>(dk), static_cast<float*>(dv), P);
  return (int)cudaGetLastError();
}
