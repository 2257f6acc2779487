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
// bf16 inputs are multiplied in fp32 with fp32 sums; p~ (forward), ds and
// a~ (backward) round to bf16 before their products, where the TPU kernel
// casts them to the operand's type.
//
// Bound: at the EHR shape (B*H = 1024, L = 2003, Dh = 16, bf16) the three
// kernels move 0.27-0.41 GB each (q, k, v, dO, out: 65.6 MB apiece), 0.08-
// 0.12 ms at 3.35 TB/s, while the products are 4, 6 and 8 x
// B*H*Lq*Lk_valid*Dh FLOP: 263, 394 and 526 GFLOP per layer when every key
// is valid (0.27-0.53 ms on bf16 tensor cores, so operations bound them),
// about a quarter of that on EHR batches, whose median patient has a few
// hundred codes (then bytes bound the forward and dq). Outside that bound,
// every score also costs one exp and about a dozen integer operations of
// the hash (when dropout is on), which at Dh = 16 is as much issue work as
// the 32-48 FMAs of its products.
//
// Design. The TPU walks the key axis serially in one grid dimension and
// carries m, l and acc in VMEM; here each block owns 128 rows of one (b, h)
// and loops over the other axis itself, so nothing carries across blocks
// and no atomics are needed (gradients are deterministic run to run):
//   fwd: one thread per query keeps q, m, l and the fp32 accumulator in
//        registers; key/value tiles of 64 rows stream through shared memory,
//        converted to fp32 once; the online softmax rescales only when the
//        running max grows.
//   dq:  one thread per query keeps q, dO, lse, D and dq; keys stream as in
//        the forward.
//   dkv: one thread per key keeps k, v, dk and dv; query/dO tiles with
//        their lse and D stream through shared memory.
// Reads inside the loops are shared-memory broadcasts (all threads of a
// block read the same row). Masked keys are skipped: in fwd/dq the test is
// uniform over the block, in dkv a thread with a masked key skips its loop.
// Products run on fp32 CUDA cores, not tensor cores: this first kernel is
// simple and right; mma/wgmma, TMA and pipelining are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int DH = 16;            // head width
constexpr int RT = 128;           // rows owned by a block (one per thread)
constexpr int ST = 64;            // rows of the other axis staged per tile
constexpr float MASKED = -1e30f;  // finite -inf stand-in, as in the TPU kernel

constexpr uint32_t ROW_MUL = 2654435761u;
constexpr uint32_t COL_MUL = 0x85EBCA6Bu;
constexpr uint32_t BH_MUL = 0x9E3779B9u;

// The TPU kernel's _uniform_hash with its row, column and (seed, bh) terms
// premultiplied: x = row*ROW_MUL ^ col*COL_MUL ^ (seed + bh*BH_MUL), then
// two xorshift-multiply rounds and a final xorshift, all mod 2^32.
__device__ __forceinline__ uint32_t hash_bits(uint32_t row_term,
                                              uint32_t col_term,
                                              uint32_t seed_term) {
  uint32_t x = row_term ^ col_term ^ seed_term;
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  return x ^ (x >> 16);
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

// Stage rows [r0, r0 + ST) of two [rows, DH] arrays into shared fp32 tiles,
// zeros past the end. ST * DH / 8 = 128 chunks of 8: one per thread.
template <typename T>
__device__ __forceinline__ void stage_pair(const T* a, const T* b, int r0,
                                           int rows, float (*a_s)[DH],
                                           float (*b_s)[DH]) {
  for (int i = threadIdx.x; i < ST * DH / 8; i += RT) {
    const int j = i / (DH / 8), d = (i % (DH / 8)) * 8;
    float ab[8], bb[8];
    if (r0 + j < rows) {
      load8(a + (size_t)(r0 + j) * DH + d, ab);
      load8(b + (size_t)(r0 + j) * DH + d, bb);
    } else {
#pragma unroll
      for (int x = 0; x < 8; ++x) { ab[x] = 0.f; bb[x] = 0.f; }
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

// ------------------------------------------------------------- K3-fwd ----
template <typename T>
__global__ void __launch_bounds__(RT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const uint8_t* __restrict__ mask,
                 T* __restrict__ out, float* __restrict__ lse, Params P) {
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

  for (int t0 = 0; t0 < P.Lk; t0 += ST) {
    __syncthreads();  // the previous tile is consumed
    stage_pair(kb, vb, t0, P.Lk, k_s, v_s);
    if (threadIdx.x < ST) {
      const int j = t0 + threadIdx.x;
      valid_s[threadIdx.x] = j < P.Lk && mrow[j] != 0;
      col_s[threadIdx.x] = (uint32_t)j * COL_MUL;
    }
    __syncthreads();

    const int jn = min(ST, P.Lk - t0);
    for (int j = 0; j < jn; ++j) {
      if (!valid_s[j]) continue;  // the same key for every thread
      const float s = dot16(qr, k_s[j]) * P.sm_scale;
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
      axpy16(round_to<T>(pn), v_s[j], acc);
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

// -------------------------------------------------------------- K3-dq ----
template <typename T>
__global__ void __launch_bounds__(RT)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const uint8_t* __restrict__ mask,
                const float* __restrict__ lse, const float* __restrict__ delta,
                const T* __restrict__ dout, T* __restrict__ dq, Params P) {
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
    stage_pair(kb, vb, t0, P.Lk, k_s, v_s);
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
      axpy16(round_to<T>(a * (t - d_i)), k_s[j], acc);
    }
  }

  if (live) {
#pragma unroll
    for (int d = 0; d < DH; ++d) acc[d] *= P.sm_scale;
    store_row(dq + ((size_t)bh * P.Lq + qi) * DH, acc);
  }
}

// ------------------------------------------------------------- K3-dkv ----
template <typename T>
__global__ void __launch_bounds__(RT)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const uint8_t* __restrict__ mask,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 const T* __restrict__ dout, T* __restrict__ dk,
                 T* __restrict__ dv, Params P) {
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
  const T* qb = q + (size_t)bh * P.Lq * DH;
  const T* dob = dout + (size_t)bh * P.Lq * DH;

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
    stage_pair(qb, dob, t0, P.Lq, q_s, do_s);
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
      axpy16(round_to<T>(a * kf), do_s[i], dvr);
      axpy16(round_to<T>(a * (t - d_s[i])), q_s[i], dkr);
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

bool bad_shape(int B, int H, int Lq, int Lk, int Dh) {
  return B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0 || Dh != DH;
}

Params params(int H, int Lq, int Lk, float sm_scale, float rate,
              unsigned threshold, const void* seed) {
  return Params{H, Lq, Lk, sm_scale, rate, threshold,
                static_cast<const long long*>(seed)};
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
    using T = __nv_bfloat16;
    flash_fwd_kernel<T><<<grid, RT, 0, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), m, static_cast<T*>(out), l, P);
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
  const dim3 grid(B * H, (Lq + RT - 1) / RT);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  const float* l = static_cast<const float*>(lse);
  const float* dd = static_cast<const float*>(delta);
  if (is_bf16) {
    using T = __nv_bfloat16;
    flash_dq_kernel<T><<<grid, RT, 0, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), m, l, dd, static_cast<const T*>(dout),
        static_cast<T*>(dq), P);
  } else {
    using T = float;
    flash_dq_kernel<T><<<grid, RT, 0, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), m, l, dd, static_cast<const T*>(dout),
        static_cast<T*>(dq), P);
  }
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
  const dim3 grid(B * H, (Lk + RT - 1) / RT);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  const float* l = static_cast<const float*>(lse);
  const float* dd = static_cast<const float*>(delta);
  if (is_bf16) {
    using T = __nv_bfloat16;
    flash_dkv_kernel<T><<<grid, RT, 0, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), m, l, dd, static_cast<const T*>(dout),
        static_cast<T*>(dk), static_cast<T*>(dv), P);
  } else {
    using T = float;
    flash_dkv_kernel<T><<<grid, RT, 0, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), m, l, dd, static_cast<const T*>(dout),
        static_cast<T*>(dk), static_cast<T*>(dv), P);
  }
  return (int)cudaGetLastError();
}
