// The bf16 gelu fit of the BERT FFN (medtok_tpu_torch/ops/gelu.py) in one
// pass, for Hopper (sm_90a).
//
//   gelu(x) = x * sigmoid(2 p(x)),  p = a degree-11 polynomial in Horner form
//   (its coefficients, lowest first, from the wrapper); x > x_hi returns x,
//   x < x_lo returns 0.
//
// Replaces no TPU kernel: the JAX package writes the fit as plain jnp math
// (medtok_tpu/ops/gelu.py::gelu_bf16) and XLA fuses it into one pass. In
// PyTorch each operation of the plain version is a pass of its own over the
// fp32 activation (about 30 kernels); this kernel is that fusion by hand.
//
// It rounds where the plain version rounds on the card, so the two agree bit
// for bit: the bf16 input widened exactly; each Horner step an fp32 multiply,
// rounded, then an fp32 add, rounded (__fmul_rn / __fadd_rn: no FMA
// contraction, as two ATen kernels round twice); 2 q exact; ATen's float
// sigmoid, 1 / (1 + expf(-t)), written as ATen writes it (IEEE division);
// x * s rounded; x > x_hi returns x, then x < x_lo returns +0, so NaN fails
// both compares and +-inf takes a threshold, as torch.where does; round to
// nearest even to bf16 (__float2bfloat16_rn, the conversion of ATen's copy).
//
// Bound: one bf16 read and one bf16 write an element. The export's FFN
// activation, [256 * 128, 3072], is 100.7 M elements, 402.7 MB in and out:
// 0.120 ms at 3.35 TB/s. Its arithmetic, about 50 fp32 instructions an
// element (22 for the polynomial, the rest for expf, the IEEE division, the
// selects and the conversions), is about 5 G lane instructions, the same
// order of time on 132 SMs; so the kernel keeps loads in flight while it
// computes.
//
// Design: each thread loads two 16-byte words (8 bf16 each), neighbouring
// threads on neighbouring words, computes their 16 elements in registers
// and stores two 16-byte words, in a grid-stride loop over as many blocks as
// the SMs hold at once. A numel that is no multiple of 8 ends in a scalar
// tail; an input or output that is not 16-byte aligned takes the scalar loop
// throughout.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int GELU_COEFS = 12;     // degree 11
constexpr int GELU_THREADS = 256;
constexpr int GELU_WORDS = 2;      // 16-byte words a thread loads at once

struct GeluFit {
  float c[GELU_COEFS];             // lowest first
  float x_hi, x_lo;
};

__device__ __forceinline__ float gelu_fit(float x, const GeluFit& f) {
  float q = f.c[GELU_COEFS - 1];
#pragma unroll
  for (int i = GELU_COEFS - 2; i >= 0; --i) q = __fadd_rn(__fmul_rn(q, x), f.c[i]);
  const float t = __fmul_rn(2.0f, q);
  const float one = 1.0f;
  const float s = one / (one + expf(-t));
  float y = __fmul_rn(x, s);
  y = x > f.x_hi ? x : y;
  y = x < f.x_lo ? 0.0f : y;
  return y;
}

// Two bf16 in one 32-bit word, the lower address in the low half.
__device__ __forceinline__ uint32_t gelu_pair(uint32_t w, const GeluFit& f) {
  const float lo = gelu_fit(__uint_as_float(w << 16), f);
  const float hi = gelu_fit(__uint_as_float(w & 0xffff0000u), f);
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
}

__device__ __forceinline__ uint4 gelu_word(uint4 v, const GeluFit& f) {
  return make_uint4(gelu_pair(v.x, f), gelu_pair(v.y, f), gelu_pair(v.z, f),
                    gelu_pair(v.w, f));
}

// x, y: n bf16; the first n_words * 8 of them as 16-byte words (n_words is 0
// when a pointer is not 16-byte aligned), the rest one by one.
__global__ void __launch_bounds__(GELU_THREADS)
gelu_fit_kernel(const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ y,
                long long n, long long n_words, GeluFit f) {
  const long long stride = static_cast<long long>(gridDim.x) * GELU_THREADS;
  const long long first = static_cast<long long>(blockIdx.x) * GELU_THREADS + threadIdx.x;
  const uint4* xw = reinterpret_cast<const uint4*>(x);
  uint4* yw = reinterpret_cast<uint4*>(y);
  for (long long i = first; i < n_words; i += GELU_WORDS * stride) {
    uint4 v[GELU_WORDS];
#pragma unroll
    for (int j = 0; j < GELU_WORDS; ++j)
      if (i + j * stride < n_words) v[j] = __ldg(xw + i + j * stride);
#pragma unroll
    for (int j = 0; j < GELU_WORDS; ++j)
      if (i + j * stride < n_words) yw[i + j * stride] = gelu_word(v[j], f);
  }
  for (long long k = 8 * n_words + first; k < n; k += stride)
    y[k] = __float2bfloat16_rn(gelu_fit(__bfloat162float(x[k]), f));
}

}  // namespace

// x, y: n bf16 (y a new buffer); coef: the polynomial's 12 coefficients,
// lowest first, in host memory; x_hi, x_lo: the thresholds. Launches on
// `stream`; returns the first CUDA error, else 0.
extern "C" int medtok_gelu_fit(const void* x, void* y, long long n, const float* coef,
                               float x_hi, float x_lo, void* stream) {
  if (n < 0 || coef == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  GeluFit f;
  for (int i = 0; i < GELU_COEFS; ++i) f.c[i] = coef[i];
  f.x_hi = x_hi;
  f.x_lo = x_lo;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) & 15) == 0;
  const long long n_words = aligned ? n / 8 : 0;
  int dev = 0, sms = 0;
  static int per_sm = 0;           // blocks an SM holds at once (one per build)
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && per_sm == 0)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gelu_fit_kernel,
                                                        GELU_THREADS, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  // threads with work: a pair of words each, or an element of the tail each
  const long long words = (n_words + GELU_WORDS - 1) / GELU_WORDS;
  const long long tail = n - 8 * n_words;
  const long long threads = words > tail ? words : tail;
  long long blocks = (threads + GELU_THREADS - 1) / GELU_THREADS;
  const long long resident = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  if (blocks > resident) blocks = resident;
  gelu_fit_kernel<<<static_cast<int>(blocks), GELU_THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y), n, n_words, f);
  return static_cast<int>(cudaGetLastError());
}
