// Kernels K2 and K4: block-diagonal (sequence-packed) attention, forward
// only, for Hopper (sm_90a).
//
// K2 replaces medtok_tpu/ops/flash_attention.py::packed_segment_attention
// (kernel _flash_seg_kernel): q, k, v, out are [B, H, L, Dh]. K4 replaces
// packed_segment_attention_nt (kernel _flash_seg_kernel_nt): the same
// attention with q, k, v, out in the projection layout [B, L, H, Dh]. Both
// are one kernel templated on the layout: element (b, h, i, d) sits at
// b*L*H*Dh + h*head_stride + i*row_stride + d, with (head, row) strides
// (L*Dh, Dh) for K2 and (Dh, H*Dh) for K4. Dh = 64 is contiguous in both,
// so the 16-byte vector loads hold. bf16 or fp32; seg is [B, L] int32.
// Query i of a row attends to key j iff seg_i == seg_j > 0; the softmax of
// q.k * sm_scale runs in fp32 with a running max and sum, and a query row
// with no valid key (padding) writes 0.
//
// Bound: at the packed BERT shape [256, 12, 128, 64] in bf16 the kernel must
// read q, k, v and write o, 4 x 50.3 MB per layer (about 60 us at 3.35 TB/s),
// while the block-diagonal products are at most 12.9 GFLOP, so it is
// memory-bound; K4 moves the same bytes. This first kernel does the products
// on fp32 CUDA cores, not tensor cores, and sits above that bound. In K4's
// layout a thread's q and out rows lie H*Dh apart instead of side by side;
// the key/value staging still reads whole 128-byte rows.
//
// Design. One block per (row b, head h, tile of 128 queries); one thread per
// query keeps its q row and its fp32 accumulator in registers. Keys and values
// stream through shared memory in tiles of 32, converted to fp32 once; the
// reads inside the loop are broadcasts (every thread reads the same key). A
// thread skips keys of other segments, so a warp only pays for keys that one
// of its queries can see. Segments need not be contiguous: the mask is the
// segment comparison itself, as in the TPU kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int DH = 64;    // head width (bert-base: 768 / 12)
constexpr int QT = 128;   // queries per block (one per thread)
constexpr int TK = 32;    // keys per staged tile

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

// kBLHD: the [B, L, H, Dh] layout (K4); otherwise [B, H, L, Dh] (K2)
template <typename T, bool kBLHD>
__global__ void __launch_bounds__(QT)
segment_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const int* __restrict__ seg,
                         T* __restrict__ out, int H, int L, float sm_scale) {
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
      float4* kd = reinterpret_cast<float4*>(&k_s[j][d]);
      float4* vd = reinterpret_cast<float4*>(&v_s[j][d]);
      kd[0] = make_float4(kb[0], kb[1], kb[2], kb[3]);
      kd[1] = make_float4(kb[4], kb[5], kb[6], kb[7]);
      vd[0] = make_float4(vb[0], vb[1], vb[2], vb[3]);
      vd[1] = make_float4(vb[4], vb[5], vb[6], vb[7]);
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

template <typename T, bool kBLHD>
cudaError_t launch(const void* q, const void* k, const void* v, const int* seg,
                   void* out, int B, int H, int L, float scale,
                   cudaStream_t stream) {
  const dim3 grid(B * H, (L + QT - 1) / QT);
  segment_attention_kernel<T, kBLHD><<<grid, QT, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), seg, static_cast<T*>(out), H, L, scale);
  return cudaGetLastError();
}

template <bool kBLHD>
int dispatch(const void* q, const void* k, const void* v, const void* seg,
             void* out, int B, int H, int L, int Dh, float sm_scale,
             int is_bf16, void* stream) {
  if (B <= 0 || H <= 0 || L <= 0 || Dh != DH) return (int)cudaErrorInvalidValue;
  const int* sp = static_cast<const int*>(seg);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16, kBLHD>(q, k, v, sp, out, B, H, L, sm_scale, s)
              : launch<float, kBLHD>(q, k, v, sp, out, B, H, L, sm_scale, s);
  return (int)err;
}

}  // namespace

// K2. q, k, v, out: [B, H, L, Dh] contiguous, 16-byte aligned, bf16
// (is_bf16=1) or fp32; seg: [B, L] int32. Dh must be 64.
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
