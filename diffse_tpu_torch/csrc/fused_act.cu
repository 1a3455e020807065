// Fused bias-add + LeakyReLU for Hopper (sm_90a), float32 and bfloat16.
//
// Replaces the Pallas TPU kernel `_fused_bias_lrelu_kernel` of
// diffse_tpu/ops/pallas_kernels.py (K4, public op
// `fused_bias_leaky_relu_pallas`):
//   out = where(v >= 0, v, negative_slope * v) * scale,  v = x + bias[col],
// over x viewed as [M, C] (channels last), bias [C] or none.
//
// What bounds it on the card, and what the design does about it:
//   - A few operations per element against one read and one write: it is
//     bound by device memory. Each thread moves 16 bytes of float32 (4
//     elements) per load and store when C % 4 == 0 and the pointers are
//     16-byte aligned (bfloat16: 4 elements, 8 bytes), one element otherwise.
//     The bias, C values, stays in L1/L2.
//   - The maths is float32; bfloat16 is loaded, widened, computed in float32
//     and rounded to nearest even on the store.
//   - A grid-stride loop over at most 132 * 16 blocks of 256 threads.
//
// Each entry point launches on the given stream and returns
// cudaGetLastError(); the Python wrapper raises when it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float bias_lrelu(float x, float b, float slope, float scale) {
  const float v = x + b;
  return (v >= 0.0f ? v : slope * v) * scale;
}

// Four elements of one row per thread: C % 4 == 0, so the four share a row.
struct alignas(16) F32x4 { float v[4]; };
struct alignas(8) BF16x4 { __nv_bfloat16 v[4]; };
template <typename T> struct Vec4;
template <> struct Vec4<float> { using type = F32x4; };
template <> struct Vec4<__nv_bfloat16> { using type = BF16x4; };

template <typename T>
__global__ void __launch_bounds__(kThreads)
bias_lrelu_vec4_kernel(const T* __restrict__ x, const T* __restrict__ bias,
                       T* __restrict__ out, long long n4, int c, float slope,
                       float scale) {
  using V = typename Vec4<T>::type;
  const V* xv = reinterpret_cast<const V*>(x);
  V* ov = reinterpret_cast<V*>(out);
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < n4;
       i += stride) {
    const V in = xv[i];
    const int col = static_cast<int>((i * 4) % c);
    V r;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float b = bias != nullptr ? to_f32(bias[col + k]) : 0.0f;
      r.v[k] = from_f32<T>(bias_lrelu(to_f32(in.v[k]), b, slope, scale));
    }
    ov[i] = r;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bias_lrelu_kernel(const T* __restrict__ x, const T* __restrict__ bias,
                  T* __restrict__ out, long long n, int c, float slope, float scale) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += stride) {
    const float b = bias != nullptr ? to_f32(bias[i % c]) : 0.0f;
    out[i] = from_f32<T>(bias_lrelu(to_f32(x[i]), b, slope, scale));
  }
}

int blocks_for(long long work) {
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return static_cast<int>(blocks < 1 ? 1 : blocks);
}

bool aligned16(const void* p) { return reinterpret_cast<unsigned long long>(p) % 16 == 0; }

template <typename T>
int launch(const T* x, const T* bias, T* out, long long m, int c, float slope,
           float scale, cudaStream_t stream) {
  const long long n = m * c;
  if (n > 0) {
    if (c % 4 == 0 && aligned16(x) && aligned16(out)) {
      bias_lrelu_vec4_kernel<T><<<blocks_for(n / 4), kThreads, 0, stream>>>(
          x, bias, out, n / 4, c, slope, scale);
    } else {
      bias_lrelu_kernel<T><<<blocks_for(n), kThreads, 0, stream>>>(
          x, bias, out, n, c, slope, scale);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x, out: [m, c]; bias: [c] or null. dtype: 0 = float32, 1 = bfloat16.
int diffse_fused_bias_lrelu(const void* x, const void* bias, void* out, long long m,
                            int c, int dtype, float negative_slope, float scale,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch(static_cast<const float*>(x), static_cast<const float*>(bias),
                  static_cast<float*>(out), m, c, negative_slope, scale, s);
  }
  if (dtype == 1) {
    return launch(static_cast<const __nv_bfloat16*>(x),
                  static_cast<const __nv_bfloat16*>(bias),
                  static_cast<__nv_bfloat16*>(out), m, c, negative_slope, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
