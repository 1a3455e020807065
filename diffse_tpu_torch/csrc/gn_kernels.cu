// GroupNorm -> SiLU (-> conv3x3) kernels for Hopper (sm_90a), float32.
//
// Replaces the Pallas TPU kernels of diffse_tpu/ops/pallas_kernels.py:
//   gn_stats_ab_kernel      the GroupNorm statistics (`_gn_stats_ab`), shared
//                           by both chains below;
//   gn_apply_kernel         with the stats kernel, `_groupnorm_silu_kernel`
//                           (K3): x*a+b, optional SiLU;
//   gn_silu_conv3x3_kernel  `_gn_silu_conv3x3_kernel` (K1, row-tiled maps) and
//                           `_gn_silu_conv3x3_small_kernel` (K2, tiny maps):
//                           conv3x3_SAME(SiLU(x*a+b)) + bias_total[b]
//                           [+ skip, * skip_coef].
//
// Layouts are the JAX package's: activations NHWC, conv weights HWIO, the
// per-(batch, channel) GroupNorm affine a, b as [B, C].
//
// What bounds them on the card, and what the design does about it:
//   - The statistics and the apply pass read (and write) the map once each:
//     they are bound by device memory. The stats kernel accumulates in
//     double, so E[x^2]-mu^2 loses nothing to cancellation; one block per
//     (batch, group) keeps it free of atomics.
//   - The conv is an implicit GEMM, M = output positions, N = Cout,
//     K = 9*Cin, in CUDA-core FMAs: it is bound by float32 arithmetic. Each
//     block computes a 64x64 output tile with a 4x4 register tile per thread;
//     the activation tile is normalised and passed through SiLU as it is
//     staged in shared memory, so the activated map never reaches device
//     memory (the point of the TPU kernel). Zero padding is applied after the
//     activation, as SAME padding of the activated map requires. Taps that
//     fall outside every map of height or width 1 are skipped. Edge masking
//     lets one kernel serve both TPU regimes (W = 1, 2, ...; Cout = 4).
//   - No tensor cores, no TMA, no pipelining yet: a first kernel that is
//     right. wgmma on bf16/tf32 tiles is the way to the card's full rate.
//     Lacking a pipeline, the conv asks for its weights in L2 up front: the
//     model's weights are read where they live, not from a fresh copy.
//
// Each entry point launches on the given stream and returns
// cudaGetLastError(); the Python wrapper raises when it is not 0.

#include <cuda_runtime.h>

namespace {

constexpr int kStatsThreads = 256;
constexpr int kApplyThreads = 256;

constexpr int kBM = 64;   // output positions per block
constexpr int kBN = 64;   // output channels per block
constexpr int kBK = 16;   // input channels per shared-memory stage
constexpr int kTM = 4;    // positions per thread
constexpr int kTN = 4;    // output channels per thread
constexpr int kConvThreads = (kBM / kTM) * (kBN / kTN);  // 256

__device__ __forceinline__ float silu(float v) { return v / (1.0f + expf(-v)); }

__global__ void __launch_bounds__(kStatsThreads)
gn_stats_ab_kernel(const float* __restrict__ x, const float* __restrict__ scale,
                   const float* __restrict__ bias, float* __restrict__ a,
                   float* __restrict__ b, int hw, int c, int groups, float eps) {
  const int g = blockIdx.x;
  const int bi = blockIdx.y;
  const int cg = c / groups;
  const int n = hw * cg;
  const float* xb = x + static_cast<long long>(bi) * hw * c + g * cg;

  double s = 0.0, sq = 0.0;
  for (int e = threadIdx.x; e < n; e += kStatsThreads) {
    const int p = e / cg;
    const float v = xb[static_cast<long long>(p) * c + (e - p * cg)];
    s += v;
    sq += static_cast<double>(v) * v;
  }
  __shared__ double sh_s[kStatsThreads];
  __shared__ double sh_q[kStatsThreads];
  sh_s[threadIdx.x] = s;
  sh_q[threadIdx.x] = sq;
  __syncthreads();
  for (int off = kStatsThreads / 2; off > 0; off >>= 1) {
    if (threadIdx.x < off) {
      sh_s[threadIdx.x] += sh_s[threadIdx.x + off];
      sh_q[threadIdx.x] += sh_q[threadIdx.x + off];
    }
    __syncthreads();
  }
  const double mean = sh_s[0] / n;
  const double var = sh_q[0] / n - mean * mean;
  const float rstd = rsqrtf(static_cast<float>(var) + eps);
  for (int j = threadIdx.x; j < cg; j += kStatsThreads) {
    const int ch = g * cg + j;
    const float av = rstd * scale[ch];
    a[bi * c + ch] = av;
    b[bi * c + ch] = bias[ch] - static_cast<float>(mean) * av;
  }
}

// x, out: [B, HW, C] with C % 4 == 0; one float4 per thread and step.
__global__ void __launch_bounds__(kApplyThreads)
gn_apply_kernel(const float4* __restrict__ x, const float* __restrict__ a,
                const float* __restrict__ b, float4* __restrict__ out,
                long long total4, int hwc, int c, int apply_silu) {
  const long long stride = static_cast<long long>(gridDim.x) * kApplyThreads;
  for (long long i = blockIdx.x * static_cast<long long>(kApplyThreads) + threadIdx.x;
       i < total4; i += stride) {
    const long long e = i * 4;
    const int bi = static_cast<int>(e / hwc);
    const int ch = static_cast<int>(e % c);
    const float4 av = *reinterpret_cast<const float4*>(a + bi * c + ch);
    const float4 bv = *reinterpret_cast<const float4*>(b + bi * c + ch);
    const float4 xv = x[i];
    float4 v = make_float4(xv.x * av.x + bv.x, xv.y * av.y + bv.y,
                           xv.z * av.z + bv.z, xv.w * av.w + bv.w);
    if (apply_silu) {
      v.x = silu(v.x);
      v.y = silu(v.y);
      v.z = silu(v.z);
      v.w = silu(v.w);
    }
    out[i] = v;
  }
}

// grid (ceil(H*W / kBM), ceil(Cout / kBN), B); Cin % kBK == 0, Cout % 4 == 0.
// bias_total's row for batch bi starts at bi * bias_row_stride (0: one row
// shared by the whole batch).
__global__ void __launch_bounds__(kConvThreads)
gn_silu_conv3x3_kernel(const float* __restrict__ x, const float* __restrict__ a,
                       const float* __restrict__ b, const float* __restrict__ w,
                       const float* __restrict__ bias_total, int bias_row_stride,
                       const float* __restrict__ skip, float skip_coef,
                       float* __restrict__ out, int h, int wd, int cin, int cout) {
  const int bi = blockIdx.z;
  const int hw = h * wd;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int tid = threadIdx.x;
  const int tx = tid % (kBN / kTN);
  const int ty = tid / (kBN / kTN);

  __shared__ __align__(16) float as[kBK][kBM + 4];
  __shared__ __align__(16) float bs[kBK][kBN];

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;

  const float* xb = x + static_cast<long long>(bi) * hw * cin;
  const float* ab = a + static_cast<long long>(bi) * cin;
  const float* bb = b + static_cast<long long>(bi) * cin;

  // Activation tile: each thread stages 4 consecutive input channels of one
  // output position. Weight tile: 4 consecutive output channels of one row.
  const int a_row = tid >> 2;
  const int a_k = (tid & 3) * 4;
  const int m = m0 + a_row;
  const bool m_ok = m < hw;
  const int oh = m_ok ? m / wd : 0;
  const int ow = m_ok ? m % wd : 0;
  const int b_k = tid >> 4;
  const int b_n = (tid & 15) * 4;
  const bool n_ok = n0 + b_n < cout;

  // Every K step below waits on its weight tile. Weights that are not in L2
  // would make each step wait on device memory in turn; request the weight
  // slab of this Cout tile (9 * cin rows of up to kBN channels, two 128-byte
  // lines each) into L2 up front, so that those misses overlap. The blocks
  // of one Cout tile share the requests out between them.
  const int lines = 9 * cin * 2;
  const int share = (lines + gridDim.x - 1) / gridDim.x;
  const int line_end = min(lines, (blockIdx.x + 1) * share);
  for (int i = blockIdx.x * share + tid; i < line_end; i += kConvThreads) {
    const int col = n0 + (i & 1) * (kBN / 2);
    if (col < cout) {
      const float* p = w + static_cast<long long>(i >> 1) * cout + col;
      asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
    }
  }

  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3 - 1;
    const int dx = tap % 3 - 1;
    if ((h == 1 && dy != 0) || (wd == 1 && dx != 0)) continue;  // all-zero tap
    const int ih = oh + dy;
    const int iw = ow + dx;
    const bool in_ok = m_ok && ih >= 0 && ih < h && iw >= 0 && iw < wd;
    const float* xrow = xb + (static_cast<long long>(ih) * wd + iw) * cin;
    const float* wtap = w + static_cast<long long>(tap) * cin * cout;

    for (int c0 = 0; c0 < cin; c0 += kBK) {
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (in_ok) {
        const int ch = c0 + a_k;
        const float4 xv = *reinterpret_cast<const float4*>(xrow + ch);
        const float4 av = *reinterpret_cast<const float4*>(ab + ch);
        const float4 bv = *reinterpret_cast<const float4*>(bb + ch);
        v.x = silu(xv.x * av.x + bv.x);
        v.y = silu(xv.y * av.y + bv.y);
        v.z = silu(xv.z * av.z + bv.z);
        v.w = silu(xv.w * av.w + bv.w);
      }
      as[a_k + 0][a_row] = v.x;
      as[a_k + 1][a_row] = v.y;
      as[a_k + 2][a_row] = v.z;
      as[a_k + 3][a_row] = v.w;

      float4 wv = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (n_ok) {
        wv = *reinterpret_cast<const float4*>(
            wtap + static_cast<long long>(c0 + b_k) * cout + n0 + b_n);
      }
      *reinterpret_cast<float4*>(&bs[b_k][b_n]) = wv;
      __syncthreads();

#pragma unroll
      for (int k = 0; k < kBK; ++k) {
        const float4 ar = *reinterpret_cast<const float4*>(&as[k][ty * kTM]);
        const float4 br = *reinterpret_cast<const float4*>(&bs[k][tx * kTN]);
        const float av4[kTM] = {ar.x, ar.y, ar.z, ar.w};
        const float bv4[kTN] = {br.x, br.y, br.z, br.w};
#pragma unroll
        for (int i = 0; i < kTM; ++i)
#pragma unroll
          for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(av4[i], bv4[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  const int n = n0 + tx * kTN;
  if (n >= cout) return;
  const float4 bt = *reinterpret_cast<const float4*>(
      bias_total + static_cast<long long>(bi) * bias_row_stride + n);
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int mm = m0 + ty * kTM + i;
    if (mm >= hw) continue;
    const long long off = (static_cast<long long>(bi) * hw + mm) * cout + n;
    float4 o = make_float4(acc[i][0] + bt.x, acc[i][1] + bt.y, acc[i][2] + bt.z,
                           acc[i][3] + bt.w);
    if (skip != nullptr) {
      const float4 s = *reinterpret_cast<const float4*>(skip + off);
      o = make_float4((s.x + o.x) * skip_coef, (s.y + o.y) * skip_coef,
                      (s.z + o.z) * skip_coef, (s.w + o.w) * skip_coef);
    }
    *reinterpret_cast<float4*>(out + off) = o;
  }
}

}  // namespace

extern "C" {

int diffse_gn_stats_ab(const float* x, const float* scale, const float* bias,
                       float* a, float* b, int batch, int hw, int c, int groups,
                       float eps, void* stream) {
  dim3 grid(groups, batch);
  gn_stats_ab_kernel<<<grid, kStatsThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, scale, bias, a, b, hw, c, groups, eps);
  return static_cast<int>(cudaGetLastError());
}

int diffse_gn_apply(const float* x, const float* a, const float* b, float* out,
                    int batch, int hw, int c, int apply_silu, void* stream) {
  const long long total4 = static_cast<long long>(batch) * hw * c / 4;
  long long blocks = (total4 + kApplyThreads - 1) / kApplyThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  if (blocks < 1) blocks = 1;
  gn_apply_kernel<<<static_cast<int>(blocks), kApplyThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(x), a, b, reinterpret_cast<float4*>(out),
      total4, hw * c, c, apply_silu);
  return static_cast<int>(cudaGetLastError());
}

int diffse_gn_silu_conv3x3(const float* x, const float* a, const float* b,
                           const float* w, const float* bias_total,
                           int bias_row_stride, const float* skip,
                           float skip_coef, float* out,
                           int batch, int h, int wd, int cin, int cout,
                           void* stream) {
  dim3 grid((h * wd + kBM - 1) / kBM, (cout + kBN - 1) / kBN, batch);
  gn_silu_conv3x3_kernel<<<grid, kConvThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, a, b, w, bias_total, bias_row_stride, skip, skip_coef, out, h, wd, cin, cout);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
