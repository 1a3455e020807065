// GroupNorm -> SiLU (-> conv3x3) kernels for Hopper (sm_90a), float32 and
// bfloat16 activations (the bf16 trunk), float32 parameters and sums.
//
// Replaces the Pallas TPU kernels of diffse_tpu/ops/pallas_kernels.py:
//   gn_stats_ab_kernel       the GroupNorm statistics (`_gn_stats_ab`, :314),
//                            shared by both chains below;
//   gn_apply_kernel          with the stats kernel, `_groupnorm_silu_kernel`
//                            (K3, :46): x*a+b, optional SiLU;
//   gn_silu_conv3x3_kernel   `_gn_silu_conv3x3_kernel` (K1, :269, row-tiled
//   (+ conv_split_reduce)    maps) and `_gn_silu_conv3x3_small_kernel` (K2,
//                            :350, tiny maps): conv3x3_SAME(SiLU(x*a+b)) +
//                            bias_total[b] [+ skip, * skip_coef].
//
// Layouts are the JAX package's: activations NHWC, conv weights HWIO (read in
// place), the per-(batch, channel) GroupNorm affine a, b as [B, C].
//
// The statistics pass. Bound by device memory (it reads x once). Each block
// reads a contiguous run of positions across all channels with 16-byte loads
// (a warp reads 512 consecutive bytes), accumulating per channel in double,
// so E[x^2]-mu^2 loses nothing to cancellation. The grid is (parts, batch):
// far more blocks than (batch x groups) on the large maps, one block on the
// small ones (ops/cuda_kernels.py::stats_plan sizes the run). Each block
// writes per-group partial sums; the last block of a batch row to finish (an
// integer ticket, not a float atomic) folds that row's partials in a fixed
// order and writes a, b. So the result does not depend on which block ends
// last, and the chain keeps two launches. The ticket counter is zero between
// calls: the folding block resets it.
//
// The conv. An implicit GEMM, M = output positions, N = Cout, K = 9 * Cin,
// on the tensor cores in 3xTF32: each operand v is split into hi = tf32(v)
// and lo = tf32(v - hi), and acc += lo_a*hi_w + hi_a*lo_w + hi_a*hi_w in
// float32, which keeps float32 accuracy (one TF32 pass keeps ~3 digits).
// Bound by those operations at the large levels (3 x 2*M*N*K over 495
// TFLOP/s), by latency at the deep ones.
//   - Staging. Per 8-channel chunk of Cin a block stages the raw x halo tile
//     [(TH+2) x (TW+2) x 8] of its TH x TW positions and the chunk's weights
//     [taps x 8 x BN] through a cp.async ring (3 stages, kStages; 2 in the
//     wgmma kernel), ahead of the tensor cores. The weights are read where the model keeps
//     them (HWIO) and split into hi/lo as each thread loads its fragment.
//   - The prologue runs once per staged element: x*a+b, SiLU, the SAME zero
//     padding (after the activation, as padding the activated map requires)
//     and the hi/lo split are applied to the halo tile once (the mma.sync
//     kernels activate chunk i + 1 into a second buffer while the tensor
//     cores work on chunk i), and all nine taps read that one tile at a
//     shifted position. This
//     is the TPU kernel's padded [h_t+2, W+2, Cin] tile
//     (pallas_kernels.py:283-305).
//   - The large levels run gn_silu_conv3x3_wgmma_kernel: wgmma m64n32k8 with
//     the weights as the register operand A (M = Cout, so the threads load
//     and split them in any order) and the activated tile as the shared-
//     memory operand B (N = one output row of TW positions). TF32 wgmma
//     takes K-major operands only, and the NHWC tile is K-major: each plane
//     holds a position's 4 channels in 16 contiguous bytes, so 8 consecutive
//     positions form one core matrix, and since the positions of a halo row
//     are contiguous, a tap's shift by whole rows (dy) or by one position
//     (dx) is a shift of the descriptor's start address by 16-byte steps:
//     no copy per dx is needed. Two such blocks share an SM, so that one's
//     prologue overlaps the other's tensor-core work.
//   - The other maps run gn_silu_conv3x3_kernel on mma.sync.m16n8k8.tf32,
//     its fragments loaded by hand from the same tile (any tile shape, dead
//     taps of maps of height or width 1 skipped, Cout = 4 heads).
//   - Split K. The deep levels have few output tiles, so the K axis (live
//     taps x 8-channel chunks) is cut into `splits` ranges, one per block
//     (grid z). Those blocks write float32 partial sums, and
//     conv_split_reduce_kernel adds them in split order (no atomics, so the
//     result is the same on every run) and applies the epilogue. With one
//     split the conv kernel applies the epilogue itself.
//   The launch plan (instantiation, tile, split, shared memory, grids) is
//   chosen in Python (ops/cuda_kernels.py::conv_plan); the entry point checks
//   it.
//
// bfloat16 (the trunk of NCSNpp(dtype="bf16"); pallas_kernels.py:330-347
// with compute_dtype bf16). Every kernel is templated on the activation type
// T; the float32 instantiations are the ones described above. In bfloat16:
//   - the statistics pass reads 8 values a 16-byte load (256 threads, so
//     that the shared sums stay 32 KB) and sums in double as in float32;
//   - the apply pass reads bf16 and writes bf16 or float32 (the attention's
//     norm, which flax promotes to float32);
//   - the conv's K chunk is 16 channels (32 bytes of a position, as in
//     float32), one k16 product per tap: the prologue computes x*a+b and
//     SiLU in float32 and rounds each activated element to bf16 once (round
//     to nearest even), into the same halo tile the taps share; the weights
//     stay float32 in device memory and in the ring, and each thread rounds
//     its fragment to bf16 (to nearest even) as it loads it, as the TF32
//     kernels split theirs. Products on the tensor cores, summed in float32:
//     wgmma m64n32k16 .f32.bf16.bf16 on the large levels (the tile K-major in
//     two planes of 8 channels, so a tap is still a shift of the descriptor's
//     start; one block per SM: the float32 weights of a 16-channel chunk take
//     76 KB a stage), mma.sync m16n8k16 .bf16 elsewhere. Split-K partials
//     stay float32; bias, skip and scale are applied in float32 and the
//     output rounded to bf16 once.
//   Bound at the large levels by the weights' staging and the prologue
//   rather than the products (989 TFLOP/s for bf16 against 495 for one TF32
//   pass); a simple kernel first.
//
// Each entry point launches on the given stream and returns a cudaError_t
// (cudaGetLastError after the launches); the Python wrapper raises when it is
// not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

// Threads of the statistics pass: 16-byte loads (4 float32 or 8 bf16
// channels), 2048 doubles of sums each, so C <= 2048 for both types.
template <typename T>
__host__ __device__ constexpr int stats_threads() { return std::is_same<T, float>::value ? 512 : 256; }
constexpr int kApplyThreads = 256;
constexpr int kReduceThreads = 256;
constexpr int kSmemLimit = 232448;  // bytes of shared memory a block can use

constexpr int kBK = 8;          // float32 input channels per K chunk: one mma k-step per tap
constexpr int kStages = 3;      // depth of the cp.async ring
// Floats per position of the activated tile: for t = 0..3, channels t and
// t + 4 as (hi, hi, lo, lo), so that one 16-byte load gives a thread both of
// its A-fragment columns in both halves of the split.
constexpr int kActFloats = 16;

// Hooks for tools/trace_conv_phases.py, which builds this file with
// -DDIFFSE_CONV_TRACE: block (0, 0, 0) of the wgmma kernel records clock64()
// at the phases of its first 64 chunks, per warpgroup. Without the flag they
// compile to nothing.
#ifdef DIFFSE_CONV_TRACE
__device__ long long g_conv_trace[2][64][8];
#define CONV_TRACE(k)                                                                  \
  if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 && tid % 128 == 0 && i < 64) \
  g_conv_trace[tid / 128][i][k] = clock64()
#else
#define CONV_TRACE(k)
#endif

__device__ __forceinline__ float silu(float v) { return v / (1.0f + expf(-v)); }

// x*a+b and SiLU as the plain versions compute them (ops/cuda_kernels.py: a
// product and a sum each rounded, then v * sigmoid(v) with sigmoid as
// torch's 1 / (1 + exp(-v))), for the bf16 instantiations: a value rounded
// to bf16 then lands where the plain version's lands.
__device__ __forceinline__ float affine_rn(float x, float a, float b) {
  return __fadd_rn(__fmul_rn(x, a), b);
}
__device__ __forceinline__ float silu_rn(float v) {
  return __fmul_rn(v, __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-v))));
}

// bfloat16 bits <-> float32
__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }
// Two floats to bf16, round to nearest even: lo in the low half (the lower
// address, the lower column of a fragment).
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) { return __float2bfloat16_rn(v); }

// 16 bytes of T as floats: 4 float32 or 8 bfloat16 values.
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float (&v)[4]) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  }
};
template <>
struct Vec16<bf16> {
  static constexpr int N = 8;
  __device__ static void load(const bf16* p, float (&v)[8]) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[2 * j] = bf16_lo(w[j]);
      v[2 * j + 1] = bf16_hi(w[j]);
    }
  }
};

// N (a multiple of 4) floats to T at p
template <typename T, int N>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[N]) {
  if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int j = 0; j < N; j += 4)
      *reinterpret_cast<float4*>(p + j) = make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
  } else {
#pragma unroll
    for (int j = 0; j < N; j += 4)
      *reinterpret_cast<uint2*>(p + j) =
          make_uint2(pack_bf16x2(v[j], v[j + 1]), pack_bf16x2(v[j + 2], v[j + 3]));
  }
}

// SiLU for the conv's prologue, where it sits on the critical path of every
// chunk: the hardware exponential and a correctly rounded reciprocal (a few
// ulp from silu(), far inside what the 3xTF32 products round away).
__device__ __forceinline__ float silu_fast(float v) { return v * __frcp_rn(1.0f + __expf(-v)); }

// ----------------------------------------------------------------- statistics

// grid (parts, batch). x: [B, HW, C] of T, C a multiple of the 16-byte vector
// (4 float32, 8 bfloat16), C <= 2048. partial: [B, groups,
// parts] (sum, sum of squares); counter: [B], zero.
template <typename T>
__global__ void __launch_bounds__(stats_threads<T>())
gn_stats_ab_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                   const float* __restrict__ bias, double2* __restrict__ partial,
                   int* __restrict__ counter, float* __restrict__ a,
                   float* __restrict__ b, int hw, int c, int groups, int chunk,
                   float eps) {
  constexpr int kThreads = stats_threads<T>();
  constexpr int V = Vec16<T>::N;
  __shared__ double sh_s[V * kThreads];
  __shared__ double sh_q[V * kThreads];
  __shared__ int is_last;

  const int part = blockIdx.x;
  const int parts = gridDim.x;
  const int bi = blockIdx.y;
  const int tid = threadIdx.x;
  const int cv = c / V;
  const int rows = kThreads / cv;  // positions read side by side
  const int col = tid % cv;
  const int row = tid / cv;
  const int cg = c / groups;

  double s[V], q[V];
#pragma unroll
  for (int j = 0; j < V; ++j) s[j] = q[j] = 0.0;
  if (row < rows) {
    const T* xb = x + static_cast<long long>(bi) * hw * c + col * V;
    const int p1 = min(hw, (part + 1) * chunk);
    int p = part * chunk + row;
    for (; p + 3 * rows < p1; p += 4 * rows) {  // four 16-byte loads in flight
      float e[4][V];
#pragma unroll
      for (int u = 0; u < 4; ++u) Vec16<T>::load(xb + static_cast<long long>(p + u * rows) * c, e[u]);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          s[j] += e[u][j];
          q[j] = fma(static_cast<double>(e[u][j]), static_cast<double>(e[u][j]), q[j]);
        }
      }
    }
    for (; p < p1; p += rows) {
      float e[V];
      Vec16<T>::load(xb + static_cast<long long>(p) * c, e);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        s[j] += e[j];
        q[j] = fma(static_cast<double>(e[j]), static_cast<double>(e[j]), q[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
      sh_s[row * c + col * V + j] = s[j];
      sh_q[row * c + col * V + j] = q[j];
    }
  }
  __syncthreads();
  // per channel over the rows, then per group over its channels: fixed order
  for (int ch = tid; ch < c; ch += kThreads) {
    double cs = 0.0, cq = 0.0;
    for (int r = 0; r < rows; ++r) {
      cs += sh_s[r * c + ch];
      cq += sh_q[r * c + ch];
    }
    sh_s[ch] = cs;
    sh_q[ch] = cq;
  }
  __syncthreads();
  for (int g = tid; g < groups; g += kThreads) {
    double gs = 0.0, gq = 0.0;
    for (int j = 0; j < cg; ++j) {
      gs += sh_s[g * cg + j];
      gq += sh_q[g * cg + j];
    }
    partial[(static_cast<long long>(bi) * groups + g) * parts + part] = make_double2(gs, gq);
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(counter + bi, 1) == parts - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();

  // The last block of this batch row folds its partials: one warp per group,
  // lanes over the parts in order, then a fixed shuffle tree; lane 0's sum.
  const int warp = tid / 32;
  const int lane = tid % 32;
  const double n = static_cast<double>(hw) * cg;
  for (int g = warp; g < groups; g += kThreads / 32) {
    const double2* pg = partial + (static_cast<long long>(bi) * groups + g) * parts;
    double gs = 0.0, gq = 0.0;
    for (int i = lane; i < parts; i += 32) {
      const double2 v = __ldcg(pg + i);
      gs += v.x;
      gq += v.y;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      gs += __shfl_xor_sync(0xffffffffu, gs, off);
      gq += __shfl_xor_sync(0xffffffffu, gq, off);
    }
    gs = __shfl_sync(0xffffffffu, gs, 0);
    gq = __shfl_sync(0xffffffffu, gq, 0);
    const double mean = gs / n;
    const double var = gq / n - mean * mean;
    if constexpr (std::is_same<T, float>::value) {
      const float rstd = rsqrtf(static_cast<float>(var) + eps);
      for (int j = lane; j < cg; j += 32) {
        const int ch = g * cg + j;
        const float av = rstd * scale[ch];
        a[bi * c + ch] = av;
        b[bi * c + ch] = bias[ch] - static_cast<float>(mean) * av;
      }
    } else {
      // bf16: 1/sqrt in double and no contraction, as the plain version
      // computes a and b, so that the activations round alike
      const float rstd = static_cast<float>(1.0 / sqrt(var + static_cast<double>(eps)));
      for (int j = lane; j < cg; j += 32) {
        const int ch = g * cg + j;
        const float av = __fmul_rn(rstd, scale[ch]);
        a[bi * c + ch] = av;
        b[bi * c + ch] = __fsub_rn(bias[ch], __fmul_rn(static_cast<float>(mean), av));
      }
    }
  }
  if (tid == 0) counter[bi] = 0;
}

// x: [B, HW, C] of Tin, out: of Tout, C a multiple of the 16-byte vector of
// Tin; one vector (4 float32 or 8 bfloat16 values) per thread and step.
template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kApplyThreads)
gn_apply_kernel(const Tin* __restrict__ x, const float* __restrict__ a,
                const float* __restrict__ b, Tout* __restrict__ out,
                long long total_v, int hwc, int c, int apply_silu) {
  constexpr int V = Vec16<Tin>::N;
  const long long stride = static_cast<long long>(gridDim.x) * kApplyThreads;
  for (long long i = blockIdx.x * static_cast<long long>(kApplyThreads) + threadIdx.x;
       i < total_v; i += stride) {
    const long long e = i * V;
    const int bi = static_cast<int>(e / hwc);
    const int ch = static_cast<int>(e % c);
    float v[V];
    Vec16<Tin>::load(x + e, v);
#pragma unroll
    for (int j = 0; j < V; j += 4) {
      const float4 av = *reinterpret_cast<const float4*>(a + bi * c + ch + j);
      const float4 bv = *reinterpret_cast<const float4*>(b + bi * c + ch + j);
      if constexpr (std::is_same<Tin, float>::value) {
        v[j] = v[j] * av.x + bv.x;
        v[j + 1] = v[j + 1] * av.y + bv.y;
        v[j + 2] = v[j + 2] * av.z + bv.z;
        v[j + 3] = v[j + 3] * av.w + bv.w;
      } else {
        v[j] = affine_rn(v[j], av.x, bv.x);
        v[j + 1] = affine_rn(v[j + 1], av.y, bv.y);
        v[j + 2] = affine_rn(v[j + 2], av.z, bv.z);
        v[j + 3] = affine_rn(v[j + 3], av.w, bv.w);
      }
    }
    if (apply_silu) {
#pragma unroll
      for (int j = 0; j < V; ++j) v[j] = std::is_same<Tin, float>::value ? silu(v[j]) : silu_rn(v[j]);
    }
    store_vec<Tout, V>(out + e, v);
  }
}

// ----------------------------------------------------------------------- conv

__device__ __forceinline__ uint32_t tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

// v = hi + lo, each a TF32 value
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32(v);
  lo = tf32(v - __uint_as_float(hi));
}

// d += a * b: a 16x8 (row), b 8x8 (col), d 16x8, float32 accumulation
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a * b: a 16x16 bf16 (row), b 16x8 bf16 (col), d 16x8, float32 accumulation
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16 bytes from global to shared, asynchronously; zeros when !valid
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Row stride of a staged weight row: a warp's fragment loads (lanes g = 0..7
// over columns, t = 0..3 over rows t in TF32, rows 2t in bf16) hit 32
// distinct banks when it is 8 mod 32 (TF32) or 4 mod 32 (bf16).
__host__ __device__ constexpr int weight_row_stride(int bn, int mod = 8) {
  return bn + (mod - bn % 32 + 32) % 32;
}

// What the conv's activation type sets: input channels per K chunk (32 bytes
// of a position either way), bytes a position of the activated tile takes
// (float32: hi and lo of 8 channels; bf16: 16 channels), and the weight
// rows' stride rule.
template <typename T>
struct ConvTypes;
template <>
struct ConvTypes<float> {
  static constexpr int kBK = 8;
  static constexpr int kActBytes = 4 * kActFloats;
  static constexpr int kWMod = 8;
};
template <>
struct ConvTypes<bf16> {
  static constexpr int kBK = 16;
  static constexpr int kActBytes = 32;
  static constexpr int kWMod = 4;
};

template <typename T>
struct ConvArgs {
  const T* x;              // [B, H, W, Cin]
  const float* a;          // [B, Cin] GroupNorm affine
  const float* b;
  const float* w;          // [3, 3, Cin, Cout], float32
  const float* bias;       // row bi at bias + bi * bias_row_stride
  int bias_row_stride;
  const T* skip;           // [B, H, W, Cout] or null
  float skip_coef;
  T* out;                  // [B, H, W, Cout]
  float* partial;          // [splits, B*H*W, Cout] when splits > 1
  int batch, h, wd, cin, cout;
  int th, tw, tiles_w, tiles_per_image;  // the position tile
  int units_per_split, splits;           // K units: (live tap, K chunk)
};

__host__ __device__ inline int conv_taps(int h, int wd) {
  return (h > 1 ? 3 : 1) * (wd > 1 ? 3 : 1);
}

// Dynamic shared memory of one block, in bytes (conv_plan computes the same):
// a ring of `stages` (raw halo, 32 bytes a position; float32 weights) and
// `act_bufs` activated tiles.
template <typename T>
__host__ __device__ inline int conv_smem_bytes(int bn, int th, int tw, int taps,
                                               int stages = kStages, int act_bufs = 2) {
  const int halo = (th + 2) * (tw + 2);
  return stages * (halo * 32 + 4 * taps * ConvTypes<T>::kBK *
                                   weight_row_stride(bn, ConvTypes<T>::kWMod)) +
         act_bufs * halo * ConvTypes<T>::kActBytes;
}

// The state of one conv block, shared by the kernels: its tile of positions,
// output channels and K range, and the staging of a chunk.
template <typename T>
struct ConvBlock {
  static constexpr int kBKT = ConvTypes<T>::kBK;
  static constexpr int kActWords = ConvTypes<T>::kActBytes / 4;
  const ConvArgs<T> p;
  float* raw_s;  // [stages][halo_n][8 words]: 32 bytes of x a position
  float* w_s;    // [stages][taps][kBKT][bnp]
  float* act_s;  // [bufs][halo_n][kActWords]
  int bi, oh0, ow0, n0, split;
  int dy0, dx0, nx, taps, u0, u1, c_first, c_last;
  int halo_w, halo_n, raw_size, w_size;

  __device__ ConvBlock(const ConvArgs<T>& args, float* smem, int bn, int bnp,
                       int stages = kStages)
      : p(args) {
    bi = blockIdx.x / p.tiles_per_image;
    const int tile = blockIdx.x - bi * p.tiles_per_image;
    oh0 = (tile / p.tiles_w) * p.th;
    ow0 = (tile % p.tiles_w) * p.tw;
    n0 = blockIdx.y * bn;
    split = blockIdx.z;
    // live taps l = 0..taps-1 -> (dy, dx) = (dy0 + l / nx, dx0 + l % nx)
    dy0 = p.h > 1 ? -1 : 0;
    dx0 = p.wd > 1 ? -1 : 0;
    nx = p.wd > 1 ? 3 : 1;
    taps = conv_taps(p.h, p.wd);
    const int units = (p.cin / kBKT) * taps;
    u0 = split * p.units_per_split;
    u1 = min(units, u0 + p.units_per_split);
    c_first = u0 / taps;
    c_last = (u1 - 1) / taps;
    halo_w = p.tw + 2;
    halo_n = (p.th + 2) * halo_w;
    raw_size = halo_n * 8;
    w_size = taps * kBKT * bnp;
    raw_s = smem;
    w_s = raw_s + stages * raw_size;
    act_s = w_s + stages * w_size;
  }

  __device__ int chunks() const { return c_last - c_first + 1; }

  // the live taps [lo, hi) of chunk c in this block's K range
  __device__ void tap_range(int c, int& lo, int& hi) const {
    lo = c == c_first ? u0 - c * taps : 0;
    hi = c == c_last ? u1 - c * taps : taps;
  }

  // halo position hp -> map position (ih, iw); true inside the map.
  // kHaloW: the halo width when the kernel knows it at compile time, else 0.
  template <int kHaloW = 0>
  __device__ bool in_map(int hp, int& ih, int& iw) const {
    const int hw = kHaloW ? kHaloW : halo_w;
    const int hr = hp / hw;
    ih = oh0 - 1 + hr;
    iw = ow0 - 1 + (hp - hr * hw);
    return ih >= 0 && ih < p.h && iw >= 0 && iw < p.wd;
  }

  // Stage chunk i of this block's range: the raw x halo and its taps' weights,
  // by threads tid = 0..kThreads-1. kHaloW != 0: the halo width is known and
  // all nine taps are live.
  template <int BN, int kThreads, int kHaloW = 0>
  __device__ void load_chunk(int tid, int i, int stage) const {
    constexpr int BNP = weight_row_stride(BN, ConvTypes<T>::kWMod);
    constexpr int kVecs = BN / 4;           // 16-byte pieces of one weight row
    constexpr int kHalf = 16 / sizeof(T);   // channels in 16 bytes of x
    const int c = c_first + i;
    const int ci0 = c * kBKT;
    const T* xb = p.x + static_cast<long long>(bi) * p.h * p.wd * p.cin;
    float* rs = raw_s + stage * raw_size;
    float* ws = w_s + stage * w_size;
    int lo, hi;
    tap_range(c, lo, hi);
    const int n_halo = halo_n * 2;
    const int total = n_halo + (hi - lo) * kBKT * kVecs;
#pragma unroll 4
    for (int e = tid; e < total; e += kThreads) {
      if (e < n_halo) {  // 16 bytes of a halo position's chunk
        const int hp = e >> 1;
        const int half = e & 1;
        int ih, iw;
        const bool ok = in_map<kHaloW>(hp, ih, iw);
        const T* src =
            ok ? xb + (static_cast<long long>(ih) * p.wd + iw) * p.cin + ci0 + half * kHalf : p.x;
        cp_async16(rs + hp * 8 + half * 4, src, ok);
      } else {  // 16 bytes of a weight row
        const int ew = e - n_halo;
        const int l = lo + ew / (kBKT * kVecs);
        const int r = ew % (kBKT * kVecs);
        const int k = r / kVecs;
        const int v = r % kVecs;
        const int tap = kHaloW ? l : (dy0 + l / nx + 1) * 3 + (dx0 + l % nx + 1);
        const int n = n0 + v * 4;
        const bool ok = n < p.cout;
        const float* src =
            ok ? p.w + (static_cast<long long>(tap) * p.cin + ci0 + k) * p.cout + n : p.w;
        cp_async16(ws + (l * kBKT + k) * BNP + v * 4, src, ok);
      }
    }
  }

  // The float32 prologue, once per staged element: x*a+b, SiLU, zero
  // padding, split. Thread tid always takes channels k and k + 4, k = tid %
  // 4, by threads tid = 0..kThreads-1 (kThreads % 4 == 0). Packed: per
  // position, for k = 0..3, (hi_k, hi_k+4, lo_k, lo_k+4) (mma.sync A
  // fragments). Planar: four planes [halo_n][4], hi of channels 0-3, hi of
  // 4-7, lo of 0-3, lo of 4-7 (wgmma's K-major core matrices).
  template <bool kPlanar, int kThreads, int kHaloW = 0>
  __device__ void activate(int tid, int i, int stage, int buf) const {
    const int ci0 = (c_first + i) * kBK;
    const int k = tid & 3;
    const float* ab = p.a + static_cast<long long>(bi) * p.cin + ci0;
    const float* bb = p.b + static_cast<long long>(bi) * p.cin + ci0;
    const float a0 = __ldg(ab + k), a1 = __ldg(ab + k + 4);
    const float b0 = __ldg(bb + k), b1 = __ldg(bb + k + 4);
    const float* rs = raw_s + stage * raw_size;
    float* as = act_s + buf * halo_n * kActWords;
#pragma unroll 4
    for (int e = tid; e < halo_n * 4; e += kThreads) {
      const int hp = e >> 2;
      int ih, iw;
      float v0 = 0.0f, v1 = 0.0f;
      if (in_map<kHaloW>(hp, ih, iw)) {
        v0 = silu_fast(rs[hp * kBK + k] * a0 + b0);
        v1 = silu_fast(rs[hp * kBK + k + 4] * a1 + b1);
      }
      uint32_t h0, l0, h1, l1;
      split_tf32(v0, h0, l0);
      split_tf32(v1, h1, l1);
      if (kPlanar) {
        uint32_t* plane = reinterpret_cast<uint32_t*>(as) + hp * 4 + k;
        plane[0] = h0;
        plane[halo_n * 4] = h1;
        plane[2 * halo_n * 4] = l0;
        plane[3 * halo_n * 4] = l1;
      } else {
        *reinterpret_cast<uint4*>(as + hp * kActFloats + k * 4) = make_uint4(h0, h1, l0, l1);
      }
    }
  }

  // The bf16 prologue, once per staged element: x*a+b and SiLU in float32,
  // rounded as the plain version rounds them (affine_rn, silu_rn), zero
  // padding, one rounding to bf16. Thread tid always takes the channel
  // pair (2j, 2j + 1), j = tid % 8 (kThreads % 8 == 0), one 32-bit word.
  // Packed: per position, for t = 0..3, channels (2t, 2t+1, 2t+8, 2t+9), so
  // that one 8-byte load gives a thread both halves of its m16n8k16 A row.
  // Planar: two planes [halo_n][8], channels 0-7 and 8-15 (wgmma's K-major
  // core matrices: 8 positions x 16 bytes).
  template <bool kPlanar, int kThreads, int kHaloW = 0>
  __device__ void activate_bf16(int tid, int i, int stage, int buf) const {
    const int ci0 = (c_first + i) * kBKT;
    const int j = tid & 7;
    const float* ab = p.a + static_cast<long long>(bi) * p.cin + ci0 + 2 * j;
    const float* bb = p.b + static_cast<long long>(bi) * p.cin + ci0 + 2 * j;
    const float a0 = __ldg(ab), a1 = __ldg(ab + 1);
    const float b0 = __ldg(bb), b1 = __ldg(bb + 1);
    const uint32_t* rs = reinterpret_cast<const uint32_t*>(raw_s + stage * raw_size);
    uint32_t* as = reinterpret_cast<uint32_t*>(act_s + buf * halo_n * kActWords);
    const int word = kPlanar ? (j >> 2) * halo_n * 4 + (j & 3) : (j & 3) * 2 + (j >> 2);
#pragma unroll 4
    for (int e = tid; e < halo_n * 8; e += kThreads) {
      const int hp = e >> 3;
      int ih, iw;
      float v0 = 0.0f, v1 = 0.0f;
      if (in_map<kHaloW>(hp, ih, iw)) {
        const uint32_t xw = rs[hp * 8 + j];
        v0 = silu_rn(affine_rn(bf16_lo(xw), a0, b0));
        v1 = silu_rn(affine_rn(bf16_hi(xw), a1, b1));
      }
      as[hp * (kPlanar ? 4 : 8) + word] = pack_bf16x2(v0, v1);
    }
  }

  // one output value pair: bias, skip and scale, or a partial sum of the split
  __device__ void store(int pos_in_batch, int n, float v0, float v1, bool pair) const {
    const long long pos = static_cast<long long>(bi) * p.h * p.wd + pos_in_batch;
    if (p.splits > 1) {
      float* dst = p.partial + (split * static_cast<long long>(p.batch) * p.h * p.wd + pos) * p.cout + n;
      dst[0] = v0;
      if (pair) dst[1] = v1;
      return;
    }
    const long long off = pos * p.cout + n;
    const float* bt = p.bias + static_cast<long long>(bi) * p.bias_row_stride + n;
    v0 += bt[0];
    if (pair) v1 += bt[1];
    if (p.skip != nullptr) {
      v0 = (to_f32(p.skip[off]) + v0) * p.skip_coef;
      if (pair) v1 = (to_f32(p.skip[off + 1]) + v1) * p.skip_coef;
    }
    if constexpr (std::is_same<T, bf16>::value) {
      if (pair) {  // n is even: a 4-byte store
        *reinterpret_cast<uint32_t*>(p.out + off) = pack_bf16x2(v0, v1);
        return;
      }
    }
    p.out[off] = from_f32<T>(v0);
    if (pair) p.out[off + 1] = from_f32<T>(v1);
  }
};

// grid (B * tiles_per_image, ceil(Cout / BN), splits)
template <typename T, int BM, int BN, int WARPS_M, int WARPS_N>
__global__ void __launch_bounds__(32 * WARPS_M * WARPS_N)
gn_silu_conv3x3_kernel(const ConvArgs<T> p) {
  constexpr bool kBf16 = std::is_same<T, bf16>::value;
  constexpr int kThreads = 32 * WARPS_M * WARPS_N;
  constexpr int WM = BM / WARPS_M;
  constexpr int WN = BN / WARPS_N;
  constexpr int MT = WM / 16;  // m16 tiles per warp
  constexpr int NT = WN / 8;   // n8 tiles per warp
  constexpr int BNP = weight_row_stride(BN, ConvTypes<T>::kWMod);
  constexpr int kBKT = ConvTypes<T>::kBK;
  static_assert(MT >= 1 && NT >= 1 && BM % (16 * WARPS_M) == 0 && BN % (8 * WARPS_N) == 0,
                "warp tile must be whole m16n8 tiles");

  extern __shared__ __align__(16) float smem[];
  const ConvBlock<T> blk(p, smem, BN, BNP);

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int g = lane / 4;  // fragment row / column group
  const int t = lane % 4;  // thread in group
  const int wm0 = (warp / WARPS_N) * WM;
  const int wn0 = (warp % WARPS_N) * WN;
  const int nchunks = blk.chunks();

  // Halo index of each A-fragment row at tap (0, 0); rows past the tile read
  // the tile's first position and are never stored.
  int hb[MT][2];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = wm0 + mi * 16 + g + hf * 8;
      const int r = row < p.th * p.tw ? row / p.tw : 0;
      const int c = row < p.th * p.tw ? row - r * p.tw : 0;
      hb[mi][hf] = (r + 1) * blk.halo_w + c + 1;
    }

  float acc[MT][NT][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0.0f;

  auto activate = [&](int i, int stage, int buf) {
    if constexpr (kBf16) {
      blk.template activate_bf16<false, kThreads>(tid, i, stage, buf);
    } else {
      blk.template activate<false, kThreads>(tid, i, stage, buf);
    }
  };

  // The ring: chunk i lands in stage i % kStages, kStages - 1 chunks ahead;
  // it is activated into buffer i % 2 one chunk ahead of the tensor cores.
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < nchunks) blk.template load_chunk<BN, kThreads>(tid, i, i);
    cp_async_commit();
  }
  cp_async_wait<kStages - 2>();
  __syncthreads();
  activate(0, 0, 0);
  for (int i = 0; i < nchunks; ++i) {
    cp_async_wait<kStages - 3>();
    // chunk i + 1 is in and chunk i activated; every warp is done with i - 1
    __syncthreads();
    if (i + 1 < nchunks) activate(i + 1, (i + 1) % kStages, (i + 1) % 2);
    const int next = i + kStages - 1;
    if (next < nchunks) blk.template load_chunk<BN, kThreads>(tid, next, next % kStages);
    cp_async_commit();
    int lo, hi;
    blk.tap_range(blk.c_first + i, lo, hi);
    const float* ws = blk.w_s + (i % kStages) * blk.w_size;
    if constexpr (kBf16) {  // one m16n8k16 per tap (inline: acc stays in registers)
      const uint32_t* as = reinterpret_cast<const uint32_t*>(
                               blk.act_s + (i % 2) * blk.halo_n * ConvBlock<T>::kActWords) + t * 2;
      for (int l = lo; l < hi; ++l) {
        const int shift = (blk.dy0 + l / blk.nx) * blk.halo_w + (blk.dx0 + l % blk.nx);
        uint32_t af[MT][4];
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
          // rows g and g + 8: columns (2t, 2t+1) and (2t+8, 2t+9)
          const uint2 q0 = *reinterpret_cast<const uint2*>(as + (hb[mi][0] + shift) * 8);
          const uint2 q1 = *reinterpret_cast<const uint2*>(as + (hb[mi][1] + shift) * 8);
          af[mi][0] = q0.x;
          af[mi][1] = q1.x;
          af[mi][2] = q0.y;
          af[mi][3] = q1.y;
        }
        const float* wl = ws + l * kBKT * BNP + wn0 + g;
#pragma unroll
        for (int ni = 0; ni < NT; ++ni) {
          // rows (2t, 2t+1) and (2t+8, 2t+9) of column g, rounded to bf16
          const uint32_t bf[2] = {
              pack_bf16x2(wl[2 * t * BNP + ni * 8], wl[(2 * t + 1) * BNP + ni * 8]),
              pack_bf16x2(wl[(2 * t + 8) * BNP + ni * 8], wl[(2 * t + 9) * BNP + ni * 8])};
#pragma unroll
          for (int mi = 0; mi < MT; ++mi) mma_bf16(acc[mi][ni], af[mi], bf);
        }
      }
    } else {  // 3xTF32 (inline: acc stays in registers)
      const float* as = blk.act_s + (i % 2) * blk.halo_n * kActFloats + t * 4;
      for (int l = lo; l < hi; ++l) {
        const int shift = (blk.dy0 + l / blk.nx) * blk.halo_w + (blk.dx0 + l % blk.nx);
        uint32_t ah[MT][4], al[MT][4];
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
          // rows g and g + 8, columns t and t + 4, hi and lo
          const uint4 q0 = *reinterpret_cast<const uint4*>(as + (hb[mi][0] + shift) * kActFloats);
          const uint4 q1 = *reinterpret_cast<const uint4*>(as + (hb[mi][1] + shift) * kActFloats);
          ah[mi][0] = q0.x;
          ah[mi][1] = q1.x;
          ah[mi][2] = q0.y;
          ah[mi][3] = q1.y;
          al[mi][0] = q0.z;
          al[mi][1] = q1.z;
          al[mi][2] = q0.w;
          al[mi][3] = q1.w;
        }
        const float* wl = ws + l * kBK * BNP + wn0 + g;
#pragma unroll
        for (int ni = 0; ni < NT; ++ni) {
          uint32_t bh[2], bl[2];
          split_tf32(wl[t * BNP + ni * 8], bh[0], bl[0]);
          split_tf32(wl[(t + 4) * BNP + ni * 8], bh[1], bl[1]);
          // the small products first; independent tiles between dependent ones
#pragma unroll
          for (int mi = 0; mi < MT; ++mi) mma_tf32(acc[mi][ni], al[mi], bh);
#pragma unroll
          for (int mi = 0; mi < MT; ++mi) mma_tf32(acc[mi][ni], ah[mi], bl);
#pragma unroll
          for (int mi = 0; mi < MT; ++mi) mma_tf32(acc[mi][ni], ah[mi], bh);
        }
      }
    }
  }

  // Epilogue: fragment d[0..1] is row g, columns 2t, 2t+1; d[2..3] row g + 8.
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = wm0 + mi * 16 + g + hf * 8;
      if (row >= p.th * p.tw) continue;
      const int oh = blk.oh0 + row / p.tw;
      const int ow = blk.ow0 + row % p.tw;
      if (oh >= p.h || ow >= p.wd) continue;
#pragma unroll
      for (int ni = 0; ni < NT; ++ni) {
        const int n = blk.n0 + wn0 + ni * 8 + 2 * t;
        if (n < p.cout) {
          blk.store(oh * p.wd + ow, n, acc[mi][ni][2 * hf], acc[mi][ni][2 * hf + 1], true);
        }
      }
    }
}

// d += a * b, wgmma m64n32k8 tf32: a in registers (the m16n8k8 A fragment of
// each warp's 16 rows), b a K-major shared-memory tile given by its descriptor
__device__ __forceinline__ void wgmma_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// d += a * b, wgmma m64n32k16 bf16: a in registers (the m16n8k16 A fragment
// of each warp's 16 rows), b a K-major shared-memory tile (no transpose)
__device__ __forceinline__ void wgmma_n32_bf16(float (&d)[16], const uint32_t (&a)[4],
                                               uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}


// generic-proxy writes to shared memory, made visible to wgmma's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Keeps the compiler from moving accesses to v across this point: the
// accumulators across a wgmma wait, and the A fragments' computation ahead
// of wgmma.fence (else ptxas must fence before every wgmma).
__device__ __forceinline__ void fence_operand(float& v) { asm volatile("" : "+f"(v)::"memory"); }
__device__ __forceinline__ void fence_operand(uint32_t& v) { asm volatile("" : "+r"(v)); }

// Shared-memory matrix descriptor, no swizzle: start address, the byte
// offset between the two core matrices along K (LBO) and between core
// matrices of 8 rows along M/N (SBO), all in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(const float* ptr, uint32_t lbo, uint32_t sbo) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32);
}

// Blocks of the wgmma kernel on one SM: two in float32 (~104 KB each); one
// in bf16, whose 16-channel chunks of float32 weights take 76 KB a stage.
template <typename T>
__host__ __device__ constexpr int wgmma_blocks_per_sm() {
  return std::is_same<T, float>::value ? 2 : 1;
}

// The large levels on wgmma: a block of two warpgroups computes 128 output
// channels (64 per warpgroup: M) of a (128 / TW) x TW tile of positions; each
// wgmma takes one output row (N = TW positions) at one tap. The weights are
// the register operand A, loaded and split (TF32) or rounded (bf16) by the
// threads; the activated tile is operand B, K-major: in each of its planes a
// position's channels (4 float32 or 8 bf16) are 16 contiguous bytes, so 8
// consecutive positions are one core matrix, and a tap's shift of the row is
// a shift of the descriptor's start address.
// In float32 two blocks share an SM: a 2-stage ring and one activated tile
// (~104 KB of shared memory), and the A fragments of only two taps live at a
// time (tap l + 1's load while tap l's wgmmas run), so that a block fits 128
// registers a thread. Within a block the prologue and the tensor cores take
// turns (a warp issuing wgmma stalls while the tensor cores' queue is full);
// the other block on the SM fills the gaps.
// grid (B * tiles_per_image, ceil(Cout / 128), splits); H > 1 and W > 1.
template <typename T, int TW>
__global__ void __launch_bounds__(256, wgmma_blocks_per_sm<T>())
gn_silu_conv3x3_wgmma_kernel(const ConvArgs<T> p) {
  static_assert(TW == 32, "the wgmma wrappers are m64n32");
  constexpr bool kBf16 = std::is_same<T, bf16>::value;
  constexpr int kThreads = 256;
  constexpr int kRing = 2;
  constexpr int BN = 128;
  constexpr int BNP = weight_row_stride(BN, ConvTypes<T>::kWMod);
  constexpr int kBKT = ConvTypes<T>::kBK;
  constexpr int TH = 128 / TW;
  constexpr int NREG = TW / 2;
  constexpr int kHaloW = TW + 2;

  extern __shared__ __align__(16) float smem[];
  const ConvBlock<T> blk(p, smem, BN, BNP, kRing);

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid / 32) % 4;
  const int g = (tid % 32) / 4;
  const int t = tid % 4;
  const int m0 = wg * 64 + warp * 16 + g;
  const int nchunks = blk.chunks();
  const uint32_t plane_bytes = blk.halo_n * 16;

  float acc[TH][NREG];
#pragma unroll
  for (int r = 0; r < TH; ++r)
#pragma unroll
    for (int j = 0; j < NREG; ++j) acc[r][j] = 0.0f;

  blk.template load_chunk<BN, kThreads, kHaloW>(tid, 0, 0);
  cp_async_commit();
  for (int i = 0; i < nchunks; ++i) {
    CONV_TRACE(0);
    cp_async_wait<0>();
    CONV_TRACE(1);
    // chunk i is in; every wgmma of chunk i - 1 is done
    __syncthreads();
    if (i + 1 < nchunks) blk.template load_chunk<BN, kThreads, kHaloW>(tid, i + 1, (i + 1) % kRing);
    cp_async_commit();
    CONV_TRACE(2);
    if constexpr (kBf16) {
      blk.template activate_bf16<true, kThreads, kHaloW>(tid, i, i % kRing, 0);
    } else {
      blk.template activate<true, kThreads, kHaloW>(tid, i, i % kRing, 0);
    }
    CONV_TRACE(3);
    fence_proxy_async();
    __syncthreads();
    CONV_TRACE(4);
    int lo, hi;
    blk.tap_range(blk.c_first + i, lo, hi);
    const float* ws = blk.w_s + (i % kRing) * blk.w_size;
    if constexpr (kBf16) {
      // planes of channels 0-7 and 8-15: the two core matrices along K
      const uint64_t d0 = smem_desc(blk.act_s, plane_bytes, 128);
      // A fragments of tap l in set l % 2, rounded to bf16; a tap outside
      // this block's K range gets zeros, so that the wgmma sequence has no
      // branch
      uint32_t af[2][4];
      auto load_a = [&](int l, int set) {
        const bool live = l >= lo && l < hi;
        const float* wl = ws + (live ? l : lo) * kBKT * BNP + m0;
        // rows (2t, 2t+1) then (2t+8, 2t+9), at output channels g and g + 8
        const float w8[8] = {wl[2 * t * BNP],           wl[(2 * t + 1) * BNP],
                             wl[2 * t * BNP + 8],       wl[(2 * t + 1) * BNP + 8],
                             wl[(2 * t + 8) * BNP],     wl[(2 * t + 9) * BNP],
                             wl[(2 * t + 8) * BNP + 8], wl[(2 * t + 9) * BNP + 8]};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          af[set][k] = pack_bf16x2(live ? w8[2 * k] : 0.0f, live ? w8[2 * k + 1] : 0.0f);
          fence_operand(af[set][k]);
        }
      };
      load_a(0, 0);
#pragma unroll
      for (int r = 0; r < TH; ++r)
#pragma unroll
        for (int j = 0; j < NREG; ++j) fence_operand(acc[r][j]);
#pragma unroll
      for (int l = 0; l < 9; ++l) {
        wgmma_fence();
#pragma unroll
        for (int r = 0; r < TH; ++r) {
          const int pos = (r + 1 + l / 3 - 1) * kHaloW + 1 + l % 3 - 1;
          wgmma_n32_bf16(acc[r], af[l % 2], d0 + pos);
        }
        wgmma_commit();
        if (l < 8) {
          wgmma_wait<1>();  // tap l - 1 is done: its set takes tap l + 1
          load_a(l + 1, (l + 1) % 2);
        }
      }
    } else {
      const uint64_t hi0 = smem_desc(blk.act_s, plane_bytes, 128);
      const uint64_t lo0 = smem_desc(blk.act_s + 2 * blk.halo_n * 4, plane_bytes, 128);
      // A fragments of tap l in set l % 2; a tap outside this block's K range
      // gets zeros, so that the wgmma sequence has no branch
      uint32_t ah[2][4], al[2][4];
      auto load_a = [&](int l, int set) {
        const bool live = l >= lo && l < hi;
        const float* wl = ws + (live ? l : lo) * kBK * BNP + m0;
        const float w4[4] = {wl[t * BNP], wl[t * BNP + 8], wl[(t + 4) * BNP],
                             wl[(t + 4) * BNP + 8]};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          split_tf32(live ? w4[k] : 0.0f, ah[set][k], al[set][k]);
          fence_operand(ah[set][k]);
          fence_operand(al[set][k]);
        }
      };
      load_a(0, 0);
#pragma unroll
      for (int r = 0; r < TH; ++r)
#pragma unroll
        for (int j = 0; j < NREG; ++j) fence_operand(acc[r][j]);
#pragma unroll
      for (int l = 0; l < 9; ++l) {
        wgmma_fence();
#pragma unroll
        for (int r = 0; r < TH; ++r) {
          const int pos = (r + 1 + l / 3 - 1) * kHaloW + 1 + l % 3 - 1;
          wgmma_n32(acc[r], al[l % 2], hi0 + pos);
          wgmma_n32(acc[r], ah[l % 2], lo0 + pos);
          wgmma_n32(acc[r], ah[l % 2], hi0 + pos);
        }
        wgmma_commit();
        if (l < 8) {
          wgmma_wait<1>();  // tap l - 1 is done: its set takes tap l + 1
          load_a(l + 1, (l + 1) % 2);
        }
      }
    }
    CONV_TRACE(5);
    wgmma_wait<0>();
    CONV_TRACE(6);
#pragma unroll
    for (int r = 0; r < TH; ++r)
#pragma unroll
      for (int j = 0; j < NREG; ++j) fence_operand(acc[r][j]);
  }

  const int n_a = blk.n0 + m0;
#pragma unroll
  for (int r = 0; r < TH; ++r) {
    const int oh = blk.oh0 + r;
    if (oh >= p.h) continue;
#pragma unroll
    for (int j = 0; j < TW / 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int ow = blk.ow0 + 8 * j + 2 * t + (q & 1);
        const int n = n_a + (q >> 1) * 8;
        if (ow < p.wd && n < p.cout) blk.store(oh * p.wd + ow, n, acc[r][4 * j + q], 0.0f, false);
      }
  }
}

// out = [(skip +)] sum over splits, in split order, + bias [* skip_coef].
// partial: [splits, total4] float4; rows of hwc elements per batch row;
// skip and out of T, 4 values a step.
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
conv_split_reduce_kernel(const float4* __restrict__ partial, int splits, long long total4,
                         const float* __restrict__ bias, int bias_row_stride,
                         const T* __restrict__ skip, float skip_coef,
                         T* __restrict__ out, int hwc, int cout) {
  const long long stride = static_cast<long long>(gridDim.x) * kReduceThreads;
  for (long long i = blockIdx.x * static_cast<long long>(kReduceThreads) + threadIdx.x;
       i < total4; i += stride) {
    float4 s = partial[i];
    for (int z = 1; z < splits; ++z) {
      const float4 v = partial[z * total4 + i];
      s = make_float4(s.x + v.x, s.y + v.y, s.z + v.z, s.w + v.w);
    }
    const long long e = i * 4;
    const int bi = static_cast<int>(e / hwc);
    const int n = static_cast<int>(e % cout);
    const float4 bt = *reinterpret_cast<const float4*>(
        bias + static_cast<long long>(bi) * bias_row_stride + n);
    float o[4] = {s.x + bt.x, s.y + bt.y, s.z + bt.z, s.w + bt.w};
    if (skip != nullptr) {
      float k[4];
      if constexpr (std::is_same<T, float>::value) {
        const float4 kv = reinterpret_cast<const float4*>(skip)[i];
        k[0] = kv.x; k[1] = kv.y; k[2] = kv.z; k[3] = kv.w;
      } else {
        const uint2 kv = reinterpret_cast<const uint2*>(skip)[i];
        k[0] = bf16_lo(kv.x); k[1] = bf16_hi(kv.x); k[2] = bf16_lo(kv.y); k[3] = bf16_hi(kv.y);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) o[j] = (k[j] + o[j]) * skip_coef;
    }
    store_vec<T, 4>(out + e, o);
  }
}

template <typename T, int BM, int BN, int WARPS_M, int WARPS_N>
cudaError_t launch_conv(const ConvArgs<T>& p, dim3 grid, int smem_bytes, cudaStream_t stream) {
  if (grid.y * BN < static_cast<unsigned>(p.cout) || p.th * p.tw > BM ||
      smem_bytes < conv_smem_bytes<T>(BN, p.th, p.tw, conv_taps(p.h, p.wd)) ||
      smem_bytes > kSmemLimit) {
    return cudaErrorInvalidValue;
  }
  auto kernel = gn_silu_conv3x3_kernel<T, BM, BN, WARPS_M, WARPS_N>;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, 32 * WARPS_M * WARPS_N, smem_bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int TW>
cudaError_t launch_conv_wgmma(const ConvArgs<T>& p, dim3 grid, int smem_bytes,
                              cudaStream_t stream) {
  if (grid.y * 128 < static_cast<unsigned>(p.cout) || p.th != 128 / TW || p.tw != TW ||
      p.h < 2 || p.wd < 2 || smem_bytes < conv_smem_bytes<T>(128, p.th, p.tw, 9, 2, 1) ||
      smem_bytes > kSmemLimit) {
    return cudaErrorInvalidValue;
  }
  auto kernel = gn_silu_conv3x3_wgmma_kernel<T, TW>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, 256, smem_bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
int stats_ab(const T* x, const float* scale, const float* bias, double* partial,
             int* counter, float* a, float* b, int batch, int hw, int c, int groups,
             int parts, int chunk, float eps, cudaStream_t stream) {
  constexpr int kThreads = stats_threads<T>();
  constexpr int V = Vec16<T>::N;
  if (c % V || c / V > kThreads || c % groups || parts < 1 ||
      static_cast<long long>(parts) * chunk < hw || (parts - 1) * chunk >= hw) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  gn_stats_ab_kernel<T><<<dim3(parts, batch), kThreads, 0, stream>>>(
      x, scale, bias, reinterpret_cast<double2*>(partial), counter, a, b, hw, c, groups,
      chunk, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename Tin, typename Tout>
int gn_apply(const Tin* x, const float* a, const float* b, Tout* out, int batch, int hw,
             int c, int apply_silu, cudaStream_t stream) {
  constexpr int V = Vec16<Tin>::N;
  if (c % V) return static_cast<int>(cudaErrorInvalidValue);
  const long long total_v = static_cast<long long>(batch) * hw * c / V;
  long long blocks = (total_v + kApplyThreads - 1) / kApplyThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  if (blocks < 1) blocks = 1;
  gn_apply_kernel<Tin, Tout><<<static_cast<int>(blocks), kApplyThreads, 0, stream>>>(
      x, a, b, out, total_v, hw * c, c, apply_silu);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int gn_silu_conv3x3(const T* x, const float* a, const float* b, const float* w,
                    const float* bias_total, int bias_row_stride, const T* skip,
                    float skip_coef, T* out, float* partial, int batch, int h, int wd,
                    int cin, int cout, int config, int th, int tw, int tiles_w,
                    int tiles_per_image, int units_per_split, int splits, int grid_x,
                    int grid_y, int grid_z, int smem_bytes, int reduce_blocks,
                    cudaStream_t st) {
  constexpr int kBKT = ConvTypes<T>::kBK;
  const int units = (cin / kBKT) * conv_taps(h, wd);
  if (cin % kBKT || cout % 4 || th < 1 || tw < 1 || units_per_split < 1 || splits < 1 ||
      grid_z != splits || grid_x != batch * tiles_per_image ||
      tiles_per_image % tiles_w || (tiles_per_image / tiles_w) * th < h ||
      tiles_w * tw < wd || static_cast<long long>(splits) * units_per_split < units ||
      (splits - 1) * units_per_split >= units || (splits > 1 && partial == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const ConvArgs<T> p{x, a, b, w, bias_total, bias_row_stride, skip, skip_coef, out, partial,
                      batch, h, wd, cin, cout, th, tw, tiles_w, tiles_per_image,
                      units_per_split, splits};
  const dim3 grid(grid_x, grid_y, grid_z);
  cudaError_t err;
  switch (config) {
    case 0: err = launch_conv<T, 64, 64, 2, 2>(p, grid, smem_bytes, st); break;
    case 1: err = launch_conv<T, 128, 8, 8, 1>(p, grid, smem_bytes, st); break;
    case 2: err = launch_conv_wgmma<T, 32>(p, grid, smem_bytes, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const long long total4 = static_cast<long long>(batch) * h * wd * cout / 4;
  conv_split_reduce_kernel<T><<<reduce_blocks, kReduceThreads, 0, st>>>(
      reinterpret_cast<const float4*>(partial), splits, total4, bias_total, bias_row_stride,
      skip, skip_coef, out, h * wd * cout, cout);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype codes (ops/cuda_kernels.py _DTYPE_CODES): 0 float32, 1 bfloat16.

int diffse_gn_stats_ab(const void* x, int dtype, const float* scale, const float* bias,
                       double* partial, int* counter, float* a, float* b, int batch,
                       int hw, int c, int groups, int parts, int chunk, float eps,
                       void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return stats_ab(static_cast<const float*>(x), scale, bias, partial, counter, a,
                            b, batch, hw, c, groups, parts, chunk, eps, st);
    case 1: return stats_ab(static_cast<const bf16*>(x), scale, bias, partial, counter, a, b,
                            batch, hw, c, groups, parts, chunk, eps, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int diffse_gn_apply(const void* x, int in_dtype, const float* a, const float* b, void* out,
                    int out_dtype, int batch, int hw, int c, int apply_silu, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_dtype == 0 && out_dtype == 0) {
    return gn_apply(static_cast<const float*>(x), a, b, static_cast<float*>(out), batch, hw,
                    c, apply_silu, st);
  }
  if (in_dtype == 1 && out_dtype == 1) {
    return gn_apply(static_cast<const bf16*>(x), a, b, static_cast<bf16*>(out), batch, hw,
                    c, apply_silu, st);
  }
  if (in_dtype == 1 && out_dtype == 0) {
    return gn_apply(static_cast<const bf16*>(x), a, b, static_cast<float*>(out), batch, hw,
                    c, apply_silu, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The plan's config ids, in the order of CONV_CONFIGS in ops/cuda_kernels.py;
// x, skip and out of the dtype's type.
int diffse_gn_silu_conv3x3(const void* x, int dtype, const float* a, const float* b,
                           const float* w, const float* bias_total,
                           int bias_row_stride, const void* skip,
                           float skip_coef, void* out, float* partial,
                           int batch, int h, int wd, int cin, int cout,
                           int config, int th, int tw, int tiles_w, int tiles_per_image,
                           int units_per_split, int splits, int grid_x, int grid_y,
                           int grid_z, int smem_bytes, int reduce_blocks, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return gn_silu_conv3x3(static_cast<const float*>(x), a, b, w, bias_total,
                             bias_row_stride, static_cast<const float*>(skip), skip_coef,
                             static_cast<float*>(out), partial, batch, h, wd, cin, cout,
                             config, th, tw, tiles_w, tiles_per_image, units_per_split,
                             splits, grid_x, grid_y, grid_z, smem_bytes, reduce_blocks, st);
    case 1:
      return gn_silu_conv3x3(static_cast<const bf16*>(x), a, b, w, bias_total,
                             bias_row_stride, static_cast<const bf16*>(skip), skip_coef,
                             static_cast<bf16*>(out), partial, batch, h, wd, cin, cout,
                             config, th, tw, tiles_w, tiles_per_image, units_per_split,
                             splits, grid_x, grid_y, grid_z, smem_bytes, reduce_blocks, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

#ifdef DIFFSE_CONV_TRACE
int diffse_conv_trace_fetch(long long* host) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, g_conv_trace, sizeof(g_conv_trace)));
}
#endif

}  // extern "C"
