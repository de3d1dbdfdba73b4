// Fused LayerNorm -> Dense, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_ln_dense_kernel` (veon_tpu/ops/fused_ln.py:36,
// launched by `ln_dense_pallas`). Contract, per row of x (M, C):
//   y   = (x - mean) * rsqrt(var + eps) * ln_scale + ln_bias   (fp32; var
//         the centred mean square, as the TPU kernel computes it)
//   out = cast_T( sum_k cast_T(y)[k] * w[k, n]  (fp32 accumulator)  + b[n] )
// with T the type of x and w (float32 or bfloat16, one type for both) and
// ln_scale, ln_bias, b given in fp32. C and N are multiples of 128, as the
// TPU entry asserts; any M (the last row tile is masked).
//
// Bound on the H100: bytes in bf16 (x read once, W and the vectors once, out
// written once: 208.5 MB, ~0.062 ms at 3.35 TB/s, at the HSA qkv shape
// 67,584 x 384 @ 384 x 1,152), operations in fp32 (2 M C N = 59.8 GFLOP
// there, ~0.89 ms at 67 TFLOP/s outside the tensor cores: fp32 stays fp32,
// no TF32).
//
// Design (simple first; wgmma, TMA and a pipeline are later work): one CTA
// of 256 threads per 64-row tile. Its 8 warps normalise the tile's rows (one
// warp per row, 4 consecutive channels per lane and 16-byte or 8-byte
// loads, the row kept in registers for the two reductions) into shared
// memory in T, so the normalised tensor never goes to device memory. The
// CTA then walks N in 128-column tiles:
//   * bf16: warps in a 2 x 4 grid, each 32 x 32 of the tile as 2 x 2
//     16x16x16 `wmma` products with fp32 accumulators; W fragments are read
//     from global memory (W is at most 0.9 MB and stays in L2); the
//     accumulators go through shared memory for the fp32 bias add and one
//     rounding to bf16;
//   * fp32: 32-row chunks of the W column tile staged in shared memory, each
//     thread 4 rows x 8 columns of fp32 FMAs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBM = 64;          // rows per CTA
constexpr int kBN = 128;         // output columns per tile
constexpr int kThreads = 256;
constexpr int kMaxChunks = 8;    // C <= 1024 (128 channels per chunk)
constexpr int kLdc = kBN + 4;    // fp32 staging of the bf16 accumulators
constexpr int kKc = 32;          // fp32 path: rows of W per staged chunk
constexpr int kMaxSmem = 232448; // the H100's per-block dynamic shared memory

struct alignas(8) Bf16x4 {
  __nv_bfloat162 lo, hi;
};

__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void load4(const bf16* p, float v[4]) {
  const Bf16x4 t = *reinterpret_cast<const Bf16x4*>(p);
  const float2 a = __bfloat1622float2(t.lo), b = __bfloat1622float2(t.hi);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}
__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(bf16* p, const float v[4]) {
  Bf16x4 t;
  t.lo = __floats2bfloat162_rn(v[0], v[1]);
  t.hi = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<Bf16x4*>(p) = t;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Rows row0 .. row0 + kBM of x, normalised and affine, into As (kBM x lda,
// type T); rows past M are written as zeros.
template <typename T>
__device__ void layer_norm_tile(const T* __restrict__ x, const float* __restrict__ scale,
                                const float* __restrict__ shift, T* As, int lda, int row0,
                                int M, int C, float eps) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nch = C / 128;
  for (int r = warp; r < kBM; r += kThreads / 32) {
    T* dst = As + (size_t)r * lda;
    const int grow = row0 + r;
    if (grow >= M) {
      const float z[4] = {0.f, 0.f, 0.f, 0.f};
      for (int ch = 0; ch < nch; ++ch) store4(dst + ch * 128 + lane * 4, z);
      continue;
    }
    const T* src = x + (size_t)grow * C;
    float v[kMaxChunks][4];
    float sum = 0.f;
#pragma unroll
    for (int ch = 0; ch < kMaxChunks; ++ch) {
      if (ch < nch) {
        load4(src + ch * 128 + lane * 4, v[ch]);
        sum += (v[ch][0] + v[ch][1]) + (v[ch][2] + v[ch][3]);
      }
    }
    const float mean = warp_sum(sum) / C;
    float sq = 0.f;
#pragma unroll
    for (int ch = 0; ch < kMaxChunks; ++ch) {
      if (ch < nch) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float d = v[ch][i] - mean;
          sq += d * d;
        }
      }
    }
    const float rstd = rsqrtf(warp_sum(sq) / C + eps);
#pragma unroll
    for (int ch = 0; ch < kMaxChunks; ++ch) {
      if (ch < nch) {
        const int c0 = ch * 128 + lane * 4;
        float y[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) y[i] = (v[ch][i] - mean) * rstd * scale[c0 + i] + shift[c0 + i];
        store4(dst + c0, y);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
ln_dense_bf16_kernel(const bf16* __restrict__ x, const float* __restrict__ scale,
                     const float* __restrict__ shift, const bf16* __restrict__ w,
                     const float* __restrict__ bias, bf16* __restrict__ out, int M, int C, int N,
                     float eps) {
  namespace wmma = nvcuda::wmma;
  extern __shared__ __align__(128) unsigned char smem[];
  const int lda = C + 8;  // 16-byte row padding against bank conflicts
  bf16* As = reinterpret_cast<bf16*>(smem);
  float* Cs = reinterpret_cast<float*>(smem + (size_t)kBM * lda * sizeof(bf16));
  const int row0 = blockIdx.x * kBM;
  layer_norm_tile<bf16>(x, scale, shift, As, lda, row0, M, C, eps);
  __syncthreads();

  const int warp = threadIdx.x / 32, wm = warp / 4, wn = warp % 4;
  for (int n0 = 0; n0 < N; n0 += kBN) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
    for (int k = 0; k < C; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + (size_t)(wm * 32 + i * 16) * lda + k, lda);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], w + (size_t)k * N + n0 + wn * 32 + j * 16, N);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * kLdc + wn * 32 + j * 16, acc[i][j],
                                kLdc, wmma::mem_row_major);
    __syncthreads();
    for (int idx = threadIdx.x; idx < kBM * kBN; idx += kThreads) {
      const int r = idx / kBN, c = idx % kBN, grow = row0 + r;
      if (grow < M)
        out[(size_t)grow * N + n0 + c] = __float2bfloat16(Cs[r * kLdc + c] + bias[n0 + c]);
    }
    __syncthreads();  // Cs is rewritten by the next column tile
  }
}

__global__ void __launch_bounds__(kThreads)
ln_dense_f32_kernel(const float* __restrict__ x, const float* __restrict__ scale,
                    const float* __restrict__ shift, const float* __restrict__ w,
                    const float* __restrict__ bias, float* __restrict__ out, int M, int C, int N,
                    float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lda = C + 4;
  float* As = reinterpret_cast<float*>(smem);
  float* Bs = As + (size_t)kBM * lda;  // kKc x kBN chunk of the W column tile
  const int row0 = blockIdx.x * kBM;
  layer_norm_tile<float>(x, scale, shift, As, lda, row0, M, C, eps);

  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;  // rows 4 ty.., columns tx + 16 j
  for (int n0 = 0; n0 < N; n0 += kBN) {
    float acc[4][8];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[r][j] = 0.f;
    for (int k0 = 0; k0 < C; k0 += kKc) {
      __syncthreads();  // the tile's rows are normalised / the last chunk is consumed
      for (int i = threadIdx.x; i < kKc * kBN / 4; i += kThreads) {
        const int kr = i / (kBN / 4), c4 = i % (kBN / 4);
        *reinterpret_cast<float4*>(Bs + kr * kBN + c4 * 4) =
            *reinterpret_cast<const float4*>(w + (size_t)(k0 + kr) * N + n0 + c4 * 4);
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < kKc; ++kk) {
        float a[4], b[8];
#pragma unroll
        for (int r = 0; r < 4; ++r) a[r] = As[(ty * 4 + r) * lda + k0 + kk];
#pragma unroll
        for (int j = 0; j < 8; ++j) b[j] = Bs[kk * kBN + tx + 16 * j];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[r][j] = fmaf(a[r], b[j], acc[r][j]);
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int grow = row0 + ty * 4 + r;
      if (grow < M)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          out[(size_t)grow * N + n0 + tx + 16 * j] = acc[r][j] + bias[n0 + tx + 16 * j];
    }
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, w and out share it); ln_scale,
// ln_bias and b are fp32. Returns the cudaError_t of the launch (0 =
// success); the wrapper raises otherwise.
extern "C" int veon_ln_dense(const void* x, const void* ln_scale, const void* ln_bias,
                             const void* w, const void* b, void* out, int M, int C, int N,
                             float eps, int dtype, void* stream) {
  if (M <= 0 || C % 128 || N % 128 || C > 128 * kMaxChunks) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((M + kBM - 1) / kBM);
  const float* s = static_cast<const float*>(ln_scale);
  const float* sh = static_cast<const float*>(ln_bias);
  const float* bb = static_cast<const float*>(b);
  if (dtype == 1) {
    const size_t smem = (size_t)kBM * (C + 8) * sizeof(bf16) + (size_t)kBM * kLdc * sizeof(float);
    if (smem > kMaxSmem) return cudaErrorInvalidValue;
    cudaError_t e = cudaFuncSetAttribute(ln_dense_bf16_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    ln_dense_bf16_kernel<<<grid, kThreads, smem, st>>>(
        static_cast<const bf16*>(x), s, sh, static_cast<const bf16*>(w), bb,
        static_cast<bf16*>(out), M, C, N, eps);
    return cudaGetLastError();
  }
  if (dtype == 0) {
    const size_t smem = ((size_t)kBM * (C + 4) + (size_t)kKc * kBN) * sizeof(float);
    if (smem > kMaxSmem) return cudaErrorInvalidValue;
    cudaError_t e = cudaFuncSetAttribute(ln_dense_f32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    ln_dense_f32_kernel<<<grid, kThreads, smem, st>>>(
        static_cast<const float*>(x), s, sh, static_cast<const float*>(w), bb,
        static_cast<float*>(out), M, C, N, eps);
    return cudaGetLastError();
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
