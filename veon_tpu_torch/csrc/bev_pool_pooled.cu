// Presorted voxel pool with the fused [dz,dy,dx] max-pool, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_bev_pool_block_kernel_pooled`
// (veon_tpu/ops/bev_pool.py:223, launched by `_bev_pool_sorted_pallas` with
// pool_r = 8). Contract: the rows of `vals` (P_cap, C) are sorted by their
// COARSE-MAJOR rank `rk` (veon_tpu_torch/ops/bev_pool.py pooled_rank_remap),
// so the pool_r fine cells of one coarse cell are one contiguous run of rows.
// For every coarse cell g:
//   out[g, c] = max_{j < pool_r} sum_{p : rk[p] == g*pool_r + j} vals[p, c]
// with fp32 sums, a fine cell without rows contributing 0 to the max (the
// TPU kernel's zeroed accumulator), and one cast to the output type. Ranks
// >= num_cells (overflow and pad rows) lie past starts[n_coarse] and are
// never read.
//
// Bound on the H100: bytes. The work is one add per (row, channel); the
// least traffic is P_cap*C*sizeof(vals) + 4*P_cap (ranks) + n_coarse*C*
// sizeof(out), ~0.49 GB with bf16 vals at the flagship (P_cap ~ 0.86M,
// C = 256, 80,000 coarse cells), i.e. ~0.15 ms at 3.35 TB/s.
//
// Design: one group of C/VEC threads per coarse cell (one warp at C = 256
// bf16), each thread owning VEC consecutive channels read as one 16-byte
// load, so a row is one coalesced 512-byte transaction and every input byte
// is read once. The CSR row range of the cell comes from `starts` (one
// searchsorted in the wrapper). The thread walks its rows in rank order,
// keeps the running fine-cell sum in registers and folds it into the max
// when the rank changes: no shared memory, no atomics, deterministic. Each
// output row is written once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, int VEC>
__global__ void bev_pool_pooled_kernel(const T* __restrict__ vals, const int* __restrict__ rk,
                                       const int* __restrict__ starts, T* __restrict__ out,
                                       int n_coarse, int C, int pool_r) {
  const int lanes = C / VEC;
  const int cell = blockIdx.x * (blockDim.x / lanes) + threadIdx.x / lanes;
  if (cell >= n_coarse) return;
  const int c0 = (threadIdx.x % lanes) * VEC;
  const int s = starts[cell];
  const int e = starts[cell + 1];

  float best[VEC], cur[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    best[i] = -CUDART_INF_F;
    cur[i] = 0.f;
  }
  int prev = -1;
  int seen = 0;
  for (int p = s; p < e; ++p) {
    const int r = __ldg(rk + p);
    if (r != prev) {
      if (seen > 0) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          best[i] = fmaxf(best[i], cur[i]);
          cur[i] = 0.f;
        }
      }
      prev = r;
      ++seen;
    }
    const Pack<T, VEC> x = *reinterpret_cast<const Pack<T, VEC>*>(vals + (size_t)p * C + c0);
#pragma unroll
    for (int i = 0; i < VEC; ++i) cur[i] += to_f32(x.v[i]);
  }
  Pack<T, VEC> y;
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    float m = seen > 0 ? fmaxf(best[i], cur[i]) : 0.f;
    if (seen < pool_r) m = fmaxf(m, 0.f);  // empty fine cells hold 0
    y.v[i] = from_f32<T>(m);
  }
  *reinterpret_cast<Pack<T, VEC>*>(out + (size_t)cell * C + c0) = y;
}

template <typename T, int VEC>
cudaError_t launch(const void* vals, const int* rk, const int* starts, void* out, int n_coarse,
                   int C, int pool_r, cudaStream_t stream) {
  const int lanes = C / VEC;
  const int cells_per_block = lanes >= 256 ? 1 : 256 / lanes;
  const int threads = lanes * cells_per_block;
  const int blocks = (n_coarse + cells_per_block - 1) / cells_per_block;
  bev_pool_pooled_kernel<T, VEC><<<blocks, threads, 0, stream>>>(
      static_cast<const T*>(vals), rk, starts, static_cast<T*>(out), n_coarse, C, pool_r);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* vals, const int* rk, const int* starts, void* out, int n_coarse,
                     int C, int pool_r, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);  // 16-byte loads
  if (C % kVec == 0 && C / kVec <= 1024)
    return launch<T, kVec>(vals, rk, starts, out, n_coarse, C, pool_r, stream);
  if (C > 1024) return cudaErrorInvalidValue;
  return launch<T, 1>(vals, rk, starts, out, n_coarse, C, pool_r, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (vals and out share it). Returns the
// cudaError_t of the launch (0 = success); the wrapper raises otherwise.
extern "C" int veon_bev_pool_pooled(const void* vals, const void* rk, const void* starts,
                                    void* out, int n_coarse, int C, int pool_r, int dtype,
                                    void* stream) {
  const int* r = static_cast<const int*>(rk);
  const int* s = static_cast<const int*>(starts);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(vals, r, s, out, n_coarse, C, pool_r, st);
  if (dtype == 1) return dispatch<__nv_bfloat16>(vals, r, s, out, n_coarse, C, pool_r, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
