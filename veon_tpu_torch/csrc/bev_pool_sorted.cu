// Sorted-stream voxel pool, one or two streams into one grid, for Hopper (sm_90a).
//
// Replaces two TPU kernels of veon_tpu/ops/bev_pool.py:
//   * `_bev_pool_block_kernel` (:211, one stream; `bev_pool_pallas` and
//     `bev_pool_pallas_banded`, and the pooled op's backward) -> entry
//     `veon_bev_pool_sorted`;
//   * `_bev_pool_block_kernel2` (:244, two streams into one output; the
//     banded main stream plus the far-depth spray of
//     `bev_pool_pallas_banded2`) -> entry `veon_bev_pool_sorted2`.
// Contract: each stream's rows `vals_i` (P_i, C) are sorted by their voxel
// rank, and `starts_i` (num_cells + 1) is the CSR row range of every cell
// (one searchsorted in the wrapper). For every cell v:
//   out[v, c] = sum_{p in [starts1[v], starts1[v+1])} vals1[p, c]
//             + sum_{p in [starts2[v], starts2[v+1])} vals2[p, c]
// summed in fp32 in sorted row order, stream 1 before stream 2 (the TPU
// kernel's order), then cast once to the output type. A cell without rows
// is 0. Overflow rows (rank >= num_cells) lie past starts_i[num_cells] and
// are never read.
//
// Bound on the H100: bytes. One add per in-grid (row, channel); the least
// traffic is the in-grid rows of both streams plus the whole output grid,
// which dominates: the fine grid is sparse (about 0.26 main-stream rows per
// cell at the flagship), and 640,000 x 256 bf16 cells are 328 MB to write,
// ~0.1 ms at 3.35 TB/s.
//
// Design: the CSR-interval form of bev_pool_pooled.cu without the max. One
// group of C/VEC threads per cell (one warp at C = 256 bf16), each thread
// owning VEC consecutive channels read and written as 16-byte vectors, so a
// row is one coalesced 512-byte transaction. The thread walks the cell's
// rows of each stream in order with the sums in registers: no shared
// memory, no atomics, deterministic, and each output row is written once.
// Empty cells cost one 16-byte store per thread.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
__device__ __forceinline__ void accumulate(const T* __restrict__ vals, int s, int e, int C,
                                           int c0, float (&acc)[VEC]) {
  for (int p = s; p < e; ++p) {
    const Pack<T, VEC> x = *reinterpret_cast<const Pack<T, VEC>*>(vals + (size_t)p * C + c0);
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] += to_f32(x.v[i]);
  }
}

template <typename T, int VEC, int NSTREAMS>
__global__ void bev_pool_sorted_kernel(const T* __restrict__ vals1,
                                       const int* __restrict__ starts1,
                                       const T* __restrict__ vals2,
                                       const int* __restrict__ starts2, T* __restrict__ out,
                                       int num_cells, int C) {
  const int lanes = C / VEC;
  const int cell = blockIdx.x * (blockDim.x / lanes) + threadIdx.x / lanes;
  if (cell >= num_cells) return;
  const int c0 = (threadIdx.x % lanes) * VEC;
  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
  accumulate<T, VEC>(vals1, __ldg(starts1 + cell), __ldg(starts1 + cell + 1), C, c0, acc);
  if constexpr (NSTREAMS == 2)
    accumulate<T, VEC>(vals2, __ldg(starts2 + cell), __ldg(starts2 + cell + 1), C, c0, acc);
  Pack<T, VEC> y;
#pragma unroll
  for (int i = 0; i < VEC; ++i) y.v[i] = from_f32<T>(acc[i]);
  *reinterpret_cast<Pack<T, VEC>*>(out + (size_t)cell * C + c0) = y;
}

template <typename T, int VEC, int NSTREAMS>
cudaError_t launch(const void* vals1, const int* starts1, const void* vals2, const int* starts2,
                   void* out, int num_cells, int C, cudaStream_t stream) {
  const int lanes = C / VEC;
  const int cells_per_block = lanes >= 256 ? 1 : 256 / lanes;
  const int threads = lanes * cells_per_block;
  const int blocks = (num_cells + cells_per_block - 1) / cells_per_block;
  bev_pool_sorted_kernel<T, VEC, NSTREAMS><<<blocks, threads, 0, stream>>>(
      static_cast<const T*>(vals1), starts1, static_cast<const T*>(vals2), starts2,
      static_cast<T*>(out), num_cells, C);
  return cudaGetLastError();
}

template <typename T, int NSTREAMS>
cudaError_t dispatch(const void* vals1, const int* starts1, const void* vals2,
                     const int* starts2, void* out, int num_cells, int C, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);  // 16-byte loads and stores
  if (C <= 0 || C > 1024 || num_cells <= 0) return cudaErrorInvalidValue;
  if (C % kVec == 0)
    return launch<T, kVec, NSTREAMS>(vals1, starts1, vals2, starts2, out, num_cells, C, stream);
  return launch<T, 1, NSTREAMS>(vals1, starts1, vals2, starts2, out, num_cells, C, stream);
}

template <int NSTREAMS>
int run(const void* vals1, const void* starts1, const void* vals2, const void* starts2, void* out,
        int num_cells, int C, int dtype, void* stream) {
  const int* s1 = static_cast<const int*>(starts1);
  const int* s2 = static_cast<const int*>(starts2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float, NSTREAMS>(vals1, s1, vals2, s2, out, num_cells, C, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16, NSTREAMS>(vals1, s1, vals2, s2, out, num_cells, C, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (vals and out share it). Each returns the
// cudaError_t of its launch (0 = success); the wrapper raises otherwise.
extern "C" int veon_bev_pool_sorted(const void* vals, const void* starts, void* out,
                                    int num_cells, int C, int dtype, void* stream) {
  return run<1>(vals, starts, nullptr, nullptr, out, num_cells, C, dtype, stream);
}

extern "C" int veon_bev_pool_sorted2(const void* vals1, const void* starts1, const void* vals2,
                                     const void* starts2, void* out, int num_cells, int C,
                                     int dtype, void* stream) {
  return run<2>(vals1, starts1, vals2, starts2, out, num_cells, C, dtype, stream);
}
