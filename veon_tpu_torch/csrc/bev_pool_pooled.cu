// Presorted voxel pool with the point gather and the [dz,dy,dx] max-pool
// fused in, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_bev_pool_block_kernel_pooled`
// (veon_tpu/ops/bev_pool.py:223, launched by `_bev_pool_sorted_pallas` with
// pool_r = 8) together with the gather that feeds it (`_presorted_vals`,
// bev_pool.py:539, which XLA fuses into the kernel's producer on the TPU).
// Contract: `order` (P_cap,) indexes the pixel-major point set (point
// o = pix * D + d) sorted by COARSE-MAJOR rank `rk` (veon_tpu_torch/ops/
// bev_pool.py pooled_rank_remap), so the pool_r fine cells of one coarse
// cell are one contiguous run of rows. For every coarse cell g:
//   out[g, c] = max_{j < pool_r} sum_{p : rk[p] == g*pool_r + j}
//                   round_T(feat[order[p] / D, c] * w(order[p]))
// with the two-hot weight w(o) read in place from the depth view
// (w(pix * D + d) = depth[pix * pix_stride + d * bin_stride]), each product
// rounded once to T as the plain version's `feat * w` does, fp32 sums in
// sorted row order, a fine cell without rows contributing 0 to the max (the
// TPU kernel's zeroed accumulator), and one cast to T. Ranks >= num_cells
// (overflow and pad rows) lie past starts[n_coarse] and are never read.
//
// Bound on the H100: bytes. The least traffic is the in-grid rows' order,
// rank and weight, the feature rows of the pixels those rows use, the CSR
// starts and the pooled output: ~60 MB in bf16 at the flagship (0.87M rows,
// 6 x 2,816 pixels, C = 256, 80,000 coarse cells), ~0.018 ms at 3.35 TB/s.
// Each pixel's feature row is read again for every point of it in the grid
// (~51 times): ~0.44 GB of L2 traffic, the likely ceiling.
//
// Design: no atomics on any sum, deterministic. A coarse cell is walked by
// one warp (per slice of 32 * VEC channels), each lane owning VEC
// consecutive channels read as one 16-byte load, over its CSR row range
// (`starts`, one searchsorted in the wrapper) in batches of 32 rows: each
// lane loads one (order, rank) pair, coalesced, the next batch's pairs load
// while this one is summed, and each lane loads the weight of its own row;
// the warp then broadcasts the rows' pixels with __shfl_sync and issues U
// feature-row loads before it consumes any. The running fine-cell sum and
// the max stay in registers. The few cells next to the cameras (up to ~1,000
// rows) would keep one warp walking long after the rest are done, so every
// block first takes such cells, a warp per fine cell, and then groups of
// the short cells, a warp per cell, both from shared counters.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 8;
constexpr int kLongRows = 128;  // longer coarse cells go to pool_long_cells
constexpr int kMaxSlices = 1024 / 32;  // channel slices of 32 lanes: C <= 1024
constexpr int kGroup = 4;       // consecutive short cells a warp takes at a time
// long_list: the long cells' count, per channel slice a long-cell counter and
// a short-group counter, then the long cells
constexpr int kListHead = 1 + 2 * kMaxSlices;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// feat * w rounded once to T, as torch's `feat * w` in T: the fp32 product
// of two bf16 values is exact, so rounding it to bf16 is torch's one rounding;
// __fmul_rn keeps nvcc from contracting the fp32 product into the add.
template <typename T> __device__ __forceinline__ float product(float f, float w);
template <> __device__ __forceinline__ float product<float>(float f, float w) {
  return __fmul_rn(f, w);
}
template <> __device__ __forceinline__ float product<__nv_bfloat16>(float f, float w) {
  return __bfloat162float(__float2bfloat16(__fmul_rn(f, w)));
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// (order, rank) of row s + lane, if it is below e
__device__ __forceinline__ void load_pair(const int* __restrict__ order, const int* __restrict__ rk,
                                          int s, int e, int& o, int& r) {
  const int p = s + threadIdx.x % 32;
  if (p < e) {
    o = __ldg(order + p);
    r = __ldg(rk + p);
  }
}

// Sums rows [s, e) in sorted order into the running fine-cell sum `cur`,
// folding it into `best` when the rank changes (`prev`, `seen` carry the
// walk's state). (next_o, next_r) hold the first 32 rows' pairs, one per
// lane. The warp loads the next 32 pairs, coalesced, while a batch is
// summed; each lane loads its own row's weight; then U feature rows are
// issued before any is consumed.
template <typename T, int VEC, int U>
__device__ __forceinline__ void walk_rows(const T* __restrict__ feat, const T* __restrict__ depth,
                                          long long pix_stride, long long bin_stride,
                                          const int* __restrict__ order,
                                          const int* __restrict__ rk, int s, int e, int next_o,
                                          int next_r, int C, int D, int c0, bool active,
                                          float (&best)[VEC], float (&cur)[VEC], int& prev,
                                          int& seen) {
  const int lane = threadIdx.x % 32;
  for (int p = s; p < e; p += 32) {
    const int n = min(32, e - p);
    const int my_o = next_o, my_r = next_r;
    load_pair(order, rk, p + 32, e, next_o, next_r);  // while this batch is summed
    const int my_pix = my_o / D;
    float my_w = 0.f;
    if (lane < n)
      my_w = to_f32(depth[my_pix * pix_stride + (long long)(my_o - my_pix * D) * bin_stride]);
#pragma unroll 1
    for (int i0 = 0; i0 < n; i0 += U) {
      Pack<T, VEC> x[U];
#pragma unroll
      for (int i = 0; i < U; ++i) {
        const int pix = __shfl_sync(kFull, my_pix, i0 + i);
        if (active && i0 + i < n)
          x[i] = *reinterpret_cast<const Pack<T, VEC>*>(feat + (size_t)pix * C + c0);
      }
#pragma unroll
      for (int i = 0; i < U; ++i) {
        const int r = __shfl_sync(kFull, my_r, i0 + i);
        const float w = __shfl_sync(kFull, my_w, i0 + i);
        if (i0 + i < n) {  // uniform over the warp
          if (r != prev) {
            if (seen > 0) {
#pragma unroll
              for (int v = 0; v < VEC; ++v) {
                best[v] = fmaxf(best[v], cur[v]);
                cur[v] = 0.f;
              }
            }
            prev = r;
            ++seen;
          }
#pragma unroll
          for (int v = 0; v < VEC; ++v)
            cur[v] = __fadd_rn(cur[v], product<T>(to_f32(x[i].v[v]), w));
        }
      }
    }
  }
}

// the first row of [lo, hi) whose rank is >= target (the ranks are sorted):
// the warp probes 32 evenly spaced rows per step
__device__ __forceinline__ int warp_lower_bound(const int* __restrict__ rk, int lo, int hi,
                                                int target) {
  const int lane = threadIdx.x % 32;
  while (hi > lo) {
    const int stride = (hi - lo + 31) / 32;
    const int pos = lo + lane * stride;
    const unsigned below = __ballot_sync(kFull, pos < hi && __ldg(rk + pos) < target);
    const int k = __popc(below);  // the probes below target are a prefix
    if (stride == 1) return lo + k;
    if (k > 0) lo += (k - 1) * stride + 1;
    hi = min(hi, lo + (k > 0 ? stride - 1 : 0));
  }
  return lo;
}

// fp32 <-> int with the same order, for a max by integer atomics
__device__ __forceinline__ int ordered(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}
__device__ __forceinline__ float unordered(int k) {
  return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff);
}

template <typename T, int VEC>
__device__ __forceinline__ void store_max(T* __restrict__ out, int cell, int C, int c0,
                                          const float (&m)[VEC], int seen, int pool_r) {
  Pack<T, VEC> y;
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    float x = seen > 0 ? m[v] : 0.f;
    if (seen < pool_r) x = fmaxf(x, 0.f);  // empty fine cells hold 0
    y.v[v] = from_f32<T>(x);
  }
  *reinterpret_cast<Pack<T, VEC>*>(out + (size_t)cell * C + c0) = y;
}

// The cells of more than kLongRows rows into long_list, before the pool, so
// the pool can start on them at once.
__global__ void find_long_cells(const int* __restrict__ starts, int* __restrict__ long_list,
                                int n_coarse) {
  const int cell = blockIdx.x * blockDim.x + threadIdx.x;
  if (cell < n_coarse && starts[cell + 1] - starts[cell] > kLongRows)
    long_list[kListHead + atomicAdd(long_list, 1)] = cell;
}

// The cells of more than kLongRows rows (next to the cameras, up to ~1,000
// rows; a fine cell up to ~600): each block takes the next cell from its
// slice's counter (neighbouring long cells are alike, so a fixed stride would
// hand one block a run of the largest), a warp per fine cell, each fine cell
// summed by one warp in sorted row order (the sum a short cell's walk would
// form) and the cell's max folded in shared memory (max is exact in any
// order).
template <typename T, int VEC, int U>
__device__ void pool_long_cells(const T* __restrict__ feat, const T* __restrict__ depth,
                                long long pix_stride, long long bin_stride,
                                const int* __restrict__ order, const int* __restrict__ rk,
                                const int* __restrict__ starts, T* __restrict__ out,
                                int* __restrict__ long_list, int C, int D, int pool_r) {
  __shared__ int cell_best[32 * VEC];
  __shared__ int cell_seen, next_cell;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c0 = (blockIdx.y * 32 + lane) * VEC;
  const bool active = c0 < C;
  const int count = long_list[0];
  for (;;) {
    if (threadIdx.x == 0) {
      next_cell = atomicAdd(long_list + 1 + blockIdx.y, 1);  // each slice takes every cell
      cell_seen = 0;
    }
    for (int i = threadIdx.x; i < 32 * VEC; i += blockDim.x) cell_best[i] = ordered(-CUDART_INF_F);
    __syncthreads();
    const int k = next_cell;
    if (k >= count) return;  // uniform over the block
    const int g = long_list[kListHead + k];
    const int s = __ldg(starts + g), e = __ldg(starts + g + 1);
    for (int j = warp; j < pool_r; j += kWarpsPerBlock) {
      const int fs = warp_lower_bound(rk, s, e, g * pool_r + j);
      const int fe = warp_lower_bound(rk, fs, e, g * pool_r + j + 1);
      if (fe == fs) continue;
      float best[VEC], cur[VEC];  // one rank: the walk never folds into best
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        best[v] = -CUDART_INF_F;
        cur[v] = 0.f;
      }
      int o = 0, r = 0, prev = -1, seen = 0;
      load_pair(order, rk, fs, fe, o, r);
      walk_rows<T, VEC, U>(feat, depth, pix_stride, bin_stride, order, rk, fs, fe, o, r, C, D,
                           c0, active, best, cur, prev, seen);
#pragma unroll
      for (int v = 0; v < VEC; ++v) atomicMax(&cell_best[lane * VEC + v], ordered(cur[v]));
      if (lane == 0) atomicAdd(&cell_seen, 1);
    }
    __syncthreads();
    if (warp == 0 && active) {
      float m[VEC];
#pragma unroll
      for (int v = 0; v < VEC; ++v) m[v] = unordered(cell_best[lane * VEC + v]);
      store_max<T, VEC>(out, g, C, c0, m, cell_seen, pool_r);
    }
    __syncthreads();  // cell_best is reset for the next cell
  }
}

// The cells of at most kLongRows rows, after the long ones: each warp takes
// the next kGroup consecutive cells from its slice's counter (one load
// brings the group's CSR starts), and loads a cell's first 32 (order, rank)
// pairs while the cell before it is summed.
template <typename T, int VEC, int U>
__device__ void pool_short_cells(const T* __restrict__ feat, const T* __restrict__ depth,
                                 long long pix_stride, long long bin_stride,
                                 const int* __restrict__ order, const int* __restrict__ rk,
                                 const int* __restrict__ starts, T* __restrict__ out,
                                 int* __restrict__ long_list, int n_coarse, int C, int D,
                                 int pool_r) {
  const int lane = threadIdx.x % 32;
  const int c0 = (blockIdx.y * 32 + lane) * VEC;
  const bool active = c0 < C;
  for (;;) {
    int first = 0;
    if (lane == 0) first = atomicAdd(long_list + 1 + kMaxSlices + blockIdx.y, 1) * kGroup;
    first = __shfl_sync(kFull, first, 0);
    if (first >= n_coarse) return;  // uniform over the warp
    const int n = min(kGroup, n_coarse - first);
    const int bound = lane <= n ? __ldg(starts + first + lane) : 0;
    int s = __shfl_sync(kFull, bound, 0), e = __shfl_sync(kFull, bound, 1);
    int o = 0, r = 0;
    load_pair(order, rk, s, e, o, r);
    for (int i = 0; i < n; ++i) {
      const int sn = __shfl_sync(kFull, bound, min(i + 1, n));
      const int en = __shfl_sync(kFull, bound, min(i + 2, n));
      int on = 0, rn = 0;
      if (i + 1 < n) load_pair(order, rk, sn, en, on, rn);  // while this cell is summed
      if (e - s <= kLongRows) {
        float best[VEC], cur[VEC];
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          best[v] = -CUDART_INF_F;
          cur[v] = 0.f;
        }
        int prev = -1, seen = 0;
        walk_rows<T, VEC, U>(feat, depth, pix_stride, bin_stride, order, rk, s, e, o, r, C, D,
                             c0, active, best, cur, prev, seen);
#pragma unroll
        for (int v = 0; v < VEC; ++v) best[v] = fmaxf(best[v], cur[v]);
        if (active) store_max<T, VEC>(out, first + i, C, c0, best, seen, pool_r);
      }
      s = sn;
      e = en;
      o = on;
      r = rn;
    }
  }
}

// Every block first takes long cells, then groups of short cells, both from
// shared counters: the long walks start at once and the short cells fill
// in around them.
template <typename T, int VEC, int U>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
bev_pool_pooled_kernel(const T* __restrict__ feat, const T* __restrict__ depth,
                       long long pix_stride, long long bin_stride, const int* __restrict__ order,
                       const int* __restrict__ rk, const int* __restrict__ starts,
                       T* __restrict__ out, int* __restrict__ long_list, int n_coarse, int C,
                       int D, int pool_r) {
  static_assert(32 % U == 0, "U divides the 32-row batch");
  pool_long_cells<T, VEC, U>(feat, depth, pix_stride, bin_stride, order, rk, starts, out,
                             long_list, C, D, pool_r);
  pool_short_cells<T, VEC, U>(feat, depth, pix_stride, bin_stride, order, rk, starts, out,
                              long_list, n_coarse, C, D, pool_r);
}

// blocks of `kernel` the card holds at once
template <typename K>
int resident_blocks(K kernel) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kWarpsPerBlock * 32, 0) !=
          cudaSuccess)
    return 0;
  return sms * per_sm;
}

template <typename T, int VEC>
cudaError_t launch(const void* feat, const void* depth, long long pix_stride,
                   long long bin_stride, const int* order, const int* rk, const int* starts,
                   void* out, int* long_list, int n_coarse, int C, int D, int pool_r,
                   cudaStream_t stream) {
  constexpr int kRowsInFlight = 4;  // feature rows a warp issues before it sums them
  static int resident = 0;          // per card, found at first use
  if (resident == 0 &&
      (resident = resident_blocks(bev_pool_pooled_kernel<T, VEC, kRowsInFlight>)) == 0)
    return cudaErrorInvalidConfiguration;
  const int need = (n_coarse + kWarpsPerBlock * kGroup - 1) / (kWarpsPerBlock * kGroup);
  cudaError_t e = cudaMemsetAsync(long_list, 0, kListHead * sizeof(int), stream);
  if (e != cudaSuccess) return e;
  find_long_cells<<<(n_coarse + 255) / 256, 256, 0, stream>>>(starts, long_list, n_coarse);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  bev_pool_pooled_kernel<T, VEC, kRowsInFlight>
      <<<dim3(need < resident ? need : resident, (C / VEC + 31) / 32), kWarpsPerBlock * 32, 0,
         stream>>>(static_cast<const T*>(feat), static_cast<const T*>(depth), pix_stride,
                   bin_stride, order, rk, starts, static_cast<T*>(out), long_list, n_coarse, C,
                   D, pool_r);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* feat, const void* depth, long long pix_stride,
                     long long bin_stride, const int* order, const int* rk, const int* starts,
                     void* out, int* long_list, int n_coarse, int C, int D, int pool_r,
                     cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);  // 16-byte loads
  // the wrapper passes 16-byte aligned feat and out; rows stay aligned when C % kVec == 0
  if (C % kVec == 0)
    return launch<T, kVec>(feat, depth, pix_stride, bin_stride, order, rk, starts, out,
                           long_list, n_coarse, C, D, pool_r, stream);
  return launch<T, 1>(feat, depth, pix_stride, bin_stride, order, rk, starts, out, long_list,
                      n_coarse, C, D, pool_r, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (feat, depth and out share it); strides
// in elements; long_list: n_coarse + 65 int32 of scratch. Returns the
// cudaError_t of the launches (0 = success); the wrapper raises otherwise.
extern "C" int veon_bev_pool_pooled(const void* feat, const void* depth, long long pix_stride,
                                    long long bin_stride, const void* order, const void* rk,
                                    const void* starts, void* out, void* long_list, int n_coarse,
                                    int C, int D, int pool_r, int dtype, void* stream) {
  if (n_coarse <= 0 || C <= 0 || D <= 0 || C > 1024) return cudaErrorInvalidValue;
  const int* o = static_cast<const int*>(order);
  const int* r = static_cast<const int*>(rk);
  const int* s = static_cast<const int*>(starts);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* l = static_cast<int*>(long_list);
  if (dtype == 0)
    return dispatch<float>(feat, depth, pix_stride, bin_stride, o, r, s, out, l, n_coarse, C, D,
                           pool_r, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(feat, depth, pix_stride, bin_stride, o, r, s, out, l,
                                   n_coarse, C, D, pool_r, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
