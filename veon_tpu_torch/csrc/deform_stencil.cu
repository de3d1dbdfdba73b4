// Deformable attention on a 3x3x3 stencil, the temporal fusion's
// `TemporalDeformable` (use_stencil=True), for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package (veon_tpu/nn/alignnet.py
// `TemporalDeformable`) leaves the stencil to XLA, which fuses it. In
// PyTorch the same ops run as some 500 small kernels a call that write and
// re-read per-tap products and an fp32 accumulator (ops/deform_stencil.py
// `deform_stencil_plain`, this kernel's oracle); this kernel keeps all of
// it in registers.
//
// Contract (entry `veon_deform_stencil`): off (B, D, H, W, heads, 8, 3),
// the tanh offsets (z, y, x) of every head's 8 samples; query
// (B, D, H, W, heads * HD); kv (B, D, H, W, heads * 2HD), each head's key
// and value halves side by side; all contiguous, of one dtype (fp32 or
// bf16), HD 64 or 4 -> out (B, D, H, W, heads * HD) in that dtype. For each
// voxel, head and sample: the sample's position base + off / size clipped
// to [-1, 1], its offset delta in cells, the hats max(0, 1 - |delta - t|)
// per axis and tap t in (-1, 0, 1), and the weight w_t = h_z * h_y * h_x of
// each of the 27 taps (edge-replicated neighbours, in (tz, ty, tx) order);
// d_t = <q * HD^-0.5, key of tap t>; logits = sum_t w_t d_t; attn =
// softmax over the samples; out = sum_t (sum_s attn_s w_t,s) value_t.
//
// Arithmetic, rule by rule as the plain version on the card computes it,
// so that the two agree bit for bit where PyTorch's reductions take the
// orders below: the grid and hat arithmetic in fp32 with no contraction
// into FMAs (__fadd_rn / __fmul_rn); off / size in the offsets' dtype;
// q * scale and each q.k product rounded to the compute dtype and summed in
// fp32 in the order of PyTorch's inner-dimension reduce (x + x+32, then
// x + 16, 8, 4, 2, 1), d_t rounded to the compute dtype; logits in fp32 in tap
// order; the softmax in fp32 as PyTorch's warp softmax (butterfly max and
// sum over the 8 samples, expf, one division), rounded to the compute
// dtype; g_t = sum_s attn_s * w_t,s in fp32 (s + 4, 2, 1); the values
// summed into fp32 registers in tap order; one rounding at the end.
// `dt_out` (fp32, (B, D, H, W, heads, 27), may be null) receives every d_t.
//
// Bound on the H100: bytes. 27 x 4 x C multiply-adds a voxel are 2.2
// GFLOP a call at VEON-B (80,000 voxels, C = 256), against one read of off,
// q and kv and one write of out: 180 MB in bf16, 0.054 ms at 3.35 TB/s.
//
// Design: one group of 8 lanes per (voxel, head), four groups a warp (one
// voxel of VEON-B's four heads); lane l owns sample l's grid, hats, logit
// and softmax weight. For the q.k sums it owns the head's channels l + 8k,
// the slots that PyTorch's reduce adds first (8 two-byte loads a tap, each
// a 16-byte run across the group); for the values and the output the
// channels 8l..8l+7 (one 16-byte load, two in fp32); at HD = 4 channel l.
// Every cross-lane sum is 3 shuffles within the group. The 8 warps of a
// block are 8 neighbouring voxels along x, whose taps share rows in L1;
// the rest of the 27-fold reuse comes from L2 (kv is 82 MB at VEON-B). Two
// passes over the taps, each an outer loop over z kept rolled: keys for
// the logits, then values; the output is written once. Registers are
// capped for 3 blocks an SM. No shared memory, no atomics; nothing else is
// allocated or written. Measured at VEON-B's shape on one card, bf16 with
// L2 flushed: 0.47 ms as built; all 27 taps unrolled with registers
// uncapped (182 a thread, one block an SM) 0.65-0.69; 16 or 32 lanes a
// pair (fewer, wider q.k loads, more shuffles) 0.56-0.58 and 0.92.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int kSamples = 8;
constexpr int kLanes = 8;  // lanes per (voxel, head): one per sample
constexpr int kGroups = 32 / kLanes;  // (voxel, head) pairs per warp
constexpr int kWarps = 8;  // warps per block
constexpr unsigned kFull = 0xffffffffu;

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// x rounded to T and back: the plain version's casts to the compute dtype
template <typename T> __device__ __forceinline__ float round_to(float x);
template <> __device__ __forceinline__ float round_to<float>(float x) { return x; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T, int N>
struct alignas(sizeof(T) * N) Pack {
  T v[N];
};

// What lane l of a group owns of a head's HD channels.
//  * The q.k sums: PyTorch's inner reduce over HD = 64 channels gives
//    thread x < 32 the channels x and x + 32 and then adds x + 16, x + 8,
//    x + 4, x + 2, x + 1 across the warp. Lane l holds the NX = 32 / kLanes
//    slots x = l + kLanes * k, so it takes the first levels itself and the
//    group the last log2(kLanes); at HD = 4 (a reduce over 4 threads: x + 2,
//    x + 1) lane l < 4 holds channel l and the others 0.
//  * The value sums and the output: NV = HD / kLanes consecutive channels,
//    one vector access (channel l alone at HD = 4).
template <int HD>
struct Own {
  static constexpr int NX = HD == 64 ? 32 / kLanes : 1;
  static constexpr int NQ = HD == 64 ? 2 * NX : 1;
  static constexpr int NV = HD == 64 ? HD / kLanes : 1;
};

template <typename T, int HD>
__device__ __forceinline__ void load_strided(const T* __restrict__ row, int l,
                                             float (&v)[Own<HD>::NQ]) {
  if constexpr (HD == 64) {
#pragma unroll
    for (int k = 0; k < Own<HD>::NQ; ++k) v[k] = to_f32(row[l + kLanes * k]);
  } else {
    v[0] = l < HD ? to_f32(row[l]) : 0.f;
  }
}

template <typename T, int HD>
__device__ __forceinline__ void load_block(const T* __restrict__ row, int l,
                                           float (&v)[Own<HD>::NV]) {
  if constexpr (HD == 64) {
    constexpr int NV = Own<HD>::NV;
    const Pack<T, NV> x = *reinterpret_cast<const Pack<T, NV>*>(row + NV * l);
#pragma unroll
    for (int i = 0; i < NV; ++i) v[i] = to_f32(x.v[i]);
  } else {
    v[0] = l < HD ? to_f32(row[l]) : 0.f;
  }
}

template <typename T, int HD>
__device__ __forceinline__ void store_block(T* __restrict__ row, int l,
                                            const float (&v)[Own<HD>::NV]) {
  if constexpr (HD == 64) {
    constexpr int NV = Own<HD>::NV;
    Pack<T, NV> x;
#pragma unroll
    for (int i = 0; i < NV; ++i) x.v[i] = from_f32<T>(v[i]);
    *reinterpret_cast<Pack<T, NV>*>(row + NV * l) = x;
  } else {
    if (l < HD) row[l] = from_f32<T>(v[0]);
  }
}

// jnp.linspace(-1, 1, n)[i] as ops/deform_stencil.py `_linspace_pm1`:
// step = i * fp32(1 / (n - 1)), -(1 - step) + step, the last entry 1.
__device__ __forceinline__ float linspace_pm1(int i, int n) {
  if (n == 1) return -1.f;
  if (i == n - 1) return 1.f;
  const float step = __fmul_rn(static_cast<float>(i), __frcp_rn(static_cast<float>(n - 1)));
  return __fadd_rn(-__fsub_rn(1.f, step), step);
}

// The sum over a group's lanes l ^ o, o = W/2 .. 1, every lane getting it:
// PyTorch's warp reduce over W threads (shuffle offsets W/2 down to 1).
// W = kLanes for the q.k sums, W = kSamples for the sums over samples.
template <int W>
__device__ __forceinline__ float lane_sum(float x) {
#pragma unroll
  for (int o = W / 2; o > 0; o >>= 1) x = __fadd_rn(x, __shfl_xor_sync(kFull, x, o, kLanes));
  return x;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kWarps * 32, 3)
deform_stencil_kernel(const T* __restrict__ off, const T* __restrict__ query,
                      const T* __restrict__ kv, T* __restrict__ out,
                      float* __restrict__ dt_out, int B, int D, int H, int W, int nh,
                      float scale) {
  constexpr int NX = Own<HD>::NX, NQ = Own<HD>::NQ, NV = Own<HD>::NV;
  const int lane = threadIdx.x & 31, l = lane % kLanes, j = l % kSamples;
  const long long n_pairs = static_cast<long long>(B) * D * H * W * nh;
  const long long pair = (static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5)) *
                             kGroups + lane / kLanes;
  // every lane takes part in the shuffles; a group past the end computes
  // the last pair again and stores nothing
  const bool valid = pair < n_pairs;
  const long long p = valid ? pair : n_pairs - 1;
  const int m = static_cast<int>(p % nh);
  const long long vox = p / nh;
  const int x = static_cast<int>(vox % W), y = static_cast<int>((vox / W) % H);
  const long long bz = vox / (static_cast<long long>(W) * H);  // b * D + z
  const int z = static_cast<int>(bz % D);
  const long long plane0 = (bz - z) * H;  // (b * D) * H: the batch's first row of planes
  const int C = nh * HD;

  // sample j's 9 hat factors, hat[axis][t + 1]
  float hat[3][3];
  {
    const T* o = off + (p * kSamples + j) * 3;
    const int pos[3] = {z, y, x}, size[3] = {D, H, W};
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float norm = round_to<T>(static_cast<float>(size[a]));  // in the offsets' dtype
      const float r = round_to<T>(__fdiv_rn(to_f32(o[a]), norm));
      const float base = linspace_pm1(pos[a], size[a]);
      const float g = fminf(fmaxf(__fadd_rn(base, r), -1.f), 1.f);
      const float delta = __fmul_rn(__fsub_rn(g, base), static_cast<float>(size[a] - 1) * 0.5f);
#pragma unroll
      for (int t = 0; t < 3; ++t)
        hat[a][t] = fmaxf(__fsub_rn(1.f, fabsf(__fsub_rn(delta, static_cast<float>(t - 1)))), 0.f);
    }
  }
  // edge-replicated neighbour coordinates
  int zn[3], yn[3], xn[3];
#pragma unroll
  for (int t = 0; t < 3; ++t) {
    zn[t] = min(max(z + t - 1, 0), D - 1);
    yn[t] = min(max(y + t - 1, 0), H - 1);
    xn[t] = min(max(x + t - 1, 0), W - 1);
  }
  float qs[NQ];
  load_strided<T, HD>(query + vox * C + m * HD, l, qs);
#pragma unroll
  for (int i = 0; i < NQ; ++i) qs[i] = round_to<T>(__fmul_rn(qs[i], scale));

  // pass 1: the logit of sample j over the 27 taps
  const T* kv_head = kv + m * 2 * HD;
  float logit = 0.f;
#pragma unroll 1
  for (int tz = 0; tz < 3; ++tz)
#pragma unroll
    for (int ty = 0; ty < 3; ++ty)
#pragma unroll
      for (int tx = 0; tx < 3; ++tx) {
        const long long row = (plane0 + static_cast<long long>(zn[tz]) * H + yn[ty]) * W + xn[tx];
        float k[NQ];
        load_strided<T, HD>(kv_head + row * 2 * C, l, k);
        float v[NX];
        if constexpr (HD == 64) {
#pragma unroll
          for (int i = 0; i < NX; ++i)  // x and x + 32
            v[i] = __fadd_rn(round_to<T>(__fmul_rn(qs[i], k[i])),
                             round_to<T>(__fmul_rn(qs[NX + i], k[NX + i])));
#pragma unroll
          for (int h = NX / 2; h > 0; h >>= 1)  // x + 16 .. x + kLanes, in the lane
#pragma unroll
            for (int i = 0; i < h; ++i) v[i] = __fadd_rn(v[i], v[i + h]);
        } else {
          v[0] = round_to<T>(__fmul_rn(qs[0], k[0]));
        }
        const float d = round_to<T>(lane_sum<kLanes>(v[0]));
        if (dt_out != nullptr && valid && l == 0) dt_out[p * 27 + (tz * 3 + ty) * 3 + tx] = d;
        const float w = __fmul_rn(__fmul_rn(hat[0][tz], hat[1][ty]), hat[2][tx]);
        logit = __fadd_rn(logit, __fmul_rn(w, d));
      }

  // the softmax over the samples (PyTorch's warp softmax: butterfly 4, 2, 1)
  float mx = logit;
#pragma unroll
  for (int o = kSamples / 2; o > 0; o >>= 1) {
    const float other = __shfl_xor_sync(kFull, mx, o, kLanes);
    mx = mx < other ? other : mx;
  }
  const float e = expf(__fsub_rn(logit, mx));
  const float attn = round_to<T>(__fdiv_rn(e, lane_sum<kSamples>(e)));

  // pass 2: the values, weighted by g_t = sum_s attn_s w_t,s
  float acc[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) acc[i] = 0.f;
#pragma unroll 1
  for (int tz = 0; tz < 3; ++tz)
#pragma unroll
    for (int ty = 0; ty < 3; ++ty)
#pragma unroll
      for (int tx = 0; tx < 3; ++tx) {
        const long long row = (plane0 + static_cast<long long>(zn[tz]) * H + yn[ty]) * W + xn[tx];
        float v[NV];
        load_block<T, HD>(kv_head + row * 2 * C + HD, l, v);
        const float w = __fmul_rn(__fmul_rn(hat[0][tz], hat[1][ty]), hat[2][tx]);
        const float g = lane_sum<kSamples>(__fmul_rn(attn, w));
#pragma unroll
        for (int i = 0; i < NV; ++i) acc[i] = __fadd_rn(acc[i], __fmul_rn(g, v[i]));
      }
  if (valid) store_block<T, HD>(out + vox * C + m * HD, l, acc);
}

template <typename T, int HD>
int launch(const void* off, const void* query, const void* kv, void* out, void* dt_out, int B,
           int D, int H, int W, int nh, float scale, long long blocks, cudaStream_t stream) {
  deform_stencil_kernel<T, HD><<<static_cast<unsigned>(blocks), kWarps * 32, 0, stream>>>(
      static_cast<const T*>(off), static_cast<const T*>(query), static_cast<const T*>(kv),
      static_cast<T*>(out), static_cast<float*>(dt_out), B, D, H, W, nh, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 fp32, 1 bf16. Returns a cudaError_t (0 on success); shapes the
// kernel does not take return cudaErrorInvalidValue without a launch.
extern "C" int veon_deform_stencil(const void* off, const void* query, const void* kv, void* out,
                                   void* dt_out, int B, int D, int H, int W, int num_heads,
                                   int head_dim, int num_samples, int dtype, void* stream) {
  if (num_samples != kSamples || (head_dim != 64 && head_dim != 4) || (dtype != 0 && dtype != 1) ||
      B < 0 || D < 0 || H < 0 || W < 0 || num_heads < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long pairs = static_cast<long long>(B) * D * H * W * num_heads;
  if (pairs == 0) return 0;
  const long long blocks = (pairs + kWarps * kGroups - 1) / (kWarps * kGroups);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(head_dim)));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto fn = dtype == 0 ? (head_dim == 64 ? launch<float, 64> : launch<float, 4>)
                       : (head_dim == 64 ? launch<__nv_bfloat16, 64> : launch<__nv_bfloat16, 4>);
  return fn(off, query, kv, out, dt_out, B, D, H, W, num_heads, scale, blocks, s);
}
