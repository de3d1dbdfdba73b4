// Fused LayerNorm -> Dense, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_ln_dense_kernel` (veon_tpu/ops/fused_ln.py:36,
// launched by `ln_dense_pallas`). Contract, per row of x (M, C):
//   y   = (x - mean) * rsqrt(var + eps) * ln_scale + ln_bias   (fp32; var
//         the centred mean square, as the TPU kernel computes it)
//   out = cast_T( sum_k cast_T(y)[k] * w[k, n]  (fp32 accumulator)  + b[n] )
// with T the type of x and w (float32 or bfloat16, one type for both) and
// ln_scale, ln_bias, b given in fp32. C and N are multiples of 128 (as the
// TPU entry asserts), C <= 1024; any M (the last row tile is masked).
//
// Bound on the H100: bytes in bf16 (x read once, W and the vectors once, out
// written once: 208.5 MB, ~0.062 ms at 3.35 TB/s, at the HSA qkv shape
// 67,584 x 384 @ 384 x 1,152; the tensor cores need ~0.061 ms for its 59.8
// GFLOP at 989 TFLOP/s), operations in fp32 (~0.89 ms there at 67 TFLOP/s
// outside the tensor cores: fp32 stays fp32, no TF32).
//
// bf16 design: a persistent grid, one CTA per SM, each taking an equal run
// of (128-row tile, 128-column tile) units of the output, with two consumer
// warpgroups of 64 rows (one, and 64-row tiles, where C > 512 leaves too
// little shared memory) and one producer warp.
//   * The producer brings the x tile into shared memory by TMA, in the
//     K-major 128-byte-swizzled layout a `wgmma` descriptor names (C/64
//     blocks of rows x 128 bytes), and the 64 x 128 tiles of W (C x N, row-
//     major: an MN-major B operand) through a ring of 3-8 stages (what
//     shared memory leaves) with mbarrier full/empty handshakes. W (at most
//     2 MB) stays in L2.
//   * Each consumer warpgroup normalises its 64 rows in place, two lanes
//     per row (fp32 row statistics, one rounding to bf16, written back at
//     the same swizzled addresses), so the normalised tile never reaches
//     device memory and is reused for all the CTA's column tiles of that
//     row tile. It then runs `wgmma.mma_async` m64n128k16 (bf16 x bf16 ->
//     fp32 registers; B transposed) over the ring, releasing each stage as
//     its products complete.
//   * Epilogue: the fp32 bias and one rounding to bf16 into a swizzled
//     staging tile, written out by an asynchronous TMA store (which also
//     drops the rows past M), so the next column tile's products start at
//     once.
//   * The producer loads the next x tile as soon as the consumers' last
//     products of the current one complete, under their last epilogue.
// fp32 design: a register-blocked SIMT product. One CTA of 2 * BM threads
// per BM-row tile normalises the tile into shared memory, k-major (float4
// reads of 4 rows), and walks the N/128 column tiles with the W k-slices in
// a 3-stage cp.async ring; each thread owns 8 x 8 outputs.

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxSmem = 232448;  // the H100's per-block dynamic shared memory
constexpr int kMaxC = 1024;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the affine of one normalised value in the reference's order, no contraction
__device__ __forceinline__ float affine(float v, float mean, float rstd, float s, float sh) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v, mean), rstd), s), sh);
}

// ---------------------------------------------------------------- bf16 path

constexpr int kBN = 128;                 // output columns per tile
constexpr int kBK = 64;                  // K per ring stage: one 128-byte swizzle row
constexpr int kMaxStages = 8;            // the ring takes what shared memory leaves, up to this
constexpr int kStageBytes = kBK * kBN * 2;
constexpr int kOutBox = 64 * 64 * 2;     // one 64 x 64 TMA store box

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}
// returns once the barrier's phase of parity `parity` has completed; a
// wait of 2^24 polls (far beyond any load) is a broken pipeline and traps
// rather than hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (polls == (1u << 24)) __trap();
  }
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, uint32_t src, int c0, int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(src), "r"(c0), "r"(c1)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void bulk_wait_read() {  // at most N store groups still read smem
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(N) : "memory");
}
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

__device__ __forceinline__ void named_bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// wgmma shared-memory descriptors, 128-byte swizzle (layout type 1):
// A, K-major: rows of 128 bytes, 8-row groups 1024 bytes apart (SBO);
// B, MN-major: 64-column chunks kBK * 128 bytes apart (LBO), 8-row K groups
// 1024 bytes apart (SBO).
__device__ __forceinline__ uint64_t desc_a(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)64 << 32) |
         ((uint64_t)1 << 62);
}
__device__ __forceinline__ uint64_t desc_b(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(kBK * 128 / 16) << 16) |
         ((uint64_t)64 << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// keeps the compiler from touching the accumulators across a wgmma wait
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128, fp32) = A (64 x 16, K-major) * B (16 x 128, MN-major) + (scale_d ? d : 0)
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// byte offset of the 16-byte chunk `ch` (8 channels) of row r in an A tile of
// `rows` rows: C/64 blocks of rows x 128 bytes, the chunk index XORed with
// r % 8 (the 128-byte swizzle TMA writes and wgmma reads)
__device__ __forceinline__ uint32_t a_offset(int r, int ch, int rows) {
  return (uint32_t)((ch >> 3) * rows * 128 + r * 128 + (((ch & 7) ^ (r & 7)) << 4));
}

__device__ __forceinline__ void unpack8(uint4 u, float v[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// Normalise the warpgroup's 64 rows of the A tile in place: two lanes per
// row (lane pair i of the warpgroup owns row row0 + i; each lane every
// other 16-byte chunk), so every lane holds a row's sums and one shuffle
// completes them; fp32 statistics, then one rounding to bf16 written back
// at the same swizzled addresses. ln_scale / ln_bias come from shared
// memory. Rows past M hold TMA's zero fill and normalise to ln_bias; they
// are never stored.
template <int BM>
__device__ __forceinline__ void layer_norm_rows(unsigned char* a_tile, int row0,
                                                const float* s_scale, const float* s_shift,
                                                int C, float eps) {
  const int t = threadIdx.x % 128, r = row0 + t / 2, half = t % 2;
  const int nch = C / 8;
  float sum = 0.f;
#pragma unroll 4
  for (int ch = half; ch < nch; ch += 2) {
    float v[8];
    unpack8(*reinterpret_cast<const uint4*>(a_tile + a_offset(r, ch, BM)), v);
#pragma unroll
    for (int i = 0; i < 8; ++i) sum += v[i];
  }
  const float mean = (sum + __shfl_xor_sync(0xffffffffu, sum, 1)) / C;
  float sq = 0.f;
#pragma unroll 4
  for (int ch = half; ch < nch; ch += 2) {
    float v[8];
    unpack8(*reinterpret_cast<const uint4*>(a_tile + a_offset(r, ch, BM)), v);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float dv = v[i] - mean;
      sq += dv * dv;
    }
  }
  const float rstd = rsqrtf((sq + __shfl_xor_sync(0xffffffffu, sq, 1)) / C + eps);
#pragma unroll 4
  for (int ch = half; ch < nch; ch += 2) {
    uint4* at = reinterpret_cast<uint4*>(a_tile + a_offset(r, ch, BM));
    float v[8];
    unpack8(*at, v);
    const float4 s0 = *reinterpret_cast<const float4*>(s_scale + ch * 8);
    const float4 s1 = *reinterpret_cast<const float4*>(s_scale + ch * 8 + 4);
    const float4 h0 = *reinterpret_cast<const float4*>(s_shift + ch * 8);
    const float4 h1 = *reinterpret_cast<const float4*>(s_shift + ch * 8 + 4);
    const float sc[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
    const float sh[8] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
    uint4 y;
    __nv_bfloat162* yh = reinterpret_cast<__nv_bfloat162*>(&y);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      yh[i] = __floats2bfloat162_rn(affine(v[2 * i], mean, rstd, sc[2 * i], sh[2 * i]),
                                    affine(v[2 * i + 1], mean, rstd, sc[2 * i + 1], sh[2 * i + 1]));
    *at = y;
  }
}

// CTA c takes the units [c * units / G, (c + 1) * units / G) of the row-major
// (row tile, column tile) units: an equal share of the products whatever the
// number of row tiles, normalising each row tile it enters once.
template <int NWG>
__global__ void __launch_bounds__(NWG * 128 + 32, 1)
ln_dense_wgmma_kernel(const __grid_constant__ CUtensorMap tmap_x,
                      const __grid_constant__ CUtensorMap tmap_w,
                      const __grid_constant__ CUtensorMap tmap_out, const float* __restrict__ scale,
                      const float* __restrict__ shift, const float* __restrict__ bias, int M,
                      int C, int N, int stages, float eps) {
  constexpr int BM = NWG * 64;
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the tiles to it
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* a_tile = smem;
  unsigned char* ring = a_tile + (size_t)BM * C * 2;
  unsigned char* staging = ring + stages * kStageBytes;  // NWG x 2 boxes
  float* s_scale = reinterpret_cast<float*>(staging + NWG * 2 * kOutBox);
  float* s_shift = s_scale + C;
  uint64_t* bars = reinterpret_cast<uint64_t*>(s_shift + C);
  const uint32_t full0 = smem_u32(bars), empty0 = smem_u32(bars + stages);
  const uint32_t a_full = smem_u32(bars + 2 * stages), a_empty = smem_u32(bars + 2 * stages + 1);
  const uint32_t a_u32 = smem_u32(a_tile), ring_u32 = smem_u32(ring);

  const int n_tiles = N / kBN, kblocks = C / kBK;
  const long long units = (long long)((M + BM - 1) / BM) * n_tiles;
  const int u0 = (int)(units * blockIdx.x / gridDim.x);
  const int u1 = (int)(units * (blockIdx.x + 1) / gridDim.x);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, NWG * 4);
    }
    mbar_init(a_full, 1);
    mbar_init(a_empty, NWG * 4);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int i = threadIdx.x; i < C; i += blockDim.x) {
    s_scale[i] = scale[i];
    s_shift[i] = shift[i];
  }
  __syncthreads();

  if (warp == NWG * 4) {  // the producer warp: one thread issues every TMA load
    if (lane != 0) return;
    int stage = 0;
    uint32_t phase = 0;
    int it = 0;
    for (int u = u0; u < u1; ++u) {
      const int tile = u / n_tiles, nt = u % n_tiles, n0 = nt * kBN;
      if (u == u0 || nt == 0) {  // a new row tile
        if (it > 0) mbar_wait(a_empty, (it - 1) & 1);  // the last tile's products are done
        ++it;
        mbar_expect_tx(a_full, (uint32_t)BM * C * 2);
        for (int kb = 0; kb < kblocks; ++kb)
          tma_load_2d(a_u32 + kb * BM * 128, &tmap_x, kb * kBK, tile * BM, a_full);
      }
      for (int kb = 0; kb < kblocks; ++kb) {
        mbar_wait(empty0 + 8 * stage, phase ^ 1);
        const uint32_t full = full0 + 8 * stage, dst = ring_u32 + stage * kStageBytes;
        mbar_expect_tx(full, kStageBytes);
        tma_load_2d(dst, &tmap_w, n0, kb * kBK, full);
        tma_load_2d(dst + kStageBytes / 2, &tmap_w, n0 + 64, kb * kBK, full);
        if (++stage == stages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows wg * 64 .. + 64 of each tile
  const int wg = warp / 4, wtid = threadIdx.x % 128;
  const uint32_t stg = smem_u32(staging) + wg * 2 * kOutBox;
  int stage = 0;
  uint32_t phase = 0;
  int it = 0;
  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  for (int u = u0; u < u1; ++u) {
    const int m0 = (u / n_tiles) * BM, nt = u % n_tiles, n0 = nt * kBN;
    if (u == u0 || nt == 0) {  // a new row tile: normalise it in place
      mbar_wait(a_full, it++ & 1);
      layer_norm_rows<BM>(a_tile, wg * 64, s_scale, s_shift, C, eps);
      // the generic-proxy writes must be visible to wgmma (async proxy)
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      named_bar_sync(1 + wg, 128);
    }
    const uint32_t a_rows = a_u32 + wg * 64 * 128;
    int prev = -1;
    for (int kb = 0; kb < kblocks; ++kb) {
      mbar_wait(full0 + 8 * stage, phase);
      wgmma_fence();
      const uint32_t a_k = a_rows + kb * BM * 128, b_k = ring_u32 + stage * kStageBytes;
#pragma unroll
      for (int k = 0; k < kBK / 16; ++k)  // 16 K: 32 bytes along A's row, 16 rows of B
        wgmma_m64n128k16(d, desc_a(a_k + k * 32), desc_b(b_k + k * 16 * 128), kb | k);
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done
      if (prev >= 0 && lane == 0) mbar_arrive(empty0 + 8 * prev);
      prev = stage;
      if (++stage == stages) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_acc(d);
    if (lane == 0) {
      mbar_arrive(empty0 + 8 * prev);
      if (nt + 1 == n_tiles || u + 1 == u1) mbar_arrive(a_empty);  // A is free for the next tile
    }

    // epilogue: fp32 bias, one rounding, into the warpgroup's two 64 x 64
    // boxes (128-byte swizzled rows), then one TMA store per box, which
    // drops the rows past M
    if (wtid == 0) bulk_wait_read<0>();  // the last unit's store has read the boxes
    named_bar_sync(1 + wg, 128);
    const int wr = (warp % 4) * 16 + lane / 4;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int col = 8 * j + 2 * (lane % 4);
      const float2 b = __ldg(reinterpret_cast<const float2*>(bias + n0 + col));
      const uint32_t at = stg + (j >> 3) * kOutBox + (((j & 7) ^ (wr & 7)) << 4) + (lane % 4) * 4;
      const __nv_bfloat162 lo = __floats2bfloat162_rn(d[4 * j] + b.x, d[4 * j + 1] + b.y);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(d[4 * j + 2] + b.x, d[4 * j + 3] + b.y);
      asm volatile("st.shared.b32 [%0], %1;" ::"r"(at + wr * 128),
                   "r"(*reinterpret_cast<const uint32_t*>(&lo)));
      asm volatile("st.shared.b32 [%0], %1;" ::"r"(at + (wr + 8) * 128),
                   "r"(*reinterpret_cast<const uint32_t*>(&hi)));
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    named_bar_sync(1 + wg, 128);
    if (wtid == 0) {
      tma_store_2d(&tmap_out, stg, n0, m0 + wg * 64);
      tma_store_2d(&tmap_out, stg + kOutBox, n0 + 64, m0 + wg * 64);
      bulk_commit();
    }
  }
  if (wtid == 0) bulk_wait_all();
}

// shared memory of everything but the ring, and the ring stages that fit
size_t wgmma_fixed_smem(int nwg, int C) {
  return 1024 /* alignment slack */ + (size_t)nwg * 64 * C * 2 + (size_t)nwg * 2 * kOutBox +
         (size_t)C * 2 * sizeof(float) + (2 * kMaxStages + 2) * 8;
}
int wgmma_stages(int nwg, int C) {
  const size_t fixed = wgmma_fixed_smem(nwg, C);
  const int n = fixed < (size_t)kMaxSmem ? (int)((kMaxSmem - fixed) / kStageBytes) : 0;
  return n < kMaxStages ? n : kMaxStages;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API function; the library is not linked
// against libcuda, so it is taken from the runtime's driver entry point.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a 2-D bf16 tensor map (inner x outer, row stride `inner` elements) with a
// box of 64 x box_outer and the 128-byte swizzle; loads past the edge fill
// zeros, stores past it are dropped
bool make_map(CUtensorMap* map, const void* base, uint64_t inner, uint64_t outer,
              uint32_t box_outer) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {inner * sizeof(bf16)};
  const cuuint32_t box[2] = {64, box_outer};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides,
             box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 0;
  }
  return sms;
}

template <int NWG>
cudaError_t launch_bf16(const bf16* x, const float* s, const float* sh, const bf16* w,
                        const float* b, bf16* out, int M, int C, int N, float eps,
                        cudaStream_t st) {
  constexpr int BM = NWG * 64;
  static bool configured = false;  // the attribute holds for every later launch
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(ln_dense_wgmma_kernel<NWG>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  CUtensorMap map_x, map_w, map_out;
  if (!make_map(&map_x, x, C, M, BM) || !make_map(&map_w, w, N, C, kBK) ||
      !make_map(&map_out, out, N, M, 64))
    return cudaErrorInvalidValue;
  const int sms = sm_count();  // one CTA per SM (its shared memory allows no more)
  if (sms < 1) return cudaErrorInvalidDevice;
  const long long units = (long long)((M + BM - 1) / BM) * (N / kBN);
  const int grid = units < sms ? (int)units : sms;
  const int stages = wgmma_stages(NWG, C);
  ln_dense_wgmma_kernel<NWG>
      <<<grid, NWG * 128 + 32, wgmma_fixed_smem(NWG, C) + (size_t)stages * kStageBytes, st>>>(
          map_x, map_w, map_out, s, sh, b, M, C, N, stages, eps);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- fp32 path

constexpr int kKs = 16;   // rows of W per cp.async slice
constexpr int kRing = 3;  // slices in flight

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// the widest C whose BM-row tile, k-major with a row of padding, and the W
// ring fit in shared memory
__host__ __device__ constexpr int f32_max_c(int bm) {
  return bm == 128 ? 384 : bm == 64 ? 640 : kMaxC;
}

// BM rows per CTA, 2 * BM threads: thread (ty, tx) owns rows ty*4 .. +4 and
// BM/2 + ty*4 .. +4, columns tx*4 .. +4 and 64 + tx*4 .. +4 of each 128-
// column tile.
template <int BM>
__global__ void __launch_bounds__(2 * BM)
ln_dense_f32_kernel(const float* __restrict__ x, const float* __restrict__ scale,
                    const float* __restrict__ shift, const float* __restrict__ w,
                    const float* __restrict__ bias, float* __restrict__ out, int M, int C, int N,
                    float eps) {
  constexpr int kThreads = 2 * BM;
  constexpr int S = BM + 4;  // k-major A: As[c * S + r]
  constexpr int kMaxJ = f32_max_c(BM) / 32;
  extern __shared__ float4 smem_f4[];
  float* As = reinterpret_cast<float*>(smem_f4);
  float* Bs = As + (size_t)C * S;  // kRing x kKs x 128
  const int row0 = blockIdx.x * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nj = C / 32;

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int ks = C / kKs, total = (N / 128) * ks;
  // slice g = (column tile g / ks, k-slice g % ks) of W goes to ring buffer g % 3
  auto load_slice = [&](int g) {
    if (g < total) {
      const int n0 = (g / ks) * 128, k0 = (g % ks) * kKs;
      float* dst = Bs + (g % kRing) * kKs * 128;
      for (int i = threadIdx.x; i < kKs * 32; i += kThreads) {
        const int kr = i / 32, c4 = i % 32;
        cp_async16(dst + kr * 128 + c4 * 4, w + (size_t)(k0 + kr) * N + n0 + c4 * 4);
      }
    }
    cp_async_commit();  // an empty group past the end keeps the count uniform
  };
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  load_slice(0);  // the first W slices fly while the tile is normalised
  load_slice(1);

  // LayerNorm: a warp per pair of rows (both rows' loads in flight at once),
  // lane owns channels lane + 32 j
  for (int r0 = 2 * warp; r0 < BM; r0 += 2 * (kThreads / 32)) {
    float v[2][kMaxJ], mean[2], rstd[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int grow = row0 + r0 + q;
#pragma unroll
      for (int j = 0; j < kMaxJ; ++j)
        if (j < nj) v[q][j] = grow < M ? __ldg(x + (size_t)grow * C + lane + 32 * j) : 0.f;
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kMaxJ; ++j)
        if (j < nj) sum += v[q][j];
      mean[q] = warp_sum(sum) / C;
      float sq = 0.f;
#pragma unroll
      for (int j = 0; j < kMaxJ; ++j) {
        if (j < nj) {
          const float dv = v[q][j] - mean[q];
          sq += dv * dv;
        }
      }
      rstd[q] = rsqrtf(warp_sum(sq) / C + eps);
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const bool in = row0 + r0 + q < M;  // rows past M are zeros
#pragma unroll
      for (int j = 0; j < kMaxJ; ++j) {
        if (j < nj) {
          const int c = lane + 32 * j;
          As[c * S + r0 + q] =
              in ? affine(v[q][j], mean[q], rstd[q], __ldg(scale + c), __ldg(shift + c)) : 0.f;
        }
      }
    }
  }

  for (int g = 0; g < total; ++g) {
    cp_async_wait<1>();  // slice g has landed (g + 1 may still fly)
    // every thread's part of slice g is in, and every thread is done with
    // slice g - 1, whose buffer slice g + 2 now takes (at g = 0 the
    // normalised tile is complete too)
    __syncthreads();
    load_slice(g + 2);
    const float* B = Bs + (g % kRing) * kKs * 128;
    const float* A = As + (size_t)(g % ks) * kKs * S;
#pragma unroll
    for (int kk = 0; kk < kKs; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(A + kk * S + ty * 4);
      const float4 a1 = *reinterpret_cast<const float4*>(A + kk * S + BM / 2 + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(B + kk * 128 + tx * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(B + kk * 128 + 64 + tx * 4);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (g % ks == ks - 1) {  // the column tile is complete: bias, 16-byte stores
      const int n0 = (g / ks) * 128;
      const float4 bb0 = __ldg(reinterpret_cast<const float4*>(bias + n0 + tx * 4));
      const float4 bb1 = __ldg(reinterpret_cast<const float4*>(bias + n0 + 64 + tx * 4));
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int grow = row0 + (i < 4 ? ty * 4 + i : BM / 2 + ty * 4 + i - 4);
        if (grow < M) {
          float* o = out + (size_t)grow * N + n0;
          *reinterpret_cast<float4*>(o + tx * 4) =
              make_float4(acc[i][0] + bb0.x, acc[i][1] + bb0.y, acc[i][2] + bb0.z,
                          acc[i][3] + bb0.w);
          *reinterpret_cast<float4*>(o + 64 + tx * 4) =
              make_float4(acc[i][4] + bb1.x, acc[i][5] + bb1.y, acc[i][6] + bb1.z,
                          acc[i][7] + bb1.w);
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
      }
    }
  }
}

size_t f32_smem(int bm, int C) {
  return ((size_t)C * (bm + 4) + kRing * kKs * 128) * sizeof(float);
}

template <int BM>
cudaError_t launch_f32(const float* x, const float* s, const float* sh, const float* w,
                       const float* b, float* out, int M, int C, int N, float eps,
                       cudaStream_t st) {
  static bool configured = false;  // the attribute holds for every later launch
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(ln_dense_f32_kernel<BM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const size_t smem = f32_smem(BM, C);
  ln_dense_f32_kernel<BM><<<(M + BM - 1) / BM, 2 * BM, smem, st>>>(x, s, sh, w, b, out, M, C,
                                                                    N, eps);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, w and out share it); ln_scale,
// ln_bias and b are fp32. Returns the cudaError_t of the launch (0 =
// success); the wrapper raises otherwise.
extern "C" int veon_ln_dense(const void* x, const void* ln_scale, const void* ln_bias,
                             const void* w, const void* b, void* out, int M, int C, int N,
                             float eps, int dtype, void* stream) {
  if (M <= 0 || C <= 0 || N <= 0 || C % 128 || N % 128 || C > kMaxC)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* s = static_cast<const float*>(ln_scale);
  const float* sh = static_cast<const float*>(ln_bias);
  const float* bb = static_cast<const float*>(b);
  if (dtype == 1) {
    const bf16* xb = static_cast<const bf16*>(x);
    const bf16* wb = static_cast<const bf16*>(w);
    bf16* ob = static_cast<bf16*>(out);
    if (wgmma_stages(2, C) >= 3)  // two warpgroups of 64 rows where a 3-stage ring still fits
      return launch_bf16<2>(xb, s, sh, wb, bb, ob, M, C, N, eps, st);
    return launch_bf16<1>(xb, s, sh, wb, bb, ob, M, C, N, eps, st);
  }
  if (dtype == 0) {
    const float* xf = static_cast<const float*>(x);
    const float* wf = static_cast<const float*>(w);
    float* of = static_cast<float*>(out);
    if (C <= f32_max_c(128)) return launch_f32<128>(xf, s, sh, wf, bb, of, M, C, N, eps, st);
    if (C <= f32_max_c(64)) return launch_f32<64>(xf, s, sh, wf, bb, of, M, C, N, eps, st);
    return launch_f32<32>(xf, s, sh, wf, bb, of, M, C, N, eps, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
