// Kernels #1-#3 and the deformable stencil as C++-registered operators,
// for programs with no Python in the loop: the C++ runner
// (host/aoti_runner.cpp) and daemon (host/serve_host.cpp) load this
// library, then an AOTInductor package
// (utils/export.py `export_native_bundle`) whose extern nodes call
// torch.ops.veon.* by name.
//
// The schemas are those of the Python custom ops of ops/bev_pool.py and
// ops/deform_stencil.py, and the package names them, so the two must not
// meet in one process: a process that imported those modules has defined
// veon::* already and would fail at TORCH_LIBRARY below. Python keeps the
// Python ops; the C++ programs load only this library.
//
// CUDA: the same pre-launch work as the Python wrappers (argument checks,
// `_weight_strides`, `_cell_starts`, the pooled kernel's scratch list), then
// the kernels' C entries (bev_pool_pooled.cu, bev_pool_sorted.cu,
// deform_stencil.cu, linked by path) on the current stream. Each launch
// counts in `veon_ops_launches`. CPU: the plain versions (`presorted_vals` +
// `bev_pool_pooled_plain`, `bev_pool_sorted_plain`, `deform_stencil_plain`)
// in ATen, op for op, so they give the Python plain versions' bits. Built
// without VEON_WITH_CUDA (a CPU-only torch), a CUDA tensor raises.

#include <atomic>
#include <cmath>
#include <cstring>
#include <string>
#include <tuple>
#include <utility>
#include <vector>

#include <ATen/ATen.h>
#include <torch/library.h>

#ifdef VEON_WITH_CUDA
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>

extern "C" int veon_bev_pool_pooled(const void* feat, const void* depth, long long pix_stride,
                                    long long bin_stride, const void* order, const void* rk,
                                    const void* starts, void* out, void* long_list, int n_coarse,
                                    int C, int D, int pool_r, int dtype, void* stream);
extern "C" int veon_bev_pool_sorted(const void* vals, const void* starts, void* out,
                                    int num_cells, int C, int dtype, void* stream);
extern "C" int veon_bev_pool_sorted2(const void* vals1, const void* starts1, const void* vals2,
                                     const void* starts2, void* out, int num_cells, int C,
                                     int dtype, void* stream);
extern "C" int veon_deform_stencil(const void* off, const void* query, const void* kv, void* out,
                                   void* dt_out, int B, int D, int H, int W, int num_heads,
                                   int head_dim, int num_samples, int dtype, void* stream);
#endif

namespace {

constexpr int kNumOps = 4;
const char* const kOpNames[kNumOps] = {"bev_pool_pooled", "bev_pool_sorted", "bev_pool_sorted2",
                                       "deform_stencil"};
std::atomic<long long> launches[kNumOps];

// ---------------------------------------------------------------- CPU --

at::Tensor presorted_vals(const at::Tensor& depth, const at::Tensor& feat,
                          const at::Tensor& order) {
  const int64_t D = depth.size(2);
  const int64_t C = feat.size(-1);
  at::Tensor o = order.to(at::kLong);
  at::Tensor wts = depth.permute({0, 1, 3, 4, 2}).reshape({-1});
  return feat.reshape({-1, C}).index({at::div(o, D, "floor")}) * wts.index({o}).unsqueeze(1);
}

at::Tensor sorted_plain(const std::vector<std::pair<at::Tensor, at::Tensor>>& streams,
                        int64_t num_cells) {
  const at::Tensor& vals0 = streams[0].first;
  at::Tensor acc = at::zeros({num_cells + 1, vals0.size(1)},
                             vals0.options().dtype(at::kFloat));
  for (const auto& [vals, rk] : streams)
    acc.index_add_(0, rk.to(at::kLong).clamp_max(num_cells), vals.to(at::kFloat));
  return acc.slice(0, 0, num_cells).to(vals0.scalar_type());
}

at::Tensor pooled_cpu(const at::Tensor& depth, const at::Tensor& feat, const at::Tensor& order,
                      const at::Tensor& rk_sorted, int64_t num_cells, int64_t pool_r) {
  at::Tensor vals = presorted_vals(depth, feat, order);
  at::Tensor acc = at::zeros({num_cells + 1, vals.size(1)}, vals.options().dtype(at::kFloat));
  acc.index_add_(0, rk_sorted.to(at::kLong).clamp_max(num_cells), vals.to(at::kFloat));
  return acc.slice(0, 0, num_cells)
      .reshape({num_cells / pool_r, pool_r, -1})
      .amax(1)
      .to(feat.scalar_type());
}

at::Tensor sorted_cpu(const at::Tensor& vals, const at::Tensor& rk_sorted, int64_t num_cells) {
  return sorted_plain({{vals, rk_sorted}}, num_cells);
}

at::Tensor sorted2_cpu(const at::Tensor& vals1, const at::Tensor& rk1, const at::Tensor& vals2,
                       const at::Tensor& rk2, int64_t num_cells) {
  return sorted_plain({{vals1, rk1}, {vals2, rk2}}, num_cells);
}

// ops/deform_stencil.py `_check`: (B, D, H, W, C) of shapes that fit.
std::vector<int64_t> stencil_shape(const at::Tensor& off, const at::Tensor& query,
                                   const at::Tensor& kv, int64_t nh, int64_t ns) {
  TORCH_CHECK(query.dim() == 5 && off.dim() == 5 && kv.dim() == 5, "deform_stencil: off ",
              off.sizes(), ", query ", query.sizes(), " and kv ", kv.sizes(),
              " must be (B, D, H, W, channels)");
  std::vector<int64_t> s = query.sizes().vec();
  const bool fit = nh >= 1 && ns >= 1 && s[4] % nh == 0 &&
                   off.sizes() == at::IntArrayRef({s[0], s[1], s[2], s[3], nh * ns * 3}) &&
                   kv.sizes() == at::IntArrayRef({s[0], s[1], s[2], s[3], 2 * s[4]});
  TORCH_CHECK(fit, "deform_stencil: off ", off.sizes(), ", query ", query.sizes(), " and kv ",
              kv.sizes(), " do not fit ", nh, " heads of ", ns, " samples");
  return s;
}

// `_linspace_pm1`: step = iota * fp32(1 / (n - 1)), -(1 - step) + step, 1.
at::Tensor linspace_pm1(int64_t n, const at::TensorOptions& f32) {
  if (n == 1) return at::full({1}, -1.0, f32);
  const int64_t div = n - 1;
  const float recip = 1.0f / static_cast<float>(div);  // fp32, as the Python version's
  const at::Tensor step = at::arange(div, f32) * static_cast<double>(recip);
  return at::cat({at::rsub(step, 1).neg() + step, at::ones({1}, f32)});
}

// `_edge_pad3d` and `_shift3d`.
at::Tensor edge_pad3d(at::Tensor x) {
  for (int64_t ax = 1; ax <= 3; ++ax) {
    const int64_t n = x.size(ax);
    x = at::cat({x.narrow(ax, 0, 1), x, x.narrow(ax, n - 1, 1)}, ax);
  }
  return x;
}

at::Tensor shift3d(const at::Tensor& xp, int64_t tz, int64_t ty, int64_t tx) {
  const int64_t Z = xp.size(1) - 2, Y = xp.size(2) - 2, X = xp.size(3) - 2;
  return xp.slice(1, 1 + tz, 1 + tz + Z).slice(2, 1 + ty, 1 + ty + Y).slice(3, 1 + tx, 1 + tx + X);
}

// `deform_stencil_plain`, op for op.
at::Tensor stencil_cpu(const at::Tensor& off_in, const at::Tensor& query, const at::Tensor& kv,
                       int64_t nh, int64_t ns) {
  const std::vector<int64_t> s = stencil_shape(off_in, query, kv, nh, ns);
  const int64_t B = s[0], D = s[1], H = s[2], W = s[3], C = s[4], hd = C / nh;
  const at::TensorOptions f32 = query.options().dtype(at::kFloat);
  const at::Tensor off = off_in.reshape({B, D, H, W, nh, ns, 3});
  std::vector<at::Tensor> zyx =
      at::meshgrid({linspace_pm1(D, f32), linspace_pm1(H, f32), linspace_pm1(W, f32)}, "ij");
  const at::Tensor base = at::stack(zyx, -1).unsqueeze(0).unsqueeze(4).unsqueeze(4);
  const at::Tensor norm =
      at::tensor(std::vector<int64_t>{D, H, W}, query.options().dtype(at::kLong))
          .to(off.scalar_type());
  const at::Tensor grid = (base + off / norm).clamp(-1, 1);
  const at::Tensor q = query.reshape({B, D, H, W, nh, hd});
  const at::Tensor kvh = kv.reshape({B, D, H, W, nh, 2 * hd});
  const at::Tensor sizes =
      at::tensor(std::vector<int64_t>{D - 1, H - 1, W - 1}, query.options().dtype(at::kLong))
          .to(at::kFloat) / 2.0;
  const at::Tensor delta = (grid - base) * sizes;
  const at::Tensor qs = q * std::pow(static_cast<double>(hd), -0.5);
  at::Tensor hats[3][3];
  for (int64_t a = 0; a < 3; ++a)
    for (int64_t t = -1; t <= 1; ++t)
      hats[a][t + 1] = at::clamp_min(at::rsub((delta.select(-1, a) - t).abs(), 1.0), 0.0);
  const at::Tensor kvp = edge_pad3d(kvh);
  std::vector<at::Tensor> weights;
  at::Tensor logits;
  for (int64_t tz = -1; tz <= 1; ++tz)
    for (int64_t ty = -1; ty <= 1; ++ty)
      for (int64_t tx = -1; tx <= 1; ++tx) {
        at::Tensor w = hats[0][tz + 1] * hats[1][ty + 1] * hats[2][tx + 1];
        at::Tensor d = (qs * shift3d(kvp, tz, ty, tx).slice(-1, 0, hd)).sum(-1);
        at::Tensor wd = w * d.unsqueeze(-1);
        logits = logits.defined() ? logits + wd : wd.add(0.0);  // Python: 0.0 + wd
        weights.push_back(w);
      }
  const at::Tensor attn = at::softmax(logits.to(at::kFloat), -1).to(q.scalar_type());
  at::Tensor fused;
  size_t i = 0;
  for (int64_t tz = -1; tz <= 1; ++tz)
    for (int64_t ty = -1; ty <= 1; ++ty)
      for (int64_t tx = -1; tx <= 1; ++tx) {
        at::Tensor g = (attn * weights[i++]).sum(-1);
        at::Tensor gv = g.unsqueeze(-1) * shift3d(kvp, tz, ty, tx).slice(-1, hd);
        fused = fused.defined() ? fused + gv : gv.add(0.0);
      }
  return fused.reshape({B, D, H, W, C}).to(query.scalar_type());
}

// --------------------------------------------------------------- CUDA --

#ifdef VEON_WITH_CUDA

int dtype_code(const at::Tensor& t, const char* name) {
  if (t.scalar_type() == at::kFloat) return 0;
  if (t.scalar_type() == at::kBFloat16) return 1;
  TORCH_CHECK(false, name, " takes float32/bfloat16, got ", t.scalar_type());
}

// CSR row offsets: the first row of every `step`-th cell and the end of the
// last, by binary search of the sorted ranks (ops/bev_pool.py `_cell_starts`).
at::Tensor cell_starts(const at::Tensor& rk_sorted, int64_t num_cells, int64_t step) {
  at::Tensor bounds = at::arange(0, num_cells + 1, step,
                                 rk_sorted.options().dtype(at::kInt));
  return at::searchsorted(rk_sorted, bounds, /*out_int32=*/true);
}

// (weights, pixel stride, bin stride) of the pixel-major view of the depth
// weights, read in place where two strides describe it
// (ops/bev_pool.py `_weight_strides`).
std::tuple<at::Tensor, int64_t, int64_t> weight_strides(const at::Tensor& depth) {
  at::Tensor view = depth.permute({0, 1, 3, 4, 2});
  const int64_t D = view.size(4);
  const int64_t pix_stride = view.stride(3);
  int64_t expect = pix_stride;
  for (int i = 3; i >= 0; --i) {
    if (view.size(i) > 1 && view.stride(i) != expect) return {view.contiguous(), D, 1};
    expect *= view.size(i);
  }
  return {view, pix_stride, view.stride(4)};
}

void check_launch(int err, const char* name) {
  TORCH_CHECK(err == 0, name, " launch failed: cudaError ", err);
}

at::Tensor pooled_cuda(const at::Tensor& depth, const at::Tensor& feat_in,
                       const at::Tensor& order, const at::Tensor& rk_sorted, int64_t num_cells,
                       int64_t pool_r) {
  const char* name = "bev_pool_pooled";
  const auto dev = feat_in.device();
  for (const auto& [what, t] : {std::pair<const char*, const at::Tensor*>{"depth", &depth},
                                {"order", &order}, {"ranks", &rk_sorted}})
    TORCH_CHECK(t->device() == dev, name, ": ", what, " on ", t->device(), ", feat on ", dev);
  TORCH_CHECK(depth.scalar_type() == feat_in.scalar_type(), name,
              " takes depth and feat of one dtype, got ", depth.scalar_type(), " and ",
              feat_in.scalar_type());
  const int code = dtype_code(feat_in, name);
  TORCH_CHECK(pool_r > 0 && num_cells % pool_r == 0, name, ": num_cells ", num_cells,
              " is not a multiple of pool_r ", pool_r);
  TORCH_CHECK(depth.dim() == 5 && feat_in.dim() == 5 &&
                  depth.sizes().slice(0, 2) == feat_in.sizes().slice(0, 2) &&
                  depth.sizes().slice(3, 2) == feat_in.sizes().slice(2, 2),
              name, ": depth ", depth.sizes(), " and feat ", feat_in.sizes(), " do not match");
  TORCH_CHECK(order.scalar_type() == at::kInt && rk_sorted.scalar_type() == at::kInt &&
                  order.dim() == 1 && rk_sorted.sizes() == order.sizes(),
              name, ": order ", order.sizes(), " ", order.scalar_type(), " and ranks ",
              rk_sorted.sizes(), " ", rk_sorted.scalar_type(), " must be int32 (P_cap,)");
  TORCH_CHECK(order.is_contiguous() && rk_sorted.is_contiguous(), name,
              " needs contiguous order and ranks");
  const int64_t C = feat_in.size(-1);
  TORCH_CHECK(C <= 1024, name, " takes C <= 1024 channels, got ", C);
  at::Tensor feat = feat_in.contiguous();
  TORCH_CHECK(reinterpret_cast<uintptr_t>(feat.data_ptr()) % 16 == 0, name,
              " needs 16-byte aligned feat");
  c10::cuda::CUDAGuard guard(dev);
  auto [weights, pix_stride, bin_stride] = weight_strides(depth);
  const int64_t n_coarse = num_cells / pool_r;
  at::Tensor out = at::empty({n_coarse, C}, feat.options());
  at::Tensor starts = cell_starts(rk_sorted, num_cells, pool_r);
  at::Tensor long_list = at::empty({n_coarse + 65}, feat.options().dtype(at::kInt));
  check_launch(veon_bev_pool_pooled(feat.data_ptr(), weights.data_ptr(), pix_stride, bin_stride,
                                    order.data_ptr(), rk_sorted.data_ptr(), starts.data_ptr(),
                                    out.data_ptr(), long_list.data_ptr(),
                                    static_cast<int>(n_coarse), static_cast<int>(C),
                                    static_cast<int>(depth.size(2)), static_cast<int>(pool_r),
                                    code, c10::cuda::getCurrentCUDAStream(dev.index()).stream()),
               name);
  launches[0] += 1;
  return out;
}

// One or two (vals, rk) streams -> (num_cells, C) (ops/bev_pool.py
// `_check_stream` and `_launch_sorted`).
at::Tensor launch_sorted(const char* name,
                         const std::vector<std::pair<at::Tensor, at::Tensor>>& streams,
                         int64_t num_cells) {
  const at::Tensor& vals1 = streams[0].first;
  const auto dev = vals1.device();
  const int code = dtype_code(vals1, name);
  const int64_t C = vals1.size(1);
  for (const auto& [vals, rk] : streams) {
    TORCH_CHECK(vals.device() == dev && rk.device() == dev, name, ": vals on ", vals.device(),
                ", ranks on ", rk.device(), ", expected ", dev);
    TORCH_CHECK(vals.scalar_type() == vals1.scalar_type(), name,
                " takes float32/bfloat16 vals of one dtype, got ", vals.scalar_type());
    TORCH_CHECK(vals.dim() == 2 && rk.dim() == 1 && rk.size(0) == vals.size(0) &&
                    rk.scalar_type() == at::kInt,
                name, ": bad shapes: vals ", vals.sizes(), ", ranks ", rk.sizes(), " ",
                rk.scalar_type());
    TORCH_CHECK(vals.is_contiguous() && rk.is_contiguous(), name,
                " needs contiguous vals and ranks");
    TORCH_CHECK(reinterpret_cast<uintptr_t>(vals.data_ptr()) % 16 == 0, name,
                " needs 16-byte aligned rows");
    TORCH_CHECK(vals.size(1) == C, name, ": streams of ", C, " and ", vals.size(1), " channels");
  }
  c10::cuda::CUDAGuard guard(dev);
  at::Tensor out = at::empty({num_cells, C}, vals1.options());
  std::vector<at::Tensor> starts;
  for (const auto& s : streams) starts.push_back(cell_starts(s.second, num_cells, 1));
  void* stream = c10::cuda::getCurrentCUDAStream(dev.index()).stream();
  int err;
  if (streams.size() == 1)
    err = veon_bev_pool_sorted(vals1.data_ptr(), starts[0].data_ptr(), out.data_ptr(),
                               static_cast<int>(num_cells), static_cast<int>(C), code, stream);
  else
    err = veon_bev_pool_sorted2(vals1.data_ptr(), starts[0].data_ptr(),
                                streams[1].first.data_ptr(), starts[1].data_ptr(),
                                out.data_ptr(), static_cast<int>(num_cells),
                                static_cast<int>(C), code, stream);
  check_launch(err, name);
  return out;
}

at::Tensor sorted_cuda(const at::Tensor& vals, const at::Tensor& rk_sorted, int64_t num_cells) {
  at::Tensor out = launch_sorted("bev_pool_sorted", {{vals, rk_sorted}}, num_cells);
  launches[1] += 1;
  return out;
}

at::Tensor sorted2_cuda(const at::Tensor& vals1, const at::Tensor& rk1, const at::Tensor& vals2,
                        const at::Tensor& rk2, int64_t num_cells) {
  at::Tensor out =
      launch_sorted("bev_pool_sorted2", {{vals1, rk1}, {vals2, rk2}}, num_cells);
  launches[2] += 1;
  return out;
}

// ops/deform_stencil.py `launch`.
at::Tensor stencil_cuda(const at::Tensor& off_in, const at::Tensor& query_in,
                        const at::Tensor& kv_in, int64_t nh, int64_t ns) {
  const char* name = "deform_stencil";
  const std::vector<int64_t> s = stencil_shape(off_in, query_in, kv_in, nh, ns);
  const auto dev = query_in.device();
  for (const auto& [what, t] : {std::pair<const char*, const at::Tensor*>{"off", &off_in},
                                {"kv", &kv_in}}) {
    TORCH_CHECK(t->device() == dev, name, ": ", what, " on ", t->device(), ", query on ", dev);
    TORCH_CHECK(t->scalar_type() == query_in.scalar_type(), name,
                " takes off, query and kv of one dtype, got ", off_in.scalar_type(), ", ",
                query_in.scalar_type(), " and ", kv_in.scalar_type());
  }
  const int code = dtype_code(query_in, name);
  const int64_t hd = s[4] / nh;
  TORCH_CHECK((hd == 4 || hd == 64) && ns == 8, name,
              " kernel takes heads of (4, 64) channels and 8 samples, got query ",
              query_in.sizes(), " in ", nh, " heads of ", hd, " and ", ns, " samples");
  const at::Tensor off = off_in.contiguous(), query = query_in.contiguous(),
                   kv = kv_in.contiguous();
  TORCH_CHECK(reinterpret_cast<uintptr_t>(query.data_ptr()) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(kv.data_ptr()) % 16 == 0,
              name, " needs 16-byte aligned query and kv");
  c10::cuda::CUDAGuard guard(dev);
  at::Tensor out = at::empty(query.sizes(), query.options());
  check_launch(veon_deform_stencil(off.data_ptr(), query.data_ptr(), kv.data_ptr(),
                                   out.data_ptr(), nullptr, static_cast<int>(s[0]),
                                   static_cast<int>(s[1]), static_cast<int>(s[2]),
                                   static_cast<int>(s[3]), static_cast<int>(nh),
                                   static_cast<int>(hd), static_cast<int>(ns), code,
                                   c10::cuda::getCurrentCUDAStream(dev.index()).stream()),
               name);
  launches[3] += 1;
  return out;
}

#else  // a CPU-only build: a CUDA tensor is an error, never the plain version

[[noreturn]] void no_cuda(const char* name) {
  TORCH_CHECK(false, "veon::", name, ": this veon_ops library was built without CUDA ",
              "(a CPU-only torch); it runs CPU tensors only");
}

at::Tensor pooled_cuda(const at::Tensor&, const at::Tensor&, const at::Tensor&,
                       const at::Tensor&, int64_t, int64_t) {
  no_cuda(kOpNames[0]);
}

at::Tensor sorted_cuda(const at::Tensor&, const at::Tensor&, int64_t) { no_cuda(kOpNames[1]); }

at::Tensor sorted2_cuda(const at::Tensor&, const at::Tensor&, const at::Tensor&,
                        const at::Tensor&, int64_t) {
  no_cuda(kOpNames[2]);
}

at::Tensor stencil_cuda(const at::Tensor&, const at::Tensor&, const at::Tensor&, int64_t,
                        int64_t) {
  no_cuda(kOpNames[3]);
}

#endif  // VEON_WITH_CUDA

}  // namespace

// Kernel launches per op since the library was loaded: `op` is an op's
// name without its namespace ("bev_pool_pooled"); -1 for an unknown name.
extern "C" long long veon_ops_launches(const char* op) {
  for (int i = 0; i < kNumOps; ++i)
    if (std::strcmp(op, kOpNames[i]) == 0) return launches[i].load();
  return -1;
}

// 1 where this library launches the CUDA kernels, 0 in a CPU-only build.
extern "C" int veon_ops_with_cuda() {
#ifdef VEON_WITH_CUDA
  return 1;
#else
  return 0;
#endif
}

TORCH_LIBRARY(veon, m) {
  m.def("bev_pool_pooled(Tensor depth, Tensor feat, Tensor order, Tensor rk_sorted, "
        "int num_cells, int pool_r) -> Tensor");
  m.def("bev_pool_sorted(Tensor vals, Tensor rk_sorted, int num_cells) -> Tensor");
  m.def("bev_pool_sorted2(Tensor vals1, Tensor rk1, Tensor vals2, Tensor rk2, "
        "int num_cells) -> Tensor");
  m.def("deform_stencil(Tensor off, Tensor query, Tensor kv, int num_heads, "
        "int num_samples) -> Tensor");
}

TORCH_LIBRARY_IMPL(veon, CPU, m) {
  m.impl("bev_pool_pooled", &pooled_cpu);
  m.impl("bev_pool_sorted", &sorted_cpu);
  m.impl("bev_pool_sorted2", &sorted2_cpu);
  m.impl("deform_stencil", &stencil_cpu);
}

TORCH_LIBRARY_IMPL(veon, CUDA, m) {
  m.impl("bev_pool_pooled", &pooled_cuda);
  m.impl("bev_pool_sorted", &sorted_cuda);
  m.impl("bev_pool_sorted2", &sorted2_cuda);
  m.impl("deform_stencil", &stencil_cuda);
}
