// What the C++ runner (aoti_runner.cpp) and daemon (serve_host.cpp) share
// over libtorch: frame tensors <-> at::Tensor, the package's device, the
// fp32 policy, and the op library (veon_ops.cpp) with its launch counters.
#ifndef VEON_TORCH_AOTI_UTIL_H_
#define VEON_TORCH_AOTI_UTIL_H_

#include <dlfcn.h>

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

#include <ATen/ATen.h>
#include <ATen/Context.h>
#include <torch/cuda.h>
#include <torch/csrc/inductor/aoti_package/model_package_loader.h>
#ifdef VEON_WITH_CUDA
#include <c10/cuda/CUDACachingAllocator.h>
#endif

#include "frame.h"

namespace veon_aoti {

namespace vf = veon_frame;

// protocol dtype codes (serve/protocol.py) <-> torch scalar types
inline bool frame_code_type(uint8_t code, at::ScalarType* out) {
  switch (code) {
    case 0: *out = at::kFloat; return true;
    case 1: *out = at::kDouble; return true;
    case 2: *out = at::kInt; return true;
    case 3: *out = at::kLong; return true;
    case 4: *out = at::kByte; return true;
    case 5: *out = at::kBFloat16; return true;
    case 6: *out = at::kBool; return true;
    case 7: *out = at::kHalf; return true;
  }
  return false;
}

inline bool type_frame_code(at::ScalarType t, uint8_t* out) {
  for (uint8_t code = 0; code < 8; ++code) {
    at::ScalarType s;
    if (frame_code_type(code, &s) && s == t) {
      *out = code;
      return true;
    }
  }
  return false;
}

// A frame tensor on `device` (a copy); throws on an unknown dtype code.
inline at::Tensor to_tensor(const vf::Tensor& t, const c10::Device& device) {
  at::ScalarType type;
  if (!frame_code_type(t.dtype, &type))
    throw std::runtime_error("unsupported dtype code " + std::to_string(t.dtype) + " for " +
                             t.name);
  std::vector<int64_t> dims(t.dims.begin(), t.dims.end());
  at::Tensor host = at::from_blob(const_cast<uint8_t*>(t.data.data()), dims,
                                  at::TensorOptions().dtype(type));
  return host.to(device, /*non_blocking=*/false, /*copy=*/true);
}

// A tensor as a frame tensor named `name` (copied to the host).
inline vf::Tensor from_tensor(const at::Tensor& x, const std::string& name) {
  at::Tensor host = x.to(at::kCPU).contiguous();
  vf::Tensor t;
  t.name = name;
  if (!type_frame_code(host.scalar_type(), &t.dtype))
    throw std::runtime_error("unsupported output dtype " +
                             std::string(c10::toString(host.scalar_type())) + " for " + name);
  t.dims.assign(host.sizes().begin(), host.sizes().end());
  const auto* p = static_cast<const uint8_t*>(host.data_ptr());
  t.data.assign(p, p + host.nbytes());
  return t;
}

// The device a package was compiled for ("cpu" or "cuda"), from its
// metadata.
inline std::string package_device(const std::string& package) {
  auto meta = torch::inductor::AOTIModelPackageLoader::load_metadata_from_package(package,
                                                                                "model");
  auto it = meta.find("AOTI_DEVICE_KEY");
  if (it == meta.end()) throw std::runtime_error(package + ": no AOTI_DEVICE_KEY in metadata");
  return it->second;
}

// fp32 stays fp32, as the Python side's `entry._no_tf32` keeps it: no
// TF32 in cuBLAS products or cuDNN convolutions (libtorch allows it in
// cuDNN by default).
inline void no_tf32() {
  at::globalContext().setAllowTF32CuBLAS(false);
  at::globalContext().setAllowTF32CuDNN(false);
}

// The op library, loaded with its symbols global (so its TORCH_LIBRARY
// registrations serve the package's extern nodes), and its counters.
struct OpsLibrary {
  long long (*launches)(const char*) = nullptr;
  int (*with_cuda)() = nullptr;

  // Empty on success, else the loader's error.
  std::string load(const char* path) {
    void* h = dlopen(path, RTLD_NOW | RTLD_GLOBAL);
    if (!h) return std::string("cannot load op library: ") + dlerror();
    launches = reinterpret_cast<long long (*)(const char*)>(dlsym(h, "veon_ops_launches"));
    with_cuda = reinterpret_cast<int (*)()>(dlsym(h, "veon_ops_with_cuda"));
    if (!launches || !with_cuda)
      return std::string(path) + " is not a veon_ops library (no veon_ops_* entries)";
    return "";
  }

  // "bev_pool_pooled=N bev_pool_sorted=N bev_pool_sorted2=N deform_stencil=N"
  std::string counts() const {
    std::string s;
    for (const char* op : {"bev_pool_pooled", "bev_pool_sorted", "bev_pool_sorted2",
                           "deform_stencil"})
      s += std::string(s.empty() ? "" : " ") + op + "=" + std::to_string(launches(op));
    return s;
  }
};

// Bytes the caching allocator of `device` has held at most (0 on the CPU).
inline long long device_peak_bytes(const c10::Device& device) {
#ifdef VEON_WITH_CUDA
  if (device.is_cuda()) {
    auto stats = c10::cuda::CUDACachingAllocator::getDeviceStats(device.index());
    return stats.allocated_bytes[static_cast<size_t>(c10::CachingAllocator::StatType::AGGREGATE)]
        .peak;
  }
#endif
  (void)device;
  return 0;
}

}  // namespace veon_aoti

#endif  // VEON_TORCH_AOTI_UTIL_H_
