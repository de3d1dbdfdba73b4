// veon_aoti_runner: runs an exported VEON serving package once, with no
// Python (the port's counterpart of the JAX package's one-shot PJRT
// runner). Loads the op library (veon_ops.cpp: kernels #1-#3 as
// torch.ops.veon.*), then the AOTInductor package (utils/export.py
// `export_native_bundle`: model.pt2), feeds .npy inputs in the package's
// flat input order (the bundle's manifest "order"), runs, and writes one
// .npy per output (bf16 as '<V2').
//
//   veon_aoti_runner <ops.so> <package.pt2> [in0.npy in1.npy ...]
//                    [--out prefix] [--probe]
//
// --probe: print the device the package needs, the CUDA devices present
// and the op library's build, and stop. A CUDA package with no CUDA device
// exits 3 (with or without --probe), a usage error 2, any other failure 1.
// After a run it prints the op library's launch counts.
//
// Build: ops/native.py `build_host("veon_aoti_runner")` (g++ against the
// installed torch's include/ and lib/).

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <exception>
#include <string>
#include <vector>

#include "aoti_util.h"

namespace va = veon_aoti;
namespace vf = veon_frame;

int main(int argc, char** argv) {
  if (argc < 3) {
    std::fprintf(stderr,
                 "usage: %s <ops.so> <package.pt2> [inputs.npy ...] [--out prefix] [--probe]\n",
                 argv[0]);
    return 2;
  }
  bool probe = false;
  std::string out_prefix = "./out_";
  std::vector<std::string> input_paths;
  for (int i = 3; i < argc; ++i) {
    if (std::strcmp(argv[i], "--probe") == 0) {
      probe = true;
    } else if (std::strcmp(argv[i], "--out") == 0) {
      if (i + 1 >= argc) {
        std::fprintf(stderr, "--out needs a prefix\n");
        return 2;
      }
      out_prefix = argv[++i];
    } else {
      input_paths.push_back(argv[i]);
    }
  }
  // the package checks every input's size, stride and dtype before it runs
  setenv("AOTI_RUNTIME_CHECK_INPUTS", "1", 1);
  std::setvbuf(stdout, nullptr, _IOLBF, 0);
  veon_aoti::no_tf32();

  va::OpsLibrary ops;
  std::string err = ops.load(argv[1]);
  if (!err.empty()) {
    std::fprintf(stderr, "%s\n", err.c_str());
    return 1;
  }
  try {
    const std::string device = va::package_device(argv[2]);
    const size_t n_cuda = torch::cuda::device_count();
    std::printf("package device: %s\ncuda devices: %zu\nop library: %s\n", device.c_str(),
                n_cuda, ops.with_cuda() ? "cuda" : "cpu");
    if (device == "cuda" && n_cuda == 0) {
      std::fprintf(stderr, "%s needs a CUDA device and this host has none\n", argv[2]);
      return 3;
    }
    if (probe) return 0;

    torch::inductor::AOTIModelPackageLoader loader(argv[2]);
    const c10::Device dev(device == "cuda" ? c10::DeviceType::CUDA : c10::DeviceType::CPU, 0);
    std::vector<at::Tensor> inputs;
    for (const auto& p : input_paths) {
      vf::Tensor t;
      if (!vf::parse_npy(p, &t)) {
        std::fprintf(stderr, "cannot read npy %s\n", p.c_str());
        return 1;
      }
      t.name = p;
      inputs.push_back(va::to_tensor(t, dev));
    }
    std::vector<at::Tensor> outs = loader.run(inputs);
    for (size_t i = 0; i < outs.size(); ++i) {
      const std::string path = out_prefix + std::to_string(i) + ".npy";
      if (!vf::write_npy(path, va::from_tensor(outs[i], path))) {
        std::fprintf(stderr, "write failed: %s\n", path.c_str());
        return 1;
      }
      std::printf("output %zu -> %s\n", i, path.c_str());
    }
    std::printf("launches %s\n", ops.counts().c_str());
  } catch (const std::exception& e) {
    std::fprintf(stderr, "error: %s\n", e.what());
    return 1;
  }
  return 0;
}
