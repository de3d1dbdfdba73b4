// veon_serve_host: serves an exported VEON package on a unix socket with
// no Python in the loop (the port's counterpart of the JAX package's
// native serve_host.cpp, and the C++ twin of serve/server.py). Loads the
// op library (veon_ops.cpp), then the AOTInductor package, puts the fixed
// inputs (rig metas, the open-vocabulary matrix; the bundle's bind/*.npy)
// on the package's device once, then answers tensor frames
// (serve/protocol.py framing, frame.h).
//
//   veon_serve_host <socket> <ops.so> <package.pt2> --order a,b,c
//       [--bind name=file.npy ...] [--out y0,y1] [--once]
//   veon_serve_host <socket> --echo [--once]
//
// --order: the package's flat input names (manifest "order"); each comes
//   from --bind or, per request, from the request tensor of that name.
// --out: response tensor names (default out0..outN-1).
// --once: exit after the first connection closes.
// --echo: no package: answer every request with its own tensors (the
//   transport alone; -DVEON_NO_TORCH builds only this, with no libtorch).
//
// As serve/server.py: one thread per connection, calls serialized on a
// mutex (one device), persistent connections, one request per round; a
// per-request error becomes a status-1 frame and the daemon keeps serving.
// Each response adds server_ms (f32). After each served request the
// daemon prints one line: the request's server_ms, the op library's
// launch counts and the device allocator's peak bytes. Without --once,
// SIGTERM or SIGINT stops it cleanly (exit 0): the loader's unpacked copy
// of the package in the temporary directory is removed, as on a normal
// exit.
//
// Build: ops/native.py `build_host("veon_serve_host")` (libtorch) or
// `build_host("veon_serve_host_echo")` (-DVEON_NO_TORCH).

#include <chrono>
#include <csignal>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <exception>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <utility>
#include <vector>

#include <sys/socket.h>
#include <unistd.h>

#include "frame.h"
#ifndef VEON_NO_TORCH
#include "aoti_util.h"
#endif

namespace vf = veon_frame;

namespace {

std::vector<std::string> split_csv(const char* s) {
  std::vector<std::string> out;
  std::string cur;
  for (const char* p = s;; ++p) {
    if (*p == ',' || *p == '\0') {
      if (!cur.empty()) out.push_back(cur);
      cur.clear();
      if (!*p) break;
    } else {
      cur += *p;
    }
  }
  return out;
}

double now_ms() {
  return std::chrono::duration<double, std::milli>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

// request handler interface: fills `resp` or returns an error message
struct Handler {
  virtual ~Handler() = default;
  virtual std::string handle(const std::vector<vf::Tensor>& req,
                             std::vector<vf::Tensor>* resp) = 0;
  virtual void served(double /*ms*/) {}
};

struct EchoHandler : Handler {
  std::string handle(const std::vector<vf::Tensor>& req,
                     std::vector<vf::Tensor>* resp) override {
    *resp = req;
    return "";
  }
};

#ifndef VEON_NO_TORCH
struct PackageHandler : Handler {
  torch::inductor::AOTIModelPackageLoader* loader = nullptr;
  veon_aoti::OpsLibrary ops;
  c10::Device device{c10::DeviceType::CPU};
  std::vector<std::string> order;      // flat input names
  std::vector<std::string> out_names;  // response tensor names
  std::vector<at::Tensor> bound;       // per order slot, or undefined
  long long requests = 0;

  std::string handle(const std::vector<vf::Tensor>& req,
                     std::vector<vf::Tensor>* resp) override {
    try {
      std::vector<at::Tensor> inputs(order.size());
      for (size_t i = 0; i < order.size(); ++i) {
        if (bound[i].defined()) {
          inputs[i] = bound[i];
          continue;
        }
        const vf::Tensor* t = nullptr;
        for (const auto& r : req)
          if (r.name == order[i]) t = &r;
        if (!t) return "missing request tensor: " + order[i];
        inputs[i] = veon_aoti::to_tensor(*t, device);
      }
      std::vector<at::Tensor> outs = loader->run(inputs);
      for (size_t i = 0; i < outs.size(); ++i)
        resp->push_back(veon_aoti::from_tensor(
            outs[i], i < out_names.size() ? out_names[i] : "out" + std::to_string(i)));
    } catch (const std::exception& e) {
      resp->clear();
      return e.what();
    }
    return "";
  }

  void served(double ms) override {
    std::printf("served request %lld: server_ms %.3f; launches %s; device peak %lld bytes\n",
                ++requests, ms, ops.counts().c_str(), veon_aoti::device_peak_bytes(device));
    std::fflush(stdout);
  }
};
#endif  // VEON_NO_TORCH

// calls are serialized: the package runs on one device, so concurrency buys
// nothing on the compute side; the mutex lets a second client in while the
// first holds its persistent connection (serve/server.py's semantics)
std::mutex handler_mu;

// SIGTERM / SIGINT: stop accepting (accept() then fails and the serve loop
// returns); shutdown() is async-signal-safe
volatile std::sig_atomic_t stopping = 0;
int listen_fd_for_signal = -1;

void on_stop_signal(int) {
  stopping = 1;
  if (listen_fd_for_signal >= 0) ::shutdown(listen_fd_for_signal, SHUT_RDWR);
}

void serve_connection(int conn, Handler* handler) {
  for (;;) {  // persistent connection: one request per round
    std::vector<vf::Tensor> req;
    uint16_t status = 0;
    if (!vf::recv_frame(conn, &req, &status)) break;  // peer closed
    std::vector<vf::Tensor> resp;
    std::string err;
    double ms = 0;
    if (status == 0) {
      std::lock_guard<std::mutex> lk(handler_mu);
      const double t0 = now_ms();
      err = handler->handle(req, &resp);
      ms = now_ms() - t0;
      if (err.empty()) handler->served(ms);
    } else {
      err = "request status " + std::to_string(status);
    }
    if (!err.empty()) {
      if (!vf::send_error(conn, err)) break;
      continue;  // keep serving, like serve/server.py
    }
    vf::Tensor t;
    t.name = "server_ms";
    t.dtype = 0;  // f32 scalar
    const float v = static_cast<float>(ms);
    t.data.resize(4);
    std::memcpy(t.data.data(), &v, 4);
    resp.push_back(std::move(t));
    if (!vf::send_frame(conn, resp)) break;
  }
  ::close(conn);
}

int serve_loop(int listen_fd, Handler* handler, bool once) {
  for (;;) {
    int conn = ::accept(listen_fd, nullptr, nullptr);
    if (conn < 0) return 1;
    if (once) {  // handle the one connection inline, then exit
      serve_connection(conn, handler);
      return 0;
    }
    std::thread(serve_connection, conn, handler).detach();
  }
}

}  // namespace

int main(int argc, char** argv) {
  if (argc < 3) {
    std::fprintf(stderr,
                 "usage: %s <socket> --echo [--once]\n"
                 "       %s <socket> <ops.so> <package.pt2> --order a,b,c"
                 " [--bind name=file.npy ...] [--out y0,y1] [--once]\n",
                 argv[0], argv[0]);
    return 2;
  }
  const char* socket_path = argv[1];
  const bool echo = std::strcmp(argv[2], "--echo") == 0;
  bool once = false;
  for (int i = 2; i < argc; ++i)
    if (std::strcmp(argv[i], "--once") == 0) once = true;

  EchoHandler echo_handler;
  Handler* handler = &echo_handler;

#ifndef VEON_NO_TORCH
  PackageHandler pkg;
  std::unique_ptr<torch::inductor::AOTIModelPackageLoader> loader;
  if (!echo) {
    if (argc < 4) {
      std::fprintf(stderr, "need <ops.so> <package.pt2>\n");
      return 2;
    }
    std::vector<std::pair<std::string, std::string>> binds;
    for (int i = 4; i < argc; ++i) {
      if (std::strcmp(argv[i], "--order") == 0 && i + 1 < argc) {
        pkg.order = split_csv(argv[++i]);
      } else if (std::strcmp(argv[i], "--out") == 0 && i + 1 < argc) {
        pkg.out_names = split_csv(argv[++i]);
      } else if (std::strcmp(argv[i], "--bind") == 0 && i + 1 < argc) {
        const char* eq = std::strchr(argv[++i], '=');
        if (!eq) {
          std::fprintf(stderr, "bad --bind (want name=file.npy): %s\n", argv[i]);
          return 2;
        }
        binds.emplace_back(std::string(argv[i], eq - argv[i]), std::string(eq + 1));
      } else if (std::strcmp(argv[i], "--once") != 0) {
        std::fprintf(stderr, "unknown argument: %s\n", argv[i]);
        return 2;
      }
    }
    if (pkg.order.empty()) {
      std::fprintf(stderr, "--order is required to serve a package\n");
      return 2;
    }
    // the package checks every input's size, stride and dtype before it runs
    setenv("AOTI_RUNTIME_CHECK_INPUTS", "1", 1);
    veon_aoti::no_tf32();
    std::string e = pkg.ops.load(argv[2]);
    if (!e.empty()) {
      std::fprintf(stderr, "%s\n", e.c_str());
      return 1;
    }
    try {
      const std::string device = veon_aoti::package_device(argv[3]);
      if (device == "cuda" && torch::cuda::device_count() == 0) {
        std::fprintf(stderr, "%s needs a CUDA device and this host has none\n", argv[3]);
        return 3;
      }
      pkg.device = c10::Device(device == "cuda" ? c10::DeviceType::CUDA : c10::DeviceType::CPU,
                               0);
      loader = std::make_unique<torch::inductor::AOTIModelPackageLoader>(argv[3]);
      pkg.loader = loader.get();
      // the fixed inputs go to the device once
      pkg.bound.assign(pkg.order.size(), at::Tensor());
      for (const auto& [name, path] : binds) {
        vf::Tensor t;
        if (!vf::parse_npy(path, &t)) {
          std::fprintf(stderr, "cannot read npy %s\n", path.c_str());
          return 1;
        }
        t.name = name;
        bool placed = false;
        for (size_t i = 0; i < pkg.order.size(); ++i) {
          if (pkg.order[i] != name) continue;
          pkg.bound[i] = veon_aoti::to_tensor(t, pkg.device);
          placed = true;
        }
        if (!placed) {
          std::fprintf(stderr, "--bind name %s not in --order\n", name.c_str());
          return 2;
        }
      }
    } catch (const std::exception& ex) {
      std::fprintf(stderr, "error: %s\n", ex.what());
      return 1;
    }
    handler = &pkg;
    std::printf("loaded %s on %s; serving a %zu-input package\n", argv[3],
                pkg.device.str().c_str(), pkg.order.size());
  }
#else
  if (!echo) {
    std::fprintf(stderr, "built with -DVEON_NO_TORCH: only --echo is available\n");
    return 2;
  }
#endif  // VEON_NO_TORCH

  int lfd = vf::listen_unix(socket_path);
  if (lfd < 0) {
    std::fprintf(stderr, "cannot listen on %s\n", socket_path);
    return 1;
  }
  if (!once) {  // --once serves its connection on this thread: signals stay fatal
    listen_fd_for_signal = lfd;
    struct sigaction sa {};
    sa.sa_handler = on_stop_signal;
    sigaction(SIGTERM, &sa, nullptr);
    sigaction(SIGINT, &sa, nullptr);
  }
  std::printf("serving on %s (%s)\n", socket_path, echo ? "echo" : "package");
  std::fflush(stdout);
  int rc = serve_loop(lfd, handler, once);
  if (stopping) rc = 0;
  // no request runs from here on (the lock is never released): the loader
  // can go, and with it the unpacked package; connection threads end with
  // the process
  handler_mu.lock();
#ifndef VEON_NO_TORCH
  loader.reset();
#endif
  std::fflush(stdout);
  std::_Exit(rc);
}
