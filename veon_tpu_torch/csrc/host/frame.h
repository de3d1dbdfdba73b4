// The port's copy of the JAX package's native/frame.h: the tensor-frame
// protocol of serve/protocol.py and .npy io, shared by the C++ runner
// (aoti_runner.cpp) and daemon (serve_host.cpp). Little-endian frame =
// u32 magic 'VEON', u16 version=1, u16 status, u32 count, then per tensor
// u16 name_len, name, u8 dtype, u8 ndim, u64 dims[ndim], raw C-order data.
// bf16 .npy files carry descr '<V2' (numpy has no bfloat16), as
// utils/export.py `_write_npy` writes them. Header-only, no dependencies
// beyond POSIX sockets.
#ifndef VEON_NATIVE_FRAME_H_
#define VEON_NATIVE_FRAME_H_

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <string>
#include <vector>

#include <sys/socket.h>
#include <sys/un.h>
#include <unistd.h>

namespace veon_frame {

constexpr uint32_t kMagic = 0x56454F4E;
constexpr uint16_t kVersion = 1;

struct Tensor {
  std::string name;
  uint8_t dtype = 0;  // 0 f32,1 f64,2 i32,3 i64,4 u8,5 bf16,6 bool,7 f16
  std::vector<uint64_t> dims;
  std::vector<uint8_t> data;
};

inline size_t dtype_size(uint8_t code) {
  switch (code) {
    case 0: case 2: return 4;
    case 1: case 3: return 8;
    case 4: case 6: return 1;
    case 5: case 7: return 2;
  }
  return 0;
}

#ifndef MSG_NOSIGNAL
// macOS/BSD have no MSG_NOSIGNAL; those platforms can set SO_NOSIGPIPE
// on the socket instead.
#define MSG_NOSIGNAL 0
#endif

inline bool send_all(int fd, const void* buf, size_t n) {
  const char* p = static_cast<const char*>(buf);
  while (n) {
    // MSG_NOSIGNAL: a peer that closed mid-response must surface as EPIPE
    // (send_frame returns false, the serve loop drops the connection) —
    // the default SIGPIPE would kill the long-lived serve_host daemon.
    ssize_t w = ::send(fd, p, n, MSG_NOSIGNAL);
    if (w <= 0) return false;
    p += w;
    n -= static_cast<size_t>(w);
  }
  return true;
}

inline bool recv_all(int fd, void* buf, size_t n) {
  char* p = static_cast<char*>(buf);
  while (n) {
    ssize_t r = ::recv(fd, p, n, 0);
    if (r <= 0) return false;
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

inline bool send_frame(int fd, const std::vector<Tensor>& ts,
                       uint16_t status = 0) {
  struct __attribute__((packed)) {
    uint32_t magic;
    uint16_t version, status;
    uint32_t count;
  } hdr{kMagic, kVersion, status, static_cast<uint32_t>(ts.size())};
  if (!send_all(fd, &hdr, sizeof hdr)) return false;
  for (const auto& t : ts) {
    uint16_t nlen = static_cast<uint16_t>(t.name.size());
    uint8_t ndim = static_cast<uint8_t>(t.dims.size());
    if (!send_all(fd, &nlen, 2) || !send_all(fd, t.name.data(), nlen) ||
        !send_all(fd, &t.dtype, 1) || !send_all(fd, &ndim, 1) ||
        !send_all(fd, t.dims.data(), 8 * ndim) ||
        !send_all(fd, t.data.data(), t.data.size()))
      return false;
  }
  return true;
}

inline bool recv_frame(int fd, std::vector<Tensor>* out, uint16_t* status) {
  struct __attribute__((packed)) {
    uint32_t magic;
    uint16_t version, status;
    uint32_t count;
  } hdr;
  if (!recv_all(fd, &hdr, sizeof hdr)) return false;
  if (hdr.magic != kMagic || hdr.version != kVersion) return false;
  // tensor-count and whole-frame caps: without them a malicious header
  // (count up to 2^32) could drive cumulative resize()s to many GiB even
  // with the per-tensor cap below. Real frames carry <10 tensors and
  // <200 MB total.
  constexpr uint32_t kMaxTensors = 64;
  constexpr uint64_t kMaxFrameBytes = 2ull << 30;
  if (hdr.count > kMaxTensors) return false;
  *status = hdr.status;
  out->clear();
  uint64_t frame_bytes = 0;
  for (uint32_t i = 0; i < hdr.count; ++i) {
    Tensor t;
    uint16_t nlen;
    if (!recv_all(fd, &nlen, 2)) return false;
    t.name.resize(nlen);
    if (!recv_all(fd, t.name.data(), nlen)) return false;
    uint8_t ndim;
    if (!recv_all(fd, &t.dtype, 1) || !recv_all(fd, &ndim, 1)) return false;
    // An unknown dtype (size 0) or an absurd element count would desync the
    // stream / drive resize() into std::bad_alloc (uncaught -> the daemon
    // dies). The stream is unrecoverable either way, so fail the frame and
    // let the serve loop close the connection — the python server's
    // per-connection ValueError equivalent. 1 GiB/tensor is ~75x the
    // largest real frame (6-cam fp32 @ 512x1408).
    const size_t esz = dtype_size(t.dtype);
    if (esz == 0) return false;
    t.dims.resize(ndim);
    if (ndim && !recv_all(fd, t.dims.data(), 8 * ndim)) return false;
    constexpr uint64_t kMaxBytes = 1ull << 30;
    uint64_t n = 1;
    for (auto d : t.dims) {
      if (d != 0 && n > kMaxBytes / d) return false;
      n *= d;
    }
    if (n * esz > kMaxBytes) return false;
    frame_bytes += n * esz;
    if (frame_bytes > kMaxFrameBytes) return false;
    t.data.resize(n * esz);
    if (!t.data.empty() && !recv_all(fd, t.data.data(), t.data.size()))
      return false;
    out->push_back(std::move(t));
  }
  return true;
}

inline bool send_error(int fd, const std::string& msg) {
  Tensor t;
  t.name = "error";
  t.dtype = 4;  // u8 utf-8 bytes
  t.dims = {msg.size()};
  t.data.assign(msg.begin(), msg.end());
  return send_frame(fd, {t}, /*status=*/1);
}

inline int connect_unix(const char* path) {
  int fd = ::socket(AF_UNIX, SOCK_STREAM, 0);
  if (fd < 0) return -1;
  sockaddr_un addr{};
  addr.sun_family = AF_UNIX;
  std::snprintf(addr.sun_path, sizeof addr.sun_path, "%s", path);
  if (::connect(fd, reinterpret_cast<sockaddr*>(&addr), sizeof addr) != 0) {
    ::close(fd);
    return -1;
  }
  return fd;
}

inline int listen_unix(const char* path, int backlog = 8) {
  ::unlink(path);
  int fd = ::socket(AF_UNIX, SOCK_STREAM, 0);
  if (fd < 0) return -1;
  sockaddr_un addr{};
  addr.sun_family = AF_UNIX;
  std::snprintf(addr.sun_path, sizeof addr.sun_path, "%s", path);
  if (::bind(fd, reinterpret_cast<sockaddr*>(&addr), sizeof addr) != 0 ||
      ::listen(fd, backlog) != 0) {
    ::close(fd);
    return -1;
  }
  return fd;
}

// ---------------- minimal .npy v1/v2 reader + writer (C order only) ------

inline bool parse_npy(const std::string& path, Tensor* t) {
  FILE* f = std::fopen(path.c_str(), "rb");
  if (!f) return false;
  uint8_t magic[8];
  if (std::fread(magic, 1, 8, f) != 8 || std::memcmp(magic, "\x93NUMPY", 6)) {
    std::fclose(f);
    return false;
  }
  uint32_t hlen = 0;
  if (magic[6] == 1) {
    uint16_t h;
    if (std::fread(&h, 2, 1, f) != 1) { std::fclose(f); return false; }
    hlen = h;
  } else {
    if (std::fread(&hlen, 4, 1, f) != 1) { std::fclose(f); return false; }
  }
  std::string hdr(hlen, '\0');
  if (std::fread(hdr.data(), 1, hlen, f) != hlen) { std::fclose(f); return false; }
  if (hdr.find("'fortran_order': True") != std::string::npos) {
    std::fclose(f);
    return false;
  }
  size_t dp = hdr.find("'descr':");
  if (dp == std::string::npos) { std::fclose(f); return false; }
  size_t q1 = hdr.find('\'', dp + 8);
  size_t q2 = q1 == std::string::npos ? q1 : hdr.find('\'', q1 + 1);
  // truncated/malformed headers must return false like every other bad-file
  // path here, not throw out_of_range from substr
  if (q2 == std::string::npos) { std::fclose(f); return false; }
  std::string descr = hdr.substr(q1 + 1, q2 - q1 - 1);
  struct { const char* d; uint8_t c; } map[] = {
      {"<f4", 0}, {"<f8", 1}, {"<i4", 2}, {"<i8", 3}, {"|u1", 4},
      {"|b1", 6}, {"<f2", 7}, {"<V2", 5}};
  t->dtype = 255;
  for (auto& m : map)
    if (descr == m.d) t->dtype = m.c;
  if (t->dtype == 255) { std::fclose(f); return false; }
  size_t sp = hdr.find("'shape':");
  if (sp == std::string::npos) { std::fclose(f); return false; }
  size_t p1 = hdr.find('(', sp);
  size_t p2 = p1 == std::string::npos ? p1 : hdr.find(')', p1);
  if (p2 == std::string::npos) { std::fclose(f); return false; }
  std::string shape = hdr.substr(p1 + 1, p2 - p1 - 1);
  t->dims.clear();
  const char* s = shape.c_str();
  while (*s) {
    while (*s == ' ' || *s == ',') ++s;
    if (!*s) break;
    t->dims.push_back(std::strtoull(s, const_cast<char**>(&s), 10));
  }
  uint64_t n = 1;
  for (auto d : t->dims) n *= d;
  t->data.resize(n * dtype_size(t->dtype));
  bool ok = t->data.empty() ||
            std::fread(t->data.data(), 1, t->data.size(), f) == t->data.size();
  std::fclose(f);
  return ok;
}

inline bool write_npy(const std::string& path, const Tensor& t) {
  const char* descr = nullptr;
  switch (t.dtype) {
    case 0: descr = "<f4"; break;
    case 1: descr = "<f8"; break;
    case 2: descr = "<i4"; break;
    case 3: descr = "<i8"; break;
    case 4: descr = "|u1"; break;
    case 6: descr = "|b1"; break;
    case 7: descr = "<f2"; break;
    case 5: descr = "<V2"; break;  // bf16 as raw 2-byte void
    default: return false;
  }
  std::string shape = "(";
  for (size_t i = 0; i < t.dims.size(); ++i) {
    shape += std::to_string(t.dims[i]);
    if (t.dims.size() == 1 || i + 1 < t.dims.size()) shape += ",";
    if (i + 1 < t.dims.size()) shape += " ";
  }
  shape += ")";
  std::string hdr = std::string("{'descr': '") + descr +
                    "', 'fortran_order': False, 'shape': " + shape + ", }";
  size_t total = 10 + hdr.size() + 1;
  hdr += std::string(((total + 63) / 64) * 64 - total, ' ');
  hdr += '\n';
  FILE* f = std::fopen(path.c_str(), "wb");
  if (!f) return false;
  uint16_t hlen = static_cast<uint16_t>(hdr.size());
  std::fwrite("\x93NUMPY\x01\x00", 1, 8, f);
  std::fwrite(&hlen, 2, 1, f);
  std::fwrite(hdr.data(), 1, hdr.size(), f);
  std::fwrite(t.data.data(), 1, t.data.size(), f);
  std::fclose(f);
  return true;
}

}  // namespace veon_frame

#endif  // VEON_NATIVE_FRAME_H_
