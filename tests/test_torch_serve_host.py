"""The port's C++ daemon (`veon_tpu_torch/csrc/host/serve_host.cpp`) in its
echo build with no libtorch (-DVEON_NO_TORCH, `ops/native.py`
`build_host("veon_serve_host_echo")`), driven as the JAX package's
`tests/test_serve_host.py` drives its own: every protocol dtype through
the port's `TensorClient` byte for byte, the JAX package's dependency-free
C++ client (`veon_tpu/native/serve_client.cpp`, compiled unchanged), a
client gone mid-send, malformed frames, concurrent clients, the usage
error and the echo build refusing a package. Skips where no C++ compiler
is installed."""

import os
import shutil
import socket as socket_mod
import struct
import subprocess
import time

import numpy as np
import pytest
import torch

from veon_tpu_torch.ops import native
from veon_tpu_torch.serve.client import TensorClient
from veon_tpu_torch.serve.protocol import send_frame

CLIENT_SRC = os.path.join(os.path.dirname(__file__), "..", "veon_tpu", "native",
                          "serve_client.cpp")


@pytest.fixture(scope="module")
def echo_host():
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no C++ compiler")
    return native.build_host("veon_serve_host_echo")["veon_serve_host_echo"]["path"]


def _wait_socket(path, proc, timeout=10.0):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if os.path.exists(path):
            return
        if proc.poll() is not None:
            raise AssertionError(f"server exited rc={proc.returncode}: "
                                 f"{proc.stderr.read().decode()}")
        time.sleep(0.05)
    raise AssertionError("server socket never appeared")


def _serve(echo_host, sock, once=False):
    proc = subprocess.Popen([echo_host, sock, "--echo"] + (["--once"] if once else []),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    _wait_socket(sock, proc)
    return proc


def _first(x):
    return float(np.asarray(x).reshape(-1)[0])


def test_echo_build_links_no_torch(echo_host):
    r = subprocess.run(["ldd", echo_host], capture_output=True, text=True, timeout=30)
    assert r.returncode == 0 and "libtorch" not in r.stdout and "libc10" not in r.stdout


def test_echo_host_roundtrip_all_dtypes(echo_host, tmp_path):
    """Every protocol dtype bit-exact (bf16 as a torch.bfloat16 tensor),
    server_ms along, two requests on one connection, and --once exits
    cleanly after the close."""
    sock = str(tmp_path / "host.sock")
    proc = _serve(echo_host, sock, once=True)
    try:
        arrays = {
            "f32": np.arange(6, dtype=np.float32).reshape(2, 3),
            "f64": np.arange(4, dtype=np.float64),
            "i32": np.arange(3, dtype=np.int32),
            "i64": np.arange(3, dtype=np.int64),
            "u8": np.arange(5, dtype=np.uint8),
            "bool": np.asarray([True, False]),
            "f16": np.arange(4, dtype=np.float16),
            "scalar": np.float32(3.5),
        }
        bf16 = torch.arange(4, dtype=torch.float32).to(torch.bfloat16) / 3
        with TensorClient(sock) as c:
            out = c.infer(bf16=bf16, **arrays)
            for k, v in arrays.items():
                # the wire format carries a 0-d array as (1,)
                got, want = out[k], np.ascontiguousarray(v).reshape(np.shape(v) or (1,))
                assert got.dtype == want.dtype and got.shape == want.shape, k
                np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8),
                                              err_msg=k)
            assert out["bf16"].dtype == torch.bfloat16
            assert torch.equal(out["bf16"].view(torch.int16), bf16.view(torch.int16))
            assert _first(out["server_ms"]) >= 0.0
            assert _first(c.infer(x=np.float32(1.0))["x"]) == 1.0
        assert proc.wait(timeout=10) == 0
    finally:
        if proc.poll() is None:
            proc.kill()


def test_echo_host_cpp_client(echo_host, tmp_path):
    """The JAX package's C++ client, compiled unchanged, against the
    port's daemon: a transport with no Python on either side."""
    exe = str(tmp_path / "veon_client")
    subprocess.run(["g++", "-O2", "-std=c++17", "-o", exe, os.path.abspath(CLIENT_SRC)],
                   check=True, capture_output=True, timeout=300)
    sock = str(tmp_path / "cc.sock")
    proc = _serve(echo_host, sock, once=True)
    try:
        x = np.random.default_rng(0).standard_normal((3, 4)).astype(np.float32)
        np.save(tmp_path / "x.npy", x)
        r = subprocess.run([exe, sock, f"x={tmp_path}/x.npy", "--out", f"{tmp_path}/r_"],
                           capture_output=True, text=True, timeout=120)
        assert r.returncode == 0, r.stderr
        np.testing.assert_array_equal(np.load(tmp_path / "r_x.npy"), x)
        assert os.path.exists(tmp_path / "r_server_ms.npy")
    finally:
        if proc.poll() is None:
            proc.kill()


def test_echo_host_survives_client_gone_midsend(echo_host, tmp_path):
    """A client gone before it reads a 16 MB response: the daemon's send
    fails with EPIPE (no SIGPIPE), it drops that connection and serves the
    next one."""
    sock = str(tmp_path / "gone.sock")
    proc = _serve(echo_host, sock)
    try:
        for _ in range(3):  # EPIPE against a buffered FIN: repeat the race
            s = socket_mod.socket(socket_mod.AF_UNIX, socket_mod.SOCK_STREAM)
            s.connect(sock)
            send_frame(s, {"big": np.zeros((4 << 20,), np.float32)})
            s.close()
        time.sleep(0.3)
        assert proc.poll() is None, proc.stderr.read().decode()
        with TensorClient(sock) as c:
            assert _first(c.infer(x=np.float32(7.0))["x"]) == 7.0
    finally:
        if proc.poll() is None:
            proc.kill()


def test_echo_host_rejects_bad_dtype_and_bogus_dims(echo_host, tmp_path):
    """An unknown dtype code or a multi-GB dims product closes that
    connection; the daemon stays up and answers a well-formed frame."""
    sock = str(tmp_path / "bad.sock")
    proc = _serve(echo_host, sock)
    try:
        frames = [
            struct.pack("<IHHI", 0x56454F4E, 1, 0, 1) + struct.pack("<H", 1) + b"x"
            + bytes([200, 1]) + struct.pack("<Q", 4),
            struct.pack("<IHHI", 0x56454F4E, 1, 0, 1) + struct.pack("<H", 1) + b"x"
            + bytes([0, 2]) + struct.pack("<QQ", 1 << 31, 1 << 31),
        ]
        for raw in frames:
            s = socket_mod.socket(socket_mod.AF_UNIX, socket_mod.SOCK_STREAM)
            s.connect(sock)
            s.sendall(raw)
            try:  # a clean FIN if the stream was consumed, else a reset
                assert s.recv(1) == b""
            except ConnectionResetError:
                pass
            s.close()
        assert proc.poll() is None, proc.stderr.read().decode()
        with TensorClient(sock) as c:
            assert _first(c.infer(x=np.float32(1.5))["x"]) == 1.5
    finally:
        if proc.poll() is None:
            proc.kill()


def test_echo_host_concurrent_clients(echo_host, tmp_path):
    """A second client is answered while the first holds its connection,
    and the first keeps working after the second leaves."""
    sock = str(tmp_path / "two.sock")
    proc = _serve(echo_host, sock)
    try:
        with TensorClient(sock) as c1:
            assert _first(c1.infer(x=np.float32(1.0))["x"]) == 1.0
            with TensorClient(sock) as c2:
                assert _first(c2.infer(x=np.float32(2.0))["x"]) == 2.0
            assert _first(c1.infer(x=np.float32(3.0))["x"]) == 3.0
    finally:
        if proc.poll() is None:
            proc.kill()


def test_echo_host_usage_error(echo_host, tmp_path):
    r = subprocess.run([echo_host], capture_output=True, text=True, timeout=30)
    assert r.returncode == 2 and "usage:" in r.stderr
    r = subprocess.run([echo_host, str(tmp_path / "p.sock"), "libveon_ops.so", "model.pt2",
                        "--order", "x"], capture_output=True, text=True, timeout=30)
    assert r.returncode == 2 and "only --echo is available" in r.stderr
