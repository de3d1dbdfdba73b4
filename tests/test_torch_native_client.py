"""The JAX package's dependency-free C++ client
(`veon_tpu/native/serve_client.cpp`, compiled unchanged, as
`tests/test_serve.py` compiles it) against the port's `TensorServer`:
every dtype the client reads from .npy echoed byte for byte (not bf16:
numpy writes a 2-byte void as '|V2', which the client does not parse;
`test_torch_serve.py` holds bf16 frames byte-equal), the port's tiny F=1
serving handler answering a request with text tokens byte-equal to the
port's own `TensorClient` and to the direct handler call, and an error
frame turned into the client's non-zero exit.
Skips where no C++ compiler is installed."""

import os
import shutil
import subprocess

import numpy as np
import pytest

import test_torch_common  # noqa: F401  (one CPU thread)

from veon_tpu_torch.cli.shapes import example_batch_full
from veon_tpu_torch.configs import presets
from veon_tpu_torch.entry import serve_entry
from veon_tpu_torch.nn.text import ClipTokenizer
from veon_tpu_torch.serve.client import TensorClient
from veon_tpu_torch.serve.server import TensorServer

SOURCE = os.path.join(os.path.dirname(__file__), "..", "veon_tpu", "native", "serve_client.cpp")


@pytest.fixture(scope="module")
def client_exe(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler")
    exe = str(tmp_path_factory.mktemp("cxx") / "veon_client")
    subprocess.run([cxx, "-O2", "-o", exe, os.path.abspath(SOURCE)], check=True,
                   capture_output=True, timeout=120)
    return exe


def _call(exe, sock, req, d):
    """Run the C++ client on `req` ({name: array}): (exit code, stderr,
    {name: response array})."""
    os.makedirs(d, exist_ok=True)
    args = [exe, sock]
    for k, v in req.items():
        path = os.path.join(d, f"req_{k}.npy")
        np.save(path, v)
        args.append(f"{k}={path}")
    r = subprocess.run(args + ["--out", os.path.join(d, "resp_")], capture_output=True,
                       text=True, timeout=120)
    out = {f[len("resp_"):-len(".npy")]: np.load(os.path.join(d, f))
           for f in os.listdir(d) if f.startswith("resp_")}
    return r.returncode, r.stderr, out


def _serving(handler, required, exclusive, path):
    srv = TensorServer(handler, path, required=required, exclusive=exclusive)
    srv.start()
    return srv


def test_cpp_client_echo_every_dtype(client_exe, tmp_path):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 3)) * 40
    req = {"f32": x.astype(np.float32), "f64": x, "i32": x.astype(np.int32),
           "i64": x.astype(np.int64), "u8": np.abs(x).astype(np.uint8), "b": x > 0,
           "f16": x.astype(np.float16)}
    srv = _serving(lambda **r: dict(r), ("f32",), False, str(tmp_path / "e.sock"))
    try:
        rc, err, out = _call(client_exe, srv.socket_path, req, str(tmp_path))
    finally:
        srv.stop()
    assert rc == 0, err
    assert set(out) == set(req) | {"server_ms"}
    for k, v in req.items():
        assert out[k].dtype == v.dtype and out[k].shape == v.shape, k
        assert out[k].tobytes() == v.tobytes(), k
    assert out["server_ms"].dtype == np.float32 and out["server_ms"][0] >= 0


def test_cpp_client_gets_the_served_answer_byte_equal(client_exe, tmp_path):
    cfg = presets.veon_tiny_test()
    handler, required, _expect, exclusive = serve_entry(cfg, device="cpu", seed=2)
    imgs, depth_imgs, _ = example_batch_full(cfg, device="cpu")
    req = {"imgs": imgs.numpy(), "depth_imgs": depth_imgs.numpy(),
           "text_tokens": ClipTokenizer().tokenize(["a parked red car"])}
    srv = _serving(handler, required, exclusive, str(tmp_path / "f.sock"))
    try:
        rc, err, out = _call(client_exe, srv.socket_path, req, str(tmp_path))
        with TensorClient(srv.socket_path) as c:
            py = c.infer(**req)
        rc_bad, err_bad, _ = _call(client_exe, srv.socket_path, {"imgs": req["imgs"]},
                                   str(tmp_path / "bad"))
    finally:
        srv.stop()
    assert rc == 0, err
    direct = handler(**req)
    for k in ("pred", "retrieval"):
        assert out[k].dtype == py[k].dtype == direct[k].dtype, k
        assert out[k].shape == py[k].shape == direct[k].shape, k
        assert out[k].tobytes() == py[k].tobytes() == direct[k].tobytes(), k
    assert out["pred"].dtype == np.uint8 and (out["pred"] != 17).any()
    assert rc_bad == 1 and "missing tensors" in err_bad
