"""The native serving path on the CPU (`utils/export.py`
`export_native_bundle`, `csrc/veon_ops.cpp`, `csrc/host/`): the tiny F=1
bundle, compiled by AOTInductor once for the file, against JAX's
`export_tiny_native` bundle (request, outputs, the bound leaves' names and
values), served by the C++ runner and daemon with a class grid equal to
the live port module's and to JAX's tiny forward off near-ties; the op
library's CPU implementations bit-equal to the plain Python versions of
kernels #1-#3 with the Python ops' schemas (in a process that loads only
the library: both define veon::*); a CUDA package refused with rc 3 where
there is no card; a daemon stopped by SIGTERM removing its unpacked
package; the usage errors. Skips where no C++ compiler is installed."""

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import perturbed

from veon_tpu.cli.shapes import example_batch as j_example_batch
from veon_tpu.configs import presets as jpresets
from veon_tpu.model.veon import VeonModel as JModel
from veon_tpu.model.veon import fusion_rule as j_fusion_rule
from veon_tpu.nn import text as jtext
from veon_tpu.utils import export as j_export

from veon_tpu_torch.entry import ServingForward, _ov_weight, build_model
from veon_tpu_torch.ops import bev_pool, native
from veon_tpu_torch.serve.client import TensorClient
from veon_tpu_torch.utils import export as t_export

HOST = ("veon_ops", "veon_aoti_runner", "veon_serve_host")


@pytest.fixture(scope="module")
def host():
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no C++ compiler")
    native.build_host(*HOST)
    return {n: str(native.host_path(n)) for n in HOST}


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """JAX's tiny bundle, and JAX's tiny forward + merge + fusion rule on
    perturbed weights (LoRA folded, as the port serves) at a request of the
    bundle's inputs with random depth-tower frames."""
    jdir = j_export.export_tiny_native(str(tmp_path_factory.mktemp("jax") / "b"))
    cfg = jpresets.veon_tiny_test()
    cfg = dataclasses.replace(cfg, depth=dataclasses.replace(cfg.depth, use_lora=False))
    model = JModel(cfg=cfg)
    imgs, _depth, metas = j_example_batch(cfg, B=1)
    depth_imgs = np.random.default_rng(3).standard_normal(imgs.shape).astype(np.float32)
    prompts, refl = jtext.build_vocabulary(cfg.vocabulary)
    ovw = jnp.asarray(np.random.default_rng(0).standard_normal(
        (len(prompts) + 1, cfg.san.clip_embed_dim)).astype(np.float32))
    init = jax.jit(model.init, static_argnames=("train", "method"))
    variables = perturbed(init(jax.random.PRNGKey(1), imgs, depth_imgs, metas, ovw,
                               train=False, method=JModel.full_forward))
    out = jax.jit(model.apply, static_argnames=("train", "method"))(
        variables, imgs, depth_imgs, metas, ovw, train=False, method=JModel.full_forward)
    merged = np.asarray(jtext.merge_classes_max(out["sem_occ_raw"], jtext.merge_matrix(refl),
                                                axis=-1))
    b = np.asarray(out["bin_occ"])
    pred = np.asarray(j_fusion_rule(jnp.asarray(merged), jnp.asarray(b)))
    top2 = np.sort(merged, -1)[..., -2:]
    p0 = 1.0 / (1.0 + np.exp(b[..., 1] - b[..., 0]))
    clear = (((top2[..., 1] - top2[..., 0]) > 1e-3) & (np.abs(p0 - 0.5) > 1e-3))
    return dict(dir=jdir, variables=variables, request={
        "imgs": np.asarray(imgs), "depth_imgs": depth_imgs}, pred=pred,
        clear=clear.transpose(0, 3, 2, 1))


@pytest.fixture(scope="module")
def bundle(jax_side, tmp_path_factory):
    """The port's tiny bundle on JAX's weights, and its live module's grid
    on the request."""
    out = t_export.export_tiny_native(str(tmp_path_factory.mktemp("port") / "b"),
                                      device="cpu", variables=jax_side["variables"])
    cfg = t_export._serving_cfg("veon_tiny_test")
    ovw, membership = _ov_weight(cfg, torch.device("cpu"), seed=0)
    live = ServingForward(build_model(cfg, torch.device("cpu"), 0, jax_side["variables"]),
                          membership).eval()
    b = t_export.NativeBundle(out)
    flat = b.flat_inputs({k: torch.from_numpy(v) for k, v in jax_side["request"].items()},
                         "cpu")
    metas = dict(zip([n.split(".", 1)[1] for n in b.manifest["order"][2:-1]], flat[2:-1]))
    with torch.no_grad():
        want = live(flat[0], flat[1], metas, ovw)
    return b, want


def test_bundle_contract_matches_jax(bundle, jax_side):
    """request and outputs equal; the bound leaves are JAX's non-params
    binds, each file equal in value; in/out shapes as JAX prints them;
    weights inside the package, none bound."""
    b, _want = bundle
    man = b.manifest
    jman = json.load(open(os.path.join(jax_side["dir"], "manifest.json")))
    assert man["request"] == jman["request"] == ["imgs", "depth_imgs"]
    assert man["outputs"] == jman["outputs"] == ["pred"]
    assert "split_concat" not in man and "split_concat" not in jman
    jbinds = {n for n in jman["binds"] if not n.startswith("params.")}
    assert set(man["binds"]) == jbinds
    assert set(man["order"]) == jbinds | set(man["request"])
    for n in jbinds:
        got = np.load(os.path.join(b.dir, man["binds"][n]))
        want = np.load(os.path.join(jax_side["dir"], jman["binds"][n]))
        assert got.dtype == want.dtype, n
        np.testing.assert_array_equal(got, want, err_msg=n)
    jshapes = dict(zip(jman["order"], jman["in_shapes"]))
    assert [jshapes[n] for n in man["order"]] == man["in_shapes"]
    assert man["out_shapes"] == jman["out_shapes"] == ["int32[1,20,20,4]"]
    assert man["device"] == "cpu" and os.path.getsize(b.package) > 10**6
    assert man["serve_cmd"].startswith("veon_serve_host <socket> libveon_ops.so model.pt2 "
                                       "--order imgs,depth_imgs,")


def test_write_npy_bf16_as_v2(tmp_path):
    """bf16 leaves as JAX writes them: '<V2' raw 2-byte words, read back
    by `read_npy` bit for bit."""
    x = torch.randn(3, 5).to(torch.bfloat16)
    p = str(tmp_path / "x.npy")
    t_export._write_npy(p, x)
    raw = np.load(p)
    assert raw.dtype.str == "|V2" and raw.shape == (3, 5)
    np.testing.assert_array_equal(raw.view(np.int16), x.view(torch.int16).numpy())
    assert torch.equal(t_export.read_npy(p), x)
    import ml_dtypes

    j_export._write_npy(str(tmp_path / "j.npy"),
                        x.float().numpy().astype(ml_dtypes.bfloat16))
    assert open(tmp_path / "j.npy", "rb").read() == open(p, "rb").read()


def test_runner_grid_equals_live_and_jax(bundle, jax_side, host, tmp_path):
    """The one-shot runner on the flat inputs: the grid equals the live
    module's (torch.equal) and JAX's off near-ties; no kernel launch on the
    CPU."""
    b, want = bundle
    flat = b.flat_inputs({k: torch.from_numpy(v) for k, v in jax_side["request"].items()},
                         "cpu")
    paths = []
    for i, t in enumerate(flat):
        paths.append(str(tmp_path / f"in{i}.npy"))
        t_export._write_npy(paths[-1], t)
    r = subprocess.run(b.runner_argv(paths, str(tmp_path / "out_")), capture_output=True,
                       text=True, timeout=180)
    assert r.returncode == 0, r.stderr
    assert "package device: cpu" in r.stdout and "op library: cpu" in r.stdout
    assert "launches bev_pool_pooled=0 bev_pool_sorted=0 bev_pool_sorted2=0" in r.stdout
    got = np.load(tmp_path / "out_0.npy")
    assert torch.equal(torch.from_numpy(got), want)
    clear = jax_side["clear"]
    assert clear.mean() >= 0.99, clear.mean()
    np.testing.assert_array_equal(got[clear], jax_side["pred"][clear])
    assert 0.05 < (got != 17).mean() < 0.95  # both branches of the rule occur


def _wait_socket(path, proc, timeout=60.0):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if os.path.exists(path):
            return
        if proc.poll() is not None:
            raise AssertionError(f"daemon exited rc={proc.returncode}: "
                                 f"{proc.stderr.read().decode()}")
        time.sleep(0.05)
    raise AssertionError("daemon socket never appeared")


def test_daemon_serves_the_bundle(bundle, jax_side, host, tmp_path):
    """`veon_serve_host` with the bundle's binds: two requests on one
    connection give the live module's grid and server_ms; a request
    without depth_imgs gets an error frame and the daemon keeps serving;
    one printed line per served request."""
    b, want = bundle
    sock = str(tmp_path / "d.sock")
    proc = subprocess.Popen(b.daemon_argv(sock, once=True), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE)
    try:
        _wait_socket(sock, proc)
        with TensorClient(sock) as c:
            for _ in range(2):
                out = c.infer(**jax_side["request"])
                assert torch.equal(torch.from_numpy(out["pred"]), want)
                assert float(np.asarray(out["server_ms"]).reshape(-1)[0]) > 0
            with pytest.raises(RuntimeError, match="missing request tensor: depth_imgs"):
                c.infer(imgs=jax_side["request"]["imgs"])
            with pytest.raises(RuntimeError):  # a wrong shape, refused by the package
                c.infer(imgs=jax_side["request"]["imgs"][..., :100, :],
                        depth_imgs=jax_side["request"]["depth_imgs"])
            out = c.infer(**jax_side["request"])
            assert torch.equal(torch.from_numpy(out["pred"]), want)
        stdout, stderr = proc.communicate(timeout=30)
        assert proc.returncode == 0, stderr
        lines = [ln for ln in stdout.decode().splitlines() if ln.startswith("served request")]
        assert len(lines) == 3 and "bev_pool_pooled=0" in lines[-1], stdout
    finally:
        if proc.poll() is None:
            proc.kill()


def test_daemon_stops_cleanly_on_sigterm(bundle, jax_side, host, tmp_path):
    """SIGTERM ends a serving daemon with exit 0 after a request, and the
    loader's unpacked copy of the package in the temporary directory goes
    with it (a killed loader leaves the whole package there)."""
    b, want = bundle
    tmp = tmp_path / "tmpdir"
    tmp.mkdir()
    sock = str(tmp_path / "t.sock")
    proc = subprocess.Popen(b.daemon_argv(sock), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            env=dict(os.environ, TMPDIR=str(tmp)))
    try:
        _wait_socket(sock, proc)
        assert os.listdir(tmp)  # the unpacked package
        with TensorClient(sock) as c:
            assert torch.equal(torch.from_numpy(c.infer(**jax_side["request"])["pred"]), want)
        proc.terminate()
        assert proc.wait(timeout=60) == 0, proc.stderr.read()
        assert os.listdir(tmp) == []
    finally:
        if proc.poll() is None:
            proc.kill()


def _as_cuda_package(src, dst):
    """A copy of a package whose metadata names the CUDA device."""
    with zipfile.ZipFile(src) as zin, zipfile.ZipFile(dst, "w") as zout:
        for item in zin.infolist():
            data = zin.read(item.filename)
            if item.filename.endswith("_metadata.json"):
                meta = json.loads(data)
                meta["AOTI_DEVICE_KEY"] = "cuda"
                data = json.dumps(meta).encode()
            zout.writestr(item, data)


def test_probe_and_cuda_package_refused(bundle, host, tmp_path):
    """--probe on the CPU package: rc 0 with the device report. A package
    that needs CUDA on a host with none: rc 3 from the runner (probe or
    run) and the daemon, never a run on the CPU."""
    b, _want = bundle
    r = subprocess.run([host["veon_aoti_runner"], host["veon_ops"], b.package, "--probe"],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.splitlines()[:3] == ["package device: cpu", "cuda devices: 0",
                                         "op library: cpu"]
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cuda_pkg = str(tmp_path / "cuda.pt2")
    _as_cuda_package(b.package, cuda_pkg)
    for extra in (["--probe"], []):
        r = subprocess.run([host["veon_aoti_runner"], host["veon_ops"], cuda_pkg, *extra],
                           capture_output=True, text=True, timeout=120)
        assert r.returncode == 3, (r.stdout, r.stderr)
        assert "needs a CUDA device" in r.stderr
    r = subprocess.run([host["veon_serve_host"], str(tmp_path / "c.sock"), host["veon_ops"],
                        cuda_pkg, "--order", "imgs"], capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 3 and "needs a CUDA device" in r.stderr


def test_usage_errors(bundle, host, tmp_path):
    b, _want = bundle
    runner, ops, daemon = host["veon_aoti_runner"], host["veon_ops"], host["veon_serve_host"]
    sock = str(tmp_path / "u.sock")
    cases = [
        ([runner], 2, "usage:"),
        ([runner, ops, b.package, "--out"], 2, "--out needs a prefix"),
        ([runner, "/nonexistent/libveon_ops.so", b.package], 1, "cannot load op library"),
        ([runner, host["veon_serve_host"], b.package], 1, "cannot load op library"),
        ([daemon], 2, "usage:"),
        ([daemon, sock, ops], 2, "need <ops.so> <package.pt2>"),
        ([daemon, sock, ops, b.package], 2, "--order is required"),
        ([daemon, sock, ops, b.package, "--order", "imgs", "--bind", "imgs"], 2, "bad --bind"),
        ([daemon, sock, ops, b.package, "--order", "imgs", "--bind",
          f"ovw={os.path.join(b.dir, 'bind', 'ovw.npy')}"], 2, "not in --order"),
        ([daemon, sock, ops, b.package, "--order", "imgs", "--frobnicate"], 2,
         "unknown argument"),
    ]
    for argv, rc, msg in cases:
        r = subprocess.run(argv, capture_output=True, text=True, timeout=120)
        assert r.returncode == rc and msg in r.stderr, (argv, r.returncode, r.stderr)


_OPS_CHILD = r"""
import sys, numpy as np, torch
lib, d = sys.argv[1], sys.argv[2]
torch.ops.load_library(lib)
inp = dict(np.load(d + "/in.npz"))
t = {k: (torch.from_numpy(v).view(torch.bfloat16) if k.endswith("_bf16") else
         torch.from_numpy(v)) for k, v in inp.items()}
out = {}
for dt in ("f32", "bf16"):
    s = "_" + dt
    out["pooled" + s] = torch.ops.veon.bev_pool_pooled(
        t["depth" + s], t["feat" + s], t["order"], t["rk"], 512, 8)
    out["sorted" + s] = torch.ops.veon.bev_pool_sorted(t["vals1" + s], t["rk1"], 512)
    out["sorted2" + s] = torch.ops.veon.bev_pool_sorted2(
        t["vals1" + s], t["rk1"], t["vals2" + s], t["rk2"], 512)
np.savez(d + "/out.npz", **{k: (v.view(torch.int16) if v.dtype == torch.bfloat16 else v).numpy()
                            for k, v in out.items()})
schemas = {n: str(getattr(torch.ops.veon, n).default._schema)
           for n in ("bev_pool_pooled", "bev_pool_sorted", "bev_pool_sorted2")}
try:
    torch.ops.veon.bev_pool_sorted.default.redispatch(
        torch._C.DispatchKeySet(torch._C.DispatchKey.CUDA), t["vals1_f32"], t["rk1"], 512)
    cuda = "ran"
except RuntimeError as e:
    cuda = str(e)
print(repr((schemas, cuda)))
"""


def test_veon_ops_cpu_bit_equal_plain_and_schemas(host, tmp_path):
    """The library's CPU ops on random streams (ranks past the grid
    included, unsorted pixel order for #1) give the plain Python versions'
    bits in fp32 and bf16; its schemas are the Python ops'; its CUDA entry
    in a CPU-only build raises rather than run the plain version."""
    rng = np.random.default_rng(0)
    B, N, D, h, w, C = 1, 2, 8, 3, 5, 24
    P = B * N * D * h * w
    order = rng.permutation(P)[: P - 13].astype(np.int32)
    rk = np.sort(rng.integers(0, 560, size=order.shape)).astype(np.int32)  # >= 512: overflow
    depth = rng.random((B, N, D, h, w)).astype(np.float32)
    feat = rng.standard_normal((B, N, h, w, C)).astype(np.float32)
    vals1 = rng.standard_normal((300, C)).astype(np.float32)
    rk1 = np.sort(rng.integers(0, 530, size=300)).astype(np.int32)
    vals2 = rng.standard_normal((170, C)).astype(np.float32)
    rk2 = np.sort(rng.integers(0, 512, size=170)).astype(np.int32)
    inp = {"order": order, "rk": rk, "rk1": rk1, "rk2": rk2}
    ts = {}
    for dt, tdt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        for k, v in (("depth", depth), ("feat", feat), ("vals1", vals1), ("vals2", vals2)):
            x = torch.from_numpy(v).to(tdt)
            ts[f"{k}_{dt}"] = x
            inp[f"{k}_{dt}"] = x.view(torch.int16).numpy() if dt == "bf16" else x.numpy()
    np.savez(tmp_path / "in.npz", **inp)
    r = subprocess.run([sys.executable, "-c", _OPS_CHILD, host["veon_ops"], str(tmp_path)],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    schemas, cuda = eval(r.stdout.strip().splitlines()[-1])
    got = dict(np.load(tmp_path / "out.npz"))
    o, k, k1, k2 = (torch.from_numpy(inp[n]) for n in ("order", "rk", "rk1", "rk2"))
    for dt, tdt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        want = {
            "pooled": bev_pool.bev_pool_pooled_plain(
                bev_pool.presorted_vals(ts[f"depth_{dt}"], ts[f"feat_{dt}"], o), k, 512, 8,
                tdt),
            "sorted": bev_pool.bev_pool_sorted_plain([(ts[f"vals1_{dt}"], k1)], 512, tdt),
            "sorted2": bev_pool.bev_pool_sorted_plain(
                [(ts[f"vals1_{dt}"], k1), (ts[f"vals2_{dt}"], k2)], 512, tdt)}
        for name, w in want.items():
            g = got[f"{name}_{dt}"]
            w = w.view(torch.int16).numpy() if tdt == torch.bfloat16 else w.numpy()
            assert g.shape == w.shape and np.array_equal(g, w), (name, dt)
    for name in ("bev_pool_pooled", "bev_pool_sorted", "bev_pool_sorted2"):
        assert schemas[name] == str(getattr(torch.ops.veon, name).default._schema)
    assert "built without CUDA" in cuda, cuda
