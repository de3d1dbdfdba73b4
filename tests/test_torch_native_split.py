"""`export --native --split-output 2` on the CPU: the tiny bundle whose
class grid comes back as two chunks along X, written by the port's CLI
(AOTInductor compiles once for the file), against JAX's
`export_tiny_native(split_output=2)` (request, outputs, split_concat,
shapes, the bound leaves' names and values), and served by the C++ daemon
with the chunks joined back equal to the live port module's grid. Skips
where no C++ compiler is installed."""

import json
import os
import shutil
import subprocess
import time

import numpy as np
import pytest
import torch

import test_torch_common  # noqa: F401  (one CPU thread)

from veon_tpu.utils import export as j_export

from veon_tpu_torch.cli import main as cli
from veon_tpu_torch.cli.shapes import example_batch
from veon_tpu_torch.entry import ServingForward, _ov_weight, build_model
from veon_tpu_torch.ops import native
from veon_tpu_torch.serve.client import TensorClient
from veon_tpu_torch.utils import export as t_export


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no C++ compiler")
    native.build_host("veon_ops", "veon_serve_host")
    jdir = j_export.export_tiny_native(str(tmp_path_factory.mktemp("jax") / "b"),
                                       split_output=2)
    work = tmp_path_factory.mktemp("port")
    out = cli.main(["export", "--native", "--preset", "veon_tiny_test", "--device", "cpu",
                    "--split-output", "2", "--work-dir", str(work)])
    assert out == str(work / "veon_native")
    return t_export.NativeBundle(out), json.load(open(os.path.join(jdir, "manifest.json"))), jdir


def test_split_contract_matches_jax(bundles):
    b, jman, jdir = bundles
    man = b.manifest
    assert man["request"] == jman["request"] == ["imgs", "depth_imgs"]
    assert man["outputs"] == jman["outputs"] == ["pred.0", "pred.1"]
    assert man["split_concat"] == jman["split_concat"] == {"axis": 1, "parts": 2, "name": "pred"}
    assert man["out_shapes"] == jman["out_shapes"] == ["int32[1,10,20,4]"] * 2
    binds = {n for n in jman["binds"] if not n.startswith("params.")}
    assert set(man["binds"]) == binds
    for n in binds:
        np.testing.assert_array_equal(np.load(os.path.join(b.dir, man["binds"][n])),
                                      np.load(os.path.join(jdir, jman["binds"][n])), err_msg=n)
    assert man["serve_cmd"].endswith("--out pred.0,pred.1")


def test_split_rule_refuses_a_ragged_split():
    fwd = t_export.SplitPred(torch.nn.Identity(), 3)
    with pytest.raises(ValueError, match="does not split into 3 parts"):
        fwd(torch.zeros(1, 20, 20, 4))
    assert [t.shape[1] for t in t_export.SplitPred(torch.nn.Identity(), 4)(
        torch.zeros(1, 20, 20, 4))] == [5] * 4


def test_daemon_serves_split_chunks(bundles, tmp_path):
    """Two chunks per response, joined on axis 1 (`concat_split`) equal to
    the live module's grid on the CLI's seeded weights."""
    b, _jman, _jdir = bundles
    dev = torch.device("cpu")
    cfg = t_export._serving_cfg("veon_tiny_test")
    imgs, _depth, metas = example_batch(cfg, B=1, device=dev)
    ovw, membership = _ov_weight(cfg, dev, seed=0)
    depth_imgs = torch.from_numpy(
        np.random.default_rng(5).standard_normal(imgs.shape).astype(np.float32))
    with torch.no_grad():
        want = ServingForward(build_model(cfg, dev, 0, None), membership).eval()(
            imgs, depth_imgs, metas, ovw)
    sock = str(tmp_path / "s.sock")
    proc = subprocess.Popen(b.daemon_argv(sock, once=True), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE)
    try:
        t0 = time.monotonic()
        while not os.path.exists(sock):
            assert proc.poll() is None, proc.stderr.read().decode()
            assert time.monotonic() - t0 < 60
            time.sleep(0.05)
        with TensorClient(sock) as c:
            resp = c.infer(imgs=imgs.numpy(), depth_imgs=depth_imgs.numpy())
        assert [resp[f"pred.{i}"].shape for i in range(2)] == [(1, 10, 20, 4)] * 2
        got = b.concat_split(resp)
        assert set(got) == {"pred", "server_ms"}
        assert torch.equal(torch.from_numpy(got["pred"]), want)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
