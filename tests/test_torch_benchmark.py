"""The port's serving benchmarks and the `export` command on the CPU at the
tiny preset: `benchmark --artifact` on a saved program with float and
integer inputs (as `tests/test_export.py` test_benchmark_artifact_tiny),
`utils/bench_model.py` `measure` and `benchmark --num-temporal 2`, each
printing the JAX tool's metric name, and `export` through the CLI: the F=1
`.pt2`, the streaming step with `--raw-uint8` against the float step on the
host-normalized frames, and the refusals. A CPU run times the CPU's plain
versions: these tests check names, shapes and flow, not speeds."""

import argparse
import json
import os

import numpy as np
import pytest
import torch

from veon_tpu_torch.cli import main as cli
from veon_tpu_torch.data.transforms import NORMALIZERS
from veon_tpu_torch.utils import bench_model
from veon_tpu_torch.utils import export as t_export

TINY = "veon_tiny_test"


class _Tiny(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.from_numpy(
            np.random.default_rng(0).standard_normal((6, 4)).astype(np.float32)))

    def forward(self, x, n):
        return {"y": torch.tanh(x @ self.w) + n.float().sum(),
                "cls": x.argmax(-1).to(torch.uint8)}


def test_benchmark_artifact_tiny(tmp_path):
    """A saved program is loaded without its module's code and timed on its
    saved example inputs, the float one perturbed per call, the integer one
    kept: JAX's metric name, a positive rate, the inputs counted."""
    x = torch.ones(3, 6)
    n = torch.tensor([2, 3], dtype=torch.int32)
    path = t_export.export_inference(_Tiny(), (x, n), str(tmp_path / "tiny.pt2"))
    out = cli._benchmark_artifact(argparse.Namespace(artifact=path), n_iters=2, outer=1)
    assert out["metric"] == "tiny_artifact_frames_per_sec"
    assert out["value"] > 0 and out["detail"]["n_inputs"] == 2
    calls = bench_model.perturbed((x, n), 3, (0,))
    assert torch.equal(calls[0][0], x) and torch.equal(calls[-1][0], x + 1e-3)
    assert all(c[1] is n for c in calls)


def test_measure_prints_the_jax_metric(capsys):
    line = bench_model.main(["--preset", TINY, "--dtype", "float32", "--iters", "2",
                             "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == line
    assert line["metric"] == "veon_tiny_test_6cam_frames_per_sec_per_chip"
    assert line["unit"] == "frames/s" and line["value"] > 0
    assert {"ms_per_frame", "first_call_s", "iters", "dtype", "presorted"} <= set(line["detail"])


@pytest.mark.parametrize("argv,metric", [
    ([], "veon_tiny_test_6cam_frames_per_sec_per_chip"),
    (["--num-temporal", "2"], "veon_tiny_test_streaming_t2_frames_per_sec")])
def test_benchmark_cli_live_and_streaming(monkeypatch, capsys, argv, metric):
    """`benchmark` without --eval: the live F=1 graph and the streaming step
    whose early_vox rolls into the next call's cache, in the dtype
    VEON_ENTRY_DTYPE names."""
    monkeypatch.setenv("VEON_ENTRY_DTYPE", "float32")
    line = cli.main(["benchmark", "--preset", TINY, "--device", "cpu"] + argv)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == line
    assert line["metric"] == metric and line["value"] > 0
    assert line["detail"]["iters"] == cli.BENCH_ITERS


def test_export_cli_f1_and_refusals(tmp_path, capsys):
    """`export` writes <work-dir>/veon_infer.pt2 (bf16, the flagship's
    dtype) that `benchmark --artifact` times; `--raw-uint8` at F=1 is
    refused, and so is `--native` at F=1 for a preset other than veon_b and
    the tiny smoke preset (JAX's rule: the F=1 bundle is the flagship's
    graph), before anything is built."""
    base = ["export", "--preset", TINY, "--device", "cpu", "--work-dir", str(tmp_path)]
    with pytest.raises(SystemExit, match="needs --num-temporal > 1"):
        cli.main(base + ["--raw-uint8"])
    with pytest.raises(SystemExit, match="veon_b flagship graph only .or veon_tiny_test"):
        cli.main(["export", "--preset", "veon_b_fast", "--device", "cpu", "--work-dir",
                  str(tmp_path), "--native"])
    assert not os.path.exists(tmp_path / "veon_native")
    path = cli.main(base)
    assert path == str(tmp_path / "veon_infer.pt2")
    args = t_export.load_program(path).example_inputs[0]
    assert args[0].dtype == torch.float32  # frames stay fp32; the graph casts them
    line = cli.main(["benchmark", "--device", "cpu", "--artifact", path])
    assert line["metric"] == "veon_infer_artifact_frames_per_sec" and line["value"] > 0


def test_export_cli_raw_uint8_equals_float_step(tmp_path):
    """`export --num-temporal 2 --raw-uint8` freezes a step of raw uint8
    frames that equals the float step on the host-normalized frames, early
    voxels included (the in-graph normalizers are the host ones' bit-exact
    twins)."""
    path = cli.main(["export", "--preset", TINY, "--device", "cpu", "--work-dir",
                     str(tmp_path), "--num-temporal", "2", "--raw-uint8"])
    assert path == str(tmp_path / "veon_infer_t2.pt2")
    program = t_export.load_program(path)
    imgs, depth_imgs, m1, ovw, pv, pl, te = program.example_inputs[0]
    assert imgs.dtype == torch.uint8 and depth_imgs.dtype == torch.uint8
    out = program.module()(imgs, depth_imgs, m1, ovw, pv, pl, te)
    step, _ = t_export._build_streaming(TINY, 2, device="cpu")
    depth_m = step.model.cfg.data.depth_norm_method
    with torch.no_grad():
        want = step(torch.from_numpy(NORMALIZERS["clipsan"](imgs.numpy())),
                    torch.from_numpy(NORMALIZERS[depth_m](depth_imgs.numpy())),
                    m1, ovw, pv, pl, te)
    assert out["pred"].dtype == torch.uint8 and set(out) == set(want)
    for k in want:
        torch.testing.assert_close(out[k], want[k], rtol=0, atol=0, msg=k)
