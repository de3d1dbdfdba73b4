"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked `cuda`: skips without a card. On the machine with the card
(which has no JAX) run it without the JAX conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from veon_tpu_torch.ops import bev_pool as bp

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the kernels have no CPU or interpret mode)")
    return torch.device("cuda")


def _stream(card, P, C, num_cells, dtype, seed=0):
    """Sorted ranks with empty cells and overflow rows."""
    rng = np.random.default_rng(seed)
    rk = np.sort(rng.integers(0, num_cells + num_cells // 8, P)).astype(np.int32)
    vals = torch.from_numpy(rng.standard_normal((P, C)).astype(np.float32))
    return vals.to(card, dtype), torch.from_numpy(rk).to(card)


def _pooled_case(card, C, dtype, seed=0, num_coarse=600, pool_r=8):
    """Kernel #1's inputs: two-hot-like weights as the sliced softmax view
    `two_hot_depth` makes (pixel stride D + 1, bin stride 1), features, and
    the coarse-major sorted point stream. Every pixel's bins land in runs of
    one cell (several points of a pixel in one cell), a third of the points
    crowd into three coarse cells (cells of hundreds of rows, the shape of
    the cells next to the cameras), a quarter overflow, and many fine and
    coarse cells stay empty."""
    rng = np.random.default_rng(seed)
    B, N, D, h, w = 1, 3, 16, 8, 12
    num_cells = num_coarse * pool_r
    logits = rng.standard_normal((B, N, h, w, D + 1)).astype(np.float32)
    depth = torch.softmax(torch.from_numpy(logits), -1)[..., :D].movedim(-1, 2)
    feat = torch.from_numpy(rng.standard_normal((B, N, h, w, C)).astype(np.float32))
    P = B * N * h * w * D
    ranks = np.repeat(rng.integers(0, num_cells, P // 4), 4)  # runs of 4 bins per cell
    crowd = rng.random(P) < 0.3
    ranks[crowd] = rng.integers(0, 3, crowd.sum()) * pool_r * 7 + rng.integers(0, pool_r, crowd.sum())
    ranks[rng.random(P) < 0.25] = num_cells + 5  # overflow
    order = np.argsort(ranks, kind="stable")
    n_valid = int((ranks < num_cells).sum())
    order = order[:min(-(-n_valid // 256) * 256, P)]
    rk = torch.from_numpy(ranks[order].astype(np.int32)).to(card)
    order = torch.from_numpy(order.astype(np.int32)).to(card)
    return depth.to(card, dtype), feat.to(card, dtype), order, rk, num_cells


def _assert_pooled_close(got, vals, rk, num_cells, pool_r, dtype):
    """fp32: 1e-5 of the plain version (sums in another order). bf16: within
    one bf16 ulp (at the larger magnitude) of the fp32 sum of the same bf16
    products, on top of the fp32 tolerance."""
    ref32 = bp.bev_pool_pooled_plain(vals, rk, num_cells, pool_r, torch.float32)
    if dtype == torch.float32:
        torch.testing.assert_close(got, ref32, rtol=1e-5, atol=1e-5)
        return
    big = torch.maximum(got.float().abs(), ref32.abs()).clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(big)) - 7)
    over = (got.float() - ref32).abs() - (ulp + 1e-5 + 1e-5 * ref32.abs())
    assert over.max().item() <= 0, f"bf16 off by more than one ulp: {over.max().item()}"


# C=256: 16-byte vector loads (the flagship); C=12 fp32: 3 x float4;
# C=12 bf16: not a multiple of 8, the scalar-load instance
@pytest.mark.parametrize("C", [256, 12])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pool_kernel_matches_plain(card, C, dtype):
    """Kernel #1 (gather, weights, fine-cell sums, max) against its plain
    version on the card: empty fine and coarse cells, overflow rows, several
    points of a pixel in one cell, and cells long enough for the block's
    warps to share them."""
    depth, feat, order, rk, num_cells = _pooled_case(card, C, dtype)
    counts = torch.bincount(rk[rk < num_cells].long() // 8, minlength=num_cells // 8)
    assert counts.max() > 200 and (counts == 0).any()  # long and empty coarse cells
    before = bp.bev_pool_pooled.launches
    got = bp.bev_pool_pooled(depth, feat, order, rk, num_cells, 8)
    torch.cuda.synchronize()
    assert bp.bev_pool_pooled.launches == before + 1
    assert got.dtype == dtype and tuple(got.shape) == (num_cells // 8, C)
    _assert_pooled_close(got, bp.presorted_vals(depth, feat, order), rk, num_cells, 8, dtype)


def test_pool_kernel_reads_the_depth_view_in_place(card):
    """The sliced softmax view, its contiguous copy and a view whose strides
    no (pixel, bin) pair describes (the wrapper copies it) give one result,
    bit for bit."""
    depth, feat, order, rk, num_cells = _pooled_case(card, 256, torch.bfloat16, seed=3)
    assert not depth.is_contiguous()
    got = bp.bev_pool_pooled(depth, feat, order, rk, num_cells, 8)
    for other in (depth.contiguous(),
                  depth.transpose(3, 4).contiguous().transpose(3, 4)):
        torch.testing.assert_close(bp.bev_pool_pooled(other, feat, order, rk, num_cells, 8), got,
                                   rtol=0, atol=0)


def test_pool_kernel_rejects_what_it_does_not_take(card):
    depth, feat, order, rk, num_cells = _pooled_case(card, 16, torch.float32)
    with pytest.raises(TypeError):
        bp.bev_pool_pooled(depth.to(torch.bfloat16), feat, order, rk, num_cells, 8)
    with pytest.raises(ValueError):
        bp.bev_pool_pooled(depth, feat, order.long(), rk, num_cells, 8)
    with pytest.raises(ValueError):
        bp.bev_pool_pooled(depth, feat, order, rk.cpu(), num_cells, 8)


# kernels #2 (one stream) and #3 (two streams): C=256 is the flagship's
# 16-byte vector path, C=12 bf16 the scalar instance
@pytest.mark.parametrize("streams", [1, 2])
@pytest.mark.parametrize("C", [256, 12])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sorted_kernels_match_plain(card, streams, C, dtype):
    num_cells = 5000
    pairs = [_stream(card, n, C, num_cells, dtype, seed=s)
             for n, s in ((6000, 1), (9000, 2))[:streams]]
    kernel = bp.bev_pool_sorted if streams == 1 else bp.bev_pool_sorted2
    before = kernel.launches
    got = kernel(*[t for pair in pairs for t in pair], num_cells)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    want32 = bp.bev_pool_sorted_plain(pairs, num_cells, torch.float32)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want32, rtol=1e-5, atol=1e-5)
    else:  # fp32 sums in another order, then one bf16 rounding
        torch.testing.assert_close(got.float(), want32, rtol=2 ** -7, atol=1e-5)


def test_registered_ops_launch_the_kernels(card):
    """Called as registered operators (as a loaded `.pt2` program calls
    them), kernels #1-#3 launch and count, and equal the wrappers."""
    depth, feat, order, rk, num_cells = _pooled_case(card, 16, torch.float32)
    vals, rk2 = _stream(card, 6000, 16, 5000, torch.float32)
    cases = ((bp.bev_pool_pooled, torch.ops.veon.bev_pool_pooled, (depth, feat, order, rk,
                                                                   num_cells, 8)),
             (bp.bev_pool_sorted, torch.ops.veon.bev_pool_sorted, (vals, rk2, 5000)),
             (bp.bev_pool_sorted2, torch.ops.veon.bev_pool_sorted2, (vals, rk2, vals, rk2, 5000)))
    for wrapper, op, args in cases:
        before = wrapper.launches
        got = op(*args)
        torch.cuda.synchronize()
        assert wrapper.launches == before + 1
        torch.testing.assert_close(got, wrapper(*args), rtol=0, atol=0)


def test_sorted_kernel_rejects_what_it_does_not_take(card):
    vals, rk = _stream(card, 100, 16, 64, torch.float32)
    with pytest.raises(TypeError):
        bp.bev_pool_sorted2(vals, rk, vals.to(torch.bfloat16), rk, 64)
    with pytest.raises(ValueError):
        bp.bev_pool_sorted(vals, rk.long(), 64)
    with pytest.raises(ValueError):
        bp.bev_pool_sorted(vals.t().contiguous().t(), rk, 64)


def test_pooled_op_backward_on_card_matches_cpu(card):
    """bev_pool_presorted_pooled forward (kernel #1) and backward (kernel
    #2 recompute + group-max routing + gather adjoints) on the card vs the
    plain versions on the CPU, fp32, random ranks with empty fine cells."""
    rng = np.random.default_rng(5)
    grid_size, B, N, D, h, w, C = (8, 6, 4), 1, 2, 5, 3, 4, 16
    num_cells = B * 8 * 6 * 4
    ranks = rng.integers(0, num_cells + num_cells // 4, (B, N, D, h, w)).astype(np.int32)
    ranks = np.minimum(ranks, num_cells)
    ranks = bp.pooled_rank_remap(torch.from_numpy(ranks), grid_size, (2, 2, 2), num_cells)
    rk = ranks.permute(0, 1, 3, 4, 2).reshape(-1)
    order = torch.argsort(rk, stable=True).to(torch.int32)
    rk_sorted = rk[order.long()].contiguous()
    depth = torch.from_numpy(rng.random((B, N, D, h, w)).astype(np.float32))
    feat = torch.from_numpy(rng.standard_normal((B, N, h, w, C)).astype(np.float32))
    cot = torch.from_numpy(rng.standard_normal((B, 2, 3, 4, C)).astype(np.float32))
    res = {}
    for dev in ("cpu", card):
        d = depth.to(dev, copy=True).requires_grad_()
        f = feat.to(dev, copy=True).requires_grad_()
        out = bp.bev_pool_presorted_pooled(d, f, order.to(dev), rk_sorted.to(dev), ranks.to(dev),
                                           grid_size, (2, 2, 2))
        out.backward(cot.to(dev))
        res[str(dev)] = (out.detach().cpu(), d.grad.cpu(), f.grad.cpu())
    for got, want in zip(res[str(card)], res["cpu"]):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def _ln_inputs(card, M, C, N, dtype, seed=0):
    rng = np.random.default_rng(seed)
    arrays = ((2.0 * rng.standard_normal((M, C)) + 0.5), 1.0 + 0.1 * rng.standard_normal(C),
              0.1 * rng.standard_normal(C), rng.standard_normal((C, N)) / np.sqrt(C),
              0.1 * rng.standard_normal(N))
    x, s, sh, w, b = (torch.from_numpy(a.astype(np.float32)).to(card) for a in arrays)
    return x.to(dtype), s, sh, w.to(dtype), b


# kernel #4 at the CPU tests' shapes (M = 1500 ends in a partial row tile)
# and at the HSA qkv production shape, and at the edges of what it takes:
# one row, C = 128 and 1024, N = 128 and 1152, and the C where the tile
# shapes change (C = 512: the shortest ring of the 128-row bf16 tile; 640:
# 64-row tiles in both paths; 1024: 32-row fp32 tiles); fp32 at 1e-5 (sums
# in another order), bf16 at 2e-2 (the normalised row may round to the
# other bf16 neighbour)
@pytest.mark.parametrize("M,C,N,dtype", [
    (700, 128, 256, torch.float32), (1500, 384, 1152, torch.bfloat16),
    (67584, 384, 1152, torch.float32), (67584, 384, 1152, torch.bfloat16)] + [
    (M, C, N, dt) for M, C, N in ((1, 128, 128), (1, 1024, 1152), (1500, 128, 128),
                                  (1500, 1024, 1152), (513, 512, 384), (777, 640, 256))
    for dt in (torch.float32, torch.bfloat16)])
def test_ln_dense_kernel_matches_plain(card, M, C, N, dtype):
    from veon_tpu_torch.ops import fused_ln

    args = _ln_inputs(card, M, C, N, dtype)
    before = fused_ln.ln_dense.launches
    got = fused_ln.ln_dense(*args)
    torch.cuda.synchronize()
    assert fused_ln.ln_dense.launches == before + 1
    assert got.dtype == dtype and tuple(got.shape) == (M, N)
    want = fused_ln.ln_dense_plain(*args)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_ln_dense_rejects_what_it_does_not_take(card):
    from veon_tpu_torch.ops import fused_ln

    x, s, sh, w, b = _ln_inputs(card, 64, 128, 128, torch.float32)
    with pytest.raises(ValueError, match="multiples of 128"):
        fused_ln.ln_dense(x[:, :100], s[:100], sh[:100], w[:100], b)
    with pytest.raises(TypeError):
        fused_ln.ln_dense(x, s, sh, w.to(torch.bfloat16), b)
    with pytest.raises(ValueError, match="contiguous"):
        fused_ln.ln_dense(x.t().contiguous().t(), s, sh, w, b)
    x, s, sh, w, b = _ln_inputs(card, 4, 1152, 128, torch.float32)
    with pytest.raises(ValueError, match="C <= 1024"):
        fused_ln.ln_dense(x, s, sh, w, b)


def test_text_tower_on_card_matches_cpu(card):
    """The tiny text tower (fp32, TF32 off) on the card against the CPU,
    same seeded weights: unit-norm embeddings within 1e-5."""
    from veon_tpu_torch.configs import presets
    from veon_tpu_torch.entry import build_text_tower
    from veon_tpu_torch.nn.text import ClipTokenizer

    cfg = presets.veon_tiny_test()
    tokens = torch.from_numpy(ClipTokenizer().tokenize(
        ["a photo of a car.", "There is a large traffic cone in the scene", "", "x " * 90]))
    with torch.no_grad():
        want = build_text_tower(cfg, "cpu", seed=2)(tokens)
        got = build_text_tower(cfg, card, seed=2)(tokens.to(card))
    assert got.dtype == torch.float32
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-5)


def test_confusion_hist_on_card_matches_cpu(card):
    from veon_tpu_torch.eval import confusion_hist

    rng = np.random.default_rng(4)
    pred = torch.from_numpy(rng.integers(0, 18, (200, 200, 16)).astype(np.uint8))
    gt = torch.from_numpy(rng.integers(0, 18, (200, 200, 16)).astype(np.uint8))
    gt[torch.from_numpy(rng.random((200, 200, 16)) < 0.1)] = 255
    mask = torch.from_numpy((rng.random((200, 200, 16)) < 0.7).astype(np.uint8))
    got = confusion_hist(pred.to(card), gt.to(card), mask.to(card))
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), confusion_hist(pred, gt, mask))


def test_weights_drill_on_card_matches_cpu(card, tmp_path, capsys):
    """`selftest --weights-dir` on tiny reference-layout files: the card's
    first step lines equal to the CPU's and its mIoU within 1 point (a
    near-tie voxel may flip between summation orders), one lift-kernel
    launch in the forward (the tiny grid's band covers every bin: the
    one-stream kernel)."""
    from test_torch_mirror import write_weights_dir

    from veon_tpu_torch.cli.main import main
    from veon_tpu_torch.configs import presets

    write_weights_dir(presets.veon_tiny_test(), str(tmp_path))
    argv = ["selftest", "--preset", "veon_tiny_test", "--weights-dir", str(tmp_path)]
    want = main(argv + ["--device", "cpu"])
    cpu = capsys.readouterr().out
    fns = (bp.bev_pool_pooled, bp.bev_pool_sorted, bp.bev_pool_sorted2)
    for fn in fns:
        fn.launches = 0
    got = main(argv + ["--device", "cuda"])
    gpu = capsys.readouterr().out
    assert [fn.launches for fn in fns[1:]] in ([1, 0], [0, 1]) and fns[0].launches == 0
    lines = [ln for ln in gpu.splitlines() if ln.startswith("[")]
    assert len(lines) == 4 and lines[:3] == [ln for ln in cpu.splitlines() if ln.startswith("[")][:3]
    assert abs(got["miou"] - want["miou"]) <= 1.0


def test_normalize_in_graph_on_card_equals_host_normalizers(card):
    """Raw uint8 frames normalized on the card are bit-equal to the host
    normalizers, for every method: `test --raw-uint8` and raw-uint8
    serving rely on it (a Python-scalar /255 on the card multiplies by the
    reciprocal and moved voxels of a VEON-B grid)."""
    from veon_tpu_torch.data.transforms import NORMALIZERS, normalize_in_graph

    u8 = np.random.default_rng(0).integers(0, 256, size=(2, 64, 96, 3)).astype(np.uint8)
    for method, host in NORMALIZERS.items():
        got = normalize_in_graph(torch.from_numpy(u8).to(card), method).cpu().numpy()
        np.testing.assert_array_equal(got, host(u8), err_msg=method)


@pytest.mark.parametrize("num_shards", [2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sorted_kernel_on_a_shards_presorted_stream(card, num_shards, dtype):
    """Camera sharding's lift on the card: the stacked per-shard presort
    (`prepare_camshard_metas(presort=True)`) integer-equal to the CPU's;
    on each shard's stream, padded past its own rows with rank num_cells,
    kernel #2 (through `bev_pool_presorted`) against its plain version."""
    from veon_tpu_torch.cli.shapes import example_batch
    from veon_tpu_torch.configs import presets
    from veon_tpu_torch.lift.lss import two_hot_depth
    from veon_tpu_torch.model.camshard import prepare_camshard_metas

    cfg = presets.veon_tiny_test()
    want = prepare_camshard_metas(cfg, example_batch(cfg, device="cpu")[2], num_shards, True)
    got = prepare_camshard_metas(cfg, example_batch(cfg, device=card)[2], num_shards, True)
    for k in ("order", "rk_sorted", "ranks"):
        assert torch.equal(got["lift_sorted"][k].cpu(), want["lift_sorted"][k]), k
    ls = got["lift_sorted"]
    num_cells = int(np.prod(cfg.grid.size))
    B, N, D, h, w = ls["ranks"].shape
    nl = N // num_shards
    rng = np.random.default_rng(num_shards)
    feat = torch.from_numpy(rng.standard_normal((B, nl, h, w, 32)).astype(np.float32)).to(card,
                                                                                          dtype)
    metric = torch.from_numpy(rng.uniform(1.0, 44.0, (B, nl, h, w)).astype(np.float32))
    depth = two_hot_depth(metric, cfg.grid).to(card, dtype)
    for i in range(num_shards):
        order, rk = ls["order"][i], ls["rk_sorted"][i]
        assert (rk[int((rk < num_cells).sum()):] == num_cells).all()
        vals = bp.presorted_vals(depth, feat, order).contiguous()
        before = bp.bev_pool_sorted.launches
        out = bp.bev_pool_presorted(depth, feat, order, rk, ls["ranks"][:, i * nl:(i + 1) * nl],
                                    cfg.grid.size)
        torch.cuda.synchronize()
        assert bp.bev_pool_sorted.launches == before + 1
        want32 = bp.bev_pool_sorted_plain([(vals, rk)], num_cells, torch.float32)
        got32 = out.float().reshape(num_cells, -1)
        if dtype == torch.float32:
            torch.testing.assert_close(got32, want32, rtol=1e-5, atol=1e-5)
        else:
            torch.testing.assert_close(got32, want32, rtol=2 ** -7, atol=1e-5)


_CPP_OPS_CHILD = r"""
import sys, torch
lib, d = sys.argv[1], sys.argv[2]
torch.ops.load_library(lib)
t = {k: v.cuda() for k, v in torch.load(d + "/in.pt").items()}
ops = torch.ops.veon
out = [ops.bev_pool_pooled(t["depth"], t["feat"], t["order"], t["rk"], t["num_cells"].item(), 8),
       ops.bev_pool_sorted(t["v1"], t["r1"], t["cells"].item()),
       ops.bev_pool_sorted2(t["v1"], t["r1"], t["v2"], t["r2"], t["cells"].item())]
torch.cuda.synchronize()
import ctypes
n = ctypes.CDLL(lib)
n.veon_ops_launches.restype = ctypes.c_longlong
counts = [n.veon_ops_launches(s) for s in (b"bev_pool_pooled", b"bev_pool_sorted",
                                          b"bev_pool_sorted2")]
torch.save({"out": [o.cpu() for o in out], "counts": counts}, d + "/out.pt")
"""


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpp_ops_bit_equal_python_ops(card, tmp_path, dtype):
    """`veon_ops` (kernels #1-#3 registered in C++, loaded by a process of
    its own: this one holds the Python ops of the same names) launches the
    same kernels as the Python ops: bit-equal outputs, one launch each by
    its own counters."""
    import subprocess
    import sys

    from veon_tpu_torch.ops import native

    native.build_host("veon_ops")
    depth, feat, order, rk, num_cells = _pooled_case(card, 256, dtype)
    v1, r1 = _stream(card, 5000, 256, 4096, dtype, seed=1)
    v2, r2 = _stream(card, 3000, 256, 4096, dtype, seed=2)
    torch.save({"depth": depth.cpu(), "feat": feat.cpu(), "order": order.cpu(), "rk": rk.cpu(),
                "num_cells": torch.tensor(num_cells), "v1": v1.cpu(), "r1": r1.cpu(),
                "v2": v2.cpu(), "r2": r2.cpu(), "cells": torch.tensor(4096)},
               tmp_path / "in.pt")
    r = subprocess.run([sys.executable, "-c", _CPP_OPS_CHILD, str(native.host_path("veon_ops")),
                        str(tmp_path)], capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    got = torch.load(tmp_path / "out.pt")
    want = [bp.bev_pool_pooled(depth, feat, order, rk, num_cells, 8),
            bp.bev_pool_sorted(v1, r1, 4096), bp.bev_pool_sorted2(v1, r1, v2, r2, 4096)]
    for g, w in zip(got["out"], want):
        assert g.dtype == w.dtype and torch.equal(g, w.cpu())
    assert got["counts"] == [1, 1, 1]


@pytest.mark.parametrize("num_temporal", [1, 2])
def test_traced_request_on_card(card, num_temporal):
    """A tiny served request traced on the card (`utils/tracing.py`): every
    span holds device ms, the host's waits are counted (at least one per
    counted upload and the readback, each a pageable copy), kernel #1
    launched once, and the sync debug mode is back as it was."""
    from veon_tpu_torch.configs import presets
    from veon_tpu_torch.data.transforms import depth_tower_size
    from veon_tpu_torch.entry import serve_entry
    from veon_tpu_torch.utils import tracing

    cfg = presets.veon_tiny_test(num_temporal=num_temporal)
    handler, *_ = serve_entry(cfg, device=card, raw_uint8=True)
    rng = np.random.default_rng(0)
    N, (H, W) = cfg.data.num_cams, cfg.data.input_size
    dh, dw = depth_tower_size(cfg.data)
    req = {"imgs": rng.integers(0, 256, (1, 1, N, H, W, 3), dtype=np.uint8),
           "depth_imgs": rng.integers(0, 256, (1, 1, N, dh, dw, 3), dtype=np.uint8)}
    if num_temporal > 1:
        req["lidarego2global"] = np.eye(4, dtype=np.float32)[None]
    tracing.clear()
    tracing.enable()
    try:
        handler(**req)
    finally:
        tracing.disable()
    (rec,) = tracing.requests()
    tracing.clear()
    assert all(s["device_ms"] is not None and s["device_ms"] >= 0 for s in rec["spans"])
    c = rec["counters"]
    assert c["host_syncs"] >= c["h2d_copies"] + 1, c
    assert rec["launches"]["bev_pool_pooled"] == 1
    assert torch.cuda.get_sync_debug_mode() == 0
