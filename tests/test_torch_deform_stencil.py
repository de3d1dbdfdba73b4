"""The temporal fusion's deformable stencil as a registered op
(`veon_tpu_torch/ops/deform_stencil.py`, kernel `csrc/deform_stencil.cu`).

On the CPU: the op's CPU route and the module equal the stencil as
`TemporalDeformable.forward` computed it before the op (a frozen copy
below) bit for bit in fp32 and bf16; the fake version's shape and dtype;
`torch.export` of the tiny streaming step keeps the op as two nodes; under
grad the module calls the op, whose backward (the plain version re-run
under grad) gives the old gradients; shapes that do not fit raise;
`libveon_ops.so`'s C++ op has the Python schema and gives the Python CPU
route's bits (in a process of its own: both define veon::*); the tiny T=2
native package through `veon_aoti_runner`, whose extern nodes call that
C++ op.

Marked `cuda` (skip without a card): the kernel against the plain version
on the card at the tiny and the VEON-B shapes, every tap's q.k and the
output, border voxels on their own; the C++ op's CUDA route; launches
through `ServeHandler` and under grad (the forward launches, the backward
does not). This file imports no JAX; on the
machine with the card:

    python -m pytest --noconftest tests/test_torch_deform_stencil.py
"""

import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from veon_tpu_torch.nn import alignnet as t_align
from veon_tpu_torch.ops import deform_stencil as ds

TINY = (1, 2, 10, 10, 16)  # the tiny preset's lifted grid: 4 heads of 4 channels
VEON_B = (1, 8, 100, 100, 256)  # VEON-B's: 4 heads of 64
NH, NS = 4, 8


def _pre_change_forward(mod, feat_prev, feat_curr, train=False):
    """`TemporalDeformable.forward` (use_stencil=True) as it stood before
    the registered op, frozen: the oracle of the op's CPU route."""
    B, D, H, W, C = feat_curr.shape
    nh, ns = mod.num_heads, mod.num_samples
    hd = C // nh
    dev = feat_curr.device
    kv = mod.key_value_proj(feat_prev)
    query = mod.query_proj(feat_curr)
    off = torch.tanh(mod.offset_conv2(torch.nn.functional.gelu(mod.offset_conv1(feat_curr))))
    off = off.reshape(B, D, H, W, nh, ns, 3)
    zz, yy, xx = torch.meshgrid(ds._linspace_pm1(D, dev), ds._linspace_pm1(H, dev),
                                ds._linspace_pm1(W, dev), indexing="ij")
    base = torch.stack([zz, yy, xx], -1)[None, :, :, :, None, None, :]
    norm = torch.tensor([D, H, W], dtype=off.dtype, device=dev)
    grid_zyx = (base + off / norm).clamp(-1, 1)
    q = query.reshape(B, D, H, W, nh, hd)
    kvh = kv.reshape(B, D, H, W, nh, 2 * hd)
    sizes = torch.tensor([D - 1, H - 1, W - 1], dtype=torch.float32, device=dev) / 2.0
    delta = (grid_zyx - base) * sizes
    qs = q * hd ** -0.5
    hats = [{s: torch.clamp_min(1.0 - (delta[..., a] - s).abs(), 0.0) for s in (-1, 0, 1)}
            for a in range(3)]
    kvp = ds._edge_pad3d(kvh)
    weights, logits = [], 0.0
    for tz, ty, tx in ds._TAPS:
        w = hats[0][tz] * hats[1][ty] * hats[2][tx]
        d_t = (qs * ds._shift3d(kvp, (tz, ty, tx))[..., :hd]).sum(-1)
        logits = logits + w * d_t[..., None]
        weights.append(w)
    attn = torch.softmax(logits.float(), -1).to(q.dtype)
    fused = 0.0
    for w, t in zip(weights, ds._TAPS):
        g = (attn * w).sum(-1)
        fused = fused + g[..., None] * ds._shift3d(kvp, t)[..., hd:]
    fused = fused.reshape(B, D, H, W, C)
    return torch.nn.functional.relu(mod.final_norm(mod.out_proj(fused), train))


def _module(C, dtype, device="cpu", seed=0):
    """A TemporalDeformable with every parameter and BN statistic drawn
    (N(0, 0.1) weights and means, U(0.5, 1.5) variances)."""
    mod = t_align.TemporalDeformable(C, NH, NS, dtype=dtype)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in list(mod.named_parameters()) + list(mod.named_buffers()):
            if name.endswith("var"):
                t.copy_(torch.rand(t.shape, generator=g) + 0.5)
            elif t.is_floating_point():
                t.copy_(torch.randn(t.shape, generator=g) * 0.1)
    return mod.to(device).eval()


def _feats(shape, dtype, device="cpu", seed=1):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=g).to(device, dtype) for _ in range(2)]


def _op_inputs(shape, dtype, device="cpu", seed=2):
    """off (tanh of N(0, 4): many samples near +-1, clipped at the grid's
    edge), query and kv N(0, 1), drawn on the device."""
    B, D, H, W, C = shape
    g = torch.Generator(device=device).manual_seed(seed)
    off = torch.tanh(2 * torch.randn(B, D, H, W, NH * NS * 3, generator=g, device=device))
    query = torch.randn(B, D, H, W, C, generator=g, device=device)
    kv = torch.randn(B, D, H, W, 2 * C, generator=g, device=device)
    return [t.to(dtype) for t in (off, query, kv)]


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


# -- CPU -------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_route_equals_pre_change_stencil(dtype):
    """At the tiny preset's shape the module (through the op's CPU route,
    no gradient) and the op itself give the pre-change stencil's bits."""
    mod = _module(TINY[-1], dtype)
    prev, cur = _feats(TINY, dtype)
    with torch.no_grad():
        want = _pre_change_forward(mod, prev, cur)
        got = mod(prev, cur)
        kv, query = mod.key_value_proj(prev), mod.query_proj(cur)
        off = torch.tanh(mod.offset_conv2(torch.nn.functional.gelu(mod.offset_conv1(cur))))
        fused = torch.ops.veon.deform_stencil(off, query, kv, NH, NS)
        plain = ds.deform_stencil_plain(off, query, kv, NH, NS)
    assert got.dtype == want.dtype == dtype
    assert torch.equal(_bits(got), _bits(want))
    assert fused.dtype == dtype and torch.equal(_bits(fused), _bits(plain))
    assert ds.deform_stencil.launches == 0  # the plain version is no launch


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_op_passes_opcheck(dtype):
    """Schema, fake version, autograd registration and AOT dispatch."""
    args = (*_op_inputs(TINY, dtype), NH, NS)
    result = torch.library.opcheck(torch.ops.veon.deform_stencil.default, args)
    assert set(result.values()) == {"SUCCESS"}, result


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_op_with_grad_passes_opcheck(dtype):
    """The same checks on inputs that require grad: the registered backward
    is used and traces (the AOT check builds the backward graph too)."""
    args = (*(t.requires_grad_() for t in _op_inputs(TINY, dtype)), NH, NS)
    result = torch.library.opcheck(torch.ops.veon.deform_stencil.default, args)
    assert set(result.values()) == {"SUCCESS"}, result


def test_fake_op_gives_shape_and_dtype():
    """The fake version: the query's shape and dtype, contiguous, no data."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        off = torch.empty(2, 3, 5, 7, NH * NS * 3, dtype=torch.bfloat16)
        query = torch.empty(2, 3, 5, 7, 256, dtype=torch.bfloat16)
        kv = torch.empty(2, 3, 5, 7, 512, dtype=torch.bfloat16)
        out = torch.ops.veon.deform_stencil(off, query, kv, NH, NS)
    assert tuple(out.shape) == (2, 3, 5, 7, 256) and out.dtype == torch.bfloat16
    assert out.is_contiguous()


def test_export_of_streaming_step_keeps_two_stencil_nodes():
    """`torch.export` of the tiny T=2 streaming step holds the op twice (the
    shared deformable layer into the current and the merged previous
    frame), and the program computes what the step computes."""
    from veon_tpu_torch.utils import export as t_export

    step, example = t_export._build_streaming("veon_tiny_test", 2, device="cpu")
    program = t_export.export_program(step, example)
    nodes = [n for n in program.graph.nodes if n.target is torch.ops.veon.deform_stencil.default]
    assert len(nodes) == 2
    with torch.no_grad():
        want = step(*example)
    got = program.module()(*example)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_grad_takes_the_plain_version(monkeypatch):
    """With gradients and without, the module calls the op once a call;
    under grad the op's backward takes the plain version, and the module's
    gradients are the pre-change stencil's, bit for bit."""
    calls = []

    def spy(*args):
        calls.append(1)
        return ds.deform_stencil(*args)

    monkeypatch.setattr(t_align, "deform_stencil", spy)
    mod = _module(TINY[-1], torch.float32)
    prev, cur = _feats(TINY, torch.float32)
    grads = []
    for fwd in (lambda: mod(prev, cur, True), lambda: _pre_change_forward(mod, prev, cur, True)):
        mod.zero_grad()
        (fwd().square().sum()).backward()
        grads.append({n: p.grad.clone() for n, p in mod.named_parameters()})
    assert calls == [1]
    for n in grads[0]:
        assert torch.equal(grads[0][n], grads[1][n]), n
    with torch.no_grad():
        mod(prev, cur)
    assert calls == [1, 1]


@pytest.mark.parametrize("what", ["heads", "samples", "kv", "rank"])
def test_shapes_that_do_not_fit_raise(what):
    """A head count that does not divide C, a sample count the offsets do
    not hold, a kv of the wrong width or a tensor of the wrong rank raise,
    with the shapes in the message."""
    off, query, kv = _op_inputs(TINY, torch.float32)
    args = {"heads": (off, query, kv, 3, NS), "samples": (off, query, kv, NH, 7),
            "kv": (off, query, kv[..., :-1], NH, NS), "rank": (off, query[0], kv, NH, NS)}[what]
    with pytest.raises(ValueError, match=r"deform_stencil: off \("):
        torch.ops.veon.deform_stencil(*args)


_OPS_CHILD = r"""
import sys, torch
lib, d = sys.argv[1], sys.argv[2]
torch.ops.load_library(lib)
inp = torch.load(d + "/in.pt")
out = {k: torch.ops.veon.deform_stencil(*v, 4, 8) for k, v in inp.items()}
schema = str(torch.ops.veon.deform_stencil.default._schema)
try:
    torch.ops.veon.deform_stencil.default.redispatch(
        torch._C.DispatchKeySet(torch._C.DispatchKey.CUDA), *inp["f32"], 4, 8)
    cuda = "ran"
except RuntimeError as e:
    cuda = str(e)
torch.save({"out": out, "schema": schema, "cuda": cuda}, d + "/out.pt")
"""


def test_veon_ops_stencil_cpu_bit_equal_and_schema(tmp_path):
    """`libveon_ops.so` (loaded by a process of its own) defines
    veon::deform_stencil with the Python op's schema, and its CPU version
    gives the Python CPU route's bits in fp32 and bf16, at the tiny shape
    and at one with a single plane (D = 1) and two batch entries."""
    from veon_tpu_torch.ops import native

    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no C++ compiler")
    native.build_host("veon_ops")
    cases = {f"{name}_{dt}": _op_inputs(shape, dtype, seed=3)
             for name, shape in (("tiny", TINY), ("plane", (2, 1, 3, 5, 16)))
             for dt, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16))}
    cases["f32"] = cases["tiny_f32"]
    torch.save(cases, tmp_path / "in.pt")
    r = subprocess.run([sys.executable, "-c", _OPS_CHILD, str(native.host_path("veon_ops")),
                        str(tmp_path)], capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    got = torch.load(tmp_path / "out.pt")
    for k, args in cases.items():
        want = torch.ops.veon.deform_stencil(*args, NH, NS)
        g = got["out"][k]
        assert g.dtype == want.dtype and torch.equal(_bits(g), _bits(want)), k
    assert got["schema"] == str(torch.ops.veon.deform_stencil.default._schema)
    if not native.torch_with_cuda():
        assert "built without CUDA" in got["cuda"], got["cuda"]


def test_native_streaming_package_runs_in_the_runner(tmp_path):
    """`export_streaming_native` of the tiny T=2 step on the CPU (its two
    `veon.deform_stencil` extern nodes served by `libveon_ops.so`'s C++
    op) run by `veon_aoti_runner` on a request with a random cache: every
    float output within 2e-4 of the Python step's, the class grid equal off
    near-ties; no kernel launch on the CPU."""
    import torch.utils._pytree as pytree

    from veon_tpu_torch.entry import _ov_weight
    from veon_tpu_torch.nn.text import merge_classes_max
    from veon_tpu_torch.ops import native
    from veon_tpu_torch.utils import export as t_export

    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no C++ compiler")
    native.build_host("veon_ops", "veon_aoti_runner")
    b = t_export.NativeBundle(t_export.export_streaming_native(
        str(tmp_path / "b"), preset="veon_tiny_test", device="cpu"))
    step, (imgs, depth_imgs, m1, ovw, prev_vox, prev_l2g, te) = t_export._build_streaming(
        "veon_tiny_test", 2, device="cpu")
    prev_vox = torch.randn(prev_vox.shape, generator=torch.Generator().manual_seed(5))
    rig = {k: v for k, v in m1.items() if k != "lidarego2global"}
    args = (imgs, depth_imgs, rig, m1["lidarego2global"], ovw, prev_vox, prev_l2g, te)
    paths = []
    for i, t in enumerate(pytree.tree_leaves(args)):
        paths.append(str(tmp_path / f"in{i}.npy"))
        t_export._write_npy(paths[-1], t.contiguous())
    assert len(paths) == len(b.manifest["order"])
    r = subprocess.run(b.runner_argv(paths, str(tmp_path / "out_")), capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "deform_stencil=0" in r.stdout
    with torch.no_grad():
        want = step(imgs, depth_imgs, m1, ovw, prev_vox, prev_l2g, te)
    got = {n: t_export.read_npy(str(tmp_path / f"out_{i}.npy"))
           for i, n in enumerate(b.manifest["outputs"])}
    assert set(got) == set(want)
    for k, w in want.items():
        if w.is_floating_point():
            torch.testing.assert_close(got[k], w, rtol=2e-4, atol=2e-4, msg=k)
    _ovw, membership = _ov_weight(t_export._serving_cfg("veon_tiny_test", 2), "cpu", seed=0)
    top2 = merge_classes_max(want["sem_occ_raw"], membership, axis=-1).topk(2, dim=-1).values
    occ = want["bin_occ"]
    clear = (((top2[..., 0] - top2[..., 1]) > 1e-3)
             & ((occ[..., 0] - occ[..., 1]).abs() > 1e-3)).permute(0, 3, 2, 1)
    assert clear.float().mean() > 0.9
    assert torch.equal(got["pred"][clear], want["pred"][clear])


# -- on the card -------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the kernel has no CPU or interpret mode)")
    return torch.device("cuda")


def _plain_taps(off, query, kv):
    """Every tap's q.k as the plain version computes it, (B, D, H, W,
    heads, 27) in fp32."""
    B, D, H, W, C = query.shape
    hd = C // NH
    qs = query.reshape(B, D, H, W, NH, hd) * hd ** -0.5
    kvp = ds._edge_pad3d(kv.reshape(B, D, H, W, NH, 2 * hd))
    return torch.stack([(qs * ds._shift3d(kvp, t)[..., :hd]).sum(-1) for t in ds._TAPS],
                       -1).float()


def _over(got, want, dtype):
    """How far each element of got lies beyond its tolerance (<= 0 within):
    fp32 1e-5 relative, 1e-5 absolute near 0 (fp32 sums of O(1) terms that
    cancel); bf16 one bf16 ulp at the larger magnitude on top of that."""
    g, w = got.float(), want.float()
    fp32 = 1e-5 + 1e-5 * w.abs()
    if dtype == torch.float32:
        return (g - w).abs() - fp32
    big = torch.maximum(g.abs(), w.abs()).clamp_min(2.0 ** -126)
    return (g - w).abs() - (torch.exp2(torch.floor(torch.log2(big)) - 7) + fp32)


def _border(shape, device):
    """(D, H, W) mask of the voxels on the grid's faces."""
    _B, D, H, W, _C = shape
    z, y, x = torch.meshgrid(*(torch.arange(n, device=device) for n in (D, H, W)), indexing="ij")
    return (z == 0) | (z == D - 1) | (y == 0) | (y == H - 1) | (x == 0) | (x == W - 1)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [TINY, VEON_B], ids=["tiny", "veon_b"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain(card, shape, dtype):
    """The kernel against the plain version on the card: every tap's q.k
    and the output, interior and border voxels each within the tolerance
    (`_over`), one launch."""
    off, query, kv = _op_inputs(shape, dtype, device=card)
    B, D, H, W, C = shape
    dt = torch.empty(B, D, H, W, NH, 27, dtype=torch.float32, device=card)
    before = ds.deform_stencil.launches
    got = ds.launch(off, query, kv, NH, NS, dt_out=dt)
    torch.cuda.synchronize()
    assert ds.deform_stencil.launches == before + 1
    assert got.dtype == dtype and tuple(got.shape) == shape
    want = ds.deform_stencil_plain(off, query, kv, NH, NS)
    want_dt = _plain_taps(off, query, kv)
    border = _border(shape, card)
    for what, over in (("q.k", _over(dt, want_dt, dtype).amax((-2, -1))),
                       ("output", _over(got, want, dtype).amax(-1))):
        for where, mask in (("interior", ~border), ("border", border)):
            if mask.any():  # the tiny grid's two planes are all border
                worst = over[:, mask].max().item()
                assert worst <= 0, f"{what} at the {where} voxels: {worst} beyond the tolerance"


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(card):
    off, query, kv = _op_inputs((1, 2, 3, 4, 128), torch.float32, device=card)  # heads of 32
    with pytest.raises(ValueError, match="heads of"):
        ds.launch(off, query, kv, NH, NS)
    off, query, kv = _op_inputs(TINY, torch.float32, device=card)
    with pytest.raises(TypeError, match="one dtype"):
        ds.launch(off, query, kv.bfloat16(), NH, NS)
    with pytest.raises(TypeError, match="float32/bfloat16"):
        ds.launch(off.half(), query.half(), kv.half(), NH, NS)


_CPP_CUDA_CHILD = r"""
import ctypes, sys, torch
lib, d = sys.argv[1], sys.argv[2]
torch.ops.load_library(lib)
t = [x.cuda() for x in torch.load(d + "/in.pt")]
out = torch.ops.veon.deform_stencil(*t, 4, 8)
torch.cuda.synchronize()
n = ctypes.CDLL(lib)
n.veon_ops_launches.restype = ctypes.c_longlong
torch.save({"out": out.cpu(), "count": n.veon_ops_launches(b"deform_stencil")}, d + "/out.pt")
"""


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpp_op_launches_the_same_kernel(card, tmp_path, dtype):
    """`veon_ops`' CUDA route (in a process of its own) gives the Python
    op's bits, one launch by its own counter."""
    from veon_tpu_torch.ops import native

    native.build_host("veon_ops")
    args = _op_inputs(VEON_B, dtype, device=card)
    torch.save([a.cpu() for a in args], tmp_path / "in.pt")
    r = subprocess.run([sys.executable, "-c", _CPP_CUDA_CHILD,
                        str(native.host_path("veon_ops")), str(tmp_path)],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    got = torch.load(tmp_path / "out.pt")
    want = ds.deform_stencil(*args, NH, NS).cpu()
    assert got["count"] == 1 and torch.equal(_bits(got["out"]), _bits(want))


@pytest.mark.cuda
@pytest.mark.parametrize("num_temporal", [1, 2])
def test_handler_launches_per_request(card, num_temporal):
    """Through `ServeHandler` at the tiny preset: 2 launches a T=2 request
    (the shared layer into the current and the previous frame), 0 at F=1,
    by the tracer's launch deltas of two requests."""
    from veon_tpu_torch.configs import presets
    from veon_tpu_torch.data.transforms import depth_tower_size
    from veon_tpu_torch.entry import serve_entry
    from veon_tpu_torch.utils import tracing

    cfg = presets.veon_tiny_test(num_temporal=num_temporal)
    handler, *_ = serve_entry(cfg, device=card, raw_uint8=True)
    rng = np.random.default_rng(0)
    N, (H, W) = cfg.data.num_cams, cfg.data.input_size
    dh, dw = depth_tower_size(cfg.data)
    tracing.clear()
    tracing.enable()
    try:
        for i in range(2):
            req = {"imgs": rng.integers(0, 256, (1, 1, N, H, W, 3), dtype=np.uint8),
                   "depth_imgs": rng.integers(0, 256, (1, 1, N, dh, dw, 3), dtype=np.uint8)}
            if num_temporal > 1:
                pose = np.eye(4, dtype=np.float32)
                pose[0, 3] = 2.0 * i
                req["lidarego2global"] = pose[None]
            handler(**req)
    finally:
        tracing.disable()
    recs = tracing.requests()
    tracing.clear()
    assert [r["launches"]["deform_stencil"] for r in recs] == [2 * (num_temporal > 1)] * 2


@pytest.mark.cuda
def test_grad_on_card_launches_the_kernel(card):
    """Under grad the module's forward on the card launches the kernel once
    and its backward launches nothing (the plain version re-run); the
    output and the gradients within the kernel's tolerance of the
    pre-change stencil's on the card."""
    mod = _module(TINY[-1], torch.float32, device=card)
    prev, cur = _feats(TINY, torch.float32, device=card)
    grads, outs = [], []
    for fwd in (lambda: mod(prev, cur, True), lambda: _pre_change_forward(mod, prev, cur, True)):
        mod.zero_grad()
        before = ds.deform_stencil.launches
        out = fwd()
        launched = ds.deform_stencil.launches - before
        out.square().sum().backward()
        torch.cuda.synchronize()
        outs.append(out.detach())
        grads.append({n: p.grad.clone() for n, p in mod.named_parameters()})
        if not outs[1:]:
            assert (launched, ds.deform_stencil.launches - before) == (1, 1)
    torch.testing.assert_close(outs[0], outs[1], rtol=1e-5, atol=1e-5)
    for n in grads[0]:
        torch.testing.assert_close(grads[0][n], grads[1][n], rtol=1e-5, atol=1e-5, msg=n)
