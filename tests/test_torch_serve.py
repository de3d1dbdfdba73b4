"""The port's serving surface against the JAX package on the CPU: socket
frames byte for byte for every dtype code (bf16 included), each side's
server with the other side's client, and the port's request handler
(`entry.serve_entry`) against `veon_tpu.cli.main._build_serve_handler` at
`veon_tiny_test` for F=1 and T=2 with the same weights: `pred` equal off
near-ties (as `test_torch_slice.py` holds the class grid), `retrieval`
within atol 2e-4 (the slice's tolerance for the features it is the
cosine of); at T=2 and two more weight seeds, `retrieval` within the
rounding floor of those weights. Then reset, exclusive refusal, dtype and
key errors, and the CLI's refusal and dtype."""

import argparse
import functools
import os
import socket

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from test_torch_common import np_tree, perturbed, to_np

from veon_tpu.serve import client as jclient
from veon_tpu.serve import protocol as jproto
from veon_tpu.serve import server as jserver
from veon_tpu_torch.cli.main import build_serve_handler, main
from veon_tpu_torch.cli.shapes import example_batch_full, example_drive
from veon_tpu_torch.configs import presets
from veon_tpu_torch.entry import serve_entry
from veon_tpu_torch.nn import text as ptext
from veon_tpu_torch.serve import protocol as pproto
from veon_tpu_torch.serve.client import TensorClient
from veon_tpu_torch.serve.server import TensorServer

CODES = {0: np.float32, 1: np.float64, 2: np.int32, 3: np.int64, 4: np.uint8,
         5: ml_dtypes.bfloat16, 6: np.bool_, 7: np.float16}


def _frame_bytes(send, tensors, status=0):
    a, b = socket.socketpair()
    with a, b:
        send(a, tensors, status)
        a.shutdown(socket.SHUT_WR)
        chunks = []
        while True:
            c = b.recv(1 << 16)
            if not c:
                return b"".join(chunks)
            chunks.append(c)


def _recv(recv, data):
    a, b = socket.socketpair()
    with a, b:
        a.sendall(data)
        return recv(b)


def _arrays(code):
    """(reference numpy arrays, the port's arrays or tensors) of one dtype:
    a matrix, a scalar (sent with one dimension) and an empty array."""
    rng = np.random.default_rng(code)
    x = rng.standard_normal((2, 3)) * 50
    shapes = [x, x[0, 0], x[:0]]
    ref = [np.asarray(v).astype(CODES[code]) for v in shapes]
    if code == 5:  # bf16: the port sends and reads torch.bfloat16 tensors
        port = [torch.from_numpy(np.asarray(v, np.float32)).to(torch.bfloat16) for v in ref]
    else:
        port = [np.array(v) for v in ref]
    return ref, port


@pytest.mark.parametrize("code", sorted(CODES))
def test_frames_byte_equal_reference(code):
    ref, port = _arrays(code)
    names = ["matrix", "scalar", "empty"]
    want = _frame_bytes(jproto.send_frame, dict(zip(names, ref)))
    got = _frame_bytes(pproto.send_frame, dict(zip(names, port)))
    assert got == want
    assert want[12 + 2 + len("matrix")] == code  # the dtype byte of the first tensor
    status, back = _recv(pproto.recv_frame, want)
    assert status == 0 and list(back) == names
    for name, r in zip(names, ref):
        b, r = back[name], np.ascontiguousarray(r)  # a scalar travels with one dimension
        if code == 5:
            assert isinstance(b, torch.Tensor) and b.dtype == torch.bfloat16
            b = b.float().numpy()
        assert b.shape == r.shape
        np.testing.assert_array_equal(np.asarray(b, np.float64), r.astype(np.float64))
    status, jback = _recv(jproto.recv_frame, got)
    for name, r in zip(names, ref):
        assert jback[name].dtype == np.dtype(CODES[code])
        np.testing.assert_array_equal(jback[name], np.ascontiguousarray(r))


def test_error_frames_byte_equal_reference():
    a = _frame_bytes(lambda s, t, st: jproto.error_frame(s, "KeyError: 'imgs' ✗"), None)
    b = _frame_bytes(lambda s, t, st: pproto.error_frame(s, "KeyError: 'imgs' ✗"), None)
    assert a == b
    with pytest.raises(ValueError, match="unsupported dtype"):
        _frame_bytes(pproto.send_frame, {"c": np.zeros(2, np.complex64)})


def _echo(**req):
    return dict(req)


def _mixed():
    rng = np.random.default_rng(7)
    return {"f": rng.standard_normal((3, 4)).astype(np.float32),
            "i": np.arange(6, dtype=np.int32).reshape(2, 3),
            "u": np.arange(5, dtype=np.uint8),
            "h": rng.standard_normal(4).astype(ml_dtypes.bfloat16)}


def test_port_server_answers_reference_client(tmp_path):
    sock = os.path.join(str(tmp_path), "p.sock")
    srv = TensorServer(_echo, sock, required=("f",))
    srv.start()
    try:
        c = jclient.TensorClient(sock)
        with c:
            req = _mixed()
            out = c.infer(**req)
            for k, v in req.items():
                assert out[k].dtype == v.dtype
                np.testing.assert_array_equal(out[k], v)
            assert out["server_ms"].dtype == np.float32
            with pytest.raises(RuntimeError, match="missing tensors"):
                c.infer(i=req["i"])
            assert c.infer(f=req["f"])["f"].shape == (3, 4)  # still serving
    finally:
        srv.stop()


def test_reference_server_answers_port_client(tmp_path):
    sock = os.path.join(str(tmp_path), "j.sock")
    srv = jserver.TensorServer(_echo, sock)
    srv.start()
    try:
        with TensorClient(sock) as c:
            req = _mixed()
            req["h"] = torch.from_numpy(req["h"].astype(np.float32)).to(torch.bfloat16)
            out = c.infer(**req)
            assert out["h"].dtype == torch.bfloat16 and torch.equal(out["h"], req["h"])
            for k in ("f", "i", "u"):
                np.testing.assert_array_equal(out[k], req[k])
            assert float(out["server_ms"][0]) >= 0.0
    finally:
        srv.stop()


def _zero_lora_b(tree):
    if isinstance(tree, dict):
        return {k: (np.zeros_like(v) if k == "lora_B" else _zero_lora_b(v))
                for k, v in tree.items()}
    return tree


def _args(T):
    return argparse.Namespace(preset="veon_tiny_test", num_temporal=T, load_from=None,
                              depth_load_from=None, bpe_path=None)


@functools.lru_cache(maxsize=None)
def _cli_init(T):
    """The JAX CLI's init tree at veon_tiny_test with num_temporal T, as
    numpy (its one-slot memo restored after)."""
    from veon_tpu.cli import main as jmain

    saved = dict(jmain._INIT_MEMO)
    try:
        jmain._build_model_and_params(jmain._build_cfg(_args(T)))
        return np_tree(jmain._INIT_MEMO["variables"])
    finally:
        jmain._INIT_MEMO.clear()
        jmain._INIT_MEMO.update(saved)


def _weights(T, seed):
    """The JAX CLI's init tree perturbed with `seed`, its LoRA B factors
    zeroed (the adapters add nothing, so the port takes the base weights)."""
    variables = perturbed(_cli_init(T), seed=seed)
    variables["params"] = _zero_lora_b(variables["params"])
    return variables


@functools.lru_cache(maxsize=None)
def handlers(T):
    """(JAX handler, port handler) at veon_tiny_test with num_temporal T,
    same weights: `_weights(T, 0)`, the JAX CLI's seeded text tower, its
    placeholder classifier. The JAX CLI memoizes its init tree; the
    perturbed tree is planted there for one build and the memo is restored
    after. At other perturbation seeds the T=2 retrieval differs by up to
    ~1e-3 on both sides' fp32 rounding: `test_streaming_retrieval_within_
    the_rounding_floor_at_other_seeds` holds those."""
    from veon_tpu.cli import main as jmain
    from veon_tpu.ckpt.convert import merge_lora
    from veon_tpu.nn.vit import CLIPTextEncoder

    args = _args(T)
    cfg = jmain._build_cfg(args)
    variables = _weights(T, 0)
    saved = dict(jmain._INIT_MEMO)
    try:
        jmain._build_model_and_params(cfg)
        jmain._INIT_MEMO["variables"] = jax.tree_util.tree_map(jnp.asarray, variables)
        jax_handler, required, _expect, exclusive = jmain._build_serve_handler(args)
    finally:
        jmain._INIT_MEMO.clear()
        jmain._INIT_MEMO.update(saved)
    s = cfg.san
    enc = CLIPTextEncoder(width=s.text_width, heads=s.text_heads, num_layers=s.text_layers,
                          out_dim=s.clip_embed_dim, vocab_size=s.text_vocab_size,
                          context_length=s.text_context_length)
    text_params = jax.jit(enc.init)(jax.random.PRNGKey(1), jnp.zeros((1, 77), jnp.int32))
    port_vars = dict(variables, params=merge_lora(variables["params"]))
    port = serve_entry(presets.veon_tiny_test(num_temporal=T), device="cpu",
                       variables=port_vars, text_tower=np_tree(text_params["params"]))
    assert port[1] == required and port[3] == exclusive
    return jax_handler, port


def _text_requests(cfg):
    te = np.random.default_rng(3).standard_normal(cfg.propagation.clip_proj_dim)
    tokens = ptext.ClipTokenizer().tokenize(["a parked red car"])
    return [{}, {"text_tokens": tokens}, {"text_embed": te.astype(np.float32)}]


def _clear(out, membership):
    """Voxels (B, X, Y, Z) clear of near-ties: top-2 merged-logit margin and
    |softmax(bin)[0] - 0.5| both above 1e-3."""
    merged = to_np(ptext.merge_classes_max(out["sem_occ_raw"], membership, axis=-1))
    top2 = np.sort(merged, -1)[..., -2:]
    b = to_np(out["bin_occ"])
    p0 = 0.5 * (1.0 + np.tanh(0.5 * (b[..., 0] - b[..., 1])))  # softmax(bin)[0]
    clear = ((top2[..., 1] - top2[..., 0]) > 1e-3) & (np.abs(p0 - 0.5) > 1e-3)
    return clear.transpose(0, 3, 2, 1)


def _compare(got, want, clear, with_text):
    assert got.keys() == want.keys() == ({"pred", "retrieval"} if with_text else {"pred"})
    assert got["pred"].dtype == np.uint8 and got["pred"].shape == want["pred"].shape
    assert clear.mean() >= 0.99, clear.mean()
    np.testing.assert_array_equal(got["pred"][clear], np.asarray(want["pred"])[clear])
    assert (got["pred"] != 17).any() and (got["pred"] == 17).any()  # both branches of the rule
    if with_text:
        np.testing.assert_allclose(got["retrieval"], np.asarray(want["retrieval"]),
                                   rtol=0, atol=2e-4)


def test_frame_handler_matches_reference():
    jax_handler, (handler, *_rest) = handlers(1)
    cfg = presets.veon_tiny_test()
    np.testing.assert_array_equal(to_np(handler.server.ov_weight), np.random.default_rng(0)
                                  .standard_normal((67, cfg.san.clip_embed_dim)).astype(np.float32))
    imgs, depth_imgs, _ = example_batch_full(cfg, device="cpu")
    frame = {"imgs": imgs.numpy(), "depth_imgs": depth_imgs.numpy()}
    clear = _clear(handler.server.outputs(imgs, depth_imgs), handler.server.membership)
    for text in _text_requests(cfg):
        _compare(handler(**frame, **text), jax_handler(**frame, **text), clear, bool(text))


def test_streaming_handler_matches_reference():
    jax_handler, (handler, *_rest) = handlers(2)
    cfg = presets.veon_tiny_test(num_temporal=2)
    _rig, drive = example_drive(cfg, 3, device="cpu", seed=2)
    reqs = [{k: v.numpy() for k, v in r.items()} for r in drive]
    texts = _text_requests(cfg)
    got = [handler(**r, **t) for r, t in zip(reqs, texts)]
    want = [jax_handler(**r, **t) for r, t in zip(reqs, texts)]
    session = handler.session  # replay the calls for the port's raw outputs
    session.reset()
    for r, g, w, t in zip(drive, got, want, texts):
        out = session.infer(r["imgs"], r["depth_imgs"], {"lidarego2global": r["lidarego2global"]})
        _compare(g, w, _clear(out, session.membership), bool(t))
    assert handler(reset=np.int32(1))["ok"] == 1 and session.calls == 0
    assert int(np.asarray(jax_handler(reset=np.int32(1))["ok"])) == 1


def _jiggled(tree, rng):
    """Every leaf times (1 + 2^-23 N(0, 1)): a one-ulp change of each weight."""
    if isinstance(tree, dict):
        return {k: _jiggled(v, rng) for k, v in tree.items()}
    return (tree * (1.0 + 2.0 ** -23 * rng.standard_normal(tree.shape))).astype(tree.dtype)


def _port_retrieval(cfg, variables, reqs):
    """The port's T=2 handler on `variables` (LoRA merged), the requests in
    order: (retrieval maps, the session's raw outputs of each call)."""
    from veon_tpu.ckpt.convert import merge_lora

    handler, *_ = serve_entry(cfg, device="cpu",
                              variables=dict(variables, params=merge_lora(variables["params"])))
    got = [handler(**r) for r in reqs]
    handler.session.reset()
    raw = [handler.session.infer(*(torch.from_numpy(r[k]) for k in ("imgs", "depth_imgs")),
                                 {"lidarego2global": torch.from_numpy(r["lidarego2global"])})
           for r in reqs]
    return got, raw, handler.session.membership


# the largest one-ulp spread s of the 15 calls of seeds 1-5 on the CPU
# (1.11e-3, seed 3 call 1; seeds 1 and 2 reach 4.71e-4)
S_MAX = 1.12e-3


@pytest.mark.parametrize("seed", [1, 2])
def test_streaming_retrieval_within_the_rounding_floor_at_other_seeds(seed):
    """At perturbation seeds other than 0 the T=2 served retrieval differs
    from JAX's by up to ~1e-3, and so does the port against itself when
    every weight moves by one ulp: the depth tower's fp32 rounding (~3e-5
    relative on both sides) is amplified by the two-hot binning (softmax
    logits -4|d - c|, slope 4 per metre) where these weights put depths
    inside the grid, then by the 3D head (occupancy logits up to ~900).
    So the sides part on rounding, not op order. The rule: per call,
    |retrieval - JAX's| <= max(2e-4, 8 s), s the largest change of the
    port's own retrieval under two one-ulp jiggles of every weight (the
    rounding floor of these weights; 8 covers two independent rounding
    paths and the spread of a maximum over voxels: the ratio of the JAX
    difference to s measured 0.19-2.72 over the 15 calls of seeds 1-5),
    capped at 8 S_MAX, S_MAX the largest s of those 15 calls, so that a
    port grown more sensitive to rounding cannot widen its own bound.
    `pred` equal off near-ties, as at seed 0."""
    from veon_tpu.serve.streaming import TemporalSession as JaxSession

    jax_handler, _port = handlers(2)
    session = next(c.cell_contents for c in jax_handler.__closure__
                   if isinstance(c.cell_contents, JaxSession))
    cfg = presets.veon_tiny_test(num_temporal=2)
    _rig, drive = example_drive(cfg, 3, device="cpu", seed=2)
    te = np.random.default_rng(3).standard_normal(cfg.propagation.clip_proj_dim)
    reqs = [dict({k: v.numpy() for k, v in r.items()}, text_embed=te.astype(np.float32))
            for r in drive]
    variables = _weights(2, seed)
    base = session.variables
    session.variables = jax.tree_util.tree_map(jnp.asarray, variables)  # same graph, new weights
    try:
        session.reset()
        want = [jax_handler(**r) for r in reqs]
    finally:
        session.variables = base
        session.reset()
    got, raw, membership = _port_retrieval(cfg, variables, reqs)
    rng = np.random.default_rng(100)
    spread = np.zeros(len(reqs))
    for _ in range(2):
        other, _raw, _m = _port_retrieval(cfg, _jiggled(variables, rng), reqs)
        spread = np.maximum(spread, [np.abs(a["retrieval"] - b["retrieval"]).max()
                                     for a, b in zip(got, other)])
    for i, (g, w, out) in enumerate(zip(got, want, raw)):
        diff = np.abs(g["retrieval"] - np.asarray(w["retrieval"])).max()
        tol = min(max(2e-4, 8 * spread[i]), 8 * S_MAX)
        print(f"seed {seed} call {i}: |retrieval - JAX| {diff:.3g}, one-ulp floor {spread[i]:.3g}, "
              f"ratio {diff / max(spread[i], 1e-12):.2f}, tolerance {tol:.3g}")
        assert diff <= tol, (seed, i, diff, spread[i])
        clear = _clear(out, membership)
        assert clear.mean() >= 0.99, clear.mean()
        np.testing.assert_array_equal(g["pred"][clear], np.asarray(w["pred"])[clear])


def test_streaming_server_resets_refuses_and_reports(tmp_path):
    """Over the socket: a reset frame, a second connection refused while
    the first is open, a dtype mismatch and a missing key answered with
    error frames, and the server serving on after each."""
    _jax, (handler, required, _expect, exclusive) = handlers(2)
    assert required == () and exclusive
    cfg = presets.veon_tiny_test(num_temporal=2)
    _rig, drive = example_drive(cfg, 2, device="cpu", seed=5)
    reqs = [{k: v.numpy() for k, v in r.items()} for r in drive]
    sock = os.path.join(str(tmp_path), "t.sock")
    srv = TensorServer(handler, sock, required=required, exclusive=exclusive)
    srv.start()
    try:
        with TensorClient(sock) as c:
            first = c.infer(**reqs[0])["pred"]
            assert first.dtype == np.uint8 and first.shape == (1,) + cfg.grid.size
            assert int(c.infer(reset=np.int32(1))["ok"][0]) == 1
            np.testing.assert_array_equal(c.infer(**reqs[0])["pred"], first)  # cache zeroed
            with TensorClient(sock) as c2:
                with pytest.raises((RuntimeError, OSError)) as err:
                    c2.infer(**reqs[1])
                if isinstance(err.value, RuntimeError):
                    assert "busy" in str(err.value)
            with pytest.raises(RuntimeError, match="TypeError: imgs dtype float64"):
                c.infer(**dict(reqs[1], imgs=reqs[1]["imgs"].astype(np.float64)))
            with pytest.raises(RuntimeError, match=r"KeyError: .*lidarego2global"):
                c.infer(imgs=reqs[1]["imgs"], depth_imgs=reqs[1]["depth_imgs"])
            assert c.infer(**reqs[1])["pred"].shape == first.shape
    finally:
        srv.stop()


def test_frame_server_checks_keys_and_raw_uint8(tmp_path):
    """F=1: the required keys, and a raw-uint8 handler that takes uint8
    frames (normalized on the device: equal to fp32 frames normalized
    first) and refuses fp32 ones."""
    from veon_tpu_torch.data.transforms import normalize_in_graph

    _jax, (handler, required, _expect, exclusive) = handlers(1)
    assert required == ("imgs", "depth_imgs") and not exclusive
    cfg = presets.veon_tiny_test()
    imgs, depth_imgs, _ = example_batch_full(cfg, device="cpu")
    rng = np.random.default_rng(9)
    u8 = rng.integers(0, 256, imgs.shape, dtype=np.uint8)
    d8 = rng.integers(0, 256, depth_imgs.shape, dtype=np.uint8)
    raw, *_ = serve_entry(cfg, device="cpu", raw_uint8=True)
    sock = os.path.join(str(tmp_path), "f.sock")
    srv = TensorServer(raw, sock, required=required)
    srv.start()
    try:
        with TensorClient(sock) as c:
            got = c.infer(imgs=u8, depth_imgs=d8)["pred"]
            want = raw.server(normalize_in_graph(torch.from_numpy(u8), "clipsan"),
                              normalize_in_graph(torch.from_numpy(d8), "depthanythingv2"))
            np.testing.assert_array_equal(got, to_np(want).astype(np.uint8))
            with pytest.raises(RuntimeError, match="does not match this server's --raw-uint8"):
                c.infer(imgs=imgs.numpy(), depth_imgs=depth_imgs.numpy())
            with pytest.raises(RuntimeError, match=r"KeyError: .*depth_imgs"):
                c.infer(imgs=u8)
            assert c.infer(imgs=u8, depth_imgs=d8)["pred"].shape == got.shape
    finally:
        srv.stop()


def test_cli_refuses_what_is_not_ported():
    """--cam-shards S needs a world of S processes (JAX's error, raised
    before anything is built; the sharded path is `test_torch_camshard.py`);
    the CLI computes in the preset's dtype, as the reference's `_build_cfg`
    (fp32 for veon_b), where `serve_entry` keeps its bf16 default."""
    args = ["serve", "--preset", "veon_tiny_test", "--device", "cpu"]
    with pytest.raises(ValueError, match="--cam-shards 2 needs that many devices; have 1"):
        main(args + ["--cam-shards", "2"])
    ns = argparse.Namespace(preset="veon_b", num_temporal=2, device="cpu", bpe_path=None,
                            raw_uint8=False, cam_shards=4, load_from=None, depth_load_from=None)
    with pytest.raises(ValueError, match="--cam-shards 4 needs that many devices"):
        build_serve_handler(ns)
    from veon_tpu.cli.main import _build_cfg
    from veon_tpu_torch.cli.main import build_cfg

    cfg = build_cfg(ns)
    assert cfg.compute_dtype == _build_cfg(ns).compute_dtype == "float32"
    assert cfg.num_temporal == 2 and cfg == presets.veon_b(num_temporal=2)
