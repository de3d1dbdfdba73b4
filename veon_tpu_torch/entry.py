"""Entry points of the port, on the card unless device="cpu".

Serving, the VEON-B F=1 forward from camera images to the class grid
(counterpart of `__graft_entry__.entry`):

    forward, (imgs, depth_imgs) = entry()      # veon_b, bf16
    grid = forward(imgs, depth_imgs)           # (1, 200, 200, 16) int32

The rig is fixed, so its rank sort is precomputed once here
(`LSSLift.precompute_sorted`) and each frame runs no sort. The graph
itself is `forward.forward`, a stateless `ServingForward` of (imgs,
depth_imgs, metas, ov_weight), which `utils/export.py` freezes.

Temporal serving, a streaming session over a synthetic drive (counterpart
of `veon_tpu serve --num-temporal 2`, the flagship's temporal mode):

    session, frames = temporal_entry()         # veon_b, T=2, bf16
    for r in frames:                           # time order
        out = session.infer(r["imgs"], r["depth_imgs"],
                            {"lidarego2global": r["lidarego2global"]})
        out["pred"]                            # (1, 200, 200, 16) uint8

Each call lifts only its own frame (kernel #1 on the fixed rig) and fuses
the cached voxels of the previous num_temporal - 1 frames.

Training, the stage-2 step (counterpart of `make_train_step(mesh=None)` on
the synthetic batch of `veon_tpu/utils/train_bench.py` build_train_setup):

    trainer, batch = train_entry()             # veon_b, bf16
    losses = trainer(batch)                    # one step: dict of scalars

The batch carries depth_imgs, so the frozen depth tower runs in the step
(the flagship's no-depth-cache recipe); the lift is the banded one unless
cfg.lss_banded is False.

Socket serving with free-text retrieval (counterpart of `veon_tpu serve`,
`veon_tpu/cli/main.py` `_build_serve_handler`):

    handler, required, expect, exclusive = serve_entry()   # veon_b, bf16
    srv = TensorServer(handler, "/tmp/veon.sock", required, exclusive)
    srv.start()                                # serve/server.py
    TensorClient("/tmp/veon.sock").infer(imgs=..., depth_imgs=...,
                                         text_tokens=...)  # pred, retrieval

With a cfg of num_temporal > 1 the handler holds a `TemporalSession`.

Camera-sharded serving (counterpart of `veon_tpu serve --cam-shards S`):
every rank of a cam group (`collectives.cam_groups`) calls
`serve_entry(..., cam_group=cg)`; the group's first rank mounts the
handler on its server and each request it takes is broadcast to the
others, which run `handler.follow()` until the first rank's
`handler.close()`.
"""

from __future__ import annotations

import sys
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from . import resolve_device
from .collectives import CamGroup
from .cli.shapes import example_batch, example_batch_full, example_depth_imgs, example_drive
from .ckpt.from_jax import load_from_jax, load_text_tower
from .configs import presets
from .configs.base import VeonConfig
from .data.transforms import normalize_in_graph
from .geometry.frustum import sensor2keyego_chain
from .model.camshard import prepare_camshard_metas
from .model.veon import VeonModel, fused_classes, retrieval_map
from .nn import text as text_mod
from .nn.layers import init_random_
from .nn.rematutil import RematSpec
from .nn.vit import CLIPTextEncoder
from .serve.camshard import make_camera_sharded_forward, share_request
from .serve.streaming import TemporalSession
from .train.step import AdamW, TrainState, create_train_state, make_train_step
from .utils import tracing


class ServingForward(nn.Module):
    """The F=1 serving graph as a stateless module (counterpart of the
    `forward` of `veon_tpu/utils/bench_model.py` `build_serving_forward`):
    (imgs, depth_imgs, metas, ov_weight) -> the (B, X, Y, Z) int32 class
    grid. The weights and the vocabulary's merge are the module's; the rig
    metas (with "lift_sorted") and the open-vocabulary matrix are inputs,
    so `utils/export.py` freezes the one and keeps the others arguments.
    `full_forward` is the forward whose outputs it classifies: the model's
    own, or a camera-sharded one (`serve/camshard.py`)."""

    def __init__(self, model: VeonModel, membership, full_forward=None):
        super().__init__()
        self.model, self.membership = model, membership
        self.full_forward = full_forward or model.full_forward

    def forward(self, imgs, depth_imgs, metas, ov_weight):
        return fused_classes(self.full_forward(imgs, depth_imgs, metas, ov_weight),
                             self.membership)


class FrameServer:
    """A built model with its rig precompute, vocabulary merge and
    open-vocabulary weights; calling it serves one frame through its
    `ServingForward` (`forward`).
    `normalize=(img_method, depth_method)` makes `infer` take raw uint8 HWC
    frames and normalize them on the device (`data/transforms.py`).
    `cam_group` shards the cameras over its ranks (`serve/camshard.py`,
    the model in place): `metas` then come from
    `prepare_camshard_metas(presort=True)` and every rank of the group
    calls with the whole frame."""

    def __init__(self, model: VeonModel, metas, ov_weight, membership, normalize=None,
                 cam_group: Optional[CamGroup] = None):
        self.model, self.metas = model, metas
        self.ov_weight, self.membership = ov_weight, membership
        self.normalize = normalize
        self.forward = ServingForward(model, membership, None if cam_group is None
                                      else make_camera_sharded_forward(model, cam_group))

    @torch.no_grad()
    def outputs(self, imgs, depth_imgs):
        """The model's raw fp32 outputs (bin_occ, feat_occ, sem_occ_raw, ...)."""
        return self.forward.full_forward(imgs, depth_imgs, self.metas, self.ov_weight)

    @torch.no_grad()
    def __call__(self, imgs, depth_imgs):
        """The (B, X, Y, Z) int32 class grid of normalized frames."""
        return self.forward(imgs, depth_imgs, self.metas, self.ov_weight)

    @torch.no_grad()
    def infer(self, imgs, depth_imgs, text_embed=None) -> Dict[str, torch.Tensor]:
        """The served response: `pred`, the uint8 class grid, and with
        text_embed (C,) the free-text `retrieval` map (B, X, Y, Z)."""
        with tracing.span("session.infer"):
            if self.normalize is not None:
                with tracing.span("session.normalize"):
                    imgs = normalize_in_graph(imgs, self.normalize[0])
                    depth_imgs = normalize_in_graph(depth_imgs, self.normalize[1])
            out = self.outputs(imgs, depth_imgs)
            with tracing.span("session.merge"):
                resp = {"pred": fused_classes(out, self.membership).to(torch.uint8)}
            if text_embed is not None:
                resp["retrieval"] = retrieval_map(out["feat_occ"], text_embed)
            return resp


def _no_tf32(dev):
    if dev.type == "cuda":
        # fp32 stays fp32 where a config asks for it: no TF32 in convs or matmuls
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False


def build_model(cfg, dev, seed, variables, remat: RematSpec = False) -> VeonModel:
    """The model on `dev` with weights from `variables` (a whole JAX
    variables tree as numpy arrays, strict on both sides) when given, else
    from a seeded random init; `remat` as `nn/rematutil.py` reads it."""
    with tracing.setup_span("setup.build_model"):
        _no_tf32(dev)
        model = VeonModel(cfg, device=dev, remat=remat)
        if variables is not None:
            load_from_jax(model, variables)
        else:
            init_random_(model, torch.Generator(device=dev).manual_seed(seed))
        return model


def _ov_weight(cfg: VeonConfig, dev, seed: int = 1):
    """A numpy-seeded open-vocabulary matrix standing in for the text
    classifier, and the vocabulary's merge matrix. Seed 1 is the JAX
    entry's (`__graft_entry__.entry`), seed 0 the JAX CLI's placeholder."""
    prompts, refl = text_mod.build_vocabulary(cfg.vocabulary)
    rng = np.random.default_rng(seed)
    ovw = torch.from_numpy(rng.standard_normal(
        (len(prompts) + 1, cfg.san.clip_embed_dim)).astype(np.float32)).to(dev)
    return ovw, text_mod.merge_matrix(refl)


def _with_presort(model: VeonModel, metas):
    """The rig metas plus the fixed rig's presorted lift streams
    ("lift_sorted"), from frame 0's geometry."""
    F, N = metas["intrins"].shape[1:3]
    s2k = sensor2keyego_chain(metas["sensor2egos"].reshape(1, -1, 4, 4),
                              metas["ego2globals"].reshape(1, -1, 4, 4), F, N)
    metas = dict(metas)
    metas["lift_sorted"] = model.lift.precompute_sorted(
        s2k[:, 0], metas["intrins"][:, 0], metas["post_rots"][:, 0],
        metas["post_trans"][:, 0], metas["bda"])
    return metas


def entry(cfg: Optional[VeonConfig] = None, device="cuda", seed: int = 0,
          variables: Optional[Mapping] = None):
    """(forward, (imgs, depth_imgs)) for `cfg` (default: veon_b in bf16);
    `ov_weight` is the numpy-seeded open-vocabulary matrix of the JAX entry."""
    dev = resolve_device(device)
    if cfg is None:
        cfg = presets.veon_b(compute_dtype="bfloat16")
    model = build_model(cfg, dev, seed, variables)
    imgs, depth_imgs, metas = example_batch_full(cfg, device=dev)
    ovw, membership = _ov_weight(cfg, dev)
    return FrameServer(model, _with_presort(model, metas), ovw, membership), (imgs, depth_imgs)


def temporal_entry(cfg: Optional[VeonConfig] = None, device="cuda", seed: int = 0,
                   variables: Optional[Mapping] = None, num_temporal: int = 2,
                   frames: int = 4):
    """(session, requests): a `TemporalSession` for `cfg` (default: veon_b
    with `num_temporal` frames, bf16) whose rig metas carry the fixed rig's
    presorted lift, and `frames` requests of the seeded synthetic drive
    (`cli/shapes.py` `example_drive`), in time order."""
    dev = resolve_device(device)
    if cfg is None:
        cfg = presets.veon_b(num_temporal=num_temporal, compute_dtype="bfloat16")
    model = build_model(cfg, dev, seed, variables)
    rig, requests = example_drive(cfg, frames, device=dev, seed=seed)
    ovw, membership = _ov_weight(cfg, dev)
    return TemporalSession(model, ovw, membership, rig_metas=_with_presort(model, rig)), requests


class Trainer:
    """A model in training with its optimizer state; calling it takes one
    stage-2 step on a batch and returns the losses."""

    def __init__(self, model: VeonModel, state: TrainState, step, membership):
        self.model, self.state, self.step, self.membership = model, state, step, membership

    def __call__(self, batch) -> Dict[str, torch.Tensor]:
        self.state, losses = self.step(self.state, batch)
        return losses


def train_batch(cfg: VeonConfig, device="cuda") -> Dict:
    """The synthetic stage-2 batch: the example rig and images, depth_imgs
    for the frozen depth tower, the seeded open-vocabulary matrix and
    random voxel labels (both from default_rng(7)), every voxel visible,
    epoch 0."""
    imgs, _depth, metas = example_batch(cfg, device=device)
    prompts, _refl = text_mod.build_vocabulary(cfg.vocabulary)
    rng = np.random.default_rng(7)
    ovw = rng.standard_normal((len(prompts) + 1, cfg.san.clip_embed_dim)).astype(np.float32)
    nx, ny, nz = cfg.grid.size
    labels = rng.integers(0, 18, size=(1, nx, ny, nz)).astype(np.int32)
    return {"imgs": imgs, "depth_imgs": example_depth_imgs(cfg, device=device), "metas": metas,
            "voxel_semantics": torch.from_numpy(labels).to(device),
            "mask_camera": torch.ones(1, nx, ny, nz, dtype=torch.int32, device=device),
            "ov_weight": torch.from_numpy(ovw).to(device), "epoch": 0}


def train_entry(cfg: Optional[VeonConfig] = None, device="cuda", seed: int = 0,
                variables: Optional[Mapping] = None, remat: RematSpec = False):
    """(trainer, batch) for `cfg` (default: veon_b in bf16): the stage-2
    trainable set (hsa, lift_fusion, alignnet), AdamW with warmup and the
    EMA from 10,560 updates, as `veon_tpu/train/step.py`; `remat` (default
    none, as `train_bench`'s model) recomputes the scan-stacked blocks in
    the backward (`nn/rematutil.py`)."""
    dev = resolve_device(device)
    if cfg is None:
        cfg = presets.veon_b(compute_dtype="bfloat16")
    model = build_model(cfg, dev, seed, variables, remat)
    _prompts, refl = text_mod.build_vocabulary(cfg.vocabulary)
    membership = text_mod.merge_matrix(refl)
    tx = AdamW()
    state = create_train_state(model, tx)
    return (Trainer(model, state, make_train_step(model, tx, cfg, membership), membership),
            train_batch(cfg, device=dev))


def build_text_tower(cfg: VeonConfig, device="cuda", seed: int = 0,
                     params: Optional[Mapping] = None) -> CLIPTextEncoder:
    """The CLIP text tower of `cfg` on `device`, in fp32 even where the
    model computes in bf16 (the JAX CLI builds it without a dtype). Weights
    from `params` (the JAX tower's params tree as numpy) when given, else a
    seeded random init made on the CPU, so one seed gives one tower on
    every device."""
    dev = resolve_device(device)
    _no_tf32(dev)
    s = cfg.san
    tower = CLIPTextEncoder(s.text_width, s.text_heads, s.text_layers, s.clip_embed_dim,
                            s.text_vocab_size, s.text_context_length)
    if params is not None:
        load_text_tower(tower, params)
    else:
        init_random_(tower, torch.Generator().manual_seed(seed))
    return tower.to(dev)


def serving_model(cfg: VeonConfig, device="cuda", seed: int = 0,
                  variables: Optional[Mapping] = None, text_tower: Optional[Mapping] = None,
                  bg_embed=None, logit_scale=None, bpe_path: Optional[str] = None,
                  model: Optional[VeonModel] = None):
    """(model, text tower, open-vocabulary weight, merge matrix) of the
    serving surface (counterpart of the model, classifier and tower that
    `veon_tpu/cli/main.py` `_build_model_and_params` builds): `model` when
    given (the CLI's checkpoint route, `cli/main.py` `checkpoint_model`),
    else as `build_model` builds it from `variables`; the text tower from
    `text_tower` (the JAX tower's params tree as numpy) or seeded, and the
    classifier over `cfg.vocabulary` through the tower (`nn/text.py`
    `text_classifier`) when the tower comes with `bg_embed` (1, C) and
    `logit_scale`, else the JAX CLI's placeholder, N(0, 1) from numpy's
    default_rng(0). A real tower without BPE merges, or with another
    vocabulary size than the config's, raises before anything encodes
    (the reference's refusals)."""
    dev = resolve_device(device)
    classify = text_tower is not None and bg_embed is not None and logit_scale is not None
    if classify:
        rows = np.shape(text_tower["token_embedding"]["embedding"])[0]
        text_mod.check_text_tower(cfg, text_mod.ClipTokenizer(bpe_path), rows)
    if model is None:
        model = build_model(cfg, dev, seed, variables)
    ovw, membership = _ov_weight(cfg, dev, seed=0)
    tower = build_text_tower(cfg, dev, seed, text_tower)
    if classify:
        prompts, _refl = text_mod.build_vocabulary(cfg.vocabulary)
        ovw = text_mod.text_classifier(cfg, prompts, tower, bg_embed, logit_scale, bpe_path)
    return model, tower, ovw, membership


# the request's tensors whose shapes the warm-up frame fixes
_FRAME_KEYS = ("imgs", "depth_imgs", "lidarego2global")


class ServeHandler:
    """The request handler of the socket server (counterpart of the one
    `veon_tpu/cli/main.py` `_build_serve_handler` builds); called with a
    request's tensors by name, it returns the response as numpy arrays.

    F=1 (`server`, a `FrameServer`): imgs (1, 1, N, H, W, 3) and depth_imgs
    -> pred (1, X, Y, Z) uint8. Streaming (`session`, a `TemporalSession`):
    one frame per request plus lidarego2global (1, 4, 4), in time order; a
    request holding `reset` zeroes the cache and answers {"ok": 1}. Either
    mode: text_embed (C,) or text_tokens (1, 77) int32 (through the text
    tower) adds `retrieval` (1, X, Y, Z). Frames must be uint8 with
    raw_uint8 (normalized on the device), else fp32.

    Every call computes on the handler's one worker thread, whichever
    thread calls it (the server calls from each connection's own thread):
    PyTorch keeps cuDNN's execution-plan cache and the cuBLAS handles per
    thread, so a request computed on a new thread builds them again (on an
    H100 a connection's first request took 0.7-1.8 s against ~0.15 s
    steady). Grad mode is per thread too: the worker runs under no_grad.
    Each call is one request of `utils/tracing.py` when tracing is on or a
    `torch.profiler` records: `serve.request` on the caller's thread, the
    check, upload, compute and readback spans on the worker under it.

    With a `cam_group` (the server or session sharded over it) every rank
    of the group holds a handler: the group's first rank (`leader`) is
    called by its server, checks each request and broadcasts it
    (`serve/camshard.py` `share_request`) before it computes; every other
    rank computes the same requests in `follow()`, which returns after the
    leader's `close()`. A request whose frames differ in shape from the
    warm-up frame's (`warm`) is refused before it is broadcast, and a
    follower whose compute raises logs it and takes the next request: the
    leader answers its client with the error."""

    def __init__(self, cfg: VeonConfig, tower: CLIPTextEncoder,
                 server: Optional[FrameServer] = None,
                 session: Optional[TemporalSession] = None, raw_uint8: bool = False,
                 cam_group: Optional[CamGroup] = None):
        self.cfg, self.text_tower = cfg, tower
        self.server, self.session, self.raw_uint8 = server, session, raw_uint8
        self.cam_group = cam_group
        self.leader = cam_group is None or cam_group.index == 0
        self.shapes: Dict[str, tuple] = {}
        self.device = tower.positional_embedding.device
        self._worker = ThreadPoolExecutor(max_workers=1, thread_name_prefix="veon-serve")

    def _tensor(self, x):
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.ascontiguousarray(x))
        return tracing.uploaded(x.to(self.device))

    def _check_img_dtype(self, req):
        """Refuse frames of the other mode's dtype: normalized fp32 frames
        into a raw-uint8 server, or raw uint8 into a float one, would both
        give well-formed garbage."""
        want = "uint8" if self.raw_uint8 else "float32"
        for k in ("imgs", "depth_imgs"):
            x = req[k]
            got = str(x.dtype).replace("torch.", "") if isinstance(x, torch.Tensor) \
                else str(np.asarray(x).dtype)
            if got != want:
                mode = "--raw-uint8" if self.raw_uint8 else "normalized-float"
                raise TypeError(f"{k} dtype {got} does not match this server's {mode} "
                                f"mode (expected {want})")

    def _embed(self, req):
        """The request's text embedding (C,) fp32, or None without text."""
        if "text_embed" in req:
            return self._tensor(req["text_embed"]).to(torch.float32)
        if "text_tokens" in req:
            return self.text_tower(self._tensor(req["text_tokens"]).to(torch.int32))[0]
        return None

    def __call__(self, **req) -> Dict[str, np.ndarray]:
        if not self.leader:
            raise RuntimeError("only the cam group's first rank takes requests; the others "
                               "follow()")
        return self._run(self._lead, req)

    def _run(self, fn, req):
        """fn(req) on the worker, one request of `utils/tracing.py` when
        tracing is on or a profiler records: `serve.request` on this
        thread, the worker's spans under it."""
        with tracing.request() as root:
            return self._worker.submit(self._attached, fn, req, root).result()

    @staticmethod
    def _attached(fn, req, root):
        with tracing.attach(root):
            return fn(req)

    def warm(self, **req) -> Dict[str, np.ndarray]:
        """Compute the warm-up frame, which every rank of a cam group holds,
        without broadcasting it; its frames' shapes are the ones every
        request must have."""
        self.shapes = {k: tuple(req[k].shape) for k in _FRAME_KEYS if k in req}
        return self._run(self._compute, req)

    def follow(self) -> None:
        """A cam rank after the first: compute each request the first rank
        broadcasts, until its `close()`."""
        while True:
            req = self._worker.submit(share_request, None, self.cam_group, self.device).result()
            if req is None:
                return
            try:
                self._run(self._compute, req)
            except Exception as e:  # the first rank reports it; keep following
                print(f"cam rank {self.cam_group.index}: request failed: "
                      f"{type(e).__name__}: {e}", file=sys.stderr, flush=True)

    def close(self) -> None:
        """The first rank of a cam group: end the other ranks' `follow()`."""
        if self.cam_group is not None and self.leader:
            self._worker.submit(share_request, None, self.cam_group, self.device).result()

    def _lead(self, req):
        with tracing.span("serve.check"):
            self._check(req)
        if self.cam_group is not None:
            req = share_request(req, self.cam_group, self.device)
        return self._compute(req)

    def _check(self, req) -> None:
        """Refuse a malformed request before any rank computes it."""
        if self.session is not None and "reset" not in req:
            missing = [k for k in ("imgs", "depth_imgs", "lidarego2global") if k not in req]
            if missing:
                raise KeyError(f"missing tensors: {missing} (or send a `reset` frame)")
        if self.session is None or "reset" not in req:
            self._check_img_dtype(req)
            for k, want in self.shapes.items():
                if k in req and tuple(req[k].shape) != want:
                    raise ValueError(f"{k} shape {tuple(req[k].shape)} is not this server's "
                                     f"{want}")

    @torch.no_grad()
    def _compute(self, req) -> Dict[str, np.ndarray]:
        if self.session is not None and "reset" in req:
            self.session.reset()
            return {"ok": np.int32(1)}
        te = self._embed(req)
        with tracing.span("serve.upload"):
            imgs, depth_imgs = self._tensor(req["imgs"]), self._tensor(req["depth_imgs"])
            if self.session is not None:
                metas = {"lidarego2global": self._tensor(req["lidarego2global"])}
        with tracing.span("serve.compute"):
            if self.session is not None:
                out = self.session.infer(imgs, depth_imgs, metas, text_embed=te)
            else:
                out = self.server.infer(imgs, depth_imgs, text_embed=te)
        with tracing.span("serve.readback"):
            resp = {"pred": tracing.read_back(out["pred"].cpu()).numpy()}
            if te is not None:
                resp["retrieval"] = tracing.read_back(out["retrieval"].cpu()).numpy()
        return resp


def serve_entry(cfg: Optional[VeonConfig] = None, device="cuda", seed: int = 0,
                variables: Optional[Mapping] = None, text_tower: Optional[Mapping] = None,
                bg_embed=None, logit_scale=None, bpe_path: Optional[str] = None,
                raw_uint8: bool = False, model: Optional[VeonModel] = None,
                cam_group: Optional[CamGroup] = None):
    """(handler, required request keys, expectation string, exclusive) of
    the socket server for `cfg` (default: veon_b in bf16), warmed on the
    example frames (mid-gray uint8 ones with raw_uint8) with an empty
    prompt's tokens.

    The model, text tower and classifier as `serving_model` builds them
    from `model` or `variables`, `text_tower`, `bg_embed`, `logit_scale`
    and `bpe_path`. cfg.num_temporal > 1 serves a streaming session, one
    connection at a time (exclusive). `cam_group` shards the cameras over
    its ranks, each of which calls this (`ServeHandler` says who serves):
    the rig's presort is then each shard's (`prepare_camshard_metas`)."""
    with tracing.setup_span("setup.serve_entry"):
        dev = resolve_device(device)
        if cfg is None:
            cfg = presets.veon_b(compute_dtype="bfloat16")
        with tracing.setup_span("setup.serving_model"):
            model, tower, ovw, membership = serving_model(cfg, dev, seed, variables, text_tower,
                                                          bg_embed, logit_scale, bpe_path, model)
        imgs, depth_imgs, metas = example_batch_full(cfg, device=dev)
        no_text = text_mod.ClipTokenizer().tokenize([""])  # warms the text path too
        norm = ("clipsan", cfg.data.depth_norm_method) if raw_uint8 else None
        if raw_uint8:
            imgs = torch.full(imgs.shape, 127, dtype=torch.uint8, device=dev)
            depth_imgs = torch.full(depth_imgs.shape, 127, dtype=torch.uint8, device=dev)

        def presorted(rig):
            with tracing.setup_span("setup.presort"):
                if cam_group is None:
                    return _with_presort(model, rig)
                return prepare_camshard_metas(cfg, rig, cam_group.size, presort=True)

        if cfg.num_temporal > 1:
            rig = {k: metas[k][:, 0:1] for k in ("sensor2egos", "ego2globals", "intrins",
                                                 "post_rots", "post_trans")}
            rig["bda"] = metas["bda"]
            session = TemporalSession(model, ovw, membership, rig_metas=presorted(rig),
                                      normalize=norm, cam_group=cam_group)
            handler = ServeHandler(cfg, tower, session=session, raw_uint8=raw_uint8,
                                   cam_group=cam_group)
            imgs, depth_imgs = imgs[:, 0:1], depth_imgs[:, 0:1]
            with tracing.setup_span("setup.warm"):
                handler.warm(imgs=imgs, depth_imgs=depth_imgs,
                             lidarego2global=metas["lidarego2global"], text_tokens=no_text)
            session.reset()
            required = ()  # reset frames carry no frames; the handler checks the keys
            expect = (f"expected per-frame imgs {tuple(imgs.shape)} {imgs.dtype}, depth_imgs "
                      f"{tuple(depth_imgs.shape)}, lidarego2global (1, 4, 4); optional "
                      f"text_embed/text_tokens for retrieval")
        else:
            server = FrameServer(model, presorted(metas), ovw, membership, normalize=norm,
                                 cam_group=cam_group)
            handler = ServeHandler(cfg, tower, server=server, raw_uint8=raw_uint8,
                                   cam_group=cam_group)
            with tracing.setup_span("setup.warm"):
                handler.warm(imgs=imgs, depth_imgs=depth_imgs, text_tokens=no_text)
            required = ("imgs", "depth_imgs")
            expect = (f"expected imgs {tuple(imgs.shape)} {imgs.dtype}, depth_imgs "
                      f"{tuple(depth_imgs.shape)}; optional text_embed/text_tokens for retrieval")
        return handler, required, expect, cfg.num_temporal > 1
