"""`--remat` on the CPU: recompute in the backward (`nn/rematutil.py`)
against the JAX reference's `nn.remat` step, fp32, tiny preset.

- One stage-2 step under none, full and dots_saveable equals JAX's step
  under the same spec (losses, gradients, moved BatchNorm stats), and the
  port's recomputing steps equal its own step without recompute bit for
  bit: the running stats moved once, not again in the recompute.
- What each policy recomputes, counted in the backward's dispatched ops.
- Train-mode BatchNorm in a region: its batch statistics in the recompute
  are the forward's even where the synced statistics would differ.
- The flag threads from `build_model_and_params` to every scan-stacked
  module (as `tests/test_train_bench.py`), and JAX's policy factories are
  refused.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from test_torch_common import np_tree, perturbed, to_np, to_torch
from test_torch_train import _adam_moments, _cfgs, _far_depth

from veon_tpu.cli.shapes import example_batch as j_example_batch
from veon_tpu.model.veon import VeonModel as JModel
from veon_tpu.nn import text as jtext
from veon_tpu.train import step as jstep

from veon_tpu_torch import collectives
from veon_tpu_torch.cli import main as pcli
from veon_tpu_torch.cli.shapes import example_depth_imgs
from veon_tpu_torch.ckpt.from_jax import state_dict_from_jax
from veon_tpu_torch.configs import presets
from veon_tpu_torch.entry import train_batch, train_entry
from veon_tpu_torch.model.veon import VeonModel
from veon_tpu_torch.nn import rematutil
from veon_tpu_torch.nn.alignnet import ResBlock3D
from veon_tpu_torch.nn.layers import BatchNorm, init_random_
from veon_tpu_torch.nn.vit import CLIPBlock, ScanBlocks

SPECS = {"none": False, "full": True, "dots_saveable": "dots_saveable"}


@pytest.fixture(scope="module")
def setup():
    """The banded tiny step's weights and batches (`test_torch_train.py`
    `stepped`, banded leg), and the port's step without recompute."""
    jcfg, tcfg = _cfgs(True)
    imgs, _depth, metas = j_example_batch(jcfg)
    batch = train_batch(tcfg, device="cpu")
    del batch["depth_imgs"]
    batch["depth"] = to_torch(_far_depth(tcfg))
    jbatch = {"imgs": imgs, "metas": metas, "ov_weight": jnp.asarray(to_np(batch["ov_weight"])),
              "voxel_semantics": jnp.asarray(to_np(batch["voxel_semantics"])),
              "mask_camera": jnp.asarray(to_np(batch["mask_camera"])),
              "epoch": jnp.asarray(0, jnp.int32), "depth": jnp.asarray(to_np(batch["depth"]))}
    model = JModel(cfg=jcfg)
    depth_imgs = jnp.asarray(to_np(example_depth_imgs(tcfg, device="cpu")))
    variables = perturbed(jax.jit(model.init, static_argnames=("train", "method"))(
        jax.random.PRNGKey(2), imgs, depth_imgs, metas, jbatch["ov_weight"], train=True,
        method=JModel.full_forward), seed=3)
    plain = _port_step(tcfg, variables, batch, False)
    return dict(jcfg=jcfg, tcfg=tcfg, batch=batch, jbatch=jbatch, variables=variables,
                plain=plain)


def _port_step(tcfg, variables, batch, remat):
    trainer, _ = train_entry(tcfg, device="cpu", variables=variables, remat=remat)
    losses = trainer(batch)
    return dict(model=trainer.model, state=trainer.state,
                losses={k: float(v) for k, v in losses.items()})


@pytest.fixture(scope="module", params=list(SPECS))
def stepped(request, setup):
    """One JAX step under `nn.remat` with the spec and one port step with it."""
    spec = SPECS[request.param]
    s = setup
    model = JModel(cfg=s["jcfg"], remat=spec)
    _, refl = jtext.build_vocabulary(s["jcfg"].vocabulary)
    jtx = jstep.make_optimizer(labels=jstep.trainable_mask(s["variables"]["params"],
                                                           jstep.stage2_trainable))
    jstate = jstep.create_train_state(model, jax.tree_util.tree_map(jnp.asarray, s["variables"]),
                                      jtx)
    jstate, jl = jstep.make_train_step(model, jtx, s["jcfg"], jtext.merge_matrix(refl),
                                       mesh=None)(jstate, s["jbatch"])
    port = s["plain"] if spec is False else _port_step(s["tcfg"], s["variables"], s["batch"],
                                                        spec)
    assert port["model"].remat == spec and port["model"].alignnet.remat == spec
    return dict(port, jstate=jstate, jlosses={k: float(v) for k, v in jl.items()}, spec=spec,
                plain=s["plain"])


def test_remat_step_losses_match_reference(stepped):
    """The loss dict at the train step's 2e-4 (`test_torch_train.py`), and
    bit-equal to the port's step without recompute."""
    got, want = stepped["losses"], stepped["jlosses"]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=2e-4, atol=2e-4, err_msg=k)
    assert got == stepped["plain"]["losses"]


def test_remat_step_gradients_match_reference(stepped):
    """Adam's first moment ((1 - b1) x the clipped gradient) within 1e-4 of
    the step's largest entry, as `test_train_step_gradients_match_reference`,
    and within 1e-6 of it against the port's step without recompute."""
    mu = state_dict_from_jax(stepped["model"],
                             {"params": _adam_moments(stepped["jstate"].opt_state)}, strict=False)
    got, plain = stepped["state"].opt_state.mu, stepped["plain"]["state"].opt_state.mu
    assert sorted(got) == sorted(mu) and len(got) > 10
    scale = max(np.abs(to_np(w)).max() for w in mu.values())
    for n, want in mu.items():
        np.testing.assert_allclose(to_np(got[n]), to_np(want), rtol=0, atol=1e-4 * scale,
                                   err_msg=n)
        np.testing.assert_allclose(to_np(got[n]), to_np(plain[n]), rtol=0, atol=1e-6 * scale,
                                   err_msg=n)


def test_remat_step_batch_stats_moved_once(stepped):
    """The running stats at the train step's 1e-4 / 1e-5 against JAX's
    (flax's remat moves them once), and bit-equal to the port's step
    without recompute: a second move in the recompute would show."""
    want = state_dict_from_jax(stepped["model"],
                               {"batch_stats": np_tree(stepped["jstate"].batch_stats)},
                               strict=False)
    bufs = dict(stepped["model"].named_buffers())
    plain = dict(stepped["plain"]["model"].named_buffers())
    assert sorted(want) == sorted(bufs)
    for n, w in want.items():
        np.testing.assert_allclose(to_np(bufs[n]), to_np(w), rtol=1e-4, atol=1e-5, err_msg=n)
        assert torch.equal(bufs[n], plain[n]), n


class _OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        self.counts[name] = self.counts.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


def _backward_ops(remat):
    """Dispatched op counts of the backward of two CLIP blocks under remat."""
    blocks = ScanBlocks(2, lambda: CLIPBlock(16, 2), remat)
    init_random_(blocks, torch.Generator().manual_seed(0))
    x = torch.randn(2, 7, 16, generator=torch.Generator().manual_seed(1), requires_grad=True)
    y = blocks(x).square().sum()
    with _OpCount() as c:
        y.backward()
    return c.counts, x.grad


@pytest.mark.parametrize("policy", ["full", "everything_saveable", "dots_saveable",
                                    "dots_with_no_batch_dims_saveable"])
def test_policy_selects_what_the_backward_recomputes(policy):
    """Counted in the backward's ops: full recomputes each block's attention
    and three of its four Dense products (addmm; the non-reentrant
    checkpoint stops once the saved tensors are back, before the last); everything_saveable nothing;
    dots_saveable neither the products nor the attention (a dot with batch
    dims, as JAX's attention einsums); dots_with_no_batch_dims_saveable the
    attention but not the products. The gradient is the same every time."""
    base, g0 = _backward_ops(False)
    got, g = _backward_ops(rematutil.parse_policy(policy))
    torch.testing.assert_close(g, g0, rtol=0, atol=0)
    attn = [k for k in base if "scaled_dot_product" in k]
    assert attn and all(base[k] == 2 for k in attn), base  # the two attention backwards
    extra_mm = got.get("addmm", 0) - base.get("addmm", 0)
    extra_attn = sum(got.get(k, 0) for k in got if "scaled_dot_product" in k) - 2
    want = {"full": (6, 2), "everything_saveable": (0, 0), "dots_saveable": (0, 0),
            "dots_with_no_batch_dims_saveable": (0, 2)}[policy]
    assert (extra_mm, extra_attn) == want, got


def test_batchnorm_in_a_region_reuses_its_batch_stats(monkeypatch):
    """A train-mode ResBlock3D recomputed under `full` while the synced
    statistics change from call to call (a stand-in for an all-reduce that
    would not repeat): the backward uses the forward's statistics, so the
    gradient and the moved stats equal the step without recompute, where
    the sync runs once per BatchNorm."""
    calls = []

    def sync_mean(t):
        calls.append(1)
        return t + 0.01 * (len(calls) - 1)  # another value each call, the same derivative

    monkeypatch.setattr(collectives, "data_parallel", lambda: True)
    monkeypatch.setattr(collectives, "sync_mean", sync_mean)
    out = {}
    for remat in (False, True):
        calls.clear()
        blk = ResBlock3D(4)
        init_random_(blk, torch.Generator().manual_seed(0))
        x = torch.randn(1, 3, 4, 5, 4, generator=torch.Generator().manual_seed(1),
                        requires_grad=True)
        fn = rematutil.remat_wrap(blk, remat)
        y = fn(x, True)
        calls_fwd = len(calls)
        (y * torch.linspace(-1, 1, y.numel()).reshape(y.shape)).sum().backward()
        out[remat] = (x.grad, [b.clone() for b in blk.buffers()], calls_fwd, len(calls))
    (g0, b0, f0, n0), (g1, b1, f1, n1) = out[False], out[True]
    assert f0 == f1 == n0 == 2 and n1 == 4  # the recompute synced again
    torch.testing.assert_close(g1, g0, rtol=0, atol=0)
    for a, b in zip(b1, b0):
        assert torch.equal(a, b)


def test_remat_policy_flag_threads_to_model():
    """`train --remat dots_saveable` reaches every scan-stacked module (train
    only; eval builds never recompute), as JAX's `_build_model_and_params`."""
    cfg = presets.veon_tiny_test()

    def remat_of(**kw):
        model = pcli.build_model_and_params(cfg, device="cpu", **kw)[0]
        mods = [m for n, m in model.named_modules()
                if hasattr(m, "remat") and not n.startswith("depth.")]
        assert {type(m).__name__ for m in mods} == {
            "VeonModel", "ScanBlocks", "SideAdapterNetwork", "CLIPRecHead",
            "HighresSideAdaptor", "AlignNet3D"}
        assert len({m.remat for m in mods}) == 1
        # the frozen depth tower is no scan JAX recomputes
        assert {m.remat for m in model.depth.modules() if hasattr(m, "remat")} == {False}
        return model.remat

    assert remat_of(train=True, remat_policy="dots_saveable") == "dots_saveable"
    assert remat_of(train=True, remat_policy=None) is True
    assert remat_of(train=True, remat_policy=False) is False
    assert remat_of(train=False, remat_policy="dots_saveable") is False


def test_parse_policy_tokens():
    assert rematutil.parse_policy("true") is True
    assert rematutil.parse_policy("full") is True
    assert rematutil.parse_policy("false") is False
    assert rematutil.parse_policy("none") is False
    assert rematutil.parse_policy(" dots_saveable ") == "dots_saveable"


@pytest.mark.parametrize("name", ["save_only_these_names", "save_anything_except_these_names",
                                  "offload_dot_with_no_batch_dims", "dots_savable"])
def test_factory_and_unknown_policies_are_refused(name):
    """JAX's policy factories name tensors the port does not tag: refused,
    named; an unknown name too, before a model is built."""
    with pytest.raises(ValueError, match="factory" if "names" in name or "offload" in name
                       else "unknown"):
        rematutil.check_policy(name)
    with pytest.raises(ValueError):
        VeonModel(presets.veon_tiny_test(), device="cpu", remat=name)
