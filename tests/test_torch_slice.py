"""The port's F=1 serving slice as a whole against the JAX reference on the
CPU: `veon_tpu_torch.entry` with weights carried over by `from_jax` vs
`VeonModel.full_forward` with the presorted lift, tiny preset, fp32."""

import numpy as np
import pytest
import torch

from test_torch_common import port_tiny_cfg, tiny_reference, to_np

from veon_tpu_torch import entry as entry_mod
from veon_tpu_torch.ckpt.from_jax import state_dict_from_jax
from veon_tpu_torch.model.veon import VeonModel


@pytest.fixture(scope="module")
def served():
    ref = tiny_reference()
    server, (imgs, depth_imgs) = entry_mod.entry(port_tiny_cfg(), device="cpu",
                                                 variables=ref["variables"])
    return ref, server, imgs, depth_imgs, server.outputs(imgs, depth_imgs)


def test_entry_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry_mod.entry(port_tiny_cfg())


def test_example_batch_matches_reference(served):
    ref, server, imgs, depth_imgs, _ = served
    np.testing.assert_array_equal(to_np(imgs), np.asarray(ref["imgs"]))
    np.testing.assert_array_equal(to_np(depth_imgs), np.asarray(ref["depth_imgs"]))
    np.testing.assert_array_equal(to_np(server.ov_weight), np.asarray(ref["ovw"]))


@pytest.mark.parametrize("key", ["order", "rk_pooled", "ranks"])
def test_rig_precompute_integer_equal(served, key):
    ref, server, *_ = served
    np.testing.assert_array_equal(to_np(server.metas["lift_sorted"][key]),
                                  np.asarray(ref["metas"]["lift_sorted"][key]))


# tolerance of the JAX camera-sharded serving check for this graph
@pytest.mark.parametrize("key", ["bin_occ", "feat_occ", "sem_occ_raw", "sem_seg_ds",
                                 "sem_embed_ds", "clip_feat"])
def test_full_forward_matches_reference(served, key):
    ref, *_, out = served
    got = to_np(out[key])
    assert got.dtype == np.float32 and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref["out"][key], rtol=2e-4, atol=2e-4)


def test_class_grid_matches_reference(served):
    """Identical wherever the decision is not a near-tie: top-2 merged-logit
    margin and |softmax(bin)[0] - 0.5| both above 1e-3 (>= 99% of voxels)."""
    import jax.numpy as jnp

    from veon_tpu.model.veon import fusion_rule
    from veon_tpu.nn import text as text_ref

    ref, server, imgs, depth_imgs, _ = served
    membership = text_ref.merge_matrix(ref["refl"])
    merged = np.asarray(text_ref.merge_classes_max(jnp.asarray(ref["out"]["sem_occ_raw"]),
                                                   membership, axis=-1))
    want = np.asarray(fusion_rule(jnp.asarray(merged), jnp.asarray(ref["out"]["bin_occ"])))
    got = to_np(server(imgs, depth_imgs))
    assert got.dtype == np.int32 and got.shape == want.shape
    top2 = np.sort(merged, -1)[..., -2:]
    b = ref["out"]["bin_occ"]
    p0 = 1.0 / (1.0 + np.exp(b[..., 1] - b[..., 0]))
    clear = ((top2[..., 1] - top2[..., 0]) > 1e-3) & (np.abs(p0 - 0.5) > 1e-3)
    clear = clear.transpose(0, 3, 2, 1)
    assert clear.mean() >= 0.99, clear.mean()
    np.testing.assert_array_equal(got[clear], want[clear])
    assert 0.05 < (want != 17).mean() < 0.95  # both branches of the rule occur


def test_from_jax_consumes_every_leaf_and_fills_every_entry():
    ref = tiny_reference()
    model = VeonModel(port_tiny_cfg(), device="cpu")
    sd = state_dict_from_jax(model, ref["variables"])
    assert set(sd) == set(model.state_dict())
    extra = dict(ref["variables"])
    extra["params"] = dict(extra["params"], stray={"kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(ValueError, match="not consumed"):
        state_dict_from_jax(model, extra)
    short = dict(ref["variables"])
    short["params"] = {k: v for k, v in short["params"].items() if k != "hsa"}
    with pytest.raises(ValueError, match="no JAX leaf"):
        state_dict_from_jax(model, short)
