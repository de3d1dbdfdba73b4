"""The port's metrics against the JAX package's on the CPU: the confusion
histogram and mIoU (Occ3D), the retrieval average precision (POP-3D) and
the occupancy F-score, on seeded grids. Histograms and F-score counts
exact, floats within 1e-9."""

import numpy as np
import pytest
import torch

from veon_tpu import eval as jeval
from veon_tpu.eval.fscore import FScoreMetric as JaxFScore
from veon_tpu_torch import eval as peval

SHAPE = (20, 20, 8)


def _grids(seed):
    """pred over [-2, 20) (out of range both ways), gt over 0..17 with 255s,
    a camera mask."""
    rng = np.random.default_rng(seed)
    pred = rng.integers(-2, 20, SHAPE).astype(np.int32)
    gt = rng.integers(0, 18, SHAPE).astype(np.int32)
    gt[rng.random(SHAPE) < 0.1] = 255
    mask = (rng.random(SHAPE) < 0.7).astype(np.uint8)
    return pred, gt, mask


@pytest.mark.parametrize("masked", [True, False])
def test_confusion_hist_matches_reference(masked):
    import jax.numpy as jnp

    pred, gt, mask = _grids(0)
    m = mask if masked else None
    got = peval.confusion_hist(torch.from_numpy(pred), torch.from_numpy(gt),
                               None if m is None else torch.from_numpy(m))
    want = np.asarray(jeval.confusion_hist(jnp.asarray(pred), jnp.asarray(gt),
                                           None if m is None else jnp.asarray(m)))
    assert tuple(got.shape) == (18, 18)
    np.testing.assert_array_equal(got.numpy(), want)
    u8 = peval.confusion_hist(torch.from_numpy(np.clip(pred, 0, 17).astype(np.uint8)),
                              torch.from_numpy(gt), None)
    assert int(u8.sum()) == int((gt != 255).sum())


def test_miou_metric_matches_reference(capsys):
    port, ref = peval.MIoUMetric(), jeval.MIoUMetric()
    for seed in range(3):
        pred, gt, mask = _grids(seed)
        port.add_batch(pred, gt, mask_camera=mask)
        ref.add_batch(pred, gt, mask_camera=mask)
    np.testing.assert_array_equal(port.hist, ref.hist)
    names, iou, miou = port.count_miou()
    want_names, want_iou, want_miou = ref.count_miou()
    assert names == want_names == peval.OCC3D_CLASS_NAMES
    np.testing.assert_allclose(iou, want_iou, rtol=0, atol=1e-9)
    assert abs(miou - want_miou) <= 1e-9
    empty = np.zeros((18, 18), np.int64)
    empty[0, 0] = 3  # classes never seen give NaN, as the reference's
    np.testing.assert_array_equal(np.isnan(peval.per_class_iou(empty)),
                                  np.isnan(jeval.per_class_iou(empty)))
    assert "mIoU of 3 samples" in capsys.readouterr().out


@pytest.mark.parametrize("case", ["random", "ties", "no_positive", "all_positive"])
def test_average_precision_matches_reference(case):
    rng = np.random.default_rng(1)
    labels = (rng.random(500) < 0.3).astype(np.int64)
    scores = rng.standard_normal(500)
    if case == "ties":
        scores = np.round(scores, 1)
    elif case == "no_positive":
        labels[:] = 0
    elif case == "all_positive":
        labels[:] = 1
    got, want = peval.average_precision(labels, scores), jeval.average_precision(labels, scores)
    if case == "no_positive":
        assert np.isnan(got) and np.isnan(want)
    else:
        assert abs(got - want) <= 1e-9


def test_retrieval_scores_match_reference():
    rng = np.random.default_rng(2)
    occ_feat = rng.standard_normal(SHAPE + (16,)).astype(np.float32)
    occ_feat[0, 0, 0] = 0.0  # a zero feature: the eps-guarded cosine
    q = rng.standard_normal(16).astype(np.float32)
    pts = np.stack([rng.integers(0, n, 300) for n in SHAPE], -1)
    pts[0] = 0
    anno = (rng.random(300) < 0.2).astype(np.int64)
    visible = np.flatnonzero(rng.random(300) < 0.6)
    got = peval.retrieval_scores(occ_feat, q, pts, visible, anno)
    want = jeval.retrieval_scores(occ_feat, q, pts, visible, anno)
    assert got.keys() == want.keys()
    for k in got:
        assert abs(got[k] - want[k]) <= 1e-9, k


def _adjacent(seed):
    """gt's block shifted one voxel along x in pred (its far face lies
    exactly one 0.4 m step from gt: on the `<` threshold, where float
    rounding decides), plus pred blocks away from gt and void voxels."""
    rng = np.random.default_rng(seed)
    gt = np.full((40, 40, 16), 17, np.int32)
    gt[5:15, 5:15, 2:6] = 4
    gt[rng.random(gt.shape) < 0.05] = 11
    pred = np.full_like(gt, 17)
    pred[6:16, 5:15, 2:6] = 4
    pred[5:15, 20:30, 3:7] = 11
    pred[22:30, 22:30, 8:9] = 255
    mask = (rng.random(gt.shape) < 0.9).astype(np.uint8)
    return pred, gt, mask


@pytest.mark.parametrize("case", ["random", "adjacent", "empty"])
def test_fscore_matches_reference(case, capsys):
    port, ref = peval.FScoreMetric(), JaxFScore()
    for seed in range(2):
        if case == "random":
            pred, gt, mask = _grids(seed)
        elif case == "adjacent":
            pred, gt, mask = _adjacent(seed)
        else:
            pred, gt, mask = _grids(seed)
            pred[:] = 17
        port.add_batch(pred, gt, mask_camera=mask)
        ref.add_batch(pred, gt, mask_camera=mask)
    # accuracy and completeness are means of threshold counts: equal exactly
    assert (port.tot_acc, port.tot_cmpl, port.cnt) == (ref.tot_acc, ref.tot_cmpl, ref.cnt)
    got, want = port.count_fscore(), ref.count_fscore()
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-9, k
    if case == "adjacent":
        assert 0.0 < got["accuracy"] < 1.0  # both sides of the threshold occur
    capsys.readouterr()
