"""``kbe_torch.models.maskrcnn`` against ``kbe_tpu.models.maskrcnn`` (CPU),
on the same numpy inputs made from seeds, at full width (the only width
the model has), on 64^2 images with ``MaskRCNN(num_proposals=32,
pre_nms_top_n=64, num_detections=8)`` as ``tests/test_maskrcnn.py`` runs
it. The weights are a synthetic torchvision-layout state dict
(``synthetic_maskrcnn_state_dict``), converted by each package's own
``convert_maskrcnn``. No trained weights are in the repository.

Tolerances: the resizes' indices and the NMS's kept set are exact; the box
geometry 1e-6 of the largest coordinate (XLA's and PyTorch's f32 ``exp``
differ by an ulp, and a corner, the centre less half the width, cancels);
ROIAlign and the paste atol 1e-5 (sums of four products in another
order); the mask source's masks equal on 99.9 % of the pixels (its
antialiased resize is a dense f32 sum in another order); the whole model
1e-4 relative on the FPN
features (53 convolutions summed in another order), equal labels, boxes
within 1e-2 px and the masks equal on at least 99.9 % of the pixels, with
at least one detection above the mask source's 0.5.
"""

import argparse

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import cli.train as JT
import cli.train_torch as T
from kbe_tpu.models import maskrcnn as J
from kbe_tpu.utils import torch_convert as tc
from kbe_torch.models import maskrcnn as P
from kbe_torch.ops import nms as N
from kbe_torch.ops.resize import resize_bilinear_antialias, resize_nearest
from kbe_torch.utils.reference_convert import convert_maskrcnn, \
    synthetic_maskrcnn_state_dict

SMALL = dict(num_proposals=32, pre_nms_top_n=64, num_detections=8)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def state_dict():
    return synthetic_maskrcnn_state_dict(0)


@pytest.fixture(scope="module")
def trees(state_dict):
    return tc.convert_maskrcnn(state_dict), convert_maskrcnn(state_dict)


# ------------------------------------------------------------------ resizes

@pytest.mark.parametrize("m,n", [(378, 189), (756, 189), (512, 256), (7, 3),
                                 (13, 29)])
def test_resize_nearest_matches_jax(m, n):
    x = np.arange(2 * m * 3, dtype=np.float32).reshape(2, m, 3)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, n, 3), "nearest"))
    got = resize_nearest(torch.from_numpy(x), (2, n, 3)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("src,dst", [((150, 350), (110, 256)),
                                     ((24, 32), (48, 64))],
                         ids=["downsample", "upsample"])
def test_resize_bilinear_antialias_matches_jax(src, dst):
    """JAX's CPU resize is a dense product whose f32 sum strays up to a few
    1e-6 from float64 on a downsample; the port's must be at least as close
    to float64 with JAX's own weights, and within 1e-5 of JAX."""
    from jax._src.image.scale import _fill_triangle_kernel, \
        compute_weight_mat

    x = np.random.default_rng(3).uniform(size=src + (3,)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), dst + (3,),
                                       "bilinear"))
    got = resize_bilinear_antialias(torch.from_numpy(x), *dst).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    wy, wx = (np.asarray(compute_weight_mat(a, b, b / a, 0.0,
                                            _fill_triangle_kernel, True),
                         np.float64) for a, b in zip(src, dst))
    exact = np.einsum("hwc,wW->hWc", x.astype(np.float64), wx)
    exact = np.einsum("hWc,hH->HWc", exact, wy)
    assert np.abs(got - exact).max() <= max(np.abs(want - exact).max(),
                                            2e-7)


# -------------------------------------------------------------- conv5_mask

def test_conv5_mask_applies_torchvision_kernel_flipped(state_dict, trees):
    """``kbe_tpu``'s converter gives Flax's ConvTranspose torchvision's
    (in, out, kh, kw) kernel as (kh, kw, in, out) with no flip, and Flax
    applies it flipped in both axes against ``F.conv_transpose2d``: from
    real torchvision weights both packages deconvolve with a spatially
    flipped 2x2 kernel. The port reproduces ``kbe_tpu``."""
    w_tv = torch.from_numpy(state_dict[
        "roi_heads.mask_predictor.conv5_mask.weight"])
    b_tv = torch.from_numpy(state_dict[
        "roi_heads.mask_predictor.conv5_mask.bias"])
    x = np.random.default_rng(4).normal(size=(1, 5, 6, 256)).astype(
        np.float32)
    tree = trees[0]["params"]["mask_head"]["conv5_mask"]
    flax_out = np.asarray(fnn.ConvTranspose(256, (2, 2), strides=(2, 2))
                          .apply({"params": tree}, jnp.asarray(x)))
    head = P.load_maskrcnn(trees[1], device="cpu", **SMALL).mask_head
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        port = head.conv5_mask(xt)
        flipped = F.conv_transpose2d(xt, w_tv.flip(2, 3), b_tv, stride=2)
        torchvision = F.conv_transpose2d(xt, w_tv, b_tv, stride=2)
    np.testing.assert_allclose(port.permute(0, 2, 3, 1).numpy(), flax_out,
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(port.numpy(), flipped.numpy(), rtol=0,
                               atol=1e-5)
    assert np.abs(port.numpy() - torchvision.numpy()).max() > 0.1


def test_convert_maskrcnn_matches_kbe_tpu(trees):
    """The port's converter gives ``kbe_tpu``'s tree, leaf for leaf and bit
    for bit, and the tree loads strictly into the port's module."""
    flat_j = dict(jax.tree_util.tree_flatten_with_path(trees[0])[0])
    flat_p = dict(jax.tree_util.tree_flatten_with_path(trees[1])[0])
    assert flat_j.keys() == flat_p.keys()
    for k in flat_j:
        np.testing.assert_array_equal(np.asarray(flat_p[k]),
                                      np.asarray(flat_j[k]), err_msg=str(k))
    model = P.load_maskrcnn(trees[1], device="cpu")
    assert sum(p.numel() for p in model.parameters()) == sum(
        np.asarray(v).size for v in flat_p.values())


# ---------------------------------------------------------------- geometry

def _boxes(rng, n, size=64.0):
    xy = rng.uniform(-8, size, (n, 2))
    wh = rng.uniform(0.5, size / 2, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


@pytest.mark.parametrize("what", ["decode", "decode_weighted", "anchors",
                                  "iou"])
def test_box_geometry_matches_jax(what):
    rng = np.random.default_rng(5)
    boxes = _boxes(rng, 200)
    deltas = rng.normal(0, 2, (200, 4)).astype(np.float32)
    deltas[:3, 2:] = [[30.0, -30.0], [5.0, 5.0], [-25.0, 4.2]]  # the clips
    if what == "decode":
        want = J._decode(jnp.asarray(boxes), jnp.asarray(deltas))
        got = P._decode(torch.from_numpy(boxes), torch.from_numpy(deltas))
    elif what == "decode_weighted":
        want = J._decode(jnp.asarray(boxes), jnp.asarray(deltas), 10.0,
                         10.0, 5.0, 5.0)
        got = P._decode(torch.from_numpy(boxes), torch.from_numpy(deltas),
                        10.0, 10.0, 5.0, 5.0)
    elif what == "anchors":
        want = jnp.concatenate([J._anchors_for_level(5, 7, 2 ** (i + 2), s)
                                for i, s in enumerate(J._ANCHOR_SIZES)])
        got = torch.cat([P._anchors_for_level(5, 7, 2 ** (i + 2), s)
                         for i, s in enumerate(P._ANCHOR_SIZES)])
    else:
        want = J._iou_matrix(jnp.asarray(boxes))
        got = N.iou_matrix(torch.from_numpy(boxes))
    # rtol 1e-6 of the largest coordinate: a corner is the centre less
    # half the width, which cancels
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


def _nms_case(case):
    rng = np.random.default_rng(6)
    n = 96
    boxes = _boxes(rng, n)
    scores = rng.uniform(0.01, 1.0, n).astype(np.float32)
    if case == "ties":
        scores = np.round(scores * 4) / 4   # four values, many equal
        scores[scores == 0] = 0.25
    elif case == "zero_slots":
        scores[rng.uniform(size=n) < 0.3] = 0.0
    elif case == "full_overlap":
        boxes[1::2] = boxes[0::2]          # each box twice, equal scores
        scores[1::2] = scores[0::2]
    return boxes, scores


@pytest.mark.parametrize("case", ["random", "ties", "zero_slots",
                                  "full_overlap"])
def test_nms_keep_matches_jax(case):
    boxes, scores = _nms_case(case)
    want = np.asarray(J._nms_keep(jnp.asarray(boxes), jnp.asarray(scores),
                                  0.5))
    got = P._nms_keep(torch.from_numpy(boxes), torch.from_numpy(scores), 0.5)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < (want > 0).sum() < (scores > 0).sum()
    # several sets at once, as the RPN levels go: each is its own set
    sets = [(torch.from_numpy(boxes[:k]), torch.from_numpy(scores[:k]))
            for k in (96, 40, 7)]
    for (b, s), kept in zip(sets, N.nms_keep_sets(sets, 0.5)):
        want = np.asarray(J._nms_keep(jnp.asarray(b.numpy()),
                                      jnp.asarray(s.numpy()), 0.5))
        np.testing.assert_array_equal(kept.numpy(), want)


def test_roi_align_pyramid_matches_jax():
    """Boxes of every FPN level (P2..P5 of a 512^2 image, 4 channels),
    some past the image's border."""
    rng = np.random.default_rng(7)
    feats = [rng.normal(size=(1, 512 >> (i + 2), 512 >> (i + 2), 4))
             .astype(np.float32) for i in range(4)]
    xy = rng.uniform(-20, 500, (40, 2))
    wh = np.exp(rng.uniform(np.log(4), np.log(600), (40, 2)))
    boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    lvl = np.floor(4 + np.log2(np.sqrt(wh.prod(1)) / 224))
    assert set(np.clip(lvl, 2, 5)) == {2, 3, 4, 5}
    for out in (7, 14):
        want = np.asarray(J._roi_align_pyramid(
            [jnp.asarray(f) for f in feats], jnp.asarray(boxes), out))
        got = P._roi_align_pyramid([torch.from_numpy(f[0]) for f in feats],
                                   torch.from_numpy(boxes), out)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_paste_masks_matches_jax():
    rng = np.random.default_rng(8)
    masks = rng.uniform(size=(12, 28, 28)).astype(np.float32)
    boxes = _boxes(rng, 12, size=48.0)
    boxes[0] = [10.0, 10.0, 10.4, 10.2]   # under a pixel: widened to 1
    want = np.asarray(J._paste_masks(jnp.asarray(masks), jnp.asarray(boxes),
                                     40, 48))
    got = P._paste_masks(torch.from_numpy(masks), torch.from_numpy(boxes),
                         40, 48)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


# ------------------------------------------------------------ whole model

def test_model_matches_jax(trees):
    """Two 64^2 images through both models, each on its own package's
    converted tree from one torchvision-layout state dict."""
    images = np.random.default_rng(9).uniform(size=(2, 64, 64, 3)).astype(
        np.float32)
    jmodel = J.MaskRCNN(**SMALL)
    want = jax.jit(jmodel.apply)(trees[0], jnp.asarray(images))
    xj = (jnp.asarray(images) - J._IMAGENET_MEAN) / J._IMAGENET_STD
    feats_j = jax.jit(J.ResNet50FPN().apply)(
        {"params": trees[0]["params"]["backbone"]}, xj)
    model = P.load_maskrcnn(trees[1], device="cpu", **SMALL)
    with torch.no_grad():
        got = model(torch.from_numpy(images))
        feats = model.features(torch.from_numpy(images))
    for fj, fp in zip(feats_j, feats):
        fj = np.asarray(fj)
        err = np.abs(fp.permute(0, 2, 3, 1).numpy() - fj).max()
        assert err <= 1e-4 * np.abs(fj).max(), err
    want = {k: np.asarray(v) for k, v in want.items()}
    got = {k: v.numpy() for k, v in got.items()}
    assert got["masks"].shape == want["masks"].shape == (2, 8, 64, 64)
    np.testing.assert_array_equal(got["labels"], want["labels"])
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=0,
                               atol=1e-2)
    assert ((got["masks"] > 0.5) == (want["masks"] > 0.5)).mean() >= 0.999
    np.testing.assert_allclose(got["masks"], want["masks"], rtol=0,
                               atol=1e-3)
    assert (want["scores"] > 0.5).sum() >= 1
    binary = P.maskrcnn_instance_masks(model, torch.from_numpy(images))
    assert binary.shape == (2, 8, 64, 64, 1) and binary.sum() > 0


def test_mask_source_matches_jax(state_dict, tmp_path):
    """``resolve_mask_source``'s callable against ``cli/train.py``'s on the
    same ``.pth``, with a 64^2 canvas: one image downsampled onto it (JAX's
    antialiased bilinear), one upsampled; the masks come back at each
    image's size."""
    path = tmp_path / "maskrcnn.pth"
    torch.save({k: torch.from_numpy(v) for k, v in state_dict.items()},
               path)
    args = argparse.Namespace(mask_source="maskrcnn",
                              maskrcnn_weights=str(path), device="cpu")
    ours = T.resolve_mask_source(args, max_instances=8, infer_size=64)
    theirs = JT.resolve_mask_source(args, max_instances=8, infer_size=64)
    rng = np.random.default_rng(10)
    for shape in ((40, 100, 3), (1, 24, 32, 3)):
        image = rng.uniform(size=shape).astype(np.float32)
        got, want = ours(image, None), theirs(image, None)
        assert got.shape == want.shape == (
            shape[:-3] + (8,) + shape[-3:-1] + (1,))
        assert (got == want).mean() >= 0.999
        assert want.sum() > 0
    assert T.resolve_mask_source(argparse.Namespace(
        mask_source="depth")) == "depth"
    with pytest.raises(SystemExit, match="--maskrcnn-weights"):
        T.resolve_mask_source(argparse.Namespace(
            mask_source="maskrcnn", maskrcnn_weights=None, device="cpu"))
