"""Reference PyTorch checkpoints -> Flax-shaped param trees -> the port's
nets. Port of the inference part of ``kbe_tpu/utils/torch_convert.py``.

The reference's released ``.tar`` checkpoints (its ``{nb_iter,
model_state_dict, ...}`` format and raw state dicts) name their modules by
strings (``2x0 - 3x0`` lattice keys, ``moduleMain.1``). The converters here
map them onto the systematic ``blk/down/up`` naming as trees of numpy
arrays shaped like the Flax params:

  - conv weights (O, I, kh, kw) -> kernels (kh, kw, I, O)
  - PReLU weights -> per-channel ``slope``
  - the frozen batch norm of the VGG19-bn Semantics and of Inception-v3
    folded into the preceding conv: W' = W * g/sqrt(v+eps), b' = beta +
    (b - mean) * g/sqrt(v+eps)
  - a spectral-norm checkpoint's ``weight_orig``/``weight_u``/``weight_v``
    materialised to the plain weight ``weight_orig / sigma``

``kbe_torch.utils.convert.state_dict_from_flax`` then carries such a tree
into a ``kbe_torch`` module, the one function that carries weights across.
``convert_maskrcnn`` maps torchvision's ``maskrcnn_resnet50_fpn`` weights
(frozen batch norm folded at eps 0), and ``synthetic_maskrcnn_state_dict``
draws such weights from a seed: no trained ones are in the repository.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np

from kbe_torch.utils.convert import load_flax


def _load_state_dict(path: str) -> Dict[str, np.ndarray]:
    import torch

    blob = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(blob, dict) and "model_state_dict" in blob:
        blob = blob["model_state_dict"]
    sd = {k: v.detach().numpy() if hasattr(v, "detach") else np.asarray(v)
          for k, v in blob.items()}
    return _materialize_spectral_norm(sd)


def _materialize_spectral_norm(sd: Dict[str, np.ndarray]) -> Dict:
    """Plain ``.weight`` entries from torch spectral-norm state.

    A checkpoint saved with spectral norm on stores ``weight_orig``,
    ``weight_u`` and ``weight_v`` instead of ``weight``; at eval torch
    divides by sigma = u^T W v with the stored vectors. A converted
    discriminator therefore loads into a ``spectral_norm=False`` module."""
    out = dict(sd)
    for k in list(sd):
        if not k.endswith(".weight_orig"):
            continue
        base = k[:-len("_orig")]
        w = sd[k]
        wm = w.reshape(w.shape[0], -1)
        u = sd.get(base + "_u")
        v = sd.get(base + "_v")
        if u is None:
            u = np.ones(w.shape[0], w.dtype)
            u /= np.linalg.norm(u) + 1e-12
        if v is None:
            v = wm.T @ u
            v /= np.linalg.norm(v) + 1e-12
        sigma = float(u @ (wm @ v))
        out[base] = w / sigma
        for suffix in ("_orig", "_u", "_v"):
            out.pop(base + suffix, None)
    return out


def _conv(sd, key):
    w = sd[f"{key}.weight"]
    out = {"kernel": np.transpose(w, (2, 3, 1, 0))}
    if f"{key}.bias" in sd:
        out["bias"] = sd[f"{key}.bias"]
    return out


def _conv_bn_folded(sd, conv_key, bn_key, eps=1e-5):
    w = sd[f"{conv_key}.weight"]
    b = sd.get(f"{conv_key}.bias", np.zeros(w.shape[0], w.dtype))
    g = sd[f"{bn_key}.weight"]
    beta = sd[f"{bn_key}.bias"]
    mean = sd[f"{bn_key}.running_mean"]
    var = sd[f"{bn_key}.running_var"]
    scale = g / np.sqrt(var + eps)
    w = w * scale[:, None, None, None]
    b = beta + (b - mean) * scale
    return {"kernel": np.transpose(w, (2, 3, 1, 0)), "bias": b}


def _prelu(sd, key):
    return {"slope": sd[f"{key}.weight"].reshape(-1)}


def _basic(sd, key, kind: str):
    """Reference Basic -> the ``Basic`` tree (``models/layers.py``)."""
    out = {}
    if kind == "relu-conv-relu-conv":
        out["prelu1"] = _prelu(sd, f"{key}.moduleMain.0")
        out["conv1"] = _conv(sd, f"{key}.moduleMain.1")
        out["prelu2"] = _prelu(sd, f"{key}.moduleMain.2")
        out["conv2"] = _conv(sd, f"{key}.moduleMain.3")
    else:  # conv-relu-conv
        out["conv1"] = _conv(sd, f"{key}.moduleMain.0")
        out["prelu2"] = _prelu(sd, f"{key}.moduleMain.1")
        out["conv2"] = _conv(sd, f"{key}.moduleMain.2")
    if f"{key}.moduleShortcut.weight" in sd:
        out["shortcut"] = _conv(sd, f"{key}.moduleShortcut")
    return out


def _down(sd, key):
    return {
        "prelu1": _prelu(sd, f"{key}.moduleMain.0"),
        "conv1": _conv(sd, f"{key}.moduleMain.1"),
        "prelu2": _prelu(sd, f"{key}.moduleMain.2"),
        "conv2": _conv(sd, f"{key}.moduleMain.3"),
    }


def _up(sd, key):
    return {
        "prelu1": _prelu(sd, f"{key}.moduleMain.1"),
        "conv1": _conv(sd, f"{key}.moduleMain.2"),
        "prelu2": _prelu(sd, f"{key}.moduleMain.3"),
        "conv2": _conv(sd, f"{key}.moduleMain.4"),
    }


def _lattice(sd, rows: int):
    """Columns 1..3 of a grid net (string-keyed reference modules)."""
    out = {}
    for c in (1, 2, 3):
        for r in range(rows):
            out[f"blk{r}x{c}"] = _basic(sd, f"{r}x{c - 1} - {r}x{c}",
                                        "relu-conv-relu-conv")
    for r in range(1, rows):
        out[f"down{r}x1"] = _down(sd, f"{r - 1}x1 - {r}x1")
    for c in (2, 3):
        for r in range(rows - 1):
            out[f"up{r}x{c}"] = _up(sd, f"{r + 1}x{c} - {r}x{c}")
    return out


def convert_disparity(path: str) -> Dict:
    """Reference Disparity .tar -> the ``Disparity`` tree."""
    sd = _load_state_dict(path)
    params = {
        "stem_image": _conv(sd, "moduleImage"),
        "stem_semantics": _conv(sd, "moduleSemantics"),
        "head": _basic(sd, "moduleDisparity", "conv-relu-conv"),
        "lattice": _lattice(sd, rows=6),
    }
    for r in range(1, 6):
        params[f"down{r}x0"] = _down(sd, f"{r - 1}x0 - {r}x0")
    return {"params": params}


def convert_refine(path: str) -> Dict:
    """Reference Refine .tar -> the ``Refine`` / ``RefinePretrained`` tree
    (the latter's checkpoint carries ``moduleShortcut`` entries)."""
    sd = _load_state_dict(path)
    core = {
        "image_one": _basic(sd, "moduleImageOne", "conv-relu-conv"),
        "image_two": _down(sd, "moduleImageTwo"),
        "image_thr": _down(sd, "moduleImageThr"),
        "disparity_one": _basic(sd, "moduleDisparityOne", "conv-relu-conv"),
        "disparity_two": _up(sd, "moduleDisparityTwo"),
        "disparity_thr": _up(sd, "moduleDisparityThr"),
        "disparity_fou": _basic(sd, "moduleDisparityFou", "conv-relu-conv"),
        "refine": _basic(sd, "moduleRefine", "conv-relu-conv"),
    }
    return {"params": {"core": core}}


def convert_inpaint(path: str):
    """Reference Inpaint .tar -> (``ContextNet`` tree, ``Inpaint`` tree)."""
    sd = _load_state_dict(path)
    context = {
        "conv1": _conv(sd, "moduleContext.0"),
        "prelu1": _prelu(sd, "moduleContext.1"),
        "conv2": _conv(sd, "moduleContext.2"),
        "prelu2": _prelu(sd, "moduleContext.3"),
    }
    net = {
        "stem": _basic(sd, "moduleInput", "conv-relu-conv"),
        "head_image": _basic(sd, "moduleImage", "conv-relu-conv"),
        "head_disparity": _basic(sd, "moduleDisparity", "conv-relu-conv"),
        "lattice": _lattice(sd, rows=4),
    }
    for r in range(1, 4):
        net[f"down{r}x0"] = _down(sd, f"{r - 1}x0 - {r}x0")
    return {"params": context}, {"params": net}


# VGG19-bn Semantics: (conv, bn) indices inside the reference's nested
# Sequential -> conv{b}_{i}
_VGG19_LAYOUT = (
    (("0.0", "0.1"), ("1.0", "1.1")),
    (("3.0", "3.1"), ("4.0", "4.1")),
    (("6.0", "6.1"), ("7.0", "7.1"), ("8.0", "8.1"), ("9.0", "9.1")),
    (("11.0", "11.1"), ("12.0", "12.1"), ("13.0", "13.1"), ("14.0", "14.1")),
)

# torchvision vgg19_bn ``features`` indices per conv block
_VGG19_TV_LAYOUT = (
    ((0, 1), (3, 4)),
    ((7, 8), (10, 11)),
    ((14, 15), (17, 18), (20, 21), (23, 24)),
    ((27, 28), (30, 31), (33, 34), (36, 37)),
)


def convert_semantics(path_or_sd) -> Dict:
    """VGG19-bn weights (the reference Semantics state dict with
    ``moduleVgg.*`` keys, or a torchvision ``features.*`` state dict) ->
    the BN-folded ``Semantics`` tree."""
    sd = (path_or_sd if isinstance(path_or_sd, dict)
          else _load_state_dict(path_or_sd))
    params = {}
    if any(k.startswith("moduleVgg") for k in sd):
        for b, block in enumerate(_VGG19_LAYOUT):
            for i, (conv_k, bn_k) in enumerate(block):
                params[f"conv{b}_{i}"] = _conv_bn_folded(
                    sd, f"moduleVgg.{conv_k}", f"moduleVgg.{bn_k}")
    else:
        prefix = "features." if any(k.startswith("features.")
                                    for k in sd) else ""
        for b, block in enumerate(_VGG19_TV_LAYOUT):
            for i, (conv_i, bn_i) in enumerate(block):
                params[f"conv{b}_{i}"] = _conv_bn_folded(
                    sd, f"{prefix}{conv_i}", f"{prefix}{bn_i}")
    return {"params": params}


# VGG16 (the perceptual-loss extractor): torchvision ``features`` indices
_VGG16_TV_LAYOUT = ((0, 2), (5, 7), (10, 12, 14), (17, 19, 21))


def convert_vgg16(path_or_sd, num_slices: int = 3) -> Dict:
    """torchvision vgg16 ``features`` -> the ``VGG16Features`` tree."""
    sd = (path_or_sd if isinstance(path_or_sd, dict)
          else _load_state_dict(path_or_sd))
    prefix = "features." if any(k.startswith("features.") for k in sd) \
        else ""
    params = {}
    for b in range(num_slices):
        for i, conv_i in enumerate(_VGG16_TV_LAYOUT[b]):
            params[f"conv{b}_{i}"] = _conv(sd, f"{prefix}{conv_i}")
    return {"params": params}


# The reference's discriminators: a ConvBlock's conv is ``{key}.conv.0`` and
# its batch norm ``{key}.conv.1`` (none in a block built first=True). The
# batch norm trains with D, so it maps to ``scale``/``bias`` and the
# ``batch_stats`` mean and variance instead of being folded.

def _disc_conv_block(sd, key, use_bn):
    params = {"conv": _conv(sd, f"{key}.conv.0")}
    stats = {}
    if use_bn:
        params["bn"] = {"scale": sd[f"{key}.conv.1.weight"],
                        "bias": sd[f"{key}.conv.1.bias"]}
        stats["bn"] = {"mean": sd[f"{key}.conv.1.running_mean"],
                       "var": sd[f"{key}.conv.1.running_var"]}
    return params, stats


def _patch_disc(sd, prefix, n_blocks, first_has_bn):
    """A patch discriminator's ``net.{i}`` ConvBlocks and ``outConv`` ->
    ``block{i}`` and ``out``."""
    params, stats = {}, {}
    for i in range(n_blocks):
        p, bs = _disc_conv_block(sd, f"{prefix}net.{i}",
                                 first_has_bn or i > 0)
        params[f"block{i}"] = p
        if bs:
            stats[f"block{i}"] = bs
    params["out"] = _conv(sd, f"{prefix}outConv")
    return params, stats


def _vgg_block(sd, key, n_convs):
    """A VGGBlock's convs at ``block.{0,2,4}``."""
    return {f"conv{i}": _conv(sd, f"{key}.block.{2 * i}")
            for i in range(n_convs)}


# the reference's VGG16Partial: convs at slice1.{0,2}, slice2.{5,7} and
# slice3.{10,12,14} -> ``VGG16Features`` conv{b}_{i}
_VGG16_PARTIAL_SLICES = (
    (("slice1", 0), ("slice1", 2)),
    (("slice2", 5), ("slice2", 7)),
    (("slice3", 10), ("slice3", 12), ("slice3", 14)),
)


def _vgg16_partial(sd, prefix):
    params = {}
    for b, block in enumerate(_VGG16_PARTIAL_SLICES):
        for i, (sl, idx) in enumerate(block):
            params[f"conv{b}_{i}"] = _conv(sd, f"{prefix}{sl}.{idx}")
    return params


def _multiscale_core(sd, with_vgg):
    """The multi-scale trunk: the ConvBlock0-2 pyramid, the localD1,
    localD2 and Dmain heads, and the frozen VGG16 where there is one."""
    params, stats = {}, {}
    for i, n in enumerate((2, 2, 3)):
        params[f"pyr{i}"] = _vgg_block(sd, f"ConvBlock{i}", n)
    for ours, theirs, n in (("local1", "localD1", 2),
                            ("local2", "localD2", 2),
                            ("main", "Dmain", 3)):
        p, bs = _patch_disc(sd, f"{theirs}.", n, first_has_bn=True)
        params[ours] = p
        if bs:
            stats[ours] = bs
    if with_vgg:
        params["vgg"] = _vgg16_partial(sd, "extractor.")
    return params, stats


def _has_leaves(tree) -> bool:
    if isinstance(tree, dict):
        return any(_has_leaves(v) for v in tree.values())
    return True


def convert_discriminator(path_or_sd, kind: str = "mpd") -> Dict:
    """A reference discriminator's state dict -> its Flax-shaped variables
    (``params``, and ``batch_stats`` where it has batch norms). ``kind``:
    'patch' | 'perceptual' | 'multiscale' | 'multiscale_perceptual' |
    'mpd'. Spectral-norm weights are materialised
    (``_materialize_spectral_norm``)."""
    sd = (_materialize_spectral_norm(path_or_sd)
          if isinstance(path_or_sd, dict) else _load_state_dict(path_or_sd))
    if kind == "patch":
        params, stats = _patch_disc(sd, "", 4, first_has_bn=False)
    elif kind == "perceptual":
        params, stats = _patch_disc(sd, "", 3, first_has_bn=True)
        params["vgg"] = _vgg16_partial(sd, "extractor.")
    elif kind in ("multiscale", "multiscale_perceptual", "mpd"):
        core_p, core_s = _multiscale_core(sd, with_vgg=kind != "multiscale")
        params, stats = {"core": core_p}, {"core": core_s}
    else:
        raise ValueError(f"unknown discriminator kind: {kind}")
    out = {"params": params}
    if _has_leaves(stats):
        out["batch_stats"] = stats
    return out


# Inception-v3 for FID: torchvision's ``inception_v3`` names, batch norm
# folded at eps 1e-3 (Flax name, torchvision name)
_INCEPTION_STEM = (
    ("Conv2d_1a", "Conv2d_1a_3x3"), ("Conv2d_2a", "Conv2d_2a_3x3"),
    ("Conv2d_2b", "Conv2d_2b_3x3"), ("Conv2d_3b", "Conv2d_3b_1x1"),
    ("Conv2d_4a", "Conv2d_4a_3x3"),
)
_INCEPTION_A = ("b1x1", "b5x5_1", "b5x5_2", "b3x3dbl_1", "b3x3dbl_2",
                "b3x3dbl_3", "bpool")
_INCEPTION_B = ("b3x3", "b3x3dbl_1", "b3x3dbl_2", "b3x3dbl_3")
_INCEPTION_C = ("b1x1", "b7x7_1", "b7x7_2", "b7x7_3", "b7x7dbl_1",
                "b7x7dbl_2", "b7x7dbl_3", "b7x7dbl_4", "b7x7dbl_5", "bpool")
_INCEPTION_D = ("b3x3_1", "b3x3_2", "b7x7x3_1", "b7x7x3_2", "b7x7x3_3",
                "b7x7x3_4")
_INCEPTION_E = ("b1x1", "b3x3_1", "b3x3_2a", "b3x3_2b", "b3x3dbl_1",
                "b3x3dbl_2", "b3x3dbl_3a", "b3x3dbl_3b", "bpool")
_INCEPTION_BLOCKS = {
    "Mixed_5b": _INCEPTION_A, "Mixed_5c": _INCEPTION_A,
    "Mixed_5d": _INCEPTION_A, "Mixed_6a": _INCEPTION_B,
    "Mixed_6b": _INCEPTION_C, "Mixed_6c": _INCEPTION_C,
    "Mixed_6d": _INCEPTION_C, "Mixed_6e": _INCEPTION_C,
    "Mixed_7a": _INCEPTION_D, "Mixed_7b": _INCEPTION_E,
    "Mixed_7c": _INCEPTION_E,
}


def _tv_branch(ours: str) -> str:
    return "branch_pool" if ours == "bpool" else "branch" + ours[1:]


def convert_inception(path_or_sd) -> Dict:
    """torchvision ``inception_v3`` weights -> the BN-folded
    ``InceptionV3Features`` tree."""
    sd = (path_or_sd if isinstance(path_or_sd, dict)
          else _load_state_dict(path_or_sd))
    params = {}
    for ours, tv in _INCEPTION_STEM:
        params[ours] = {"conv": _conv_bn_folded(sd, f"{tv}.conv", f"{tv}.bn",
                                                eps=1e-3)}
    for block, branches in _INCEPTION_BLOCKS.items():
        params[block] = {
            b: {"conv": _conv_bn_folded(sd, f"{block}.{_tv_branch(b)}.conv",
                                        f"{block}.{_tv_branch(b)}.bn",
                                        eps=1e-3)}
            for b in branches}
    return {"params": params}


# Mask R-CNN: torchvision ``maskrcnn_resnet50_fpn`` (frozen batch norm),
# the reference's instance-mask source (training/train_depth.py:55,151-163)
_RESNET50_BLOCKS = (3, 4, 6, 3)
_RESNET50_WIDTHS = (64, 128, 256, 512)


def convert_maskrcnn(path_or_sd, eps: float = 0.0) -> Dict:
    """torchvision ``maskrcnn_resnet50_fpn`` weights -> the BN-folded
    ``MaskRCNN`` tree, as ``kbe_tpu``'s converter maps them. A Dense kernel
    is (in, out). ``conv5_mask``'s (in, out, kh, kw) weight becomes the
    Flax ``ConvTranspose`` kernel (kh, kw, in, out) with no spatial flip,
    as ``kbe_tpu`` maps it; the port's ``ConvTranspose`` applies that kernel
    as Flax does, so both packages deconvolve with torchvision's kernel
    flipped in both axes."""
    sd = (path_or_sd if isinstance(path_or_sd, dict)
          else _load_state_dict(path_or_sd))

    def fold(conv_key, bn_key):
        return _conv_bn_folded(sd, conv_key, bn_key, eps=eps)

    def dense(key):
        return {"kernel": np.transpose(sd[f"{key}.weight"], (1, 0)),
                "bias": sd[f"{key}.bias"]}

    backbone: Dict = {"stem": fold("backbone.body.conv1",
                                   "backbone.body.bn1")}
    for s, blocks in enumerate(_RESNET50_BLOCKS):
        for b in range(blocks):
            key = f"backbone.body.layer{s + 1}.{b}"
            blk = {f"conv{i}": fold(f"{key}.conv{i}", f"{key}.bn{i}")
                   for i in (1, 2, 3)}
            if f"{key}.downsample.0.weight" in sd:
                blk["downsample"] = fold(f"{key}.downsample.0",
                                         f"{key}.downsample.1")
            backbone[f"layer{s + 1}_{b}"] = blk
    for i in range(4):
        backbone[f"fpn_inner{i}"] = _conv(sd,
                                          f"backbone.fpn.inner_blocks.{i}")
        backbone[f"fpn_layer{i}"] = _conv(sd,
                                          f"backbone.fpn.layer_blocks.{i}")
    rpn = {name: _conv(sd, f"rpn.head.{name}")
           for name in ("conv", "cls_logits", "bbox_pred")}
    box_head = {"fc6": dense("roi_heads.box_head.fc6"),
                "fc7": dense("roi_heads.box_head.fc7"),
                "cls_score": dense("roi_heads.box_predictor.cls_score"),
                "bbox_pred": dense("roi_heads.box_predictor.bbox_pred")}
    mask_head = {f"mask_fcn{i}": _conv(sd, f"roi_heads.mask_head.mask_fcn{i}")
                 for i in (1, 2, 3, 4)}
    w = sd["roi_heads.mask_predictor.conv5_mask.weight"]
    mask_head["conv5_mask"] = {
        "kernel": np.transpose(w, (2, 3, 0, 1)),
        "bias": sd["roi_heads.mask_predictor.conv5_mask.bias"]}
    mask_head["mask_fcn_logits"] = _conv(
        sd, "roi_heads.mask_predictor.mask_fcn_logits")
    return {"params": {"backbone": backbone, "rpn": rpn,
                       "box_head": box_head, "mask_head": mask_head}}


# the classes whose classifier bias lifts them above the mask source's 0.5
_SYNTHETIC_CLASSES = (1, 3)


def synthetic_maskrcnn_state_dict(seed: int = 0) -> Dict:
    """A torchvision-layout ``maskrcnn_resnet50_fpn`` state dict of numpy
    f32 arrays drawn from ``seed``, for runs without trained weights.

    Convs are He-scaled; the frozen batch norms are near identity, with a
    small scale on each bottleneck's last one, so activations stay O(1)
    through the 53 folded convs (draws of std 1 saturate every sigmoid,
    and ties then decide the detections). The classifier's bias lifts
    two classes so that detections pass the mask source's 0.5 (at
    random weights each of the 91 classes gets about 0.011, under the box
    head's 0.05) and differ in class (``_SYNTHETIC_CLASSES``)."""
    rng = np.random.default_rng(seed)
    sd: Dict[str, np.ndarray] = {}

    def normal(shape, std):
        return (rng.standard_normal(shape, dtype=np.float32)
                * np.float32(std))

    def conv(key, cout, cin, k, bias=True, gain=2.0):
        sd[f"{key}.weight"] = normal((cout, cin, k, k),
                                     math.sqrt(gain / (cin * k * k)))
        if bias:
            sd[f"{key}.bias"] = normal((cout,), 0.05)

    def bn(key, c, scale=(0.8, 1.2)):
        sd[f"{key}.weight"] = rng.uniform(*scale, c).astype(np.float32)
        sd[f"{key}.bias"] = normal((c,), 0.1)
        sd[f"{key}.running_mean"] = normal((c,), 0.1)
        sd[f"{key}.running_var"] = rng.uniform(0.8, 1.2, c).astype(
            np.float32)

    def linear(key, cout, cin, gain=2.0):
        sd[f"{key}.weight"] = normal((cout, cin), math.sqrt(gain / cin))
        sd[f"{key}.bias"] = normal((cout,), 0.05)

    conv("backbone.body.conv1", 64, 3, 7, bias=False)
    bn("backbone.body.bn1", 64)
    cin = 64
    for s, (blocks, width) in enumerate(zip(_RESNET50_BLOCKS,
                                            _RESNET50_WIDTHS)):
        for b in range(blocks):
            key = f"backbone.body.layer{s + 1}.{b}"
            conv(f"{key}.conv1", width, cin, 1, bias=False)
            bn(f"{key}.bn1", width)
            conv(f"{key}.conv2", width, width, 3, bias=False)
            bn(f"{key}.bn2", width)
            conv(f"{key}.conv3", width * 4, width, 1, bias=False)
            bn(f"{key}.bn3", width * 4, scale=(0.2, 0.4))
            if b == 0:
                conv(f"{key}.downsample.0", width * 4, cin, 1, bias=False)
                bn(f"{key}.downsample.1", width * 4)
            cin = width * 4
    for i, c in enumerate((256, 512, 1024, 2048)):
        conv(f"backbone.fpn.inner_blocks.{i}", 256, c, 1, gain=0.02)
        conv(f"backbone.fpn.layer_blocks.{i}", 256, 256, 3, gain=1.0)
    conv("rpn.head.conv", 256, 256, 3)
    conv("rpn.head.cls_logits", 3, 256, 1, gain=1.0)
    conv("rpn.head.bbox_pred", 12, 256, 1, gain=0.01)
    linear("roi_heads.box_head.fc6", 1024, 256 * 7 * 7)
    linear("roi_heads.box_head.fc7", 1024, 1024)
    linear("roi_heads.box_predictor.cls_score", 91, 1024, gain=0.5)
    sd["roi_heads.box_predictor.cls_score.bias"][
        list(_SYNTHETIC_CLASSES)] = 8.0
    linear("roi_heads.box_predictor.bbox_pred", 91 * 4, 1024, gain=0.01)
    for i in (1, 2, 3, 4):
        conv(f"roi_heads.mask_head.mask_fcn{i}", 256, 256, 3)
    # ConvTranspose2d: (in, out, kh, kw); each output takes one tap a
    # channel, so its fan-in is the input's channels
    sd["roi_heads.mask_predictor.conv5_mask.weight"] = normal(
        (256, 256, 2, 2), math.sqrt(2.0 / 256))
    sd["roi_heads.mask_predictor.conv5_mask.bias"] = normal((256,), 0.05)
    conv("roi_heads.mask_predictor.mask_fcn_logits", 91, 256, 1, gain=1.0)
    return sd


def load_torch_pipeline(models, estim: Optional[str] = None,
                        refine: Optional[str] = None,
                        inpaint: Optional[str] = None,
                        inpaint_depth: Optional[str] = None,
                        semantics: Optional[str] = None):
    """Load converted reference checkpoints into a ``PipelineModels``, in
    place; nets with no checkpoint keep their weights. ``inpaint_depth``
    needs the dual-net pair (``context_depth``, ``inpaint_depth``) to be
    there already. Returns ``models``."""
    if estim:
        load_flax(models.disparity, convert_disparity(estim))
    if refine:
        load_flax(models.refine, convert_refine(refine))
    if inpaint:
        ctx, net = convert_inpaint(inpaint)
        load_flax(models.context, ctx)
        load_flax(models.inpaint, net)
    if inpaint_depth:
        if models.inpaint_depth is None or models.context_depth is None:
            raise ValueError("inpaint_depth checkpoint given, but the "
                             "models were built without the dual-net pair")
        ctx, net = convert_inpaint(inpaint_depth)
        load_flax(models.context_depth, ctx)
        load_flax(models.inpaint_depth, net)
    if semantics:
        load_flax(models.semantics, convert_semantics(semantics))
    return models
