"""Reference PyTorch checkpoints -> Flax-shaped param trees -> the port's
nets. Port of the inference part of ``kbe_tpu/utils/torch_convert.py``.

The reference's released ``.tar`` checkpoints (its ``{nb_iter,
model_state_dict, ...}`` format and raw state dicts) name their modules by
strings (``2x0 - 3x0`` lattice keys, ``moduleMain.1``). The converters here
map them onto the systematic ``blk/down/up`` naming as trees of numpy
arrays shaped like the Flax params:

  - conv weights (O, I, kh, kw) -> kernels (kh, kw, I, O)
  - PReLU weights -> per-channel ``slope``
  - the frozen batch norm of the VGG19-bn Semantics folded into the
    preceding conv: W' = W * g/sqrt(v+eps), b' = beta + (b - mean) *
    g/sqrt(v+eps)

``kbe_torch.utils.convert.state_dict_from_flax`` then carries such a tree
into a ``kbe_torch`` module, the one function that carries weights across.
The discriminator, VGG16, Inception and Mask R-CNN converters belong to
training and are not ported.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from kbe_torch.utils.convert import load_flax


def _load_state_dict(path: str) -> Dict[str, np.ndarray]:
    import torch

    blob = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(blob, dict) and "model_state_dict" in blob:
        blob = blob["model_state_dict"]
    return {k: v.detach().numpy() if hasattr(v, "detach") else np.asarray(v)
            for k, v in blob.items()}


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
