"""Mask R-CNN (ResNet50-FPN), frozen: instance masks for the depth mask
loss. Port of ``kbe_tpu/models/maskrcnn.py``.

The reference runs torchvision's ``maskrcnn_resnet50_fpn`` frozen as an
instance-mask source (training/train_depth.py:55,151-163); ``kbe_tpu``
rebuilt its inference path with static shapes, and this computes what
``kbe_tpu`` computes from the same weights:

  * frozen batch norm folded into the convs at conversion
    (``kbe_torch.utils.reference_convert.convert_maskrcnn``);
  * fixed capacities (``pre_nms_top_n`` a level, ``num_proposals``,
    ``num_detections``): suppressed and empty slots keep their place with
    score 0, nothing is dropped;
  * greedy NMS on the five RPN levels of an image (one kernel launch) and
    on its box set with the class-offset trick (one launch): kernel
    ``nms`` (``ops/nms.py``, ``ops/csrc/nms.cu``), where ``kbe_tpu`` runs a
    ``lax.fori_loop``;
  * ROIAlign (sampling ratio 2, aligned=False) as bilinear gathers against
    all four FPN levels, then each box's level selected; ``top_k`` is a
    stable descending sort and a slice (``lax.top_k`` puts the lower index
    first among equal values; ``torch.topk`` promises no order on CUDA).

Submodules are named as in the Flax tree (``backbone.layer1_0.conv1``,
``rpn.cls_logits``, ``box_head.fc6``, ``mask_head.conv5_mask``), so
``state_dict_from_flax`` loads a Flax tree. The public forward takes NHWC
images in [0, 1]; the convolutions run NCHW. Run in f32 with TF32 off
(``load_maskrcnn`` turns it off on the card), under ``torch.no_grad``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from kbe_torch.device import disable_tf32, resolve_device
from kbe_torch.ops.geometry import true_div
from kbe_torch.ops.nms import nms_keep_sets
from kbe_torch.ops.resize import resize_nearest

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)

# ResNet50 stage config: (blocks, bottleneck width)
_STAGES = ((3, 64), (4, 128), (6, 256), (3, 512))
_ANCHOR_SIZES = (32.0, 64.0, 128.0, 256.0, 512.0)   # P2..P6
_ANCHOR_RATIOS = (0.5, 1.0, 2.0)
_NUM_CLASSES = 91  # COCO

__all__ = ["Bottleneck", "BoxHead", "ConvTranspose", "MaskHead", "MaskRCNN",
           "RPNHead", "ResNet50FPN", "load_maskrcnn",
           "maskrcnn_instance_masks"]


def _conv(cin: int, cout: int, k: int, s: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=s, padding=k // 2)


class ConvTranspose(nn.Module):
    """Flax ``nn.ConvTranspose((2, 2), strides=(2, 2))`` on NCHW. ``weight``
    keeps a conv's layout (out, in, 2, 2), which ``state_dict_from_flax``
    gives a Flax kernel (2, 2, in, out); Flax's transposed conv equals
    ``F.conv_transpose2d`` with that kernel as (in, out, 2, 2) flipped in
    both spatial axes, so the forward flips it."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin, 2, 2))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        w = self.weight.transpose(0, 1).flip(2, 3)
        return F.conv_transpose2d(x, w, self.bias, stride=2)


class Bottleneck(nn.Module):
    """ResNet bottleneck with folded BN (conv bias carries the BN)."""

    def __init__(self, cin: int, width: int, stride: int = 1,
                 project: bool = False):
        super().__init__()
        self.conv1 = _conv(cin, width, 1)
        self.conv2 = _conv(width, width, 3, stride)
        self.conv3 = _conv(width, width * 4, 1)
        self.downsample = (_conv(cin, width * 4, 1, stride) if project
                           else None)

    def forward(self, x):
        y = F.relu(self.conv1(x))
        y = F.relu(self.conv2(y))
        y = self.conv3(y)
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class ResNet50FPN(nn.Module):
    """Backbone + FPN: image (B, 3, H, W) -> P2..P6, 256 channels each."""

    def __init__(self):
        super().__init__()
        self.stem = _conv(3, 64, 7, 2)
        cin, outs = 64, []
        for si, (blocks, width) in enumerate(_STAGES):
            for b in range(blocks):
                setattr(self, f"layer{si + 1}_{b}", Bottleneck(
                    cin, width, stride=2 if b == 0 and si > 0 else 1,
                    project=b == 0))
                cin = width * 4
            outs.append(cin)
        for i, c in enumerate(outs):
            setattr(self, f"fpn_inner{i}", _conv(c, 256, 1))
            setattr(self, f"fpn_layer{i}", _conv(256, 256, 3))

    def forward(self, x) -> List[torch.Tensor]:
        x = F.relu(self.stem(x))
        x = F.max_pool2d(x, 3, 2, padding=1)  # -inf padding, as kbe_tpu's
        cs = []
        for si, (blocks, _) in enumerate(_STAGES):
            for b in range(blocks):
                x = getattr(self, f"layer{si + 1}_{b}")(x)
            cs.append(x)
        laterals = [getattr(self, f"fpn_inner{i}")(c)
                    for i, c in enumerate(cs)]
        ps = [laterals[-1]]
        for i in range(len(laterals) - 2, -1, -1):
            up = resize_nearest(ps[0], laterals[i].shape)
            ps.insert(0, laterals[i] + up)
        ps = [getattr(self, f"fpn_layer{i}")(p) for i, p in enumerate(ps)]
        return ps + [ps[-1][..., ::2, ::2]]  # P6: a 1x1 max pool, stride 2


class RPNHead(nn.Module):
    def __init__(self):
        super().__init__()
        a = len(_ANCHOR_RATIOS)
        self.conv = _conv(256, 256, 3)
        self.cls_logits = _conv(256, a, 1)
        self.bbox_pred = _conv(256, a * 4, 1)

    def forward(self, feats):
        outs = []
        for f in feats:
            t = F.relu(self.conv(f))
            outs.append((self.cls_logits(t), self.bbox_pred(t)))
        return outs


class BoxHead(nn.Module):
    def __init__(self):
        super().__init__()
        self.fc6 = nn.Linear(256 * 7 * 7, 1024)
        self.fc7 = nn.Linear(1024, 1024)
        self.cls_score = nn.Linear(1024, _NUM_CLASSES)
        self.bbox_pred = nn.Linear(1024, _NUM_CLASSES * 4)

    def forward(self, rois):  # (N, 7, 7, 256)
        # torchvision flattens NCHW: (256, 7, 7) order
        x = rois.permute(0, 3, 1, 2).reshape(rois.shape[0], -1)
        x = F.relu(self.fc6(x))
        x = F.relu(self.fc7(x))
        return self.cls_score(x), self.bbox_pred(x)


class MaskHead(nn.Module):
    def __init__(self):
        super().__init__()
        for i in range(4):
            setattr(self, f"mask_fcn{i + 1}", _conv(256, 256, 3))
        self.conv5_mask = ConvTranspose(256, 256)
        self.mask_fcn_logits = _conv(256, _NUM_CLASSES, 1)

    def forward(self, rois):  # (N, 14, 14, 256) -> (N, 91, 28, 28)
        x = rois.permute(0, 3, 1, 2)
        for i in range(4):
            x = F.relu(getattr(self, f"mask_fcn{i + 1}")(x))
        x = F.relu(self.conv5_mask(x))
        return self.mask_fcn_logits(x)


# --------------------------------------------------------------- geometry

def _anchors_for_level(h: int, w: int, stride: int, size: float,
                       device=None) -> torch.Tensor:
    """(h*w*A, 4) xyxy anchors, torchvision AnchorGenerator layout."""
    ws, hs = [], []
    for r in _ANCHOR_RATIOS:
        hr = math.sqrt(r)
        ws.append(size / hr)
        hs.append(size * hr)
    ws = torch.stack([torch.full((), v, device=device) for v in ws])
    hs = torch.stack([torch.full((), v, device=device) for v in hs])
    cx = (torch.arange(w, dtype=torch.float32, device=device)
          * stride)[None, :, None]
    cy = (torch.arange(h, dtype=torch.float32, device=device)
          * stride)[:, None, None]
    zeros = torch.zeros((h, w, len(_ANCHOR_RATIOS)), dtype=torch.float32,
                        device=device)
    half_w = true_div(ws, 2.0)
    half_h = true_div(hs, 2.0)
    x1 = cx + zeros - half_w
    y1 = cy + zeros - half_h
    x2 = cx + zeros + half_w
    y2 = cy + zeros + half_h
    return torch.stack([x1, y1, x2, y2], -1).reshape(-1, 4)


def _decode(boxes, deltas, wx=1.0, wy=1.0, ww=1.0, wh=1.0):
    """torchvision BoxCoder.decode (xyxy boxes, dxdydwdh deltas)."""
    bw = boxes[:, 2] - boxes[:, 0]
    bh = boxes[:, 3] - boxes[:, 1]
    cx = boxes[:, 0] + 0.5 * bw
    cy = boxes[:, 1] + 0.5 * bh
    dx = true_div(deltas[:, 0], wx)
    dy = true_div(deltas[:, 1], wy)
    clip = float(np.float32(math.log(1000.0 / 16)))
    dw = torch.clamp(true_div(deltas[:, 2], ww), -20.0, clip)
    dh = torch.clamp(true_div(deltas[:, 3], wh), -20.0, clip)
    pcx = cx + dx * bw
    pcy = cy + dy * bh
    pw = torch.exp(dw) * bw
    ph = torch.exp(dh) * bh
    return torch.stack([pcx - 0.5 * pw, pcy - 0.5 * ph,
                        pcx + 0.5 * pw, pcy + 0.5 * ph], -1)


def _clip_boxes(boxes, h: float, w: float):
    return torch.stack([torch.clamp(boxes[:, 0], 0.0, w),
                        torch.clamp(boxes[:, 1], 0.0, h),
                        torch.clamp(boxes[:, 2], 0.0, w),
                        torch.clamp(boxes[:, 3], 0.0, h)], -1)


def _nms_keep(boxes, scores, iou_thresh: float, tag: str = "set"):
    """Greedy NMS over a score-sorted static set: returns scores with
    suppressed entries zeroed (same order)."""
    return nms_keep_sets([(boxes, scores)], iou_thresh, tag)[0]


def _top_k(x: torch.Tensor, k: int):
    """``lax.top_k``: the k largest, lower index first among equal ones."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k]


def _roi_align(feat, boxes, out_size: int, spatial_scale: float):
    """torchvision ROIAlign (sampling_ratio=2, aligned=False).

    ``feat``: (H, W, C); ``boxes``: (N, 4) xyxy image coords.
    Returns (N, out_size, out_size, C).
    """
    fh, fw, c = feat.shape
    n = boxes.shape[0]
    ss = 2  # sampling ratio
    dev = feat.device

    x1 = boxes[:, 0] * spatial_scale
    y1 = boxes[:, 1] * spatial_scale
    bw = torch.clamp(boxes[:, 2] * spatial_scale - x1, min=1.0)
    bh = torch.clamp(boxes[:, 3] * spatial_scale - y1, min=1.0)
    bin_w = true_div(bw, float(out_size))
    bin_h = true_div(bh, float(out_size))

    grid = true_div(torch.arange(out_size * ss, dtype=torch.float32,
                             device=dev) + 0.5, float(ss))
    sx = x1[:, None] + bin_w[:, None] * grid[None, :]   # (N, out*ss)
    sy = y1[:, None] + bin_h[:, None] * grid[None, :]

    px = torch.clamp(sx - 0.5, 0.0, fw - 1.0)
    py = torch.clamp(sy - 0.5, 0.0, fh - 1.0)
    x0 = torch.floor(px)
    y0 = torch.floor(py)
    fx = px - x0
    fy = py - y0
    x0 = x0.to(torch.long)
    y0 = y0.to(torch.long)
    x1_ = torch.clamp(x0 + 1, max=fw - 1)
    y1_ = torch.clamp(y0 + 1, max=fh - 1)
    flat = feat.reshape(-1, c)

    # the sample grid is separable (sy x sx outer product), so one
    # (N, Sy, Sx) index outer-product per corner gathers everything
    def corner(yi, xi):
        return flat[yi[:, :, None] * fw + xi[:, None, :]]

    wy0 = (1.0 - fy)[:, :, None, None]
    wy1 = fy[:, :, None, None]
    wx0 = (1.0 - fx)[:, None, :, None]
    wx1 = fx[:, None, :, None]
    samples = (corner(y0, x0) * wy0 * wx0 + corner(y0, x1_) * wy0 * wx1
               + corner(y1_, x0) * wy1 * wx0 + corner(y1_, x1_) * wy1 * wx1)
    samples = samples.reshape(n, out_size, ss, out_size, ss, c)
    return samples.mean(dim=(2, 4))


def _roi_align_pyramid(feats: Sequence[torch.Tensor], boxes, out_size: int,
                       canonical: float = 224.0):
    """Multi-level ROIAlign with the FPN level-assignment rule
    (lvl = 4 + log2(sqrt(area)/224), clamped to P2..P5). ``feats``: the
    image's (H, W, C) maps of P2..P5."""
    bw = torch.clamp(boxes[:, 2] - boxes[:, 0], min=1e-6)
    bh = torch.clamp(boxes[:, 3] - boxes[:, 1], min=1e-6)
    lvl = torch.floor(4.0 + torch.log2(
        true_div(torch.sqrt(bw * bh), canonical) + 1e-8))
    lvl = torch.clamp(lvl, 2.0, 5.0).to(torch.long)   # P2..P5
    stacked = torch.stack([
        _roi_align(feats[i], boxes, out_size, 1.0 / (2 ** (i + 2)))
        for i in range(4)])  # (4, N, out, out, C)
    return stacked[lvl - 2, torch.arange(boxes.shape[0],
                                         device=boxes.device)]


def _paste_masks(masks, boxes, h: int, w: int):
    """(N, 28, 28) sigmoid masks + (N, 4) boxes -> (N, h, w) soft masks
    (torchvision paste_masks_in_image bilinear semantics)."""
    n, m = masks.shape[0], masks.shape[1]
    dev = masks.device
    x1, y1, x2, y2 = (boxes[:, i:i + 1] for i in range(4))   # (N, 1)
    bw = torch.clamp(x2 - x1, min=1.0)
    bh = torch.clamp(y2 - y1, min=1.0)
    col = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    row = torch.arange(h, dtype=torch.float32, device=dev)[None, :]
    xs = torch.div(col + 0.5 - x1, bw) * m - 0.5     # (N, w)
    ys = torch.div(row + 0.5 - y1, bh) * m - 0.5     # (N, h)
    x0 = torch.clamp(torch.floor(xs), 0.0, m - 1.0)
    y0 = torch.clamp(torch.floor(ys), 0.0, m - 1.0)
    fx = torch.clamp(xs - x0, 0.0, 1.0)[:, None, :]
    fy = torch.clamp(ys - y0, 0.0, 1.0)[:, :, None]
    x0i = x0.to(torch.long)
    y0i = y0.to(torch.long)
    x1i = torch.clamp(x0i + 1, max=m - 1)
    y1i = torch.clamp(y0i + 1, max=m - 1)
    flat = masks.reshape(n, m * m)

    def at(yi, xi):
        idx = (yi[:, :, None] * m + xi[:, None, :]).reshape(n, -1)
        return torch.gather(flat, 1, idx).reshape(n, h, w)

    val = (at(y0i, x0i) * (1 - fy) * (1 - fx)
           + at(y0i, x1i) * (1 - fy) * fx
           + at(y1i, x0i) * fy * (1 - fx)
           + at(y1i, x1i) * fy * fx)
    inside = ((col >= x1) & (col < x2))[:, None, :] \
        & ((row >= y1) & (row < y2))[:, :, None]
    return torch.where(inside, val, torch.zeros_like(val))


class MaskRCNN(nn.Module):
    """Frozen Mask R-CNN inference: images -> instance masks.

    ``images``: (B, H, W, 3) RGB in [0, 1]. Returns a dict with ``masks``
    (B, num_detections, H, W) soft masks, ``boxes``, ``scores`` and
    ``labels``: fixed capacity, empty slots have score 0.
    """

    def __init__(self, num_proposals: int = 256, pre_nms_top_n: int = 512,
                 num_detections: int = 32, rpn_nms_thresh: float = 0.7,
                 box_score_thresh: float = 0.05,
                 box_nms_thresh: float = 0.5):
        super().__init__()
        self.num_proposals = num_proposals
        self.pre_nms_top_n = pre_nms_top_n
        self.num_detections = num_detections
        self.rpn_nms_thresh = rpn_nms_thresh
        self.box_score_thresh = box_score_thresh
        self.box_nms_thresh = box_nms_thresh
        self.register_buffer("mean", torch.tensor(_IMAGENET_MEAN),
                             persistent=False)
        self.register_buffer("std", torch.tensor(_IMAGENET_STD),
                             persistent=False)
        self.backbone = ResNet50FPN()
        self.rpn = RPNHead()
        self.box_head = BoxHead()
        self.mask_head = MaskHead()

    def features(self, images):
        """The FPN's P2..P6, NCHW, of (B, H, W, 3) images in [0, 1]."""
        x = torch.div(images.to(torch.float32) - self.mean, self.std)
        return self.backbone(x.permute(0, 3, 1, 2))

    def forward(self, images) -> Dict[str, torch.Tensor]:
        h, w = images.shape[1], images.shape[2]
        feats = self.features(images)
        rpn_outs = self.rpn(feats)
        outs = [self._one_image(feats, rpn_outs, idx, h, w)
                for idx in range(images.shape[0])]
        return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}

    def _proposals(self, rpn_outs, idx: int, h: int, w: int):
        """RPN: per-level top-k -> decode -> clip -> NMS (the five levels in
        one launch) -> the ``num_proposals`` best."""
        sets = []
        for li, (cls, bbox) in enumerate(rpn_outs):
            fh, fw = cls.shape[2], cls.shape[3]
            anchors = _anchors_for_level(fh, fw, 2 ** (li + 2),
                                         _ANCHOR_SIZES[li], cls.device)
            scores = cls[idx].permute(1, 2, 0).reshape(-1)
            deltas = bbox[idx].permute(1, 2, 0).reshape(-1, 4)
            top, ti = _top_k(scores, min(self.pre_nms_top_n,
                                         scores.shape[0]))
            boxes = _clip_boxes(_decode(anchors[ti], deltas[ti]), float(h),
                                float(w))
            # drop degenerate boxes (torchvision min_size 1e-3)
            ok = ((boxes[:, 2] - boxes[:, 0] > 1e-3)
                  & (boxes[:, 3] - boxes[:, 1] > 1e-3))
            s = torch.where(ok, torch.sigmoid(top), torch.zeros_like(top))
            sets.append((boxes, s))
        kept = nms_keep_sets(sets, self.rpn_nms_thresh, "rpn")
        boxes = torch.cat([b for b, _ in sets])
        scores = torch.cat(kept)
        _, keep = _top_k(scores, min(self.num_proposals, scores.shape[0]))
        return boxes[keep]

    def _one_image(self, feats, rpn_outs, idx: int, h: int, w: int):
        proposals = self._proposals(rpn_outs, idx, h, w)
        levels = [f[idx].permute(1, 2, 0).contiguous() for f in feats[:4]]

        # ---- box head
        rois = _roi_align_pyramid(levels, proposals, 7)
        cls_scores, deltas = self.box_head(rois)
        del rois
        probs = torch.softmax(cls_scores, -1)
        # best foreground class per proposal, the first of equal maxima
        fg = probs[:, 1:]
        score = fg.max(-1).values
        cls_idx = torch.arange(fg.shape[1], device=fg.device)
        label = torch.where(fg == score[:, None], cls_idx,
                            fg.shape[1]).min(-1).values + 1
        dsel = deltas.reshape(-1, _NUM_CLASSES, 4)[
            torch.arange(label.shape[0], device=label.device), label]
        det_boxes = _decode(proposals, dsel, 10.0, 10.0, 5.0, 5.0)
        det_boxes = _clip_boxes(det_boxes, float(h), float(w))
        score = torch.where(score >= self.box_score_thresh, score,
                            torch.zeros_like(score))
        # class-offset trick: per-class NMS in one pass
        off = label.to(torch.float32)[:, None] * (max(h, w) + 2.0)
        score = _nms_keep(det_boxes + off, score, self.box_nms_thresh, "box")
        top_s, di = _top_k(score, min(self.num_detections, score.shape[0]))
        det_boxes = det_boxes[di]
        det_labels = label[di]

        # ---- mask head
        mrois = _roi_align_pyramid(levels, det_boxes, 14)
        logits = self.mask_head(mrois)   # (K, 91, 28, 28)
        msel = logits[torch.arange(det_labels.shape[0],
                                   device=logits.device), det_labels]
        masks = _paste_masks(torch.sigmoid(msel), det_boxes, h, w)
        masks = masks * (top_s > 0.0).to(masks.dtype)[:, None, None]
        return {"boxes": det_boxes, "labels": det_labels, "scores": top_s,
                "masks": masks}


def load_maskrcnn(params, device=None, **capacities) -> MaskRCNN:
    """A frozen ``MaskRCNN`` holding ``params`` (a Flax-shaped tree such as
    ``reference_convert.convert_maskrcnn`` gives, or the port's state dict)
    on ``device`` (default CUDA; raises where there is none), in eval mode
    with TF32 off on the card. ``capacities`` go to ``MaskRCNN``."""
    from kbe_torch.utils.convert import load_params

    dev = resolve_device(device)
    if dev.type == "cuda":
        disable_tf32()
    model = MaskRCNN(**capacities)
    load_params(model, params)
    model.requires_grad_(False)
    return model.eval().to(dev)


@torch.no_grad()
def maskrcnn_instance_masks(model: MaskRCNN, images,
                            score_thresh: float = 0.5) -> torch.Tensor:
    """Mask-source adapter for KBEDataset(mask_source=...) / TrainerDepth:
    (B, H, W, 3) [0, 1] -> (B, K, H, W, 1) binary masks."""
    out = model(images)
    keep = out["scores"] > score_thresh
    masks = (out["masks"] > 0.5) & keep[..., None, None]
    return masks.to(torch.float32)[..., None]
