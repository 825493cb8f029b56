"""Disparity refinement U-net. Port of ``kbe_tpu/models/refine.py``.

Super-resolves the quarter-resolution disparity to full resolution with
image-feature skips, inside a per-sample normalisation of both inputs and
the output. ``RefinePretrained`` is the layout of the released checkpoint:
the same topology with residual shortcuts in its Basic blocks.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from kbe_torch.models.layers import (Basic, Downsample, Upsample,
                                     denormalize_sample, normalize_sample)


class _RefineCore(nn.Module):
    def __init__(self, residual_basics: bool):
        super().__init__()
        res = residual_basics
        self.image_one = Basic("conv-relu-conv", (3, 24, 24), residual=res)
        self.image_two = Downsample((24, 48, 48))
        self.image_thr = Downsample((48, 96, 96))
        self.disparity_one = Basic("conv-relu-conv", (1, 96, 96),
                                   residual=res)
        self.disparity_two = Upsample((192, 96, 96))
        self.disparity_thr = Upsample((144, 48, 48))
        self.disparity_fou = Basic("conv-relu-conv", (72, 24, 24),
                                   residual=res)
        self.refine = Basic("conv-relu-conv", (24, 24, 1), residual=res)

    def forward(self, image, disparity):
        dt = self.refine.conv2.weight.dtype
        img, _ = normalize_sample(image)
        disp, disp_stats = normalize_sample(disparity)
        im1 = self.image_one(img.to(dt).permute(0, 3, 1, 2))
        im2 = self.image_two(im1)
        im3 = self.image_thr(im2)
        up = self.disparity_one(disp.to(dt).permute(0, 3, 1, 2))
        up = self.disparity_two(torch.cat([im3, up], dim=1))
        up = self.disparity_thr(torch.cat([im2, up], dim=1))
        up = self.disparity_fou(torch.cat([im1, up], dim=1))
        out = self.refine(up).permute(0, 2, 3, 1).float()
        return denormalize_sample(out, disp_stats)


class Refine(nn.Module):
    """``image`` (B, H, W, 3), ``disparity`` (B, H/4, W/4, 1) ->
    (B, H, W, 1) f32. Submodules live under ``core`` as in the Flax tree."""

    residual_basics = False

    def __init__(self):
        super().__init__()
        self.core = _RefineCore(self.residual_basics)

    def forward(self, image, disparity):
        return self.core(image, disparity)


class RefinePretrained(Refine):
    """The released checkpoint's refinement net: residual Basic blocks, with
    a 1x1 ``shortcut`` conv wherever a block changes the channel count."""

    residual_basics = True
