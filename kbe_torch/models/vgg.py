"""VGG16 feature pyramid of the perceptual losses and discriminators. Port
of ``kbe_tpu/models/vgg.py``, built by hand (no torchvision).

Three slices: [relu-pool features after blocks 1, 2, 3] = 64 channels at
1/2, 128 at 1/4, 256 at 1/8. As in the reference, the input is the raw
image, not ImageNet-normalised. Convolutions are named as the Flax tree
(``conv{block}_{i}``).
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F

_WIDTHS = ((64, 64), (128, 128), (256, 256, 256), (512, 512, 512))


class VGG16Features(nn.Module):

    def __init__(self, num_slices: int = 3, in_channels: int = 3):
        super().__init__()
        self.num_slices = num_slices
        cin = in_channels
        for b in range(num_slices):
            for i, width in enumerate(_WIDTHS[b]):
                self.add_module(f"conv{b}_{i}",
                                nn.Conv2d(cin, width, 3, padding=1))
                cin = width

    def forward_nchw(self, x: torch.Tensor) -> List[torch.Tensor]:
        outs = []
        for b in range(self.num_slices):
            for i in range(len(_WIDTHS[b])):
                x = F.relu(getattr(self, f"conv{b}_{i}")(x))
            x = F.max_pool2d(x, 2, 2)
            outs.append(x)
        return outs

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """(B, H, W, 3) -> [(B, H/2, W/2, 64), (B, H/4, W/4, 128),
        (B, H/8, W/8, 256)], NHWC."""
        feats = self.forward_nchw(x.permute(0, 3, 1, 2))
        return [f.permute(0, 2, 3, 1) for f in feats]
