"""Frozen VGG19-bn semantic features (BN folded into the convs).

Port of ``kbe_tpu/models/semantics.py``: BGR -> RGB flip, ImageNet
normalisation, then the conv+ReLU stack of VGG19's first four blocks with a
ceil-mode 2x2 max pool after each: (B, H, W, 3) -> (B, H/16, W/16, 512).
Convs are named ``conv{b}_{i}`` as in the Flax tree.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from kbe_torch.models.layers import ceil_max_pool, conv

_BLOCKS = ((64, 64), (128, 128), (256, 256, 256, 256), (512, 512, 512, 512))
_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


class Semantics(nn.Module):
    def __init__(self, bgr_input: bool = True):
        super().__init__()
        self.bgr_input = bgr_input
        cin = 3
        for b, widths in enumerate(_BLOCKS):
            for i, wch in enumerate(widths):
                self.add_module(f"conv{b}_{i}", conv(cin, wch))
                cin = wch

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        """``image``: (B, H, W, 3) in [0, 1] -> (B, H/16, W/16, 512) f32."""
        dtype = self.conv0_0.weight.dtype
        x = image.flip(-1) if self.bgr_input else image
        mean = torch.tensor(_IMAGENET_MEAN, dtype=torch.float32,
                            device=x.device)
        std = torch.tensor(_IMAGENET_STD, dtype=torch.float32,
                           device=x.device)
        x = ((x.float() - mean) / std).to(dtype).permute(0, 3, 1, 2)
        for b, widths in enumerate(_BLOCKS):
            for i in range(len(widths)):
                x = F.relu(getattr(self, f"conv{b}_{i}")(x))
            x = ceil_max_pool(x)
        return x.permute(0, 2, 3, 1).float()
