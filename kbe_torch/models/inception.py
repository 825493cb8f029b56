"""Inception-v3 features for FID: the trunk through Mixed_7c, 2048-d.
Port of ``kbe_tpu/models/inception.py``.

The torchvision Inception-v3 trunk that the reference's FID uses, with
batch norm folded into the convolutions when weights are converted
(``kbe_torch.utils.reference_convert.convert_inception``), so each unit is
a biased conv and a ReLU. Input (B, H, W, 3) in [0, 1], 299^2 for FID;
the rescale to [-1, 1] and torchvision's ``transform_input`` affine happen
inside. Output (B, 2048): the mean of Mixed_7c over H and W.

The max pools are 3x3 at stride 2 with no padding; the branch pools are
3x3 averages at stride 1, padded by 1, counting the padding. Submodules
are named as in the Flax tree (``Mixed_5b.b1x1.conv``), so
``kbe_torch.utils.convert.state_dict_from_flax`` maps a Flax tree onto
them. Public forwards take NHWC; the units run NCHW.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


class ConvUnit(nn.Module):
    """A biased conv (batch norm folded in), then ReLU."""

    def __init__(self, cin: int, cout: int, kernel: Tuple[int, int] = (3, 3),
                 stride: int = 1, padding: Tuple[int, int] = (0, 0)):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride=stride,
                              padding=padding, bias=True)

    def forward(self, x):
        return F.relu(self.conv(x))


def _max_pool3(x):
    return F.max_pool2d(x, 3, 2)


def _avg_pool3_same(x):
    return F.avg_pool2d(x, 3, 1, padding=1, count_include_pad=True)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.b1x1 = ConvUnit(cin, 64, (1, 1))
        self.b5x5_1 = ConvUnit(cin, 48, (1, 1))
        self.b5x5_2 = ConvUnit(48, 64, (5, 5), padding=(2, 2))
        self.b3x3dbl_1 = ConvUnit(cin, 64, (1, 1))
        self.b3x3dbl_2 = ConvUnit(64, 96, (3, 3), padding=(1, 1))
        self.b3x3dbl_3 = ConvUnit(96, 96, (3, 3), padding=(1, 1))
        self.bpool = ConvUnit(cin, pool_features, (1, 1))

    def forward(self, x):
        b1 = self.b1x1(x)
        b5 = self.b5x5_2(self.b5x5_1(x))
        b3 = self.b3x3dbl_3(self.b3x3dbl_2(self.b3x3dbl_1(x)))
        bp = self.bpool(_avg_pool3_same(x))
        return torch.cat([b1, b5, b3, bp], dim=1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.b3x3 = ConvUnit(cin, 384, (3, 3), stride=2)
        self.b3x3dbl_1 = ConvUnit(cin, 64, (1, 1))
        self.b3x3dbl_2 = ConvUnit(64, 96, (3, 3), padding=(1, 1))
        self.b3x3dbl_3 = ConvUnit(96, 96, (3, 3), stride=2)

    def forward(self, x):
        b3 = self.b3x3(x)
        bd = self.b3x3dbl_3(self.b3x3dbl_2(self.b3x3dbl_1(x)))
        return torch.cat([b3, bd, _max_pool3(x)], dim=1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, channels7: int):
        super().__init__()
        c7 = channels7
        self.b1x1 = ConvUnit(cin, 192, (1, 1))
        self.b7x7_1 = ConvUnit(cin, c7, (1, 1))
        self.b7x7_2 = ConvUnit(c7, c7, (1, 7), padding=(0, 3))
        self.b7x7_3 = ConvUnit(c7, 192, (7, 1), padding=(3, 0))
        self.b7x7dbl_1 = ConvUnit(cin, c7, (1, 1))
        self.b7x7dbl_2 = ConvUnit(c7, c7, (7, 1), padding=(3, 0))
        self.b7x7dbl_3 = ConvUnit(c7, c7, (1, 7), padding=(0, 3))
        self.b7x7dbl_4 = ConvUnit(c7, c7, (7, 1), padding=(3, 0))
        self.b7x7dbl_5 = ConvUnit(c7, 192, (1, 7), padding=(0, 3))
        self.bpool = ConvUnit(cin, 192, (1, 1))

    def forward(self, x):
        b1 = self.b1x1(x)
        b7 = self.b7x7_3(self.b7x7_2(self.b7x7_1(x)))
        bd = self.b7x7dbl_1(x)
        for unit in (self.b7x7dbl_2, self.b7x7dbl_3, self.b7x7dbl_4,
                     self.b7x7dbl_5):
            bd = unit(bd)
        bp = self.bpool(_avg_pool3_same(x))
        return torch.cat([b1, b7, bd, bp], dim=1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.b3x3_1 = ConvUnit(cin, 192, (1, 1))
        self.b3x3_2 = ConvUnit(192, 320, (3, 3), stride=2)
        self.b7x7x3_1 = ConvUnit(cin, 192, (1, 1))
        self.b7x7x3_2 = ConvUnit(192, 192, (1, 7), padding=(0, 3))
        self.b7x7x3_3 = ConvUnit(192, 192, (7, 1), padding=(3, 0))
        self.b7x7x3_4 = ConvUnit(192, 192, (3, 3), stride=2)

    def forward(self, x):
        b3 = self.b3x3_2(self.b3x3_1(x))
        b7 = self.b7x7x3_1(x)
        for unit in (self.b7x7x3_2, self.b7x7x3_3, self.b7x7x3_4):
            b7 = unit(b7)
        return torch.cat([b3, b7, _max_pool3(x)], dim=1)


class InceptionE(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.b1x1 = ConvUnit(cin, 320, (1, 1))
        self.b3x3_1 = ConvUnit(cin, 384, (1, 1))
        self.b3x3_2a = ConvUnit(384, 384, (1, 3), padding=(0, 1))
        self.b3x3_2b = ConvUnit(384, 384, (3, 1), padding=(1, 0))
        self.b3x3dbl_1 = ConvUnit(cin, 448, (1, 1))
        self.b3x3dbl_2 = ConvUnit(448, 384, (3, 3), padding=(1, 1))
        self.b3x3dbl_3a = ConvUnit(384, 384, (1, 3), padding=(0, 1))
        self.b3x3dbl_3b = ConvUnit(384, 384, (3, 1), padding=(1, 0))
        self.bpool = ConvUnit(cin, 192, (1, 1))

    def forward(self, x):
        b1 = self.b1x1(x)
        b3 = self.b3x3_1(x)
        b3 = torch.cat([self.b3x3_2a(b3), self.b3x3_2b(b3)], dim=1)
        bd = self.b3x3dbl_2(self.b3x3dbl_1(x))
        bd = torch.cat([self.b3x3dbl_3a(bd), self.b3x3dbl_3b(bd)], dim=1)
        bp = self.bpool(_avg_pool3_same(x))
        return torch.cat([b1, b3, bd, bp], dim=1)


# torchvision's transform_input: (scale, offset) per RGB channel, applied
# after the [0, 1] -> [-1, 1] rescale
_TRANSFORM = ((0.229 / 0.5, (0.485 - 0.5) / 0.5),
              (0.224 / 0.5, (0.456 - 0.5) / 0.5),
              (0.225 / 0.5, (0.406 - 0.5) / 0.5))


class InceptionV3Features(nn.Module):
    """(B, H, W, 3) in [0, 1] -> (B, 2048) Mixed_7c features, f32."""

    def __init__(self, transform_input: bool = True):
        super().__init__()
        self.transform_input = transform_input
        self.Conv2d_1a = ConvUnit(3, 32, (3, 3), stride=2)
        self.Conv2d_2a = ConvUnit(32, 32, (3, 3))
        self.Conv2d_2b = ConvUnit(32, 64, (3, 3), padding=(1, 1))
        self.Conv2d_3b = ConvUnit(64, 80, (1, 1))
        self.Conv2d_4a = ConvUnit(80, 192, (3, 3))
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x * 2.0 - 1.0
        if self.transform_input:
            x = torch.cat([x[..., i:i + 1] * scale + offset
                           for i, (scale, offset) in enumerate(_TRANSFORM)],
                          dim=-1)
        x = x.to(self.Conv2d_1a.conv.weight.dtype).permute(0, 3, 1, 2)
        x = self.Conv2d_2b(self.Conv2d_2a(self.Conv2d_1a(x)))
        x = _max_pool3(x)
        x = self.Conv2d_4a(self.Conv2d_3b(x))
        x = _max_pool3(x)
        for block in (self.Mixed_5b, self.Mixed_5c, self.Mixed_5d,
                      self.Mixed_6a, self.Mixed_6b, self.Mixed_6c,
                      self.Mixed_6d, self.Mixed_6e, self.Mixed_7a,
                      self.Mixed_7b, self.Mixed_7c):
            x = block(x)
        return torch.mean(x, dim=(2, 3)).float()
