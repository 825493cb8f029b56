"""Shared conv building blocks. Port of ``kbe_tpu/models/layers.py``.

The modules take and return NCHW tensors (PyTorch's convolution layout);
the nets convert at their NHWC boundaries. Attribute names mirror the Flax
param tree (``prelu1``, ``conv1``, ``prelu2``, ``conv2``, ``shortcut``), so
``kbe_torch.utils.convert.state_dict_from_flax`` maps it mechanically.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from kbe_torch.ops.geometry import true_div
from kbe_torch.ops.resize import resize_bilinear


class PReLU(nn.PReLU):
    """Per-channel PReLU, init 0.25 (param ``weight`` <- Flax ``slope``)."""

    def __init__(self, features: int, init: float = 0.25):
        super().__init__(num_parameters=features, init=init)


def conv(cin: int, cout: int, kernel: int = 3, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, kernel, stride=stride, padding=kernel // 2)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Bilinear 2x upsample at half-pixel centers, NCHW. Same weights as
    ``jax.image.resize`` (at 2x they equal F.interpolate's)."""
    b, c, h, w = x.shape
    nhwc = resize_bilinear(x.permute(0, 2, 3, 1), 2 * h, 2 * w)
    return nhwc.permute(0, 3, 1, 2)


def crop_to(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Crop trailing rows/cols (NCHW)."""
    return x[:, :, :height, :width]


def ceil_max_pool(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 max pool with ceil_mode=True (NCHW)."""
    return F.max_pool2d(x, 2, 2, ceil_mode=True)


class Basic(nn.Module):
    """conv-relu-conv / relu-conv-relu-conv block, optional residual."""

    def __init__(self, kind: str, channels: Tuple[int, int, int],
                 residual: bool = True):
        super().__init__()
        c0, c1, c2 = channels
        if kind not in ("relu-conv-relu-conv", "conv-relu-conv"):
            raise ValueError(f"unknown Basic kind {kind!r}")
        self.kind = kind
        self.residual = residual
        if kind == "relu-conv-relu-conv":
            self.prelu1 = PReLU(c0)
        self.conv1 = conv(c0, c1)
        self.prelu2 = PReLU(c1)
        self.conv2 = conv(c1, c2)
        self.identity = c0 == c2
        if residual and not self.identity:
            self.shortcut = conv(c0, c2, kernel=1)

    def forward(self, x):
        h = self.prelu1(x) if self.kind == "relu-conv-relu-conv" else x
        h = self.conv2(self.prelu2(self.conv1(h)))
        if not self.residual:
            return h
        return h + (x if self.identity else self.shortcut(x))


class Downsample(nn.Module):
    """PReLU, stride-2 conv, PReLU, conv."""

    def __init__(self, channels: Tuple[int, int, int]):
        super().__init__()
        c0, c1, c2 = channels
        self.prelu1 = PReLU(c0)
        self.conv1 = conv(c0, c1, stride=2)
        self.prelu2 = PReLU(c1)
        self.conv2 = conv(c1, c2)

    def forward(self, x):
        return self.conv2(self.prelu2(self.conv1(self.prelu1(x))))


class Upsample(nn.Module):
    """bilinear 2x, PReLU, conv, PReLU, conv."""

    def __init__(self, channels: Tuple[int, int, int]):
        super().__init__()
        c0, c1, c2 = channels
        self.prelu1 = PReLU(c0)
        self.conv1 = conv(c0, c1)
        self.prelu2 = PReLU(c1)
        self.conv2 = conv(c1, c2)

    def forward(self, x):
        h = self.prelu1(upsample2x(x))
        return self.conv2(self.prelu2(self.conv1(h)))


def sample_norm_stats(x: torch.Tensor):
    """Per-sample mean and Bessel-corrected std over all non-batch dims,
    in f32 whatever the input type. Returns (B, 1, 1, 1) tensors."""
    b = x.shape[0]
    flat = x.reshape(b, -1).to(torch.float32)
    n = flat.shape[1]
    mean = torch.mean(flat, dim=1)
    var = true_div(torch.sum((flat - mean[:, None]) ** 2, dim=1), n - 1)
    std = torch.sqrt(var)
    return mean.reshape(b, 1, 1, 1), std.reshape(b, 1, 1, 1)


def normalize_sample(x: torch.Tensor):
    """Normalize with per-sample stats; returns (normed, (mean, std))."""
    mean, std = sample_norm_stats(x)
    return (x - mean) / (std + 1e-7), (mean, std)


def denormalize_sample(x: torch.Tensor, stats) -> torch.Tensor:
    mean, std = stats
    return x * (std + 1e-7) + mean


def init_params(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded init in the Flax defaults' spirit: conv kernels
    N(0, 1/fan_in), biases 0, PReLU slopes 0.25. Draws on the CPU from
    ``generator`` so a seed gives the same weights on every device."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()
                w = torch.randn(m.weight.shape, generator=generator)
                m.weight.copy_(w / fan_in ** 0.5)
                m.bias.zero_()
            elif isinstance(m, nn.PReLU):
                m.weight.fill_(0.25)
