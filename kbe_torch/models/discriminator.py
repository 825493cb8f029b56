"""The discriminators of adversarial inpainting training. Port of
``kbe_tpu/models/discriminator.py``:

  Discriminator                      PatchGAN, 4x4 stride-2 convs
  PerceptualDiscriminator            VGG16 features -> convs
  MultiScalePerceptualDiscriminator  3 heads over VGG and conv pyramids
  MultiScaleDiscriminator            3 heads, no VGG
  MPDDiscriminator                   (image, disparity) 4-channel input: the
                                     one the inpainting trainer uses

and ``adversarial_loss`` (LSGAN). Forwards take NHWC and a ``train`` flag,
as the Flax modules do: with ``train`` the batch norms use and fold in the
batch statistics and the spectral norms store their power iteration; the
flag, not ``nn.Module.training``, decides.

Two layers mirror Flax rather than ``torch.nn``, because their state and
gradients differ:

``BatchNorm`` (Flax ``nn.BatchNorm``): batch mean and the *biased* variance
E[x^2] - E[x]^2 (clipped at 0), running averages at momentum 0.99, eps
1e-5; the gradient flows through the batch statistics. ``torch.nn.
BatchNorm2d`` keeps the unbiased variance and the other momentum.

``SpectralConv2d`` (Flax ``nn.SpectralNorm`` around a conv): the kernel,
as Flax's (kh, kw, in, out) flattened to (kh*kw*in, out), is divided by
sigma = v W u^T after one power step from the stored ``u`` (1, out), in
both modes (eval only skips storing ``u`` and ``sigma``); eps 1e-12; u and
v carry no gradient, W does. ``torch.nn.utils.spectral_norm`` flattens to
(out, -1), skips the step in eval and keeps its own ``u``.

Parameter and buffer names mirror the Flax tree (``core.pyr0.conv0``,
``core.local1.block0.conv``, ``.bn``, ``.out``; ``u``/``sigma``/``mean``/
``var`` from ``batch_stats``), so ``kbe_torch.utils.convert`` maps it.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from kbe_torch.models.vgg import VGG16Features


class BatchNorm(nn.Module):
    """Flax's BatchNorm over the channels of an NCHW tensor."""

    def __init__(self, features: int, momentum: float = 0.99,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        if train:
            mean = torch.mean(x, dim=(0, 2, 3))
            var = torch.clamp(torch.mean(x * x, dim=(0, 2, 3)) - mean * mean,
                              min=0.0)
            with torch.no_grad():
                keep = self.momentum
                self.mean.copy_(keep * self.mean + (1.0 - keep) * mean)
                self.var.copy_(keep * self.var + (1.0 - keep) * var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.eps) * self.scale
        y = (x - mean[None, :, None, None]) * mul[None, :, None, None]
        return y + self.bias[None, :, None, None]


def _l2_normalize(x: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.sum(x * x) + eps)


class SpectralConv2d(nn.Conv2d):
    """A conv whose kernel is spectrally normalised as Flax's SpectralNorm
    normalises it (see the module doc)."""

    def __init__(self, *args, eps: float = 1e-12, **kwargs):
        super().__init__(*args, **kwargs)
        self.eps = eps
        self.register_buffer("u", torch.randn(1, self.out_channels))
        self.register_buffer("sigma", torch.ones(()))

    def normalized_weight(self, update_stats: bool) -> torch.Tensor:
        w = self.weight
        mat = w.permute(2, 3, 1, 0).reshape(-1, self.out_channels)
        with torch.no_grad():
            v0 = _l2_normalize(self.u @ mat.T, self.eps)
            u0 = _l2_normalize(v0 @ mat, self.eps)
        sigma = (v0 @ mat @ u0.T)[0, 0]
        if update_stats:
            with torch.no_grad():
                self.u.copy_(u0)
                self.sigma.copy_(sigma)
        return w / torch.where(sigma != 0, sigma, torch.ones_like(sigma))

    def forward(self, x: torch.Tensor, update_stats: bool = False):
        return self._conv_forward(x, self.normalized_weight(update_stats),
                                  self.bias)


def _conv(sn: bool, *args, **kwargs) -> nn.Conv2d:
    return (SpectralConv2d if sn else nn.Conv2d)(*args, **kwargs)


def _apply_conv(conv: nn.Conv2d, x, train: bool):
    if isinstance(conv, SpectralConv2d):
        return conv(x, update_stats=train)
    return conv(x)


class ConvBlock(nn.Module):
    """4x4 conv (+ BatchNorm) + LeakyReLU(0.2), NCHW."""

    def __init__(self, cin: int, features: int, stride: int = 2,
                 dilation: int = 1, use_bn: bool = True,
                 spectral_norm: bool = False):
        super().__init__()
        self.conv = _conv(spectral_norm, cin, features, 4, stride=stride,
                          padding=1, dilation=dilation)
        self.bn = BatchNorm(features) if use_bn else None

    def forward(self, x, train: bool = True):
        x = _apply_conv(self.conv, x, train)
        if self.bn is not None:
            x = self.bn(x, train)
        return F.leaky_relu(x, 0.2)


class VGGBlock(nn.Module):
    """2 or 3 3x3 convs with LeakyReLU(0.2), then a 2x2 average pool, NCHW."""

    def __init__(self, cin: int, features: int, small: bool = True,
                 spectral_norm: bool = False):
        super().__init__()
        self.n = 2 if small else 3
        for i in range(self.n):
            self.add_module(f"conv{i}", _conv(spectral_norm, cin, features, 3,
                                              padding=1))
            cin = features

    def forward(self, x, train: bool = True):
        for i in range(self.n):
            x = F.leaky_relu(_apply_conv(getattr(self, f"conv{i}"), x, train),
                             0.2)
        return F.avg_pool2d(x, 2, 2)


class Discriminator(nn.Module):
    """PatchGAN head, NCHW in and out. Default: a 32-64-128-256 stride-2
    pyramid over ``cin`` channels; or (channels, dilation, stride) stacks,
    ``channels[0]`` the input, as the multi-scale sub-heads use."""

    def __init__(self, cin: Optional[int] = 3,
                 channels: Optional[Sequence[int]] = None,
                 dilation: Optional[Sequence[int]] = None,
                 stride: Optional[Sequence[int]] = None,
                 spectral_norm: bool = False):
        super().__init__()
        if channels is None:
            specs = [(32, 2, 1, False), (64, 2, 1, True), (128, 2, 1, True),
                     (256, 2, 1, True)]
        else:
            cin = channels[0]
            specs = [(channels[i + 1], stride[i], dilation[i], True)
                     for i in range(len(channels) - 1)]
        self.n = len(specs)
        for i, (feat, st, dil, bn) in enumerate(specs):
            self.add_module(f"block{i}", ConvBlock(
                cin, feat, stride=st, dilation=dil, use_bn=bn,
                spectral_norm=spectral_norm))
            cin = feat
        self.out = nn.Conv2d(cin, 1, 4, padding=1)

    def forward_nchw(self, x, train: bool = True):
        for i in range(self.n):
            x = getattr(self, f"block{i}")(x, train)
        return self.out(x)

    def forward(self, image, train: bool = True):
        """(B, H, W, C) -> patch logits (B, h, w, 1)."""
        return self.forward_nchw(image.permute(0, 3, 1, 2),
                                 train).permute(0, 2, 3, 1)


class PerceptualDiscriminator(nn.Module):
    """VGG16 slice-3 features -> 3 ConvBlocks -> patch logits."""

    def __init__(self, spectral_norm: bool = False):
        super().__init__()
        self.vgg = VGG16Features()
        for i in range(3):
            self.add_module(f"block{i}", ConvBlock(
                256, 256, spectral_norm=spectral_norm))
        self.out = nn.Conv2d(256, 1, 4, padding=1)

    def forward(self, image, train: bool = True):
        h = self.vgg.forward_nchw(image.permute(0, 3, 1, 2))[-1]
        for i in range(3):
            h = getattr(self, f"block{i}")(h, train)
        return self.out(h).permute(0, 2, 3, 1)


class _MultiScaleCore(nn.Module):
    """The 3-head pyramid shared by the multi-scale discriminators."""

    def __init__(self, use_vgg: bool, cin: int, spectral_norm: bool = False):
        super().__init__()
        sn = spectral_norm
        self.use_vgg = use_vgg
        if use_vgg:
            self.vgg = VGG16Features()
            self.pyr0 = VGGBlock(cin, 64, spectral_norm=sn)
            self.pyr1 = VGGBlock(64 + 64, 128, spectral_norm=sn)
            self.pyr2 = VGGBlock(128 + 128, 256, small=False,
                                 spectral_norm=sn)
            chans = ((256, 256, 256), (512, 256, 256), (512, 256, 256, 256))
        else:
            self.pyr0 = VGGBlock(cin, 64, spectral_norm=sn)
            self.pyr1 = VGGBlock(64, 128, spectral_norm=sn)
            self.pyr2 = VGGBlock(128, 256, small=False, spectral_norm=sn)
            chans = ((128, 256, 256), (256, 256, 256), (256, 256, 256, 256))
        self.local1 = Discriminator(channels=chans[0], dilation=(1, 1),
                                    stride=(1, 1), spectral_norm=sn)
        self.local2 = Discriminator(channels=chans[1], dilation=(1, 1),
                                    stride=(2, 1), spectral_norm=sn)
        self.main = Discriminator(channels=chans[2], dilation=(8, 4, 1),
                                  stride=(1, 1, 1), spectral_norm=sn)

    def forward(self, x, vgg_input=None, train: bool = True):
        """NCHW in; the three heads' sigmoids, NHWC."""
        if self.use_vgg:
            f1, f2, f3 = self.vgg.forward_nchw(vgg_input)
            h1 = self.pyr0(x, train)
            h2 = self.pyr1(torch.cat([f1, h1], 1), train)
            h3 = self.pyr2(torch.cat([f2, h2], 1), train)
            local1_in = torch.cat([f2, h2], 1)
            local2_in = torch.cat([f3, h3], 1)
            main_in = local2_in
        else:
            h1 = self.pyr0(x, train)
            h2 = self.pyr1(h1, train)
            h3 = self.pyr2(h2, train)
            local1_in, local2_in, main_in = h2, h3, h3
        heads = (self.local1.forward_nchw(local1_in, train),
                 self.local2.forward_nchw(local2_in, train),
                 self.main.forward_nchw(main_in, train))
        return [torch.sigmoid(p).permute(0, 2, 3, 1) for p in heads]


class MultiScalePerceptualDiscriminator(nn.Module):

    def __init__(self, spectral_norm: bool = False):
        super().__init__()
        self.core = _MultiScaleCore(True, 3, spectral_norm)

    def forward(self, image, train: bool = True) -> List[torch.Tensor]:
        x = image.permute(0, 3, 1, 2)
        return self.core(x, vgg_input=x, train=train)


class MultiScaleDiscriminator(nn.Module):

    def __init__(self, spectral_norm: bool = False):
        super().__init__()
        self.core = _MultiScaleCore(False, 3, spectral_norm)

    def forward(self, image, train: bool = True) -> List[torch.Tensor]:
        return self.core(image.permute(0, 3, 1, 2), train=train)


class MPDDiscriminator(nn.Module):
    """Multi-scale perceptual discriminator over (image, disparity): the
    adversarial trainer's discriminator. Needs images of at least 288^2."""

    def __init__(self, spectral_norm: bool = False):
        super().__init__()
        self.core = _MultiScaleCore(True, 4, spectral_norm)

    def forward(self, image, disparity, train: bool = True
                ) -> List[torch.Tensor]:
        """(B, H, W, 3) image and (B, H, W, 1) disparity -> the sigmoid
        patch maps of the three heads, NHWC."""
        x = torch.cat([image, disparity], dim=-1).permute(0, 3, 1, 2)
        return self.core(x, vgg_input=image.permute(0, 3, 1, 2), train=train)


def adversarial_loss(predictions, is_real: bool) -> torch.Tensor:
    """LSGAN MSE against all-ones or all-zeros labels, averaged over the
    heads."""
    preds = (predictions if isinstance(predictions, (list, tuple))
             else [predictions])
    target = 1.0 if is_real else 0.0
    return sum(torch.mean((p - target) ** 2) for p in preds) / len(preds)
