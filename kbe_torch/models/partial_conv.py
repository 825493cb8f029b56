"""Mask-aware (partial) convolutions and the partial-conv inpainting net.
Port of ``kbe_tpu/models/partial_conv.py``.

A partial convolution only sees masked-in pixels: its output is
renormalised by ``window / coverage`` and re-masked, and the mask is
propagated by an all-ones convolution. ``PartialInpaint`` is the inpainting
grid-net built from them, with masks merged by elementwise min wherever
the lattice adds two streams.

Every mask of ``PartialInpaint`` is the same in every channel: the stem's
is one channel broadcast, an update gives one coverage to all output
channels, and the min of two such masks and their bilinear 2x stay so. So
the net carries each mask as one channel (B, 1, H, W), and a partial conv
takes its coverage as the box sum of that channel times ``C_in``
(``ops/pconv.py``), equal bit for bit to the all-ones convolution over
``C_in`` copies for the 0/1 masks the net makes. A mask of ``C_in``
channels takes the general path, on the CPU only: on CUDA it raises
``ValueError``. The mask side (coverage, ratio, bias, re-mask) is the span
``kbe/bootstrap/pconv_mask``; on CUDA, with no gradient wanted, it is one
launch of kernel ``pconv`` (whose wrapper refuses, by ``ValueError``, what
it cannot take, such as a mask that is not f32), else the plain chain.
The span is named for the effect's bootstrap, where the net runs in the
effect (inside ``kbe/bootstrap/inpaint``), because the benchmark's
``bootstrap_ms`` counts device time by the ``bootstrap/`` prefix of the
innermost span; a traced run of the net outside the effect (training,
evaluation) shows it under that name too. The counters ``pconv_calls``, ``pconv_out_elems`` (B * C_out * H' *
W') and ``pconv_mask_px`` (B * (H * W + H' * W'), one channel; a conv
given no mask reads none and counts only its new one) count the model's
shapes.

Attribute names mirror the Flax tree (``conv1/conv/kernel`` and
``conv1/bias`` side by side), so ``state_dict_from_flax`` maps it
mechanically. The modules take and return NCHW; ``PartialInpaint`` converts
at its NHWC boundary.

Types, as the Flax modules have them: only the weighted convolution runs in
the module's compute type (bf16 in the production mix). Its result times the
f32 ratio promotes back to f32, so the mask, the coverage count (up to
256 * 9 = 2304), the ratio, the PReLUs and the residual sums are f32 in
every mix. The PReLU slope is therefore read in the activation's type.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from kbe_torch.models.layers import crop_to, upsample2x
from kbe_torch.ops import pconv
from kbe_torch.utils.logging import count, span


class _PReLU(nn.Module):
    """Per-channel PReLU whose slope (param ``weight`` <- Flax ``slope``)
    follows the input's type."""

    def __init__(self, features: int, init: float = 0.25):
        super().__init__()
        self.weight = nn.Parameter(torch.full((features,), init))

    def forward(self, x):
        a = self.weight.to(x.dtype).view(1, -1, 1, 1)
        return torch.clamp(x, min=0) + a * torch.clamp(x, max=0)


class PartialConv(nn.Module):
    """Multi-channel partial convolution. ``forward(x, mask)`` returns
    (output, updated mask). A mask (B, 1, H, W) stands for the same mask in
    every input channel and gives a one-channel mask; a mask of ``x``'s
    channels (CPU only), or ``mask=None`` (all ones), gives the updated
    mask broadcast to the output's channels."""

    def __init__(self, cin: int, cout: int, kernel: int = 3,
                 stride: int = 1):
        super().__init__()
        self.kernel, self.stride = kernel, stride
        self.conv = nn.Conv2d(cin, cout, kernel, stride=stride,
                              padding=kernel // 2, bias=False)
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None):
        k, stride, pad = self.kernel, self.stride, self.kernel // 2
        in_ch, in_hw = x.shape[1], tuple(x.shape[2:])
        if mask is not None:
            mask = mask.to(x.dtype)
            x = x * mask
        raw = self.conv(x.to(self.conv.weight.dtype))
        bias = self.bias.to(raw.dtype)
        one_channel = mask is None or mask.shape[1] == 1
        if raw.is_cuda and not one_channel:
            raise ValueError("a partial conv on CUDA takes a one-channel "
                             "mask or none; a mask of C_in channels takes "
                             "the general path on the CPU only")
        use_kernel = raw.is_cuda and not (torch.is_grad_enabled() and (
            raw.requires_grad or bias.requires_grad))
        with span("bootstrap/pconv_mask"):
            count("pconv_calls", 1)
            count("pconv_out_elems", raw.numel())
            count("pconv_mask_px", raw.shape[0] * (
                (0 if mask is None else in_hw[0] * in_hw[1])
                + raw.shape[2] * raw.shape[3]))
            if use_kernel:
                out, new_mask = pconv.mask_side_cuda(
                    raw, mask, bias, in_ch, in_hw, k, stride, pad)
            else:
                # no gradient flows through the mask
                with torch.no_grad():
                    if one_channel:
                        coverage = pconv.coverage_plain(
                            mask, in_ch, in_hw, k, stride, pad, x)
                    else:
                        ones_k = torch.ones((1, in_ch, k, k), dtype=x.dtype,
                                            device=x.device)
                        coverage = F.conv2d(mask, ones_k, stride=stride,
                                            padding=pad)
                out, new_mask = pconv.mask_side_plain(
                    raw, coverage, bias, float(in_ch * k * k))
        if mask is not None and mask.shape[1] == 1:
            return out, new_mask
        return out, new_mask.expand(out.shape)


class PBasic(nn.Module):
    """Partial-conv Basic block with a residual shortcut: the identity, or
    a 1x1 partial conv whose mask is not propagated."""

    def __init__(self, kind: str, channels: Tuple[int, int, int]):
        super().__init__()
        c0, c1, c2 = channels
        if kind not in ("relu-conv-relu-conv", "conv-relu-conv"):
            raise ValueError(f"unknown PBasic kind {kind!r}")
        self.kind = kind
        if kind == "relu-conv-relu-conv":
            self.prelu1 = _PReLU(c0)
        self.conv1 = PartialConv(c0, c1)
        self.prelu2 = _PReLU(c1)
        self.conv2 = PartialConv(c1, c2)
        self.identity = c0 == c2
        if not self.identity:
            self.shortcut = PartialConv(c0, c2, kernel=1)

    def forward(self, x, mask):
        h = self.prelu1(x) if self.kind == "relu-conv-relu-conv" else x
        h, mask = self.conv1(h, mask)
        h, mask = self.conv2(self.prelu2(h), mask)
        shortcut = x if self.identity else self.shortcut(x, None)[0]
        return h + shortcut, mask


class PDownsample(nn.Module):
    """PReLU, stride-2 partial conv, PReLU, partial conv."""

    def __init__(self, channels: Tuple[int, int, int]):
        super().__init__()
        c0, c1, c2 = channels
        self.prelu1 = _PReLU(c0)
        self.conv1 = PartialConv(c0, c1, stride=2)
        self.prelu2 = _PReLU(c1)
        self.conv2 = PartialConv(c1, c2)

    def forward(self, x, mask):
        h, mask = self.conv1(self.prelu1(x), mask)
        return self.conv2(self.prelu2(h), mask)


class PUpsample(nn.Module):
    """Bilinear 2x of the features, and of the mask thresholded at 0.5,
    then PReLU, partial conv, PReLU, partial conv."""

    def __init__(self, channels: Tuple[int, int, int]):
        super().__init__()
        c0, c1, c2 = channels
        self.prelu1 = _PReLU(c0)
        self.conv1 = PartialConv(c0, c1)
        self.prelu2 = _PReLU(c1)
        self.conv2 = PartialConv(c1, c2)

    def forward(self, x, mask):
        h = upsample2x(x)
        mask = (upsample2x(mask) > 0.5).to(h.dtype)
        h, mask = self.conv1(self.prelu1(h), mask)
        return self.conv2(self.prelu2(h), mask)


class PartialInpaint(nn.Module):
    """Partial-conv inpainting grid-net: the 4-row lattice of ``Inpaint``
    with every conv mask-aware. The input is the 68-channel payload alone:
    the mask is the convs' mask, not a channel."""

    def __init__(self, rows: Tuple[int, ...] = (32, 64, 128, 256),
                 in_channels: int = 68):
        super().__init__()
        self.rows = tuple(rows)
        n = len(rows)
        self.stem = PBasic("conv-relu-conv", (in_channels, rows[0], rows[0]))
        for r in range(1, n):
            self.add_module(f"down{r}x0",
                            PDownsample((rows[r - 1], rows[r], rows[r])))
        for col in (1, 2, 3):
            for r in range(n):
                self.add_module(f"blk{r}x{col}", PBasic(
                    "relu-conv-relu-conv", (rows[r], rows[r], rows[r])))
        for r in range(1, n):
            self.add_module(f"down{r}x1",
                            PDownsample((rows[r - 1], rows[r], rows[r])))
        for col in (2, 3):
            for r in range(n - 1):
                self.add_module(f"up{r}x{col}",
                                PUpsample((rows[r + 1], rows[r], rows[r])))
        self.head_image = PBasic("conv-relu-conv", (rows[0], rows[0], 3))
        self.head_disparity = PBasic("conv-relu-conv",
                                     (rows[0], rows[0], 1))

    def forward(self, data: torch.Tensor, masks: torch.Tensor):
        """``data`` (B, H, W, 68), ``masks`` (B, H, W, 1) -> (image,
        disparity, existing mask), NHWC f32, normalized space."""
        n = len(self.rows)
        x = data.permute(0, 3, 1, 2)
        mask0 = masks.permute(0, 3, 1, 2).to(x.dtype)
        col, cmask = [None] * n, [None] * n
        col[0], cmask[0] = self.stem(x, mask0)
        for r in range(1, n):
            col[r], cmask[r] = getattr(self, f"down{r}x0")(col[r - 1],
                                                          cmask[r - 1])
        # column 1, top-down
        for r in range(n):
            col[r], cmask[r] = getattr(self, f"blk{r}x1")(col[r], cmask[r])
            if r != 0:
                d, dm = getattr(self, f"down{r}x1")(col[r - 1], cmask[r - 1])
                col[r] = col[r] + d
                cmask[r] = torch.minimum(cmask[r], dm)
        # columns 2 and 3, bottom-up
        for c in (2, 3):
            for r in range(n - 1, -1, -1):
                col[r], cmask[r] = getattr(self, f"blk{r}x{c}")(col[r],
                                                                cmask[r])
                if r != n - 1:
                    u, um = getattr(self, f"up{r}x{c}")(col[r + 1],
                                                        cmask[r + 1])
                    hh, ww = col[r].shape[2], col[r].shape[3]
                    col[r] = col[r] + crop_to(u, hh, ww)
                    cmask[r] = torch.minimum(cmask[r], crop_to(um, hh, ww))
        image, _ = self.head_image(col[0], cmask[0])
        disparity, _ = self.head_disparity(col[0], cmask[0])

        def nhwc(t):
            return t.permute(0, 2, 3, 1).float()

        return nhwc(image), nhwc(disparity), nhwc(cmask[0][:, :1])


def net_pconv_shapes(height: int, width: int,
                     rows: Tuple[int, ...] = (32, 64, 128, 256)):
    """[(C_in, C_out, k, stride, H, W, masked)] of each partial conv of one
    ``PartialInpaint`` call on a (height, width) payload, in call order:
    the net run on the meta device, which computes nothing."""
    with torch.device("meta"):
        net = PartialInpaint(rows)
    shapes = []

    def record(conv, args, _):
        x = args[0]
        masked = len(args) > 1 and args[1] is not None
        shapes.append((x.shape[1], conv.conv.out_channels, conv.kernel,
                       conv.stride, x.shape[2], x.shape[3], masked))

    for m in net.modules():
        if isinstance(m, PartialConv):
            m.register_forward_hook(record)
    with torch.no_grad():
        net(torch.zeros(1, height, width, 68, device="meta"),
            torch.zeros(1, height, width, 1, device="meta"))
    return shapes
