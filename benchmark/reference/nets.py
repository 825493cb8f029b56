"""The effect's nets in plain PyTorch: a frozen copy of the port's
``models/layers.py``, ``semantics.py``, ``gridnet.py`` and ``refine.py``
(the grid-net ``Inpaint`` and the plain ``Refine``), with nothing imported
from the port. Attribute names are the port's, so one state dict loads into
either. Forwards take and return NHWC; the convolutions run in the dtype of
their weights.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.ops import resize_bilinear, true_div


class PReLU(nn.PReLU):
    def __init__(self, features: int, init: float = 0.25):
        super().__init__(num_parameters=features, init=init)


def conv(cin: int, cout: int, kernel: int = 3, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, kernel, stride=stride, padding=kernel // 2)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    b, c, h, w = x.shape
    return resize_bilinear(x.permute(0, 2, 3, 1), 2 * h, 2 * w).permute(
        0, 3, 1, 2)


def crop_to(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    return x[:, :, :height, :width]


class Basic(nn.Module):
    def __init__(self, kind: str, channels: Tuple[int, int, int],
                 residual: bool = True):
        super().__init__()
        c0, c1, c2 = channels
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
    """Per-sample mean and Bessel-corrected std, in f32."""
    b = x.shape[0]
    flat = x.reshape(b, -1).to(torch.float32)
    n = flat.shape[1]
    mean = torch.mean(flat, dim=1)
    var = true_div(torch.sum((flat - mean[:, None]) ** 2, dim=1), n - 1)
    return mean.reshape(b, 1, 1, 1), torch.sqrt(var).reshape(b, 1, 1, 1)


def normalize_sample(x: torch.Tensor):
    mean, std = sample_norm_stats(x)
    return (x - mean) / (std + 1e-7), (mean, std)


def denormalize_sample(x: torch.Tensor, stats) -> torch.Tensor:
    mean, std = stats
    return x * (std + 1e-7) + mean


_VGG_BLOCKS = ((64, 64), (128, 128), (256, 256, 256, 256),
               (512, 512, 512, 512))
_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


class Semantics(nn.Module):
    """VGG19 (BN folded) blocks 1-4 with ceil-mode pools, BGR input:
    (B, H, W, 3) -> (B, H/16, W/16, 512) f32."""

    def __init__(self):
        super().__init__()
        cin = 3
        for b, widths in enumerate(_VGG_BLOCKS):
            for i, wch in enumerate(widths):
                self.add_module(f"conv{b}_{i}", conv(cin, wch))
                cin = wch

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        dtype = self.conv0_0.weight.dtype
        x = image.flip(-1)
        mean = torch.tensor(_IMAGENET_MEAN, dtype=torch.float32,
                            device=x.device)
        std = torch.tensor(_IMAGENET_STD, dtype=torch.float32,
                           device=x.device)
        x = ((x.float() - mean) / std).to(dtype).permute(0, 3, 1, 2)
        for b, widths in enumerate(_VGG_BLOCKS):
            for i in range(len(widths)):
                x = F.relu(getattr(self, f"conv{b}_{i}")(x))
            x = F.max_pool2d(x, 2, 2, ceil_mode=True)
        return x.permute(0, 2, 3, 1).float()


def _dtype(module: nn.Module) -> torch.dtype:
    return next(module.parameters()).dtype


def _nchw(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x.to(dtype).permute(0, 3, 1, 2)


def _nhwc_f32(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).float()


class GridLattice(nn.Module):
    def __init__(self, rows: Sequence[int]):
        super().__init__()
        self.rows = tuple(rows)
        n = len(rows)
        for col in (1, 2, 3):
            for r in range(n):
                self.add_module(f"blk{r}x{col}", Basic(
                    "relu-conv-relu-conv", (rows[r], rows[r], rows[r])))
        for r in range(1, n):
            self.add_module(f"down{r}x1",
                            Downsample((rows[r - 1], rows[r], rows[r])))
        for col in (2, 3):
            for r in range(n - 1):
                self.add_module(f"up{r}x{col}",
                                Upsample((rows[r + 1], rows[r], rows[r])))

    def forward(self, column: List[torch.Tensor]) -> torch.Tensor:
        n = len(self.rows)
        out = list(column)
        for r in range(n):
            out[r] = getattr(self, f"blk{r}x1")(out[r])
            if r != 0:
                out[r] = out[r] + getattr(self, f"down{r}x1")(out[r - 1])
        for col in (2, 3):
            for r in range(n - 1, -1, -1):
                out[r] = getattr(self, f"blk{r}x{col}")(out[r])
                if r != n - 1:
                    up = getattr(self, f"up{r}x{col}")(out[r + 1])
                    out[r] = out[r] + crop_to(up, out[r].shape[2],
                                              out[r].shape[3])
        return out[0]


class Disparity(nn.Module):
    """(B, H, W, 3), semantics (B, H/16, W/16, 512) -> (B, H/2, W/2, 1)."""

    def __init__(self, rows: Tuple[int, ...] = (32, 48, 64, 512, 512, 512)):
        super().__init__()
        self.rows = tuple(rows)
        self.stem_image = nn.Conv2d(3, rows[0], 7, stride=2, padding=3)
        self.stem_semantics = conv(512, rows[3])
        for r in range(1, len(rows)):
            self.add_module(f"down{r}x0",
                            Downsample((rows[r - 1], rows[r], rows[r])))
        self.lattice = GridLattice(rows)
        self.head = Basic("conv-relu-conv", (rows[0], rows[0], 1))

    def forward(self, image, semantics):
        dt = _dtype(self)
        column = [self.stem_image(_nchw(image, dt))]
        sem = self.stem_semantics(_nchw(semantics, dt))
        for r in range(1, len(self.rows)):
            column.append(getattr(self, f"down{r}x0")(column[-1]))
            if r == 3:
                column[r] = column[r] + sem
        return _nhwc_f32(self.head(self.lattice(column)))


class Inpaint(nn.Module):
    """cat(data68, mask) -> (image, disparity), normalised, NHWC f32."""

    def __init__(self, rows: Tuple[int, ...] = (32, 64, 128, 256),
                 in_channels: int = 69):
        super().__init__()
        self.rows = tuple(rows)
        self.stem = Basic("conv-relu-conv", (in_channels, rows[0], rows[0]))
        for r in range(1, len(rows)):
            self.add_module(f"down{r}x0",
                            Downsample((rows[r - 1], rows[r], rows[r])))
        self.lattice = GridLattice(rows)
        self.head_image = Basic("conv-relu-conv", (rows[0], rows[0], 3))
        self.head_disparity = Basic("conv-relu-conv", (rows[0], rows[0], 1))

    def forward(self, data, masks):
        x = _nchw(torch.cat([data, masks], dim=-1), _dtype(self))
        column = [self.stem(x)]
        for r in range(1, len(self.rows)):
            column.append(getattr(self, f"down{r}x0")(column[-1]))
        top = self.lattice(column)
        return (_nhwc_f32(self.head_image(top)),
                _nhwc_f32(self.head_disparity(top)))


class ContextNet(nn.Module):
    """(B, H, W, 3) + (B, H, W, 1) -> (B, H, W, 64) f32."""

    def __init__(self):
        super().__init__()
        self.conv1 = conv(4, 64)
        self.prelu1 = PReLU(64)
        self.conv2 = conv(64, 64)
        self.prelu2 = PReLU(64)

    def forward(self, image, disparity):
        x = _nchw(torch.cat([image, disparity], dim=-1), _dtype(self))
        return _nhwc_f32(self.prelu2(self.conv2(self.prelu1(self.conv1(x)))))


class _RefineCore(nn.Module):
    def __init__(self):
        super().__init__()
        self.image_one = Basic("conv-relu-conv", (3, 24, 24), residual=False)
        self.image_two = Downsample((24, 48, 48))
        self.image_thr = Downsample((48, 96, 96))
        self.disparity_one = Basic("conv-relu-conv", (1, 96, 96),
                                   residual=False)
        self.disparity_two = Upsample((192, 96, 96))
        self.disparity_thr = Upsample((144, 48, 48))
        self.disparity_fou = Basic("conv-relu-conv", (72, 24, 24),
                                   residual=False)
        self.refine = Basic("conv-relu-conv", (24, 24, 1), residual=False)

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
    """(B, H, W, 3), disparity (B, H/4, W/4, 1) -> (B, H, W, 1) f32."""

    def __init__(self):
        super().__init__()
        self.core = _RefineCore()

    def forward(self, image, disparity):
        return self.core(image, disparity)


# the effect's nets, in the order of the port's ``PipelineModels``, and
# which of the configuration's two precisions each runs in
NETS = (("semantics", Semantics, "depth"), ("disparity", Disparity, "depth"),
        ("refine", Refine, "depth"), ("context", ContextNet, "inpaint"),
        ("inpaint", Inpaint, "inpaint"))


def build_nets(device="meta") -> dict:
    """{name: net} of the effect's nets, their weights not yet made (on the
    meta device, which allocates nothing)."""
    with torch.device(device):
        return {name: cls() for name, cls, _ in NETS}
