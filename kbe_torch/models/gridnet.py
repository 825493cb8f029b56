"""The grid-net family. Port of ``kbe_tpu/models/gridnet.py``.

``GridLattice`` is columns 1..3 of the 4-column residual lattice given the
finished column 0; ``Disparity`` (depth) and ``Inpaint`` build column 0
and their heads around it. Submodules are named as in the Flax tree
(``stem_image``, ``down{r}x0``, ``lattice.blk{r}x{c}``, ``up{r}x{c}``,
``head`` ...). Public forwards take and return NHWC.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn as nn

from kbe_torch.models.layers import (Basic, Downsample, PReLU, Upsample,
                                     conv, crop_to)


def _dtype(module: nn.Module) -> torch.dtype:
    return next(module.parameters()).dtype


def _nchw(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x.to(dtype).permute(0, 3, 1, 2)


def _nhwc_f32(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).float()


class GridLattice(nn.Module):
    """Columns 1..3: top-down with Downsample injections, then two
    bottom-up columns with Upsample injections (cropped for odd sizes)."""

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
    """Grid-net disparity estimator: 7x7 stride-2 stem, VGG semantics added
    at row 3, output 1 channel at half the input resolution."""

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

    def forward(self, image: torch.Tensor,
                semantics: torch.Tensor) -> torch.Tensor:
        """``image`` (B, H, W, 3), ``semantics`` (B, H/16, W/16, 512) ->
        (B, H/2, W/2, 1) f32."""
        dt = _dtype(self)
        column = [self.stem_image(_nchw(image, dt))]
        sem = self.stem_semantics(_nchw(semantics, dt))
        for r in range(1, len(self.rows)):
            column.append(getattr(self, f"down{r}x0")(column[-1]))
            if r == 3:
                column[r] = column[r] + sem
        return _nhwc_f32(self.head(self.lattice(column)))


class Inpaint(nn.Module):
    """Grid-net inpainter: input cat(data68, mask) = 69 channels, color and
    disparity heads on the top row. Works in normalized space; the flow
    around it lives in ``kbe_torch.pipeline.inpaint_flow``."""

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

    def forward(self, data: torch.Tensor, masks: torch.Tensor):
        """``data`` (B, H, W, 68), ``masks`` (B, H, W, 1) -> (image,
        disparity), NHWC f32, normalized."""
        x = _nchw(torch.cat([data, masks], dim=-1), _dtype(self))
        column = [self.stem(x)]
        for r in range(1, len(self.rows)):
            column.append(getattr(self, f"down{r}x0")(column[-1]))
        top = self.lattice(column)
        return (_nhwc_f32(self.head_image(top)),
                _nhwc_f32(self.head_disparity(top)))


class ContextNet(nn.Module):
    """The 64-channel context extractor of the inpainting render payload."""

    def __init__(self):
        super().__init__()
        self.conv1 = conv(4, 64)
        self.prelu1 = PReLU(64)
        self.conv2 = conv(64, 64)
        self.prelu2 = PReLU(64)

    def forward(self, image: torch.Tensor,
                disparity: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) + (B, H, W, 1) -> (B, H, W, 64) f32."""
        x = _nchw(torch.cat([image, disparity], dim=-1), _dtype(self))
        h = self.prelu2(self.conv2(self.prelu1(self.conv1(x))))
        return _nhwc_f32(h)
