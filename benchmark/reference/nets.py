"""The effect's nets in plain PyTorch, with nothing imported from the port:
copies of the port's ``models/layers.py``, ``semantics.py``, ``gridnet.py``
and ``refine.py`` (the grid-net ``Inpaint``, the plain ``Refine`` and the
residual ``RefinePretrained``), and ``PartialConv`` / ``PartialInpaint``,
written from the published partial-convolution inpainting net (pierlj/
ken-burns-effect ``models/partial_inpainting.py``, built on NVIDIA's
``PartialConv2d``, Liu et al., arXiv:1804.07723). Attribute names are the
port's, so one state dict loads into either. Forwards take and return
NHWC; the convolutions run in the dtype of their weights.

``PartialConv`` departs from pierlj's all-f32 code in its types and in one
order of operations, and nowhere else:

- only the weighted convolution runs in the configuration's ``inpaint``
  precision (bf16 in the production mix). The mask, its coverage, the
  ratio, the PReLUs, the bias, the re-mask and the residual sums stay f32;
  the bias and the slopes are the bf16 values of the loaded weights;
- the weighted convolution runs without its bias, which joins after the
  renormalisation: ``(conv(x * mask) * ratio + bias) * new_mask``. NVIDIA's
  code adds the bias in the convolution and subtracts it again before the
  ratio, which is the same value rounded twice more.

The coverage is NVIDIA's ``multi_channel`` one: an all-ones (out, in, k, k)
convolution of the mask, so every output channel carries the same count.
``model_flags`` reads a configuration's ``models`` and ``nets_for`` lists
the nets those flags build.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

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
    def __init__(self, residual: bool):
        super().__init__()
        self.image_one = Basic("conv-relu-conv", (3, 24, 24),
                               residual=residual)
        self.image_two = Downsample((24, 48, 48))
        self.image_thr = Downsample((48, 96, 96))
        self.disparity_one = Basic("conv-relu-conv", (1, 96, 96),
                                   residual=residual)
        self.disparity_two = Upsample((192, 96, 96))
        self.disparity_thr = Upsample((144, 48, 48))
        self.disparity_fou = Basic("conv-relu-conv", (72, 24, 24),
                                   residual=residual)
        self.refine = Basic("conv-relu-conv", (24, 24, 1), residual=residual)

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

    residual = False

    def __init__(self):
        super().__init__()
        self.core = _RefineCore(self.residual)

    def forward(self, image, disparity):
        return self.core(image, disparity)


class RefinePretrained(Refine):
    """The released refinement checkpoint's layout: residual Basic blocks,
    with a 1x1 ``shortcut`` conv wherever a block changes its channel
    count."""

    residual = True


class _F32PReLU(PReLU):
    """A PReLU on f32 activations, its slopes read in the activations'
    type."""

    def forward(self, x):
        return F.prelu(x, self.weight.to(x.dtype))


class PartialConv(nn.Module):
    """NVIDIA's ``PartialConv2d`` (``multi_channel``, ``return_mask``):
    ``forward(x, mask)`` with ``mask`` the shape of ``x`` returns (output,
    updated mask), the mask with the output's channels."""

    def __init__(self, cin: int, cout: int, kernel: int = 3,
                 stride: int = 1):
        super().__init__()
        self.kernel, self.stride = kernel, stride
        self.conv = nn.Conv2d(cin, cout, kernel, stride=stride,
                              padding=kernel // 2, bias=False)
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor, mask: torch.Tensor):
        cout, cin, k, _ = self.conv.weight.shape
        ones = torch.ones((cout, cin, k, k), dtype=torch.float32,
                          device=x.device)
        coverage = F.conv2d(mask.float(), ones, stride=self.stride,
                            padding=k // 2)
        ratio = true_div(float(cin * k * k), coverage + 1e-8)
        new_mask = torch.clamp(coverage, 0.0, 1.0)
        ratio = ratio * new_mask
        raw = self.conv((x * mask).to(self.conv.weight.dtype))
        out = (raw.float() * ratio + self.bias.float()[None, :, None, None]) \
            * new_mask
        return out, new_mask


class PBasic(nn.Module):
    """A Basic block of partial convs, always residual: the identity, or a
    1x1 partial conv of the block's input under an all-ones mask."""

    def __init__(self, kind: str, channels: Tuple[int, int, int]):
        super().__init__()
        c0, c1, c2 = channels
        self.kind = kind
        if kind == "relu-conv-relu-conv":
            self.prelu1 = _F32PReLU(c0)
        self.conv1 = PartialConv(c0, c1)
        self.prelu2 = _F32PReLU(c1)
        self.conv2 = PartialConv(c1, c2)
        self.identity = c0 == c2
        if not self.identity:
            self.shortcut = PartialConv(c0, c2, kernel=1)

    def forward(self, x, mask):
        h = self.prelu1(x) if self.kind == "relu-conv-relu-conv" else x
        h, mask = self.conv1(h, mask)
        h, mask = self.conv2(self.prelu2(h), mask)
        if self.identity:
            return h + x, mask
        return h + self.shortcut(x, torch.ones_like(x))[0], mask


class PDownsample(nn.Module):
    def __init__(self, channels: Tuple[int, int, int]):
        super().__init__()
        c0, c1, c2 = channels
        self.prelu1 = _F32PReLU(c0)
        self.conv1 = PartialConv(c0, c1, stride=2)
        self.prelu2 = _F32PReLU(c1)
        self.conv2 = PartialConv(c1, c2)

    def forward(self, x, mask):
        h, mask = self.conv1(self.prelu1(x), mask)
        return self.conv2(self.prelu2(h), mask)


class PUpsample(nn.Module):
    """Bilinear 2x of the features and of the mask, the mask thresholded at
    0.5, then PReLU, partial conv, PReLU, partial conv."""

    def __init__(self, channels: Tuple[int, int, int]):
        super().__init__()
        c0, c1, c2 = channels
        self.prelu1 = _F32PReLU(c0)
        self.conv1 = PartialConv(c0, c1)
        self.prelu2 = _F32PReLU(c1)
        self.conv2 = PartialConv(c1, c2)

    def forward(self, x, mask):
        h = upsample2x(x)
        mask = (upsample2x(mask) > 0.5).float()
        h, mask = self.conv1(self.prelu1(h), mask)
        return self.conv2(self.prelu2(h), mask)


class PartialInpaint(nn.Module):
    """The inpainting grid-net of partial convs: data68 (no mask channel),
    masks -> (image, disparity, the mask of row 0), normalised, NHWC f32.
    Where the lattice adds two streams, their masks merge by elementwise
    min."""

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
        self.head_disparity = PBasic("conv-relu-conv", (rows[0], rows[0], 1))

    def forward(self, data, masks):
        n = len(self.rows)
        x = data.float().permute(0, 3, 1, 2)
        mask = masks.float().permute(0, 3, 1, 2).expand(x.shape)
        col, cmask = [None] * n, [None] * n
        col[0], cmask[0] = self.stem(x, mask)
        for r in range(1, n):
            col[r], cmask[r] = getattr(self, f"down{r}x0")(col[r - 1],
                                                          cmask[r - 1])
        for r in range(n):
            col[r], cmask[r] = getattr(self, f"blk{r}x1")(col[r], cmask[r])
            if r != 0:
                d, dm = getattr(self, f"down{r}x1")(col[r - 1], cmask[r - 1])
                col[r] = col[r] + d
                cmask[r] = torch.minimum(cmask[r], dm)
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
        return (_nhwc_f32(image), _nhwc_f32(disparity),
                _nhwc_f32(cmask[0][:, :1]))


# ``KenBurnsPipeline.create``'s flags, by their names; each false where a
# configuration's ``models`` leaves it out
MODEL_FLAGS = ("pretrained_refine", "partial_inpainting", "inpaint_depth")


def model_flags(config: dict) -> Dict[str, bool]:
    """The configuration's ``models``: {flag: bool} of ``MODEL_FLAGS``."""
    given = config.get("models") or {}
    unknown = sorted(set(given) - set(MODEL_FLAGS))
    if unknown:
        raise ValueError(f"unknown models flags {unknown}; known: "
                         f"{MODEL_FLAGS}")
    return {flag: bool(given.get(flag, False)) for flag in MODEL_FLAGS}


def nets_for(models: Dict[str, bool]) -> tuple:
    """(name, class, precision kind) of the nets that ``models`` (a
    ``model_flags``) builds, in the order of the port's ``PipelineModels``:
    the five nets, ``refine`` and ``inpaint`` swapped for their variants as
    the flags say, then ``context_depth`` and ``inpaint_depth`` where
    ``inpaint_depth`` is set."""
    inpaint = PartialInpaint if models["partial_inpainting"] else Inpaint
    nets = (("semantics", Semantics, "depth"),
            ("disparity", Disparity, "depth"),
            ("refine", RefinePretrained if models["pretrained_refine"]
             else Refine, "depth"),
            ("context", ContextNet, "inpaint"),
            ("inpaint", inpaint, "inpaint"))
    if models["inpaint_depth"]:
        nets += (("context_depth", ContextNet, "inpaint"),
                 ("inpaint_depth", inpaint, "inpaint"))
    return nets


def build_nets(device, models: Dict[str, bool]) -> dict:
    """{name: net} of the nets that ``models`` builds, their weights not
    yet made (on the meta device, which allocates nothing)."""
    with torch.device(device):
        return {name: cls() for name, cls, _ in nets_for(models)}
