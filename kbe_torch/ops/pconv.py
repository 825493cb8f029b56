"""The partial convolution's mask side: coverage -> ratio -> bias ->
re-mask. Plain PyTorch chain + CUDA kernel.

A partial convolution (``models/partial_conv.py::PartialConv``) convolves
the masked input, then renormalises the result by ``window / coverage``,
adds the bias and re-masks it, and propagates the mask. Where the mask is
the same in every input channel it is carried as one channel (B, 1, H, W),
and the coverage is the k x k box sum of that channel (the conv's stride,
zero padding) times the input's channels ``C_in``. For a 0/1 mask, the
only masks the nets make, the box sum of one channel times ``C_in`` is an
exact integer (at most 256 * 9 in the inpainting net), so it equals the
all-ones convolution over ``C_in`` copies bit for bit.

``mask_side_plain`` is the chain in PyTorch, for the CPU and for training.
``mask_side_cuda`` is kernel ``pconv_kernel`` (``csrc/pconv.cu``): one
launch a partial conv, bit-equal to the plain chain, writing the output
in f32 and the one-channel new mask. The wrapper takes CUDA tensors only
and counts its launches in ``LAUNCHES`` (``pconv``).

Both compute, with ``window = C_in * k * k`` and no fused multiply-add::

    coverage = box_sum(mask) * C_in
    new_mask = clamp(coverage, 0, 1)
    ratio    = (window / (coverage + 1e-8)) * new_mask    (IEEE division)
    out      = (raw * ratio + bias) * new_mask             (f32)
"""

from __future__ import annotations

import collections
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from kbe_torch.ops import _build
from kbe_torch.ops.geometry import true_div

LAUNCHES: collections.Counter = collections.Counter()

TILE_ELEMS = 8192   # output values a block, about; its pixels <= THREADS
THREADS = 256


def out_size(size: int, kernel: int, stride: int, padding: int) -> int:
    """A convolution's output length along an axis of ``size``."""
    return (size + 2 * padding - kernel) // stride + 1


def coverage_plain(mask: Optional[torch.Tensor], in_channels: int,
                   in_hw: Tuple[int, int], kernel: int, stride: int,
                   padding: int, like: torch.Tensor) -> torch.Tensor:
    """(B, 1, H', W') coverage of the one-channel ``mask`` (B, 1, H, W), in
    ``like``'s type and on its device; ``mask=None`` is all ones, border
    windows counting only their pixels inside the image."""
    if mask is None:
        mask = torch.ones((like.shape[0], 1) + tuple(in_hw),
                          dtype=like.dtype, device=like.device)
    ones = torch.ones((1, 1, kernel, kernel), dtype=mask.dtype,
                      device=mask.device)
    return F.conv2d(mask, ones, stride=stride, padding=padding) * in_channels


def mask_side_plain(raw: torch.Tensor, coverage: torch.Tensor,
                    bias: torch.Tensor, window: float):
    """(out, new mask) of the weighted convolution's result ``raw`` (B,
    C_out, H', W') and its ``coverage`` (one channel, or ``raw``'s
    channels); ``bias`` (C_out,) in ``raw``'s type."""
    # a tensor-by-tensor quotient: a scalar numerator would go through a
    # reciprocal and miss the reference's ratio by an ulp
    ratio = true_div(window, coverage + 1e-8)
    new_mask = torch.clamp(coverage, 0.0, 1.0)
    ratio = ratio * new_mask
    out = (raw * ratio + bias.view(1, -1, 1, 1)) * new_mask
    return out, new_mask


def _layout(raw: torch.Tensor) -> Optional[bool]:
    """True for a channels-last (NHWC) ``raw``, False for a contiguous
    NCHW one, None for any other layout."""
    if raw.is_contiguous():
        return False
    if raw.is_contiguous(memory_format=torch.channels_last):
        return True
    return None


def tile_pixels(c_out: int) -> int:
    """The pixels a block takes: about ``TILE_ELEMS`` values, a multiple
    of 4, at most ``THREADS`` (one thread a pixel computes the ratio)."""
    return max(4, min(THREADS, TILE_ELEMS // c_out // 4 * 4))


def mask_side_cuda(raw: torch.Tensor, mask: Optional[torch.Tensor],
                   bias: torch.Tensor, in_channels: int,
                   in_hw: Tuple[int, int], kernel: int, stride: int,
                   padding: int):
    """Kernel ``pconv`` on one partial conv: ``raw`` (B, C_out, H', W')
    bf16 or f32, contiguous NCHW or channels-last; ``mask`` (B, 1, H, W)
    contiguous f32, or None for all ones; ``bias`` (C_out,) contiguous in
    ``raw``'s type; ``in_hw`` = (H, W), the convolution's input size.
    Returns (out f32 in ``raw``'s layout, new mask (B, 1, H', W') f32)."""
    if not raw.is_cuda or raw.dim() != 4 \
            or raw.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError("raw must be a 4-d bf16 or f32 CUDA tensor")
    nhwc = _layout(raw)
    if nhwc is None:
        raise ValueError("raw must be contiguous, NCHW or channels-last")
    b, c_out, ho, wo = raw.shape
    h, w = (int(v) for v in in_hw)
    if min(in_channels, kernel, stride) < 1 or padding < 0:
        raise ValueError("in_channels, kernel and stride must be >= 1, "
                         "padding >= 0")
    if (out_size(h, kernel, stride, padding),
            out_size(w, kernel, stride, padding)) != (ho, wo):
        raise ValueError(f"raw is {ho}x{wo}, not the convolution's output "
                         f"of {h}x{w} (k {kernel}, stride {stride}, "
                         f"padding {padding})")
    if mask is not None and (
            not mask.is_cuda or mask.dtype != torch.float32
            or tuple(mask.shape) != (b, 1, h, w) or not mask.is_contiguous()
            or mask.device != raw.device):
        raise ValueError(f"mask must be a contiguous ({b}, 1, {h}, {w}) f32 "
                         "tensor on raw's device, or None")
    if bias.dtype != raw.dtype or tuple(bias.shape) != (c_out,) \
            or not bias.is_contiguous() or bias.device != raw.device:
        raise ValueError(f"bias must be a contiguous ({c_out},) {raw.dtype} "
                         "tensor on raw's device")
    if raw.numel() >= 2**31 or b >= 65536:
        raise ValueError("raw is too large for one launch")
    out = torch.empty_like(raw, dtype=torch.float32)
    new_mask = torch.empty((b, 1, ho, wo), dtype=torch.float32,
                           device=raw.device)
    if raw.numel() == 0:
        return out, new_mask
    tile = tile_pixels(c_out)
    # four values a thread where they lie in one aligned vector
    vec = 4 if ((c_out % 4 == 0) if nhwc else ((ho * wo) % 4 == 0)) \
        and raw.data_ptr() % (4 * raw.element_size()) == 0 else 1
    lib = _build.lib("pconv")
    LAUNCHES["pconv"] += 1
    _build.check(lib.kbe_pconv(
        raw.data_ptr(), int(raw.dtype == torch.bfloat16), int(nhwc),
        0 if mask is None else mask.data_ptr(), bias.data_ptr(), b, c_out,
        h, w, ho, wo, in_channels, kernel, stride, padding, tile, vec,
        out.data_ptr(), new_mask.data_ptr(),
        torch.cuda.current_stream(raw.device).cuda_stream), "pconv")
    return out, new_mask
