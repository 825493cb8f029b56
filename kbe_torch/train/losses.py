"""Training losses. Port of ``kbe_tpu/train/losses.py``:

  compute_loss_ord         masked L1 / scale-invariant RMSE / log-RMSE
  compute_loss_grad        multi-scale (h = 1, 2, 4, 8) MSE on normalised
                           gradients
  compute_masked_grad_loss L1 pulling in-mask gradients toward kappa
  joint_edge_loss          image/disparity Sobel-edge agreement
  inpainting_loss          the partial-conv recipe: hole/valid L1, VGG16
                           perceptual, style (Gram), total variation
  inpainting_loss_adv      the adversarial variant: valid L1, TV,
                           extended-mask flatness, valid-depth L1
  LOSS_WEIGHTS             the inpainting trainer's weights
  depth_loss_schedule      the depth trainer's (ord, grad, mask) schedule

Tensors are NHWC, (B, H, W, 1) for disparities and masks. The losses that
divide by a batch-wide count, or are not linear in the batch's sums, take a
``mesh`` (``kbe_torch.parallel``): on a rank's local batch they then give
the global batch's loss. Means over the batch need none: the data-parallel
step averages them over the ranks. Without a mesh nothing changes.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from kbe_torch.ops.image_ops import (gaussian_blur, gram_matrix,
                                     rgb_to_grayscale, sobel_magnitude,
                                     total_variation)
from kbe_torch.parallel.dp import global_sum

LOSS_WEIGHTS: Dict[str, float] = {
    "hole": 6.0,
    "valid": 1.0,
    "prc": 0.05,
    "tv": 0.1,
    "style": 120.0,
    "grad": 10.0,
    "ord": 0.0001,
    "color": 0.0,
    "mask": 0.0001,
    "valid_depth": 1.0,
    "joint_edge": 1.0,
}


def depth_loss_schedule(iter_nb, beta: float = 0.015):
    """(gamma_ord, gamma_grad, gamma_mask) at training step ``iter_nb``,
    as f32 0-d tensors."""
    it = torch.as_tensor(iter_nb, dtype=torch.float32)
    decay = torch.exp(-beta * it)
    gamma_ord = 0.03 * (1.0 + 2.0 * decay)
    gamma_grad = 1.0 - decay
    gamma_mask = 0.0001 * (1.0 - decay)
    return gamma_ord, gamma_grad, gamma_mask


def _difference(x: torch.Tensor, h: int, vertical: bool,
                sign: float) -> torch.Tensor:
    """The (h+1)-tap stencil x[i + h] + sign * x[i] along one axis, 'VALID'
    (B, H, W, 1) -> (B, H - h, W, 1) or (B, H, W - h, 1)."""
    n = x.shape[1 if vertical else 2]
    far = x.narrow(1 if vertical else 2, h, n - h)
    near = x.narrow(1 if vertical else 2, 0, n - h)
    return sign * near + far


def _derivative_scale(x: torch.Tensor, h: int, norm: bool = True):
    """Finite differences at scale h, optionally normalised by the sum of
    the two magnitudes; the vertical one is zero-padded at the top, the
    horizontal one at the left (the reference's asymmetric pads)."""
    dv = _difference(x, h, True, -1.0)
    dh = _difference(x, h, False, -1.0)
    if norm:
        ax = torch.abs(x)
        dv = dv / (_difference(ax, h, True, 1.0) + 1e-7)
        dh = dh / (_difference(ax, h, False, 1.0) + 1e-7)
    dv = F.pad(dv, (0, 0, 0, 0, h, 0))
    dh = F.pad(dh, (0, 0, h, 0))
    return dv, dh


def _masked(loss, n):
    return torch.where(n > 0, loss, torch.zeros_like(loss))


def _sum(x, mesh):
    """``torch.sum(x)``; with a mesh, summed over its ranks too: the global
    batch's sum."""
    return global_sum(torch.sum(x), mesh)


def compute_loss_ord(disparity, target, mask, mode: str = "L1", mesh=None):
    """Masked ordinal loss; with ``mesh`` over the global batch."""
    n = _sum(mask, mesh)
    safe_n = torch.clamp(n, min=1.0)
    if mode == "L1":
        loss = _sum(torch.abs(disparity * mask - target * mask), mesh) / safe_n
    elif mode == "rmse":
        ri = (disparity - target) * mask
        loss = (_sum(ri ** 2, mesh) / safe_n
                - (_sum(ri, mesh) / safe_n) ** 2)
    elif mode == "logrmse":
        ri = (torch.log10(disparity * mask + 1e-7)
              - torch.log10(target * mask + 1e-7))
        loss = (_sum(ri ** 2, mesh) / safe_n
                - (0.5 * _sum(ri, mesh) / safe_n) ** 2)
    else:
        raise ValueError(f"unknown ord mode {mode!r}")
    return _masked(loss, n)


def compute_loss_grad(disparity, target, mask, mesh=None):
    """Multi-scale masked MSE on normalised gradients (h = 1, 2, 4, 8); with
    ``mesh`` over the global batch."""
    n = _sum(mask, mesh)
    safe_n = torch.clamp(n, min=1.0)
    loss = torch.zeros((), dtype=disparity.dtype, device=disparity.device)
    for h in (1, 2, 4, 8):
        dv, dh = _derivative_scale(disparity, h, norm=True)
        tv_, th_ = _derivative_scale(target, h, norm=True)
        loss = loss + _sum((dv * mask - tv_ * mask) ** 2, mesh) / safe_n
        loss = loss + _sum((dh * mask - th_ * mask) ** 2, mesh) / safe_n
    return _masked(loss, n)


def compute_masked_grad_loss(disparity, masks, scales=(1,), kappa=0.5,
                             mesh=None):
    """Pull in-mask gradients toward ``kappa`` (the flat-objects prior);
    with ``mesh`` over the global batch."""
    n = _sum(masks, mesh)
    safe_n = torch.clamp(n, min=1.0)
    loss = torch.zeros((), dtype=disparity.dtype, device=disparity.device)
    for h in scales:
        dv, dh = _derivative_scale(disparity, h, norm=False)
        loss = loss + _sum(torch.abs(dv * masks - kappa * masks),
                           mesh) / safe_n
        loss = loss + _sum(torch.abs(dh * masks - kappa * masks),
                           mesh) / safe_n
    return _masked(loss, n)


def joint_edge_loss(image, disparity, masks_extended, mesh=None):
    """Fraction of in-mask image edges with no matching disparity edge;
    with ``mesh`` over the global batch."""
    edge_img = (sobel_magnitude(rgb_to_grayscale(image)) > 0.1).float()
    edge_disp = (sobel_magnitude(disparity) > 0.3).float()
    return (_sum(edge_img * masks_extended * (1.0 - edge_disp), mesh)
            / torch.clamp(_sum(masks_extended, mesh), min=1.0))


@dataclasses.dataclass(frozen=True)
class InpaintingLossConfig:
    kbe_only: bool = False
    perceptual: bool = True


def inpainting_loss(vgg_features: Optional[Callable], inp, mask, output, gt,
                    config: InpaintingLossConfig = InpaintingLossConfig()
                    ) -> Dict[str, torch.Tensor]:
    """Supervised inpainting loss dict (hole/valid/prc/style/tv).

    ``vgg_features(x3ch) -> [f1, f2, f3]``, NHWC (``VGG16Features``), or
    None (no perceptual and style terms). A 1-channel ``output`` is tiled
    to 3 channels for the perceptual branch."""
    out_comp = mask * inp + (1.0 - mask) * output
    loss = {}

    def tile(x):
        return torch.cat([x] * 3, dim=-1) if x.shape[-1] == 1 else x

    perceptual = config.perceptual and vgg_features is not None
    if perceptual:
        f_comp = vgg_features(tile(out_comp))
        f_out = vgg_features(tile(output))
        f_gt = vgg_features(tile(gt))
        prc = 0.0
        for i in range(3):
            prc = prc + torch.mean(torch.abs(f_out[i] - f_gt[i]))
            prc = prc + torch.mean(torch.abs(f_comp[i] - f_gt[i]))
        loss["prc"] = prc

    if config.kbe_only:
        loss["color"] = torch.mean(torch.abs(output - gt))
    else:
        loss["hole"] = torch.mean(torch.abs((1.0 - mask) * (output - gt)))
        loss["valid"] = torch.mean(torch.abs(mask * (output - gt)))
        if perceptual:
            style = 0.0
            for i in range(3):
                g_gt = gram_matrix(f_gt[i])
                style = style + torch.mean(
                    torch.abs(gram_matrix(f_out[i]) - g_gt))
                style = style + torch.mean(
                    torch.abs(gram_matrix(f_comp[i]) - g_gt))
            loss["style"] = style
        loss["tv"] = total_variation(out_comp)
    return loss


def inpainting_loss_adv(inp, mask, output, disparity=None,
                        disparity_gt=None, mesh=None
                        ) -> Dict[str, torch.Tensor]:
    """Unsupervised (adversarial) pixel losses: valid L1, TV,
    extended-mask flatness minus blurred edges (over the global batch with
    ``mesh``), valid-depth L1."""
    out_comp = mask * inp + (1.0 - mask) * output
    loss = {
        "valid": torch.mean(torch.abs(mask * (output - inp))),
        "tv": total_variation(out_comp),
    }
    if disparity is not None:
        # The reference's test, blur(mask) < 1.0, holds in f32 where the
        # holes' share of the window exceeds half an ulp below 1 (2^-25).
        # Away from holes blur(mask) rounds to 1.0 or to 1 - 2^-24 by the
        # order of the convolution's sum (XLA's CPU one gives 1.0, the CPU's
        # torch.conv2d the other at some sizes), which flips the whole
        # interior; the complement blurs to exactly 0 there in any order.
        extended = (gaussian_blur(1.0 - mask, 13, 1.5) > 2.0 ** -25).float()
        edge = (sobel_magnitude(rgb_to_grayscale(output)) > 0.1).float()
        extended_edges = (gaussian_blur(edge, 7, 1.0) > 0.0).float()
        loss["mask"] = compute_masked_grad_loss(
            disparity, extended * (1.0 - extended_edges), (1,), 0.5, mesh)
        if disparity_gt is not None:
            loss["valid_depth"] = torch.mean(
                torch.abs(mask * (disparity - disparity_gt)))
    return loss


def weighted_total(loss: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Σ LOSS_WEIGHTS[k] * loss[k], in the dict's order."""
    return sum(LOSS_WEIGHTS[k] * v for k, v in loss.items())
