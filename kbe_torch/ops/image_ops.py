"""Image metrics. Port of the SSIM of ``kbe_tpu/ops/image_ops.py``
(Gaussian window, reflect padding, the standard Wang et al. form)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def gaussian_kernel1d(size: int, sigma: float,
                      device=None) -> torch.Tensor:
    half = (size - 1) / 2.0
    xs = torch.arange(size, dtype=torch.float32, device=device) - half
    k = torch.exp(-0.5 * (xs / sigma) ** 2)
    return k / torch.sum(k)


def gaussian_blur(x: torch.Tensor, size: int, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur of NHWC ``x``, reflect padding."""
    c = x.shape[-1]
    k = gaussian_kernel1d(size, sigma, x.device).to(x.dtype)
    h = x.permute(0, 3, 1, 2)
    p = size // 2
    h = F.conv2d(F.pad(h, (0, 0, p, p), mode="reflect"),
                 k.view(1, 1, size, 1).expand(c, 1, size, 1), groups=c)
    h = F.conv2d(F.pad(h, (p, p, 0, 0), mode="reflect"),
                 k.view(1, 1, 1, size).expand(c, 1, 1, size), groups=c)
    return h.permute(0, 2, 3, 1)


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
         max_val: float = 1.0, sigma: float = 1.5) -> torch.Tensor:
    """Mean SSIM of two NHWC images."""
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2

    def blur(t):
        return gaussian_blur(t, window_size, sigma)

    mu1, mu2 = blur(img1), blur(img2)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = blur(img1 * img1) - mu1_sq
    s2 = blur(img2 * img2) - mu2_sq
    s12 = blur(img1 * img2) - mu12
    m = ((2 * mu12 + c1) * (2 * s12 + c2)) / ((mu1_sq + mu2_sq + c1)
                                              * (s1 + s2 + c2))
    return torch.mean(m)
