"""Image-processing primitives of the losses and metrics. Port of
``kbe_tpu/ops/image_ops.py``: kornia's Sobel, Gaussian blur and grayscale
as the reference used them, total variation, the Gram matrix and SSIM
(Gaussian window, reflect padding, the standard Wang et al. form). Layout
NHWC, as in the JAX package."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _depthwise(x: torch.Tensor, kernel2d: torch.Tensor) -> torch.Tensor:
    """Depthwise 2D convolution of NHWC ``x`` with one (kh, kw) kernel for
    every channel, reflect-padded by half the kernel on each side."""
    kh, kw = kernel2d.shape
    c = x.shape[-1]
    h = F.pad(x.permute(0, 3, 1, 2), (kw // 2, kw // 2, kh // 2, kh // 2),
              mode="reflect")
    k = kernel2d.to(device=x.device, dtype=x.dtype)
    h = F.conv2d(h, k.view(1, 1, kh, kw).expand(c, 1, kh, kw), groups=c)
    return h.permute(0, 2, 3, 1)


def rgb_to_grayscale(image: torch.Tensor) -> torch.Tensor:
    """ITU-R 601 luma (kornia RgbToGrayscale weights), (..., 3) -> (..., 1)."""
    w = torch.tensor([0.299, 0.587, 0.114], dtype=image.dtype,
                     device=image.device)
    return torch.sum(image * w, dim=-1, keepdim=True)


_SOBEL_X = ((-1.0, 0.0, 1.0), (-2.0, 0.0, 2.0), (-1.0, 0.0, 1.0))


def sobel_magnitude(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Sobel gradient magnitude with kornia's normalised (/8) kernels."""
    kx = torch.tensor(_SOBEL_X) / 8.0
    gx = _depthwise(x, kx)
    gy = _depthwise(x, kx.T.contiguous())
    return torch.sqrt(gx * gx + gy * gy + eps)


def gaussian_kernel1d(size: int, sigma: float,
                      device=None) -> torch.Tensor:
    half = (size - 1) / 2.0
    xs = torch.arange(size, dtype=torch.float32, device=device) - half
    k = torch.exp(-0.5 * (xs / sigma) ** 2)
    return k / torch.sum(k)


def gaussian_blur(x: torch.Tensor, size: int, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur of NHWC ``x``, reflect padding (kornia
    GaussianBlur2d)."""
    k = gaussian_kernel1d(size, sigma, x.device)
    return _depthwise(_depthwise(x, k[:, None]), k[None, :])


def total_variation(image: torch.Tensor) -> torch.Tensor:
    """Mean absolute difference of horizontal plus vertical neighbours."""
    dh = torch.mean(torch.abs(image[:, :, :-1, :] - image[:, :, 1:, :]))
    dv = torch.mean(torch.abs(image[:, :-1, :, :] - image[:, 1:, :, :]))
    return dh + dv


def gram_matrix(features: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, C, C) Gram matrix normalised by C*H*W."""
    b, h, w, c = features.shape
    f = features.reshape(b, h * w, c)
    return torch.einsum("bnc,bnd->bcd", f, f) / (c * h * w)


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


def ssim_distance(img1: torch.Tensor, img2: torch.Tensor,
                  window_size: int = 11) -> torch.Tensor:
    """(1 - SSIM) / 2: the value kornia-0.3's SSIM loss reports, which the
    reference logs as its 'SSIM' metric."""
    return (1.0 - ssim(img1, img2, window_size)) / 2.0
