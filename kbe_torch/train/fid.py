"""Fréchet Inception Distance. Port of ``kbe_tpu/train/fid.py``.

Inception-v3 Mixed_7c activations (2048-d, ``InceptionV3Features`` on the
given device), their mean and covariance, and the Fréchet distance
between two such statistics. The distance is computed on the host in
float64 with numpy, as the reference computes it; the matrix square root
is ``scipy.linalg.sqrtm``, with a Newton-Schulz iteration in torch where
scipy is missing or fails.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch

from kbe_torch.device import disable_tf32, resolve_device
from kbe_torch.models.inception import InceptionV3Features
from kbe_torch.models.init import flax_default_init
from kbe_torch.ops.resize import resize_bilinear
from kbe_torch.utils.convert import load_flax

FID_SIZE = 299


def preprocess_images(images: np.ndarray, device: Any = None) -> np.ndarray:
    """(N, H, W, 3) float [0, 1] -> (N, 299, 299, 3) f32, resized on
    ``device`` with ``resize_bilinear`` (cv2's INTER_LINEAR sampling, as the
    reference resizes)."""
    x = torch.as_tensor(np.asarray(images, np.float32),
                        device=resolve_device(device))
    return resize_bilinear(x, FID_SIZE, FID_SIZE).cpu().numpy()


class FID:
    """Inception activations and the Fréchet distance.

    ``params``: a Flax-shaped ``InceptionV3Features`` tree (converted
    torchvision weights, ``reference_convert.convert_inception``), or None
    for fresh weights drawn as a Flax init from a ``torch.Generator``
    seeded with ``seed``. Those are not the JAX package's fresh weights,
    which come from ``jax.random.PRNGKey(0)`` and cannot be repeated here;
    either gives a valid, if less meaningful, embedding. ``device``
    defaults to ``cuda``, which raises where there is none."""

    def __init__(self, params: Optional[Mapping] = None, device: Any = None,
                 seed: int = 0):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            disable_tf32()
        module = InceptionV3Features()
        if params is None:
            flax_default_init(module, torch.Generator().manual_seed(seed))
        else:
            load_flax(module, params)
        self.module = module.to(self.device).eval().requires_grad_(False)

    @torch.no_grad()
    def activations(self, images: np.ndarray,
                    batch_size: int = 16) -> np.ndarray:
        """(N, H, W, 3) in [0, 1] -> (N, 2048) f32, ``batch_size`` images
        a forward; each batch is resized to 299^2 on the device."""
        images = np.asarray(images, np.float32)
        outs = []
        for i in range(0, images.shape[0], batch_size):
            x = torch.as_tensor(images[i:i + batch_size], device=self.device)
            x = resize_bilinear(x, FID_SIZE, FID_SIZE)
            outs.append(self.module(x).cpu().numpy())
        acts = np.concatenate(outs, axis=0)
        assert acts.shape == (images.shape[0], 2048)
        return acts

    @staticmethod
    def activation_statistics(acts: np.ndarray):
        mu = np.mean(acts, axis=0)
        sigma = np.cov(acts, rowvar=False)
        return mu, sigma

    @staticmethod
    def frechet_distance(mu1, sigma1, mu2, sigma2,
                         eps: float = 1e-6) -> float:
        """d^2 = |mu1 - mu2|^2 + Tr(C1 + C2 - 2 sqrt(C1 C2)); the product is
        offset by ``eps`` on the diagonal where its root is not finite."""
        mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
        sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
        diff = mu1 - mu2
        covmean = _sqrtm(sigma1 @ sigma2)
        if not np.isfinite(covmean).all():
            offset = np.eye(sigma1.shape[0]) * eps
            covmean = _sqrtm((sigma1 + offset) @ (sigma2 + offset))
        if np.iscomplexobj(covmean):
            covmean = covmean.real
        return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2)
                     - 2.0 * np.trace(covmean))

    def fid(self, real_images: np.ndarray, fake_images: np.ndarray,
            batch_size: int = 16) -> float:
        a1 = self.activations(real_images, batch_size)
        a2 = self.activations(fake_images, batch_size)
        mu1, s1 = self.activation_statistics(a1)
        mu2, s2 = self.activation_statistics(a2)
        return self.frechet_distance(mu1, s1, mu2, s2)


def _sqrtm(mat: np.ndarray) -> np.ndarray:
    try:
        from scipy import linalg

        out, _ = linalg.sqrtm(mat, disp=False)
        return out
    except Exception:
        return _newton_schulz_sqrtm(torch.as_tensor(mat)).numpy()


def _newton_schulz_sqrtm(a: torch.Tensor, iters: int = 40) -> torch.Tensor:
    """The principal square root of ``a`` by the coupled Newton-Schulz
    iteration on ``a / |a|_F`` (matrix products only)."""
    dim = a.shape[0]
    norm = torch.linalg.norm(a)
    y = a / norm
    z = torch.eye(dim, dtype=a.dtype, device=a.device)
    eye3 = 3.0 * torch.eye(dim, dtype=a.dtype, device=a.device)
    for _ in range(iters):
        t = 0.5 * (eye3 - z @ y)
        y, z = y @ t, t @ z
    return y * torch.sqrt(norm)
