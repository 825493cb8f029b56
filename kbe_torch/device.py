"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``. Asking for CUDA where there is no GPU raises:
    the entry points never fall back to the CPU on their own; pass
    ``device="cpu"`` to run the plain PyTorch versions of the kernels."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "kbe_torch runs on CUDA by default and no GPU is available; "
            "pass device='cpu' to run the plain PyTorch path")
    return dev


def disable_tf32() -> None:
    """Turn off TF32 for cuDNN convolutions and cuBLAS matmuls.

    cuDNN runs f32 convolutions in TF32 by default; the depth nets move every
    splat, so they must run true f32 (bf16 depth cut mean SSIM from 0.9961
    to 0.9860 in the JAX package's own measurement)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
