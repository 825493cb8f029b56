"""kbe_torch — the 3D Ken Burns effect in PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper (sm_90a).

A port of ``kbe_tpu`` (JAX/Pallas on a TPU), which stays the reference. The
module layout mirrors ``kbe_tpu`` so each counterpart is easy to find:

  ops/       geometry, filters, resize, splat renderer, disocclusion fill;
             ``ops/csrc/*.cu`` hold the CUDA kernels, ``ops/_build.py``
             builds them with nvcc at first use and binds them with ctypes
  models/    the PyTorch nets (Semantics, Disparity, Refine, ContextNet,
             Inpaint), named as the Flax param trees are
  pipeline/  the inpainting flow and the 75-pose effect
  utils/     the Flax param tree -> state dict converter

Public functions keep the JAX package's layouts (NHWC images, (G, H, W, 3)
clouds). Entry points run on ``cuda`` unless the caller asks for the CPU.
"""

__version__ = "0.1.0"

from kbe_torch.config import CameraConfig, EffectConfig, ZoomSettings, ZoomWindow
from kbe_torch.device import resolve_device

__all__ = [
    "CameraConfig",
    "EffectConfig",
    "ZoomSettings",
    "ZoomWindow",
    "resolve_device",
]
