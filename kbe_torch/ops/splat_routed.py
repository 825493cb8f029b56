"""Grid-cloud splat, routed entry points.

Port of ``kbe_tpu/ops/splat_routed.py::render_grids_routed`` and
``render_grids_fast``, whose TPU kernel (``_build_kernel``) routes chunks of
the cloud to output tiles through a CSR table and gathers with one-hot
matrix products. That routing is the TPU's schedule; the function is the
z-buffered splat of ``kbe_torch.ops.splat``, which on CUDA tensors runs the
kernels ``splat_zee``, ``splat_degrid``, ``splat_place`` and ``splat_sum``
of ``csrc/splat.cu`` at any payload width.

Not carried over: ``capacity_factor`` and the limit of 72 payload channels,
which sized the CSR table and the VMEM tiles. ``overflow`` is always false,
because these kernels drop no point.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from kbe_torch.ops.splat import check_fallback, no_overflow, render_grids


def render_grids_routed(xyz: torch.Tensor, data: torch.Tensor, height: int,
                        width: int, focal, baseline,
                        valid: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``xyz`` (G, H, W, 3) stacked pixel-grid clouds, ``data`` (G, H, W, C),
    ``valid`` (G, H, W) or None -> (rendered (1, H, W, C), existing
    (1, H, W, 1), overflow)."""
    rendered, existing = render_grids(xyz, data, height, width, focal,
                                      baseline, valid)
    return rendered, existing, no_overflow(xyz)


def render_grids_fast(xyz: torch.Tensor, data: torch.Tensor, height: int,
                      width: int, focal, baseline,
                      valid: Optional[torch.Tensor] = None,
                      fallback: str = "clip"
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The surface of ``render_pointcloud`` for grid clouds: (rendered,
    existing). ``fallback`` is ``'clip'`` or ``'scatter'``; see
    ``kbe_torch.ops.splat.check_fallback``."""
    check_fallback(fallback)
    return render_grids(xyz, data, height, width, focal, baseline, valid)
