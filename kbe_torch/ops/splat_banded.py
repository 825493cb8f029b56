"""Grid-cloud splat, banded entry points.

Port of ``kbe_tpu/ops/splat_banded.py::render_grids_banded`` and
``render_grids_fast_banded``. The TPU package has two kernels behind them:
``_build_banded_kernel`` for payloads of up to 8 channels and
``_build_banded_wide_kernel``, which streams wider payloads in groups of 8.
Both compute the z-buffered splat of ``kbe_torch.ops.splat``; here one code
path serves every width, through the kernels of ``csrc/splat.cu`` on CUDA
tensors.

Not carried over: ``capacity_factor`` and ``work_limit``, which bounded the
TPU kernel's routing table and its per-chunk work. ``overflow`` is always
false, because these kernels drop no point.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from kbe_torch.ops.splat import check_fallback, no_overflow, render_grids


def render_grids_banded(xyz: torch.Tensor, data: torch.Tensor, height: int,
                        width: int, focal, baseline,
                        valid: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Same surface as ``splat_routed.render_grids_routed``: (rendered
    (1, H, W, C), existing (1, H, W, 1), overflow)."""
    rendered, existing = render_grids(xyz, data, height, width, focal,
                                      baseline, valid)
    return rendered, existing, no_overflow(xyz)


def render_grids_fast_banded(xyz: torch.Tensor, data: torch.Tensor,
                             height: int, width: int, focal, baseline,
                             valid: Optional[torch.Tensor] = None,
                             fallback: str = "clip"
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Same surface as ``splat_routed.render_grids_fast``."""
    check_fallback(fallback)
    return render_grids(xyz, data, height, width, focal, baseline, valid)
