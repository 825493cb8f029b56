"""Grid-cloud splat, the displacement-decomposed entry points.

Port of ``kbe_tpu/ops/legacy/splat_delta.py::render_grids_delta`` and
``render_grids_fast_delta`` (TPU kernel ``_build_delta_kernel``), which
split each point's displacement into a per-chunk base and a residual to
shrink the TPU kernel's candidate windows. The function is the z-buffered
splat of ``kbe_torch.ops.splat``; ``capacity_factor`` and the limit of 8
payload channels were schedule and are not carried over.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from kbe_torch.ops.splat import check_fallback, no_overflow, render_grids


def render_grids_delta(xyz: torch.Tensor, data: torch.Tensor, height: int,
                       width: int, focal, baseline,
                       valid: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Same surface as ``splat_routed.render_grids_routed``: (rendered
    (1, H, W, C), existing (1, H, W, 1), overflow)."""
    rendered, existing = render_grids(xyz, data, height, width, focal,
                                      baseline, valid)
    return rendered, existing, no_overflow(xyz)


def render_grids_fast_delta(xyz: torch.Tensor, data: torch.Tensor,
                            height: int, width: int, focal, baseline,
                            valid: Optional[torch.Tensor] = None,
                            fallback: str = "clip"
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Same surface as ``splat_routed.render_grids_fast``."""
    check_fallback(fallback)
    return render_grids(xyz, data, height, width, focal, baseline, valid)
