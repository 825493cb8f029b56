"""Grid-cloud splat, the windowed entry point.

Port of ``kbe_tpu/ops/legacy/splat_pallas.py::render_grids_pallas`` (TPU
kernels ``_build_zee`` and ``_build_acc``). The TPU renderer reads, for each
output tile, a window of the source grids widened by ``margin`` pixels, and
drops every point whose screen displacement exceeds it. The kernels of
``csrc/splat.cu`` drop no point: for clouds that stay inside the margin
both give the scatter spec's render, and beyond it this one stays exact.
The effect keeps the TPU package's refusal of trajectories beyond
``EffectConfig.max_pallas_margin`` so that the same configurations are
accepted and refused.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from kbe_torch.ops.splat import render_grids


def render_grids_pallas(xyz: torch.Tensor, data: torch.Tensor, height: int,
                        width: int, focal, baseline,
                        valid: Optional[torch.Tensor] = None,
                        margin: int = 72
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``xyz`` (G, H, W, 3), ``data`` (G, H, W, C), ``valid`` (G, H, W) or
    None -> (rendered (1, H, W, C), existing (1, H, W, 1)). ``margin`` is
    the caller's bound on per-point screen displacement in pixels; it must
    be a non-negative int and changes nothing here."""
    if isinstance(margin, bool) or not isinstance(margin, int) or margin < 0:
        raise ValueError(f"margin must be a non-negative int, got "
                         f"{margin!r}")
    return render_grids(xyz, data, height, width, focal, baseline, valid)
