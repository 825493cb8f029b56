"""Entry points of the TPU package's superseded splat generations.

``kbe_tpu/ops/legacy`` keeps two earlier Pallas renderers that
``EffectConfig.splat_method='pallas'`` and ``'delta'`` still select. Both
compute the z-buffered splat of ``kbe_torch.ops.splat``, so their
counterparts here are thin: they exist so that those names select an entry
point, and they run the same CUDA kernels as every other renderer.
"""

from kbe_torch.ops.legacy.splat_delta import render_grids_delta, \
    render_grids_fast_delta
from kbe_torch.ops.legacy.splat_pallas import render_grids_pallas

__all__ = ["render_grids_delta", "render_grids_fast_delta",
           "render_grids_pallas"]
