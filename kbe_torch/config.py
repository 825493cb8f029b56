"""Configuration dataclasses.

The reference hard-codes its camera model and effect constants across several
files (focal/baseline 512/120 at utils/pipeline.py:26-27, 75 steps at
utils/pipeline.py:104, 25 fps at utils/pipeline.py:132, laplacian validity
threshold 0.03 at utils/common.py:28, default crop windows at kbe.py:128-140).
Here they are explicit, hashable config objects.

A field-for-field copy of ``kbe_tpu/config.py``: the port imports nothing of
the JAX package. The TPU schedule knobs of ``EffectConfig``
(``fill_march_phase1``, ``fill_phase0``, ``fill_phase0_gate``,
``splat_overflow_chunks``, ``splat_fallback``, ``max_pallas_margin``) do not
change the function the effect computes, and ``kbe_torch`` ignores them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """Pinhole camera model used for unprojection and splatting.

    Reference: utils/pipeline.py:26-27 (inference), train.py:21-33 (training
    datasets use focal/baseline 512/74, 512/120, 770/12).
    """

    focal: float = 512.0
    baseline: float = 120.0

    def with_focal(self, focal: float) -> "CameraConfig":
        return dataclasses.replace(self, focal=focal)


@dataclasses.dataclass(frozen=True)
class ZoomWindow:
    """A crop window: center (u, v) in pixels + crop size in pixels.

    Reference: the ``objectFrom``/``objectTo`` dicts built at kbe.py:152-164.
    """

    center_u: float
    center_v: float
    crop_width: int
    crop_height: int


@dataclasses.dataclass(frozen=True)
class ZoomSettings:
    """Start/end crop windows of the Ken Burns move (kbe.py:166-169)."""

    src: ZoomWindow
    dst: ZoomWindow

    @staticmethod
    def default_3d(width: int, height: int) -> "ZoomSettings":
        """Default 3D KBE move (kbe.py:128-133)."""
        return ZoomSettings(
            src=ZoomWindow(width / 2.15, height / 2.15,
                           int(math.floor(0.90 * width)),
                           int(math.floor(0.90 * height))),
            dst=ZoomWindow(width / 1.85, height / 1.85,
                           int(math.floor(0.85 * width)),
                           int(math.floor(0.85 * height))),
        )

    @staticmethod
    def default_dolly(width: int, height: int) -> "ZoomSettings":
        """Default dolly-zoom move (kbe.py:135-140)."""
        return ZoomSettings(
            src=ZoomWindow(width / 2, height / 2,
                           int(math.floor(0.8 * width)),
                           int(math.floor(0.8 * height))),
            dst=ZoomWindow(width / 2, height / 2,
                           int(math.floor(0.3 * width)),
                           int(math.floor(0.3 * height))),
        )

    def validate(self, width: int, height: int) -> None:
        """Window-in-bounds asserts (kbe.py:142-146)."""
        for name, w in (("src", self.src), ("dst", self.dst)):
            if not (height >= w.center_v + w.crop_height / 2
                    and w.center_v - w.crop_height / 2 >= 0):
                raise ValueError(f"{name} window too tall for its center")
            if not (width >= w.center_u + w.crop_width / 2
                    and w.center_u - w.crop_width / 2 >= 0):
                raise ValueError(f"{name} window too wide for its center")


@dataclasses.dataclass(frozen=True)
class EffectConfig:
    """Knobs of the Ken Burns effect rendering loop.

    Reference constants: 75 steps (utils/pipeline.py:104), 25 fps
    (utils/pipeline.py:132), inpaint shift overshoot 1.1
    (utils/common.py:218), laplacian validity threshold 0.03
    (utils/common.py:28,70), depth-range crop margin 128
    (utils/pipeline.py:96), disocclusion-fill march bound (ours: the
    reference marches unbounded, utils/common.py:876-894; XLA needs a
    static bound).
    """

    num_steps: int = 75
    fps: int = 25
    dolly: bool = False
    two_d: bool = False
    inpaint: bool = True
    inpaint_overshoot: float = 1.1
    validity_threshold: float = 0.03
    depth_range_margin: int = 128
    fill_march_steps: int = 128
    # Phase-1 march bound of the two-phase disocclusion fill: the fused
    # Pallas kernel marches this far and proves per-pixel stability; only
    # frames with provably-unresolved pixels (holes wider than ~this many
    # pixels) re-run the exact fill_march_steps march under a lax.cond.
    # 8 measured +1.0 fps over 16 at 1024^2 (r5); scenes with many
    # 9..16-px holes trip the phase-2 re-march more often — raise it back
    # for such content.
    fill_march_phase1: int = 8
    # Phase-0 radius of the thin-hole resolver (0 disables): hole pixels
    # whose best endpoint pair lies within this radius have a PROVABLY
    # global winner (any direction unresolved at radius r has pair
    # distance > r + 0.58) and resolve with ~32*r vectorized shifted
    # compares; only tiles with unresolved pixels enter the phase-1
    # march. Bit-identical output (ops/discfill.py::resolve_thin_holes).
    # It pays on noisy-depth scenes (thin scattered holes in every tile
    # saturate the gated march: 22 -> ~7 ms/frame) but on realistic
    # scenes the gated fill is already ~5 ms and the resolver's own
    # full-image epilogue costs ~22 ms at 1024^2 — hence the census gate
    # below decides per frame.
    fill_phase0: int = 2
    # Runtime census gate for phase 0 (0 = always run phase 0 when
    # fill_phase0 > 0): the resolver runs only on frames where the
    # fraction of hole-bearing fill tiles exceeds this — the saturated-
    # march regime it wins in. Realistic scenes take the passthrough
    # branch of the lax.cond at unchanged cost (measured: the gate costs
    # nothing vs phase 0 compiled out entirely at 1024^2/75).
    # Calibration (recheck when KBE_FILL_TILE_H/W change): a thin
    # disocclusion band flags many tiles with few hole pixels each — the
    # bench scene peaked near 0.23 tile fraction with 16x256 fill tiles
    # and sits higher with the round-5 64x256 tiles (coarser census),
    # while noisy-depth scenes sit near 1.0. A 0.25 gate misfired the
    # resolver on real endpoint frames (-7.8 ms/frame); 0.75 separates
    # the regimes with margin at the 64x256 geometry.
    fill_phase0_gate: float = 0.75
    # 'pallas' (two-phase fused kernel, the default) or 'xla' (pure-XLA
    # march — slower on TPU but compiles fast and runs on any backend;
    # used by CPU-oracle tests).
    fill_impl: str = "pallas"
    # Restrict the fill to the centered crop window the frames actually
    # sample (+2px bilinear margin). Final frames are bit-identical: the
    # crop discards everything outside, and in-ROI fill results are
    # unchanged because march sources (the validity/depth maps) are not
    # masked — only which pixels get *written*.
    fill_roi: bool = True
    # Frame-loop splat renderer: 'auto' == 'banded', the banded
    # static-residual Pallas kernel (ops/splat_banded.py) — works for
    # every trajectory and (with splat_fallback='scatter') falls back to
    # the exact scatter path per frame on capacity overflow. 'banded' |
    # 'routed' (CSR one-hot kernel) | 'scatter' force an implementation;
    # 'delta' | 'pallas' run the superseded generations in
    # ops/legacy/ (documented history, not live capability).
    splat_method: str = "auto"
    # Bounded per-chunk scatter capacity of the posed/banded frame-loop
    # renderer: chunks whose window work exceeds the kernel budget render
    # EXACTLY through the XLA scatter spec sharing the kernel's z-buffer,
    # up to this many chunks per frame (a lax.cond epilogue — free when
    # nothing overflows). The reference never drops a point
    # (utils/common.py:585-669); with this path neither do we, at a
    # bounded cost on adversarial scenes. 0 disables.
    splat_overflow_chunks: int = 256
    # Beyond-cap CSR-overflow behavior: 'clip' (graceful degradation,
    # fast compile) or 'scatter' (exact full-frame in-graph fallback,
    # adds the scatter renderer's multi-minute XLA compile to the program).
    splat_fallback: str = "clip"
    # Upper bound on per-point screen displacement accepted by the legacy
    # windowed Pallas renderer (splat_method='pallas' only).
    max_pallas_margin: int = 128
