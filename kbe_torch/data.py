"""The demo/bench input image. A numpy copy of the parts of
``kbe_tpu/train/data.py`` that ``demo_scene_image`` needs: the procedural
scene of ``synthetic_batches`` (planes + boxes), same generator, same draws,
so a seed gives the same image in both packages."""

from __future__ import annotations

import numpy as np


def demo_scene_image(height: int, width: int, seed: int = 0) -> np.ndarray:
    """Deterministic demo/bench input image (H, W, 3) f32 in [0, 1]: one
    item of ``synthetic_batches`` (a plane and 1-3 boxes), drawing what it
    draws in its order (the depths are drawn and dropped)."""
    rng = np.random.default_rng(seed)
    rng.uniform(30, 90)  # background depth
    img = rng.uniform(0, 1, 3).astype(np.float32) * np.ones(
        (height, width, 3), np.float32)
    for _ in range(rng.integers(1, 4)):
        bh = rng.integers(height // 6, height // 2)
        bw = rng.integers(width // 6, width // 2)
        y = rng.integers(0, height - bh)
        x = rng.integers(0, width - bw)
        rng.uniform(10, 40)  # box depth
        img[y:y + bh, x:x + bw] = rng.uniform(0, 1, 3)
    return (((img * 2.0 - 1.0) + 1.0) / 2.0).astype(np.float32)
