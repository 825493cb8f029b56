"""The general traffic generator: reads a mix from ``traffic/<name>.json``
and makes the requests of a run from ``--seed``.

A mix gives ``shapes``, the (height, width) of the photographs it sends,
each sent equally often. Request ``i`` of the window has the shape at place
``i`` of a sequence of seeded shuffles of ``shapes``, one shuffle after
another, so every stretch of requests holds each shape as often as the
others, to one; its photograph is the synthetic scene of ``scene_image``
seeded with (seed, i), so that no two requests of a run send the same
photograph. The set-up's warm-up photographs, one a shape, are seeded with
indices from ``WARM_UP_INDEX`` on, which the window never reaches.

``scene_image`` is a frozen copy of the port's ``data.py::
demo_scene_image`` (one item of the JAX package's ``synthetic_batches``: a
plane and 1-3 boxes, the depths drawn and dropped), the same draws in the
same order; it colours each box once instead of the whole image, which
gives the same f32 values.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Iterator, List, NamedTuple, Tuple

import numpy as np

TRAFFIC_DIR = Path(__file__).resolve().parent / "traffic"
WARM_UP_INDEX = 1 << 62


class Request(NamedTuple):
    index: int
    height: int
    width: int
    image: np.ndarray


def scene_image(height: int, width: int, seed) -> np.ndarray:
    """A (H, W, 3) f32 image in [0, 1]: a plane and 1-3 boxes."""
    rng = np.random.default_rng(seed)

    def colour(c):
        return ((c.astype(np.float32) * 2.0 - 1.0) + 1.0) / 2.0

    rng.uniform(30, 90)  # background depth
    img = np.empty((height, width, 3), np.float32)
    img[...] = colour(rng.uniform(0, 1, 3))
    for _ in range(rng.integers(1, 4)):
        bh = rng.integers(height // 6, height // 2)
        bw = rng.integers(width // 6, width // 2)
        y = rng.integers(0, height - bh)
        x = rng.integers(0, width - bw)
        rng.uniform(10, 40)  # box depth
        img[y:y + bh, x:x + bw] = colour(rng.uniform(0, 1, 3))
    return img


def load(name: str) -> dict:
    """The mix ``traffic/<name>.json``, checked."""
    mix = json.loads((TRAFFIC_DIR / f"{name}.json").read_text())
    shapes = mix.get("shapes")
    if not shapes or any(len(s) != 2 or min(s) < 4 or s[0] % 4 or s[1] % 4
                         for s in shapes):
        raise ValueError(f"traffic {name}: shapes must be [height, width] "
                         "pairs, multiples of 4")
    if mix.get("loop") != "closed" or mix.get("clients") != 1:
        raise ValueError(f"traffic {name}: only a closed loop of 1 client "
                         "is generated")
    return mix


def _shapes(mix: dict, seed: int) -> Iterator[Tuple[int, int]]:
    rng = np.random.default_rng([seed % (1 << 64), 0x5A])
    shapes = [tuple(s) for s in mix["shapes"]]
    while True:
        for j in rng.permutation(len(shapes)):
            yield shapes[j]


def shape_sequence(mix: dict, seed: int, count: int) -> List[Tuple[int, int]]:
    """The (height, width) of requests 0..count-1."""
    shapes = _shapes(mix, seed)
    return [next(shapes) for _ in range(count)]


def stream(mix: dict, seed: int) -> Iterator[Request]:
    """The run's requests 0, 1, 2, ..., each photograph made when it is
    asked for."""
    seed = seed % (1 << 64)
    for i, (h, w) in enumerate(_shapes(mix, seed)):
        yield Request(i, h, w, scene_image(h, w, [seed, i]))


def warm_ups(mix: dict, seed: int) -> List[Request]:
    """One request for each shape of the mix, from indices the window
    never sends."""
    seed = seed % (1 << 64)
    shapes = list(dict.fromkeys(tuple(s) for s in mix["shapes"]))
    return [Request(WARM_UP_INDEX + j, h, w,
                    scene_image(h, w, [seed, WARM_UP_INDEX + j]))
            for j, (h, w) in enumerate(shapes)]
