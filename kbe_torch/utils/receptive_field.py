"""Receptive-field / feature-map summary of conv stacks. A copy of
``kbe_tpu/utils/receptive_field.py``: plain arithmetic, kept in the port so
that it imports nothing of the JAX package.

Equivalent of the reference's (misleadingly named) ``utils/fov.py`` — a
debugging aid that walks a network's conv/pool layers and reports, per
layer, the output feature count, pixel jump, receptive-field size and
center offset. The reference introspects torch modules
(fov.py:6-28); here layers are described declaratively, as ``kbe_tpu``
describes them, and the model zoo's conv stacks are provided as ready-made
specs.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterable, List, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One conv-like layer: kernel, stride, padding, dilation."""

    name: str
    kernel: int
    stride: int = 1
    padding: int = 0
    dilation: int = 1


@dataclasses.dataclass(frozen=True)
class LayerInfo:
    name: str
    n_features: int
    jump: int
    receptive: int
    start: float


def out_from_in(spec: LayerSpec, n_in: int, j_in: int, r_in: int,
                start_in: float):
    """Receptive-field propagation through one layer (fov.py:30-47)."""
    k, s, p, d = spec.kernel, spec.stride, spec.padding, spec.dilation
    n_out = math.floor((n_in + 2 * p - d * k) / s) + 1
    actual_p = (n_out - 1) * s - n_in + k
    p_left = math.floor(actual_p / 2)
    j_out = j_in * s
    r_out = r_in + d * (k - 1) * j_in
    start_out = start_in + ((k - 1) / 2 - p_left) * j_in
    return n_out, j_out, r_out, start_out


def net_summary(layers: Sequence[LayerSpec], imsize: int,
                verbose: bool = True) -> List[LayerInfo]:
    """Per-layer feature counts + receptive fields (fov.py:55-65)."""
    infos: List[LayerInfo] = []
    n, j, r, start = imsize, 1, 1, 0.5
    if verbose:
        print("-------Net summary------")
        print(f"input image:\n\t n features: {n}\n\t receptive size: {r}")
    for spec in layers:
        n, j, r, start = out_from_in(spec, n, j, r, start)
        infos.append(LayerInfo(spec.name, n, j, r, start))
        if verbose:
            print(f"{spec.name}:\n\t n features: {n}"
                  f"\n\t receptive size: {r}")
    return infos


def _basic(name: str, reps: int = 2) -> List[LayerSpec]:
    return [LayerSpec(f"{name}_conv{i}", 3, 1, 1) for i in range(reps)]


def _down(name: str) -> List[LayerSpec]:
    return [LayerSpec(f"{name}_conv0", 3, 2, 1),
            LayerSpec(f"{name}_conv1", 3, 1, 1)]


def disparity_layers() -> List[LayerSpec]:
    """Column-0 path of the Disparity grid-net (stem + 5 downsamples),
    the path that sets its receptive field."""
    layers = [LayerSpec("stem_image", 7, 2, 3)]
    for r in range(1, 6):
        layers += _down(f"down{r}x0")
    for c in (1, 2, 3):
        layers += _basic(f"row5_col{c}")
    return layers


def refine_layers() -> List[LayerSpec]:
    layers = _basic("image_one")
    layers += _down("image_two")
    layers += _down("image_thr")
    return layers


def semantics_layers() -> List[LayerSpec]:
    layers: List[LayerSpec] = []
    widths = (2, 2, 4, 4)
    for b, reps in enumerate(widths):
        layers += [LayerSpec(f"conv{b}_{i}", 3, 1, 1) for i in range(reps)]
        layers.append(LayerSpec(f"pool{b}", 2, 2, 0))
    return layers
