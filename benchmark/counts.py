"""The yardstick: the card's peaks and the work that the stages and the
nets must do, computed from their inputs and outputs at the cell's shapes,
never from what a kernel does. The byte arithmetic follows
``chip_smoke.py``'s bounds: each byte in and out once, at the HBM rate.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference import effect as E
from benchmark.reference import nets as N
from benchmark.reference.ops import resized_shape

# NVIDIA H100 SXM, data sheet, dense: HBM3 bytes/s, f32 outside the tensor
# cores (the depth nets run with TF32 off), bf16 on the tensor cores
PEAKS = {"hbm_bytes_per_s": 3.35e12, "float32": 67e12, "bfloat16": 989e12}

POSE_BYTES = 5 * 4


def splat_bytes(valid_points: int, height: int, width: int,
                channels: int = 4) -> int:
    """One frame's splat: each valid point's xyz (12 B) and payload
    (4 B a channel) read once, the pose read once, the render (4 B a
    channel) and weight (4 B) planes written once."""
    return (valid_points * (12 + 4 * channels) + POSE_BYTES
            + height * width * (channels + 1) * 4)


def fill_bytes(region: Tuple[int, int, int, int], channels: int = 4) -> int:
    """One frame's fill over the region the crop reads, (y0, y1, x0, x1):
    the render (4 B a channel) and the weight (4 B) read once, the filled
    frame (4 B a channel) written once."""
    y0, y1, x0, x1 = region
    return (y1 - y0) * (x1 - x0) * (4 * channels + 4 + 4 * channels)


def least_seconds(nbytes: float) -> float:
    return nbytes / PEAKS["hbm_bytes_per_s"]


def net_flops(height: int, width: int, config: dict) -> Dict[str, float]:
    """{precision: FLOPs} of one video's net calls at (H, W): the depth
    nets once, ContextNet and Inpaint once a bootstrap step. Counted with
    ``FlopCounterMode`` over the reference's nets on the meta device."""
    precision = config["precision"]
    nets = {name: net.to(E.DTYPES[precision[kind]])
            for (name, _, kind), net in zip(
                N.NETS, N.build_nets("meta").values())}
    f = dict(dtype=torch.float32, device="meta")
    image = torch.zeros(1, height, width, 3, **f)
    resized = torch.zeros(1, *resized_shape(
        height, width, max(height, width) // 2), 3, **f)
    effect = config["effect"]
    steps = 2 if effect["inpaint"] and not effect["dolly"] else 0
    out = {}

    def count(kind, fn):
        with FlopCounterMode(display=False) as fc:
            result = fn()
        key = precision[kind]
        out[key] = out.get(key, 0.0) + float(fc.get_total_flops())
        return result

    with torch.no_grad():
        disp = count("depth", lambda: nets["disparity"](
            resized, nets["semantics"](resized)))
        count("depth", lambda: nets["refine"](image, disp))
        for _ in range(steps):
            count("inpaint", lambda: nets["context"](
                image, torch.zeros(1, height, width, 1, **f)))
            count("inpaint", lambda: nets["inpaint"](
                torch.zeros(1, height, width, 68, **f),
                torch.zeros(1, height, width, 1, **f)))
    return out


def video_least_seconds(flops: Dict[str, float]) -> float:
    """The least time of a video's nets: each precision's FLOPs at its
    peak."""
    return sum(n / PEAKS[kind] for kind, n in flops.items())
