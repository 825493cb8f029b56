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


def _coverage_flops(nets) -> list:
    """A tally, kept by forward hooks, of the FLOPs of the coverage
    convolutions that the partial convs of ``nets`` run: each an all-ones
    (out, in, k, k) convolution, 2 FLOPs a multiply-add, as
    ``FlopCounterMode`` counts it."""
    tally = [0.0]

    def hook(module, args, result):
        tally[0] += 2.0 * result[0].numel() * args[0].shape[1] \
            * module.kernel ** 2

    for net in nets:
        for m in net.modules():
            if isinstance(m, N.PartialConv):
                m.register_forward_hook(hook)
    return tally


def net_flops(height: int, width: int, config: dict) -> Dict[str, float]:
    """{precision: FLOPs} of one video's net calls at (H, W), for the nets
    that the configuration's ``models`` builds: the depth nets once
    (``refine`` with its shortcuts where residual), ContextNet and the
    inpainting net once a bootstrap step, and with ``inpaint_depth`` the
    second pair too. Counted with ``FlopCounterMode`` over the reference's
    nets on the meta device.

    A partial conv counts its weighted convolution and not its coverage
    convolution: the coverage computes a count of the mask, not the
    model's arithmetic. Were it counted, a kernel that counts the mask
    from one channel would do less work for the same model FLOPs, and the
    count would no longer stand for the work."""
    precision = config["precision"]
    models = N.model_flags(config)
    nets = {name: net.to(E.DTYPES[precision[kind]])
            for (name, _, kind), net in zip(
                N.nets_for(models), N.build_nets("meta", models).values())}
    f = dict(dtype=torch.float32, device="meta")
    image = torch.zeros(1, height, width, 3, **f)
    resized = torch.zeros(1, *resized_shape(
        height, width, max(height, width) // 2), 3, **f)
    effect = config["effect"]
    steps = 2 if effect["inpaint"] and not effect["dolly"] else 0
    pairs = [("context", "inpaint")]
    if models["inpaint_depth"]:
        pairs.append(("context_depth", "inpaint_depth"))
    coverage = _coverage_flops(nets.values())
    out = {}

    def count(kind, net, *args):
        before = coverage[0]
        with FlopCounterMode(display=False) as fc:
            result = nets[net](*args)
        key = precision[kind]
        out[key] = out.get(key, 0.0) + float(fc.get_total_flops()) - (
            coverage[0] - before)
        return result

    with torch.no_grad():
        disp = count("depth", "disparity", resized,
                     count("depth", "semantics", resized))
        count("depth", "refine", image, disp)
        for _ in range(steps):
            for context, inpaint in pairs:
                count("inpaint", context, image,
                      torch.zeros(1, height, width, 1, **f))
                count("inpaint", inpaint,
                      torch.zeros(1, height, width, 68, **f),
                      torch.zeros(1, height, width, 1, **f))
    return out


def video_least_seconds(flops: Dict[str, float]) -> float:
    """The least time of a video's nets: each precision's FLOPs at its
    peak."""
    return sum(n / PEAKS[kind] for kind, n in flops.items())
