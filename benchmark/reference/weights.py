"""Seeded weights of the effect's nets, made on the device.

The scheme is a frozen copy of the port's ``models/layers.py::init_params``,
with which ``KenBurnsPipeline.create`` draws its random nets: every conv
kernel N(0, 1 / fan_in), biases 0, PReLU slopes 0.25. The kernels of all
the configuration's nets (``nets.nets_for``) come from one ``torch.randn``
of a generator on ``device`` seeded with ``seed``, in the order of the nets
and of their parameters, so a seed gives the same weights on a device every
time. The five default nets draw exactly what they drew before a
configuration could name its nets.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from benchmark.reference.nets import build_nets


def make_weights(seed: int, device, models: Dict[str, bool]
                 ) -> Dict[str, Dict[str, torch.Tensor]]:
    """{net: state dict} of f32 tensors on ``device``, for the nets that
    ``models`` (``nets.model_flags``) builds."""
    nets = build_nets("meta", models)
    params = [(name, key, p) for name, net in nets.items()
              for key, p in net.named_parameters()]
    convs = [(name, key, p) for name, key, p in params if p.ndim == 4]
    sizes = [p.numel() for _, _, p in convs]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 64))
    draw = torch.randn(sum(sizes), generator=gen, device=device)
    scale = torch.repeat_interleave(
        torch.tensor([1.0 / math.sqrt(p[0].numel()) for _, _, p in convs],
                     device=device),
        torch.tensor(sizes, device=device))
    kernels = iter((draw * scale).split(sizes))
    out = {name: {} for name in nets}
    for name, key, p in params:
        if p.ndim == 4:
            out[name][key] = next(kernels).view(p.shape)
        elif key.endswith("bias"):
            out[name][key] = torch.zeros(p.shape, device=device)
        else:  # a PReLU's slopes
            out[name][key] = torch.full(p.shape, 0.25, device=device)
    return out
