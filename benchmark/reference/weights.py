"""Seeded weights of the effect's nets, made on the device.

The scheme is a frozen copy of the port's ``models/layers.py::init_params``,
with which ``KenBurnsPipeline.create`` draws its random nets: every conv
kernel N(0, 1 / fan_in), biases 0, PReLU slopes 0.25. The kernels of all
the nets come from one ``torch.randn`` of a generator on ``device`` seeded
with ``seed``, in the order of the nets and of their parameters, so a seed
gives the same weights on a device every time.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from benchmark.reference.nets import NETS, build_nets


def make_weights(seed: int, device) -> Dict[str, Dict[str, torch.Tensor]]:
    """{net: state dict} of f32 tensors on ``device``."""
    nets = build_nets("meta")
    params = [(name, key, p) for name, _, _ in NETS
              for key, p in nets[name].named_parameters()]
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
    out = {name: {} for name, _, _ in NETS}
    for name, key, p in params:
        if p.ndim == 4:
            out[name][key] = next(kernels).view(p.shape)
        elif key.endswith("bias"):
            out[name][key] = torch.zeros(p.shape, device=device)
        else:  # a PReLU's slopes
            out[name][key] = torch.full(p.shape, 0.25, device=device)
    return out
