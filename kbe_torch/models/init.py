"""Weight initialisation. Port of ``kbe_tpu/models/init.py``, plus the
Flax defaults that the JAX trainers start from where no selector is
applied.

``apply_weights_init`` is the reference's conv re-initialisation selector:
every 4-D conv weight is redrawn (biases, PReLU slopes and norms are left
as they are): 'normal' N(0, gain^2), 'xavier' (the default, gain 1.4)
N(0, gain^2 * 2 / (fan_in + fan_out)), 'he' N(0, 2 / fan_in),
'orthogonal' (rows of the (out, in*kh*kw) matrix, times gain) or 'none'.
``flax_default_init`` sets what a Flax init gives: truncated lecun-normal
kernels, zero biases, PReLU slopes 0.25, BatchNorm scale 1, bias 0, mean 0,
var 1, a spectral norm's ``u`` from N(0, 1) and ``sigma`` 1.

Every draw comes from the ``torch.Generator`` passed in, on the CPU, in the
order of ``module.modules()``, so a seed gives the same weights on every
device. The numbers differ from ``jax.random``'s; the tests load converted
Flax trees instead.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from kbe_torch.models.discriminator import BatchNorm, SpectralConv2d

# the standard deviation of N(0, 1) truncated to (-2, 2)
_TRUNC_STD = 0.87962566103423978


def _draw(shape, init_type: str, gain: float,
          generator: torch.Generator) -> torch.Tensor:
    """One conv weight (out, in, kh, kw); torch's fan counts."""
    cout = shape[0]
    fan_in = math.prod(shape[1:])
    fan_out = cout * math.prod(shape[2:])
    if init_type == "normal":
        return gain * torch.randn(shape, generator=generator)
    if init_type == "xavier":
        std = gain * math.sqrt(2.0 / (fan_in + fan_out))
        return std * torch.randn(shape, generator=generator)
    if init_type == "he":
        return math.sqrt(2.0 / fan_in) * torch.randn(shape,
                                                     generator=generator)
    if init_type == "orthogonal":
        flat = torch.randn((cout, fan_in), generator=generator)
        tall = fan_in >= cout
        q, r = torch.linalg.qr(flat.T if tall else flat)
        q = q * torch.sign(torch.diagonal(r))[None, :]
        return gain * (q.T if tall else q).reshape(shape)
    raise ValueError(f"unknown init_type {init_type!r}")


def apply_weights_init(module: nn.Module, generator: torch.Generator,
                       init_type: str = "xavier",
                       gain: float = 1.4) -> nn.Module:
    """Redraw every conv weight of ``module`` in place; returns it."""
    if init_type in ("none", "None", None):
        return module
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Conv2d):
                w = _draw(tuple(m.weight.shape), init_type, gain, generator)
                m.weight.copy_(w)
    return module


def flax_default_init(module: nn.Module,
                      generator: torch.Generator) -> nn.Module:
    """Set ``module``'s parameters and buffers to a Flax init's
    distributions, in place; returns it."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Conv2d):
                std = math.sqrt(1.0 / m.weight[0].numel()) / _TRUNC_STD
                w = torch.empty(m.weight.shape)
                nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0,
                                      generator=generator)
                m.weight.copy_(w * std)
                if m.bias is not None:
                    m.bias.zero_()
            if isinstance(m, SpectralConv2d):
                m.u.copy_(torch.randn(m.u.shape, generator=generator))
                m.sigma.fill_(1.0)
            elif isinstance(m, BatchNorm):
                m.scale.fill_(1.0)
                m.bias.zero_()
                m.mean.zero_()
                m.var.fill_(1.0)
            elif isinstance(m, nn.PReLU):
                m.weight.fill_(0.25)
    return module
