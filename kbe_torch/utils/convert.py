"""Flax param tree -> ``kbe_torch`` state dict.

The inverse direction of ``kbe_tpu/utils/torch_convert.py``, for the port's
own module names, which mirror the Flax tree: a module path
``lattice/blk0x1/conv1`` becomes ``lattice.blk0x1.conv1``. Leaves:

  ``kernel`` (kh, kw, in, out)  -> ``weight`` (out, in, kh, kw)
  ``bias``                      -> ``bias``
  ``slope`` (PReLU)             -> ``weight``

The tree is nested dicts of numpy arrays (``jax.device_get`` of a Flax
``params`` collection, or an orbax restore); a top-level ``{"params": ...}``
wrapper is unwrapped.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def state_dict_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    if set(tree.keys()) == {"params"}:
        tree = tree["params"]
    out: Dict[str, torch.Tensor] = {}

    def walk(node: Mapping, prefix: str) -> None:
        for key, val in node.items():
            if isinstance(val, Mapping):
                walk(val, f"{prefix}{key}.")
                continue
            arr = np.asarray(val, dtype=np.float32)
            if key == "kernel":
                if arr.ndim != 4:
                    raise ValueError(f"{prefix}kernel: expected HWIO, got "
                                     f"shape {arr.shape}")
                name, arr = "weight", arr.transpose(3, 2, 0, 1)
            elif key == "slope":
                name = "weight"
            elif key == "bias":
                name = "bias"
            else:
                raise ValueError(f"unknown Flax leaf {prefix}{key}")
            out[prefix + name] = torch.from_numpy(
                np.ascontiguousarray(arr))

    walk(tree, "")
    return out
