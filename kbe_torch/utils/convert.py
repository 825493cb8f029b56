"""Flax param tree -> ``kbe_torch`` state dict.

The inverse direction of ``kbe_tpu/utils/torch_convert.py``, for the port's
own module names, which mirror the Flax tree: a module path
``lattice/blk0x1/conv1`` becomes ``lattice.blk0x1.conv1``. Leaves:

  ``kernel`` (kh, kw, in, out)  -> ``weight`` (out, in, kh, kw)
  ``bias``                      -> ``bias``
  ``slope`` (PReLU)             -> ``weight``

A leaf may sit beside submodules: ``PartialConv`` keeps its ``bias`` next to
its bias-free ``conv`` (``conv1/conv/kernel``, ``conv1/bias``), and
``RefinePretrained``'s blocks carry a ``shortcut`` conv; both map by the
same rules, because the port's modules name their attributes as the Flax
tree does.

The discriminators add BatchNorm and spectral-norm state:

  ``scale`` (BatchNorm, in ``params``)     -> ``scale``
  ``mean``, ``var`` (in ``batch_stats``)   -> ``mean``, ``var``
  ``SpectralNorm_<k>/<layer>/kernel/u``, ``.../sigma`` (in ``batch_stats``)
                                           -> ``<layer>.u``, ``<layer>.sigma``

The tree is nested dicts of numpy arrays (``jax.device_get`` of a Flax
``params`` collection, or an orbax restore). A top-level ``{"params": ...}``
wrapper is unwrapped; a ``{"params": ..., "batch_stats": ...}`` tree maps
both collections. Any other leaf raises.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch


_SPECTRAL = re.compile(r"SpectralNorm_\d+$")


def _tensor(arr) -> torch.Tensor:
    return torch.from_numpy(np.array(arr, dtype=np.float32))


def _params(tree: Mapping, out: Dict[str, torch.Tensor]) -> None:
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
            elif key in ("bias", "scale"):
                name = key
            else:
                raise ValueError(f"unknown Flax leaf {prefix}{key}")
            out[prefix + name] = _tensor(arr)

    walk(tree, "")


def _batch_stats(tree: Mapping, out: Dict[str, torch.Tensor]) -> None:
    def walk(node: Mapping, prefix: str) -> None:
        for key, val in node.items():
            if isinstance(val, Mapping) and _SPECTRAL.match(key):
                for leaf, arr in val.items():
                    parts = leaf.split("/")
                    if (len(parts) != 3 or parts[1] != "kernel"
                            or parts[2] not in ("u", "sigma")):
                        raise ValueError(f"unknown spectral-norm leaf "
                                         f"{prefix}{key}/{leaf}")
                    out[f"{prefix}{parts[0]}.{parts[2]}"] = _tensor(arr)
            elif isinstance(val, Mapping):
                walk(val, f"{prefix}{key}.")
            elif key in ("mean", "var"):
                out[prefix + key] = _tensor(val)
            else:
                raise ValueError(f"unknown Flax batch_stats leaf "
                                 f"{prefix}{key}")

    walk(tree, "")


def state_dict_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    if set(tree.keys()) == {"params"}:
        tree = tree["params"]
    elif set(tree.keys()) == {"params", "batch_stats"}:
        _batch_stats(tree["batch_stats"], out)
        tree = tree["params"]
    _params(tree, out)
    return out


def load_flax(module: torch.nn.Module, tree: Mapping) -> torch.nn.Module:
    """Load a Flax param tree into its ``kbe_torch`` counterpart, strictly:
    a missing or unexpected entry raises."""
    module.load_state_dict(state_dict_from_flax(tree))
    return module
