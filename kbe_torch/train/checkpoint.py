"""Checkpoints as torch ``.tar`` files. The counterpart of
``kbe_tpu/train/checkpoint.py``, which writes orbax directories.

A trainer's state (``InpaintState``, ``DiscState``, or a tuple of them)
has ``state_dict()`` and ``load_state_dict()``; ``save_checkpoint`` writes
``{"state": [...], "step": n}`` to ``<directory>/<name>-<step>.tar``, and
``load_checkpoint`` reads it back into a template state made by the
trainer (modules, optimizer moments and step count), which
``--continue-training`` resumes from.

``load_pretrained_params`` warm-starts a trainer from a reference torch
``.tar`` through ``kbe_torch.utils.reference_convert``; an orbax
directory (a JAX checkpoint) raises, since reading one needs JAX.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Optional, Tuple

import torch


def _states(state) -> Tuple:
    return tuple(state) if isinstance(state, (tuple, list)) else (state,)


def save_checkpoint(directory: str, name: str, state: Any,
                    step: int) -> str:
    """Write ``state`` to ``<directory>/<name>-<step>.tar``; returns the
    path."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.abspath(os.path.join(directory, f"{name}-{step}.tar"))
    tmp = path + ".tmp"
    torch.save({"state": [s.state_dict() for s in _states(state)],
                "step": int(step)}, tmp)
    os.replace(tmp, path)
    return path


def latest_checkpoint(directory: str, name: str) -> Optional[str]:
    """The ``<name>-<step>.tar`` of the highest step, or None."""
    if not os.path.isdir(directory):
        return None
    pattern = re.compile(re.escape(name) + r"-(\d+)\.tar$")
    best, best_step = None, -1
    for entry in os.listdir(directory):
        m = pattern.match(entry)
        if m and int(m.group(1)) > best_step:
            best, best_step = entry, int(m.group(1))
    return os.path.join(directory, best) if best else None


def load_checkpoint(path: str, template: Any = None):
    """(state, step). With ``template`` (a state or tuple of states, as
    saved) the saved values are loaded into it, which raises if a module's
    entries or an optimizer's shapes differ; without, the raw list of state
    dicts is returned."""
    saved = torch.load(path, map_location="cpu", weights_only=True)
    if template is None:
        return saved["state"], saved["step"]
    states = _states(template)
    if len(states) != len(saved["state"]):
        raise ValueError(f"{path} holds {len(saved['state'])} states, the "
                         f"template {len(states)}")
    for s, d in zip(states, saved["state"]):
        s.load_state_dict(d)
    return template, saved["step"]


def load_optimizer_state(into: Dict, saved: Dict) -> None:
    """Copy a saved optimizer state into ``into`` (same lengths and shapes),
    on ``into``'s devices."""
    if (len(into["mu"]) != len(saved["mu"])
            or len(into["nu"]) != len(saved["nu"])):
        raise ValueError("optimizer state of another parameter list")
    for key in ("mu", "nu"):
        for dst, src in zip(into[key], saved[key]):
            if dst.shape != src.shape:
                raise ValueError(f"optimizer {key}: shape {tuple(src.shape)}"
                                 f", want {tuple(dst.shape)}")
            dst.copy_(src)
    into["count"] = int(saved["count"])


def load_pretrained_params(path: str, kind: str) -> Dict:
    """Flax-shaped params to warm-start a trainer from: a reference torch
    ``.tar`` converted by ``kbe_torch.utils.reference_convert``.
    ``kind``: 'disparity' | 'refine' | 'inpaint' (then {'context': ...,
    'net': ...}). Map them to the port's modules with
    ``kbe_torch.utils.convert.load_flax``."""
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path} is an orbax checkpoint directory: reading one needs "
            "JAX, which the port does not import (ROADMAP.md Queue 1 item "
            "1 plans torch bench weights instead); pass a reference .tar")
    from kbe_torch.utils import reference_convert as rc

    if kind == "disparity":
        return rc.convert_disparity(path)
    if kind == "refine":
        return rc.convert_refine(path)
    if kind == "inpaint":
        ctx, net = rc.convert_inpaint(path)
        return {"context": ctx, "net": net}
    raise ValueError(f"unknown kind {kind!r}")
