"""Checkpoints as torch ``.tar`` files. The counterpart of
``kbe_tpu/train/checkpoint.py``, which writes orbax directories.

A trainer's state (``InpaintState``, ``DiscState``, or a tuple of them)
has ``state_dict()`` and ``load_state_dict()``; ``save_checkpoint`` writes
``{"state": [...], "step": n}`` to ``<directory>/<name>-<step>.tar``, and
``load_checkpoint`` reads it back into a template state made by the
trainer (modules, optimizer moments and step count), which
``--continue-training`` resumes from.

``save_pipeline`` writes the nets of the effect (``PipelineModels``) as one
``{"pipeline": {net: state dict}, "step": n}`` file,
``<directory>/pipeline-<step>.tar``, in f32 whatever the compute types;
``load_pipeline_params`` restores it as ``PipelineModels`` placed as
``create_models`` places them, and ``find_bench_weights`` finds the one that
``tools/make_bench_weights_torch.py`` writes.

``load_pretrained_params`` warm-starts a trainer from the port's own
trainer checkpoints or from a reference torch ``.tar`` through
``kbe_torch.utils.reference_convert``, told apart by their contents.

Every loader keeps ``kbe_tpu``'s rule (``kbe_tpu/train/checkpoint.py:99``):
a path ending in ``.tar`` is a torch file; anything else is an orbax
directory, which raises, since reading one needs JAX.
"""

from __future__ import annotations

import os
import pickle
import re
from typing import Any, Dict, Optional, Tuple

import torch


def _states(state) -> Tuple:
    return tuple(state) if isinstance(state, (tuple, list)) else (state,)


def _save(directory: str, name: str, step: int, blob: Dict) -> str:
    os.makedirs(directory, exist_ok=True)
    path = os.path.abspath(os.path.join(directory, f"{name}-{step}.tar"))
    tmp = path + ".tmp"
    torch.save(blob, tmp)
    os.replace(tmp, path)
    return path


def _torch_file(path: str, weights_only: bool = True):
    """The contents of a torch ``.tar``; any other path is an orbax
    directory, which raises."""
    if not path.endswith(".tar"):
        raise NotImplementedError(
            f"{path} does not end in .tar, so it is an orbax checkpoint "
            "directory: reading one needs JAX, which the port does not "
            "import; pass a torch .tar")
    return torch.load(path, map_location="cpu", weights_only=weights_only)


def save_checkpoint(directory: str, name: str, state: Any,
                    step: int) -> str:
    """Write ``state`` to ``<directory>/<name>-<step>.tar``; returns the
    path."""
    return _save(directory, name, step,
                 {"state": [s.state_dict() for s in _states(state)],
                  "step": int(step)})


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
    saved = _torch_file(path)
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
    """Params to warm-start a trainer from. ``kind``: 'disparity' |
    'refine' | 'inpaint' (then {'context': ..., 'net': ...}). ``path``:

      - a checkpoint of the port's trainers (``save_checkpoint``): the
        net's state dict; of a ``(disparity, refine)`` pair the first for
        'disparity' and the second for 'refine', of a ``(G, D)`` pair G's;
      - a reference torch ``.tar``: Flax-shaped trees converted by
        ``kbe_torch.utils.reference_convert``.

    The port's checkpoints are read with ``weights_only=True``; only a file
    that is not one goes on to the reference converter, which needs the
    full unpickler. ``kbe_torch.utils.convert.load_params`` loads either
    kind of params into the port's modules, as the trainers do."""
    if kind not in ("disparity", "refine", "inpaint"):
        raise ValueError(f"unknown kind {kind!r}")
    try:
        blob = _torch_file(path)
    except pickle.UnpicklingError:
        blob = None
    if isinstance(blob, dict) and set(blob) == {"state", "step"}:
        states = blob["state"]
        state = states[1 if kind == "refine" and len(states) == 2 else 0]
        if kind == "inpaint":
            return {"context": state["context"], "net": state["net"]}
        return state["net"]
    from kbe_torch.utils import reference_convert as rc

    if kind == "disparity":
        return rc.convert_disparity(path)
    if kind == "refine":
        return rc.convert_refine(path)
    ctx, net = rc.convert_inpaint(path)
    return {"context": ctx, "net": net}


def save_pipeline(directory: str, models, step: int) -> str:
    """Write the nets of ``models`` (``PipelineModels``; the dual-net pair
    where it is there) to ``<directory>/pipeline-<step>.tar`` as f32 state
    dicts on the CPU; returns the path."""
    nets = {}
    for field, net in zip(models._fields, models):
        if net is not None:
            nets[field] = {k: (v.detach().to("cpu", torch.float32)
                               if v.is_floating_point() else v.cpu())
                           for k, v in net.state_dict().items()}
    return _save(directory, "pipeline", step, {"pipeline": nets,
                                         "step": int(step)})


def load_pipeline_params(path: str, device=None, dtype=torch.float32,
                         depth_dtype=None, pretrained_refine: bool = False,
                         partial_inpainting: bool = False,
                         inpaint_depth: Optional[bool] = None):
    """``PipelineModels`` from a ``save_pipeline`` file, on ``device``
    (default ``cuda``) in the compute types of ``create_models``: ``dtype``
    for context and inpaint, ``depth_dtype`` (default ``dtype``) for the
    depth nets; the production mix is ``dtype=torch.bfloat16,
    depth_dtype=torch.float32``. ``inpaint_depth=None`` takes the dual-net
    pair when the file holds one. A missing or extra net, a missing or
    extra entry, or a shape that differs raises."""
    from kbe_torch.pipeline.kenburns import PipelineModels, models_from_flax

    blob = _torch_file(path)
    if not (isinstance(blob, dict) and set(blob) == {"pipeline", "step"}):
        raise ValueError(f"{path} is not a pipeline checkpoint")
    nets = blob["pipeline"]
    if inpaint_depth is None:
        inpaint_depth = "inpaint_depth" in nets
    want = set(PipelineModels._fields[:5])
    if inpaint_depth:
        want |= {"context_depth", "inpaint_depth"}
    if set(nets) != want:
        raise ValueError(f"{path}: missing nets {sorted(want - set(nets))}, "
                         f"extra nets {sorted(set(nets) - want)}")
    return models_from_flax(nets, device, dtype, depth_dtype,
                            pretrained_refine, partial_inpainting,
                            inpaint_depth)


def find_bench_weights(repo_root: Optional[str] = None) -> Optional[str]:
    """The bench weights' checkpoint, or None for random weights.

    ``$KBE_BENCH_WEIGHTS`` first: a checkpoint path, or '', '0' or 'none'
    for random weights. Else the ``pipeline-<step>.tar`` of the highest
    step in ``<repo_root>/.bench_weights`` (``kbe_tpu``'s orbax
    ``pipeline-<step>`` directories beside it are not read)."""
    env = os.environ.get("KBE_BENCH_WEIGHTS")
    if env is not None:
        return env if env not in ("", "0", "none") else None
    if repo_root is None:
        repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
    return latest_checkpoint(os.path.join(repo_root, ".bench_weights"),
                             "pipeline")
