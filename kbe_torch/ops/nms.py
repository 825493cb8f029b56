"""Greedy NMS over static sets: plain PyTorch spec + CUDA kernel.

Port of ``kbe_tpu/models/maskrcnn.py::_iou_matrix`` and ``::_nms_keep``,
whose greedy loop (a ``lax.fori_loop`` in XLA there) is kernel ``nms`` in
``csrc/nms.cu`` here. A set is sorted by descending score (``torch.sort``
with ``stable=True``, as ``jnp.argsort`` is stable); slot ``i``, in order,
kills every later slot whose IoU with it is > ``iou_thresh`` if it is still
alive; a slot starts alive where its score is > 0; suppressed slots keep
their place with score 0. ``keep_plain`` is the loop written out, the
kernel computes it bit for bit on one block a set.

``nms_keep_sets`` takes several sets at once: each is sorted, the sorted
sets are zero-padded to the longest (a slot of score 0 never kills), one
launch covers them all, and each result goes back to its set's order.
"""

from __future__ import annotations

import collections
from typing import List, Sequence, Tuple

import numpy as np
import torch

from kbe_torch.ops import _build

LAUNCHES: collections.Counter = collections.Counter()


def iou_matrix(boxes: torch.Tensor) -> torch.Tensor:
    """(N, 4) xyxy -> (N, N) IoU, in ``_iou_matrix``'s operation order."""
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    area = torch.clamp(x2 - x1, min=0.0) * torch.clamp(y2 - y1, min=0.0)
    ix1 = torch.maximum(x1[:, None], x1[None, :])
    iy1 = torch.maximum(y1[:, None], y1[None, :])
    ix2 = torch.minimum(x2[:, None], x2[None, :])
    iy2 = torch.minimum(y2[:, None], y2[None, :])
    inter = (torch.clamp(ix2 - ix1, min=0.0)
             * torch.clamp(iy2 - iy1, min=0.0))
    union = area[:, None] + area[None, :] - inter
    return torch.div(inter, torch.clamp(union, min=1e-9))


def keep_plain(boxes: torch.Tensor, scores: torch.Tensor,
               iou_thresh: float) -> torch.Tensor:
    """The greedy loop on one sorted set: (N, 4), (N,) -> (N,) scores with
    the suppressed slots zeroed."""
    iou = iou_matrix(boxes)
    n = boxes.shape[0]
    later = torch.arange(n, device=boxes.device)
    thresh = torch.tensor(np.float32(iou_thresh), device=boxes.device)
    alive = scores > 0
    for i in range(n):
        kill = (iou[i] > thresh) & (later > i) & alive[i]
        alive = alive & ~kill
    return torch.where(alive, scores, torch.zeros_like(scores))


def keep_cuda(boxes: torch.Tensor, scores: torch.Tensor, iou_thresh: float,
              tag: str) -> torch.Tensor:
    """Kernel ``nms`` on sorted, zero-padded sets: ``boxes`` (S, cap, 4),
    ``scores`` (S, cap), contiguous f32 CUDA tensors -> (S, cap). ``tag``
    names the launch in ``LAUNCHES`` (``nms/<tag>``)."""
    for name, t in (("boxes", boxes), ("scores", scores)):
        if not t.is_cuda or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous f32 CUDA tensor")
    sets, cap = scores.shape
    if boxes.shape != (sets, cap, 4) or boxes.device != scores.device:
        raise ValueError("boxes must be (S, cap, 4) on the scores' device")
    lib = _build.lib("nms")
    if cap > lib.kbe_nms_max_cap():
        raise ValueError(f"a set of {cap} boxes: the kernel takes at most "
                         f"{lib.kbe_nms_max_cap()}")
    out = torch.empty_like(scores)
    LAUNCHES[f"nms/{tag}"] += 1
    _build.check(lib.kbe_nms(
        boxes.data_ptr(), scores.data_ptr(), sets, cap,
        float(np.float32(iou_thresh)), out.data_ptr(),
        torch.cuda.current_stream(scores.device).cuda_stream), "nms")
    return out


def sort_sets(sets: Sequence[Tuple[torch.Tensor, torch.Tensor]]):
    """Each set sorted by descending score (stable), zero-padded to the
    longest: (boxes (S, cap, 4), scores (S, cap), orders)."""
    cap = max(s.shape[0] for _, s in sets)
    dev = sets[0][1].device
    boxes = torch.zeros((len(sets), cap, 4), dtype=torch.float32, device=dev)
    scores = torch.zeros((len(sets), cap), dtype=torch.float32, device=dev)
    orders = []
    for k, (b, s) in enumerate(sets):
        _, order = torch.sort(-s, stable=True)
        boxes[k, :s.shape[0]] = b[order]
        scores[k, :s.shape[0]] = s[order]
        orders.append(order)
    return boxes, scores, orders


def nms_keep_sets(sets: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                  iou_thresh: float, tag: str = "sets") -> List[torch.Tensor]:
    """``_nms_keep`` of each ``(boxes (N, 4), scores (N,))`` set: scores with
    the suppressed entries zeroed, in the set's own order. One kernel
    launch for all sets on the card; the plain loop on the CPU."""
    boxes, scores, orders = sort_sets(sets)
    if scores.is_cuda:
        kept = keep_cuda(boxes, scores, iou_thresh, tag)
    else:
        kept = torch.stack([keep_plain(b, s, iou_thresh)
                            for b, s in zip(boxes, scores)])
    out = []
    for k, order in enumerate(orders):
        back = torch.empty_like(kept[k, :order.shape[0]])
        back[order] = kept[k, :order.shape[0]]
        out.append(back)
    return out
