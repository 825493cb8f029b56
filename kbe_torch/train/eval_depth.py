"""Standalone depth evaluation. Port of ``kbe_tpu/train/eval_depth.py``.

``DepthEval`` runs the full depth front end over an eval set: the
semantics and the disparity net on the image resized to at most 512
pixels, then the refinement net at full resolution; it reports the 7
depth metrics averaged over the batches, and ``get_depths`` returns the
estimation, the refined disparity and the ground truth of one batch.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable

import torch

from kbe_torch.device import disable_tf32, resolve_device
from kbe_torch.models import Disparity, Refine, RefinePretrained, Semantics
from kbe_torch.ops.resize import resize_to_max
from kbe_torch.train.metrics import compute_depth_metrics
from kbe_torch.utils.convert import load_params


def _tensor(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


@dataclasses.dataclass
class DepthEval:
    """``params``: {'semantics', 'disparity', 'refine'}, Flax-shaped trees
    or the port's state dicts (a trainer's nets).
    ``eval_pretrained`` shifts inputs from [-1, 1] to [0, 1], the range the
    released nets were trained on; ``pretrained_refine`` picks
    ``RefinePretrained``. ``device`` defaults to ``cuda``, which raises
    where there is none."""

    params: Dict[str, Any]
    eval_pretrained: bool = False
    pretrained_refine: bool = False
    dtype: Any = torch.float32
    device: Any = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.device.type == "cuda":
            disable_tf32()
        self.semantics = load_params(Semantics(), self.params["semantics"])
        self.disparity = load_params(Disparity(), self.params["disparity"])
        self.refine = load_params(
            (RefinePretrained if self.pretrained_refine else Refine)(),
            self.params["refine"])
        for m in (self.semantics, self.disparity, self.refine):
            m.to(self.device, self.dtype).eval().requires_grad_(False)

    def _estimate(self, image):
        """(estimation, refined): the disparity at the resized image's
        half resolution, and refined at the image's."""
        resized = resize_to_max(image, 512)
        est = self.disparity(resized, self.semantics(resized))
        return est, self.refine(image, est)

    @torch.no_grad()
    def _eval_step(self, image, disparity_gt, mask):
        if self.eval_pretrained:
            image = (image + 1.0) / 2.0
        _, disp = self._estimate(image)
        return compute_depth_metrics(torch.clamp(disp, min=0.0),
                                     disparity_gt, torch.clamp(mask, 0.0,
                                                               1.0))

    def eval(self, batches: Iterable[Dict]) -> Dict[str, float]:
        acc, n = None, 0
        for batch in batches:
            m = self._eval_step(*(_tensor(batch[k], self.device)
                                  for k in ("image", "disparity", "mask")))
            m = {k: float(v) for k, v in m.items()}
            acc = m if acc is None else {k: acc[k] + m[k] for k in m}
            n += 1
        return {k: v / n for k, v in acc.items()} if acc else {}

    @torch.no_grad()
    def get_depths(self, batch: Dict):
        """Estimation, refined, ground truth, the [0, 1] image and the
        mask of one batch, as numpy arrays."""
        image = _tensor(batch["image"], self.device)
        if self.eval_pretrained:
            image = (image + 1.0) / 2.0
        est, refined = self._estimate(image)
        shown = image if self.eval_pretrained else (image + 1.0) / 2.0
        numpy = lambda t: t.float().cpu().numpy()
        return {"estimation": numpy(est), "refined": numpy(refined),
                "gt": numpy(_tensor(batch["disparity"], "cpu")),
                "image": numpy(shown),
                "mask": numpy(_tensor(batch["mask"], "cpu"))}
