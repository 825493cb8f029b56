"""Standalone inpainting evaluation. Port of
``kbe_tpu/train/eval_inpaint.py``.

``InpaintEval`` runs the trained context and inpainting nets over an eval
set: the supervised evaluation (PSNR, SSIM and optionally FID of the
masked-view inpainting), the unsupervised one (the FID of the A -> B
warped and inpainted views), and inspection outputs, among them the
halfway view C of ``generate_view_c``. Both warps go through
``kbe_torch.ops.splat.render_pointcloud``: on the card, the hand-written
splat kernels (C = 68 for the warp to B, C = 4 for view C).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable

import numpy as np
import torch

from kbe_torch.config import CameraConfig
from kbe_torch.device import disable_tf32, resolve_device
from kbe_torch.models import ContextNet, Inpaint, PartialInpaint
from kbe_torch.models.layers import denormalize_sample, normalize_sample
from kbe_torch.ops.geometry import depth_to_points, disparity_to_depth
from kbe_torch.ops.splat import render_pointcloud
from kbe_torch.train.fid import FID
from kbe_torch.train.metrics import compute_inpaint_metrics
from kbe_torch.train.trainer_inpaint import TRAIN_CAMERA, to_device
from kbe_torch.train.view_synthesis import masks_a_from_b, render_view_b
from kbe_torch.utils.convert import load_params


def generate_view_c(points_a, image_a, depth_a, image_b, depth_b, mask_b,
                    shift, camera: CameraConfig, height: int, width: int):
    """The halfway view C: cloud A and the inpainted cloud B, 2N points of
    (image, depth), rendered at ``shift / 2``. Only B's revealed points
    (``mask_b == 0``) are new, but the whole B cloud is merged, as the
    reference merges it; the z-test resolves the overlap. ``mask_b`` is
    kept for the signature. Returns (render (B, H, W, 4), coverage
    weights (B, H, W, 1))."""
    del mask_b
    b = image_a.shape[0]
    pts_b = depth_to_points(depth_b[..., 0], camera.focal).reshape(
        b, -1, 3) - shift[:, None, :]
    pts = torch.cat([points_a, pts_b], dim=1)
    img = torch.cat([image_a.reshape(b, -1, 3), image_b.reshape(b, -1, 3)],
                    dim=1)
    dep = torch.cat([depth_a.reshape(b, -1, 1), depth_b.reshape(b, -1, 1)],
                    dim=1)
    data = torch.cat([img, dep], dim=-1)
    return render_pointcloud(pts + shift[:, None, :] / 2.0, data, height,
                             width, camera.focal, camera.baseline)


@dataclasses.dataclass
class InpaintEval:
    """``params``: {'context': ..., 'net': ...}, the nets' Flax-shaped trees
    (a converted reference checkpoint, or a JAX checkpoint's arrays) or
    the port's state dicts (a trainer's nets).
    ``partial_conv`` picks ``PartialInpaint``; ``fid_params`` is the
    Inception tree of the FID (None: fresh weights). ``device`` defaults to
    ``cuda``, which raises where there is none."""

    params: Dict[str, Any]
    camera: CameraConfig = TRAIN_CAMERA
    partial_conv: bool = False
    fid_params: Any = None
    dtype: Any = torch.float32
    device: Any = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.device.type == "cuda":
            disable_tf32()
        self.context = load_params(ContextNet(), self.params["context"])
        self.net = load_params(
            (PartialInpaint if self.partial_conv else Inpaint)(),
            self.params["net"])
        for m in (self.context, self.net):
            m.to(self.device, self.dtype).eval().requires_grad_(False)

    def _apply_net(self, data, masks):
        out = self.net(data, masks)
        return out[0], out[1]  # PartialInpaint adds its mask

    def _supervised_forward(self, batch):
        masks, _ = masks_a_from_b(batch["image"], batch["disparity"],
                                  batch["depth"], batch["zoom"], self.camera)
        image01 = (batch["image"] + 1.0) / 2.0
        img_n, i_stats = normalize_sample(image01 * masks)
        disp_n, d_stats = normalize_sample(batch["disparity"] * masks)
        ctx = self.context(img_n, disp_n)
        data = torch.cat([img_n, disp_n, ctx], dim=-1)
        out_i, out_d = self._apply_net(data, masks)
        out_img = torch.clamp(denormalize_sample(out_i, i_stats), 0.0, 1.0)
        out_disp = torch.clamp(denormalize_sample(out_d, d_stats), min=0.0)
        metrics = compute_inpaint_metrics(out_img, out_disp, image01,
                                          batch["disparity"])
        return metrics, out_img, image01, masks, out_disp

    def _adversarial_forward(self, batch):
        image01 = (batch["image"] + 1.0) / 2.0
        img_n, i_stats = normalize_sample(image01)
        disp_n, d_stats = normalize_sample(batch["disparity"])
        ctx = self.context(img_n, disp_n)
        render, mask_b, pts_a, shift = render_view_b(
            img_n, disp_n, batch["depth"], batch["zoom"], self.camera,
            context=ctx)
        out_i, out_d = self._apply_net(render, mask_b)
        out_img = torch.clamp(denormalize_sample(out_i, i_stats), 0.0, 1.0)
        out_disp = torch.clamp(denormalize_sample(out_d, d_stats), min=0.0)
        real = torch.clamp(image01, 0.0, 1.0)
        return out_img, out_disp, real, mask_b, pts_a, shift

    @staticmethod
    def _numpy(t: torch.Tensor) -> np.ndarray:
        return t.float().cpu().numpy()

    # ----------------------------------------------------------- public

    @torch.no_grad()
    def eval(self, batches: Iterable[Dict],
             compute_fid: bool = True) -> Dict[str, float]:
        """Supervised metrics, means over the batches, and the FID of the
        inpainted images against the real ones."""
        acc, n = None, 0
        real_imgs, fake_imgs = [], []
        for batch in batches:
            metrics, out_img, image01, _, _ = self._supervised_forward(
                to_device(batch, self.device))
            m = {k: float(v) for k, v in metrics.items()}
            acc = m if acc is None else {k: acc[k] + m[k] for k in m}
            n += 1
            if compute_fid:
                real_imgs.append(self._numpy(image01))
                fake_imgs.append(self._numpy(out_img))
        out = {k: v / n for k, v in acc.items()} if acc else {}
        if compute_fid and real_imgs:
            fid = FID(self.fid_params, device=self.device)
            out["fid"] = fid.fid(np.concatenate(real_imgs),
                                 np.concatenate(fake_imgs))
        return out

    @torch.no_grad()
    def eval_adv(self, batches: Iterable[Dict]) -> float:
        """The FID of the A -> B inpainted views against the real A views
        (no ground truth at B)."""
        real_imgs, fake_imgs = [], []
        for batch in batches:
            out_img, _, real, _, _, _ = self._adversarial_forward(
                to_device(batch, self.device))
            real_imgs.append(self._numpy(real))
            fake_imgs.append(self._numpy(out_img))
        fid = FID(self.fid_params, device=self.device)
        return fid.fid(np.concatenate(real_imgs), np.concatenate(fake_imgs))

    @torch.no_grad()
    def get_inpaint(self, batch: Dict, output_render_c: bool = False):
        """Inspection arrays of one batch: the supervised inpainting, or
        with ``output_render_c`` the A -> B inpainting and the halfway view
        C rendered from A and the inpainted B."""
        batch = to_device(batch, self.device)
        if not output_render_c:
            _, out_img, image01, masks, out_disp = self._supervised_forward(
                batch)
            return {"image": self._numpy(image01),
                    "inpaint_image": self._numpy(out_img),
                    "inpaint_disparity": self._numpy(out_disp),
                    "masks": self._numpy(masks)}
        out_img, out_disp, real, mask_b, pts_a, shift = \
            self._adversarial_forward(batch)
        h, w = real.shape[1], real.shape[2]
        depth_b = disparity_to_depth(out_disp, self.camera.focal,
                                     self.camera.baseline)
        render_c, mask_c = generate_view_c(
            pts_a, real, batch["depth"], out_img, depth_b, mask_b, shift,
            self.camera, h, w)
        return {"image_a": self._numpy(real),
                "inpaint_image_b": self._numpy(out_img),
                "inpaint_disparity_b": self._numpy(out_disp),
                "mask_b": self._numpy(mask_b),
                "render_c": self._numpy(render_c),
                "mask_c": self._numpy(mask_c)}
