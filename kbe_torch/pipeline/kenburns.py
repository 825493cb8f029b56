"""The 3D Ken Burns effect, end to end. Port of
``kbe_tpu/pipeline/kenburns.py`` on its default path.

Stages, as in the JAX package:
  1. depth: ``resize_to_max`` -> Semantics -> Disparity -> Refine ->
     normalise -> depth -> points, and the ``depth_range`` anchor;
  2. the inpainting bootstrap at steps 0 and 1, each appended to the cloud
     as a pixel grid valid where the render left a hole (3 grids);
  3. the pose loop: splat of the 3-grid cloud (payload rgb + depth) ->
     disocclusion fill -> uint8 quantise -> sub-pixel crop -> resize.

On CUDA tensors the splat and the fill run the hand-written kernels of
``kbe_torch/ops/csrc``; on CPU tensors their plain versions.

Not supported yet (they raise ``NotImplementedError``): dolly, 2D,
``pretrained_refine``, ``partial_inpainting`` and the dual-net
inpaint-depth mode. The TPU schedule knobs of ``EffectConfig``
(``splat_method``, ``splat_overflow_chunks``, ``splat_fallback``,
``fill_impl``, ``fill_march_phase1``, ``fill_phase0``,
``fill_phase0_gate``, ``max_pallas_margin``) do not change the function, so
they are ignored: every ``splat_method`` is the one splat, every
``fill_impl`` the one fill, and ``with_stats`` reports
``splat_overflow_frames = 0`` because no point is ever dropped.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from kbe_torch.config import CameraConfig, EffectConfig, ZoomSettings
from kbe_torch.device import disable_tf32, resolve_device
from kbe_torch.models import ContextNet, Disparity, Inpaint, Refine, \
    Semantics
from kbe_torch.models.layers import init_params
from kbe_torch.ops.discfill import fill_disocclusion
from kbe_torch.ops.geometry import (depth_range, depth_to_points,
                                    disparity_to_depth, interpolate_window,
                                    solve_shift, true_div)
from kbe_torch.ops.resize import crop_rect_subpix, resize_bilinear, \
    resize_to_max
from kbe_torch.ops.splat import prepare_scene, render_posed
from kbe_torch.pipeline.inpaint_flow import InpaintModels, \
    pointcloud_inpainting
from kbe_torch.utils.convert import state_dict_from_flax


class PipelineModels(NamedTuple):
    """The nets of the effect (the JAX package's ``PipelineParams``)."""

    semantics: Semantics
    disparity: Disparity
    refine: Refine
    context: ContextNet
    inpaint: Inpaint


def _place(models: PipelineModels, device, dtype,
           depth_dtype) -> PipelineModels:
    depth_dtype = dtype if depth_dtype is None else depth_dtype
    kinds = (depth_dtype, depth_dtype, depth_dtype, dtype, dtype)
    return PipelineModels(*(m.to(device=device, dtype=dt).eval()
                            for m, dt in zip(models, kinds)))


def create_models(seed: int = 0, device=None, dtype=torch.float32,
                  depth_dtype=None) -> PipelineModels:
    """Full-width nets with seeded random weights (drawn on the CPU from
    one ``torch.Generator``), on ``device`` in the given compute types:
    ``dtype`` for context + inpaint, ``depth_dtype`` (default ``dtype``)
    for semantics, disparity and refine."""
    gen = torch.Generator().manual_seed(seed)
    models = PipelineModels(Semantics(), Disparity(), Refine(), ContextNet(),
                            Inpaint())
    for m in models:
        init_params(m, gen)
    return _place(models, resolve_device(device), dtype, depth_dtype)


def models_from_flax(trees, device=None, dtype=torch.float32,
                     depth_dtype=None) -> PipelineModels:
    """Nets loaded from Flax param trees: ``trees`` has the fields of
    ``PipelineModels`` (a ``kbe_tpu`` ``PipelineParams`` as numpy)."""
    models = PipelineModels(Semantics(), Disparity(), Refine(), ContextNet(),
                            Inpaint())
    for name, m in zip(PipelineModels._fields, models):
        m.load_state_dict(state_dict_from_flax(getattr(trees, name)
                                               if hasattr(trees, name)
                                               else trees[name]))
    return _place(models, resolve_device(device), dtype, depth_dtype)


def _window_shift(step, zoom: ZoomSettings, width: int, height: int):
    cu, cv, cw, ch = interpolate_window(zoom.src, zoom.dst, step)
    return cu - width / 2.0, cv - height / 2.0, cw


def compute_pose_shift(step, focal, anchor, zoom: ZoomSettings,
                       camera: CameraConfig, width: int, height: int):
    """Camera shift (3,) for ``step`` in [0, 1]; ``step`` and ``focal`` may
    be (T,) tensors, giving (T, 3). ``anchor`` = (min_depth, min_u, min_v)
    from ``depth_range``."""
    dmin, du, dv = anchor
    shift_u, shift_v, crop_w = _window_shift(step, zoom, width, height)
    max_crop_w = max(zoom.src.crop_width, zoom.dst.crop_width)
    ratio = (true_div(crop_w, max_crop_w) if isinstance(crop_w, torch.Tensor)
             else crop_w / max_crop_w)
    depth_to = dmin * ratio
    return solve_shift(shift_u, shift_v, dmin, depth_to, dmin, du, dv,
                       width, height, focal)


def fill_roi_of(height: int, width: int, zoom: ZoomSettings,
                effect: EffectConfig):
    """The static fill ROI: the centered max-crop window the frames sample,
    +2 px for the bilinear taps; None when it covers the image."""
    if not effect.fill_roi:
        return None
    max_cw = max(zoom.src.crop_width, zoom.dst.crop_width)
    max_ch = max(zoom.src.crop_height, zoom.dst.crop_height)
    rx0 = max(0, int(np.floor(width / 2.0 - (max_cw - 1) / 2.0)) - 2)
    rx1 = min(width, int(np.floor(width / 2.0 + (max_cw - 1) / 2.0)) + 3)
    ry0 = max(0, int(np.floor(height / 2.0 - (max_ch - 1) / 2.0)) - 2)
    ry1 = min(height, int(np.floor(height / 2.0 + (max_ch - 1) / 2.0)) + 3)
    if (ry0, ry1, rx0, rx1) == (0, height, 0, width):
        return None
    return (ry0, ry1, rx0, rx1)


def build_effect_fn(height: int, width: int, zoom: ZoomSettings,
                    camera: CameraConfig = CameraConfig(),
                    effect: EffectConfig = EffectConfig(),
                    pretrained_refine: bool = False,
                    partial_inpainting: bool = False,
                    with_stats: bool = False,
                    device=None) -> Callable:
    """Build ``effect(models, image) -> frames``.

    ``image``: (1, H, W, 3) f32 in [0, 1] on ``device`` (default ``cuda``);
    returns (num_steps, H, W, 3) uint8 on that device, or ``(frames,
    stats)`` with ``with_stats``. The compute types are those of the
    ``PipelineModels`` passed in. On CUDA, TF32 is turned off for cuDNN and
    cuBLAS (``kbe_torch.device.disable_tf32``): the depth nets must run
    true f32.

    The returned function also carries its two halves: ``front_end(models,
    image) -> state`` (depth, bootstrap, cloud, poses) and
    ``render_frames(state) -> frames`` (the pose loop), for timing.
    """
    dev = resolve_device(device)
    if height % 4 or width % 4:
        raise ValueError("image dims must be multiples of 4 (kbe.py:108-114)")
    for flag, name in ((effect.dolly, "dolly"), (effect.two_d, "2D"),
                       (pretrained_refine, "pretrained_refine"),
                       (partial_inpainting, "partial_inpainting")):
        if flag:
            raise NotImplementedError(f"kbe_torch does not support {name} "
                                      "yet")
    zoom.validate(width, height)
    if dev.type == "cuda":
        disable_tf32()

    steps = np.linspace(0.0, 1.0, effect.num_steps).astype(np.float32)
    max_cw = max(zoom.src.crop_width, zoom.dst.crop_width)
    max_ch = max(zoom.src.crop_height, zoom.dst.crop_height)
    roi = fill_roi_of(height, width, zoom, effect)

    def front_end(models: PipelineModels, image: torch.Tensor):
        resized = resize_to_max(image, max(height, width) // 2)
        semantics = models.semantics(resized)
        disp_half = models.disparity(resized, semantics)
        disparity = models.refine(image, disp_half).float()
        disparity = disparity - torch.clamp(disparity.min(), max=0.0)
        disparity = disparity / disparity.max() * camera.baseline
        depth = disparity_to_depth(disparity, camera.focal, camera.baseline)
        points = depth_to_points(depth[..., 0], camera.focal)
        anchor = depth_range(depth[0, ..., 0], effect.depth_range_margin)

        grids_xyz = [points[0]]
        grids_data = [torch.cat([image[0], disparity[0], depth[0]], dim=-1)]
        grids_valid = [torch.ones((height, width), device=dev)]
        if effect.inpaint:
            flow = InpaintModels(context=models.context, net=models.inpaint)
            for s in (0.0, 1.0):
                shift = compute_pose_shift(s, camera.focal, anchor, zoom,
                                           camera, width, height)
                inp = pointcloud_inpainting(
                    flow, image, disparity, effect.inpaint_overshoot * shift,
                    camera, camera.focal, effect.validity_threshold)
                grids_xyz.append(inp["points"].reshape(height, width, 3))
                grids_data.append(torch.cat(
                    [inp["image"][0], inp["disparity"][0], inp["depth"][0]],
                    dim=-1))
                grids_valid.append(
                    (inp["existing"][0, ..., 0] == 0.0).float())
        cloud_data = torch.stack(grids_data)
        frame_data = torch.cat([cloud_data[..., 0:3], cloud_data[..., 4:5]],
                               dim=-1)
        scene = prepare_scene(torch.stack(grids_xyz), frame_data,
                              torch.stack(grids_valid))

        steps_t = torch.as_tensor(steps, device=dev)
        focals_t = torch.full_like(steps_t, camera.focal)
        shifts = compute_pose_shift(steps_t, focals_t, anchor, zoom, camera,
                                    width, height)
        poses = torch.cat([shifts, focals_t[:, None],
                           (focals_t * camera.baseline)[:, None]],
                          dim=1).contiguous()
        return scene, poses

    def render_frame(scene, pose: torch.Tensor) -> torch.Tensor:
        render, weight = render_posed(scene, pose, height, width)
        render_depth = render[..., 3:4] * (weight > 0.0)
        filled = fill_disocclusion(render[None], render_depth[None],
                                   effect.fill_march_steps, roi)[0]
        # quantise BEFORE the crop, round after the crop and the resize,
        # as the reference's uint8 cv2 chain does
        rgb = torch.floor(torch.clamp(filled[..., 0:3] * 255.0, 0.0, 255.0))
        patch = crop_rect_subpix(rgb, max_cw, max_ch, width / 2.0,
                                 height / 2.0)
        patch = torch.clamp(torch.round(patch), 0.0, 255.0)
        out = resize_bilinear(patch[None], height, width)[0]
        return torch.clamp(torch.round(out), 0.0, 255.0).to(torch.uint8)

    def render_frames(state) -> torch.Tensor:
        scene, poses = state
        # poses are independent; they run one after another only to bound
        # the memory of the intermediate planes
        return torch.stack([render_frame(scene, poses[i])
                            for i in range(poses.shape[0])])

    @torch.inference_mode()
    def effect_fn(models: PipelineModels, image: torch.Tensor):
        frames = render_frames(front_end(models, image))
        if with_stats:
            return frames, {"splat_overflow_frames": 0}
        return frames

    effect_fn.front_end = torch.inference_mode()(front_end)
    effect_fn.render_frames = torch.inference_mode()(render_frames)
    return effect_fn


@dataclasses.dataclass
class KenBurnsPipeline:
    """User-facing pipeline: owns the nets and the built effects."""

    camera: CameraConfig
    effect: EffectConfig
    models: PipelineModels
    device: torch.device
    _cache: dict = dataclasses.field(default_factory=dict)

    @staticmethod
    def create(seed: int = 0, camera: CameraConfig = CameraConfig(),
               effect: EffectConfig = EffectConfig(),
               pretrained_refine: bool = False,
               partial_inpainting: bool = False,
               inpaint_depth: bool = False,
               dtype: torch.dtype = torch.float32,
               depth_dtype: Optional[torch.dtype] = None,
               device=None) -> "KenBurnsPipeline":
        """Seeded random nets on ``device`` (default ``cuda``; raises where
        there is no GPU unless ``device="cpu"``). The production mix is
        ``dtype=torch.bfloat16, depth_dtype=torch.float32``. For other
        weights, build the dataclass with ``models_from_flax``."""
        dev = resolve_device(device)
        for flag, name in ((pretrained_refine, "pretrained_refine"),
                           (partial_inpainting, "partial_inpainting"),
                           (inpaint_depth, "inpaint_depth")):
            if flag:
                raise NotImplementedError(
                    f"kbe_torch does not support {name} yet")
        return KenBurnsPipeline(
            camera=camera, effect=effect,
            models=create_models(seed, dev, dtype, depth_dtype), device=dev)

    def effect_fn(self, height: int, width: int,
                  zoom: ZoomSettings) -> Callable:
        key = (height, width, zoom)
        if key not in self._cache:
            self._cache[key] = build_effect_fn(
                height, width, zoom, self.camera, self.effect,
                device=self.device)
        return self._cache[key]

    def __call__(self, image: np.ndarray,
                 zoom: Optional[ZoomSettings] = None) -> np.ndarray:
        """``image``: (H, W, 3) float [0, 1] -> (num_steps, H, W, 3)
        uint8."""
        h, w = image.shape[0], image.shape[1]
        if zoom is None:
            zoom = (ZoomSettings.default_dolly(w, h) if self.effect.dolly
                    else ZoomSettings.default_3d(w, h))
        fn = self.effect_fn(h, w, zoom)
        x = torch.as_tensor(np.asarray(image, np.float32),
                            device=self.device)[None]
        return fn(self.models, x).cpu().numpy()
