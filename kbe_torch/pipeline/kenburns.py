"""The 3D Ken Burns effect, end to end. Port of
``kbe_tpu/pipeline/kenburns.py``.

Stages, as in the JAX package:
  1. depth: ``resize_to_max`` -> Semantics -> Disparity (replaced by ones
     in 2D mode) -> Refine -> normalise -> depth -> points, and the
     ``depth_range`` anchor;
  2. the inpainting bootstrap at steps 0 and 1 (skipped for dolly), each
     appended to the cloud as a pixel grid valid where the net reports no
     coverage (3 grids);
  3. the pose loop: splat of the cloud (payload rgb + depth) at each pose's
     shift and focal -> disocclusion fill -> uint8 quantise -> sub-pixel
     crop -> resize.

``EffectConfig.splat_method`` and ``fill_impl`` select the entry point that
the JAX package selects with them (see ``build_effect_fn``). On CUDA tensors
every one of them runs the hand-written kernels of ``kbe_torch/ops/csrc``;
on CPU tensors their plain versions. The kernels never drop a point, so
``splat_overflow_chunks`` and ``splat_fallback`` have nothing to choose and
``with_stats`` reports ``splat_overflow_frames = 0``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from kbe_torch.config import CameraConfig, EffectConfig, ZoomSettings
from kbe_torch.device import disable_tf32, resolve_device
from kbe_torch.models import (ContextNet, Disparity, Inpaint, PartialInpaint,
                              Refine, RefinePretrained, Semantics)
from kbe_torch.models.layers import init_params
from kbe_torch.ops.discfill import fill_disocclusion, \
    fill_disocclusion_pallas
from kbe_torch.ops.geometry import (apply_shift, depth_range,
                                    depth_to_points, disparity_to_depth,
                                    interpolate_window, solve_shift,
                                    true_div)
from kbe_torch.ops.legacy import render_grids_fast_delta, \
    render_grids_pallas
from kbe_torch.ops.resize import crop_rect_subpix, resize_bilinear, \
    resize_to_max
from kbe_torch.ops.splat import prepare_scene, render_pointcloud, \
    render_posed
from kbe_torch.ops.splat_routed import render_grids_fast
from kbe_torch.pipeline.inpaint_flow import InpaintModels, \
    pointcloud_inpainting
from kbe_torch.utils.convert import load_flax

SPLAT_METHODS = ("auto", "banded", "routed", "scatter", "delta", "pallas")
FILL_IMPLS = ("pallas", "xla")


def displacement_margin(zoom: ZoomSettings, camera: CameraConfig,
                        effect: EffectConfig, width: int,
                        height: int) -> int:
    """Static bound on any point's per-frame screen displacement (pixels).

    The solved metric shift sx ~= shiftU * closest / focal projects to at
    most shiftU (z >= closest); the z-shift adds |u| * sz/z <= (W/2) *
    (1 - min crop ratio); inpaint-grid points carry an extra -overshoot *
    endpoint shift; dolly focal interpolation rescales u by up to the crop
    scaling. ``splat_method='pallas'`` is refused beyond
    ``effect.max_pallas_margin``, as in the JAX package.
    """
    su = [zoom.src.center_u - width / 2.0, zoom.dst.center_u - width / 2.0]
    sv = [zoom.src.center_v - height / 2.0,
          zoom.dst.center_v - height / 2.0]
    max_cw = max(zoom.src.crop_width, zoom.dst.crop_width)
    dr = 1.0 - min(zoom.src.crop_width, zoom.dst.crop_width) / max_cw
    over = (effect.inpaint_overshoot
            if effect.inpaint and not effect.dolly else 0.0)
    mx = max(abs(a - over * b) for a in su + [0.0] for b in su + [0.0])
    my = max(abs(a - over * b) for a in sv + [0.0] for b in sv + [0.0])
    scale_term = (max(width, height) / 2.0) * dr * (1.0 + over)
    if effect.dolly:
        # focal interpolation rescales all screen coords
        scaling = zoom.dst.crop_width / zoom.src.crop_width
        scale_term += (max(width, height) / 2.0) * abs(scaling - 1.0)
    return int(math.ceil(max(mx, my) + scale_term)) + 6


def _step_focal(step: float, zoom: ZoomSettings, camera: CameraConfig,
                dolly: bool) -> float:
    """Dolly focal interpolation f*(1-s) + s*f*(wTo/wFrom); constant
    otherwise. Python float math: the caller rounds to f32 once."""
    if not dolly:
        return camera.focal
    scaling = zoom.dst.crop_width / zoom.src.crop_width
    return camera.focal * (1.0 - step) + step * camera.focal * scaling


class PipelineModels(NamedTuple):
    """The nets of the effect (the JAX package's ``PipelineParams``).
    ``context_depth`` and ``inpaint_depth`` are the dual-net mode's second
    pair; both or neither."""

    semantics: Semantics
    disparity: Disparity
    refine: Refine
    context: ContextNet
    inpaint: torch.nn.Module
    context_depth: Optional[ContextNet] = None
    inpaint_depth: Optional[torch.nn.Module] = None


def _new_models(pretrained_refine: bool, partial_inpainting: bool,
                inpaint_depth: bool) -> PipelineModels:
    inpaint_cls = PartialInpaint if partial_inpainting else Inpaint
    return PipelineModels(
        Semantics(), Disparity(),
        RefinePretrained() if pretrained_refine else Refine(),
        ContextNet(), inpaint_cls(),
        ContextNet() if inpaint_depth else None,
        inpaint_cls() if inpaint_depth else None)


def _place(models: PipelineModels, device, dtype,
           depth_dtype) -> PipelineModels:
    depth_dtype = dtype if depth_dtype is None else depth_dtype
    kinds = (depth_dtype, depth_dtype, depth_dtype, dtype, dtype, dtype,
             dtype)
    return PipelineModels(*(
        None if m is None else m.to(device=device, dtype=dt).eval()
        for m, dt in zip(models, kinds)))


def create_models(seed: int = 0, device=None, dtype=torch.float32,
                  depth_dtype=None, pretrained_refine: bool = False,
                  partial_inpainting: bool = False,
                  inpaint_depth: bool = False) -> PipelineModels:
    """Full-width nets with seeded random weights (drawn on the CPU from
    one ``torch.Generator``), on ``device`` in the given compute types:
    ``dtype`` for context + inpaint, ``depth_dtype`` (default ``dtype``)
    for semantics, disparity and refine."""
    gen = torch.Generator().manual_seed(seed)
    models = _new_models(pretrained_refine, partial_inpainting,
                         inpaint_depth)
    for m in models:
        if m is not None:
            init_params(m, gen)
    return _place(models, resolve_device(device), dtype, depth_dtype)


def models_from_flax(trees, device=None, dtype=torch.float32,
                     depth_dtype=None, pretrained_refine: bool = False,
                     partial_inpainting: bool = False,
                     inpaint_depth: Optional[bool] = None) -> PipelineModels:
    """Nets loaded from Flax param trees: ``trees`` has the fields of
    ``PipelineModels`` (a ``kbe_tpu`` ``PipelineParams`` as numpy, or a
    dict). ``inpaint_depth=None`` builds the second pair when the trees
    hold one."""

    def tree(name):
        return (getattr(trees, name, None) if hasattr(trees, "_fields")
                else trees.get(name))

    if inpaint_depth is None:
        inpaint_depth = tree("inpaint_depth") is not None
    models = _new_models(pretrained_refine, partial_inpainting,
                         inpaint_depth)
    for name, m in zip(PipelineModels._fields, models):
        if m is None:
            continue
        if tree(name) is None:
            raise ValueError(f"no param tree for {name}" + (
                ": inpaint_depth requires context_depth"
                if name == "context_depth" else ""))
        load_flax(m, tree(name))
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


class EffectState(NamedTuple):
    """What the front end hands the pose loop. ``scene`` is the cloud with
    x, y pre-scaled for the posed renderer; ``cloud_xyz`` (G, H, W, 3) is
    the raw cloud that the other renderers shift themselves; ``poses``
    (T, 5) = (shift, focal, focal * baseline) per step."""

    scene: object
    cloud_xyz: torch.Tensor
    poses: torch.Tensor


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
    ``PipelineModels`` passed in; ``pretrained_refine`` and
    ``partial_inpainting`` say which nets they must hold, and a mismatch
    raises. On CUDA, TF32 is turned off for cuDNN and cuBLAS
    (``kbe_torch.device.disable_tf32``): the depth nets must run true f32.

    ``effect.splat_method`` picks the frame loop's renderer: ``'auto'`` and
    ``'banded'`` the posed renderer (``render_posed``, the shift applied in
    the kernel); ``'routed'`` ``apply_shift`` then ``render_grids_fast``;
    ``'delta'`` and ``'pallas'`` the entry points of ``ops/legacy``;
    ``'scatter'`` ``render_pointcloud``. The bootstrap renders through
    ``'scatter'`` or ``'banded'`` when the frame loop does, else through
    ``'routed'``. ``effect.fill_impl``: ``'pallas'`` is
    ``fill_disocclusion_pallas`` inside the ROI, ``'xla'``
    ``fill_disocclusion`` over the whole frame. Any other value raises
    ``ValueError``.

    The returned function also carries its two halves: ``front_end(models,
    image) -> state`` (depth, bootstrap, cloud, poses) and
    ``render_frames(state) -> frames`` (the pose loop), for timing.
    """
    dev = resolve_device(device)
    if height % 4 or width % 4:
        raise ValueError("image dims must be multiples of 4 (kbe.py:108-114)")
    zoom.validate(width, height)
    splat = effect.splat_method
    if splat not in SPLAT_METHODS:
        raise ValueError(f"splat_method must be one of {SPLAT_METHODS}, got "
                         f"{splat!r}")
    if effect.fill_impl not in FILL_IMPLS:
        raise ValueError(f"fill_impl must be one of {FILL_IMPLS}, got "
                         f"{effect.fill_impl!r}")
    if splat == "auto":
        splat = "banded"
    margin = displacement_margin(zoom, camera, effect, width, height)
    if splat == "pallas" and margin > effect.max_pallas_margin:
        raise ValueError(
            f"trajectory displacement bound {margin}px exceeds "
            f"max_pallas_margin={effect.max_pallas_margin}; use "
            "splat_method='routed'")
    bootstrap_splat = splat if splat in ("scatter", "banded") else "routed"
    if dev.type == "cuda":
        disable_tf32()

    steps = np.linspace(0.0, 1.0, effect.num_steps)
    focals = np.array([_step_focal(s, zoom, camera, effect.dolly)
                       for s in steps], np.float32)
    max_cw = max(zoom.src.crop_width, zoom.dst.crop_width)
    max_ch = max(zoom.src.crop_height, zoom.dst.crop_height)
    roi = fill_roi_of(height, width, zoom, effect)

    def check_models(models: PipelineModels) -> None:
        if isinstance(models.refine, RefinePretrained) != pretrained_refine:
            raise ValueError("pretrained_refine does not match the refine "
                             f"net given ({type(models.refine).__name__})")
        if isinstance(models.inpaint, PartialInpaint) != partial_inpainting:
            raise ValueError("partial_inpainting does not match the inpaint "
                             f"net given ({type(models.inpaint).__name__})")
        if models.inpaint_depth is not None and models.context_depth is None:
            raise ValueError("inpaint_depth requires context_depth")

    def net_apply(net):
        if partial_inpainting:
            return net

        def apply(data, masks):
            return net(data, masks) + (masks,)

        return apply

    def front_end(models: PipelineModels, image: torch.Tensor):
        check_models(models)
        resized = resize_to_max(image, max(height, width) // 2)
        semantics = models.semantics(resized)
        disp_half = models.disparity(resized, semantics)
        if effect.two_d:
            # 2D KBE: a flat scene
            disp_half = torch.ones_like(disp_half)
        disparity = models.refine(image, disp_half).float()
        disparity = disparity - torch.clamp(disparity.min(), max=0.0)
        disparity = disparity / disparity.max() * camera.baseline
        depth = disparity_to_depth(disparity, camera.focal, camera.baseline)
        points = depth_to_points(depth[..., 0], camera.focal)
        anchor = depth_range(depth[0, ..., 0], effect.depth_range_margin)

        grids_xyz = [points[0]]
        grids_data = [torch.cat([image[0], disparity[0], depth[0]], dim=-1)]
        grids_valid = [torch.ones((height, width), device=dev)]
        if effect.inpaint and not effect.dolly:
            flow = InpaintModels(
                context=models.context, net=net_apply(models.inpaint),
                depth_net=(net_apply(models.inpaint_depth)
                           if models.inpaint_depth is not None else None),
                context_depth=models.context_depth)
            for s in (0.0, 1.0):
                shift = compute_pose_shift(s, camera.focal, anchor, zoom,
                                           camera, width, height)
                inp = pointcloud_inpainting(
                    flow, image, disparity, effect.inpaint_overshoot * shift,
                    camera, camera.focal, effect.validity_threshold,
                    splat_method=bootstrap_splat)
                grids_xyz.append(inp["points"].reshape(height, width, 3))
                grids_data.append(torch.cat(
                    [inp["image"][0], inp["disparity"][0], inp["depth"][0]],
                    dim=-1))
                grids_valid.append(
                    (inp["existing"][0, ..., 0] == 0.0).float())
        cloud_xyz = torch.stack(grids_xyz)
        cloud_data = torch.stack(grids_data)
        frame_data = torch.cat([cloud_data[..., 0:3], cloud_data[..., 4:5]],
                               dim=-1)
        scene = prepare_scene(cloud_xyz, frame_data,
                              torch.stack(grids_valid))

        steps_t = torch.as_tensor(steps.astype(np.float32), device=dev)
        focals_t = torch.as_tensor(focals, device=dev)
        shifts = compute_pose_shift(steps_t, focals_t, anchor, zoom, camera,
                                    width, height)
        poses = torch.cat([shifts, focals_t[:, None],
                           (focals_t * camera.baseline)[:, None]],
                          dim=1).contiguous()
        return EffectState(scene, cloud_xyz, poses)

    def splat_frame(state: EffectState, pose: torch.Tensor):
        """One pose's (render (H, W, 4), weight (H, W, 1))."""
        scene = state.scene
        if splat == "banded":
            return render_posed(scene, pose, height, width)
        xyz = apply_shift(state.cloud_xyz, pose[:3])
        g = xyz.shape[0]
        data = scene.payload.reshape(g, height, width, -1)
        valid = scene.valid.reshape(g, height, width)
        focal = pose[3]
        if splat == "routed":
            render, weight = render_grids_fast(
                xyz, data, height, width, focal, camera.baseline,
                valid=valid, fallback=effect.splat_fallback)
        elif splat == "delta":
            render, weight = render_grids_fast_delta(
                xyz, data, height, width, focal, camera.baseline,
                valid=valid, fallback=effect.splat_fallback)
        elif splat == "pallas":
            render, weight = render_grids_pallas(
                xyz, data, height, width, focal, camera.baseline,
                valid=valid, margin=margin)
        else:
            render, weight = render_pointcloud(
                xyz.reshape(1, -1, 3), data.reshape(1, -1, data.shape[-1]),
                height, width, focal, camera.baseline,
                valid=valid.reshape(1, -1))
        return render[0], weight[0]

    def render_frame(state: EffectState, pose: torch.Tensor) -> torch.Tensor:
        render, weight = splat_frame(state, pose)
        render_depth = render[..., 3:4] * (weight > 0.0)
        if effect.fill_impl == "xla":
            filled = fill_disocclusion(render[None], render_depth[None],
                                       effect.fill_march_steps)[0]
        else:
            filled = fill_disocclusion_pallas(
                render[None], render_depth[None], effect.fill_march_steps,
                phase1_steps=effect.fill_march_phase1, roi=roi,
                phase0_steps=effect.fill_phase0,
                phase0_gate=effect.fill_phase0_gate)[0]
        # quantise BEFORE the crop, round after the crop and the resize,
        # as the reference's uint8 cv2 chain does
        rgb = torch.floor(torch.clamp(filled[..., 0:3] * 255.0, 0.0, 255.0))
        patch = crop_rect_subpix(rgb, max_cw, max_ch, width / 2.0,
                                 height / 2.0)
        patch = torch.clamp(torch.round(patch), 0.0, 255.0)
        out = resize_bilinear(patch[None], height, width)[0]
        return torch.clamp(torch.round(out), 0.0, 255.0).to(torch.uint8)

    def render_frames(state: EffectState) -> torch.Tensor:
        # poses are independent; they run one after another only to bound
        # the memory of the intermediate planes
        return torch.stack([render_frame(state, state.poses[i])
                            for i in range(state.poses.shape[0])])

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
    pretrained_refine: bool = False
    partial_inpainting: bool = False
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
        weights, build the dataclass with ``models_from_flax``, or load
        reference checkpoints with
        ``kbe_torch.utils.reference_convert.load_torch_pipeline``."""
        dev = resolve_device(device)
        return KenBurnsPipeline(
            camera=camera, effect=effect,
            models=create_models(seed, dev, dtype, depth_dtype,
                                 pretrained_refine, partial_inpainting,
                                 inpaint_depth),
            device=dev, pretrained_refine=pretrained_refine,
            partial_inpainting=partial_inpainting)

    def effect_fn(self, height: int, width: int,
                  zoom: ZoomSettings) -> Callable:
        key = (height, width, zoom, self.effect, self.camera)
        if key not in self._cache:
            self._cache[key] = build_effect_fn(
                height, width, zoom, self.camera, self.effect,
                self.pretrained_refine, self.partial_inpainting,
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
