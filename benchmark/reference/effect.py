"""The 3D Ken Burns effect in plain PyTorch: what the port's
``pipeline/kenburns.py`` and ``pipeline/inpaint_flow.py`` compute for one
image, from its own copies of the nets and operations.

Stages: depth (``resize_to_max`` -> Semantics -> Disparity -> Refine ->
normalise -> depth -> points, and the ``depth_range`` anchor); the
inpainting bootstrap at steps 0 and 1 (skipped for dolly): ContextNet ->
68-channel splat -> binary median-5 -> Inpaint -> unproject, each appended
as a grid valid where the inpainting net reports no coverage (a grid-net
reports its input mask, a partial-conv net the mask it propagated); with
``inpaint_depth`` a second ContextNet and net inpaint a second payload of
the same cloud, and their disparity replaces the first net's; then a frame
a pose: splat of the cloud's rgb + depth, disocclusion fill inside the
region the crop reads, uint8 quantise, sub-pixel crop, resize and round.

``configs/<name>.json`` gives the effect's settings (``effect``,
``camera``, ``zoom``, ``precision``, and ``models``, the nets it builds:
``nets.model_flags``); the nets' weights come as state dicts. The
reference switches TF32 off itself for all it computes, and puts the flags
back as it found them, so that it never takes the precision of whoever ran
before it in the process. ``precision="tf32"`` runs the f32 depth nets
with TF32 allowed on the card: the benchmark's control (on the CPU, where
TF32 does not exist, it changes nothing).
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, NamedTuple

import numpy as np
import torch

from benchmark.reference import nets as N
from benchmark.reference import ops as O

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def zoom_windows(kind: str, width: int, height: int):
    """(src, dst) windows (center_u, center_v, crop_w, crop_h) of the
    reference's default moves (kbe.py:128-140)."""
    if kind == "default_3d":
        return ((width / 2.15, height / 2.15, int(math.floor(0.90 * width)),
                 int(math.floor(0.90 * height))),
                (width / 1.85, height / 1.85, int(math.floor(0.85 * width)),
                 int(math.floor(0.85 * height))))
    if kind == "default_dolly":
        return ((width / 2, height / 2, int(math.floor(0.8 * width)),
                 int(math.floor(0.8 * height))),
                (width / 2, height / 2, int(math.floor(0.3 * width)),
                 int(math.floor(0.3 * height))))
    raise ValueError(f"unknown zoom {kind!r}")


def crop_region(height: int, width: int, zoom, fill_roi: bool = True):
    """(y0, y1, x0, x1): the centered largest crop window that the frames
    sample, +2 px for the bilinear taps; the whole frame without
    ``fill_roi``."""
    if not fill_roi:
        return (0, height, 0, width)
    src, dst = zoom
    max_cw, max_ch = max(src[2], dst[2]), max(src[3], dst[3])
    return (max(0, int(np.floor(height / 2.0 - (max_ch - 1) / 2.0)) - 2),
            min(height, int(np.floor(height / 2.0 + (max_ch - 1) / 2.0)) + 3),
            max(0, int(np.floor(width / 2.0 - (max_cw - 1) / 2.0)) - 2),
            min(width, int(np.floor(width / 2.0 + (max_cw - 1) / 2.0)) + 3))


def load_nets(weights: Dict[str, dict], precision: Dict[str, str],
              device, models: Dict[str, bool]
              ) -> Dict[str, torch.nn.Module]:
    """The nets that ``models`` (``nets.model_flags``) builds, with
    ``weights`` ({net: state dict}) in the configuration's precisions,
    copied, so that nothing is shared with whoever else holds the state
    dicts."""
    nets = N.build_nets("meta", models)
    out = {}
    for name, _, kind in N.nets_for(models):
        dt = DTYPES[precision[kind]]
        sd = {k: v.to(device=device, dtype=dt, copy=True)
              for k, v in weights[name].items()}
        nets[name].load_state_dict(sd, assign=True)
        out[name] = nets[name].eval()
    return out


@contextlib.contextmanager
def _tf32(allowed: bool):
    """TF32 allowed or not for convolutions and matmuls while the block
    runs; the flags as they were afterwards."""
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = allowed
    torch.backends.cuda.matmul.allow_tf32 = allowed
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = old


class Cloud(NamedTuple):
    """The valid points of the cloud's grids, x and y pre-scaled by
    z / (z + 1e-7), with their rgb + depth, and the (T, 5) poses."""

    xyz: torch.Tensor
    payload: torch.Tensor
    poses: torch.Tensor


def _pose_shift(step, focal, anchor, zoom, camera, width: int, height: int):
    dmin, du, dv = anchor
    src, dst = zoom
    cu, cv, cw, _ = O.interpolate_window(src, dst, step)
    max_cw = max(src[2], dst[2])
    ratio = (O.true_div(cw, max_cw) if isinstance(cw, torch.Tensor)
             else cw / max_cw)
    return O.solve_shift(cu - width / 2.0, cv - height / 2.0, dmin,
                         dmin * ratio, dmin, du, dv, width, height, focal)


def _flow_cloud(disparity, camera, focal, threshold):
    h, w = disparity.shape[1], disparity.shape[2]
    depth = O.disparity_to_depth(disparity, focal, camera["baseline"])
    valid = O.validity_mask(disparity, threshold)
    points = O.depth_to_points((depth * valid)[..., 0], focal)
    return depth, points.reshape(1, h * w, 3)


def _inpainting(net, context_net, points, shift, image_n, disp_n, focal,
                baseline):
    """One inpainting net on the payload (image_n, disp_n, its context) of
    the cloud ``points`` splatted at ``shift``: (image_n, disparity_n,
    existing), ``existing`` the net's mask where it reports one, else the
    coverage it was given."""
    h, w = image_n.shape[1], image_n.shape[2]
    context = context_net(image_n, disp_n)
    payload = torch.cat([image_n, disp_n, context], dim=-1).reshape(h * w, -1)
    f = torch.full((), focal, dtype=torch.float32, device=image_n.device)
    zero = torch.zeros(3, dtype=torch.float32, device=image_n.device)
    render, weight = O.splat((points + shift)[0].float().contiguous(),
                             payload.float().contiguous(), zero, f,
                             f * baseline, h, w)
    render, weight = render[None], weight[None]
    existing = (weight > 0.0).float()
    existing = existing * O.median_filter_binary(existing, 5)
    out = net(render * existing, existing)
    if isinstance(net, N.PartialInpaint):
        return out
    return out + (existing,)


def _inpainted_grid(nets, image, disparity, shift, camera, threshold):
    """One bootstrap step's grid (xyz, rgb + disparity + depth, valid)."""
    h, w = image.shape[1], image.shape[2]
    focal = camera["focal"]
    _, points = _flow_cloud(disparity, camera, focal, threshold)
    image_n, img_stats = N.normalize_sample(image)
    disp_n, disp_stats = N.normalize_sample(disparity)
    inputs = (points, shift, image_n, disp_n, focal, camera["baseline"])
    img_n, dsp_n, existing = _inpainting(nets["inpaint"], nets["context"],
                                         *inputs)
    if "inpaint_depth" in nets:
        # the dual colour/depth mode: the disparity of the second pair
        _, dsp_n, _ = _inpainting(nets["inpaint_depth"],
                                  nets["context_depth"], *inputs)
    img = torch.clamp(N.denormalize_sample(img_n, img_stats), 0.0, 1.0)
    dsp = torch.clamp(N.denormalize_sample(dsp_n, disp_stats), min=0.0)
    depth, pts = _flow_cloud(dsp, camera, focal, threshold)
    return ((pts - shift).reshape(h, w, 3),
            torch.cat([img[0], dsp[0], depth[0]], dim=-1),
            (existing[0, ..., 0] == 0.0).float())


@torch.inference_mode()
def front_end(nets, image: torch.Tensor, config: dict,
              precision: str = "config") -> Cloud:
    """The cloud and poses of ``image`` (1, H, W, 3) f32 on the nets'
    device."""
    if precision not in ("config", "tf32"):
        raise ValueError(f"unknown precision {precision!r}")
    with _tf32(False):
        return _front_end(nets, image, config, precision)


def _front_end(nets, image, config, precision) -> Cloud:
    effect, camera = config["effect"], config["camera"]
    h, w = image.shape[1], image.shape[2]
    zoom = zoom_windows(config["zoom"], w, h)
    focal, baseline = camera["focal"], camera["baseline"]
    with _tf32(precision == "tf32"):
        resized = O.resize_to_max(image, max(h, w) // 2)
        disp_half = nets["disparity"](resized, nets["semantics"](resized))
        if effect["two_d"]:
            disp_half = torch.ones_like(disp_half)
        disparity = nets["refine"](image, disp_half).float()
    disparity = disparity - torch.clamp(disparity.min(), max=0.0)
    disparity = disparity / disparity.max() * baseline
    depth = O.disparity_to_depth(disparity, focal, baseline)
    anchor = O.depth_range(depth[0, ..., 0], effect["depth_range_margin"])
    grids = [(O.depth_to_points(depth[..., 0], focal)[0],
              torch.cat([image[0], disparity[0], depth[0]], dim=-1),
              torch.ones((h, w), device=image.device))]
    if effect["inpaint"] and not effect["dolly"]:
        for s in (0.0, 1.0):
            shift = _pose_shift(s, focal, anchor, zoom, camera, w, h)
            grids.append(_inpainted_grid(
                nets, image, disparity, effect["inpaint_overshoot"] * shift,
                camera, effect["validity_threshold"]))
    xyz = torch.stack([g[0] for g in grids]).reshape(-1, 3)
    data = torch.stack([g[1] for g in grids]).reshape(-1, 5)
    valid = torch.stack([g[2] for g in grids]).reshape(-1) > 0.0
    z = xyz[:, 2]
    scale = O.true_div(z, z + 1e-7)
    pts = torch.stack([xyz[:, 0] * scale, xyz[:, 1] * scale, z], dim=-1)
    payload = torch.cat([data[:, 0:3], data[:, 4:5]], dim=-1)
    kept = torch.nonzero(valid)[:, 0]

    steps = np.linspace(0.0, 1.0, effect["num_steps"])
    if effect["dolly"]:
        scaling = zoom[1][2] / zoom[0][2]
        focals = [focal * (1.0 - s) + s * focal * scaling for s in steps]
    else:
        focals = [focal] * len(steps)
    steps_t = torch.as_tensor(steps.astype(np.float32), device=image.device)
    focals_t = torch.as_tensor(np.array(focals, np.float32),
                               device=image.device)
    shifts = _pose_shift(steps_t, focals_t, anchor, zoom, camera, w, h)
    poses = torch.cat([shifts, focals_t[:, None],
                       (focals_t * baseline)[:, None]], dim=1)
    return Cloud(pts[kept].contiguous(), payload[kept].contiguous(), poses)


@torch.inference_mode()
def frame(cloud: Cloud, index: int, height: int, width: int,
          config: dict) -> torch.Tensor:
    """The uint8 (H, W, 3) frame at pose ``index``."""
    with _tf32(False):
        return _frame(cloud, index, height, width, config)


def _frame(cloud, index, height, width, config) -> torch.Tensor:
    effect = config["effect"]
    zoom = zoom_windows(config["zoom"], width, height)
    pose = cloud.poses[index]
    render, weight = O.splat(cloud.xyz, cloud.payload, pose[:3], pose[3],
                             pose[4], height, width)
    filled = O.fill(render, render[..., 3:4] * (weight > 0.0),
                    effect["fill_march_steps"],
                    crop_region(height, width, zoom, effect["fill_roi"]))
    rgb = torch.floor(torch.clamp(filled[..., 0:3] * 255.0, 0.0, 255.0))
    max_cw = max(zoom[0][2], zoom[1][2])
    max_ch = max(zoom[0][3], zoom[1][3])
    patch = torch.clamp(torch.round(O.crop_rect_subpix(
        rgb, max_cw, max_ch, width / 2.0, height / 2.0)), 0.0, 255.0)
    out = O.resize_bilinear(patch[None], height, width)[0]
    return torch.clamp(torch.round(out), 0.0, 255.0).to(torch.uint8)


def video(nets, image: np.ndarray, config: dict, device,
          precision: str = "config") -> torch.Tensor:
    """The (T, H, W, 3) uint8 frames of ``image`` (H, W, 3) f32, on
    ``device``."""
    x = torch.as_tensor(np.asarray(image, np.float32), device=device)[None]
    h, w = x.shape[1], x.shape[2]
    cloud = front_end(nets, x, config, precision)
    return torch.stack([frame(cloud, i, h, w, config)
                        for i in range(cloud.poses.shape[0])])

