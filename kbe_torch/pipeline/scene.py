"""Scene bootstrap helper. Port of ``kbe_tpu/pipeline/scene.py``.

An alternative bootstrap beside the effect: estimates and refines the
disparity of a raw numpy image under a focal = 512 / baseline = 40 camera,
builds the validity-masked point cloud, and returns what later stages (for
one, ``autozoom``) need.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from kbe_torch.config import CameraConfig
from kbe_torch.device import disable_tf32, resolve_device
from kbe_torch.ops.filters import validity_mask
from kbe_torch.ops.geometry import (depth_range, depth_to_points,
                                    disparity_to_depth)
from kbe_torch.ops.resize import resize_to_max

LOAD_CAMERA = CameraConfig(focal=512.0, baseline=40.0)


@torch.inference_mode()
def load_scene(models, numpy_image: np.ndarray,
               camera: CameraConfig = LOAD_CAMERA,
               device=None) -> Dict[str, Any]:
    """image (H, W, 3) uint8 or float -> scene dict (cloud, depth, anchor).

    ``models`` has ``semantics``, ``disparity`` and ``refine`` nets (a
    ``PipelineModels`` or a dict), already on ``device`` (default
    ``cuda``). Estimate -> refine -> normalise the disparity to the
    baseline -> depth -> validity-masked points and unaltered points.
    """
    dev = resolve_device(device)
    if dev.type == "cuda":
        disable_tf32()

    def net(name):
        return models[name] if isinstance(models, dict) \
            else getattr(models, name)

    img = torch.as_tensor(np.asarray(numpy_image, np.float32), device=dev)
    if img.max() > 1.5:
        img = img / 255.0
    image = img[None]
    h, w = image.shape[1], image.shape[2]

    resized = resize_to_max(image, max(h, w) // 2)
    sem = net("semantics")(resized)
    disparity = net("disparity")(resized, sem)
    disparity = net("refine")(image, disparity).float()
    disparity = disparity / disparity.max() * camera.baseline

    depth = disparity_to_depth(disparity, camera.focal, camera.baseline)
    valid = validity_mask(disparity)
    points = depth_to_points((depth * valid)[..., 0], camera.focal)
    unaltered = depth_to_points(depth[..., 0], camera.focal)
    anchor = depth_range(depth[0, ..., 0], 128)

    return {
        "image": image,
        "disparity": disparity,
        "depth": depth,
        "points": points.reshape(1, h * w, 3),
        "unaltered_points": unaltered.reshape(1, h * w, 3),
        "anchor": anchor,
        "camera": camera,
    }
