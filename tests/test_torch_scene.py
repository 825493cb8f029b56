"""kbe_torch's scene bootstrap against kbe_tpu's on the CPU, f32, with the
same numpy-seeded full-width weights through ``state_dict_from_flax``.
Tolerance: rtol/atol 1e-4 of each output's scale (three f32 nets whose
convolutions sum in another order); the anchor's pixel position is exact."""

import numpy as np
import torch

from kbe_tpu.pipeline.scene import LOAD_CAMERA as CAMERA_J
from kbe_tpu.pipeline.scene import load_scene as load_scene_j
from kbe_torch.data import demo_scene_image
from kbe_torch.pipeline import LOAD_CAMERA, load_scene
from kbe_torch.pipeline.kenburns import models_from_flax
from tests.test_torch_pipeline import _close, _pipeline_params


def test_load_scene_matches_jax():
    h, w = 64, 48
    params = _pipeline_params(h, w)
    image = (demo_scene_image(h, w) * 255.0).astype(np.uint8)
    want = load_scene_j({"semantics": params.semantics,
                         "disparity": params.disparity,
                         "refine": params.refine}, image)
    assert (LOAD_CAMERA.focal, LOAD_CAMERA.baseline) \
        == (CAMERA_J.focal, CAMERA_J.baseline) == (512.0, 40.0)

    models = models_from_flax(params, device="cpu")
    got = load_scene(models, image, device="cpu")
    assert set(got) == set(want)
    assert got["camera"] == LOAD_CAMERA
    assert got["points"].shape == (1, h * w, 3)
    for key in ("image", "disparity", "depth", "points",
                "unaltered_points"):
        _close(got[key], want[key])
    _close(got["anchor"][0], want["anchor"][0])
    assert [float(v) for v in got["anchor"][1:]] \
        == [float(v) for v in want["anchor"][1:]]
    # uint8 and float images are the same scene; a dict of nets works too
    again = load_scene({"semantics": models.semantics,
                        "disparity": models.disparity,
                        "refine": models.refine},
                       image.astype(np.float32) / 255.0, device="cpu")
    assert torch.equal(again["points"], got["points"])
