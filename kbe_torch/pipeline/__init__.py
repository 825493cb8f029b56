"""The inpainting flow, the end-to-end Ken Burns effect, auto-zoom and the
scene bootstrap. ``kbe_torch.pipeline.video`` (frame and video writers) is
imported on demand: it needs imageio or cv2."""

from kbe_torch.pipeline.autozoom import autozoom
from kbe_torch.pipeline.kenburns import KenBurnsPipeline, build_effect_fn
from kbe_torch.pipeline.scene import LOAD_CAMERA, load_scene

__all__ = ["KenBurnsPipeline", "LOAD_CAMERA", "autozoom", "build_effect_fn",
           "load_scene"]
