"""The inpainting flow and the end-to-end Ken Burns effect."""

from kbe_torch.pipeline.kenburns import KenBurnsPipeline, build_effect_fn

__all__ = ["KenBurnsPipeline", "build_effect_fn"]
