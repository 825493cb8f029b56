"""Training: losses, metrics, view synthesis, data, checkpoints and the
inpainting trainer. Port of ``kbe_tpu/train`` (the depth trainer, the
evaluation modules and FID are still to come)."""
