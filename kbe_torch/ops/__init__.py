"""Geometry and image ops, the splat renderer and the disocclusion fill.

The splat and the fill have CUDA kernels (``csrc/``, built by ``_build``)
and plain PyTorch versions in the same modules; the kernels run for CUDA
tensors, the plain versions for CPU tensors.
"""
