"""PyTorch counterparts of the ``kbe_tpu`` nets on the effect's path."""

from kbe_torch.models.gridnet import ContextNet, Disparity, GridLattice, \
    Inpaint
from kbe_torch.models.layers import Basic, Downsample, PReLU, Upsample
from kbe_torch.models.refine import Refine
from kbe_torch.models.semantics import Semantics

__all__ = ["Basic", "ContextNet", "Disparity", "Downsample", "GridLattice",
           "Inpaint", "PReLU", "Refine", "Semantics", "Upsample"]
