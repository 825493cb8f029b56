"""PyTorch counterparts of the ``kbe_tpu`` nets: the effect's nets, the
discriminators and VGG16 of training, Inception-v3 of the FID, and the
Mask R-CNN of the depth mask loss."""

from kbe_torch.models.gridnet import ContextNet, Disparity, GridLattice, \
    Inpaint
from kbe_torch.models.layers import Basic, Downsample, PReLU, Upsample
from kbe_torch.models.partial_conv import PartialConv, PartialInpaint
from kbe_torch.models.refine import Refine, RefinePretrained
from kbe_torch.models.semantics import Semantics
from kbe_torch.models.discriminator import (
    Discriminator, MPDDiscriminator, MultiScaleDiscriminator,
    MultiScalePerceptualDiscriminator, PerceptualDiscriminator)
from kbe_torch.models.inception import InceptionV3Features
from kbe_torch.models.maskrcnn import MaskRCNN, load_maskrcnn, \
    maskrcnn_instance_masks
from kbe_torch.models.vgg import VGG16Features

__all__ = ["Basic", "ContextNet", "Discriminator", "Disparity",
           "Downsample", "GridLattice", "InceptionV3Features", "Inpaint",
           "MPDDiscriminator", "MaskRCNN", "MultiScaleDiscriminator",
           "MultiScalePerceptualDiscriminator", "PReLU", "PartialConv",
           "PartialInpaint", "PerceptualDiscriminator", "Refine",
           "RefinePretrained", "Semantics", "Upsample", "VGG16Features",
           "load_maskrcnn", "maskrcnn_instance_masks"]
