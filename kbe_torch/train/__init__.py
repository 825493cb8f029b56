"""Training and evaluation: losses, metrics, view synthesis, data,
checkpoints, the depth and inpainting trainers, FID and the evaluation
modules. Port of ``kbe_tpu/train``."""

from kbe_torch.train.losses import (
    InpaintingLossConfig, LOSS_WEIGHTS, compute_loss_grad, compute_loss_ord,
    compute_masked_grad_loss, depth_loss_schedule, inpainting_loss,
    inpainting_loss_adv, joint_edge_loss)
from kbe_torch.train.metrics import (compute_depth_metrics,
                                     compute_inpaint_metrics, psnr)
from kbe_torch.train.fid import FID
from kbe_torch.train.trainer_depth import TrainerDepth
from kbe_torch.train.trainer_inpaint import TrainerInpaint
from kbe_torch.train.eval_depth import DepthEval
from kbe_torch.train.eval_inpaint import InpaintEval, generate_view_c

__all__ = ["DepthEval", "FID", "InpaintEval", "InpaintingLossConfig",
           "LOSS_WEIGHTS", "TrainerDepth", "TrainerInpaint",
           "compute_depth_metrics", "compute_inpaint_metrics",
           "compute_loss_grad", "compute_loss_ord",
           "compute_masked_grad_loss", "depth_loss_schedule",
           "generate_view_c", "inpainting_loss", "inpainting_loss_adv",
           "joint_edge_loss", "psnr"]
