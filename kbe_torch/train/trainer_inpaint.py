"""The inpainting trainer: supervised and adversarial. Port of
``kbe_tpu/train/trainer_inpaint.py``.

  supervised: visibility masks of a random zoom (``masks_a_from_b``, no
    gradient), the partial-conv loss recipe plus ord and grad, weighted by
    ``LOSS_WEIGHTS``; clip 1.0 and Adam at lr0 * gamma^step.
  adversarial: warp view A to view B with the normalised image, disparity
    and context as the payload (``render_view_b``: the splat, which on the
    card runs forward and backward through the hand-written kernels),
    inpaint B, and judge it with ``MPDDiscriminator`` (spectral norm). G
    updates when (iter % stop_g) > pretrain_steps and iter % balance_steps
    == 0; its loss is 10 * the pixel losses + the adversarial loss with D in
    eval mode. D trains every iteration on 0.5 * (fake + real) with D in
    train mode, the fakes first, each pass updating its batch norms and
    spectral norms; its VGG16 is frozen (G still backpropagates through it).

Every 500th iteration of ``train`` checkpoints and validates first: the
supervised trainer reports PSNR and SSIM, the adversarial one the FID of
its inpainted B views against the real A views (``validation_adv``).

Data parallel (``mesh``, a ``kbe_torch.parallel.DataMesh``): ``train``
takes each rank's part of the global batches and runs the supervised and
adversarial steps through ``data_parallel_step``, as ``kbe_tpu`` shards
exactly those: the batch-wide counts of the losses and the discriminator's
batch statistics are the global batch's, the gradients of G and of D are
averaged over the ranks before each clip, and a W-rank step is the 1-rank
step on the joint batch. The fresh states are broadcast from rank 0;
validation and ``validation_adv`` run on rank 0 alone while the others
wait, and only rank 0 writes metrics and checkpoints.

Each step takes gradients with ``torch.autograd.grad`` with respect to the
parameters it updates, so G's loss leaves nothing in D's parameters, and D
is trained on the fakes of the G that made the G loss (before its update).
A D-only iteration runs the warp and the inpainting with no graph.
Parameters are f32; on the card TF32 is turned off, as in the effect;
under ``kbe_torch.device.deterministic_training``, which the training CLI
turns on, two runs from one seed give equal bits.

The state is held by ``InpaintState`` and ``DiscState`` (modules, optimizer
state, step), which the steps update in place and return.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterable, List, Optional

import numpy as np
import torch
import torch.nn as nn

from kbe_torch.config import CameraConfig
from kbe_torch.device import disable_tf32, resolve_device
from kbe_torch.models import ContextNet, Inpaint, PartialInpaint
from kbe_torch.models.discriminator import MPDDiscriminator, adversarial_loss
from kbe_torch.models.init import apply_weights_init, flax_default_init
from kbe_torch.models.layers import denormalize_sample, normalize_sample
from kbe_torch.models.vgg import VGG16Features
from kbe_torch.train.checkpoint import load_optimizer_state
from kbe_torch.train.losses import (compute_loss_grad, compute_loss_ord,
                                    inpainting_loss, inpainting_loss_adv,
                                    weighted_total)
from kbe_torch.train.metrics import compute_inpaint_metrics
from kbe_torch.parallel import replicate
from kbe_torch.train.trainer_depth import (Optimizer, _detached, _grads,
                                           _on_chief, _parallel,
                                           _writer, make_optimizer,
                                           to_device)
from kbe_torch.train.view_synthesis import masks_a_from_b, render_view_b
from kbe_torch.utils.convert import load_params

# iterations between checkpoints and validations
# (training/train_inpaint.py:332-418)
VALIDATE_EVERY = 500

# the reference's training camera
TRAIN_CAMERA = CameraConfig(focal=512.0, baseline=74.0)


@dataclasses.dataclass
class InpaintState:
    """G: the context net, the inpainting net, their optimizer state and
    step count."""

    context: ContextNet
    net: nn.Module
    opt_state: Dict
    step: int = 0

    def parameters(self) -> List[nn.Parameter]:
        return list(self.context.parameters()) + list(self.net.parameters())

    def state_dict(self) -> Dict:
        return {"context": self.context.state_dict(),
                "net": self.net.state_dict(), "opt_state": self.opt_state,
                "step": self.step}

    def load_state_dict(self, saved: Dict) -> None:
        self.context.load_state_dict(saved["context"])
        self.net.load_state_dict(saved["net"])
        load_optimizer_state(self.opt_state, saved["opt_state"])
        self.step = int(saved["step"])


@dataclasses.dataclass
class DiscState:
    """D: the discriminator (parameters, batch norm and spectral norm
    state), its optimizer state over the trainable parameters and step."""

    disc: MPDDiscriminator
    opt_state: Dict
    step: int = 0

    def parameters(self) -> List[nn.Parameter]:
        """The trainable parameters: all but the frozen VGG16's."""
        return [p for name, p in self.disc.named_parameters()
                if not name.startswith("core.vgg.")]

    def state_dict(self) -> Dict:
        return {"disc": self.disc.state_dict(), "opt_state": self.opt_state,
                "step": self.step}

    def load_state_dict(self, saved: Dict) -> None:
        self.disc.load_state_dict(saved["disc"])
        load_optimizer_state(self.opt_state, saved["opt_state"])
        self.step = int(saved["step"])


@dataclasses.dataclass
class TrainerInpaint:
    """``hparams`` keys: lr_inpaint, lr_D, gamma_lr, n_epochs, adversarial,
    model_to_train ('inpainting' | 'partial inpainting'), init, save_name,
    inpaint_rows (a narrower grid-net, for tests) and inception_params (a
    Flax-shaped Inception-v3 tree for the FID, else fresh weights from a
    seed). ``vgg``: the frozen
    ``VGG16Features`` of the supervised perceptual and style losses, or
    None (those terms are left out). ``seed`` seeds the fresh nets' draws;
    ``device`` defaults to ``cuda``, which raises where there is none, or
    to the device of ``mesh`` (a ``kbe_torch.parallel.DataMesh``:
    data-parallel training)."""

    hparams: Dict[str, Any]
    vgg: Optional[VGG16Features] = None
    camera: CameraConfig = TRAIN_CAMERA
    seed: int = 0
    device: Any = None
    logs_path: str = "runs/train_inpaint"
    mesh: Any = None

    # GAN balancing of the reference
    balance_steps: int = 5
    pretrain_steps: int = 1000
    stop_g: int = 10000

    def __post_init__(self):
        if self.mesh is not None and self.device is None:
            self.device = self.mesh.device
        self.device = resolve_device(self.device)
        if self.device.type == "cuda":
            disable_tf32()
        self.partial = self.hparams.get(
            "model_to_train", "inpainting") == "partial inpainting"
        rows = self.hparams.get("inpaint_rows")
        net_cls = PartialInpaint if self.partial else Inpaint
        self._make_net = ((lambda: net_cls(rows=tuple(rows))) if rows
                          else net_cls)
        if self.vgg is not None:
            self.vgg = self.vgg.to(self.device).requires_grad_(False)
        self.tx: Optimizer = make_optimizer(
            self.hparams.get("lr_inpaint", 1e-4),
            self.hparams.get("gamma_lr", 0.99997))
        self.tx_d: Optimizer = make_optimizer(
            self.hparams.get("lr_D", 1e-4),
            self.hparams.get("gamma_lr", 0.99997))
        self.writer = _writer(self.logs_path, self.mesh)
        self.iter_nb = 0
        self._fid = None

    # ------------------------------------------------------------ states

    def init_state(self, image_shape, pretrained_params: Any = None
                   ) -> InpaintState:
        """Fresh nets (a Flax init, then the conv selector
        ``hparams['init']``, default xavier gain 1.4), or the
        ``{'context', 'net'}`` of ``pretrained_params``, Flax-shaped trees
        or the port's state dicts. ``image_shape``
        is kept for the JAX signature: the nets take any size."""
        del image_shape
        context, net = ContextNet(), self._make_net()
        if pretrained_params is not None:
            load_params(context, pretrained_params["context"])
            load_params(net, pretrained_params["net"])
        else:
            g = torch.Generator().manual_seed(self.seed)
            init_type = self.hparams.get("init", "xavier")
            for m in (context, net):
                apply_weights_init(flax_default_init(m, g), g, init_type)
        context, net = context.to(self.device), net.to(self.device)
        state = InpaintState(context, net, None)
        state.opt_state = self.tx.init(state.parameters())
        return state if self.mesh is None else replicate(self.mesh, state)

    def init_disc_state(self, image_shape) -> DiscState:
        """A fresh ``MPDDiscriminator`` with spectral norm, drawn as a
        Flax init from its own seed; its VGG16 frozen."""
        del image_shape
        disc = MPDDiscriminator(spectral_norm=True)
        flax_default_init(disc, torch.Generator().manual_seed(self.seed + 7))
        disc = disc.to(self.device)
        disc.core.vgg.requires_grad_(False)
        state = DiscState(disc, None)
        state.opt_state = self.tx_d.init(state.parameters())
        return state if self.mesh is None else replicate(self.mesh, state)

    # ----------------------------------------------------------- shared

    def _inpaint(self, net, data, masks):
        out = net(data, masks)
        return out[0], out[1]  # PartialInpaint adds its mask

    def _forward(self, context, net, image01, disparity, masks):
        """Inpaint the masked image and disparity; returns denormalised
        (image, disparity): the image unclamped, the disparity >= 0."""
        img_n, img_stats = normalize_sample(image01 * masks)
        disp_n, disp_stats = normalize_sample(disparity * masks)
        ctx = context(img_n, disp_n)
        data = torch.cat([img_n, disp_n, ctx], dim=-1)
        out_i, out_d = self._inpaint(net, data, masks)
        disp = denormalize_sample(out_d, disp_stats)
        return (denormalize_sample(out_i, img_stats),
                torch.maximum(disp, torch.zeros_like(disp)))

    # -------------------------------------------------- supervised step

    def supervised_step(self, state: InpaintState, batch: Dict, mesh=None):
        """``batch``: image (B, H, W, 3) in [-1, 1], disparity, depth and
        the zoom windows, as tensors on the trainer's device. ``mesh``: the
        rank's part of a data-parallel step (``data_parallel_step``)."""
        with torch.no_grad():
            masks, _ = masks_a_from_b(batch["image"], batch["disparity"],
                                      batch["depth"], batch["zoom"],
                                      self.camera)
        image01 = (batch["image"] + 1.0) / 2.0
        out_img, out_disp = self._forward(state.context, state.net, image01,
                                          batch["disparity"], masks)
        loss = inpainting_loss(self.vgg, image01 * masks, masks, out_img,
                               image01)
        loss["ord"] = compute_loss_ord(out_disp, batch["disparity"], masks,
                                       mesh=mesh)
        loss["grad"] = compute_loss_grad(out_disp, batch["disparity"], masks,
                                         mesh)
        loss["total"] = weighted_total(loss)
        params = state.parameters()
        state.opt_state = self.tx.step(
            params, _grads(loss["total"], params, mesh), state.opt_state)
        state.step += 1
        return state, _detached(loss)

    # ------------------------------------------------- adversarial step

    def _adv_forward(self, context, net, batch) -> Dict[str, torch.Tensor]:
        """The A -> B warp and inpainting; everything the G and D losses
        need, denormalised."""
        image01 = (batch["image"] + 1.0) / 2.0
        img_n, img_stats = normalize_sample(image01)
        disp_n, disp_stats = normalize_sample(batch["disparity"])
        ctx = context(img_n, disp_n)
        render, mask_b, _, _ = render_view_b(
            img_n, disp_n, batch["depth"], batch["zoom"], self.camera,
            context=ctx)
        img_b_n, disp_b_n = render[..., 0:3], render[..., 3:4]
        data = torch.cat([img_b_n, disp_b_n, render[..., 4:]], dim=-1)
        out_i, out_d = self._inpaint(net, data, mask_b)
        disp = denormalize_sample(out_d, disp_stats)
        return {
            "inpaint_img": denormalize_sample(out_i, img_stats),
            "inpaint_disp": torch.maximum(disp, torch.zeros_like(disp)),
            "image_b": denormalize_sample(img_b_n, img_stats),
            "disp_b": denormalize_sample(disp_b_n, disp_stats),
            "mask_b": mask_b,
            "image_a": image01,
            "disp_a": batch["disparity"],
        }

    def adversarial_step(self, g_state: InpaintState, d_state: DiscState,
                         batch: Dict, do_g_update: bool, mesh=None):
        """One GAN iteration; returns (g_state, d_state, metrics). ``mesh``:
        the rank's part of a data-parallel step."""
        metrics = {}
        if do_g_update:
            out = self._adv_forward(g_state.context, g_state.net, batch)
            preds = d_state.disc(out["inpaint_img"], out["inpaint_disp"],
                                 train=False)
            loss_adv = adversarial_loss(preds, is_real=True)
            loss = inpainting_loss_adv(out["image_b"], out["mask_b"],
                                       out["inpaint_img"],
                                       out["inpaint_disp"], out["disp_b"],
                                       mesh=mesh)
            total = 10.0 * weighted_total(loss) + loss_adv
            loss.update(total_g=total, adv_g=loss_adv)
            params = g_state.parameters()
            g_state.opt_state = self.tx.step(
                params, _grads(total, params, mesh), g_state.opt_state)
            g_state.step += 1
            metrics.update(_detached(loss))
        else:
            with torch.no_grad():
                out = self._adv_forward(g_state.context, g_state.net, batch)
        fake_img = out["inpaint_img"].detach()
        fake_disp = out["inpaint_disp"].detach()
        disc = d_state.disc
        fake_preds = disc(fake_img, fake_disp, train=True, mesh=mesh)
        real_preds = disc(out["image_a"], out["disp_a"], train=True,
                          mesh=mesh)
        d_loss = 0.5 * (adversarial_loss(fake_preds, False)
                        + adversarial_loss(real_preds, True))
        params = d_state.parameters()
        d_state.opt_state = self.tx_d.step(
            params, _grads(d_loss, params, mesh), d_state.opt_state)
        d_state.step += 1
        metrics["loss_d"] = d_loss.detach()
        return g_state, d_state, metrics

    # -------------------------------------------------------- validation

    @torch.no_grad()
    def validation_step(self, state: InpaintState, batch: Dict):
        masks, _ = masks_a_from_b(batch["image"], batch["disparity"],
                                  batch["depth"], batch["zoom"], self.camera)
        image01 = (batch["image"] + 1.0) / 2.0
        out_img, out_disp = self._forward(state.context, state.net, image01,
                                          batch["disparity"], masks)
        return compute_inpaint_metrics(out_img, out_disp, image01,
                                       batch["disparity"])

    def validation(self, state: InpaintState, val_iter) -> Dict[str, float]:
        acc, n = None, 0
        for batch in val_iter:
            m = {k: float(v) for k, v in self.validation_step(
                state, to_device(batch, self.device)).items()}
            acc = m if acc is None else {k: acc[k] + m[k] for k in m}
            n += 1
        if not acc:
            return {}
        metrics = {k: v / n for k, v in acc.items()}
        self.writer.scalars(metrics, self.iter_nb,
                            prefix="Validation inpaint/")
        return metrics

    def validation_adv(self, state: InpaintState, val_iter) -> float:
        """FID between the adversarially inpainted view-B images (clipped
        to [0, 1]) and the real view-A images over the validation set;
        written as ``Validation inpaint/FID``. An empty set gives nan. The
        ``FID`` is built once, on the trainer's device."""
        from kbe_torch.train.fid import FID

        if self._fid is None:
            self._fid = FID(params=self.hparams.get("inception_params"),
                            device=self.device)
        reals, fakes = [], []
        with torch.no_grad():
            for batch in val_iter:
                out = self._adv_forward(state.context, state.net,
                                        to_device(batch, self.device))
                reals.append(out["image_a"].float().cpu().numpy())
                fakes.append(torch.clamp(out["inpaint_img"], 0.0, 1.0)
                             .float().cpu().numpy())
        if not reals:
            return float("nan")
        score = self._fid.fid(np.concatenate(reals), np.concatenate(fakes))
        self.writer.scalar("Validation inpaint/FID", float(score),
                           self.iter_nb)
        return float(score)

    # -------------------------------------------------------- host loop

    def _want_g_update(self) -> bool:
        return ((self.iter_nb % self.stop_g) > self.pretrain_steps
                and self.iter_nb % self.balance_steps == 0)

    def train(self, train_iter: Iterable, val_iter_factory: Callable,
              image_shape, max_steps: Optional[int] = None,
              checkpoint_cb: Optional[Callable] = None,
              pretrained_params: Any = None, resume_state: Any = None,
              resume_step: int = 0):
        """The loop: every 500th iteration checkpoints and validates first
        (rank 0 alone, with a mesh; the batches of ``train_iter`` are then
        the rank's local parts, those of ``val_iter_factory()`` whole).
        ``resume_state``: an ``InpaintState``, or (``InpaintState``,
        ``DiscState``) when adversarial, loaded from a checkpoint."""
        self.iter_nb = resume_step
        adversarial = bool(self.hparams.get("adversarial"))
        if adversarial:
            if resume_state is not None:
                state, d_state = resume_state
            else:
                state = self.init_state(image_shape, pretrained_params)
                d_state = self.init_disc_state(image_shape)
            ckpt = (state, d_state)
        else:
            state = (resume_state if resume_state is not None
                     else self.init_state(image_shape, pretrained_params))
            ckpt = state
        checkpoint_cb = checkpoint_cb or (lambda state, step: None)
        validate = self.validation_adv if adversarial else self.validation
        adversarial_step = _parallel(self.adversarial_step, self.mesh)
        supervised_step = _parallel(self.supervised_step, self.mesh)
        for batch in train_iter:
            if max_steps is not None and self.iter_nb >= max_steps:
                break
            if (self.iter_nb + 1) % VALIDATE_EVERY == 0:
                _on_chief(self.mesh,
                          lambda: checkpoint_cb(ckpt, self.iter_nb),
                          lambda: validate(state, val_iter_factory()))
            batch = to_device(batch, self.device)
            if adversarial:
                state, d_state, metrics = adversarial_step(
                    state, d_state, batch, self._want_g_update())
            else:
                state, metrics = supervised_step(state, batch)
            self.writer.scalars({k: float(v) for k, v in metrics.items()},
                                self.iter_nb, prefix="Inpaint/")
            self.iter_nb += 1
        self.writer.flush()
        return ckpt
