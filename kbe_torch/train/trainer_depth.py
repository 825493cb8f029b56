"""The depth trainer: disparity estimation and refinement. Port of
``kbe_tpu/train/trainer_depth.py``.

  disparity: the frozen ``Semantics`` (no gradient) feeds ``Disparity``;
    the loss is gamma_ord * logrmse-ord + gamma_grad * grad, plus gamma_mask
    * the instance-mask flatness loss (kappa 0.5, per sample, summed over
    the batch) where the batch has ``instance_masks``, with the schedule
    ``depth_loss_schedule(step)``; clip 1.0, Adam at lr0 * gamma^count.
    With ``mask_loss='other'`` an auxiliary batch (``batch['imagenet']``)
    takes a second step, ``imagenet_mask_step``: 1e-4 * the mask loss at
    kappa 1.0, clip 0.1, on the same parameters, Adam moments and step
    count, so the count goes up twice in such an iteration.
  refine: the disparity net, frozen, estimates on the image resized to at
    most ``estimation_size`` (512) pixels; ``Refine`` is trained at full
    resolution on 1e-4 * L1-ord + grad. Only the refine state is
    checkpointed.

Validation every 500 iterations and once after the loop: the 7 depth
metrics, at 256 pixels in disparity mode, at full resolution after the
refinement.

Data parallel (``mesh``, a ``kbe_torch.parallel.DataMesh``): ``train``
takes each rank's part of the global batches and runs the disparity and
refine steps through ``data_parallel_step``, as ``kbe_tpu`` shards exactly
those: their losses reduce over the global batch (the instance-mask loss
is summed over it), their gradients are averaged over the ranks before the
clip, and a W-rank step is the 1-rank step on the joint batch. The 'other'
step runs replicated on every rank over the whole auxiliary batch, as JAX
runs it unsharded. The fresh states are broadcast from rank 0; validation
runs on rank 0 alone while the others wait, and only rank 0 writes metrics
and checkpoints.

On the card TF32 is off, as in the inpainting trainer; two
runs from one seed give equal bits under
``kbe_torch.device.deterministic_training``, which the training CLI turns
on.

A ``TrainState`` holds one net, its optimizer state and step count; the
steps update it in place and return it.

``make_optimizer`` is ``optax.chain(optax.clip_by_global_norm(clip),
optax.adam(lr0 * gamma ** count))`` written out, in optax's arithmetic:

  - the clip scales by ``max / norm`` only when ``norm >= max``, as
    ``(g / norm) * max`` (``torch.nn.utils.clip_grad_norm_`` scales by
    ``max / (norm + 1e-6)`` whenever it is called);
  - Adam's moments are ``(1 - b) * g^k + b * m``, its bias correction
    divides each moment by ``1 - b^t`` (t counted from 1), and the update
    is ``m_hat / (sqrt(v_hat) + eps)`` (``torch.optim.Adam`` folds the
    corrections into its step size and its denominator instead);
  - the learning rate is ``lr0 * gamma^count``, the count of updates made
    before this one, from 0.

Scalars are rounded to f32 where JAX computes them in f32. The state is a
dict ``{"count": int, "mu": [...], "nu": [...]}`` of tensors aligned with
the parameter list, which ``kbe_torch.train.checkpoint`` saves.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from kbe_torch.device import disable_tf32, resolve_device
from kbe_torch.models import Disparity, Refine, Semantics
from kbe_torch.models.init import apply_weights_init, flax_default_init
from kbe_torch.ops.resize import resize_to_max
from kbe_torch.parallel import (data_parallel_step, global_sum,
                                mean_over_ranks, replicate)
from kbe_torch.train.checkpoint import load_optimizer_state
from kbe_torch.train.losses import (compute_loss_grad, compute_loss_ord,
                                    compute_masked_grad_loss,
                                    depth_loss_schedule)
from kbe_torch.train.metrics import compute_depth_metrics
from kbe_torch.utils.convert import load_params
from kbe_torch.utils.logging import MetricsWriter, NullWriter

# iterations between checkpoints and validations
# (training/train_depth.py:121-126)
VALIDATE_EVERY = 500


def exp_decay_schedule(lr0: float, gamma: float) -> Callable:
    """count -> lr0 * gamma^count as an f32 0-d tensor."""
    def schedule(count: int) -> torch.Tensor:
        g = torch.tensor(gamma, dtype=torch.float32)
        return lr0 * torch.pow(g, torch.tensor(float(count)))
    return schedule


class Optimizer:
    """Global-norm clipping, then Adam with a scheduled learning rate."""

    def __init__(self, schedule: Callable, clip: float = 1.0, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.schedule = schedule
        self.clip = clip
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params: Sequence[torch.Tensor]) -> Dict:
        return {"count": 0,
                "mu": [torch.zeros_like(p) for p in params],
                "nu": [torch.zeros_like(p) for p in params]}

    @torch.no_grad()
    def step(self, params: Sequence[torch.Tensor],
             grads: Sequence[torch.Tensor], state: Dict) -> Dict:
        """Update ``params`` in place with ``grads``, as optax's ``update``
        and ``apply_updates``; returns the new state."""
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        keep = norm < self.clip  # no host sync: a select, as optax's
        grads = [torch.where(keep, g, (g / norm) * self.clip) for g in grads]
        count = state["count"] + 1
        f32 = lambda x: torch.tensor(x, dtype=torch.float32)
        bc1 = 1.0 - torch.pow(f32(self.b1), f32(float(count)))
        bc2 = 1.0 - torch.pow(f32(self.b2), f32(float(count)))
        lr = -1.0 * self.schedule(state["count"])
        mu, nu = [], []
        for p, g, m, v in zip(params, grads, state["mu"], state["nu"]):
            m = (1.0 - self.b1) * g + self.b1 * m
            v = (1.0 - self.b2) * (g * g) + self.b2 * v
            u = (m / bc1.to(g.device)) / (torch.sqrt(v / bc2.to(g.device))
                                          + self.eps)
            p.add_(lr.to(g.device) * u)
            mu.append(m)
            nu.append(v)
        return {"count": count, "mu": mu, "nu": nu}


def make_optimizer(lr0: float, gamma: float, clip: float = 1.0) -> Optimizer:
    return Optimizer(exp_decay_schedule(lr0, gamma), clip)


@dataclasses.dataclass
class TrainState:
    """One net, its optimizer state and its step count."""

    net: nn.Module
    opt_state: Dict
    step: int = 0

    def parameters(self) -> List[nn.Parameter]:
        return list(self.net.parameters())

    def state_dict(self) -> Dict:
        return {"net": self.net.state_dict(), "opt_state": self.opt_state,
                "step": self.step}

    def load_state_dict(self, saved: Dict) -> None:
        self.net.load_state_dict(saved["net"])
        load_optimizer_state(self.opt_state, saved["opt_state"])
        self.step = int(saved["step"])


def _grads(loss: torch.Tensor, params: List[nn.Parameter], mesh=None):
    """d loss / d params; a parameter the loss does not reach gets zeros,
    as ``jax.grad`` gives. With a mesh, averaged over its ranks."""
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return mean_over_ranks([torch.zeros_like(p) if g is None else g
                            for p, g in zip(params, grads)], mesh)


def _detached(metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach() for k, v in metrics.items()}


def to_device(batch, device) -> Dict:
    """A numpy batch (``zoom`` or ``imagenet`` a dict of arrays) as f32
    tensors."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, dict):
            out[k] = to_device(v, device)
        else:
            out[k] = torch.as_tensor(np.asarray(v, np.float32),
                                     device=device)
    return out


def _masked_grad_sum(disp, instance_masks, kappa: float,
                     mesh=None) -> torch.Tensor:
    """The instance-mask loss of each sample's disparity against its
    (M, h, w, 1) masks, summed over the batch (the global batch with a
    mesh)."""
    return global_sum(torch.sum(torch.stack([
        compute_masked_grad_loss(disp[i:i + 1], instance_masks[i], (1,),
                                 kappa)
        for i in range(disp.shape[0])])), mesh)


def _is_chief(mesh) -> bool:
    return mesh is None or mesh.is_chief


def _writer(logs_path: str, mesh):
    """Rank 0's metrics writer; the other ranks write nothing."""
    return MetricsWriter(logs_path) if _is_chief(mesh) else NullWriter()


def _parallel(step: Callable, mesh) -> Callable:
    return step if mesh is None else data_parallel_step(step, mesh)


def _on_chief(mesh, *fns: Callable) -> None:
    """Call ``fns`` on rank 0 (a checkpoint, a validation); the other ranks
    wait for it."""
    if _is_chief(mesh):
        for fn in fns:
            fn()
    if mesh is not None:
        mesh.barrier()


@dataclasses.dataclass
class TrainerDepth:
    """``hparams`` keys: lr_estimation, lr_refine, gamma_lr, n_epochs,
    model_to_train ('disparity' | 'refine' | 'both'), mask_loss ('none' |
    'same' | 'other'), estimation_size, init, save_name, and
    disparity_rows (a narrower lattice, for tests). ``semantics_params``:
    the frozen ``Semantics``, a Flax-shaped tree or the port's state dict
    (``load_params``), or None for fresh
    weights drawn as a Flax init from ``seed + 2``. ``seed`` seeds the
    fresh nets' draws; ``device`` defaults to ``cuda``, which raises where
    there is none, or to the device of ``mesh`` (a
    ``kbe_torch.parallel.DataMesh``: data-parallel training)."""

    hparams: Dict[str, Any]
    semantics_params: Any = None
    seed: int = 111
    device: Any = None
    logs_path: str = "runs/train_depth"
    checkpoint_dir: str = "checkpoints"
    mesh: Any = None

    def __post_init__(self):
        if self.mesh is not None and self.device is None:
            self.device = self.mesh.device
        self.device = resolve_device(self.device)
        if self.device.type == "cuda":
            disable_tf32()
        sem = Semantics()
        if self.semantics_params is None:
            flax_default_init(sem, torch.Generator().manual_seed(
                self.seed + 2))
        else:
            load_params(sem, self.semantics_params)
        self.semantics = sem.to(self.device).eval().requires_grad_(False)
        rows = self.hparams.get("disparity_rows")
        self._make_disparity = ((lambda: Disparity(rows=tuple(rows)))
                                if rows else Disparity)
        self.mode = self.hparams.get("model_to_train", "disparity")
        lr_d = self.hparams.get("lr_estimation", 1e-4)
        gamma = self.hparams.get("gamma_lr", 0.99995)
        self.tx_disparity: Optimizer = make_optimizer(lr_d, gamma)
        self.tx_refine: Optimizer = make_optimizer(
            self.hparams.get("lr_refine", 1e-6), gamma)
        self.tx_imagenet: Optimizer = make_optimizer(lr_d, gamma, clip=0.1)
        self.writer = _writer(self.logs_path, self.mesh)
        self.iter_nb = 0

    # ------------------------------------------------------------ states

    def _state(self, net: nn.Module, params: Any, seed: int,
               tx: Optimizer) -> TrainState:
        if params is not None:
            load_params(net, params)
        else:
            g = torch.Generator().manual_seed(seed)
            apply_weights_init(flax_default_init(net, g), g,
                               self.hparams.get("init", "xavier"))
        net = net.to(self.device)
        state = TrainState(net, tx.init(list(net.parameters())))
        return state if self.mesh is None else replicate(self.mesh, state)

    def init_state(self, image_shape, mode: Optional[str] = None,
                   disparity_params: Any = None, refine_params: Any = None):
        """The disparity ``TrainState``, and in 'refine' / 'both' mode the
        refine one beside it. ``*_params`` warm-start a net from a
        Flax-shaped tree or the port's state dict; fresh nets get a Flax init, then the conv
        selector ``hparams['init']`` (default xavier, gain 1.4).
        ``image_shape`` is kept for the JAX signature: the nets take any
        size."""
        del image_shape
        mode = mode or self.mode
        dstate = self._state(self._make_disparity(), disparity_params,
                             self.seed, self.tx_disparity)
        if mode == "disparity":
            return dstate
        rstate = self._state(Refine(), refine_params, self.seed + 1,
                             self.tx_refine)
        return dstate, rstate

    # ------------------------------------------------------------- steps

    def _disparity_forward(self, net: nn.Module, image) -> torch.Tensor:
        with torch.no_grad():
            sem = self.semantics(image)
        disp = net(image, sem)
        return torch.maximum(disp, torch.zeros_like(disp))

    def disparity_train_step(self, state: TrainState, batch: Dict,
                             mesh=None):
        """One estimation step. ``batch``: image (B, H, W, 3) in [-1, 1],
        disparity and mask at half its size, optional instance_masks
        (B, M, H/2, W/2, 1). ``mesh``: the rank's part of a data-parallel
        step (``data_parallel_step``)."""
        disp = self._disparity_forward(state.net, batch["image"])
        l_ord = compute_loss_ord(disp, batch["disparity"], batch["mask"],
                                 mode="logrmse", mesh=mesh)
        l_grad = compute_loss_grad(disp, batch["disparity"], batch["mask"],
                                   mesh)
        g_ord, g_grad, g_mask = depth_loss_schedule(state.step)
        loss = g_ord * l_ord + g_grad * l_grad
        l_mask = torch.zeros((), device=disp.device)
        if "instance_masks" in batch:
            l_mask = _masked_grad_sum(disp, batch["instance_masks"], 0.5,
                                      mesh)
            loss = loss + g_mask * l_mask
        params = state.parameters()
        state.opt_state = self.tx_disparity.step(
            params, _grads(loss, params, mesh), state.opt_state)
        state.step += 1
        return state, _detached({"ord": l_ord, "grad": l_grad,
                                 "mask": l_mask, "total": loss})

    def imagenet_mask_step(self, state: TrainState, batch: Dict):
        """The 'other' mask loss on an auxiliary batch (image and
        instance_masks): 1e-4 * the mask loss at kappa 1.0, clip 0.1."""
        disp = self._disparity_forward(state.net, batch["image"])
        loss = 0.0001 * _masked_grad_sum(disp, batch["instance_masks"], 1.0)
        params = state.parameters()
        state.opt_state = self.tx_imagenet.step(
            params, _grads(loss, params), state.opt_state)
        state.step += 1
        return state, {"mask": loss.detach()}

    def refine_train_step(self, dstate: TrainState, rstate: TrainState,
                          batch: Dict, mesh=None):
        """One refinement step: the frozen estimation at the resized image,
        the refinement at full resolution. ``mesh``: the rank's part of a
        data-parallel step."""
        with torch.no_grad():
            resized = resize_to_max(batch["image"],
                                    self.hparams.get("estimation_size", 512))
            disp_est = self._disparity_forward(dstate.net, resized)
        disp = rstate.net(batch["image"], disp_est)
        l_ord = compute_loss_ord(disp, batch["disparity"], batch["mask"],
                                 mode="L1", mesh=mesh)
        l_grad = compute_loss_grad(disp, batch["disparity"], batch["mask"],
                                   mesh)
        loss = 0.0001 * l_ord + l_grad
        params = rstate.parameters()
        rstate.opt_state = self.tx_refine.step(
            params, _grads(loss, params, mesh), rstate.opt_state)
        rstate.step += 1
        return rstate, _detached({"ord": l_ord, "grad": l_grad,
                                  "total": loss})

    # -------------------------------------------------------- validation

    @torch.no_grad()
    def validation_step(self, dstate: TrainState, batch: Dict,
                        rstate: Optional[TrainState] = None):
        resized = resize_to_max(batch["image"],
                                self.hparams.get("estimation_size", 512))
        disp = self._disparity_forward(dstate.net, resized)
        if rstate is not None:
            disp = rstate.net(batch["image"], disp)
            disp = torch.maximum(disp, torch.zeros_like(disp))
            gt, mask = batch["disparity"], batch["mask"]
        else:
            gt = resize_to_max(batch["disparity"], 256)
            mask = resize_to_max(batch["mask"], 256)
        return compute_depth_metrics(disp, gt, torch.clamp(mask, 0.0, 1.0))

    def validation(self, dstate: TrainState, val_iter,
                   rstate: Optional[TrainState] = None) -> Dict[str, float]:
        acc, n = None, 0
        for batch in val_iter:
            m = self.validation_step(dstate, to_device(batch, self.device),
                                     rstate)
            m = {k: float(v) for k, v in m.items()}
            acc = m if acc is None else {k: acc[k] + m[k] for k in m}
            n += 1
        if acc is None:
            return {}
        metrics = {k: v / n for k, v in acc.items()}
        self.writer.scalars(metrics, self.iter_nb, prefix="Validation/")
        return metrics

    # -------------------------------------------------------- host loop

    def train(self, train_iter: Iterable, val_iter_factory: Callable,
              image_shape, max_steps: Optional[int] = None,
              checkpoint_cb: Optional[Callable] = None,
              pretrained: Optional[Dict[str, Any]] = None,
              resume_state: Any = None, resume_step: int = 0):
        """The loop: every 500th iteration checkpoints and validates first,
        and the end validates once more (rank 0 alone, with a mesh; the
        batches of ``train_iter`` are then the rank's local parts, those of
        ``val_iter_factory()`` whole). ``pretrained``: optional
        {'disparity': tree, 'refine': tree} warm starts. ``resume_state``:
        a disparity ``TrainState``, or (disparity, refine) in refine mode,
        loaded from a checkpoint. Returns the state(s)."""
        pretrained = pretrained or {}
        self.iter_nb = resume_step
        checkpoint_cb = checkpoint_cb or (lambda state, step: None)
        if self.mode == "disparity":
            state = resume_state if resume_state is not None else \
                self.init_state(image_shape,
                                disparity_params=pretrained.get("disparity"))
            step = _parallel(self.disparity_train_step, self.mesh)
            for batch in train_iter:
                if max_steps is not None and self.iter_nb >= max_steps:
                    break
                if (self.iter_nb + 1) % VALIDATE_EVERY == 0:
                    _on_chief(self.mesh,
                              lambda: checkpoint_cb(state, self.iter_nb),
                              lambda: self.validation(state,
                                                      val_iter_factory()))
                aux = batch.pop("imagenet", None)
                state, metrics = step(
                    state, to_device(batch, self.device))
                self.writer.scalars({k: float(v) for k, v in metrics.items()},
                                    self.iter_nb, prefix="Estimation/")
                if self.hparams.get("mask_loss") == "other" \
                        and aux is not None:
                    state, m2 = self.imagenet_mask_step(
                        state, to_device(aux, self.device))
                    self.writer.scalar("Estimation/mask_other",
                                       float(m2["mask"]), self.iter_nb)
                self.iter_nb += 1
            _on_chief(self.mesh, lambda: self.validation(
                state, val_iter_factory()))
            self.writer.flush()
            return state

        if resume_state is not None:
            dstate, rstate = resume_state
        else:
            dstate, rstate = self.init_state(
                image_shape, self.mode,
                disparity_params=pretrained.get("disparity"),
                refine_params=pretrained.get("refine"))
        step = _parallel(self.refine_train_step, self.mesh)
        for batch in train_iter:
            if max_steps is not None and self.iter_nb >= max_steps:
                break
            if (self.iter_nb + 1) % VALIDATE_EVERY == 0:
                _on_chief(self.mesh,
                          lambda: checkpoint_cb(rstate, self.iter_nb),
                          lambda: self.validation(dstate, val_iter_factory(),
                                                  rstate))
            batch.pop("imagenet", None)
            rstate, metrics = step(
                dstate, rstate, to_device(batch, self.device))
            self.writer.scalars({k: float(v) for k, v in metrics.items()},
                                self.iter_nb, prefix="Refine/")
            self.iter_nb += 1
        _on_chief(self.mesh, lambda: self.validation(
            dstate, val_iter_factory(), rstate))
        self.writer.flush()
        return dstate, rstate
