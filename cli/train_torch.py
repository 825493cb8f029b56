"""Training CLI of the PyTorch/CUDA port.

The flags of ``cli/train.py`` (the reference ``train.py``'s, plus
--dataset/--synthetic) and ``--device`` (default ``cuda``). The four
training modes: ``estimation`` (the disparity net, optionally with the
instance-mask loss, ``--mask-loss same|other``), ``refinement`` (the
refinement net behind the frozen disparity net of ``--model-path``),
``inpainting`` (supervised) and ``inpainting_ref`` (adversarial).
``--mask-source maskrcnn --maskrcnn-weights <torchvision .pth>`` takes a
``--dataset``'s instance masks from the port's Mask R-CNN on the card, as
the reference does; ``--synthetic`` keeps the generator's own masks.

``--data-parallel`` trains on every rank that torchrun starts (or its
environment describes: ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
``RANK``, ``LOCAL_RANK``), one process a card, over NCCL (gloo with
``--device cpu``); without that environment it trains on one rank. Rank r
computes on ``cuda:LOCAL_RANK``. ``--batch-size`` is the global batch and
must divide by the number of ranks; each rank loads its part of each batch,
and a step is the 1-rank step on the whole batch (``kbe_torch.parallel``).
Rank 0 alone validates and writes logs and checkpoints.

Usage:
  python cli/train_torch.py --training-mode estimation --synthetic \\
      --mask-loss same --max-steps 3 [--device cpu]
  torchrun --nproc_per_node=4 cli/train_torch.py --data-parallel \\
      --training-mode inpainting_ref --synthetic --batch-size 32

Checkpoints are ``<checkpoint-dir>/<save-name>-<step>.tar``, written every
500 iterations and when the run stops; ``--continue-training`` resumes the
latest one (nets, optimizer state and step). Refinement checkpoints hold
the refinement net alone.

On the card a run is reproducible: ``main`` turns on
``kbe_torch.device.deterministic_training`` (deterministic cuDNN
convolutions and upsampling backward, a fixed cuBLAS workspace) before the
trainer's first CUDA call.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

# the synthetic generator's (height, width) per trainer mode, as
# cli/train.py's
SYNTHETIC_SIZE = {"disparity": (384, 512), "refine": (768, 1024),
                  "inpainting": (384, 512)}


def parse_dataset(spec: str):
    name, path, focal, baseline = spec.split(":")
    return {"name": name, "path": path,
            "params": {"focal": float(focal), "baseline": float(baseline)}}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="kbe_torch training")
    p.add_argument("--training-mode", required=True,
                   choices=["estimation", "refinement", "inpainting",
                            "inpainting_ref"])
    p.add_argument("--mask-loss", default="none",
                   choices=["none", "same", "other"])
    p.add_argument("--mask-loss-dataset", default=None)
    p.add_argument("--mask-source", default="depth",
                   choices=["depth", "image", "maskrcnn"])
    p.add_argument("--maskrcnn-weights", default=None)
    p.add_argument("--n-epochs", type=int, default=50)
    p.add_argument("--lr-estimation", type=float, default=1e-4)
    p.add_argument("--lr-refinement", type=float, default=1e-5)
    p.add_argument("--lr-inpaint", type=float, default=1e-4)
    p.add_argument("--lr-discriminator", type=float, default=5e-5)
    p.add_argument("--save-name", default="3dkbe")
    p.add_argument("--model-path", default=None,
                   help="a .tar to warm-start from (a reference "
                        "checkpoint, or one the port's trainers wrote): the "
                        "disparity net in estimation and refinement (there "
                        "frozen), the inpainting nets in inpainting_ref "
                        "and inpainting")
    p.add_argument("--continue-training", action="store_true",
                   help="resume the latest checkpoint under "
                        "--checkpoint-dir/--save-name: nets, optimizer "
                        "state and step count")
    p.add_argument("--init", default="xavier",
                   choices=["xavier", "normal", "orthogonal", "he", "none"])
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--gamma-lr", type=float, default=0.99999)
    p.add_argument("--partial-conv", action="store_true")
    p.add_argument("--dataset", action="append", default=[],
                   help="name:path:focal:baseline (repeatable)")
    p.add_argument("--synthetic", action="store_true",
                   help="train on procedural RGBD data")
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--checkpoint-dir", default="checkpoints")
    p.add_argument("--logs-path", default="runs/train_0")
    p.add_argument("--data-parallel", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without a GPU) or 'cpu' "
                        "for the plain PyTorch path")
    return p


def resolve_mask_source(args, max_instances: int = 8,
                        infer_size: int = 512):
    """'depth' and 'image' pass through to KBEDataset's own segmenters;
    'maskrcnn' loads the converted torchvision weights of
    ``--maskrcnn-weights`` on ``--device`` and returns the instance-mask
    callable of ``cli/train.py::resolve_mask_source``: numpy (h, w, 3) in
    [0, 1] (or (1, h, w, 3)) -> (max_instances, h, w, 1) masks. The image
    is resized, aspect kept (JAX's antialiased bilinear), onto a zero-padded
    ``infer_size`` square canvas, the net's first ``max_instances`` masks
    are cropped to it and resized back (nearest)."""
    if args.mask_source != "maskrcnn":
        return args.mask_source
    if not args.maskrcnn_weights:
        raise SystemExit("--mask-source maskrcnn requires "
                         "--maskrcnn-weights <torchvision .pth>")
    import numpy as np
    import torch

    from kbe_torch.models.maskrcnn import load_maskrcnn, \
        maskrcnn_instance_masks
    from kbe_torch.ops.resize import resize_bilinear_antialias, \
        resize_nearest
    from kbe_torch.utils.reference_convert import convert_maskrcnn

    model = load_maskrcnn(convert_maskrcnn(args.maskrcnn_weights),
                          device=args.device)
    dev = model.rpn.conv.weight.device

    def source(image01, disparity=None):
        img = np.asarray(image01[0] if image01.ndim == 4 else image01,
                         np.float32)
        h, w = img.shape[0], img.shape[1]
        s = infer_size / max(h, w)
        rh, rw = max(1, round(h * s)), max(1, round(w * s))
        small = resize_bilinear_antialias(torch.from_numpy(img).to(dev),
                                          rh, rw)
        canvas = torch.zeros((infer_size, infer_size, 3), device=dev)
        canvas[:rh, :rw] = small
        masks = maskrcnn_instance_masks(model, canvas[None])[0]
        masks = masks[:max_instances, :rh, :rw]
        out = resize_nearest(masks, (masks.shape[0], h, w, 1)).cpu().numpy()
        return out[None] if image01.ndim == 4 else out

    return source


def make_data(args, mode: str, camera, mesh=None):
    """(train iterator, validation iterator factory, image size) of the
    trainer mode ``mode``: 'disparity', 'refine' or 'inpainting'. In
    'disparity' mode with a mask loss the batches carry instance masks
    (the synthetic generator's own, or ``--mask-source``'s through
    ``resolve_mask_source``). With a ``mesh`` the training batches are the
    rank's parts of the global ones; validation batches stay whole, and
    draw from a seed of their own."""
    import numpy as np

    from kbe_torch.train.data import KBEDataset, Prefetcher, \
        synthetic_batches

    shard = None if mesh is None else (mesh.rank, mesh.world_size)
    with_masks = args.mask_loss != "none" and mode == "disparity"
    if args.synthetic or not args.dataset:
        if not args.synthetic:
            print("No --dataset given; falling back to --synthetic data.")
        size = SYNTHETIC_SIZE[mode]
        train_iter = synthetic_batches(args.batch_size, *size, mode=mode,
                                       camera=camera, steps=args.max_steps,
                                       with_instance_masks=with_masks,
                                       shard=shard)
        val_factory = lambda: synthetic_batches(
            args.batch_size, *size, mode=mode, camera=camera, seed=1,
            steps=4)
        return train_iter, val_factory, size
    max_instances = 8  # KBEDataset's capacity, the mask source's too
    dataset = KBEDataset([parse_dataset(d) for d in args.dataset],
                         mode=mode, imagenet_path=args.mask_loss_dataset,
                         mask_source=(resolve_mask_source(
                             args, max_instances=max_instances)
                             if with_masks else None),
                         max_instances=max_instances)
    train_idx, val_idx = dataset.split()
    train_iter = Prefetcher(dataset.batches(train_idx, args.batch_size,
                                            epochs=args.n_epochs,
                                            shard=shard))
    # validation draws from generators of its own: the dataset's stream is
    # the training batches' alone, drawn in the prefetch thread, and alike on
    # every rank while rank 0 alone validates
    val_factory = lambda: dataset.batches(val_idx, args.batch_size,
                                          shuffle=False, epochs=1,
                                          rng=np.random.default_rng(1))
    size = dataset.load_item(0, np.random.default_rng(0))["image"].shape[:2]
    return train_iter, val_factory, size


DEPTH_MODES = {"estimation": "disparity", "refinement": "refine"}


def make_mesh(args):
    """``--data-parallel``'s mesh: the ranks of torchrun's environment, one
    process a device (NCCL, or gloo with ``--device cpu``), or one rank
    without it. ``--batch-size`` must divide by their number."""
    from kbe_torch.parallel import data_mesh, initialize_multihost

    initialize_multihost(device=args.device)
    mesh = data_mesh(device=args.device)
    if args.batch_size % mesh.world_size:
        raise SystemExit(f"--batch-size {args.batch_size} is the global batch"
                         f" and must divide by the {mesh.world_size} ranks")
    return mesh


def make_trainer(args, mesh=None, **kwargs):
    """The trainer of the parsed flags: ``TrainerDepth`` for estimation and
    refinement (fresh seeded ``Semantics`` weights; no dataset or trained
    weights are in the repo), ``TrainerInpaint`` for the inpainting modes,
    on ``mesh``'s device where there is one; ``kwargs`` go to it (the GAN
    balancing, for a short run)."""
    device = args.device if mesh is None else mesh.device
    if args.training_mode in DEPTH_MODES:
        from kbe_torch.train.trainer_depth import TrainerDepth

        return TrainerDepth(
            {"model_to_train": DEPTH_MODES[args.training_mode],
             "lr_estimation": args.lr_estimation,
             "lr_refine": args.lr_refinement,
             "gamma_lr": args.gamma_lr,
             "n_epochs": args.n_epochs,
             "mask_loss": args.mask_loss,
             "init": args.init,
             "save_name": args.save_name},
            device=device, logs_path=args.logs_path, mesh=mesh, **kwargs)
    from kbe_torch.train.trainer_inpaint import TrainerInpaint

    return TrainerInpaint(
        {"model_to_train": ("partial inpainting" if args.partial_conv
                            else "inpainting"),
         "lr_inpaint": args.lr_inpaint,
         "lr_D": args.lr_discriminator,
         "gamma_lr": args.gamma_lr,
         "n_epochs": args.n_epochs,
         "adversarial": args.training_mode == "inpainting_ref",
         "init": args.init,
         "save_name": args.save_name},
        device=device, logs_path=args.logs_path, mesh=mesh, **kwargs)


def _resume(args, trainer, size, pretrained):
    """(resume state, next iteration) of ``--continue-training``: the latest
    checkpoint loaded into a template of the trainer's state, or None."""
    from kbe_torch.train.checkpoint import latest_checkpoint, \
        load_checkpoint

    ck = latest_checkpoint(args.checkpoint_dir, args.save_name)
    if ck is None:
        print("--continue-training: no checkpoint found under "
              f"{args.checkpoint_dir}/{args.save_name}-*", file=sys.stderr)
        return None
    mode = args.training_mode
    if mode == "estimation":
        state, step = load_checkpoint(ck, trainer.init_state(size))
    elif mode == "refinement":
        dstate, rstate = trainer.init_state(
            size, "refine", disparity_params=pretrained.get("disparity"))
        rstate, step = load_checkpoint(ck, rstate)
        state = (dstate, rstate)
    else:
        state = trainer.init_state(size, pretrained)
        if mode == "inpainting_ref":
            state = (state, trainer.init_disc_state(size))
        state, step = load_checkpoint(ck, state)
    print(f"resuming from {ck} at iteration {int(step) + 1}")
    return state, int(step) + 1


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.mask_loss == "other" and args.mask_loss_dataset is None \
            and args.dataset and not args.synthetic:
        print("--mask-loss other requires --mask-loss-dataset (the "
              "synthetic generator supplies its own aux batch)",
              file=sys.stderr)
        return 1
    mode = args.training_mode
    if mode in ("refinement", "inpainting_ref") and args.model_path is None \
            and not args.continue_training:
        print(f"NOTE: --model-path not given for {mode}; starting from "
              "random init (the reference requires a pretrained net "
              "here).")

    from kbe_torch.device import deterministic_training, resolve_device
    from kbe_torch.train.checkpoint import load_pretrained_params, \
        save_checkpoint
    from kbe_torch.train.trainer_inpaint import TRAIN_CAMERA

    if resolve_device(args.device).type == "cuda":
        deterministic_training()  # in every rank, before CUDA starts
    mesh = make_mesh(args) if args.data_parallel else None
    trainer = make_trainer(args, mesh=mesh)
    if mode in DEPTH_MODES:
        from kbe_torch.config import CameraConfig

        train_iter, val_factory, size = make_data(
            args, DEPTH_MODES[mode], CameraConfig(512.0, 74.0), mesh)
        pretrained = {}
        if args.model_path:
            pretrained["disparity"] = load_pretrained_params(
                args.model_path, "disparity")
        run = lambda **kw: trainer.train(train_iter, val_factory, size,
                                         pretrained=pretrained, **kw)
    else:
        train_iter, val_factory, size = make_data(args, "inpainting",
                                                  TRAIN_CAMERA, mesh)
        pretrained = None
        if args.model_path:
            pretrained = load_pretrained_params(args.model_path, "inpaint")
        run = lambda **kw: trainer.train(train_iter, val_factory, size,
                                         pretrained_params=pretrained, **kw)
    resume_state, resume_step = None, 0
    if args.continue_training:
        resumed = _resume(args, trainer, size, pretrained)
        if resumed is None:
            return 1
        resume_state, resume_step = resumed
    ckpt_cb = lambda state, step: save_checkpoint(
        args.checkpoint_dir, args.save_name, state, step)
    try:
        final = run(max_steps=args.max_steps, checkpoint_cb=ckpt_cb,
                    resume_state=resume_state, resume_step=resume_step)
    finally:
        train_iter.close()  # a Prefetcher's thread, or a generator
    if mode == "refinement":  # only the refine state is checkpointed
        final = final[1]
    if trainer.iter_nb > resume_step and (mesh is None or mesh.is_chief):
        # the state after the last iteration run, resumed at the next one
        path = ckpt_cb(final, trainer.iter_nb - 1)
        print(f"saved {path}")
    trainer.writer.close()
    if mesh is not None and mesh.group is not None:
        import torch.distributed as dist

        mesh.barrier()
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
