"""Training CLI of the PyTorch/CUDA port.

The flags of ``cli/train.py`` (the reference ``train.py``'s, plus
--dataset/--synthetic) and ``--device`` (default ``cuda``). This slice of
the port trains inpainting: ``--training-mode inpainting`` (supervised) and
``inpainting_ref`` (adversarial). ``estimation`` and ``refinement``,
``--mask-source maskrcnn`` and ``--data-parallel`` raise, naming the
``ROADMAP.md`` Queue 1 item that brings them.

Usage:
  python cli/train_torch.py --training-mode inpainting_ref --synthetic \\
      --max-steps 3 [--device cpu]

Checkpoints are ``<checkpoint-dir>/<save-name>-<step>.tar``, written every
500 iterations and when the run stops; ``--continue-training`` resumes the
latest one (nets, optimizer state and step).
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
                   help="a reference torch .tar to warm-start the "
                        "inpainting nets from")
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


def make_data(args, mode: str, camera):
    from kbe_torch.train.data import KBEDataset, Prefetcher, \
        synthetic_batches

    if args.synthetic or not args.dataset:
        if not args.synthetic:
            print("No --dataset given; falling back to --synthetic data.")
        size = SYNTHETIC_SIZE[mode]
        train_iter = synthetic_batches(args.batch_size, *size, mode=mode,
                                       camera=camera, steps=args.max_steps)
        val_factory = lambda: synthetic_batches(
            args.batch_size, *size, mode=mode, camera=camera, seed=1,
            steps=4)
        return train_iter, val_factory, size
    dataset = KBEDataset([parse_dataset(d) for d in args.dataset],
                         mode=mode)
    train_idx, val_idx = dataset.split()
    train_iter = Prefetcher(dataset.batches(train_idx, args.batch_size,
                                            epochs=args.n_epochs))
    val_factory = lambda: dataset.batches(val_idx, args.batch_size,
                                          shuffle=False, epochs=1)
    size = dataset.load_item(0)["image"].shape[:2]
    return train_iter, val_factory, size


def make_trainer(args, **kwargs):
    """The ``TrainerInpaint`` of the parsed flags; ``kwargs`` go to it (the
    GAN balancing, for a short run)."""
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
        device=args.device, logs_path=args.logs_path, **kwargs)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.training_mode in ("estimation", "refinement"):
        raise NotImplementedError(
            f"--training-mode {args.training_mode} needs the port's "
            "TrainerDepth, the next slice (ROADMAP.md Queue 1 item 11)")
    if args.mask_source == "maskrcnn" and args.mask_loss != "none":
        raise NotImplementedError(
            "--mask-source maskrcnn needs the port of models/maskrcnn.py "
            "(ROADMAP.md Queue 1 item 12)")
    if args.data_parallel:
        raise NotImplementedError(
            "--data-parallel needs the port of kbe_tpu/parallel "
            "(ROADMAP.md Queue 1 item 13)")
    adversarial = args.training_mode == "inpainting_ref"
    if adversarial and args.model_path is None \
            and not args.continue_training:
        print("NOTE: --model-path not given for inpainting_ref; starting "
              "from random init (the reference requires a pretrained "
              "inpainting net here).")

    from kbe_torch.train.checkpoint import (latest_checkpoint,
                                            load_checkpoint,
                                            load_pretrained_params,
                                            save_checkpoint)
    from kbe_torch.train.trainer_inpaint import TRAIN_CAMERA

    trainer = make_trainer(args)
    train_iter, val_factory, size = make_data(args, "inpainting",
                                              TRAIN_CAMERA)
    pretrained = None
    if args.model_path:
        pretrained = load_pretrained_params(args.model_path, "inpaint")
    resume_state, resume_step = None, 0
    if args.continue_training:
        ck = latest_checkpoint(args.checkpoint_dir, args.save_name)
        if ck is None:
            print("--continue-training: no checkpoint found under "
                  f"{args.checkpoint_dir}/{args.save_name}-*",
                  file=sys.stderr)
            return 1
        tmpl = trainer.init_state(size, pretrained)
        if adversarial:
            tmpl = (tmpl, trainer.init_disc_state(size))
        resume_state, resume_step = load_checkpoint(ck, tmpl)
        resume_step = int(resume_step) + 1
        print(f"resuming from {ck} at iteration {resume_step}")
    ckpt_cb = lambda state, step: save_checkpoint(
        args.checkpoint_dir, args.save_name, state, step)
    final = trainer.train(train_iter, val_factory, size,
                          max_steps=args.max_steps, checkpoint_cb=ckpt_cb,
                          pretrained_params=pretrained,
                          resume_state=resume_state,
                          resume_step=resume_step)
    if trainer.iter_nb > resume_step:
        # the state after the last iteration run, resumed at the next one
        path = ckpt_cb(final, trainer.iter_nb - 1)
        print(f"saved {path}")
    trainer.writer.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
