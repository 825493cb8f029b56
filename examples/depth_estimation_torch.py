"""Depth estimation analysis on the PyTorch/CUDA port: the flow of
``examples/depth_estimation.py`` through ``kbe_torch``'s ``DepthEval``.
Runs the depth front end over a dataset (or synthetic RGBD scenes), prints
the 7 depth metrics, and saves a side-by-side panel (input / estimation /
refined / ground truth).

The nets are fresh, from a seed, unless ``--checkpoint`` names a
checkpoint of ``cli/train_torch.py`` (estimation: the disparity net;
refinement: the refinement net). The synthetic scenes are 256x1024: the
refinement takes the estimation at a quarter of the image, which the
resize to a 512-pixel side gives at a 1024-pixel one.

Usage:
  python examples/depth_estimation_torch.py \\
      [--dataset name:path:focal:baseline] [--checkpoint file.tar] \\
      [--out runs/depth_eval.png] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np

SIZE = (256, 1024)


def _fresh_nets(seed: int = 0):
    """Port state dicts of fresh Semantics, Disparity and Refine nets, drawn
    as Flax inits from ``seed``."""
    import torch

    from kbe_torch.models import Disparity, Refine, Semantics
    from kbe_torch.models.init import flax_default_init

    nets = {"semantics": Semantics(), "disparity": Disparity(),
            "refine": Refine()}
    for i, net in enumerate(nets.values()):
        flax_default_init(net, torch.Generator().manual_seed(seed + i))
    return {k: net.state_dict() for k, net in nets.items()}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", action="append", default=[])
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--out", default="runs/depth_eval.png")
    p.add_argument("--batches", type=int, default=2)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from kbe_torch.config import CameraConfig
    from kbe_torch.ops.resize import resize_bilinear
    from kbe_torch.pipeline.video import write_image
    from kbe_torch.train.data import synthetic_batches
    from kbe_torch.train.eval_depth import DepthEval

    h, w = SIZE
    params = _fresh_nets()
    if args.checkpoint:
        from kbe_torch.train.checkpoint import load_checkpoint

        (state,), _ = load_checkpoint(args.checkpoint)
        refine = all(k.startswith("core.") for k in state["net"])
        params["refine" if refine else "disparity"] = state["net"]

    ev = DepthEval(params, device=args.device)

    if args.dataset:
        from cli.train_torch import parse_dataset
        from kbe_torch.train.data import KBEDataset

        ds = KBEDataset([parse_dataset(d) for d in args.dataset],
                        mode="eval")
        _, val_idx = ds.split()
        batches = list(ds.batches(val_idx, 1, shuffle=False, epochs=1))
    else:
        print("No dataset — using synthetic RGBD scenes.")
        batches = list(synthetic_batches(1, h, w, mode="eval",
                                         camera=CameraConfig(512.0, 74.0),
                                         steps=args.batches))

    metrics = ev.eval(iter(batches))
    print("Depth metrics:", {k: round(v, 4) for k, v in metrics.items()})

    views = ev.get_depths(batches[0])
    h, w = views["image"].shape[1:3]

    def gray(x):
        """A (1, h, w, 1) disparity as a (h, w, 3) [0, 1] image at the
        panel's size."""
        import torch

        x = torch.as_tensor(np.asarray(x, np.float32))
        x = resize_bilinear(x, h, w)[0, ..., 0].numpy()
        g = (x - x.min()) / (x.max() - x.min() + 1e-7)
        return np.stack([g] * 3, -1)

    panel = np.concatenate([
        views["image"][0], gray(views["estimation"]), gray(views["refined"]),
        gray(views["gt"])], axis=1)
    write_image(args.out, (np.clip(panel, 0, 1) * 255).astype(np.uint8))
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
