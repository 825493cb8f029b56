"""Bench and demo weights for the PyTorch/CUDA port: ``kbe_tpu``'s recipe
(``tools/make_bench_weights.py``) through the port's trainers.

A seeded, deterministic run of brief supervised training on the procedural
RGBD generator (``kbe_torch.train.data.synthetic_batches``), saved as one
pipeline checkpoint, ``<out_dir>/pipeline-<steps>.tar``, which
``kbe_torch.train.checkpoint.find_bench_weights`` finds and
``load_pipeline_params`` (or ``cli/kbe_torch.py --checkpoint``) loads:

  1. depth estimation: ``TrainerDepth`` ('both'), disparity steps at
     384x512, batch 2, behind a seeded frozen ``Semantics``;
  2. refinement at 768x1024, batch 1, behind the frozen estimation;
  3. inpainting: ``TrainerInpaint``, supervised steps at 384x512, batch 1.

The stages, hyper-parameters, sizes, batches, seeds and cameras are
``kbe_tpu``'s; the nets' initial draws are torch-seeded, so these are the
same recipe, not the same weights. Random-weight nets give noisy depth,
which leaves the splat and the fill more holes than trained depth does;
trained nets give the piecewise-smooth depth a real photograph's would.

On the card the run is deterministic (``deterministic_training``): two runs
give equal bits. Usage (on the card; 415 MiB of weights, git-ignored):

    python tools/make_bench_weights_torch.py

Environment: KBE_BW_STEPS_DEPTH (300), KBE_BW_STEPS_REFINE (150),
KBE_BW_STEPS_INPAINT (300), KBE_BW_DIR (.bench_weights).
"""

from __future__ import annotations

import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DEPTH_HPARAMS = {"model_to_train": "both", "lr_estimation": 1e-4,
                 "lr_refine": 1e-5, "gamma_lr": 0.99995, "init": "xavier",
                 "estimation_size": 512}
INPAINT_HPARAMS = {"model_to_train": "inpainting", "lr_inpaint": 1e-4,
                   "gamma_lr": 0.99997, "init": "xavier"}
DEPTH_CAMERA = (512.0, 74.0)    # (focal, baseline) of the depth stages
# stage: (batch, mode of synthetic_batches, its seed)
STAGES = {"depth": (2, "disparity", 2), "refine": (1, "refine", 3),
          "inpaint": (1, "inpainting", 4)}
SIZES = {"depth": (384, 512), "refine": (768, 1024), "inpaint": (384, 512)}
LOG_EVERY = 50


def _stage(name, steps, batches, step_fn, device, log):
    """Run ``step_fn(batch) -> metrics`` over ``batches``; the stage's
    wall seconds, ms a step and losses (one a step, as floats)."""
    import torch

    totals = []
    t0 = time.perf_counter()
    for i, batch in enumerate(batches):
        totals.append(step_fn(batch)["total"])
        if i % LOG_EVERY == 0:
            log(f"[{name} {i}/{steps}] total={float(totals[-1]):.4f} "
                f"({time.perf_counter() - t0:.0f}s)")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    return {"steps": len(totals), "wall_s": wall,
            "ms_a_step": wall / max(1, len(totals)) * 1e3,
            "losses": [float(t) for t in totals]}


def make_bench_weights(steps_depth: int = 300, steps_refine: int = 150,
                       steps_inpaint: int = 300,
                       out_dir: str = os.path.join(REPO, ".bench_weights"),
                       device=None, sizes=None, log=print):
    """Train the recipe and save it; returns (checkpoint path, report).

    ``device`` defaults to ``cuda`` (raises where there is no GPU);
    ``sizes`` overrides ``SIZES`` per stage (a test's small schedule).
    The report holds each stage's steps, wall seconds, ms a step and
    losses."""
    import torch

    from kbe_torch.config import CameraConfig
    from kbe_torch.device import deterministic_training, resolve_device
    from kbe_torch.pipeline.kenburns import PipelineModels
    from kbe_torch.train.checkpoint import save_pipeline
    from kbe_torch.train.data import synthetic_batches
    from kbe_torch.train.trainer_depth import TrainerDepth, to_device
    from kbe_torch.train.trainer_inpaint import TRAIN_CAMERA, TrainerInpaint

    dev = resolve_device(device)
    sizes = {**SIZES, **(sizes or {})}
    camera = CameraConfig(*DEPTH_CAMERA)
    was_deterministic = torch.are_deterministic_algorithms_enabled()
    if dev.type == "cuda":
        deterministic_training()

    def batches(stage, steps, cam):
        batch, mode, seed = STAGES[stage]
        for b in synthetic_batches(batch, *sizes[stage], mode=mode,
                                   camera=cam, seed=seed, steps=steps):
            yield to_device(b, dev)

    report = {}
    try:
        with tempfile.TemporaryDirectory() as logs:
            trainer = TrainerDepth(dict(DEPTH_HPARAMS), device=dev,
                                   logs_path=os.path.join(logs, "depth"))
            dstate, rstate = trainer.init_state(sizes["depth"], "refine")

            def depth_step(b):
                return trainer.disparity_train_step(dstate, b)[1]

            def refine_step(b):
                return trainer.refine_train_step(dstate, rstate, b)[1]

            report["depth"] = _stage("depth", steps_depth,
                                     batches("depth", steps_depth, camera),
                                     depth_step, dev, log)
            report["refine"] = _stage(
                "refine", steps_refine,
                batches("refine", steps_refine, camera), refine_step, dev,
                log)

            itrainer = TrainerInpaint(dict(INPAINT_HPARAMS),
                                      camera=TRAIN_CAMERA, device=dev,
                                      logs_path=os.path.join(logs, "inp"))
            istate = itrainer.init_state(sizes["inpaint"])

            def inpaint_step(b):
                return itrainer.supervised_step(istate, b)[1]

            report["inpaint"] = _stage(
                "inpaint", steps_inpaint,
                batches("inpaint", steps_inpaint, TRAIN_CAMERA),
                inpaint_step, dev, log)
            trainer.writer.close()
            itrainer.writer.close()
    finally:
        if dev.type == "cuda":
            torch.use_deterministic_algorithms(was_deterministic)
    # the bench pipeline runs one shared inpainting net (the reference's
    # default: --inpaint-depth is optional)
    models = PipelineModels(semantics=trainer.semantics,
                            disparity=dstate.net, refine=rstate.net,
                            context=istate.context, inpaint=istate.net)
    path = save_pipeline(out_dir, models,
                         steps_depth + steps_refine + steps_inpaint)
    log(f"saved {path}")
    return path, report


def main() -> int:
    import json

    import torch

    from kbe_torch.device import card_name

    path, report = make_bench_weights(
        int(os.environ.get("KBE_BW_STEPS_DEPTH", "300")),
        int(os.environ.get("KBE_BW_STEPS_REFINE", "150")),
        int(os.environ.get("KBE_BW_STEPS_INPAINT", "300")),
        os.environ.get("KBE_BW_DIR", os.path.join(REPO, ".bench_weights")))
    for stage in report.values():
        losses = stage.pop("losses")
        stage["first_loss"], stage["last_loss"] = losses[0], losses[-1]
    print(json.dumps({"checkpoint": path,
                      "device": torch.cuda.get_device_name(0),
                      "nvidia_smi": card_name(), "stages": report}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
