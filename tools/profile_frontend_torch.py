"""The port's front end by stage, on the bench scene: the counterpart of
``tools/profile_frontend.py``.

    python tools/profile_frontend_torch.py [--size 1024] [--steps 75]
                                           [--checkpoint find|none|PATH]

The front end of ``build_effect_fn`` (depth, the inpainting bootstrap, the
cloud and the poses) runs as a chain of stages, each the pipeline's own
calls on the tensors of the stage before (``front_end_stages``):

  - ``resize_to_max``; ``semantics`` and ``disparity`` at half resolution;
    ``refine`` at full resolution;
  - ``depth_grid``: normalise, depth, points and the ``depth_range``
    anchor (``kenburns.depth_grid``);
  - for each bootstrap step s in {0, 1}: ``inputs`` (the step's shift,
    ``inpaint_flow.flow_cloud`` and the two ``normalize_sample``s),
    ``context`` (``ContextNet``), ``splat68`` (``render_payload``: the six
    splat kernels at C = 68, the counterpart of ``kbe_tpu``'s banded-wide
    kernel), ``median`` (``coverage``: the binary median-5),
    ``inpaint`` (``inpaint_net``) and ``unproject`` (``flow_cloud`` of the
    result, un-shifted, appended as a grid);
  - ``prepare_scene``: ``kenburns.scene_of`` and ``effect_poses``.

For each stage: host ms (the minimum of ``reps`` runs, each ended by a
synchronise, with no profiler), device ms and launches (the device
intervals of one run under ``torch.profiler``: kernels and copies) and the
hand-written kernels it launches. The sum of the stages' host ms is set
against ``fn.front_end``'s own, timed the same way: the stages add a
synchronise each, which the front end does not have. The chain gives
``fn.front_end``'s state bit for bit (``tests/test_torch_layer_tools.py``).

``device`` defaults to ``cuda`` (raises where there is none unless
``device="cpu"``, where the device columns are null).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from kbe_torch.models.layers import normalize_sample  # noqa: E402
from kbe_torch.ops.resize import resize_to_max  # noqa: E402
from kbe_torch.pipeline.inpaint_flow import coverage, flow_cloud, \
    inpaint_net, render_payload  # noqa: E402
from kbe_torch.pipeline.kenburns import (EffectState, bootstrap_method,
                                         compute_pose_shift, depth_grid,
                                         effect_poses, inpaint_models,
                                         inpainted_grid,
                                         scene_of)  # noqa: E402
from tools.bench_scene_torch import (bench_scene, card_of, device_profile,
                                     kernel_launches, timeit,
                                     total)  # noqa: E402


def front_end_stages(scene):
    """[(name, stage)] of the front end of ``scene`` (``bench_scene``'s):
    each ``stage(values)`` reads the dict of the values made so far and
    returns the values it adds; it changes none. The chain's last stage
    adds ``state``, ``fn.front_end``'s ``EffectState``. Raises for an
    effect whose front end this chain does not follow (dolly, 2D, no
    inpainting, the dual-net or partial-conv nets)."""
    models, image = scene["models"], scene["image"]
    camera, zoom, effect = scene["camera"], scene["zoom"], scene["effect"]
    if (effect.dolly or effect.two_d or not effect.inpaint
            or models.inpaint_depth is not None
            or type(models.inpaint).__name__ != "Inpaint"):
        raise ValueError("the front-end stages follow the default effect "
                         "with the grid-net Inpaint")
    h, w = image.shape[1], image.shape[2]
    dev = image.device
    focal = camera.focal
    flow = inpaint_models(models, partial_inpainting=False)
    method = bootstrap_method(effect.splat_method)

    def depth(v):
        disparity, grid, anchor = depth_grid(image, v["refined"], camera,
                                             effect.depth_range_margin)
        return {"disparity": disparity, "grids": [grid], "anchor": anchor}

    stages = [
        ("resize_to_max",
         lambda v: {"resized": resize_to_max(image, max(h, w) // 2)}),
        ("semantics",
         lambda v: {"semantics": models.semantics(v["resized"])}),
        ("disparity", lambda v: {"disp_half": models.disparity(
            v["resized"], v["semantics"])}),
        ("refine", lambda v: {"refined": models.refine(
            image, v["disp_half"]).float()}),
        ("depth_grid", depth),
    ]

    def step_stages(s: float, k: int):
        def inputs(v):
            shift = compute_pose_shift(s, focal, v["anchor"], zoom, camera,
                                       w, h)
            shift = effect.inpaint_overshoot * shift
            _, points = flow_cloud(v["disparity"], camera, focal,
                                   effect.validity_threshold)
            image_n, img_stats = normalize_sample(image)
            disp_n, disp_stats = normalize_sample(v["disparity"])
            return {"shift": shift, "points": points, "image_n": image_n,
                    "img_stats": img_stats, "disp_n": disp_n,
                    "disp_stats": disp_stats}

        def unproject(v):
            out_image, out_disp, out_existing = v["inpainted"]
            out_depth, out_points = flow_cloud(out_disp, camera, focal,
                                               effect.validity_threshold)
            inp = {"image": out_image, "disparity": out_disp,
                   "depth": out_depth, "existing": out_existing,
                   "points": out_points - v["shift"]}
            return {"grids": v["grids"] + [inpainted_grid(inp, h, w)]}

        return [
            (f"step{k}/inputs", inputs),
            (f"step{k}/context", lambda v: {"context": flow.context(
                v["image_n"], v["disp_n"])}),
            (f"step{k}/splat68", lambda v: {"splat": render_payload(
                v["points"], v["shift"], v["image_n"], v["disp_n"],
                v["context"], camera, focal, method)}),
            (f"step{k}/median", lambda v: {"covered": coverage(
                *v["splat"])}),
            (f"step{k}/inpaint", lambda v: {"inpainted": inpaint_net(
                flow.net, *v["covered"], v["img_stats"],
                v["disp_stats"])}),
            (f"step{k}/unproject", unproject),
        ]

    for k, s in enumerate((0.0, 1.0)):
        stages += step_stages(s, k)

    def prepare(v):
        scene_, cloud_xyz = scene_of(v["grids"])
        poses = effect_poses(v["anchor"], zoom, camera, effect, w, h, dev)
        return {"state": EffectState(scene_, cloud_xyz, poses)}

    return stages + [("prepare_scene", prepare)]


def profile_frontend(size: int = 1024, steps: int = 75, checkpoint="find",
                     device=None, reps: int = 5, scene=None) -> dict:
    """The front end by stage as a dict (see the module's doc); ``scene``:
    a ``bench_scene`` to reuse, else one is built."""
    if scene is None:
        scene = bench_scene(size, steps, checkpoint, device=device,
                            front=False)
    dev = scene["device"]
    fn, models, image = scene["fn"], scene["models"], scene["image"]
    rows = []
    values = {}
    with torch.inference_mode():
        for name, stage in front_end_stages(scene):
            def call(stage=stage):
                return stage(values)

            host = timeit(call, dev, reps)
            dev_ms, launches = device_profile(call, dev)
            rows.append({"stage": name, "host_ms": host, "device_ms": dev_ms,
                         "launches": launches,
                         "kernels": kernel_launches(call)})
            values.update(call())

        def whole():
            return fn.front_end(models, image)

        front_ms = timeit(whole, dev, reps)
        front_dev, front_launches = device_profile(whole, dev)
    host_total = sum(r["host_ms"] for r in rows)
    return {
        "tool": "profile_frontend_torch", "size": scene["size"],
        **card_of(dev), "weights": scene["weights"],
        "mix": scene["mix"],
        "reps": reps, "stages": rows,
        "sum_host_ms": host_total, "front_end_ms": front_ms,
        "sum_over_front_end": host_total / front_ms,
        "sum_device_ms": total(r["device_ms"] for r in rows),
        "front_end_device_ms": front_dev,
        "sum_launches": total(r["launches"] for r in rows),
        "front_end_launches": front_launches,
        "state": values["state"],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=75)
    ap.add_argument("--checkpoint", default="find",
                    help="'find' (find_bench_weights), 'none' (seeded "
                         "random weights) or a pipeline .tar")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    checkpoint = None if args.checkpoint == "none" else args.checkpoint
    report = profile_frontend(args.size, args.steps, checkpoint,
                              reps=args.reps)
    del report["state"]
    for row in report["stages"]:
        print(json.dumps(row), flush=True)
    print(json.dumps({k: v for k, v in report.items() if k != "stages"}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
