#!/usr/bin/env python3
"""Time the splat's front half, its accumulation, the fill, the frame's
finish, the greedy NMS, the splat's gradient and the partial conv's mask
side of a kbe_torch tree on the card.

    python tools/kernel_times.py [--tree DIR] [--sets 5] [--reps 20]
        [--only front,accumulate,fill,finish,nms,grad,pconv]

Imports ``kbe_torch`` from ``DIR`` (default: this checkout), so one call
can time two versions of the kernels in turns on one card, for example
this tree and an unpacked parent commit. The front half (the z-buffer's
fill, zee and degrid) is ``front_cuda`` where the tree has it (one call,
which also zeroes the count pass's counts, as a render makes it), else
``zee_cuda`` then ``degrid_cuda``. Each tree gets what its own frame loop
splats: the valid points alone and no mask where its scene keeps them
(``kept_xyz``), else the whole grids and their mask. The accumulation,
the fill, the NMS and the gradient use the wrappers the versions share:
``accumulate_cuda``, ``fill_cuda``, ``nms.keep_cuda(boxes, scores,
iou_thresh, tag)`` and ``splat.grad_cuda(xyz, valid, pose, zee, existing,
grad, h, w)``. The inputs are those of ``chip_smoke.py`` (its
``make_cloud`` and its phases' helpers, the same seeds):
  (a)  C=4, the frame loop's 3-grid 1024^2 cloud at a frame pose;
  (a2) C=4, one grid at dolly's focal;
  (b)  C=68, the bootstrap's one grid, no mask where the tree takes none;
  (c3) C=3, autozoom's shape: one raw grid, the shift in the pose, no
       mask where the tree takes none;
  (p)  C=4, 65,536 points of a 1024^2 grid on one pixel (accumulation);
  (c)  the fill of the (a) render, K=128, the default ROI;
  (c2) the fill of the (a2) render, dolly's ROI (open disocclusions);
  (k)  the finish of the (c) fill's frame, the default move's crop, and
       (k2) of the (c2) fill's frame, dolly's crop (``finish_cuda``; null
       for a tree that has no finish kernel);
  (w)  the NMS of (w)'s 512^2 forward: the RPN's five sets of 512 at 0.7
       and the box set of 256 at 0.5, sorted and padded as the model
       hands them over (the synthetic item's canvas, seeded weights);
  (t)  the gradient at (t)'s shape: the third adversarial batch's item 0
       at 384x512 (196,608 points, no mask), C=68, the upstream gradient
       of ``grad_check``; and the same upstream times 2^100, whose
       quotients all take the IEEE division (outside the
       multiply-and-FMA route's range, where the tree has one);
  (m)  the partial conv's mask side at the inpainting net's stem (68 -> 32
       channels, 1024^2) and (m3) at its row 3 (256 channels, 128^2), bf16
       channels-last, a seeded mask with a hole (``pconv.mask_side_cuda``;
       null for a tree that has no such kernel), beside the plain chain.
Prints the card's name and power limit, then one JSON line: the median over
``--sets`` of the mean ms of ``--reps`` calls (CUDA events); for the front
half, the finish, the NMS and the gradient also, from ``torch.profiler`` over
``--reps`` calls, the device ms a call in its own kernels; for the front
half its kernels apart and its device span (from its first kernel's start
to its last one's end, the median over the calls); and whether the
accumulation was bit-equal over two runs.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def device_span_ms(cs, fn, reps: int) -> float:
    """The median device span of a call of ``fn``: its first kernel's start
    to its last one's end, over ``reps`` calls (``chip_smoke``'s
    ``device_events``)."""
    spans = sorted((start, end) for _, start, end in
                   cs.device_events(fn, reps))
    per = len(spans) // reps
    return statistics.median(
        max(e for _, e in spans[k:k + per]) - spans[k][0]
        for k in range(0, len(spans), per)) / 1e3


def splat_times(cs, args, only, med):
    """The front half, the accumulation, the fill and the finish (see
    above)."""
    import importlib.util

    import torch
    from kbe_torch.config import EffectConfig, ZoomSettings
    from kbe_torch.ops import discfill as D
    from kbe_torch.ops import splat as S
    from kbe_torch.pipeline.kenburns import fill_roi_of

    has_finish = importlib.util.find_spec("kbe_torch.ops.finish") is not None
    size = cs.SIZE
    shift = torch.tensor([-9.5, 6.25, -30.0])
    xyz, payload, valid = cs.make_cloud(3, 4, seed=1, shift=shift)
    scene = S.prepare_scene(xyz, payload, valid)
    pose = S.make_pose(shift.cuda(), cs.FOCAL, cs.BASELINE)
    xyz1, payload1, valid1 = cs.make_cloud(1, 4, seed=3, shift=shift)
    scene1 = S.prepare_scene(xyz1, payload1, valid1)
    pose1 = S.make_pose(shift.cuda(), cs.FOCAL * 1.21875, cs.BASELINE)
    xyz68, payload68, _ = cs.make_cloud(1, 68, seed=2, shift=shift)
    pts68 = (xyz68.reshape(-1, 3) + shift.cuda()).contiguous()
    zero = S.make_pose(torch.zeros(3, device="cuda"), cs.FOCAL, cs.BASELINE)

    # (p) as chip_smoke.py's pathological_phase builds it
    xyzp, payloadp, validp = cs.make_cloud(1, 4, seed=5,
                                           shift=torch.zeros(3))
    g = torch.Generator().manual_seed(6)
    ptsp = xyzp.reshape(-1, 3).clone()
    pile = torch.randperm(size * size, generator=g)[:65536].cuda()
    z = 300.0 + torch.rand(65536, generator=g).cuda()
    du, dv = (0.1 + 0.8 * torch.rand(2, 65536, generator=g)).cuda()
    ptsp[pile, 0] = (700.0 + du - size / 2 + 0.5) * z / cs.FOCAL
    ptsp[pile, 1] = (400.0 + dv - size / 2 + 0.5) * z / cs.FOCAL
    ptsp[pile, 2] = z

    kept = hasattr(scene, "kept_xyz")

    def frame_cloud(sc):
        if kept:
            return sc.kept_xyz, sc.kept_payload, None
        return sc.xyz, sc.payload, sc.valid

    def mask(n):
        return None if kept else torch.ones(n, device="cuda")

    xyz3, payload3, _ = cs.make_cloud(1, 3, seed=4, shift=shift)
    cases = {
        "c4": frame_cloud(scene) + (pose,),
        "c4_dolly": frame_cloud(scene1) + (pose1,),
        "c68": (pts68, payload68.reshape(-1, 68).contiguous(),
                mask(size * size), zero),
        "c3": (xyz3.reshape(-1, 3).contiguous(),
               payload3.reshape(-1, 3).contiguous(), mask(size * size),
               pose)}
    counts = torch.empty(size * size, dtype=torch.int32, device="cuda")

    def front(x, v, q, c):
        if hasattr(S, "front_cuda"):
            return S.front_cuda(x, v, q, size, size, c, counts=counts)[1]
        return S.degrid_cuda(S.zee_cuda(x, v, q, size, size, c), size,
                             size, c)

    def short(name):
        return name.replace("(anonymous namespace)::", "").split("(")[0][:60]

    front_ms, front_dev, front_span, front_kernels = {}, {}, {}, {}
    for name, (x, p, v, q) in cases.items() if "front" in only else ():
        c = p.shape[1]
        front_ms[name] = med(lambda: front(x, v, q, c))
        front_dev[name] = statistics.median(
            cs.device_ms(lambda: front(x, v, q, c), args.reps, ("splat",))[1]
            for _ in range(args.sets))
        front_kernels[name] = {
            short(k): t for k, t in cs.device_times(
                lambda: front(x, v, q, c), args.reps).items()}
        front_span[name] = device_span_ms(
            cs, lambda: front(x, v, q, c), args.reps)

    times, equal = {}, {}
    for name, (x, p, v, q) in () if "accumulate" not in only else (
            ("accumulate_c4", cases["c4"]),
            ("accumulate_c4_dolly", cases["c4_dolly"]),
            ("accumulate_c68", cases["c68"]),
            ("accumulate_c4_pathological", (ptsp.contiguous(),
                                            payloadp.reshape(-1, 4)
                                            .contiguous(),
                                            validp.reshape(-1).contiguous(),
                                            zero))):
        deg = front(x, v, q, p.shape[1])
        times[name] = med(lambda: S.accumulate_cuda(x, v, p, q, deg, size,
                                                    size))
        equal[name] = bool(torch.equal(
            S.accumulate_cuda(x, v, p, q, deg, size, size),
            S.accumulate_cuda(x, v, p, q, deg, size, size)))
    finish = {}
    for name, sc, q, zoom, effect in () if not only & {"fill", "finish"} \
            else (("fill", scene, pose, ZoomSettings.default_3d(size, size),
                   EffectConfig()),
                  ("fill_dolly", scene1, pose1,
                   ZoomSettings.default_dolly(size, size),
                   EffectConfig(dolly=True))):
        render, existing = S.render_posed(sc, q, size, size)
        depth = (render[..., 3:4] * (existing > 0.0)).contiguous()
        render = render.contiguous()
        roi = fill_roi_of(size, size, zoom, effect)
        if "fill" in only:
            times[name] = med(lambda: D.fill_cuda(render, depth, 128, roi))
        if "finish" in only and has_finish:
            finish[name.replace("fill", "finish")] = finish_row(
                cs, args, med, D.fill_cuda(render, depth, 128, roi), zoom)
    out = {"front_ms": front_ms, "front_device_ms": front_dev,
           "front_device_span_ms": front_span,
           "front_kernel_device_ms": front_kernels, "ms": times,
           "accumulate_run_to_run_equal": equal}
    if "finish" in only:
        # a tree without the kernel finishes with the plain chain's launches
        out["finish"] = finish if has_finish else None
    if "front" in only:
        out["front"] = ("front_cuda" if hasattr(S, "front_cuda")
                        else "zee_cuda + degrid_cuda")
    return out


def finish_row(cs, args, med, filled, zoom) -> dict:
    """Kernel ``finish`` on a filled frame under ``zoom``'s crop, checked
    against the plain chain: call ms, device ms and its bound (the crop's
    window read once, 12 B a pixel, and the frame written, 3 B a pixel)."""
    import torch
    from kbe_torch.ops import finish as F
    from kbe_torch.pipeline.kenburns import frame_taps

    h, w = filled.shape[0], filled.shape[1]
    taps = frame_taps(h, w, zoom, filled.device)
    plan = F.finish_plan(taps)
    out = torch.empty((h, w, 3), dtype=torch.uint8, device=filled.device)
    fn = lambda: F.finish_cuda(filled, plan, out)
    nbytes = cs.finish_bytes(taps, h, w)
    return {"ms": med(fn),
            "device_ms": statistics.median(
                cs.device_ms(fn, args.reps, ("finish_kernel",))[0]
                for _ in range(args.sets)),
            "bound_ms": cs.bound(nbytes, 0)[0], "bytes": nbytes,
            "tile": list(F.TILE),
            "equal_to_plain": bool(torch.equal(fn(), F.finish_plain(filled,
                                                                    taps)))}


def nms_times(cs, args, med):
    """(w)'s two NMS launches of a 512^2 forward (see above)."""
    import torch
    from kbe_torch.models.maskrcnn import load_maskrcnn
    from kbe_torch.ops import nms as N
    from kbe_torch.utils.reference_convert import convert_maskrcnn, \
        synthetic_maskrcnn_state_dict

    model = load_maskrcnn(convert_maskrcnn(synthetic_maskrcnn_state_dict(0)),
                          device="cuda")
    canvas = cs.item_canvas(cs.ESTIMATION_SIZE, cs.MASK_CANVAS, "cuda")
    ms, dev, work = {}, {}, {}
    for sets, thresh, tag in cs.nms_sets_of_forward(model, canvas):
        boxes, scores, _ = N.sort_sets(sets)
        want = torch.stack([N.keep_plain(b, s, thresh)
                            for b, s in zip(boxes, scores)])
        work[tag] = dict(zip(("sets", "cap"), scores.shape))
        work[tag]["live_slots"], work[tag]["ious"] = cs.nms_work(
            boxes, scores, thresh)
        fn = lambda: N.keep_cuda(boxes, scores, thresh, "time")
        if not torch.equal(fn(), want):
            raise AssertionError(f"nms {tag}: not bit-equal to the plain "
                                 "loop")
        ms[tag] = med(fn)
        dev[tag] = statistics.median(
            cs.device_ms(fn, args.reps, ("nms_kernel",))[0]
            for _ in range(args.sets))
    return {"nms_ms": ms, "nms_device_ms": dev, "nms_work": work}


def grad_times(cs, args, med):
    """``splat_grad`` at (t)'s shape (see above)."""
    import itertools

    import torch
    from kbe_torch.ops import splat as S
    from kbe_torch.train.data import synthetic_batches
    from kbe_torch.train.trainer_inpaint import TRAIN_CAMERA, to_device

    h, w = cs.TRAIN_SIZE
    batch = next(itertools.islice(synthetic_batches(
        cs.TRAIN_BATCH, h, w, mode="inpainting", camera=TRAIN_CAMERA), 2,
        None))
    xyz = cs.step_points(to_device(batch, "cuda"), TRAIN_CAMERA)
    c = 68
    g = torch.Generator().manual_seed(c)
    upstream = torch.rand(h * w, c, generator=g).cuda()
    payload = torch.rand(xyz.shape[0], c, generator=g).cuda()
    pose = S.make_pose(torch.zeros(3, device="cuda"), TRAIN_CAMERA.focal,
                       TRAIN_CAMERA.baseline)
    _, existing, zee = S._render(xyz, payload, None, pose, h, w)
    existing = existing.contiguous()
    ms, dev, equal = {}, {}, {}
    for name, up in (("grad_c68", upstream),
                     ("grad_c68_ieee_quotients", upstream * 2.0 ** 100)):
        fn = lambda: S.grad_cuda(xyz, None, pose, zee, existing, up, h, w)
        equal[name] = bool(torch.equal(fn(), S.splat_grad_plain(
            xyz, None, pose, zee, existing, up, h, w)))
        ms[name] = med(fn)
        dev[name] = statistics.median(
            cs.device_ms(fn, args.reps, ("splat_grad",))[0]
            for _ in range(args.sets))
    return {"grad_ms": ms, "grad_device_ms": dev,
            "grad_points": int(xyz.shape[0]),
            "grad_equal_to_plain": equal}


def pconv_times(cs, args, med):
    """(m) and (m3) (see above): call ms, device ms, the plain chain's ms,
    the bound (``benchmark/pconv_counts.py``'s least bytes) and equality with the plain
    chain."""
    import torch

    if importlib.util.find_spec("kbe_torch.ops.pconv") is None:
        return {"pconv": None}
    out = {}
    for name, c_in, c_out, size in (("pconv_stem", 68, 32, 1024),
                                    ("pconv_row3", 256, 256, 128)):
        fn, plain, nbytes = cs.pconv_case(c_in, c_out, 3, 1, size, size)
        got, want = fn(), plain()
        out[name] = {
            "ms": med(fn),
            "device_ms": statistics.median(
                cs.device_ms(fn, args.reps, ("pconv_kernel",))[0]
                for _ in range(args.sets)),
            "plain_ms": med(plain), "bound_ms": cs.bound(nbytes, 0)[0],
            "bytes": nbytes,
            "equal_to_plain": bool(torch.equal(got[0], want[0])
                                   and torch.equal(got[1], want[1]))}
    return {"pconv": out}


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--tree", default=HERE)
    parser.add_argument("--sets", type=int, default=5)
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--only",
                        default="front,accumulate,fill,finish,nms,grad,"
                                "pconv",
                        help="comma-separated groups to time")
    args = parser.parse_args()
    only = set(args.only.split(","))
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_here", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    def med(fn):
        return statistics.median(cs.timed(fn, args.reps)
                                 for _ in range(args.sets))

    out = {"tree": tree}
    if only & {"front", "accumulate", "fill", "finish"}:
        out.update(splat_times(cs, args, only, med))
    if "nms" in only:
        out.update(nms_times(cs, args, med))
    if "grad" in only:
        out.update(grad_times(cs, args, med))
    if "pconv" in only:
        out.update(pconv_times(cs, args, med))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
