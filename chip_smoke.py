#!/usr/bin/env python3
"""Drive the kbe_torch port on one CUDA card and check it.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:
  1. device: require CUDA; print the card's name and power limit;
  2. build: compile ``kbe_torch/ops/csrc/*.cu`` with nvcc (sm_90a);
  3. kernels vs their plain PyTorch versions at the main path's shapes:
     (a) splat, C=4, a 3-grid 1024^2 cloud at a frame pose;
     (b) splat, C=68, one 1024^2 grid (the inpainting bootstrap);
     (c) fill at 1024^2, K=128, with and without the ROI (bit-identical);
     (d) two identical renders at C=4 and at C=68: bit-equal;
     (a2) splat, C=4, one grid at a pose with a focal of its own (dolly);
     (c2) fill of the (a2) render: one grid, no inpainted grids (dolly);
     (p) a pathological cloud: 65,536 points of a 1024^2 grid on one pixel;
  4. main path: the 1024^2, 75-frame effect at the production precision mix
     (f32 depth nets, bf16 inpainting nets), seeded random weights; checks
     the frames and that every kernel ran (77 renders of five splat
     launches each: zee, degrid, count, place, sum; 75 fills);
  5. card vs CPU: the default effect, dolly and partial-conv inpainting at
     256^2, f32, 5 steps, same weights, mean SSIM of the frames >= 0.99;
  6. the other entry points and inference modes:
     (e) every grid renderer (``render_grids_banded``, ``_routed`` at C=4
         and C=68, ``_pallas``, ``_delta``) on the card against the plain
         passes at 1024^2, five launches a call, then driven over the
         poses of a move for its launch count;
     (f) ``fill_disocclusion_pallas`` under every phase schedule, with and
         without the ROI, at 8 and 128 steps: bit-identical to the plain
         fill, one launch each;
     (g) the inference modes at 1024^2, 9 steps, production precision mix,
         through ``KenBurnsPipeline.__call__``: dolly, 2D, pretrained
         refine, partial conv, dual net, routed + whole-frame fill, delta,
         and the one-phase and fused fill schedules; frames and launch
         counts checked, the pose loop timed several times;
     (h) the ``'routed'`` effect against the ``'auto'`` one, same models,
         and two runs of the ``'auto'`` effect: equal frames;
     (i) ``load_scene`` and ``autozoom`` on the card (256 candidates), the
         C=3 coverage renders of three candidates against the plain passes,
         and the card's choice against the CPU's at 256^2;
     (j) the CLI's ``run`` at 256^2, defaults and ``--dolly``;
  7. the ``{"kernels": [...]}`` line, then the device line last. A row's
     ``launches`` are those of the run named in its ``path``, counted from
     zero just before that run.

Tolerances: none. Every kernel is exact: zee, degrid and the fill are
bit-equal to their plain versions on the card, and the accumulation (the
place and sum passes) and the normalised render are bit-equal to the plain
version run on the CPU, whose ``index_add_`` sums each pixel's entries in
ascending entry order (on the card ``index_add_`` uses atomics, so the
reference for the sums is the CPU's).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

SIZE = 1024
STEPS = 75
MODE_STEPS = 9              # depth of the other modes' runs
LOOP_RUNS = 7               # timed pose loops per mode in (g)
FOCAL, BASELINE = 512.0, 120.0
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
F32_OPS_PER_S = 67e12       # H100 SXM f32 outside the tensor cores

K1 = "kbe_tpu/ops/splat_posed.py:206"         # _build_posed_kernel
K3 = "kbe_tpu/ops/splat_banded.py:398"        # _build_banded_wide_kernel
K2 = "kbe_tpu/ops/discfill_pallas.py:451"     # _build_gated_flagging_kernel
K4 = "kbe_tpu/ops/splat_banded.py:198"        # _build_banded_kernel
K5 = "kbe_tpu/ops/splat_routed.py:132"        # _build_kernel
K6 = "kbe_tpu/ops/discfill_pallas.py:87"      # _build_kernel (one phase)
K6_FUSED = "kbe_tpu/ops/discfill_pallas.py:376"   # _build_fused_kernel
K7_ZEE = "kbe_tpu/ops/legacy/splat_pallas.py:68"      # _build_zee
K7_ACC = "kbe_tpu/ops/legacy/splat_pallas.py:129"     # _build_acc
K7_DELTA = "kbe_tpu/ops/legacy/splat_delta.py:85"     # _build_delta_kernel
SPLAT_SRC = "kbe_torch/ops/csrc/splat.cu"
FILL_SRC = "kbe_torch/ops/csrc/discfill.cu"


def log(*args):
    print(*args, flush=True)


def timed(fn, reps: int) -> float:
    """Mean ms of ``fn()`` on the card over ``reps`` runs, after one
    warm-up, timed with CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, nops: float):
    """(bound_ms, bound_by) from bytes moved and f32 operations."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def make_cloud(grids: int, c: int, seed: int, shift):
    """A 1024^2 grid cloud with a real disocclusion: a background plane with
    a near square, and grids after the first valid on a random half, as
    inpainted grids are. A 32x32 patch of grid 0 is placed so that, once
    shifted by ``shift``, it lies at z = 0.03 < f*b/1e6 in front of the
    camera: its z keys are negative and it lands in the image.
    Returns (xyz (G, H, W, 3), payload (G, H, W, C), valid (G, H, W)) on
    the card."""
    import torch
    from kbe_torch.ops.geometry import depth_to_points

    g = torch.Generator().manual_seed(seed)
    h = w = SIZE
    yy = torch.linspace(0, 1, h)[:, None]
    xx = torch.linspace(0, 1, w)[None, :]
    xyz, valid = [], []
    for i in range(grids):
        depth = (400.0 + 60.0 * yy + 30.0 * torch.sin(6 * xx)).expand(
            h, w).clone()
        if i == 0:
            depth[h // 3:2 * h // 3, w // 3:2 * w // 3] = 40.0
            valid.append(torch.ones(h, w))
        else:
            depth = depth * (1.0 + 0.05 * i)
            valid.append((torch.rand(h, w, generator=g) > 0.5).float())
        xyz.append(depth_to_points(depth, FOCAL))
    near = torch.stack(torch.meshgrid(torch.arange(32.0), torch.arange(32.0),
                                      indexing="ij"), dim=-1)
    xyz[0][8:40, 8:40, 0] = -shift[0] + (near[..., 1] - 16.0) * 1.7e-3
    xyz[0][8:40, 8:40, 1] = -shift[1] + (near[..., 0] - 16.0) * 1.7e-3
    xyz[0][8:40, 8:40, 2] = -shift[2] + 0.03
    payload = torch.rand(grids, h, w, c, generator=g)
    return (torch.stack(xyz).cuda(), payload.cuda(),
            torch.stack(valid).cuda())


def march_steps(depth, steps: int, roi) -> int:
    """Ray steps the fill's march takes on this frame: for each in-ROI hole
    pixel, each of the 32 rays up to its first event (the data-dependent
    work the fill's operation count is made of)."""
    import torch
    from kbe_torch.ops.discfill import _offset_tables

    h, w = depth.shape[:2]
    valid = depth[..., 0] > 0
    hole = ~valid
    if roi is not None:
        y0, y1, x0, x1 = roi
        inside = torch.zeros_like(hole)
        inside[y0:y1, x0:x1] = True
        hole = hole & inside
    ys, xs = torch.nonzero(hole, as_tuple=True)
    ox, oy = (torch.as_tensor(t, device=depth.device)
              for t in _offset_tables(steps))
    total = 0
    for r in range(32):
        alive = torch.ones_like(ys, dtype=torch.bool)
        for k in range(steps):
            if not bool(alive.any()):
                break
            total += int(alive.sum())
            py, px = ys + oy[r, k], xs + ox[r, k]
            out = (py < 0) | (py >= h) | (px < 0) | (px >= w)
            hit = valid[py.clamp(0, h - 1), px.clamp(0, w - 1)]
            alive = alive & ~out & ~hit
    return total


def assert_equal(name, got, want):
    """Bit equality; ``want`` may live on the CPU."""
    import torch

    got = got.to(want.device)
    if not torch.equal(got, want):
        raise AssertionError(f"{name}: not bit-equal, max abs diff "
                             f"{max_err(got, want)} in "
                             f"{int((got != want).sum())} elements")


def accumulate_on_cpu(xyz, valid, payload, pose, zee, h: int, w: int):
    """``accumulate_plain`` on CPU copies of the inputs: the CPU's
    ``index_add_`` sums each pixel's entries in ascending entry order, the
    order the card's sum pass reproduces (on the card it uses atomics)."""
    from kbe_torch.ops import splat as S

    return S.accumulate_plain(xyz.cpu(), valid.cpu(), payload.cpu(),
                              pose.cpu(), zee.cpu(), h, w)


def splat_compare(label, xyz, payload, valid, pose, h: int, w: int):
    """Each splat kernel against its plain version on the same inputs (the
    sums against the CPU's), and the whole render through ``splat``: all
    bit-equal. Returns the kernels' outputs and the largest difference."""
    from kbe_torch.ops import splat as S

    n, c = payload.shape
    keys = S.zee_cuda(xyz, valid, pose, h, w, c)
    zee_k = S.decode_keys(keys).reshape(h, w)
    assert_equal(f"{label} zee", zee_k, S.zee_plain(xyz, valid, pose, h, w))
    deg_k = S.degrid_cuda(keys, h, w, c)
    assert_equal(f"{label} degrid", deg_k, S.degrid_plain(zee_k))
    acc_k = S.accumulate_cuda(xyz, valid, payload, pose, deg_k, h, w)
    acc_p = accumulate_on_cpu(xyz, valid, payload, pose, deg_k, h, w)
    assert_equal(f"{label} accumulate", acc_k, acc_p)
    r_k, x_k = S.splat(xyz, payload, valid, pose, h, w)
    want_r = (acc_p[:, :c] / (acc_p[:, c:] + 1e-7)).reshape(h, w, c)
    want_x = acc_p[:, c:].reshape(h, w, 1)
    assert_equal(f"{label} render", r_k, want_r)
    assert_equal(f"{label} existing", x_k, want_x)
    covered = int((x_k > 0).sum())
    counts = S.count_cuda(xyz, valid, pose, deg_k, h, w, c)
    entries = int(counts.sum())
    longest = int(counts.max())
    log(f"{label}: N={n} C={c} zee/degrid/accumulate/render bit-equal to "
        f"the plain passes (sums on the CPU); {entries} visible entries, "
        f"longest segment {longest}; hole share "
        f"{1.0 - covered / (h * w):.4f}")
    return keys, counts, zee_k, deg_k, r_k, x_k


def splat_phase(label, xyz, payload, valid, pose, replaces, rows,
                entry=None, **extra):
    """Each splat kernel against its plain version on the same inputs, then
    timed. ``replaces`` is one TPU kernel, or one per pass (zee, degrid,
    accumulate); ``entry`` names the entry point in the rows of a path off
    the main one, whose launch counts the caller fills in; ``extra`` keys
    go into each row. The accumulate row times the count, place and sum
    passes together (and each alone beside it); its launches are the sum
    pass's."""
    from kbe_torch.ops import splat as S

    n, c = payload.shape
    h = w = SIZE
    keys, counts, zee_k, deg_k, r_k, x_k = splat_compare(
        label, xyz, payload, valid, pose, h, w)

    reps, preps = 20, 3
    ms_zee = timed(lambda: S.zee_cuda(xyz, valid, pose, h, w, c), reps)
    pms_zee = timed(lambda: S.zee_plain(xyz, valid, pose, h, w), preps)
    ms_deg = timed(lambda: S.degrid_cuda(keys, h, w, c), reps)
    pms_deg = timed(lambda: S.degrid_plain(zee_k), preps)
    ms_count = timed(lambda: S.count_cuda(xyz, valid, pose, deg_k, h, w, c),
                     reps)
    ms_place = timed(lambda: S.place_cuda(xyz, valid, pose, deg_k, counts,
                                          h, w, c), reps)
    starts, keys_s = S.place_cuda(xyz, valid, pose, deg_k, counts, h, w, c)
    ms_sum = timed(lambda: S.sum_cuda(payload, counts, starts, keys_s, h, w),
                   reps)
    ms_acc = timed(lambda: S.accumulate_cuda(xyz, valid, payload, pose,
                                             deg_k, h, w), reps)
    pms_acc = timed(lambda: S.accumulate_plain(xyz, valid, payload, pose,
                                               deg_k, h, w), preps)
    ms_all = timed(lambda: S.splat(xyz, payload, valid, pose, h, w), reps)
    log(f"{label}: kernel ms zee {ms_zee:.4f} degrid {ms_deg:.4f} "
        f"accumulate {ms_acc:.4f} (count {ms_count:.4f}, scan+place "
        f"{ms_place:.4f}, sum {ms_sum:.4f}) whole render {ms_all:.4f}; plain "
        f"ms zee "
        f"{pms_zee:.4f} degrid {pms_deg:.4f} accumulate {pms_acc:.4f}")
    hw = h * w
    tag = f"c{c}"
    if isinstance(replaces, str):
        replaces = (replaces,) * 3
    for (kern, key, ms, pms, nbytes, nops), repl in zip((
            ("zee", "zee", ms_zee, pms_zee, n * 16 + 20 + hw * 4, n * 20),
            ("degrid", "degrid", ms_deg, pms_deg, hw * 8, hw * 20),
            ("accumulate", "sum", ms_acc, pms_acc,
             n * (16 + 4 * c) + 20 + hw * 4 + hw * (c + 1) * 4,
             n * (20 + 4 * 2 * (c + 1)))), replaces):
        b_ms, b_by = bound(nbytes, nops)
        row = {"name": f"splat_{kern}[{tag}]", "route": "cuda",
               "source": SPLAT_SRC, "replaces": repl,
               "count_key": f"{key}/{tag}", "max_abs_err": 0.0,
               "ms": ms, "plain_ms": pms, "bound_ms": b_ms,
               "bound_by": b_by, "library_ms": None}
        if kern == "accumulate":
            # the function's kernels: splat_route twice, then splat_sum
            row.update(count_ms=ms_count, place_ms=ms_place, sum_ms=ms_sum,
                       pass_keys=[f"{k}/{tag}"
                                  for k in ("count", "place", "sum")])
        if entry is not None:
            row["name"] += f"/{entry}"
            row["entry"] = entry
        row.update(extra)
        rows.append(row)
    return r_k, x_k


def fill_steps(render, depth, roi):
    """Ray steps and warp rounds of the kernel's march on this frame, from
    its device counters (one extra launch, not timed)."""
    import torch
    from kbe_torch.ops import discfill as D

    stats = torch.zeros(2, dtype=torch.int64, device=render.device)
    D.fill_cuda(render, depth, 128, roi, stats=stats)
    return int(stats[0]), int(stats[1])


def fill_phase(label, render, existing, roi, rows, name="discfill",
               **extra):
    """The fill on a rendered frame against the plain fill, with and
    without the ROI (bit-identical), then timed; the march's work by the
    first kernel's schedule (every ray to its end) and by this one's."""
    import torch
    from kbe_torch.ops import discfill as D

    depth = (render[..., 3:4] * (existing > 0.0)).contiguous()
    render = render.contiguous()
    h, w, c = render.shape
    for r in (None, roi):
        got = D.fill_cuda(render, depth, 128, r)
        want = D.fill_plain(render, depth, 128, r)
        if not torch.equal(got, want):
            raise AssertionError(f"{label} roi={r}: not bit-identical, max "
                                 f"abs diff {max_err(got, want)}")
    holes = int((depth <= 0).sum())
    full_march = march_steps(depth, 128, roi)
    marched, rounds = fill_steps(render, depth, roi)
    ms = timed(lambda: D.fill_cuda(render, depth, 128, roi), 20)
    pms = timed(lambda: D.fill_plain(render, depth, 128, roi), 2)
    log(f"{label}: {h}x{w}x{c}, {holes} hole pixels, bit-identical with and "
        f"without ROI {roi}; ray steps in the ROI: {full_march} to every "
        f"ray's end, {marched} with the exact stop ({rounds} warp "
        f"rounds of 8 steps); kernel ms {ms:.4f}, plain ms {pms:.4f}")
    # bytes: image and depth read once, image written once; operations:
    # each ray step the exact stop takes is an add pair, a bounds test and
    # a depth compare
    b_ms, b_by = bound(h * w * (2 * c + 1) * 4, marched * 4)
    row = {"name": name, "route": "cuda", "source": FILL_SRC,
           "replaces": K2, "count_key": "discfill", "max_abs_err": 0.0,
           "ms": ms, "plain_ms": pms, "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": None, "march_steps_full": full_march,
           "march_steps": marched, "warp_rounds": rounds}
    row.update(extra)
    rows.append(row)


def kernel_phases(rows, more):
    import torch
    from kbe_torch.ops import splat as S
    from kbe_torch.pipeline.kenburns import fill_roi_of
    from kbe_torch.config import EffectConfig, ZoomSettings

    # (a) the frame loop's splat: the 3-grid cloud, pre-scaled once, at a
    # frame pose
    shift = torch.tensor([-9.5, 6.25, -30.0])
    xyz, payload, valid = make_cloud(3, 4, seed=1, shift=shift)
    scene = S.prepare_scene(xyz, payload, valid)
    shift = shift.cuda()
    pose = S.make_pose(shift, FOCAL, BASELINE)
    render, existing = splat_phase("(a) splat C=4", scene.xyz,
                                   scene.payload, scene.valid, pose, K1,
                                   rows)
    # (a2) the dolly loop's splat: one grid, no inpainted grids behind it,
    # and a focal of the step's own in the pose
    xyz1, payload1, valid1 = make_cloud(1, 4, seed=3, shift=shift.cpu())
    scene1 = S.prepare_scene(xyz1, payload1, valid1)
    splat_phase("(a2) splat C=4, one grid, dolly focal", scene1.xyz,
                scene1.payload, scene1.valid,
                S.make_pose(shift, FOCAL * 1.21875, BASELINE), K1, more,
                entry="render_posed", mode="dolly")
    # (b) the bootstrap splat: one grid, 68 channels, unscaled points plus
    # the shift
    xyz68, payload68, _ = make_cloud(1, 68, seed=2, shift=shift.cpu())
    pts = (xyz68.reshape(-1, 3) + shift).contiguous()
    zero = S.make_pose(torch.zeros(3, device="cuda"), FOCAL, BASELINE)
    splat_phase("(b) splat C=68", pts, payload68.reshape(-1, 68),
                torch.ones(SIZE * SIZE, device="cuda"), zero, K3, rows)
    # (c) the fill, on the rendered frame of (a)
    zoom = ZoomSettings.default_3d(SIZE, SIZE)
    fill_phase("(c) fill", render, existing,
               fill_roi_of(SIZE, SIZE, zoom, EffectConfig()), rows)
    # (c2) dolly's fill: the (a2) render, one grid and no inpainted grids,
    # so the disocclusions stay open; dolly's own ROI
    render1, existing1 = S.render_posed(
        scene1, S.make_pose(shift, FOCAL * 1.21875, BASELINE), SIZE, SIZE)
    fill_phase("(c2) fill, dolly frame", render1, existing1,
               fill_roi_of(SIZE, SIZE, ZoomSettings.default_dolly(SIZE, SIZE),
                           EffectConfig(dolly=True)), more,
               name="discfill/dolly", mode="dolly")
    # (d) run to run: two identical renders at each width
    for c, again in ((4, lambda: S.render_posed(scene, pose, SIZE, SIZE)),
                     (68, lambda: S.splat(pts, payload68.reshape(-1, 68),
                                          torch.ones(SIZE * SIZE,
                                                     device="cuda"),
                                          zero, SIZE, SIZE))):
        (r1, x1), (r2, x2) = again(), again()
        assert_equal(f"(d) two identical C={c} renders", r1, r2)
        assert_equal(f"(d) two identical C={c} weights", x1, x2)
        log(f"(d) run to run, two identical C={c} renders: max diff "
            f"{max(max_err(r1, r2), max_err(x1, x2))}")
    pathological_phase(more)


def pathological_phase(rows):
    """(p) 65,536 points of a 1024^2 grid on one pixel, the rest spread:
    four pixels with 65,536 entries each, which the sum pass sorts and sums
    with a whole block. Bit-equal to the CPU's plain sums, and timed."""
    import torch
    from kbe_torch.ops import splat as S

    xyz, payload, valid = make_cloud(1, 4, seed=5, shift=torch.zeros(3))
    g = torch.Generator().manual_seed(6)
    pts = xyz.reshape(-1, 3).clone()
    pile = torch.randperm(SIZE * SIZE, generator=g)[:65536].cuda()
    # within 1 of each other in z: every entry passes the z test
    z = 300.0 + torch.rand(65536, generator=g).cuda()
    # u, v inside the cell of pixel (400, 700) at every depth
    du, dv = (0.1 + 0.8 * torch.rand(2, 65536, generator=g)).cuda()
    pts[pile, 0] = (700.0 + du - SIZE / 2 + 0.5) * z / FOCAL
    pts[pile, 1] = (400.0 + dv - SIZE / 2 + 0.5) * z / FOCAL
    pts[pile, 2] = z
    pts = pts.contiguous()
    pflat = payload.reshape(-1, 4).contiguous()
    vflat = valid.reshape(-1).contiguous()
    zero = S.make_pose(torch.zeros(3, device="cuda"), FOCAL, BASELINE)
    first = len(rows)
    splat_phase("(p) pathological cloud C=4", pts, pflat, vflat, zero, K1,
                rows, entry="pathological")
    clear_launches()
    S.splat(pts, pflat, vflat, zero, SIZE, SIZE)
    torch.cuda.synchronize()
    expect_counts("(p) pathological cloud", splat_counts(4, 1))
    for row in rows[first:]:
        settle(row, splat_counts(4, 1))
        row["path"] = ("pathological cloud: one render of a 1024^2 grid "
                       "with 65,536 points on one pixel, C=4")


def main_path():
    import numpy as np
    import torch
    from kbe_torch.config import ZoomSettings
    from kbe_torch.data import demo_scene_image
    from kbe_torch.ops import discfill, splat
    from kbe_torch.pipeline import KenBurnsPipeline

    pipe = KenBurnsPipeline.create(seed=0, dtype=torch.bfloat16,
                                   depth_dtype=torch.float32, device="cuda")
    image_np = demo_scene_image(SIZE, SIZE)
    pipe(image_np)  # warm-up: builds the kernels' tables, cuDNN plans
    torch.cuda.synchronize()

    # the counted run, through the user's entry point
    splat.LAUNCHES.clear()
    discfill.LAUNCHES.clear()
    t0 = time.perf_counter()
    frames = pipe(image_np)
    wall = time.perf_counter() - t0
    counts = dict(splat.LAUNCHES)
    counts.update(discfill.LAUNCHES)
    log(f"main path launch counts: {json.dumps(counts, sort_keys=True)}")
    for kern in ("zee", "degrid", "count", "place", "sum"):
        c4, c68 = counts.get(f"{kern}/c4", 0), counts.get(f"{kern}/c68", 0)
        if (c4, c68) != (STEPS, 2):
            raise AssertionError(f"splat_{kern}: {c4} frame + {c68} "
                                 f"bootstrap launches, want {STEPS} + 2")
    if counts.get("discfill", 0) != STEPS:
        raise AssertionError(f"discfill: {counts.get('discfill')} launches,"
                             f" want {STEPS}")
    if frames.shape != (STEPS, SIZE, SIZE, 3) or frames.dtype != np.uint8:
        raise AssertionError(f"frames {frames.shape} {frames.dtype}")
    if int(frames.max()) == int(frames.min()):
        raise AssertionError("frames are constant")

    # timing on the card: the two halves of the effect, frames left there
    fn = pipe.effect_fn(SIZE, SIZE, ZoomSettings.default_3d(SIZE, SIZE))
    image = torch.as_tensor(image_np, device="cuda")[None]
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        state = fn.front_end(pipe.models, image)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        fn.render_frames(state)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        times.append((t2 - t0, t1 - t0, t2 - t1))
    total, front, loop = min(times)
    log(f"main path {SIZE}^2 x {STEPS} frames, bf16 inpainting + f32 depth: "
        f"best of 2 {total:.4f} s = {STEPS / total:.3f} frames/s "
        f"(front end {front:.4f} s, pose loop {loop:.4f} s = "
        f"{loop / STEPS * 1e3:.3f} ms/frame); all runs "
        f"{[round(t[0], 4) for t in times]}; the counted run through "
        f"KenBurnsPipeline.__call__ with frames copied to the host "
        f"{wall:.4f} s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; frames mean "
        f"{float(frames.mean()):.3f}")
    return counts


def card_vs_cpu():
    """The card's frames against the CPU's plain path at 256^2, f32, 5
    steps, same weights: the default effect, dolly (one grid, open holes,
    a focal per step) and partial-conv inpainting."""
    import numpy as np
    import torch
    from kbe_torch.config import EffectConfig
    from kbe_torch.data import demo_scene_image
    from kbe_torch.ops.image_ops import ssim
    from kbe_torch.pipeline import KenBurnsPipeline

    size, steps = 256, 5
    image = demo_scene_image(size, size)
    for name, effect_kw, model_kw in (
            ("default", {}, {}),
            ("dolly", {"dolly": True}, {}),
            ("partial_inpainting", {}, {"partial_inpainting": True})):
        effect = EffectConfig(num_steps=steps, **effect_kw)
        out = {}
        for dev in ("cuda", "cpu"):
            pipe = KenBurnsPipeline.create(seed=0, effect=effect, device=dev,
                                           **model_kw)
            out[dev] = torch.as_tensor(pipe(image)).float() / 255.0
        scores = [float(ssim(out["cuda"][i:i + 1], out["cpu"][i:i + 1]))
                  for i in range(steps)]
        diff = float((out["cuda"] - out["cpu"]).abs().max() * 255.0)
        mean = float(np.mean(scores))
        log(f"card vs CPU, {name}, at {size}^2, f32, {steps} steps: mean "
            f"SSIM {mean:.6f} (per frame {[round(s, 6) for s in scores]}), "
            f"max abs diff {diff:.0f} of 255")
        if mean < 0.99:
            raise AssertionError(f"card vs CPU, {name}: mean SSIM {mean} "
                                 f"< 0.99")


def launch_counts():
    from kbe_torch.ops import discfill, splat

    counts = dict(splat.LAUNCHES)
    counts.update(discfill.LAUNCHES)
    return counts


def clear_launches():
    from kbe_torch.ops import discfill, splat

    splat.LAUNCHES.clear()
    discfill.LAUNCHES.clear()


def expect_counts(label, want):
    got = launch_counts()
    if got != want:
        raise AssertionError(f"{label}: launches {got}, want {want}")


def settle(row, counts) -> None:
    """A row's launches from the counts of its path's run; the accumulate
    rows also list each pass's."""
    key = row.pop("count_key", None)
    keys = row.pop("pass_keys", None)
    if key is None:
        return
    row["launches"] = counts.get(key, 0)
    if keys:
        row["pass_launches"] = {k: counts.get(k, 0) for k in keys}


def splat_counts(c: int, n: int):
    return {f"{k}/c{c}": n
            for k in ("zee", "degrid", "count", "place", "sum")}


def grid_renderer_phases(rows):
    """(e) every ``render_grids_*`` generation on the card: the kernels
    against the plain passes, the entry point's own output against the
    plain render (all bit-equal, the sums on the CPU), its five launches,
    and a driven run over the poses of a move."""
    import torch
    from kbe_torch.ops import legacy, splat as S, splat_banded, splat_routed
    from kbe_torch.ops.geometry import apply_shift

    h = w = SIZE
    shift = torch.tensor([-9.5, 6.25, -30.0])
    cases = (
        ("render_grids_banded", splat_banded.render_grids_banded, 3, 4, K4),
        ("render_grids_routed", splat_routed.render_grids_routed, 3, 4, K5),
        ("render_grids_routed", splat_routed.render_grids_routed, 1, 68, K5),
        ("render_grids_pallas", legacy.render_grids_pallas, 3, 4,
         (K7_ZEE, K7_ZEE, K7_ACC)),
        ("render_grids_delta", legacy.render_grids_delta, 3, 4, K7_DELTA))
    zero = S.make_pose(torch.zeros(3, device="cuda"), FOCAL, BASELINE)
    for name, fn, grids, c, replaces in cases:
        label = f"(e) {name} G={grids} C={c}"
        xyz, payload, valid = make_cloud(grids, c, seed=10 + c + grids,
                                         shift=shift)
        moved = apply_shift(xyz, shift.cuda())
        pts = moved.reshape(-1, 3).contiguous()
        pflat = payload.reshape(-1, c).contiguous()
        vflat = valid.reshape(-1).contiguous()
        first = len(rows)
        splat_phase(label, pts, pflat, vflat, zero, replaces, rows,
                    entry=name)

        clear_launches()
        out = fn(moved, payload, h, w, FOCAL, BASELINE, valid=valid)
        torch.cuda.synchronize()
        expect_counts(label, splat_counts(c, 1))
        acc = accumulate_on_cpu(pts, vflat, pflat, zero, S.degrid_plain(
            S.zee_plain(pts, vflat, zero, h, w)), h, w)
        assert_equal(f"{label} entry render", out[0][0],
                     (acc[:, :c] / (acc[:, c:] + 1e-7)).reshape(h, w, c))
        assert_equal(f"{label} entry existing", out[1][0],
                     acc[:, c:].reshape(h, w, 1))
        if len(out) == 3 and bool(out[2]):
            raise AssertionError(f"{label}: overflow flag set")

        # the entry point as a caller drives it: the wide payload twice, as
        # the bootstrap does; the frame payload over the poses of a move
        n = 2 if c == 68 else MODE_STEPS
        clear_launches()
        for i in range(n):
            step = shift.cuda() * (i / max(n - 1, 1))
            fn(apply_shift(xyz, step), payload, h, w, FOCAL, BASELINE,
               valid=valid)
        torch.cuda.synchronize()
        expect_counts(f"{label} driven", splat_counts(c, n))
        for row in rows[first:]:
            settle(row, splat_counts(c, n))
            row["path"] = (f"{name} over {n} poses of a camera move, "
                           f"{grids} x {SIZE}^2 points, C={c}")
        log(f"{label}: entry point bit-equal to the plain render, overflow "
            f"false, 5 launches a call, {n} calls driven")


def fill_variant_phase(rows):
    """(f) ``fill_disocclusion_pallas`` under every phase schedule: one
    ``discfill`` launch each, bit-identical to the plain fill."""
    import torch
    from kbe_torch.config import EffectConfig, ZoomSettings
    from kbe_torch.ops import discfill as D
    from kbe_torch.ops import splat as S
    from kbe_torch.pipeline.kenburns import fill_roi_of

    shift = torch.tensor([-9.5, 6.25, -30.0])
    xyz, payload, valid = make_cloud(3, 4, seed=1, shift=shift)
    scene = S.prepare_scene(xyz, payload, valid)
    render, existing = S.render_posed(
        scene, S.make_pose(shift.cuda(), FOCAL, BASELINE), SIZE, SIZE)
    depth = (render[..., 3:4] * (existing > 0.0)).contiguous()
    render = render.contiguous()
    roi = fill_roi_of(SIZE, SIZE, ZoomSettings.default_3d(SIZE, SIZE),
                      EffectConfig())
    tried = 0
    for steps in (8, 128):
        for r in (None, roi):
            want = D.fill_plain(render, depth, steps, r)
            for phase1 in (0, 8):
                for phase0 in (0, 2):
                    clear_launches()
                    got = D.fill_disocclusion_pallas(
                        render[None], depth[None], steps,
                        phase1_steps=phase1, roi=r, phase0_steps=phase0,
                        phase0_gate=0.75 if phase0 else 0.0)[0]
                    expect_counts("(f) fill", {"discfill": 1})
                    if not torch.equal(got, want):
                        raise AssertionError(
                            f"(f) fill steps={steps} phase1={phase1} "
                            f"phase0={phase0} roi={r}: not bit-identical, "
                            f"max abs diff {max_err(got, want)}")
                    tried += 1
    h, w, c = render.shape
    marched, _ = fill_steps(render, depth, roi)
    want = D.fill_plain(render, depth, 128, roi)
    pms = timed(lambda: D.fill_plain(render, depth, 128, roi), 2)
    b_ms, b_by = bound(h * w * (2 * c + 1) * 4, marched * 4)
    for name, kwargs, replaces, mode in (
            ("phase1_steps=0", dict(phase1_steps=0), K6,
             "fill_march_phase1=0"),
            ("phase1_steps=8,phase0_steps=0", dict(phase1_steps=8),
             K6_FUSED, "fill_phase0=0")):
        def call(kwargs=kwargs):
            return D.fill_disocclusion_pallas(render[None], depth[None], 128,
                                              roi=roi, **kwargs)

        err = max_err(call()[0], want)
        if err != 0.0:
            raise AssertionError(f"(f) fill {name}: not bit-identical, max "
                                 f"abs diff {err}")
        ms = timed(call, 20)
        rows.append({"name": f"discfill/fill_disocclusion_pallas[{name}]",
                     "route": "cuda", "source": FILL_SRC,
                     "replaces": replaces, "count_key": "discfill",
                     "entry": "fill_disocclusion_pallas", "mode": mode,
                     "max_abs_err": err, "ms": ms, "plain_ms": pms,
                     "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": None})
    ms_whole = timed(lambda: D.fill_disocclusion(render[None], depth[None],
                                                 128), 20)
    log(f"(f) fill_disocclusion_pallas: {tried} settings (steps 8/128, "
        f"phase1 0/8, phase0 0/2, ROI {roi} or none) bit-identical to the "
        f"plain fill, one launch each; entry ms with the ROI "
        f"{rows[-2]['ms']:.4f} and {rows[-1]['ms']:.4f}, whole frame "
        f"(fill_impl='xla') {ms_whole:.4f}, plain {pms:.4f}")


MODES = (
    # name, EffectConfig fields, create() flags, bootstrap splats at C=68
    ("dolly", {"dolly": True}, {}, 0),
    ("2d", {"two_d": True}, {}, 2),
    ("pretrained_refine", {}, {"pretrained_refine": True}, 2),
    ("partial_inpainting", {}, {"partial_inpainting": True}, 2),
    ("inpaint_depth", {}, {"inpaint_depth": True}, 4),
    ("routed+xla", {"splat_method": "routed", "fill_impl": "xla"}, {}, 2),
    ("delta", {"splat_method": "delta"}, {}, 2),
    ("fill_march_phase1=0", {"fill_march_phase1": 0}, {}, 2),
    ("fill_phase0=0", {"fill_phase0": 0}, {}, 2),
)


def mode_phases(size: int = SIZE, device: str = "cuda"):
    """(g) every other inference mode at full width through the user's
    entry point. Returns {mode: launch counts of its counted run}."""
    import numpy as np
    import torch
    from kbe_torch.config import EffectConfig, ZoomSettings
    from kbe_torch.data import demo_scene_image
    from kbe_torch.pipeline import KenBurnsPipeline

    on_card = device == "cuda"
    image_np = demo_scene_image(size, size)
    image = torch.as_tensor(image_np, device=device)[None]
    all_counts = {}
    for name, effect_kw, model_kw, boot in MODES:
        effect = EffectConfig(num_steps=MODE_STEPS, **effect_kw)
        pipe = KenBurnsPipeline.create(
            seed=0, effect=effect, dtype=torch.bfloat16,
            depth_dtype=torch.float32, device=device, **model_kw)
        if on_card:
            pipe(image_np)   # warm-up: cuDNN plans for this mode's nets
            torch.cuda.synchronize()
        clear_launches()
        t0 = time.perf_counter()
        frames = pipe(image_np)
        wall = time.perf_counter() - t0
        counts = launch_counts()
        want = dict(splat_counts(4, MODE_STEPS), discfill=MODE_STEPS)
        if boot:
            want.update(splat_counts(68, boot))
        if on_card:
            expect_counts(f"(g) {name}", want)
        if (frames.shape != (MODE_STEPS, size, size, 3)
                or frames.dtype != np.uint8):
            raise AssertionError(f"(g) {name}: frames {frames.shape} "
                                 f"{frames.dtype}")
        if int(frames.max()) == int(frames.min()):
            raise AssertionError(f"(g) {name}: frames are constant")
        if not (frames[0] != frames[-1]).any():
            raise AssertionError(f"(g) {name}: first frame equals the last")
        # the halves of one more run, under the windows __call__ picked
        zoom = (ZoomSettings.default_dolly(size, size) if effect.dolly
                else ZoomSettings.default_3d(size, size))
        fn = pipe.effect_fn(size, size, zoom)
        t0 = time.perf_counter()
        state = fn.front_end(pipe.models, image)
        if on_card:
            torch.cuda.synchronize()
        front = time.perf_counter() - t0
        loops = []
        for _ in range(LOOP_RUNS):
            t0 = time.perf_counter()
            fn.render_frames(state)
            if on_card:
                torch.cuda.synchronize()
            loops.append((time.perf_counter() - t0) / MODE_STEPS * 1e3)
        log(f"(g) mode {name}: {size}^2 x {MODE_STEPS} frames in {wall:.4f} s"
            f" through KenBurnsPipeline.__call__ (frames copied to the "
            f"host); front end {front:.4f} s, pose loop ms/frame over "
            f"{LOOP_RUNS} runs: median {float(np.median(loops)):.3f}, min "
            f"{min(loops):.3f}, max {max(loops):.3f}; launches "
            f"{json.dumps(counts, sort_keys=True)}; frames mean "
            f"{float(frames.mean()):.3f}")
        all_counts[name] = counts
        del pipe, fn, state
        if on_card:
            torch.cuda.empty_cache()
    return all_counts


def routed_vs_posed(size: int = SIZE, device: str = "cuda"):
    """(h) the ``'routed'`` frame loop (``apply_shift`` in PyTorch, then
    ``render_grids_fast``) against the posed one, same models and image,
    and two runs of the same ``'auto'`` effect.

    Every splat is exact and deterministic, so the routed and posed loops
    give equal frames from one front-end state and as whole effects, and
    two whole ``'auto'`` effects give equal frames. Where those two
    differ, the two front-end states are compared grid by grid to name the
    stage before the check fails (grid 0 comes from the depth nets, grids
    1-2 from the inpainting nets after the exact bootstrap splat). Both
    loops are timed in turns on the shared state."""
    import torch
    from kbe_torch.config import EffectConfig, ZoomSettings
    from kbe_torch.data import demo_scene_image
    from kbe_torch.pipeline.kenburns import build_effect_fn, create_models

    on_card = device == "cuda"
    models = create_models(0, device, torch.bfloat16, torch.float32)
    image = torch.as_tensor(demo_scene_image(size, size), device=device)[None]
    zoom = ZoomSettings.default_3d(size, size)
    fns = {method: build_effect_fn(size, size, zoom, effect=EffectConfig(
        num_steps=MODE_STEPS, splat_method=method), device=device)
        for method in ("auto", "routed")}

    def compare(label, a, b, strict=True):
        diff = (a.int() - b.int()).abs()
        same = torch.equal(a, b)
        log(f"(h) {label} at {size}^2, {MODE_STEPS} steps: "
            f"{'equal' if same else 'DIFFER'}, max abs diff "
            f"{int(diff.max())} of 255, pixels differing "
            f"{float((diff > 0).float().mean()):.6f}")
        if strict and not same:
            raise AssertionError(f"(h) {label}: frames differ")
        return same

    state = fns["auto"].front_end(models, image)
    compare("routed vs posed loop, one front-end state",
            fns["routed"].render_frames(state),
            fns["auto"].render_frames(state))
    compare("posed loop twice, one front-end state",
            fns["auto"].render_frames(state),
            fns["auto"].render_frames(state))
    whole = {m: fn(models, image) for m, fn in fns.items()}
    compare("routed vs posed, whole effects", whole["routed"], whole["auto"])
    if not compare("posed vs posed again, whole effects",
                   fns["auto"](models, image), whole["auto"], strict=False):
        other = fns["auto"].front_end(models, image)
        hw = size * size
        for g in range(state.scene.payload.shape[0] // hw):
            rows = slice(g * hw, (g + 1) * hw)
            same = all(torch.equal(a[rows], b[rows]) for a, b in (
                (state.scene.xyz, other.scene.xyz),
                (state.scene.payload, other.scene.payload),
                (state.scene.valid, other.scene.valid)))
            log(f"(h) two front ends, grid {g} "
                f"({'depth nets' if g == 0 else 'inpainting nets'}): "
                f"{'equal' if same else 'DIFFER'}")
        raise AssertionError("(h) two runs of one effect differ; the grids "
                             "above name the stage")

    times = {"auto": [], "routed": []}
    for method in ("auto", "routed", "routed", "auto") * 3:
        if on_card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        fns[method].render_frames(state)
        if on_card:
            torch.cuda.synchronize()
        times[method].append((time.perf_counter() - t0) / MODE_STEPS * 1e3)
    log(f"(h) pose loop ms/frame on the shared state, in turns: posed "
        f"{[round(t, 3) for t in times['auto']]}, routed "
        f"{[round(t, 3) for t in times['routed']]}")


def autozoom_phase(rows, size: int = SIZE, small: int = 256, grid: int = 16,
                   device: str = "cuda"):
    """(i) ``load_scene`` then ``autozoom`` on the card; on the card, the
    coverage renders of a few candidates (C=3, one raw grid, the shift in
    the pose) against the plain passes; the card's choice against the CPU's
    plain route on the same cloud at ``small``^2. Returns the launch counts
    of the search."""
    import numpy as np
    import torch
    from kbe_torch.config import ZoomWindow
    from kbe_torch.data import demo_scene_image
    from kbe_torch.ops.splat import make_pose
    from kbe_torch.pipeline import autozoom, load_scene
    from kbe_torch.pipeline.autozoom import candidate_shifts, flat_cloud
    from kbe_torch.pipeline.kenburns import create_models

    on_card = device == "cuda"
    models = create_models(0, device)

    def scene_of(n):
        image = (demo_scene_image(n, n) * 255.0).astype(np.uint8)
        return load_scene(models, image, device=device)

    scene = scene_of(size)
    window = ZoomWindow(size / 2.0, size / 2.0, size * 7 // 8, size * 7 // 8)
    clear_launches()
    t0 = time.perf_counter()
    chosen = autozoom(scene["unaltered_points"], scene["image"], window,
                      1.25, size / 10.0, scene["anchor"], scene["camera"],
                      grid=grid)
    wall = time.perf_counter() - t0
    counts = launch_counts()
    if on_card:
        expect_counts("(i) autozoom", splat_counts(3, grid * grid))
    log(f"(i) autozoom at {size}^2, {grid * grid} candidates: window "
        f"{chosen} in {wall:.4f} s, {grid * grid} x 3 launches")

    if on_card:
        camera = scene["camera"]
        su, sv, ok, cam_shifts = candidate_shifts(
            window, 1.25, size / 10.0, scene["anchor"], size, size, camera,
            grid, device)
        xyz, payload, valid = flat_cloud(scene["unaltered_points"],
                                         scene["image"])
        best = int(np.argmin(
            np.abs(su - (chosen.center_u - window.center_u))
            + np.abs(sv - (chosen.center_v - window.center_v))))
        inside = np.flatnonzero(ok)
        for i in (int(inside[0]), int(inside[-1])):
            splat_compare(f"(i) candidate {i}", xyz, payload, valid,
                          make_pose(cam_shifts[i], camera.focal,
                                    camera.baseline), size, size)
        splat_phase(f"(i) chosen candidate {best}", xyz, payload, valid,
                    make_pose(cam_shifts[best], camera.focal,
                              camera.baseline), K1, rows, entry="autozoom")

    scene = scene_of(small)
    window = ZoomWindow(small / 2.0, small / 2.0, small * 7 // 8,
                        small * 7 // 8)
    picks = []
    for dev in (device, "cpu"):
        picks.append(autozoom(
            scene["unaltered_points"].to(dev), scene["image"].to(dev),
            window, 1.25, small / 10.0,
            tuple(a.to(dev) for a in scene["anchor"]), scene["camera"],
            grid=4))
    log(f"(i) autozoom at {small}^2, 16 candidates: card {picks[0]}, CPU "
        f"{picks[1]}")
    if picks[0] != picks[1]:
        raise AssertionError("(i) autozoom: the card and the CPU chose "
                             "different windows")
    return counts


def cli_phase(size: int = 256, device: str = "cuda"):
    """(j) the CLI's ``run``: everything between reading the image and
    writing the video, on the demo image."""
    import numpy as np
    from cli import kbe_torch as cli
    from kbe_torch.data import demo_scene_image

    image = (demo_scene_image(size, size) * 255.0).astype(np.uint8)
    for argv in ([], ["--dolly"]):
        args = cli.build_parser().parse_args(
            argv + ["--steps", "5", "--device", device])
        t0 = time.perf_counter()
        frames = cli.run(args, image)
        wall = time.perf_counter() - t0
        if frames.shape != (5, size, size, 3) or frames.dtype != np.uint8:
            raise AssertionError(f"(j) cli {argv}: frames {frames.shape} "
                                 f"{frames.dtype}")
        if int(frames.max()) == int(frames.min()) \
                or not (frames[0] != frames[-1]).any():
            raise AssertionError(f"(j) cli {argv}: frames do not move")
        log(f"(j) cli run {argv or ['defaults']} at {size}^2, 5 steps: "
            f"{wall:.4f} s, frames mean {float(frames.mean()):.3f}")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from kbe_torch.ops import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(f"device: {torch.cuda.get_device_name(0)}; torch {torch.__version__}"
        f", CUDA {torch.version.cuda}; {smi}")
    log(f"tf32 before the effect: cudnn {torch.backends.cudnn.allow_tf32}, "
        f"matmul {torch.backends.cuda.matmul.allow_tf32}")

    t0 = time.perf_counter()
    _build.build_all()
    log(f"build: {time.perf_counter() - t0:.2f} s")
    for name, text in _build.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    # rows of the main path's kernels, and of the paths off it: a row's
    # launches are those of its own path's run
    rows, more = [], []
    kernel_phases(rows, more)
    counts = main_path()
    log(f"tf32 after the effect: cudnn {torch.backends.cudnn.allow_tf32}, "
        f"matmul {torch.backends.cuda.matmul.allow_tf32}")
    card_vs_cpu()
    for row in rows:
        settle(row, counts)
        row["path"] = f"main path: {SIZE}^2 x {STEPS} frames, default effect"

    grid_renderer_phases(more)
    fill_variant_phase(more)
    mode_counts = mode_phases()
    routed_vs_posed()
    autozoom_counts = autozoom_phase(more)
    cli_phase()
    for row in more:
        if "mode" in row:
            mode = row["mode"]
            settle(row, mode_counts[mode])
            row["path"] = (f"mode {mode}: {SIZE}^2 x {MODE_STEPS} frames "
                           "through KenBurnsPipeline.__call__")
        elif row.get("entry") == "autozoom":
            settle(row, autozoom_counts)
            row["path"] = (f"autozoom: {SIZE}^2 points, "
                           f"{row['launches']} candidates")
        else:  # (e) and (p) counted their own runs
            assert "launches" in row, row["name"]
    rows += more
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
