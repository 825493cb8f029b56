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
     (d) two identical C=4 renders, their run-to-run difference;
  4. main path: the 1024^2, 75-frame effect at the production precision mix
     (f32 depth nets, bf16 inpainting nets), seeded random weights; checks
     the frames and that every kernel ran (77 splats, 75 fills);
  5. card vs CPU: the effect at 256^2, f32, 5 steps, same weights, mean
     SSIM of the frames >= 0.99;
  6. the ``{"kernels": [...]}`` line, then the device line last.

Tolerances: the zee and degrid passes and the fill are exact (bit-equal to
the plain version). The accumulation uses float atomics, whose order varies
from run to run, so the rendered planes are held per channel to rtol 1e-5,
atol 2e-4: the standard the JAX package holds its posed TPU kernel to.
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
FOCAL, BASELINE = 512.0, 120.0
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
F32_OPS_PER_S = 67e12       # H100 SXM f32 outside the tensor cores
RTOL, ATOL = 1e-5, 2e-4

K1 = "kbe_tpu/ops/splat_posed.py:206"         # _build_posed_kernel
K3 = "kbe_tpu/ops/splat_banded.py:398"        # _build_banded_wide_kernel
K2 = "kbe_tpu/ops/discfill_pallas.py:451"     # _build_gated_flagging_kernel
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


def assert_close(name, got, want):
    import torch

    if not torch.allclose(got, want, rtol=RTOL, atol=ATOL):
        raise AssertionError(f"{name}: max abs diff {max_err(got, want)} "
                             f"beyond rtol {RTOL}, atol {ATOL}")


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


def splat_phase(label, xyz, payload, valid, pose, replaces, rows):
    """Each splat kernel against its plain version on the same inputs."""
    import torch
    from kbe_torch.ops import splat as S

    n, c = payload.shape
    h = w = SIZE
    keys = S.zee_cuda(xyz, valid, pose, h, w, c)
    zee_p = S.zee_plain(xyz, valid, pose, h, w)
    zee_k = S.decode_keys(keys).reshape(h, w)
    e_zee = max_err(zee_k, zee_p)
    if not torch.equal(zee_k, zee_p):
        raise AssertionError(f"{label} zee: max abs diff {e_zee}")
    deg_k = S.degrid_cuda(keys, h, w, c)
    deg_p = S.degrid_plain(zee_k)
    e_deg = max_err(deg_k, deg_p)
    if not torch.equal(deg_k, deg_p):
        raise AssertionError(f"{label} degrid: max abs diff {e_deg}")
    acc_k = S.accumulate_cuda(xyz, valid, payload, pose, deg_k, h, w)
    acc_p = S.accumulate_plain(xyz, valid, payload, pose, deg_k, h, w)
    assert_close(f"{label} accumulate", acc_k, acc_p)
    e_acc = max_err(acc_k, acc_p)
    r_k, x_k = S.splat(xyz, payload, valid, pose, h, w)
    r_p = S.accumulate_plain(xyz, valid, payload, pose, S.degrid_plain(
        S.zee_plain(xyz, valid, pose, h, w)), h, w)
    want_r = (r_p[:, :c] / (r_p[:, c:] + 1e-7)).reshape(h, w, c)
    assert_close(f"{label} render", r_k, want_r)
    assert_close(f"{label} existing", x_k, r_p[:, c:].reshape(h, w, 1))
    e_render = max(max_err(r_k, want_r),
                   max_err(x_k, r_p[:, c:].reshape(h, w, 1)))
    holes = float((x_k == 0).float().mean())
    log(f"{label}: N={n} C={c} zee/degrid bit-equal, accumulate max diff "
        f"{e_acc:.3e}, render max diff {e_render:.3e} (held to rtol {RTOL},"
        f" atol {ATOL}), hole share {holes:.4f}")

    reps, preps = 20, 3
    ms_zee = timed(lambda: S.zee_cuda(xyz, valid, pose, h, w, c), reps)
    pms_zee = timed(lambda: S.zee_plain(xyz, valid, pose, h, w), preps)
    ms_deg = timed(lambda: S.degrid_cuda(keys, h, w, c), reps)
    pms_deg = timed(lambda: S.degrid_plain(zee_k), preps)
    ms_acc = timed(lambda: S.accumulate_cuda(xyz, valid, payload, pose,
                                             deg_k, h, w), reps)
    pms_acc = timed(lambda: S.accumulate_plain(xyz, valid, payload, pose,
                                               deg_k, h, w), preps)
    ms_all = timed(lambda: S.splat(xyz, payload, valid, pose, h, w), reps)
    log(f"{label}: kernel ms zee {ms_zee:.4f} degrid {ms_deg:.4f} "
        f"accumulate {ms_acc:.4f} whole render {ms_all:.4f}; plain ms zee "
        f"{pms_zee:.4f} degrid {pms_deg:.4f} accumulate {pms_acc:.4f}")
    hw = h * w
    tag = f"c{c}"
    for kern, err, ms, pms, nbytes, nops in (
            ("zee", e_zee, ms_zee, pms_zee, n * 16 + 20 + hw * 4, n * 20),
            ("degrid", e_deg, ms_deg, pms_deg, hw * 8, hw * 20),
            ("accumulate", e_acc, ms_acc, pms_acc,
             n * (16 + 4 * c) + 20 + hw * 4 + hw * (c + 1) * 4,
             n * (20 + 4 * 2 * (c + 1)))):
        b_ms, b_by = bound(nbytes, nops)
        rows.append({"name": f"splat_{kern}[{tag}]", "route": "cuda",
                     "source": SPLAT_SRC, "replaces": replaces,
                     "count_key": f"{kern}/{tag}", "max_abs_err": err,
                     "ms": ms, "plain_ms": pms, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": None})
    return r_k, x_k


def fill_phase(render, existing, roi, rows):
    import torch
    from kbe_torch.ops import discfill as D

    depth = (render[..., 3:4] * (existing > 0.0)).contiguous()
    render = render.contiguous()
    h, w, c = render.shape
    for r in (None, roi):
        got = D.fill_cuda(render, depth, 128, r)
        want = D.fill_plain(render, depth, 128, r)
        if not torch.equal(got, want):
            raise AssertionError(f"fill roi={r}: not bit-identical, max abs "
                                 f"diff {max_err(got, want)}")
    holes = int((depth <= 0).sum())
    marched = march_steps(depth, 128, roi)
    ms = timed(lambda: D.fill_cuda(render, depth, 128, roi), 20)
    pms = timed(lambda: D.fill_plain(render, depth, 128, roi), 2)
    log(f"fill: {h}x{w}x{c}, {holes} hole pixels, {marched} ray steps in "
        f"the ROI, bit-identical with and without ROI {roi}; kernel ms "
        f"{ms:.4f}, plain ms {pms:.4f}")
    # bytes: image and depth read once, image written once; operations:
    # each ray step is an add pair, a bounds test and a depth compare
    b_ms, b_by = bound(h * w * (2 * c + 1) * 4, marched * 4)
    rows.append({"name": "discfill", "route": "cuda", "source": FILL_SRC,
                 "replaces": K2, "count_key": "discfill",
                 "max_abs_err": 0.0, "ms": ms, "plain_ms": pms,
                 "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})


def kernel_phases(rows):
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
    # (b) the bootstrap splat: one grid, 68 channels, unscaled points plus
    # the shift
    xyz68, payload68, _ = make_cloud(1, 68, seed=2, shift=shift.cpu())
    pts = (xyz68.reshape(-1, 3) + shift).contiguous()
    zero = S.make_pose(torch.zeros(3, device="cuda"), FOCAL, BASELINE)
    splat_phase("(b) splat C=68", pts, payload68.reshape(-1, 68),
                torch.ones(SIZE * SIZE, device="cuda"), zero, K3, rows)
    # (c) the fill, on the rendered frame of (a)
    zoom = ZoomSettings.default_3d(SIZE, SIZE)
    fill_phase(render, existing, fill_roi_of(SIZE, SIZE, zoom,
                                             EffectConfig()), rows)
    # (d) run to run: float atomics reorder the accumulation
    r1, _ = S.render_posed(scene, pose, SIZE, SIZE)
    r2, _ = S.render_posed(scene, pose, SIZE, SIZE)
    log(f"(d) run-to-run max diff of two identical C=4 renders: "
        f"{max_err(r1, r2):.3e}")


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
    for kern in ("zee", "degrid", "accumulate"):
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
    import numpy as np
    import torch
    from kbe_torch.config import EffectConfig, ZoomSettings
    from kbe_torch.data import demo_scene_image
    from kbe_torch.ops.image_ops import ssim
    from kbe_torch.pipeline import KenBurnsPipeline

    size, steps = 256, 5
    effect = EffectConfig(num_steps=steps)
    image = demo_scene_image(size, size)
    out = {}
    for dev in ("cuda", "cpu"):
        pipe = KenBurnsPipeline.create(seed=0, effect=effect, device=dev)
        out[dev] = torch.as_tensor(pipe(image)).float() / 255.0
    scores = [float(ssim(out["cuda"][i:i + 1], out["cpu"][i:i + 1]))
              for i in range(steps)]
    diff = float((out["cuda"] - out["cpu"]).abs().max() * 255.0)
    mean = float(np.mean(scores))
    log(f"card vs CPU at {size}^2, f32, {steps} steps: mean SSIM "
        f"{mean:.6f} (per frame {[round(s, 6) for s in scores]}), max abs "
        f"diff {diff:.0f} of 255")
    if mean < 0.99:
        raise AssertionError(f"card vs CPU mean SSIM {mean} < 0.99")


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

    rows = []
    kernel_phases(rows)
    counts = main_path()
    log(f"tf32 after the effect: cudnn {torch.backends.cudnn.allow_tf32}, "
        f"matmul {torch.backends.cuda.matmul.allow_tf32}")
    card_vs_cpu()

    for row in rows:
        row["launches"] = counts.get(row.pop("count_key"), 0)
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
