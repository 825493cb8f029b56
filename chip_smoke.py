#!/usr/bin/env python3
"""Drive the kbe_torch port on one CUDA card and check it.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:
  1. device: require CUDA; print the card's name and power limit;
  2. build: compile ``kbe_torch/ops/csrc/*.cu`` with nvcc (sm_90a);
  3. kernels vs their plain PyTorch versions at the main path's shapes:
     (a) splat, C=4, a 3-grid 1024^2 cloud at a frame pose, its valid
         points alone, as ``render_posed`` splats them (no mask);
     (b) splat, C=68, one 1024^2 grid, no mask (the inpainting bootstrap);
     (c) fill at 1024^2, K=128, with and without the ROI (bit-identical);
     (d) two identical renders at C=4 and at C=68: bit-equal;
     (a2) splat, C=4, one grid at a pose with a focal of its own (dolly);
     (c2) fill of the (a2) render: one grid, no inpainted grids (dolly);
     (p) a pathological cloud: 65,536 points of a 1024^2 grid on one pixel;
     (k) the finish (quantise, crop, round, resize, round into uint8) of
         the (c) fill's frame, the default move's crop, against the plain
         chain (bit-equal);
     (k2) the finish of the (c2) fill's frame, dolly's crop;
  4. main path: the 1024^2, 75-frame effect at the production precision mix
     (f32 depth nets, bf16 inpainting nets), seeded random weights; checks
     the frames and that every kernel ran (77 renders of six splat
     kernels each: the front half's fill, zee and degrid, then count,
     place and sum; 75 fills, 75 finishes);
     prints the
     scene's size, each grid's valid share and the fill's holes a frame;
  5. card vs CPU: the default effect, dolly and partial-conv inpainting at
     256^2, f32, 5 steps, same weights, mean SSIM of the frames >= 0.99;
  6. the other entry points and inference modes:
     (e) every grid renderer (``render_grids_banded``, ``_routed`` at C=4
         and C=68, ``_pallas``, ``_delta``) on the card against the plain
         passes at 1024^2, six launches a call, then driven over the
         poses of a move for its launch count;
     (f) ``fill_disocclusion_pallas`` under every phase schedule, with and
         without the ROI, at 8 and 128 steps: bit-identical to the plain
         fill, one launch each;
     (g) the inference modes at 1024^2, 9 steps, production precision mix,
         through ``KenBurnsPipeline.__call__``: dolly, 2D, pretrained
         refine, partial conv, dual net, routed + the spec's whole-frame
         fill (``fill_impl='xla'``: the plain fill, no ``discfill``
         launch), delta, and the one-phase and fused fill schedules;
         frames and launch counts checked, the pose loop timed several
         times;
     (h) the ``'routed'`` effect against the ``'auto'`` one, same models,
         and two runs of the ``'auto'`` effect: equal frames;
     (i) ``load_scene`` and ``autozoom`` on the card (256 candidates), the
         C=3 coverage renders of three candidates against the plain passes,
         and the card's choice against the CPU's at 256^2;
     (j) the CLI's ``run`` at 256^2, defaults and ``--dolly``;
     (t) inpainting training through ``cli/train_torch.py``'s trainer and
         data at 384x512, batch 8 (full ContextNet, Inpaint, and
         MPDDiscriminator with spectral norm and VGG16): 3 supervised
         steps, then one D-only and two G+D adversarial iterations; ms a
         step, finite losses, moved parameters and launches checked (six
         forward splat kernels a batch item, one ``splat_grad`` a batch
         item on a G step). Three such runs: two from one seed under
         the training CLI's ``deterministic_training()``
         (``torch.use_deterministic_algorithms(True)``), whose losses and
         final states must be bit-equal, then one with the mode off, cuDNN
         free to pick its algorithms (the step times give the cost of
         determinism); ``splat_grad`` against ``splat_grad_plain`` and the
         CPU's autograd on the step's own cloud (C=68), on a masked C=4
         cloud and on the step's cloud with edge gradients (zeros,
         subnormals, values whose quotient overflows; and a fifth of the
         weight sums zeroed), and its row;
     (u) depth training at full width through the same CLI's trainer and
         data: 3 estimation steps at 384x512, batch 8, with the 'same'
         mask loss and one with 'other' added (full Semantics and
         Disparity lattice), twice from one seed, bit-equal; 3 refinement
         steps at 768x1024, batch 8 (full Refine behind the frozen
         Disparity); ms a step, finite losses, moved parameters, no splat
         launch; a validation of each mode (7 metrics) and its peak memory;
     (v) evaluation: the adversarial trainer's ``validation_adv`` of (t)
         over 4 validation batches with a real 2048-d FID (Inception on the
         card, ``sqrtm`` on the host, each timed; six forward splat kernels
         a batch item); ``InpaintEval.eval`` and
         ``get_inpaint(output_render_c=True)`` on (t)'s nets, whose halfway
         view C (``generate_view_c``, C=4 over two merged clouds) is
         bit-equal to the same function on the CPU, then timed as its
         row; ``DepthEval.eval`` of (u)'s nets on two batches at 768x1024;
     (w) Mask R-CNN instance masks: a synthetic torchvision-layout
         ``.pth`` (seeded, full width) loaded through
         ``cli/train_torch.py``'s ``resolve_mask_source`` (512^2 canvas);
         kernel ``nms`` bit-equal to its plain loop on the card, on a real
         forward's five RPN sets and its box set and on tie, zero-slot,
         full-overlap and 1000-slot sets, and its two rows; the forward on
         the card against the CPU on a 512^2 noise image (FPN features 1e-4
         relative, equal labels, boxes within 1e-2 px, masks equal on
         99.9 %; a synthetic item's canvas reported beside it); a forward
         and the source per item timed; 3 'same' estimation steps and one
         with 'other' at 384x512, batch 8, on the source's masks computed
         in ``Prefetcher``'s thread, twice from one seed, bit-equal, with
         masks and mask losses not zero and two NMS launches an image;
     (x) data parallel (``kbe_torch.parallel``): one NCCL rank in this
         process through ``data_parallel_step``, the G+D iteration and an
         estimation step ('same') at 384x512, batch 8, bit-equal to the
         trainers without a mesh, both timed; two gloo ranks on the card
         (subprocesses, 4 + 4) held to the 1-rank step, run by rank 0
         after its own, whose per-sample nets and D's convolutions and
         batch statistics run in the ranks' parts (losses rtol 1e-5,
         gradients 1e-4 relative L2 a leaf, D's leaves where the f32 runs
         part further refereed by D's float64 gradient, batch norms rtol
         1e-5, states bit-equal across the ranks, six forward splat
         kernels and one ``splat_grad`` a local item);
         ``batch_parallel_effect`` of 4 images at 256^2, 5 steps, on the
         two ranks, equal to the single-image effect;
     (y) trained weights: ``tools/make_bench_weights_torch.py``'s recipe at
         a short schedule, twice from one seed, bit-equal checkpoints; the
         checkpoint found by ``find_bench_weights`` (``KBE_BENCH_WEIGHTS``);
         the 1024^2, 75-frame effect at the production mix from it through
         ``KenBurnsPipeline.create(checkpoint=...)``, its launch counts (77
         renders, 75 fills), frames/s, valid points per grid and hole
         pixels a frame; ``cli/kbe_torch.py``'s ``run --checkpoint`` at
         256^2 equal to the loaded pipeline's frames; and
         ``tools/fidelity_report_torch.py``'s production path against its
         spec path at 256^2, 9 steps, mean SSIM >= 0.99;
     (z) the spec path (``splat_method='scatter'``, ``fill_impl='xla'``,
         f32 nets) at 256^2, 9 steps, seeded random weights: no
         hand-written kernel launched; the production path with the same
         f32 nets against it, mean SSIM >= 0.999; then
         ``tools/profile_frontend_torch.py``'s and
         ``tools/profile_frame_torch.py``'s functions once on that scene,
         their stages' hand-written launches against the main path's
         counts (a C=68 render in each bootstrap step's ``splat68``; a
         C=4 render in ``splat`` and a ``discfill`` in ``fill`` a frame);
  7. the ``{"kernels": [...]}`` line, then the device line last. A row's
     ``launches`` are those of the run named in its ``path``, counted from
     zero just before that run. ``ms`` is the call's time (CUDA events
     around the Python wrapper), ``device_ms`` the time of the row's own
     kernels on the device (``torch.profiler`` over the same number of
     calls), ``device_all_ms`` that of every kernel the call launches.

The later phases take ``size`` and ``device`` arguments, so each runs
alone on the card, or at a small size on the CPU, from Python (the kernels
build at first use): ``CUBLAS_WORKSPACE_CONFIG=:4096:8 python3 -c "import
chip_smoke as cs; t = cs.training_phase([]); cs.evaluation_phase([], t,
cs.depth_phase())"`` runs (t), (u) and (v) alone, ``... -c "import
chip_smoke as cs; cs.maskrcnn_phase([])"`` runs (w) alone, and ``... -c
"import chip_smoke as cs; cs.dp_phase()"`` runs (x) alone, and ``... -c
"import chip_smoke as cs; cs.trained_weights_phase()"`` runs (y) alone,
and ``... -c "import chip_smoke as cs; cs.spec_phase({})"`` runs (z)
alone (with no main-path counts to hold the tools' launches to, as on the
CPU: ``cs.spec_phase({}, size=32, steps=3, device="cpu")``).

Tolerances: none for the kernels. Every kernel is exact (``nms`` against
its plain loop on the card; ``splat_grad`` too, against the
plain gather on the card and the CPU's autograd of the plain render): the
front half's z-buffer keys and its degridded buffer, and the fill, are bit-equal to their plain versions
on the card (the keys and the degrid compared apart), and the accumulation (the
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
FRONT_KERNELS = ("splat_fill", "splat_zee", "splat_degrid")
FILL_SRC = "kbe_torch/ops/csrc/discfill.cu"
FINISH_SRC = "kbe_torch/ops/csrc/finish.cu"


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


def device_events(fn, reps: int):
    """The device intervals (name, start us, end us) of ``reps`` calls of
    ``fn``, from ``torch.profiler``: a warm-up step of ``reps`` calls,
    which the profiler drops (a profile's first kernels can go missing),
    then the recorded one, each after an idle gap on the host (a recorded
    step has kept only its last calls' kernels, as if its window opened
    late). Each kernel must come a multiple of ``reps`` times; a profile
    that lost some is taken again, four times at most."""
    import collections

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):
                time.sleep(0.05)
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        # the device timeline also holds the schedule's step annotation
        events = [(e.name, e.time_range.start, e.time_range.end)
                  for e in prof.events() if e.device_type == DeviceType.CUDA
                  and not e.name.startswith("ProfilerStep")]
        counts = collections.Counter(name for name, _, _ in events)
        if events and all(n % reps == 0 for n in counts.values()):
            return events
    raise AssertionError(f"profiles of {reps} calls lost kernels: {counts}")


def device_times(fn, reps: int):
    """{kernel name: mean device ms a call of ``fn``} over ``reps``
    calls (``device_events``)."""
    times = {}
    for name, start, end in device_events(fn, reps):
        times[name] = times.get(name, 0.0) + (end - start) / reps / 1e3
    return times


def device_ms(fn, reps: int, kernels):
    """(own, all): the mean device ms a call of ``fn`` spends in the
    kernels whose names contain one of ``kernels``, and in every kernel it
    launches."""
    times = device_times(fn, reps)
    own = sum(t for name, t in times.items()
              if any(k in name for k in kernels))
    if own == 0.0:
        raise AssertionError(f"no device time in kernels {kernels}; the "
                             f"profile holds {sorted(times)}")
    return own, sum(times.values())


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


def assert_equal(name, got, want, nan: bool = False):
    """Bit equality; ``want`` may live on the CPU. With ``nan``, NaN where
    ``want`` has NaN, and equal values elsewhere."""
    import torch

    got = got.to(want.device)
    if nan and torch.equal(got.isnan(), want.isnan()):
        got = torch.where(got.isnan(), 0.0, got)
        want = torch.where(want.isnan(), 0.0, want)
    if not torch.equal(got, want):
        raise AssertionError(f"{name}: not bit-equal, max abs diff "
                             f"{max_err(got, want)} in "
                             f"{int((got != want).sum())} elements")


def accumulate_on_cpu(xyz, valid, payload, pose, zee, h: int, w: int):
    """``accumulate_plain`` on CPU copies of the inputs: the CPU's
    ``index_add_`` sums each pixel's entries in ascending entry order, the
    order the card's sum pass reproduces (on the card it uses atomics)."""
    from kbe_torch.ops import splat as S

    return S.accumulate_plain(xyz.cpu(), None if valid is None
                              else valid.cpu(), payload.cpu(), pose.cpu(),
                              zee.cpu(), h, w)


def splat_compare(label, xyz, payload, valid, pose, h: int, w: int):
    """Each splat kernel against its plain version on the same inputs (the
    sums against the CPU's), and the whole render through ``splat``: all
    bit-equal; the front half's keys and degridded buffer apart. Returns
    the kernels' outputs."""
    import torch
    from kbe_torch.ops import splat as S

    n, c = payload.shape
    counts = torch.full((h * w,), -1, dtype=torch.int32, device=xyz.device)
    keys, deg_k = S.front_cuda(xyz, valid, pose, h, w, c, counts=counts)
    zee_p = S.zee_plain(xyz, valid, pose, h, w)
    assert_equal(f"{label} front keys", S.decode_keys(keys).reshape(h, w),
                 zee_p)
    assert_equal(f"{label} front degrid", deg_k, S.degrid_plain(zee_p))
    if bool(counts.any()):
        raise AssertionError(f"{label} front: counts not zeroed")
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
    live = n if valid is None else int((valid > 0).sum())
    log(f"{label}: N={n} ({live} valid, "
        f"{'a mask' if valid is not None else 'no mask'}) C={c} front keys/"
        f"front degrid/accumulate/render bit-equal to the plain passes (sums "
        f"on the CPU); {entries} visible entries, longest segment {longest}; "
        f"hole share {1.0 - covered / (h * w):.4f}")
    return counts, deg_k, r_k, x_k


def zeroed_counts(calls: int, hw: int):
    """A function that hands out a new (H*W,) int32 buffer of zeros a
    call, ``calls`` of them made in advance: the counts that ``splat``'s
    front half zeroes for the count pass, so that a timed accumulation
    launches no fill a render does not make."""
    import torch

    pool = iter(torch.zeros((calls, hw), dtype=torch.int32, device="cuda"))
    return lambda: next(pool)


def splat_phase(label, xyz, payload, valid, pose, replaces, rows,
                entry=None, **extra):
    """Each splat kernel against its plain version on the same inputs, then
    timed. ``replaces`` is one TPU kernel, or one per row (front,
    accumulate); ``entry`` names the entry point in the rows of a path off
    the main one, whose launch counts the caller fills in; ``extra`` keys
    go into each row. The front row times the call as ``splat`` makes
    it (the counts zeroed too); the accumulate row times the count, place
    and sum passes together on counts zeroed in advance, as ``splat``
    hands them on (and each pass alone beside it). A row's launches are
    its last kernel's, and each of its kernels' are listed beside them."""
    import torch
    from kbe_torch.ops import splat as S

    n, c = payload.shape
    h = w = SIZE
    counts, deg_k, r_k, x_k = splat_compare(label, xyz, payload, valid, pose,
                                            h, w)
    hw = h * w
    buf = torch.empty((hw,), dtype=torch.int32, device=xyz.device)

    def front():
        return S.front_cuda(xyz, valid, pose, h, w, c, counts=buf)

    def acc(zeros):
        return lambda: S.accumulate_cuda(xyz, valid, payload, pose, deg_k,
                                         h, w, counts=zeros())

    reps, preps = 20, 3
    ms_front = timed(front, reps)
    front_times = device_times(front, reps)
    dev_phases = {k: sum(t for name, t in front_times.items() if k in name)
                  for k in FRONT_KERNELS}
    if not all(dev_phases.values()):
        raise AssertionError(f"{label}: the front's kernels are missing from "
                             f"the profile's {sorted(front_times)}")
    dev_front = (sum(dev_phases.values()), sum(front_times.values()))
    pms_front = timed(lambda: S.degrid_plain(S.zee_plain(xyz, valid, pose,
                                                         h, w)), preps)
    zeros = zeroed_counts(reps + 1, hw)
    ms_count = timed(lambda: S.count_cuda(xyz, valid, pose, deg_k, h, w, c,
                                          counts=zeros()), reps)
    ms_place = timed(lambda: S.place_cuda(xyz, valid, pose, deg_k, counts,
                                          h, w, c), reps)
    starts, keys_s = S.place_cuda(xyz, valid, pose, deg_k, counts, h, w, c)
    ms_sum = timed(lambda: S.sum_cuda(payload, counts, starts, keys_s, h, w),
                   reps)
    ms_acc = timed(acc(zeroed_counts(reps + 1, hw)), reps)
    # device_events: at most three tries of a warm-up and a recorded step
    dev_acc = device_ms(acc(zeroed_counts(6 * reps, hw)), reps,
                        ("splat_route", "splat_sum"))
    pms_acc = timed(lambda: S.accumulate_plain(xyz, valid, payload, pose,
                                               deg_k, h, w), preps)
    ms_all = timed(lambda: S.splat(xyz, payload, valid, pose, h, w), reps)
    log(f"{label}: kernel ms front {ms_front:.4f} (device {dev_front[0]:.4f}"
        f": {', '.join(f'{k} {t:.4f}' for k, t in dev_phases.items())})"
        f" accumulate {ms_acc:.4f} (device {dev_acc[0]:.4f}; count "
        f"{ms_count:.4f}, scan+place {ms_place:.4f}, sum {ms_sum:.4f}) whole "
        f"render {ms_all:.4f}; plain ms front {pms_front:.4f} accumulate "
        f"{pms_acc:.4f}")
    live = n if valid is None else int((valid > 0).sum())
    tag = f"c{c}"
    if isinstance(replaces, str):
        replaces = (replaces,) * 2
    # the front half's bytes: the mask if one is passed, the xyz of the
    # valid points, the pose, and the keys, the degridded buffer and the
    # counts written once each
    front_bytes = (0 if valid is None else 4 * n) + 12 * live + 20 + 3 * hw * 4
    for (kern, key, ms, dev, pms, nbytes, nops), repl in zip((
            ("front", "degrid", ms_front, dev_front, pms_front, front_bytes,
             live * 20 + hw * 20),
            ("accumulate", "sum", ms_acc, dev_acc, pms_acc,
             n * (16 + 4 * c) + 20 + hw * 4 + hw * (c + 1) * 4,
             n * (20 + 4 * 2 * (c + 1)))), replaces):
        b_ms, b_by = bound(nbytes, nops)
        row = {"name": f"splat_{kern}[{tag}]", "route": "cuda",
               "source": SPLAT_SRC, "replaces": repl,
               "count_key": f"{key}/{tag}", "max_abs_err": 0.0,
               "ms": ms, "device_ms": dev[0], "device_all_ms": dev[1],
               "plain_ms": pms, "bound_ms": b_ms,
               "bound_by": b_by, "library_ms": None}
        if kern == "front":
            # the front half's kernels: fill, zee, degrid
            row.update(kernel_device_ms=dev_phases, points=n,
                       valid_points=live, mask=valid is not None,
                       pass_keys=[f"{k}/{tag}"
                                  for k in ("fill", "zee", "degrid")],
                       bound_note="fill (keys + counts) + zee (4 B mask a "
                       "point if a mask is passed, 12 B xyz a valid point) "
                       "+ degrid (f32 written)")
        else:
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
    dev = device_ms(lambda: D.fill_cuda(render, depth, 128, roi), 20,
                    ("discfill",))
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
           "ms": ms, "device_ms": dev[0], "device_all_ms": dev[1],
           "plain_ms": pms, "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": None, "march_steps_full": full_march,
           "march_steps": marched, "warp_rounds": rounds}
    row.update(extra)
    rows.append(row)


def finish_bytes(taps, h: int, w: int) -> int:
    """The least bytes of a finish: the crop's window of the filled frame
    read once (its rgb, 12 B a pixel) and the uint8 frame written once (3 B
    a pixel)."""
    (ylo, yhi, _, _), (xlo, xhi, _, _) = taps.crop_y, taps.crop_x
    rows = int(yhi.max()) - int(ylo.min()) + 1
    cols = int(xhi.max()) - int(xlo.min()) + 1
    return rows * cols * 12 + h * w * 3


def finish_phase(label, filled, zoom, rows, name="finish", **extra):
    """The finish of a filled frame (H, W, 4) under ``zoom``'s crop: the
    kernel against the plain chain (bit-equal), then timed, writing into a
    frame of its own."""
    import torch
    from kbe_torch.ops import finish as F
    from kbe_torch.pipeline.kenburns import frame_taps

    h, w = filled.shape[0], filled.shape[1]
    taps = frame_taps(h, w, zoom, filled.device)
    plan = F.finish_plan(taps)
    out = torch.empty((h, w, 3), dtype=torch.uint8, device=filled.device)
    want = F.finish_plain(filled, taps)
    if not torch.equal(F.finish_cuda(filled, plan, out), want):
        raise AssertionError(f"{label}: not bit-equal to the plain chain, "
                             f"{int((out != want).sum())} values differ")
    ms = timed(lambda: F.finish_cuda(filled, plan, out), 20)
    dev = device_ms(lambda: F.finish_cuda(filled, plan, out), 20,
                    ("finish_kernel",))
    pms = timed(lambda: F.finish_plain(filled, taps), 2)
    nbytes = finish_bytes(taps, h, w)
    b_ms, b_by = bound(nbytes, 0)
    log(f"{label}: {h}x{w} from a {plan.crop_height}x{plan.crop_width} "
        f"crop, tiles "
        f"{F.TILE}, {4 * (plan.a_floats + plan.b_floats)} B of shared "
        f"memory a block; bit-equal to the plain chain; kernel ms {ms:.4f} "
        f"(device {dev[0]:.4f}), plain ms {pms:.4f}, bound {b_ms:.4f} "
        f"({nbytes} B)")
    row = {"name": name, "route": "cuda", "source": FINISH_SRC,
           "replaces": None,
           "replaces_note": "none: kbe_tpu finishes a frame in XLA (the "
                            "uint8 quantise, crop_rect_subpix_mm, "
                            "resize_bilinear)",
           "count_key": "finish", "max_abs_err": 0.0, "ms": ms,
           "device_ms": dev[0], "device_all_ms": dev[1], "plain_ms": pms,
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
           "tile": list(F.TILE), "bytes": nbytes}
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
    render, existing = splat_phase("(a) splat C=4", scene.kept_xyz,
                                   scene.kept_payload, None, pose, K1, rows)
    # (a2) the dolly loop's splat: one grid, no inpainted grids behind it,
    # and a focal of the step's own in the pose
    xyz1, payload1, valid1 = make_cloud(1, 4, seed=3, shift=shift.cpu())
    scene1 = S.prepare_scene(xyz1, payload1, valid1)
    splat_phase("(a2) splat C=4, one grid, dolly focal", scene1.kept_xyz,
                scene1.kept_payload, None,
                S.make_pose(shift, FOCAL * 1.21875, BASELINE), K1, more,
                entry="render_posed", mode="dolly")
    # (b) the bootstrap splat: one grid, 68 channels, unscaled points plus
    # the shift, no mask
    xyz68, payload68, _ = make_cloud(1, 68, seed=2, shift=shift.cpu())
    pts = (xyz68.reshape(-1, 3) + shift).contiguous()
    zero = S.make_pose(torch.zeros(3, device="cuda"), FOCAL, BASELINE)
    splat_phase("(b) splat C=68", pts, payload68.reshape(-1, 68), None,
                zero, K3, rows)
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
    # (k), (k2) the finish of the (c) and (c2) fills' frames
    from kbe_torch.ops import discfill as D
    for label, rend, ex, z, eff, out_rows, kw in (
            ("(k) finish", render, existing, zoom, EffectConfig(), rows, {}),
            ("(k2) finish, dolly frame", render1, existing1,
             ZoomSettings.default_dolly(SIZE, SIZE), EffectConfig(dolly=True),
             more, {"name": "finish/dolly", "mode": "dolly"})):
        depth = (rend[..., 3:4] * (ex > 0.0)).contiguous()
        filled = D.fill_cuda(rend.contiguous(), depth, 128,
                             fill_roi_of(SIZE, SIZE, z, eff))
        finish_phase(label, filled, z, out_rows, **kw)
    # (d) run to run: two identical renders at each width
    for c, again in ((4, lambda: S.render_posed(scene, pose, SIZE, SIZE)),
                     (68, lambda: S.splat(pts, payload68.reshape(-1, 68),
                                          None, zero, SIZE, SIZE))):
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
    from kbe_torch.pipeline import KenBurnsPipeline

    pipe = KenBurnsPipeline.create(seed=0, dtype=torch.bfloat16,
                                   depth_dtype=torch.float32, device="cuda")
    image_np = demo_scene_image(SIZE, SIZE)
    pipe(image_np)  # warm-up: builds the kernels' tables, cuDNN plans
    torch.cuda.synchronize()

    # the counted run, through the user's entry point
    clear_launches()
    t0 = time.perf_counter()
    frames = pipe(image_np)
    wall = time.perf_counter() - t0
    counts = launch_counts()
    log(f"main path launch counts: {json.dumps(counts, sort_keys=True)}")
    for kern in SPLAT_PASSES:
        c4, c68 = counts.get(f"{kern}/c4", 0), counts.get(f"{kern}/c68", 0)
        if (c4, c68) != (STEPS, 2):
            raise AssertionError(f"splat_{kern}: {c4} frame + {c68} "
                                 f"bootstrap launches, want {STEPS} + 2")
    for kern in ("discfill", "finish"):
        if counts.get(kern, 0) != STEPS:
            raise AssertionError(f"{kern}: {counts.get(kern)} launches, "
                                 f"want {STEPS}")
    if frames.shape != (STEPS, SIZE, SIZE, 3) or frames.dtype != np.uint8:
        raise AssertionError(f"frames {frames.shape} {frames.dtype}")
    if int(frames.max()) == int(frames.min()):
        raise AssertionError("frames are constant")

    # timing on the card: the two halves of the effect, frames left there;
    # then the scene's valid points and the fill's holes
    from kbe_torch.pipeline.kenburns import path_stats

    zoom = ZoomSettings.default_3d(SIZE, SIZE)
    stats = path_stats(pipe.effect_fn(SIZE, SIZE, zoom), pipe.models,
                       torch.as_tensor(image_np, device="cuda")[None], SIZE,
                       SIZE, zoom, pipe.effect)
    log(f"main path scene: {len(stats['valid_points_per_grid'])} grids of "
        f"{SIZE}^2 = {stats['points']} points, {stats['valid_points']} valid "
        f"({stats['valid_points'] / stats['points']:.6f}), which the frame "
        f"loop splats with no mask; valid share per grid "
        f"{[round(v, 6) for v in stats['valid_share_per_grid']]}; hole "
        f"pixels a frame in the fill's ROI {stats['fill_roi']}: "
        f"{stats['hole_pixels_a_frame']:.1f} (most "
        f"{stats['hole_pixels_max_frame']})")
    total = min(stats["runs_s"])
    log(f"main path {SIZE}^2 x {STEPS} frames, bf16 inpainting + f32 depth: "
        f"best of 2 {total:.4f} s = {stats['frames_per_s']:.3f} frames/s "
        f"(front end {stats['front_end_s']:.4f} s, pose loop "
        f"{stats['pose_loop_ms_a_frame']:.3f} ms/frame); all runs "
        f"{[round(t, 4) for t in stats['runs_s']]}; the counted run through "
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
    from kbe_torch.ops import discfill, finish, nms, splat

    counts = dict(splat.LAUNCHES)
    counts.update(discfill.LAUNCHES)
    counts.update(nms.LAUNCHES)
    counts.update(finish.LAUNCHES)
    return counts


def clear_launches():
    from kbe_torch.ops import discfill, finish, nms, splat

    splat.LAUNCHES.clear()
    discfill.LAUNCHES.clear()
    nms.LAUNCHES.clear()
    finish.LAUNCHES.clear()


def expect_counts(label, want):
    got = launch_counts()
    if got != want:
        raise AssertionError(f"{label}: launches {got}, want {want}")


def settle(row, counts) -> None:
    """A row's launches from the counts of its path's run, and each of its
    kernels' beside them."""
    key = row.pop("count_key", None)
    keys = row.pop("pass_keys", None)
    if key is None:
        return
    row["launches"] = counts.get(key, 0)
    if keys:
        row["pass_launches"] = {k: counts.get(k, 0) for k in keys}


# the kernels of a render, as ``splat.LAUNCHES`` counts them
SPLAT_PASSES = ("fill", "zee", "degrid", "count", "place", "sum")


def splat_counts(c: int, n: int):
    return {f"{k}/c{c}": n for k in SPLAT_PASSES}


def grid_renderer_phases(rows):
    """(e) every ``render_grids_*`` generation on the card: the kernels
    against the plain passes, the entry point's own output against the
    plain render (all bit-equal, the sums on the CPU), its six launches,
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
         (K7_ZEE, K7_ACC)),
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
            f"false, 6 launches a call, {n} calls driven")


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
        dev = device_ms(call, 20, ("discfill",))
        rows.append({"name": f"discfill/fill_disocclusion_pallas[{name}]",
                     "route": "cuda", "source": FILL_SRC,
                     "replaces": replaces, "count_key": "discfill",
                     "entry": "fill_disocclusion_pallas", "mode": mode,
                     "max_abs_err": err, "ms": ms, "device_ms": dev[0],
                     "device_all_ms": dev[1], "plain_ms": pms,
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
        want = splat_counts(4, MODE_STEPS)
        want["finish"] = MODE_STEPS
        if effect.fill_impl != "xla":   # 'xla' is the spec: the plain fill
            want["discfill"] = MODE_STEPS
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
        f"{chosen} in {wall:.4f} s, {grid * grid} x 6 launches")

    if on_card:
        camera = scene["camera"]
        su, sv, ok, cam_shifts = candidate_shifts(
            window, 1.25, size / 10.0, scene["anchor"], size, size, camera,
            grid, device)
        xyz, payload = flat_cloud(scene["unaltered_points"], scene["image"])
        best = int(np.argmin(
            np.abs(su - (chosen.center_u - window.center_u))
            + np.abs(sv - (chosen.center_v - window.center_v))))
        inside = np.flatnonzero(ok)
        for i in (int(inside[0]), int(inside[-1])):
            splat_compare(f"(i) candidate {i}", xyz, payload, None,
                          make_pose(cam_shifts[i], camera.focal,
                                    camera.baseline), size, size)
        splat_phase(f"(i) chosen candidate {best}", xyz, payload, None,
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


TRAIN_SIZE = (384, 512)     # cli/train_torch.py's synthetic inpainting size
TRAIN_BATCH = 8             # its default batch
SUP_STEPS = 3
SPLAT_SPEC = "kbe_tpu/ops/splat.py:106"   # _accumulate_pass, under jax.grad


def _train_args(mode: str, device: str, logs: str, *more,
                batch: int = TRAIN_BATCH):
    from cli import train_torch as cli

    return cli.build_parser().parse_args(
        ["--training-mode", mode, "--synthetic", "--device", device,
         "--batch-size", str(batch), "--logs-path", logs, *more])


def _params_of(state):
    return [p.detach().clone() for p in state.parameters()]


def _moved(before, state) -> float:
    return max(float((a - p.detach()).abs().max())
               for a, p in zip(before, state.parameters()))


def _check_losses(label, metrics):
    import math

    values = {k: float(v) for k, v in metrics.items()}
    bad = [k for k, v in values.items() if not math.isfinite(v)]
    if bad:
        raise AssertionError(f"{label}: losses not finite: {bad} {values}")
    return values


def _sync(device: str):
    import torch

    if device == "cuda":
        torch.cuda.synchronize()


def _deterministic(on: bool, device: str):
    """The training CLI's deterministic mode on the card (deterministic
    cuDNN convolutions and upsampling backward; an op with none raises), or
    off, cuDNN free to pick its fastest convolutions."""
    from kbe_torch.device import deterministic_training

    if device == "cuda":
        deterministic_training(on)


def _step(label, fn, before_states, device, want_counts):
    """Run one training step ``fn()``; check its launches and that the
    states moved; returns (result, ms, losses)."""
    clear_launches()
    befores = [_params_of(st) for st in before_states]
    _sync(device)
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    ms = (time.perf_counter() - t0) * 1e3
    if device != "cuda":  # a rehearsal: the plain path counts none
        want_counts = {}
    expect_counts(label, want_counts)
    moved = [_moved(b, st) for b, st in zip(befores, before_states)]
    return out, ms, moved


class TrainRun:
    """What one run of (t) leaves: its losses and step times in order,
    its final states, and the adversarial trainer, state and last batch
    for the backward kernel's check and for (v)."""

    def __init__(self):
        self.losses, self.times, self.states = [], [], []
        self.upstreams = []

    def record(self, kind, ms, losses):
        self.times.append((kind, ms))
        self.losses.append((kind, losses))


class RecordUpstreams:
    """While on, every ``splat_grad`` call appends its points and its
    upstream gradient (the G loss's gradient with respect to the render)
    to ``calls``, then runs as before."""

    def __init__(self, calls: list, on: bool = True):
        self.calls, self.on = calls, on

    def __enter__(self):
        from kbe_torch.ops import splat as S

        self.inner = S.splat_grad
        if self.on:
            def spy(xyz, valid, pose, zee, existing, grad, h, w):
                self.calls.append((xyz, grad))
                return self.inner(xyz, valid, pose, zee, existing, grad, h,
                                  w)
            S.splat_grad = spy

    def __exit__(self, *exc):
        from kbe_torch.ops import splat as S

        S.splat_grad = self.inner


def _train_once(size, device: str, deterministic: bool, logs: str,
                quiet: bool = False, record: bool = False) -> TrainRun:
    """Three supervised steps, then three adversarial iterations with
    ``pretrain_steps=0`` and ``balance_steps=1`` (one D-only, two G+D),
    from the CLI's seeds and data. ``record``: keep the last iteration's
    ``splat_grad`` calls (``RecordUpstreams``) in ``upstreams``."""
    from cli import train_torch as cli
    from kbe_torch.train.trainer_inpaint import TRAIN_CAMERA, to_device

    h, w = size
    b = TRAIN_BATCH
    run = TrainRun()
    tag = "deterministic" if deterministic else "cuDNN free"
    say = (lambda *a: None) if quiet else log
    _deterministic(deterministic, device)
    # supervised
    args = _train_args("inpainting", device, logs + "/sup")
    cli.SYNTHETIC_SIZE["inpainting"] = size
    trainer = cli.make_trainer(args)
    data, _, _ = cli.make_data(args, "inpainting", TRAIN_CAMERA)
    state = trainer.init_state(size)
    for i in range(SUP_STEPS):
        batch = to_device(next(data), trainer.device)
        label = f"(t) supervised step {i}"
        (state, metrics), ms, (moved,) = _step(
            label, lambda: trainer.supervised_step(state, batch), [state],
            device, {})
        losses = _check_losses(label, metrics)
        if not moved > 0.0:
            raise AssertionError(f"{label}: parameters did not move")
        run.record("supervised", ms, losses)
        say(f"{label} at {h}x{w}, batch {b}, {tag}: {ms:.1f} ms; losses "
            f"{json.dumps(losses)}; parameters moved (max {moved:.3g}); "
            "launches none (masks in plain PyTorch)")
    run.states.append(state)
    del trainer

    # adversarial
    args = _train_args("inpainting_ref", device, logs + "/adv")
    trainer = cli.make_trainer(args, pretrain_steps=0, balance_steps=1)
    data, _, _ = cli.make_data(args, "inpainting", TRAIN_CAMERA)
    g_state = trainer.init_state(size)
    d_state = trainer.init_disc_state(size)
    run.gd_counts = {}
    for i in range(3):
        batch = to_device(next(data), trainer.device)
        do_g = trainer._want_g_update()
        if do_g != (i > 0):
            raise AssertionError(f"(t) iteration {i}: G update {do_g}")
        kind = "G+D" if do_g else "D-only"
        want = splat_counts(68, b)
        if do_g:
            want[GRAD_KEY] = b
        label = f"(t) {kind} iteration {i}"
        with RecordUpstreams(run.upstreams, record and i == 2):
            (g_state, d_state, metrics), ms, (g_moved, d_moved) = _step(
                label, lambda: trainer.adversarial_step(g_state, d_state,
                                                        batch, do_g),
                [g_state, d_state], device, want)
        counts = launch_counts()
        if do_g:
            for k, v in counts.items():
                run.gd_counts[k] = run.gd_counts.get(k, 0) + v
        trainer.iter_nb += 1
        losses = _check_losses(label, metrics)
        if not d_moved > 0.0 or (g_moved > 0.0) != do_g:
            raise AssertionError(f"{label}: G moved {g_moved}, D moved "
                                 f"{d_moved}")
        run.record(kind, ms, losses)
        say(f"{label} at {h}x{w}, batch {b}, {tag}: {ms:.1f} ms; losses "
            f"{json.dumps(losses)}; G moved {g_moved:.3g}, D moved "
            f"{d_moved:.3g}; launches {json.dumps(counts)}")
    run.states += [g_state, d_state]
    run.trainer, run.g_state, run.batch = trainer, g_state, batch
    _deterministic(False, device)
    return run


def _module_states(state):
    """Every tensor of a trainer state's modules (parameters, the
    discriminator's batch and spectral norms) and its optimizer moments."""
    mods = [getattr(state, k) for k in ("context", "net", "disc")
            if hasattr(state, k)]
    out = [t for m in mods for t in m.state_dict().values()]
    return out + list(state.opt_state["mu"]) + list(state.opt_state["nu"])


def assert_runs_equal(label, a: TrainRun, b: TrainRun):
    """Two runs from one seed: every loss and every tensor of the final
    states bit-equal."""
    import torch

    if a.losses != b.losses:
        raise AssertionError(f"{label}: losses differ between two runs: "
                             f"{a.losses} vs {b.losses}")
    n = 0
    for sa, sb in zip(a.states, b.states):
        for x, y in zip(_module_states(sa), _module_states(sb)):
            if not torch.equal(x, y):
                raise AssertionError(f"{label}: a state tensor differs "
                                     f"between two runs, max diff "
                                     f"{max_err(x, y)}")
            n += 1
    log(f"{label}: two runs from one seed bit-equal: {len(a.losses)} steps'"
        f" losses and {n} tensors of the final states (parameters, norm "
        "state, Adam moments)")


def _step_ms(run: TrainRun):
    """{kind: [ms, ...]} of a run, in order."""
    out = {}
    for kind, ms in run.times:
        out.setdefault(kind, []).append(round(ms, 1))
    return out


def training_phase(rows, size=TRAIN_SIZE, device: str = "cuda"):
    """(t) inpainting training, the path of ``cli/train_torch.py`` (its
    trainer, its synthetic data) at full width: ``ContextNet``, the full
    ``Inpaint`` grid-net, ``MPDDiscriminator`` with spectral norm and its
    VGG16, ``size``, batch 8. A run is three supervised steps, then three
    adversarial iterations with ``pretrain_steps=0`` and
    ``balance_steps=1`` (one D-only, two G+D); each step: ms, finite
    losses, parameters moved, its launches (none in a supervised step,
    whose masks are plain PyTorch; six forward splat kernels a batch item
    in an adversarial one, and one ``grad`` a batch item in a G+D one).
    Three runs: two under ``torch.use_deterministic_algorithms(True)`` from
    one seed, as the training CLI trains, whose losses and final states
    must be bit-equal, then one with the mode off, cuDNN free to pick its
    algorithms; the step times of the second and the third (both warm)
    give the cost of determinism. Then ``splat_grad`` on the
    last step's own cloud (C=68) and on a masked C=4 cloud, against
    ``splat_grad_plain`` and the CPU's autograd, and its row. Returns the
    last run (its adversarial trainer and state go on to (v))."""
    import tempfile

    import torch

    with tempfile.TemporaryDirectory() as logs:
        first = _train_once(size, device, True, logs + "/det1", record=True)
        second = _train_once(size, device, True, logs + "/det2", quiet=True)
        assert_runs_equal("(t) training", first, second)
        upstreams = first.upstreams
        del first
        free = _train_once(size, device, False, logs + "/free")
        log(f"(t) ms a step, deterministic (second run): "
            f"{json.dumps(_step_ms(second))}; cuDNN free (third run): "
            f"{json.dumps(_step_ms(free))}")
        del free
        if device == "cuda":
            torch.cuda.empty_cache()
        grad_phase(rows, second.trainer, second.g_state, second.batch,
                   second.gd_counts, device, upstreams)
    return second


GRAD_KEY = "grad/c68"


def step_points(batch, camera):
    """Item 0's points of ``render_view_b`` in the adversarial step: the
    pixel grid's valid points, shifted by the full step's camera move."""
    import torch
    from kbe_torch.train import view_synthesis as V

    with torch.no_grad():
        shift = V.batch_full_shift(batch["zoom"], batch["depth"], camera)
        pts = V._valid_points(batch["disparity"], batch["depth"], camera,
                              0.03)
        return (pts + shift[:, None, :])[0].contiguous()


def _step_cloud(trainer, g_state, batch):
    """Item 0's cloud of ``render_view_b`` in the adversarial step: the
    shifted points and the normalised image, disparity and context."""
    import torch
    from kbe_torch.models.layers import normalize_sample

    with torch.no_grad():
        img_n, _ = normalize_sample((batch["image"] + 1.0) / 2.0)
        disp_n, _ = normalize_sample(batch["disparity"])
        ctx = g_state.context(img_n, disp_n)
        xyz = step_points(batch, trainer.camera)
        payload = torch.cat([img_n, disp_n, ctx], dim=-1)[0]
    return xyz, payload.reshape(xyz.shape[0], -1).contiguous()


def edge_upstream(shape, seed: int):
    """An upstream gradient of edge values in random places and signs:
    zeros of both signs, subnormals, the bounds of ``splat_grad``'s
    multiply-and-FMA quotient (2^-60, 2^60) and their outer neighbours,
    values whose quotient overflows, ordinary ones."""
    import torch

    g = torch.Generator().manual_seed(seed)
    edges = torch.tensor([0.0, -0.0, 1e-45, 1e-40, 1.1754942e-38,
                          2.0 ** -60, 2.0 ** 60, 3e38, 1e30, 0.37])
    edges = torch.cat([edges, torch.nextafter(edges[5:7], torch.tensor(
        [0.0, float("inf")]))])
    pick = torch.randint(0, len(edges), shape, generator=g)
    sign = torch.randint(0, 2, shape, generator=g) * 2.0 - 1.0
    return edges[pick] * sign


def _masked_cloud(h: int, w: int, device: str):
    """A C=4 cloud of an h x w grid with a near box, a fifth masked out."""
    import torch
    from kbe_torch.ops.geometry import depth_to_points

    g = torch.Generator().manual_seed(50)
    depth = 300.0 + 40.0 * torch.rand(h, w, generator=g)
    depth[h // 4:h // 2, w // 3:2 * w // 3] = 60.0
    xyz = depth_to_points(depth, FOCAL).reshape(-1, 3)
    valid = (torch.rand(h * w, generator=g) > 0.2).float()
    payload = torch.rand(h * w, 4, generator=g)
    return xyz.to(device), payload.to(device), valid.to(device)


def grad_check(label, xyz, payload, valid, pose, h: int, w: int,
               upstream=None):
    """``splat_grad`` against ``splat_grad_plain`` on the card and the CPU's
    autograd of the plain render (``accumulate_plain``'s ``index_add_``):
    bit-equal (NaN where they have NaN, for an edge ``upstream``). Returns
    the saved forward and the upstream gradient."""
    import torch
    from kbe_torch.ops import splat as S

    c = payload.shape[1]
    edge = upstream is not None
    if not edge:
        g = torch.Generator().manual_seed(c)
        upstream = torch.rand(h * w, c, generator=g)
    upstream = upstream.reshape(h * w, c).to(xyz.device)
    _, existing, zee = S._render(xyz, payload, valid, pose, h, w)
    existing = existing.contiguous()
    # the kernel on CUDA tensors (the plain gather in a CPU rehearsal)
    got = S.splat_grad(xyz, valid, pose, zee, existing, upstream, h, w)
    assert_equal(f"{label} splat_grad vs plain", got,
                 S.splat_grad_plain(xyz, valid, pose, zee, existing,
                                    upstream, h, w), nan=edge)
    cpu = payload.detach().cpu().clone().requires_grad_(True)
    rendered, _ = S.splat(xyz.cpu(), cpu, None if valid is None
                          else valid.cpu(), pose.cpu(), h, w)
    (rendered.reshape(-1, c) * upstream.cpu()).sum().backward()
    assert_equal(f"{label} splat_grad vs CPU autograd", got, cpu.grad,
                 nan=edge)
    live = int((got != 0).any(dim=1).sum())
    if edge:
        # and a fifth of the weight sums zeroed: d = 1e-7 there
        g = torch.Generator().manual_seed(c + 1)
        empty = existing.clone().reshape(-1)
        empty[(torch.rand(h * w, generator=g) < 0.2).to(xyz.device)] = 0.0
        got = S.splat_grad(xyz, valid, pose, zee, empty, upstream, h, w)
        assert_equal(f"{label} splat_grad vs plain, empty pixels", got,
                     S.splat_grad_plain(xyz, valid, pose, zee, empty,
                                        upstream, h, w), nan=True)
        if not bool(got.isinf().any()):
            raise AssertionError(f"{label}: no quotient overflowed")
    also = " (and to the plain version with a fifth of W zeroed)"
    log(f"{label}: N={xyz.shape[0]} C={c} "
        f"{'a mask' if valid is not None else 'no mask'}: splat_grad "
        f"bit-equal to splat_grad_plain and to the CPU's autograd"
        f"{also if edge else ''}; {live} points get a gradient")
    return existing, zee, upstream


def route_shares(upstream, counts, c: int):
    """The shares of ``splat_grad``'s (visible corner, group of four
    channels) pairs, over the visible corners ``counts`` (H*W,) a pixel:
    those whose upstream group holds a value off the multiply-and-FMA
    quotient's route (a |g| outside [2^-60, 2^60], 0 included), so that
    the group takes the IEEE division, and those whose group holds an
    exact zero. Returns (off route, with a zero)."""
    import torch

    groups = -(-c // 4)
    a = torch.ones(upstream.shape[0], groups * 4, device=upstream.device)
    a[:, :c] = upstream.abs()
    a = a.reshape(-1, groups, 4)
    off = (~((a >= 2.0 ** -60) & (a <= 2.0 ** 60))).any(-1)
    zero = (a == 0).any(-1)
    n = counts.double()
    total = float(n.sum()) * groups
    return (float((off.sum(1).double() * n).sum()) / total,
            float((zero.sum(1).double() * n).sum()) / total)


def grad_phase(rows, trainer, g_state, batch, gd_counts, device,
               upstreams=()):
    """splat_grad on the step's own cloud (C=68, no mask), on a masked
    C=4 cloud and on the step's cloud with edge gradients, then timed on
    the step's cloud; its row. ``upstreams``: the (points, upstream
    gradient) of the last G+D iteration's ``splat_grad`` calls, whose item
    0 (the step's cloud) gives the real gradient's route shares and a
    second time."""
    import torch
    from kbe_torch.ops import splat as S

    h, w = batch["image"].shape[1:3]
    xyz, payload = _step_cloud(trainer, g_state, batch)
    pose = S.make_pose(torch.zeros(3, device=xyz.device),
                       trainer.camera.focal, trainer.camera.baseline)
    existing, zee, upstream = grad_check("(t) step cloud", xyz, payload,
                                         None, pose, h, w)
    m_xyz, m_payload, m_valid = _masked_cloud(h, w, device)
    grad_check("(t) masked cloud", m_xyz, m_payload, m_valid, pose, h, w)
    grad_check("(t) step cloud, edge gradients", xyz, payload, None, pose, h,
               w, upstream=edge_upstream((h * w, payload.shape[1]), 7))
    if device != "cuda":
        return

    def fn():
        return S.grad_cuda(xyz, None, pose, zee, existing, upstream, h, w)

    reps = 20
    ms = timed(fn, reps)
    dev = device_ms(fn, reps, ("splat_grad",))
    pms = timed(lambda: S.splat_grad_plain(xyz, None, pose, zee, existing,
                                           upstream, h, w), 3)
    n, c = payload.shape
    counts = S.count_cuda(xyz, None, pose, zee, h, w, c)
    entries = int(counts.sum())
    real = next((g for x, g in upstreams if torch.equal(x, xyz)), None)
    if real is None:
        raise AssertionError("(t): no splat_grad call of the last G+D "
                             "iteration had item 0's points")
    real = real.reshape(h * w, c).contiguous()

    def fn_real():
        return S.grad_cuda(xyz, None, pose, zee, existing, real, h, w)

    assert_equal("(t) splat_grad vs plain, the G step's own upstream",
                 fn_real(), S.splat_grad_plain(xyz, None, pose, zee,
                                               existing, real, h, w))
    off, zero = route_shares(real, counts, c)
    real_dev = device_ms(fn_real, reps, ("splat_grad",))
    # bytes: the upstream gradient, the weight sums, the degridded buffer
    # and the points read once, the payload's gradient written once;
    # operations: a projection a point (~20) and a divide, multiply and
    # add a channel of each visible corner
    nbytes = h * w * (c + 2) * 4 + n * 12 + 20 + n * c * 4
    b_ms, b_by = bound(nbytes, n * 20 + entries * c * 3)
    log(f"(t) splat_grad at {h}x{w}, C={c}: kernel ms {ms:.4f} (device "
        f"{dev[0]:.4f}), plain ms {pms:.4f}, bound {b_ms:.4f} ({b_by}, "
        f"{nbytes / 1e6:.1f} MB, {entries} visible entries)")
    log(f"(t) splat_grad on the G step's own upstream: bit-equal to plain; "
        f"device ms {real_dev[0]:.4f}; (corner, 4-channel group) pairs "
        f"that divide: {off:.6f}, that hold an exact zero: {zero:.6f}")
    row = {"name": f"splat_grad[c{c}]", "route": "cuda",
           "source": SPLAT_SRC, "replaces": SPLAT_SPEC,
           "replaces_note": "no Pallas kernel: XLA's autodiff of the "
           "scatter spec, which the adversarial trainer differentiates",
           "count_key": GRAD_KEY, "max_abs_err": 0.0, "ms": ms,
           "device_ms": dev[0], "device_all_ms": dev[1], "plain_ms": pms,
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
           "points": n, "visible_entries": entries,
           "real_upstream_device_ms": real_dev[0],
           "real_upstream_groups_dividing": off,
           "real_upstream_groups_with_zero": zero}
    settle(row, gd_counts)
    row["path"] = (f"training: 2 G+D iterations of inpainting_ref at {h}x{w},"
                   f" batch {TRAIN_BATCH}")
    rows.append(row)


ESTIMATION_SIZE = (384, 512)  # cli/train_torch.py's synthetic sizes
REFINE_SIZE = (768, 1024)
DEPTH_STEPS = 3


def _peak_gib(device: str) -> float:
    import torch

    if device != "cuda":
        return float("nan")
    return torch.cuda.max_memory_allocated() / 2**30


def _reset_peak(device: str) -> None:
    import torch

    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()


def _check_metrics(label, metrics, names):
    values = _check_losses(label, metrics)
    if set(values) != set(names):
        raise AssertionError(f"{label}: metrics {sorted(values)}")
    return values


def _estimation_once(size, device: str, logs: str,
                     quiet: bool = False) -> TrainRun:
    """(u) estimation through the CLI's trainer and data: the full
    ``Semantics`` and ``Disparity`` lattice, ``size``, batch 8; three steps
    with the 'same' mask loss, then one that adds the 'other' step on the
    auxiliary batch; then a validation."""
    from cli import train_torch as cli
    from kbe_torch.config import CameraConfig
    from kbe_torch.train.metrics import DEPTH_METRIC_NAMES
    from kbe_torch.train.trainer_inpaint import to_device

    h, w = size
    run = TrainRun()
    say = (lambda *a: None) if quiet else log
    args = _train_args("estimation", device, logs, "--mask-loss", "same")
    cli.SYNTHETIC_SIZE["disparity"] = size
    _deterministic(True, device)  # as the CLI trains
    trainer = cli.make_trainer(args)
    data, val, _ = cli.make_data(args, "disparity",
                                 CameraConfig(512.0, 74.0))
    _reset_peak(device)
    state = trainer.init_state(size)
    for i in range(DEPTH_STEPS + 1):
        batch = next(data)
        aux = to_device(batch.pop("imagenet"), trainer.device)
        batch = to_device(batch, trainer.device)
        other = i == DEPTH_STEPS

        def step():
            st, m = trainer.disparity_train_step(state, batch)
            if other:
                st, m2 = trainer.imagenet_mask_step(st, aux)
                m = dict(m, mask_other=m2["mask"])
            return st, m

        loss_kind = "same + other" if other else "same"
        label = f"(u) estimation step {i} ({loss_kind})"
        (state, metrics), ms, (moved,) = _step(label, step, [state], device,
                                               {})
        losses = _check_losses(label, metrics)
        if not moved > 0.0:
            raise AssertionError(f"{label}: parameters did not move")
        run.record("estimation", ms, losses)
        say(f"{label} at {h}x{w}, batch {TRAIN_BATCH}: {ms:.1f} ms; losses "
            f"{json.dumps(losses)}; parameters moved (max {moved:.3g}); "
            f"launches none; step count {state.step}, optimizer count "
            f"{state.opt_state['count']}")
    if state.step != DEPTH_STEPS + 2 or state.opt_state["count"] != \
            state.step:
        raise AssertionError(f"(u) estimation: step {state.step}, count "
                             f"{state.opt_state['count']}")
    _sync(device)
    t0 = time.perf_counter()
    metrics = _check_metrics("(u) estimation validation",
                             trainer.validation(state, val()),
                             DEPTH_METRIC_NAMES)
    _sync(device)
    say(f"(u) estimation validation, 4 batches of {TRAIN_BATCH} at {h}x{w}:"
        f" {time.perf_counter() - t0:.2f} s; {json.dumps(metrics)}; peak "
        f"memory {_peak_gib(device):.2f} GiB")
    run.states.append(state)
    run.trainer = trainer
    _deterministic(False, device)
    return run


def _refinement(size, device: str, logs: str, batch: int):
    """(u) refinement: three steps of the full ``Refine`` behind the frozen
    full ``Disparity`` at ``size``, then a validation. Returns the trainer
    and its states."""
    from cli import train_torch as cli
    from kbe_torch.config import CameraConfig
    from kbe_torch.train.metrics import DEPTH_METRIC_NAMES
    from kbe_torch.train.trainer_inpaint import to_device

    h, w = size
    args = _train_args("refinement", device, logs, batch=batch)
    cli.SYNTHETIC_SIZE["refine"] = size
    _deterministic(True, device)  # as the CLI trains
    trainer = cli.make_trainer(args)
    data, val, _ = cli.make_data(args, "refine", CameraConfig(512.0, 74.0))
    _reset_peak(device)
    dstate, rstate = trainer.init_state(size, "refine")
    frozen = _params_of(dstate)
    for i in range(DEPTH_STEPS):
        b = next(data)
        b.pop("imagenet", None)
        b = to_device(b, trainer.device)
        label = f"(u) refinement step {i}"
        (rstate, metrics), ms, (moved,) = _step(
            label, lambda: trainer.refine_train_step(dstate, rstate, b),
            [rstate], device, {})
        losses = _check_losses(label, metrics)
        if not moved > 0.0:
            raise AssertionError(f"{label}: parameters did not move")
        log(f"{label} at {h}x{w}, batch {batch}: {ms:.1f} ms; losses "
            f"{json.dumps(losses)}; parameters moved (max {moved:.3g}); "
            "launches none")
    if _moved(frozen, dstate) != 0.0:
        raise AssertionError("(u) refinement moved the disparity net")
    _sync(device)
    t0 = time.perf_counter()
    metrics = _check_metrics("(u) refinement validation",
                             trainer.validation(dstate, val(), rstate),
                             DEPTH_METRIC_NAMES)
    _sync(device)
    log(f"(u) refinement validation, 4 batches of {batch} at {h}x{w}: "
        f"{time.perf_counter() - t0:.2f} s; {json.dumps(metrics)}; peak "
        f"memory {_peak_gib(device):.2f} GiB")
    _deterministic(False, device)
    return trainer, dstate, rstate


def depth_phase(est_size=ESTIMATION_SIZE, ref_size=REFINE_SIZE,
                device: str = "cuda"):
    """(u) depth training at full width through ``cli/train_torch.py``'s
    trainer and synthetic data: estimation at ``est_size``, run twice from
    one seed under deterministic algorithms (bit-equal), then refinement at
    ``ref_size`` at the CLI's batch of 8, or the largest batch that fits
    (said on its line). No step launches a splat kernel. Returns the
    refinement's (trainer, disparity state, refine state) for (v)."""
    import tempfile

    import torch

    with tempfile.TemporaryDirectory() as logs:
        first = _estimation_once(est_size, device, logs + "/e1")
        second = _estimation_once(est_size, device, logs + "/e2",
                                  quiet=True)
        assert_runs_equal("(u) estimation", first, second)
        log(f"(u) estimation ms a step: {json.dumps(_step_ms(first))}, "
            f"second run {json.dumps(_step_ms(second))}")
        del first, second
        batch = TRAIN_BATCH
        while True:
            try:
                out = _refinement(ref_size, device, logs + f"/r{batch}",
                                  batch)
                break
            except torch.cuda.OutOfMemoryError:
                if batch == 1:
                    raise
                batch //= 2
                torch.cuda.empty_cache()
                log(f"(u) refinement: out of memory; the batch is cut to "
                    f"{batch}")
        if batch != TRAIN_BATCH:
            log(f"(u) refinement ran at batch {batch}, the largest that "
                f"fits, not the CLI's {TRAIN_BATCH}")
    return out


VIEW_C_KEY = "sum/c4"


def _timed_calls(fn, sink, device):
    """``fn`` wrapped to add its host seconds (after a device sync) to
    ``sink``."""
    def wrapped(*args, **kwargs):
        _sync(device)
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        _sync(device)
        sink.append(time.perf_counter() - t0)
        return out
    return wrapped


def evaluation_phase(rows, trained: TrainRun, depth, size=TRAIN_SIZE,
                     device: str = "cuda"):
    """(v) evaluation:
    - ``validation_adv`` of (t)'s adversarial trainer over the CLI's 4
      validation batches at ``size``, batch 8, with a real 2048-d FID:
      the FID, the seconds of the Inception activations on the card and of
      the Fréchet distance (its ``sqrtm``) on the host, and the splat
      launches (six forward kernels a batch item);
    - ``InpaintEval`` of (t)'s trained nets: ``eval(compute_fid=False)`` and
      ``get_inpaint(output_render_c=True)`` on one batch, whose view C
      (``generate_view_c``, 2N points, C=4) is bit-equal to the same
      function on the CPU, then timed as its row;
    - ``DepthEval`` of (u)'s refinement nets on two batches at 768x1024."""
    import math

    import numpy as np
    import torch
    from cli import train_torch as cli
    from kbe_torch.config import CameraConfig
    from kbe_torch.ops.geometry import disparity_to_depth
    from kbe_torch.train.eval_depth import DepthEval
    from kbe_torch.train.eval_inpaint import InpaintEval, generate_view_c
    from kbe_torch.train.fid import FID
    from kbe_torch.train.metrics import DEPTH_METRIC_NAMES
    from kbe_torch.train.trainer_inpaint import TRAIN_CAMERA, to_device

    h, w = size
    b = TRAIN_BATCH
    trainer, g_state = trained.trainer, trained.g_state
    args = _train_args("inpainting_ref", device, os.devnull)
    cli.SYNTHETIC_SIZE["inpainting"] = size
    _, val, _ = cli.make_data(args, "inpainting", TRAIN_CAMERA)

    # validation_adv with a real FID; the FID built as the trainer builds
    # it, its two halves timed
    fid = FID(trainer.hparams.get("inception_params"), device=device)
    card_s, host_s = [], []
    fid.activations = _timed_calls(fid.activations, card_s, device)
    fid.frechet_distance = _timed_calls(fid.frechet_distance, host_s,
                                        device)
    trainer._fid = fid
    clear_launches()
    t0 = time.perf_counter()
    score = trainer.validation_adv(g_state, val())
    wall = time.perf_counter() - t0
    counts = launch_counts()
    expect_counts("(v) validation_adv", splat_counts(68, 4 * b)
                  if device == "cuda" else {})
    if not (math.isfinite(score) and score > 0.0):
        raise AssertionError(f"(v) validation_adv: FID {score}")
    log(f"(v) validation_adv, 4 batches of {b} at {h}x{w}: FID "
        f"{score:.6g} (2048-d); {wall:.2f} s, of which Inception "
        f"activations {sum(card_s):.3f} s on the card ({len(card_s)} calls of"
        f" {2 * b * 4 // len(card_s)} images at 299^2) and the Fréchet "
        f"distance {sum(host_s):.3f} s on the host (scipy sqrtm of 2048^2);"
        f" launches {json.dumps(counts)}")

    # InpaintEval of (t)'s nets
    cam = trainer.camera
    ev = InpaintEval({"context": g_state.context.state_dict(),
                      "net": g_state.net.state_dict()}, camera=cam,
                     device=device)
    batch = next(val())
    metrics = _check_losses("(v) InpaintEval.eval",
                            ev.eval([batch], compute_fid=False))
    clear_launches()
    out = ev.get_inpaint(batch, output_render_c=True)
    counts = launch_counts()
    want = splat_counts(68, b)
    want.update(splat_counts(4, b))
    expect_counts("(v) get_inpaint", want if device == "cuda" else {})
    for k, v in out.items():
        if not np.isfinite(v).all():
            raise AssertionError(f"(v) get_inpaint: {k} not finite")
    covered = float((out["mask_c"] > 0).mean())
    log(f"(v) InpaintEval at {h}x{w}, batch {b}: eval(compute_fid=False) "
        f"{json.dumps(metrics)}; get_inpaint(output_render_c=True) "
        f"{sorted(out)}, view C covered {covered:.4f}; launches "
        f"{json.dumps(counts)}")

    # view C on the card against the same function on the CPU
    with torch.no_grad():
        tb = to_device(batch, ev.device)
        out_img, out_disp, real, mask_b, pts_a, shift = \
            ev._adversarial_forward(tb)
        depth_b = disparity_to_depth(out_disp, cam.focal, cam.baseline)
        inputs = (pts_a, real, tb["depth"], out_img, depth_b, mask_b, shift)
        clear_launches()
        r_k, w_k = generate_view_c(*inputs, cam, h, w)
        view_counts = launch_counts()
        r_p, w_p = generate_view_c(*(t.cpu() for t in inputs), cam, h, w)
    assert_equal("(v) view C render", r_k, r_p)
    assert_equal("(v) view C weights", w_k, w_p)
    log(f"(v) generate_view_c at {h}x{w}, batch {b}, 2x{h * w} points, C=4: "
        "render and weights bit-equal to the CPU's")
    if device == "cuda":
        view_c_row(rows, inputs, cam, h, w, view_counts)

    # DepthEval of (u)'s nets
    dtrainer, dstate, rstate = depth
    de = DepthEval({"semantics": dtrainer.semantics.state_dict(),
                    "disparity": dstate.net.state_dict(),
                    "refine": rstate.net.state_dict()}, device=device)
    dargs = _train_args("refinement", device, os.devnull)
    _, dval, dsize = cli.make_data(dargs, "refine",
                                   CameraConfig(512.0, 74.0))
    it = dval()
    batches = [next(it), next(it)]
    _sync(device)
    t0 = time.perf_counter()
    dm = _check_metrics("(v) DepthEval", de.eval(batches),
                        DEPTH_METRIC_NAMES)
    _sync(device)
    log(f"(v) DepthEval, 2 batches of {b} at {dsize[0]}x{dsize[1]}: "
        f"{time.perf_counter() - t0:.2f} s; {json.dumps(dm)}")


def view_c_row(rows, inputs, cam, h: int, w: int, counts):
    """The row of view C's render: one batch item's merged cloud (2N
    points, no mask, C=4) through ``splat`` as ``render_pointcloud`` calls
    it, timed, its kernels' device time, the plain passes on the card, and
    its bound (each byte in and out once)."""
    import torch
    from kbe_torch.ops import splat as S
    from kbe_torch.ops.geometry import depth_to_points

    pts_a, real, depth_a, out_img, depth_b, _, shift = inputs
    pts_b = depth_to_points(depth_b[0, ..., 0], cam.focal).reshape(-1, 3) \
        - shift[0]
    xyz = (torch.cat([pts_a[0], pts_b]) + shift[0] / 2.0).contiguous()
    payload = torch.cat([
        torch.cat([real[0].reshape(-1, 3), out_img[0].reshape(-1, 3)]),
        torch.cat([depth_a[0].reshape(-1, 1), depth_b[0].reshape(-1, 1)])],
        dim=-1).contiguous()
    pose = S.make_pose(torch.zeros(3, device=xyz.device), cam.focal,
                       cam.baseline)
    n, c = payload.shape

    def plain():
        zee = S.degrid_plain(S.zee_plain(xyz, None, pose, h, w))
        acc = S.accumulate_plain(xyz, None, payload, pose, zee, h, w)
        return acc[:, :c] / (acc[:, c:] + 1e-7), acc[:, c:]

    fn = lambda: S.splat(xyz, payload, None, pose, h, w)
    reps = 20
    ms = timed(fn, reps)
    dev = device_ms(fn, reps, ("splat_",))
    pms = timed(plain, 3)
    hw = h * w
    # bytes: the function's own inputs read once (the points, the payload,
    # the pose) and its outputs written once (the render and the weights);
    # the kernels' z-buffer, degridded buffer and counts are neither, and
    # at this size they stay in L2; operations: a projection a point, four
    # corners' weights and (C+1) multiply-adds each
    nbytes = n * (12 + 4 * c) + 20 + hw * (c + 1) * 4
    b_ms, b_by = bound(nbytes, n * (20 + 4 * 2 * (c + 1)) + hw * 20)
    log(f"(v) view C splat, one item: N={n} C={c}: call ms {ms:.4f} (device "
        f"{dev[0]:.4f}), plain ms {pms:.4f}, bound {b_ms:.4f} ({b_by})")
    row = {"name": f"splat[c{c}]/generate_view_c", "route": "cuda",
           "source": SPLAT_SRC, "replaces": K1,
           "replaces_note": "kbe_tpu renders view C with the XLA scatter "
           "spec ops/splat.py::render_pointcloud, the function K1 computes",
           "max_abs_err": 0.0, "ms": ms, "device_ms": dev[0],
           "device_all_ms": dev[1], "plain_ms": pms, "bound_ms": b_ms,
           "bound_by": b_by, "library_ms": None, "points": n,
           "launches": counts.get(VIEW_C_KEY, 0),
           "pass_launches": {f"{k}/c4": counts.get(f"{k}/c4", 0)
                             for k in SPLAT_PASSES},
           "path": f"evaluation: generate_view_c of one batch of "
                   f"{TRAIN_BATCH} at {h}x{w} (2N points each)"}
    rows.append(row)

NMS_SRC = "kbe_torch/ops/csrc/nms.cu"
NMS_SPEC = "kbe_tpu/models/maskrcnn.py:222"   # _nms_keep's lax.fori_loop
MASK_CANVAS = 512           # resolve_mask_source's inference canvas


def nms_work(boxes, scores, thresh: float):
    """(rounds, IoUs): the rounds of the greedy loop whose slot is alive
    (each a step of the kernel's scan) and the IoUs they need (one a later
    slot still alive), over sorted sets on the CPU: the work this data
    needs."""
    import numpy as np
    from kbe_torch.ops import nms as N

    rounds = ious = 0
    for b, s in zip(boxes.cpu(), scores.cpu()):
        over = (N.iou_matrix(b) > float(np.float32(thresh))).numpy()
        alive = (s > 0).numpy().copy()
        for i in np.flatnonzero(alive):
            if not alive[i]:
                continue
            rounds += 1
            later = alive[i + 1:]
            ious += int(later.sum())
            later &= ~over[i, i + 1:]
    return rounds, ious


def nms_sets_of_forward(model, canvas):
    """The sets that ``canvas``'s forward hands to ``nms_keep_sets``:
    [(sets, thresh, tag)], the RPN's five levels and the box set."""
    import torch
    from kbe_torch.models import maskrcnn as MR

    calls, keep = [], MR.nms_keep_sets

    def record(sets, thresh, tag):
        calls.append(([(b.clone(), s.clone()) for b, s in sets], thresh,
                      tag))
        return keep(sets, thresh, tag)

    MR.nms_keep_sets = record
    try:
        with torch.no_grad():
            model(canvas[None])
    finally:
        MR.nms_keep_sets = keep
    return calls


def item_canvas(size, canvas_size: int, device: str):
    """A synthetic item's canvas, as the mask source builds it: the first
    item of ``synthetic_batches(1, *size)`` at half size in [0, 1],
    resized into the top left of a ``canvas_size``^2 zero canvas."""
    import torch
    from kbe_torch.ops.resize import resize_bilinear_antialias
    from kbe_torch.train.data import synthetic_batches

    small = _half_01(next(synthetic_batches(1, *size))["image"][0])
    s = canvas_size / max(small.shape[:2])
    rh, rw = round(small.shape[0] * s), round(small.shape[1] * s)
    canvas = torch.zeros((canvas_size, canvas_size, 3), device=device)
    canvas[:rh, :rw] = resize_bilinear_antialias(
        torch.from_numpy(small).to(device), rh, rw)
    return canvas


def nms_rows(rows, model, canvas):
    """Kernel ``nms`` against its plain loop on the card, bit-equal: on the
    RPN's five sets and the box set of a real forward, and on tie,
    zero-slot, full-overlap and 1000-slot sets; then the two real launches
    timed as rows (launches filled in by the caller)."""
    import torch
    from kbe_torch.ops import nms as N

    g = torch.Generator().manual_seed(5)
    extra = []
    for case in ("ties", "zero_slots", "full_overlap", "1000_slots"):
        n = 1000 if case == "1000_slots" else 512
        xy = torch.rand(n, 2, generator=g) * 480.0
        boxes = torch.cat([xy, xy + 4.0 + torch.rand(n, 2, generator=g)
                           * 120.0], 1)
        scores = torch.rand(n, generator=g)
        if case == "ties":
            scores = torch.round(scores * 4) / 4
        elif case == "zero_slots":
            scores[torch.rand(512, generator=g) < 0.3] = 0.0
        else:
            boxes[1::2] = boxes[0::2]
            scores[1::2] = scores[0::2]
        extra.append(([(boxes.cuda(), scores.cuda())], 0.5, case))
    out = {}
    for sets, thresh, tag in nms_sets_of_forward(model, canvas) + extra:
        boxes, scores, _ = N.sort_sets(sets)
        got = N.keep_cuda(boxes, scores, thresh, "compare")
        want = torch.stack([N.keep_plain(b, s, thresh)
                            for b, s in zip(boxes, scores)])
        assert_equal(f"(w) nms {tag}", got, want)
        kept = int((want > 0).sum())
        log(f"(w) nms {tag}: {boxes.shape[0]} set(s) of up to "
            f"{boxes.shape[1]}, {int((scores > 0).sum())} alive, {kept} "
            "kept: bit-equal to the plain loop on the card")
        if tag == "1000_slots":
            ms = timed(lambda: N.keep_cuda(boxes, scores, thresh, "compare"),
                       20)
            log(f"(w) nms {tag}: call ms {ms:.4f}")
        if tag in ("rpn", "box"):
            out[tag] = (boxes, scores, thresh)
    for tag, (boxes, scores, thresh) in out.items():
        fn = lambda: N.keep_cuda(boxes, scores, thresh, "compare")
        ms = timed(fn, 20)
        dev = device_ms(fn, 20, ("nms_kernel",))
        pms = timed(lambda: [N.keep_plain(b, s, thresh)
                             for b, s in zip(boxes, scores)], 2)
        rounds, ious = nms_work(boxes, scores, thresh)
        sets, cap = scores.shape
        # bytes: boxes and scores read once, the kept scores written once;
        # operations: 15 f32 operations an IoU and its compare
        b_ms, b_by = bound(sets * cap * (16 + 4 + 4), ious * 15)
        log(f"(w) nms[{tag}]: {sets} set(s) x {cap}, {rounds} live slots "
            f"(the scan's serial steps), {ious} IoUs; call ms {ms:.4f} "
            f"(device {dev[0]:.4f}), plain ms {pms:.4f}, bound {b_ms:.6f} "
            f"({b_by})")
        rows.append({
            "name": f"nms[{tag}]", "route": "cuda", "source": NMS_SRC,
            "replaces": NMS_SPEC,
            "replaces_note": "none: lax.fori_loop in XLA",
            "max_abs_err": 0.0, "ms": ms, "device_ms": dev[0],
            "device_all_ms": dev[1], "plain_ms": pms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None, "sets": sets, "cap": cap,
            "rounds": rounds, "ious": ious, "count_key": f"nms/{tag}",
            "bound_note": "bytes and IoUs of this data; the time goes to "
                          "the launch and to the scan's chain of live "
                          "slots"})


# kernel kinds of a forward's profile, by name
FORWARD_KINDS = (("nms", ("nms_kernel",)),
                 ("conv/gemm", ("conv", "gemm", "xmma", "cudnn", "cutlass",
                                "winograd", "fft", "sm90", "implicit")),
                 ("sort", ("sort", "radix")),
                 ("gather/index", ("index", "gather", "scatter")))


def forward_profile(fwd, fwd_ms: float):
    """The device time of one forward by kernel kind, its busy share of the
    forward's time, its launches, and its five longest kernels."""
    events = device_events(fwd, 3)
    times, counts = {}, {}
    for name, start, end in events:
        kind = next((k for k, keys in FORWARD_KINDS
                     if any(x in name.lower() for x in keys)), "other")
        times[kind] = times.get(kind, 0.0) + (end - start) / 3 / 1e3
        counts[name] = counts.get(name, 0.0) + (end - start) / 3 / 1e3
    busy = sum(times.values())
    kinds = {k: round(v, 3) for k, v in times.items()}
    top = [(n[:60], round(t, 3))
           for n, t in sorted(counts.items(), key=lambda kv: -kv[1])[:5]]
    log(f"(w) a forward's device time {busy:.3f} ms of {fwd_ms:.3f} ms "
        f"(idle share {1.0 - busy / fwd_ms:.3f}), {len(events) // 3} "
        f"kernels; by kind {json.dumps(kinds)}; longest {top}")


def _half_01(image):
    """A [-1, 1] image (H, W, 3) at half size in [0, 1], as KBEDataset
    hands the mask source its items (cv2's INTER_AREA at 2x is the 2x2
    mean)."""
    h, w = image.shape[0] // 2, image.shape[1] // 2
    x = (image[:2 * h, :2 * w] + 1.0) / 2.0
    return x.reshape(h, 2, w, 2, 3).mean(axis=(1, 3)).astype("float32")


def _source_batches(data, source, steps: int, record):
    """``steps`` batches of ``data`` whose items' instance masks, and the
    last batch's auxiliary ones, come from ``source`` (at the items' half
    size, as KBEDataset computes them); ``record`` gains each mask stack."""
    import numpy as np

    for i in range(steps):
        batch = next(data)
        parts = [batch] + ([batch["imagenet"]] if i == steps - 1 else [])
        for part in parts:
            part["instance_masks"] = np.stack(
                [source(_half_01(im), None) for im in part["image"]])
            record.append(part["instance_masks"])
        yield batch


def _estimation_with_source(size, device: str, logs: str, source,
                            quiet: bool = False):
    """(w) estimation through the CLI's trainer and synthetic data whose
    masks come from the Mask R-CNN source, computed in ``Prefetcher``'s
    thread as the CLI's dataset does: three 'same' steps, then one that
    adds the 'other' step on the auxiliary batch. Returns (TrainRun, the
    NMS launches of the run, the masks)."""
    from cli import train_torch as cli
    from kbe_torch.config import CameraConfig
    from kbe_torch.train.data import Prefetcher
    from kbe_torch.train.trainer_inpaint import to_device

    h, w = size
    run, masks = TrainRun(), []
    say = (lambda *a: None) if quiet else log
    args = _train_args("estimation", device, logs, "--mask-loss", "same")
    cli.SYNTHETIC_SIZE["disparity"] = size
    _deterministic(True, device)
    trainer = cli.make_trainer(args)
    data, _, _ = cli.make_data(args, "disparity", CameraConfig(512.0, 74.0))
    state = trainer.init_state(size)
    clear_launches()
    prefetch = Prefetcher(_source_batches(data, source, DEPTH_STEPS + 1,
                                          masks))
    for i, batch in enumerate(prefetch):
        aux = to_device(batch.pop("imagenet"), trainer.device)
        batch = to_device(batch, trainer.device)
        other = i == DEPTH_STEPS
        before = _params_of(state)
        _sync(device)
        t0 = time.perf_counter()
        state, m = trainer.disparity_train_step(state, batch)
        if other:
            state, m2 = trainer.imagenet_mask_step(state, aux)
            m = dict(m, mask_other=m2["mask"])
        _sync(device)
        ms = (time.perf_counter() - t0) * 1e3
        label = (f"(w) estimation step {i} "
                 f"({'same + other' if other else 'same'})")
        losses = _check_losses(label, m)
        if not _moved(before, state) > 0.0:
            raise AssertionError(f"{label}: parameters did not move")
        for k in ("mask",) + (("mask_other",) if other else ()):
            if not losses[k] > 0.0:
                raise AssertionError(f"{label}: {k} loss {losses[k]}")
        run.record("estimation", ms, losses)
        say(f"{label} at {h}x{w}, batch {TRAIN_BATCH}, Mask R-CNN masks: "
            f"{ms:.1f} ms; losses {json.dumps(losses)}")
    prefetch.thread.join(timeout=60)
    if prefetch.thread.is_alive() or len(run.times) != DEPTH_STEPS + 1:
        raise AssertionError(f"(w) {len(run.times)} steps; the prefetch "
                             "thread did not end or its source failed")
    counts = launch_counts()
    run.states.append(state)
    _deterministic(False, device)
    return run, counts, masks


def maskrcnn_phase(rows, size=ESTIMATION_SIZE, device: str = "cuda",
                   canvas_size: int = MASK_CANVAS):
    """(w) Mask R-CNN instance masks for depth training:
    - a synthetic torchvision-layout ``.pth`` (seeded, full width) written
      to a temporary directory, loaded through ``cli/train_torch.py``'s
      ``resolve_mask_source`` on ``device`` (canvas ``canvas_size``^2);
    - kernel ``nms`` bit-equal to its plain loop on the card on a real
      forward's RPN and box sets and on tie, zero-slot, full-overlap and
      1000-slot sets, and its rows timed (on the card);
    - the forward on the card against the CPU on one noise image, and on a
      synthetic item's canvas (reported);
    - a forward and the source per item timed;
    - estimation at ``size``, batch 8, with the source's masks, twice from
      one seed: losses and states bit-equal, masks and mask losses not
      zero, two NMS launches an image."""
    import tempfile

    import numpy as np
    import torch
    from cli import train_torch as cli
    from kbe_torch.models.maskrcnn import load_maskrcnn
    from kbe_torch.train.data import synthetic_batches
    from kbe_torch.utils.reference_convert import convert_maskrcnn, \
        synthetic_maskrcnn_state_dict

    h, w = size
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "maskrcnn.pth")
        torch.save({k: torch.from_numpy(v) for k, v in
                    synthetic_maskrcnn_state_dict(0).items()}, path)
        args = _train_args("estimation", device, tmp, "--mask-loss", "same",
                           "--mask-source", "maskrcnn",
                           "--maskrcnn-weights", path)
        t0 = time.perf_counter()
        source = cli.resolve_mask_source(args, max_instances=8,
                                         infer_size=canvas_size)
        load_s = time.perf_counter() - t0
        tree = convert_maskrcnn(path)
    model = load_maskrcnn(tree, device=device)
    cpu_model = load_maskrcnn(tree, device="cpu")
    log(f"(w) Mask R-CNN: synthetic torchvision weights "
        f"({sum(p.numel() for p in model.parameters())} parameters) "
        f"through resolve_mask_source in {load_s:.2f} s")

    canvas = item_canvas(size, canvas_size, device)
    if device == "cuda":
        nms_rows(rows, model, canvas)

    # card against CPU: one noise image (asserted), the item's canvas
    noise = torch.from_numpy(np.random.default_rng(9).uniform(
        size=(1, canvas_size, canvas_size, 3)).astype(np.float32))
    for name, image in (("noise image", noise), ("item canvas",
                                                 canvas[None].cpu())):
        with torch.no_grad():
            got = {k: v.cpu() for k, v in model(image.to(device)).items()}
            want = cpu_model(image)
            ferr = float("nan")
            if name == "noise image":
                feats = [f.cpu() for f in model.features(image.to(device))]
                ferr = max(float((a - b).abs().max() / b.abs().max())
                           for a, b in zip(feats, cpu_model.features(image)))
        same_labels = bool(torch.equal(got["labels"], want["labels"]))
        berr = float((got["boxes"] - want["boxes"]).abs().max())
        agree = float(((got["masks"] > 0.5) == (want["masks"] > 0.5))
                      .float().mean())
        passing = int((want["scores"] > 0.5).sum())
        log(f"(w) forward at {canvas_size}^2, card vs CPU, {name}: FPN "
            f"features max rel err {ferr:.3g}, labels equal {same_labels}, "
            f"boxes max err {berr:.4g} px, masks agree on {agree:.6f}, "
            f"{passing} of {want['scores'].shape[1]} detections above 0.5")
        if name == "noise image" and not (
                ferr <= 1e-4 and same_labels and berr <= 1e-2
                and agree >= 0.999 and passing >= 1):
            raise AssertionError("(w) Mask R-CNN on the card does not "
                                 "match the CPU")

    # timings: a forward (and where its device time goes), the source per
    # item
    fwd_ms = float("nan")
    if device == "cuda":
        fwd = lambda: model(canvas[None])
        with torch.no_grad():
            fwd_ms = timed(fwd, 5)
            forward_profile(fwd, fwd_ms)
    batch = next(synthetic_batches(TRAIN_BATCH, h, w))
    per_item = []
    for im in batch["image"]:
        _sync(device)
        t0 = time.perf_counter()
        source(_half_01(im), None)
        _sync(device)
        per_item.append((time.perf_counter() - t0) * 1e3)
    log(f"(w) a {canvas_size}^2 forward {fwd_ms:.2f} ms (CUDA events, "
        f"mean of 5); the source per {h // 2}x{w // 2} item "
        f"{[round(t, 2) for t in per_item]} ms (host clock)")

    # estimation with the source's masks, twice from one seed
    with tempfile.TemporaryDirectory() as logs:
        first, counts, masks = _estimation_with_source(size, device,
                                                       logs + "/1", source)
        second, _, _ = _estimation_with_source(size, device, logs + "/2",
                                               source, quiet=True)
    assert_runs_equal("(w) estimation with Mask R-CNN masks", first, second)
    images = TRAIN_BATCH * (DEPTH_STEPS + 2)
    want = ({"nms/rpn": images, "nms/box": images} if device == "cuda"
            else {})
    if counts != want:
        raise AssertionError(f"(w) estimation: launches {counts}, want "
                             f"{want}")
    filled = [float(m.mean()) for m in masks]
    if not all(f > 0 for f in filled):
        raise AssertionError(f"(w) a batch's masks are empty: {filled}")
    log(f"(w) estimation with Mask R-CNN masks: ms a step "
        f"{json.dumps(_step_ms(first))}, second run "
        f"{json.dumps(_step_ms(second))}; mask share of each batch "
        f"{[round(f, 5) for f in filled]}; launches {json.dumps(counts)}")
    for row in rows:
        if row["name"].startswith("nms["):
            settle(row, counts)
            row["path"] = (f"(w) estimation at {h}x{w}, batch {TRAIN_BATCH}:"
                           f" {DEPTH_STEPS + 1} batches and one auxiliary "
                           f"batch, {images} images, one launch an image")
    return {"forward_ms": fwd_ms, "source_ms": per_item,
            "step_ms": _step_ms(first)}


DP_WORLD = 2                # ranks of (x)'s gloo run on the one card
DP_EFFECT = dict(size=256, steps=5, images=4)
DP_GRAD_TOL = 1e-4          # relative L2 a gradient leaf
DP_LOSS_RTOL = 1e-5


class Recorder:
    """An optimizer that records the gradients it is given (``state['g']``)
    and passes them on to the real one."""

    def __init__(self, inner):
        self.inner = inner

    def init(self, params):
        return {"g": None, "inner": self.inner.init(params)}

    def step(self, params, grads, state):
        return {"g": [g.detach().clone() for g in grads],
                "inner": self.inner.step(params, grads, state["inner"])}


def _dp_tensors(*states):
    """Every tensor of training states recorded by ``Recorder``: the
    modules' (parameters, batch and spectral norms) and the Adam moments."""
    out = []
    for st in states:
        for k in ("context", "net", "disc"):
            if hasattr(st, k):
                out += list(getattr(st, k).state_dict().values())
        out += list(st.opt_state["inner"]["mu"])
        out += list(st.opt_state["inner"]["nu"])
    return out


def _cpu(tensors):
    return [t.detach().cpu() for t in tensors]


def chunked(obj, name: str, parts: int, batched: int = 99) -> None:
    """Make ``obj.<name>`` run its batch in ``parts`` equal parts, one after
    another, and concatenate the outputs (tensors, or tuples and lists of
    them): a per-sample net as ``parts`` ranks run it. The first
    ``batched`` arguments carry the batch."""
    import torch

    fn = getattr(obj, name)

    def run(*args):
        outs = [fn(*(a.chunk(parts)[i] if k < batched else a
                     for k, a in enumerate(args))) for i in range(parts)]
        if torch.is_tensor(outs[0]):
            return torch.cat(outs)
        return type(outs[0])(torch.cat(x) for x in zip(*outs))
    setattr(obj, name, run)


def _chunked_adv_forward(trainer, parts: int) -> None:
    """Make ``trainer._adv_forward`` (the A -> B warp and inpainting) run
    the batch in ``parts`` equal parts, one after another, and concatenate
    the outputs: G's nets and every per-sample reduction on the card then
    see the ranks' batch shapes, whose kernels can sum in another order
    than the whole batch's."""
    import torch

    fn = trainer._adv_forward

    def part(tree, i):
        return {k: part(v, i) if isinstance(v, dict) else v.chunk(parts)[i]
                for k, v in tree.items()}

    def run(context, net, batch):
        outs = [fn(context, net, part(batch, i)) for i in range(parts)]
        return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}
    trainer._adv_forward = run


def _chunked_spectral_conv(conv, parts: int) -> None:
    """Make a ``SpectralConv2d`` run its batch in ``parts`` equal parts as
    ``parts`` ranks run it: each part normalises the kernel itself, from the
    same power-iteration state, so that the gradient through the kernel's
    norm (a sum over the whole kernel) is taken part by part and the parts'
    gradients are summed after it, as the ranks' all-reduce sums them."""
    import torch

    def run(x, update_stats: bool = False):
        u = conv.u.clone()
        outs = []
        for p in x.chunk(parts):
            with torch.no_grad():
                conv.u.copy_(u)
            outs.append(conv._conv_forward(
                p, conv.normalized_weight(update_stats), conv.bias))
        return torch.cat(outs)
    conv.forward = run


def _chunked_batch_norm(bn, parts: int) -> None:
    """Make a train-mode ``BatchNorm`` run as ``parts`` ranks run it through
    ``global_mean``, in one process: each part takes its means of x and
    x^2, an all-reduce stand-in sums them (and, backward, sums the parts'
    gradients of the sums), and each part normalises with a copy of the
    global statistics of its own, so that the gradients of the statistics
    add up part by part before they are summed, in the ranks' order of f32
    sums (statistics over the whole batch put D's leaves about 5e-6 from
    the ranks' on an H100)."""
    import torch

    class PartsSum(torch.autograd.Function):
        """Each part's copy of the parts' sum; backward, each part's
        gradient is the sum of the copies' (``_GlobalSum`` over ranks)."""

        @staticmethod
        def forward(ctx, *xs):
            total = xs[0]
            for x in xs[1:]:
                total = total + x
            return tuple(total.clone() for _ in xs)

        @staticmethod
        def backward(ctx, *grads):
            total = grads[0]
            for g in grads[1:]:
                total = total + g
            return tuple(total.clone() for _ in grads)

    forward = bn.forward

    def run(x, train, mesh=None):
        if not train:
            return forward(x, train, mesh)
        xs = x.chunk(parts)
        means = PartsSum.apply(*[torch.mean(p, dim=(0, 2, 3)) for p in xs])
        sqs = PartsSum.apply(*[torch.mean(p * p, dim=(0, 2, 3))
                               for p in xs])
        outs = []
        for i, p in enumerate(xs):
            mean = means[i] / parts
            var = torch.clamp(sqs[i] / parts - mean * mean, min=0.0)
            if i == 0:
                with torch.no_grad():
                    keep = bn.momentum
                    bn.mean.copy_(keep * bn.mean + (1.0 - keep) * mean)
                    bn.var.copy_(keep * bn.var + (1.0 - keep) * var)
            mul = torch.rsqrt(var + bn.eps) * bn.scale
            outs.append((p - mean[None, :, None, None])
                        * mul[None, :, None, None]
                        + bn.bias[None, :, None, None])
        return torch.cat(outs)
    bn.forward = run


def _d_grads_f64(state, inputs, names, device: str):
    """D's gradients in float64 from ``state`` (its state dict before the
    step) on the step's fakes and reals, the loss of D's step: the referee
    of the leaves where two f32 runs part, as ``tests/test_torch_train.py``
    referees them (f64's order of sums does not matter at this size)."""
    import torch
    from kbe_torch.models.discriminator import (MPDDiscriminator,
                                                adversarial_loss)

    disc = MPDDiscriminator(spectral_norm=True)
    disc.load_state_dict(state)
    disc = disc.to(device).double()
    x = {k: v.double() for k, v in inputs.items()}
    _deterministic(False, device)  # f64 needs no fixed order of sums
    try:
        fake = disc(x["inpaint_img"], x["inpaint_disp"], train=True)
        real = disc(x["image_a"], x["disp_a"], train=True)
        loss = 0.5 * (adversarial_loss(fake, False)
                      + adversarial_loss(real, True))
        params = dict(disc.named_parameters())
        grads = torch.autograd.grad(loss, [params[n] for n in names])
    finally:
        _deterministic(True, device)
    return [g.cpu() for g in grads]


def _dp_run(mesh, size, device: str, logs: str, label: str,
            kinds=("adv", "est"), chunks: int = 1, referee: bool = False):
    """One adversarial G+D iteration (``'adv'``), then one estimation step
    with the 'same' mask loss (``'est'``), from the training CLI's seeds and
    synthetic data at ``size`` and the global batch 8: through
    ``cli.make_trainer(args, mesh)`` and ``make_data(..., mesh)`` and
    ``data_parallel_step`` with a mesh, through the trainers' own steps
    without. ``chunks`` runs G's forward (its nets and per-sample
    reductions), Semantics, Disparity and D's convolutions (each part
    normalising the spectral-norm kernels itself) on the batch in that many
    parts, and takes D's batch statistics, as that many ranks do.
    ``referee`` adds D's gradients in float64 on the G+D iteration's own
    inputs (``d_f64``). Returns per step its losses, the gradients each
    optimizer was given, D's batch-norm buffers, ms and launches (on the
    host), and the final state tensors."""
    import torch
    from cli import train_torch as cli
    from kbe_torch.config import CameraConfig
    from kbe_torch.models.discriminator import BatchNorm, SpectralConv2d
    from kbe_torch.parallel import data_parallel_step
    from kbe_torch.train.trainer_inpaint import TRAIN_CAMERA, to_device

    par = ((lambda f: f) if mesh is None
           else (lambda f: data_parallel_step(f, mesh)))
    local = TRAIN_BATCH // (1 if mesh is None else mesh.world_size)
    out = {}

    if "adv" in kinds:
        cli.SYNTHETIC_SIZE["inpainting"] = size
        args = _train_args("inpainting_ref", device, logs + "/adv")
        trainer = cli.make_trainer(args, mesh=mesh)
        trainer.tx = Recorder(trainer.tx)
        trainer.tx_d = Recorder(trainer.tx_d)
        data, _, _ = cli.make_data(args, "inpainting", TRAIN_CAMERA, mesh)
        g, d = trainer.init_state(size), trainer.init_disc_state(size)
        if chunks > 1:
            _chunked_adv_forward(trainer, chunks)
            for m in d.disc.modules():
                if isinstance(m, SpectralConv2d):
                    _chunked_spectral_conv(m, chunks)
                elif isinstance(m, torch.nn.Conv2d):
                    chunked(m, "_conv_forward", chunks, batched=1)
                elif isinstance(m, BatchNorm):
                    _chunked_batch_norm(m, chunks)
        if referee:
            taken, d_before = {}, {k: v.clone() for k, v in
                                   d.disc.state_dict().items()}
            forward = trainer._adv_forward

            def keep(*args):
                o = forward(*args)
                taken.update({k: o[k].detach().clone() for k in (
                    "inpaint_img", "inpaint_disp", "image_a", "disp_a")})
                return o
            trainer._adv_forward = keep
        batch = to_device(next(data), trainer.device)
        want = splat_counts(68, local)
        want[GRAD_KEY] = local
        (g, d, metrics), ms, moved = _step(
            f"{label} G+D iteration",
            lambda: par(trainer.adversarial_step)(g, d, batch, True),
            [g, d], device, want)
        if not min(moved) > 0.0:
            raise AssertionError(f"{label} G+D: states moved {moved}")
        out["adv"] = {
            "losses": _check_losses(label, metrics), "ms": ms,
            "launches": launch_counts(),
            "g": _cpu(g.opt_state["g"]), "d": _cpu(d.opt_state["g"]),
            "d_names": [n for n, _ in d.disc.named_parameters()
                        if not n.startswith("core.vgg.")],
            "bn": {k: v.cpu().clone() for k, v in
                   d.disc.state_dict().items()
                   if k.endswith((".bn.mean", ".bn.var"))},
            "states": _dp_tensors(g, d)}
        if referee:
            out["adv"]["d_f64"] = _d_grads_f64(
                d_before, taken, out["adv"]["d_names"], device)
        del trainer, data, batch

    if "est" in kinds:
        cli.SYNTHETIC_SIZE["disparity"] = size
        args = _train_args("estimation", device, logs + "/est",
                           "--mask-loss", "same")
        trainer = cli.make_trainer(args, mesh=mesh)
        trainer.tx_disparity = Recorder(trainer.tx_disparity)
        data, _, _ = cli.make_data(args, "disparity",
                                   CameraConfig(512.0, 74.0), mesh)
        state = trainer.init_state(size)
        if chunks > 1:
            for obj in (trainer.semantics, state.net):
                chunked(obj, "forward", chunks)
        batch = next(data)
        batch.pop("imagenet")
        batch = to_device(batch, trainer.device)
        (state, metrics), ms, (moved,) = _step(
            f"{label} estimation step",
            lambda: par(trainer.disparity_train_step)(state, batch),
            [state], device, {})
        if not moved > 0.0 or not float(metrics["mask"]) > 0.0:
            raise AssertionError(f"{label} estimation: moved {moved}, mask "
                                 f"loss {float(metrics['mask'])}")
        out["est"] = {"losses": _check_losses(label, metrics), "ms": ms,
                      "g": _cpu(state.opt_state["g"]),
                      "states": _dp_tensors(state)}
    return out


def _dp_images(size: int, n: int):
    import numpy as np
    from kbe_torch.data import demo_scene_image

    rng = np.random.default_rng(11)
    base = demo_scene_image(size, size)
    return np.stack([np.clip(base * rng.uniform(0.6, 1.0, 3)
                             + rng.uniform(0.0, 0.3, 3), 0.0, 1.0)
                     for _ in range(n)]).astype(np.float32)


def _dp_effect(mesh, device: str = "cuda"):
    """(x) part 3: ``DP_EFFECT['images']`` images through the default
    effect (f32, seeded nets): ``batch_parallel_effect`` over ``mesh``
    gathered to rank 0 (with its launches on this rank), or each image's
    single-image effect with no mesh."""
    import torch
    from kbe_torch.config import EffectConfig, ZoomSettings
    from kbe_torch.parallel import batch_parallel_effect
    from kbe_torch.pipeline import KenBurnsPipeline

    n, steps = DP_EFFECT["size"], DP_EFFECT["steps"]
    pipe = KenBurnsPipeline.create(0, effect=EffectConfig(num_steps=steps),
                                   device=device)
    fn = pipe.effect_fn(n, n, ZoomSettings.default_3d(n, n))
    images = _dp_images(n, DP_EFFECT["images"])
    if mesh is None:
        return torch.stack([fn(pipe.models, torch.as_tensor(
            im, device=device)[None]) for im in images]).cpu(), {}
    clear_launches()
    frames = batch_parallel_effect(fn, mesh, gather=True)(pipe.models,
                                                          images)
    _sync(device)
    return (None if frames is None else frames.cpu()), launch_counts()


def _equal_on_ranks(tensors, mesh) -> bool:
    """Whether every tensor equals rank 0's, bit for bit, on every rank."""
    import torch
    import torch.distributed as dist
    from kbe_torch.parallel import replicate

    # every rank takes part in every broadcast, whatever it finds
    same = [torch.equal(t, replicate(mesh, t.clone())) for t in tensors]
    flag = torch.tensor([int(all(same))], device=mesh.device)
    dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=mesh.group)
    return bool(flag.item())


def dp_rank(out_dir: str, size, device: str, batch: int) -> None:
    """(x) parts 2 and 3 as one rank of ``DP_WORLD`` on the one card, under
    gloo (NCCL refuses two ranks on one device), from torchrun's
    environment: the G+D iteration and the estimation step on the rank's
    part of the global ``batch``, the states compared across the ranks,
    then ``batch_parallel_effect``; rank 0 then runs the reference, the
    1-rank steps on the global batch with G's forward, Semantics,
    Disparity and D's convolutions and statistics run in the ranks' parts
    (the ranks' order of f32 sums), and D's float64 gradients; writes
    ``out_dir/rank<r>.pt``."""
    import torch
    import torch.distributed as dist
    from kbe_torch.parallel import data_mesh, initialize_multihost

    global TRAIN_BATCH
    TRAIN_BATCH = batch
    if not initialize_multihost(device=device, backend="gloo"):
        raise RuntimeError("(x) rank: no torchrun environment")
    mesh = data_mesh(DP_WORLD, device=device)
    _deterministic(True, device)
    run = _dp_run(mesh, tuple(size), device, f"{out_dir}/logs{mesh.rank}",
                  f"(x) rank {mesh.rank} of {DP_WORLD}, gloo,")
    if mesh.rank == 0:
        # the 1-rank reference, next in this process: its convolutions of
        # the ranks' batch shapes then run the plans cuDNN chose for the
        # step above (which plan it picks can depend on the process's
        # memory); the other rank waits in the first broadcast below
        run["ref"] = _dp_run(None, tuple(size), device, f"{out_dir}/ref",
                             f"(x) rank 0, no mesh, nets in {DP_WORLD} "
                             "parts", chunks=DP_WORLD, referee=True)
        for part in run["ref"].values():
            part.pop("states")
    for kind in ("adv", "est"):
        run[kind]["equal"] = _equal_on_ranks(run[kind].pop("states"), mesh)
    _deterministic(False, device)  # the effect's kernels are deterministic
    run["frames"], run["effect_launches"] = _dp_effect(mesh, device)
    if mesh.rank != 0:  # rank 0's gradients stand for both
        for kind in ("adv", "est"):
            for k in ("g", "d", "bn"):
                run[kind].pop(k, None)
    torch.save(run, os.path.join(out_dir, f"rank{mesh.rank}.pt"))
    mesh.barrier()
    dist.destroy_process_group()


def _rel_l2(got, want) -> float:
    num = float((got.double() - want.double()).norm())
    den = float(want.double().norm())
    return num / den if den > 0 else num


def _dp_worst(got, want):
    """(relative L2 error, leaf) of the leaf of ``got`` furthest from the
    1-rank run's ``want``."""
    if len(got) != len(want):
        return float("inf"), f"{len(got)} leaves for {len(want)}"
    worst = (0.0, None)
    for i, (g, w) in enumerate(zip(got, want)):
        err = _rel_l2(g, w)
        if err > worst[0]:
            worst = (err, i)
    return worst


def _d_refereed(got, want, f64, names):
    """D's leaves against the 1-rank run's: each within ``DP_GRAD_TOL``
    relative L2, or, where the two f32 runs part further, the ranks' leaf
    no further from the float64 run's than the 1-rank run's leaf is, plus
    ``DP_GRAD_TOL`` (D's train-mode batch norms cancel heavily, and each f32
    run loses digits of its own on a few leaves). A leaf whose float64
    norm is below 1e-6 of the largest leaf's (a conv bias before a
    train-mode batch norm, zero in exact arithmetic) is held below that in
    both runs. Returns (the worst leaf against the 1-rank run, {refereed
    leaf: (ranks vs f64, 1 rank vs f64)}, [failed leaves])."""
    norm = lambda t: float(t.double().norm())
    top = max(norm(t) for t in f64)
    worst, refereed, failed = (0.0, None), {}, []
    for name, g, w, x in zip(names, got, want, f64):
        if norm(x) <= 1e-6 * top:
            if max(norm(g), norm(w)) > 1e-6 * top:
                failed.append(name)
            continue
        err = _rel_l2(g, w)
        if err > worst[0]:
            worst = (err, name)
        if err > DP_GRAD_TOL:
            refereed[name] = (_rel_l2(g.double(), x), _rel_l2(w.double(), x))
            if refereed[name][0] > refereed[name][1] + DP_GRAD_TOL:
                failed.append(name)
    if not len(got) == len(want) == len(f64) == len(names):
        failed.append("leaf count")
    return worst, refereed, failed


def _assert_bit_equal(label, a, b):
    import torch

    if a["losses"] != b["losses"]:
        raise AssertionError(f"{label}: losses {a['losses']} vs "
                             f"{b['losses']}")
    for key in ("g", "d", "states"):
        for x, y in zip(a.get(key, []), b.get(key, [])):
            if not torch.equal(x, y):
                raise AssertionError(f"{label}: a {key} tensor differs, max "
                                     f"diff {max_err(x, y)}")
    for k, v in a.get("bn", {}).items():
        if not torch.equal(v, b["bn"][k]):
            raise AssertionError(f"{label}: batch norm {k} differs")


def dp_phase(size=TRAIN_SIZE, device: str = "cuda"):
    """(x) data parallel on the one card, three parts:
    1. one rank under NCCL in this process (world size 1): the G+D
       iteration and the estimation step through ``mesh=data_mesh()``,
       bit-equal (losses, gradients, batch norms, final states) to the
       trainers without a mesh from the same seed; both timed;
    2. two ranks on the card under gloo, as subprocesses, the global batch
       8 split 4 + 4, held to the 1-rank joint-batch step that rank 0
       runs after its own (``dp_rank``), whose per-sample nets and D's
       convolutions and statistics run the batch in the ranks' two parts
       (cuDNN picks
       convolution algorithms by batch size, and at random weights the
       estimation loss's log of the clamped disparity turns that into
       gradients some per cent apart): losses rtol 1e-5, each gradient leaf
       of G, D and Disparity within 1e-4 relative L2, or, on a D leaf where
       the two f32 runs part further, the ranks' leaf no further from D's
       float64 gradient than the 1-rank run's is (plus 1e-4), D's
       batch-norm buffers rtol 1e-5, states bit-equal across the ranks,
       per rank six forward splat kernels and one ``splat_grad`` a local
       batch item on the G step; the step ms (gloo stages every
       all-reduce through the host: a correctness check, not the cost of
       NVLink data parallelism);
    3. ``batch_parallel_effect`` over the two ranks, 4 images at 256^2, 5
       steps: each image's frames equal its single-image effect's.

    On the CPU (``device='cpu'``, gloo in part 1 too, ``TRAIN_BATCH`` and
    ``size`` cut) it rehearses the same control flow."""
    import socket
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist
    from kbe_torch.parallel import data_mesh, initialize_multihost

    def free_port() -> int:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    h, w = size
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        # part 1: both steps deterministic without a mesh (they warm up
        # too), then on one NCCL rank
        _deterministic(True, device)
        plain = _dp_run(None, size, device, tmp + "/plain", "(x) no mesh")
        if not initialize_multihost(f"127.0.0.1:{free_port()}", 1, 0,
                                    device=device):
            raise RuntimeError("(x) no NCCL process group")
        try:
            one = _dp_run(data_mesh(1, device=device), size, device,
                          tmp + "/one", "(x) 1 NCCL rank")
        finally:
            dist.destroy_process_group()
        for kind in ("adv", "est"):
            _assert_bit_equal(f"(x) 1 NCCL rank, {kind}", one[kind],
                              plain[kind])
        log(f"(x) 1 NCCL rank through data_parallel_step, {h}x{w}, batch "
            f"{TRAIN_BATCH}: G+D iteration {one['adv']['ms']:.1f} ms (no "
            f"mesh {plain['adv']['ms']:.1f} ms), estimation step "
            f"{one['est']['ms']:.1f} ms (no mesh {plain['est']['ms']:.1f} "
            f"ms); losses, gradients, batch norms and "
            f"{len(one['adv']['states']) + len(one['est']['states'])} state "
            "tensors bit-equal to the trainers without a mesh")
        del one
        for part in plain.values():
            part.pop("states")
        if device == "cuda":
            torch.cuda.empty_cache()

        # parts 2 and 3 on two gloo ranks, and the reference on rank 0
        env = dict(os.environ, MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(free_port()), WORLD_SIZE=str(DP_WORLD),
                   LOCAL_RANK="0")
        t_ranks = time.perf_counter()
        call = (f"import chip_smoke as cs; cs.dp_rank({tmp!r}, "
                f"{tuple(size)!r}, {device!r}, {TRAIN_BATCH})")
        procs = [subprocess.Popen([sys.executable, "-c", call], cwd=HERE,
                                  env=dict(env, RANK=str(r)))
                 for r in range(DP_WORLD)]
        try:
            for r, p in enumerate(procs):
                if p.wait(timeout=600) != 0:
                    raise AssertionError(f"(x) rank {r} failed: exit "
                                         f"{p.returncode}")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                            weights_only=False) for r in range(DP_WORLD)]
        wall = time.perf_counter() - t_ranks
    got, ref = ranks[0], ranks[0].pop("ref")
    groups = (("G", "adv", "g"), ("D", "adv", "d"), ("Disparity", "est", "g"))
    worst = {name: _dp_worst(got[kind][key], ref[kind][key])
             for name, kind, key in groups if name != "D"}
    worst["D"], refereed, d_failed = _d_refereed(
        got["adv"]["d"], ref["adv"]["d"], ref["adv"]["d_f64"],
        ref["adv"]["d_names"])

    def apart(a, b):
        return max(_rel_l2(x, y) for x, y in zip(a, b))

    by_parts = {name: apart(ref[kind][key], plain[kind][key])
                for name, kind, key in groups}
    nbytes = {name: 4 * sum(t.numel() for t in plain[kind][key])
              for name, kind, key in groups}
    log(f"(x) {DP_WORLD} gloo ranks on one card, {h}x{w}, global batch "
        f"{TRAIN_BATCH} ({TRAIN_BATCH // DP_WORLD} a rank): G+D iteration "
        f"{[round(r['adv']['ms'], 1) for r in ranks]} ms, estimation step "
        f"{[round(r['est']['ms'], 1) for r in ranks]} ms a rank (gloo "
        "stages every all-reduce through the host: a correctness check, "
        f"not NVLink data parallelism); worst gradient leaf against the "
        f"1-rank run (relative L2, limit {DP_GRAD_TOL}): "
        f"{json.dumps(worst)}; D's leaves beyond it against float64 (ranks, "
        f"1 rank): {json.dumps(refereed)}; the 1-rank step with its nets "
        f"in {DP_WORLD} parts against the whole batch (worst leaf) "
        f"{json.dumps(by_parts)}"
        f"; gradient bytes all-reduced a step {json.dumps(nbytes)}; "
        f"launches a rank {json.dumps(got['adv']['launches'])}; the two "
        f"ranks' processes {wall:.1f} s, rank 0's reference run included")
    for r, run in enumerate(ranks):
        for kind in ("adv", "est"):
            if not run[kind]["equal"]:
                raise AssertionError(f"(x) rank {r} {kind}: states differ "
                                     "across the ranks")
            for k, v in ref[kind]["losses"].items():
                if abs(run[kind]["losses"][k] - v) > DP_LOSS_RTOL * abs(v) \
                        + 1e-7:
                    raise AssertionError(
                        f"(x) rank {r} {kind} loss {k}: "
                        f"{run[kind]['losses'][k]} vs 1 rank {v}")
    bad = {k: v for k, v in worst.items()
           if k != "D" and not v[0] <= DP_GRAD_TOL}
    if d_failed:
        bad["D"] = d_failed
    if bad:
        raise AssertionError(f"(x) 2 ranks: gradients part from the 1-rank "
                             f"run's: {bad}")
    for k, v in ref["adv"]["bn"].items():
        np.testing.assert_allclose(got["adv"]["bn"][k].numpy(), v.numpy(),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    log(f"(x) losses within rtol {DP_LOSS_RTOL}, gradient leaves within "
        f"{DP_GRAD_TOL} (D's {len(refereed)} refereed leaves no further from "
        "float64 than the 1-rank run's), batch norms within rtol 1e-5 of "
        "the 1-rank run; states bit-equal across the ranks")

    # part 3
    _deterministic(False, device)  # the effect's kernels are deterministic
    want, _ = _dp_effect(None, device)
    frames = got["frames"]
    if frames is None or not torch.equal(frames, want):
        raise AssertionError("(x) batch_parallel_effect: frames differ from "
                             "the single-image effect's")
    n, steps = DP_EFFECT["size"], DP_EFFECT["steps"]
    per_rank = DP_EFFECT["images"] // DP_WORLD
    want_counts = ({**splat_counts(4, steps * per_rank),
                    **splat_counts(68, 2 * per_rank),
                    "discfill": steps * per_rank,
                    "finish": steps * per_rank} if device == "cuda"
                   else {})
    for r, run in enumerate(ranks):
        if run["effect_launches"] != want_counts:
            raise AssertionError(f"(x) effect rank {r}: launches "
                                 f"{run['effect_launches']}, want "
                                 f"{want_counts}")
    log(f"(x) batch_parallel_effect, {DP_EFFECT['images']} images at {n}^2 "
        f"x {steps} steps on {DP_WORLD} ranks: frames {tuple(frames.shape)} "
        f"equal to each image's single-image effect; launches a rank "
        f"{json.dumps(want_counts)}")
    log(f"(x) {time.perf_counter() - t_phase:.1f} s in all (part 1 "
        f"{t_ranks - t_phase:.1f} s)")


BW_STEPS = (3, 2, 3)        # (y)'s short recipe: depth, refine, inpaint
FIDELITY_BAR = 0.99         # PERF.md section 2: mean SSIM, production/spec


def _nets_equal(a: str, b: str):
    """Whether two pipeline checkpoints hold equal nets, bit for bit; and
    whether the files are equal byte for byte."""
    import torch

    na = torch.load(a, weights_only=True)["pipeline"]
    nb = torch.load(b, weights_only=True)["pipeline"]
    nets = set(na) == set(nb) and all(
        na[k].keys() == nb[k].keys()
        and all(torch.equal(na[k][e], nb[k][e]) for e in na[k])
        for k in na)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return nets, fa.read() == fb.read()


def trained_weights_phase(size: int = SIZE, steps: int = STEPS,
                          small: int = 256, fid_steps: int = 9,
                          device: str = "cuda", sizes=None):
    """(y) trained weights: ``tools/make_bench_weights_torch.py``'s recipe
    at a short schedule (``BW_STEPS``), twice from one seed, bit-equal
    checkpoints; the checkpoint found through ``find_bench_weights`` with
    ``KBE_BENCH_WEIGHTS`` set; the ``size``^2 x ``steps`` effect at the
    production mix from it through ``KenBurnsPipeline.create(checkpoint=)``
    (launch counts, frames/s, valid points per grid, holes a frame);
    ``cli/kbe_torch.py``'s ``run --checkpoint --bf16`` at ``small``^2 equal
    to the loaded pipeline's frames; and ``fidelity_report_torch``'s
    production path against its spec path at ``small``^2 x ``fid_steps``,
    mean SSIM at least ``FIDELITY_BAR``. ``sizes``: the recipe's stage
    sizes (a CPU rehearsal's)."""
    import tempfile

    import numpy as np
    import torch
    from cli import kbe_torch as cli
    from kbe_torch.config import EffectConfig, ZoomSettings
    from kbe_torch.data import demo_scene_image
    from kbe_torch.pipeline import KenBurnsPipeline
    from kbe_torch.train.checkpoint import find_bench_weights
    from kbe_torch.pipeline.kenburns import path_stats
    from tools.fidelity_report_torch import fidelity_report
    from tools.make_bench_weights_torch import make_bench_weights

    mix = dict(dtype=torch.bfloat16, depth_dtype=torch.float32)
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        made = [make_bench_weights(*BW_STEPS, out_dir=os.path.join(
            tmp, f"run{i}"), device=device, sizes=sizes,
            log=lambda *a: None) for i in range(2)]
        nets, files = _nets_equal(made[0][0], made[1][0])
        losses = [{k: v["losses"] for k, v in r.items()} for _, r in made]
        if not nets or losses[0] != losses[1]:
            raise AssertionError(f"(y) two recipe runs differ: nets equal "
                                 f"{nets}, losses {losses}")
        report = made[0][1]
        log(f"(y) recipe at {list(BW_STEPS)} steps (depth, refine, "
            "inpaint), twice from one seed: nets and losses bit-equal, "
            f"files byte-equal {files}; ms a step (first run, the first "
            "step included) " + json.dumps(
                {k: round(v["ms_a_step"], 1) for k, v in report.items()})
            + f"; {os.path.getsize(made[0][0]) / 2**20:.1f} MiB")
        for name, stage in report.items():
            _check_losses(f"(y) {name}", {str(i): v for i, v in
                                           enumerate(stage["losses"])})

        before = os.environ.get("KBE_BENCH_WEIGHTS")
        os.environ["KBE_BENCH_WEIGHTS"] = made[0][0]
        try:
            ckpt = find_bench_weights()
        finally:
            if before is None:
                del os.environ["KBE_BENCH_WEIGHTS"]
            else:
                os.environ["KBE_BENCH_WEIGHTS"] = before
        if ckpt != made[0][0]:
            raise AssertionError(f"(y) find_bench_weights gave {ckpt}")

        pipe = KenBurnsPipeline.create(
            effect=EffectConfig(num_steps=steps), device=device,
            checkpoint=ckpt, **mix)
        image_np = demo_scene_image(size, size)
        pipe(image_np)  # warm-up
        clear_launches()
        frames = pipe(image_np)
        counts = launch_counts()
        want = ({**splat_counts(4, steps), **splat_counts(68, 2),
                 "discfill": steps, "finish": steps} if device == "cuda"
                else {})
        if counts != want:
            raise AssertionError(f"(y) launches {counts}, want {want}")
        if frames.shape != (steps, size, size, 3) \
                or int(frames.max()) == int(frames.min()):
            raise AssertionError(f"(y) frames {frames.shape}, constant or "
                                 "not")
        zoom = ZoomSettings.default_3d(size, size)
        stats = path_stats(pipe.effect_fn(size, size, zoom), pipe.models,
                           torch.as_tensor(image_np, device=device)[None],
                           size, size, zoom, pipe.effect)
        log(f"(y) trained weights, {size}^2 x {steps} frames, bf16 "
            f"inpainting + f32 depth: launches {json.dumps(counts)}; "
            f"{stats['frames_per_s']:.3f} frames/s (front end "
            f"{stats['front_end_s'] * 1e3:.3f} ms, pose loop "
            f"{stats['pose_loop_ms_a_frame']:.3f} ms/frame; runs "
            f"{[round(t, 4) for t in stats['runs_s']]} s); "
            f"{stats['valid_points']} valid points of {stats['points']}, per "
            f"grid {stats['valid_points_per_grid']} (shares "
            f"{[round(v, 6) for v in stats['valid_share_per_grid']]}); hole "
            f"pixels a frame in the fill's ROI {stats['fill_roi']}: "
            f"{stats['hole_pixels_a_frame']:.1f} (most "
            f"{stats['hole_pixels_max_frame']}); frames mean "
            f"{float(frames.mean()):.3f}")
        del pipe

        image = (demo_scene_image(small, small) * 255.0).astype(np.uint8)
        got = cli.run(cli.build_parser().parse_args(
            ["--checkpoint", ckpt, "--bf16", "--steps", "5", "--device",
             device]), image)
        want = KenBurnsPipeline.create(
            effect=EffectConfig(num_steps=5), device=device,
            checkpoint=ckpt, **mix)(image.astype(np.float32) / 255.0)
        if not np.array_equal(got, want):
            raise AssertionError("(y) cli run --checkpoint: frames differ "
                                 "from the loaded pipeline's")
        log(f"(y) cli run --checkpoint --bf16 at {small}^2, 5 steps: frames "
            "equal to the loaded pipeline's")

        fid = fidelity_report(small, fid_steps, checkpoint=ckpt,
                              device=device, log=lambda *a: None)
    log(f"(y) fidelity, production against spec at {small}^2 x "
        f"{fid_steps}: mean SSIM {fid['mean_ssim']:.6f}, min "
        f"{fid['min_ssim']:.6f}, max abs diff "
        f"{fid['max_abs_diff_uint8']:.0f}; kernels_f32_path mean "
        f"{fid['kernels_f32_path']['mean_ssim']:.6f}, min "
        f"{fid['kernels_f32_path']['min_ssim']:.6f}; production "
        f"{fid['production_stats']['hole_pixels_a_frame']:.1f} holes a "
        f"frame; {time.perf_counter() - t_phase:.1f} s in all")
    if fid["mean_ssim"] < FIDELITY_BAR:
        raise AssertionError(f"(y) production against spec: mean SSIM "
                             f"{fid['mean_ssim']} < {FIDELITY_BAR}")


SPEC_SIZE, SPEC_STEPS = 256, 9
SPEC_BAR = 0.999            # production kernels with f32 nets vs the spec


def spec_phase(main_counts, size: int = SPEC_SIZE, steps: int = SPEC_STEPS,
               device: str = "cuda"):
    """(z) the spec path launches no hand-written kernel; the production
    path with the same f32 nets is held to it (mean SSIM at least
    ``SPEC_BAR``); the layer tools' stages launch the main path's kernels
    where the main path does: ``main_counts`` are the main path's counts
    over its ``STEPS`` frames (empty on the CPU)."""
    import torch
    from kbe_torch.config import EffectConfig
    from kbe_torch.pipeline.kenburns import build_effect_fn
    from tools.bench_scene_torch import bench_scene
    from tools.fidelity_report_torch import compare
    from tools.profile_frame_torch import profile_frame
    from tools.profile_frontend_torch import profile_frontend

    on_card = device == "cuda"
    t0 = time.perf_counter()
    scene = bench_scene(size, steps, None, "all_f32", device=device)
    spec_fn = build_effect_fn(size, size, scene["zoom"], scene["camera"],
                              EffectConfig(num_steps=steps,
                                           splat_method="scatter",
                                           fill_impl="xla"), device=device)
    clear_launches()
    spec = spec_fn(scene["models"], scene["image"]).cpu().numpy()
    if launch_counts():
        raise AssertionError(f"(z) the spec path launched hand-written "
                             f"kernels: {launch_counts()}")
    clear_launches()
    prod = scene["fn"](scene["models"], scene["image"]).cpu().numpy()
    want = ({**splat_counts(4, steps), **splat_counts(68, 2),
             "discfill": steps, "finish": steps} if on_card else {})
    expect_counts("(z) production path, f32 nets", want)
    row = compare(prod, spec)
    log(f"(z) spec path (scatter + xla, f32 nets) at {size}^2 x {steps}, "
        f"{scene['weights']}: no hand-written kernel launched; production "
        f"kernels with the same nets against it: mean SSIM "
        f"{row['mean_ssim']:.6f}, min {row['min_ssim']:.6f} (frame "
        f"{row['argmin_ssim_frame']}), max abs diff "
        f"{row['max_abs_diff_uint8']:.0f} of 255, "
        f"{row['pixels_diff_gt8_per_frame']:.1f} pixels a frame > 8")
    if row["mean_ssim"] < SPEC_BAR:
        raise AssertionError(f"(z) production against spec: mean SSIM "
                             f"{row['mean_ssim']} < {SPEC_BAR}")

    boot = {k: v for k, v in main_counts.items() if k.endswith("/c68")}
    frame = {k: v / STEPS for k, v in main_counts.items() if k not in boot}
    front = profile_frontend(scene=scene, reps=1)
    got = {}
    for r in front["stages"]:
        if r["kernels"] and not r["stage"].endswith("/splat68"):
            raise AssertionError(f"(z) front-end stage {r['stage']} "
                                 f"launched {r['kernels']}")
        for k, v in r["kernels"].items():
            got[k] = got.get(k, 0) + v
    if got != boot:
        raise AssertionError(f"(z) front-end stages launched {got}, the "
                             f"main path's bootstrap {boot}")
    frames = profile_frame(scene=scene, reps=1)
    got = {}
    for r in frames["stages"]:
        kernels = r.get("kernels_a_frame", {})   # none for the final wait
        if kernels and r["stage"] not in ("splat", "fill", "finish"):
            raise AssertionError(f"(z) frame stage {r['stage']} launched "
                                 f"{kernels}")
        got.update(kernels)
    if got != frame:
        raise AssertionError(f"(z) frame stages launched {got} a frame, "
                             f"the main path {frame}")
    if on_card:   # device columns are None where a profile lost kernels
        log(f"(z) tools at {size}^2: front-end stages sum "
            f"{front['sum_host_ms']:.3f} ms against the front end's "
            f"{front['front_end_ms']:.3f} ({front['sum_over_front_end']:.4f}"
            f"), device ms {front['sum_device_ms']}, launches "
            f"{front['sum_launches']}; frame stages sum "
            f"{frames['sum_host_ms_a_frame']:.4f} ms a frame against the "
            f"loop's {frames['render_frames_ms_a_frame']:.4f} "
            f"({frames['sum_over_render_frames']:.4f}), launches a frame "
            f"{frames['sum_launches_a_frame']}; their hand-written launches "
            f"are the main path's")
    log(f"(z) {time.perf_counter() - t0:.1f} s")
    return row


def main() -> int:
    # cuBLAS is deterministic under torch.use_deterministic_algorithms only
    # with a fixed workspace, which must be set before its first call
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    t_start = time.perf_counter()
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
    trained = training_phase(more)
    evaluation_phase(more, trained, depth_phase())
    del trained
    maskrcnn_phase(more)
    torch.cuda.empty_cache()
    dp_phase()
    torch.cuda.empty_cache()
    trained_weights_phase()
    spec_phase(counts)
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
        else:  # (e), (p), (t) and (w) counted their own runs
            assert "launches" in row, row["name"]
    rows += more
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s, the build "
        "included")
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
