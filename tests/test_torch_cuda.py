"""kbe_torch's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: each test skips where there is no CUDA device. Run on the
card with ``KBE_TESTS_ALLOW_TPU=1 python -m pytest tests/test_torch_cuda.py
-q``. Every kernel is exact: the front half (the z-buffer's keys and its
degridded copy) and the fill are bit-identical to the plain versions on
the card, and the accumulation and
the render to the plain version on the CPU (whose ``index_add_`` sums in
ascending entry order, the order the sum pass reproduces; on the card
``index_add_`` uses atomics). Two renders of one cloud are bit-equal.
"""

import numpy as np
import pytest
import torch

from kbe_torch.ops import discfill as D
from kbe_torch.ops import finish as F
from kbe_torch.ops import pconv as P
from kbe_torch.ops import splat as S
from kbe_torch.ops.geometry import depth_to_points
from tests.test_torch_finish import CASES as FINISH_CASES
from tests.test_torch_finish import case_taps, filled_frames

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _cloud(cuda, h, w, c, seed):
    g = torch.Generator().manual_seed(seed)
    depth = 100.0 + 50.0 * torch.rand(h, w, generator=g)
    depth[h // 4:h // 2, w // 4:w // 2] = 20.0
    xyz = depth_to_points(depth, 128.0).reshape(-1, 3)
    payload = torch.rand(h * w, c, generator=g)
    valid = (torch.rand(h * w, generator=g) > 0.1).float()
    return xyz.to(cuda), payload.to(cuda), valid.to(cuda)


@pytest.mark.parametrize("c", [4, 68])
def test_splat_kernels_match_plain(cuda, c):
    h, w = 96, 128
    xyz, payload, valid = _cloud(cuda, h, w, c, seed=c)
    pose = S.make_pose(torch.tensor([3.5, -2.0, -10.0], device=cuda), 128.0,
                       60.0)
    counts = torch.empty(h * w, dtype=torch.int32, device=cuda)
    keys, deg = S.front_cuda(xyz, valid, pose, h, w, c, counts=counts)
    zee = S.zee_plain(xyz, valid, pose, h, w)
    assert torch.equal(S.decode_keys(keys).reshape(h, w), zee)
    assert torch.equal(deg, S.degrid_plain(zee))
    acc = S.accumulate_cuda(xyz, valid, payload, pose, deg, h, w)
    want = _plain_on_cpu(xyz, valid, payload, pose, deg, h, w)
    assert torch.equal(acc.cpu(), want)
    # the counts the front half zeroed, as ``splat`` hands them on
    assert torch.equal(S.accumulate_cuda(xyz, valid, payload, pose, deg, h,
                                         w, counts=counts), acc)
    assert torch.equal(counts, S.count_cuda(xyz, valid, pose, deg, h, w, c))
    rendered, existing = S.splat(xyz, payload, valid, pose, h, w)
    assert torch.equal(rendered.cpu(), (want[:, :c] / (want[:, c:] + 1e-7))
                       .reshape(h, w, c))
    assert torch.equal(existing.cpu(), want[:, c:].reshape(h, w, 1))


def _front_case(cuda, case):
    """(xyz, valid, h, w) of a front-half case."""
    if case == "odd":       # tile-ragged, W % 4 != 0: no 16 B rows
        h, w = 37, 1029
        xyz, _, valid = _cloud(cuda, h, w, 1, seed=21)
        xyz[:64, 0] = 0.0    # a near patch with negative keys in the image
        xyz[:64, 1] = 0.0
        xyz[:64, 2] = 0.005  # f*b/z = 1.5e6
        return xyz, valid, h, w
    if case == "empty":
        return (torch.zeros(0, 3, device=cuda), torch.zeros(0, device=cuda),
                48, 64)
    if case == "all_invalid":
        xyz, _, valid = _cloud(cuda, 48, 64, 1, seed=22)
        return xyz, torch.zeros_like(valid), 48, 64
    if case == "no_mask":
        xyz, _, _ = _cloud(cuda, 33, 260, 1, seed=23)
        return xyz, None, 33, 260
    # chip_smoke.py's pathological pile, at 256^2: a quarter of the points
    # on one pixel
    h = w = 256
    xyz, _, valid = _cloud(cuda, h, w, 1, seed=24)
    g = torch.Generator().manual_seed(25)
    pile = torch.randperm(h * w, generator=g)[:h * w // 4].to(cuda)
    z = 100.0 + torch.rand(len(pile), generator=g).to(cuda)
    xyz[pile, 0] = (70.5 - w / 2 + 0.5) * z / 128.0
    xyz[pile, 1] = (40.5 - h / 2 + 0.5) * z / 128.0
    xyz[pile, 2] = z
    return xyz, valid, h, w


@pytest.mark.parametrize("case", ["odd", "empty", "all_invalid", "no_mask",
                                  "pathological"])
def test_front_half_matches_plain(cuda, case):
    """``front_cuda``'s keys and degridded buffer against ``zee_plain`` and
    ``degrid_plain``, the counts zeroed, its three kernels launched (no
    zee for no points); and the whole render against the CPU's plain
    one."""
    xyz, valid, h, w = _front_case(cuda, case)
    pose = S.make_pose(torch.zeros(3, device=cuda), 128.0, 60.0)
    counts = torch.full((h * w,), 7, dtype=torch.int32, device=cuda)
    S.LAUNCHES.clear()
    keys, deg = S.front_cuda(xyz, valid, pose, h, w, 4, counts=counts)
    kernels = ("fill", "degrid") if case == "empty" else (
        "fill", "zee", "degrid")
    assert dict(S.LAUNCHES) == {f"{k}/c4": 1 for k in kernels}
    zee = S.zee_plain(xyz, valid, pose, h, w)
    assert torch.equal(S.decode_keys(keys).reshape(h, w), zee)
    assert torch.equal(deg, S.degrid_plain(zee))
    assert not counts.any()
    if case == "odd":
        assert (zee < 0).any()
    if case in ("empty", "all_invalid"):
        assert bool((zee == 1e6).all())
    payload = torch.rand(xyz.shape[0], 4, device=cuda)
    got = S.splat(xyz, payload, valid, pose, h, w)
    want = S.splat(xyz.cpu(), payload.cpu(),
                   None if valid is None else valid.cpu(), pose.cpu(), h, w)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))


def test_front_half_refuses_bad_inputs(cuda):
    xyz, _, valid = _cloud(cuda, 8, 8, 1, seed=26)
    pose = S.make_pose(torch.zeros(3, device=cuda), 128.0, 60.0)
    with pytest.raises(ValueError, match="valid"):
        S.front_cuda(xyz, valid[:-1], pose, 8, 8, 4)
    with pytest.raises(ValueError, match="counts"):
        S.front_cuda(xyz, valid, pose, 8, 8, 4,
                     counts=torch.zeros(63, dtype=torch.int32, device=cuda))


def _plain_on_cpu(xyz, valid, payload, pose, zee, h, w):
    return S.accumulate_plain(xyz.cpu(), valid.cpu(), payload.cpu(),
                              pose.cpu(), zee.cpu(), h, w)


@pytest.mark.parametrize("c", [4, 68])
def test_two_renders_are_bit_equal(cuda, c):
    h, w = 96, 128
    xyz, payload, valid = _cloud(cuda, h, w, c, seed=c + 1)
    pose = S.make_pose(torch.tensor([1.5, -1.0, -5.0], device=cuda), 128.0,
                       60.0)
    first = S.splat(xyz, payload, valid, pose, h, w)
    second = S.splat(xyz, payload, valid, pose, h, w)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("c", [4, 68])
@pytest.mark.parametrize("spots,least,most", [
    (400, 17, 64),        # a warp sorts each segment across its lanes
    (64, 33, 2048),       # the block sorts one run in shared memory
    (2, 2049, 1 << 20),   # runs of 2048 merged in global scratch
])
def test_long_segments_match_plain(cuda, c, spots, least, most):
    """A third of the points piled on a few spots, so that the longest
    segments are beyond the thread's register sort (16 entries) and reach
    each longer path: the warp's, the block's, the block's with merges."""
    h, w = 128, 192
    xyz, payload, valid = _cloud(cuda, h, w, c, seed=7)
    g = torch.Generator().manual_seed(8)
    pile = torch.randperm(h * w, generator=g)[:h * w // 3].to(cuda)
    spot = torch.randint(0, spots, (len(pile),), generator=g).to(cuda)
    # z within 0.3 of 100: keys within 1 of each other, so all are visible
    z = 100.0 + 0.3 * torch.rand(len(pile), generator=g).to(cuda)
    # pixel centres below and right of the near box, which would hide them
    u = 100.3 + 4.0 * (spot % 20)
    v = 70.3 + 2.0 * (spot // 20)
    xyz[pile, 0] = (u - w / 2 + 0.5) * z / 128.0
    xyz[pile, 1] = (v - h / 2 + 0.5) * z / 128.0
    xyz[pile, 2] = z
    pose = S.make_pose(torch.zeros(3, device=cuda), 128.0, 60.0)
    _, deg = S.front_cuda(xyz, valid, pose, h, w, c)
    longest = int(S.count_cuda(xyz, valid, pose, deg, h, w, c).max())
    assert least <= longest <= most
    for normalize in (False, True):
        acc = S.accumulate_cuda(xyz, valid, payload, pose, deg, h, w,
                                normalize=normalize)
        want = _plain_on_cpu(xyz, valid, payload, pose, deg, h, w)
        if normalize:
            want = torch.cat([want[:, :c] / (want[:, c:] + 1e-7),
                              want[:, c:]], dim=1)
        assert torch.equal(acc.cpu(), want)


def test_fill_wide_holes_match_plain(cuda):
    """Bands of holes wider than most rays, isolated holes with distance
    ties, rays that run out of steps, and a C=3 image (no 16 B copy)."""
    g = torch.Generator().manual_seed(4)
    for c in (4, 3):
        image = torch.rand(160, 224, c, generator=g)
        depth = torch.rand(160, 224, 1, generator=g) * 50.0 + 1.0
        depth[torch.rand(160, 224, 1, generator=g) < 0.05] = 0.0
        depth[40:100, 30:200] = 0.0
        depth[120:150, 10:60] = 0.0
        image, depth = image.to(cuda), depth.to(cuda)
        for steps in (8, 64, 128, 256):
            for roi in (None, (20, 140, 25, 210)):
                got = D.fill_cuda(image, depth, steps, roi)
                assert torch.equal(got, D.fill_plain(image, depth, steps,
                                                     roi))


@pytest.mark.parametrize("roi", [None, (10, 80, 20, 100)])
def test_fill_kernel_bit_identical(cuda, roi):
    g = torch.Generator().manual_seed(1)
    image = torch.rand(96, 128, 4, generator=g)
    depth = torch.rand(96, 128, 1, generator=g) * 50.0
    depth[torch.rand(96, 128, 1, generator=g) < 0.4] = 0.0
    depth[30:40, 20:90] = 0.0
    image, depth = image.to(cuda), depth.to(cuda)
    for steps in (16, 128):
        got = D.fill_cuda(image, depth, steps, roi)
        assert torch.equal(got, D.fill_plain(image, depth, steps, roi))


def _grids(h, w, grids, c, seed):
    """A (G, H, W) grid cloud on the CPU: shifted planes with a near box,
    later grids valid on a random half."""
    from kbe_torch.ops.geometry import apply_shift

    g = torch.Generator().manual_seed(seed)
    xyz, valid = [], []
    for i in range(grids):
        depth = (100.0 + 10.0 * i) + 50.0 * torch.rand(h, w, generator=g)
        depth[h // 4:h // 2, w // 4:w // 2] = 20.0 + i
        xyz.append(depth_to_points(depth, 128.0))
        valid.append(torch.ones(h, w) if i == 0
                     else (torch.rand(h, w, generator=g) > 0.5).float())
    xyz = apply_shift(torch.stack(xyz), torch.tensor([3.5, -2.0, -10.0]))
    return xyz, torch.rand(grids, h, w, c, generator=g), torch.stack(valid)


def _entry_points():
    from kbe_torch.ops import legacy, splat_banded, splat_routed

    return {"routed": splat_routed.render_grids_routed,
            "fast": splat_routed.render_grids_fast,
            "banded": splat_banded.render_grids_banded,
            "fast_banded": splat_banded.render_grids_fast_banded,
            "delta": legacy.render_grids_delta,
            "fast_delta": legacy.render_grids_fast_delta,
            "pallas": legacy.render_grids_pallas}


@pytest.mark.parametrize("name", ["routed", "fast", "banded", "fast_banded",
                                  "delta", "fast_delta", "pallas"])
@pytest.mark.parametrize("grids,c", [(3, 4), (1, 68)])
def test_grid_entry_point_runs_the_kernels(cuda, name, grids, c):
    """Each ``render_grids_*`` on CUDA tensors against its own plain route
    (the same call on CPU tensors) at 256^2, and its six launches."""
    h = w = 256
    fn = _entry_points()[name]
    xyz, data, valid = _grids(h, w, grids, c, seed=c + grids)
    want = fn(xyz, data, h, w, 128.0, 60.0, valid=valid)
    S.LAUNCHES.clear()
    got = fn(xyz.to(cuda), data.to(cuda), h, w, 128.0, 60.0,
             valid=valid.to(cuda))
    assert dict(S.LAUNCHES) == {f"{k}/c{c}": 1 for k in (
        "fill", "zee", "degrid", "count", "place", "sum")}
    assert len(got) == len(want)
    for g, wnt in zip(got[:2], want[:2]):
        assert torch.equal(g.cpu(), wnt)
    if len(got) == 3:
        assert got[2].is_cuda and not bool(got[2])


@pytest.mark.parametrize("kwargs", [
    dict(steps=128), dict(steps=8, phase1_steps=8),
    dict(steps=128, phase1_steps=8, phase0_steps=2, phase0_gate=0.75),
    dict(steps=128, phase1_steps=0, roi=(10, 200, 20, 230))],
    ids=["one_phase", "short", "three_phase", "roi"])
def test_fill_pallas_entry_runs_the_kernel(cuda, kwargs):
    g = torch.Generator().manual_seed(2)
    image = torch.rand(1, 256, 256, 4, generator=g)
    depth = torch.rand(1, 256, 256, 1, generator=g) * 50.0
    depth[torch.rand(1, 256, 256, 1, generator=g) < 0.4] = 0.0
    depth[:, 60:90, 40:200] = 0.0
    want = D.fill_disocclusion_pallas(image, depth, **kwargs)
    D.LAUNCHES.clear()
    got = D.fill_disocclusion_pallas(image.to(cuda), depth.to(cuda),
                                     **kwargs)
    assert dict(D.LAUNCHES) == {"discfill": 1}
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("h, w, move", FINISH_CASES)
def test_finish_kernel_equals_the_plain_chain(cuda, h, w, move):
    """Kernel ``finish`` against the plain chain on the card, bit for bit,
    on seeded frames with values below 0 and above 1 and on one of a
    constant colour, written into the middle slot of a video's buffer: its
    neighbours are left as they were. One launch a frame."""
    taps = case_taps(h, w, move, cuda)
    plan = F.finish_plan(taps)
    for filled in filled_frames(h, w, seed=5 * h + w):
        filled = filled.to(cuda)
        video = torch.full((3, h, w, 3), 7, dtype=torch.uint8, device=cuda)
        F.LAUNCHES.clear()
        F.finish_cuda(filled, plan, video[1])
        torch.cuda.synchronize()
        assert dict(F.LAUNCHES) == {"finish": 1}
        assert torch.equal(video[1], F.finish_plain(filled, taps))
        assert (video[0] == 7).all() and (video[2] == 7).all()


def test_finish_kernel_refuses_bad_inputs(cuda):
    taps = case_taps(64, 64, "3d", cuda)
    plan = F.finish_plan(taps)
    out = torch.empty(64, 64, 3, dtype=torch.uint8, device=cuda)
    for bad in (torch.zeros(64, 64, 3, device=cuda),
                torch.zeros(64, 64, 4, device=cuda, dtype=torch.float64),
                torch.zeros(64, 128, 4, device=cuda)[:, ::2]):
        with pytest.raises(ValueError):
            F.finish_cuda(bad, plan, out)
    shifted = torch.zeros(64 * 64 * 4 + 1, device=cuda)[1:].view(64, 64, 4)
    with pytest.raises(ValueError, match="16 B"):
        F.finish_cuda(shifted, plan, out)
    with pytest.raises(ValueError, match="uint8"):
        F.finish_cuda(torch.zeros(64, 64, 4, device=cuda), plan,
                      out.float())


def _pconv_plain(raw, mask, bias, c_in, in_hw, k, stride, pad):
    """The plain chain on the kernel's inputs."""
    like = torch.empty((raw.shape[0],), device=raw.device)
    coverage = P.coverage_plain(mask, c_in, in_hw, k, stride, pad, like)
    return P.mask_side_plain(raw, coverage, bias, float(c_in * k * k))


def _pconv_inputs(cuda, c_out, k, stride, h, w, dtype, masked, nhwc, seed):
    g = torch.Generator().manual_seed(seed)
    pad = k // 2
    ho, wo = P.out_size(h, k, stride, pad), P.out_size(w, k, stride, pad)
    raw = (torch.randn(1, c_out, ho, wo, generator=g) * 20.0).to(dtype)
    if nhwc:
        raw = raw.contiguous(memory_format=torch.channels_last)
    mask = None
    if masked:
        mask = (torch.rand(1, 1, h, w, generator=g) > 0.2).float()
        mask[:, :, h // 3:h // 2, w // 4:3 * w // 4] = 0.0
    bias = torch.randn(c_out, generator=g).to(dtype)
    return (raw.to(cuda), None if mask is None else mask.to(cuda),
            bias.to(cuda))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_pconv_kernel_equals_the_plain_chain_at_the_nets_shapes(cuda, dtype):
    """Kernel ``pconv`` against the plain chain on the card, bit for bit, at
    every (C_in, C_out, k, stride, H, W) that ``PartialInpaint`` meets at
    1024^2, with a mask and without, channels-last as the net runs and
    NCHW; one launch a call."""
    from kbe_torch.models.partial_conv import net_pconv_shapes

    cases = sorted({s[:6] for s in net_pconv_shapes(1024, 1024)})
    assert len(cases) == 16
    for n, (c_in, c_out, k, stride, h, w) in enumerate(cases):
        for masked in (True, False):
            for nhwc in ((True, False) if n % 4 == 0 else (True,)):
                raw, mask, bias = _pconv_inputs(cuda, c_out, k, stride, h, w,
                                                dtype, masked, nhwc, n)
                args = (bias, c_in, (h, w), k, stride, k // 2)
                P.LAUNCHES.clear()
                got, got_m = P.mask_side_cuda(raw, mask, *args)
                torch.cuda.synchronize()
                assert dict(P.LAUNCHES) == {"pconv": 1}
                want, want_m = _pconv_plain(raw, mask, *args)
                what = (c_in, c_out, k, stride, h, w, masked, nhwc)
                assert got.stride() == want.stride(), what
                assert torch.equal(got_m, want_m), what
                assert torch.equal(got, want), what


def test_pconv_kernel_refuses_bad_inputs(cuda):
    raw, mask, bias = _pconv_inputs(cuda, 8, 3, 1, 16, 20, torch.bfloat16,
                                    True, True, 1)
    args = (8, (16, 20), 3, 1, 1)
    P.mask_side_cuda(raw, mask, bias, *args)
    for bad in (raw.cpu(), raw.half(), raw[:, :, :, ::2],
                raw.permute(0, 1, 3, 2), raw[0]):
        with pytest.raises(ValueError, match="raw"):
            P.mask_side_cuda(bad, mask, bias, *args)
    for bad in (mask.half(), mask.expand(1, 8, 16, 20), mask[:, :, :, :10],
                mask.cpu(), mask.transpose(2, 3).contiguous()):
        with pytest.raises(ValueError, match="mask"):
            P.mask_side_cuda(raw, bad, bias, *args)
    for bad in (bias.float(), bias[:4], bias.cpu()):
        with pytest.raises(ValueError, match="bias"):
            P.mask_side_cuda(raw, mask, bad, *args)
    with pytest.raises(ValueError, match="output"):
        P.mask_side_cuda(raw, mask, bias, 8, (16, 20), 3, 2, 1)
    with pytest.raises(ValueError, match=">= 1"):
        P.mask_side_cuda(raw, mask, bias, 0, (16, 20), 3, 1, 1)


def test_partial_conv_takes_the_kernel_or_refuses_on_the_card(cuda):
    """On the card a partial conv with no gradient wanted takes kernel
    ``pconv``, one launch; with a gradient wanted, the plain chain, equal
    bit for bit; a mask of C_in channels or of another type than f32 is
    refused, not sent quietly to the plain chain."""
    from kbe_torch.models.partial_conv import PartialConv

    g = torch.Generator().manual_seed(5)
    conv = PartialConv(8, 16).to(cuda)
    x = torch.randn(1, 8, 20, 24, generator=g).to(cuda)
    mask = (torch.rand(1, 1, 20, 24, generator=g) > 0.3).float().to(cuda)
    P.LAUNCHES.clear()
    with torch.no_grad():
        out, new_mask = conv(x, mask)
    assert dict(P.LAUNCHES) == {"pconv": 1}
    P.LAUNCHES.clear()
    grad_out, grad_mask = conv(x, mask)
    assert not P.LAUNCHES and grad_out.requires_grad
    assert torch.equal(out, grad_out.detach())
    assert torch.equal(new_mask, grad_mask)
    with torch.no_grad():
        with pytest.raises(ValueError, match="one-channel"):
            conv(x, mask.expand(1, 8, 20, 24).contiguous())
        with pytest.raises(ValueError, match="mask"):
            conv.to(torch.bfloat16)(x.bfloat16(), mask)


def test_all_nets_effect_is_the_same_on_the_kernel_and_the_plain_chain(
        cuda, monkeypatch):
    """The residual refine, the partial-conv nets and the dual colour/depth
    pair at 256^2, 5 steps, production precisions: the partial convs take
    kernel ``pconv`` (one launch each, as ``pconv_calls`` counts them,
    four nets' worth a video) and give the frames the plain chain gives,
    bit for bit."""
    from kbe_torch.config import EffectConfig
    from kbe_torch.data import demo_scene_image
    from kbe_torch.models import partial_conv as PC
    from kbe_torch.pipeline import KenBurnsPipeline
    from kbe_torch.utils import logging as trace

    pipe = KenBurnsPipeline.create(
        0, effect=EffectConfig(num_steps=5), device=cuda,
        dtype=torch.bfloat16, depth_dtype=torch.float32,
        pretrained_refine=True, partial_inpainting=True, inpaint_depth=True)
    image = demo_scene_image(256, 256)
    P.LAUNCHES.clear()
    trace.reset_counters()
    with trace.tracing():
        frames = pipe(image)
    counts = trace.counters()
    trace.reset_counters()
    assert counts["pconv_calls"] == 4 * 57 == P.LAUNCHES["pconv"]
    monkeypatch.setattr(PC.pconv, "mask_side_cuda", _pconv_plain)
    P.LAUNCHES.clear()
    plain = pipe(image)
    assert not P.LAUNCHES
    assert (frames == plain).all()
    assert (frames[0] != frames[-1]).any()


def test_videos_come_back_in_page_locked_blocks_kept_apart(cuda):
    """``__call__`` at 256^2, 5 poses: the array is ``render_frames``'s
    frames bit for bit, in page-locked memory; two videos held at once
    share no memory; once the first is dropped, a third video takes a
    cached block and counts no ``pinned_allocs``."""
    from kbe_torch.config import EffectConfig, ZoomSettings
    from kbe_torch.data import demo_scene_image
    from kbe_torch.pipeline import KenBurnsPipeline
    from kbe_torch.utils import logging as trace

    pipe = KenBurnsPipeline.create(0, effect=EffectConfig(num_steps=5),
                                   device=cuda)
    image = demo_scene_image(256, 256)
    first = pipe(image)
    fn = pipe.effect_fn(256, 256, ZoomSettings.default_3d(256, 256))
    frames = fn.render_frames(fn.front_end(pipe.models, torch.as_tensor(
        np.asarray(image, np.float32), device=cuda)[None]))
    want = frames.cpu().numpy()
    assert first.shape == (5, 256, 256, 3) and first.dtype == np.uint8
    assert np.array_equal(first, want)
    assert (first[0] != first[-1]).any()
    assert torch.from_numpy(first).is_pinned()
    second = pipe(image)
    assert not np.shares_memory(first, second)
    assert np.array_equal(second, want)
    del first
    trace.reset_counters()
    with trace.tracing():
        third = pipe(image)
    counts = trace.counters()
    trace.reset_counters()
    assert counts["pinned_allocs"] == 0
    assert counts["bytes_to_host"] == third.nbytes
    assert torch.from_numpy(third).is_pinned()
    assert not np.shares_memory(second, third)
    assert np.array_equal(third, want)


def test_autozoom_on_the_card_picks_the_cpu_window(cuda):
    from kbe_torch.config import CameraConfig, ZoomWindow
    from kbe_torch.ops.geometry import depth_range
    from kbe_torch.pipeline import autozoom

    h = w = 256
    g = torch.Generator().manual_seed(3)
    depth = 160.0 + 20.0 * torch.rand(h, w, generator=g)
    depth[64:160, 64:160] = 80.0
    cam = CameraConfig(focal=256.0, baseline=40.0)
    points = depth_to_points(depth[None], cam.focal).reshape(1, -1, 3)
    image = torch.rand(1, h, w, 3, generator=g)
    window = ZoomWindow(128.0, 128.0, 224, 224)
    want = autozoom(points, image, window, 1.25, 24.0,
                    depth_range(depth, 32), cam, grid=4)
    S.LAUNCHES.clear()
    got = autozoom(points.to(cuda), image.to(cuda), window, 1.25, 24.0,
                   depth_range(depth.to(cuda), 32), cam, grid=4)
    assert dict(S.LAUNCHES) == {f"{k}/c3": 16 for k in (
        "fill", "zee", "degrid", "count", "place", "sum")}
    assert got == want


def _grad_case(cuda, case, c):
    """(xyz, valid, h, w) of a gradient case."""
    if case in ("odd", "empty", "all_invalid", "no_mask"):
        return _front_case(cuda, case)
    h, w = 96, 128  # masked, edge
    xyz, _, valid = _cloud(cuda, h, w, c, seed=30 + c)
    return xyz, valid, h, w


def _equal_or_both_nan(a, b):
    """Equal values, NaN where the other has NaN (an edge gradient's
    infinities of both signs meet in a sum)."""
    nan = a.isnan()
    return torch.equal(nan, b.isnan()) and torch.equal(
        torch.where(nan, 0.0, a), torch.where(nan, 0.0, b))


@pytest.mark.parametrize("c", [1, 4, 68])
@pytest.mark.parametrize("case", ["masked", "odd", "empty", "all_invalid",
                                  "no_mask", "edge"])
def test_splat_grad_matches_plain(cuda, case, c):
    """``splat_grad`` against ``splat_grad_plain`` on the card's saved
    forward and against the CPU's autograd of the plain render: bit-equal;
    one ``grad`` launch a backward (none for no points); two backwards
    equal. The edge case takes edge upstream values, and against the plain
    version also a fifth of the weight sums zeroed (d = 1e-7)."""
    xyz, valid, h, w = _grad_case(cuda, case, c)
    pose = S.make_pose(torch.tensor([1.5, -0.5, -4.0], device=cuda), 128.0,
                       60.0)
    g = torch.Generator().manual_seed(c)
    payload = torch.rand(xyz.shape[0], c, generator=g).to(cuda)
    upstream = torch.rand(h, w, c, generator=g).to(cuda)
    if case == "edge":
        from chip_smoke import edge_upstream

        upstream = edge_upstream((h, w, c), c).to(cuda)
    _, existing, zee = S._render(xyz, payload, valid, pose, h, w)
    existing = existing.contiguous()
    S.LAUNCHES.clear()
    got = S.grad_cuda(xyz, valid, pose, zee, existing,
                      upstream.reshape(-1, c), h, w)
    assert dict(S.LAUNCHES) == ({} if case == "empty" else {f"grad/c{c}": 1})
    want = S.splat_grad_plain(xyz, valid, pose, zee, existing,
                              upstream.reshape(-1, c), h, w)
    same = _equal_or_both_nan if case == "edge" else torch.equal
    assert same(got, want)
    again = S.grad_cuda(xyz, valid, pose, zee, existing,
                        upstream.reshape(-1, c), h, w)
    assert same(got, again)
    # the CPU's plain autograd of the whole render
    cpu = payload.cpu().requires_grad_(True)
    rendered, _ = S.splat(xyz.cpu(), cpu,
                          None if valid is None else valid.cpu(), pose.cpu(),
                          h, w)
    (rendered * upstream.cpu()).sum().backward()
    assert same(got.cpu(), cpu.grad)
    if case in ("masked", "edge"):
        assert (got != 0).any()
    if case == "edge":
        empty = existing.clone().reshape(-1)
        empty[torch.rand(h * w, generator=g).to(cuda) < 0.2] = 0.0
        got = S.grad_cuda(xyz, valid, pose, zee, empty,
                          upstream.reshape(-1, c), h, w)
        assert same(got, S.splat_grad_plain(xyz, valid, pose, zee, empty,
                                            upstream.reshape(-1, c), h, w))
        assert got.isinf().any()


def test_render_pointcloud_trains_through_the_kernel(cuda):
    """On the card the render has a ``grad_fn`` (``SplatFunction``), each
    item's backward is one ``splat_grad`` launch, and the payload's
    gradient is the CPU's; a payload row whose start is not 16 B aligned
    (C = 5) is cloned for the sum pass, and its gradient still reaches the
    caller's tensor."""
    h, w, b, c = 41, 51, 2, 5
    xyz, _, _ = _cloud(cuda, h, w, 1, seed=40)
    xyz = torch.stack([xyz, xyz + 0.3])
    g = torch.Generator().manual_seed(41)
    data = torch.rand(b, h * w, c, generator=g).to(cuda).requires_grad_(True)
    upstream = torch.rand(b, h, w, c, generator=g).to(cuda)
    S.LAUNCHES.clear()
    rendered, existing = S.render_pointcloud(xyz, data, h, w, 128.0, 60.0)
    assert rendered.grad_fn is not None and not existing.requires_grad
    (rendered * upstream).sum().backward()
    assert S.LAUNCHES[f"grad/c{c}"] == b
    assert data.grad is not None and bool((data.grad != 0).any())
    cpu = data.detach().cpu().requires_grad_(True)
    r_cpu, _ = S.render_pointcloud(xyz.cpu(), cpu, h, w, 128.0, 60.0)
    (r_cpu * upstream.cpu()).sum().backward()
    assert torch.equal(data.grad.cpu(), cpu.grad)
    with torch.inference_mode():
        S.LAUNCHES.clear()
        r_inf, _ = S.render_pointcloud(xyz, data.detach(), h, w, 128.0, 60.0)
    assert torch.equal(r_inf, rendered.detach())
    assert "grad/c5" not in S.LAUNCHES


def test_generate_view_c_on_the_card_matches_the_cpu(cuda):
    """The halfway view C (two merged clouds, C = 4) through the kernels
    equals the same function on the CPU, bit for bit, with six launches an
    item."""
    from kbe_torch.config import CameraConfig
    from kbe_torch.train.eval_inpaint import generate_view_c

    b, h, w = 2, 48, 64
    g = torch.Generator().manual_seed(60)
    cam = CameraConfig(64.0, 30.0)
    depth_a = 200.0 + 200.0 * torch.rand(b, h, w, 1, generator=g)
    depth_b = 150.0 + 250.0 * torch.rand(b, h, w, 1, generator=g)
    inputs = (depth_to_points(depth_a[..., 0], cam.focal).reshape(b, -1, 3),
              torch.rand(b, h, w, 3, generator=g), depth_a,
              torch.rand(b, h, w, 3, generator=g), depth_b,
              (torch.rand(b, h, w, 1, generator=g) > 0.3).float(),
              torch.tensor([[12.0, -4.0, 6.0], [-9.0, 3.0, -5.0]]))
    S.LAUNCHES.clear()
    got = generate_view_c(*(t.to(cuda) for t in inputs), cam, h, w)
    assert S.LAUNCHES["sum/c4"] == b
    want = generate_view_c(*inputs, cam, h, w)
    for x, y in zip(got, want):
        assert torch.equal(x.cpu(), y)


@pytest.fixture
def deterministic(cuda, monkeypatch):
    from kbe_torch.device import deterministic_training

    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    deterministic_training(True)
    yield
    deterministic_training(False)


def test_depth_training_is_reproducible(cuda, deterministic, tmp_path):
    """Two runs of two estimation steps (with the instance-mask loss) from
    one seed give equal losses and parameters, bit for bit."""
    from kbe_torch.train.data import synthetic_batches
    from kbe_torch.train.trainer_depth import TrainerDepth
    from kbe_torch.train.trainer_inpaint import to_device

    def run(i):
        trainer = TrainerDepth({"disparity_rows": (16, 24, 32, 64, 64, 64)},
                               device=cuda, logs_path=str(tmp_path / f"{i}"))
        state = trainer.init_state((128, 192))
        losses = []
        for batch in synthetic_batches(2, 128, 192, steps=2,
                                       with_instance_masks=True):
            batch.pop("imagenet")
            state, m = trainer.disparity_train_step(
                state, to_device(batch, cuda))
            losses.append({k: float(v) for k, v in m.items()})
        return losses, [p.detach().clone() for p in state.parameters()]

    (la, pa), (lb, pb) = run(0), run(1)
    assert la == lb
    assert all(torch.equal(x, y) for x, y in zip(pa, pb))


def test_validation_adv_gives_a_finite_fid(cuda, tmp_path):
    """The adversarial trainer's FID validation on the card at 288^2 (the
    discriminator's smallest size; a narrow grid-net), two batches of 2:
    a real 2048-d Fréchet distance, and six forward splat kernels an
    item."""
    import math

    from kbe_torch.config import CameraConfig
    from kbe_torch.train.data import synthetic_batches
    from kbe_torch.train.trainer_inpaint import TrainerInpaint

    cam = CameraConfig(256.0, 60.0)
    trainer = TrainerInpaint({"adversarial": True, "inpaint_rows": (8, 16)},
                             camera=cam, device=cuda,
                             logs_path=str(tmp_path / "runs"))
    state = trainer.init_state((288, 288))
    S.LAUNCHES.clear()
    score = trainer.validation_adv(state, synthetic_batches(
        2, 288, 288, mode="inpainting", camera=cam, seed=3, steps=2))
    assert math.isfinite(score) and score > 0.0
    assert S.LAUNCHES["sum/c68"] == 4 and S.LAUNCHES["zee/c68"] == 4


NMS_SIZES = {"sets": (512, 512, 192), "odd": (1, 31, 33, 513),
             "cap64": (64, 40), "cap192": (192, 100), "cap1000": (1000,),
             "cap1024": (1024, 1000)}


def _nms_sets(case, seed=0):
    g = torch.Generator().manual_seed(seed)
    sizes = NMS_SIZES.get(case, (300,))
    sets = []
    for n in sizes:
        xy = torch.rand(n, 2, generator=g) * 480.0
        wh = 4.0 + torch.rand(n, 2, generator=g) * 120.0
        boxes = torch.cat([xy, xy + wh], 1)
        scores = torch.rand(n, generator=g)
        if case == "ties":
            scores = torch.round(scores * 4) / 4
        elif case == "zero_slots":
            scores[torch.rand(n, generator=g) < 0.3] = 0.0
        elif case == "full_overlap":
            boxes[1::2] = boxes[0::2]
            scores[1::2] = scores[0::2]
        sets.append((boxes, scores))
    return sets


@pytest.mark.parametrize("case", ["random", "ties", "zero_slots",
                                  "full_overlap", "sets", "odd", "cap64",
                                  "cap192", "cap1000", "cap1024"])
def test_nms_kernel_matches_plain(cuda, case):
    """Kernel ``nms`` against the plain greedy loop on the same sorted,
    zero-padded sets, on the card; and ``nms_keep_sets`` on the card
    against the CPU's, one launch for all sets. Sets of up to 1024 slots;
    the caps give clusters of 1 (64), 3 (192), 5 (300) and 8 blocks a
    set (512 and more), so every split of the IoU rows is run."""
    from kbe_torch.ops import nms as N

    sets = _nms_sets(case)
    boxes, scores, _ = N.sort_sets([(b.to(cuda), s.to(cuda))
                                    for b, s in sets])
    want = torch.stack([N.keep_plain(b, s, 0.7)
                        for b, s in zip(boxes, scores)])
    assert torch.equal(N.keep_cuda(boxes, scores, 0.7, "test"), want)
    N.LAUNCHES.clear()
    on_card = N.nms_keep_sets([(b.to(cuda), s.to(cuda)) for b, s in sets],
                              0.5, "test")
    assert N.LAUNCHES["nms/test"] == 1
    for k, (x, y) in enumerate(zip(on_card, N.nms_keep_sets(sets, 0.5))):
        assert torch.equal(x.cpu(), y), k
        if sets[k][1].shape[0] > 33:
            assert 0 < int((y > 0).sum()) < int((sets[k][1] > 0).sum())


def test_nms_kernel_refuses_a_set_above_its_cap(cuda):
    """1024 slots a set at most (``kbe_nms_max_cap``): 1025 raises, with
    no launch."""
    from kbe_torch.ops import _build
    from kbe_torch.ops import nms as N

    assert _build.lib("nms").kbe_nms_max_cap() == 1024
    N.LAUNCHES.clear()
    wide = torch.zeros((1, 1025), device=cuda)
    with pytest.raises(ValueError, match="at most 1024"):
        N.keep_cuda(torch.zeros((1, 1025, 4), device=cuda), wide, 0.7, "t")
    assert not N.LAUNCHES


def test_maskrcnn_on_the_card_matches_the_cpu(cuda):
    """Two 64^2 images through the full-width Mask R-CNN (small
    capacities) on the card and on the CPU, same synthetic weights:
    equal labels, boxes within 1e-2 px, masks equal on 99.9 % of the
    pixels, detections above 0.5; two NMS launches an image."""
    import numpy as np
    from kbe_torch.models.maskrcnn import load_maskrcnn
    from kbe_torch.ops import nms as N
    from kbe_torch.utils.reference_convert import convert_maskrcnn, \
        synthetic_maskrcnn_state_dict

    tree = convert_maskrcnn(synthetic_maskrcnn_state_dict(0))
    small = dict(num_proposals=32, pre_nms_top_n=64, num_detections=8)
    images = torch.from_numpy(np.random.default_rng(9).uniform(
        size=(2, 64, 64, 3)).astype(np.float32))
    N.LAUNCHES.clear()
    with torch.no_grad():
        got = load_maskrcnn(tree, device=cuda, **small)(images.to(cuda))
    assert dict(N.LAUNCHES) == {"nms/rpn": 2, "nms/box": 2}
    with torch.no_grad():
        want = load_maskrcnn(tree, device="cpu", **small)(images)
    assert torch.equal(got["labels"].cpu(), want["labels"])
    assert (got["boxes"].cpu() - want["boxes"]).abs().max() <= 1e-2
    agree = ((got["masks"].cpu() > 0.5) == (want["masks"] > 0.5)).float()
    assert float(agree.mean()) >= 0.999
    assert int((want["scores"] > 0.5).sum()) >= 1


def test_maskrcnn_at_torchvision_capacities_on_the_card(cuda):
    """``MaskRCNN(pre_nms_top_n=1000, num_proposals=1000)``, torchvision's
    test-time capacities, on one 64^2 image: the RPN's first level hands
    the kernel 768 slots and the box head 1000 (above the first kernel's
    512). The card matches the CPU as with the small capacities; two NMS
    launches."""
    import numpy as np
    from kbe_torch.models.maskrcnn import load_maskrcnn
    from kbe_torch.ops import nms as N
    from kbe_torch.utils.reference_convert import convert_maskrcnn, \
        synthetic_maskrcnn_state_dict

    tree = convert_maskrcnn(synthetic_maskrcnn_state_dict(0))
    caps = dict(num_proposals=1000, pre_nms_top_n=1000)
    image = torch.from_numpy(np.random.default_rng(9).uniform(
        size=(1, 64, 64, 3)).astype(np.float32))
    N.LAUNCHES.clear()
    with torch.no_grad():
        got = load_maskrcnn(tree, device=cuda, **caps)(image.to(cuda))
    assert dict(N.LAUNCHES) == {"nms/rpn": 1, "nms/box": 1}
    with torch.no_grad():
        want = load_maskrcnn(tree, device="cpu", **caps)(image)
    assert torch.equal(got["labels"].cpu(), want["labels"])
    assert (got["boxes"].cpu() - want["boxes"]).abs().max() <= 1e-2
    agree = ((got["masks"].cpu() > 0.5) == (want["masks"] > 0.5)).float()
    assert float(agree.mean()) >= 0.999
    assert int((want["scores"] > 0.5).sum()) >= 1


def test_one_nccl_rank_step_is_the_step_without_a_mesh(cuda, deterministic,
                                                       tmp_path):
    """A 1-rank NCCL process group: the supervised step (48x64, batch 2)
    and the adversarial G+D iteration (288^2, batch 2; the discriminator's
    batch norms through the mesh) through ``data_parallel_step`` give the
    losses and states of the steps without a mesh, bit for bit (narrow
    grid-nets)."""
    import socket

    import torch.distributed as dist
    from kbe_torch.config import CameraConfig
    from kbe_torch.parallel import (data_mesh, data_parallel_step,
                                    initialize_multihost)
    from kbe_torch.train.data import synthetic_batches
    from kbe_torch.train.trainer_inpaint import TrainerInpaint, to_device

    def run(mesh, i):
        out = []
        for adversarial, (h, w), cam in (
                (False, (48, 64), CameraConfig(64.0, 30.0)),
                (True, (288, 288), CameraConfig(256.0, 60.0))):
            trainer = TrainerInpaint(
                {"adversarial": adversarial, "inpaint_rows": (8, 16)},
                camera=cam, device=cuda, logs_path=str(tmp_path / f"{i}"))
            step = (trainer.adversarial_step if adversarial
                    else trainer.supervised_step)
            if mesh is not None:
                step = data_parallel_step(step, mesh)
            states = [trainer.init_state((h, w))]
            if adversarial:
                states.append(trainer.init_disc_state((h, w)))
            batch = to_device(next(synthetic_batches(
                2, h, w, mode="inpainting", camera=cam, seed=4)), cuda)
            *states, m = step(*states, batch,
                              *((True,) if adversarial else ()))
            out.append({k: float(v) for k, v in m.items()})
            mods = [getattr(st, k) for st in states
                    for k in ("context", "net", "disc") if hasattr(st, k)]
            out += [t.clone() for mod in mods
                    for t in mod.state_dict().values()]
        return out

    want = run(None, 0)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    assert initialize_multihost(f"127.0.0.1:{port}", 1, 0, device=cuda)
    try:
        got = run(data_mesh(1, device=cuda), 1)
    finally:
        dist.destroy_process_group()
    assert len(got) == len(want)
    for x, y in zip(got, want):
        assert x == y if isinstance(y, dict) else torch.equal(x, y)


def test_pipeline_checkpoint_round_trip_on_the_card(cuda, tmp_path):
    """Seeded nets at the production mix, saved as a pipeline checkpoint
    (f32 on the host) and loaded back through
    ``KenBurnsPipeline.create(checkpoint=...)``: equal frames at 64^2."""
    import numpy as np

    from kbe_torch.config import EffectConfig
    from kbe_torch.data import demo_scene_image
    from kbe_torch.pipeline import KenBurnsPipeline
    from kbe_torch.train.checkpoint import save_pipeline

    mix = dict(dtype=torch.bfloat16, depth_dtype=torch.float32,
               effect=EffectConfig(num_steps=3), device=cuda)
    pipe = KenBurnsPipeline.create(3, **mix)
    path = save_pipeline(str(tmp_path), pipe.models, 0)
    loaded = KenBurnsPipeline.create(checkpoint=path, **mix)
    image = demo_scene_image(64, 64)
    want = pipe(image)
    assert (want[0] != want[-1]).any()
    np.testing.assert_array_equal(loaded(image), want)


def test_spec_path_launches_no_kernel_on_the_card(cuda):
    """``splat_method='scatter'`` and ``fill_impl='xla'`` name ``kbe_tpu``'s
    XLA specs: on the card the effect runs their plain versions, with no
    hand-written kernel, in the frame loop and in the bootstrap. The
    production path with the same f32 nets launches its kernels (a C=68
    render a bootstrap step, a C=4 render, a fill and a finish a frame)
    and agrees with the spec at 64^2, 3 steps: mean SSIM >= 0.999."""
    from kbe_torch.config import EffectConfig, ZoomSettings
    from kbe_torch.data import demo_scene_image
    from kbe_torch.ops.image_ops import ssim
    from kbe_torch.pipeline.kenburns import build_effect_fn, create_models

    size, steps = 64, 3
    models = create_models(0, cuda)
    image = torch.as_tensor(demo_scene_image(size, size), device=cuda)[None]
    zoom = ZoomSettings.default_3d(size, size)
    frames = {}
    for name, kw in (("spec", dict(splat_method="scatter", fill_impl="xla")),
                     ("production", {})):
        fn = build_effect_fn(size, size, zoom, effect=EffectConfig(
            num_steps=steps, **kw), device=cuda)
        S.LAUNCHES.clear()
        D.LAUNCHES.clear()
        F.LAUNCHES.clear()
        frames[name] = fn(models, image).float() / 255.0
        torch.cuda.synchronize()
        counts = {**S.LAUNCHES, **D.LAUNCHES, **F.LAUNCHES}
        if name == "spec":
            assert counts == {}
        else:
            assert counts == {**{f"{k}/c4": steps for k in (
                "fill", "zee", "degrid", "count", "place", "sum")},
                **{f"{k}/c68": 2 for k in (
                    "fill", "zee", "degrid", "count", "place", "sum")},
                "discfill": steps, "finish": steps}
    scores = [float(ssim(frames["production"][i:i + 1],
                         frames["spec"][i:i + 1])) for i in range(steps)]
    assert sum(scores) / steps >= 0.999, scores
