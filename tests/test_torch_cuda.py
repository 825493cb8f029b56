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

import pytest
import torch

from kbe_torch.ops import discfill as D
from kbe_torch.ops import splat as S
from kbe_torch.ops.geometry import depth_to_points

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
    h, w = 96, 128  # masked
    xyz, _, valid = _cloud(cuda, h, w, c, seed=30 + c)
    return xyz, valid, h, w


@pytest.mark.parametrize("c", [1, 4, 68])
@pytest.mark.parametrize("case", ["masked", "odd", "empty", "all_invalid",
                                  "no_mask"])
def test_splat_grad_matches_plain(cuda, case, c):
    """``splat_grad`` against ``splat_grad_plain`` on the card's saved
    forward and against the CPU's autograd of the plain render: bit-equal;
    one ``grad`` launch a backward (none for no points); two backwards
    equal."""
    xyz, valid, h, w = _grad_case(cuda, case, c)
    pose = S.make_pose(torch.tensor([1.5, -0.5, -4.0], device=cuda), 128.0,
                       60.0)
    g = torch.Generator().manual_seed(c)
    payload = torch.rand(xyz.shape[0], c, generator=g).to(cuda)
    upstream = torch.rand(h, w, c, generator=g).to(cuda)
    _, existing, zee = S._render(xyz, payload, valid, pose, h, w)
    existing = existing.contiguous()
    S.LAUNCHES.clear()
    got = S.grad_cuda(xyz, valid, pose, zee, existing,
                      upstream.reshape(-1, c), h, w)
    assert dict(S.LAUNCHES) == ({} if case == "empty" else {f"grad/c{c}": 1})
    want = S.splat_grad_plain(xyz, valid, pose, zee, existing,
                              upstream.reshape(-1, c), h, w)
    assert torch.equal(got, want)
    again = S.grad_cuda(xyz, valid, pose, zee, existing,
                        upstream.reshape(-1, c), h, w)
    assert torch.equal(got, again)
    # the CPU's plain autograd of the whole render
    cpu = payload.cpu().requires_grad_(True)
    rendered, _ = S.splat(xyz.cpu(), cpu,
                          None if valid is None else valid.cpu(), pose.cpu(),
                          h, w)
    (rendered * upstream.cpu()).sum().backward()
    assert torch.equal(got.cpu(), cpu.grad)
    if case == "masked":
        assert (got != 0).any()


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
