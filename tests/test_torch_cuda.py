"""kbe_torch's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: each test skips where there is no CUDA device. Run on the
card with ``KBE_TESTS_ALLOW_TPU=1 python -m pytest tests/test_torch_cuda.py
-q``. Every kernel is exact: the zee and degrid passes and the fill are
bit-identical to the plain versions on the card, and the accumulation and
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
    keys = S.zee_cuda(xyz, valid, pose, h, w, c)
    zee = S.decode_keys(keys).reshape(h, w)
    assert torch.equal(zee, S.zee_plain(xyz, valid, pose, h, w))
    deg = S.degrid_cuda(keys, h, w, c)
    assert torch.equal(deg, S.degrid_plain(zee))
    acc = S.accumulate_cuda(xyz, valid, payload, pose, deg, h, w)
    want = _plain_on_cpu(xyz, valid, payload, pose, deg, h, w)
    assert torch.equal(acc.cpu(), want)
    rendered, existing = S.splat(xyz, payload, valid, pose, h, w)
    assert torch.equal(rendered.cpu(), (want[:, :c] / (want[:, c:] + 1e-7))
                       .reshape(h, w, c))
    assert torch.equal(existing.cpu(), want[:, c:].reshape(h, w, 1))


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
    deg = S.degrid_cuda(S.zee_cuda(xyz, valid, pose, h, w, c), h, w, c)
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
    (the same call on CPU tensors) at 256^2, and its five launches."""
    h = w = 256
    fn = _entry_points()[name]
    xyz, data, valid = _grids(h, w, grids, c, seed=c + grids)
    want = fn(xyz, data, h, w, 128.0, 60.0, valid=valid)
    S.LAUNCHES.clear()
    got = fn(xyz.to(cuda), data.to(cuda), h, w, 128.0, 60.0,
             valid=valid.to(cuda))
    assert dict(S.LAUNCHES) == {f"{k}/c{c}": 1 for k in (
        "zee", "degrid", "count", "place", "sum")}
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
        "zee", "degrid", "count", "place", "sum")}
    assert got == want
