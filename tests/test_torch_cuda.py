"""kbe_torch's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: each test skips where there is no CUDA device. Run on the
card with ``python -m pytest tests/test_torch_cuda.py -q``. The zee and
degrid passes and the fill must be bit-identical to the plain versions; the
accumulation (float atomics, order varies from run to run) is held to
rtol 1e-5, atol 2e-4.
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
    want = S.accumulate_plain(xyz, valid, payload, pose, deg, h, w)
    torch.testing.assert_close(acc, want, rtol=1e-5, atol=2e-4)


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
