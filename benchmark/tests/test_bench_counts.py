"""The yardstick's counts, worked out by hand for small shapes."""

import json
from pathlib import Path

import pytest

from benchmark import counts

ROOT = Path(__file__).resolve().parents[2]


def _config(name):
    return json.loads((ROOT / "benchmark" / "configs" / f"{name}.json")
                      .read_text())


def test_splat_bytes_by_hand():
    # 10 valid points: 12 B xyz + 16 B rgb + depth each = 280; the pose 20;
    # a 4x4 render of 4 channels and its weight, f32: 16 * 5 * 4 = 320
    assert counts.splat_bytes(10, 4, 4) == 280 + 20 + 320


def test_fill_bytes_by_hand():
    # rows 1..2, columns 2..5: 8 pixels, each 16 B render + 4 B weight in
    # and 16 B out
    assert counts.fill_bytes((1, 3, 2, 6)) == 8 * 36


def test_least_seconds_at_the_hbm_rate():
    assert counts.least_seconds(3.35e12) == pytest.approx(1.0)
    assert counts.video_least_seconds(
        {"float32": 67e12, "bfloat16": 989e12}) == pytest.approx(2.0)


def test_net_flops_by_hand_for_the_bootstrap_nets():
    # the bootstrap's two steps each run ContextNet and Inpaint in bf16, so
    # the default mode's bf16 count is twice theirs and dolly has none
    h, w = 16, 16
    c3 = _config("kbe3d-1024-prod")
    dolly = _config("dolly-1024-prod")
    f3 = counts.net_flops(h, w, c3)
    fd = counts.net_flops(h, w, dolly)
    assert fd.get("bfloat16", 0.0) == 0.0
    assert f3["float32"] == fd["float32"]
    # ContextNet: 3x3 convs 4 -> 64 and 64 -> 64 over 16x16, 2 FLOPs a MAC
    context = 2 * h * w * 64 * 9 * (4 + 64)
    # Inpaint's stem: a Basic 69 -> 32 -> 32 with a 1x1 shortcut 69 -> 32
    stem = 2 * h * w * 32 * (9 * 69 + 9 * 32 + 69)
    assert f3["bfloat16"] > 2 * (context + stem)
    from benchmark.reference import nets as N
    from torch.utils.flop_counter import FlopCounterMode
    import torch
    with torch.device("meta"):
        net = N.ContextNet()
    with FlopCounterMode(display=False) as fc:
        net(torch.zeros(1, h, w, 3, device="meta"),
            torch.zeros(1, h, w, 1, device="meta"))
    assert fc.get_total_flops() == context


def test_depth_flops_by_hand_for_the_first_vgg_conv():
    # Semantics' first conv, 3 -> 64 at 8x8: 2 * 64 * 64 * 27
    from benchmark.reference import nets as N
    from torch.utils.flop_counter import FlopCounterMode
    import torch
    with torch.device("meta"):
        net = N.Semantics()
    x = torch.zeros(1, 3, 8, 8, device="meta")
    with FlopCounterMode(display=False) as fc:
        net.conv0_0(x)
    assert fc.get_total_flops() == 2 * 64 * 64 * 27


def test_bf16_flops_scale_with_the_pixels():
    # Inpaint halves its rows three times: 32x32 and 64x64 divide evenly
    c3 = _config("kbe3d-1024-prod")
    assert counts.net_flops(64, 64, c3)["bfloat16"] == \
        4 * counts.net_flops(32, 32, c3)["bfloat16"]


def _with_models(models):
    config = _config("kbe3d-1024-prod")
    config["models"] = models
    return config


def test_the_residual_refine_adds_its_shortcuts_by_hand():
    # 1x1 shortcuts: image_one 3 -> 24 and disparity_fou 72 -> 24 and
    # refine 24 -> 1 at H x W, disparity_one 1 -> 96 at the disparity's
    # H/4 x W/4
    h = w = 16
    plain = counts.net_flops(h, w, _config("kbe3d-1024-prod"))
    residual = counts.net_flops(h, w, _with_models({"pretrained_refine":
                                                     True}))
    shortcuts = 2 * (h * w * 24 * 3 + (h // 4) * (w // 4) * 96
                     + h * w * 24 * 72 + h * w * 24)
    assert residual["float32"] - plain["float32"] == shortcuts
    assert residual["bfloat16"] == plain["bfloat16"]


def test_a_partial_conv_counts_its_weighted_convolution_alone():
    # every weighted conv of the partial-conv net, counted by hand from
    # its input and output: 2 FLOPs a multiply-add, no coverage
    import torch

    from benchmark.reference import nets as N

    h = w = 32
    with torch.device("meta"):
        net = N.PartialInpaint()
    weighted = []

    def hook(module, args, out):
        weighted.append(2 * out.numel() * args[0].shape[1]
                        * module.kernel_size[0] * module.kernel_size[1])

    for m in net.modules():
        if isinstance(m, torch.nn.Conv2d):
            m.register_forward_hook(hook)
    with torch.no_grad():
        net(torch.zeros(1, h, w, 68, device="meta"),
            torch.zeros(1, h, w, 1, device="meta"))
    # ContextNet: 3x3 convs 4 -> 64 and 64 -> 64
    context = 2 * h * w * 64 * 9 * (4 + 64)
    partial = counts.net_flops(h, w, _with_models({"partial_inpainting":
                                                    True}))
    assert partial["bfloat16"] == 2 * (context + sum(weighted))
    # the dual colour/depth mode runs both pairs in each bootstrap step
    dual = counts.net_flops(h, w, _with_models({"partial_inpainting": True,
                                                "inpaint_depth": True}))
    assert dual["bfloat16"] == 2 * partial["bfloat16"]
    assert dual["float32"] == partial["float32"]
    grid_dual = counts.net_flops(h, w, _with_models({"inpaint_depth": True}))
    assert grid_dual["bfloat16"] == 2 * counts.net_flops(
        h, w, _config("kbe3d-1024-prod"))["bfloat16"]
