"""The reference against the port's plain path on the CPU, on the same
weights and photographs: frames, nets, splat and fill. The tests may import
the port; the reference may not."""

import dataclasses

import numpy as np
import pytest
import torch

from benchmark import traffic
from benchmark.reference import effect as E
from benchmark.reference import nets as N
from benchmark.reference import ops as O
from benchmark.reference.weights import make_weights
from kbe_torch.config import EffectConfig, ZoomSettings
from kbe_torch.ops import discfill, splat
from kbe_torch.pipeline.kenburns import build_effect_fn, create_models


def _config(dolly: bool, steps: int) -> dict:
    effect = dataclasses.asdict(EffectConfig(num_steps=steps, dolly=dolly))
    return {"effect": effect, "camera": {"focal": 512.0, "baseline": 120.0},
            "zoom": "default_dolly" if dolly else "default_3d",
            "precision": {"depth": "float32", "inpaint": "bfloat16"}}


def _port_models(weights, config):
    dt = E.DTYPES
    models = create_models(0, "cpu", dt[config["precision"]["inpaint"]],
                           dt[config["precision"]["depth"]])
    for name, net in zip(models._fields, models):
        if net is not None:
            net.load_state_dict(weights[name])
    return models


@pytest.mark.parametrize("dolly,shape,seed", [(False, (64, 64), 3),
                                              (False, (96, 128), 2**31 + 7),
                                              (True, (128, 96), 11)])
def test_reference_frames_equal_the_ports_plain_path(dolly, shape, seed):
    torch.manual_seed(0)
    config = _config(dolly, 5)
    weights = make_weights(seed, "cpu")
    h, w = shape
    image = traffic.scene_image(h, w, [seed, 0])
    zoom = (ZoomSettings.default_dolly(w, h) if dolly
            else ZoomSettings.default_3d(w, h))
    fn = build_effect_fn(h, w, zoom, effect=EffectConfig(**config["effect"]),
                         device="cpu")
    got = fn(_port_models(weights, config), torch.as_tensor(image)[None])
    nets = E.load_nets(weights, config["precision"], "cpu")
    want = E.video(nets, image, config, "cpu")
    assert got.dtype == want.dtype == torch.uint8
    assert torch.equal(got, want)


def test_reference_nets_equal_the_ports_nets():
    weights = make_weights(5, "cpu")
    config = _config(False, 3)
    port = _port_models(weights, config)
    ref = E.load_nets(weights, config["precision"], "cpu")
    g = torch.Generator().manual_seed(0)
    img = torch.rand(1, 64, 48, 3, generator=g)
    with torch.no_grad():
        sem = ref["semantics"](img)
        assert torch.equal(sem, port.semantics(img))
        disp = ref["disparity"](img, sem)
        assert torch.equal(disp, port.disparity(img, sem))
        assert torch.equal(ref["refine"](img, disp[:, :16, :12] + 1.0),
                           port.refine(img, disp[:, :16, :12] + 1.0))
        d1 = torch.rand(1, 64, 48, 1, generator=g)
        assert torch.equal(ref["context"](img, d1), port.context(img, d1))
        data = torch.rand(1, 64, 48, 68, generator=g)
        for a, b in zip(ref["inpaint"](data, d1), port.inpaint(data, d1)):
            assert torch.equal(a, b)


def test_reference_state_dicts_fit_the_ports_nets():
    weights = make_weights(0, "cpu")
    models = create_models(0, "cpu")
    for name, net in zip(models._fields, models):
        if net is None:
            continue
        sd = net.state_dict()
        assert sorted(sd) == sorted(weights[name])
        assert all(sd[k].shape == weights[name][k].shape for k in sd)
    assert [n for n, _, _ in N.NETS] == [
        f for f, m in zip(models._fields, models) if m is not None]


def test_weights_repeat_from_the_seed_and_follow_the_scheme():
    a, b = make_weights(2**33 + 1, "cpu"), make_weights(2**33 + 1, "cpu")
    c = make_weights(2**33 + 2, "cpu")
    for name in a:
        for k in a[name]:
            assert torch.equal(a[name][k], b[name][k])
    w = a["disparity"]["stem_semantics.weight"]
    assert not torch.equal(w, c["disparity"]["stem_semantics.weight"])
    fan_in = w[0].numel()
    assert abs(float(w.std()) * fan_in ** 0.5 - 1.0) < 0.01
    assert torch.all(a["disparity"]["stem_semantics.bias"] == 0)
    assert torch.all(a["context"]["prelu1.weight"] == 0.25)


@pytest.mark.parametrize("roi", [None, (5, 40, 3, 50)])
def test_fill_equals_the_ports_plain_fill(roi):
    g = torch.Generator().manual_seed(1)
    h, w = 48, 56
    image = torch.rand(h, w, 4, generator=g)
    depth = torch.rand(h, w, 1, generator=g) * 10 + 1
    holes = torch.rand(h, w, generator=g) < 0.3
    holes[10:30, 20:24] = True          # a wide band, and one that meets
    holes[:, :3] = True                 # the edge
    depth[holes] = 0.0
    for steps in (128, 7):
        want = discfill.fill_plain(image, depth, steps, roi)
        got = O.fill(image, depth, steps, roi, chunk=97)
        assert torch.equal(got, want)


def test_splat_equals_the_ports_plain_splat():
    g = torch.Generator().manual_seed(2)
    h, w, n = 40, 48, 3000
    xyz = torch.stack([torch.rand(n, generator=g) * 80 - 40,
                       torch.rand(n, generator=g) * 60 - 30,
                       torch.rand(n, generator=g) * 50 + 20], dim=-1)
    payload = torch.rand(n, 4, generator=g)
    shift = torch.tensor([1.5, -2.25, 3.0])
    pose = splat.make_pose(shift, 512.0, 120.0)
    want_r, want_w, _ = splat._render_plain(xyz, payload, None, pose, h, w)
    got_r, got_w = O.splat(xyz, payload, pose[:3], pose[3], pose[4], h, w)
    assert torch.equal(got_r.reshape(-1, 4), want_r)
    assert torch.equal(got_w.reshape(-1, 1), want_w)


@pytest.mark.parametrize("precision", ["config", "tf32"])
@pytest.mark.parametrize("flags", [True, False])
def test_reference_sets_tf32_itself_and_restores_the_flags(
        precision, flags, monkeypatch):
    config = _config(False, 2)
    nets = E.load_nets(make_weights(6, "cpu"), config["precision"], "cpu")
    seen = {}

    def flags_now():
        return (torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32)

    def hook(name):
        def record(module, args):
            seen.setdefault(name, flags_now())
        return record

    for name in ("semantics", "refine", "context", "inpaint"):
        nets[name].register_forward_pre_hook(hook(name))
    resize = O.resize_bilinear

    def frame_resize(*args, **kwargs):
        seen["frame"] = flags_now()  # the last call: a frame's resize
        return resize(*args, **kwargs)

    monkeypatch.setattr(O, "resize_bilinear", frame_resize)
    old = flags_now()
    torch.backends.cudnn.allow_tf32 = flags
    torch.backends.cuda.matmul.allow_tf32 = flags
    try:
        E.video(nets, traffic.scene_image(48, 48, [6, 0]), config, "cpu",
                precision=precision)
        after = flags_now()
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = old
    depth = (precision == "tf32",) * 2
    assert seen == {"semantics": depth, "refine": depth,
                    "context": (False, False), "inpaint": (False, False),
                    "frame": (False, False)}
    assert after == (flags, flags)
