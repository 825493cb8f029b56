"""The reference against the port's plain path on the CPU, on the same
weights and photographs: frames, nets, splat and fill, for the default
nets and for each of the nets a configuration's ``models`` can name. The
tests may import the port; the reference may not."""

import dataclasses
import hashlib
import itertools

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
from kbe_torch.pipeline.kenburns import (_new_models, build_effect_fn,
                                         create_models)

# the nets a configuration's ``models`` can name, one flag at a time, and
# the partial-conv net in the dual colour/depth mode
MODELS = [None, {"pretrained_refine": True}, {"partial_inpainting": True},
          {"inpaint_depth": True},
          {"partial_inpainting": True, "inpaint_depth": True}]
MODEL_IDS = ["default", "pretrained_refine", "partial_inpainting",
             "inpaint_depth", "partial_dual"]

# make_weights(seed, "cpu") of the five default nets as the draw was before
# a configuration could name its nets: per net, the first 32 hex digits of
# the SHA-256 of its state dict's keys and f32 bytes in order, and the
# float64 sum and sum of squares of all its tensors
FROZEN_DIGEST = {
    0: {"semantics": ("8f1dd4a3bf327bd16e2d23f4b9886813",
                      -32.70101696947199, 3459.4963410397695),
        "disparity": ("8508b88e6efce0a1905c055e37fbb3f2",
                      5170.847733781608, 23261.396269821093),
        "refine": ("84df09cb544ff180deffec3f7f67d54a",
                   219.9324564414635, 943.2261556268999),
        "context": ("3b4ccb6dd3d8e0db010bdcb6ea5bc48d",
                    28.03317455330898, 137.8349434704572),
        "inpaint": ("2d3ca8f4d280456975c5af30ab3224b6",
                    1315.5455604199433, 6091.122648727344)},
    2**33 + 1: {"semantics": ("53b59e45e599d31f8768c0097d8e50da",
                              -11.627884370584036, 3462.9419913169213),
                "disparity": ("ca6e4adf6a16b0f2548dafc31e4a9d57",
                              5350.6552717886725, 23253.609597801733),
                "refine": ("95c2e58f5121c1fa166c9bc8814e8fa7",
                           221.76679865549664, 945.8871615964017),
                "context": ("7665a204b57772d9e2113fbec069bd87",
                            44.6821328422505, 137.56376761171384),
                "inpaint": ("94eb2c73297c90721cf2f939cf6bd3b6",
                            1395.5576832666025, 6087.075510562579)},
}


def _config(dolly: bool, steps: int, models=None) -> dict:
    effect = dataclasses.asdict(EffectConfig(num_steps=steps, dolly=dolly))
    config = {"effect": effect,
              "camera": {"focal": 512.0, "baseline": 120.0},
              "zoom": "default_dolly" if dolly else "default_3d",
              "precision": {"depth": "float32", "inpaint": "bfloat16"}}
    if models is not None:
        config["models"] = models
    return config


def _port_models(weights, config):
    dt = E.DTYPES
    models = create_models(0, "cpu", dt[config["precision"]["inpaint"]],
                           dt[config["precision"]["depth"]],
                           **N.model_flags(config))
    for name, net in zip(models._fields, models):
        if net is not None:
            net.load_state_dict(weights[name])
    return models


@pytest.mark.parametrize("dolly,shape,seed,models", [
    (False, (64, 64), 3, None),
    (False, (96, 128), 2**31 + 7, None),
    (True, (128, 96), 11, None),
    (False, (64, 64), 13, MODELS[1]),
    (False, (64, 96), 2**32 + 17, MODELS[2]),
    (False, (96, 64), 19, MODELS[3]),
    (False, (128, 128), 2**31 + 23, MODELS[4])],
    ids=["default-64", "default-96x128", "dolly-128x96", *MODEL_IDS[1:]])
def test_reference_frames_equal_the_ports_plain_path(dolly, shape, seed,
                                                     models):
    torch.manual_seed(0)
    config = _config(dolly, 5 if models is None else 3, models)
    flags = N.model_flags(config)
    weights = make_weights(seed, "cpu", flags)
    h, w = shape
    image = traffic.scene_image(h, w, [seed, 0])
    zoom = (ZoomSettings.default_dolly(w, h) if dolly
            else ZoomSettings.default_3d(w, h))
    fn = build_effect_fn(h, w, zoom, effect=EffectConfig(**config["effect"]),
                         pretrained_refine=flags["pretrained_refine"],
                         partial_inpainting=flags["partial_inpainting"],
                         device="cpu")
    got = fn(_port_models(weights, config), torch.as_tensor(image)[None])
    nets = E.load_nets(weights, config["precision"], "cpu", flags)
    want = E.video(nets, image, config, "cpu")
    assert got.dtype == want.dtype == torch.uint8
    assert torch.equal(got, want)


@pytest.mark.parametrize("models", MODELS, ids=MODEL_IDS)
def test_reference_nets_equal_the_ports_nets(models):
    config = _config(False, 3, models)
    flags = N.model_flags(config)
    weights = make_weights(5, "cpu", flags)
    port = _port_models(weights, config)
    ref = E.load_nets(weights, config["precision"], "cpu", flags)
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
        data = torch.rand(1, 64, 48, 68, generator=g)
        mask = (torch.rand(1, 64, 48, 1, generator=g) < 0.7).float()
        pairs = [("context", "inpaint")]
        if flags["inpaint_depth"]:
            pairs.append(("context_depth", "inpaint_depth"))
        for context, inpaint in pairs:
            assert torch.equal(ref[context](img, d1),
                               getattr(port, context)(img, d1))
            want = getattr(port, inpaint)(data * mask, mask)
            got = ref[inpaint](data * mask, mask)
            assert len(got) == len(want) == (
                3 if flags["partial_inpainting"] else 2)
            for a, b in zip(got, want):
                assert torch.equal(a, b)


@pytest.mark.parametrize("models", MODELS, ids=MODEL_IDS)
def test_reference_state_dicts_fit_the_ports_nets(models):
    flags = N.model_flags({"models": models})
    weights = make_weights(0, "cpu", flags)
    with torch.device("meta"):
        port = _new_models(**flags)
    for name, net in zip(port._fields, port):
        if net is None:
            assert name not in weights
            continue
        sd = net.state_dict()
        assert list(sd) == list(weights[name])
        assert all(sd[k].shape == weights[name][k].shape for k in sd)


@pytest.mark.parametrize("flags", [
    dict(zip(N.MODEL_FLAGS, values))
    for values in itertools.product((False, True), repeat=3)])
def test_the_nets_follow_the_ports_pipeline_models(flags):
    with torch.device("meta"):
        port = _new_models(**flags)
    assert [(n, cls.__name__) for n, cls, _ in N.nets_for(flags)] == [
        (f, type(m).__name__) for f, m in zip(port._fields, port)
        if m is not None]
    assert [kind for _, _, kind in N.nets_for(flags)][:3] == ["depth"] * 3


def test_a_configuration_names_only_known_nets():
    assert N.model_flags({}) == dict.fromkeys(N.MODEL_FLAGS, False)
    assert N.model_flags({"models": {"inpaint_depth": True}}) == {
        "pretrained_refine": False, "partial_inpainting": False,
        "inpaint_depth": True}
    with pytest.raises(ValueError, match="partial_conv"):
        N.model_flags({"models": {"partial_conv": True}})


@pytest.mark.parametrize("seed", sorted(FROZEN_DIGEST))
def test_the_default_nets_draw_the_frozen_weights(seed):
    weights = make_weights(seed, "cpu", N.model_flags({}))
    assert list(weights) == list(FROZEN_DIGEST[seed])
    for name, (digest, total, squares) in FROZEN_DIGEST[seed].items():
        h = hashlib.sha256()
        for key, t in weights[name].items():
            h.update(key.encode())
            h.update(t.contiguous().numpy().tobytes())
        assert h.hexdigest()[:32] == digest, name
        assert sum(float(t.double().sum()) for t in
                   weights[name].values()) == pytest.approx(total, rel=1e-12)
        assert sum(float((t.double() ** 2).sum()) for t in
                   weights[name].values()) == pytest.approx(squares,
                                                             rel=1e-12)


def test_weights_repeat_from_the_seed_and_follow_the_scheme():
    flags = N.model_flags({})
    a = make_weights(2**33 + 1, "cpu", flags)
    b = make_weights(2**33 + 1, "cpu", flags)
    c = make_weights(2**33 + 2, "cpu", flags)
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
    models = N.model_flags(config)
    nets = E.load_nets(make_weights(6, "cpu", models), config["precision"],
                       "cpu", models)
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
