"""kbe_torch.config is a field-for-field copy of kbe_tpu.config."""

import dataclasses

import pytest

import kbe_torch.config as port
import kbe_tpu.config as ref


@pytest.mark.parametrize("name", ["CameraConfig", "ZoomWindow",
                                  "ZoomSettings", "EffectConfig"])
def test_dataclass_fields_equal(name):
    a = [(f.name, str(f.type), f.default) for f in
         dataclasses.fields(getattr(port, name))]
    b = [(f.name, str(f.type), f.default) for f in
         dataclasses.fields(getattr(ref, name))]
    assert a == b
    assert getattr(port, name).__dataclass_params__.frozen


def test_defaults_and_zoom_presets_equal():
    assert dataclasses.asdict(port.EffectConfig()) == dataclasses.asdict(
        ref.EffectConfig())
    assert dataclasses.asdict(port.CameraConfig()) == dataclasses.asdict(
        ref.CameraConfig())
    for w, h in ((1024, 1024), (640, 480), (64, 64)):
        for preset in ("default_3d", "default_dolly"):
            assert dataclasses.asdict(getattr(port.ZoomSettings, preset)(
                w, h)) == dataclasses.asdict(getattr(ref.ZoomSettings,
                                                     preset)(w, h))
    bad = port.ZoomSettings(port.ZoomWindow(10.0, 10.0, 40, 40),
                            port.ZoomWindow(32.0, 32.0, 20, 20))
    with pytest.raises(ValueError):
        bad.validate(64, 64)
