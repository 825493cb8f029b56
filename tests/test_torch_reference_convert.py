"""kbe_torch's converters of the reference's PyTorch checkpoints against
kbe_tpu's, on synthetic state dicts with the reference's key names: the
trees must be equal leaf for leaf (same arithmetic on the same numpy
arrays, so exactly), and must load strictly into the port's nets. The
training converters (VGG16, the MPD discriminator with spectral-norm
entries) are also run: the port's forward on its tree against JAX's on the
JAX converter's, at rtol 1e-4 and atol 1e-4 of the output's scale."""

import numpy as np
import pytest
import torch

from kbe_tpu.utils import torch_convert as tc
from kbe_torch.models import ContextNet, Disparity, Inpaint, \
    RefinePretrained, Semantics
from kbe_torch.pipeline.kenburns import create_models
from kbe_torch.utils import reference_convert as rc
from kbe_torch.utils.convert import load_flax
from tests.test_convert import _reference_disparity_sd


class _Builder:
    """Collects a state dict under the reference's module names."""

    def __init__(self, seed):
        self.sd = {}
        self.rng = np.random.default_rng(seed)

    def conv(self, key, ci, co, k=3):
        self.sd[f"{key}.weight"] = self.rng.normal(
            0, 0.1, (co, ci, k, k)).astype(np.float32)
        self.sd[f"{key}.bias"] = self.rng.normal(0, 0.1, co).astype(
            np.float32)

    def prelu(self, key, c):
        self.sd[f"{key}.weight"] = self.rng.uniform(0.1, 0.4, c).astype(
            np.float32)

    def basic(self, key, c0, c1, c2, kind="relu-conv-relu-conv",
              shortcut=False):
        i = 0
        if kind == "relu-conv-relu-conv":
            self.prelu(f"{key}.moduleMain.0", c0)
            i = 1
        self.conv(f"{key}.moduleMain.{i}", c0, c1)
        self.prelu(f"{key}.moduleMain.{i + 1}", c1)
        self.conv(f"{key}.moduleMain.{i + 2}", c1, c2)
        if shortcut and c0 != c2:
            self.conv(f"{key}.moduleShortcut", c0, c2, k=1)

    def down(self, key, c0, c1, c2):
        self.basic(key, c0, c1, c2)

    def up(self, key, c0, c1, c2):
        self.prelu(f"{key}.moduleMain.1", c0)
        self.conv(f"{key}.moduleMain.2", c0, c1)
        self.prelu(f"{key}.moduleMain.3", c1)
        self.conv(f"{key}.moduleMain.4", c1, c2)

    def bn(self, key, c):
        self.sd[f"{key}.weight"] = self.rng.uniform(0.5, 1.5, c).astype(
            np.float32)
        self.sd[f"{key}.bias"] = self.rng.normal(0, 0.1, c).astype(np.float32)
        self.sd[f"{key}.running_mean"] = self.rng.normal(0, 0.1, c).astype(
            np.float32)
        self.sd[f"{key}.running_var"] = self.rng.uniform(0.5, 1.5, c).astype(
            np.float32)


def _refine_sd():
    b = _Builder(1)
    b.basic("moduleImageOne", 3, 24, 24, "conv-relu-conv", True)
    b.down("moduleImageTwo", 24, 48, 48)
    b.down("moduleImageThr", 48, 96, 96)
    b.basic("moduleDisparityOne", 1, 96, 96, "conv-relu-conv", True)
    b.up("moduleDisparityTwo", 192, 96, 96)
    b.up("moduleDisparityThr", 144, 48, 48)
    b.basic("moduleDisparityFou", 72, 24, 24, "conv-relu-conv", True)
    b.basic("moduleRefine", 24, 24, 1, "conv-relu-conv", True)
    return b.sd


def _inpaint_sd():
    b = _Builder(2)
    b.conv("moduleContext.0", 4, 64)
    b.prelu("moduleContext.1", 64)
    b.conv("moduleContext.2", 64, 64)
    b.prelu("moduleContext.3", 64)
    rows = [32, 64, 128, 256]
    b.basic("moduleInput", 69, 32, 32, "conv-relu-conv", True)
    for r, f in enumerate(rows):
        for c in (1, 2, 3):
            b.basic(f"{r}x{c - 1} - {r}x{c}", f, f, f)
    for c in (0, 1):
        for r in range(1, 4):
            b.down(f"{r - 1}x{c} - {r}x{c}", rows[r - 1], rows[r], rows[r])
    for c in (2, 3):
        for r in range(3):
            b.up(f"{r + 1}x{c} - {r}x{c}", rows[r + 1], rows[r], rows[r])
    b.basic("moduleImage", 32, 32, 3, "conv-relu-conv", True)
    b.basic("moduleDisparity", 32, 32, 1, "conv-relu-conv", True)
    return b.sd


def _semantics_sd(style):
    b = _Builder(3)
    widths = ((3, 64, 64), (64, 128, 128), (128, 256, 256, 256, 256),
              (256, 512, 512, 512, 512))
    layouts = {"reference": rc._VGG19_LAYOUT, "torchvision":
               rc._VGG19_TV_LAYOUT}[style]
    for block, chans in zip(layouts, widths):
        for i, (conv_k, bn_k) in enumerate(block):
            if style == "reference":
                conv_k, bn_k = f"moduleVgg.{conv_k}", f"moduleVgg.{bn_k}"
            else:
                conv_k, bn_k = f"features.{conv_k}", f"features.{bn_k}"
            b.conv(conv_k, chans[i], chans[i + 1])
            b.bn(bn_k, chans[i + 1])
    return b.sd


def _assert_trees_equal(got, want, path=""):
    assert type(got) is type(want) or not isinstance(want, dict), path
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_trees_equal(got[k], want[k], f"{path}/{k}")
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                      err_msg=path)


def _convert_both(monkeypatch, sd, name):
    monkeypatch.setattr(tc, "_load_state_dict", lambda path: sd)
    monkeypatch.setattr(rc, "_load_state_dict", lambda path: sd)
    return getattr(rc, name)("fake.tar"), getattr(tc, name)("fake.tar")


def test_convert_disparity_equals_jax_converter(monkeypatch):
    got, want = _convert_both(monkeypatch, _reference_disparity_sd(),
                              "convert_disparity")
    _assert_trees_equal(got, want)
    load_flax(Disparity(), got)


def test_convert_refine_equals_jax_converter(monkeypatch):
    got, want = _convert_both(monkeypatch, _refine_sd(), "convert_refine")
    _assert_trees_equal(got, want)
    assert "shortcut" in got["params"]["core"]["image_one"]
    load_flax(RefinePretrained(), got)


def test_convert_inpaint_equals_jax_converter(monkeypatch):
    got, want = _convert_both(monkeypatch, _inpaint_sd(), "convert_inpaint")
    for g, w in zip(got, want):
        _assert_trees_equal(g, w)
    load_flax(ContextNet(), got[0])
    load_flax(Inpaint(), got[1])


@pytest.mark.parametrize("style", ["reference", "torchvision"])
def test_convert_semantics_equals_jax_converter(style):
    sd = _semantics_sd(style)
    got, want = rc.convert_semantics(sd), tc.convert_semantics(sd)
    _assert_trees_equal(got, want)
    load_flax(Semantics(), got)


def test_load_torch_pipeline_replaces_only_what_it_is_given(tmp_path):
    """``.tar`` files as ``torch.save`` writes them (a raw state dict, and
    the ``model_state_dict`` wrapper) through the port's own reader."""
    def save(sd, path, wrap):
        blob = {k: torch.as_tensor(v) for k, v in sd.items()}
        torch.save({"nb_iter": 7, "model_state_dict": blob} if wrap else blob,
                   path)
        return str(path)

    refine = save(_refine_sd(), tmp_path / "refine.tar", True)
    inpaint = save(_inpaint_sd(), tmp_path / "inpaint.tar", False)
    models = create_models(0, device="cpu", pretrained_refine=True)
    before = {k: v.clone() for k, v in models.disparity.state_dict().items()}
    out = rc.load_torch_pipeline(models, refine=refine, inpaint=inpaint)
    assert out is models
    with pytest.raises(ValueError, match="dual-net"):
        rc.load_torch_pipeline(models, inpaint_depth=inpaint)
    w = _refine_sd()["moduleRefine.moduleMain.2.weight"]
    assert torch.equal(models.refine.core.refine.conv2.weight,
                       torch.as_tensor(w))
    w = _inpaint_sd()["moduleContext.0.weight"]
    assert torch.equal(models.context.conv1.weight, torch.as_tensor(w))
    for k, v in models.disparity.state_dict().items():
        assert torch.equal(v, before[k])


def _vgg16_tv_sd(seed):
    """torchvision ``vgg16`` ``features`` entries of the first three
    blocks."""
    b = _Builder(seed)
    widths = ((3, 64), (64, 64), (64, 128), (128, 128), (128, 256),
              (256, 256), (256, 256))
    flat = [i for block in rc._VGG16_TV_LAYOUT[:3] for i in block]
    for idx, (ci, co) in zip(flat, widths):
        b.conv(f"features.{idx}", ci, co)
        b.sd[f"features.{idx}.weight"] *= (9 * ci) ** -0.5 / 0.1
    return b.sd


def test_convert_vgg16_equals_jax_converter():
    from kbe_tpu.models.vgg import VGG16Features as VGGJ
    from kbe_torch.models.vgg import VGG16Features
    from tests.test_torch_discriminator import _close

    sd = _vgg16_tv_sd(4)
    got, want = rc.convert_vgg16(sd), tc.convert_vgg16(sd)
    _assert_trees_equal(got, want)
    x = np.random.default_rng(5).uniform(0, 1, (1, 36, 44, 3)).astype(
        np.float32)
    with torch.no_grad():
        out = load_flax(VGG16Features(), got)(torch.as_tensor(x))
    for g, w in zip(out, VGGJ().apply(want, x)):
        _close(g, w)


def _mpd_sd(seed):
    """The reference ``MPDDiscriminator``'s entries (as
    ``tests/test_convert.py`` names them), fan-in scaled, with live batch
    norm statistics; two convs saved with spectral norm on
    (``weight_orig``, ``weight_u``, ``weight_v``)."""
    from tests.test_convert import _reference_mpd_sd

    np.random.seed(seed)
    sd = _reference_mpd_sd()
    rng = np.random.default_rng(seed)
    for k in list(sd):
        v = sd[k]
        if k.endswith(".weight") and v.ndim == 4:
            sd[k] = v * np.float32(np.prod(v.shape[1:]) ** -0.5)
        elif k.endswith(".bias") and ".conv.1." not in k:
            sd[k] = v * np.float32(0.05)
        elif k.endswith("running_mean"):
            sd[k] = rng.normal(0, 0.1, v.shape).astype(np.float32)
        elif k.endswith("running_var") or k.endswith("conv.1.weight"):
            sd[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
    for key in ("Dmain.net.1.conv.0", "localD1.outConv"):
        w = sd.pop(f"{key}.weight")
        sd[f"{key}.weight_orig"] = w * np.float32(3.0)
        sd[f"{key}.weight_u"] = rng.normal(0, 1, w.shape[0]).astype(
            np.float32)
        sd[f"{key}.weight_v"] = rng.normal(0, 1, w[0].size).astype(
            np.float32)
    return sd


def test_convert_discriminator_equals_jax_converter():
    """The MPD discriminator (with its VGG16 and the spectral-norm entries
    materialised) at 288^2, its smallest size, in eval mode: tree equal to
    the JAX converter's, and the port's patch maps equal JAX's on it."""
    from kbe_tpu.models.discriminator import MPDDiscriminator as MPDJ
    from kbe_torch.models.discriminator import MPDDiscriminator
    from tests.test_torch_discriminator import _close

    sd = _mpd_sd(6)
    got = rc.convert_discriminator(sd, kind="mpd")
    want = tc.convert_discriminator(sd, kind="mpd")
    _assert_trees_equal(got, want)
    plain = rc._materialize_spectral_norm(sd)
    assert "Dmain.net.1.conv.0.weight" in plain
    assert not any(k.endswith(("_orig", "_u", "_v")) for k in plain)
    port = MPDDiscriminator(spectral_norm=False)
    load_flax(port, got)
    rng = np.random.default_rng(7)
    img = rng.uniform(0, 1, (1, 288, 288, 3)).astype(np.float32)
    disp = rng.uniform(0, 1, (1, 288, 288, 1)).astype(np.float32)
    with torch.no_grad():
        out = port(torch.as_tensor(img), torch.as_tensor(disp), train=False)
    ref = MPDJ(spectral_norm=False).apply(want, img, disp, train=False)
    for g, w in zip(out, ref):
        _close(g, w)
    with pytest.raises(ValueError, match="unknown discriminator"):
        rc.convert_discriminator(sd, kind="stylegan")
