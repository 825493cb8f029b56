"""kbe_torch's nets against their Flax forwards at f32, through
``state_dict_from_flax``, on numpy-seeded weights and inputs (CPU).

Param trees come from ``jax.eval_shape`` of the Flax init, filled from a
numpy generator (no Flax init runs). Tolerance: rtol 1e-4 and atol 1e-4 of
the output's scale. Both sides run f32 convolutions that sum in different
orders, so they agree to about 1e-6 relative per layer; the deep nets add
a few such layers' worth.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from kbe_tpu.models import Disparity as DisparityJ
from kbe_tpu.models import Inpaint as InpaintJ
from kbe_tpu.models import PartialInpaint as PartialInpaintJ
from kbe_tpu.models import Refine as RefineJ
from kbe_tpu.models import RefinePretrained as RefinePretrainedJ
from kbe_tpu.models import Semantics as SemanticsJ
from kbe_tpu.models.gridnet import ContextNet as ContextNetJ
from kbe_tpu.models.layers import sample_norm_stats as stats_j
from kbe_tpu.models.partial_conv import PartialConv as PartialConvJ
from kbe_torch.models import (ContextNet, Disparity, Inpaint, PartialConv,
                              PartialInpaint, Refine, RefinePretrained,
                              Semantics)
from kbe_torch.models.layers import ceil_max_pool, sample_norm_stats
from kbe_torch.utils.convert import state_dict_from_flax


def random_params(module, *inputs, seed=0):
    """A Flax param tree of ``module`` for ``inputs``, filled with seeded
    numpy values: conv kernels N(0, 1/fan_in), biases N(0, 0.05^2), PReLU
    slopes around 0.25."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *inputs)

    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return rng.normal(0, fan_in ** -0.5, leaf.shape).astype(
                np.float32)
        if name == "bias":
            return rng.normal(0, 0.05, leaf.shape).astype(np.float32)
        return (0.25 + rng.uniform(-0.1, 0.1, leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale)


def _port(module, params):
    module.load_state_dict(state_dict_from_flax(params))
    return module.eval()


def _u(*shape, seed=1, lo=0.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(
        np.float32)


def test_semantics_matches_flax():
    img = _u(1, 32, 48, 3)
    params = random_params(SemanticsJ(), img)
    want = SemanticsJ().apply(params, img)
    with torch.no_grad():
        got = _port(Semantics(), params)(torch.as_tensor(img))
    _close(got, want)


@pytest.mark.parametrize("hw", [(32, 32), (36, 44)])
def test_disparity_matches_flax(hw):
    rows = (8, 12, 16, 24, 24, 24)
    h, w = hw
    img = _u(1, h, w, 3)
    sem = _u(1, -(-h // 16), -(-w // 16), 512, seed=2)
    params = random_params(DisparityJ(rows=rows), img, sem)
    want = DisparityJ(rows=rows).apply(params, img, sem)
    with torch.no_grad():
        got = _port(Disparity(rows=rows), params)(torch.as_tensor(img),
                                                   torch.as_tensor(sem))
    _close(got, want)


def test_refine_matches_flax():
    img = _u(1, 32, 40, 3)
    disp = _u(1, 8, 10, 1, seed=2, hi=50.0)
    params = random_params(RefineJ(), img, disp)
    want = RefineJ().apply(params, img, disp)
    with torch.no_grad():
        got = _port(Refine(), params)(torch.as_tensor(img),
                                      torch.as_tensor(disp))
    _close(got, want)


def test_refine_pretrained_matches_flax():
    """The released checkpoint's layout: residual Basic blocks, with a 1x1
    ``shortcut`` conv where a block changes its channel count."""
    img = _u(1, 32, 40, 3)
    disp = _u(1, 8, 10, 1, seed=2, hi=50.0)
    params = random_params(RefinePretrainedJ(), img, disp)
    flat = state_dict_from_flax(params)
    assert any(".shortcut." in k for k in flat)
    want = RefinePretrainedJ().apply(params, img, disp)
    with torch.no_grad():
        got = _port(RefinePretrained(), params)(torch.as_tensor(img),
                                                torch.as_tensor(disp))
    _close(got, want)
    # a flat disparity (the 2D mode's ones): the per-sample normalisation
    # sees a zero deviation and must come back finite and equal
    ones = np.ones_like(disp)
    want = RefinePretrainedJ().apply(params, img, ones)
    with torch.no_grad():
        got = _port(RefinePretrained(), params)(torch.as_tensor(img),
                                                torch.as_tensor(ones))
    assert np.isfinite(np.asarray(want)).all()
    _close(got, want)


@pytest.mark.parametrize("kernel,stride,masked", [(3, 1, True), (3, 2, True),
                                                  (1, 1, False)])
def test_partial_conv_matches_flax(kernel, stride, masked):
    """A random 0/1 mask with whole windows masked out (coverage 0) and
    partly covered ones; ``masked=False`` is the shortcut's ``mask=None``.
    The propagated masks must be equal, the outputs within tolerance."""
    cin, cout = 6, 5
    x = _u(1, 13, 18, cin, lo=-1.0)
    mask = (_u(1, 13, 18, cin, seed=2) > 0.4).astype(np.float32)
    mask[:, 3:9, 4:11] = 0.0
    conv_j = PartialConvJ(cout, kernel=kernel, stride=stride)
    params = random_params(conv_j, x, mask)
    want, want_m = conv_j.apply(params, x, mask if masked else None)
    assert set(params["params"]) == {"conv", "bias"}
    port = _port(PartialConv(cin, cout, kernel=kernel, stride=stride), params)
    with torch.no_grad():
        got, got_m = port(
            torch.as_tensor(x).permute(0, 3, 1, 2),
            torch.as_tensor(mask).permute(0, 3, 1, 2) if masked else None)
    got, got_m = got.permute(0, 2, 3, 1), got_m.permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    if masked:
        assert 0.0 < float(np.asarray(want_m).mean()) < 1.0
    _close(got, want)


@pytest.mark.parametrize("hw", [(32, 32), (36, 44)])
def test_partial_inpaint_matches_flax(hw):
    rows = (8, 12, 16, 20)
    data = _u(1, *hw, 68, lo=-1.0)
    mask = np.ones((1, *hw, 1), np.float32)
    mask[:, 6:26, 10:28] = 0.0     # a hole wider than one conv can close
    params = random_params(PartialInpaintJ(rows=rows), data, mask)
    want = PartialInpaintJ(rows=rows).apply(params, data, mask)
    with torch.no_grad():
        got = _port(PartialInpaint(rows=rows), params)(
            torch.as_tensor(data), torch.as_tensor(mask))
    assert len(got) == len(want) == 3
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert got[2].shape == (1, *hw, 1)
    for g, w in zip(got[:2], want[:2]):
        _close(g, w)


def test_context_net_matches_flax():
    img = _u(1, 24, 32, 3, lo=-1.0)
    disp = _u(1, 24, 32, 1, seed=2, lo=-1.0)
    params = random_params(ContextNetJ(), img, disp)
    want = ContextNetJ().apply(params, img, disp)
    with torch.no_grad():
        got = _port(ContextNet(), params)(torch.as_tensor(img),
                                          torch.as_tensor(disp))
    _close(got, want)


@pytest.mark.parametrize("hw", [(32, 32), (36, 44)])
def test_inpaint_matches_flax(hw):
    rows = (8, 12, 16, 20)
    data = _u(1, *hw, 68, lo=-1.0)
    mask = (_u(1, *hw, 1, seed=2) > 0.3).astype(np.float32)
    params = random_params(InpaintJ(rows=rows), data, mask)
    want = InpaintJ(rows=rows).apply(params, data, mask)
    with torch.no_grad():
        got = _port(Inpaint(rows=rows), params)(torch.as_tensor(data),
                                                torch.as_tensor(mask))
    for g, w in zip(got, want):
        _close(g, w)


def test_layers_pool_and_norm_stats():
    x = _u(2, 7, 9, 3, lo=-1.0)
    pooled = ceil_max_pool(torch.as_tensor(x).permute(0, 3, 1, 2))
    want = np.full((2, 4, 5, 3), -np.inf, np.float32)
    for i in range(4):
        for j in range(5):
            want[:, i, j] = x[:, 2 * i:2 * i + 2, 2 * j:2 * j + 2].max((1, 2))
    np.testing.assert_array_equal(pooled.permute(0, 2, 3, 1).numpy(), want)
    for a, b in zip(sample_norm_stats(torch.as_tensor(x).bfloat16()),
                    stats_j(jnp.asarray(x, jnp.bfloat16))):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


@pytest.mark.parametrize("kind", ["dense", "conv_transpose"])
def test_dense_and_conv_transpose_load_from_flax(kind):
    """The converter's 2-D rule (a Dense kernel (in, out) becomes a
    ``Linear.weight`` (out, in)) and a Flax ``ConvTranspose`` (2x2, stride
    2) loaded into the port's ``ConvTranspose``: the same forward. A leaf
    the converter does not know still raises."""
    import flax.linen as fnn
    from kbe_torch.models.maskrcnn import ConvTranspose

    if kind == "dense":
        flax_mod, port = fnn.Dense(24), torch.nn.Linear(40, 24)
        x = _u(3, 40, seed=2, lo=-1.0)
    else:
        flax_mod, port = (fnn.ConvTranspose(6, (2, 2), strides=(2, 2)),
                          ConvTranspose(5, 6))
        x = _u(2, 7, 9, 5, seed=2, lo=-1.0)
    params = random_params(flax_mod, jnp.asarray(x), seed=3)
    want = flax_mod.apply(params, jnp.asarray(x))
    port = _port(port, params)
    with torch.no_grad():
        if kind == "dense":
            got = port(torch.from_numpy(x))
        else:
            got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(
                0, 2, 3, 1)
    _close(got.numpy(), want)
    with pytest.raises(ValueError, match="unknown Flax leaf"):
        state_dict_from_flax({"params": {"fc": {"embedding": np.zeros(3)}}})
    with pytest.raises(ValueError, match="expected HWIO"):
        state_dict_from_flax({"params": {"fc": {"kernel": np.zeros(3)}}})
