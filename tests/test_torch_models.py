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
from kbe_tpu.models import Refine as RefineJ
from kbe_tpu.models import Semantics as SemanticsJ
from kbe_tpu.models.gridnet import ContextNet as ContextNetJ
from kbe_tpu.models.layers import sample_norm_stats as stats_j
from kbe_torch.models import ContextNet, Disparity, Inpaint, Refine, \
    Semantics
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
