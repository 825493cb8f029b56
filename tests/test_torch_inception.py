"""kbe_torch's Inception-v3 feature trunk against kbe_tpu's (CPU, f32), and
the torchvision converter against the JAX package's.

- ``InceptionV3Features`` at 128^2, batch 2 (the JAX package's own test
  size, ``tests/test_convert.py``), from a numpy-seeded Flax tree through
  ``state_dict_from_flax``: features to a relative L2 error of 1e-4 (f32
  convolutions summed in other orders through 94 layers).
- ``convert_inception`` on a synthetic torchvision state dict: the tree
  equals ``kbe_tpu.utils.torch_convert``'s leaf for leaf, loads strictly,
  and the port's forward on it equals JAX's on the JAX converter's tree to
  the same 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kbe_tpu.models.inception import InceptionV3Features as InceptionJ
from kbe_tpu.utils import torch_convert as tc
from kbe_torch.models.inception import InceptionV3Features
from kbe_torch.utils import reference_convert as rc
from kbe_torch.utils.convert import load_flax, state_dict_from_flax
from tests.test_torch_models import random_params
from tests.test_torch_reference_convert import _assert_trees_equal

SIZE = 128


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The Tier-1 run has six worker processes on the CPU: one thread for
    this file's convolutions keeps them from oversubscribing the cores
    that the other workers' tests run on."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_apply():
    return jax.jit(InceptionJ().apply)


def _images(seed):
    return np.random.default_rng(seed).uniform(
        0, 1, (2, SIZE, SIZE, 3)).astype(np.float32)


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _port_features(tree, x):
    with torch.no_grad():
        return load_flax(InceptionV3Features(), tree)(
            torch.as_tensor(x)).numpy()


def test_inception_features_match_flax(jax_apply):
    x = _images(0)
    params = random_params(InceptionJ(), jnp.zeros((1, SIZE, SIZE, 3)),
                           seed=1)
    want = np.asarray(jax_apply(params, x))
    got = _port_features(params, x)
    assert got.shape == want.shape == (2, 2048)
    assert _rel_l2(got, want) <= 1e-4


def test_inception_attribute_names_mirror_flax():
    shapes = jax.eval_shape(InceptionJ().init, jax.random.PRNGKey(0),
                            jnp.zeros((1, SIZE, SIZE, 3)))
    want = {k: tuple(v.shape) for k, v in state_dict_from_flax(
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                               shapes)).items()}
    got = {k: tuple(v.shape)
           for k, v in InceptionV3Features().state_dict().items()}
    assert got == want
    assert "Mixed_5b.b1x1.conv.weight" in got


def _tv_inception_sd(seed):
    """A torchvision ``inception_v3`` state dict (its keys and shapes, from
    the shapes of the Flax tree; no init runs), random values."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(InceptionJ().init, jax.random.PRNGKey(0),
                            jnp.zeros((1, SIZE, SIZE, 3)))["params"]
    sd = {}

    def add_unit(tv_key, kernel_shape):
        kh, kw, ci, co = kernel_shape
        f32 = lambda a: np.asarray(a, np.float32)
        sd[f"{tv_key}.conv.weight"] = f32(rng.normal(
            0, (kh * kw * ci) ** -0.5, (co, ci, kh, kw)))
        sd[f"{tv_key}.bn.weight"] = f32(rng.uniform(0.5, 1.5, co))
        sd[f"{tv_key}.bn.bias"] = f32(rng.normal(0, 0.1, co))
        sd[f"{tv_key}.bn.running_mean"] = f32(rng.normal(0, 0.1, co))
        sd[f"{tv_key}.bn.running_var"] = f32(rng.uniform(0.5, 1.5, co))

    for ours, tv in tc._INCEPTION_STEM:
        add_unit(tv, shapes[ours]["conv"]["kernel"].shape)
    for block, branches in tc._INCEPTION_BLOCKS.items():
        for b in branches:
            add_unit(f"{block}.{tc._tv_branch(b)}",
                     shapes[block][b]["conv"]["kernel"].shape)
    return sd


def test_convert_inception_equals_jax_converter(jax_apply):
    sd = _tv_inception_sd(2)
    got, want = rc.convert_inception(sd), tc.convert_inception(sd)
    _assert_trees_equal(got, want)
    x = _images(3)
    want_f = np.asarray(jax_apply(want, x))
    got_f = _port_features(got, x)
    assert _rel_l2(got_f, want_f) <= 1e-4
