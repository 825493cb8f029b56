"""kbe_torch's VGG16 and discriminators against kbe_tpu's Flax modules
(CPU), through ``state_dict_from_flax`` on numpy-seeded variables: the
outputs in train and eval mode, and after a train-mode call the
``batch_stats`` (BatchNorm mean and biased variance at momentum 0.99, the
spectral norms' ``u`` and ``sigma``). Tolerance: rtol 1e-4 and atol 1e-4 of
the output's scale, the conv stack's standard (tests/test_torch_models.py);
the updated statistics rtol 1e-4 and atol 1e-5 (a variance of a layer's
output, E[x^2] - E[x]^2, in f32).
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kbe_tpu.models import discriminator as DJ
from kbe_tpu.models.vgg import VGG16Features as VGGJ
from kbe_torch.models import discriminator as DT
from kbe_torch.models.vgg import VGG16Features
from kbe_torch.utils.convert import load_flax, state_dict_from_flax


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The Tier-1 run has six worker processes on the CPU: one thread for
    this file's convolutions keeps them from oversubscribing the cores
    that the other workers' tests run on."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def random_variables(module, *inputs, seed=0, **kw):
    """A Flax variables tree of ``module`` ({'params'} and, where it has
    them, {'batch_stats'}) filled with seeded numpy values."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(
        lambda: module.init({"params": jax.random.PRNGKey(0)}, *inputs, **kw))

    def fill(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return rng.normal(0, fan_in ** -0.5, leaf.shape)
        if name == "bias":
            return rng.normal(0, 0.05, leaf.shape)
        if name == "scale":
            return rng.uniform(0.8, 1.2, leaf.shape)
        if name == "mean":
            return rng.normal(0, 0.1, leaf.shape)
        if name == "var":
            return rng.uniform(0.5, 1.5, leaf.shape)
        if name.endswith("/u"):
            return rng.normal(0, 1, leaf.shape)
        if name.endswith("/sigma"):
            return np.ones(leaf.shape)
        raise ValueError(name)

    tree = jax.tree_util.tree_map_with_path(
        lambda p, l: fill(p, l).astype(np.float32),
        flax.core.unfreeze(shapes))
    return tree


def _close(got, want, rtol=1e-4):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


def _u(*shape, seed=1):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(
        np.float32)


def test_vgg16_features_matches_flax():
    x = _u(2, 36, 44, 3)
    params = random_variables(VGGJ(), x)
    want = VGGJ().apply(params, x)
    with torch.no_grad():
        got = load_flax(VGG16Features(), params)(torch.as_tensor(x))
    assert [tuple(g.shape) for g in got] == [(2, 18, 22, 64), (2, 9, 11, 128),
                                             (2, 4, 5, 256)]
    for g, w in zip(got, want):
        _close(g, w)


def _stats_match(port: torch.nn.Module, flax_stats):
    sd = port.state_dict()
    want = state_dict_from_flax({"params": {}, "batch_stats": flax_stats})
    assert want
    for name, value in want.items():
        np.testing.assert_allclose(sd[name].numpy(), value.numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


@pytest.fixture(scope="module")
def mpd():
    """MPD with spectral norm at 288^2 (its smallest size), batch 1."""
    img, disp = _u(1, 288, 288, 3, seed=2), _u(1, 288, 288, 1, seed=3)
    module = DJ.MPDDiscriminator(spectral_norm=True)
    variables = random_variables(module, img, disp, train=True, seed=4)
    port = DT.MPDDiscriminator(spectral_norm=True)
    port.load_state_dict(state_dict_from_flax(variables))
    return module, variables, port, img, disp


def test_mpd_eval_matches_flax(mpd):
    module, variables, port, img, disp = mpd
    want = module.apply(variables, img, disp, train=False)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    with torch.no_grad():
        got = port(torch.as_tensor(img), torch.as_tensor(disp), train=False)
    assert [tuple(g.shape) for g in got] == [(1, 69, 69, 1), (1, 16, 16, 1),
                                             (1, 2, 2, 1)]
    for g, w in zip(got, want):
        _close(g, w)
    # eval runs the power step but stores nothing
    for k, v in port.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_mpd_train_and_batch_stats_match_flax(mpd):
    module, variables, port, img, disp = mpd
    port = DT.MPDDiscriminator(spectral_norm=True)
    port.load_state_dict(state_dict_from_flax(variables))
    want, upd = module.apply(variables, img, disp, train=True,
                             mutable=["batch_stats"])
    with torch.no_grad():
        got = port(torch.as_tensor(img), torch.as_tensor(disp), train=True)
    for g, w in zip(got, want):
        _close(g, w)
    _stats_match(port, flax.core.unfreeze(upd["batch_stats"]))


@pytest.mark.parametrize("name,size", [
    ("Discriminator", 64),
    ("PerceptualDiscriminator", 128),
    ("MultiScaleDiscriminator", 288),
    ("MultiScalePerceptualDiscriminator", 288),
], ids=["patchgan", "perceptual", "multiscale", "multiscale_perceptual"])
def test_other_discriminators_match_flax(name, size):
    img = _u(1, size, size, 3, seed=5)
    module = getattr(DJ, name)(spectral_norm=name != "Discriminator")
    variables = random_variables(module, img, train=True, seed=6)
    port = getattr(DT, name)(spectral_norm=name != "Discriminator")
    port.load_state_dict(state_dict_from_flax(variables))
    # the 288^2 ones in eval mode only: their train-mode layers are
    # MPD's (test_mpd_train_and_batch_stats_match_flax)
    modes = (False,) if size == 288 else (False, True)
    for train in modes:
        if train:
            want, upd = module.apply(variables, img, train=True,
                                     mutable=["batch_stats"])
        else:
            want = module.apply(variables, img, train=False)
        with torch.no_grad():
            got = port(torch.as_tensor(img), train=train)
        for g, w in zip(got if isinstance(got, list) else [got],
                        want if isinstance(want, list) else [want]):
            _close(g, w)
    if size != 288:
        _stats_match(port, flax.core.unfreeze(upd["batch_stats"]))


def test_adversarial_loss_matches():
    preds = [_u(2, 5, 5, 1, seed=s) for s in range(3)]
    for real in (True, False):
        want = float(DJ.adversarial_loss([jnp.asarray(p) for p in preds],
                                         real))
        got = float(DT.adversarial_loss([torch.as_tensor(p) for p in preds],
                                        real))
        assert got == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("sn", [True, False], ids=["spectral", "plain"])
def test_conv_block_is_flax_not_torch_nn(sn):
    """One ``ConvBlock`` against Flax's: the spectral norm flattens the
    kernel as (kh*kw*in, out) and takes one power step from the stored
    ``u`` in both modes (eval stores nothing); the batch norm keeps the
    biased variance at momentum 0.99. ``torch.nn.utils.spectral_norm`` and
    ``torch.nn.BatchNorm2d`` would each give other numbers."""
    x = _u(2, 20, 24, 6, seed=8) * 4.0 - 1.0
    module = DJ.ConvBlock(5, spectral_norm=sn)
    variables = random_variables(module, x, train=True, seed=9)
    port = DT.ConvBlock(6, 5, spectral_norm=sn)
    port.load_state_dict(state_dict_from_flax(variables))
    nchw = torch.as_tensor(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = port(nchw, train=False).permute(0, 2, 3, 1)
    _close(got, module.apply(variables, x, train=False), rtol=1e-5)
    want, upd = module.apply(variables, x, train=True,
                             mutable=["batch_stats"])
    with torch.no_grad():
        got = port(nchw, train=True).permute(0, 2, 3, 1)
    _close(got, want, rtol=1e-5)
    # after the eval call: had it stored u, this pass would start elsewhere
    _stats_match(port, flax.core.unfreeze(upd["batch_stats"]))


def test_mpd_needs_288():
    """The main head's dilated convolutions leave nothing of a 256^2
    input, as in the JAX package, where 288^2 is the smallest size."""
    disc = DT.MPDDiscriminator(spectral_norm=True)
    with pytest.raises(RuntimeError):
        disc(torch.zeros(1, 256, 256, 3), torch.zeros(1, 256, 256, 1))


def test_converter_refuses_unknown_leaves():
    with pytest.raises(ValueError, match="batch_stats"):
        state_dict_from_flax({"params": {}, "batch_stats": {
            "bn": {"count": np.zeros(3)}}})
    with pytest.raises(ValueError, match="spectral"):
        state_dict_from_flax({"params": {}, "batch_stats": {
            "SpectralNorm_0": {"conv/kernel/v": np.zeros((1, 3))}}})
    with pytest.raises(ValueError, match="unknown Flax leaf"):
        state_dict_from_flax({"params": {"bn": {"gamma": np.zeros(3)}}})
