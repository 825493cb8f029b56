"""kbe_torch's FID against kbe_tpu's (CPU), and the adversarial trainer's
FID validation.

- ``preprocess_images``: 2 images, 40x56 -> 299^2: atol 1e-6 against a
  float64 product with ``jax.image.resize``'s own weight matrices, and 5e-6
  against ``kbe_tpu``'s, whose CPU einsum is itself 1.9e-6 from that
  float64 value (the port 7e-8).
- ``activation_statistics`` and ``frechet_distance`` on the statistics of
  ``tests/test_fid_parity.py`` (16 features, full rank; 256 features from
  24 samples, the eps branch): rtol 1e-10, both sides run numpy and scipy
  in float64 on equal inputs.
- The Newton-Schulz fallback against ``kbe_tpu``'s on a 32^2 SPD matrix,
  rtol 1e-4 (JAX iterates in f32, the port in float64).
- ``FID.activations`` of 4 images at 64^2, through 299^2, from one Flax
  Inception tree: relative L2 error 1e-4.
- ``TrainerInpaint.validation_adv`` at 288^2 (the discriminator's smallest
  size; a narrow grid-net), 2 validation batches of 1, one Inception tree
  through ``hparams['inception_params']`` on both sides. A 2048-d Fréchet
  distance takes about half a minute of ``sqrtm`` on the host, so
  ``frechet_distance`` is swapped in both packages for one that records
  its statistics and returns 0: the means agree to a relative L2 error of
  1e-4, the covariances to 1e-3 (a two-sample covariance is a difference
  of activations, which loses digits).
- An adversarial ``TrainerInpaint.train`` runs through iteration 499,
  where it validates with the FID: here the distance of the first 64
  features, by the real ``frechet_distance``.
"""

import json
import os

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kbe_tpu.config import CameraConfig as CameraJ
from kbe_tpu.models import Inpaint as InpaintJ
from kbe_tpu.models.inception import InceptionV3Features as InceptionJ
from kbe_tpu.train import fid as FJ
from kbe_tpu.train import trainer_inpaint as TIJ
from kbe_torch.config import CameraConfig
from kbe_torch.train import fid as FT
from kbe_torch.train import trainer_inpaint as TIT
from kbe_torch.train.data import synthetic_batches
from tests.test_torch_models import random_params
from tests.test_torch_train import ROWS, _g_params


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
def inception_tree():
    tree = random_params(InceptionJ(), jnp.zeros((1, 75, 75, 3)), seed=3)
    return flax.core.unfreeze(jax.device_get(tree))


def _rel_l2(got, want):
    return float(np.linalg.norm(np.asarray(got) - np.asarray(want))
                 / np.linalg.norm(np.asarray(want)))


def test_preprocess_matches_jax():
    imgs = np.random.default_rng(0).uniform(0, 1, (2, 40, 56, 3)).astype(
        np.float32)
    got = FT.preprocess_images(imgs, device="cpu")
    want = FJ.preprocess_images(imgs)
    assert got.shape == (2, 299, 299, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-6)
    from jax._src.image import scale as S

    def weights(m):
        return np.asarray(S.compute_weight_mat(
            m, 299, 299 / m, 0.0, S._kernels[S.ResizeMethod.LINEAR],
            False), np.float64)

    exact = np.einsum("bhwc,hi,wj->bijc", imgs.astype(np.float64),
                      weights(40), weights(56), optimize=True)
    np.testing.assert_allclose(got, exact, rtol=0, atol=1e-6)


def _nan_first(module, calls):
    """``module._sqrtm`` returning NaN at its first call: the distance's
    eps retry then runs, whatever scipy makes of the first product."""
    real = module._sqrtm

    def sqrtm(mat):
        calls.append(mat)
        out = real(mat)
        return out * np.nan if len(calls) == 1 else out
    return sqrtm


@pytest.mark.parametrize("n,d,scale,shift,seed", [
    (400, 16, 1.3, 0.2, 1), (24, 256, 0.7, -0.1, 2)],
    ids=["well_conditioned", "eps_branch"])
def test_statistics_and_distance_match_jax(n, d, scale, shift, seed,
                                           monkeypatch):
    rng = np.random.default_rng(seed)
    a1 = rng.normal(size=(n, d)).astype(np.float32)
    a2 = (rng.normal(size=(n, d)) * scale + shift).astype(np.float32)
    stats = [FT.FID.activation_statistics(a) for a in (a1, a2)]
    for a, (mu, sigma) in zip((a1, a2), stats):
        mu_j, sigma_j = FJ.FID.activation_statistics(a)
        np.testing.assert_array_equal(mu, mu_j)
        np.testing.assert_array_equal(sigma, sigma_j)
    (mu1, s1), (mu2, s2) = stats
    calls_t, calls_j = [], []
    if d == 256:  # rank 23 of 256: the offset product of the retry
        monkeypatch.setattr(FT, "_sqrtm", _nan_first(FT, calls_t))
        monkeypatch.setattr(FJ, "_sqrtm", _nan_first(FJ, calls_j))
    got = FT.FID.frechet_distance(mu1, s1, mu2, s2)
    want = FJ.FID.frechet_distance(mu1, s1, mu2, s2)
    assert np.isfinite(got)
    assert got == pytest.approx(want, rel=1e-10)
    if d == 256:
        assert len(calls_t) == len(calls_j) == 2
        np.testing.assert_array_equal(calls_t[1], calls_j[1])
        assert not np.array_equal(calls_t[1], calls_t[0])


def _spd(dim, seed):
    a = np.random.default_rng(seed).normal(size=(dim, dim))
    return a @ a.T / dim + np.eye(dim)


def test_newton_schulz_matches_jax(monkeypatch):
    mat = _spd(32, 4)
    got = FT._newton_schulz_sqrtm(torch.as_tensor(mat)).numpy()
    want = np.asarray(FJ._newton_schulz_sqrtm(jnp.asarray(mat)))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    np.testing.assert_allclose(got @ got, mat, rtol=1e-8, atol=1e-8)
    # the fallback is taken where scipy fails

    def fail(*a, **k):
        raise RuntimeError("no scipy")

    import scipy.linalg

    monkeypatch.setattr(scipy.linalg, "sqrtm", fail)
    np.testing.assert_array_equal(FT._sqrtm(mat), got)


def test_activations_match_jax(inception_tree):
    imgs = np.random.default_rng(5).uniform(0, 1, (4, 64, 64, 3)).astype(
        np.float32)
    got = FT.FID(inception_tree, device="cpu").activations(imgs)
    want = FJ.FID(inception_tree).activations(imgs)
    assert got.shape == (4, 2048) and got.dtype == np.float32
    assert _rel_l2(got, want) <= 1e-4


def _recording(calls):
    def frechet_distance(mu1, sigma1, mu2, sigma2, eps=1e-6):
        calls.append((mu1, sigma1, mu2, sigma2))
        return 0.0
    return staticmethod(frechet_distance)


def test_validation_adv_matches_jax(inception_tree, tmp_path, monkeypatch):
    h = w = 288
    cam = (256.0, 60.0)
    hparams = {"model_to_train": "inpainting", "adversarial": True,
               "inception_params": inception_tree}
    calls_j, calls_t = [], []
    monkeypatch.setattr(FJ.FID, "frechet_distance", _recording(calls_j))
    monkeypatch.setattr(FT.FID, "frechet_distance", _recording(calls_t))
    params = _g_params(h, w, seed=30)
    val = lambda: synthetic_batches(1, h, w, mode="inpainting",
                                    camera=CameraConfig(*cam), seed=8,
                                    steps=2)

    tj = TIJ.TrainerInpaint(hparams, camera=CameraJ(*cam),
                            logs_path=str(tmp_path / "jax"))
    tj.net_def = InpaintJ(rows=ROWS)
    sj = TIJ.InpaintState(params["context"], params["net"], (),
                          jnp.zeros((), jnp.int32))
    assert tj.validation_adv(sj, val()) == 0.0

    tt = TIT.TrainerInpaint(dict(hparams, inpaint_rows=ROWS),
                            camera=CameraConfig(*cam), device="cpu",
                            logs_path=str(tmp_path / "torch"))
    st = tt.init_state((h, w), params)
    assert tt.validation_adv(st, val()) == 0.0
    fid = tt._fid
    assert np.isnan(tt.validation_adv(st, iter(())))  # an empty set
    assert tt._fid is fid  # built once
    (got,), (want,) = calls_t, calls_j
    for i, tol in enumerate((1e-4, 1e-3, 1e-4, 1e-3)):
        assert got[i].shape == want[i].shape
        assert _rel_l2(got[i], want[i]) <= tol, (i, _rel_l2(got[i], want[i]))
    assert [r["value"] for r in _logged(tt)
            if r["tag"] == "Validation inpaint/FID"] == [0.0]


def _logged(trainer):
    trainer.writer.flush()
    with open(os.path.join(trainer.writer.logdir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_adversarial_train_validates_at_iteration_499(inception_tree,
                                                      tmp_path,
                                                      monkeypatch):
    """The loop reaches ``validation_adv`` at iteration 499, after its
    checkpoint, and goes on."""
    h = w = 288
    frechet = FT.FID.frechet_distance
    scores = []

    def first_64(mu1, s1, mu2, s2, eps=1e-6):
        scores.append(frechet(mu1[:64], s1[:64, :64], mu2[:64],
                              s2[:64, :64], eps))
        return scores[-1]

    monkeypatch.setattr(FT.FID, "frechet_distance", staticmethod(first_64))
    cam = CameraConfig(256.0, 60.0)
    tt = TIT.TrainerInpaint({"adversarial": True, "inpaint_rows": ROWS,
                             "inception_params": inception_tree},
                            camera=cam, device="cpu",
                            logs_path=str(tmp_path / "torch"),
                            pretrain_steps=1000)
    saved = []
    data = synthetic_batches(1, h, w, mode="inpainting", camera=cam, seed=9)
    val = lambda: synthetic_batches(1, h, w, mode="inpainting", camera=cam,
                                    seed=10, steps=2)
    g, d = tt.train(data, val, (h, w), max_steps=500, resume_step=499,
                    checkpoint_cb=lambda st, step: saved.append(step))
    assert tt.iter_nb == 500 and saved == [499]
    assert d.step == 1 and g.step == 0  # D-only: G is pretraining
    assert len(scores) == 1 and np.isfinite(scores[0]) and scores[0] > 0
    assert [(r["step"], r["value"]) for r in _logged(tt)
            if r["tag"] == "Validation inpaint/FID"] == [(499, scores[0])]
