"""kbe_torch's depth trainer against kbe_tpu's on the CPU, from the same
Flax trees and the same batches (64^2, a narrow disparity lattice through
``hparams['disparity_rows']``, the full ``Semantics`` and ``Refine``,
``estimation_size`` 32, as ``tests/test_training.py`` sizes them).

Both trainers' optimizers are swapped for ones that record the gradients
they are given (``tests/test_torch_train.py``) around a real optimizer at
lr 1e-9, so each side's own step code makes the gradients, the parameters
barely move, and the optimizer's count goes on:

- one ``disparity_train_step`` with instance masks (the 'same' loss), then
  one ``imagenet_mask_step`` on the same state (the 'other' loss): losses
  rtol 1e-4, each gradient leaf to a relative L2 error of 1e-3; after the
  two, step and optimizer count are both 2 on both sides (the two steps
  share the Adam moments and the count);
- one ``refine_train_step``: the losses rtol 1e-4; each gradient leaf of
  the refine net within 1e-3 of JAX's or, where the two f32 runs part
  further, both within 3e-3 of a float64 run of the port's refine net on
  the same inputs, as ``tests/test_torch_train.py`` referees D (the
  normalised-gradient loss divides by the magnitudes of a prediction near
  zero: each f32 run is about 6e-4 from float64 on
  ``disparity_one.conv1``, and they part by 1.1e-3 on this batch);
- ``validation`` in refine and in disparity mode: the 7 metrics rtol 1e-4.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kbe_tpu.models import Disparity as DisparityJ
from kbe_tpu.models import Refine as RefineJ
from kbe_tpu.models import Semantics as SemanticsJ
from kbe_tpu.train import trainer_depth as TDJ
from kbe_tpu.train.metrics import DEPTH_METRIC_NAMES
from kbe_torch.train import trainer_depth as TDT
from kbe_torch.utils.convert import state_dict_from_flax
from tests.test_torch_models import random_params
from kbe_torch.models import Refine
from kbe_torch.ops.resize import resize_to_max
from kbe_torch.parallel import data_mesh
from kbe_torch.train.losses import compute_loss_grad, compute_loss_ord
from kbe_torch.utils.convert import load_flax
from tests.test_torch_train import (_capture_jax, _CaptureTorch,
                                    _d_grads_match, _grads_match,
                                    _losses_match)

H = W = 64
ROWS = (8, 12, 16, 32, 32, 32)
LR = 1e-9


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The Tier-1 run has six worker processes on the CPU: one thread for
    this file's convolutions keeps them from oversubscribing the cores
    that the other workers' tests run on."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _unfrozen(tree):
    return flax.core.unfreeze(jax.device_get(tree))


@pytest.fixture(scope="module")
def trees():
    img = jnp.zeros((1, H, W, 3))
    return {
        "semantics": _unfrozen(random_params(SemanticsJ(), img, seed=40)),
        "disparity": _unfrozen(random_params(
            DisparityJ(rows=ROWS), img, jnp.zeros((1, 4, 4, 512)), seed=41)),
        "refine": _unfrozen(random_params(
            RefineJ(), img, jnp.zeros((1, 16, 16, 1)), seed=42)),
    }


def _batch(seed, h, w, with_masks=False):
    """Image in [-1, 1], disparity and mask at (h, w), as the trainers'
    modes take them; three instance masks a sample."""
    r = np.random.default_rng(seed)
    batch = {
        "image": r.uniform(-1, 1, (2, H, W, 3)).astype(np.float32),
        "disparity": r.uniform(1, 60, (2, h, w, 1)).astype(np.float32),
        "mask": (r.uniform(0, 1, (2, h, w, 1)) > 0.2).astype(np.float32),
    }
    if with_masks:
        batch["instance_masks"] = (r.uniform(0, 1, (2, 3, h, w, 1))
                                   > 0.7).astype(np.float32)
    return batch


@pytest.fixture(scope="module")
def trainers(trees, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("depth")
    hp = {"model_to_train": "refine", "estimation_size": 32,
          "disparity_rows": ROWS, "lr_estimation": LR, "lr_refine": LR}
    tj = TDJ.TrainerDepth(hp, semantics_params=trees["semantics"],
                          logs_path=str(tmp / "jax"))
    tj.disparity = DisparityJ(rows=ROWS)
    tt = TDT.TrainerDepth(hp, semantics_params=trees["semantics"],
                          device="cpu", logs_path=str(tmp / "torch"))
    for name, clip in (("tx_disparity", 1.0), ("tx_imagenet", 0.1),
                       ("tx_refine", 1.0)):
        setattr(tj, name, _capture_jax(TDJ.make_optimizer(LR, 0.99995,
                                                          clip)))
        setattr(tt, name, _CaptureTorch(TDT.make_optimizer(LR, 0.99995,
                                                           clip)))
    return tj, tt


def _jax_batch(batch):
    return jax.tree_util.tree_map(jnp.asarray, batch)


def _torch_batch(batch):
    return TDT.to_device(batch, "cpu")


def _named(net, grads):
    return dict(zip([n for n, _ in net.named_parameters()], grads))


def _counts(opt_state):
    """The optax state's counts (scale_by_adam's and the schedule's)."""
    return {int(leaf) for leaf in jax.tree_util.tree_leaves(opt_state)
            if jnp.issubdtype(jnp.asarray(leaf).dtype, jnp.integer)}


def test_disparity_and_imagenet_steps_match_jax(trees, trainers):
    tj, tt = trainers
    sj, _ = tj.init_state((H, W), "refine",
                          disparity_params=trees["disparity"],
                          refine_params=trees["refine"])
    st, _ = tt.init_state((H, W), "refine",
                          disparity_params=trees["disparity"],
                          refine_params=trees["refine"])
    batch = _batch(1, H // 2, W // 2, with_masks=True)
    sj, mj = jax.jit(tj.disparity_train_step)(sj, _jax_batch(batch))
    st, mt = tt.disparity_train_step(st, _torch_batch(batch))
    _losses_match(mt, mj)
    assert float(mt["mask"]) > 0
    _grads_match(_named(st.net, st.opt_state["g"]), sj.opt_state["g"])

    aux = {"image": _batch(2, H // 2, W // 2)["image"],
           "instance_masks": batch["instance_masks"]}
    sj, mj = jax.jit(tj.imagenet_mask_step)(sj, _jax_batch(aux))
    st, mt = tt.imagenet_mask_step(st, _torch_batch(aux))
    _losses_match(mt, mj)
    _grads_match(_named(st.net, st.opt_state["g"]), sj.opt_state["g"])
    # one Adam state, and its count, for both steps
    assert int(sj.step) == 2 and _counts(sj.opt_state["inner"]) == {2}
    assert st.step == 2 and st.opt_state["inner"]["count"] == 2


def _refine_grads_f64(trainer, dstate, tree, batch):
    """The refine loss's gradients from a float64 copy of the port's
    refine net, on the port's frozen estimation of ``batch``."""
    b = _torch_batch(batch)
    with torch.no_grad():
        est = trainer._disparity_forward(dstate.net,
                                         resize_to_max(b["image"], 32))
    net = load_flax(Refine(), tree).double()
    d = net(b["image"].double(), est.double())
    gt, mask = b["disparity"].double(), b["mask"].double()
    loss = (0.0001 * compute_loss_ord(d, gt, mask, mode="L1")
            + compute_loss_grad(d, gt, mask))
    names, params = zip(*net.named_parameters())
    return dict(zip(names, torch.autograd.grad(loss, params)))


def test_refine_step_and_validation_match_jax(trees, trainers):
    tj, tt = trainers
    dj, rj = tj.init_state((H, W), "refine",
                           disparity_params=trees["disparity"],
                           refine_params=trees["refine"])
    dt, rt = tt.init_state((H, W), "refine",
                           disparity_params=trees["disparity"],
                           refine_params=trees["refine"])
    batch = _batch(3, H, W)
    rj2, mj = jax.jit(tj.refine_train_step)(dj, rj, _jax_batch(batch))
    rt, mt = tt.refine_train_step(dt, rt, _torch_batch(batch))
    assert rt.step == 1
    _losses_match(mt, mj)
    _d_grads_match(_named(rt.net, rt.opt_state["g"]),
                   state_dict_from_flax(rj2.opt_state["g"]),
                   _refine_grads_f64(tt, dt, trees["refine"], batch))
    # the disparity net is frozen in refine mode
    want = state_dict_from_flax(trees["disparity"])
    for k, v in dt.net.state_dict().items():
        assert torch.equal(v, want[k]), k

    _validation_match(tj.validation(dj, iter([batch]), rj),
                      tt.validation(dt, iter([batch]), rt))


def test_disparity_validation_matches_jax(trees, tmp_path):
    """Disparity-mode validation compares at 256: the estimation at the
    default ``estimation_size`` 512 has half of it, so the image is 8x64,
    resized to 64x512, its ground truth 4x32, resized to 32x256."""
    hp = {"model_to_train": "disparity", "disparity_rows": ROWS}
    tj = TDJ.TrainerDepth(hp, semantics_params=trees["semantics"],
                          logs_path=str(tmp_path / "jax"))
    tj.disparity = DisparityJ(rows=ROWS)
    tt = TDT.TrainerDepth(hp, semantics_params=trees["semantics"],
                          device="cpu", logs_path=str(tmp_path / "torch"))
    dj = tj.init_state((8, 64), disparity_params=trees["disparity"])
    dt = tt.init_state((8, 64), disparity_params=trees["disparity"])
    r = np.random.default_rng(4)
    batch = {"image": r.uniform(-1, 1, (2, 8, 64, 3)).astype(np.float32),
             "disparity": r.uniform(1, 60, (2, 4, 32, 1)).astype(
                 np.float32),
             "mask": (r.uniform(0, 1, (2, 4, 32, 1)) > 0.2).astype(
                 np.float32)}
    _validation_match(tj.validation(dj, iter([batch])),
                      tt.validation(dt, iter([batch])))


def _validation_match(want, got):
    assert set(got) == set(want) == set(DEPTH_METRIC_NAMES)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-4, abs=1e-7), k


def test_fresh_state_follows_the_init_selector(tmp_path):
    """Fresh nets: a Flax init, then xavier (gain 1.4) on every conv
    weight, the same from one seed; a 1-rank mesh (``data_mesh`` with no
    process group) gives the same state on its device."""
    tt = TDT.TrainerDepth({"disparity_rows": ROWS}, device="cpu",
                          logs_path=str(tmp_path / "a"))
    a = tt.init_state((H, W))
    b = tt.init_state((H, W))
    for (name, p), q in zip(a.net.named_parameters(), b.net.parameters()):
        assert torch.equal(p, q), name
    w = a.net.lattice.blk0x1.conv1.weight
    fan_in, fan_out = w[0].numel(), w.shape[0] * w[0, 0].numel()
    want = 1.4 * np.sqrt(2.0 / (fan_in + fan_out))
    assert abs(float(w.detach().std()) - want) / want < 0.1
    assert a.opt_state["count"] == 0 and a.step == 0
    tm = TDT.TrainerDepth({"disparity_rows": ROWS},
                          mesh=data_mesh(device="cpu"),
                          logs_path=str(tmp_path / "b"))
    assert tm.device == torch.device("cpu")
    for p, q in zip(a.net.parameters(), tm.init_state((H, W)).net
                    .parameters()):
        assert torch.equal(p, q)
