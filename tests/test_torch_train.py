"""kbe_torch's inpainting trainer against kbe_tpu's on the CPU, from the
same converted parameters and the same synthetic batch.

- The optimizer against ``optax.chain(clip_by_global_norm(1), adam(lr0 *
  gamma^count))`` over 3 steps on the same gradients (one clipped, one
  not), atol 1e-7.
- One supervised step (48x64, a narrow grid-net) and one adversarial G+D
  step (288^2, the discriminator's smallest size, a narrow grid-net and the
  full MPD discriminator with spectral norm): both trainers' optimizers are
  swapped for one that records the gradients it is given, so each side's
  own step code computes them. The loss dicts agree to rtol 1e-4, and each
  gradient leaf of G to a relative L2 error of 1e-3 (the warped view is
  held to atol 2e-4, convolutions sum in other orders, and both feed a
  backward pass); D's leaves as ``_d_grads_match`` says. After the D step, the discriminator's batch norm and spectral norm
  state agrees with Flax's ``batch_stats`` to rtol 1e-4, atol 1e-5.

One entry is held to rtol 1e-3: the adversarial ``mask`` loss. Its
region is the reference's ``gaussian_blur(mask) < 1.0``, a test at the f32
rounding of 1.0, which XLA's convolution decides by its own order of sums;
the port decides it without rounding noise (``kbe_torch.train.losses``),
and the two disagree on about 10 of the 82,944 pixels here, where a hole
weighs 1-2 ulps of 1.0 in the window.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kbe_tpu.config import CameraConfig as CameraJ
from kbe_tpu.models import Inpaint as InpaintJ
from kbe_tpu.models.discriminator import MPDDiscriminator as MPDJ
from kbe_tpu.models.gridnet import ContextNet as ContextJ
from kbe_tpu.train import trainer_depth as TDJ
from kbe_tpu.train import trainer_inpaint as TIJ
from kbe_torch.config import CameraConfig
from kbe_torch.models import discriminator as DT
from kbe_torch.train import trainer_depth as TDT
from kbe_torch.train import trainer_inpaint as TIT
from kbe_torch.train.data import synthetic_batches
from kbe_torch.utils.convert import state_dict_from_flax
from tests.test_torch_discriminator import random_variables
from tests.test_torch_models import random_params

ROWS = (8, 16)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The Tier-1 run has six worker processes on the CPU: one thread for
    this file's convolutions keeps them from oversubscribing the cores
    that the other workers' tests run on."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_optimizer_matches_optax():
    rng = np.random.default_rng(0)
    shapes = [(3, 3, 4, 5), (5,), (7, 2)]
    params = [rng.normal(0, 1, s).astype(np.float32) for s in shapes]
    # the first step's norm is above the clip, the others below it
    grads = [[rng.normal(0, scale, s).astype(np.float32) for s in shapes]
             for scale in (2.0, 0.05, 0.01)]
    tx = TDJ.make_optimizer(1e-2, 0.9)
    pj = [jnp.asarray(p) for p in params]
    state = tx.init(pj)
    opt = TDT.make_optimizer(1e-2, 0.9)
    pt = [torch.as_tensor(p) for p in params]
    st = opt.init(pt)
    for g in grads:
        upd, state = tx.update([jnp.asarray(x) for x in g], state, pj)
        pj = optax.apply_updates(pj, upd)
        st = opt.step(pt, [torch.as_tensor(x) for x in g], st)
        for a, b in zip(pt, pj):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-7)
    assert st["count"] == 3


def _capture_jax(inner=None):
    """Records the gradients it is given in its state; passes them on to
    ``inner`` (then the parameters move) or returns zero updates."""
    def init(params):
        return {"g": jax.tree_util.tree_map(jnp.zeros_like, params),
                "inner": () if inner is None else inner.init(params)}

    def update(updates, state, params=None):
        if inner is None:
            return (jax.tree_util.tree_map(jnp.zeros_like, updates),
                    {"g": updates, "inner": ()})
        out, inner_state = inner.update(updates, state["inner"], params)
        return out, {"g": updates, "inner": inner_state}

    return optax.GradientTransformation(init, update)


class _CaptureTorch:
    """The port's counterpart of ``_capture_jax``."""

    def __init__(self, inner=None):
        self.inner = inner

    def init(self, params):
        return {"count": 0, "mu": [], "nu": [], "g": None,
                "inner": None if self.inner is None
                else self.inner.init(params)}

    def step(self, params, grads, state):
        state = dict(state, g=[g.detach().clone() for g in grads])
        if self.inner is not None:
            state["inner"] = self.inner.step(params, grads, state["inner"])
        return state


def _jax_batch(batch):
    return jax.tree_util.tree_map(jnp.asarray, batch)


def _torch_batch(batch):
    return TIT.to_device(batch, "cpu")


def _rel_l2(got, want):
    num = float(torch.linalg.vector_norm(got - want))
    den = float(torch.linalg.vector_norm(want))
    return num / den if den > 0 else num


def _grads_match(named_grads, flax_grads, tol=1e-3):
    want = state_dict_from_flax(flax_grads)
    assert set(named_grads) == set(want)
    worst = max((_rel_l2(named_grads[k], want[k]), k) for k in want)
    assert worst[0] <= tol, worst


def _d_grads_f64(variables, out, names):
    """D's gradients from a float64 copy of the port's discriminator, on
    the same inputs: the referee of the leaves where two f32 runs part."""
    disc = DT.MPDDiscriminator(spectral_norm=True)
    disc.load_state_dict(state_dict_from_flax(variables))
    disc = disc.double()
    o = {k: v.double() for k, v in out.items()}
    fake = disc(o["inpaint_img"], o["inpaint_disp"], train=True)
    real = disc(o["image_a"], o["disp_a"], train=True)
    loss = 0.5 * (DT.adversarial_loss(fake, False)
                  + DT.adversarial_loss(real, True))
    params = dict(disc.named_parameters())
    grads = torch.autograd.grad(loss, [params[n] for n in names])
    return dict(zip(names, grads))


def _d_grads_match(got, want, f64):
    """Each D leaf within 1e-3 of JAX's, or, where the two f32 runs part
    further, both within 3e-3 of the float64 run: the batch norms' sums
    over the two passes cancel heavily, and each f32 run loses digits on
    its own leaves (the port ~2.5e-3 on one, JAX ~1.2e-3 on another, on
    this batch). A conv bias before a train-mode batch norm has gradient 0
    in exact arithmetic: both runs must keep it below 1e-6 of the largest
    leaf's norm."""
    assert set(got) == set(want) == set(f64)
    norm = lambda t: float(torch.linalg.vector_norm(t.double()))
    top = max(norm(v) for v in f64.values())
    for k in want:
        if norm(f64[k]) <= 1e-6 * top:
            assert max(norm(got[k]), norm(want[k])) <= 1e-6 * top, k
        elif _rel_l2(got[k], want[k]) > 1e-3:
            assert _rel_l2(got[k].double(), f64[k]) <= 3e-3, k
            assert _rel_l2(want[k].double(), f64[k]) <= 3e-3, k


def _losses_match(got, want, rtols=None):
    assert set(got) == set(want)
    for k in want:
        rel = (rtols or {}).get(k, 1e-4)
        assert float(got[k]) == pytest.approx(float(want[k]), rel=rel,
                                              abs=1e-7), k


def _g_params(h, w, seed):
    zi = np.zeros((1, h, w, 3), np.float32)
    zd = np.zeros((1, h, w, 1), np.float32)
    ctx = random_params(ContextJ(), zi, zd, seed=seed)
    net = random_params(InpaintJ(rows=ROWS),
                        np.zeros((1, h, w, 68), np.float32), zd,
                        seed=seed + 1)
    # Flax variable trees, {"params": ...}, as the JAX trainer keeps them
    return {"context": flax.core.unfreeze(ctx),
            "net": flax.core.unfreeze(net)}


def _named(state, grads):
    names = ([f"context.{n}" for n, _ in state.context.named_parameters()]
             + [f"net.{n}" for n, _ in state.net.named_parameters()])
    return dict(zip(names, grads))


def _trainers(tmp_path, hparams, cam, g_lr=None):
    """Both trainers with recording optimizers; with ``g_lr`` G's also
    applies Adam at that rate (D's never moves)."""
    tj = TIJ.TrainerInpaint(hparams, camera=CameraJ(*cam),
                            logs_path=str(tmp_path / "jax"))
    tt = TIT.TrainerInpaint(dict(hparams, inpaint_rows=ROWS),
                            camera=CameraConfig(*cam), device="cpu",
                            logs_path=str(tmp_path / "torch"))
    tj.net_def = InpaintJ(rows=ROWS)
    tj.tx_d, tt.tx_d = _capture_jax(), _CaptureTorch()
    if g_lr is None:
        tj.tx, tt.tx = _capture_jax(), _CaptureTorch()
    else:
        tj.tx = _capture_jax(TDJ.make_optimizer(g_lr, 0.99997))
        tt.tx = _CaptureTorch(TDT.make_optimizer(g_lr, 0.99997))
    return tj, tt


def test_supervised_step_matches_jax(tmp_path):
    h, w, cam = 48, 64, (64.0, 30.0)
    tj, tt = _trainers(tmp_path, {"model_to_train": "inpainting"}, cam)
    params = _g_params(h, w, seed=10)
    batch = next(synthetic_batches(2, h, w, mode="inpainting",
                                   camera=CameraConfig(*cam), seed=5))
    sj = TIJ.InpaintState(params["context"], params["net"],
                          tj.tx.init(params), jnp.zeros((), jnp.int32))
    sj, mj = jax.jit(tj.supervised_step)(sj, _jax_batch(batch))
    st = tt.init_state((h, w), params)
    st, mt = tt.supervised_step(st, _torch_batch(batch))
    assert st.step == 1
    # no VGG16 given, as cli/train.py gives none: no perceptual or style
    assert "prc" not in mt and "style" not in mt
    _losses_match(mt, mj)
    named = _named(st, st.opt_state["g"])
    gj = sj.opt_state["g"]
    _grads_match({k[8:]: v for k, v in named.items()
                  if k.startswith("context.")}, gj["context"])
    _grads_match({k[4:]: v for k, v in named.items()
                  if k.startswith("net.")}, gj["net"])


def test_adversarial_step_matches_jax(tmp_path):
    """G's optimizer applies Adam at lr 1e-2, large enough that fakes made
    after G's update would move D's gradients far beyond the bar: D's
    gradients agreeing with JAX's shows D trained on the fakes of the G
    before its update. The G loss leaves no gradient in D (no ``.grad``
    anywhere: each step differentiates its own parameters), and D's VGG16
    stays frozen."""
    h = w = 288
    cam = (256.0, 60.0)
    tj, tt = _trainers(tmp_path, {"model_to_train": "inpainting",
                                  "adversarial": True}, cam, g_lr=1e-2)
    params = _g_params(h, w, seed=20)
    img = np.zeros((1, h, w, 3), np.float32)
    variables = random_variables(MPDJ(spectral_norm=True), img,
                                 img[..., :1], train=True, seed=21)
    batch = next(synthetic_batches(1, h, w, mode="inpainting",
                                   camera=CameraConfig(*cam), seed=6))

    gj = TIJ.InpaintState(params["context"], params["net"],
                          tj.tx.init(params), jnp.zeros((), jnp.int32))
    _, trainable = tj._split_disc_params(variables["params"])
    dj = TIJ.DiscState(variables, tj.tx_d.init(trainable),
                       jnp.zeros((), jnp.int32))
    step = jax.jit(tj.adversarial_step, static_argnums=(3,))
    gj, dj, mj = step(gj, dj, _jax_batch(batch), True)

    gt = tt.init_state((h, w), params)
    dt = tt.init_disc_state((h, w))
    dt.disc.load_state_dict(state_dict_from_flax(variables))
    with torch.no_grad():  # the fakes of the G before its update
        out = tt._adv_forward(gt.context, gt.net, _torch_batch(batch))
    g0 = [p.detach().clone() for p in gt.parameters()]
    vgg0 = [p.detach().clone() for p in dt.disc.core.vgg.parameters()]
    gt, dt, mt = tt.adversarial_step(gt, dt, _torch_batch(batch), True)
    assert (gt.step, dt.step) == (1, 1)
    _losses_match(mt, mj, rtols={"mask": 1e-3})
    assert all(p.grad is None for p in gt.parameters())
    assert all(p.grad is None for p in dt.disc.parameters())
    assert any(not torch.equal(a, p) for a, p in zip(g0, gt.parameters()))
    assert not any(p.requires_grad for p in dt.disc.core.vgg.parameters())
    assert all(torch.equal(a, p) for a, p in
               zip(vgg0, dt.disc.core.vgg.parameters()))

    named = _named(gt, gt.opt_state["g"])
    _grads_match({k[8:]: v for k, v in named.items()
                  if k.startswith("context.")}, gj.opt_state["g"]["context"])
    _grads_match({k[4:]: v for k, v in named.items()
                  if k.startswith("net.")}, gj.opt_state["g"]["net"])
    d_names = [n for n, _ in dt.disc.named_parameters()
               if not n.startswith("core.vgg.")]
    _d_grads_match(dict(zip(d_names, dt.opt_state["g"])),
                   state_dict_from_flax(flax.core.unfreeze(
                       dj.opt_state["g"])),
                   _d_grads_f64(variables, out, d_names))
    # the batch norms and spectral norms after the fake and the real pass
    sd = dt.disc.state_dict()
    stats = state_dict_from_flax(
        {"params": {}, "batch_stats": flax.core.unfreeze(
            dj.variables["batch_stats"])})
    for name, value in stats.items():
        np.testing.assert_allclose(sd[name].numpy(), value.numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=name)

