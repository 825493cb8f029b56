"""The splat's gradient with respect to the payload (CPU).

- The plain autograd of kbe_torch's ``render_pointcloud`` (``index_add_``)
  against ``jax.grad`` of kbe_tpu's XLA scatter spec, rtol 1e-5: the same
  products and quotients, the weight sums added in another order.
- ``splat_grad_plain`` against the plain autograd, and a numpy emulation of
  the ``splat_grad`` kernel's per-thread gather (project, four corners, z
  test, ``w_k * (g / (W + 1e-7))`` added NW, NE, SW, SE from zero, one f32
  rounding per operation, as the kernel's round-to-nearest intrinsics and
  ``-fmad=false``) against both: bit-equal.
- ``SplatFunction``, the card's autograd node, run on CPU tensors, whose
  forward and backward then take the plain versions: bit-equal to the
  plain autograd.
- The points, the mask and the pose get no gradient: asking for one
  raises. A render under ``torch.inference_mode()`` is unchanged.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kbe_tpu.ops.splat import render_pointcloud as render_jax
from kbe_torch.ops import splat as S
from kbe_torch.ops.geometry import depth_to_points

H, W, FOCAL, BASELINE = 40, 56, 48.0, 25.0


def _cloud(c, seed, masked):
    """A wavy plane with a near box, shifted so some points leave the
    image, and a random fifth of the points masked out."""
    rng = np.random.default_rng(seed)
    yy = np.linspace(0, 1, H)[:, None]
    xx = np.linspace(0, 1, W)[None, :]
    depth = 150.0 + 20.0 * np.sin(5 * yy) + 10.0 * np.cos(7 * xx) + 0 * xx
    depth[10:22, 12:30] = 45.0
    xyz = depth_to_points(torch.as_tensor(depth, dtype=torch.float32),
                          FOCAL).numpy().reshape(-1, 3)
    xyz = xyz + np.array([6.3, -2.1, -12.0], np.float32)
    data = rng.uniform(-1, 1, (H * W, c)).astype(np.float32)
    valid = (rng.uniform(size=H * W) > 0.2).astype(np.float32)
    grad = rng.uniform(0, 1, (H, W, c)).astype(np.float32)
    return xyz.astype(np.float32), data, valid if masked else None, grad


def _torch_grad(xyz, data, valid, grad):
    payload = torch.as_tensor(data[None]).requires_grad_(True)
    rendered, existing = S.render_pointcloud(
        torch.as_tensor(xyz[None]), payload, H, W, FOCAL, BASELINE,
        valid=None if valid is None else torch.as_tensor(valid[None]))
    (rendered[0] * torch.as_tensor(grad)).sum().backward()
    return payload.grad[0], rendered[0].detach(), existing[0].detach()


@pytest.fixture(scope="module", params=[(4, True), (68, False)],
                ids=["c4_mask", "c68"])
def case(request):
    c, masked = request.param
    xyz, data, valid, grad = _cloud(c, c, masked)
    got, rendered, existing = _torch_grad(xyz, data, valid, grad)
    return dict(c=c, xyz=xyz, data=data, valid=valid, grad=grad, got=got,
                rendered=rendered, existing=existing)


def test_plain_autograd_matches_jax_grad(case):
    xyz, data, valid, grad = (case[k] for k in ("xyz", "data", "valid",
                                                "grad"))
    mask = None if valid is None else jnp.asarray(valid[None])

    def loss(d):
        r, _ = render_jax(jnp.asarray(xyz[None]), d, H, W, FOCAL, BASELINE,
                          valid=mask, method="scatter")
        return jnp.sum(r[0] * jnp.asarray(grad))

    want = np.asarray(jax.grad(loss)(jnp.asarray(data[None])))[0]
    got = case["got"].numpy()
    assert (got != 0).any(axis=1).mean() > 0.5
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def _pose():
    return S.make_pose(torch.zeros(3), FOCAL, BASELINE)


def _saved(case):
    xyz = torch.as_tensor(case["xyz"])
    valid = None if case["valid"] is None else torch.as_tensor(case["valid"])
    pose = _pose()
    zee = S.degrid_plain(S.zee_plain(xyz, valid, pose, H, W))
    return xyz, valid, pose, zee


def test_splat_grad_plain_equals_autograd(case):
    xyz, valid, pose, zee = _saved(case)
    c = case["c"]
    got = S.splat_grad(xyz, valid, pose, zee, case["existing"].reshape(-1),
                       torch.as_tensor(case["grad"]).reshape(-1, c), H, W)
    assert torch.equal(got, case["got"])


def _emulate_kernel(xyz, valid, pose, zee, wsum, grad):
    """The ``splat_grad`` kernel's threads in numpy f32: for each point, the
    projection of ``project_at``, ``corner_weights`` and ``corner_pixel``,
    and the gather of its visible corners in NW, NE, SW, SE order."""
    f32 = np.float32
    sx, sy, sz, focal, fb = (f32(v) for v in pose)
    h, w = zee.shape
    zee, wsum = zee.reshape(-1), wsum.reshape(-1)
    out = np.zeros((xyz.shape[0], grad.shape[1]), f32)
    for i, (px, py, pz) in enumerate(xyz):
        x, y, z = f32(px + sx), f32(py + sy), f32(pz + sz)
        if not z >= f32(0.001) or (valid is not None and not valid[i] > 0):
            continue
        u = f32(f32(f32(f32(x * focal) / z) + f32(0.5 * w)) - f32(0.5))
        v = f32(f32(f32(f32(y * focal) / z) + f32(0.5 * h)) - f32(0.5))
        err = f32(f32(1e6) - f32(fb / f32(z + f32(1e-7))))
        x0, y0 = np.floor(u), np.floor(v)
        ax, bx = f32(f32(x0 + f32(1)) - u), f32(u - x0)
        ay, by = f32(f32(y0 + f32(1)) - v), f32(v - y0)
        weights = (f32(ax * ay), f32(bx * ay), f32(ax * by), f32(bx * by))
        acc = np.zeros(grad.shape[1], f32)
        for k in range(4):
            cx, cy = f32(x0 + f32(k & 1)), f32(y0 + f32(k >> 1))
            if not (0 <= cx < w and 0 <= cy < h):
                continue
            pix = int(cy) * w + int(cx)
            if not err <= f32(zee[pix] + f32(1)):
                continue
            denom = f32(wsum[pix] + f32(1e-7))
            acc = (acc + weights[k] * (grad[pix] / denom)).astype(f32)
        out[i] = acc
    return out


def test_kernel_emulation_equals_autograd(case):
    xyz, valid, pose, zee = _saved(case)
    c = case["c"]
    got = _emulate_kernel(case["xyz"], case["valid"], pose.numpy(),
                          zee.numpy(), case["existing"].numpy(),
                          case["grad"].reshape(-1, c))
    np.testing.assert_array_equal(got, case["got"].numpy())


def test_splat_function_on_cpu_equals_autograd(case):
    xyz, valid, pose, _ = _saved(case)
    payload = torch.as_tensor(case["data"]).requires_grad_(True)
    rendered, existing = S.SplatFunction.apply(payload, xyz, valid, pose, H,
                                               W)
    assert not existing.requires_grad
    assert torch.equal(rendered.reshape(H, W, -1), case["rendered"])
    assert torch.equal(existing.reshape(H, W, 1), case["existing"])
    (rendered.reshape(H, W, -1) * torch.as_tensor(case["grad"])).sum() \
        .backward()
    assert torch.equal(payload.grad, case["got"])


@pytest.mark.parametrize("which", ["xyz", "valid", "pose"])
def test_geometry_gradient_raises(which):
    xyz, data, valid, _ = _cloud(4, 1, True)
    args = {"xyz": torch.as_tensor(xyz), "valid": torch.as_tensor(valid),
            "pose": _pose()}
    args[which] = args[which].clone().requires_grad_(True)
    with pytest.raises(ValueError, match="payload"):
        S.splat(args["xyz"], torch.as_tensor(data), args["valid"],
                args["pose"], H, W)


def test_inference_mode_render_unchanged():
    xyz, data, valid, _ = _cloud(68, 2, True)
    args = (torch.as_tensor(xyz), torch.as_tensor(data),
            torch.as_tensor(valid), _pose(), H, W)
    with torch.no_grad():
        want = S.splat(*args)
    with torch.inference_mode():
        got = S.splat(*args)
    assert not got[0].requires_grad
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    payload = args[1].clone().requires_grad_(True)
    rendered, existing = S.splat(args[0], payload, *args[2:])
    assert torch.equal(rendered.detach(), want[0])
    assert torch.equal(existing.detach(), want[1])
