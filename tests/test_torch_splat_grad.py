"""The splat's gradient with respect to the payload (CPU).

- The plain autograd of kbe_torch's ``render_pointcloud`` (``index_add_``)
  against ``jax.grad`` of kbe_tpu's XLA scatter spec, rtol 1e-5: the same
  products and quotients, the weight sums added in another order.
- ``splat_grad_plain`` against the plain autograd, and a numpy emulation of
  the ``splat_grad`` kernel (a tile of points a block: each point projected
  once, its visible corners' pixels, weights, ``d = W + 1e-7`` and
  ``RN(1/d)`` kept; then a (point, four channels) pair a thread adding
  ``w_k * (g / d)`` NW, NE, SW, SE from zero, the quotient by a multiply
  and two FMA corrections in the normal range and an IEEE division
  outside it, one f32 rounding per operation, as the kernel's
  round-to-nearest intrinsics and ``-fmad=false``) against both:
  bit-equal, also on edge gradients (zeros, subnormals, huge values) and
  on pixels whose weight sum is 0. The quotient route alone against the
  IEEE division on adversarial denominators.
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

from chip_smoke import edge_upstream
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


def _fma32(a, b, c):
    """f32 ``fma(a, b, c)``, one rounding of the exact ``a * b + c``: the
    product is exact in f64, TwoSum gives the f64 sum's error, and where
    the f64 sum sits on an f32 rounding midpoint the error says which way
    the exact value lies (elsewhere the f64 sum rounds as it does)."""
    a, b, c = (np.asarray(x, np.float64) for x in (a, b, c))
    with np.errstate(all="ignore"):  # inf and NaN where the route is off
        p = a * b
        s = p + c
        t = s - p
        e = (p - (s - t)) + (c - t)
        r = s.astype(np.float32)
        toward = np.nextafter(r, np.where(s > r, np.float32(np.inf),
                                          np.float32(-np.inf)))
        mid = (r.astype(np.float64) + toward.astype(np.float64)) / 2
    tie = (s == mid) & (e != 0)
    up = np.maximum(r, toward)
    down = np.minimum(r, toward)
    return np.where(tie, np.where(e > 0, up, down), r).astype(np.float32)


def _quotient(g, d, r):
    """The kernel's ``quotients`` a channel: ``g / d`` from ``r = RN(1/d)``
    by a multiply and two FMA corrections where d is in [2^-24, 2^24] and
    |g| in [2^-60, 2^60], an IEEE division elsewhere. Returns it and the
    route's mask."""
    f32 = np.float32
    g, d, r = (np.asarray(x, f32) for x in (g, d, r))
    a = np.abs(g)
    fast = ((d >= f32(2.0 ** -24)) & (d <= f32(2.0 ** 24))
            & (a >= f32(2.0 ** -60)) & (a <= f32(2.0 ** 60)))
    with np.errstate(all="ignore"):
        q0 = (g.astype(np.float64) * r.astype(np.float64)).astype(f32)
        q1 = _fma32(_fma32(-q0, d, g), r, q0)
        q2 = _fma32(_fma32(-q1, d, g), r, q1)
        return np.where(fast, q2, g / d), fast


GRAD_POINTS, THREADS, GROUP = 128, 256, 4   # the kernel's tile and block


def _emulate_kernel(xyz, valid, pose, zee, wsum, grad):
    """The ``splat_grad`` kernel in numpy f32. Phase 1, a thread a point:
    the projection of ``project_at``, ``corner_weights`` and
    ``corner_pixel``, the z test, each visible corner's pixel, weight,
    ``d = W + 1e-7`` and ``r = RN(1/d)``. Phase 2, a tile's threads over
    its (point, group of four channels) pairs: ``w_k * quotient(g, d, r)``
    added over the visible corners in NW, NE, SW, SE order from +0.0."""
    f32 = np.float32
    sx, sy, sz, focal, fb = (f32(v) for v in pose)
    h, w = zee.shape
    zee, wsum = zee.reshape(-1), wsum.reshape(-1)
    n, c = xyz.shape[0], grad.shape[1]
    pix = np.full((n, 4), -1, np.int64)
    wts = np.zeros((n, 4), f32)
    dd = np.ones((n, 4), f32)
    rr = np.ones((n, 4), f32)
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
        wts[i] = (f32(ax * ay), f32(bx * ay), f32(ax * by), f32(bx * by))
        for k in range(4):
            cx, cy = f32(x0 + f32(k & 1)), f32(y0 + f32(k >> 1))
            if not (0 <= cx < w and 0 <= cy < h):
                continue
            p = int(cy) * w + int(cx)
            if not err <= f32(zee[p] + f32(1)):
                continue
            pix[i, k] = p
            dd[i, k] = f32(wsum[p] + f32(1e-7))
            rr[i, k] = f32(1) / dd[i, k]
    # phase 2: each (point, group) pair of a tile visited once
    groups = (c + GROUP - 1) // GROUP
    seen = np.zeros((n, groups), np.int64)
    dq, dgroup = divmod(THREADS, groups)
    for first in range(0, n, GRAD_POINTS):
        pts = min(GRAD_POINTS, n - first)
        for tid in range(THREADS):
            q, group = divmod(tid, groups)
            while q < pts:
                if group >= groups:
                    group -= groups
                    q += 1
                    if q >= pts:
                        break
                seen[first + q, group] += 1
                q, group = q + dq, group + dgroup
    assert (seen == 1).all()
    out = np.zeros((n, c), f32)
    pad = groups * GROUP - c
    for k in range(4):
        vis = pix[:, k] >= 0
        g = grad[pix[vis, k]]
        q, fast = _quotient(g, dd[vis, k][:, None], rr[vis, k][:, None])
        # one route for a corner's group of four channels (a channel past C
        # reads 0, outside the route)
        fast = np.pad(fast, ((0, 0), (0, pad))).reshape(-1, groups, GROUP)
        fast = np.repeat(fast.all(-1), GROUP, -1)[:, :c]
        with np.errstate(all="ignore"):
            q = np.where(fast, q, g / dd[vis, k][:, None])
        with np.errstate(over="ignore", invalid="ignore"):  # edge gradients
            out[vis] = out[vis] + wts[vis, k][:, None] * q
    return out


def test_kernel_emulation_equals_autograd(case):
    xyz, valid, pose, zee = _saved(case)
    c = case["c"]
    got = _emulate_kernel(case["xyz"], case["valid"], pose.numpy(),
                          zee.numpy(), case["existing"].numpy(),
                          case["grad"].reshape(-1, c))
    np.testing.assert_array_equal(got, case["got"].numpy())


def test_kernel_emulation_on_edge_gradients(case):
    """Edge gradients (``chip_smoke.edge_upstream``: zeros of both signs,
    subnormals, the route's bounds and their outer neighbours, quotients
    that overflow), and a fifth of the pixels with their weight sum
    zeroed (d = 1e-7, r = 1e7): the emulated kernel equals
    ``splat_grad_plain`` bit for bit, and on the true weight sums the
    CPU's autograd of the render too."""
    xyz, valid, pose, zee = _saved(case)
    c = case["c"]
    edge = edge_upstream((H * W, c), c).numpy()
    existing = case["existing"].numpy().reshape(-1).copy()
    args = (case["xyz"], case["valid"], pose.numpy(), zee.numpy())
    got = _emulate_kernel(*args, existing.reshape(H, W), edge)
    payload = torch.as_tensor(case["data"][None]).requires_grad_(True)
    rendered, _ = S.render_pointcloud(
        torch.as_tensor(case["xyz"][None]), payload, H, W, FOCAL, BASELINE,
        valid=None if valid is None else valid[None])
    (rendered[0] * torch.as_tensor(edge.reshape(H, W, c))).sum().backward()
    np.testing.assert_array_equal(got, payload.grad[0].numpy())
    existing[np.random.default_rng(c).uniform(size=H * W) < 0.2] = 0.0
    got = _emulate_kernel(*args, existing.reshape(H, W), edge)
    want = S.splat_grad_plain(xyz, valid, pose, zee,
                              torch.as_tensor(existing),
                              torch.as_tensor(edge), H, W)
    np.testing.assert_array_equal(got, want.numpy())
    assert np.isinf(got).any() and (got != 0).any()


def test_quotient_route_is_the_ieee_division():
    """The fast route's multiply and two FMA corrections against numpy's
    f32 division (IEEE, correctly rounded): every quotient equal, on
    denominators whose reciprocal lies within 2^-9 ulp of a rounding
    midpoint (where RN(g r) is off the most), on the 1e-7 of an empty
    pixel, and on numerators across the route's range."""
    f32 = np.float32
    rng = np.random.default_rng(0)
    d = rng.uniform(1, 2, 4_000_000).astype(f32)
    inv = 1.0 / d.astype(np.float64)
    r = inv.astype(f32)
    off = np.abs(r.astype(np.float64) - inv) / np.spacing(r)
    d = d[off > 0.498][:2000]
    d = np.concatenate([d, d * f32(2.0 ** -20), d * f32(2.0 ** 20),
                        [f32(1e-7), f32(2.0 ** -24), f32(2.0 ** 24)]])
    g = (rng.uniform(1, 2, (d.shape[0], 64))
         * 2.0 ** rng.integers(-60, 60, (d.shape[0], 64))
         * rng.choice([-1, 1], (d.shape[0], 64))).astype(f32)
    g[:, 0] = np.nextafter(f32(2.0), f32(0))    # significands near 2
    g[:, 1] = f32(2.0 ** -60)
    g[:, 2] = f32(2.0 ** 60)
    d = d[:, None]
    q, fast = _quotient(g, d, f32(1) / d)
    assert fast.all()
    np.testing.assert_array_equal(q, g / d)


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
