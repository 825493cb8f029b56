"""kbe_torch's splat (plain path, CPU) against kbe_tpu's XLA scatter spec
``render_pointcloud`` and the numpy simulator of the reference kernels.

Tolerance: atol 2e-4 on the rendered planes and the weights, the standard
the JAX package holds its own splat kernels to (tests/test_splat_posed.py).
"""

import numpy as np
import jax.numpy as jnp
import torch

from kbe_tpu.ops.geometry import apply_shift as apply_shift_jax
from kbe_tpu.ops.splat import render_pointcloud as render_jax
from kbe_torch.ops import splat as S
from kbe_torch.ops.geometry import depth_to_points
from tests.reference_sim import render_pointcloud_sim

ATOL = 2e-4


def _cloud(h, w, grids, c, seed, focal):
    """Grid clouds: a wavy background plane, a near box, and grids after
    the first valid on a random ~60%."""
    rng = np.random.default_rng(seed)
    yy = np.linspace(0, 1, h)[:, None]
    xx = np.linspace(0, 1, w)[None, :]
    xyz, valid = [], []
    for g in range(grids):
        depth = 200.0 + 30.0 * np.sin(6 * yy) + 10.0 * np.cos(9 * xx) \
            + 0.0 * xx
        if g == 0:
            depth[h // 4:h // 2, w // 4:w // 2] = 60.0
            valid.append(np.ones((h, w)))
        else:
            depth = depth * (1.0 + 0.1 * g)
            valid.append(rng.uniform(size=(h, w)) > 0.4)
        xyz.append(depth_to_points(torch.as_tensor(depth, dtype=torch.float32),
                                   focal).numpy())
    data = rng.uniform(0, 1, (grids, h, w, c)).astype(np.float32)
    return (np.stack(xyz).astype(np.float32), data,
            np.stack(valid).astype(np.float32))


def _jax_render(xyz, data, valid, h, w, focal, baseline):
    g = xyz.shape[0]
    r, e = render_jax(jnp.asarray(xyz.reshape(1, -1, 3)),
                      jnp.asarray(data.reshape(1, g * h * w, -1)), h, w,
                      focal, baseline,
                      valid=jnp.asarray(valid.reshape(1, -1)),
                      method="scatter")
    return np.asarray(r[0]), np.asarray(e[0])


def test_posed_splat_c4_three_grids_matches_spec():
    h, w, focal, baseline = 48, 64, 64.0, 20.0
    xyz, data, valid = _cloud(h, w, 3, 4, 0, focal)
    scene = S.prepare_scene(torch.as_tensor(xyz), torch.as_tensor(data),
                            torch.as_tensor(valid))
    holes = []
    for shift in ((0.0, 0.0, 0.0), (3.5, -2.25, 0.0), (-6.0, 4.0, 18.0),
                  (1.0, 1.0, -22.0)):
        sh = np.asarray(shift, np.float32)
        shifted = np.asarray(apply_shift_jax(jnp.asarray(xyz),
                                             jnp.asarray(sh)))
        want_r, want_e = _jax_render(shifted, data, valid, h, w, focal,
                                     baseline)
        pose = S.make_pose(torch.as_tensor(sh), focal, baseline)
        got_r, got_e = S.render_posed(scene, pose, h, w)
        np.testing.assert_allclose(got_r.numpy(), want_r, atol=ATOL)
        np.testing.assert_allclose(got_e.numpy(), want_e, atol=ATOL)
        holes.append(bool((want_e == 0).any()))
    assert any(holes)  # the shifted poses disocclude the background


def test_splat_c68_matches_spec():
    h, w, focal, baseline = 40, 56, 48.0, 30.0
    xyz, data, valid = _cloud(h, w, 1, 68, 1, focal)
    shift = np.asarray((2.0, -1.5, 5.0), np.float32)
    pts = (xyz + shift).reshape(1, -1, 3)
    want_r, want_e = render_jax(jnp.asarray(pts),
                                jnp.asarray(data.reshape(1, -1, 68)), h, w,
                                focal, baseline, method="scatter")
    got_r, got_e = S.render_pointcloud(torch.as_tensor(pts),
                                       torch.as_tensor(data.reshape(1, -1,
                                                                    68)),
                                       h, w, focal, baseline)
    np.testing.assert_allclose(got_r.numpy(), np.asarray(want_r), atol=ATOL)
    np.testing.assert_allclose(got_e.numpy(), np.asarray(want_e), atol=ATOL)


def test_negative_keys_and_corner_ties():
    """Points nearer than f*b/1e6 have negative z keys and must still win
    the z test; points at exact half-pixel positions tie all four corner
    weights (NW must win), and points on pixel centers tie NW/NE or NW/SW."""
    h, w, focal, baseline = 16, 16, 16.0, 100.0  # f*b/1e6 = 0.0016
    pts, data = [], []
    rng = np.random.default_rng(3)
    for i in range(h * w):
        y, x = divmod(i, w)
        z = 0.0012 if (x + y) % 3 == 0 else 50.0   # negative key: z < 0.0016
        u = x + (0.5 if (x + y) % 2 else 0.0)
        v = y + (0.5 if x % 2 else 0.0)
        pts.append(((u - w / 2 + 0.5) * z / focal,
                    (v - h / 2 + 0.5) * z / focal, z))
        data.append(rng.uniform(0, 1, 3))
    pts = np.asarray(pts, np.float32)[None]
    data = np.asarray(data, np.float32)[None]
    err = 1e6 - focal * baseline / (pts[0, :, 2] + 1e-7)
    assert (err < 0).any()
    want_r, want_e = render_jax(jnp.asarray(pts), jnp.asarray(data), h, w,
                                focal, baseline, method="scatter")
    got_r, got_e = S.render_pointcloud(torch.as_tensor(pts),
                                       torch.as_tensor(data), h, w, focal,
                                       baseline)
    np.testing.assert_allclose(got_r.numpy(), np.asarray(want_r), atol=ATOL)
    np.testing.assert_allclose(got_e.numpy(), np.asarray(want_e), atol=ATOL)
    zee = S.zee_plain(torch.as_tensor(pts[0]), torch.ones(h * w),
                      S.make_pose(torch.zeros(3), focal, baseline), h, w)
    assert (zee < 0).any()


def test_splat_matches_reference_simulator():
    h, w, focal, baseline = 12, 16, 20.0, 10.0
    xyz, data, _ = _cloud(h, w, 1, 3, 4, focal)
    pts = xyz.reshape(-1, 3) + np.asarray((0.7, -0.4, 3.0), np.float32)
    dat = data.reshape(-1, 3)
    want_r, want_e = render_pointcloud_sim(pts, dat, h, w, focal, baseline)
    got_r, got_e = S.render_pointcloud(torch.as_tensor(pts)[None],
                                       torch.as_tensor(dat)[None], h, w,
                                       focal, baseline)
    np.testing.assert_allclose(got_r[0].numpy(),
                               np.transpose(want_r, (1, 2, 0)), atol=ATOL)
    np.testing.assert_allclose(got_e[0, ..., 0].numpy(), want_e, atol=ATOL)


def test_decode_keys_inverts_the_order_preserving_encoding():
    vals = np.asarray([-3e5, -1.0, -0.0, 0.0, 1e-30, 2.5, 1e6], np.float32)
    bits = vals.view(np.int32)
    keys = np.where(bits < 0, bits ^ 0x7fffffff, bits).astype(np.int32)
    assert np.all(np.diff(keys[[0, 1, 3, 4, 5, 6]]) > 0)
    back = S.decode_keys(torch.as_tensor(keys)).numpy()
    np.testing.assert_array_equal(back.view(np.int32), bits)
    assert S._ZFAR_KEY == int(np.float32(1e6).view(np.int32))
