"""kbe_torch's splat (plain path, CPU) against kbe_tpu's XLA scatter spec
``render_pointcloud`` and the numpy simulator of the reference kernels.

Tolerance: atol 2e-4 on the rendered planes and the weights, the standard
the JAX package holds its own splat kernels to (tests/test_splat_posed.py).
"""

import numpy as np
import jax.numpy as jnp
import pytest
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


# ------------------------------------------- the order the card reproduces

def _entries(xyz, valid, pose, zee, h, w):
    """Per entry e = 4 i + k (numpy, (N*4,)): its pixel (-1 outside the
    image or for a point that is not ok), its weight, and whether it passes
    the z test, from the plain version's own projection."""
    u, v, err, ok = S._project(xyz, valid, pose, h, w)
    xi, yi, wt = S._neighbor_weights(u, v)
    flat, inb = S._flat_index(xi, yi, h, w, ok[:, None])
    zn = zee.reshape(-1)[flat.clamp(max=h * w - 1)]
    vis = inb & (err[:, None] <= zn + 1.0)
    pix = torch.where(inb, flat, torch.full_like(flat, -1))
    return (pix.reshape(-1).numpy(), wt.reshape(-1).numpy(),
            vis.reshape(-1).numpy())


def _ordered_sum(entry_ids, wt, vis, payload, rows):
    """Sum each row's visible entries in the given order, one f32 add at a
    time from +0.0; ``entry_ids[p]`` are the entries of pixel p."""
    c = payload.shape[1]
    out = np.zeros((rows, c + 1), np.float32)
    for p, ids in enumerate(entry_ids):
        for e in ids:
            if vis[e]:
                w = np.float32(wt[e])
                out[p, :c] = out[p, :c] + w * payload[e >> 2]
                out[p, c] = out[p, c] + w
    return out


def _collision_cloud(c, seed):
    """Two 20x24 grids whose points pile up: a third of them on a few
    pixels (segments of 30-200 entries), the rest spread, some invalid."""
    rng = np.random.default_rng(seed)
    h, w, focal = 20, 24, 32.0
    xyz, _, _ = _cloud(h, w, 2, c, seed, focal)
    pts = xyz.reshape(-1, 3).copy()
    pile = rng.uniform(size=len(pts)) < 0.3
    spot = rng.integers(0, 3, size=len(pts))
    z = pts[:, 2]
    pts[pile, 0] = (spot[pile] * 2.3 - 2.0) * z[pile] / focal
    pts[pile, 1] = (spot[pile] * 1.7 - 1.0) * z[pile] / focal
    valid = (rng.uniform(size=len(pts)) > 0.1).astype(np.float32)
    payload = rng.uniform(-1, 1, (len(pts), c)).astype(np.float32)
    pose = S.make_pose(torch.tensor([0.5, -0.25, 2.0]), focal, 20.0)
    t = (torch.as_tensor(pts), torch.as_tensor(valid),
         torch.as_tensor(payload), pose)
    zee = S.degrid_plain(S.zee_plain(t[0], t[1], pose, h, w))
    return t, zee, h, w


def test_accumulate_plain_sums_in_ascending_entry_order():
    """The plain version's index_add_ on the CPU sums each pixel's visible
    entries in ascending e = 4 i + k, from +0.0, one f32 add at a time:
    the order the card's sum pass reproduces."""
    (xyz, valid, payload, pose), zee, h, w = _collision_cloud(5, seed=2)
    pix, wt, vis = _entries(xyz, valid, pose, zee, h, w)
    segments = [np.flatnonzero(pix == p) for p in range(h * w)]
    assert max(len(s) for s in segments) > 32  # long segments too
    want = _ordered_sum(segments, wt, vis, payload.numpy(), h * w)
    got = S.accumulate_plain(xyz, valid, payload, pose, zee, h, w).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("c", [4, 68])
def test_count_scan_place_sort_sum_equals_plain(c):
    """The card's passes emulated in numpy: count each in-image corner that
    passes the z test per pixel, scan, place those entries in a shuffled
    order (the integer atomics' order is arbitrary), sort each segment,
    sum in that order. Bit-equal to ``accumulate_plain``, rendered planes
    too."""
    (xyz, valid, payload, pose), zee, h, w = _collision_cloud(c, seed=c)
    pix, wt, vis = _entries(xyz, valid, pose, zee, h, w)
    counted = (pix >= 0) & vis
    counts = np.bincount(pix[counted], minlength=h * w)
    ends = np.cumsum(counts)
    ids = np.full(counted.sum(), -1)
    cursor = ends.copy()
    for e in np.random.default_rng(c).permutation(np.flatnonzero(counted)):
        cursor[pix[e]] -= 1
        ids[cursor[pix[e]]] = e
    assert (ids >= 0).all() and np.array_equal(cursor, ends - counts)
    segments = [np.sort(ids[s:s + n]) for s, n in zip(cursor, counts)]
    got = _ordered_sum(segments, wt, vis, payload.numpy(), h * w)
    want = S.accumulate_plain(xyz, valid, payload, pose, zee, h, w)
    np.testing.assert_array_equal(got.view(np.int32),
                                  want.numpy().view(np.int32))
    # the sum pass's normalisation, as splat divides
    got_r = torch.as_tensor(got[:, :c]) / (torch.as_tensor(got[:, c:])
                                           + 1e-7)
    want_r, want_e = S.splat(xyz, payload, valid, pose, h, w)
    assert torch.equal(got_r.reshape(h, w, c), want_r)
    assert torch.equal(torch.as_tensor(got[:, c:]).reshape(h, w, 1), want_e)
