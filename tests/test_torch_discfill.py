"""kbe_torch's disocclusion fill (plain path, CPU) against kbe_tpu's
``fill_disocclusion``: bit-exact, on sparse and dense holes, K=16 and K=128,
holes wider than 16 pixels, and the ROI variant."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from kbe_tpu.ops.discfill import _offset_tables as tables_jax
from kbe_tpu.ops.discfill import fill_disocclusion as fill_jax
from kbe_torch.ops import discfill as D
from tests.reference_sim import fill_disocclusion_sim


def _frame(h, w, c, hole_frac, seed, band=0):
    rng = np.random.default_rng(seed)
    image = rng.uniform(0, 1, (1, h, w, c)).astype(np.float32)
    depth = rng.uniform(1, 100, (1, h, w, 1)).astype(np.float32)
    depth[rng.uniform(size=(1, h, w, 1)) < hole_frac] = 0.0
    if band:  # a hole wider than the K=16 march
        depth[:, h // 4:h // 4 + 8, w // 3:w // 3 + band] = 0.0
    image[..., -1:] = depth
    return image, depth


def _both(image, depth, steps, roi=None):
    want = np.asarray(fill_jax(jnp.asarray(image), jnp.asarray(depth),
                               steps))
    got = D.fill_disocclusion(torch.as_tensor(image), torch.as_tensor(depth),
                              steps, roi).numpy()
    return got, want


def test_offset_tables_match_jax():
    for steps in (16, 128):
        for a, b in zip(D._offset_tables(steps), tables_jax(steps)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("hole_frac,steps,band", [
    (0.05, 16, 0),     # sparse holes
    (0.6, 16, 24),     # dense holes, a band wider than K
    (0.3, 128, 40),    # K=128 reaches across the band
])
def test_fill_bit_exact(hole_frac, steps, band):
    image, depth = _frame(40, 72, 4, hole_frac, seed=int(hole_frac * 100),
                          band=band)
    got, want = _both(image, depth, steps)
    np.testing.assert_array_equal(got, want)
    changed = (got != image).any(-1)
    assert changed.any()
    if band and steps == 16:
        # the band's middle is beyond a 16-step march in every direction
        # that crosses it, and stays as it was wherever the JAX fill left it
        assert (got[depth[..., 0] <= 0] == image[depth[..., 0] <= 0]).any()


def test_fill_roi_inside_equal_outside_untouched():
    image, depth = _frame(48, 64, 4, 0.3, seed=7)
    roi = (5, 40, 9, 50)
    got, want = _both(image, depth, 128, roi)
    y0, y1, x0, x1 = roi
    np.testing.assert_array_equal(got[:, y0:y1, x0:x1],
                                  want[:, y0:y1, x0:x1])
    outside = np.ones(got.shape[:3], bool)
    outside[:, y0:y1, x0:x1] = False
    np.testing.assert_array_equal(got[outside], image[outside])


def test_fill_matches_reference_simulator():
    image, depth = _frame(14, 18, 3, 0.35, seed=11)
    got = D.fill_disocclusion(torch.as_tensor(image), torch.as_tensor(depth),
                              64).numpy()
    want = fill_disocclusion_sim(np.transpose(image[0], (2, 0, 1)),
                                 depth[0, ..., 0])
    np.testing.assert_array_equal(got[0], np.transpose(want, (1, 2, 0)))


# ------------------------------ the card's lockstep march and its early stop

SLACK = np.float32(1.4153)  # csrc/discfill.cu kSlack: sqrt(2) + 1e-3
ROUND = 8                   # csrc/discfill.cu kRound: steps between checks
MARCH, HIT, FAIL = 0, 1, 2


def test_stop_rule_bound_holds_over_the_tables():
    """Every direction, every pair of ray lengths kt, kf <= 256: the f32
    endpoint distance is >= kt + kf - kSlack, the bound the kernel's early
    stop drops a direction by."""
    ox, oy = D._offset_tables(256)
    k = np.arange(1, 257)
    worst = 0.0
    for d in range(16):
        ddx = (ox[d][:, None] - ox[d + 16][None, :]).astype(np.float32)
        ddy = (oy[d][:, None] - oy[d + 16][None, :]).astype(np.float32)
        dist = np.sqrt(ddx * ddx + ddy * ddy)
        lengths = (k[:, None] + k[None, :]).astype(np.float32)
        assert (dist >= lengths - SLACK).all(), d
        worst = max(worst, float((lengths - dist).max()))
    assert 1.40 < worst < 1.4143  # the margin is small but positive


def _lockstep_fill(image, depth, steps, roi=None):
    """numpy emulation of the kernel: for each hole pixel in the ROI, the 32
    rays march in lockstep; after every ``ROUND`` steps a pair stops once
    it is dead, complete, or bounded strictly above the best complete
    distance; the march ends when no pair is left. Returns (out, ray steps
    taken)."""
    h, w, c = image.shape
    valid = depth[..., 0] > 0
    hole = ~valid
    if roi is not None:
        y0, y1, x0, x1 = roi
        inside = np.zeros_like(hole)
        inside[y0:y1, x0:x1] = True
        hole &= inside
    ys, xs = np.nonzero(hole)
    ox, oy = D._offset_tables(max(steps, 1))
    p = len(ys)
    st = np.full((p, 32), MARCH)
    length = np.zeros((p, 32), np.int64)
    ey = np.zeros((p, 32), np.int64)
    ex = np.zeros((p, 32), np.int64)
    keep = np.ones((p, 32), bool)
    dist = np.full((p, 32), np.inf, np.float32)
    marched = 0
    partner = np.arange(32) ^ 16
    for k in range(steps):
        go = (st == MARCH) & keep
        marched += int(go.sum())
        qy, qx = ys[:, None] + oy[:, k], xs[:, None] + ox[:, k]
        out = (qy < 0) | (qy >= h) | (qx < 0) | (qx >= w)
        hit = ~out & valid[qy.clip(0, h - 1), qx.clip(0, w - 1)]
        st = np.where(go & out, FAIL, st)
        newly = go & hit
        st = np.where(newly, HIT, st)
        ey, ex = np.where(newly, qy, ey), np.where(newly, qx, ex)
        length = np.where(newly, k + 1, length)
        st = np.where(go & ~out & ~hit & (k + 1 == steps), FAIL, st)
        if (k + 1) % ROUND and k + 1 != steps:
            continue  # the kernel checks the stop rule after each round
        least = np.where(st == HIT, length, k + 2)
        pst = st[:, partner]
        complete = (st == HIT) & (pst == HIT)
        dead = (st == FAIL) | (pst == FAIL)
        ddx = (ex - ex[:, partner]).astype(np.float32)
        ddy = (ey - ey[:, partner]).astype(np.float32)
        dist = np.where(complete, np.sqrt(ddx * ddx + ddy * ddy), dist)
        best = dist.min(axis=1, keepdims=True)
        bound = (least + least[:, partner]).astype(np.float32) - SLACK
        keep = ~dead & ~complete & ~(bound > best)
        if not keep.any():
            break
    result = image.copy()
    for j in range(p):
        d = dist[j, :16]
        if not np.isfinite(d).any():
            continue
        win = int(np.flatnonzero(d == d.min())[0])  # the first minimum
        to = (ey[j, win], ex[j, win])
        fr = (ey[j, win + 16], ex[j, win + 16])
        src = to if depth[fr][0] < depth[to][0] else fr
        result[ys[j], xs[j]] = image[src]
    return result, marched


def _old_march_steps(depth, steps):
    """Ray steps of the first kernel's schedule: every ray of every hole
    pixel to its first event."""
    valid = depth[..., 0] > 0
    h, w = valid.shape
    ys, xs = np.nonzero(~valid)
    ox, oy = D._offset_tables(steps)
    alive = np.ones((len(ys), 32), bool)
    total = 0
    for k in range(steps):
        total += int(alive.sum())
        qy, qx = ys[:, None] + oy[:, k], xs[:, None] + ox[:, k]
        out = (qy < 0) | (qy >= h) | (qx < 0) | (qx >= w)
        alive &= ~out & ~valid[qy.clip(0, h - 1), qx.clip(0, w - 1)]
    return total


@pytest.mark.parametrize("hole_frac,band,steps,roi", [
    (0.05, 0, 128, None),            # isolated holes: distance ties
    (0.3, 40, 128, None),            # a band wider than most rays
    (0.5, 24, 16, None),             # rays that run out of steps
    (0.2, 48, 128, (6, 50, 10, 90)),  # the ROI
])
def test_lockstep_march_with_exact_stop_equals_plain(hole_frac, band, steps,
                                                     roi):
    image, depth = _frame(56, 96, 4, hole_frac, seed=int(hole_frac * 10)
                          + band, band=band)
    image, depth = image[0], depth[0]
    got, marched = _lockstep_fill(image, depth, steps, roi)
    want = D.fill_plain(torch.as_tensor(image), torch.as_tensor(depth), steps,
                        roi).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got != image).any()
    if roi is None:  # the stop saves steps where the holes are wide
        old = _old_march_steps(depth, steps)
        assert marched < old if band else marched <= old
