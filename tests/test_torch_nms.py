"""The bitmask NMS of ``kbe_torch/ops/csrc/nms.cu`` emulated in numpy (CPU).

The kernel cannot run here, so its design is emulated step by step: the
IoU pass (the kernel's operation order, the IEEE quotient's comparison
with the threshold made exactly in float64 without dividing, one uint32
word of 32 IoU bits per row and word, rows shared among a cluster's
blocks) and the scan (one lane a word of ``removed``; a word's slots
settled in rounds of two warp-wide ORs, each keeping the undecided slots
that no undecided slot kills and dropping what they kill; then a
warp-wide OR of the kept slots' rows for each later word). The
emulation is held exactly equal to ``keep_plain`` (the kernel's plain
version) and to ``kbe_tpu``'s ``_nms_keep`` on the same sorted sets: the
four cases of ``tests/test_torch_maskrcnn.py`` (random, ties, zero slots,
full overlap), sets of 1, 31, 33, 512, 513 and 1000 slots, an all-zero set
and IoUs exactly at the threshold. No tolerance: the kept set is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kbe_tpu.models import maskrcnn as J
from kbe_torch.ops import nms as N

f32 = np.float32


def _words(cap):
    return (cap + 31) // 32


def _cluster_of(cap):
    """The kernel's blocks a set: one per 64 slots, at most 8."""
    return min((cap + 63) // 64, 8)


def _rows_of_cluster(cap):
    """The kernel's IoU tasks: block ``rank`` of the set's cluster of
    ``nb`` takes rows ``rank``, ``rank + nb``, ..., a task (row i, word w)
    a thread index. Returns every (i, w) in the order the blocks' loops
    visit them."""
    nb = _cluster_of(cap)
    words, tasks = _words(cap), []
    for rank in range(nb):
        rows = (cap - rank + nb - 1) // nb if rank < cap else 0
        for t in range(rows * words):
            w = t // rows
            tasks.append((rank + nb * (t - w * rows), w))
    return tasks


def iou_over(inter, u, thresh):
    """The kernel's ``RN(inter / u) > thresh`` without the division:
    ``inter > above * u`` in float64 (``>=`` where the float above
    ``thresh`` is even), ``above`` the midpoint between ``thresh`` and
    that float."""
    thresh = f32(thresh)
    up = np.nextafter(thresh, f32(np.inf))
    if thresh == -np.inf:
        above = -np.inf
    else:
        with np.errstate(invalid="ignore"):
            above = np.float64(thresh) + 0.5 * (np.float64(up)
                                                - np.float64(thresh))
    x = np.asarray(inter, np.float64)
    y = above * np.asarray(u, np.float64)
    return x >= y if up.view(np.uint32) % 2 == 0 else x > y


def _iou_bits(boxes, alive, thresh):
    """The (cap, pitch) uint32 mask: bit b of word w of row i set iff
    j = 32 w + b > i, slots i and j alive and IoU(i, j) > thresh, in the
    kernel's operation order (f32, one rounding a step)."""
    cap = boxes.shape[0]
    words = _words(cap)
    pitch = words | 1
    x1, y1, x2, y2 = (boxes[:, k] for k in range(4))
    area = np.maximum(x2 - x1, f32(0)) * np.maximum(y2 - y1, f32(0))
    ix1 = np.maximum(x1[:, None], x1[None, :])
    iy1 = np.maximum(y1[:, None], y1[None, :])
    ix2 = np.minimum(x2[:, None], x2[None, :])
    iy2 = np.minimum(y2[:, None], y2[None, :])
    inter = np.maximum(ix2 - ix1, f32(0)) * np.maximum(iy2 - iy1, f32(0))
    uni = (area[:, None] + area[None, :]) - inter
    over = iou_over(inter, np.maximum(uni, f32(1e-9)), thresh)
    idx = np.arange(cap)
    over &= (idx[None, :] > idx[:, None]) & alive[None, :] & alive[:, None]
    padded = np.zeros((cap, words * 32), bool)
    padded[:, :cap] = over
    weights = (np.uint64(1) << np.arange(32, dtype=np.uint64))
    packed = (padded.reshape(cap, words, 32) * weights).sum(-1)
    mask = np.zeros((cap, pitch), np.uint32)
    mask[:, :words] = packed.astype(np.uint32)
    return mask


def emulate_bitmask_nms(boxes, scores, thresh):
    """One sorted, zero-padded set through the kernel's two passes:
    (cap, 4), (cap,) f32 -> (cap,) scores with the suppressed slots 0."""
    cap = scores.shape[0]
    words = _words(cap)
    thresh = f32(thresh)
    alive = scores > 0
    bits = np.zeros(words * 32, bool)
    bits[:cap] = alive
    alive_w = [int(np.sum(bits[32 * w:32 * w + 32].astype(np.uint64)
                          << np.arange(32, dtype=np.uint64)))
               for w in range(words)]
    mask = _iou_bits(boxes, alive, thresh)
    removed = [0] * words               # lane w's word
    keep_w = [0] * words
    for w in range(words):
        und = alive_w[w] & ~removed[w]
        d = [int(mask[32 * w + b, w]) if 32 * w + b < cap else 0
             for b in range(32)]       # lane b's row, word w

        def reduce_or(lanes):           # __reduce_or_sync over lanes' d
            out = 0
            for b in range(32):
                if (lanes >> b) & 1:
                    out |= d[b]
            return out

        kept = 0
        while und:
            now = und & ~reduce_or(und)
            kept |= now
            und &= ~(now | reduce_or(now))
        keep_w[w] = kept
        # each later word: one warp-wide OR of the kept lanes' rows there
        for v in range(w + 1, words):
            for b in range(32):
                if (kept >> b) & 1 and 32 * w + b < cap:
                    removed[v] |= int(mask[32 * w + b, v])
    keep = np.zeros(words * 32, bool)
    for w in range(words):
        keep[32 * w:32 * w + 32] = (keep_w[w] >> np.arange(32)) & 1
    return np.where(keep[:cap], scores, f32(0))


def _boxes(rng, n, span=480.0, size=120.0):
    xy = rng.uniform(0, span, (n, 2))
    wh = 4.0 + rng.uniform(0, size, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def _case(name):
    """(boxes, scores, thresh) of a named case."""
    rng = np.random.default_rng(6)
    if name.startswith("n"):
        n = int(name[1:])
        return _boxes(rng, n), rng.uniform(0.01, 1, n).astype(f32), 0.7
    if name.startswith("at_"):
        # IoUs of exactly 1/2 (slots 0-1, 0-2) and 7/10 (3-4), quotients
        # of exact f32 areas, and pairs just over them (3-5: 0.75, 6-7:
        # 0.505)
        boxes = np.array([[0, 0, 2, 1], [0, 0, 1, 1], [0, 0, 4, 1],
                          [10, 0, 20, 1], [10, 0, 17, 1], [10, 0, 17.5, 1],
                          [30, 0, 32, 1], [30, 0, 31.01, 1]], f32)
        scores = np.linspace(0.9, 0.2, len(boxes)).astype(f32)
        return boxes, scores, float(name[3:])
    n = 96
    boxes = _boxes(rng, n)
    scores = rng.uniform(0.01, 1.0, n).astype(f32)
    if name == "ties":
        scores = np.round(scores * 4) / 4
        scores[scores == 0] = 0.25
    elif name == "zero_slots":
        scores[rng.uniform(size=n) < 0.3] = 0.0
    elif name == "full_overlap":
        boxes[1::2] = boxes[0::2]
        scores[1::2] = scores[0::2]
    elif name == "all_zero":
        scores[:] = 0.0
    return boxes, scores.astype(f32), 0.5


CASES = ["random", "ties", "zero_slots", "full_overlap", "n1", "n31", "n33",
         "n512", "n513", "n1000", "all_zero", "at_0.5", "at_0.7"]


@pytest.mark.parametrize("name", CASES)
def test_bitmask_emulation_matches_plain_and_jax(name):
    boxes, scores, thresh = _case(name)
    sb, ss, _ = N.sort_sets([(torch.from_numpy(boxes),
                              torch.from_numpy(scores))])
    sb, ss = sb[0].numpy(), ss[0].numpy()
    got = emulate_bitmask_nms(sb, ss, thresh)
    plain = N.keep_plain(torch.from_numpy(sb), torch.from_numpy(ss),
                         thresh).numpy()
    np.testing.assert_array_equal(got, plain)
    # kbe_tpu sorts itself and answers in the set's own order
    want = np.asarray(J._nms_keep(jnp.asarray(sb), jnp.asarray(ss), thresh))
    np.testing.assert_array_equal(got, want)
    kept, alive = int((got > 0).sum()), int((ss > 0).sum())
    if name == "all_zero":
        assert alive == 0 and kept == 0
    elif name.startswith("at_"):
        # a pair exactly at the threshold keeps both; one over it does not
        dead = [4, 5, 7] if name == "at_0.5" else [5]
        np.testing.assert_array_equal(
            got, np.where(np.isin(np.arange(8), dead), f32(0), ss))
    elif name not in ("n1", "n31", "n33"):
        assert 0 < kept < alive


@pytest.mark.parametrize("cap", [1, 2, 31, 32, 33, 63, 64, 65, 127, 128,
                                 192, 193, 256, 320, 448, 512, 513, 700,
                                 999, 1000, 1024])
def test_cluster_rows_cover_the_mask_once(cap):
    """Every (row, word) of the mask is written by exactly one thread of
    the set's cluster, whatever its size (1 to 8 blocks over these caps),
    and its scan reads stay inside the rows."""
    tasks = _rows_of_cluster(cap)
    assert len(tasks) == len(set(tasks)) == cap * _words(cap)
    assert all(0 <= i < cap and 0 <= w < _words(cap) for i, w in tasks)
    assert _words(cap) <= 32  # a word a lane of the scan's warp


def test_nms_keep_sets_of_several_sizes_match_the_emulation():
    """``nms_keep_sets``'s padding: sets of 1, 33 and 513 slots in one
    call, each answered in its own order, equal to the emulation of the
    padded launch and to ``kbe_tpu``."""
    rng = np.random.default_rng(7)
    sets = [(torch.from_numpy(_boxes(rng, n)),
             torch.from_numpy(rng.uniform(0.01, 1, n).astype(f32)))
            for n in (1, 33, 513)]
    boxes, scores, orders = N.sort_sets(sets)
    assert scores.shape == (3, 513)
    for k, (b, s) in enumerate(zip(boxes.numpy(), scores.numpy())):
        got = emulate_bitmask_nms(b, s, 0.7)
        n = orders[k].shape[0]
        assert not got[n:].any()
        back = np.empty(n, f32)
        back[orders[k].numpy()] = got[:n]
        np.testing.assert_array_equal(
            back, N.nms_keep_sets(sets, 0.7)[k].numpy())
        np.testing.assert_array_equal(back, np.asarray(J._nms_keep(
            jnp.asarray(sets[k][0].numpy()),
            jnp.asarray(sets[k][1].numpy()), 0.7)))


@pytest.mark.parametrize("thresh", [0.5, 0.7, 0.3, 0.0, -0.0, 1e-30,
                                    float(np.nextafter(f32(0.7), f32(1))),
                                    float("inf"), float("-inf"),
                                    float("nan")])
def test_iou_comparison_without_division_is_the_division(thresh):
    """``iou_over`` against ``inter / u > thresh`` in f32 (IEEE, as
    ``keep_plain`` divides): equal on quotients within a few ulps of the
    threshold, on either side, on random ones, on exact ties of small
    integers and at u = 1e-9."""
    rng = np.random.default_rng(3)
    t = f32(thresh)
    u = rng.uniform(1e-3, 5e5, 200_000).astype(f32)
    near = t if np.isfinite(t) else f32(0.5)
    inter = (u.astype(np.float64) * near
             * (1 + rng.integers(-8, 9, u.shape) * 2.0 ** -24)).astype(f32)
    inter = np.concatenate([inter, rng.uniform(0, 5e5, 50_000).astype(f32),
                            np.arange(1, 2001, dtype=f32)])
    u = np.concatenate([u, rng.uniform(1e-9, 5e5, 50_000).astype(f32),
                        np.full(2000, 2000, f32)])
    inter = np.concatenate([inter, np.array([0, 1e-9, 7e-10, 5e-10], f32)])
    u = np.concatenate([u, np.full(4, 1e-9, f32)])
    with np.errstate(all="ignore"):
        want = inter / u > t
    np.testing.assert_array_equal(iou_over(inter, u, t), want)
    if np.isfinite(t) and t > 0:
        assert want.any() and not want.all()
