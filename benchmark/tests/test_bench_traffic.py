"""The traffic generator: its frozen scene, the same stream from one seed,
and the photos-mixed draw."""

import collections
import hashlib
import json

import numpy as np
import pytest

from benchmark import traffic
from kbe_torch.data import demo_scene_image


@pytest.mark.parametrize("shape", [(1024, 1024), (680, 1024), (64, 48)])
@pytest.mark.parametrize("seed", [0, 7, 2**31 + 3])
def test_scene_is_the_ports_demo_scene(shape, seed):
    got = traffic.scene_image(*shape, seed)
    want = demo_scene_image(*shape, seed)
    assert got.dtype == np.float32
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def _first(mix, seed, n):
    reqs = traffic.stream(mix, seed)
    return [next(reqs) for _ in range(n)]


def test_same_seed_same_stream_and_another_seed_another():
    mix = traffic.load("photos-mixed")
    a = _first(mix, 2**31 + 40, 7)
    b = _first(mix, 2**31 + 40, 7)
    c = _first(mix, 2**31 + 41, 7)
    assert [(r.height, r.width) for r in a] == [(r.height, r.width)
                                                for r in b]
    assert all(np.array_equal(x.image, y.image) for x, y in zip(a, b))
    assert not all(np.array_equal(x.image, y.image) for x, y in zip(a, c)
                   if x.image.shape == y.image.shape)
    assert len({r.image.tobytes() for r in a}) == len(a)
    assert [r.index for r in a] == list(range(7))
    assert [(r.height, r.width) for r in a] == traffic.shape_sequence(
        mix, 2**31 + 40, 7)


@pytest.mark.parametrize("name", ["square-1024", "photos-mixed"])
def test_every_request_and_warm_up_sends_a_photograph_of_its_own(name):
    mix = traffic.load(name)
    seed = 2**33 + 5
    warm = traffic.warm_ups(mix, seed)
    assert sorted((r.height, r.width) for r in warm) == sorted(
        {tuple(s) for s in mix["shapes"]})
    window = _first(mix, seed, 30)
    seen = {hashlib.sha1(r.image).digest() for r in warm + window}
    assert len(seen) == len(warm) + len(window)
    assert min(r.index for r in warm) > 10**12


def test_photos_mixed_draws_each_shape_equally_in_seeded_order():
    mix = traffic.load("photos-mixed")
    shapes = [tuple(s) for s in mix["shapes"]]
    assert sorted(shapes) == sorted([(1024, 1024), (768, 1024), (1024, 768),
                                     (680, 1024), (576, 1024)])
    orders = set()
    for seed in (1, 2, 2**31 + 9):
        seq = traffic.shape_sequence(mix, seed, 103)
        for n in range(1, len(seq) + 1):
            counts = collections.Counter(seq[:n])
            assert max(counts.values()) - min(counts.get(s, 0)
                                              for s in shapes) <= 1
        orders.add(tuple(seq))
    assert len(orders) == 3


def test_square_mix_sends_one_shape():
    mix = traffic.load("square-1024")
    assert set(traffic.shape_sequence(mix, 3, 50)) == {(1024, 1024)}


@pytest.mark.parametrize("bad", [
    {"loop": "open", "clients": 1, "shapes": [[64, 64]]},
    {"loop": "closed", "clients": 1, "shapes": [[66, 64]]},
    {"loop": "closed", "clients": 2, "shapes": [[64, 64]]}])
def test_mixes_are_checked(bad, tmp_path, monkeypatch):
    (tmp_path / "t.json").write_text(json.dumps(bad))
    monkeypatch.setattr(traffic, "TRAFFIC_DIR", tmp_path)
    with pytest.raises(ValueError):
        traffic.load("t")
