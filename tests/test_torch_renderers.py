"""kbe_torch's grid-renderer and fill entry points (plain path, CPU) against
kbe_tpu's XLA specs: every ``render_grids_*`` against
``kbe_tpu.ops.splat.render_pointcloud`` (``method='scatter'``), and
``fill_disocclusion_pallas`` under every phase setting against
``kbe_tpu.ops.discfill.fill_disocclusion``.

Tolerances: splat atol 2e-4 on the rendered planes and the weights (the
standard the JAX package holds its own splat kernels to); the fill is
bit-exact. The JAX Pallas kernels themselves are not run here: in interpret
mode they take minutes, and the JAX package's own tests hold them to these
same specs.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from kbe_tpu.ops.discfill import fill_disocclusion as fill_jax
from kbe_tpu.ops.geometry import apply_shift as apply_shift_jax
from kbe_tpu.ops.geometry import project_points as project_jax
from kbe_torch.ops import splat as S
from kbe_torch.ops.discfill import fill_disocclusion_pallas
from kbe_torch.ops.geometry import apply_shift
from kbe_torch.ops.legacy import (render_grids_delta,
                                  render_grids_fast_delta,
                                  render_grids_pallas)
from kbe_torch.ops.splat_banded import (render_grids_banded,
                                        render_grids_fast_banded)
from kbe_torch.ops.splat_routed import render_grids_fast, \
    render_grids_routed
from tests.test_torch_discfill import _frame
from tests.test_torch_splat import ATOL, _cloud, _jax_render

# entry point -> whether it returns the overflow flag
ENTRY_POINTS = {
    "routed": (render_grids_routed, True),
    "fast": (render_grids_fast, False),
    "banded": (render_grids_banded, True),
    "fast_banded": (render_grids_fast_banded, False),
    "delta": (render_grids_delta, True),
    "fast_delta": (render_grids_fast_delta, False),
    "pallas": (render_grids_pallas, False),
}


def _shifted_cloud(h, w, grids, c, seed, focal):
    xyz, data, valid = _cloud(h, w, grids, c, seed, focal)
    shift = np.asarray((-4.0, 2.5, 9.0), np.float32)
    xyz = np.asarray(apply_shift_jax(jnp.asarray(xyz), jnp.asarray(shift)))
    return xyz, data, valid


def _call(name, xyz, data, h, w, focal, baseline, valid):
    fn, has_flag = ENTRY_POINTS[name]
    out = fn(torch.as_tensor(xyz), torch.as_tensor(data), h, w, focal,
             baseline, valid=None if valid is None
             else torch.as_tensor(valid))
    if has_flag:
        assert out[2].dtype == torch.bool and out[2].shape == ()
        assert not bool(out[2])   # no point is ever dropped
    return out[0].numpy(), out[1].numpy()


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_grid_renderer_matches_spec(name):
    """G=3, C=4 (the frame loop's cloud) for every entry point."""
    h, w, focal, baseline = 40, 56, 56.0, 20.0
    xyz, data, valid = _shifted_cloud(h, w, 3, 4, 5, focal)
    want_r, want_e = _jax_render(xyz, data, valid, h, w, focal, baseline)
    got_r, got_e = _call(name, xyz, data, h, w, focal, baseline, valid)
    assert got_r.shape == (1, h, w, 4) and got_e.shape == (1, h, w, 1)
    np.testing.assert_allclose(got_r[0], want_r, atol=ATOL)
    np.testing.assert_allclose(got_e[0], want_e, atol=ATOL)
    assert (want_e == 0).any() and (want_e > 0).any()


@pytest.mark.parametrize("name", ["fast", "fast_banded"])
def test_grid_renderer_wide_payload_and_no_mask(name):
    """G=1, C=68, ``valid=None``: the inpainting bootstrap's render."""
    h, w, focal, baseline = 32, 40, 40.0, 30.0
    xyz, data, _ = _shifted_cloud(h, w, 1, 68, 6, focal)
    want_r, want_e = _jax_render(xyz, data, np.ones((1, h, w), np.float32),
                                 h, w, focal, baseline)
    got_r, got_e = _call(name, xyz, data, h, w, focal, baseline, None)
    np.testing.assert_allclose(got_r[0], want_r, atol=ATOL)
    np.testing.assert_allclose(got_e[0], want_e, atol=ATOL)


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_all_invalid_cloud_renders_empty(name):
    h, w = 16, 24
    xyz, data, valid = _shifted_cloud(h, w, 2, 4, 7, 24.0)
    got_r, got_e = _call(name, xyz, data, h, w, 24.0, 10.0,
                         np.zeros_like(valid))
    assert not got_r.any() and not got_e.any()


def test_entry_points_validate_their_arguments():
    h, w = 8, 8
    xyz, data, valid = (torch.as_tensor(a)
                        for a in _shifted_cloud(h, w, 1, 4, 8, 8.0))
    for fn in (render_grids_fast, render_grids_fast_banded,
               render_grids_fast_delta):
        fn(xyz, data, h, w, 8.0, 10.0, fallback="scatter")
        with pytest.raises(ValueError, match="fallback"):
            fn(xyz, data, h, w, 8.0, 10.0, fallback="drop")
    with pytest.raises(ValueError, match="margin"):
        render_grids_pallas(xyz, data, h, w, 8.0, 10.0, margin=-1)
    with pytest.raises(ValueError, match="xyz"):
        render_grids_routed(xyz.reshape(-1, 3), data, h, w, 8.0, 10.0)
    with pytest.raises(ValueError, match="valid"):
        render_grids_banded(xyz, data, h, w, 8.0, 10.0,
                            valid=valid.reshape(-1))


def test_apply_shift_route_projects_as_the_posed_route():
    """The routed frame (``apply_shift`` in PyTorch, then a zero-shift
    pose) and the posed frame (x, y pre-scaled once, the shift added in the
    renderer) must land every point on the same (u, v), bit for bit, and
    both must equal the JAX spec's projection."""
    h, w, focal, baseline = 24, 32, 32.0, 20.0
    xyz, data, valid = _cloud(h, w, 2, 4, 9, focal)
    shift = np.asarray((3.25, -1.75, -12.5), np.float32)
    t_xyz, t_valid = torch.as_tensor(xyz), torch.as_tensor(valid)
    scene = S.prepare_scene(t_xyz, torch.as_tensor(data), t_valid)
    posed = S._project(scene.xyz, scene.valid,
                       S.make_pose(torch.as_tensor(shift), focal, baseline),
                       h, w)
    moved = apply_shift(t_xyz, torch.as_tensor(shift)).reshape(-1, 3)
    routed = S._project(moved, scene.valid,
                        S.make_pose(torch.zeros(3), focal, baseline), h, w)
    for a, b in zip(posed, routed):
        assert torch.equal(a, b)
    u, v, _ = project_jax(apply_shift_jax(jnp.asarray(xyz),
                                          jnp.asarray(shift)), h, w, focal)
    np.testing.assert_array_equal(routed[0].numpy(),
                                  np.asarray(u).reshape(-1))
    np.testing.assert_array_equal(routed[1].numpy(),
                                  np.asarray(v).reshape(-1))


@pytest.mark.parametrize("phase1,phase0,gate,roi,steps", [
    (0, 0, 0.0, None, 16),           # the one-phase march
    (8, 0, 0.0, None, 128),          # fused phase 1 + re-march
    (8, 2, 0.0, (4, 36, 6, 60), 128),   # thin-hole resolver, ROI
    (8, 2, 0.75, None, 16),          # census-gated resolver
    (16, 0, 0.0, (0, 40, 0, 72), 16),   # phase1 >= steps: one phase
])
def test_fill_pallas_entry_bit_exact(phase1, phase0, gate, roi, steps):
    image, depth = _frame(40, 72, 4, 0.35, seed=21, band=24)
    want = np.asarray(fill_jax(jnp.asarray(image), jnp.asarray(depth),
                               steps))
    got = fill_disocclusion_pallas(
        torch.as_tensor(image), torch.as_tensor(depth), steps,
        phase1_steps=phase1, roi=roi, phase0_steps=phase0,
        phase0_gate=gate).numpy()
    assert (want != image).any()
    if roi is None:
        np.testing.assert_array_equal(got, want)
    else:
        y0, y1, x0, x1 = roi
        np.testing.assert_array_equal(got[:, y0:y1, x0:x1],
                                      want[:, y0:y1, x0:x1])
        outside = np.ones(got.shape[:3], bool)
        outside[:, y0:y1, x0:x1] = False
        np.testing.assert_array_equal(got[outside], image[outside])


def test_fill_pallas_entry_validates_its_arguments():
    image = torch.zeros(1, 8, 8, 4)
    depth = torch.ones(1, 8, 8, 1)
    for kwargs in (dict(steps=-1), dict(phase1_steps=1.5),
                   dict(phase0_steps=-2), dict(phase0_gate=1.5),
                   dict(roi=(4, 2, 0, 8)), dict(roi=(0, 8, 0, 8.0))):
        with pytest.raises(ValueError):
            fill_disocclusion_pallas(image, depth, **kwargs)
