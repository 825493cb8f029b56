"""The port's CLI against ``cli/kbe.py``: the same flags and defaults, the
same crop windows from the same arguments, and ``run`` (everything between
reading the image and writing the video) on the CPU at 32^2."""

import numpy as np
import pytest

from cli import kbe as cli_j
from cli import kbe_torch as cli_t


def _options(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.type, a.nargs,
                     type(a).__name__)
            for a in parser._actions if a.dest != "help"}


def test_parser_has_the_flags_of_the_jax_cli():
    got, want = _options(cli_t.build_parser()), _options(cli_j.build_parser())
    assert set(got) - set(want) == {"device"}
    for dest, spec in want.items():
        assert got[dest] == spec, dest
    assert got["device"][1] == "cuda"


@pytest.mark.parametrize("argv,size", [
    ([], (64, 48)),
    (["--dolly"], (64, 48)),
    # heights given: the widths follow the image's aspect
    (["--startU", "30", "--startV", "22", "--startH", "40", "--endU", "32",
      "--endV", "24", "--endH", "30"], (64, 48)),
    # widths given: the heights follow
    (["--startU", "50", "--startV", "30", "--startW", "80", "--endU", "52",
      "--endV", "32", "--endW", "60"], (100, 60)),
    # one window incomplete: the defaults
    (["--startU", "30", "--startV", "22", "--startH", "40"], (64, 48)),
])
def test_resolve_windows_matches_the_jax_cli(argv, size):
    w, h = size
    got = cli_t.resolve_windows(cli_t.build_parser().parse_args(argv), w, h)
    want = cli_j.resolve_windows(cli_j.build_parser().parse_args(argv), w, h)
    for a, b in ((got.src, want.src), (got.dst, want.dst)):
        assert (a.center_u, a.center_v, a.crop_width, a.crop_height) \
            == (b.center_u, b.center_v, b.crop_width, b.crop_height)


def test_resolve_windows_refuses_a_window_outside_the_image():
    args = cli_t.build_parser().parse_args(
        ["--startU", "5", "--startV", "22", "--startH", "40", "--endU", "32",
         "--endV", "24", "--endH", "30"])
    with pytest.raises(ValueError):
        cli_t.resolve_windows(args, 64, 48)


def _image(h, w):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 255, (h, w, 3)).astype(np.uint8)
    img[h // 3:2 * h // 3, w // 3:2 * w // 3] = (20, 200, 90)
    return img


@pytest.mark.parametrize("argv", [
    [], ["--dolly"], ["--2d", "--partial-conv", "--pretrained-refine"],
    ["--bf16", "--inpaint-depth", ""]], ids=lambda a: " ".join(a) or "default")
def test_run_on_the_cpu(argv):
    """34 x 35 crops to 32 x 32; random weights (no checkpoint files)."""
    args = cli_t.build_parser().parse_args(
        argv + ["--steps", "2", "--device", "cpu"])
    frames = cli_t.run(args, _image(34, 35))
    assert frames.shape == (2, 32, 32, 3) and frames.dtype == np.uint8
    assert (frames[0] != frames[1]).any()


def test_run_pretrained_estim_flips_bgr_to_rgb():
    image = _image(32, 32)
    parse = cli_t.build_parser().parse_args
    base = ["--steps", "2", "--device", "cpu"]
    got = cli_t.run(parse(base + ["--pretrained-estim"]), image)
    want = cli_t.run(parse(base), image[:, :, ::-1])
    np.testing.assert_array_equal(got, want)


def test_run_refuses_an_orbax_checkpoint():
    args = cli_t.build_parser().parse_args(
        ["--checkpoint", "ckpt_dir", "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="JAX"):
        cli_t.run(args, _image(32, 32))
