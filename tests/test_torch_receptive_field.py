"""kbe_torch's receptive-field summary against kbe_tpu's: every spec of
the model zoo at three sizes, and a hand-made stack with stride, padding
and dilation, give equal per-layer summaries and equal printouts."""

import pytest

from kbe_torch.utils import receptive_field as RT
from kbe_tpu.utils import receptive_field as RJ


def _rows(infos):
    return [(i.name, i.n_features, i.jump, i.receptive, i.start)
            for i in infos]


@pytest.mark.parametrize("spec", ["disparity_layers", "refine_layers",
                                  "semantics_layers"])
@pytest.mark.parametrize("imsize", [64, 512, 1000])
def test_spec_summary_matches_jax(spec, imsize):
    got = RT.net_summary(getattr(RT, spec)(), imsize, verbose=False)
    want = RJ.net_summary(getattr(RJ, spec)(), imsize, verbose=False)
    assert _rows(got) == _rows(want)


def test_custom_stack_matches_jax(capsys):
    layers = [("a", 7, 2, 3, 1), ("b", 3, 1, 2, 2), ("c", 2, 2, 0, 1)]
    got = RT.net_summary([RT.LayerSpec(*x) for x in layers], 97)
    printed = capsys.readouterr().out
    want = RJ.net_summary([RJ.LayerSpec(*x) for x in layers], 97)
    assert capsys.readouterr().out == printed
    assert _rows(got) == _rows(want)
