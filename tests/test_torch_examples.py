"""The port's example scripts end to end on the CPU at their own sizes, one
synthetic batch each: they print their metrics and write their panel
(with imageio, else cv2; the case skips, naming them, where neither is
installed)."""

import importlib.util
import os

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the Tier-1 run has six worker processes on
    the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "examples", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("name,more,panel", [
    ("depth_estimation_torch", [], (256, 4 * 1024)),
    ("inpainting_torch", [], (192, 3 * 256)),
    ("inpainting_torch", ["--view-c"], (192, 3 * 256)),
], ids=["depth", "inpainting", "inpainting_view_c"])
def test_example_writes_its_panel(name, more, panel, tmp_path, capsys):
    if importlib.util.find_spec("imageio") is None \
            and importlib.util.find_spec("cv2") is None:
        pytest.skip("writing the panel needs imageio or cv2")
    out = tmp_path / "panel.png"
    _example(name).main(["--device", "cpu", "--batches", "1",
                         "--out", str(out), *more])
    printed = capsys.readouterr().out
    assert "metrics:" in printed and f"wrote {out}" in printed
    if importlib.util.find_spec("imageio") is not None:
        import imageio.v2 as iio

        image = np.asarray(iio.imread(out))
    else:
        import cv2

        image = cv2.imread(str(out))
    assert image.shape == (*panel, 3) and image.dtype == np.uint8
    assert image.max() > image.min()
