"""``cli/train_torch.py`` on the CPU: each training mode runs a step at a
patched small data size (and a narrow grid-net or disparity lattice),
writes its checkpoint, and resumes from it with ``--continue-training``
(nets, optimizer state and step). ``--mask-source maskrcnn`` trains on a
``--dataset`` with the Mask R-CNN's masks (a synthetic torchvision-layout
``.pth``; a 64^2 canvas), exits without ``--maskrcnn-weights`` as
``cli/train.py`` does, and leaves ``--synthetic`` the generator's masks.
``--data-parallel`` refuses a global batch that does not divide over the
ranks (its runs on two ranks are in ``tests/test_torch_parallel.py``), and
the default device raises where there is no GPU.

The depth modes' sizes follow their resizes: estimation validates at 256
pixels from an estimation at ``estimation_size`` 512, half of it, so the
images are 16x128 (64x512 after the resize); refinement takes the
estimation at a quarter of the image, so the images are 32x1024.
"""

import json
import os

import pytest
import torch

import cli.train_torch as T
from kbe_torch.models import Disparity, Inpaint
from kbe_torch.train.checkpoint import latest_checkpoint, load_checkpoint


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The Tier-1 run has six worker processes on the CPU: one thread for
    this file's convolutions keeps them from oversubscribing the cores
    that the other workers' tests run on."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _argv(mode, tmp_path, steps, *more):
    return ["--training-mode", mode, "--synthetic", "--batch-size", "1",
            "--max-steps", str(steps), "--device", "cpu",
            "--checkpoint-dir", str(tmp_path / "ck"),
            "--logs-path", str(tmp_path / "runs" / "train_0"), *more]


@pytest.mark.parametrize("mode,size", [("inpainting", (48, 64)),
                                       ("inpainting_ref", (288, 288))])
def test_cli_trains_checkpoints_and_resumes(mode, size, tmp_path,
                                            monkeypatch):
    monkeypatch.setitem(T.SYNTHETIC_SIZE, "inpainting", size)
    make_trainer = T.make_trainer

    def narrow(args, **kwargs):  # a narrow grid-net: the CLI's plumbing is
        trainer = make_trainer(args, **kwargs)  # what is under test
        trainer._make_net = lambda: Inpaint(rows=(8, 16))
        return trainer

    monkeypatch.setattr(T, "make_trainer", narrow)
    assert T.main(_argv(mode, tmp_path, 1)) == 0
    first = latest_checkpoint(str(tmp_path / "ck"), "3dkbe")
    assert first is not None and first.endswith("3dkbe-0.tar")
    states, step = load_checkpoint(first)
    assert step == 0
    assert len(states) == (2 if mode == "inpainting_ref" else 1)
    g = states[0]
    assert g["step"] == (0 if mode == "inpainting_ref" else 1)
    assert g["opt_state"]["count"] == g["step"]
    if mode == "inpainting_ref":  # a D-only iteration (pretraining)
        assert states[1]["step"] == 1 and states[1]["opt_state"]["count"] == 1

    assert T.main(_argv(mode, tmp_path, 2, "--continue-training")) == 0
    second = latest_checkpoint(str(tmp_path / "ck"), "3dkbe")
    assert second.endswith("3dkbe-1.tar")
    resumed, step = load_checkpoint(second)
    d_or_g = resumed[-1]
    assert d_or_g["step"] == 2
    moved = [not torch.equal(resumed[0]["net"][k], states[0]["net"][k])
             for k in states[0]["net"]]
    assert any(moved) == (mode == "inpainting")
    metrics = os.path.join(tmp_path, "runs", "train_0", "metrics.jsonl")
    assert os.path.getsize(metrics) > 0


def _narrow_depth(monkeypatch):
    make_trainer = T.make_trainer

    def narrow(args, **kwargs):
        trainer = make_trainer(args, **kwargs)
        trainer._make_disparity = lambda: Disparity(
            rows=(8, 12, 16, 32, 32, 32))
        return trainer

    monkeypatch.setattr(T, "make_trainer", narrow)
    monkeypatch.setitem(T.SYNTHETIC_SIZE, "disparity", (16, 128))
    monkeypatch.setitem(T.SYNTHETIC_SIZE, "refine", (32, 1024))


@pytest.mark.parametrize("mask_loss", ["same", "other"])
def test_cli_estimation_trains_with_the_mask_loss(mask_loss, tmp_path,
                                                  monkeypatch):
    """One iteration; with 'other' the auxiliary batch takes a second step
    on the same optimizer state, so step and count are 2."""
    _narrow_depth(monkeypatch)
    assert T.main(_argv("estimation", tmp_path, 1, "--mask-loss",
                        mask_loss)) == 0
    ck = latest_checkpoint(str(tmp_path / "ck"), "3dkbe")
    assert ck.endswith("3dkbe-0.tar")
    (state,), step = load_checkpoint(ck)
    steps = 2 if mask_loss == "other" else 1
    assert step == 0 and state["step"] == state["opt_state"]["count"] == steps
    assert "lattice.blk0x1.conv1.weight" in state["net"]
    with open(tmp_path / "runs" / "train_0" / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    tags = {r["tag"] for r in rows}
    assert "Validation/abs_rel" in tags and "Estimation/mask" in tags
    assert ("Estimation/mask_other" in tags) == (mask_loss == "other")
    mask = [r["value"] for r in rows if r["tag"] == "Estimation/mask"]
    assert mask[0] > 0


def test_cli_refinement_checkpoints_and_resumes(tmp_path, monkeypatch):
    """Only the refinement net is checkpointed; a resumed run goes on from
    its step and moves it."""
    _narrow_depth(monkeypatch)
    assert T.main(_argv("refinement", tmp_path, 1)) == 0
    first = latest_checkpoint(str(tmp_path / "ck"), "3dkbe")
    (state,), step = load_checkpoint(first)
    assert step == 0 and state["step"] == state["opt_state"]["count"] == 1
    assert all(k.startswith("core.") for k in state["net"])
    assert T.main(_argv("refinement", tmp_path, 2,
                        "--continue-training")) == 0
    second = latest_checkpoint(str(tmp_path / "ck"), "3dkbe")
    assert second.endswith("3dkbe-1.tar")
    (resumed,), step = load_checkpoint(second)
    assert step == 1 and resumed["step"] == 2
    assert any(not torch.equal(resumed["net"][k], state["net"][k])
               for k in state["net"])


@pytest.mark.parametrize("argv", [
    ["--training-mode", "refinement", "--data-parallel"],
    ["--training-mode", "inpainting", "--data-parallel"],
], ids=["refinement", "data_parallel"])
def test_later_slices_raise(argv, tmp_path, monkeypatch):
    """``--data-parallel`` in every mode: the global ``--batch-size`` of 8
    does not divide over three ranks, and the run stops, saying so, before
    a trainer is made."""
    from kbe_torch import parallel

    monkeypatch.setattr(parallel, "data_mesh", lambda device=None:
                        parallel.DataMesh(0, 3, torch.device("cpu")))
    monkeypatch.setattr(T, "make_trainer", None)  # never called
    with pytest.raises(SystemExit, match="divide by the 3 ranks"):
        T.main(argv + ["--device", "cpu", "--logs-path",
                       str(tmp_path / "runs")])


def test_default_device_raises_without_a_gpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.main(["--training-mode", "inpainting", "--synthetic",
                "--max-steps", "1", "--logs-path", str(tmp_path / "runs")])


def _tiny_dataset(root, n=2):
    """``n`` 16x128 PNG images with 16-bit depth maps, in the reference's
    layout (``images/``, ``depth/``)."""
    import cv2
    import numpy as np

    rng = np.random.default_rng(0)
    for d in ("images", "depth"):
        os.makedirs(root / d)
    for i in range(n):
        cv2.imwrite(str(root / "images" / f"{i}.png"),
                    rng.integers(0, 256, (16, 128, 3), dtype=np.uint8))
        cv2.imwrite(str(root / "depth" / f"{i}.png"),
                    rng.integers(1000, 3000, (16, 128), dtype=np.uint16))
    return f"tiny:{root}:512:74"


@pytest.mark.parametrize("case", ["no_weights", "synthetic"])
def test_mask_source_maskrcnn(case, tmp_path, monkeypatch):
    """Without ``--maskrcnn-weights`` a ``--dataset`` run exits, as
    ``cli/train.py`` does; with ``--synthetic`` the generator's own masks
    feed the mask loss and no Mask R-CNN is built."""
    _narrow_depth(monkeypatch)
    more = ["--mask-loss", "same", "--mask-source", "maskrcnn"]
    if case == "no_weights":
        argv = _argv("estimation", tmp_path, 1, *more)
        argv[argv.index("--synthetic")] = "--dataset"
        argv.insert(argv.index("--dataset") + 1,
                    _tiny_dataset(tmp_path / "data"))
        with pytest.raises(SystemExit, match="--maskrcnn-weights"):
            T.main(argv)
        return
    monkeypatch.setattr(T, "resolve_mask_source", None)  # never called
    assert T.main(_argv("estimation", tmp_path, 1, *more)) == 0
    with open(tmp_path / "runs" / "train_0" / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert [r["value"] for r in rows if r["tag"] == "Estimation/mask"][0] > 0


def test_cli_estimation_with_maskrcnn_masks(tmp_path, monkeypatch):
    """One estimation step through ``main`` on a two-image PNG dataset
    (one for training, one for validation) with the 'same' mask loss, its
    masks from the Mask R-CNN on a 64^2 canvas (the CLI's is 512^2): the
    masks hold detections and the mask loss is not zero."""
    import numpy as np
    from kbe_torch.utils.reference_convert import \
        synthetic_maskrcnn_state_dict

    _narrow_depth(monkeypatch)
    weights = tmp_path / "maskrcnn.pth"
    torch.save({k: torch.from_numpy(v) for k, v in
                synthetic_maskrcnn_state_dict(0).items()}, weights)
    resolve, masks = T.resolve_mask_source, []

    def small_canvas(args, **kwargs):
        source = resolve(args, infer_size=64, **kwargs)

        def recorded(image01, disparity=None):
            out = source(image01, disparity)
            masks.append(out)
            return out
        return recorded

    monkeypatch.setattr(T, "resolve_mask_source", small_canvas)
    argv = ["--training-mode", "estimation", "--dataset",
            _tiny_dataset(tmp_path / "data"), "--mask-loss", "same",
            "--mask-source", "maskrcnn", "--maskrcnn-weights", str(weights),
            "--batch-size", "1", "--max-steps", "1", "--n-epochs", "1",
            "--device", "cpu", "--checkpoint-dir", str(tmp_path / "ck"),
            "--logs-path", str(tmp_path / "runs" / "train_0")]
    assert T.main(argv) == 0
    assert masks and all(m.shape == (8, 32, 256, 1) for m in masks)
    assert all(set(np.unique(m)) <= {0.0, 1.0} for m in masks)
    assert sum(float(m.sum()) for m in masks) > 0
    with open(tmp_path / "runs" / "train_0" / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    tags = {r["tag"] for r in rows}
    assert "Validation/abs_rel" in tags
    assert [r["value"] for r in rows if r["tag"] == "Estimation/mask"][0] > 0
    (state,), step = load_checkpoint(latest_checkpoint(
        str(tmp_path / "ck"), "3dkbe"))
    assert step == 0 and state["step"] == 1
