"""``cli/train_torch.py`` on the CPU: each training mode runs a step at a
patched small data size (and a narrow grid-net or disparity lattice),
writes its checkpoint, and resumes from it with ``--continue-training``
(nets, optimizer state and step). The flags of later slices
(``--mask-source maskrcnn``, ``--data-parallel``) raise in every mode, and
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
    ["--training-mode", "estimation", "--mask-loss", "same",
     "--mask-source", "maskrcnn"],
    ["--training-mode", "refinement", "--data-parallel"],
    ["--training-mode", "inpainting", "--data-parallel"],
    ["--training-mode", "inpainting", "--mask-loss", "same",
     "--mask-source", "maskrcnn"],
], ids=["estimation", "refinement", "data_parallel", "maskrcnn"])
def test_later_slices_raise(argv, tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        T.main(argv + ["--device", "cpu", "--logs-path",
                       str(tmp_path / "runs")])


def test_default_device_raises_without_a_gpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.main(["--training-mode", "inpainting", "--synthetic",
                "--max-steps", "1", "--logs-path", str(tmp_path / "runs")])
