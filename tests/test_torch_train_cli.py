"""``cli/train_torch.py`` on the CPU: each inpainting mode runs a step at
a patched small data size (and a narrow grid-net), writes its checkpoint,
and resumes from it with ``--continue-training`` (nets, optimizer state
and step). The modes of later slices raise, and the default device raises
where there is no GPU.
"""

import os

import pytest
import torch

import cli.train_torch as T
from kbe_torch.models import Inpaint
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


@pytest.mark.parametrize("argv", [
    ["--training-mode", "estimation"],
    ["--training-mode", "refinement"],
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
