"""The control of ``correct``: the reference with TF32 allowed for the f32
depth nets, in the program's place, must fail the cell's limits, while the
program passes them; and the program with TF32 switched on in its own path
must read not correct in a whole run. Both on the card at the cell's own
size (``gpu``)."""

import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from benchmark import harness, judge
from benchmark.control import readings

ROOT = Path(__file__).resolve().parents[2]
CELLS = ("kbe3d.square-1024", "dolly.square-1024", "kbe3d.photos-mixed")


def test_control_without_a_card_exits_nonzero(tmp_path):
    env = {"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
           "HOME": str(tmp_path), "TMPDIR": str(tmp_path)}
    out = subprocess.run(
        [sys.executable, "benchmark/control.py", "--workload",
         "kbe3d.square-1024", "--seeds", "1"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300)
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no CUDA card" in out.stderr


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_and_program_passes_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = harness.load_cell(harness.load_manifest(), workload)
    limits = cell["checks"]["limits"]
    rows = readings(cell, range(3_300_000_000, 3_300_000_003),
                    int(cell["checks"]["compare"]), "cuda:0")
    for row in rows:
        assert judge.verdict(row["program"], limits)[0], row
        assert not judge.verdict(row["control"], limits)[0], row


@pytest.mark.gpu
def test_a_program_in_tf32_is_not_correct_on_the_card(monkeypatch):
    """The port's f32 depth nets switched to TF32 where the port sets its
    precision: the reference keeps TF32 off for itself, so the run reads
    not correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from kbe_torch.pipeline import kenburns

    def allow_tf32():
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True

    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    monkeypatch.setattr(kenburns, "disable_tf32", allow_tf32)
    cell = harness.load_cell(harness.load_manifest(), "kbe3d.square-1024")
    try:
        rec = harness.run_cell(cell, 3_300_000_100, 3.0, False, "cuda:0",
                               time.perf_counter())
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = old
    assert rec["failed"] == 0 and rec["compared_videos"] >= 1
    assert not rec["correct"], rec["numbers"]
