"""Observability: metrics files and per-stage timing. Port of
``kbe_tpu/utils/logging.py``'s ``MetricsWriter`` and ``StageTimer``.

``MetricsWriter`` writes every scalar to ``<logdir>/metrics.jsonl``, and to
TensorBoard too where ``tensorboardX`` is installed, in an auto-incremented
run directory (``runs/train_0`` -> ``runs/train_1`` if taken).
``StageTimer`` times named stages on the host clock and, given a CUDA
tensor, synchronises its device before it stops the clock, so a stage's
time includes its device work.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import time
from typing import Dict, Optional

import torch


def _next_run_dir(path: str) -> str:
    """Increment a trailing ``_<n>`` until the directory is free."""
    while os.path.isdir(path):
        m = re.match(r"^(.*_)(\d+)/?$", path)
        if m:
            path = f"{m.group(1)}{int(m.group(2)) + 1}/"
        else:
            path = path.rstrip("/") + "_1/"
    return path


def _plain(params: Dict) -> Dict:
    return {k: v for k, v in params.items()
            if isinstance(v, (int, float, str, bool))}


class MetricsWriter:
    """TensorBoard scalar writer (if tensorboardX is present) and JSONL."""

    def __init__(self, logdir: str = "runs/train_0",
                 subdir: Optional[str] = None):
        logdir = _next_run_dir(logdir)
        if subdir is not None:
            logdir = os.path.join(logdir, subdir)
        self.logdir = logdir
        os.makedirs(logdir, exist_ok=True)
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            self._tb = None
        else:
            self._tb = SummaryWriter(logdir)
        self._jsonl = open(os.path.join(logdir, "metrics.jsonl"), "a")

    def scalar(self, tag: str, value, step: int) -> None:
        value = float(value)
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)
        self._jsonl.write(json.dumps({"tag": tag, "value": value,
                                      "step": step}) + "\n")

    def scalars(self, values: Dict[str, float], step: int,
                prefix: str = "") -> None:
        for k, v in values.items():
            self.scalar(prefix + k, v, step)

    def hparams(self, params: Dict) -> None:
        if self._tb is not None:
            self._tb.add_hparams(_plain(params), {})
        self._jsonl.write(json.dumps({"hparams": _plain(params)}) + "\n")

    def flush(self) -> None:
        if self._tb is not None:
            self._tb.flush()
        self._jsonl.flush()

    def close(self) -> None:
        self.flush()
        if self._tb is not None:
            self._tb.close()
        self._jsonl.close()


class StageTimer:
    """Wall-clock seconds per named stage."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str, block_on: Optional[torch.Tensor] = None):
        """Time the body; with ``block_on`` a CUDA tensor, wait for its
        device first."""
        t0 = time.perf_counter()
        yield
        if block_on is not None and block_on.is_cuda:
            torch.cuda.synchronize(block_on.device)
        dt = time.perf_counter() - t0
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> Dict[str, float]:
        return {k: self.totals[k] / self.counts[k] for k in self.totals}
