"""Observability: metrics files, the effect's spans and counters, and
profiler traces. Port of ``kbe_tpu/utils/logging.py``'s ``MetricsWriter``
and ``profiler_trace``; the tracer replaces its ``StageTimer``.

``MetricsWriter`` writes every scalar to ``<logdir>/metrics.jsonl``, and to
TensorBoard too where ``tensorboardX`` is installed, in an auto-incremented
run directory (``runs/train_0`` -> ``runs/train_1`` if taken).

The tracer is off unless a block turns it on (``tracing()``). Off,
``span(name)`` returns one shared null context and ``count`` does nothing,
so the effect's path pays a flag check a call. On, ``span(name, **args)``
is a ``torch.profiler.record_function`` range named ``kbe/<name>`` (its
``args`` as JSON), so in a ``torch.profiler`` session the spans share the
device operations' clock and nest as the calls do; and ``count(name, n)``
adds ``n`` to a counter in memory: a Python int as it is, a tensor (a
count that lives on the device) into a tensor on its device, which
``settle`` reads, once the caller has synchronised. ``counters()``
returns the counts and ``reset_counters()`` clears them.

``profiler_trace`` turns tracing on and writes a ``torch.profiler`` trace
of its body (the host, and the card where there is one) to
``<logdir>/trace.json``, which Perfetto or ``chrome://tracing`` open, and
the body's counts to ``<logdir>/counters.json``.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import threading
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


class NullWriter:
    """A ``MetricsWriter`` that writes nothing: a data-parallel trainer's
    writer on every rank but rank 0."""

    def scalar(self, tag: str, value, step: int) -> None:
        pass

    def scalars(self, values: Dict[str, float], step: int,
                prefix: str = "") -> None:
        pass

    def hparams(self, params: Dict) -> None:
        pass

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


_TRACING = False
_NULL_SPAN = contextlib.nullcontext()
_HOST_COUNTS: Dict[str, int] = {}
_DEVICE_COUNTS: Dict[str, torch.Tensor] = {}
_COUNT_LOCK = threading.Lock()


def tracing_on() -> bool:
    """Whether spans and counts are recorded."""
    return _TRACING


@contextlib.contextmanager
def tracing(on: bool = True):
    """Spans and counts on (or off) inside the block."""
    global _TRACING
    was, _TRACING = _TRACING, on
    try:
        yield
    finally:
        _TRACING = was


def span(name: str, **args):
    """A ``kbe/<name>`` range of the profiler while tracing is on, else the
    shared null context."""
    if not _TRACING:
        return _NULL_SPAN
    return torch.profiler.record_function(
        "kbe/" + name, json.dumps(args) if args else None)


def count(name: str, n) -> None:
    """Add ``n`` (an int, or a one-element tensor left on its device) to
    the counter ``name`` while tracing is on."""
    if not _TRACING:
        return
    with _COUNT_LOCK:
        if isinstance(n, torch.Tensor):
            held = _DEVICE_COUNTS.get(name)
            _DEVICE_COUNTS[name] = n if held is None else held + n
        else:
            _HOST_COUNTS[name] = _HOST_COUNTS.get(name, 0) + int(n)


def settle() -> None:
    """Read the counts held on a device into the host's: a synchronise
    where a device still works on them, so call it after one."""
    with _COUNT_LOCK:
        for name, held in _DEVICE_COUNTS.items():
            _HOST_COUNTS[name] = _HOST_COUNTS.get(name, 0) + int(held)
        _DEVICE_COUNTS.clear()


def counters() -> Dict[str, int]:
    """Every counter's total since the last ``reset_counters``."""
    settle()
    with _COUNT_LOCK:
        return dict(_HOST_COUNTS)


def reset_counters() -> None:
    with _COUNT_LOCK:
        _HOST_COUNTS.clear()
        _DEVICE_COUNTS.clear()


@contextlib.contextmanager
def profiler_trace(logdir: Optional[str]):
    """Tracing on, a ``torch.profiler`` trace of the body into
    ``<logdir>/trace.json`` and the body's counts into
    ``<logdir>/counters.json``; a no-op for ``logdir=None``."""
    if logdir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    before = counters()
    with profile(activities=activities) as prof, tracing():
        yield
    counts = {name: n - before.get(name, 0)
              for name, n in counters().items()}
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    with open(os.path.join(logdir, "counters.json"), "w") as f:
        json.dump(counts, f, indent=1, sort_keys=True)
