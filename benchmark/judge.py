"""The comparison that decides ``correct``: the uint8 frames of videos that
the timed path produced against the reference's frames of the same
photographs and weights.

The numbers, pooled over every compared frame value (pixel and channel):
``mean_abs_levels``, the mean absolute difference in uint8 levels, and
``off8_ppm``, the values apart by more than 8 levels, per million values.
``checks/<workload>.json`` gives the limit of each, with the readings it
was set from.
"""

from __future__ import annotations

import json
import random
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

CHECKS_DIR = Path(__file__).resolve().parent / "checks"


class Sample:
    """A uniform sample of ``k`` of the items offered, drawn from the seed
    while they are offered (a reservoir), so that only ``k`` videos stay in
    memory."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = random.Random(seed % (1 << 64) ^ 0x6B6265)
        self.items: List[tuple] = []
        self.offered = 0

    def offer(self, item) -> None:
        self.offered += 1
        if len(self.items) < self.k:
            self.items.append(item)
            return
        j = self.rng.randrange(self.offered)
        if j < self.k:
            self.items[j] = item


class Tally:
    """Running sums of the differences of compared frames."""

    def __init__(self):
        self.values = 0
        self.abs_sum = 0
        self.off8 = 0
        self.videos = 0

    def add(self, got, want: torch.Tensor) -> None:
        """``got`` (T, H, W, 3) uint8, numpy or torch; ``want`` the same
        shape on the reference's device. A shape that differs counts every
        value as off."""
        got = torch.as_tensor(np.asarray(got)).to(want.device)
        self.videos += 1
        if got.shape != want.shape or got.dtype != torch.uint8:
            n = want.numel()
            self.values += n
            self.abs_sum += 255 * n
            self.off8 += n
            return
        diff = (got.to(torch.int16) - want.to(torch.int16)).abs()
        self.values += diff.numel()
        self.abs_sum += int(diff.sum(dtype=torch.int64))
        self.off8 += int((diff > 8).sum())

    def numbers(self) -> Dict[str, float]:
        n = max(self.values, 1)
        return {"mean_abs_levels": self.abs_sum / n,
                "off8_ppm": self.off8 / n * 1e6}


def load_checks(workload: str) -> dict:
    """``checks/<workload>.json``: {"compare": k videos, "limits": {number:
    limit}, ...}."""
    checks = json.loads((CHECKS_DIR / f"{workload}.json").read_text())
    if int(checks.get("compare", 0)) < 1 or not checks.get("limits"):
        raise ValueError(f"checks of {workload}: need compare >= 1 and "
                         "limits")
    return checks


def verdict(numbers: Dict[str, float], limits: Dict[str, float]):
    """(every number within its limit, {name: {value, limit}})."""
    shown = {name: {"value": numbers[name], "limit": limit}
             for name, limit in limits.items()}
    return all(numbers[name] <= limit for name, limit in limits.items()), \
        shown
