"""The depth trainer's optimizer. Port of ``kbe_tpu/train/trainer_depth.py``'s
``exp_decay_schedule`` and ``make_optimizer``, which the inpainting trainer
shares; ``TrainerDepth`` itself is not ported yet (``ROADMAP.md`` Queue 1).

``make_optimizer`` is ``optax.chain(optax.clip_by_global_norm(clip),
optax.adam(lr0 * gamma ** count))`` written out, in optax's arithmetic:

  - the clip scales by ``max / norm`` only when ``norm >= max``, as
    ``(g / norm) * max`` (``torch.nn.utils.clip_grad_norm_`` scales by
    ``max / (norm + 1e-6)`` whenever it is called);
  - Adam's moments are ``(1 - b) * g^k + b * m``, its bias correction
    divides each moment by ``1 - b^t`` (t counted from 1), and the update
    is ``m_hat / (sqrt(v_hat) + eps)`` (``torch.optim.Adam`` folds the
    corrections into its step size and its denominator instead);
  - the learning rate is ``lr0 * gamma^count``, the count of updates made
    before this one, from 0.

Scalars are rounded to f32 where JAX computes them in f32. The state is a
dict ``{"count": int, "mu": [...], "nu": [...]}`` of tensors aligned with
the parameter list, which ``kbe_torch.train.checkpoint`` saves.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence

import torch


def exp_decay_schedule(lr0: float, gamma: float) -> Callable:
    """count -> lr0 * gamma^count as an f32 0-d tensor."""
    def schedule(count: int) -> torch.Tensor:
        g = torch.tensor(gamma, dtype=torch.float32)
        return lr0 * torch.pow(g, torch.tensor(float(count)))
    return schedule


class Optimizer:
    """Global-norm clipping, then Adam with a scheduled learning rate."""

    def __init__(self, schedule: Callable, clip: float = 1.0, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.schedule = schedule
        self.clip = clip
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params: Sequence[torch.Tensor]) -> Dict:
        return {"count": 0,
                "mu": [torch.zeros_like(p) for p in params],
                "nu": [torch.zeros_like(p) for p in params]}

    @torch.no_grad()
    def step(self, params: Sequence[torch.Tensor],
             grads: Sequence[torch.Tensor], state: Dict) -> Dict:
        """Update ``params`` in place with ``grads``, as optax's ``update``
        and ``apply_updates``; returns the new state."""
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        keep = norm < self.clip  # no host sync: a select, as optax's
        grads = [torch.where(keep, g, (g / norm) * self.clip) for g in grads]
        count = state["count"] + 1
        f32 = lambda x: torch.tensor(x, dtype=torch.float32)
        bc1 = 1.0 - torch.pow(f32(self.b1), f32(float(count)))
        bc2 = 1.0 - torch.pow(f32(self.b2), f32(float(count)))
        lr = -1.0 * self.schedule(state["count"])
        mu, nu = [], []
        for p, g, m, v in zip(params, grads, state["mu"], state["nu"]):
            m = (1.0 - self.b1) * g + self.b1 * m
            v = (1.0 - self.b2) * (g * g) + self.b2 * v
            u = (m / bc1.to(g.device)) / (torch.sqrt(v / bc2.to(g.device))
                                          + self.eps)
            p.add_(lr.to(g.device) * u)
            mu.append(m)
            nu.append(v)
        return {"count": count, "mu": mu, "nu": nu}


def make_optimizer(lr0: float, gamma: float, clip: float = 1.0) -> Optimizer:
    return Optimizer(exp_decay_schedule(lr0, gamma), clip)
