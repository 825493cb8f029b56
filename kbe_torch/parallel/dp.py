"""Data-parallel execution wrappers. Port of ``kbe_tpu/parallel/dp.py`` over
``torch.distributed``.

Training. A JAX data-parallel step is the global-batch step: XLA shards the
batch and inserts the collectives, so every batch reduction of a loss and
every batch-norm statistic is taken over the global batch. Here each rank
runs the step on its local batch, and a step given a mesh takes its batch
reductions through ``global_sum``: an all-reduce whose gradient is the
all-reduce of the incoming gradient. Each rank then differentiates
``(1/W) * sum over ranks of the rank's loss`` (W the world size), and the
mean of the ranks' gradients (``mean_over_ranks``, before the optimizer and
its global-norm clip) is that loss's gradient: the joint batch's, for a
loss made of global sums and of means over equal local batches. A 1-rank
mesh changes no bit: a sum over one rank and a division by one are exact.

Inference: each rank renders its own images' videos with the unchanged
single-image effect, with no traffic between the ranks (the 64 images ->
64 videos production layout).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from kbe_torch.parallel.mesh import DataMesh, shard_batch


class _GlobalSum(torch.autograd.Function):
    """all_reduce(SUM) forward, all_reduce(SUM) of the gradient backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, op=dist.ReduceOp.SUM, group=ctx.group)
        return grad, None


def global_sum(x: torch.Tensor, mesh: Optional[DataMesh]) -> torch.Tensor:
    """``x`` summed over the mesh's ranks, differentiably; ``x`` itself with
    no mesh or a mesh with no process group."""
    if mesh is None or mesh.group is None:
        return x
    return _GlobalSum.apply(x, mesh.group)


def global_mean(x: torch.Tensor, mesh: Optional[DataMesh]) -> torch.Tensor:
    """The mean over the ranks of a per-rank mean of equal local batches:
    the global batch's mean."""
    if mesh is None or mesh.group is None:
        return x
    return _GlobalSum.apply(x, mesh.group) / mesh.world_size


def mean_over_ranks(tensors: Sequence[torch.Tensor],
                    mesh: Optional[DataMesh]) -> List[torch.Tensor]:
    """Each tensor averaged over the ranks, all in one all-reduce of one
    flat buffer (gradients, metrics); the tensors themselves with no
    process group."""
    tensors = list(tensors)
    if mesh is None or mesh.group is None or not tensors:
        return tensors
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.group)
    flat = flat / mesh.world_size
    parts = flat.split([t.numel() for t in tensors])
    return [p.view_as(t) for p, t in zip(parts, tensors)]


def data_parallel_step(step_fn: Callable, mesh: DataMesh) -> Callable:
    """``step_fn(*args, mesh=None) -> (*states, metrics)``, one of the
    trainers' steps, as the data-parallel step over ``mesh``: it runs on the
    rank's local batch with ``mesh``, so its losses and batch norms reduce
    over the global batch and its gradients are averaged over the ranks
    before the optimizer; the metrics come back averaged over the ranks,
    equal on every rank."""
    def step(*args, **kwargs):
        *states, metrics = step_fn(*args, mesh=mesh, **kwargs)
        keys = list(metrics)
        values = mean_over_ranks([metrics[k] for k in keys], mesh)
        return (*states, dict(zip(keys, values)))
    return step


def batch_parallel_effect(effect_fn: Callable, mesh: DataMesh,
                          gather: bool = False) -> Callable:
    """The single-image effect over a batch of images, split over the ranks.

    ``effect_fn(models, image_1hw3) -> frames`` becomes ``fn(models,
    images_bhw3)``: each rank renders the videos of its contiguous part of
    the global batch ``images`` (B must divide by the world size) with the
    unchanged effect, one image after another, with no traffic between the
    ranks, and returns them as (B / W, steps, H, W, 3). With ``gather`` rank
    0 returns every rank's videos, (B, steps, H, W, 3), and the others
    None."""
    def fn(models, images):
        local = shard_batch(mesh, images)
        frames = torch.stack([effect_fn(models, img[None]) for img in local])
        if not gather:
            return frames
        if mesh.group is None:
            return frames
        if dist.get_backend(mesh.group) != "nccl":
            frames = frames.cpu()  # gloo gathers host tensors
        parts = ([torch.empty_like(frames) for _ in range(mesh.world_size)]
                 if mesh.is_chief else None)
        dist.gather(frames, parts, dst=0, group=mesh.group)
        return torch.cat(parts) if mesh.is_chief else None
    return fn
