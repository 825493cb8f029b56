"""The cases of ``tests/test_torch_parallel.py``, run by one rank of a
data-parallel group or, with no mesh, as the 1-rank step on the joint batch.

Each case builds its trainer on the CPU from seeds (or from the Flax trees
the test hands over), takes its batch from ``synthetic_batches`` (the
rank's part of the global batch with a mesh, the whole batch without),
swaps the trainer's optimizers for ones that record the gradients they are
given around the real ones (``chip_smoke.Recorder``, the harness the card's
check uses too), runs one step (through ``data_parallel_step``
with a mesh) and returns its losses, gradients and states, and whether
every state tensor is equal on every rank.

As a program it is one rank of a gloo group on the CPU:

    python -m tests.torch_parallel_worker OUT_DIR RANK WORLD PORT

reads ``OUT_DIR/trees.pkl``, runs every case, and writes
``OUT_DIR/rank<RANK>.pt``. It imports neither JAX nor ``kbe_tpu``.
"""

from __future__ import annotations

import os
import pickle
import sys

import numpy as np
import torch
import torch.distributed as dist

from chip_smoke import Recorder, chunked
from kbe_torch.config import CameraConfig, EffectConfig, ZoomSettings
from kbe_torch.parallel import (batch_parallel_effect, data_mesh,
                                data_parallel_step, global_sum,
                                host_local_batch_to_global,
                                initialize_multihost, replicate, shard_batch)
from kbe_torch.train.data import synthetic_batches
from kbe_torch.train.trainer_depth import TrainerDepth, to_device
from kbe_torch.train.trainer_inpaint import TrainerInpaint

ROWS = (8, 16)                      # the inpainting grid-net's, narrow
DISPARITY_ROWS = (8, 12, 16, 32, 32, 32)
DEPTH_SIZE = 64
SUP = dict(size=(48, 64), batch=4, camera=CameraConfig(64.0, 30.0), seed=5)
ADV = dict(size=(288, 288), batch=2, camera=CameraConfig(256.0, 60.0),
           seed=6)
EFFECT = dict(size=32, steps=2, images=4, seed=9)


def _shard(mesh):
    return None if mesh is None else (mesh.rank, mesh.world_size)


def _step(fn, mesh):
    return fn if mesh is None else data_parallel_step(fn, mesh)


def _floats(metrics):
    return {k: float(v) for k, v in metrics.items()}


def _tensors(*modules_or_states):
    """Every tensor of the modules' state dicts and of the optimizer
    states' Adam moments."""
    out = []
    for x in modules_or_states:
        if isinstance(x, torch.nn.Module):
            out += list(x.state_dict().values())
        else:
            out += list(x["inner"]["mu"]) + list(x["inner"]["nu"])
    return out


def _equal_on_ranks(tensors, mesh) -> bool:
    """Whether every tensor equals rank 0's, bit for bit, on every rank."""
    if mesh is None:
        return True
    # every rank takes part in every broadcast, whatever it finds
    same = [torch.equal(t, replicate(mesh, t.clone())) for t in tensors]
    same = torch.tensor([all(same)], dtype=torch.int32)
    dist.all_reduce(same, op=dist.ReduceOp.MIN)
    return bool(same.item())


def supervised(mesh, logs):
    h, w = SUP["size"]
    tr = TrainerInpaint({"model_to_train": "inpainting", "inpaint_rows": ROWS},
                        camera=SUP["camera"], device="cpu", logs_path=logs,
                        mesh=mesh)
    tr.tx = Recorder(tr.tx)
    state = tr.init_state((h, w))
    batch = next(synthetic_batches(SUP["batch"], h, w, mode="inpainting",
                                   camera=SUP["camera"], seed=SUP["seed"],
                                   shard=_shard(mesh)))
    state, metrics = _step(tr.supervised_step, mesh)(state,
                                                     to_device(batch, "cpu"))
    return {"losses": _floats(metrics), "grads": state.opt_state["g"],
            "equal": _equal_on_ranks(_tensors(state.context, state.net,
                                              state.opt_state), mesh)}


def adversarial(mesh, logs, chunks: int = 1):
    """The G+D iteration. ``chunks`` runs G's nets and D's convolutions on
    the batch in that many parts, as that many ranks run them: the
    reference whose f32 sums follow the ranks' (the 1-rank step's own f32
    runs at one and four threads part by up to 1.6e-3 on leaves of G's
    disparity head and 2.6e-4 on D's)."""
    h, w = ADV["size"]
    tr = TrainerInpaint({"model_to_train": "inpainting", "adversarial": True,
                         "inpaint_rows": ROWS},
                        camera=ADV["camera"], device="cpu", logs_path=logs,
                        mesh=mesh)
    tr.tx, tr.tx_d = Recorder(tr.tx), Recorder(tr.tx_d)
    g, d = tr.init_state((h, w)), tr.init_disc_state((h, w))
    if chunks > 1:
        for net in (g.context, g.net):
            chunked(net, "forward", chunks)
        for conv in d.disc.modules():
            if isinstance(conv, torch.nn.Conv2d):
                chunked(conv, "_conv_forward", chunks, batched=1)
    batch = next(synthetic_batches(ADV["batch"], h, w, mode="inpainting",
                                   camera=ADV["camera"], seed=ADV["seed"],
                                   shard=_shard(mesh)))
    g, d, metrics = _step(tr.adversarial_step, mesh)(
        g, d, to_device(batch, "cpu"), True)
    stats = {k: v.clone() for k, v in d.disc.state_dict().items()
             if k.endswith((".bn.mean", ".bn.var"))}
    d_names = [n for n, _ in d.disc.named_parameters()
               if not n.startswith("core.vgg.")]
    return {"losses": _floats(metrics), "g_grads": g.opt_state["g"],
            "d_grads": dict(zip(d_names, d.opt_state["g"])), "stats": stats,
            "equal": _equal_on_ranks(_tensors(g.context, g.net, d.disc,
                                              g.opt_state, d.opt_state),
                                     mesh)}


def _depth_trainer(mode, trees, logs, mesh, **more):
    return TrainerDepth({"model_to_train": mode,
                         "disparity_rows": DISPARITY_ROWS, **more},
                        semantics_params=trees["semantics"], device="cpu",
                        logs_path=logs, mesh=mesh)


def estimation(mesh, logs, trees):
    """The 'same' step through the mesh, then the 'other' step, replicated,
    on the whole auxiliary batch."""
    s = DEPTH_SIZE
    tr = _depth_trainer("disparity", trees, logs, mesh, mask_loss="other")
    tr.tx_disparity = Recorder(tr.tx_disparity)
    tr.tx_imagenet = Recorder(tr.tx_imagenet)
    state = tr.init_state((s, s), disparity_params=trees["disparity"])
    batch = next(synthetic_batches(4, s, s, mode="disparity", seed=7,
                                   with_instance_masks=True,
                                   shard=_shard(mesh)))
    aux = to_device(batch.pop("imagenet"), "cpu")
    state, same = _step(tr.disparity_train_step, mesh)(
        state, to_device(batch, "cpu"))
    same_grads = state.opt_state["g"]
    state, other = tr.imagenet_mask_step(state, aux)
    return {"same": _floats(same), "same_grads": same_grads,
            "other": _floats(other), "other_grads": state.opt_state["g"],
            "step": state.step,
            "equal": _equal_on_ranks(_tensors(state.net, state.opt_state),
                                     mesh)}


def refinement(mesh, logs, trees):
    s = DEPTH_SIZE
    tr = _depth_trainer("refine", trees, logs, mesh, estimation_size=32)
    tr.tx_refine = Recorder(tr.tx_refine)
    dstate, rstate = tr.init_state((s, s), "refine",
                                   disparity_params=trees["disparity"])
    batch = next(synthetic_batches(4, s, s, mode="refine", seed=8,
                                   shard=_shard(mesh)))
    rstate, metrics = _step(tr.refine_train_step, mesh)(
        dstate, rstate, to_device(batch, "cpu"))
    return {"losses": _floats(metrics), "grads": rstate.opt_state["g"],
            "equal": _equal_on_ranks(_tensors(rstate.net, rstate.opt_state),
                                     mesh)}


def effect(mesh):
    """Videos of ``EFFECT['images']`` images: the single-image effect one
    after another with no mesh, ``batch_parallel_effect`` gathered to rank
    0 with one."""
    from kbe_torch.pipeline import KenBurnsPipeline

    n = EFFECT["size"]
    pipe = KenBurnsPipeline.create(
        0, effect=EffectConfig(num_steps=EFFECT["steps"], inpaint=False),
        device="cpu")
    fn = pipe.effect_fn(n, n, ZoomSettings.default_3d(n, n))
    images = np.random.default_rng(EFFECT["seed"]).uniform(
        0, 1, (EFFECT["images"], n, n, 3)).astype(np.float32)
    if mesh is None:
        return torch.stack([fn(pipe.models, torch.from_numpy(im)[None])
                            for im in images])
    return batch_parallel_effect(fn, mesh, gather=True)(pipe.models, images)


def mesh_helpers(mesh):
    """The mesh's helpers on this rank: its contiguous part of a batch, a
    broadcast state, a refused local batch whose size differs from the
    other rank's, and a global sum and its gradient."""
    batch = {"x": np.arange(8.0).reshape(4, 2), "z": {"y": np.arange(4.0)}}
    part = shard_batch(mesh, batch)
    state = {"w": torch.full((3,), float(mesh.rank))}
    replicate(mesh, state)
    try:
        host_local_batch_to_global(mesh, {"x": np.zeros((mesh.rank + 1, 2))})
        refused = False
    except ValueError:
        refused = True
    x = torch.tensor([1.0 + mesh.rank, 2.0], requires_grad=True)
    total = global_sum(x, mesh)
    (3.0 * total[0] + total[1]).backward()
    return {"part": part, "state": state["w"], "refused": refused,
            "sum": total.detach(), "grad": x.grad}


def run(mesh, logs: str, trees):
    return {"helpers": mesh_helpers(mesh),
            "supervised": supervised(mesh, logs + "/sup"),
            "adversarial": adversarial(mesh, logs + "/adv"),
            "estimation": estimation(mesh, logs + "/est", trees),
            "refinement": refinement(mesh, logs + "/ref", trees),
            "effect": effect(mesh)}


def main(out_dir: str, rank: int, world: int, port: int) -> None:
    torch.set_num_threads(1)
    if not initialize_multihost(f"127.0.0.1:{port}", world, rank,
                                device="cpu"):
        raise RuntimeError("no process group")
    mesh = data_mesh(world, device="cpu")
    with open(os.path.join(out_dir, "trees.pkl"), "rb") as f:
        trees = pickle.load(f)
    out = run(mesh, os.path.join(out_dir, f"logs{rank}"), trees)
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]))
