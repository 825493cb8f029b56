"""kbe_torch.parallel on the CPU: a 2-rank gloo step is the 1-rank step on
the joint batch, as a JAX mesh step is the global-batch step.

Two ranks run as subprocesses (``tests/torch_parallel_worker.py``, one
intra-op thread each), started once for the module while this process
computes the 1-rank references of the same cases with the same code and no
mesh:

- supervised inpainting (48x64, batch 4, a narrow grid-net), the
  adversarial G+D iteration (288^2, the discriminator's smallest size,
  batch 2, a narrow grid-net and the full MPD discriminator), estimation
  with the 'same' mask loss then the 'other' step on the whole auxiliary
  batch (64^2, batch 4, a narrow disparity lattice), and refinement (64^2,
  batch 4): losses rtol 1e-5, each gradient leaf to a relative L2 error of
  1e-4, the discriminator's batch-norm buffers rtol 1e-5, and every state
  tensor (parameters, batch and spectral norms, Adam moments) bit-equal
  across the ranks after the step. A discriminator leaf whose 1-rank
  gradient is below 1e-6 of the largest leaf's (a conv bias before a
  train-mode batch norm, zero in exact arithmetic) is held below that
  instead, as ``tests/test_torch_train.py`` holds it. The adversarial
  reference runs G's nets and D's convolutions on the ranks' two parts of
  the batch: the 1-rank step's own f32 runs at one and at four threads
  part by up to 1.6e-3 on leaves of G's disparity head, so the reference
  sums in the ranks' order;
- the 2-rank estimation step against ``kbe_tpu``'s ``TrainerDepth`` on
  ``data_mesh(2)`` of conftest's CPU devices: losses rtol 1e-4, gradients
  1e-3 per leaf, the standard of ``tests/test_torch_trainer_depth.py``;
- ``batch_parallel_effect`` (32^2, 2 steps, inpainting off, 4 images on 2
  ranks, gathered to rank 0): bit-equal to the single-image effect;
- ``cli/train_torch.py --data-parallel --device cpu --max-steps 1`` on two
  ranks through torchrun's environment variables, at a patched small size:
  rank 0 alone writes the checkpoint and the metrics, and the checkpoint
  matches the 1-rank run's;
- the same CLI on a small PNG ``--dataset``, eight steps across four
  validations (the period patched to 2): each rank's training batches hold
  its part of the 1-rank run's items, with the same per-item seeds, before
  and after rank 0 validates alone.
"""

import json
import os
import re
import pickle
import socket
import subprocess
import sys

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kbe_torch import parallel as P
from kbe_torch.models import Disparity
from kbe_torch.train.checkpoint import latest_checkpoint, load_checkpoint
from kbe_torch.train.data import synthetic_batches
from kbe_torch.utils.convert import state_dict_from_flax
from kbe_tpu import parallel as PJ
from kbe_tpu.models import Disparity as DisparityJ
from kbe_tpu.models import Semantics as SemanticsJ
from kbe_tpu.train import trainer_depth as TDJ
from tests import torch_parallel_worker as W
from tests.test_torch_models import random_params
from tests.test_torch_train import _capture_jax, _rel_l2

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, as in the ranks: the Tier-1 run has six worker
    processes on the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**more):
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=REPO, **more)
    return env


@pytest.fixture(scope="module")
def trees():
    """Flax trees of the frozen Semantics and the narrow Disparity."""
    s = W.DEPTH_SIZE
    img = jnp.zeros((1, s, s, 3))
    unfrozen = lambda t: flax.core.unfreeze(jax.device_get(t))
    return {"semantics": unfrozen(random_params(SemanticsJ(), img, seed=40)),
            "disparity": unfrozen(random_params(
                DisparityJ(rows=W.DISPARITY_ROWS), img,
                jnp.zeros((1, 4, 4, 512)), seed=41))}


class TwoRanks:
    """The two ranks' run of every case, started at once; ``result(r)``
    waits for it and returns rank r's results."""

    def __init__(self, out_dir, trees):
        self.out_dir = out_dir
        with open(out_dir / "trees.pkl", "wb") as f:
            pickle.dump(trees, f)
        port = _free_port()
        self.procs = [subprocess.Popen(
            [sys.executable, "-m", "tests.torch_parallel_worker",
             str(out_dir), str(r), "2", str(port)], cwd=REPO, env=_env(),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in (0, 1)]
        self.results = None

    def result(self, rank):
        if self.results is None:
            for r, p in enumerate(self.procs):
                out, _ = p.communicate(timeout=600)
                assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
            self.results = [torch.load(self.out_dir / f"rank{r}.pt",
                                       weights_only=False) for r in (0, 1)]
        return self.results[rank]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory, trees):
    ranks = TwoRanks(tmp_path_factory.mktemp("ranks"), trees)
    yield ranks
    for p in ranks.procs:
        if p.poll() is None:
            p.kill()
            p.wait()


@pytest.fixture(scope="module")
def one_rank(two_ranks, trees, tmp_path_factory):
    """The 1-rank references of the cases, computed here while the two
    ranks run."""
    logs = str(tmp_path_factory.mktemp("one"))
    return {"supervised": W.supervised(None, logs + "/sup"),
            "adversarial": W.adversarial(None, logs + "/adv", chunks=2),
            "estimation": W.estimation(None, logs + "/est", trees),
            "refinement": W.refinement(None, logs + "/ref", trees),
            "effect": W.effect(None)}


def _losses_close(got, want, rtol):
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=rtol, abs=1e-7), k


def _grads_close(got, want, tol, zero_below=None):
    """Each leaf within ``tol`` relative L2 of the 1-rank run's. With
    ``zero_below``, a leaf whose 1-rank norm is below that share of the
    largest leaf's norm must stay below it."""
    assert len(got) == len(want)
    norm = lambda t: float(torch.linalg.vector_norm(t.double()))
    top = max(norm(w) for w in want)
    worst = (0.0, None)
    for i, (g, w) in enumerate(zip(got, want)):
        if zero_below is not None and norm(w) <= zero_below * top:
            assert norm(g) <= zero_below * top, i
            continue
        worst = max(worst, (_rel_l2(g, w), i))
    assert worst[0] <= tol, worst


@pytest.mark.parametrize("n,count", [(10, 2), (7, 3), (8, 8), (3, 4)])
def test_process_shard_indices_match_jax(n, count):
    for i in range(count):
        np.testing.assert_array_equal(
            P.process_shard_indices(n, i, count),
            PJ.process_shard_indices(n, i, count))


def test_initialize_multihost_returns_false_without_the_environment(
        monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert P.initialize_multihost(device="cpu") is False
    mesh = P.data_mesh(device="cpu")
    assert (mesh.rank, mesh.world_size, mesh.group) == (0, 1, None)
    with pytest.raises(ValueError, match="torchrun"):
        P.data_mesh(2, device="cpu")


def test_supervised_step_on_two_ranks(two_ranks, one_rank):
    want = one_rank["supervised"]
    for r in (0, 1):
        got = two_ranks.result(r)["supervised"]
        assert got["equal"]
        _losses_close(got["losses"], want["losses"], 1e-5)
        _grads_close(got["grads"], want["grads"], 1e-4)


def test_adversarial_step_on_two_ranks(two_ranks, one_rank):
    """Against the 1-rank step whose G nets and D convolutions run the
    batch in the ranks' two parts (``W.adversarial``'s ``chunks``)."""
    want = one_rank["adversarial"]
    assert want["stats"]
    for r in (0, 1):
        got = two_ranks.result(r)["adversarial"]
        assert got["equal"]
        _losses_close(got["losses"], want["losses"], 1e-5)
        _grads_close(got["g_grads"], want["g_grads"], 1e-4)
        assert list(got["d_grads"]) == list(want["d_grads"])
        _grads_close(list(got["d_grads"].values()),
                     list(want["d_grads"].values()), 1e-4, zero_below=1e-6)
        for k, v in want["stats"].items():
            np.testing.assert_allclose(got["stats"][k].numpy(), v.numpy(),
                                       rtol=1e-5, atol=1e-7, err_msg=k)


def test_estimation_steps_on_two_ranks(two_ranks, one_rank):
    want = one_rank["estimation"]
    assert want["same"]["mask"] > 0 and want["other"]["mask"] > 0
    for r in (0, 1):
        got = two_ranks.result(r)["estimation"]
        assert got["equal"] and got["step"] == want["step"] == 2
        for kind in ("same", "other"):
            _losses_close(got[kind], want[kind], 1e-5)
            _grads_close(got[f"{kind}_grads"], want[f"{kind}_grads"], 1e-4)


def test_refinement_step_on_two_ranks(two_ranks, one_rank):
    want = one_rank["refinement"]
    for r in (0, 1):
        got = two_ranks.result(r)["refinement"]
        assert got["equal"]
        _losses_close(got["losses"], want["losses"], 1e-5)
        _grads_close(got["grads"], want["grads"], 1e-4)


def test_mesh_helpers_on_two_ranks(two_ranks):
    for r in (0, 1):
        h = two_ranks.result(r)["helpers"]
        assert torch.equal(h["part"]["x"], torch.arange(
            4.0 * r, 4.0 * r + 4, dtype=torch.float64).reshape(2, 2))
        assert torch.equal(h["part"]["z"]["y"], torch.tensor(
            [2.0 * r, 2.0 * r + 1], dtype=torch.float64))
        assert torch.equal(h["state"], torch.zeros(3))  # rank 0's
        assert h["refused"]
        # sum of [1 + r, 2] over r = 0, 1; the gradient of 3 * s0 + s1
        # is the sum over the ranks of (3, 1)
        assert torch.equal(h["sum"], torch.tensor([3.0, 4.0]))
        assert torch.equal(h["grad"], torch.tensor([6.0, 2.0]))


def test_two_rank_estimation_matches_jax_mesh(two_ranks, trees, tmp_path):
    """The 2-rank 'same' step against ``kbe_tpu``'s data-parallel step over
    two devices on the same batch."""
    s = W.DEPTH_SIZE
    mesh = PJ.data_mesh(2)
    tj = TDJ.TrainerDepth({"model_to_train": "disparity",
                           "disparity_rows": W.DISPARITY_ROWS,
                           "mask_loss": "other"},
                          semantics_params=trees["semantics"],
                          logs_path=str(tmp_path / "jax"), mesh=mesh)
    tj.disparity = DisparityJ(rows=W.DISPARITY_ROWS)
    tj.tx_disparity = _capture_jax(TDJ.make_optimizer(1e-4, 0.99995))
    state = tj.init_state((s, s), disparity_params=trees["disparity"])
    batch = next(synthetic_batches(4, s, s, mode="disparity", seed=7,
                                     with_instance_masks=True))
    batch.pop("imagenet")
    step = tj._get_jitted("disp", tj.disparity_train_step)
    state, metrics = step(PJ.replicate(mesh, state),
                          PJ.shard_batch(mesh, batch))
    want = state_dict_from_flax(jax.device_get(state.opt_state["g"]))
    got = two_ranks.result(0)["estimation"]
    _losses_close(got["same"], {k: float(v) for k, v in metrics.items()},
                  1e-4)
    names = list(Disparity(rows=W.DISPARITY_ROWS).state_dict())
    assert set(names) == set(want)
    _grads_close(got["same_grads"], [want[k] for k in names], 1e-3)


def test_batch_parallel_effect_matches_the_single_image_effect(two_ranks,
                                                               one_rank):
    want = one_rank["effect"]
    assert want.shape == (W.EFFECT["images"], W.EFFECT["steps"],
                          W.EFFECT["size"], W.EFFECT["size"], 3)
    assert torch.equal(two_ranks.result(0)["effect"], want)
    assert two_ranks.result(1)["effect"] is None


_CLI = r"""
import sys
import cli.train_torch as T
import kbe_torch.train.checkpoint as C
from kbe_torch.models import Inpaint

T.SYNTHETIC_SIZE["inpainting"] = (48, 64)
make_trainer, save = T.make_trainer, C.save_checkpoint


def narrow(args, *a, **kw):
    trainer = make_trainer(args, *a, **kw)
    trainer._make_net = lambda: Inpaint(rows=(8, 16))
    return trainer


def saved(*a, **kw):
    print("checkpoint written", flush=True)
    return save(*a, **kw)


T.make_trainer, C.save_checkpoint = narrow, saved
sys.exit(T.main(sys.argv[1:]))
"""


def test_cli_data_parallel_checkpoints_on_rank_zero(tmp_path):
    """Two ranks and one, the global batch 4 alike: rank 0 alone writes
    the checkpoint and the metrics; the 2-rank checkpoint holds the 1-rank
    run's nets (rel L2 1e-5 a leaf) and Adam moments (1e-4)."""
    script = tmp_path / "train.py"
    script.write_text(_CLI)

    def argv(name, *more):
        return ["--training-mode", "inpainting", "--synthetic",
                "--batch-size", "4", "--max-steps", "1", "--device", "cpu",
                "--checkpoint-dir", str(tmp_path / name / "ck"),
                "--logs-path", str(tmp_path / name / "runs" / "train_0"),
                *more]

    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, str(script)] + argv("two", "--data-parallel"),
        cwd=REPO, env=_env(RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE="2",
                           MASTER_ADDR="127.0.0.1", MASTER_PORT=port),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in (0, 1)]
    one = subprocess.run([sys.executable, str(script)] + argv("one"),
                         cwd=REPO, env=_env(), capture_output=True,
                         text=True, timeout=600)
    assert one.returncode == 0, one.stdout[-4000:] + one.stderr[-4000:]
    outs = [p.communicate(timeout=600)[0] for p in procs]
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
    assert [out.count("checkpoint written") for out in outs] == [1, 0]
    assert os.listdir(tmp_path / "two" / "runs") == ["train_0"]
    with open(tmp_path / "two" / "runs" / "train_0" / "metrics.jsonl") as f:
        assert any(json.loads(line)["tag"] == "Inpaint/total" for line in f)

    (got,), step = load_checkpoint(latest_checkpoint(
        str(tmp_path / "two" / "ck"), "3dkbe"))
    (want,), step1 = load_checkpoint(latest_checkpoint(
        str(tmp_path / "one" / "ck"), "3dkbe"))
    assert step == step1 == 0 and got["step"] == want["step"] == 1
    for part in ("context", "net"):
        assert list(got[part]) == list(want[part])
        for k in want[part]:
            assert _rel_l2(got[part][k], want[part][k]) <= 1e-5, k
    _grads_close(got["opt_state"]["mu"], want["opt_state"]["mu"], 1e-4)


_CLI_DATASET = r"""
import sys
import threading
import cli.train_torch as T
import kbe_torch.train.data as D
import kbe_torch.train.trainer_inpaint as TI
from kbe_torch.models import Inpaint

TI.VALIDATE_EVERY = 2
make_trainer, Dataset = T.make_trainer, D.KBEDataset


# the dataset at a long side of 128 (48x64 inpainting batches), whose loads
# print the item, its seed's state and the thread: the prefetch thread's are
# the training batches', the main thread's validation's
class Small(Dataset):

    def __init__(self, *a, **kw):
        super().__init__(*a, max_dim=128, **kw)

    def load_item(self, index, rng=None):
        tag = ("val" if threading.current_thread() is threading.main_thread()
               else "train")
        seed = rng.bit_generator.state["state"]["state"]
        sys.stdout.write(f"LOAD {tag} {index} {seed}\n")  # one write
        sys.stdout.flush()
        return super().load_item(index, rng)


def narrow(args, *a, **kw):
    trainer = make_trainer(args, *a, **kw)
    trainer._make_net = lambda: Inpaint(rows=(8, 16))
    return trainer


D.KBEDataset, T.make_trainer = Small, narrow
sys.exit(T.main(sys.argv[1:]))
"""


def _png_dataset(root, n: int = 200) -> str:
    """``n`` 96x128 images with 16-bit depth maps in the reference's layout
    (images/*.png, depth/*.png): 198 training items and 2 validation ones
    after the 99/1 split."""
    import cv2

    rng = np.random.default_rng(3)
    for sub in ("images", "depth"):
        os.makedirs(os.path.join(root, sub))
    for i in range(n):
        cv2.imwrite(os.path.join(root, "images", f"{i:03d}.png"),
                    rng.integers(0, 256, (96, 128, 3), dtype=np.uint8))
        cv2.imwrite(os.path.join(root, "depth", f"{i:03d}.png"),
                    rng.integers(1000, 60000, (96, 128), dtype=np.uint16))
    return f"diml:{root}:64:30"


def test_cli_data_parallel_dataset_stream_survives_validation(tmp_path):
    """Global batch 2 on two ranks and on one, eight steps, rank 0 (and the
    1-rank run) validating before steps 1, 3, 5 and 7: the items that rank
    r loads for training, and their seeds, are the 1-rank run's items r,
    2 + r, 4 + r, ... Validation draws from a generator of its own, so it
    moves no rank's stream."""
    script = tmp_path / "train.py"
    script.write_text(_CLI_DATASET)
    dataset = _png_dataset(str(tmp_path / "data"))
    steps = 8

    def argv(name, *more):
        return ["--training-mode", "inpainting", "--dataset", dataset,
                "--batch-size", "2", "--max-steps", str(steps),
                "--device", "cpu",
                "--checkpoint-dir", str(tmp_path / name / "ck"),
                "--logs-path", str(tmp_path / name / "runs" / "train_0"),
                *more]

    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, str(script)] + argv("two", "--data-parallel"),
        cwd=REPO, env=_env(RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE="2",
                           MASTER_ADDR="127.0.0.1", MASTER_PORT=port),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in (0, 1)]
    one = subprocess.run([sys.executable, str(script)] + argv("one"),
                         cwd=REPO, env=_env(), capture_output=True,
                         text=True, timeout=600)
    assert one.returncode == 0, one.stdout[-4000:] + one.stderr[-4000:]
    outs = [p.communicate(timeout=600)[0] for p in procs]
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"

    def loads(out, tag):
        return re.findall(rf"^LOAD {tag} (\d+ \d+)$", out, re.M)

    want = loads(one.stdout, "train")[:2 * steps]
    assert len(want) == 2 * steps
    assert len(loads(one.stdout, "val")) == 2 * 4 + 1  # and the size probe
    assert len(loads(outs[0], "val")) == 2 * 4 + 1
    assert loads(outs[1], "val") == loads(outs[0], "val")[:1]
    for r in (0, 1):
        assert loads(outs[r], "train")[:steps] == want[r::2], r
