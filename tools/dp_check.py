#!/usr/bin/env python3
"""How far two data-parallel ranks part from the 1-rank reference of
``chip_smoke.py`` (x) on the card, why, and whether (x) sees a fault.

    python tools/dp_check.py [--height 384] [--width 512] [--batch 8]
                             [--device cuda]

(x)'s G+D iteration (``chip_smoke._dp_run``: the training CLI's
adversarial trainer, seeded random weights, synthetic data), on two gloo
ranks of the one card against the 1-rank step on the joint batch whose G
forward and D's convolutions run in the ranks' two parts. Prints one line
for each of:

1. the reference as (x) runs it, in rank 0's process right after its step
   (D's statistics and spectral norms taken part by part), and the same
   reference with D's statistics and spectral norms over the whole batch:
   the worst leaf of G and of D against the ranks';
2. the reference in two fresh processes: whether the two give equal bits,
   and the distance of its D leaves and of the ranks' from D's float64
   gradient on the same inputs;
3. a fault, the two ranks with D's batch statistics taken per rank: D's
   leaves against the reference and float64, the batch-norm buffers, and
   whether the states are equal across the ranks.
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# one rank of the two: the step, then on rank 0 both references
RANK = r'''
import sys
import torch
import torch.distributed as dist
import chip_smoke as cs
from kbe_torch.parallel import data_mesh, initialize_multihost

out, h, w, batch, device, fault = sys.argv[1:]
size = (int(h), int(w))
cs.TRAIN_BATCH = int(batch)
if fault == "1":  # D's batch statistics per rank
    import kbe_torch.models.discriminator as D
    D.global_mean = lambda x, mesh: x
initialize_multihost(device=device, backend="gloo")
mesh = data_mesh(2, device=device)
cs._deterministic(True, device)
run = cs._dp_run(mesh, size, device, f"{out}/l{mesh.rank}", "rank",
                 kinds=("adv",))["adv"]
if mesh.rank == 0:
    run["ref"] = cs._dp_run(None, size, device, f"{out}/ref", "ref",
                            kinds=("adv",), chunks=2, referee=True)["adv"]
    if fault != "1":
        def whole_batch_norm(bn, parts):
            forward = bn.forward

            def f(x, train, mesh=None):
                if not train:
                    return forward(x, train, mesh)
                xs = x.chunk(parts)
                mean = sum(torch.mean(p, dim=(0, 2, 3)) for p in xs) / parts
                sq = sum(torch.mean(p * p, dim=(0, 2, 3))
                         for p in xs) / parts
                var = torch.clamp(sq - mean * mean, min=0.0)
                with torch.no_grad():
                    keep = bn.momentum
                    bn.mean.copy_(keep * bn.mean + (1.0 - keep) * mean)
                    bn.var.copy_(keep * bn.var + (1.0 - keep) * var)
                mul = torch.rsqrt(var + bn.eps) * bn.scale
                return torch.cat([(p - mean[None, :, None, None])
                                  * mul[None, :, None, None]
                                  + bn.bias[None, :, None, None]
                                  for p in xs])
            bn.forward = f
        cs._chunked_batch_norm = whole_batch_norm
        cs._chunked_spectral_conv = lambda m, parts: cs.chunked(
            m, "_conv_forward", parts, batched=1)
        run["whole"] = cs._dp_run(None, size, device, f"{out}/whole",
                                  "whole", kinds=("adv",), chunks=2)["adv"]
    for k in ("ref", "whole"):
        if k in run:
            run[k].pop("states")
run["equal"] = cs._equal_on_ranks(run.pop("states"), mesh)
torch.save(run, f"{out}/rank{mesh.rank}.pt")
mesh.barrier()
dist.destroy_process_group()
'''

# the reference alone, in a fresh process
REFERENCE = r'''
import sys
import torch
import chip_smoke as cs

out, h, w, batch, device = sys.argv[1:]
cs.TRAIN_BATCH = int(batch)
cs._deterministic(True, device)
ref = cs._dp_run(None, (int(h), int(w)), device, f"{out}/fresh", "fresh",
                 kinds=("adv",), chunks=2, referee=True)["adv"]
ref.pop("states")
torch.save(ref, f"{out}/fresh.pt")
'''


def _python(code: str, *args, env=None) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, "-c", code, *map(str, args)],
                            cwd=REPO, env=env)


def _wait(procs) -> None:
    try:
        for p in procs:
            if p.wait(timeout=900) != 0:
                raise SystemExit(f"a process failed: exit {p.returncode}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def _ranks(out: str, args, fault: bool):
    import torch

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
               WORLD_SIZE="2", LOCAL_RANK="0")
    os.makedirs(out)
    _wait([_python(RANK, out, args.height, args.width, args.batch,
                   args.device, int(fault), env=dict(env, RANK=str(r)))
           for r in (0, 1)])
    return [torch.load(f"{out}/rank{r}.pt", weights_only=False)
            for r in (0, 1)]


def _counted(f64):
    """The D leaves that (x) compares: not those whose float64 norm is below
    1e-6 of the largest leaf's (a conv bias before a train-mode batch norm,
    zero in exact arithmetic), which it holds near zero instead."""
    norms = [float(x.norm()) for x in f64]
    return [i for i, n in enumerate(norms) if n > 1e-6 * max(norms)]


def _d_worst(got, want, f64, names):
    """(relative L2, leaf) of the counted D leaf of ``got`` furthest from
    ``want``."""
    import chip_smoke as cs

    return max((cs._rel_l2(got[i], want[i]), names[i]) for i in _counted(f64))


def _f64_distance(run, f64, names):
    """The counted D leaves' relative L2 distance from float64, the worst
    three."""
    import chip_smoke as cs

    d = sorted(((cs._rel_l2(run["d"][i].double(), f64[i]), names[i])
                for i in _counted(f64)), reverse=True)
    return [(round(e, 9), n) for e, n in d[:3]]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--height", type=int, default=384)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    import chip_smoke as cs

    if args.device == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip())
    with tempfile.TemporaryDirectory() as tmp:
        got, _ = _ranks(f"{tmp}/ranks", args, fault=False)
        ref, whole = got.pop("ref"), got.pop("whole")
        names, f64 = ref["d_names"], ref["d_f64"]
        for label, want in (("part by part (as (x))", ref),
                            ("over the whole batch", whole)):
            print(f"1. reference in rank 0's process, D's statistics and "
                  f"spectral norms {label}: worst leaf G "
                  f"{cs._dp_worst(got['g'], want['g'])}, D "
                  f"{_d_worst(got['d'], want['d'], f64, names)}",
                  flush=True)

        for k in ("a", "b"):  # one after the other
            os.makedirs(f"{tmp}/{k}")
            _wait([_python(REFERENCE, f"{tmp}/{k}", args.height, args.width,
                           args.batch, args.device)])
        fresh = [torch.load(f"{tmp}/{k}/fresh.pt", weights_only=False)
                 for k in ("a", "b")]
        same = all(torch.equal(x, y) for x, y in
                   zip(fresh[0]["d"] + fresh[0]["g"],
                       fresh[1]["d"] + fresh[1]["g"]))
        print(f"2. reference in two fresh processes: equal bits {same}; "
              f"worst leaf against the ranks G "
              f"{cs._dp_worst(got['g'], fresh[0]['g'])}, D "
              f"{_d_worst(got['d'], fresh[0]['d'], f64, names)}; D's "
              f"distance from float64, the fresh reference "
              f"{_f64_distance(fresh[0], fresh[0]['d_f64'], names)}, the "
              f"ranks {_f64_distance(got, fresh[0]['d_f64'], names)}, the "
              f"reference in rank 0's process "
              f"{_f64_distance(ref, f64, names)}", flush=True)

        bad = _ranks(f"{tmp}/fault", args, fault=True)
        fgot, fref = bad[0], bad[0].pop("ref")
        worst, refereed, failed = cs._d_refereed(
            fgot["d"], fref["d"], fref["d_f64"], fref["d_names"])
        bn = max(float(((fgot["bn"][k] - v).abs()
                        / (v.abs() + 1e-7)).max())
                 for k, v in fref["bn"].items())
        print(f"3. fault, D's statistics per rank: D's worst counted leaf "
              f"against the reference {worst}; against float64 "
              f"{_f64_distance(fgot, fref['d_f64'], fref['d_names'])}; "
              f"(x) fails {len(failed)} of {len(fref['d_names'])} D leaves"
              f"; batch-norm buffers up to {bn:.4g} apart (relative); "
              f"states equal across the ranks {[r['equal'] for r in bad]}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
