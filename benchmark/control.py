"""The readings that the limits of ``checks/<workload>.json`` are set from.

    python3 benchmark/control.py --workload <name> --seeds <n> [--first S]
        [--videos K] [--out FILE]

For each of ``n`` seeds (``S``, ``S+1``, ...), in one process: the
cell's pipeline, with the configuration's weights, renders the first ``K``
of the seed's requests (``K`` defaults to the videos a run compares), and the
reference renders them again; the numbers of ``judge.Tally`` are read for
the program against the reference (the lower reading), and for the
control against the reference. The control is the reference with TF32
allowed for the f32 depth nets on the card: the precision below the one
the configuration states. One JSON line a seed, on standard output and in
``--out``.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def readings(cell: dict, seeds, videos: int, device, log=None):
    """[{seed, program: numbers, control: numbers, seconds}] of ``seeds``."""
    import torch

    from benchmark import harness, judge, traffic
    from benchmark.reference import effect as E
    from benchmark.reference.nets import model_flags
    from benchmark.reference.weights import make_weights

    device = torch.device(device)
    config = cell["config_data"]
    models = model_flags(config)
    weights = make_weights(config["weights_seed"], device, models)
    pipe = harness.build_pipeline(config, weights, device)
    nets = E.load_nets(weights, config["precision"], device, models)
    out = []
    for seed in seeds:
        t0 = time.perf_counter()
        stream = traffic.stream(cell["mix"], seed)
        reqs = [next(stream) for _ in range(videos)]
        frames = [pipe(r.image) for r in reqs]
        prog, ctrl = judge.Tally(), judge.Tally()
        for req, got in zip(reqs, frames):
            want = E.video(nets, req.image, config, device)
            prog.add(got, want)
            ctrl.add(E.video(nets, req.image, config, device,
                             precision="tf32").cpu(), want)
        row = {"seed": seed, "program": prog.numbers(),
               "control": ctrl.numbers(), "videos": len(reqs),
               "seconds": time.perf_counter() - t0}
        out.append(row)
        if log:
            log(row)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first", type=int, default=3_000_000_000)
    ap.add_argument("--videos", type=int, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import harness

    if not torch.cuda.is_available():
        print("control.py: no CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(harness.load_manifest(), args.workload)
    videos = args.videos or int(cell["checks"]["compare"])
    sink = open(args.out, "a") if args.out else None

    def log(row):
        row = dict(row, workload=args.workload)
        print(json.dumps(row), flush=True)
        if sink:
            sink.write(json.dumps(row) + "\n")
            sink.flush()

    try:
        readings(cell, range(args.first, args.first + args.seeds), videos,
                 "cuda:0", log)
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
