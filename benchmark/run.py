"""Run one cell of the benchmark of ``kbe_torch`` once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks for.
Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown`` and ``program`` (the port's own spans and counters a video,
``program.py``), and last ``checks``, each number compared with its limit;
the same numbers are the last lines of standard error. Exits non-zero,
printing no result, where no CUDA card is found, where the cell asks for
more cards than there are, where ``kbe_torch`` is missing, or where JAX or
the JAX package was loaded.

The port builds its CUDA kernels with nvcc into ``kbe_torch/ops/_build/``
inside the checkout on a checkout's first run and loads them from there
after; the benchmark keeps no cache of its own.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))

    import torch

    from benchmark import harness

    manifest = harness.load_manifest()
    cell = harness.load_cell(manifest, args.workload)
    if not torch.cuda.is_available():
        print("run.py: no CUDA card; the benchmark never runs on the CPU",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"run.py: {args.workload} needs {cell['chips']} cards, found "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    import kbe_torch  # noqa: F401  (the system under test must be there)

    record = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), "cuda:0", T_START)
    line = harness.result_line(manifest, args.workload, bool(args.trace),
                               record, cell["chips"])
    found = harness.forbidden_modules()
    if found:
        print(f"run.py: the process loaded {found}", file=sys.stderr)
        return 3
    for err in record["window"]["errors"]:
        print(f"run.py: a video failed: {err}", file=sys.stderr)
    lat = [v["latency_s"] for v in record["window"]["videos"] if v["ok"]]
    thirds = [lat[k * len(lat) // 3:(k + 1) * len(lat) // 3]
              for k in range(3)]
    print("run.py: window " + f"{record['window']['seconds']:.3f} s, "
          f"{len(lat)} videos; mean ms by third " + ", ".join(
              f"{sum(t) / len(t) * 1e3:.1f}" for t in thirds if t),
          file=sys.stderr)
    print("run.py: set-up " + ", ".join(
        f"{k} {v:.3f}" for k, v in record["setup_parts"].items()),
        file=sys.stderr)
    if "program_s" in record:
        print(f"run.py: the program's slice took {record['program_s']:.3f} s",
              file=sys.stderr)
    print(f"run.py: {record['compared_videos']} videos compared in "
          f"{record['reference_s']:.3f} s; correct {record['correct']}",
          file=sys.stderr)
    for name, c in record["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
