"""The program's own spans and counters over a slice of a cell's requests:
what ``kbe_torch``'s tracer (``kbe_torch/utils/logging.py``) records
inside ``KenBurnsPipeline.__call__``, read on the profiler's one clock.

``program_slice(pipe, reqs, device)`` sends ``reqs[0]`` as a warm-up, then
the others through the real ``pipe(req.image)``, with tracing on, under
``torch.profiler`` with CPU and CUDA, and returns the ``program`` record
that the metric files ``depth_nets_ms``, ``bootstrap_ms``,
``loop_device_ms`` and ``to_host_gbps`` read, every number a video.
``slice_requests`` picks its requests: a warm-up, then each of the mix's
shapes equally often, the same photographs in every run (the stream of
``SLICE_SEED``), so that the readings follow the code and not the run's
draw of shapes and scenes (dolly's fill takes 6 to 30 device ms a video as
a scene's holes go).

The record:

- ``spans``: for each span name (``kbe/`` left off), its calls, its host
  self ms (its host time less that of the spans inside it), and the
  device ms and launches of the operations charged to it;
- ``counters``: the tracer's counts;
- ``device_ms``, and ``attributed_share``, the share of it charged to a
  span;
- ``idle_gaps``: the ten longest stretches of the slice in which no
  device operation ran, [innermost span at its middle, s], or "between".

A device operation is charged to the innermost span around the host call
that launched it: the profiler links each operation to its launch, the
CUDA API's call (``cudaLaunchKernel``, ``cuLaunchKernel``, a copy), by
correlation id, and the launch's host time falls inside the spans that
made it. The device runs behind the host, so where an operation runs says
nothing of which span launched it.
Where the effect carries no spans, ``spans`` is empty and every metric
returns None.

Run alone, on a card, from the root of a checkout:

    python3 benchmark/program.py --workload <cell> --seed <n> [--out <file>]

It sets the cell up as ``harness.run_cell`` does (the nets, one warm-up
video a shape, from ``--seed``), times the slice's requests
(``slice_requests``) with
tracing off and on (``tracing_cost``), runs the slice on them, prints one
JSON line (the record, the four metrics and the cost of tracing) and
writes it to ``--out`` too.
"""

from __future__ import annotations

import collections
import json
import statistics
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import torch

ROOT = Path(__file__).resolve().parents[1]
PROGRAM_VIDEOS = 2      # at least, recorded after one warm-up video
COST_REPS = 8           # turns of the requests in each state of tracing
SLICE_SEED = 0          # the slice's photographs, the same in every run
METRICS = ("depth_nets_ms", "bootstrap_ms", "loop_device_ms",
           "to_host_gbps")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _parents(spans: Sequence[tuple]) -> List[Optional[int]]:
    """The index of the span each span of ``spans`` ((name, start, end),
    nested as calls nest) runs in, or None."""
    order = sorted(range(len(spans)),
                   key=lambda i: (spans[i][1], -spans[i][2]))
    parents: List[Optional[int]] = [None] * len(spans)
    stack: List[int] = []
    for i in order:
        while stack and spans[stack[-1]][2] <= spans[i][1]:
            stack.pop()
        parents[i] = stack[-1] if stack else None
        stack.append(i)
    return parents


def innermost(spans: Sequence[tuple],
              times: Sequence[float]) -> List[Optional[int]]:
    """For each of ``times``, the index of the innermost span of ``spans``
    ((name, start, end), nested) that holds it, or None."""
    order = sorted(range(len(spans)),
                   key=lambda i: (spans[i][1], -spans[i][2]))
    found: List[Optional[int]] = [None] * len(times)
    stack: List[int] = []
    j = 0
    for k in sorted(range(len(times)), key=times.__getitem__):
        t = times[k]
        while j < len(order) and spans[order[j]][1] <= t:
            while stack and spans[stack[-1]][2] < spans[order[j]][1]:
                stack.pop()
            stack.append(order[j])
            j += 1
        while stack and spans[stack[-1]][2] < t:
            stack.pop()
        found[k] = stack[-1] if stack else None
    return found


def read_profile(prof) -> dict:
    """The profile's program spans (name, start us, end us) and device
    operations (name, start us, end us, span name or None), each charged
    to the innermost span around its launch."""
    from torch.autograd import DeviceType

    spans, ops, launch_at = [], [], {}
    for e in prof.events():
        if e.device_type == DeviceType.CPU:
            if e.name.startswith("kbe/"):
                spans.append((e.name[len("kbe/"):], e.time_range.start,
                              e.time_range.end))
            elif e.name.startswith("cu"):
                # the CUDA API's calls: a launch shares
                # its correlation id with the operation it launched
                launch_at[e.id] = e.time_range.start
        elif (e.device_type == DeviceType.CUDA
              and not e.name.startswith(("kbe/", "ProfilerStep"))):
            ops.append((e.name, e.time_range.start, e.time_range.end, e.id))
    launched = [launch_at.get(op[3]) for op in ops]
    known = [k for k, t in enumerate(launched) if t is not None]
    where: List[Optional[str]] = [None] * len(ops)
    for k, i in zip(known, innermost(spans, [launched[k] for k in known])):
        if i is not None:
            where[k] = spans[i][0]
    return {"spans": spans,
            "ops": [(n, s, e, w) for (n, s, e, _), w in zip(ops, where)]}


def summarise(spans: Sequence[tuple], ops: Sequence[tuple],
              counts: Dict[str, int], videos: int) -> dict:
    """The ``program`` record (see the module's doc) of the spans, the
    charged device operations and the counts of ``videos`` videos."""
    from benchmark.harness import _busy_intervals

    if not videos:
        return {}
    per = 1.0 / videos
    timeline = [op[:3] for op in ops]
    table: Dict[str, Dict[str, float]] = collections.defaultdict(
        lambda: {"calls": 0.0, "host_self_ms": 0.0, "device_ms": 0.0,
                 "launches": 0.0})
    self_us = [e - s for _, s, e in spans]
    for i, p in enumerate(_parents(spans)):
        if p is not None:
            self_us[p] -= spans[i][2] - spans[i][1]
    for (name, _, _), us in zip(spans, self_us):
        table[name]["calls"] += per
        table[name]["host_self_ms"] += us / 1e3 * per
    device_us = attributed_us = 0.0
    for _, s, e, name in ops:
        device_us += e - s
        if name is not None:
            attributed_us += e - s
            table[name]["device_ms"] += (e - s) / 1e3 * per
            table[name]["launches"] += per
    gaps = []
    videos_at = [(s, e) for name, s, e in spans if name == "video"]
    if videos_at:
        lo = min(s for s, _ in videos_at)
        hi = max(e for _, e in videos_at)
        edges = [lo] + [x for iv in _busy_intervals(timeline, lo, hi)
                        for x in iv] + [hi]
        holes = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
        inside = innermost(spans, [(a + b) / 2 for a, b in holes])
        gaps = sorted(([spans[i][0] if i is not None else "between",
                        (b - a) / 1e6] for (a, b), i in zip(holes, inside)),
                      key=lambda g: -g[1])[:10]
    return {
        "videos": videos,
        "spans": dict(sorted(table.items())),
        "counters": {name: n * per for name, n in sorted(counts.items())},
        "device_ms": device_us / 1e3 * per,
        "attributed_share": (attributed_us / device_us if device_us
                             else None),
        "idle_gaps": gaps,
    }


def profile_videos(pipe, reqs, device) -> dict:
    """``reqs[0]`` as a warm-up, then ``reqs[1:]`` through ``pipe`` with
    tracing on, under ``torch.profiler``: ``read_profile``'s spans and
    operations of ``reqs[1:]``, with the tracer's ``counters`` and the
    number of ``videos``."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from kbe_torch.utils import logging as trace

    device = torch.device(device)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof, trace.tracing():
        pipe(reqs[0].image)
        _sync(device)
        prof.step()
        trace.reset_counters()
        for req in reqs[1:]:
            pipe(req.image)
        _sync(device)
        counts = trace.counters()
        prof.step()
    trace.reset_counters()
    return dict(read_profile(prof), counters=counts, videos=len(reqs) - 1)


def slice_requests(mix: dict) -> list:
    """The slice's requests, drawn in turn from the mix's stream of
    ``SLICE_SEED``: the first as the warm-up, then the first ones of each
    of the mix's shapes, each shape as often as the others and
    ``PROGRAM_VIDEOS`` in all or one a shape, whichever is more, in the
    mix's order of shapes."""
    from benchmark import traffic

    reqs = traffic.stream(mix, SLICE_SEED)
    shapes = list(dict.fromkeys(tuple(s) for s in mix["shapes"]))
    each = -(-PROGRAM_VIDEOS // len(shapes))
    picked: Dict[tuple, list] = {shape: [] for shape in shapes}
    first = next(reqs)
    while any(len(got) < each for got in picked.values()):
        req = next(reqs)
        got = picked[(req.height, req.width)]
        if len(got) < each:
            got.append(req)
    return [first] + [req for shape in shapes for req in picked[shape]]


def program_slice(pipe, reqs, device) -> dict:
    """The ``program`` record of ``reqs`` (``profile_videos``')."""
    raw = profile_videos(pipe, reqs, device)
    return summarise(raw["spans"], raw["ops"], raw["counters"],
                     raw["videos"])


def tracing_cost(pipe, reqs, device) -> dict:
    """The host ms a video of ``reqs`` with tracing off and on, each call
    ended by its copy to the host, without a profiler: ``COST_REPS`` turns
    of the requests in each state, the states in alternating order; the
    median of each state, and of each request's on over off in a turn.
    Run it before any profile in the process: launches stay slower after a
    session has ended."""
    from kbe_torch.utils import logging as trace

    times = collections.defaultdict(list)
    for rep in range(COST_REPS):
        got = {}
        for on in ((False, True) if rep % 2 == 0 else (True, False)):
            got[on] = []
            with trace.tracing(on):
                for req in reqs:
                    t = time.perf_counter()
                    pipe(req.image)
                    got[on].append((time.perf_counter() - t) * 1e3)
        times["off"] += got[False]
        times["on"] += got[True]
        times["on_over_off"] += [b / a for a, b in zip(got[False], got[True])]
    trace.reset_counters()
    return {"median": {name: statistics.median(v)
                       for name, v in times.items()},
            "reps": COST_REPS, "videos": len(reqs)}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))

    from benchmark import harness, traffic
    from benchmark.reference.nets import model_flags
    from benchmark.reference.weights import make_weights

    if not torch.cuda.is_available():
        print("program.py: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda:0")
    manifest = harness.load_manifest()
    cell = harness.load_cell(manifest, args.workload)
    config = cell["config_data"]
    pipe = harness.build_pipeline(
        config, make_weights(config["weights_seed"], device,
                             model_flags(config)), device)
    for req in traffic.warm_ups(cell["mix"], args.seed):
        pipe(req.image)
    reqs = slice_requests(cell["mix"])
    cost = tracing_cost(pipe, reqs[1:], device)
    record = {"program": program_slice(pipe, reqs, device)}
    line = {"workload": args.workload, "seed": args.seed,
            "device": {"kind": torch.cuda.get_device_name(0),
                       "power_limit": harness._power_limit()},
            "metrics": {m: harness.read_metric(m, record) for m in METRICS},
            "program": record["program"], "tracing_cost": cost}
    text = json.dumps(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
